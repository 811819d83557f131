"""Trees of tensors: nested dicts and lists, flattened as jax.tree_util does.

Parameters, optimizer states, gradients and batches are plain nested dicts
and lists (the reference's pytrees). Every walk here visits dict keys in
SORTED order and list items in order, as jax.tree_util flattens, so a leaf's
index, its checkpoint name (`keystr`) and the order of global_norm's sum are
the reference's. Anything that is not a dict or a list is a leaf: a tensor,
a numpy array, a layout tuple (distributed/sharding.py), a TensorSpec.
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple

Path = Tuple[Any, ...]  # dict keys (str) and list indices (int)


def _is_node(x) -> bool:
    return isinstance(x, (dict, list))


def leaves_with_path(tree, path: Path = ()) -> List[Tuple[Path, Any]]:
    """[(path, leaf)] in jax's order (sorted dict keys)."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in leaves_with_path(tree[k], path + (k,))]
    if isinstance(tree, list):
        return [kv for i, v in enumerate(tree) for kv in leaves_with_path(v, path + (i,))]
    return [(path, tree)]


def leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_path(tree)]


def unflatten(template, new_leaves) -> Any:
    """A tree shaped like `template` whose leaves, in jax's order, are
    `new_leaves` (dicts keep the template's insertion order)."""
    it = iter(new_leaves)

    def build(t):
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        if isinstance(t, list):
            return [build(v) for v in t]
        return next(it)

    out = build(template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out


def tree_map(fn: Callable, tree, *rest) -> Any:
    """fn over the leaves of `tree`, with the matching leaves of `rest`
    (trees of the same structure, or with leaves where `tree` has them: a
    subtree of `rest` at a leaf of `tree` is passed whole, as jax's
    flatten_up_to does)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, list):
        if any(len(r) != len(tree) for r in rest):
            raise ValueError("tree structures differ")
        return [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)


def keystr(path: Path) -> str:
    """jax.tree_util.keystr's form: "['params']['stack'][0]['mixer']['wq']['kernel']"."""
    return "".join(f"[{k!r}]" if isinstance(k, str) else f"[{k}]" for k in path)


def path_str(path: Path) -> str:
    """The reference sharding rules' form: "stack/0/mixer/wq/kernel"."""
    return "/".join(str(k) for k in path)
