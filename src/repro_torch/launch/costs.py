"""Per-rank cost counters for one eager call: FLOPs, bytes, memory and
collectives, on real tensors or on fake ones (launch/dryrun.py).

`measure(fn, *args, mesh=None)` runs fn(*args) once under two dispatch
modes: torch.utils.flop_counter.FlopCounterMode, and below it `CostMode`,
which sees every aten op that runs (after FlopCounterMode's decompositions)
and counts

  - FLOPs by operand kind, with FlopCounterMode's own formulas: "bf16" for
    products on bf16 / fp16 operands (the tensor cores), "f32" for the rest;
  - bytes accessed: each op's distinct tensor operands read once and its
    results (and mutated operands) written once. View and metadata-only ops
    (a schema view, an allocation, a result that aliases an operand) move
    nothing. This is eager traffic without fusion: the port's own, larger
    than a fused program's. The ops that move the most are kept by name;
  - memory: the bytes of the storages the call allocates that are live at
    once, at their peak (temp_size_in_bytes), tracked with a weakref
    finalizer on each new storage; argument_size_in_bytes is the distinct
    storages of the arguments, output_size_in_bytes those of the result;
  - collectives: count and result bytes per kind (the c10d ops behind
    torch.distributed's calls; a point-to-point receive, as ring_allgather
    makes, is a "collective-permute"), and bytes per mesh dim of the group
    (`mesh` names the dims; any other group is "world").

A hand-written kernel's wrapper, called on fake tensors, launches nothing
(kernels/_build.fake_launch); it reports its launch, FLOPs and bytes to
`CostMode.record_kernel`, since no aten op shows them.
"""

from __future__ import annotations

import collections
import weakref

import torch
from torch.utils._pytree import tree_leaves
from torch.utils._python_dispatch import TorchDispatchMode

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")

# c10d op -> collective kind; the op's first operand holds its result
_C10D = {
    "_allgather_base_": "all-gather",
    "allgather_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_base_": "all-to-all",
    "alltoall_": "all-to-all",
    "recv_": "collective-permute",
    "recv_any_source_": "collective-permute",
}

_ALLOCATIONS = ("empty", "empty_strided", "empty_like", "new_empty", "new_empty_strided")

_TENSOR_CORE = (torch.bfloat16, torch.float16)

TOP_OPS = 8  # aten ops a record names by their bytes


def _tensors(tree):
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _span_bytes(t: torch.Tensor) -> int:
    """The bytes a tensor's elements span (a broadcast dim counts once)."""
    n = t.element_size()
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n


def storage_bytes(tree) -> int:
    """The bytes of the distinct storages under the tensors of `tree`."""
    seen = {}
    for t in _tensors(tree):
        st = t.untyped_storage()
        seen[st._cdata] = st.nbytes()
    return sum(seen.values())


def _written(func, args, kwargs):
    """The operands an op's schema marks as written (in place or out=)."""
    out = []
    for i, arg in enumerate(func._schema.arguments):
        info = arg.alias_info
        if info is None or not info.is_write:
            continue
        val = args[i] if i < len(args) else kwargs.get(arg.name)
        out.extend(_tensors(val))
    return out


def _group_name(args):
    from torch.distributed import ProcessGroup

    for a in args:
        if type(a).__name__ == "ScriptObject":
            return ProcessGroup.unbox(a).group_name
    return None


class CostMode(TorchDispatchMode):
    """The counters of one call (see the module's docstring); `mesh`, when
    given, names the mesh dims whose groups the collectives run on."""

    def __init__(self, mesh=None):
        super().__init__()
        self.flops = {"bf16": 0.0, "f32": 0.0}
        self.op_flops = 0.0  # the aten ops' share, which FlopCounterMode also counts
        self.bytes = 0.0
        self.bytes_by_op = collections.Counter()
        self.collectives = {k: {"count": 0, "bytes": 0} for k in KINDS}
        self.by_dim = {}
        self.kernels = {}
        self.live = 0
        self.peak = 0
        self._tracked = {}  # storage key -> its finalizer
        self._dims = {}
        if mesh is not None:
            self._dims = {mesh.get_group(n).group_name: n for n in mesh.mesh_dim_names}

    # -- memory ---------------------------------------------------------------

    def _free(self, key, nbytes):
        self._tracked.pop(key, None)
        self.live -= nbytes

    def _track(self, outs, operands):
        known = {t.untyped_storage()._cdata for t in operands}
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in known or key in self._tracked:
                continue
            nbytes = st.nbytes()
            self._tracked[key] = weakref.finalize(st, self._free, key, nbytes)
            self.live += nbytes
            self.peak = max(self.peak, self.live)

    def close(self):
        """Stop tracking (finalizers of storages still alive detach)."""
        for fin in list(self._tracked.values()):
            fin.detach()
        self._tracked.clear()

    # -- kernels and collectives -------------------------------------------------

    def record_kernel(self, name, flops, nbytes):
        entry = self.kernels.setdefault(name, {"launches": 0, "flops": 0.0, "bytes": 0.0})
        entry["launches"] += 1
        for kind, f in flops.items():
            self.flops[kind] += f
            entry["flops"] += f
        entry["bytes"] += nbytes
        self.bytes += nbytes

    def _collective(self, kind, args):
        nbytes = sum(_span_bytes(t) for t in _tensors(args[0]))
        self.collectives[kind]["count"] += 1
        self.collectives[kind]["bytes"] += nbytes
        name = _group_name(args)
        dim = self._dims.get(name, "world")
        self.by_dim[dim] = self.by_dim.get(dim, 0) + nbytes

    # -- every op -----------------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace == "c10d":
            kind = _C10D.get(func._overloadpacket.__name__)
            if kind is not None:
                self._collective(kind, args)
            return out
        from torch.utils.flop_counter import flop_registry

        packet = func._overloadpacket
        operands = _tensors((args, kwargs))
        if packet in flop_registry:
            f = float(flop_registry[packet](*args, **kwargs, out_val=out))
            kind = "bf16" if operands and operands[0].dtype in _TENSOR_CORE else "f32"
            self.flops[kind] += f
            self.op_flops += f
        outs = _tensors(out)
        self._track(outs, operands)
        written = {id(t): t for t in outs + _written(func, args, kwargs)}
        if func.is_view or packet.__name__ in _ALLOCATIONS or not written:
            return out
        if not func._schema.is_mutable:
            op_storages = {t.untyped_storage()._cdata for t in operands}
            if all(t.untyped_storage()._cdata in op_storages for t in outs):
                return out  # the result aliases an operand: metadata only
        reads = {id(t): t for t in operands}
        nbytes = (sum(_span_bytes(t) for t in reads.values())
                  + sum(_span_bytes(t) for t in written.values()))
        self.bytes += nbytes
        self.bytes_by_op[packet.__name__] += nbytes
        return out


def measure(fn, *args, mesh=None, **kwargs):
    """(fn(*args, **kwargs), costs): the call run once under the counters.

    costs holds hlo_flops (every FLOP: the aten ops' and the fake kernel
    launches'), flops (by operand kind), hlo_bytes, argument_size_in_bytes,
    output_size_in_bytes, temp_size_in_bytes, collectives (per kind),
    collective_bytes_by_dim, kernels (per fake-launched kernel) and
    top_bytes (the TOP_OPS aten ops that move the most, and their bytes)."""
    from torch.utils.flop_counter import FlopCounterMode

    arg_bytes = storage_bytes((args, kwargs))
    mode = CostMode(mesh)
    try:
        with mode, FlopCounterMode(display=False) as counter:
            result = fn(*args, **kwargs)
    finally:
        mode.close()
    if mode.op_flops != counter.get_total_flops():
        raise RuntimeError(
            f"the cost counter's FLOPs {mode.op_flops} differ from FlopCounterMode's "
            f"{counter.get_total_flops()}"
        )
    costs = {
        "hlo_flops": mode.flops["bf16"] + mode.flops["f32"],
        "flops": dict(mode.flops),
        "hlo_bytes": mode.bytes,
        "argument_size_in_bytes": arg_bytes,
        "output_size_in_bytes": storage_bytes(result),
        "temp_size_in_bytes": mode.peak,
        "collectives": mode.collectives,
        "collective_bytes_by_dim": mode.by_dim,
        "kernels": mode.kernels,
        "top_bytes": dict(mode.bytes_by_op.most_common(TOP_OPS)),
    }
    return result, costs
