"""Model assembly: token input; `attn`, `swa`, `mla`, `mamba`, `mlstm` and
`slstm` mixers; `mlp` and `moe` channel mixers; no encoder.

The counterpart of the reference's models/transformer.py. A config's layer
plan is `prefix` (unstacked) + `period` x num_periods. As in the reference,
period parameters and caches are STACKED: every leaf under "stack" carries a
leading num_periods axis, so the reference's pytrees map onto the port's
leaf for leaf (convert.lm_params_from_numpy). Where the reference scans the
period body with lax.scan, the port runs a Python loop over the periods on
views of the stacked leaves. With `cfg.remat` and grad mode on, each
period's body runs under torch.utils.checkpoint (non-reentrant), the
counterpart of the reference's jax.checkpoint of the scan body: only the
period's input is kept, and the backward recomputes the rest. The
reference's REPRO_REMAT_POLICY=dots knob (keep the matmul outputs) is not
carried, nor are `scan_unroll` and the sequence-parallel knob
(REPRO_SEQ_PARALLEL, a model-axis layout).

Decode writes each new token's k/v (an `mla` layer: its c_kv and k_rope
latent rows) into the caches IN PLACE and returns the same dict (the
reference returns new caches). As in the reference, a parallel block
(`cfg.parallel_block`) runs the MLP beside the mixer in the forward for every
attention-like mixer, and at decode only for `attn` / `swa`.

A `moe` layer returns its router's aux loss; the stack sums it over the
prefix layers and the periods (through the checkpointed period body under
remat), in the reference's order.

The recurrent mixers keep O(1) states in place of a sequence-indexed cache:
a `mamba` layer (models/mamba.py) {h, conv_tail}, normed input and the
residual here, as attention; `mlstm` {c, n, m, conv_tail} and `slstm` {c, n,
m, h} blocks (models/xlstm.py) take x itself and return x with their own
residual (their configs use mlp="none"). Their decodes write the states in
place too.

Layers the port does not run yet (an encoder, embedding input) raise
NotImplementedError naming their ROADMAP item.
"""

from __future__ import annotations

import functools
from typing import Any, Dict

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.models import attention, layers, mamba, moe, xlstm
from repro_torch.models.layers import TensorSpec  # noqa: F401 (the package's name for it)
from repro_torch.tree import tree_map  # noqa: F401 (the package's name for it)

_MIXERS = ("attn", "swa", "mla", "mamba", "mlstm", "slstm")
_NORMED_MIXERS = ("attn", "swa", "mla", "mamba")  # xLSTM blocks norm their own input

# what each refused feature waits for (ROADMAP queue 1, item 13)
_TODO = {
    "encoder": "the whisper encoder and cross-attention: ROADMAP queue 1 item 13g",
    "embeddings": "embedding input (vlm/audio frontends): ROADMAP queue 1 item 13h",
}


def check_supported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError if the port cannot run `cfg` yet."""
    if cfg.encoder_layers:
        raise NotImplementedError(f"{cfg.name}: {_TODO['encoder']}")
    if cfg.input_mode != "tokens":
        raise NotImplementedError(f"{cfg.name}: {_TODO['embeddings']}")
    for spec in cfg.layer_kinds():
        if spec.mixer not in _MIXERS or spec.mlp not in ("mlp", "moe", "none"):
            raise ValueError(f"{cfg.name}: unknown layer {spec}")
    if cfg.pos_type not in ("rope", "none"):
        raise NotImplementedError(
            f"{cfg.name}: pos_type {cfg.pos_type!r} ({_TODO['encoder']})"
        )


# ---------------------------------------------------------------------------
# per-layer init / forward / decode
# ---------------------------------------------------------------------------


def _init_layer(generator, cfg: ModelConfig, spec: LayerSpec, dtype):
    p: Dict[str, Any] = {}
    dev = generator.device
    if spec.mixer in _NORMED_MIXERS:
        p["mixer_norm"] = layers.make_norm(cfg.norm_type, cfg.d_model, dtype, dev)
    make = {"mla": attention.make_mla, "mamba": mamba.make_mamba, "mlstm": xlstm.make_mlstm,
            "slstm": xlstm.make_slstm}.get(spec.mixer, attention.make_attention)
    p["mixer"] = make(generator, cfg, dtype)
    if spec.mlp == "mlp":
        p["mlp_norm"] = layers.make_norm(cfg.norm_type, cfg.d_model, dtype, dev)
        out_scale = cfg.d_ff**-0.5 / (2.0 * cfg.num_layers) ** 0.5
        p["mlp"] = layers.make_mlp(
            generator, cfg.d_model, cfg.d_ff, cfg.mlp_type, dtype,
            bias=cfg.attn_bias, out_scale=out_scale,
        )
    elif spec.mlp == "moe":
        p["mlp_norm"] = layers.make_norm(cfg.norm_type, cfg.d_model, dtype, dev)
        p["mlp"] = moe.make_moe(generator, cfg, dtype)
    return p


def _layer_forward(p, cfg: ModelConfig, spec: LayerSpec, x, positions, *, mode: str, causal=True):
    """Full-sequence layer (mode "train" | "prefill"). Returns (x, aux,
    cache or None); aux is the MoE router's loss, None for other layers (the
    reference's zero, which the sum skips)."""
    aux = None
    want_cache = mode == "prefill"
    if spec.mixer in ("mlstm", "slstm"):  # x in, x (with the block's residual) out
        fwd = xlstm.mlstm_forward if spec.mixer == "mlstm" else xlstm.slstm_forward
        out = fwd(p["mixer"], cfg, x, return_cache=want_cache)
    else:
        xn = layers.apply_norm(p["mixer_norm"], x)
        if spec.mixer == "mla":
            out = attention.mla_forward(p["mixer"], cfg, xn, positions, return_cache=want_cache)
        elif spec.mixer == "mamba":
            out = mamba.mamba_forward(p["mixer"], cfg, xn, return_cache=want_cache)
        else:
            out = attention.attn_forward(
                p["mixer"], cfg, xn, positions, causal=causal,
                window=cfg.sliding_window if spec.mixer == "swa" else 0,
                return_cache=want_cache,
            )
    cache = None
    if want_cache:
        y, state = out
        cache = {"self": state}
    else:
        y = out
    if spec.mixer in ("mlstm", "slstm"):
        x = y
    elif cfg.parallel_block and spec.mixer != "mamba" and spec.mlp != "none":
        y_mlp = layers.apply_mlp(p["mlp"], xn, cfg.mlp_type)
        return x + y + y_mlp, aux, cache
    else:
        x = x + y
    if spec.mlp in ("mlp", "moe"):
        xn = layers.apply_norm(p["mlp_norm"], x)
        if spec.mlp == "mlp":
            y = layers.apply_mlp(p["mlp"], xn, cfg.mlp_type)
        else:
            y, aux = moe.apply_moe(p["mlp"], cfg, xn)
        x = x + y
    return x, aux, cache


def _layer_decode(p, cfg: ModelConfig, spec: LayerSpec, x, cache, pos):
    """One-token layer step; updates `cache` in place. Returns (x, cache)."""
    if spec.mixer in ("mlstm", "slstm"):
        dec = xlstm.mlstm_decode if spec.mixer == "mlstm" else xlstm.slstm_decode
        x, _ = dec(p["mixer"], cfg, x, cache["self"])
    else:
        xn = layers.apply_norm(p["mixer_norm"], x)
        if spec.mixer == "mla":
            y, _ = attention.mla_decode(p["mixer"], cfg, xn, cache["self"], pos)
        elif spec.mixer == "mamba":
            y, _ = mamba.mamba_decode(p["mixer"], cfg, xn, cache["self"])
        else:
            window = cfg.sliding_window if spec.mixer == "swa" else 0
            y, _ = attention.attn_decode(p["mixer"], cfg, xn, cache["self"], pos, window=window)
        if cfg.parallel_block and spec.mixer in ("attn", "swa") and "mlp" in p:
            y_mlp = layers.apply_mlp(p["mlp"], xn, cfg.mlp_type)
            return x + y + y_mlp, cache
        x = x + y
    if "mlp" in p:
        xn = layers.apply_norm(p["mlp_norm"], x)
        if "router" in p["mlp"]:
            y, _ = moe.apply_moe(p["mlp"], cfg, xn)
        else:
            y = layers.apply_mlp(p["mlp"], xn, cfg.mlp_type)
        x = x + y
    return x, cache


def _layer_cache_spec(cfg: ModelConfig, spec: LayerSpec, batch, seq, dtype):
    recurrent = {"mamba": mamba.mamba_cache_spec, "mlstm": xlstm.mlstm_cache_spec,
                 "slstm": xlstm.slstm_cache_spec}.get(spec.mixer)
    if recurrent is not None:
        return {"self": recurrent(cfg, batch, dtype)}
    if spec.mixer == "mla":
        mla = cfg.mla
        return {"self": {"c_kv": TensorSpec((batch, seq, mla.kv_lora_rank), dtype),
                         "k_rope": TensorSpec((batch, seq, mla.qk_rope_head_dim), dtype)}}
    sd = TensorSpec((batch, seq, cfg.num_kv_heads, cfg.head_dim), dtype)
    return {"self": {"k": sd, "v": sd}}


# ---------------------------------------------------------------------------
# pytree helpers (nested dicts / lists of tensors: repro_torch.tree)
# ---------------------------------------------------------------------------


def _period(stack, i):
    """Views of period i of the stacked leaves."""
    return tree_map(lambda t: t[i], stack)


# ---------------------------------------------------------------------------
# whole-model init / apply
# ---------------------------------------------------------------------------


def _dtype_of(cfg: ModelConfig):
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg.dtype]


def init_params(cfg: ModelConfig, generator: torch.Generator):
    """Random parameters drawn from `generator`, on the generator's device,
    in the reference's pytree layout (period leaves stacked)."""
    check_supported(cfg)
    dtype = _dtype_of(cfg)
    p: Dict[str, Any] = {}
    p["embed"] = layers.make_embedding(generator, cfg.padded_vocab, cfg.d_model, dtype)
    if not cfg.tie_embeddings:
        p["lm_head"] = layers.make_dense(
            generator, cfg.d_model, cfg.padded_vocab, dtype, scale=cfg.d_model**-0.5
        )
    p["final_norm"] = layers.make_norm(cfg.norm_type, cfg.d_model, dtype, generator.device)
    if cfg.prefix:
        p["prefix"] = [_init_layer(generator, cfg, spec, dtype) for spec in cfg.prefix]
    if cfg.num_periods > 0:
        # [layer][...] leaves of (P, ...), filled as the layers are drawn (in
        # order, period by period): a layer's leaves are copied into row i and
        # dropped, so the peak holds the stack and one layer, not every layer
        # twice
        p_count = cfg.num_periods
        stack = [None] * len(cfg.period)
        for i in range(p_count):
            for j, spec in enumerate(cfg.period):
                layer = _init_layer(generator, cfg, spec, dtype)
                if stack[j] is None:
                    stack[j] = tree_map(lambda t: t.new_empty((p_count,) + tuple(t.shape)), layer)
                tree_map(lambda dst, src: dst[i].copy_(src), stack[j], layer)
                del layer
        p["stack"] = stack
    return p


class _MetaDraws:
    """Stands in for a torch.Generator: init_params then draws nothing and
    makes meta tensors."""

    device = torch.device("meta")


def param_template(cfg: ModelConfig):
    """The parameter tree as meta tensors: init_params's structure, shapes
    and dtypes without storage (a checkpoint's restore template)."""
    return init_params(cfg, _MetaDraws())


def _stack_leaves(trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack_leaves([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


def _embed_inputs(p, cfg: ModelConfig, batch):
    """Returns (x, positions) for a token batch."""
    if "inputs_embeds" in batch:
        raise NotImplementedError(f"{cfg.name}: {_TODO['embeddings']}")
    tokens = batch["tokens"]
    x = layers.embed_tokens(p["embed"], tokens, scale=cfg.embed_scale)
    b, s = tokens.shape
    positions = torch.arange(s, dtype=torch.int32, device=tokens.device).expand(b, s)
    return x, positions


def _period_forward(lp, cfg: ModelConfig, x, aux, positions, mode):
    """One period's layers. Returns (x, aux plus the layers' aux, the
    layers' caches)."""
    cs = []
    for j, spec in enumerate(cfg.period):
        x, a, c = _layer_forward(lp[j], cfg, spec, x, positions, mode=mode)
        aux = aux if a is None else aux + a
        cs.append(c)
    return x, aux, cs


def _run_stack(p, cfg: ModelConfig, x, positions, mode):
    """prefix layers + the periods in order. Returns (x, aux, caches)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    caches: Dict[str, Any] = {}
    if cfg.prefix:
        pc = []
        for lp, spec in zip(p["prefix"], cfg.prefix):
            x, a, c = _layer_forward(lp, cfg, spec, x, positions, mode=mode)
            aux = aux if a is None else aux + a
            pc.append(c)
        if mode == "prefill":
            caches["prefix"] = pc
    if cfg.num_periods > 0:
        body = _period_forward
        if cfg.remat and mode == "train" and torch.is_grad_enabled():
            body = functools.partial(checkpoint, _period_forward, use_reentrant=False,
                                     preserve_rng_state=False)
        per_period = []
        for i in range(cfg.num_periods):
            x, aux, cs = body(_period(p["stack"], i), cfg, x, aux, positions, mode)
            per_period.append(cs)
        if mode == "prefill":
            caches["stack"] = [
                _stack_leaves([per_period[i][j] for i in range(cfg.num_periods)])
                for j in range(len(cfg.period))
            ]
    return x, aux, caches


def forward_logits(p, cfg: ModelConfig, batch, mode="train"):
    """Full-sequence forward to (padded-vocab) logits, mode "train" or
    "prefill"; mode "features" returns the final-normed features (B, S, d)
    in place of logits (the loss projects them chunk by chunk). Returns
    (logits or features, aux, caches)."""
    if mode not in ("train", "prefill", "features"):
        raise ValueError(f"forward_logits mode {mode!r}")
    check_supported(cfg)
    x, positions = _embed_inputs(p, cfg, batch)
    x, aux, caches = _run_stack(p, cfg, x, positions, "train" if mode == "features" else mode)
    x = layers.apply_norm(p["final_norm"], x)
    if mode == "features":
        return x, aux, caches
    if mode == "prefill":
        # only the last position's logits are needed
        x = x[:, -1:]
    logits = layers.lm_logits(
        p.get("lm_head"), x, tied_embed=p["embed"] if cfg.tie_embeddings else None,
    )
    return logits, aux, caches


def decode_step(p, cfg: ModelConfig, tokens, caches, pos):
    """One decode step. tokens: (B, 1) int; pos: (B,) write position.
    Updates `caches` in place; returns (logits, caches)."""
    check_supported(cfg)
    x = layers.embed_tokens(p["embed"], tokens, scale=cfg.embed_scale)
    if cfg.prefix:
        for lp, spec, c in zip(p["prefix"], cfg.prefix, caches["prefix"]):
            x, _ = _layer_decode(lp, cfg, spec, x, c, pos)
    if cfg.num_periods > 0:
        for i in range(cfg.num_periods):
            lp = _period(p["stack"], i)
            cp = _period(caches["stack"], i)
            for j, spec in enumerate(cfg.period):
                x, _ = _layer_decode(lp[j], cfg, spec, x, cp[j], pos)
    x = layers.apply_norm(p["final_norm"], x)
    logits = layers.lm_logits(
        p.get("lm_head"), x, tied_embed=p["embed"] if cfg.tie_embeddings else None,
    )
    return logits, caches


_SEQ_CACHE_KEYS = ("k", "v", "c_kv", "k_rope")


def pad_caches(cfg: ModelConfig, caches, capacity: int):
    """Grow prefill caches (seq axis) to `capacity` with zeros so decode can
    append: attention k / v (B, S, KVH, D) and MLA latents c_kv (B, S, r) /
    k_rope (B, S, dr). Self caches in the period stack carry a leading
    num_periods axis (seq axis 2); prefix-layer caches have it at axis 1."""

    def pad_layer(c, stacked):
        out = {}
        for part, sub in c.items():
            o = {}
            for k, v in sub.items():
                if k in _SEQ_CACHE_KEYS:
                    axis = 2 if stacked else 1
                    pad = [0, 0] * (v.dim() - axis - 1) + [0, capacity - v.shape[axis]]
                    o[k] = torch.nn.functional.pad(v, pad)
                else:
                    o[k] = v
            out[part] = o
        return out

    out = {}
    if "prefix" in caches:
        out["prefix"] = [pad_layer(c, stacked=False) for c in caches["prefix"]]
    if "stack" in caches:
        out["stack"] = [pad_layer(c, stacked=True) for c in caches["stack"]]
    return out


def cache_specs(cfg: ModelConfig, batch: int, seq: int):
    """TensorSpec pytree of a decode cache of capacity `seq`."""
    check_supported(cfg)
    dtype = _dtype_of(cfg)
    out: Dict[str, Any] = {}
    if cfg.prefix:
        out["prefix"] = [_layer_cache_spec(cfg, spec, batch, seq, dtype) for spec in cfg.prefix]
    if cfg.num_periods > 0:
        per = [_layer_cache_spec(cfg, spec, batch, seq, dtype) for spec in cfg.period]
        out["stack"] = [
            {part: {k: TensorSpec((cfg.num_periods,) + s.shape, s.dtype) for k, s in sub.items()}
             for part, sub in layer.items()}
            for layer in per
        ]
    return out
