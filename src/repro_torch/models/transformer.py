"""Model assembly: token or embedding input; `attn`, `swa`, `mla`, `mamba`,
`mlstm` and `slstm` mixers; `mlp` and `moe` channel mixers; an encoder with
cross-attention (whisper).

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

An embedding-input arch (`input_mode="embeddings"`: llava's stubbed vision
tower) takes a batch's `inputs_embeds` (B, S, d) in place of tokens in the
forward and prefill; without them it embeds tokens, and decode always
embeds the new token, as in the reference. An encoder-decoder arch
(whisper, `encoder_layers` > 0) runs `encode` over the batch's
`encoder_frames` (B, Se, d: the stubbed conv frontend's output, plus
sinusoidal positions; bidirectional layers as unstacked `p["encoder"]`
layers), then its decoder over the tokens with learned positions
(`p["dec_pos"]`) and a cross-attention block after each mixer. Prefill
caches the encoder output's k / v per decoder layer under "cross" (B, Se,
KVH, hd), which decode reads whole and never writes, and which `pad_caches`
leaves as it is. A batch of an encoder-decoder arch without
encoder_frames raises ValueError (the reference fails on it with a
KeyError); so the entry points that feed token batches only (the LM Engine
and the trainer) refuse whisper at their first prefill or step.

On a mesh whose "model" axis is wider than 1 (distributed/
tensor_parallel.py) `init_params(cfg, generator, mesh)` gives a rank its
blocks of the one-rank init's leaves (sharding.param_specs; an encoder's
layers too), drawn layer by layer as one rank draws them, so a rank holds at
most one layer's whole leaves beyond its blocks; the layers compute on
blocks (attention and MLA heads, MLP and expert columns, Mamba's and the
mLSTM's d_inner, the sLSTM's heads, vocab rows) with the collectives in the
layers' code; a parallel block sums its mixer's and its MLP's row-parallel
partials before one all-reduce; `cache_specs(..., mesh=mesh)` gives a rank's
cache blocks (sharding.cache_spec_for), which prefill returns and decode
writes in place, and which `pad_caches(..., mesh=mesh)` pads: a leaf whose
layout lies over the sequence, at the prompt's length or at the capacity,
is gathered whole, padded and cut to the rank's block of the padded cache,
so rows move between ranks.
"""

from __future__ import annotations

import functools
from typing import Any, Dict

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.distributed import sharding as shd
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.models import attention, layers, mamba, moe, xlstm
from repro_torch.models.layers import TensorSpec  # noqa: F401 (the package's name for it)
from repro_torch.tree import leaves_with_path, path_str, unflatten
from repro_torch.tree import tree_map  # noqa: F401 (the package's name for it)

_MIXERS = ("attn", "swa", "mla", "mamba", "mlstm", "slstm")
_NORMED_MIXERS = ("attn", "swa", "mla", "mamba")  # xLSTM blocks norm their own input

_ENCODER_SPEC = LayerSpec("attn", "mlp")


def check_supported(cfg: ModelConfig) -> None:
    """Raise ValueError for a layer kind the model does not know."""
    for spec in cfg.layer_kinds():
        if spec.mixer not in _MIXERS or spec.mlp not in ("mlp", "moe", "none"):
            raise ValueError(f"{cfg.name}: unknown layer {spec}")


# ---------------------------------------------------------------------------
# per-layer init / forward / decode
# ---------------------------------------------------------------------------


def _init_layer(generator, cfg: ModelConfig, spec: LayerSpec, dtype, cross=False):
    p: Dict[str, Any] = {}
    dev = generator.device
    if spec.mixer in _NORMED_MIXERS:
        p["mixer_norm"] = layers.make_norm(cfg.norm_type, cfg.d_model, dtype, dev)
    make = {"mla": attention.make_mla, "mamba": mamba.make_mamba, "mlstm": xlstm.make_mlstm,
            "slstm": xlstm.make_slstm}.get(spec.mixer, attention.make_attention)
    p["mixer"] = make(generator, cfg, dtype)
    if cross:
        p["cross_norm"] = layers.make_norm(cfg.norm_type, cfg.d_model, dtype, dev)
        p["cross"] = attention.make_attention(generator, cfg, dtype)
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


def _fused_parallel(cfg: ModelConfig, spec: LayerSpec, p) -> bool:
    """Whether a parallel block's attention and MLP partials are summed
    before one all-reduce (a model axis wider than 1)."""
    return (tp.active() is not None and cfg.parallel_block and spec.mixer in ("attn", "swa")
            and spec.mlp == "mlp" and "mlp" in p)


def _fused_sum(p, cfg: ModelConfig, y_attn, xn):
    """A parallel block's output on a model axis: the attention's and the
    MLP's row-parallel partials summed, one all-reduce, the biases once."""
    y_mlp = layers.apply_mlp(p["mlp"], xn, cfg.mlp_type, reduce=False)
    return tp.reduce_from_model(y_attn + y_mlp) + layers.out_bias(p["mixer"]["wo"],
                                                                  p["mlp"]["w_out"])


def _layer_forward(p, cfg: ModelConfig, spec: LayerSpec, x, positions, *, mode: str, causal=True,
                   enc_out=None):
    """Full-sequence layer (mode "train" | "prefill"). Returns (x, aux,
    cache or None); aux is the MoE router's loss, None for other layers (the
    reference's zero, which the sum skips). With `enc_out` and a "cross"
    block, cross-attention to it runs after the mixer, and prefill caches
    enc_out's k / v under "cross"."""
    aux = None
    want_cache = mode == "prefill"
    fused = _fused_parallel(cfg, spec, p)
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
                return_cache=want_cache, reduce=not fused,
            )
    cache = None
    if want_cache:
        y, state = out
        cache = {"self": state}
    else:
        y = out
    if spec.mixer in ("mlstm", "slstm"):
        x = y
    elif fused:
        return x + _fused_sum(p, cfg, y, xn), aux, cache
    elif cfg.parallel_block and spec.mixer != "mamba" and spec.mlp != "none":
        y_mlp = layers.apply_mlp(p["mlp"], xn, cfg.mlp_type)
        return x + y + y_mlp, aux, cache
    else:
        x = x + y
    if enc_out is not None and "cross" in p:
        xn = layers.apply_norm(p["cross_norm"], x)
        out = attention.attn_forward(p["cross"], cfg, xn, positions, kv_x=enc_out,
                                     return_cache=want_cache)
        if want_cache:
            y, cache["cross"] = out
        else:
            y = out
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
            fused = _fused_parallel(cfg, spec, p)
            y, _ = attention.attn_decode(p["mixer"], cfg, xn, cache["self"], pos, window=window,
                                         reduce=not fused)
            if fused:
                return x + _fused_sum(p, cfg, y, xn), cache
        if cfg.parallel_block and spec.mixer in ("attn", "swa") and "mlp" in p:
            y_mlp = layers.apply_mlp(p["mlp"], xn, cfg.mlp_type)
            return x + y + y_mlp, cache
        x = x + y
    if "cross" in cache:
        xn = layers.apply_norm(p["cross_norm"], x)
        y, _ = attention.attn_decode(p["cross"], cfg, xn, cache["cross"], pos, cross=True)
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


def init_params(cfg: ModelConfig, generator: torch.Generator, mesh=None):
    """Random parameters drawn from `generator`, on the generator's device,
    in the reference's pytree layout (period leaves stacked; an encoder's
    layers a list, unstacked). With a mesh whose model axis is wider than 1,
    the rank's blocks (sharding.param_specs) of the same draws."""
    check_supported(cfg)
    dtype = _dtype_of(cfg)
    cross = cfg.encoder_layers > 0
    specs = None
    if tp.axis_of(mesh) is not None:
        specs = shd.param_specs(mesh, param_template(cfg))

    def cut(part, *keys):
        """A part's blocks: its layouts are specs[keys...] (stacked
        layouts without their leading num_periods entry)."""
        if specs is None:
            return part
        layout = specs
        for k in keys:
            layout = layout[k]
        if keys[0] == "stack":
            layout = tree_map(lambda s: s[1:], layout)
        return tp.shard_params(part, mesh, layout)

    p: Dict[str, Any] = {}
    p["embed"] = cut(layers.make_embedding(generator, cfg.padded_vocab, cfg.d_model, dtype),
                     "embed")
    if not cfg.tie_embeddings:
        p["lm_head"] = cut(layers.make_dense(
            generator, cfg.d_model, cfg.padded_vocab, dtype, scale=cfg.d_model**-0.5
        ), "lm_head")
    p["final_norm"] = layers.make_norm(cfg.norm_type, cfg.d_model, dtype, generator.device)
    if cfg.prefix:
        p["prefix"] = [cut(_init_layer(generator, cfg, spec, dtype, cross), "prefix", i)
                       for i, spec in enumerate(cfg.prefix)]
    if cfg.num_periods > 0:
        # [layer][...] leaves of (P, ...), filled as the layers are drawn (in
        # order, period by period): a layer's leaves (its blocks, on a model
        # axis) are copied into row i and dropped, so the peak holds the
        # stack and one layer, not every layer twice
        p_count = cfg.num_periods
        stack = [None] * len(cfg.period)
        for i in range(p_count):
            for j, spec in enumerate(cfg.period):
                layer = cut(_init_layer(generator, cfg, spec, dtype, cross), "stack", j)
                if stack[j] is None:
                    stack[j] = tree_map(lambda t: t.new_empty((p_count,) + tuple(t.shape)), layer)
                tree_map(lambda dst, src: dst[i].copy_(src), stack[j], layer)
                del layer
        p["stack"] = stack
    if cross:
        p["encoder"] = {
            "layers": [cut(_init_layer(generator, cfg, _ENCODER_SPEC, dtype),
                           "encoder", "layers", i) for i in range(cfg.encoder_layers)],
            "final_norm": layers.make_norm(cfg.norm_type, cfg.d_model, dtype, generator.device),
        }
        # the decoder's learned positions (whisper's)
        p["dec_pos"] = layers._normal(generator, (cfg.max_position_embeddings, cfg.d_model),
                                      0.02, dtype)
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


def _embed(p, cfg: ModelConfig, tokens):
    return layers.embed_tokens(p["embed"], tokens, scale=cfg.embed_scale,
                               vocab=cfg.padded_vocab, d_model=cfg.d_model)


def _positions(b, s, device):
    return torch.arange(s, dtype=torch.int32, device=device).expand(b, s)


def _embed_inputs(p, cfg: ModelConfig, batch):
    """Returns (x, positions) for a batch of inputs_embeds (B, S, d), or of
    tokens where it has none; a sinusoidal arch adds its positions."""
    if "inputs_embeds" in batch:
        x = batch["inputs_embeds"]
        b, s, _ = x.shape
    else:
        tokens = batch["tokens"]
        x = _embed(p, cfg, tokens)
        b, s = tokens.shape
    if cfg.pos_type == "sinusoidal":
        x = x + layers.sinusoidal_positions(s, cfg.d_model, x.device).to(x.dtype)
    return x, _positions(b, s, x.device)


def encode(p, cfg: ModelConfig, frames):
    """The encoder over stubbed frame embeddings (B, Se, d): sinusoidal
    positions, bidirectional attention layers, the final norm."""
    b, se, _ = frames.shape
    x = frames + layers.sinusoidal_positions(se, cfg.d_model, frames.device).to(frames.dtype)
    positions = _positions(b, se, frames.device)
    for lp in p["encoder"]["layers"]:
        x, _, _ = _layer_forward(lp, cfg, _ENCODER_SPEC, x, positions, mode="train", causal=False)
    return layers.apply_norm(p["encoder"]["final_norm"], x)


def _period_forward(lp, cfg: ModelConfig, x, aux, positions, mode, enc_out=None):
    """One period's layers. Returns (x, aux plus the layers' aux, the
    layers' caches)."""
    cs = []
    for j, spec in enumerate(cfg.period):
        x, a, c = _layer_forward(lp[j], cfg, spec, x, positions, mode=mode, enc_out=enc_out)
        aux = aux if a is None else aux + a
        cs.append(c)
    return x, aux, cs


def _run_stack(p, cfg: ModelConfig, x, positions, mode, enc_out=None):
    """prefix layers + the periods in order. Returns (x, aux, caches).
    enc_out is an input of each checkpointed period body, so that under
    remat the gradient reaches the encoder through every period's
    cross-attention."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    caches: Dict[str, Any] = {}
    if cfg.prefix:
        pc = []
        for lp, spec in zip(p["prefix"], cfg.prefix):
            x, a, c = _layer_forward(lp, cfg, spec, x, positions, mode=mode, enc_out=enc_out)
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
            x, aux, cs = body(_period(p["stack"], i), cfg, x, aux, positions, mode, enc_out)
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
    enc_out = None
    if cfg.encoder_layers:
        if "encoder_frames" not in batch:
            raise ValueError(f"{cfg.name}: an encoder-decoder batch needs encoder_frames "
                             f"(B, Se, d_model) beside its tokens; got {sorted(batch)}")
        enc_out = encode(p, cfg, batch["encoder_frames"])
        tokens = batch["tokens"]
        x = _embed(p, cfg, tokens)
        b, s = tokens.shape
        x = x + p["dec_pos"][:s][None].to(x.dtype)
        positions = _positions(b, s, x.device)
    else:
        x, positions = _embed_inputs(p, cfg, batch)
    x, aux, caches = _run_stack(p, cfg, x, positions, "train" if mode == "features" else mode,
                                enc_out=enc_out)
    x = layers.apply_norm(p["final_norm"], x)
    if mode == "features":
        return x, aux, caches
    if mode == "prefill":
        # only the last position's logits are needed
        x = x[:, -1:]
    logits = layers.lm_logits(
        p.get("lm_head"), x, tied_embed=p["embed"] if cfg.tie_embeddings else None,
        padded_vocab=cfg.padded_vocab,
    )
    return logits, aux, caches


def decode_step(p, cfg: ModelConfig, tokens, caches, pos):
    """One decode step. tokens: (B, 1) int; pos: (B,) write position.
    Updates `caches` in place; returns (logits, caches)."""
    check_supported(cfg)
    x = _embed(p, cfg, tokens)
    if cfg.encoder_layers:
        x = x + p["dec_pos"][pos.long()][:, None].to(x.dtype)
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
        padded_vocab=cfg.padded_vocab,
    )
    return logits, caches


_SEQ_CACHE_KEYS = ("k", "v", "c_kv", "k_rope")


def pad_caches(cfg: ModelConfig, caches, capacity: int, mesh=None):
    """Grow prefill caches (seq axis) to `capacity` with zeros so decode can
    append: attention k / v (B, S, KVH, D) and MLA latents c_kv (B, S, r) /
    k_rope (B, S, dr). Self caches in the period stack carry a leading
    num_periods axis (seq axis 2); prefix-layer caches have it at axis 1.
    A "cross" cache (the encoder's k / v) passes through as it is: decode
    reads every row of it, so a padded zero key would change the result.

    With a mesh whose model axis is wider than 1 the caches are a rank's
    blocks: a leaf laid out over the sequence (its prompt rows, or the
    capacity's under cache_spec_for) is gathered whole over the axis,
    padded, and cut to the rank's block of the padded leaf (its rows
    [r C / m, (r + 1) C / m), or, where the axis does not divide the
    capacity, its heads or columns); other blocks are padded in place."""

    def pad_layer(c, stacked):
        out = {}
        for part, sub in c.items():
            if part == "cross":
                out[part] = sub
                continue
            axis = 2 if stacked else 1
            out[part] = {k: _pad_leaf(cfg, k, v, axis, capacity) if k in _SEQ_CACHE_KEYS else v
                         for k, v in sub.items()}
        return out

    out = {}
    with tp.using(mesh):
        if "prefix" in caches:
            out["prefix"] = [pad_layer(c, stacked=False) for c in caches["prefix"]]
        if "stack" in caches:
            out["stack"] = [pad_layer(c, stacked=True) for c in caches["stack"]]
    return out


def _seq_leaf_widths(cfg: ModelConfig, key: str):
    """A sequence cache leaf's whole widths after its seq axis, and the kv
    heads its layout policy reads (0: a latent cache)."""
    if key in ("k", "v"):
        return (cfg.num_kv_heads, cfg.head_dim), cfg.num_kv_heads
    if key == "c_kv":
        return (cfg.mla.kv_lora_rank,), 0
    return (cfg.mla.qk_rope_head_dim,), 0


def _pad_seq(t, axis: int, capacity: int):
    pad = [0, 0] * (t.dim() - axis - 1) + [0, capacity - t.shape[axis]]
    return torch.nn.functional.pad(t, pad)


def _pad_leaf(cfg: ModelConfig, key: str, t, axis: int, capacity: int):
    """One leaf (a rank's block on an active model axis) padded to
    `capacity` rows along `axis` (see pad_caches)."""
    whole, kv = _seq_leaf_widths(cfg, key)
    before = attention.cache_model_dim(t.shape[axis - 1:], whole, kv)  # the block's
    if before is None:
        return _pad_seq(t, axis, capacity)
    before += axis - 1
    after = tp.cache_dim(key, t.shape[:axis] + (capacity,) + whole, stacked=axis == 2)
    if before == after != axis:  # the same heads or columns: pad the block in place
        return _pad_seq(t, axis, capacity)
    t = _pad_seq(tp.gather_from_model(t, before), axis, capacity)
    return tp.cache_block(t, key, stacked=axis == 2)


def cache_specs(cfg: ModelConfig, batch: int, seq: int, enc_seq: int = 4096, mesh=None):
    """TensorSpec pytree of a decode cache of capacity `seq`; `enc_seq` sizes
    an encoder-decoder arch's static cross cache (the encoder's length).
    With a mesh, a rank's blocks (sharding.cache_spec_for's layouts: the
    batch over the batch axes, the kv heads over "model")."""
    check_supported(cfg)
    dtype = _dtype_of(cfg)

    def spec_for(layer_spec):
        s = _layer_cache_spec(cfg, layer_spec, batch, seq, dtype)
        if cfg.encoder_layers:
            sd = TensorSpec((batch, enc_seq, cfg.num_kv_heads, cfg.head_dim), dtype)
            s["cross"] = {"k": sd, "v": sd}
        return s

    out: Dict[str, Any] = {}
    if cfg.prefix:
        out["prefix"] = [spec_for(spec) for spec in cfg.prefix]
    if cfg.num_periods > 0:
        per = [spec_for(spec) for spec in cfg.period]
        out["stack"] = [
            {part: {k: TensorSpec((cfg.num_periods,) + s.shape, s.dtype) for k, s in sub.items()}
             for part, sub in layer.items()}
            for layer in per
        ]
    if mesh is None:
        return out
    flat = [TensorSpec(tp.block_shape(s.shape, shd.cache_spec_for(path_str(path), s, mesh), mesh),
                       s.dtype)
            for path, s in leaves_with_path(out)]
    return unflatten(out, flat)
