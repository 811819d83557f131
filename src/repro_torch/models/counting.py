"""Analytic parameter / FLOP counting per config: a hardware-neutral copy of
the reference's models/counting.py (MODEL_FLOPS = 6*N*D dense / 6*N_active*D
MoE), used by chip_smoke.py for bounds and checked against the reference."""

from __future__ import annotations

from repro_torch.configs.base import LayerSpec, ModelConfig


def _attn_params(cfg: ModelConfig) -> int:
    d, h, kvh, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    n = d * h * hd + 2 * d * kvh * hd + h * hd * d
    if cfg.attn_bias or cfg.qkv_bias:
        n += h * hd + 2 * kvh * hd
    if cfg.attn_bias:
        n += d
    return n


def _mla_params(cfg: ModelConfig) -> int:
    mla = cfg.mla
    d, h = cfg.d_model, cfg.num_heads
    r, dn, dr, dv = (
        mla.kv_lora_rank,
        mla.qk_nope_head_dim,
        mla.qk_rope_head_dim,
        mla.v_head_dim,
    )
    return d * h * (dn + dr) + d * (r + dr) + r + r * h * dn + r * h * dv + h * dv * d


def _mlp_params(cfg: ModelConfig, d_ff: int) -> int:
    mats = 3 if cfg.mlp_type in ("swiglu", "geglu") else 2
    return mats * cfg.d_model * d_ff


def _moe_params(cfg: ModelConfig, active_only: bool) -> int:
    moe = cfg.moe
    d, f = cfg.d_model, moe.d_ff_expert
    router = d * moe.num_experts
    shared = moe.num_shared * 3 * d * f
    experts = (moe.top_k if active_only else moe.num_experts) * 3 * d * f
    return router + shared + experts


def _mamba_params(cfg: ModelConfig) -> int:
    mc = cfg.mamba
    d = cfg.d_model
    di = mc.expand * d
    dtr = mc.dt_rank or -(-d // 16)
    ds = mc.d_state
    return (
        d * 2 * di  # in_proj
        + mc.d_conv * di + di  # conv
        + di * (dtr + 2 * ds)  # x_proj
        + dtr * di + di  # dt_proj
        + di * ds  # a_log
        + di  # d_skip
        + dtr + 2 * ds  # norms
        + di * d  # out_proj
    )


def _mlstm_params(cfg: ModelConfig) -> int:
    xc = cfg.xlstm
    d = cfg.d_model
    di = int(xc.mlstm_proj_factor * d)
    h = cfg.num_heads
    return d * 2 * di + xc.conv_kernel * di + di + 3 * di * di + di * 2 * h + di * d


def _slstm_params(cfg: ModelConfig) -> int:
    xc = cfg.xlstm
    d = cfg.d_model
    h, dh = cfg.num_heads, d // cfg.num_heads
    df = int(xc.slstm_proj_factor * d)
    return d * 4 * d + 4 * h * dh * dh + 4 * d + 2 * d * df + df * d


def _layer_params(cfg: ModelConfig, spec: LayerSpec, active_only: bool) -> int:
    n = 0
    if spec.mixer in ("attn", "swa"):
        n += _attn_params(cfg)
    elif spec.mixer == "mla":
        n += _mla_params(cfg)
    elif spec.mixer == "mamba":
        n += _mamba_params(cfg)
    elif spec.mixer == "mlstm":
        n += _mlstm_params(cfg)
    elif spec.mixer == "slstm":
        n += _slstm_params(cfg)
    if spec.mlp == "mlp":
        n += _mlp_params(cfg, cfg.d_ff)
    elif spec.mlp == "moe":
        n += _moe_params(cfg, active_only)
    # norms (approximate: 2 per layer)
    n += 2 * cfg.d_model
    return n


def count_params(cfg: ModelConfig, active_only: bool = False) -> int:
    n = cfg.padded_vocab * cfg.d_model  # embeddings
    if not cfg.tie_embeddings:
        n += cfg.padded_vocab * cfg.d_model
    for spec in cfg.layer_kinds():
        n += _layer_params(cfg, spec, active_only)
    if cfg.encoder_layers:
        for _ in range(cfg.encoder_layers):
            n += _attn_params(cfg) + _mlp_params(cfg, cfg.d_ff) + 2 * cfg.d_model
        # decoder cross-attention + learned decoder positions
        n += cfg.num_layers * (_attn_params(cfg) + cfg.d_model)
        n += cfg.max_position_embeddings * cfg.d_model
    return n


def train_step_flops(cfg: ModelConfig, batch: int, seq: int) -> float:
    """MODEL_FLOPS: 6*N*D with N = active params (fwd 2ND + bwd 4ND)."""
    return 6.0 * cfg.active_param_count() * batch * seq


def decode_step_flops(cfg: ModelConfig, batch: int, context: int) -> float:
    """Per-token decode: 2*N_active matmul flops + attention-cache reads.

    Attention score/value FLOPs: 4 * d_head * heads * context per attn layer.
    """
    flops = 2.0 * cfg.active_param_count() * batch
    attn_layers = sum(1 for s in cfg.layer_kinds() if s.mixer in ("attn", "swa", "mla"))
    window = cfg.sliding_window or 0
    eff_ctx = min(context, window) if window else context
    flops += 4.0 * cfg.num_heads * cfg.head_dim * eff_ctx * attn_layers * batch
    return flops
