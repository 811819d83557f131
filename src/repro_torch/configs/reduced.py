"""Reduced (smoke-test) variants of every architecture: same family and
block structure, tiny dims — one period of layers, small width, few experts,
tiny vocab. Full configs are only ever lowered via the dry-run
(ShapeDtypeStruct, no allocation)."""

from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig


def reduce_config(
    cfg: ModelConfig,
    d_model: int = 64,
    n_heads: int = 4,
    vocab: int = 512,
    periods: int = 1,
) -> ModelConfig:
    """Shrink a config for CPU smoke tests, preserving its structure."""
    head_dim = max(8, d_model // n_heads)
    if cfg.head_dim > cfg.d_model // cfg.num_heads:
        head_dim = 2 * d_model // n_heads  # gemma-style oversized heads
    kv_heads = min(cfg.num_kv_heads, n_heads)
    if cfg.num_kv_heads == cfg.num_heads:
        kv_heads = n_heads  # preserve MHA

    changes = dict(
        d_model=d_model,
        num_heads=n_heads,
        num_kv_heads=kv_heads,
        head_dim=head_dim,
        d_ff=4 * d_model if cfg.d_ff else 0,
        vocab_size=vocab,
        vocab_pad_multiple=64,
        num_layers=len(cfg.prefix) + periods * len(cfg.period),
        remat=False,
    )
    if cfg.encoder_layers:
        changes["encoder_layers"] = 2
        changes["max_position_embeddings"] = 64
    if cfg.moe is not None:
        top_k = min(cfg.moe.top_k, 2)
        changes["moe"] = dataclasses.replace(
            cfg.moe,
            num_experts=8,
            top_k=top_k,
            d_ff_expert=2 * d_model,
            num_shared=min(cfg.moe.num_shared, 1),
            router_chunk=16,
            # dropless capacity so decode == train routing exactly (tests)
            capacity_factor=8.0 / top_k,
        )
    if cfg.mla is not None:
        changes["mla"] = dataclasses.replace(
            cfg.mla,
            kv_lora_rank=32,
            qk_nope_head_dim=16,
            qk_rope_head_dim=8,
            v_head_dim=16,
        )
    if cfg.mamba is not None:
        changes["mamba"] = dataclasses.replace(cfg.mamba, d_state=8, chunk=8)
    if cfg.sliding_window:
        changes["sliding_window"] = 16
    changes["name"] = cfg.name + "-reduced"
    changes["dtype"] = "float32"

    reduced = dataclasses.replace(cfg, **changes)
    return reduced
