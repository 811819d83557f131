"""Public model API: build_model(cfg) -> Model with init / loss_fn / forward /
prefill / decode_step / cache_specs, make_input_specs for the train, prefill
and decode shape cells, and concrete_batch.

The counterpart of the reference's models/model.py (see
models/transformer.py for the layers the port runs). `init` draws from
an explicit torch.Generator; parameters and caches live on `device`
("cuda" by default; raises without a card unless device="cpu").
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeCell
from repro_torch.device import resolve_device
from repro_torch.models import layers, transformer
from repro_torch.models.transformer import TensorSpec


class Model(NamedTuple):
    cfg: ModelConfig
    init: Callable  # (seed or generator) -> params
    loss_fn: Callable  # (params, batch) -> (loss, metrics)
    forward: Callable  # (params, batch) -> logits
    prefill: Callable  # (params, batch) -> (last_logits, caches)
    decode_step: Callable  # (params, tokens, caches, pos) -> (logits, caches)
    input_specs: Callable  # (cell) -> batch pytree of TensorSpec
    cache_specs: Callable  # (batch, seq) -> cache pytree of TensorSpec


def build_model(cfg: ModelConfig, device=None) -> Model:
    """The model's functions for `cfg` on `device`. Raises
    NotImplementedError for layers the port does not run yet."""
    transformer.check_supported(cfg)
    dev = resolve_device(device)

    def init(generator):
        """Parameters on `device` from a torch.Generator, or from an int seed
        (a generator on `device`, seeded with it)."""
        if isinstance(generator, int):
            generator = torch.Generator(device=dev).manual_seed(generator)
        params = transformer.init_params(cfg, generator)
        return transformer.tree_map(lambda t: t.to(dev), params)

    def forward(params, batch):
        logits, _, _ = transformer.forward_logits(params, cfg, batch, mode="train")
        return logits

    def loss_fn(params, batch):
        """(loss, {"ce", "aux"}): the sequence-chunked CE of the features
        against batch["labels"] under batch["loss_mask"] (if any), plus the
        MoE aux loss at its weight (0 for the dense family)."""
        feats, aux, _ = transformer.forward_logits(params, cfg, batch, mode="features")
        w = params["embed"]["embed"].T if cfg.tie_embeddings else params["lm_head"]["kernel"]
        ce = layers.cross_entropy_from_features(
            feats, w, batch["labels"], cfg.vocab_size, batch.get("loss_mask")
        )
        aux_w = cfg.moe.aux_loss_weight if cfg.moe else 0.0
        return ce + aux_w * aux, {"ce": ce, "aux": aux}

    def prefill(params, batch):
        logits, _, caches = transformer.forward_logits(params, cfg, batch, mode="prefill")
        return logits[:, -1:], caches

    def decode_step(params, tokens, caches, pos):
        return transformer.decode_step(params, cfg, tokens, caches, pos)

    def input_specs(cell: ShapeCell) -> Dict[str, Any]:
        return make_input_specs(cfg, cell)

    def cache_specs(batch, seq):
        return transformer.cache_specs(cfg, batch, seq)

    return Model(cfg, init, loss_fn, forward, prefill, decode_step, input_specs, cache_specs)


def make_input_specs(cfg: ModelConfig, cell: ShapeCell):
    """Batch pytree (TensorSpecs) for one (arch x shape) cell: train carries
    tokens, labels and an f32 loss mask, prefill the full token sequence,
    decode one token + cache + per-sequence positions."""
    b, s = cell.global_batch, cell.seq_len
    tok = lambda *shape: TensorSpec(shape, torch.int32)  # noqa: E731
    if cell.kind == "train":
        return {"tokens": tok(b, s), "labels": tok(b, s),
                "loss_mask": TensorSpec((b, s), torch.float32)}
    if cell.kind == "prefill":
        return {"tokens": tok(b, s)}
    if cell.kind == "decode":
        return {
            "tokens": tok(b, 1),
            "caches": transformer.cache_specs(cfg, b, s),
            "pos": tok(b),
        }
    raise ValueError(cell.kind)


def concrete_batch(cfg: ModelConfig, cell: ShapeCell, generator: torch.Generator):
    """A random batch matching make_input_specs, on the generator's device
    (smoke tests only): int leaves uniform in [0, vocab), float leaves
    0.02 x normal; the loss mask all ones, decode positions seq_len - 1. It
    draws from a torch.Generator, so its numbers are not the reference's
    (which draws from a jax key)."""
    dev = generator.device

    def mk(spec):
        if not isinstance(spec, TensorSpec):
            return {k: mk(v) for k, v in spec.items()} if isinstance(spec, dict) else [
                mk(v) for v in spec]
        if spec.dtype == torch.int32:
            return torch.randint(0, max(cfg.vocab_size, 2), spec.shape, generator=generator,
                                 device=dev, dtype=torch.int32)
        return 0.02 * torch.randn(spec.shape, generator=generator, device=dev,
                                  dtype=torch.float32).to(spec.dtype)

    batch = mk(make_input_specs(cfg, cell))
    if "loss_mask" in batch:
        batch["loss_mask"] = torch.ones_like(batch["loss_mask"])
    if "pos" in batch:
        batch["pos"] = torch.full(batch["pos"].shape, cell.seq_len - 1, dtype=torch.int32,
                                  device=dev)
    return batch
