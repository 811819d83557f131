"""Public model API: build_model(cfg) -> Model with init / forward / prefill /
decode_step / cache_specs, and make_input_specs for the prefill and decode
shape cells.

The counterpart of the reference's models/model.py for the dense attention
family (see models/transformer.py for what the port runs). `init` draws from
an explicit torch.Generator; parameters and caches live on `device`
("cuda" by default; raises without a card unless device="cpu").
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeCell
from repro_torch.device import resolve_device
from repro_torch.models import transformer
from repro_torch.models.transformer import TensorSpec


class Model(NamedTuple):
    cfg: ModelConfig
    init: Callable  # (seed or generator) -> params
    loss_fn: Callable  # (params, batch) -> (loss, metrics); training slice
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
        raise NotImplementedError(
            "loss_fn and the cross-entropy functions: the training slice, ROADMAP queue 1 item 13b"
        )

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
    """Batch pytree (TensorSpecs) for one (arch x shape) cell: prefill
    carries the full token sequence, decode one token + cache + per-sequence
    positions."""
    b, s = cell.global_batch, cell.seq_len
    tok = lambda *shape: TensorSpec(shape, torch.int32)  # noqa: E731
    if cell.kind == "prefill":
        return {"tokens": tok(b, s)}
    if cell.kind == "decode":
        return {
            "tokens": tok(b, 1),
            "caches": transformer.cache_specs(cfg, b, s),
            "pos": tok(b),
        }
    if cell.kind == "train":
        raise NotImplementedError("train input specs: the training slice, ROADMAP queue 1 item 13b")
    raise ValueError(cell.kind)
