"""Step functions: train_step (loss, gradients, optimizer update,
microbatched) and the serve steps (prefill / decode).

The counterpart of the reference's launch/steps.py. Parameters stay the
port's tree of tensors (transformer.init_params's nested dicts and lists);
a train step flattens its leaves in jax's order, sets requires_grad on
them, takes torch.autograd.grad of the loss, clears requires_grad, and
applies the update in place under torch.no_grad(). With `cfg.remat` the
forward keeps only each period's input (models/transformer.py). The
attention of a step always runs the einsum path: the flash kernel has no
backward (models/attention.py), as the reference's model never reaches its
Pallas kernel in training.

With a mesh whose "model" axis is wider than 1 (distributed/
tensor_parallel.py) the steps run on a rank's blocks with the axis active
for the whole step (forward, backward, norm, compression and update), and
the optimizer is told which leaves are split (`model_dims`); the decode
step's greedy token is the argmax over every rank's vocab block.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import torch

from repro_torch import tree
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding as shd
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.models import build_model, transformer
from repro_torch.optim import optimizer as opt_mod


def make_train_step(
    cfg: ModelConfig,
    optimizer: Optional[str] = None,
    microbatch: int = 0,
    grad_compression: str = "none",
    lr: float = 3e-4,
    warmup: int = 200,
    total_steps: int = 10_000,
    device=None,
    grad_sync: Optional[Callable] = None,
    mesh=None,
):
    """Returns (train_step, opt, model) on `device` ("cuda" by default;
    raises without a card unless device="cpu").

    train_step(params, opt_state, batch, step) -> (params, opt_state,
    metrics): params and opt_state are updated in place and returned;
    metrics holds the loss and the grad norm as 0-d tensors.

    microbatch > 0 (and below the batch) splits the batch into batch //
    microbatch chunks, one backward each, and takes the mean of their
    losses and of their f32 gradients, as the reference's lax.scan does; a
    batch that microbatch does not divide raises ValueError (the reference's
    reshape fails on it).
    grad_sync(loss, grads, batch) -> (loss, grads), when given, runs between
    the backward and the compression: the data-parallel reduction
    (train_loop.DataParallel.sync) turns a rank's local loss and gradients
    into the global batch's.
    mesh: on a model axis wider than 1, params and opt_state are the rank's
    blocks (build_model(cfg, device, mesh).init, or shard_params of whole
    leaves) and the step computes the rank's share.
    """
    model = build_model(cfg, device, mesh)
    dims = model_dims(cfg, mesh)
    optimizer = optimizer or default_optimizer(cfg)
    lr_fn = functools.partial(opt_mod.cosine_schedule, base_lr=lr, warmup=warmup, total=total_steps)
    opt = opt_mod.make_optimizer(optimizer, cfg, lr_fn=lr_fn)
    compress = opt_mod.make_compressor(grad_compression)

    def compute_grads(params, batch):
        b = _batch_size(batch)
        if microbatch and microbatch < b:
            if b % microbatch:
                raise ValueError(f"a batch of {b} rows is not a multiple of microbatch {microbatch}")
            n = b // microbatch
            acc_g = tree.tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                        device=p.device), params)
            acc_l = torch.zeros((), dtype=torch.float32, device=tree.leaves(params)[0].device)
            for i in range(n):
                mb = {k: v[i * microbatch:(i + 1) * microbatch] for k, v in batch.items()}
                loss, g = loss_and_grads(model, params, mb)
                acc_g = tree.tree_map(lambda a, x: a + x, acc_g, g)
                acc_l = acc_l + loss
            return acc_l / n, tree.tree_map(lambda x: x / n, acc_g)
        return loss_and_grads(model, params, batch)

    def train_step(params, opt_state, batch, step):
        with tp.using(mesh):
            loss, grads = compute_grads(params, batch)
            if grad_sync is not None:
                loss, grads = grad_sync(loss, grads, batch)
            grads = compress(grads, dims)
            gnorm = opt_mod.global_norm(grads, dims)
            grads = opt_mod.clip_by_global_norm(grads, 1.0, gnorm)
            params, opt_state = opt.update(params, grads, opt_state, step, dims)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}

    return train_step, opt, model


def model_dims(cfg: ModelConfig, mesh):
    """Per parameter leaf (jax's order) the dim its block splits over an
    active model axis, or None; None for the whole list without one."""
    if tp.axis_of(mesh) is None:
        return None
    specs = shd.param_specs(mesh, transformer.param_template(cfg))
    return [tp.model_dim(s) for s in tree.leaves(specs)]


def loss_and_grads(model, params, batch):
    """(loss, gradient tree) of model.loss_fn at params: the leaves get
    requires_grad for the call only, the gradients come from
    torch.autograd.grad (zeros for a leaf the loss does not reach)."""
    leaves = tree.leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    try:
        with torch.enable_grad():
            loss, _ = model.loss_fn(params, batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    finally:
        for t in leaves:
            t.requires_grad_(False)
    grads = [torch.zeros_like(t) if g is None else g for t, g in zip(leaves, grads)]
    return loss.detach(), tree.unflatten(params, grads)


def default_optimizer(cfg: ModelConfig) -> str:
    """Adafactor from 90B parameters (factored states; the reference's rule,
    sized for its TPU pod), AdamW otherwise."""
    return "adafactor" if cfg.param_count() >= 90e9 else "adamw"


def _batch_size(batch) -> int:
    return tree.leaves(batch)[0].shape[0]


def make_serve_steps(cfg: ModelConfig, device=None, mesh=None):
    """(prefill_step, decode_step) closures over the model on `device` (on
    a rank's blocks with a mesh: the logits they return are the rank's
    vocab block, the caches its blocks)."""
    model = build_model(cfg, device, mesh)

    def prefill_step(params, batch):
        last_logits, caches = model.prefill(params, batch)
        return last_logits, caches

    def decode_step(params, batch):
        logits, caches = model.decode_step(params, batch["tokens"], batch["caches"], batch["pos"])
        last = logits[:, -1]
        with tp.using(mesh):
            if last.shape[-1] < cfg.padded_vocab:  # the rank's vocab block
                next_tok = tp.argmax_over_model(last)
            else:
                next_tok = torch.argmax(last, dim=-1)
        return next_tok.to(torch.int32), logits, caches  # greedy

    return prefill_step, decode_step
