"""Mixture-of-Experts channel mixer: shared + routed top-k experts.

The counterpart of the reference's models/moe.py. Dispatch is
token-chunked and capacity-based (einsum dispatch over chunks of
`router_chunk` tokens, so the one-hot dispatch tensor is (chunk, E, C), not
(B*S, E, C)). Tokens beyond an expert's per-chunk capacity are dropped
(contribute zero); the auxiliary load-balance loss pushes the router away
from that regime. Where the reference scans the chunks with lax.scan, the
port runs them in order in a Python loop, then the remainder chunk with its
own, smaller capacity.

What the port keeps, op for op:
  - the router in f32 (f32-cast operands; full f32 on the card: TF32 off);
  - jax.lax.top_k's order: the k largest probabilities, equal values lowest
    expert first. torch.topk orders ties otherwise (on the CPU too), so the
    port takes the first k of a stable descending sort;
  - capacity positions from the exclusive cumsum over the token-major
    (T*K, E) flattening of the one-hot choices: earlier tokens, and for one
    token lower k, win an expert's slots;
  - the dispatch and combine tensors and the four expert products in x's
    dtype, the router probabilities cast to it before they are scattered.

Capacity couples the tokens of a chunk: at a decode step the chunk is the
whole slot batch, so a row can lose an expert to an earlier row (see
serve/engine.py).

Expert weights are (E, d_in, d_out). On a model axis (distributed/
tensor_parallel.py) a rank holds the experts of its block (the leading dim
over "model") or, where the axis does not divide the experts, every
expert's block of d_ff columns (sharding.param_specs' fallback). The router
is replicated, so every rank routes every token alike (the aux loss too);
the routed weights enter the rank's region through copy_to_model, so the
router's gradient is whole on every rank. A rank computes its experts' slots
(or its d_ff columns of every slot), the shared expert column then row
parallel, and one reduce_from_model of their summed partials combines the
ranks.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.device import require_full_f32_matmul
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.models import layers


def make_moe(generator, cfg: ModelConfig, dtype):
    """Router (f32), routed experts (E, d, f) / (E, f, d) in `dtype`, and
    with num_shared a SwiGLU `f * num_shared` wide, at the reference's
    scales."""
    moe = cfg.moe
    d, f, e = cfg.d_model, moe.d_ff_expert, moe.num_experts
    scale_in = d**-0.5
    scale_out = f**-0.5 / (2.0 * cfg.num_layers) ** 0.5
    p = {
        "router": layers.make_dense(generator, d, e, torch.float32),
        "w_gate": layers._normal(generator, (e, d, f), scale_in, dtype),
        "w_in": layers._normal(generator, (e, d, f), scale_in, dtype),
        "w_out": layers._normal(generator, (e, f, d), scale_out, dtype),
    }
    if moe.num_shared:
        p["shared"] = layers.make_mlp(
            generator, d, f * moe.num_shared, "swiglu", dtype, out_scale=scale_out
        )
    return p


class Routing(NamedTuple):
    """One chunk's routing: probs (T, E) f32, top_p (T, K) renormalised,
    top_e (T, K) expert ids, pos (T, K) slot within the expert, keep (T, K)
    pos < cap, cap the chunk's capacity."""

    probs: torch.Tensor
    top_p: torch.Tensor
    top_e: torch.Tensor
    pos: torch.Tensor
    keep: torch.Tensor
    cap: int


def route(p, moe, x) -> Routing:
    """Top-k routing and capacity positions for one token chunk x (T, D)."""
    t = x.shape[0]
    e, k = moe.num_experts, moe.top_k
    cap = max(1, int(math.ceil(t * k / e * moe.capacity_factor)))
    if x.device.type == "cuda":
        require_full_f32_matmul()
    logits = x.float() @ p["router"]["kernel"]
    if "bias" in p["router"]:
        logits = logits + p["router"]["bias"]
    probs = torch.softmax(logits, dim=-1)
    # lax.top_k's order: a stable descending sort puts equal values lowest
    # index first
    top_e = torch.sort(probs, dim=-1, descending=True, stable=True).indices[:, :k]
    return assign(probs, top_e, cap)


def assign(probs, top_e, cap: int) -> Routing:
    """The routing of a chunk whose tokens go to the experts top_e (T, K):
    their probs renormalised and their capacity positions."""
    t, k = top_e.shape
    e = probs.shape[-1]
    top_p = torch.gather(probs, 1, top_e)
    top_p = top_p / top_p.sum(dim=-1, keepdim=True)
    flat = _one_hot(top_e, e).reshape(t * k, e)
    pos_in_e = torch.cumsum(flat, dim=0) - flat  # exclusive, token-major
    pos = (pos_in_e * flat).sum(dim=-1).reshape(t, k)
    return Routing(probs, top_p, top_e, pos, pos < cap, cap)


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """F.one_hot(idx, n) (int64) as the zeros and scatter_ it runs on the
    card, on every device: F.one_hot takes another decomposition on fake
    tensors, so a dry run (launch/dryrun.py) would count other bytes than
    the real step moves. idx is in range by construction (top-k indices,
    capacity positions), so F.one_hot's host-side range check on the CPU
    has nothing to catch."""
    out = torch.zeros((*idx.shape, n), dtype=torch.int64, device=idx.device)
    return out.scatter_(-1, idx.unsqueeze(-1), 1)


def _route_chunk(p, moe, x, xm):
    """Routing, capacity dispatch, the experts and combine for one chunk
    x (T, D) (xm: x after copy_to_model, what the experts read). Returns
    (y (T, D), aux): y the rank's partial on a model axis."""
    e = moe.num_experts
    r = route(p, moe, x)
    cap, dt = r.cap, x.dtype
    local = p["w_gate"].shape[0]  # the rank's experts (all of them under the d_ff layout)
    onehot = _one_hot(r.top_e, e).to(dt)  # (T, K, E)
    if local < e:
        onehot = onehot[..., tp.rank() * local:(tp.rank() + 1) * local]
    slot = _one_hot(torch.where(r.keep, r.pos, cap), cap + 1).to(dt)  # (T, K, C+1)
    disp = (onehot[..., None] * slot[..., None, :])[..., :cap].sum(dim=1)  # (T, E, C)
    top_p = tp.copy_to_model(r.top_p)
    comb = disp * torch.einsum("tk,tke->te", top_p.to(dt), onehot)[..., None]

    xe = torch.einsum("tec,td->ecd", disp, xm)  # (E, C, D)
    h = F.silu(torch.einsum("ecd,edf->ecf", xe, p["w_gate"])) * torch.einsum(
        "ecd,edf->ecf", xe, p["w_in"]
    )
    ye = torch.einsum("ecf,efd->ecd", h, p["w_out"])
    y = torch.einsum("tec,ecd->td", comb, ye)

    # switch-style aux loss: E * sum_e frac_e * prob_e, frac over the top-1
    frac = _one_hot(r.top_e[:, 0], e).float().mean(dim=0)
    aux = e * (frac * r.probs.mean(dim=0)).sum()
    return y, aux


def apply_moe(p, cfg: ModelConfig, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (y, aux). Tokens are flattened over (B*S) and routed
    in chunks of min(router_chunk, B*S), then a remainder chunk; aux is the
    mean over every chunk, the remainder's included."""
    moe = cfg.moe
    b, s, d = x.shape
    flat = x.reshape(b * s, d)
    flat_m = tp.copy_to_model(flat)
    chunk = min(moe.router_chunk, b * s)
    n = flat.shape[0] // chunk
    ys = []
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(n):
        part = slice(i * chunk, (i + 1) * chunk)
        y, a = _route_chunk(p, moe, flat[part], flat_m[part])
        ys.append(y)
        aux = aux + a
    if flat.shape[0] > n * chunk:
        y, a = _route_chunk(p, moe, flat[n * chunk:], flat_m[n * chunk:])
        ys.append(y)
        aux = aux + a
        n += 1
    y = torch.cat(ys, dim=0).reshape(b, s, d)
    if moe.num_shared:
        y = y + layers.apply_mlp(p["shared"], x, "swiglu", reduce=False)
    return tp.reduce_from_model(y), aux / max(n, 1)
