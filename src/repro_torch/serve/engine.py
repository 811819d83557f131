"""Continuous-batching serving engine for the LM substrate.

The counterpart of the reference's serve/engine.py: vLLM-style slot
scheduling on top of the model's prefill/decode steps. A fixed decode batch
of `num_slots` sequences; whenever a sequence finishes (max tokens here),
its slot is refilled by prefilling the next queued request and SPLICING its
KV cache into the batched cache at that slot, so decode never stalls on
stragglers. Idle slots decode too (at position 0, against stale rows that
the kv_len mask hides) and are ignored.

Splicing is an in-place copy_ of the prompt's L rows into rows [0, L) of
the slot in the batched cache. The reference pads the prefill cache to
capacity first and its _splice_cache returns a new cache; here rows past L
keep what the slot's previous request left there, which decode overwrites
(row pos) before the kv_len mask lets it be read.

Contract (tested): a request's greedy continuation agrees with running it
alone through prefill + decode. On the CPU in f32 that holds to a stated
logit margin (a batch of one and a batch of num_slots may sum in another
order); the reference's bit-identical contract rests on XLA-CPU reduction
order.

Under capacity routing (an MoE layer whose capacity factor can drop tokens,
such as qwen2-moe's 1.25), decode rows are coupled, in both packages. A
decode step's router chunk is the whole slot batch, so at 4 slots, top-4 of
60 experts, an expert holds ceil(4 * 4 / 60 * 1.25) = 1 token, and a row
loses an expert's output to any earlier row that chose the same expert.
Idle slots decode too, so they take capacity as well. That is the
reference's behaviour and the port keeps it (no row is masked from the
router); a request's tokens then agree with it run alone only where no
drop moved them, and the contract above holds for a dropless config.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import build_model, transformer


@dataclasses.dataclass
class Request:
    rid: int
    prompt: torch.Tensor  # (L,) int token ids
    max_new: int


@dataclasses.dataclass
class _Slot:
    rid: Optional[int] = None
    pos: int = 0  # next write position in the cache
    remaining: int = 0
    out: Optional[List[int]] = None


@dataclasses.dataclass
class EngineStats:
    """Work and host time of the prefill and decode phases of `run` (each
    phase ends in a device-to-host read of the chosen tokens, so the host
    clock covers the device work)."""

    prefills: int = 0
    prefill_tokens: int = 0
    prefill_seconds: float = 0.0
    decode_steps: int = 0
    decode_tokens: int = 0  # tokens of occupied slots
    decode_seconds: float = 0.0


def _splice_cache(batch_cache, seq_cache, slot: int):
    """Copy a single-sequence prefill cache into rows [0, L) of slot `slot`
    of the batched cache, in place.

    src and dst differ on the batch axis (axis 0 for prefix-layer caches,
    axis 1 for period-stacked caches; src has size 1 there, dst has
    num_slots >= 2, enforced by Engine) and on the sequence axis just after
    it (src has the prompt's L <= capacity rows); every other axis agrees."""

    def put(dst, src):
        b_axis = next(
            (i for i in range(dst.dim()) if src.shape[i] == 1 and dst.shape[i] != 1), None
        )
        ok = b_axis is not None and b_axis + 1 < dst.dim()
        ok = ok and src.shape[b_axis + 1] <= dst.shape[b_axis + 1] and all(
            s == d for i, (s, d) in enumerate(zip(src.shape, dst.shape))
            if i not in (b_axis, b_axis + 1)
        )
        if not ok:
            raise ValueError(f"cannot splice {tuple(src.shape)} into {tuple(dst.shape)}")
        dst.narrow(b_axis, slot, 1).narrow(b_axis + 1, 0, src.shape[b_axis + 1]).copy_(src)

    def walk(dst, src):
        if isinstance(dst, dict):
            for k in dst:
                walk(dst[k], src[k])
        elif isinstance(dst, list):
            for d, s in zip(dst, src):
                walk(d, s)
        else:
            put(dst, src)

    walk(batch_cache, seq_cache)
    return batch_cache


class Engine:
    def __init__(self, cfg: ModelConfig, params, num_slots: int, capacity: int, device=None):
        if num_slots < 2:
            raise ValueError("splice axis detection needs num_slots >= 2")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = build_model(cfg, device=self.device)
        self.params = params
        self.num_slots = num_slots
        self.capacity = capacity
        self.slots = [_Slot() for _ in range(num_slots)]
        # batched cache template: zeros at full capacity
        spec = self.model.cache_specs(num_slots, capacity)
        self.caches = transformer.tree_map(
            lambda s: torch.zeros(s.shape, dtype=s.dtype, device=self.device), spec
        )
        self.next_tokens = torch.zeros((num_slots, 1), dtype=torch.long, device=self.device)
        self.results: Dict[int, List[int]] = {}
        self.stats = EngineStats()

    def _admit(self, req: Request, slot_idx: int):
        """Prefill one request and splice it into `slot_idx`."""
        t0 = time.perf_counter()
        prompt = torch.as_tensor(req.prompt, dtype=torch.long, device=self.device)
        last, seq_cache = self.model.prefill(self.params, {"tokens": prompt[None]})
        _splice_cache(self.caches, seq_cache, slot_idx)
        tok = int(torch.argmax(last[0, -1, : self.cfg.vocab_size]))
        self.stats.prefills += 1
        self.stats.prefill_tokens += int(prompt.shape[0])
        self.stats.prefill_seconds += time.perf_counter() - t0
        s = self.slots[slot_idx]
        s.rid, s.pos = req.rid, int(prompt.shape[0])
        s.remaining, s.out = req.max_new - 1, [tok]
        self.next_tokens[slot_idx, 0] = tok
        if s.remaining == 0:
            self._finish(slot_idx)

    def _finish(self, slot_idx: int):
        s = self.slots[slot_idx]
        self.results[s.rid] = s.out
        self.slots[slot_idx] = _Slot()

    def run(self, requests: List[Request]) -> Dict[int, List[int]]:
        """Serve all requests to completion; returns rid -> generated ids."""
        queue = list(requests)
        while queue or any(s.rid is not None for s in self.slots):
            # admit into free slots
            for i, s in enumerate(self.slots):
                if s.rid is None and queue:
                    self._admit(queue.pop(0), i)
            if not any(s.rid is not None for s in self.slots):
                continue
            # one lock-step decode over all slots (idle slots compute and
            # are ignored: the continuous-batching trade)
            t0 = time.perf_counter()
            pos = torch.tensor([s.pos for s in self.slots], dtype=torch.long, device=self.device)
            logits, self.caches = self.model.decode_step(
                self.params, self.next_tokens, self.caches, pos
            )
            toks = torch.argmax(logits[:, -1, : self.cfg.vocab_size], dim=-1)
            self.next_tokens = toks[:, None]
            toks = toks.tolist()
            self.stats.decode_steps += 1
            self.stats.decode_tokens += sum(s.rid is not None for s in self.slots)
            self.stats.decode_seconds += time.perf_counter() - t0
            for i, s in enumerate(self.slots):
                if s.rid is None:
                    continue
                s.out.append(toks[i])
                s.pos += 1
                s.remaining -= 1
                if s.remaining <= 0:
                    self._finish(i)
        return self.results
