"""Deterministic synthetic data pipeline (the reference's data/pipeline.py).

Index-based and stateless by construction: batch `i` is a pure function of
(seed, i), so any rank can materialize any shard (a replacement resumes
mid-epoch from the step counter), checkpoints store only (seed, step), and
a restart with another rank count re-partitions cleanly.

The token stream is a mixture of Zipf-distributed unigrams and repeated
n-gram motifs, enough structure that CE demonstrably falls. `DataConfig` and
`SyntheticTokens` are copies of the reference's: numpy on the host, the same
bytes from the same seed and step. `to_device` (the reference's
`shard_batch`) moves a host batch, or this rank's slice of it, to a device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2
    motif_len: int = 16
    motif_prob: float = 0.35


def _zipf_probs(vocab: int, a: float) -> np.ndarray:
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    p = ranks**-a
    return p / p.sum()


class SyntheticTokens:
    """batch(i) -> {tokens, labels, loss_mask} for step i (global batch)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self._probs = _zipf_probs(cfg.vocab_size, cfg.zipf_a)
        # fixed motif bank: repeated n-grams give the model learnable
        # structure (tests assert the loss drops on this data)
        self._motif_len = min(cfg.motif_len, cfg.seq_len)
        rng = np.random.default_rng(cfg.seed + 7)
        self._motifs = rng.integers(
            0, cfg.vocab_size, size=(64, self._motif_len), dtype=np.int32
        )

    def batch(self, step: int, batch_slice: Optional[slice] = None) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        b = cfg.global_batch
        toks = rng.choice(
            cfg.vocab_size, size=(b, cfg.seq_len + 1), p=self._probs
        ).astype(np.int32)
        # paste motifs at random offsets
        ml = self._motif_len
        n_paste = int(cfg.motif_prob * b * cfg.seq_len / ml)
        rows = rng.integers(0, b, n_paste)
        offs = rng.integers(0, max(cfg.seq_len + 1 - ml, 1), n_paste)
        ids = rng.integers(0, len(self._motifs), n_paste)
        for r, o, i in zip(rows, offs, ids):
            toks[r, o : o + ml] = self._motifs[i]
        out = {
            "tokens": toks[:, :-1],
            "labels": toks[:, 1:].astype(np.int32),
            "loss_mask": np.ones((b, cfg.seq_len), np.float32),
        }
        if batch_slice is not None:
            out = {k: v[batch_slice] for k, v in out.items()}
        return out

    def iterate(self, start_step: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        i = start_step
        while True:
            yield self.batch(i)
            i += 1


def to_device(batch, device=None, batch_slice: Optional[slice] = None) -> Dict[str, torch.Tensor]:
    """Host numpy batch (or its rows `batch_slice`, this rank's shard) ->
    tensors on `device` ("cuda" by default; raises without a card unless
    device="cpu")."""
    dev = resolve_device(device)
    if batch_slice is not None:
        batch = {k: v[batch_slice] for k, v in batch.items()}
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in batch.items()}
