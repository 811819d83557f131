"""Slot-batched reservoir state store.

The serving engine's device-resident state, laid out exactly like the
kernels want it (kernels/ref.py):

    m      : (3, N, E)       magnetization planes — lane e is serving slot e
    w_out  : (E, N+1, n_out) per-session trained readouts (last row = bias)

Per-tenant parameter scalars live in a host-side (14, E) numpy matrix and
only materialize as device (E, 1) leaves when the cache rebuilds.

Admitting a session SPLICES its state into the batched arrays at a free slot;
retiring resets the column to the engine's template so idle lanes hold a
harmless unit-norm state (no NaN sources) until the next admit. Admissions
and retirements BATCH: a whole chunk boundary's churn is one index write
per array. The writes are in place, which is safe because every reader and
writer of these tensors is ordered on the device's current stream.
Uploads are non-blocking so a boundary never waits for the chunk in flight.

W^cp / W^in topology is shared across tenants: every lane contracts against
the same coupling matrix, so per-tenant physics lives in the params and
readout columns. Online-learning columns and autoscale resizing are not
ported yet (ROADMAP queue 1 items 6 and 7).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.constants import STOParams
from repro_torch.kernels import ref as kref

_NF = len(STOParams._fields)


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class SlotStore:
    def __init__(self, spec, num_slots: int, n_out: int = 1):
        # spec: the engine's physics template (a repro_torch.api.SimSpec)
        self.spec = spec
        self.num_slots = num_slots
        self.n = spec.n
        self.n_in = spec.n_in
        self.n_out = n_out
        self.dtype = spec.dtype
        self.np_dtype = torch.empty((), dtype=spec.dtype).numpy().dtype
        self.device = spec.device

        self._m0_col = spec.m0.T.contiguous()  # (3, N) template column
        self._m0_col_np = _host(self._m0_col)
        self.m = self._m0_col[:, :, None].expand(3, self.n, num_slots).contiguous()
        self._template_params_col = np.asarray(
            [_host(getattr(spec.params, f)).reshape(()) for f in STOParams._fields],
            dtype=self.np_dtype,
        )
        self._params_np = np.tile(self._template_params_col[:, None], (1, num_slots))
        self.w_out = torch.zeros(
            (num_slots, self.n + 1, n_out), dtype=self.dtype, device=self.device
        )
        self._active = [False] * num_slots

        # caches derived from _params_np, rebuilt lazily after admit/retire
        # (chunk boundaries)
        self._pv: Optional[torch.Tensor] = None
        self._params_e: Optional[STOParams] = None

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device, non_blocking=True)

    # -- slot lifecycle ----------------------------------------------------

    def free_slots(self) -> List[int]:
        return [i for i, a in enumerate(self._active) if not a]

    def admit_many(self, items: Sequence[Tuple]) -> None:
        """Splice several sessions in ONE index write per batched array.

        items: (slot, m0, params, w_out) per admission — m0 (N, 3) or None
        for the template, params an STOParams of scalars or None, w_out an
        (N+1, n_out) readout or None."""
        if not items:
            return
        idx = np.empty(len(items), dtype=np.int64)
        cols = np.empty((3, self.n, len(items)), self.np_dtype)
        w_idx: List[int] = []
        w_rows: List[np.ndarray] = []
        for i, (slot, m0, params, w_out) in enumerate(items):
            if self._active[slot]:
                raise ValueError(f"slot {slot} already occupied")
            self._active[slot] = True
            idx[i] = slot
            cols[:, :, i] = self._m0_col_np if m0 is None else _host(m0).astype(self.np_dtype).T
            if params is None:
                self._params_np[:, slot] = self._template_params_col
            else:
                self._params_np[:, slot] = [
                    _host(getattr(params, f)).reshape(()) for f in STOParams._fields
                ]
            if w_out is not None:
                w_idx.append(slot)
                w_rows.append(
                    _host(w_out).astype(self.np_dtype).reshape(self.n + 1, self.n_out)
                )
        self.m[:, :, self._upload(idx)] = self._upload(cols)
        if w_idx:
            self.w_out[self._upload(np.asarray(w_idx))] = self._upload(np.stack(w_rows))
        self._invalidate()

    def retire_many(self, slots: Sequence[int]) -> None:
        """Reset several columns to the template in one write each."""
        if not len(slots):
            return
        for slot in slots:
            if not self._active[slot]:
                raise ValueError(f"slot {slot} not occupied")
            self._params_np[:, slot] = self._template_params_col
            self._active[slot] = False
        idx = self._upload(np.asarray(slots, dtype=np.int64))
        self.m[:, :, idx] = self._m0_col[:, :, None].expand(3, self.n, len(slots))
        self.w_out[idx] = 0.0
        self._invalidate()

    def _invalidate(self):
        self._pv = None
        self._params_e = None

    # -- derived batched views --------------------------------------------

    @property
    def params_vec(self) -> torch.Tensor:
        """Packed (NP, E) per-slot parameter columns."""
        if self._pv is None:
            self._pv = kref.pack_params(self.params_ensemble, self.num_slots, dtype=self.dtype)
        return self._pv

    @property
    def params_ensemble(self) -> STOParams:
        """STOParams with (E, 1) leaves, from one upload of the host rows."""
        if self._params_e is None:
            rows = self._upload(self._params_np)
            self._params_e = STOParams(
                *(rows[i].reshape(self.num_slots, 1) for i in range(_NF))
            )
        return self._params_e

    def state_columns(self, slots: Sequence[int]) -> torch.Tensor:
        """(k, N, 3) magnetization of several slots in one gather — the
        engine snapshots a whole boundary's finishers at once."""
        idx = self._upload(np.asarray(slots, dtype=np.int64))
        return self.m[:, :, idx].permute(2, 1, 0)
