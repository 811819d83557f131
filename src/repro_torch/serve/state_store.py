"""Slot-batched reservoir state store.

The serving engine's device-resident state, laid out exactly like the
kernels want it (kernels/ref.py):

    m      : (3, N, E)       magnetization planes — lane e is serving slot e
    w_out  : (E, N+1, n_out) per-session trained readouts (last row = bias)
    Wl     : (E, S, n_out)   learned readouts (learning stores, S = N + 1)
    P      : (E, S, S)       RLS inverse-Gram blocks (learn="rls" only)

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
readout columns. The learn columns live on the device and come to the host
only for a checkpoint (P is 6.4 GB at E = 256, N = 2500).

`resized` is the autoscale migration: a store of another width with every
occupied column (magnetization, params, readout, and the learn columns P /
Wl) moved by one gather-scatter per array. Column moves are pure data
movement, so a moved session's lane keeps its exact bits.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.constants import STOParams
from repro_torch.kernels import ref as kref
from repro_torch.kernels import rls as krls

_NF = len(STOParams._fields)


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class SlotStore:
    def __init__(self, spec, num_slots: int, n_out: int = 1, learn=None, learn_reg: float = 1e-6):
        # spec: the engine's physics template (a repro_torch.api.SimSpec);
        # learn: None | "rls" | "lms", the engine plan's learner
        if learn not in (None, "rls", "lms"):
            raise ValueError(f"learn must be None, 'rls' or 'lms'; got {learn!r}")
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

        self.learn = learn
        self.learn_reg = float(learn_reg)
        self.n_state = self.n + 1
        self.P: Optional[torch.Tensor] = None
        self.Wl: Optional[torch.Tensor] = None
        if learn == "rls":
            self.P, self.Wl = krls.rls_init(
                num_slots, self.n_state, n_out, self.learn_reg, self.dtype, device=self.device
            )
            self._p0 = self.P[0].clone()  # I / learn_reg, the fresh column
        elif learn == "lms":
            self.Wl = krls.lms_init(num_slots, self.n_state, n_out, self.dtype, device=self.device)

        # caches derived from _params_np / _active, rebuilt lazily after
        # admit/retire (chunk boundaries)
        self._pv: Optional[torch.Tensor] = None
        self._params_e: Optional[STOParams] = None
        self._mask: Optional[torch.Tensor] = None

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device, non_blocking=True)

    # -- slot lifecycle ----------------------------------------------------

    def free_slots(self) -> List[int]:
        return [i for i, a in enumerate(self._active) if not a]

    def admit(
        self, slot: int, m0=None, params=None, w_out=None, learn_w0=None, learn_P0=None
    ) -> None:
        """Splice one session into a free slot (see `admit_many`)."""
        self.admit_many([(slot, m0, params, w_out, learn_w0, learn_P0)])

    def admit_many(self, items: Sequence[Tuple]) -> None:
        """Splice several sessions in ONE index write per batched array.

        items: (slot, m0, params, w_out, learn_w0, learn_P0) per admission —
        m0 (N, 3) or None for the template, params an STOParams of scalars or
        None, w_out an (N+1, n_out) readout or None. On learning stores
        learn_w0 (S, n_out) starts the slot's learned weights (zeros when
        None) and learn_P0 (S, S) resumes its inverse-Gram (I / learn_reg
        when None)."""
        if not items:
            return
        idx = np.empty(len(items), dtype=np.int64)
        cols = np.empty((3, self.n, len(items)), self.np_dtype)
        w_idx: List[int] = []
        w_rows: List[np.ndarray] = []
        lw_cols: List[Optional[np.ndarray]] = []
        lp_cols: List[Optional[np.ndarray]] = []
        for i, (slot, m0, params, w_out, learn_w0, learn_P0) in enumerate(items):
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
            lw_cols.append(
                None if learn_w0 is None
                else _host(learn_w0).astype(self.np_dtype).reshape(self.n_state, self.n_out)
            )
            lp_cols.append(
                None if learn_P0 is None
                else _host(learn_P0).astype(self.np_dtype).reshape(self.n_state, self.n_state)
            )
        idx_dev = self._upload(idx)
        self.m[:, :, idx_dev] = self._upload(cols)
        if w_idx:
            self.w_out[self._upload(np.asarray(w_idx))] = self._upload(np.stack(w_rows))
        if self.learn:
            self._reset_learn_columns(idx, idx_dev, lw_cols, lp_cols)
        self._invalidate()

    def _reset_learn_columns(self, idx, idx_dev, w_cols=None, p_cols=None) -> None:
        """Restart the learn state of several slots, one write per array:
        Wl <- w_cols entries (zeros for None), P <- p_cols entries (the fresh
        I / learn_reg for None). LMS stores have no P."""
        w_cols = w_cols or [None] * len(idx)
        p_cols = p_cols or [None] * len(idx)
        if self.P is None:
            if any(p is not None for p in p_cols):
                raise ValueError(
                    "learn_P0 was passed to a learn='lms' store — LMS carries no "
                    "inverse-Gram block to resume"
                )
        else:
            self.P[idx_dev] = self._p0.expand(len(idx), self.n_state, self.n_state)
            given = [i for i, p in enumerate(p_cols) if p is not None]
            if given:
                self.P[self._upload(idx[given])] = self._upload(np.stack([p_cols[i] for i in given]))
        self.Wl[idx_dev] = 0.0
        given = [i for i, w in enumerate(w_cols) if w is not None]
        if given:
            self.Wl[self._upload(idx[given])] = self._upload(np.stack([w_cols[i] for i in given]))

    def retire(self, slot: int) -> None:
        self.retire_many([slot])

    def retire_many(self, slots: Sequence[int]) -> None:
        """Reset several columns to the template in one write each."""
        if not len(slots):
            return
        for slot in slots:
            if not self._active[slot]:
                raise ValueError(f"slot {slot} not occupied")
            self._params_np[:, slot] = self._template_params_col
            self._active[slot] = False
        idx_np = np.asarray(slots, dtype=np.int64)
        idx = self._upload(idx_np)
        self.m[:, :, idx] = self._m0_col[:, :, None].expand(3, self.n, len(slots))
        self.w_out[idx] = 0.0
        if self.learn:
            self._reset_learn_columns(idx_np, idx)
        self._invalidate()

    def _invalidate(self):
        self._pv = None
        self._params_e = None
        self._mask = None

    def resized(self, new_num_slots: int, slot_map: Dict[int, int]) -> "SlotStore":
        """A new store of width `new_num_slots` with the occupied columns
        moved per slot_map (old slot -> new slot): the autoscale migration.

        One gather-scatter per array moves every mapped magnetization
        column, params column, readout row and, on learning stores, the P
        and Wl columns; unmapped new slots hold the template, like freshly
        retired lanes. Both stores are live until the caller drops the old
        one: an RLS store holds its old and new P at once."""
        new = SlotStore(
            self.spec, new_num_slots, n_out=self.n_out, learn=self.learn,
            learn_reg=self.learn_reg,
        )
        if slot_map:
            old_np = np.asarray(list(slot_map.keys()), dtype=np.int64)
            new_np = np.asarray(list(slot_map.values()), dtype=np.int64)
            if new_np.max() >= new_num_slots:
                raise ValueError(
                    f"slot_map targets slot {new_np.max()} but the resized "
                    f"store has only {new_num_slots} slots"
                )
            old_idx, new_idx = self._upload(old_np), self._upload(new_np)
            new.m[:, :, new_idx] = self.m[:, :, old_idx]
            new.w_out[new_idx] = self.w_out[old_idx]
            new._params_np[:, new_np] = self._params_np[:, old_np]
            if self.P is not None:
                new.P[new_idx] = self.P[old_idx]
            if self.Wl is not None:
                new.Wl[new_idx] = self.Wl[old_idx]
            for old, tgt in slot_map.items():
                new._active[tgt] = self._active[old]
        return new

    # -- derived batched views --------------------------------------------

    @property
    def active_mask(self) -> torch.Tensor:
        """(E,) bool occupancy on the device: the per-tick path's lane mask."""
        if self._mask is None:
            self._mask = self._upload(np.asarray(self._active, dtype=bool))
        return self._mask

    @property
    def num_active(self) -> int:
        return sum(self._active)

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

    def a_in_row(self) -> torch.Tensor:
        """(E,) per-slot input gains (A_in is per tenant, like the rest)."""
        return self.params_ensemble.a_in.reshape(self.num_slots)

    def state_column(self, slot: int) -> torch.Tensor:
        """(N, 3) magnetization of one slot, a copy (user layout)."""
        return self.m[:, :, slot].t().clone()

    def state_columns(self, slots: Sequence[int]) -> torch.Tensor:
        """(k, N, 3) magnetization of several slots in one gather — the
        engine snapshots a whole boundary's finishers at once."""
        idx = self._upload(np.asarray(slots, dtype=np.int64))
        return self.m[:, :, idx].permute(2, 1, 0)

    def learn_w_columns(self, slots: Sequence[int]) -> torch.Tensor:
        """(k, S, n_out) learned readout weights of several slots in one
        gather (the finishers' trained readouts, ordered on the stream after
        the chunk that produced them)."""
        return self.Wl[self._upload(np.asarray(slots, dtype=np.int64))]

    def learn_P_columns(self, slots: Sequence[int]) -> torch.Tensor:
        """(k, S, S) inverse-Gram blocks of several slots in one gather, for
        checkpoints. RLS stores only."""
        if self.P is None:
            raise ValueError(
                "learn_P_columns() on a learn='lms' store — LMS has no "
                "inverse-Gram block; checkpoint the Wl lanes only"
            )
        return self.P[self._upload(np.asarray(slots, dtype=np.int64))]
