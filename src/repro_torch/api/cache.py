"""Process-wide plan cache: (spec_structural_hash, plan_key, device) -> CompiledSim.

Every autoscale bucket, every engine built from the same spec and plan, and
`compile_plan(measure=True)`'s candidate timing draw from one `PLAN_CACHE`:

  spec_structural_hash   covers only the shape/dtype/topology-determining
                         SimSpec fields (n, n_in, dtype, dt, hold_steps,
                         tableau, topology, readout_window, and the
                         *contents* of w_cp / w_in / m0). Scalar STOParams
                         VALUES are left out: every impl reads them as
                         per-lane (E, 1) columns at call time, so two specs
                         differing only in e.g. `a_cp` share one entry.
                         Ensemble-leaved params contribute their shape. The
                         digest is the JAX reference's for the same spec
                         (the same bytes in the same order).
  plan_cache_key         covers every ExecPlan field that changes what runs:
                         impl (and, for "auto", the dispatch table's
                         generation), ensemble, padding/blocking, the mesh
                         decomposition, gather dtype, precision,
                         chunk_ticks, the learner and its knobs, interpret
                         and measure. `aot` and `compilation_cache_dir`
                         change when work happens, never its result, and are
                         left out.
  device                 the resolved device the sim is bound to
                         (`compile_plan(device=)`): a CPU sim never answers
                         a card request.

A hit returns the SAME `CompiledSim` object a miss compiled, so its results
are a fresh compile's bit for bit. A hit whose scalar param values differ
from the cached sim's returns a rebind, `CompiledSim` around the caller's
spec (moved to the cached sim's device) with the cached plan and impl.

What a "compile" costs on the card: `compile_plan` binds the spec to the
device and resolves the impl (well under a millisecond); the CUDA kernels
build once per process (nvcc, or a load of the library built before, see
`enable_persistent_cache`). `warm` pays a plan's first-dispatch costs
ahead of serving: one all-lanes-masked chunk (`CompiledSim.warmup`), which
loads the kernel's module, sets its shared-memory attribute, grows the
caching allocator to the width's planes and creates cuBLAS's handles;
`aot=True` does the part of that which needs no launch
(`CompiledSim.aot_compile`), which is what a serving engine's rescale
boundary runs.

Thread safety: lookups and stats take one RLock; a compile runs outside it
with a per-key in-flight `threading.Event`, so a serving thread whose
rescale wants a bucket that the prewarm thread is compiling waits for that
one compile instead of repeating it.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import threading
import time
import warnings
from collections import OrderedDict
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.api.compiled import CompiledSim, compile_plan
from repro_torch.api.plan import ExecPlan
from repro_torch.api.spec import SimSpec
from repro_torch.kernels import _build, dispatch_table, ops

__all__ = [
    "CacheStats",
    "PlanCache",
    "PLAN_CACHE",
    "enable_persistent_cache",
    "persistent_cache_dir",
    "plan_cache_key",
    "spec_structural_hash",
]

_HASH_VERSION = b"spec-structural-v2"  # the reference's v2 (physics families)

#: Every SimSpec field spec_structural_hash accounts for. A FENCE: the hash
#: refuses a spec whose field set it does not cover, so a new SimSpec field
#: fails at the first cache lookup instead of two physics sharing an entry.
_STRUCTURAL_FIELDS = (
    "params",
    "w_cp",
    "w_in",
    "m0",
    "dt",
    "hold_steps",
    "tableau",
    "topology",
    "readout_window",
)

#: ExecPlan fields plan_cache_key reads directly, in the key's order; `mesh`,
#: `ensemble_axes` and `model_axis` enter through `_mesh_key`;
#: `_POLICY_FIELDS` change when work happens, not what runs.
#: tests/test_torch_plan_cache.py fences the three against
#: dataclasses.fields(ExecPlan), and the first against the key's order.
_KEYED_FIELDS = (
    "impl", "ensemble", "block_n", "block_e", "n_inner", "gather_dtype", "precision",
    "chunk_ticks", "learn", "learn_lam", "learn_reg", "learn_mu", "interpret", "measure",
)
_MESH_FIELDS = ("mesh", "ensemble_axes", "model_axis")
_POLICY_FIELDS = ("aot", "compilation_cache_dir")


def _host(x) -> np.ndarray:
    """A leaf as host numpy: card and CPU twins hash and compare equal."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _dtype_name(dtype) -> str:
    """numpy's name for a torch or numpy dtype ("float32"; "bfloat16")."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).rsplit(".", 1)[-1]
    return np.dtype(dtype).name


def spec_structural_hash(spec: SimSpec) -> str:
    """Canonical hash of the SimSpec fields that decide what runs.

    Two specs with the same hash run the same program: same shapes, dtypes,
    topology contents, timestep, hold window, tableau and physics family.
    Scalar param values are left out (per-lane inputs); ensemble-leaved
    params contribute their shape. Equal to the JAX reference's digest of
    the same spec; a spec on the card hashes as its CPU twin (which costs
    a copy of W off the card: callers that look one spec up repeatedly,
    as the engine does, hash it once and pass `spec_hash=`).
    """
    unknown = set(spec._fields) - set(_STRUCTURAL_FIELDS)
    if unknown:
        raise TypeError(
            "spec_structural_hash does not cover SimSpec field(s) "
            f"{sorted(unknown)}; extend _STRUCTURAL_FIELDS in "
            "repro_torch/api/cache.py (and bump _HASH_VERSION) so new physics "
            "fields key the cache instead of colliding"
        )
    h = hashlib.blake2b(digest_size=16)
    h.update(_HASH_VERSION)
    h.update(
        f"|{spec.n}|{spec.n_in}|{_dtype_name(spec.dtype)}"
        f"|{float(spec.dt)!r}|{int(spec.hold_steps)}|{spec.tableau}"
        f"|{spec.topology}|{int(spec.readout_window)}".encode()
    )
    for name in ("w_cp", "w_in", "m0"):
        a = _host(getattr(spec, name))
        h.update(f"|{name}:{a.shape}:{a.dtype.name}:".encode())
        h.update(np.ascontiguousarray(a).tobytes())
    h.update(f"|params:{tuple(np.shape(spec.params.gamma))}".encode())
    return h.hexdigest()


def _mesh_key(plan: ExecPlan):
    """Hashable description of the mesh decomposition (None when unsharded):
    the (dim name, size) pairs, the device type, the ranks in the mesh's
    order, the ensemble axes and the model axis."""
    if plan.mesh is None:
        return None
    mesh = plan.mesh
    return (
        tuple((str(k), int(v)) for k, v in zip(mesh.mesh_dim_names, mesh.shape)),
        str(mesh.device_type),
        tuple(int(r) for r in mesh.mesh.flatten().tolist()),
        tuple(plan.ensemble_axes),
        plan.model_axis,
    )


def plan_cache_key(plan: ExecPlan) -> Tuple:
    """Canonical key over the ExecPlan fields that shape what runs, the
    reference's field for field.

    impl="auto" plans also carry the dispatch table's generation, read after
    the platform's persisted table is loaded, so a cached auto resolution is
    dropped the moment a new measurement registers another winner."""
    if plan.impl == "auto" and not plan.sharded:
        dispatch_table.ensure_loaded()
        gen = ops.dispatch_generation()
    else:
        gen = None
    gd = plan.effective_gather_dtype
    return (
        plan.impl,
        gen,
        int(plan.ensemble),
        plan.block_n,
        plan.block_e,
        plan.n_inner,
        _mesh_key(plan),
        None if gd is None else _dtype_name(gd),
        ops.normalize_precision(plan.precision),
        int(plan.chunk_ticks),
        plan.learn,
        float(plan.learn_lam),
        float(plan.learn_reg),
        float(plan.learn_mu),
        bool(plan.interpret),
        bool(plan.measure),
    )


def _device_key(device) -> str:
    """"cuda" and "cuda:<current>" name one device; no card is needed."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device() if torch.cuda.is_available() else 0)
    return str(dev)


def _params_equal(a, b) -> bool:
    """Leaf-wise equality of two STOParams (shape and values, any device)."""
    if a is b:
        return True
    for la, lb in zip(a, b):
        if la is lb:
            continue
        xa, xb = _host(la), _host(lb)
        if xa.shape != xb.shape or not np.array_equal(xa, xb):
            return False
    return True


# ---------------------------------------------------------------------------
# persisted kernel builds (process restarts)
# ---------------------------------------------------------------------------

def enable_persistent_cache(directory) -> bool:
    """Build the CUDA kernel library into `directory` and load it from there.

    A fresh process pointed at a directory that holds the library of the
    same sources loads it without running nvcc (the library's name carries
    the sources' hash, so a stale one never loads). The first directory
    wins for the process: a later call with another directory warns and
    returns False, and so does a call made after the library was already
    loaded from elsewhere. Returns True when the library is (now) built in
    and loaded from `directory`.
    """
    directory = os.path.abspath(str(directory))
    if _build.set_build_dir(directory):
        return True
    pinned = _build._PINNED_DIR
    if pinned is not None:
        why = (f"the build directory is already pinned to {str(pinned)!r} (first "
               f"directory wins for the process)")
    else:
        why = f"the kernel library is already loaded from {str(_build.BUILD_DIR)!r}"
    warnings.warn(
        f"ignoring kernel build directory {directory!r}: {why}",
        RuntimeWarning,
        stacklevel=2,
    )
    return False


def persistent_cache_dir() -> Optional[str]:
    """The directory the kernel builds are pinned to (None: the default)."""
    pinned = _build._PINNED_DIR
    return None if pinned is None else str(pinned)


# ---------------------------------------------------------------------------
# PlanCache
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CacheStats:
    """Counters of a PlanCache.

    hits / misses count `get_or_compile` lookups; compiles / compile_seconds
    the `compile_plan` calls that misses made; warmups / warmup_seconds the
    first dispatches `warm` paid ahead of serving; rebinds the hits that
    re-wrapped a cached sim around other scalar param values;
    measure_hits / measure_misses the memoized `measure_impl_latency` runs.
    """

    hits: int = 0
    misses: int = 0
    compiles: int = 0
    compile_seconds: float = 0.0
    evictions: int = 0
    warmups: int = 0
    warmup_seconds: float = 0.0
    rebinds: int = 0
    measure_hits: int = 0
    measure_misses: int = 0

    def snapshot(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


class PlanCache:
    """LRU cache of CompiledSims keyed (spec_structural_hash, plan_key, device)."""

    def __init__(self, capacity: int = 64):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1; got {capacity}")
        self.capacity = int(capacity)
        self._lock = threading.RLock()
        self._entries: "OrderedDict[Tuple, CompiledSim]" = OrderedDict()
        self._warmed: set = set()
        self._inflight: Dict[Tuple, threading.Event] = {}
        self._measurements: Dict[Tuple, dict] = {}
        self.stats = CacheStats()

    # -- keys --------------------------------------------------------------
    #
    # Every lookup takes an optional `spec_hash`: spec_structural_hash(spec)
    # computed by the caller beforehand. On the card hashing copies W off
    # it (tens of ms at N = 2500), so the engine hashes its template once
    # and passes the digest to each rescale's and prewarm's lookups.

    def key(
        self, spec: SimSpec, plan: ExecPlan, device="cuda", spec_hash: Optional[str] = None
    ) -> Tuple:
        if plan.impl == "auto":
            # the device's own persisted table, before the generation is read
            dispatch_table.ensure_loaded(torch.device(device).type)
        if spec_hash is None:
            spec_hash = spec_structural_hash(spec)
        return (spec_hash, plan_cache_key(plan), _device_key(device))

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def contains(
        self,
        spec: SimSpec,
        plan: Optional[ExecPlan] = None,
        device="cuda",
        spec_hash: Optional[str] = None,
        **overrides,
    ) -> bool:
        """True when get_or_compile would hit (no stats change)."""
        key = self.key(spec, _resolve_plan(plan, overrides), device, spec_hash)
        with self._lock:
            return key in self._entries

    def is_warm(
        self,
        spec: SimSpec,
        plan: Optional[ExecPlan] = None,
        *,
        n_out: int = 1,
        device="cuda",
        spec_hash: Optional[str] = None,
        **overrides,
    ) -> bool:
        """True when `warm` already ran this (key, n_out)."""
        key = self.key(spec, _resolve_plan(plan, overrides), device, spec_hash)
        with self._lock:
            return (key, int(n_out)) in self._warmed

    # -- the cache proper --------------------------------------------------

    def get_or_compile(
        self,
        spec: SimSpec,
        plan: Optional[ExecPlan] = None,
        device="cuda",
        spec_hash: Optional[str] = None,
        **overrides,
    ) -> CompiledSim:
        """The cached `compile_plan(spec, plan, device=device, **overrides)`.

        Hit: the cached CompiledSim (the same object), rebound to the
        caller's spec when its scalar param values differ. Miss: compiles
        outside the lock (one compile in flight per key; other requesters
        of that key wait for it) and inserts with LRU eviction.
        """
        plan = _resolve_plan(plan, overrides)
        if plan.compilation_cache_dir:
            enable_persistent_cache(plan.compilation_cache_dir)
        key = self.key(spec, plan, device, spec_hash)
        while True:
            with self._lock:
                sim = self._entries.get(key)
                if sim is not None:
                    self._entries.move_to_end(key)
                    self.stats.hits += 1
                    return self._rebind(sim, spec)
                event = self._inflight.get(key)
                if event is None:
                    self._inflight[key] = threading.Event()
                    self.stats.misses += 1
                    break
            event.wait()  # another thread compiles this key; then look again
        try:
            t0 = time.perf_counter()
            sim = compile_plan(spec, plan, device=device)
            elapsed = time.perf_counter() - t0
        except BaseException:
            with self._lock:
                self._inflight.pop(key).set()  # waiters retry and raise themselves
            raise
        with self._lock:
            self._entries[key] = sim
            self._entries.move_to_end(key)
            self.stats.compiles += 1
            self.stats.compile_seconds += elapsed
            while len(self._entries) > self.capacity:
                old_key, _ = self._entries.popitem(last=False)
                self._warmed = {w for w in self._warmed if w[0] != old_key}
                self.stats.evictions += 1
            self._inflight.pop(key).set()
        return sim

    def _rebind(self, sim: CompiledSim, spec: SimSpec) -> CompiledSim:
        """A hit reflects the caller's param values: other scalar values
        re-wrap the cached plan and impl around the caller's spec, moved to
        the cached sim's device (nothing to build)."""
        if _params_equal(sim.spec.params, spec.params):
            return sim
        with self._lock:
            self.stats.rebinds += 1
        if spec.device != sim.device:
            spec = spec.to(sim.device)
        return CompiledSim(spec, sim.plan, sim.impl)

    def warm(
        self,
        sim: CompiledSim,
        *,
        n_out: int = 1,
        aot: bool = False,
        spec_hash: Optional[str] = None,
    ) -> float:
        """Pay `sim`'s first-dispatch costs once per (key, n_out); returns the
        seconds spent (0.0 when already warm).

        The default runs one all-lanes-masked zero chunk (`warmup`: on the
        card it launches the plan's kernels on the current stream and waits
        for them); aot=True does only what needs no launch (`aot_compile`:
        build or load the library, resolve the launch configuration, set
        the kernels' shared-memory attributes); a physics-family plan, whose
        aot_compile refuses, warms by the masked chunk instead."""
        key = (self.key(sim.spec, sim.plan, sim.device, spec_hash), int(n_out))
        with self._lock:
            if key in self._warmed:
                return 0.0
        t0 = time.perf_counter()
        if aot:
            try:
                sim.aot_compile(n_out=n_out)
            except NotImplementedError:  # family plans warm by one masked chunk
                sim.warmup(n_out=n_out)
        else:
            sim.warmup(n_out=n_out)
        elapsed = time.perf_counter() - t0
        with self._lock:
            if key not in self._warmed:
                self._warmed.add(key)
                self.stats.warmups += 1
                self.stats.warmup_seconds += elapsed
        return elapsed

    def ensure_warm(
        self,
        spec: SimSpec,
        plan: Optional[ExecPlan] = None,
        *,
        n_out: int = 1,
        aot: bool = False,
        device="cuda",
        spec_hash: Optional[str] = None,
        **overrides,
    ) -> CompiledSim:
        """get_or_compile + warm in one call (the prewarm entry point)."""
        if spec_hash is None:
            spec_hash = spec_structural_hash(spec)
        sim = self.get_or_compile(spec, plan, device=device, spec_hash=spec_hash, **overrides)
        self.warm(sim, n_out=n_out, aot=aot, spec_hash=spec_hash)
        return sim

    # -- measurement memo (compile_plan(measure=True)) ---------------------

    def measure(
        self,
        n: int,
        e: int,
        *,
        dt: float,
        n_steps: int = 8,
        candidates: Optional[Tuple[str, ...]] = None,
        dtype=None,
        reps: int = 3,
        precision: Optional[str] = None,
        chunk_ticks: int = 4,
        device="cuda",
    ) -> dict:
        """Memoized `ops.measure_impl_latency` on `device`: one key is timed
        once a process. Every call leaves the measured winner in the dispatch
        table, as the unmemoized call does: a hit registers it again if the
        table lost it (`ops.clear_latency_table`) or holds another impl."""
        dtype = torch.float32 if dtype is None else dtype
        key = (
            _device_key(device),
            int(n),
            int(e),
            _dtype_name(dtype),
            ops.normalize_precision(precision),
            int(chunk_ticks),
            int(n_steps),
            int(reps),
            None if candidates is None else tuple(candidates),
        )
        with self._lock:
            memo = self._measurements.get(key)
            if memo is not None:
                self.stats.measure_hits += 1
        if memo is not None:
            _keep_registered(memo, n, e, device, dtype, precision)
            return memo
        timings = ops.measure_impl_latency(
            n, e, dt=dt, n_steps=n_steps, candidates=candidates, dtype=dtype, reps=reps,
            precision=precision, chunk_ticks=chunk_ticks, device=device,
        )
        with self._lock:
            self.stats.measure_misses += 1
            self._measurements[key] = timings
        return timings

    # -- maintenance -------------------------------------------------------

    def clear(self) -> None:
        """Drop every entry, warm mark and measurement memo (stats kept)."""
        with self._lock:
            self._entries.clear()
            self._warmed.clear()
            self._measurements.clear()


def _keep_registered(timings: dict, n: int, e: int, device, dtype, precision) -> None:
    """Register a memoized measurement's winner unless the table holds it."""
    ok = {k: v for k, v in timings.items() if isinstance(v, float)}
    if not ok:
        return
    winner = min(ok, key=ok.get)
    platform = ops._platform(device)
    itemsize = torch.empty((), dtype=dtype).element_size()
    if ops.latency_table().get(ops.dispatch_key(n, e, platform, itemsize, precision)) != winner:
        ops.register_impl_choice(
            n, e, winner, platform=platform, itemsize=itemsize, precision=precision
        )


def _resolve_plan(plan: Optional[ExecPlan], overrides: dict) -> ExecPlan:
    if plan is None:
        return ExecPlan(**overrides)
    if overrides:
        return dataclasses.replace(plan, **overrides)
    return plan


#: The process-wide cache every compile hot path shares: the engine's
#: template route, its autoscale buckets and their prewarm, and
#: compile_plan(measure=True)'s candidate timing.
PLAN_CACHE = PlanCache()
