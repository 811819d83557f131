"""Persisted per-platform measured-latency dispatch tables.

`kernels/ops.py` keeps an in-process table mapping (platform, N_pad, E_pad,
itemsize, precision) -> impl, filled by `measure_impl_latency` and
`register_impl_choice`. This module gives that table a life beyond the
process:

  - `save_table()` writes the in-process entries of one platform to JSON
    (default: `dispatch_table.<platform>.json` beside this module).
  - `load_table()` reads such a file back into the in-process table.
    In-process measurements win: a persisted entry never overwrites a key
    measured in this process unless `override=True`.
  - `ensure_loaded()` loads the table of a platform from its default path
    once per process; `ops.choose_impl` calls it before it reads the table,
    so `impl="auto"` plans consult the persisted measurements without any
    caller wiring.
  - `seed_from_bench()` turns a serving-throughput run (`BENCH_serve.json`:
    each cell records the impl that won at its (N, E)) into table entries.

The platform is `ops._platform(device)`: "cuda" or "cpu". The package ships
no table: on the CPU the port runs the kernels' plain versions, and a
"cuda" table comes only from a measured grid on the card.

Keys round N and E up to the port's 64-wide granule (`ops.BLOCK_N`,
`ops.BLOCK_E`, the CUDA kernels' tiles), where the JAX reference rounds to
its 128-wide TPU lane: a key names the padded shape the kernels run.

Formats: v1 ("repro-dispatch-table-v1") keyed entries by (n_pad, e_pad,
itemsize); v2 adds a per-entry "precision" (the ExecPlan.precision policy
it was measured under). `load_table` reads both; a v1 entry migrates to the
bit-exact default precision, "highest".
"""

from __future__ import annotations

import json
import os
import warnings
from typing import Dict, Optional, Set, Tuple

_IMPLS = ("ref", "fused", "tiled", "chunk")
_FORMATS = ("repro-dispatch-table-v1", "repro-dispatch-table-v2")

# Platforms whose default table was already looked for this process.
_LOADED: Set[str] = set()


def _ops():
    # deferred: ops imports this module from choose_impl
    from repro_torch.kernels import ops

    return ops


def table_path(platform: Optional[str] = None, directory: Optional[str] = None) -> str:
    """Default path of a platform's table."""
    platform = platform or _ops()._platform()
    directory = directory or os.path.dirname(os.path.abspath(__file__))
    return os.path.join(directory, f"dispatch_table.{platform}.json")


def save_table(path: Optional[str] = None, platform: Optional[str] = None) -> str:
    """Write this process's dispatch entries for `platform` to JSON; returns
    the path."""
    ops = _ops()
    platform = platform or ops._platform()
    path = path or table_path(platform)
    entries = [
        {"n_pad": n_pad, "e_pad": e_pad, "itemsize": itemsize, "precision": precision,
         "impl": impl}
        for (plat, n_pad, e_pad, itemsize, precision), impl in sorted(ops.latency_table().items())
        if plat == platform
    ]
    payload = {"format": "repro-dispatch-table-v2", "platform": platform, "entries": entries}
    with open(path, "w") as f:
        json.dump(payload, f, indent=2)
        f.write("\n")
    return path


def load_table(
    path: Optional[str] = None, platform: Optional[str] = None, override: bool = False
) -> int:
    """Register a persisted table's entries in the in-process table; returns
    how many were registered. Keys already present (measured in this
    process) are kept unless `override=True`. Reads formats v1 and v2."""
    ops = _ops()
    platform = platform or ops._platform()
    path = path or table_path(platform)
    with open(path) as f:
        payload = json.load(f)
    fmt = payload.get("format")
    if fmt not in _FORMATS:
        raise ValueError(
            f"unknown dispatch-table format {fmt!r} in {path} (supported: {_FORMATS})"
        )
    plat = payload.get("platform", platform)
    live = ops.latency_table()
    count = 0
    for entry in payload.get("entries", ()):
        impl = entry["impl"]
        if impl not in _IMPLS:
            continue
        itemsize = int(entry.get("itemsize", 4))
        # v1: no "precision" field -> the bit-exact default
        precision = ops.normalize_precision(entry.get("precision") or ops.PRECISION_DEFAULT)
        key = (plat, int(entry["n_pad"]), int(entry["e_pad"]), itemsize, precision)
        if not override and key in live:
            continue
        ops.register_impl_choice(
            key[1], key[2], impl, platform=plat, itemsize=itemsize, precision=precision
        )
        count += 1
    return count


def ensure_loaded(platform: Optional[str] = None) -> int:
    """Load the platform's default table once per process, if it exists.

    Returns the entries registered by the loading call, else 0. An
    unreadable or corrupt file warns once and counts as missing: dispatch
    then falls back to the platform gate / L2 rule."""
    platform = platform or _ops()._platform()
    if platform in _LOADED:
        return 0
    _LOADED.add(platform)  # first: a missing or corrupt file is not retried
    path = table_path(platform)
    if not os.path.exists(path):
        return 0
    try:
        return load_table(path, platform=platform)
    except Exception as exc:  # corrupt JSON, bad schema, unreadable file
        warnings.warn(
            f"ignoring unreadable dispatch table {path}: {exc!r}; dispatch falls back "
            "to the platform gate / L2 rule",
            RuntimeWarning,
            stacklevel=2,
        )
        return 0


def reset_loaded() -> None:
    """Forget which platforms' tables were looked for (a test hook)."""
    _LOADED.clear()


def seed_from_bench(bench_path: str, platform: Optional[str] = None) -> int:
    """Register entries from a serving-throughput run (`BENCH_serve.json`).

    Each (N, E) cell records the impl the engine resolved there. Per cell
    and precision the winner is decided first: the default precision's
    `backend`, replaced by `backend_chunk_impl` only when its within-run
    `chunk_impl_speedup` > 1; "mixed" from `backend_mixed` only when
    `precision_speedup` > 1. Cells landing on one padded key: the largest
    n * e wins (the least padding). Returns the number of keys registered.
    """
    ops = _ops()
    with open(bench_path) as f:
        payload = json.load(f)
    platform = platform or payload.get("backend_platform")
    chosen: Dict[Tuple[str, int, int, int, str], Tuple[int, str]] = {}
    for cell in payload.get("cells", ()):
        per_prec: Dict[str, str] = {}
        prec0 = ops.normalize_precision(cell.get("precision"))
        if cell.get("backend") in _IMPLS:
            per_prec[prec0] = cell["backend"]
        if (
            cell.get("backend_chunk_impl") in _IMPLS
            and float(cell.get("chunk_impl_speedup", 0.0)) > 1.0
        ):
            per_prec[prec0] = cell["backend_chunk_impl"]
        if cell.get("backend_mixed") in _IMPLS and float(cell.get("precision_speedup", 0.0)) > 1.0:
            per_prec["mixed"] = cell["backend_mixed"]
        n, e = int(cell["n"]), int(cell["e"])
        itemsize = int(cell.get("itemsize", 4))  # the serve bench runs f32
        for precision, impl in per_prec.items():
            # the port's 64-wide granule (the reference: its 128-wide LANE)
            key = (
                platform, ops._round_up(n, ops.BLOCK_N), ops._round_up(e, ops.BLOCK_E),
                itemsize, precision,
            )
            if key not in chosen or n * e > chosen[key][0]:
                chosen[key] = (n * e, impl)
    for (plat, n_pad, e_pad, itemsize, precision), (_, impl) in chosen.items():
        ops.register_impl_choice(
            n_pad, e_pad, impl, platform=plat, itemsize=itemsize, precision=precision
        )
    return len(chosen)
