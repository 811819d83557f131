"""Build and load the hand-written CUDA kernels (nvcc by hand, bound with
ctypes), and count their launches.

Each source under `kernels/csrc/` compiles with its own nvcc process, all
started together, and the objects link into one shared library with a plain
C interface, `build/repro_torch/librepro_torch_<hash>.so` at the root of the
checkout (a cache: delete it freely). The hash covers the sources and flags,
so an edited source rebuilds at first use and an unchanged one loads the
cached build. Nothing is built at import time: `load()` builds on the first
kernel launch. `set_build_dir` points the build at another directory (the
plan cache's `enable_persistent_cache`): a fresh process then loads the
library built there without running nvcc. A stale library can never load,
since its name carries the hash.

A build that fails raises with nvcc's output; there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

from torch._subclasses.fake_tensor import FakeTensor

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
SOURCES = ("sto_rk4.cu", "flash_attention.cu", "sto_delay_line.cu")
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ("-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIB = None
# the directory set_build_dir pinned (None: BUILD_DIR's default); the first
# directory wins for the process
_PINNED_DIR = None
# load() and set_build_dir(): a prewarm thread and the serving thread may
# both reach the first build
_LOCK = threading.Lock()
# Launches of each kernel in this process (plain-version calls not counted):
# each wrapper adds one to its entry where it launches its kernel.
LAUNCHES = {
    "rk4_chunk": 0, "rk4_fused": 0, "field_tiled": 0, "round_bf16": 0, "flash_attention": 0,
    "tm_delay_line": 0,
}
# what the last build printed (ptxas registers / shared memory / spills);
# None when the library came from the cache
BUILD_LOG = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
_SIGNATURES = {
    "sto_tile_n": ((), _I),
    "sto_tile_e": ((), _I),
    "sto_coop_rows": ((_I,), _I),
    "sto_coop_slice": ((), _I),
    "sto_coop_lanes": ((), _I),
    "sto_coop_max_cluster": ((), _I),
    "sto_coop_smem": ((_I,), _I),
    "sto_coop_max_clusters": ((_I, _I), _I),
    "sto_rk4_coop": (
        (_I, _P, _P, _P, _L, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _F, _I, _I, _P),
        _I,
    ),
    "sto_field_smem": ((_I,), _I),
    "sto_field_max_clusters": ((_I, _I), _I),
    "sto_field_stage": (
        (_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _F, _F, _F, _I, _I, _I, _P),
        _I,
    ),
    "sto_round_bf16": ((_P, _P, _L, _P), _I),
    "flash_attention_fwd": (
        (_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I) + (_L,) * 12 + (_I, _I, _F, _I, _I, _P),
        _I,
    ),
    "flash_bf16_config": ((_I, _P), _I),
    "sto_tm_lanes": ((), _I),
    "sto_tm_delay_line": ((_P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _F, _P), _I),
}


# the prewarm thread and the serving thread may both launch kernels
_COUNT_LOCK = threading.Lock()


def count_launch(name: str) -> None:
    """Add one to a kernel's launch count (its wrapper calls this right
    after the launch)."""
    with _COUNT_LOCK:
        LAUNCHES[name] += 1


def reset_launches() -> None:
    with _COUNT_LOCK:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def is_fake(*tensors) -> bool:
    """True when one of `tensors` is a FakeTensor: a dry run's
    (launch/dryrun.py), with a shape, a dtype and a device but no memory."""
    return any(isinstance(t, FakeTensor) for t in tensors)


def fake_launch(name: str, flops: dict, nbytes: float) -> None:
    """A wrapper's stand-in for a launch on fake tensors: nothing is built,
    loaded or launched, and LAUNCHES (launches on the card) is left as it
    is. Every cost counter on the dispatch mode stack (launch/costs.py)
    records the launch, its FLOPs by operand kind ({"bf16": tensor-core
    FLOPs, "f32": the rest}) and the bytes it reads and writes, which no
    aten op shows it."""
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

    for mode in _get_current_dispatch_mode_stack():
        record = getattr(mode, "record_kernel", None)
        if record is not None:
            record(name, flops, nbytes)


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin); the CUDA "
        "kernels build only where the CUDA toolkit is installed"
    )


def _source_hash() -> str:
    h = hashlib.sha256()
    for name in sorted(p.name for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh")):
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build(build_dir=None) -> pathlib.Path:
    """Compile the sources into `build_dir` (BUILD_DIR when None) if no
    library with their hash exists there; return its path. A parent process
    builds into the directory its worker processes will load from this way
    (`serve.fleet.start_fleet`), whatever directory it loads from itself."""
    global BUILD_LOG
    build_dir = BUILD_DIR if build_dir is None else pathlib.Path(build_dir)
    digest = _source_hash()
    out = build_dir / f"librepro_torch_{digest}.so"
    if out.exists():
        return out
    build_dir.mkdir(parents=True, exist_ok=True)
    tag = f"{digest}.{os.getpid()}"
    objs = [build_dir / f"{pathlib.Path(s).stem}.{tag}.o" for s in SOURCES]
    nvcc = _nvcc()
    cmds = [
        [nvcc, *ARCH_FLAGS, *NVCC_FLAGS, "-c", "-o", str(obj), str(CSRC / src)]
        for src, obj in zip(SOURCES, objs)
    ]
    procs = [
        subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for cmd in cmds
    ]
    logs = [proc.communicate()[0] for proc in procs]
    BUILD_LOG = "".join(f"== {src}\n{log}" for src, log in zip(SOURCES, logs))
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        for cmd, proc in zip(cmds, procs):
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{BUILD_LOG}"
                )
        link = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(link, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed ({proc.returncode}): {' '.join(link)}\n"
                f"{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, out)  # atomic: a concurrent build never loads a partial file
    finally:
        tmp.unlink(missing_ok=True)
        for obj in objs:
            obj.unlink(missing_ok=True)
    return out


def set_build_dir(path) -> bool:
    """Build into and load from `path` (created) instead of BUILD_DIR's
    default.

    The first directory wins for the process: returns True when the build
    directory is (now) `path`, False when another directory was pinned
    before or the library was already loaded from another directory."""
    global BUILD_DIR, _PINNED_DIR
    path = pathlib.Path(path).resolve()
    with _LOCK:
        if _PINNED_DIR is not None:
            return _PINNED_DIR == path
        if _LIB is not None and BUILD_DIR.resolve() != path:
            return False
        path.mkdir(parents=True, exist_ok=True)
        BUILD_DIR = _PINNED_DIR = path
        return True


def load() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    global _LIB
    if _LIB is not None:
        return _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            for name, (args, res) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(args)
                fn.restype = res
            _LIB = lib
    return _LIB
