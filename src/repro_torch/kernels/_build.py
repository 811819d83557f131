"""Build and load the hand-written CUDA kernels (nvcc by hand, bound with ctypes).

The sources under `kernels/csrc/` compile with nvcc into a shared library
with a plain C interface, in `build/repro_torch/` at the root of the
checkout (a cache: delete it freely). The library's file name carries a hash
of the sources, so an edited source rebuilds at first use and an unchanged
one loads the cached build. Nothing is built at import time: `load()` builds
on the first kernel launch.

A build that fails raises with nvcc's output; there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
SOURCES = ("sto_rk4.cu",)
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ("-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIB = None
# what the last build printed (ptxas registers / shared memory / spills);
# None when the library came from the cache
BUILD_LOG = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "sto_tile_n": ((), _I),
    "sto_tile_e": ((), _I),
    "sto_rk4_coop": (
        (_I, _P, _P, _P, ctypes.c_longlong, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _F, _P),
        _I,
    ),
    "sto_field_tiled": ((_I, _P, _P, _P, _P, _P, _P, _P, _F, _I, _I, _I, _P), _I),
}


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


def build() -> pathlib.Path:
    """Compile the sources if no library with their hash exists; return its path."""
    global BUILD_LOG
    out = BUILD_DIR / f"libsto_rk4_{_source_hash()}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *ARCH_FLAGS, *NVCC_FLAGS, "-o", str(tmp), *(str(CSRC / s) for s in SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    BUILD_LOG = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{BUILD_LOG}")
    os.replace(tmp, out)  # atomic: a concurrent build never loads a partial file
    return out


def load() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        for name, (args, res) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(args)
            fn.restype = res
        _LIB = lib
    return _LIB
