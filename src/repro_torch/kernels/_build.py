"""Build and load the port's CUDA kernels: ``nvcc`` -> shared library -> ctypes.

Every ``csrc/<name>.cu`` exposes a plain C interface (pointers and the CUDA
stream as ``void*``, every entry returning ``cudaGetLastError()``), so it
compiles in seconds without PyTorch's headers. At first use it is built
into ``build/kernels/lib<name>-<hash>.so`` under the checkout's git-ignored
``build/`` directory (``$REPRO_TORCH_BUILD_DIR`` overrides the directory);
the hash covers the source and the compiler flags, so an edited kernel is
rebuilt and a stale library is never loaded.

Nothing here runs at import time: the CPU test suite imports every module
of the port on a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("fused_reductions", "block_reductions", "spmv_bcsr")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # per-kernel registers/spills, kept in the build log
)
BUILD_DIR_ENV = "REPRO_TORCH_BUILD_DIR"

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    env = os.environ.get(BUILD_DIR_ENV)
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / "kernels"


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [os.path.join(home, "bin", "nvcc")] if home else []
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError(
        "nvcc not found: the port's CUDA kernels are compiled from source at "
        "first use (set CUDA_HOME or put the CUDA toolkit's nvcc on PATH)"
    )


def target(name: str) -> tuple[Path, Path]:
    """``(source, library path)`` for kernel source ``name``."""
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return src, build_dir() / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=SOURCES) -> dict[str, tuple[float, str]]:
    """Compile every missing library in ``names``, one ``nvcc`` per source,
    all started together. Returns ``{name: (seconds, nvcc output)}`` for the
    sources compiled now; raises with the compiler output on failure."""
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        src, so = target(name)
        if so.exists():
            continue
        so.parent.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ), tmp, so)
    done = {}
    errors = []
    for name, (proc, tmp, so) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu (rc {proc.returncode}):\n{out}")
            continue
        os.replace(tmp, so)  # atomic: a concurrent loader never sees half a file
        done[name] = (time.perf_counter() - t0, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return done


def library(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library for ``name`` (built first if missing), with
    ``argtypes``/``restype`` set from ``signatures``: ``{symbol: argtypes}``,
    every symbol returning a C ``int``."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            _, so = target(name)
            if not so.exists():
                build((name,))
            lib = ctypes.CDLL(str(so))
            for sym, argtypes in signatures.items():
                fn = getattr(lib, sym)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            _LIBS[name] = lib
        return lib


def check(rc: int, what: str) -> None:
    """Raise on a non-zero ``cudaGetLastError()`` code from a C entry."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed, cudaError_t {rc}")
