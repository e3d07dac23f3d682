"""Build the port's CUDA sources with ``nvcc`` and load them with ctypes.

Each source under ``kernels/*/csrc/`` exposes a plain C interface and is
compiled on its own into a shared library for ``sm_90a`` (Hopper); it may
include the headers (``*.cuh``) beside it.  A library is built at first
use into ``build/kernels/`` at the root of the checkout, named by a hash of
its source, those headers and the flags, so an edited source or header is
rebuilt and an unchanged one is loaded as is.  :func:`build_all` starts
one ``nvcc`` per source at once and waits for all of them.

Nothing here runs when the module is imported: the CPU tests import every
module of the port on machines without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["SOURCES", "BUILD_DIR", "MAX_SMEM_BYTES", "build_all", "library"]

# Dynamic shared memory a block may use on sm_90 (H100, H200).
MAX_SMEM_BYTES = 232_448

_PKG = Path(__file__).resolve().parent
BUILD_DIR = _PKG.parents[2] / "build" / "kernels"

# library name -> CUDA source
SOURCES = {
    "peel_decode": _PKG / "ldpc_peel" / "csrc" / "peel_decode.cu",
    "seeded_decode": _PKG / "ldpc_peel" / "csrc" / "seeded_decode.cu",
    "seeded_encode": _PKG / "ldpc_peel" / "csrc" / "seeded_encode.cu",
    "replay_decode": _PKG / "ldpc_peel" / "csrc" / "replay_decode.cu",
    "flash_attention": _PKG / "flash_attention" / "csrc" / "flash_attention.cu",
    "block_matmul": _PKG / "block_matmul" / "csrc" / "block_matmul.cu",
    "check_pass": _PKG / "ldpc_peel" / "csrc" / "check_pass.cu",
}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[str, ctypes.CDLL] = {}
# ptxas' report (registers, shared memory, spills) of each library built
# by this process, by name.
build_logs: dict[str, str] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [str(Path(home) / "bin" / "nvcc")] if home else []
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for cand in candidates:
        if cand and Path(cand).is_file():
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "are built from source at first use")


def _target(name: str) -> Path:
    """The library's path, named by a hash of its source, the headers
    beside it (``*.cuh``) and the flags."""
    src = SOURCES[name]
    parts = [src.read_bytes()] + [h.read_bytes() for h in sorted(src.parent.glob("*.cuh"))]
    digest = hashlib.sha256(b"".join(parts) + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_all(names=None) -> dict[str, Path]:
    """Build every library in ``names`` (default: all) that is not built
    yet, one ``nvcc`` process per source, all started together.  Raises
    with the compiler's output if any build fails."""
    names = list(SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {n: _target(n) for n in names}
    procs = {}
    nvcc = None
    try:
        for n, out in targets.items():
            if out.exists():
                continue
            nvcc = nvcc or _nvcc()
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[n])]
            procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT, text=True),
                        tmp)
        failed = []
        for n, (proc, tmp) in procs.items():
            log, _ = proc.communicate()
            build_logs[n] = log
            if proc.returncode != 0:
                failed.append(f"{n} (nvcc exit {proc.returncode}):\n{log}")
            else:
                os.replace(tmp, targets[n])
        if failed:
            raise RuntimeError("CUDA build failed: " + "\n".join(failed))
    finally:
        for proc, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return targets


def library(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        path = build_all([name])[name]
        lib = ctypes.CDLL(str(path))
        _loaded[name] = lib
    return lib
