"""Builds the port's CUDA sources (``csrc/*.cu``) and loads them with ctypes.

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, at first use, into ``build/kernels/`` at the
root of the checkout (listed in ``.gitignore``). The library's file name
carries a hash of the source and the flags, so an edited source is
rebuilt and a stale library is never loaded. No PyTorch headers are
included, which keeps a build to seconds.
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
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


class Built(NamedTuple):
    name: str
    path: Path
    seconds: float  # 0.0 when an up-to-date library was already there
    log: str        # nvcc's output (ptxas resource usage when verbose)


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in (shutil.which("nvcc"),
                 cuda_home and os.path.join(cuda_home, "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: install the CUDA toolkit or set "
                       "CUDA_HOME to build the port's kernels")


def _target(name: str, src: bytes) -> Path:
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build_all(names: Optional[Sequence[str]] = None,
              verbose: bool = False) -> List[Built]:
    """Compile the named sources (default: every ``csrc/*.cu``), one
    ``nvcc`` per source, all started together. ``verbose`` adds
    ``-Xptxas=-v`` and always recompiles, so the log shows each kernel's
    registers, shared memory and spills."""
    if names is None:
        names = sorted(p.stem for p in CSRC_DIR.glob("*.cu"))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    jobs = []
    for name in names:
        src = CSRC_DIR / f"{name}.cu"
        out = _target(name, src.read_bytes())
        if out.exists() and not verbose:
            jobs.append((name, out, None, None, 0.0))
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, *(["-Xptxas=-v"] if verbose else []),
               "-o", str(tmp), str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((name, out, tmp, proc, time.perf_counter()))
    built = []
    for name, out, tmp, proc, t0 in jobs:
        if proc is None:
            built.append(Built(name, out, 0.0, ""))
            continue
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu "
                               f"(exit {proc.returncode}):\n{log}")
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half
        built.append(Built(name, out, seconds, log))
    return built


def load(name: str, bind: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed.
    ``bind`` declares the C functions' ``argtypes``/``restype`` once."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            (built,) = build_all([name])
            lib = ctypes.CDLL(str(built.path))
            bind(lib)
            _libs[name] = lib
        return lib
