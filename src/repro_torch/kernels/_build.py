"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` into its own shared library with a
plain C interface, loaded through ctypes.  Libraries land in ``build/``
beside this file (git-ignored), named by a hash of the source text and
the flags, so an edited source is rebuilt and an unchanged one is
reused.  The hash covers every header in ``csrc/`` too (the ``*.cuh``
files the sources include), so an edited header cannot leave a stale
library behind.  Every source that is not built yet is compiled at
once, one ``nvcc`` process each, on first use.  A failed build raises:
no caller falls back to a kernel's plain version because its library is
missing.

Nothing here runs at import time; the CPU tests import every module of
the package on machines without ``nvcc``.
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
from typing import Dict, List, Tuple

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"

# one shared library per source file
SOURCES: Dict[str, str] = {
    "decode_attention": "decode_attention.cu",
    "deque_round": "deque_round.cu",
    "flash_attention": "flash_attention.cu",
    "flash_attention_sm90": "flash_attention_sm90.cu",
    "frontier": "frontier.cu",
    "frontier_fused": "frontier_fused.cu",
    "semiring": "semiring.cu",
}

NVCC_FLAGS: Tuple[str, ...] = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_loaded: Dict[str, ctypes.CDLL] = {}
# first use may come from a serving worker thread as well as the caller's
# (serving/async_server.py): one thread builds and loads, the rest wait
_load_lock = threading.Lock()


def nvcc_path() -> str:
    """The ``nvcc`` binary: ``$CUDA_HOME/bin/nvcc``, else
    ``/usr/local/cuda/bin/nvcc``, else the one on ``PATH``."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH); the CUDA kernels cannot be built")
    return found


def lib_path(name: str) -> Path:
    """Where the library of source ``name`` is (or will be) built."""
    text = (CSRC / SOURCES[name]).read_bytes()
    for header in sorted(CSRC.glob("*.cuh")):
        text += header.name.encode() + header.read_bytes()
    digest = hashlib.sha1(text + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:12]}.so"


def build_all() -> Dict[str, Tuple[float, str]]:
    """Compile every source whose library is missing, all in parallel.

    Returns ``{name: (seconds, ptxas report)}`` for the sources built by
    this call (empty when all were built already).  Raises RuntimeError
    with the compiler's output when any build fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    jobs: List[Tuple[str, Path, Path, subprocess.Popen, float]] = []
    try:
        for name, src in SOURCES.items():
            out = lib_path(name)
            if out.exists():
                continue
            nvcc = nvcc or nvcc_path()
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            jobs.append((name, out, tmp, proc, time.perf_counter()))
        built: Dict[str, Tuple[float, str]] = {}
        failures = []
        for name, out, tmp, proc, t0 in jobs:
            report, _ = proc.communicate()
            if proc.returncode != 0:
                failures.append(f"nvcc failed for {SOURCES[name]} "
                                f"(exit {proc.returncode}):\n{report}")
                continue
            os.replace(tmp, out)
            built[name] = (time.perf_counter() - t0, report)
    finally:
        for _name, _out, _tmp, proc, _t0 in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if failures:
        raise RuntimeError("\n".join(failures))
    return built


def load(name: str) -> ctypes.CDLL:
    """The loaded library of source ``name``, building it if needed."""
    lib = _loaded.get(name)
    if lib is None:
        with _load_lock:
            lib = _loaded.get(name)
            if lib is None:
                path = lib_path(name)
                if not path.exists():
                    build_all()
                lib = ctypes.CDLL(str(path))
                _loaded[name] = lib
    return lib


def stream(device: torch.device) -> int:
    """The ``cudaStream_t`` of the current stream on ``device``, the stream
    every kernel launches on, read on every call.  The raw read skips the
    Stream object that ``torch.cuda.current_stream(device).cuda_stream``
    builds, which costs more host time than a launch (PERF.md,
    ``tools/wrapper_host_cost.py``)."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)


def check(status: int, kernel: str) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if status != 0:
        raise RuntimeError(f"CUDA launch of {kernel} failed with "
                           f"cudaError_t {status}")
