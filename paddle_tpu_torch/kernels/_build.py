"""Build and load the port's CUDA kernels.

Every ``csrc/<name>.cu`` is a source with a plain C interface (it may
include the shared headers ``csrc/*.cuh``).  At first use it is compiled with ``nvcc`` for Hopper
(``sm_90a``) into ``build/lib<name>.so`` beside this file, and loaded
with ``ctypes``; the wrapper in the kernel's module declares the
function's argument types and passes tensor pointers, ints and
PyTorch's current stream (:func:`current_stream`).  A source newer than
its library is rebuilt.

Every source links against the CUDA runtime only.  A kernel that needs
a driver-API function (the TMA descriptors of the bfloat16 flash
kernels, ``cuTensorMapEncodeTiled`` in ``csrc/sm90.cuh``) reaches it
through the runtime's ``cudaGetDriverEntryPoint``, so no source needs
``-lcuda``.

Nothing is compiled when a module is imported: the CPU tests import
every module on a machine with no ``nvcc``.  :func:`build_all` starts
one ``nvcc`` per source, all at once, so a fresh checkout pays the
slowest build rather than their sum.
"""
from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, List, Optional

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(HERE, "csrc")
BUILD_DIR = os.path.join(HERE, "build")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# name -> {"seconds": build wall, "log": nvcc/ptxas output} for builds
# made by this process (empty for a library that was already current)
build_info: Dict[str, dict] = {}


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin/nvcc``, else the one on PATH,
    else the toolkit's default install location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: set CUDA_HOME or put the CUDA "
                       "toolkit's bin directory on PATH")


def sources() -> List[str]:
    """Kernel names, one per ``csrc/*.cu``."""
    return sorted(os.path.splitext(os.path.basename(p))[0]
                  for p in glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def lib_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def _current(name: str) -> bool:
    """The library exists and is newer than its source and every shared
    header (``csrc/*.cuh``)."""
    out = lib_path(name)
    deps = [os.path.join(CSRC_DIR, f"{name}.cu"),
            *glob.glob(os.path.join(CSRC_DIR, "*.cuh"))]
    return (os.path.exists(out)
            and os.path.getmtime(out) >= max(map(os.path.getmtime, deps)))


def _start(name: str):
    """Start one nvcc into a private temp file (renamed into place on
    success, so a concurrent loader never sees a half-written .so)."""
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    if not os.path.exists(src):
        raise FileNotFoundError(f"no kernel source {src}")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib_path(name)}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, src]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, cmd


def _finish(name: str, proc, tmp: str, cmd, t0: float) -> None:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"nvcc failed for {name} (exit "
                           f"{proc.returncode}): {' '.join(cmd)}\n{log}")
    os.replace(tmp, lib_path(name))
    build_info[name] = {"seconds": time.perf_counter() - t0, "log": log}


def build_all(names: Optional[List[str]] = None) -> Dict[str, float]:
    """Compile every stale kernel library, one nvcc per source started
    together; returns {name: build seconds} for those it built."""
    names = sources() if names is None else list(names)
    with _lock:
        t0 = time.perf_counter()
        started = [(n, *_start(n)) for n in names if not _current(n)]
        errors = []
        for n, proc, tmp, cmd in started:
            try:
                _finish(n, proc, tmp, cmd, t0)
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))
        return {n: build_info[n]["seconds"] for n, *_ in started}


def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built first if it is missing or
    older than its source.  Raises if the build fails."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            if not _current(name):
                t0 = time.perf_counter()
                _finish(name, *_start(name), t0)
            lib = ctypes.CDLL(lib_path(name))
            _libs[name] = lib
    return lib


def current_stream(t: torch.Tensor) -> int:
    """PyTorch's current stream on the card of CUDA tensor ``t``, as the
    raw ``cudaStream_t`` a kernel's C entry takes, looked up without
    building a ``torch.cuda.Stream`` object."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


__all__ = ["BUILD_DIR", "CSRC_DIR", "build_all", "build_info",
           "current_stream", "load", "lib_path", "nvcc", "sources"]
