"""Build the port's native sources into shared libraries and load them.

Each CUDA source ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a``
into ``gru4rec_tpu_torch/_build/<name>-<hash>.so`` at first use, keyed on a
hash of the flags, the source and the shared headers ``csrc/*.cuh``; each
host C++ source ``csrc/<name>.cpp`` (the schedule builder) is compiled by
``g++`` the same way, keyed on its flags and the source alone, and never
reaches ``nvcc``. Both are loaded with ``ctypes``. The sources have a plain
C interface (no PyTorch headers), so a build takes seconds. Nothing here
runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Dict, Iterable

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
SOURCES = ("sparse_update", "proto_adagrad", "score_rank")  # csrc/<name>.cu
HOST_SOURCES = ("scheduler",)  # csrc/<name>.cpp, built by g++
# -fmad=false and no --use_fast_math: the kernels round as the plain torch
# versions they are held against do (one rounding per operation)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC")
# the JAX package's flags for the same schedule builder
GXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-Wall", "-shared")

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    path = shutil.which("nvcc") or (
        os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None)
    if not path or not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return path


def _gxx() -> str:
    path = shutil.which("g++")
    if not path:
        raise RuntimeError("g++ not found: the host C++ sources need a C++ compiler")
    return path


def _lib_path(name: str) -> str:
    if name in HOST_SOURCES:
        digest = hashlib.sha256(" ".join(GXX_FLAGS).encode())
        deps = [name + ".cpp"]
    else:
        digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
        deps = [name + ".cu", *headers]  # a source and every header it may include
    for src in deps:
        with open(os.path.join(CSRC_DIR, src), "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def _command(name: str, out: str) -> list:
    if name in HOST_SOURCES:
        return [_gxx(), *GXX_FLAGS, "-o", out, os.path.join(CSRC_DIR, name + ".cpp")]
    return [_nvcc(), *NVCC_FLAGS, "-o", out, os.path.join(CSRC_DIR, name + ".cu")]


def build(names: Iterable[str] = SOURCES) -> None:
    """Compile every named source that has no up-to-date library, with one
    compiler process per source, all started together."""
    pending = [(n, _lib_path(n)) for n in names]
    pending = [(n, p) for n, p in pending if not os.path.exists(p)]
    if not pending:
        return
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = []
    for name, out in pending:
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = _command(name, tmp)
        procs.append((cmd, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    errors = []
    for cmd, out, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{os.path.basename(cmd[0])} failed on {cmd[-1]}:\n{log}")
        else:
            os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    if errors:
        raise RuntimeError("\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` or ``.cpp``, built first if
    needed."""
    lib = _LIBS.get(name)
    if lib is None:
        path = _lib_path(name)
        if not os.path.exists(path):
            build([name])
        lib = ctypes.CDLL(path)
        _LIBS[name] = lib
    return lib
