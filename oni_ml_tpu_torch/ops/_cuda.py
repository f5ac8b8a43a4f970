"""Build and load the port's hand-written CUDA kernels.

Each source under `oni_ml_tpu_torch/csrc/` is compiled on first use with
nvcc into a shared library with a plain C interface and loaded with
ctypes (no PyTorch headers, so a build takes seconds, not minutes):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o <build>/lib<name>-<hash>.so <src>

The library lands in `build/oni_ml_tpu_torch/` under the checkout, named
by a hash of its source and flags, so an edited source never loads a
stale build.  Nothing here runs at import time: the CPU tests import
every module on a machine with no nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

CSRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "build", "oni_ml_tpu_torch")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_LOADED: "dict[str, ctypes.CDLL]" = {}
# name -> {"seconds": build wall (0.0 when cached), "ptxas": compiler log}
BUILD_INFO: "dict[str, dict]" = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _build(name: str) -> str:
    """Compile csrc/<name>.cu unless its library is built; its path."""
    src = os.path.join(CSRC, f"{name}.cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    lib = os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")
    if os.path.exists(lib):
        BUILD_INFO.setdefault(name, {"seconds": 0.0, "ptxas": "cached"})
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", tmp, src],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{proc.stdout}")
    os.replace(tmp, lib)
    BUILD_INFO[name] = {"seconds": time.perf_counter() - t0,
                        "ptxas": proc.stdout}
    return lib


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built on first use."""
    if name not in _LOADED:
        lib = ctypes.CDLL(_build(name))
        lib.oni_cuda_error_string.restype = ctypes.c_char_p
        lib.oni_cuda_error_string.argtypes = [ctypes.c_int]
        _LOADED[name] = lib
    return _LOADED[name]


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        msg = lib.oni_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
