"""Build and load the port's hand-written CUDA kernels.

Each source under `oni_ml_tpu_torch/csrc/` is compiled on first use with
nvcc into a shared library with a plain C interface and loaded with
ctypes (no PyTorch headers, so a build takes seconds, not minutes):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o <build>/lib<name>-<hash>.so <src>

The library lands in `build/oni_ml_tpu_torch/` under the checkout, named
by a hash of its source, the shared headers (csrc/*.cuh) and the flags,
so an edited source or header never loads a stale build.  `build()`
compiles several libraries in parallel, one nvcc each.  A library is a
source compiled as it is, or one of its VARIANTS: the same source with
a define that picks another instantiation (the bf16 storage mode's), so
that the instantiations build in parallel, not one after the other in
one nvcc.  Nothing here runs at import time: the CPU tests import every
module on a machine with no nvcc.

The build directory is the port's compilation cache: a library found
there is a cache hit (`CACHE_HITS`), one compiled is a build
(`BUILDS`).  `--no-compilation-cache` points `BUILD_DIR` at a run-scoped
temporary directory for the run (plans/warmup.compilation_cache), so
every library the process has not loaded yet builds cold.
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

# Library name -> (its source under csrc/, the defines it is compiled
# with): the bf16 storage mode's instantiations (csrc/sparse_estep.cu
# ONI_TABLE_BF16; csrc/dense_estep.cu ONI_DENSE_MODE 2 over a bf16
# corpus, 1 over a float corpus).  Any other name is csrc/<name>.cu as
# it is.
VARIANTS = {
    "sparse_estep_bf16": ("sparse_estep", ("-DONI_TABLE_BF16",)),
    "dense_estep_bf16": ("dense_estep", ("-DONI_DENSE_MODE=2",)),
    "dense_estep_bf16_f32corpus": ("dense_estep", ("-DONI_DENSE_MODE=1",)),
}

_LOADED: "dict[str, ctypes.CDLL]" = {}
# name -> {"seconds": build wall (0.0 when cached), "ptxas": compiler log}
BUILD_INFO: "dict[str, dict]" = {}
# Libraries this process compiled (a cached build adds nothing), and
# libraries it found built already, each counted once per build
# directory: plans/warmup.compile_counts reads both.
BUILDS = 0
CACHE_HITS = 0
_HIT: "set[str]" = set()


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _source(name: str) -> "tuple[str, tuple]":
    """(source name under csrc/, defines) of library `name`."""
    return VARIANTS.get(name, (name, ()))


def source_digest(name: str) -> str:
    """The build hash of library `name`: its source, every shared header
    (csrc/*.cuh), the flags and its defines.  Names the library, and keys
    what was measured with it (the engine crossover's plan entries)."""
    src, defines = _source(name)
    digest = hashlib.sha256(" ".join([*NVCC_FLAGS, *defines]).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for part in [f"{src}.cu", *headers]:
        with open(os.path.join(CSRC, part), "rb") as f:
            digest.update(part.encode() + b"\0" + f.read())
    return digest.hexdigest()[:16]


def _lib_path(name: str) -> str:
    """Where csrc/<name>.cu's library lands, named by its build hash, so
    an edited source or header never loads a stale build."""
    return os.path.join(BUILD_DIR, f"lib{name}-{source_digest(name)}.so")


def estep_kernels() -> str:
    """The build hashes of the three E-step kernels, which key the plan
    entries of values measured through them (the EM chunk and sync)."""
    return "+".join(source_digest(name) for name in
                    ("sparse_estep", "dense_estep", "fixed_point_estep"))


def build(names) -> None:
    """Compile every library of `names` that is not built yet, one nvcc
    per library, all started together."""
    global BUILDS, CACHE_HITS
    todo = {}
    for name in names:
        lib = _lib_path(name)
        if os.path.exists(lib):
            BUILD_INFO.setdefault(name, {"seconds": 0.0, "ptxas": "cached"})
            if lib not in _HIT:
                _HIT.add(lib)
                CACHE_HITS += 1
        else:
            todo[name] = lib
    if not todo:
        return
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    procs = {}
    for name, lib in todo.items():
        src, defines = _source(name)
        procs[name] = subprocess.Popen(
            [nvcc, *NVCC_FLAGS, *defines, "-o", f"{lib}.{os.getpid()}.tmp",
             os.path.join(CSRC, f"{src}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    failed = []
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            src, defines = _source(name)
            failed.append(f"nvcc failed for csrc/{src}.cu {' '.join(defines)}"
                          f":\n{out}")
            continue
        os.replace(f"{todo[name]}.{os.getpid()}.tmp", todo[name])
        BUILD_INFO[name] = {"seconds": time.perf_counter() - t0, "ptxas": out}
        BUILDS += 1
        _HIT.add(todo[name])
    if failed:
        raise RuntimeError("\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The loaded library `name`, built on first use."""
    if name not in _LOADED:
        build([name])
        lib = ctypes.CDLL(_lib_path(name))
        lib.oni_cuda_error_string.restype = ctypes.c_char_p
        lib.oni_cuda_error_string.argtypes = [ctypes.c_int]
        _LOADED[name] = lib
    return _LOADED[name]


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        msg = lib.oni_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def check_operands(dev, operands) -> None:
    """What a kernel takes: every (name, tensor, dtype, shape) operand
    on `dev`, of its dtype and shape, and contiguous; raises otherwise."""
    for name, t, dtype, shape in operands:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def ptr(t) -> "int | None":
    """A tensor's device pointer for ctypes (None: a null pointer)."""
    return None if t is None else t.data_ptr()


class ExecutedCounters:
    """Per-device int32 counters that a kernel adds one to when a launch
    runs past the chunk driver's stop check (csrc/estep_common.cuh
    count_executed): `slot(dev, i)` is the pointer of counter i on
    `dev`; `read()` sums each counter over the devices (a host sync)."""

    def __init__(self, n: int):
        self.n = n
        self._by_device: dict = {}

    def slot(self, dev, i: int) -> int:
        import torch

        idx = dev.index if dev.index is not None else torch.cuda.current_device()
        t = self._by_device.get(idx)
        if t is None:
            t = self._by_device[idx] = torch.zeros(
                self.n, dtype=torch.int32, device=torch.device("cuda", idx))
        # Pointer arithmetic, not t[i]: an indexing op per launch costs
        # host time on a host-bound path.
        return t.data_ptr() + 4 * i

    def read(self) -> list:
        totals = [0] * self.n
        for t in self._by_device.values():
            for i, v in enumerate(t.tolist()):
                totals[i] += v
        return totals

    def reset(self) -> None:
        for t in self._by_device.values():
            t.zero_()
