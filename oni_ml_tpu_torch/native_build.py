"""Build and load the port's native (C++) host libraries.

Each translation unit under `oni_ml_tpu_torch/native_src/` (the flow and
DNS featurizers, the corpus ingest, the row/model/word-count emitters and
the fused gather-dot) is compiled on first use with g++ into a shared
library with a plain C interface and loaded with ctypes (port of
oni_ml_tpu/native_build.py, built in the pattern of ops/_cuda.py):

    g++ -O2 -std=c++17 -fPIC -shared -ffp-contract=off -pthread \\
        -o build/oni_ml_tpu_torch/native/libonitorch_<name>-<hash>.so <src>

`-ffp-contract=off` keeps the arithmetic unfused, as CPython's is: the
DNS entropy and the gather-dot's sums are bit-identical to the Python
paths.  The library is named by a hash of its source, common.h and the
flags, so an edited source never loads a stale build; it is written
under a temporary name and renamed into place, and processes that
need one library at once take turns on a lock file, so the first
builds it and the others load its result.

There is no silent fallback: a failed build, load or symbol
configuration raises, naming the library and the compiler's output.
`ONI_ML_TPU_NO_NATIVE=1` is the one way onto the pure-Python paths
(`enabled()` is then False and no library is built).  Nothing here runs
at import time.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
import time
from typing import Callable

import numpy as np

SRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "native_src")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "build", "oni_ml_tpu_torch", "native")
GXX_FLAGS = ["-O2", "-std=c++17", "-fPIC", "-shared", "-ffp-contract=off",
             "-pthread"]
# Library name -> its translation unit under native_src/.
SOURCES = {"flow": "flow_featurize.cpp", "dns": "dns_featurize.cpp",
           "ingest": "corpus_ingest.cpp", "emit": "row_emit.cpp"}
# name -> {"seconds": build wall (0.0 when it was built already)}
BUILD_INFO: "dict[str, dict]" = {}
# Libraries this process compiled (a cached build adds nothing):
# plans/warmup.compile_counts reads it.
BUILDS = 0


def enabled() -> bool:
    """False when ONI_ML_TPU_NO_NATIVE is set: the pure-Python paths."""
    return not os.environ.get("ONI_ML_TPU_NO_NATIVE")


# PyBytes_FromStringAndSize with a true Py_ssize_t size.  CPython's
# ctypes.string_at truncates its size argument to a C `int`, so a native
# buffer of 2 GiB or more would arrive as a negative size.  A private
# prototype (PYFUNCTYPE holds the GIL): setting restype/argtypes on
# ctypes.pythonapi.<symbol> would change a process-wide object.
_PyBytes_FromStringAndSize = ctypes.PYFUNCTYPE(
    ctypes.py_object, ctypes.c_void_p, ctypes.c_ssize_t
)(("PyBytes_FromStringAndSize", ctypes.pythonapi))


def bytes_at(ptr, size: int) -> bytes:
    """64-bit-safe ctypes.string_at(ptr, size): `size` bytes from the
    native pointer as a bytes object."""
    if not size:
        return b""
    if not ptr:
        raise MemoryError("native buffer pointer is NULL")
    return _PyBytes_FromStringAndSize(ptr, size)


def narrow_counts_i32(counts: np.ndarray) -> np.ndarray:
    """int64 C-side counts -> int32 storage, checked: astype would wrap
    silently on overflow and corrupt the corpus counts."""
    if counts.size and int(counts.max()) >= 2**31:
        raise OverflowError(
            f"per-(ip, word) event count {int(counts.max())} exceeds "
            "int32 storage; widen wc_count to int64 before aggregating "
            "inputs this large")
    return counts.astype(np.int32, copy=False)


def source_digest(name: str) -> str:
    """The build hash of library `name`: its source, common.h and the
    flags."""
    digest = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    for part in (SOURCES[name], "common.h"):
        with open(os.path.join(SRC_DIR, part), "rb") as f:
            digest.update(part.encode() + b"\0" + f.read())
    return digest.hexdigest()[:16]


def lib_path(name: str) -> str:
    """Where library `name` lands: a basename no other package's library
    has (glibc's dlopen matches loaded objects by name)."""
    return os.path.join(BUILD_DIR,
                        f"libonitorch_{name}-{source_digest(name)}.so")


def _compile_cmd(name: str, out: str) -> list:
    return ["g++", *GXX_FLAGS, "-o", out,
            os.path.join(SRC_DIR, SOURCES[name])]


def build(names) -> None:
    """Compile every library of `names` not built yet, one g++ each, all
    started together.  Raises RuntimeError naming each library whose
    build failed and the compiler's output."""
    global BUILDS
    todo = {n: lib_path(n) for n in names}
    todo = {n: p for n, p in todo.items() if not os.path.exists(p)}
    for n in set(names) - set(todo):
        BUILD_INFO.setdefault(n, {"seconds": 0.0})
    if not todo:
        return
    os.makedirs(BUILD_DIR, exist_ok=True)
    locks = {}
    try:
        for n, path in sorted(todo.items()):
            # Another process building the same hash holds this lock
            # until its library is in place: wait, then reuse it.
            locks[n] = open(path + ".lock", "w")
            fcntl.flock(locks[n], fcntl.LOCK_EX)
        t0 = time.perf_counter()
        procs = {}
        for n, path in todo.items():
            if os.path.exists(path):
                BUILD_INFO.setdefault(n, {"seconds": 0.0})
                continue
            tmp = f"{path}.{os.getpid()}.tmp"
            try:
                procs[n] = (tmp, subprocess.Popen(
                    _compile_cmd(n, tmp), stdout=subprocess.PIPE,
                    stderr=subprocess.STDOUT, text=True))
            except OSError as e:
                procs[n] = (tmp, e)
        failed = []
        for n, (tmp, proc) in procs.items():
            if isinstance(proc, OSError):
                failed.append(f"g++ could not start for native_src/"
                              f"{SOURCES[n]} ({lib_path(n)}): {proc}")
                continue
            out, _ = proc.communicate()
            if proc.returncode != 0:
                if os.path.exists(tmp):
                    os.remove(tmp)
                failed.append(f"g++ failed for native_src/{SOURCES[n]} "
                              f"({lib_path(n)}), exit {proc.returncode}:"
                              f"\n{out}")
                continue
            os.replace(tmp, todo[n])
            BUILD_INFO[n] = {"seconds": time.perf_counter() - t0}
            BUILDS += 1
        if failed:
            raise RuntimeError("\n".join(failed))
    finally:
        for f in locks.values():
            f.close()


class NativeLib:
    """Lazy, thread-safe loader of one native library: built on first
    use, loaded, and its symbols configured by `configure`."""

    def __init__(self, name: str, configure: Callable[[ctypes.CDLL], None]):
        self.name = name
        self._configure = configure
        self._lock = threading.Lock()
        self._lib: "ctypes.CDLL | None" = None

    def load(self) -> ctypes.CDLL:
        """The configured library; raises RuntimeError when the build,
        the load or the symbol configuration fails."""
        if self._lib is not None:
            return self._lib
        with self._lock:
            if self._lib is None:
                build([self.name])
                path = lib_path(self.name)
                try:
                    lib = ctypes.CDLL(path)
                    self._configure(lib)
                except (OSError, AttributeError) as e:
                    raise RuntimeError(
                        f"native library {path} failed to load or "
                        f"configure: {e}") from e
                self._lib = lib
        return self._lib

    def load_enabled(self) -> "ctypes.CDLL | None":
        """load(), or None under ONI_ML_TPU_NO_NATIVE."""
        return self.load() if enabled() else None
