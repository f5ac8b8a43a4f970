"""Serving warm-up, the compilation cache and the build counters (port
of oni_ml_tpu/plans/warmup.py's `warmup_serving`,
`setup_compilation_cache`, `compile_counts` and `counts_delta`).

The JAX package compiles the serving scorer's padded micro-batch
programs ahead of the first event (one per power-of-two shape from the
dispatch break-even through max_batch) into a persistent compilation
cache.  PyTorch eager compiles nothing, so the port's warm-up runs
scoring.device_scores once at each of those sizes on the served model:
the model's one upload (cached on the model) and the first launches,
pinned staging buffers and allocator blocks of each size happen before
the stream's first flush instead of inside it.  No CUDA-graph capture
(ROADMAP Queue 1 item 4(b)).

The port's counterpart of the JAX package's persistent XLA compilation
cache is its build directory, `build/oni_ml_tpu_torch/` (ops/_cuda.py
and native_build.py `BUILD_DIR`): a library built there by any earlier
process loads without a compile.  `compilation_cache(False)`
(`--no-compilation-cache`) points both build directories at a
run-scoped temporary directory, so every library the process has not
loaded yet builds cold, as the JAX flag gives a cold compile; a library
already loaded in the process stays loaded, as the JAX flag leaves the
in-process compile cache alone.  A failed build still raises.

`compile_counts` counts what the port compiles at run time instead of
the JAX package's traces: the CUDA kernel libraries (one nvcc each) and
the C++ host libraries (one g++ each) this process built, and the
libraries it found built already (`cache_hits`).  The continuous
service's `retraces_after_warmup` is the `builds` delta past the
warm-up boundary.
"""

from __future__ import annotations

import contextlib
import os
import shutil
import tempfile
import time

import numpy as np


def warmup_serving(model, max_batch: int, device_min, device=None) -> dict:
    """Run device_scores on `device` once at every power-of-two flush
    size the dispatch rule (scoring.use_device_path) would send there,
    from the smallest such size up to the power of two at or above
    max_batch (device_scores pads a flush to the next power of two).
    -> {"warmed": count, "sizes": [...], "wall_s": seconds}, or
    {"warmed": 0, "reason": ...} when the rule pins the host."""
    from ..scoring.score import device_scores, use_device_path

    t0 = time.perf_counter()
    hi = 1 << max(0, max_batch - 1).bit_length()
    sizes = []
    m = 1
    while m <= hi:
        if use_device_path(min(m, max_batch), device_min, device):
            sizes.append(m)
        m <<= 1
    if not sizes:
        return {"warmed": 0, "reason": "host path pinned"}
    for m in sizes:
        idx = np.zeros(m, np.int32)
        device_scores(model, idx, idx, device=device)
    return {"warmed": len(sizes), "sizes": sizes,
            "wall_s": round(time.perf_counter() - t0, 6)}


def compile_counts() -> dict:
    """Cumulative per-process build counters: `kernel_builds` (CUDA
    libraries), `native_builds` (C++ host libraries), `builds`, their
    sum, and `cache_hits`, the libraries found built already in the
    build directory (each once per directory)."""
    from .. import native_build
    from ..ops import _cuda

    kernel, native = _cuda.BUILDS, native_build.BUILDS
    return {"kernel_builds": kernel, "native_builds": native,
            "builds": kernel + native,
            "cache_hits": _cuda.CACHE_HITS + native_build.CACHE_HITS}


@contextlib.contextmanager
def compilation_cache(enabled: bool = True):
    """Scope one run's build directory.  Enabled: the persistent one.
    Disabled: both build directories point at a fresh temporary
    directory for the scope, removed after it.  Yields the record the
    runner's `plans` record carries: {"enabled", "dir"}."""
    from .. import native_build
    from ..ops import _cuda

    if enabled:
        yield {"enabled": True, "dir": _cuda.BUILD_DIR}
        return
    tmp = tempfile.mkdtemp(prefix="oni_torch_build_")
    saved = _cuda.BUILD_DIR, native_build.BUILD_DIR
    _cuda.BUILD_DIR = tmp
    native_build.BUILD_DIR = os.path.join(tmp, "native")
    try:
        yield {"enabled": False, "dir": tmp}
    finally:
        _cuda.BUILD_DIR, native_build.BUILD_DIR = saved
        shutil.rmtree(tmp, ignore_errors=True)


def counts_delta(before: dict) -> dict:
    """compile_counts() now, less `before`, key by key."""
    now = compile_counts()
    return {k: now[k] - before.get(k, 0) for k in now}
