"""Serving warm-up (port of oni_ml_tpu/plans/warmup.py's
`warmup_serving`).

The JAX package compiles the serving scorer's padded micro-batch
programs ahead of the first event (one per power-of-two shape from the
dispatch break-even through max_batch) into a persistent compilation
cache.  PyTorch eager compiles nothing, so the port's warm-up runs
scoring.device_scores once at each of those sizes on the served model:
the model's one upload (cached on the model) and the first launches,
pinned staging buffers and allocator blocks of each size happen before
the stream's first flush instead of inside it.  No CUDA-graph capture
and no persistent cache (ROADMAP Queue 1 item 4).
"""

from __future__ import annotations

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
