"""The featurize plane's device programs (port of
oni_ml_tpu/ops/featurize_kernel.py): the word-row gather through a
compiled code table, and the fused featurize + gather + dot (+
threshold) flush, as plain PyTorch ops on tensors of an explicit device.

The heavy part of device featurization is compiling the tables
(sources/device.py: the vocabulary reverse-parsed into packed codes and
a code -> row table).  What is left per flush is gathers:

  * `lut_rows` — device codes -> model word rows (the featurize step
    alone: the on-device mirror of the host's `table.rows_of`);
  * `fused_scores` — the table gather, the theta and p row gathers and
    the K-wide dot (+ the `score < threshold` mask) in one call per
    flush, through the same `scoring.pipeline.score_dot_rows` every
    other device scoring path runs.

The JAX package jits these (`jnp.take`, no Pallas kernel), so the port
owes no hand kernel here.  Operands pad to the next power of two,
floored at the `featurize_block` knob, as the JAX package pads them, so
the cost records and the padded work match its shapes.  Each entry
registers its cost from the shapes (`roofline.register_cost`):
`serve.featurize_rows` and `serve.featurize_fused`.

Numerics: the fused scores are float32 gathers with a float32 k-order
accumulation, within rel 1e-6 of the float64 host oracle at K <= 20 (the
device engine's envelope); the serving default stays the "device"
engine, which gathers rows on the host and keeps the host's scores.
"""

from __future__ import annotations

import numpy as np
import torch


def _pow2(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


def _padded(values, m: int) -> np.ndarray:
    out = np.zeros(m, np.int32)
    out[:len(values)] = values
    return out


def device_lut(dev, device) -> torch.Tensor:
    """The compiled table's int32 `device_rows` (the dense LUT or the
    sparse row array: the gather target either way, see
    sources/device._CodeTable) on `device`, copied once per table and
    device and cached on the table: a table shared by tenants of one
    vocabulary (a rebind) is copied once."""
    cache = dev.table.__dict__.setdefault("_rows_device", {})
    key = str(torch.device(device))
    rows = cache.get(key)
    if rows is None:
        rows = cache[key] = torch.as_tensor(
            dev.table.device_rows, dtype=torch.int32).to(device)
    return rows


def _check_codes(codes: np.ndarray, size: int) -> None:
    # An out-of-range index would assert on the card and take the
    # context down; the table's own codes never are, so this is a bug.
    if len(codes) and (int(codes.min()) < 0 or int(codes.max()) >= size):
        raise IndexError("device code outside the code table")


def lut_rows(dev, codes, *, block: "int | None" = None,
             device=None) -> np.ndarray:
    """Device codes (`table.device_codes` output) -> model word rows,
    gathered on `device` (None: the card)."""
    from ..device import resolve_device
    from ..telemetry import roofline

    n = len(codes)
    if n == 0:
        return np.zeros(0, np.int32)
    device = resolve_device(device)
    lut = device_lut(dev, device)
    codes = np.asarray(codes)
    _check_codes(codes, lut.shape[0])
    m = max(_pow2(n), _pow2(int(block or 1)))
    # Per padded row: the code read, the table row gathered, the row
    # written (int32 each); no arithmetic.
    roofline.register_cost("serve.featurize_rows", flops=0.0,
                           nbytes=12.0 * m, shape=f"n{m}.l{lut.shape[0]}",
                           device=device)
    codes_t = torch.from_numpy(_padded(codes, m)).to(device)
    return lut.index_select(0, codes_t)[:n].cpu().numpy()


def fused_scores(model, dev, codes, ip_idx, word_base: int = 0, *,
                 block: "int | None" = None, threshold=None, stats=None,
                 device=None):
    """The one-call flush: table gather + theta/p gathers + K-wide dot
    (+ the `score < threshold` mask) on `device` (None: the card).

    `codes` / `ip_idx` are a DeviceBatch's device codes and absolute
    theta rows (ip_base applied); `word_base` is added to the gathered
    word rows (a stacked snapshot's offset).  Returns float64 scores
    (drop-in for batched_scores), and with `threshold` the keep mask
    too.  `stats` (pipeline.DispatchStats) counts the dispatch and its
    transfers."""
    from ..device import resolve_device
    from ..scoring.pipeline import score_dot_rows
    from ..scoring.score import _device_model
    from ..telemetry import roofline

    n = len(codes)
    if n == 0:
        empty = np.zeros(0, np.float64)
        return empty if threshold is None else (empty, np.zeros(0, bool))
    device = resolve_device(device)
    theta, p = _device_model(model, device, stats)
    lut = device_lut(dev, device)
    codes = np.asarray(codes)
    ip_idx = np.asarray(ip_idx)
    _check_codes(codes, lut.shape[0])
    rows_max = dev.table.__dict__.get("_rows_max")
    if rows_max is None:
        rows_max = dev.table._rows_max = int(dev.table.device_rows.max())
    if len(ip_idx) != n or int(ip_idx.min()) < 0 \
            or int(ip_idx.max()) >= theta.shape[0] \
            or rows_max + int(word_base) >= p.shape[0] \
            or int(word_base) < 0:
        raise IndexError("model-row index out of range")
    m = max(_pow2(n), _pow2(int(block or 1)))
    k = theta.shape[1]
    es = theta.element_size()
    # Per padded row: the code and the theta row index read, the table
    # row gathered, a theta and a p row of K gathered at the storage
    # width, K multiply-adds, the float32 score (and the mask byte)
    # written.
    roofline.register_cost(
        "serve.featurize_fused", flops=2.0 * k * m,
        nbytes=float(m * (12 + 2 * k * es + 4
                          + (1 if threshold is not None else 0))),
        shape=f"n{m}.l{lut.shape[0]}.ip{theta.shape[0]}.w{p.shape[0]}"
              f".k{k}", device=device)
    if stats is not None:
        stats.dispatches += 1
        stats.events += n
        stats.h2d_bytes += 8 * m
        stats.d2h_bytes += 4 * n
    codes_t = torch.from_numpy(_padded(codes, m)).to(device)
    ip_t = torch.from_numpy(_padded(ip_idx, m)).to(device)
    w = lut.index_select(0, codes_t) + int(word_base)
    scores = score_dot_rows(theta, p, ip_t, w)[:n]
    if threshold is None:
        return scores.cpu().numpy().astype(np.float64)
    keep = scores < torch.tensor(np.float32(threshold), device=device)
    return (scores.cpu().numpy().astype(np.float64),
            keep.cpu().numpy())
