"""ModelRegistry: validated ScoringModel snapshots with an atomic
hot-swap (port of oni_ml_tpu/serving/registry.py).

A day's model arrives as two CSVs (doc_results.csv / word_results.csv,
the lda stage's); the registry turns them into the serving side's unit
of truth: a versioned, validated snapshot that readers treat as
immutable.  `publish` is double-buffered: the swap is one reference
assignment under a lock, so a flush that took the active snapshot before
the swap finishes on the old model while the next flush takes the new
one; the retired snapshot stays pinned as `previous`.

A published ScoringModel carries its own device copies
(scoring.score._device_model caches them on the instance), so each
snapshot uploads once and a refreshed model never scores on another
snapshot's device copies.
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass

import numpy as np

from ..scoring import ScoringModel


@dataclass(frozen=True)
class ModelSnapshot:
    """One published model: readers treat every field as immutable."""

    model: ScoringModel
    version: int
    source: str          # the day dir it loaded from, or "refresh-step<N>"
    published_at: float  # time.time() at publish (an epoch stamp)


def validate_model(model: ScoringModel) -> ScoringModel:
    """Refuse a malformed model before it serves: a bad model's failure
    mode is wrong scores, not errors (the fallback rows hide most shape
    bugs).  Raises ValueError; returns the model."""
    theta = np.asarray(model.theta)
    p = np.asarray(model.p)
    if theta.ndim != 2 or p.ndim != 2:
        raise ValueError(
            f"theta/p must be 2-D, got {theta.shape} / {p.shape}")
    if theta.shape[1] != p.shape[1]:
        raise ValueError(
            f"topic-count mismatch: theta has K={theta.shape[1]}, "
            f"p has K={p.shape[1]}")
    if theta.shape[0] != len(model.ip_index) + 1:
        raise ValueError(
            f"theta has {theta.shape[0]} rows for {len(model.ip_index)} "
            "IPs — expected one row per IP plus the fallback row")
    if p.shape[0] != len(model.word_index) + 1:
        raise ValueError(
            f"p has {p.shape[0]} rows for {len(model.word_index)} words "
            "— expected one row per word plus the fallback row")
    if not (np.isfinite(theta).all() and np.isfinite(p).all()):
        raise ValueError("theta/p contain non-finite entries")
    if (theta < 0).any() or (p < 0).any():
        raise ValueError("theta/p contain negative probabilities")
    # Normalization, the fallback rows excluded: theta rows are per-IP
    # topic distributions (an all-zero gamma row legitimately writes
    # zeros) and p columns per-topic word distributions.
    row_sums = theta[:-1].sum(1)
    if ((np.abs(row_sums - 1.0) > 1e-3) & (row_sums != 0)).any():
        raise ValueError(
            "theta rows are not topic distributions (rows must sum to 1, "
            "or to 0 for the reference's all-zero-gamma rows)")
    if p.shape[0] > 1 and (np.abs(p[:-1].sum(0) - 1.0) > 1e-3).any():
        raise ValueError(
            "p columns are not word distributions (each topic's column "
            "must sum to 1 over the vocabulary)")
    return model


class ModelRegistry:
    """Thread-safe registry of the active (and previous) snapshot."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._active: "ModelSnapshot | None" = None
        self._previous: "ModelSnapshot | None" = None
        self._version = 0

    def publish(self, model: ScoringModel, source: str) -> ModelSnapshot:
        """Validate and atomically promote `model`.  Raises (and leaves
        the active snapshot as it was) on a model that fails
        validation: a broken refresh never takes serving down."""
        validate_model(model)
        with self._lock:
            self._version += 1
            snap = ModelSnapshot(model=model, version=self._version,
                                 source=source, published_at=time.time())
            self._previous = self._active
            self._active = snap
        return snap

    def load_day(self, day_dir: str, fallback: float) -> ModelSnapshot:
        """Load a completed day directory's model (doc_results.csv /
        word_results.csv, the files the score stage reads) and publish
        it."""
        doc_path = os.path.join(day_dir, "doc_results.csv")
        word_path = os.path.join(day_dir, "word_results.csv")
        for path in (doc_path, word_path):
            if not os.path.exists(path):
                raise FileNotFoundError(
                    f"{path} missing — {day_dir} is not a completed day "
                    "directory (run the lda stage first)")
        model = ScoringModel.from_files(doc_path, word_path, fallback)
        return self.publish(model, source=day_dir)

    def unload(self) -> "ModelSnapshot | None":
        """Drop the active and previous snapshots from host memory but
        keep the version counter: the residency manager's warm -> cold
        demotion (serving/residency.py).  Returns the snapshot that was
        active, for the caller to checkpoint; `restore` reinstalls it at
        the same version, so a tenant paged cold and back serves the
        same (model, version)."""
        with self._lock:
            snap = self._active
            self._active = None
            self._previous = None
            return snap

    def restore(self, model: ScoringModel, source: str,
                version: int) -> ModelSnapshot:
        """Reinstall an unloaded snapshot without bumping the version,
        the inverse of `unload`.  Validates like publish (a corrupt
        checkpoint must not serve), and refuses to replace a live
        snapshot or to rewind the version counter."""
        validate_model(model)
        with self._lock:
            if self._active is not None:
                raise RuntimeError(
                    "restore() on a loaded registry — unload first "
                    "(publish is the path that bumps versions)")
            if version != self._version:
                raise ValueError(
                    f"restore version {version} != registry version "
                    f"{self._version} — a cold reload must reinstall "
                    "the exact snapshot that was unloaded")
            snap = ModelSnapshot(model=model, version=version,
                                 source=source, published_at=time.time())
            self._active = snap
        return snap

    @property
    def loaded(self) -> bool:
        with self._lock:
            return self._active is not None

    def active(self) -> ModelSnapshot:
        with self._lock:
            if self._active is None:
                raise RuntimeError("no model published; load_day/publish first")
            return self._active

    def previous(self) -> "ModelSnapshot | None":
        with self._lock:
            return self._previous

    @property
    def version(self) -> int:
        with self._lock:
            return self._version
