"""Held-out-likelihood drift detection and the publish gates (port of
oni_ml_tpu/models/drift.py).

A continuous service that hot-swaps a fresh model every half hour has
no human looking at each one, so it needs a mechanical quality gate:

* `DriftDetector.evaluate` scores each window refresh's model by
  held-out per-token log-likelihood (models/evaluate.py document
  completion over a deterministic hash split of the window's
  documents), on `device` (the card unless the caller asks for the
  CPU).
* `check()` compares that number against a rolling-median baseline of
  the detector's own history (replayable from the journal's
  `drift_check` records, so a restarted service resumes its baseline)
  and declares drift when the likelihood regresses by more than
  `tol_nats`.  Drifted refreshes do not enter the baseline.
* `gate()` turns the decision into the publish gate: a drifted model is
  vetoed, journaled as `{"kind": "publish_gate", "action": "vetoed"}`,
  and never reaches `FleetRegistry.publish`, so serving keeps scoring
  bit-identically on the prior version.

Drift also steers the next refresh's training mode: the refresh after a
veto trains fresh (`mode_next == "fresh"`), since warm-starting from
topics that just failed the bar would carry the drift forward.

`QualityGate` is the detection-side twin: every publish candidate is
scored against a pinned labeled-injection suite
(sources/quality.QualitySuite), and a recall@k drop of more than `tol`
below the rolling-median baseline of accepted candidates vetoes the
publish, journaled as `{"kind": "quality_gate", "action": "vetoed"}`.
Same rolling baseline, same no-regressed-entry rule, same journal
replay.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class DriftDecision:
    """One refresh's drift verdict."""

    drifted: bool
    ll: float
    baseline_ll: "float | None"   # rolling-median baseline (None: warming up)
    delta: "float | None"         # ll - baseline (negative = worse)
    history: int                  # baseline depth at decision time
    mode_next: str                # "warm" | "fresh" for the NEXT refresh


class DriftDetector:
    """Rolling held-out-likelihood regression detector over the
    journal's refresh history."""

    def __init__(
        self,
        *,
        tol_nats: float = 0.5,
        history: int = 8,
        min_history: int = 2,
        journal=None,
        recorder=None,
    ) -> None:
        if tol_nats <= 0:
            raise ValueError(f"tol_nats must be > 0, got {tol_nats}")
        if min_history < 1:
            raise ValueError(
                f"min_history must be >= 1, got {min_history}"
            )
        self.tol_nats = float(tol_nats)
        self.min_history = int(min_history)
        self._history: deque = deque(maxlen=max(int(history), 1))
        self._journal = journal
        self._recorder = recorder
        self.checks = 0
        self.drifts = 0
        self.publishes = 0
        self.vetoes = 0
        self._last_drifted = False

    # -- baseline persistence -------------------------------------------

    def prime(self, records) -> int:
        """Rebuild the baseline from replayed journal records (the
        `drift_check` vocabulary): non-drifted checks re-enter the
        rolling history in order.  Returns how many were adopted."""
        n = 0
        for rec in records:
            if rec.get("kind") != "drift_check":
                continue
            ll = rec.get("ll")
            if rec.get("drifted") or not isinstance(ll, (int, float)):
                continue
            self._history.append(float(ll))
            n += 1
        return n

    # -- evaluation ------------------------------------------------------

    def evaluate(
        self,
        log_beta: np.ndarray,
        alpha: float,
        corpus,
        *,
        holdout_frac: float = 0.1,
        batch_size: int = 1024,
        min_bucket_len: int = 16,
        var_max_iters: int = 20,
        var_tol: float = 1e-6,
        device=None,
    ) -> "tuple[float, int]":
        """(held-out per-token LL, held-out doc count) for one refresh:
        document-completion score over a deterministic hash split of
        the window's documents (same salt every refresh, so an IP's
        membership is stable and the series is comparable refresh over
        refresh), on `device` (None: the card)."""
        from ..io import make_batches
        from .evaluate import hash_split, held_out_per_token_ll

        _, held_idx = hash_split(corpus.doc_names, holdout_frac)
        if len(held_idx) == 0:
            # Degenerate tiny window: score every doc rather than none
            # (completion splits tokens per doc, so this stays a
            # meaningful, if optimistic, number).
            held_idx = np.arange(corpus.num_docs)
        held = corpus.select(held_idx)
        batches = make_batches(
            held, batch_size=batch_size, min_bucket_len=min_bucket_len
        )
        ll = held_out_per_token_ll(
            log_beta, alpha, batches,
            var_max_iters=var_max_iters, var_tol=var_tol, device=device,
        )
        return float(ll), int(len(held_idx))

    # -- decision --------------------------------------------------------

    @property
    def baseline(self) -> "float | None":
        if len(self._history) < self.min_history:
            return None
        return float(np.median(np.asarray(self._history, np.float64)))

    def check(self, ll: float, **info) -> DriftDecision:
        """Drift verdict for one refresh's held-out LL; journals the
        `{"kind": "drift_check"}` record.  Extra `info` keys ride the
        record (window span, doc counts)."""
        baseline = self.baseline
        delta = None if baseline is None else float(ll) - baseline
        drifted = delta is not None and delta < -self.tol_nats
        self.checks += 1
        if drifted:
            self.drifts += 1
        else:
            self._history.append(float(ll))
        decision = DriftDecision(
            drifted=drifted,
            ll=float(ll),
            baseline_ll=baseline,
            delta=delta,
            history=len(self._history),
            mode_next="fresh" if drifted else "warm",
        )
        self._last_drifted = drifted
        record = {
            "kind": "drift_check",
            "ll": round(float(ll), 6),
            "baseline_ll": (
                None if baseline is None else round(baseline, 6)
            ),
            "delta": None if delta is None else round(delta, 6),
            "tol_nats": self.tol_nats,
            "drifted": drifted,
            "history": len(self._history),
            **info,
        }
        if self._journal is not None:
            self._journal.append(record)
        rec = self._recorder
        if rec is not None:
            rec.gauge("drift.held_out_ll", float(ll))
            if drifted:
                rec.counter("drift.drifts").add(1)
        return decision

    @property
    def mode(self) -> str:
        """Training mode for the next refresh under the "auto" policy:
        fresh right after a veto (warm-starting from rejected topics
        would carry the drift forward), warm otherwise."""
        return "fresh" if self._last_drifted else "warm"

    # -- the publish gate ------------------------------------------------

    def gate(self, decision: DriftDecision, *, version: int,
             **info) -> bool:
        """True = publish may proceed; False = vetoed.  Either way the
        verdict is journaled as `{"kind": "publish_gate"}`: the record
        that says why serving is still on an older model."""
        ok = not decision.drifted
        if ok:
            self.publishes += 1
        else:
            self.vetoes += 1
        record = {
            "kind": "publish_gate",
            "action": "published" if ok else "vetoed",
            "version": version,
            "ll": round(decision.ll, 6),
            "delta": (
                None if decision.delta is None
                else round(decision.delta, 6)
            ),
            **info,
        }
        if self._journal is not None:
            self._journal.append(record)
        rec = self._recorder
        if rec is not None:
            rec.counter(
                "publish_gate.published" if ok else "publish_gate.vetoed"
            ).add(1)
        return ok


@dataclass(frozen=True)
class QualityDecision:
    """One publish candidate's detection-quality verdict."""

    regressed: bool
    recall: float
    precision: float
    separation: float
    baseline_recall: "float | None"  # rolling median (None: warming up)
    delta: "float | None"            # recall - baseline (negative = worse)
    history: int
    per_scenario: dict


class QualityGate:
    """Rolling recall@k regression gate over a pinned injection suite.

    The suite is any object with an `evaluate(model) -> metrics` hook
    (sources/quality.QualitySuite, or a scripted one).
    Metrics must carry `recall_at_k` / `precision_at_k` /
    `score_separation` and optionally `per_scenario`.  A candidate
    whose recall sits more than `tol` below the rolling-median baseline
    of accepted candidates is vetoed; vetoed candidates never enter the
    baseline, so a weak model cannot drag the bar down to meet it."""

    def __init__(
        self,
        suite,
        *,
        tol: float = 0.25,
        history: int = 8,
        min_history: int = 2,
        journal=None,
        recorder=None,
    ) -> None:
        if tol <= 0:
            raise ValueError(f"tol must be > 0, got {tol}")
        if min_history < 1:
            raise ValueError(
                f"min_history must be >= 1, got {min_history}"
            )
        self.suite = suite
        self.tol = float(tol)
        self.min_history = int(min_history)
        self._history: deque = deque(maxlen=max(int(history), 1))
        self._journal = journal
        self._recorder = recorder
        self.checks = 0
        self.publishes = 0
        self.vetoes = 0

    def prime(self, records) -> int:
        """Rebuild the baseline from replayed `quality_gate` journal
        records: published (non-regressed) checks re-enter the rolling
        history in order.  Returns how many were adopted."""
        n = 0
        for rec in records:
            if rec.get("kind") != "quality_gate":
                continue
            recall = rec.get("recall_at_k")
            if (rec.get("action") != "published"
                    or not isinstance(recall, (int, float))):
                continue
            self._history.append(float(recall))
            n += 1
        return n

    @property
    def baseline(self) -> "float | None":
        if len(self._history) < self.min_history:
            return None
        return float(np.median(np.asarray(self._history, np.float64)))

    def check(self, model) -> QualityDecision:
        """Evaluate one publish candidate against the suite and render
        the regression verdict (no journal write: `gate()` owns the
        record, so the verdict and the action always land together)."""
        metrics = self.suite.evaluate(model)
        recall = float(metrics.get("recall_at_k", 0.0))
        baseline = self.baseline
        delta = None if baseline is None else recall - baseline
        regressed = delta is not None and delta < -self.tol
        self.checks += 1
        if not regressed:
            self._history.append(recall)
        return QualityDecision(
            regressed=regressed,
            recall=recall,
            precision=float(metrics.get("precision_at_k", 0.0)),
            separation=float(metrics.get("score_separation", 0.0)),
            baseline_recall=baseline,
            delta=delta,
            history=len(self._history),
            per_scenario=metrics.get("per_scenario", {}),
        )

    def gate(self, decision: QualityDecision, *, version: int,
             **info) -> bool:
        """True = publish may proceed; False = vetoed.  Journals the
        `{"kind": "quality_gate"}` record either way: the detection
        twin of `publish_gate`."""
        ok = not decision.regressed
        if ok:
            self.publishes += 1
        else:
            self.vetoes += 1
        record = {
            "kind": "quality_gate",
            "action": "published" if ok else "vetoed",
            "version": version,
            "recall_at_k": round(decision.recall, 6),
            "precision_at_k": round(decision.precision, 6),
            "score_separation": round(decision.separation, 6),
            "baseline_recall": (
                None if decision.baseline_recall is None
                else round(decision.baseline_recall, 6)
            ),
            "delta": (
                None if decision.delta is None
                else round(decision.delta, 6)
            ),
            "tol": self.tol,
            "history": decision.history,
            "per_scenario": {
                name: round(float(m.get("recall_at_k", 0.0)), 6)
                for name, m in decision.per_scenario.items()
            },
            **info,
        }
        if self._journal is not None:
            self._journal.append(record)
        rec = self._recorder
        if rec is not None:
            rec.gauge("quality.recall_at_k", decision.recall)
            rec.counter(
                "quality_gate.published" if ok else "quality_gate.vetoed"
            ).add(1)
        return ok
