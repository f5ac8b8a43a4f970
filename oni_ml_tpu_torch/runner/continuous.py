"""`ml_ops continuous`: the standing service that removes the day
boundary (port of oni_ml_tpu/runner/continuous.py, single card).

The batch day job's unit of work is one finished day: an event at 00:05
is servable about 24 h later, and every day pays a full EM from scratch.
This runner keeps one standing loop on one process and one card:

    raw slices ──► featurization ──► CorpusWindow (ring-buffered CSR,
       │                              first-seen vocab growth,
       │                              O(evicted) retirement)
       └────────► FleetScorer (events scored under the current model
                  the moment they arrive)

    every refresh_every_s of event time:
        window.advance ─► snapshot (pow2 vocab capacity tier)
        ─► WindowTrainer.fit (warm-started from the previous published
           topics, on the card's E-step kernels; the float64
           convergence check stops after the few iterations the stream
           moved)
        ─► DriftDetector.evaluate/check (held-out per-token LL against
           the journal's rolling history) [─► QualityGate]
        ─► publish gate: a drifted model is vetoed and never reaches
           the FleetRegistry, so serving keeps the prior version
           bit-identically; a healthy one hot-swaps in.

    python -m oni_ml_tpu_torch.runner.ml_ops continuous flow \\
        --flow-path day.csv [--no-sleep] [--device cuda|cpu]
    python -m oni_ml_tpu_torch.runner.ml_ops continuous \\
        --stream acme=flow:a.csv --stream globex=dns:b.csv [--no-cosched]

With `--stream` N tenants compose into one service
(`FleetContinuousService`): ingest and scoring stay on the caller's
thread, refresh fits run on one worker thread, and the CoScheduler
(serving/coscheduler.py) makes each fit yield to scoring at every EM
dispatch boundary.  With `--replicated N` (`replicated=`) the scoring
moves to N spawned replica processes behind a FleetRouter
(`RouterBinding`): each refit publishes through the router to the
tenant's primary and shadow, and a killed replica costs a shadow
promotion, not a score.  Everything runs on the card unless the caller
asks for the CPU (`device=`, `--device cpu`; the replicas get the same
`--device`); nothing falls back.

Refused, naming the ROADMAP item that brings it: distributed window
refreshes (`--multihost`, a collective; Queue 1 item 6).  The JAX package's
compilation cache and compile-listener set-up have no counterpart:
PyTorch eager compiles nothing, and `retraces_after_warmup` counts the
kernel and host-library builds past the warm-up boundary instead
(plans/warmup.compile_counts).
"""

from __future__ import annotations

import argparse
import contextvars
import json
import os
import queue
import threading
import time
from collections import deque
from contextlib import nullcontext
from dataclasses import dataclass

import numpy as np
import torch

from ..config import PipelineConfig
from ..device import resolve_device
from ..io import formats
from ..sources import get as get_source
from ..sources import names as source_names

_NOT_PORTED = {
    "multihost": ("--multihost", "ROADMAP Queue 1 item 6 (multi-GPU "
                  "distributed EM: the collective)"),
}


@dataclass
class IngestSlice:
    """One paced ingest unit: raw event lines covering [t0, t1) of event
    time, stamped with the wall clock it was delivered at."""

    lines: list
    t0: float
    t1: float
    arrival_wall: float = 0.0
    index: int = 0

    @property
    def events(self) -> int:
        return len(self.lines)


def event_time_s(line: str, dsource: str) -> float:
    """Event-time seconds of one raw CSV line, through the source spec's
    clock hook (flow: h/m/s columns; dns: unix_tstamp; declared sources:
    their `time_field`)."""
    return get_source(dsource).event_time_s(line)


def slice_events(
    lines, dsource: str, slice_s: float, *, t_base: "float | None" = None
) -> "list[IngestSlice]":
    """Order raw lines by event time and cut them into fixed
    `slice_s`-second slices: a historical day replayed as a stream.
    Deterministic: stable sort by event time, empty slices dropped.
    Lines whose time columns do not parse (a header row, a truncated
    tail) are skipped, as the featurizers skip garbage rows."""
    if slice_s <= 0:
        raise ValueError(f"slice_s must be > 0, got {slice_s}")
    rows = []
    parsed = []
    for ln in lines:
        if not ln.strip():
            continue
        try:
            parsed.append(event_time_s(ln, dsource))
        except (ValueError, IndexError):
            continue          # header / malformed row: not an event
        rows.append(ln)
    times = np.asarray(parsed, np.float64)
    order = np.argsort(times, kind="stable")
    if t_base is None:
        t_base = float(times[order[0]]) if len(order) else 0.0
    slices: "list[IngestSlice]" = []
    cur: list = []
    cur_idx = 0
    for j in order:
        idx = int((times[j] - t_base) // slice_s)
        if cur and idx != cur_idx:
            slices.append(IngestSlice(
                lines=cur, t0=t_base + cur_idx * slice_s,
                t1=t_base + (cur_idx + 1) * slice_s, index=len(slices),
            ))
            cur = []
        if not cur:
            cur_idx = idx
        cur.append(rows[int(j)])
    if cur:
        slices.append(IngestSlice(
            lines=cur, t0=t_base + cur_idx * slice_s,
            t1=t_base + (cur_idx + 1) * slice_s, index=len(slices),
        ))
    return slices


def paced_slices(slices, speed: float, *, sleep=time.sleep):
    """Deliver slices at `speed` times real time: the wall gap between
    consecutive slices is their event-time gap divided by `speed`.
    Stamps each slice's `arrival_wall` at delivery.  `speed=inf`
    delivers as fast as downstream consumes (the no-sleep mode)."""
    for _, sl in paced_tagged(((None, sl) for sl in slices), speed,
                              sleep=sleep):
        yield sl


@dataclass
class _SliceLedger:
    """Freshness bookkeeping for one ingested slice: arrival wall stamp,
    event count, event-time span end.  The service keeps only slices
    not yet covered by a publish."""

    index: int
    arrival_wall: float
    events: int
    t1: float


def _featurize_slice(lines, dsource: str, cuts):
    """One slice through the source's batch featurizer with pinned cuts
    (a slice's own ECDF would bin values differently slice over slice
    and churn the vocabulary: serving/events.py's rule)."""
    return get_source(dsource).featurize(
        lines, skip_header=False, precomputed_cuts=cuts
    )


def _derive_cuts(lines, dsource: str, qtiles_path: str = ""):
    """Pin the stream's quantile cuts: from a qtiles file when the source
    supports one (stable word identity across service restarts), else
    from the bootstrap slice's own ECDF."""
    return get_source(dsource).derive_cuts(lines, qtiles_path)


class ContinuousService:
    """The standing train-and-serve loop of one tenant on `device` (the
    card unless the caller asks for the CPU).  Drive it with
    `run(slices)` (a paced IngestSlice iterable) or slice by slice via
    `ingest_slice` + `maybe_refresh`.

    Exactly once: every ingested event is counted in one of
    `events_unserved` (it arrived before the first publish: ledger
    only), `events_rejected` (a malformed line, shed) or
    `events_offered` (submitted to the scorer, or to the router); after
    `close()`, `events_scored` and `score_failures` are the scorer's (or
    the router binding's) counts, and `events_scored == events_offered`
    when none failed.  Through the router a malformed line is not shed
    here: the replica refuses it and its future fails."""

    def __init__(
        self,
        config: PipelineConfig,
        dsource: str,
        *,
        out_dir: str,
        tenant: str = "stream",
        fresh_control: bool = False,
        warmup_refreshes: "int | None" = None,
        journal=None,
        recorder=None,
        coscheduler=None,
        publisher=None,
        freshness_sink=None,
        device=None,
    ) -> None:
        """Standalone by default; the fleet injects shared
        infrastructure: one `journal`/`recorder` for every tenant (the
        fleet owns their lifecycle, and this service then scopes its
        histogram names by tenant and never calls run_start/run_end), a
        `coscheduler` (refresh fits yield to slice scoring), a
        `publisher` (a RouterBinding: publishes fan out through the
        replicated router instead of the in-process registry, and slices
        score on the router's replicas) and a `freshness_sink`
        (callable(wall_s, event_s) per covered slice).  The JAX
        package's `collective` (distributed refreshes) is not ported."""
        if dsource not in source_names():
            raise ValueError(
                f"dsource must be one of {'|'.join(source_names())}, "
                f"got {dsource!r}"
            )
        self.config = config
        self.cc = config.continuous
        self.dsource = dsource
        self.device = resolve_device(device)
        self.out_dir = formats.ensure_dir(out_dir)
        self.tenant = tenant
        self.fresh_control = fresh_control
        if warmup_refreshes is None:
            # "Post-warmup" starts once the window first reaches steady
            # state: while it is still filling (the first
            # window_s/refresh_every_s refreshes), a refresh can meet a
            # new capacity tier and build a trainer for it.
            warmup_refreshes = int(
                np.ceil(self.cc.window_s
                        / max(self.cc.refresh_every_s, 1e-9))
            ) + 1
        self.warmup_refreshes = int(warmup_refreshes)

        from ..dataplane import CorpusWindow
        from ..models.drift import DriftDetector
        from ..serving import FleetRegistry, TenantSpec
        from ..telemetry import Journal, Recorder, RunJournal

        self.cosched = coscheduler
        self.publisher = publisher
        self._freshness_sink = freshness_sink
        # Ingest (window growth, ledger append, scoring) and refresh
        # (advance/snapshot, ledger resolution) run on different threads
        # in the fleet; this lock covers the window and ledger.
        self._lock = threading.Lock()
        tel = config.telemetry
        self._owns_journal = journal is None
        # Fleet composition (shared out_dir, maybe-shared recorder):
        # scope histogram names and the metrics filename by tenant.
        self._shared = (journal is not None or publisher is not None
                        or freshness_sink is not None)
        self.journal = None
        self.recorder = None
        if journal is not None:
            self.journal = journal
            self.recorder = recorder
            replayed = []
        elif tel.journal:
            jpath = os.path.join(self.out_dir, "run_journal.jsonl")
            replayed = Journal.replay(jpath)
            self.journal = RunJournal(
                Journal(jpath, fsync_every=tel.journal_fsync_every)
            )
            self.journal.run_start(
                mode="continuous", dsource=dsource, tenant=tenant,
                window_s=self.cc.window_s,
                refresh_every_s=self.cc.refresh_every_s,
                replayed_records=len(replayed), device=str(self.device),
            )
            self.recorder = Recorder(journal=self.journal.journal)
        else:
            replayed = []
        raw_journal = (
            self.journal.journal if self.journal is not None else None
        )
        self.window = CorpusWindow(
            self.cc.window_s, vocab_floor=self.cc.vocab_floor,
            recorder=self.recorder, journal=raw_journal,
        )
        self.drift = DriftDetector(
            tol_nats=self.cc.drift_tol_nats,
            history=self.cc.drift_history,
            min_history=self.cc.drift_min_history,
            journal=raw_journal, recorder=self.recorder,
        )
        # A restarted service resumes its drift baseline from the
        # journal instead of re-learning it over min_history refreshes.
        self.drift.prime(replayed)
        self._replayed = replayed
        self._qgate = None          # built lazily once cuts are pinned
        self.fleet = FleetRegistry(
            journal=raw_journal, recorder=self.recorder,
            capacity_tiers=True,
        )
        self.fleet.add_tenant(TenantSpec(tenant=tenant, dsource=dsource))
        self.scorer = None          # created at first publish
        self.cuts = None            # pinned at bootstrap
        self.trainer = None         # one per vocab capacity tier
        self.tier_rebuilds = 0
        self._prev_probs = None     # last published [V_real, K]
        self._prev_alpha = None
        self._last_fresh_iters = None
        self._next_refresh_t = None
        self._ledger: "list[_SliceLedger]" = []
        from ..telemetry.spans import Recorder as _Recorder

        rec = self.recorder or _Recorder()
        scope = f".{tenant}" if self._shared else ""
        # Two freshness ledgers: wall clock (what this replay measured,
        # speed-dependent) and event time (cadence lag + refresh wall:
        # what a real-time deployment would deliver).
        self._freshness = rec.histogram("continuous.freshness_s" + scope)
        self._freshness_event = rec.histogram(
            "continuous.freshness_event_s" + scope
        )
        # Slice-level serve wall (submit -> flush return), split by
        # whether a refresh fit was active at entry.
        self._serve_idle_ms = rec.histogram(
            "continuous.serve_idle_ms" + scope
        )
        self._serve_refresh_ms = rec.histogram(
            "continuous.serve_refresh_ms" + scope
        )
        self._freshness_count = 0
        # A standing service runs indefinitely: per-refresh detail is
        # bounded (the journal holds the full history); aggregates are
        # running sums.
        self.refresh_records: "deque[dict]" = deque(maxlen=1024)
        self.refresh_count = 0
        self._fit_agg = {
            True: {"fits": 0, "wall_s": 0.0, "em_iters": 0},
            False: {"fits": 0, "wall_s": 0.0, "em_iters": 0},
        }
        self.events = 0
        self.slices = 0
        self.events_rejected = 0
        self.events_offered = 0
        self.events_unserved = 0
        self.events_scored = 0
        self.score_failures = 0
        self.flagged = 0
        self.skipped_refreshes = 0
        self.control_record = None
        self._warmup_counts = None
        self._lda_cfg = None
        self._flagged_file = None
        self._last_ll = None

    # -- per-slice ingest ------------------------------------------------

    def ingest_slice(self, sl: IngestSlice) -> None:
        from ..dataplane import word_count_columns

        if sl.arrival_wall == 0.0:
            sl.arrival_wall = time.perf_counter()
        if self.cuts is None:
            self.cuts = _derive_cuts(sl.lines, self.dsource,
                                     self.config.qtiles_path)
        feats = _featurize_slice(sl.lines, self.dsource, self.cuts)
        with self._lock:
            self.window.ingest(word_count_columns(feats), sl.t0, sl.t1)
            self._ledger.append(_SliceLedger(
                index=sl.index, arrival_wall=sl.arrival_wall,
                events=sl.events, t1=sl.t1,
            ))
        if self._next_refresh_t is None:
            self._next_refresh_t = sl.t1 + self.cc.refresh_every_s
        self.slices += 1
        self.events += sl.events
        self._score_slice(sl)

    def _score_slice(self, sl: IngestSlice) -> None:
        """Every event rides the serving path under the current published
        model the moment it arrives.  Under the co-scheduler this is the
        high-priority side: the serve slot is claimed before submitting,
        so a refresh fit yields at its next dispatch boundary and this
        flush wins the next slot.  `refresh_active` is sampled before
        the slot wait, so a slice arriving while a fit held the device
        is a during-refresh sample.  Flagged events land through the
        scorer's on_batch sink (_start_scorer); a malformed event is
        shed and counted, never allowed to stop the service.  Through
        the router (the binding is ready once the census has published)
        the slice goes out as one submit_many frame and the binding
        resolves its futures off this thread."""
        via_router = (self.publisher is not None
                      and self.publisher.ready(self.tenant))
        if not via_router and self.scorer is None:
            self.events_unserved += sl.events
            return               # nothing published yet: ledger only
        refresh_active = (self.cosched.refresh_active
                          if self.cosched is not None else False)
        # The in-process scorer shares the trainer's stream, so the slot
        # waits out the chunk being enqueued; router scoring is remote,
        # so the slot registers pressure without waiting (the trainer
        # defers its next chunk).
        slot = (self.cosched.serve_slot(wait=not via_router)
                if self.cosched is not None else nullcontext())
        t0 = time.perf_counter()
        with slot:
            if via_router:
                self.publisher.submit_slice(
                    self.tenant, sl, refresh_active=refresh_active)
                self.events_offered += sl.events
            else:
                for ln in sl.lines:
                    try:
                        self.scorer.submit(self.tenant, ln)
                    except ValueError:
                        self.events_rejected += 1
                    else:
                        self.events_offered += 1
                self.scorer.flush()
        wall_ms = (time.perf_counter() - t0) * 1e3
        (self._serve_refresh_ms if refresh_active
         else self._serve_idle_ms).observe(wall_ms)

    def refresh_due(self, now_sim: float) -> bool:
        """Advance the cadence clock; True if `now_sim` crossed a refresh
        boundary.  Ingest thread only: the caller owns running
        `refresh`, possibly on another thread."""
        if (self._next_refresh_t is None
                or now_sim < self._next_refresh_t):
            return False
        while (self._next_refresh_t is not None
               and now_sim >= self._next_refresh_t):
            self._next_refresh_t += self.cc.refresh_every_s
        return True

    def maybe_refresh(self, now_sim: float) -> "dict | None":
        """Run one refresh if `now_sim` crossed the cadence boundary."""
        if not self.refresh_due(now_sim):
            return None
        return self.refresh(now_sim)

    # -- the refresh -----------------------------------------------------

    def _lda_config(self):
        if self._lda_cfg is None:
            import dataclasses

            cc = self.cc
            self._lda_cfg = dataclasses.replace(
                self.config.lda,
                batch_size=cc.batch_size,
                min_bucket_len=cc.min_bucket_len,
                fused_em_chunk=cc.fused_em_chunk,
            )
        return self._lda_cfg

    def refresh(self, now_sim: float) -> dict:
        from ..models.lda import WindowTrainer

        idx = self.refresh_count + self.skipped_refreshes + 1
        with self._lock:
            self.window.advance(now_sim)
            snap = self.window.snapshot()
        corpus = snap.corpus
        if corpus.num_docs < self.cc.min_refresh_docs:
            self.skipped_refreshes += 1
            return {"refresh": idx, "skipped": "window_too_small",
                    "docs": corpus.num_docs}
        cfg = self._lda_config()
        if (self.trainer is None
                or self.trainer.num_terms != corpus.num_terms):
            # One trainer per vocabulary capacity tier: churn inside a
            # tier keeps it (and its resolved E-step engine); crossing a
            # boundary builds exactly one new trainer.
            self.trainer = WindowTrainer(
                cfg, corpus.num_terms, device=self.device,
                yield_hook=(self.cosched.yield_hook
                            if self.cosched is not None else None),
            )
            self.tier_rebuilds += 1
        mode = self._train_mode()
        seed_probs = self._prev_probs if mode == "warm" else None
        seed_alpha = self._prev_alpha if mode == "warm" else None
        refresh_wall0 = time.perf_counter()
        t0 = time.perf_counter()
        # The fit bracket marks this service refresh-active: scoring that
        # lands inside it is a during-refresh latency sample, and the
        # co-scheduler journals the fit's chunk/yield rollup at exit.
        fit_ctx = (self.cosched.train_fit(self.tenant)
                   if self.cosched is not None else nullcontext())
        with fit_ctx:
            result = self.trainer.fit(
                corpus, topic_probs=seed_probs, alpha=seed_alpha,
            )
        train_wall = time.perf_counter() - t0
        ll, held_docs = self.drift.evaluate(
            result.log_beta, result.alpha, corpus,
            holdout_frac=self.cc.holdout_frac,
            batch_size=cfg.batch_size,
            min_bucket_len=cfg.min_bucket_len,
            var_max_iters=cfg.var_max_iters, var_tol=cfg.var_tol,
            device=self.device,
        )
        decision = self.drift.check(
            ll, held_docs=held_docs, docs=corpus.num_docs,
            window_t0=round(snap.t0, 3), window_t1=round(snap.t1, 3),
        )
        version = self._version()
        ok = self.drift.gate(
            decision, version=version, tenant=self.tenant,
            mode=mode, em_iters=result.em_iters,
        )
        publish_wall = None
        quality_info = {}
        if ok:
            model = self._build_model(snap, result)
            qgate = self._quality_gate()
            if qgate is not None:
                qdec = qgate.check(model)
                ok = qgate.gate(
                    qdec, version=version, tenant=self.tenant,
                )
                quality_info = {
                    "quality_recall": round(qdec.recall, 6),
                    "quality_regressed": qdec.regressed,
                }
            if ok:
                self._publish(model, snap)
                publish_wall = time.perf_counter()
                # Drop the fallback row: the [V_real, K] warm-start seed.
                self._prev_probs = np.asarray(model.p[:-1], np.float64)
                self._prev_alpha = result.alpha
        if mode == "fresh":
            self._last_fresh_iters = result.em_iters
        iters_saved = (
            self._last_fresh_iters - result.em_iters
            if mode == "warm" and self._last_fresh_iters is not None
            else None
        )
        fresh = self._freshness_record(publish_wall, now_sim,
                                       refresh_wall0)
        engine = result.plan["estep_engine"]
        record = {
            "refresh": idx,
            "mode": mode,
            "warm_start": mode == "warm",
            "em_iters": result.em_iters,
            "iters_saved": iters_saved,
            "train_wall_s": round(train_wall, 4),
            "held_out_ll": round(ll, 6),
            "held_docs": held_docs,
            "drifted": decision.drifted,
            "published": ok,
            "version": self._version(),
            "docs": corpus.num_docs,
            "vocab": snap.real_vocab,
            "vocab_capacity": snap.vocab_capacity,
            "window_chunks": snap.chunks,
            # The tier's E-step engine, where it was decided, whether
            # this refresh decided it, and the family member that ran.
            "estep_engine": engine["value"],
            "estep_engine_source": engine["source"],
            "estep_resolved": engine["resolved"],
            "member": result.stats["member"],
            **quality_info,
            **fresh,
        }
        self.refresh_records.append(record)
        self.refresh_count += 1
        agg = self._fit_agg[mode == "warm"]
        agg["fits"] += 1
        agg["wall_s"] += train_wall
        agg["em_iters"] += result.em_iters
        self._last_ll = ll
        if (self.fresh_control and self.control_record is None
                and mode == "warm" and ok
                and idx > self.warmup_refreshes):
            self.control_record = self._run_fresh_control(
                corpus, record, seed_probs, seed_alpha
            )
        if (self._warmup_counts is None
                and idx >= self.warmup_refreshes):
            from ..plans import warmup as plans_warmup

            self._warmup_counts = plans_warmup.compile_counts()
        return record

    def _train_mode(self) -> str:
        cc = self.cc
        if cc.warm_start not in ("auto", "always", "never"):
            raise ValueError(
                f"ContinuousConfig.warm_start={cc.warm_start!r}: "
                "expected 'auto', 'always', or 'never'"
            )
        if self._prev_probs is None or cc.warm_start == "never":
            return "fresh"
        if cc.warm_start == "always":
            return "warm"
        return self.drift.mode        # fresh right after a veto

    def _build_model(self, snap, result):
        from ..scoring import ScoringModel

        fallback = get_source(self.dsource).fallback(self.config.scoring)
        corpus = snap.corpus
        # The published model covers the real vocabulary only: the tier's
        # pad words never occur in an event.
        return ScoringModel.from_lda(
            corpus.doc_names,
            result.gamma,
            corpus.vocab[: snap.real_vocab],
            result.log_beta[:, : snap.real_vocab],
            fallback,
        )

    def _version(self) -> int:
        if self.publisher is not None:
            return self.publisher.version(self.tenant)
        return (
            self.fleet.version(self.tenant)
            if self.tenant in self.fleet.tenants() else 0
        )

    def _publish(self, model, snap) -> None:
        source = f"window@{round(snap.t1, 1)}"
        if self.publisher is not None:
            # Through the replicated router: the model fans out to the
            # tenant's primary and shadow, not the in-process registry.
            self.publisher.publish(self, model, source)
            return
        self.fleet.publish(self.tenant, model, source=source)
        if self.scorer is None:
            self._start_scorer()

    def _quality_gate(self):
        """The detection-quality publish gate, built lazily: the
        injection suite needs the stream's pinned cuts, which exist only
        after the bootstrap slice.  Off unless
        ContinuousConfig.quality_gate."""
        if not self.cc.quality_gate:
            return None
        if self._qgate is None:
            from ..models.drift import QualityGate
            from ..sources.quality import QualitySuite

            cc = self.cc
            suite = QualitySuite(
                self.dsource, self.cuts,
                n_events=cc.quality_events, seed=cc.quality_seed,
                attack_events=cc.quality_attack_events, k=cc.quality_k,
            )
            raw_journal = (
                self.journal.journal if self.journal is not None
                else None
            )
            if raw_journal is not None:
                # The suite's provenance: what was injected, under which
                # seed; every later quality_gate record is judged
                # against it.
                raw_journal.append(suite.manifest)
            self._qgate = QualityGate(
                suite,
                tol=cc.quality_tol,
                history=cc.quality_history,
                min_history=cc.quality_min_history,
                journal=raw_journal, recorder=self.recorder,
            )
            self._qgate.prime(self._replayed)
        return self._qgate

    def _start_scorer(self) -> None:
        from ..serving import FleetScorer

        fz = get_source(self.dsource).event_featurizer(self.cuts)
        # The flagged-event product: suspicious events stream to
        # flagged_events.jsonl as they score (serve's on_batch contract).
        self._flagged_file = open(
            os.path.join(self.out_dir, "flagged_events.jsonl"), "a"
        )

        def on_batch(tenant, snapshot, feats, scores):
            threshold = self.scorer.tenant_threshold(tenant)
            for i in np.where(scores < threshold)[0]:
                self.flagged += 1
                self._flagged_file.write(json.dumps({
                    "tenant": tenant,
                    "flagged": feats.featurized_row(int(i)),
                    "score": float(scores[i]),
                    "model_version": snapshot.version,
                }) + "\n")
            self._flagged_file.flush()

        self.scorer = FleetScorer(
            self.fleet, {self.tenant: fz}, self.config.serving,
            on_batch=on_batch, journal=self.journal, device=self.device,
        )

    def _freshness_record(self, publish_wall: "float | None",
                          now_sim: float,
                          refresh_wall0: float) -> dict:
        """Resolve the freshness ledger at a successful publish: every
        not-yet-covered slice's events became servable under a model
        trained on a window containing them.  Wall freshness is what
        this replay measured (speed-dependent); event-time freshness is
        the cadence lag plus the refresh's own wall."""
        if publish_wall is None:
            return {"freshness_slices": 0}
        refresh_cost = publish_wall - refresh_wall0
        n = 0
        wall_max = 0.0
        event_max = 0.0
        with self._lock:
            covered, self._ledger = self._ledger, []
        for entry in covered:
            wall = publish_wall - entry.arrival_wall
            event_s = max(now_sim - entry.t1, 0.0) + refresh_cost
            n += 1
            wall_max = max(wall_max, wall)
            event_max = max(event_max, event_s)
            self._freshness_count += 1
            self._freshness.observe(wall)
            self._freshness_event.observe(event_s)
            if self._freshness_sink is not None:
                self._freshness_sink(wall, event_s)
        if n and self.journal is not None:
            # Per publish, the worst newly covered slice's
            # arrival -> servable gap (tenant-keyed: the fleet's journal
            # interleaves N ledgers).
            self.journal.append({
                "kind": "freshness",
                "tenant": self.tenant,
                "slices": n,
                "wall_max_s": round(wall_max, 3),
                "event_max_s": round(event_max, 3),
            })
        return {"freshness_slices": n}

    def _run_fresh_control(self, corpus, record, seed_probs,
                           seed_alpha):
        """Warm against fresh on the same data: rerun the warm fit and one
        fresh fit back to back on the snapshot a warm refresh just
        trained (neither is published), so warm_start_speedup compares EM
        walls at matched held-out likelihood."""
        cfg = self._lda_config()

        def _eval(result):
            ll, _ = self.drift.evaluate(
                result.log_beta, result.alpha, corpus,
                holdout_frac=self.cc.holdout_frac,
                batch_size=cfg.batch_size,
                min_bucket_len=cfg.min_bucket_len,
                var_max_iters=cfg.var_max_iters, var_tol=cfg.var_tol,
                device=self.device,
            )
            return ll

        t0 = time.perf_counter()
        warm_res = self.trainer.fit(
            corpus, topic_probs=seed_probs, alpha=seed_alpha
        )
        warm_wall = time.perf_counter() - t0
        t0 = time.perf_counter()
        fresh_res = self.trainer.fit(corpus)
        fresh_wall = time.perf_counter() - t0
        warm_ll = _eval(warm_res)
        fresh_ll = _eval(fresh_res)
        self._last_fresh_iters = fresh_res.em_iters
        return {
            "at_refresh": record["refresh"],
            "warm_wall_s": round(warm_wall, 4),
            "fresh_wall_s": round(fresh_wall, 4),
            "warm_em_iters": warm_res.em_iters,
            "fresh_em_iters": fresh_res.em_iters,
            "warm_start_speedup": round(
                fresh_wall / max(warm_wall, 1e-9), 3
            ),
            "held_out_ll_warm": round(warm_ll, 6),
            "held_out_ll_fresh": round(fresh_ll, 6),
            "held_out_ll_delta": round(warm_ll - fresh_ll, 6),
        }

    # -- drive + close ---------------------------------------------------

    def run(self, slices) -> dict:
        """Consume a paced slice stream to exhaustion, then close."""
        try:
            for sl in slices:
                self.ingest_slice(sl)
                self.maybe_refresh(sl.t1)
        finally:
            payload = self.close()
        return payload

    def close(self) -> dict:
        if self.scorer is not None:
            self.scorer.close(timeout=60.0)
            self.events_scored = self.scorer.events_scored
            self.score_failures = self.scorer.counts["failures"]
            self.scorer = None
        elif self.publisher is not None:
            # The fleet closes the binding first, so every future this
            # tenant submitted has resolved or failed.
            self.events_scored, self.score_failures = \
                self.publisher.tenant_counts(self.tenant)
        if self._flagged_file is not None:
            self._flagged_file.close()
            self._flagged_file = None
        payload = self.summary()
        with self._lock:
            journal, self.journal = self.journal, None
        if journal is not None and self._owns_journal:
            journal.run_end(
                ok=True, publishes=self.drift.publishes,
                vetoes=self.drift.vetoes,
            )
            journal.close()
        # A shared journal: the fleet closes it.
        metrics_name = (
            f"continuous_metrics.{self.tenant}.json" if self._shared
            else "continuous_metrics.json"
        )
        with open(os.path.join(self.out_dir, metrics_name), "w") as f:
            json.dump(payload, f, indent=1)
        return payload

    def summary(self) -> dict:
        def _fit_stats(warm: bool) -> dict:
            agg = self._fit_agg[warm]
            if not agg["fits"]:
                return {"fits": 0}
            return {
                "fits": agg["fits"],
                "mean_wall_s": round(agg["wall_s"] / agg["fits"], 4),
                "mean_em_iters": round(
                    agg["em_iters"] / agg["fits"], 2
                ),
            }

        fresh_q = {}
        if self._freshness_count:
            fresh_q = {
                "freshness_p50_s": round(
                    self._freshness.quantile(0.50), 3
                ),
                "freshness_p99_s": round(
                    self._freshness.quantile(0.99), 3
                ),
                "freshness_event_p50_min": round(
                    self._freshness_event.quantile(0.50) / 60.0, 3
                ),
                "freshness_event_p99_min": round(
                    self._freshness_event.quantile(0.99) / 60.0, 3
                ),
            }
        serve_q = {}
        if self._serve_idle_ms.count:
            serve_q["serve_idle_p99_ms"] = round(
                self._serve_idle_ms.quantile(0.99), 3
            )
        if self._serve_refresh_ms.count:
            serve_q["serve_refresh_p99_ms"] = round(
                self._serve_refresh_ms.quantile(0.99), 3
            )
        retraces = None
        if self._warmup_counts is not None:
            from ..plans import warmup as plans_warmup

            retraces = plans_warmup.counts_delta(
                self._warmup_counts)["builds"]
        return {
            "dsource": self.dsource,
            "tenant": self.tenant,
            "slices": self.slices,
            "events": self.events,
            "events_rejected": self.events_rejected,
            "flagged": self.flagged,
            "refreshes": self.refresh_count,
            "skipped_refreshes": self.skipped_refreshes,
            "publishes": self.drift.publishes,
            "vetoes": self.drift.vetoes,
            "quality_checks": (
                self._qgate.checks if self._qgate is not None else 0
            ),
            "quality_vetoes": (
                self._qgate.vetoes if self._qgate is not None else 0
            ),
            "version": self._version(),
            **fresh_q,
            **serve_q,
            "freshness_samples": self._freshness_count,
            "uncovered_slices": len(self._ledger),
            "warm": _fit_stats(True),
            "fresh": _fit_stats(False),
            "fresh_control": self.control_record,
            "held_out_ll": self._last_ll,
            "vocab": self.window.vocab_size,
            "vocab_capacity": self.window.vocab_capacity(),
            "tier_rebuilds": self.tier_rebuilds,
            "evicted_chunks": self.window.evicted_chunks,
            "retraces_after_warmup": retraces,
            # Bounded recent detail (maxlen 1024); the journal holds the
            # full history.
            "refresh_records": list(self.refresh_records),
        }


def run_continuous(
    config: PipelineConfig,
    dsource: str,
    slices,
    *,
    out_dir: str,
    tenant: str = "stream",
    fresh_control: bool = False,
    warmup_refreshes: "int | None" = None,
    device=None,
) -> dict:
    """Stand up a ContinuousService on `device` and drive the slice
    stream to exhaustion."""
    service = ContinuousService(
        config, dsource, out_dir=out_dir, tenant=tenant,
        fresh_control=fresh_control, warmup_refreshes=warmup_refreshes,
        device=device,
    )
    return service.run(slices)


# ---------------------------------------------------------------------------
# the fleet: N tenants, one co-scheduler, one card, and optionally the
# replicated serving fleet
# ---------------------------------------------------------------------------


class RouterBinding:
    """Publishing and scoring for N per-tenant services through one
    replicated FleetRouter.

    Bootstrap: the router computes placement once, at start(), over the
    whole tenant census, so the binding holds each tenant's first
    published model until every expected tenant has one, then
    add_tenant()s the census and start()s the router.  Until then
    `ready()` is False and the services only ledger their slices, as
    before a first publish in process.  Later publishes fan out live
    through router.publish (primary and shadow, with the drain/publish
    convergence loop).

    Scoring: submit_slice ships a slice as one submit_many frame and
    hands the futures to a FIFO resolver thread, so ingest never waits
    on a score's round trip; each event's submit-to-resolve latency
    lands in the idle or the during-refresh histogram by the
    refresh_active flag sampled at submit.  `failed` counts futures that
    raised: a replica killed mid-stream leaves it at zero (the router
    resends in-flight hops to the promoted shadow)."""

    def __init__(self, router, tenants, *, journal=None,
                 recorder=None) -> None:
        from ..telemetry.spans import Recorder as _Recorder

        self.router = router
        self.expected = set(tenants)
        self._journal = getattr(journal, "journal", journal)
        rec = recorder if recorder is not None else _Recorder()
        self._serve_idle_ms = rec.histogram("route.serve_idle_ms")
        self._serve_refresh_ms = rec.histogram("route.serve_refresh_ms")
        self._lock = threading.Lock()
        self._started = False
        self._pending: dict = {}    # tenant -> (service, model) pre-start
        self._versions: dict = {}
        self.resolved = 0
        self.failed = 0
        # tenant -> [resolved, failed]
        self._per_tenant = {t: [0, 0] for t in self.expected}
        self._cond = threading.Condition()
        # (tenant, future, t_submit, refresh_active)
        self._queue: deque = deque()
        self._stopped = False
        self._resolver = threading.Thread(
            target=self._resolve_loop, name="oni-cont-resolver",
            daemon=True)
        self._resolver.start()

    def ready(self, tenant: str) -> bool:
        with self._lock:
            return self._started

    def version(self, tenant: str) -> int:
        with self._lock:
            return self._versions.get(tenant, 0)

    def publish(self, service, model, source: str) -> int:
        from ..serving import TenantSpec

        tenant = service.tenant
        with self._lock:
            if not self._started:
                self._pending[tenant] = (service, model)
                self._versions[tenant] = self._versions.get(tenant, 0) + 1
                if set(self._pending) == self.expected:
                    for t, (svc, m) in sorted(self._pending.items()):
                        self.router.add_tenant(
                            TenantSpec(tenant=t, dsource=svc.dsource),
                            svc.cuts, m)
                    self._pending.clear()
                    self.router.start()
                    self._started = True
                return self._versions[tenant]
        v = self.router.publish(tenant, model, source=source)
        with self._lock:
            self._versions[tenant] = v
            return v

    def submit_slice(self, tenant: str, sl: "IngestSlice", *,
                     refresh_active: bool = False) -> None:
        futs = self.router.submit_many(tenant, list(sl.lines))
        self.router.flush()
        t0 = time.perf_counter()
        with self._cond:
            for f in futs:
                self._queue.append((tenant, f, t0, refresh_active))
            self._cond.notify_all()

    def _resolve_loop(self) -> None:
        while True:
            with self._cond:
                while not self._queue and not self._stopped:
                    self._cond.wait()
                if not self._queue:
                    return      # stopped and drained: close() semantics
                tenant, fut, t0, during = self._queue.popleft()
            try:
                fut.result(timeout=120.0)
            except Exception:
                with self._cond:
                    self.failed += 1
                    self._per_tenant[tenant][1] += 1
                continue
            wall_ms = (time.perf_counter() - t0) * 1e3
            (self._serve_refresh_ms if during
             else self._serve_idle_ms).observe(wall_ms)
            with self._cond:
                self.resolved += 1
                self._per_tenant[tenant][0] += 1

    def tenant_counts(self, tenant: str) -> "tuple[int, int]":
        """(resolved, failed) futures of one tenant so far."""
        with self._cond:
            resolved, failed = self._per_tenant[tenant]
        return resolved, failed

    def close(self, timeout_s: float = 300.0) -> None:
        """Stop accepting and drain every queued future first: a clean
        shutdown resolves, not drops, the scores in flight."""
        with self._cond:
            self._stopped = True
            self._cond.notify_all()
        self._resolver.join(timeout=timeout_s)

    def stats(self) -> dict:
        with self._lock:
            out = {"started": self._started,
                   "versions": dict(self._versions)}
        with self._cond:
            out["events_scored"] = self.resolved
            out["failed_futures"] = self.failed
            out["pending"] = len(self._queue)
        for key, h in (("serve_idle_p99_ms", self._serve_idle_ms),
                       ("serve_refresh_p99_ms", self._serve_refresh_ms)):
            if h.count:
                out[key] = round(h.quantile(0.99), 3)
        return out


class FleetContinuousService:
    """One standing service: N per-tenant ContinuousServices composed over
    one journal/recorder and one train/serve co-scheduler, on `device`,
    and, with `replicated`/`router`, the replicated serving fleet.

    Ingest and scoring stay on the caller's thread (high priority, serve
    slots); refresh fits run on one background worker thread (low
    priority, preemptible at every EM dispatch boundary), so a tenant's
    fit never blocks scoring beyond one dispatch's enqueue.  The worker
    runs in a copy of the constructor's context (the plan store and the
    active recorder) and on the service's card.  A cadence that outruns
    the fit coalesces (the queued refresh trains on a window that holds
    the newer slices anyway).  A refresh that raises is abandoned: it
    is counted in `refresh_errors` and journaled as `refresh_abandon`,
    nothing is published, and the next boundary retries.

    Scoring is in process, or with `replicated=N` on N replica
    subprocesses this service spawns (`ml_ops replica --device` of
    `device`, with the config's ServingConfig flush settings) behind a
    router it owns, or on the replicas
    behind a caller's `router`: a RouterBinding then publishes each
    tenant's refits through the router and scores its slices there.

    Drive with `run(tagged)`, where tagged yields (tenant, IngestSlice)
    in event-time order (`interleave_streams` + `paced_tagged`), or
    slice by slice via `ingest`.  The JAX package's distributed
    refreshes (`collective`) are not ported."""

    def __init__(
        self,
        config: PipelineConfig,
        streams: "dict[str, str]",
        *,
        out_dir: str,
        replicated: int = 0,
        router=None,
        coscheduler: bool = True,
        warmup_refreshes: "int | None" = None,
        device=None,
    ) -> None:
        from ..serving import CoScheduler
        from ..telemetry import Journal, Recorder, RunJournal
        from ..telemetry.spans import Recorder as _Recorder

        if not streams:
            raise ValueError("streams must name at least one tenant")
        self.config = config
        self.device = resolve_device(device)
        self.out_dir = formats.ensure_dir(out_dir)
        self.streams = dict(streams)
        self._plock = threading.Lock()
        tel = config.telemetry
        self.journal = None
        self.recorder = None
        if tel.journal:
            jpath = os.path.join(self.out_dir, "run_journal.jsonl")
            self.journal = RunJournal(
                Journal(jpath, fsync_every=tel.journal_fsync_every)
            )
            self.journal.run_start(
                mode="continuous_fleet", tenants=sorted(self.streams),
                replicated=int(replicated or (router is not None)),
                cosched=bool(coscheduler),
                window_s=config.continuous.window_s,
                refresh_every_s=config.continuous.refresh_every_s,
                device=str(self.device),
            )
            self.recorder = Recorder(journal=self.journal.journal)
        raw_journal = (
            self.journal.journal if self.journal is not None else None
        )
        # coscheduler=False is observe-only, not absent: the control
        # still tags serve latency by refresh activity and counts chunks
        # and slots; it just never waits.
        self.cosched = CoScheduler(
            recorder=self.recorder, journal=raw_journal,
            enabled=bool(coscheduler),
        )
        rec = self.recorder or _Recorder()
        # Fleet-wide freshness next to the per-tenant ledgers.
        self._fresh_wall = rec.histogram("fleet.freshness_s")
        self._fresh_event = rec.histogram("fleet.freshness_event_s")

        self.router = router
        self._owns_router = False
        self.replica_procs: dict = {}
        self._workdir = None
        if self.router is None and replicated:
            self._spawn_fleet(int(replicated))
        self.binding = None
        if self.router is not None:
            self.binding = RouterBinding(
                self.router, self.streams,
                journal=self.journal, recorder=self.recorder,
            )

        self.services: "dict[str, ContinuousService]" = {}
        for tenant, dsource in sorted(self.streams.items()):
            self.services[tenant] = ContinuousService(
                config, dsource, out_dir=self.out_dir, tenant=tenant,
                warmup_refreshes=warmup_refreshes,
                journal=self.journal, recorder=self.recorder,
                coscheduler=self.cosched, publisher=self.binding,
                freshness_sink=self._observe_freshness,
                device=self.device,
            )

        self.coalesced_refreshes = 0
        self.refresh_errors = 0
        self._warm0 = None
        self._closed = False
        self._payload = None
        self._refresh_pending: "dict[str, bool]" = {}
        self._rq: "queue.Queue" = queue.Queue()
        # Contexts do not cross a thread start: the worker runs in a copy
        # of this one (plan store, recorder) and sets the card itself.
        self._cuda_index = None
        if self.device.type == "cuda":
            self._cuda_index = (self.device.index
                                if self.device.index is not None
                                else torch.cuda.current_device())
        ctx = contextvars.copy_context()
        self._worker = threading.Thread(
            target=ctx.run, args=(self._refresh_loop,),
            name="oni-continuous-refresh", daemon=True)
        self._worker.start()

    def _spawn_fleet(self, n: int) -> None:
        """Start n replica subprocesses together on this service's device
        with the config's flush settings, a file-KV membership directory
        and a router over them, which this service owns and closes."""
        import tempfile

        from ..parallel import FileKVClient
        from ..serving import FleetRouter
        from .route import _spawn_replicas

        scfg = self.config.serving
        dmin = ("none" if scfg.device_score_min is None
                else str(scfg.device_score_min))
        flags = ["--device", self.device.type, "--device-score-min", dmin,
                 "--fleet-max-batch", str(scfg.fleet_max_batch),
                 "--fleet-max-wait-ms", str(scfg.fleet_max_wait_ms)]
        workdir = tempfile.mkdtemp(prefix="oni_cont_fleet_")
        with self._plock:
            self._workdir = workdir
        kv_dir = os.path.join(workdir, "kv")
        router = FleetRouter(scfg, journal=self.journal,
                             recorder=self.recorder,
                             kv=FileKVClient(kv_dir))
        try:
            spawned = _spawn_replicas([f"r{i}" for i in range(n)], kv_dir,
                                      workdir, flags)
            for rid, (proc, _, _) in spawned.items():
                self.replica_procs[rid] = proc
            for rid, (_, host, port) in spawned.items():
                router.connect_replica(rid, host, port)
        except BaseException:
            router.close()
            self._stop_replicas()
            raise
        with self._plock:
            self.router = router
            self._owns_router = True

    def kill_replica(self, rid: str) -> None:
        """Chaos hook: SIGKILL a spawned replica subprocess, no drain,
        no goodbye.  The recovery contract (zero failed score futures,
        publishes converging through the promoted shadow) is what the
        chip smoke and the chaos tests hold."""
        proc = self.replica_procs[rid]
        proc.kill()
        proc.wait(timeout=30.0)

    def _stop_replicas(self) -> None:
        for proc in self.replica_procs.values():
            if proc.poll() is None:
                proc.terminate()
        for proc in self.replica_procs.values():
            try:
                proc.wait(timeout=30.0)
            except Exception:
                proc.kill()
                proc.wait(timeout=30.0)
        if self._workdir is not None:
            import shutil

            shutil.rmtree(self._workdir, ignore_errors=True)

    def _observe_freshness(self, wall_s: float, event_s: float) -> None:
        self._fresh_wall.observe(wall_s)
        self._fresh_event.observe(event_s)

    # -- drive ----------------------------------------------------------

    def ingest(self, tenant: str, sl: IngestSlice) -> None:
        svc = self.services[tenant]
        svc.ingest_slice(sl)
        if svc.refresh_due(sl.t1):
            with self._plock:
                if self._refresh_pending.get(tenant):
                    # Cadence outran the fit: coalesce; the queued
                    # refresh trains on a window that will contain this
                    # slice anyway.
                    self.coalesced_refreshes += 1
                    return
                self._refresh_pending[tenant] = True
            self._rq.put((tenant, sl.t1))

    def _refresh_loop(self) -> None:
        from ..plans import warmup as plans_warmup

        if self._cuda_index is not None:
            torch.cuda.set_device(self._cuda_index)
        while True:
            item = self._rq.get()
            try:
                if item is None:
                    return
                tenant, now_sim = item
                try:
                    self.services[tenant].refresh(now_sim)
                except Exception as e:
                    # An abandoned refresh must not stop the standing
                    # fleet: nothing was published (the gate never ran),
                    # the ledger keeps its uncovered slices, and the next
                    # cadence boundary retries.  It is counted and
                    # journaled, never hidden.
                    with self._plock:
                        self.refresh_errors += 1
                    if self.journal is not None:
                        try:
                            self.journal.append({
                                "kind": "refresh_abandon",
                                "tenant": tenant,
                                "error": repr(e)[:200],
                            })
                        except Exception:
                            pass
                if self._warm0 is None and all(
                    s._warmup_counts is not None
                    for s in self.services.values()
                ):
                    # Every tenant crossed its warm-up boundary: builds
                    # from here on are the fleet's (the counters are
                    # process-global, so per-tenant deltas would count
                    # twice).
                    with self._plock:
                        self._warm0 = plans_warmup.compile_counts()
            finally:
                if item is not None:
                    with self._plock:
                        self._refresh_pending[item[0]] = False
                self._rq.task_done()

    def run(self, tagged) -> dict:
        """Consume an event-time-ordered (tenant, slice) stream to
        exhaustion, then close."""
        try:
            for tenant, sl in tagged:
                self.ingest(tenant, sl)
        finally:
            payload = self.close()
        return payload

    def close(self) -> dict:
        with self._plock:
            if self._closed:
                return self._payload
            self._closed = True
        self._rq.join()            # every queued refresh lands first
        self._rq.put(None)
        self._worker.join(timeout=600.0)
        if self.binding is not None:
            self.binding.close()   # resolve every future in flight
        tenants = {
            t: svc.close() for t, svc in sorted(self.services.items())
        }
        payload = self.summary(tenants)
        if self._owns_router:
            try:
                self.router.close()
            except Exception as e:
                import sys

                print(f"continuous fleet: router close failed: {e!r}",
                      file=sys.stderr)
            self._stop_replicas()
        with self._plock:
            journal, self.journal = self.journal, None
        if journal is not None:
            journal.run_end(
                ok=True,
                refreshes=payload["refreshes"],
                publishes=payload["publishes"],
                refresh_errors=self.refresh_errors,
            )
            journal.close()
        with open(os.path.join(self.out_dir,
                               "fleet_continuous_metrics.json"),
                  "w") as f:
            json.dump(payload, f, indent=1)
        with self._plock:
            self._payload = payload
        return payload

    def summary(self, tenants: "dict | None" = None) -> dict:
        if tenants is None:
            tenants = {
                t: svc.summary()
                for t, svc in sorted(self.services.items())
            }
        fresh = {}
        if self._fresh_wall.count:
            fresh = {
                "freshness_p50_s": round(
                    self._fresh_wall.quantile(0.50), 3),
                "freshness_p99_s": round(
                    self._fresh_wall.quantile(0.99), 3),
                "freshness_event_p50_min": round(
                    self._fresh_event.quantile(0.50) / 60.0, 3),
                "freshness_event_p99_min": round(
                    self._fresh_event.quantile(0.99) / 60.0, 3),
            }
        retraces = None
        if self._warm0 is not None:
            from ..plans import warmup as plans_warmup

            retraces = plans_warmup.counts_delta(self._warm0)["builds"]
        out = {
            "tenants": tenants,
            "events": sum(t["events"] for t in tenants.values()),
            "slices": sum(t["slices"] for t in tenants.values()),
            "refreshes": sum(t["refreshes"] for t in tenants.values()),
            "publishes": sum(t["publishes"] for t in tenants.values()),
            "coalesced_refreshes": self.coalesced_refreshes,
            "refresh_errors": self.refresh_errors,
            "retraces_after_warmup": retraces,
            **fresh,
            "cosched": self.cosched.summary(),
        }
        if self.binding is not None:
            out["serving"] = self.binding.stats()
        if self.router is not None:
            out["router"] = self.router.stats()
        return out


def interleave_streams(per_tenant: "dict[str, list]") -> list:
    """Merge per-tenant slice lists into one event-time-ordered (tenant,
    slice) replay.  Deterministic: ties break by tenant name."""
    tagged = [
        (t, sl) for t in sorted(per_tenant) for sl in per_tenant[t]
    ]
    tagged.sort(key=lambda p: (p[1].t1, p[0]))
    return tagged


def paced_tagged(tagged, speed: float, *, sleep=time.sleep):
    """`paced_slices` for a tagged (tenant, slice) stream: one shared
    event clock paces every tenant, keeping their relative gaps at
    `speed` times real time."""
    if speed <= 0:
        raise ValueError(f"speed must be > 0, got {speed}")
    t_wall0 = time.perf_counter()
    t_sim0 = None
    for tenant, sl in tagged:
        if t_sim0 is None:
            t_sim0 = sl.t1
        due = t_wall0 + (sl.t1 - t_sim0) / speed
        delay = due - time.perf_counter()
        if delay > 0 and np.isfinite(delay):
            sleep(delay)
        sl.arrival_wall = time.perf_counter()
        yield tenant, sl


def run_fleet_continuous(
    config: PipelineConfig,
    streams: "dict[str, str]",
    tagged,
    *,
    out_dir: str,
    replicated: int = 0,
    router=None,
    coscheduler: bool = True,
    warmup_refreshes: "int | None" = None,
    device=None,
) -> dict:
    """Stand up the fleet on `device` (scoring in process, on
    `replicated` spawned replicas, or behind `router`) and drive the
    tagged stream to exhaustion."""
    fleet = FleetContinuousService(
        config, streams, out_dir=out_dir, replicated=replicated,
        router=router, coscheduler=coscheduler,
        warmup_refreshes=warmup_refreshes, device=device,
    )
    return fleet.run(tagged)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="ml_ops continuous",
        description="continuous ingestion: windowed streaming corpus, "
        "warm-start EM refreshes on the card, drift-gated publishes "
        "into the serving fleet; freshness in minutes, not next-day",
    )
    p.add_argument("dsource", nargs="?", default=None,
                   choices=list(source_names()),
                   help="single-tenant stream source (omit with --stream)")
    p.add_argument("--stream", action="append", default=[],
                   metavar="TENANT=DSOURCE:PATH",
                   help="fleet mode: one tenant stream (repeatable); N "
                   "tenants compose into one standing service sharing "
                   "the journal, the train/serve co-scheduler and (with "
                   "--replicated) the serving fleet")
    p.add_argument("--replicated", type=int, default=0, metavar="N",
                   help="with --stream: serve through the fleet router "
                   "over N spawned replica subprocesses (ml_ops replica "
                   "on --device) instead of the in-process scorer")
    p.add_argument("--multihost", action="store_true", default=None,
                   help="not ported: ROADMAP Queue 1 item 6")
    p.add_argument("--no-cosched", action="store_true",
                   help="disable the train/serve co-scheduler (control "
                   "mode: refresh fits are never preempted)")
    p.add_argument("--flow-path", default=None,
                   help="raw netflow CSV to replay (FLOW_PATH env)")
    p.add_argument("--dns-path", default=None,
                   help="raw DNS CSV to replay (DNS_PATH env)")
    p.add_argument("--proxy-path", default=None,
                   help="raw proxy/HTTP log CSV to replay (PROXY_PATH "
                   "env)")
    p.add_argument("--quality-gate", action="store_true",
                   help="veto publishes that regress recall@k on the "
                   "labeled-injection suite (sources/inject.py)")
    p.add_argument("--data-dir", default=None,
                   help="output/journal directory (LPATH env)")
    p.add_argument("--qtiles", default=None,
                   help="pinned flow quantile cuts (stable word identity "
                   "across restarts)")
    p.add_argument("--speed", type=float, default=60.0,
                   help="replay speed multiplier over event time (60 = "
                   "an hour of events per wall minute)")
    p.add_argument("--slice-s", type=float, default=300.0,
                   help="ingest slice span in event seconds")
    p.add_argument("--window-s", type=float, default=None,
                   help="override ContinuousConfig.window_s")
    p.add_argument("--refresh-s", type=float, default=None,
                   help="override ContinuousConfig.refresh_every_s")
    p.add_argument("--tenant", default="stream")
    p.add_argument("--fresh-control", action="store_true",
                   help="measure one fresh fit against a warm refresh's "
                   "snapshot (the warm_start_speedup number)")
    p.add_argument("--no-sleep", action="store_true",
                   help="deliver slices as fast as they are consumed")
    p.add_argument("--device", choices=("cuda", "cpu"), default=None,
                   help="where fits and device scoring run (default: the "
                   "card; a run without one raises)")
    return p


def _parse_stream_specs(specs: "list[str]") -> "dict[str, tuple]":
    """Parse repeated --stream TENANT=DSOURCE:PATH flags."""
    out: dict = {}
    for spec in specs:
        tenant, eq, rest = spec.partition("=")
        dsource, colon, path = rest.partition(":")
        if not eq or not colon or not tenant or not path:
            raise ValueError(
                f"--stream expects TENANT=DSOURCE:PATH, got {spec!r}"
            )
        if dsource not in source_names():
            raise ValueError(
                f"--stream {spec!r}: dsource must be one of "
                f"{'|'.join(source_names())}"
            )
        if tenant in out:
            raise ValueError(f"--stream: duplicate tenant {tenant!r}")
        out[tenant] = (dsource, path)
    return out


def _main_fleet(args, config: PipelineConfig) -> int:
    streams = _parse_stream_specs(args.stream)
    per_tenant = {}
    for tenant, (dsource, path) in streams.items():
        if not os.path.exists(path):
            print(f"continuous: no input file at {path!r}", flush=True)
            return 2
        with open(path) as f:
            lines = f.readlines()
        per_tenant[tenant] = slice_events(lines, dsource, args.slice_s)
    speed = float("inf") if args.no_sleep else args.speed
    tagged = paced_tagged(interleave_streams(per_tenant), speed)
    payload = run_fleet_continuous(
        config, {t: ds for t, (ds, _) in streams.items()}, tagged,
        out_dir=os.path.join(config.data_dir, "continuous_fleet"),
        replicated=args.replicated, coscheduler=not args.no_cosched,
        device=args.device,
    )
    print(json.dumps(payload), flush=True)
    return 0


def main(argv: "list[str] | None" = None) -> int:
    import dataclasses

    args = build_parser().parse_args(argv)
    for attr, (flag, item) in _NOT_PORTED.items():
        if getattr(args, attr) is not None:
            print(f"continuous {flag} is not ported yet: {item}",
                  flush=True)
            return 2
    env = os.environ
    config = PipelineConfig(
        data_dir=args.data_dir or env.get("LPATH", "."),
        qtiles_path=args.qtiles or "",
    )
    cc = config.continuous
    overrides = {}
    if args.window_s is not None:
        overrides["window_s"] = args.window_s
    if args.refresh_s is not None:
        overrides["refresh_every_s"] = args.refresh_s
    if args.quality_gate:
        overrides["quality_gate"] = True
    if overrides:
        config = config.replace(
            continuous=dataclasses.replace(cc, **overrides)
        )
    if args.stream:
        return _main_fleet(args, config)
    if args.dsource is None:
        print("continuous: a DSOURCE argument or --stream flags are "
              "required", flush=True)
        return 2
    path = (
        getattr(args, f"{args.dsource}_path", None)
        or env.get(f"{args.dsource.upper()}_PATH", "")
    )
    if not path or not os.path.exists(path):
        print(f"continuous: no input file at {path!r}", flush=True)
        return 2
    with open(path) as f:
        lines = f.readlines()
    slices = slice_events(lines, args.dsource, args.slice_s)
    speed = float("inf") if args.no_sleep else args.speed
    payload = run_continuous(
        config, args.dsource, paced_slices(slices, speed),
        out_dir=os.path.join(config.data_dir, "continuous"),
        tenant=args.tenant, fresh_control=args.fresh_control,
        device=args.device,
    )
    print(json.dumps(payload), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
