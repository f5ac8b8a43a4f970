"""`ml_ops serve`: the streaming scoring service over a completed day
directory, or over a fleet of them (port of oni_ml_tpu/runner/serve.py).

    python -m oni_ml_tpu_torch.runner.ml_ops serve \
        --day-dir /data/days/20160122 --dsource flow \
        --input - --refresh-every 8 [--device cuda|cpu]

reads raw CSV events (one per line) from --input (a file, or stdin for
'-'), scores them in micro-batches against the registry's active model,
prints flagged events (score < threshold) as JSON lines and one
{"stage": "serve", ...} metrics record per flush, and with
--refresh-every folds the stream into online-LDA steps on the card whose
models hot-swap in without a restart.  It runs on the card unless
`--device cpu` asks for the CPU; without a card it raises.

    python -m oni_ml_tpu_torch.runner.ml_ops serve --fleet manifest.json \
        [--hot-tenants N --warm-tenants M --residency-policy lru|lfu \
         --residency-spill DIR] [--stack-precision f32|bf16]

serves every tenant of the manifest (serving/tenants.py) through one
FleetScorer: stream lines are `<tenant>\t<raw csv line>`, each tenant
refreshes on its own, and with --hot-tenants only N tenants per topic
count stay stacked on the card (serving/residency.py).

`--dry-run` runs the whole stack (registry -> micro-batches -> a
mid-stream hot-swap -> refresh republish) on a small synthetic in-memory
day and checks the exactly-once contract; `--dry-run --fleet
synthetic[:N]` does the same for N synthetic tenants.  Both need no day
directory and finish in seconds.

`--no-compilation-cache` builds the CUDA kernels and C++ host libraries
the process loads in a run-scoped temporary directory instead of
build/oni_ml_tpu_torch/ (plans/warmup.compilation_cache: a cold build);
the `plans` record names the build directory.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

import numpy as np

from ..config import OnlineLDAConfig, ScoringConfig, ServingConfig
from ..serving import (
    BatchScorer,
    MetricsEmitter,
    ModelRegistry,
    RefreshLoop,
    event_documents,
    featurizer_from_features,
)
from ..sources import get as get_source
from ..sources import names as source_names


def build_serve_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="ml_ops serve",
        description="streaming scoring service over a completed day's "
        "model (micro-batch serving with online-LDA hot-swap refresh)",
    )
    p.add_argument("--day-dir", default=None,
                   help="completed day directory (doc_results.csv / "
                   "word_results.csv / features.pkl)")
    p.add_argument("--dsource", choices=list(source_names()),
                   default="flow")
    p.add_argument("--input", default="-", metavar="PATH",
                   help="raw event CSV stream; '-' = stdin (default)")
    p.add_argument("--threshold", type=float,
                   default=ScoringConfig.threshold,
                   help="emit events scoring under this as suspicious")
    # None = not passed, so --dry-run rescales only what the operator
    # left alone.
    p.add_argument("--max-batch", type=int, default=None,
                   help="micro-batch flush size (default: "
                   f"{ServingConfig.max_batch})")
    p.add_argument("--max-wait-ms", type=float, default=None,
                   help="micro-batch latency trigger in ms (default: "
                   f"{ServingConfig.max_wait_ms:g})")
    p.add_argument("--device-score-min", type=int,
                   default=ServingConfig.device_score_min,
                   help="flushes of at least this many events score on "
                   "the device, smaller ones on the host in float64; 0 = "
                   "the break-even of the measured dispatch calibration "
                   "(the default)")
    p.add_argument("--refresh-every", type=int, default=0, metavar="N",
                   help="fold every N scored batches into one online-LDA "
                   "step and hot-swap the refreshed model in (0=off)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="device of device-path flushes and of the refresh "
                   "trainer (default cuda; a machine without one raises "
                   "unless --device cpu)")
    p.add_argument("--metrics", default="", metavar="PATH",
                   help="also append per-batch metrics JSON lines here")
    p.add_argument("--metrics-port", type=int,
                   default=ServingConfig.metrics_port, metavar="PORT",
                   help="serve an OpenMetrics scrape endpoint (GET "
                   "/metrics) on this port: live counters, fixed-"
                   "boundary latency histograms with p50/p99/p999, and "
                   "roofline gauges (0 = off)")
    p.add_argument("--metrics-host", default=ServingConfig.metrics_host,
                   metavar="ADDR",
                   help="bind address for --metrics-port (default "
                   "loopback; 0.0.0.0 lets remote collectors scrape)")
    p.add_argument("--openmetrics", default=ServingConfig.openmetrics_path,
                   metavar="PATH",
                   help="write the same OpenMetrics text here at stream "
                   "end (the headless file sink)")
    p.add_argument("--journal", default="", metavar="PATH",
                   help="append every serving record to a crash-safe "
                   "telemetry journal (telemetry/journal.py JSONL)")
    p.add_argument("--top-domains", default=None,
                   help="top-1m.csv whitelist for DNS featurization")
    p.add_argument("--no-plans", action="store_true",
                   help="disable plan lookups and records (plans/): the "
                   "dispatch calibration is measured afresh and not "
                   "recorded")
    p.add_argument("--dry-run", action="store_true",
                   help="exercise the full serving stack on a synthetic "
                   "in-memory day (no --day-dir needed) and exit")
    p.add_argument("--fleet", default="", metavar="MANIFEST",
                   help="multi-tenant mode: serve every tenant of this "
                   "JSON manifest (serving/tenants.py) through one "
                   "FleetScorer; stream lines are '<tenant>\\t<raw csv "
                   "line>'.  With --dry-run, 'synthetic' or "
                   "'synthetic:N' runs the fleet check on N in-memory "
                   "tenants (default 2)")
    p.add_argument("--hot-tenants", type=int,
                   default=ServingConfig.fleet_hot_tenants, metavar="N",
                   help="tiered residency: at most N tenants per topic "
                   "count stay stacked on the card; the rest page to "
                   "host RAM and checkpoints on demand (0 = unbounded)")
    p.add_argument("--warm-tenants", type=int,
                   default=ServingConfig.fleet_warm_tenants, metavar="N",
                   help="at most N non-hot tenants keep their model in "
                   "host RAM; the coldest past that spill to a "
                   "checkpoint (0 = unbounded)")
    p.add_argument("--residency-policy", choices=["lru", "lfu"],
                   default=ServingConfig.residency_policy,
                   help="eviction victims: least recently or least often "
                   "admitted")
    p.add_argument("--residency-spill",
                   default=ServingConfig.residency_spill_dir, metavar="DIR",
                   help="cold-tier spill directory for a model its day "
                   "dir no longer holds (default: a per-process temp "
                   "dir)")
    p.add_argument("--stack-precision", choices=["f32", "bf16"],
                   default=ServingConfig.stack_precision,
                   help="device storage of the stacked models: bf16 "
                   "halves their bytes on the card, float32 "
                   "accumulation (scores within 2^-7 relative)")
    p.add_argument("--no-compilation-cache", action="store_true",
                   help="build the CUDA kernels and C++ host libraries "
                   "this process loads in a run-scoped temporary "
                   "directory instead of build/oni_ml_tpu_torch/ (a cold "
                   "build)")
    return p


def _serving_config(args) -> ServingConfig:
    # --max-batch / --max-wait-ms set whichever scorer the mode runs:
    # the BatchScorer's triggers, or the FleetScorer's under --fleet.
    mb, mw = args.max_batch, args.max_wait_ms
    return ServingConfig(
        max_batch=mb if mb is not None else ServingConfig.max_batch,
        max_wait_ms=mw if mw is not None else ServingConfig.max_wait_ms,
        fleet_max_batch=(mb if mb is not None
                         else ServingConfig.fleet_max_batch),
        fleet_max_wait_ms=(mw if mw is not None
                           else ServingConfig.fleet_max_wait_ms),
        device_score_min=args.device_score_min,
        refresh_every=args.refresh_every,
        threshold=args.threshold,
        metrics_path=args.metrics,
        metrics_port=args.metrics_port,
        metrics_host=args.metrics_host,
        openmetrics_path=args.openmetrics,
        fleet_manifest=args.fleet,
        fleet_hot_tenants=args.hot_tenants,
        fleet_warm_tenants=args.warm_tenants,
        residency_policy=args.residency_policy,
        residency_spill_dir=args.residency_spill,
        stack_precision=args.stack_precision,
    )


def _load_featurizer(day_dir: str, top_domains_path: "str | None"):
    """The day's serving featurizer from its features.pkl (the port's
    unpickler: a features.pkl another package wrote is refused)."""
    from .ml_ops import _PortUnpickler

    feats_path = os.path.join(day_dir, "features.pkl")
    if not os.path.exists(feats_path):
        raise FileNotFoundError(
            f"{feats_path} missing — serving pins word identity to the "
            "trained day's quantile cuts, which ride in features.pkl "
            "(run the pre stage, or keep the day dir intact)")
    with open(feats_path, "rb") as f:
        features = _PortUnpickler(f).load()
    top = frozenset()
    if top_domains_path:
        from ..features.dns import load_top_domains

        top = load_top_domains(top_domains_path)
    return featurizer_from_features(features, top_domains=top)


def _looks_like_header(line: str, dsource: str) -> bool:
    """True when a stream's first line is a column-name header: the
    source's always-numeric probe column (flow `hour`, dns
    `unix_tstamp`, proxy `duration`) does not parse.  Consulted for the
    first line only, so mid-stream garbage rows keep the day job's
    NaN-featurize-and-score semantics."""
    parts = line.strip().split(",")
    col = get_source(dsource).header_probe_col
    if len(parts) <= col:
        return False
    try:
        float(parts[col])
        return False
    except ValueError:
        return True


def _make_serve_roofline(metrics, journal, k: int):
    """The serve roofline record, computed at scrape time and once at
    stream end.  Device flushes: the `serve.micro_batch` cost counted
    from the shapes (roofline.micro_batch_cost over the device flushes'
    events, per dispatch) over their scoring wall (the
    serve.device_score_ms histogram).  A session whose every flush
    scored on the host gets a wall-only `serve.micro_batch.host` record
    (no device work to price)."""
    from ..telemetry import roofline

    def _serve_roofline(emit_journal: bool = False):
        rec = metrics.recorder
        kw = {"journal": journal} if emit_journal else {}
        hd = rec.histograms.get("serve.device_score_ms")
        if hd is not None and hd.count:
            dev_events = rec.counters["serve.device_events"].value
            flops, nbytes = roofline.micro_batch_cost(dev_events / hd.count, k)
            roofline.register_cost("serve.micro_batch", flops=flops,
                                   nbytes=nbytes, shape=f"k{k}")
            return roofline.emit(
                "serve.micro_batch", hd.total / 1e3, dispatches=hd.count,
                recorder=rec, path="device", events=dev_events, **kw)
        h = rec.histograms.get("serve.score_ms")
        if h is None or not h.count:
            return None
        return roofline.emit(
            "serve.micro_batch", h.total / 1e3, dispatches=h.count,
            recorder=rec, entry="serve.micro_batch.host", path="host", **kw)

    return _serve_roofline


def serve_stream(args) -> int:
    from ..device import resolve_device
    from ..plans import counters_snapshot
    from ..plans.warmup import warmup_serving
    from ..scoring import dispatch_calibration

    if not args.day_dir:
        raise SystemExit("serve needs --day-dir (or --dry-run)")
    dev = resolve_device(args.device)
    cfg = _serving_config(args)
    fallback = get_source(args.dsource).fallback(ScoringConfig())
    registry = ModelRegistry()
    snap = registry.load_day(args.day_dir, fallback)
    featurizer = _load_featurizer(args.day_dir, args.top_domains)
    if featurizer.dsource != args.dsource:
        raise SystemExit(
            f"--dsource {args.dsource} but {args.day_dir} holds "
            f"{featurizer.dsource} features")
    journal = None
    if args.journal:
        from ..telemetry import Journal

        journal = Journal(args.journal)
    metrics = MetricsEmitter(path=cfg.metrics_path, journal=journal)
    metrics.emit({
        "stage": "serve", "event": "model_loaded",
        "source": snap.source, "model_version": snap.version,
        "ips": len(snap.model.ip_index),
        "vocab": len(snap.model.word_index),
    })
    _serve_roofline = _make_serve_roofline(metrics, journal,
                                           snap.model.num_topics)
    mserver = None
    if cfg.metrics_port:
        from ..telemetry import MetricsServer

        mserver = MetricsServer(metrics.recorder, port=cfg.metrics_port,
                                host=cfg.metrics_host,
                                refresh=_serve_roofline)
        metrics.emit({"stage": "serve", "event": "metrics_endpoint",
                      "port": mserver.port, "path": "/metrics"})
    # One finally releases the HTTP endpoint, the metrics file and the
    # journal: a mid-stream exception must not leave the port bound or
    # the sinks open.
    try:
        refresh = (
            RefreshLoop(registry,
                        OnlineLDAConfig(num_topics=snap.model.num_topics),
                        every=cfg.refresh_every,
                        total_docs=cfg.refresh_total_docs, device=dev)
            if cfg.refresh_every else None)

        def on_batch(snapshot, feats, scores):
            for i in np.where(scores < cfg.threshold)[0]:
                print(json.dumps({
                    "flagged": feats.featurized_row(int(i)),
                    "score": float(scores[i]),
                    "model_version": snapshot.version,
                }), flush=True)
            if refresh is not None:
                ips, words = event_documents(feats, featurizer.dsource)
                new = refresh.observe(snapshot, ips, words)
                if new is not None:
                    metrics.emit({
                        "stage": "serve", "event": "model_refresh",
                        "model_version": new.version, "source": new.source,
                        "refresh_s": refresh.last_refresh_s,
                    })

        scorer = BatchScorer(registry, featurizer, cfg, metrics=metrics,
                             on_batch=on_batch, device=dev)
        # Warm the device path at the sizes the dispatch rule sends
        # there, before the first event.  The record names each knob's
        # source, the calibration the flushes dispatch on and the plan
        # layer's counters.
        warm = warmup_serving(snap.model, scorer.max_batch,
                              cfg.device_score_min, device=dev)
        plans_rec = {"stage": "serve", "event": "plans",
                     "knobs": scorer.plan, "warmup": warm,
                     "compilation_cache": args.compilation_cache,
                     "plan_counters": counters_snapshot()}
        if cfg.device_score_min in (0, "auto"):
            plans_rec["dispatch_calibration"] = dispatch_calibration(
                device=dev)
        metrics.emit(plans_rec)
        stream = sys.stdin if args.input == "-" else open(args.input)
        submitted = rejected = header_skipped = 0
        header = None
        first = True
        try:
            for line in stream:
                if not line.strip():
                    continue
                # The day's pre stage drops the CSV header and its
                # duplicates; serving matches it, or a piped raw day
                # file scores one phantom event.  Mid-stream garbage
                # rows still score, as in the day job.
                if first:
                    first = False
                    if _looks_like_header(line, args.dsource):
                        header = line
                        header_skipped += 1
                        continue
                if header is not None and line == header:
                    header_skipped += 1
                    continue
                try:
                    scorer.submit(line)
                    submitted += 1
                except ValueError:
                    rejected += 1
        finally:
            if stream is not sys.stdin:
                stream.close()
            scorer.close()
        metrics.emit({
            "stage": "serve", "event": "stream_end",
            "submitted": submitted, "rejected": rejected,
            "header_skipped": header_skipped,
            "events_scored": scorer.events_scored,
            "batches": scorer.batches_flushed,
            "final_model_version": registry.version,
        })
        _serve_roofline(emit_journal=True)
        if cfg.openmetrics_path:
            from ..telemetry import write_openmetrics

            write_openmetrics(cfg.openmetrics_path, metrics.recorder)
        metrics.emit({"stage": "serve", "event": "registry_snapshot",
                      **metrics.snapshot()})
        return 0 if scorer.events_scored == submitted else 1
    finally:
        if mserver is not None:
            mserver.close()
        metrics.close()
        if journal is not None:
            journal.close()


# ---------------------------------------------------------------------------
# --dry-run: synthetic end-to-end smoke
# ---------------------------------------------------------------------------


def _synthetic_day(n_events: int = 96, n_clients: int = 8, n_doms: int = 6,
                   seed: int = 42):
    """A tiny deterministic DNS day: raw rows, a model "trained
    yesterday" on them (Dirichlet-random theta/p over the day's IPs and
    words) and the day's cuts — the JAX package's synthetic day, draw
    for draw."""
    from ..features.dns import featurize_dns
    from ..scoring import ScoringModel

    rng = np.random.default_rng(seed)
    rows = [
        [
            "t", str(1454000000 + int(rng.integers(0, 86400))),
            str(int(rng.integers(40, 1500))),
            f"10.0.0.{i % n_clients}",
            f"sub{int(rng.integers(0, 20))}.dom{int(rng.integers(0, n_doms))}.com",
            "1", str(int(rng.integers(1, 17))), str(int(rng.integers(0, 4))),
        ]
        for i in range(n_events)
    ]
    feats = featurize_dns(rows)
    ips = sorted({feats.client_ip(i) for i in range(feats.num_events)})
    vocab = sorted(set(feats.word))
    k = 5
    theta = rng.dirichlet(np.ones(k), size=len(ips))
    p = rng.dirichlet(np.ones(len(vocab)), size=k).T
    model = ScoringModel.from_results(ips, theta, vocab, p, fallback=0.1)
    cuts = (feats.time_cuts, feats.frame_length_cuts,
            feats.subdomain_length_cuts, feats.entropy_cuts,
            feats.numperiods_cuts)
    return rows, model, cuts


def dry_run(args) -> int:
    """Load a synthetic model, score a stream of >= 3 micro-batches,
    hot-swap to a refreshed model mid-stream and check that no event was
    dropped or scored twice — the acceptance path, on args.device."""
    from ..device import resolve_device
    from ..serving import DnsEventFeaturizer

    dev = resolve_device(args.device)
    rows, model, cuts = _synthetic_day()
    registry = ModelRegistry()
    registry.publish(model, source="dry-run-synthetic")
    # Flags carry through; values the operator did not pass rescale to
    # the 96-event day (max_batch 4096 would make one batch and
    # refresh_every 0 no swap).
    cfg = ServingConfig(
        max_batch=args.max_batch if args.max_batch is not None else 32,
        max_wait_ms=(args.max_wait_ms if args.max_wait_ms is not None
                     else ServingConfig.max_wait_ms),
        refresh_every=args.refresh_every or 2,
        threshold=args.threshold,
        device_score_min=args.device_score_min,
        metrics_path=args.metrics,
    )
    metrics = MetricsEmitter(path=cfg.metrics_path)
    refresh = RefreshLoop(registry,
                          OnlineLDAConfig(num_topics=model.num_topics),
                          every=cfg.refresh_every, device=dev)
    swaps = []

    def on_batch(snapshot, feats, scores):
        ips, words = event_documents(feats, "dns")
        new = refresh.observe(snapshot, ips, words)
        if new is not None:
            swaps.append(new.version)

    scorer = BatchScorer(registry, DnsEventFeaturizer(cuts), cfg,
                         metrics=metrics, on_batch=on_batch, device=dev)
    futures = [scorer.submit(r) for r in rows]
    # Resolve before close, so the flushes exercise the live triggers,
    # not the close drain.
    results = [f.result(timeout=30.0) for f in futures]
    scorer.close()
    versions = sorted({v for _, v in results})
    triggers: "dict[str, int]" = {}
    for r in metrics.records:
        if "trigger" in r:
            triggers[r["trigger"]] = triggers.get(r["trigger"], 0) + 1
    errors = [r for r in metrics.records
              if "error" in r or "on_batch_error" in r]
    ok = (
        len(results) == len(rows)                   # none dropped
        and all(f.done() for f in futures)          # every future resolved
        and scorer.events_scored == len(rows)       # none scored twice
        and scorer.batches_flushed >= 3
        and len(swaps) >= 1                         # a hot-swap happened
        and len(versions) >= 2                      # ...and served traffic
        and not errors
        and all(np.isfinite(s) for s, _ in results)
    )
    print(json.dumps({
        "serve_dry_run": "ok" if ok else "FAILED",
        "device": str(dev),
        "events": len(rows),
        "events_scored": scorer.events_scored,
        "batches": scorer.batches_flushed,
        "triggers": triggers,
        "refresh_swaps": len(swaps),
        "model_versions_served": versions,
        "final_model_version": registry.version,
    }), flush=True)
    metrics.close()
    return 0 if ok else 1


# ---------------------------------------------------------------------------
# --fleet: multi-tenant serving
# ---------------------------------------------------------------------------


def serve_fleet_stream(args) -> int:
    """Serve every tenant of a fleet manifest through one FleetScorer on
    args.device: stacked models per topic count, per-tenant admission,
    metrics and refresh.  Stream lines are ``<tenant>\\t<raw csv
    line>`` (a one-tenant manifest also takes untagged lines)."""
    from ..device import resolve_device
    from ..plans import counters_snapshot
    from ..plans.warmup import warmup_serving
    from ..scoring import dispatch_calibration
    from ..serving import (AdmissionRejected, FleetRegistry, FleetScorer,
                           ResidencyManager, load_manifest,
                           resolve_hot_capacity)

    dev = resolve_device(args.device)
    cfg = _serving_config(args)
    specs = load_manifest(args.fleet)
    journal = None
    if args.journal:
        from ..telemetry import Journal

        journal = Journal(args.journal)
    metrics = MetricsEmitter(path=cfg.metrics_path, journal=journal)
    # Tiered residency: a hot capacity bounds the stacked members per K,
    # and the stack pads to power-of-two capacity tiers.
    hot_cap, hot_src = resolve_hot_capacity(cfg, device=dev)
    tiered = hot_cap > 0
    fleet = FleetRegistry(journal=journal, recorder=metrics.recorder,
                          capacity_tiers=tiered,
                          stack_precision=cfg.stack_precision)
    residency = None
    if tiered:
        residency = ResidencyManager(
            fleet, hot_capacity=hot_cap,
            warm_capacity=cfg.fleet_warm_tenants,
            policy=cfg.residency_policy,
            spill_dir=cfg.residency_spill_dir, journal=journal,
            recorder=metrics.recorder, capacity_source=hot_src)
    sc = ScoringConfig()
    featurizers: dict = {}
    mserver = None
    # One finally releases the pager, the HTTP endpoint, the metrics
    # file and the journal.
    try:
        for spec in specs:
            if not spec.day_dir:
                raise SystemExit(
                    f"fleet manifest tenant {spec.tenant!r} has no day_dir")
            # Under residency every tenant starts warm; the first
            # admissions fill the hot tier.
            fleet.add_tenant(spec, hot=not tiered)
            fallback = get_source(spec.dsource).fallback(sc)
            snap = fleet.load_day(spec.tenant, spec.day_dir, fallback)
            if residency is not None:
                residency.register(spec.tenant,
                                   day_source=(spec.day_dir, fallback))
            fz = _load_featurizer(spec.day_dir, args.top_domains)
            if fz.dsource != spec.dsource:
                raise SystemExit(
                    f"tenant {spec.tenant!r} declares dsource "
                    f"{spec.dsource} but {spec.day_dir} holds "
                    f"{fz.dsource} features")
            featurizers[spec.tenant] = fz
            metrics.emit({
                "stage": "serve", "event": "model_loaded",
                "tenant": spec.tenant, "source": snap.source,
                "model_version": snap.version,
                "tier": (residency.tier_of(spec.tenant)
                         if residency is not None else "hot"),
                "ips": len(snap.model.ip_index),
                "vocab": len(snap.model.word_index),
            })
        _serve_roofline = _make_serve_roofline(
            metrics, journal,
            max(fleet.tenant_k(s.tenant) for s in specs))
        if cfg.metrics_port:
            from ..telemetry import MetricsServer

            mserver = MetricsServer(metrics.recorder, port=cfg.metrics_port,
                                    host=cfg.metrics_host,
                                    refresh=_serve_roofline)
            metrics.emit({"stage": "serve", "event": "metrics_endpoint",
                          "port": mserver.port, "path": "/metrics"})
        refreshes: dict = {}
        for spec in specs:
            every = spec.refresh_every or cfg.refresh_every
            if every:
                refreshes[spec.tenant] = RefreshLoop(
                    fleet.view(spec.tenant),
                    OnlineLDAConfig(num_topics=fleet.tenant_k(spec.tenant)),
                    every=every, total_docs=cfg.refresh_total_docs,
                    device=dev)

        def on_batch(tenant, snapshot, feats, scores):
            # `scorer` binds at call time: the lane's threshold is the
            # one resolution (spec, else config) its counts use too.
            for i in np.where(scores < scorer.tenant_threshold(tenant))[0]:
                print(json.dumps({
                    "tenant": tenant,
                    "flagged": feats.featurized_row(int(i)),
                    "score": float(scores[i]),
                    "model_version": snapshot.version,
                }), flush=True)
            refresh = refreshes.get(tenant)
            if refresh is not None:
                ips, words = event_documents(feats,
                                             featurizers[tenant].dsource)
                new = refresh.observe(snapshot, ips, words)
                if new is not None:
                    metrics.emit({
                        "stage": "serve", "event": "model_refresh",
                        "tenant": tenant, "model_version": new.version,
                        "source": new.source,
                        "refresh_s": refresh.last_refresh_s,
                    })

        scorer = FleetScorer(fleet, featurizers, cfg, metrics=metrics,
                             on_batch=on_batch, journal=journal,
                             residency=residency, device=dev)
        if residency is not None:
            residency.set_pending_probe(lambda t: scorer.pending(t) > 0)
        # Warm the device path per K-group at the stacked shapes the
        # dispatch rule sends there (a K-group's tenants share its
        # stack).  Under residency the stacks form at the first
        # promotions, so the head tenants are promoted first.  A failed
        # warm-up raises: it never hides the card.
        if residency is not None:
            by_k: dict = {}
            for s in specs:
                by_k.setdefault(fleet.tenant_k(s.tenant), []).append(s.tenant)
            for group in by_k.values():
                for t in group[:max(1, hot_cap)]:
                    residency.ensure_hot(t)
        warm = []
        for k in sorted({fleet.tenant_k(s.tenant) for s in specs}):
            stack = fleet.stack(k)
            mult = max(get_source(fleet.spec(t).dsource).pairs_per_event
                       for t in stack.tenants)
            warm.append({
                "k": k, "tenants": len(stack.tenants),
                "capacity": stack.capacity or None,
                **warmup_serving(stack.model, scorer.max_batch * mult,
                                 cfg.device_score_min, device=dev)})
        plans_rec = {
            "stage": "serve", "event": "plans",
            "knobs": ({**scorer.plan, **residency.plan}
                      if residency is not None else scorer.plan),
            "warmup": warm, "compilation_cache": args.compilation_cache,
            "plan_counters": counters_snapshot()}
        if cfg.device_score_min in (0, "auto"):
            plans_rec["dispatch_calibration"] = dispatch_calibration(
                device=dev)
        metrics.emit(plans_rec)
        stream = sys.stdin if args.input == "-" else open(args.input)
        submitted = rejected = header_skipped = 0
        default_tenant = specs[0].tenant if len(specs) == 1 else None
        first_seen: set = set()
        headers: dict = {}
        try:
            for line in stream:
                if not line.strip():
                    continue
                tenant, sep, payload = line.partition("\t")
                if sep:
                    tenant = tenant.strip()
                elif default_tenant is not None:
                    tenant, payload = default_tenant, line
                else:
                    rejected += 1      # untagged line, ambiguous tenant
                    continue
                if tenant not in featurizers:
                    rejected += 1
                    continue
                # Each tenant's first line may be a CSV header, and its
                # duplicates are dropped too (serve_stream's rule).
                if tenant not in first_seen:
                    first_seen.add(tenant)
                    if _looks_like_header(payload,
                                          featurizers[tenant].dsource):
                        headers[tenant] = payload
                        header_skipped += 1
                        continue
                if headers.get(tenant) == payload:
                    header_skipped += 1
                    continue
                try:
                    scorer.submit(tenant, payload)
                    submitted += 1
                except AdmissionRejected:
                    rejected += 1      # journaled and counted per tenant
                except ValueError:
                    rejected += 1
        finally:
            if stream is not sys.stdin:
                stream.close()
            scorer.close()
        metrics.emit({
            "stage": "serve", "event": "stream_end",
            "submitted": submitted, "rejected": rejected,
            "header_skipped": header_skipped,
            "events_scored": scorer.events_scored,
            "batches": scorer.batches_flushed,
            "tenant_stats": scorer.tenant_stats(),
            "fleet_counts": dict(scorer.counts),
            "residency": (residency.stats_snapshot()
                          if residency is not None else None),
            "final_versions": {s.tenant: fleet.version(s.tenant)
                               for s in specs},
        })
        _serve_roofline(emit_journal=True)
        if cfg.openmetrics_path:
            from ..telemetry import write_openmetrics

            write_openmetrics(cfg.openmetrics_path, metrics.recorder)
        metrics.emit({"stage": "serve", "event": "registry_snapshot",
                      **metrics.snapshot()})
        if submitted == 0 and rejected > 0:
            # A stream of rejects only means the framing is wrong
            # (untagged lines into a multi-tenant fleet, or tags the
            # manifest does not name): rc 0 would call zero scored
            # events a success.
            print(f"serve: all {rejected} stream lines rejected — check "
                  "the '<tenant>\\t<line>' framing against the manifest "
                  "tenant ids", file=sys.stderr)
            return 1
        return 0 if scorer.events_scored == submitted else 1
    finally:
        if residency is not None:
            residency.close()
        if mserver is not None:
            mserver.close()
        metrics.close()
        if journal is not None:
            journal.close()


def _parse_synthetic_fleet(value: str) -> "int | None":
    """'synthetic' / 'synthetic:N' -> N (default 2); any other value is
    a manifest path -> None."""
    if value == "synthetic":
        return 2
    if value.startswith("synthetic:"):
        try:
            n = int(value.split(":", 1)[1])
        except ValueError:
            raise SystemExit(
                f"--fleet {value!r}: N in 'synthetic:N' must be an "
                "integer") from None
        if n < 2:
            raise SystemExit("--fleet synthetic:N needs N >= 2 (the "
                             "fleet acceptance path is cross-tenant)")
        return n
    return None


def dry_run_fleet(args) -> int:
    """The fleet check on synthetic in-memory tenants, on args.device:
    distinct per-tenant models score a tagged, interleaved stream
    through one FleetScorer, tenant 0 hot-swaps mid-stream, and the run
    checks per-tenant exactly-once delivery, cross-tenant packing
    (flushes spanning >= 2 tenants) and swap isolation (the other
    tenants' versions untouched)."""
    from ..device import resolve_device
    from ..serving import (DnsEventFeaturizer, FleetRegistry, FleetScorer,
                           TenantSpec)

    n_tenants = _parse_synthetic_fleet(args.fleet)
    if n_tenants is None:
        # A real manifest under --dry-run must not be replaced by the
        # synthetic fleet without a word.
        raise SystemExit(
            "--dry-run --fleet takes 'synthetic[:N]' (the dry run "
            "builds in-memory tenants); to serve a real manifest, run "
            "without --dry-run")
    dev = resolve_device(args.device)
    tenants = [f"t{i}" for i in range(n_tenants)]
    days = {t: _synthetic_day(seed=42 + i) for i, t in enumerate(tenants)}
    fleet = FleetRegistry()
    featurizers = {}
    for t in tenants:
        rows, model, cuts = days[t]
        fleet.add_tenant(TenantSpec(tenant=t, dsource="dns"))
        fleet.publish(t, model, source=f"dry-run-{t}")
        featurizers[t] = DnsEventFeaturizer(cuts)
    cfg = ServingConfig(
        fleet_max_batch=(args.max_batch if args.max_batch is not None
                         else 32),
        fleet_max_wait_ms=(args.max_wait_ms if args.max_wait_ms is not None
                           else ServingConfig.fleet_max_wait_ms),
        threshold=args.threshold,
        device_score_min=args.device_score_min,
        metrics_path=args.metrics,
    )
    metrics = MetricsEmitter(path=cfg.metrics_path)
    scorer = FleetScorer(fleet, featurizers, cfg, metrics=metrics,
                         device=dev)
    futures: dict = {t: [] for t in tenants}
    # The first half of every tenant's day, interleaved round-robin, so
    # the packed flushes span tenants.
    half = {t: len(days[t][0]) // 2 for t in tenants}
    for i in range(max(half.values())):
        for t in tenants:
            if i < half[t]:
                futures[t].append(scorer.submit(t, days[t][0][i]))
    scorer.flush()
    first_results = {t: [f.result(timeout=30.0) for f in futures[t]]
                     for t in tenants}
    # A mid-stream hot-swap of tenant 0 only, then the second half.
    swapped = tenants[0]
    fleet.publish(swapped, _perturbed_model(days[swapped][1]),
                  source="dry-run-refresh")
    for t in tenants:
        for row in days[t][0][half[t]:]:
            futures[t].append(scorer.submit(t, row))
    scorer.flush()
    results = {t: [f.result(timeout=30.0) for f in futures[t]]
               for t in tenants}
    scorer.close()
    versions = {t: sorted({v for _, v in results[t]}) for t in tenants}
    packed_flushes = sum(
        1 for r in metrics.records
        if isinstance(r.get("tenants"), int) and r["tenants"] >= 2)
    errors = [r for r in metrics.records
              if "error" in r or "on_batch_error" in r]
    ok = (
        all(len(results[t]) == len(days[t][0]) for t in tenants)
        and scorer.events_scored == sum(len(days[t][0]) for t in tenants)
        and packed_flushes >= 1                       # cross-tenant packing
        and versions[swapped][-1] >= 2                # the swap served
        and all(versions[t] == [1] for t in tenants[1:])  # isolation
        and not errors
        and all(np.isfinite(s) for t in tenants for s, _ in results[t])
    )
    print(json.dumps({
        "serve_fleet_dry_run": "ok" if ok else "FAILED",
        "device": str(dev),
        "tenants": n_tenants,
        "events": sum(len(days[t][0]) for t in tenants),
        "events_scored": scorer.events_scored,
        "batches": scorer.batches_flushed,
        "packed_flushes": packed_flushes,
        "versions_served": versions,
        "first_flush_events": sum(len(v) for v in first_results.values()),
        "tenant_stats": scorer.tenant_stats(),
    }), flush=True)
    metrics.close()
    return 0 if ok else 1


def _perturbed_model(model, seed: int = 7):
    """A validly normalized variant of `model`, the dry run's stand-in
    for a refreshed publish (same shapes, other values, so the stack
    rebuilds at the same shape).  `seed` picks the variant: fleets of
    one day's model use other seeds so tenants' scores differ."""
    from ..scoring import ScoringModel

    rng = np.random.default_rng(seed)
    theta = model.theta * rng.uniform(0.5, 1.5, model.theta.shape)
    theta[:-1] /= theta[:-1].sum(1, keepdims=True)
    p = model.p * rng.uniform(0.5, 1.5, model.p.shape)
    p[:-1] /= p[:-1].sum(0, keepdims=True)
    return ScoringModel(ip_index=model.ip_index, theta=theta,
                        word_index=model.word_index, p=p)


def main(argv: "list[str] | None" = None) -> int:
    args = build_serve_parser().parse_args(argv)
    # --no-plans binds both paths here: the BatchScorer would otherwise
    # read its dispatch calibration from, and record it into, the user's
    # plan cache.
    from ..plans import NullStore, use_store
    from ..plans.warmup import compilation_cache

    ctx = (use_store(NullStore()) if args.no_plans
           else contextlib.nullcontext())
    with ctx, compilation_cache(not args.no_compilation_cache) as cc:
        args.compilation_cache = cc
        if args.dry_run:
            if args.fleet:
                return dry_run_fleet(args)
            return dry_run(args)
        if args.fleet:
            if _parse_synthetic_fleet(args.fleet) is not None:
                raise SystemExit(
                    "--fleet synthetic is a --dry-run mode; a live serve "
                    "needs a manifest file")
            return serve_fleet_stream(args)
        return serve_stream(args)


if __name__ == "__main__":
    raise SystemExit(main())
