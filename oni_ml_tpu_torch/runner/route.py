"""`ml_ops replica` / `ml_ops route`: the replicated-serving CLI (port of
oni_ml_tpu/runner/route.py).

``ml_ops replica --id r0`` runs one serve replica process
(serving/replica.py): the FleetRegistry/FleetScorer stack behind the
framed socket protocol, heartbeating into the shared file-KV membership
directory (``--kv-dir``) or into a TCP KV server (``--kv-connect``).
``ml_ops route`` runs the router in front
(serving/router.py): it spawns (``--replicas N``) or attaches to
(``--connect``) the replicas, places every manifest tenant on a primary
and a shadow by the consistent-hash ring, and then reads the fleet
serve-stream framing on stdin (``<tenant>\\t<csv line>``) and writes
flagged events to stdout, like ``ml_ops serve --fleet``, except that the
scoring happens N processes away and a dead replica costs a shadow
promotion instead of the fleet.

The control plane is the file KV (``--kv-dir``, a temp dir by default)
or the TCP KV: ``--kv-listen [HOST][:PORT]`` runs a KVServer in the
route process and points the spawned replicas at it, ``--kv-connect
HOST:PORT`` joins another router's.  The TCP KV has no authentication:
it binds 127.0.0.1 unless told otherwise, and on any other address
whoever reaches the port can rewrite the roster.  A replica on this
host moves its link's data frames onto shared-memory rings
(``ServingConfig.wire_shm``, on by default).

``--autoscale`` runs the Little's-law controller (serving/autoscale.py):
it spawns replicas while the admission windows' EWMA'd occupancy is
above the band and drains the ones it spawned below it, between
``autoscale_min_replicas`` and ``autoscale_max_replicas``.  It stops
when the input ends.  ``--max-inflight N`` sets the admission window
(``route_max_inflight``: the events each replica may hold) that the
occupancy is measured against.

``--redeploy-after N`` performs a rolling drain-one-join-one cycle over
the replicas `route` spawned at its start after N events; the
autoscaler is held meanwhile and observes for a cooldown after it, and
its own replicas stay its own.  ``--dry-run synthetic:TxR`` is
the self-contained acceptance run (in-process replicas, synthetic tenant
days): scoring parity, a mid-stream replica kill with zero dropped
events and a rolling redeploy, reported as one JSON summary with rc 0/1.

``--device cuda|cpu`` (default the card) is where the replicas score:
`route` passes it to every replica it spawns and to the in-process
replicas of ``--dry-run``.  A replica asked for the card on a machine
without one raises.  A spawned replica's flush scores on the card only
from its ``--device-score-min`` on; the dry run on the card sends every
flush there and holds it to the float64 host scorer within
`DRY_RUN_CARD_RTOL`, while on the CPU it runs the host scorer and holds
it bit for bit.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import signal
import subprocess
import sys
import tempfile
import threading
import time
from collections import deque

import numpy as np

# The card's float32 gather-dot against the float64 host scorer: the
# fleet's bound (tests/test_torch_fleet_card.py).
DRY_RUN_CARD_RTOL = 1e-6
_KV_EXPOSURE = ("the TCP KV has no authentication: on an address other "
                "than 127.0.0.1 whoever reaches the port can rewrite the "
                "fleet's roster")


def _add_device_flag(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", choices=["cuda", "cpu"], default=None,
                   help="where the replicas score (default: the card; "
                   "'cpu' runs them on the CPU)")


def build_replica_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="ml_ops replica",
        description="Run one serve replica of the replicated fleet.")
    p.add_argument("--id", required=True, help="replica id (becomes "
                   "the membership/journal key)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=0,
                   help="listen port (0 = ephemeral)")
    p.add_argument("--kv-dir", default="",
                   help="shared file-KV membership directory "
                   "(parallel/membership.FileKVClient); empty = no "
                   "membership/heartbeats")
    p.add_argument("--kv-connect", default="", metavar="HOST:PORT",
                   help="TCP KV server to register membership with "
                   "(parallel/membership.TcpKVClient), the cross-host "
                   "alternative to --kv-dir")
    p.add_argument("--port-file", default="",
                   help="write 'host port' here once listening (the "
                   "spawn handshake)")
    p.add_argument("--fleet-max-batch", type=int, default=None)
    p.add_argument("--fleet-max-wait-ms", type=float, default=None)
    p.add_argument("--device-score-min", default=None,
                   help="int threshold (flushes of at least that many "
                   "events score on the device), 'none' to pin host "
                   "scoring, or unset for the measured auto calibration")
    _add_device_flag(p)
    return p


def _make_kv(kv_dir: str, kv_connect: str):
    """The membership transport named by the flags: a TCP KV client, the
    shared file-KV directory, or None (no membership)."""
    from ..parallel.membership import (FileKVClient, TcpKVClient,
                                       parse_hostport)

    if kv_connect:
        return TcpKVClient(*parse_hostport(kv_connect))
    if kv_dir:
        return FileKVClient(kv_dir)
    return None


def _parse_device_score_min(v):
    if v is None:
        return 0
    if isinstance(v, str) and v.lower() in ("none", "host"):
        return None
    return int(v)


def replica_main(argv: "list[str] | None" = None) -> int:
    import dataclasses

    from ..config import ServingConfig
    from ..serving import ReplicaServer

    args = build_replica_parser().parse_args(argv)
    cfg = ServingConfig(
        device_score_min=_parse_device_score_min(args.device_score_min))
    if args.fleet_max_batch is not None:
        cfg = dataclasses.replace(cfg, fleet_max_batch=args.fleet_max_batch)
    if args.fleet_max_wait_ms is not None:
        cfg = dataclasses.replace(cfg,
                                  fleet_max_wait_ms=args.fleet_max_wait_ms)
    kv = _make_kv(args.kv_dir, args.kv_connect)
    server = ReplicaServer(args.id, cfg, host=args.host, port=args.port,
                           kv=kv, device=args.device)
    if args.port_file:
        tmp = args.port_file + ".tmp"
        with open(tmp, "w") as f:
            f.write(f"{server.host} {server.port}\n")
        os.replace(tmp, args.port_file)
    print(f"REPLICA_READY {args.id} {server.host} {server.port}",
          flush=True)
    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: stop.set())
    # Exit on SIGTERM/SIGINT or a shutdown op over the wire.
    while not stop.is_set() and not server.stopped.wait(0.2):
        pass
    server.stop()
    if hasattr(kv, "close"):
        kv.close()
    return 0


# ---------------------------------------------------------------------------
# router CLI
# ---------------------------------------------------------------------------


def build_route_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="ml_ops route",
        description="Async fleet router over N serve replicas: "
        "consistent-hash tenant placement, shadow-promotion failover, "
        "rolling redeploy.")
    p.add_argument("--fleet", default="",
                   help="fleet manifest (serving/tenants.py) naming "
                   "the tenants and their day_dirs")
    p.add_argument("--replicas", type=int, default=0, metavar="N",
                   help="spawn N replica subprocesses (ml_ops "
                   "replica) on this host")
    p.add_argument("--connect", default="", metavar="ID=HOST:PORT,...",
                   help="attach to already-running replicas instead "
                   "of spawning")
    p.add_argument("--kv-dir", default="",
                   help="membership directory shared with the "
                   "replicas (default: a temp dir when spawning)")
    p.add_argument("--kv-listen", default="", metavar="[HOST][:PORT]",
                   help="run the TCP KV membership server "
                   "(parallel/membership.KVServer) here and point the "
                   "spawned replicas at it, the cross-host control plane "
                   "(empty HOST = 127.0.0.1, empty PORT = ephemeral); "
                   + _KV_EXPOSURE)
    p.add_argument("--kv-connect", default="", metavar="HOST:PORT",
                   help="join an existing TCP KV membership server "
                   "(another router's --kv-listen)")
    p.add_argument("--autoscale", action="store_true",
                   help="run the Little's-law autoscaler: spawn or drain "
                   "replicas between autoscale_min_replicas and "
                   "autoscale_max_replicas to hold the admission windows' "
                   "occupancy inside the hysteresis band")
    p.add_argument("--max-inflight", type=int, default=None, metavar="N",
                   help="the admission window: at most N events "
                   "outstanding per replica (default: ServingConfig."
                   "route_max_inflight; 0 = unbounded)")
    p.add_argument("--threshold", type=float, default=None,
                   help="suspicion threshold for flagged output "
                   "(default: ServingConfig)")
    p.add_argument("--top-domains", default=None)
    p.add_argument("--redeploy-after", type=int, default=0, metavar="N",
                   help="after N routed events, rolling-redeploy "
                   "every spawned replica (drain one, respawn, join, "
                   "next)")
    p.add_argument("--device-score-min", default=None,
                   help="passed to every spawned replica (see ml_ops "
                   "replica --help)")
    p.add_argument("--dry-run", default="", metavar="synthetic[:TxR]",
                   help="self-contained acceptance run: T synthetic "
                   "tenants over R in-process replicas (default 6x3) "
                   "with a mid-stream kill and a rolling redeploy; on "
                   "--device cuda every flush scores on the card, on "
                   "--device cpu on the host")
    _add_device_flag(p)
    return p


# How long a spawned replica may take to write its port file.
_SPAWN_TIMEOUT_S = 120.0


def _start_replica(rid: str, kv_flags: "str | list[str]", workdir: str,
                   extra: "list[str] | None" = None):
    """Exec one `ml_ops replica` subprocess (never a fork of a process
    that may hold a CUDA context) -> (proc, port_file)."""
    port_file = os.path.join(workdir, f"{rid}.port")
    try:
        os.remove(port_file)
    except FileNotFoundError:
        pass
    if isinstance(kv_flags, str):
        kv_flags = ["--kv-dir", kv_flags]
    cmd = [sys.executable, "-m", "oni_ml_tpu_torch.runner.ml_ops",
           "replica", "--id", rid, "--port-file", port_file,
           *kv_flags, *(extra or [])]
    env = dict(os.environ)
    # The child must import this checkout's package wherever the router
    # was launched from (the repo is run in place, not installed).
    pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = pkg_root + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    # The child's stdout must not interleave with the router's; the port
    # file is the readiness handshake, so the log is diagnostic only.
    log = open(os.path.join(workdir, f"{rid}.log"), "ab")
    try:
        proc = subprocess.Popen(cmd, env=env, stdout=log,
                                stderr=subprocess.STDOUT)
    finally:
        log.close()
    return proc, port_file


def _await_replica(rid: str, proc, port_file: str, deadline: float):
    """Wait for a started replica's port-file handshake -> (host, port);
    a replica that exits first or misses the deadline is killed and
    raises."""
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            raise RuntimeError(
                f"replica {rid} exited rc={proc.returncode} before "
                "listening")
        try:
            with open(port_file) as f:
                host, port = f.read().split()
            return host, int(port)
        except (FileNotFoundError, ValueError):
            time.sleep(0.05)
    proc.kill()
    proc.wait(timeout=30.0)
    raise RuntimeError(f"replica {rid} never wrote {port_file}")


def _spawn_replicas(rids: "list[str]", kv_flags: "str | list[str]",
                    workdir: str, extra: "list[str] | None" = None,
                    timeout_s: float = _SPAWN_TIMEOUT_S) -> dict:
    """Start every replica at once, then wait for each handshake:
    rid -> (proc, host, port).  `kv_flags` is the shared file-KV
    directory or a flag list (["--kv-connect", "host:port"]), as the
    JAX `_spawn_replica` takes.  Each process takes seconds to import
    torch and open its CUDA context, so N start in about the time of
    one.  On a failure every process started here is killed."""
    started = {rid: _start_replica(rid, kv_flags, workdir, extra)
               for rid in rids}
    deadline = time.monotonic() + timeout_s
    out = {}
    try:
        for rid, (proc, port_file) in started.items():
            out[rid] = (proc, *_await_replica(rid, proc, port_file,
                                              deadline))
    except BaseException:
        for proc, _ in started.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30.0)
        raise
    return out


def _spawn_replica(rid: str, kv_flags: "str | list[str]", workdir: str,
                   extra: "list[str] | None" = None,
                   timeout_s: float = _SPAWN_TIMEOUT_S):
    """One `ml_ops replica` subprocess -> (proc, host, port) after the
    port-file handshake."""
    return _spawn_replicas([rid], kv_flags, workdir, extra,
                           timeout_s)[rid]


class _FlagCollector:
    """FIFO future resolver for the stream front: resolves routed
    futures in submit order and writes flagged events (score under the
    tenant threshold) to stdout in the fleet framing."""

    def __init__(self, thresholds: dict, out) -> None:
        self._thresholds = thresholds
        self._out = out
        self._cond = threading.Condition()
        self._queue: deque = deque()
        self._stopped = False
        self.resolved = 0
        self.errors = 0
        self.flagged = 0
        self._thread = threading.Thread(
            target=self._run, name="oni-route-flags", daemon=True)
        self._thread.start()

    def add(self, tenant: str, line: str, future) -> None:
        with self._cond:
            self._queue.append((tenant, line, future))
            self._cond.notify_all()

    def _run(self) -> None:
        while True:
            with self._cond:
                while not self._queue and not self._stopped:
                    self._cond.wait()
                if not self._queue:
                    return
                tenant, line, fut = self._queue.popleft()
            try:
                score, _ = fut.result(timeout=300.0)
            except Exception:
                with self._cond:
                    self.errors += 1
                continue
            with self._cond:
                self.resolved += 1
                flag = score < self._thresholds.get(tenant, 0.0)
                if flag:
                    self.flagged += 1
            if flag:
                self._out.write(f"{tenant}\t{score:.6e}\t{line}\n")
                self._out.flush()

    def close(self) -> None:
        with self._cond:
            self._stopped = True
            self._cond.notify_all()
        self._thread.join(timeout=300.0)


def _retire(router, retired: dict, rid: str) -> dict:
    """Drain `rid` out of the rotation, first keeping its own stats reply
    (device, peak device memory, events scored) and its link's transport
    in `retired[rid]`: the router forgets both at the drain, and the
    summary reports every replica the run had."""
    retired[rid] = {"stats": router.replica_stats().get(rid),
                    "wire": router.wire().get(rid)}
    return router.drain_replica(rid)


def _rolling_redeploy(router, procs: dict, kv_flags, workdir: str,
                      extra: "list[str]", olds: "list[str]",
                      retired: dict) -> "list[dict]":
    """Drain one, join its replacement, next, over the replicas `olds`
    (each in `procs`): the fleet keeps serving throughout (the router promotes
    each drained replica's tenants to their warm shadows, and the
    placement pulls them back when the replacement joins).  The
    replacements start together before the first drain (the JAX package
    spawns each after its drain); none joins the rotation before its
    predecessor has drained.  Each drain goes through `_retire`."""
    spawned = _spawn_replicas([f"{rid}v2" for rid in olds], kv_flags,
                              workdir, extra)
    for rid, (proc, _, _) in spawned.items():
        procs[rid] = proc
    out = []
    for rid in olds:
        drained = _retire(router, retired, rid)
        proc = procs.pop(rid)
        proc.terminate()
        proc.wait(timeout=60.0)
        _, host, port = spawned[f"{rid}v2"]
        joined = router.join_replica(f"{rid}v2", host, port)
        out.append({"drained": drained, "joined": joined})
    return out


def _control_plane(args, workdir: str):
    """(kv client, the spawned replicas' KV flags, the KV server this
    process runs or None) from --kv-listen / --kv-connect / --kv-dir."""
    from ..parallel.membership import KVServer, TcpKVClient, parse_hostport

    if args.kv_listen:
        server = KVServer(*parse_hostport(args.kv_listen, default_port=0))
        print(f"KV_LISTEN {server.host} {server.port}", file=sys.stderr,
              flush=True)
        try:
            kv = TcpKVClient(server.host, server.port)
        except OSError:
            server.close()
            raise
        return kv, ["--kv-connect", f"{server.host}:{server.port}"], server
    if args.kv_connect:
        return (_make_kv("", args.kv_connect),
                ["--kv-connect", args.kv_connect], None)
    kv_dir = args.kv_dir or os.path.join(workdir, "kv")
    return _make_kv(kv_dir, ""), ["--kv-dir", kv_dir], None


def route_stream(args) -> int:
    import dataclasses

    from ..config import ScoringConfig, ServingConfig
    from ..serving import (AutoScaler, FleetRouter, ModelRegistry,
                           load_manifest)
    from ..sources import get as get_source
    from ..telemetry.spans import Recorder
    from .serve import _load_featurizer

    if not args.fleet:
        print("route: --fleet MANIFEST is required for stream mode",
              file=sys.stderr)
        return 2
    specs = load_manifest(args.fleet)
    cfg = ServingConfig()
    if args.max_inflight is not None:
        cfg = dataclasses.replace(cfg, route_max_inflight=args.max_inflight)
    workdir = tempfile.mkdtemp(prefix="oni_route_")
    procs: dict = {}
    extra: "list[str]" = []
    if args.device:
        extra += ["--device", args.device]
    if args.device_score_min is not None:
        extra += ["--device-score-min", str(args.device_score_min)]
    recorder = Recorder()
    kv = kv_server = scaler = router = None
    try:
        kv, kv_flags, kv_server = _control_plane(args, workdir)
        router = FleetRouter(cfg, kv=kv, recorder=recorder)
        if args.replicas:
            spawned = _spawn_replicas(
                [f"r{i}" for i in range(args.replicas)], kv_flags, workdir,
                extra)
            for rid, (proc, _, _) in spawned.items():
                procs[rid] = proc
            for rid, (_, host, port) in spawned.items():
                router.connect_replica(rid, host, port)
        elif args.connect:
            for part in args.connect.split(","):
                rid, _, addr = part.strip().partition("=")
                host, _, port = addr.partition(":")
                router.connect_replica(rid, host, int(port))
        else:
            print("route: need --replicas N or --connect",
                  file=sys.stderr)
            return 2
        thresholds: dict = {}
        sc_threshold = (args.threshold if args.threshold is not None
                        else cfg.threshold)
        for spec in specs:
            if not spec.day_dir:
                raise SystemExit(f"tenant {spec.tenant!r} has no day_dir")
            fallback = get_source(spec.dsource).fallback(ScoringConfig())
            snap = ModelRegistry().load_day(spec.day_dir, fallback)
            fz = _load_featurizer(spec.day_dir, args.top_domains)
            router.add_tenant(spec, (), snap.model, featurizer=fz)
            thresholds[spec.tenant] = (spec.threshold
                                       if spec.threshold is not None
                                       else sc_threshold)
        router.start()
        autoscaled: "set[str]" = set()
        retired: dict = {}
        if args.autoscale:
            spawn_seq = [len(procs)]

            def _as_spawn():
                rid = f"as{spawn_seq[0]}"
                spawn_seq[0] += 1
                proc, host, port = _spawn_replica(rid, kv_flags, workdir,
                                                  extra)
                procs[rid] = proc
                autoscaled.add(rid)
                return rid, host, port

            def _as_stop(rid):
                proc = procs.pop(rid, None)
                if proc is not None:
                    proc.terminate()
                    proc.wait(timeout=60.0)

            scaler = AutoScaler(
                router, spawn=_as_spawn, stop=_as_stop, config=cfg,
                drain=lambda rid: _retire(router, retired, rid))
            scaler.start()
        collector = _FlagCollector(thresholds, sys.stdout)
        routed = skipped = 0
        redeploys: "list[dict]" = []
        redeploy_s = None
        t0 = time.perf_counter()
        for line in sys.stdin:
            line = line.rstrip("\n")
            if not line:
                continue
            tenant, sep, payload = line.partition("\t")
            if not sep:
                skipped += 1
                continue
            try:
                # The raw line, which every source's featurizer takes
                # (the JAX CLI sends the split fields, which its flow
                # featurizer refuses).
                fut = router.submit(tenant, payload)
            except (KeyError, ValueError, RuntimeError):
                skipped += 1
                continue
            collector.add(tenant, payload, fut)
            routed += 1
            if (args.redeploy_after and procs
                    and routed == args.redeploy_after):
                t_re = time.perf_counter()
                with (scaler.hold() if scaler is not None
                      else contextlib.nullcontext()):
                    redeploys = _rolling_redeploy(
                        router, procs, kv_flags, workdir, extra,
                        sorted(set(procs) - autoscaled), retired)
                redeploy_s = time.perf_counter() - t_re
        if scaler is not None:
            # The input has ended: nothing is left to scale for, and the
            # replicas the controller joined stay for the summary.  A
            # spawn under way finishes (its replica then joins procs).
            scaler.close(timeout_s=_SPAWN_TIMEOUT_S + 30.0)
        router.flush()
        collector.close()
        stream_s = time.perf_counter() - t0
        summary = {
            "route": "ok",
            "routed": routed,
            "skipped": skipped,
            "resolved": collector.resolved,
            "errors": collector.errors,
            "flagged": collector.flagged,
            "redeploys": len(redeploys),
            "stats": router.stats(),
            # What the JAX summary does not carry: the stream's wall and
            # route latency, the redeploy's wall, each replica's own
            # stats reply (device, peak device memory) and each link's
            # transport (shared-memory rings or TCP), the drained
            # replicas' (the redeploy's and the autoscaler's) included.
            "stream_s": stream_s,
            "hop_ms": recorder.histogram("route.hop_ms").summary(),
            "redeploy_s": redeploy_s,
            "replica_stats": {
                **{r: v["stats"] for r, v in retired.items()},
                **router.replica_stats()},
            "wire": {**{r: v["wire"] for r, v in retired.items()},
                     **router.wire()},
        }
        if scaler is not None:
            summary["autoscale"] = [d for d in scaler.decisions
                                    if d["action"] != "hold"]
        print(json.dumps(summary), file=sys.stderr, flush=True)
        return 0 if collector.errors == 0 else 1
    finally:
        if scaler is not None:
            scaler.close()
        if router is not None:
            router.close()
        if hasattr(kv, "close"):
            kv.close()
        if kv_server is not None:
            kv_server.close()
        for proc in procs.values():
            proc.terminate()
        for proc in procs.values():
            try:
                proc.wait(timeout=30.0)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=30.0)
        import shutil

        # The workdir (port files, replica logs, the default kv dir) is
        # ours: a restarted front must not leave one behind each time.
        shutil.rmtree(workdir, ignore_errors=True)


def _parse_dry_run(spec: str) -> "tuple[int, int]":
    """``synthetic`` or ``synthetic:TxR`` -> (tenants, replicas)."""
    if not spec.startswith("synthetic"):
        raise SystemExit(f"--dry-run wants synthetic[:TxR], got {spec!r}")
    _, _, dims = spec.partition(":")
    if not dims:
        return 6, 3
    t, _, r = dims.partition("x")
    return max(2, int(t)), max(2, int(r))


def dry_run(args) -> int:
    """The acceptance path, runnable anywhere: T synthetic tenants placed
    over R in-process replicas on `--device`; scores must match the
    single-process float64 host scorer (bit for bit on the CPU, where
    the replicas score on the host; within DRY_RUN_CARD_RTOL on the
    card, where every flush scores on the card), a mid-stream replica
    kill must drop zero events (shadow promotion + admission-journal
    replay), and a rolling drain+join must keep every surviving future
    resolvable."""
    from ..config import ServingConfig
    from ..device import resolve_device
    from ..serving import (DnsEventFeaturizer, FleetRouter, ReplicaServer,
                           TenantSpec, score_features)
    from .serve import _synthetic_day

    n_tenants, n_replicas = _parse_dry_run(args.dry_run)
    device = resolve_device(args.device)
    on_card = device.type == "cuda"
    rtol = DRY_RUN_CARD_RTOL if on_card else 0.0
    cfg = ServingConfig(fleet_max_batch=32, fleet_max_wait_ms=5.0,
                        device_score_min=1 if on_card else None)
    replicas: dict = {}
    router = FleetRouter(cfg)
    days = {}
    try:
        for i in range(n_replicas):
            replicas[f"r{i}"] = ReplicaServer(f"r{i}", cfg,
                                              device=device)
        for rid, rep in replicas.items():
            router.connect_replica(rid, rep.host, rep.port)
        for i in range(n_tenants):
            t = f"t{i}"
            days[t] = _synthetic_day(n_events=48, seed=100 + i)
            rows, model, cuts = days[t]
            router.add_tenant(TenantSpec(tenant=t, dsource="dns"), cuts,
                              model)
        router.start()
        placement = router.placement()

        def replay(rows_per_tenant: int):
            futs = {t: [router.submit(t, r)
                        for r in days[t][0][:rows_per_tenant]]
                    for t in days}
            router.flush()
            ok, dropped = True, 0
            for t, fs in futs.items():
                rows, model, cuts = days[t]
                feats = DnsEventFeaturizer(cuts)(rows[:rows_per_tenant])
                oracle = score_features(model, feats, "dns")
                try:
                    got = np.array([f.result(timeout=60.0)[0] for f in fs])
                except Exception:
                    dropped += 1
                    ok = False
                    continue
                if not (np.array_equal(got, oracle) if rtol == 0.0 else
                        np.all(np.abs(got - oracle)
                               <= rtol * np.abs(oracle))):
                    ok = False
            return ok, dropped

        parity_ok, dropped0 = replay(24)
        # Chaos: kill the replica that primaries t0 with events in
        # flight; every future must still resolve, and survivors stay
        # bit-identical.
        victim = placement["t0"].primary
        futs = {t: [router.submit(t, r) for r in days[t][0][24:44]]
                for t in days}
        replicas[victim].kill()
        router.flush()
        chaos_dropped = 0
        for t, fs in futs.items():
            for f in fs:
                try:
                    f.result(timeout=60.0)
                except Exception:
                    chaos_dropped += 1
        post_ok, dropped1 = replay(16)
        # The failover journals its record after its resends and its
        # model backfill, which can outlast the futures it resolved.
        deadline = time.monotonic() + 60.0
        while (not router.stats()["failovers"]
               and time.monotonic() < deadline):
            time.sleep(0.01)
        failovers = router.stats()["failovers"]
        # Rolling redeploy over the survivors: join a fresh replica, then
        # drain one; the fleet serves throughout.
        spare = ReplicaServer("rx", cfg, device=device)
        replicas["rx"] = spare
        router.join_replica("rx", spare.host, spare.port)
        drain_target = next(r for r in sorted(replicas)
                            if r != victim and r != "rx")
        drained = router.drain_replica(drain_target)
        redeploy_ok, dropped2 = replay(12)
        ok = (parity_ok and post_ok and redeploy_ok
              and chaos_dropped == 0
              and dropped0 == dropped1 == dropped2 == 0
              and len(failovers) >= 1
              and drained["drained"])
        summary = {
            "route_dry_run": "ok" if ok else "FAILED",
            "tenants": n_tenants,
            "replicas": n_replicas,
            "parity": parity_ok,
            "killed": victim,
            "chaos_dropped": chaos_dropped,
            "post_failover_parity": post_ok,
            "failovers": failovers,
            "redeploy": {"drained": drained, "parity": redeploy_ok},
            # Not in the JAX summary: where the replicas scored and the
            # bound their scores were held to.
            "scoring": {"device": str(device),
                        "engine": "device" if on_card else "host",
                        "rtol": rtol},
        }
        print(json.dumps(summary), flush=True)
        return 0 if ok else 1
    finally:
        router.close()
        for rep in replicas.values():
            rep.stop()


def route_main(argv: "list[str] | None" = None) -> int:
    args = build_route_parser().parse_args(argv)
    if args.dry_run:
        return dry_run(args)
    return route_stream(args)
