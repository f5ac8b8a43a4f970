"""Little's-law autoscaler (port of oni_ml_tpu/serving/autoscale.py): a
controller thread that sizes the replicated fleet to the offered load.

The router bounds each edge's admission window (``route_max_inflight``:
at most that many events outstanding per replica), and its ``stats()``
report each window's occupancy, the concurrency actually present,
L = lambda * W by Little's law.  The controller estimates no service
time: it steers the measured occupancy fraction

    util = L / (n_replicas * route_max_inflight)

into a hysteresis band.  Above ``autoscale_high`` one replica joins;
below ``autoscale_low`` (and above ``autoscale_min_replicas``) the
youngest replica the controller spawned drains out.  The utilization
is EWMA-smoothed with a true half-life (``autoscale_halflife_s``: the
weight adapts to the actual tick spacing), so one bursty chunk cannot
flap the fleet, and every action starts an ``autoscale_cooldown_s``
cooldown in which the controller only observes: a join or drain shifts
util itself.

Every tick journals a ``{"kind": "autoscale"}`` record with all the
controller's inputs (occupancy, util, EWMA, arrival rate, stall rate)
beside the decision.  A scale-up also carries ``reaction_s``, from the
raw signal's first breach of the band to the join.

Replica lifecycle is delegated: ``spawn()`` returns ``(replica_id,
host, port)`` of a started replica and ``stop(replica_id)`` ends one,
so the same controller drives subprocess replicas (runner/route.py) and
in-process test replicas.  ``drain(replica_id)`` (not in the JAX
controller; default ``router.drain_replica``) takes a replica out of the
rotation before ``stop``: route.py keeps the replica's own stats reply
and its link's transport there, which the router forgets at the drain.
It only ever drains replicas it spawned itself; operator-connected
replicas are the floor it scales on.  A
spawn or drain that raises inside the controller thread is journaled as
``action: "error"``, and kept in ``decisions`` (the JAX controller only
journals it), and the controller keeps observing.  ``hold()`` (not in
the JAX controller) keeps the thread from ticking while the caller
changes the fleet itself, as a rolling redeploy does: the redeploy's
pause in the stream is not load, so smoothing restarts after it, and
its drains and joins shift util as the controller's own do, so the
first sample after it starts a cooldown.
"""

from __future__ import annotations

import contextlib
import threading
import time

from ..config import ServingConfig


class AutoScaler:
    """Controller-thread fleet sizing over a FleetRouter.  Lifecycle:
    construct -> start() -> (ticks) -> close().  ``tick()`` is public and
    takes the clock as an argument, so tests drive the control law
    without threads or sleeps."""

    def __init__(self, router, *, spawn, stop, drain=None,
                 config: "ServingConfig | None" = None,
                 journal=None) -> None:
        self._router = router
        self._spawn = spawn
        self._stop_replica = stop
        self._drain = drain or router.drain_replica
        self.config = config or getattr(router, "config", None) \
            or ServingConfig()
        self._journal = getattr(journal, "journal", journal)
        self._lock = threading.Lock()
        self._owned: "list[str]" = []      # spawn order; drain LIFO
        self._util_ewma: "float | None" = None
        self._last_t: "float | None" = None
        self._last_events: "int | None" = None
        self._last_stall_s: "float | None" = None
        self._cooldown_until = 0.0
        self._breach_t: "float | None" = None   # first over-band tick
        # Set by hold(): the next tick starts a cooldown on its own clock.
        self._cooldown_next = False
        self.decisions: "list[dict]" = []
        self._stop_evt = threading.Event()
        self._thread: "threading.Thread | None" = None
        # Held by the thread's tick and by hold().
        self._tick_lock = threading.Lock()

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        with self._lock:
            if self._thread is not None:
                raise RuntimeError("autoscaler already started")
            self._thread = threading.Thread(
                target=self._run, name="oni-autoscale", daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while not self._stop_evt.wait(self.config.autoscale_interval_s):
            try:
                with self._tick_lock:
                    if self._stop_evt.is_set():
                        return
                    self.tick()
            except Exception as e:
                # A failed spawn or drain must not stop the controller:
                # it is journaled (and kept in `decisions`) as an error.
                record = {"kind": "autoscale", "action": "error",
                          "error": repr(e)[:300]}
                with self._lock:
                    self.decisions.append(record)
                self._journal_safe(record)

    def close(self, timeout_s: float = 10.0) -> None:
        self._stop_evt.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout_s)

    @contextlib.contextmanager
    def hold(self):
        """No tick runs inside the block (one under way finishes first);
        after it the EWMA and the rates restart from the next sample, and
        that sample starts a cooldown: the block changed the fleet, and
        its fresh replicas' empty windows are not the load."""
        with self._tick_lock:
            yield
            with self._lock:
                self._util_ewma = None
                self._last_t = None
                self._last_events = None
                self._last_stall_s = None
                self._breach_t = None
                self._cooldown_next = True

    # -- the control law ---------------------------------------------------

    def tick(self, now: "float | None" = None) -> dict:
        """One controller step: sample, smooth, decide, act, journal.
        Returns the decision record (also journaled)."""
        now = time.monotonic() if now is None else now
        stats = self._router.stats()
        replicas = stats.get("replicas", [])
        n = len(replicas)
        cap = int(stats.get("max_inflight") or 0) or 1
        edges = stats.get("edges", {})
        occupancy = sum(int(e.get("inflight", 0)) for e in edges.values())
        events = sum(int(e.get("events", 0)) for e in edges.values())
        stall_s = sum(float(e.get("admission_stall_s", 0.0))
                      for e in edges.values())
        util = occupancy / float(max(1, n) * cap)

        with self._lock:
            if self._cooldown_next:
                self._cooldown_next = False
                self._cooldown_until = (
                    now + self.config.autoscale_cooldown_s)
            dt = (now - self._last_t) if self._last_t is not None \
                else self.config.autoscale_interval_s
            dt = max(dt, 1e-9)
            # A true half-life: alpha follows the actual tick spacing, so
            # a stalled controller thread does not over-weight stale
            # samples when it resumes.
            alpha = 1.0 - 0.5 ** (dt / self.config.autoscale_halflife_s)
            if self._util_ewma is None:
                self._util_ewma = util
            else:
                self._util_ewma += alpha * (util - self._util_ewma)
            util_ewma = self._util_ewma
            lambda_eps = ((events - self._last_events) / dt
                          if self._last_events is not None else 0.0)
            stall_rate = ((stall_s - self._last_stall_s) / dt
                          if self._last_stall_s is not None else 0.0)
            self._last_t = now
            self._last_events = events
            self._last_stall_s = stall_s
            in_cooldown = now < self._cooldown_until
            over = util_ewma > self.config.autoscale_high
            under = util_ewma < self.config.autoscale_low
            # The breach clock starts on the raw signal (the first sample
            # over the band) while the decision waits for the EWMA, so
            # reaction_s is smoothing delay + cooldown + spawn.
            raw_over = util > self.config.autoscale_high
            if raw_over and self._breach_t is None:
                self._breach_t = now
            elif not raw_over and not over:
                self._breach_t = None
            breach_t = self._breach_t

        action, reason, reaction_s = "hold", "in band", None
        if in_cooldown:
            action, reason = "hold", "cooldown"
        elif over and n >= self.config.autoscale_max_replicas:
            action, reason = "hold", "at max_replicas"
        elif over:
            action = "up"
            reason = (f"util_ewma {util_ewma:.3f} > "
                      f"high {self.config.autoscale_high:.3f}")
        elif under and n > max(self.config.autoscale_min_replicas, 1):
            with self._lock:
                candidates = [r for r in reversed(self._owned)
                              if r in replicas]
            if candidates:
                action = "down"
                reason = (f"util_ewma {util_ewma:.3f} < "
                          f"low {self.config.autoscale_low:.3f}")
            else:
                action, reason = "hold", "nothing owned to drain"

        record = {
            "kind": "autoscale", "action": action, "reason": reason,
            "replicas": n, "occupancy": occupancy,
            "util": round(util, 6), "util_ewma": round(util_ewma, 6),
            "lambda_eps": round(lambda_eps, 3),
            "stall_rate": round(stall_rate, 6),
            "cooldown": in_cooldown,
        }

        if action == "up":
            rid, host, port = self._spawn()
            self._router.join_replica(rid, host, port)
            with self._lock:
                self._owned.append(rid)
                self._cooldown_until = (
                    now + self.config.autoscale_cooldown_s)
                # The join absorbed the backlog the EWMA accumulated:
                # restart smoothing from the live sample, so the next
                # decision reflects the grown fleet, not its history.
                self._util_ewma = None
                self._breach_t = None
            if breach_t is not None:
                reaction_s = now - breach_t
            record.update(replica=rid, reaction_s=round(
                reaction_s if reaction_s is not None else 0.0, 6))
        elif action == "down":
            victim = candidates[0]
            self._drain(victim)
            try:
                self._stop_replica(victim)
            except Exception:
                pass
            with self._lock:
                self._owned.remove(victim)
                self._cooldown_until = (
                    now + self.config.autoscale_cooldown_s)
                self._util_ewma = None
            record.update(replica=victim)

        with self._lock:
            self.decisions.append(record)
        self._journal_safe(record)
        return record

    def _journal_safe(self, record: dict) -> None:
        if self._journal is None:
            return
        try:
            self._journal.append(record)
        except Exception as e:
            import sys

            print(f"autoscale journal append failed: {e!r}",
                  file=sys.stderr)
