"""Background device-liveness prober: a device that stops answering
becomes a clean `BackendLost`, not a hang (port of
oni_ml_tpu/telemetry/heartbeat.py).

The monitor probes the device on a cadence with a tiny add on the
device and a `.item()` (the smallest full round trip: launch, compute,
device-to-host copy), run on a worker thread so a wedged driver cannot
hang the monitor itself.  Misses escalate to a subprocess probe: a
fresh `python -c` that prints `torch.cuda.device_count()` under the
parent's CUDA_VISIBLE_DEVICES, which sidesteps a wedged in-process CUDA
context.  Only when THAT also fails is the device declared lost.

On loss the monitor journals a `backend_lost` record (crash-safe:
post-mortems see when liveness ended, even if the process then hung),
fires `on_lost`, and every later `check()` raises `BackendLost`, which
the runner surfaces as a clean failure at the next stage boundary
instead of entering another device call that would hang.

The monitor cannot interrupt a CUDA call already in flight (Python
cannot interrupt a blocked C extension), so its guarantees are: the
loss is detected and journaled promptly, and no NEW device work is
entered after detection.  Bounding the in-flight call remains the job
of process-level timeouts.
"""

from __future__ import annotations

import os
import subprocess
import sys
import threading

from .spans import now_ns


class BackendLost(RuntimeError):
    """The device stopped answering liveness probes."""


def device_add_probe(timeout_s: float = 30.0,
                     device="cuda") -> "float | None":
    """One liveness round trip: an add on `device` and a scalar copy to
    the host, on a worker thread.  Returns the latency in seconds, or
    None when the call wedged past `timeout_s` or raised (the worker
    thread is daemonic and abandoned: a hung device call cannot be
    cancelled)."""
    result: dict = {}

    def work():
        try:
            import torch

            t0 = now_ns()
            out = (torch.ones((), device=device) + 1).item()
            if out == 2.0:
                result["latency_s"] = (now_ns() - t0) / 1e9
        except Exception as e:  # driver/launch failure = miss
            result["error"] = repr(e)[:200]

    t = threading.Thread(target=work, name="oni-heartbeat-probe",
                         daemon=True)
    t.start()
    t.join(timeout_s)
    if t.is_alive() or "latency_s" not in result:
        return None
    return result["latency_s"]


_COUNT_CODE = "import torch; print(torch.cuda.device_count())"


def subprocess_probe(timeout_s: float = 120.0) -> "int | None":
    """The CUDA device count as a fresh Python process sees it (it
    inherits the parent's environment, CUDA_VISIBLE_DEVICES included,
    and imports torch alone): a fresh process sidesteps a wedged
    in-process CUDA context.  Returns the count, or None when the probe
    failed or timed out."""
    try:
        out = subprocess.run(
            [sys.executable, "-c", _COUNT_CODE], capture_output=True,
            text=True, timeout=timeout_s, env=dict(os.environ),
        )
    except (OSError, subprocess.TimeoutExpired):
        return None
    if out.returncode != 0:
        return None
    try:
        return int(out.stdout.strip().splitlines()[-1])
    except (ValueError, IndexError):
        return None


class HeartbeatMonitor:
    """Periodic device-liveness probe with journaled outcomes.

    probe/deep_probe are injectable for tests.  `deep_probe=None`
    disables the subprocess escalation (in-process misses alone then
    declare the loss).  The first probe runs as the monitor starts, then
    one every `interval_s`."""

    def __init__(self, interval_s: float = 30.0, timeout_s: float = 60.0,
                 max_misses: int = 2, journal=None,
                 probe=device_add_probe, deep_probe=subprocess_probe,
                 deep_timeout_s: float = 120.0, on_lost=None,
                 recorder=None) -> None:
        if interval_s <= 0:
            raise ValueError(f"interval_s must be > 0, got {interval_s}")
        self.interval_s = float(interval_s)
        self.timeout_s = float(timeout_s)
        self.max_misses = max(1, int(max_misses))
        self.journal = journal           # RunJournal (or None)
        self.probe = probe
        self.deep_probe = deep_probe
        self.deep_timeout_s = float(deep_timeout_s)
        self.on_lost = on_lost
        # Probe round trips route into the shared registry
        # (`heartbeat.probe_latency_s` histogram, `heartbeat.misses`
        # counter), so rising probe latency is visible before
        # BackendLost ever fires.  Bound at construction: the probe loop
        # runs on a worker thread, where the current_recorder contextvar
        # would not propagate.
        from .spans import current_recorder

        self.recorder = recorder if recorder is not None \
            else current_recorder()
        self.lost = threading.Event()
        self.lost_reason: "str | None" = None
        self.beats = 0
        self.misses = 0
        self._stop = threading.Event()
        self._thread: "threading.Thread | None" = None

    # -- lifecycle -------------------------------------------------------
    def start(self) -> "HeartbeatMonitor":
        if self._thread is not None:
            return self
        self._thread = threading.Thread(
            target=self._loop, name="oni-heartbeat", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        # Never join past one probe timeout: a probe thread wedged in a
        # dead device must not make stop() hang the caller.
        if t is not None:
            t.join(self.timeout_s + 1.0)

    # -- the contract ----------------------------------------------------
    def check(self) -> None:
        """Raise BackendLost once the device has been declared dead —
        what stage boundaries call so no new device work is entered."""
        if self.lost.is_set():
            raise BackendLost(
                self.lost_reason or "device stopped answering liveness "
                "probes"
            )

    def beat_once(self) -> bool:
        """One probe cycle (also the test entry point): probe, journal,
        escalate on sustained misses.  Returns liveness."""
        latency = self.probe(self.timeout_s)
        self.beats += 1
        if latency is not None:
            self.misses = 0
            if self.recorder is not None:
                self.recorder.histogram(
                    "heartbeat.probe_latency_s"
                ).observe(latency)
            if self.journal is not None:
                self.journal.heartbeat(True, latency_s=round(latency, 6))
            return True
        self.misses += 1
        if self.recorder is not None:
            self.recorder.counter("heartbeat.misses").add(1)
        if self.journal is not None:
            self.journal.heartbeat(
                False, misses=self.misses, timeout_s=self.timeout_s
            )
        if self.misses < self.max_misses:
            return False
        # Sustained misses: escalate to the subprocess probe before
        # declaring loss — an in-process stall with a healthy device (a
        # long kernel build holding the GIL) must not kill the run.
        detail = ""
        if self.deep_probe is not None:
            n = self.deep_probe(self.deep_timeout_s)
            if n is not None and n > 0:
                self.misses = 0
                if self.journal is not None:
                    self.journal.annotation(
                        "heartbeat_deep_probe", recovered=True, devices=n
                    )
                return False
            detail = "; subprocess probe also unresponsive"
        self._declare_lost(
            f"{self.misses} consecutive liveness probes missed "
            f"(timeout {self.timeout_s:.0f}s each)" + detail
        )
        return False

    def _declare_lost(self, reason: str) -> None:
        if self.lost.is_set():
            return
        self.lost_reason = reason
        self.lost.set()
        if self.journal is not None:
            self.journal.backend_lost(reason=reason)
        if self.on_lost is not None:
            try:
                self.on_lost(reason)
            except Exception:
                pass  # observer failure must not mask the loss itself

    def _loop(self) -> None:
        while not self.lost.is_set():
            self.beat_once()
            if self._stop.wait(self.interval_s):
                return
