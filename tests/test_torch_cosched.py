"""The port's train/serve co-scheduler (oni_ml_tpu_torch/serving/
coscheduler.py), held to the timings the JAX package's threading tests
set for its own class (tests/test_cosched_fleet.py:60-149), and its
journal vocabulary against the JAX class's on the same uncontended
sequence.  The CoScheduler needs no device: these run on the CPU.

Tolerances are the JAX tests' wall-clock bounds: a chunk blocked by a
live serve slot stays out for 0.25 s and enters within 5 s of the
release; the starvation cap of 0.2 s holds a chunk 0.15-2.0 s."""

import threading
import time

import pytest

from oni_ml_tpu.serving import CoScheduler as JCoScheduler
from oni_ml_tpu.telemetry import Recorder as JRecorder
from oni_ml_tpu_torch.serving import CoScheduler
from oni_ml_tpu_torch.telemetry import Recorder


def test_cosched_refresh_active_brackets_fit():
    cs = CoScheduler()
    assert not cs.refresh_active
    with cs.train_fit("t"):
        assert cs.refresh_active
    assert not cs.refresh_active
    s = cs.summary()
    assert s["train_chunks"] == 0 and s["serve_slots"] == 0


def test_cosched_waiting_serve_blocks_next_chunk():
    """A serve slot held keeps the next train chunk out (one contended
    yield); the chunk proceeds once the slot clears."""
    cs = CoScheduler()
    entered = threading.Event()

    def one_chunk():
        with cs.train_fit("t"):
            with cs.train_chunk():
                entered.set()

    th = threading.Thread(target=one_chunk)
    with cs.serve_slot():
        th.start()
        assert not entered.wait(0.25), "chunk ran under a live slot"
    assert entered.wait(5.0), "chunk never ran after slot release"
    th.join(timeout=5.0)
    s = cs.summary()
    assert s["yields"] == 1
    assert s["yield_wait_s"] > 0


def test_cosched_serve_waits_at_most_one_chunk():
    """A serve slot arriving mid-chunk waits for that chunk only: the
    train side parks before its next chunk while the slot runs."""
    cs = CoScheduler()
    stop = threading.Event()
    in_chunk = threading.Event()

    def train():
        with cs.train_fit("t"):
            while not stop.is_set():
                with cs.train_chunk():
                    in_chunk.set()
                    time.sleep(0.05)

    th = threading.Thread(target=train)
    th.start()
    try:
        for _ in range(3):
            assert in_chunk.wait(5.0)
            in_chunk.clear()
            with cs.serve_slot():
                assert not cs._train_active
    finally:
        stop.set()
        th.join(timeout=5.0)
    s = cs.summary()
    assert s["serve_slots"] == 3
    assert s["preempts"] >= 1
    assert s["preempt_wait_p99_s"] is None or \
        s["preempt_wait_p99_s"] < 5.0


def test_cosched_starvation_cap_bounds_train_wait():
    """A serve side that never drains cannot lock training out past the
    starvation deadline."""
    cs = CoScheduler(starvation_s=0.2)
    holding = threading.Event()
    release = threading.Event()

    def serve_hold():
        with cs.serve_slot():
            holding.set()
            release.wait(5.0)

    th = threading.Thread(target=serve_hold)
    th.start()
    assert holding.wait(5.0)
    t0 = time.perf_counter()
    with cs.train_fit("t"):
        with cs.train_chunk():
            waited = time.perf_counter() - t0
    release.set()
    th.join(timeout=5.0)
    assert 0.15 <= waited < 2.0, waited


def test_cosched_journals_fit_rollup():
    records = []

    class _J:
        def append(self, rec, sync=False):
            records.append(rec)

    cs = CoScheduler(recorder=Recorder(), journal=_J())
    with cs.train_fit("acme"):
        with cs.train_chunk():
            pass
    fits = [r for r in records
            if r.get("kind") == "cosched" and r.get("event") == "fit"]
    assert len(fits) == 1
    assert fits[0]["tenant"] == "acme"
    assert fits[0]["chunks"] == 1


@pytest.mark.parametrize("enabled", [True, False])
def test_cosched_uncontended_sequence_equals_jax(enabled):
    """Fits, chunks and slots with no contention: the same counters,
    summary keys and journal records (walls aside) as the JAX class."""
    def drive(cls, rec_cls):
        records = []

        class _J:
            def append(self, rec, sync=False):
                records.append(rec)

        cs = cls(recorder=rec_cls(), journal=_J(), enabled=enabled)
        for tenant in ("a", "b"):
            with cs.train_fit(tenant):
                for _ in range(3):
                    with cs.train_chunk():
                        pass
            with cs.serve_slot():
                pass
            with cs.serve_slot(wait=False):
                pass
        s = cs.summary()
        for key in ("yield_wait_s", "preempt_wait_s"):
            s.pop(key)
        strip = [{k: v for k, v in r.items() if k != "wall_s"}
                 for r in records]
        return s, strip

    assert drive(CoScheduler, Recorder) == drive(JCoScheduler, JRecorder)


def test_cosched_disabled_never_waits():
    """The uncoordinated control (`--no-cosched`): a held serve slot does
    not hold a chunk back, and nothing counts as a yield."""
    cs = CoScheduler(enabled=False)
    entered = threading.Event()

    def one_chunk():
        with cs.train_fit("t"):
            with cs.train_chunk():
                entered.set()

    th = threading.Thread(target=one_chunk)
    with cs.serve_slot():
        th.start()
        assert entered.wait(5.0)
    th.join(timeout=5.0)
    assert cs.summary()["yields"] == 0


def test_cosched_first_fit_bound_under_saturated_serve_plane():
    """A serve plane held at saturation: each slot is entered before the
    one before it is left, so the plane never has a moment without a
    slot in flight and a chunk entry can never find it free.  A tenant's
    first fit (no model published yet) stops yielding once its summed
    yield wait reaches starvation_s, so all its chunks run within about
    that bound, and its fit record says at which chunk the bound acted;
    a later fit of the same tenant still yields at every chunk, each
    wait capped at starvation_s.  The checks read what the CoScheduler
    measured (its fit records): the bound 0.2 s, the first fit's summed
    wait under 0.6 s where 20 capped waits would take 4 s.

    The plane hands its slots on under the test's control (a slot is
    left only after the next is entered), not by a thread re-entering
    fast enough: with a gap between slots a chunk entry that wins the
    race finds the plane idle and does not yield at all, which is how
    the wall-clock version of this test failed under a loaded host."""
    records = []

    class _J:
        def append(self, rec, sync=False):
            records.append(rec)

    cs = CoScheduler(recorder=Recorder(), journal=_J(), starvation_s=0.2)
    stop = threading.Event()
    serving = threading.Event()

    def serve_plane():
        held = cs.serve_slot()
        held.__enter__()
        serving.set()
        while not stop.wait(0.01):
            nxt = cs.serve_slot()
            nxt.__enter__()
            held.__exit__(None, None, None)
            held = nxt
        held.__exit__(None, None, None)

    th = threading.Thread(target=serve_plane)
    th.start()
    try:
        assert serving.wait(5.0)
        t0 = time.perf_counter()
        with cs.train_fit("acme", first_publish=True):
            for _ in range(20):
                with cs.train_chunk():
                    pass
        first_wall = time.perf_counter() - t0
        with cs.train_fit("acme"):
            for _ in range(3):
                with cs.train_chunk():
                    pass
    finally:
        stop.set()
        th.join(timeout=5.0)
    assert not th.is_alive()
    assert cs.summary()["serve_slots"] >= 2      # the plane handed on
    fits = [r for r in records if r.get("event") == "fit"]
    first, later = fits
    assert first["first_publish"] is True and first["chunks"] == 20
    assert 0.15 <= first["yield_wait_s"] < 0.6, first
    assert first["first_fit_bound_chunk"] is not None
    assert 1 <= first["first_fit_bound_chunk"] <= 20
    assert first_wall < 2.0, first_wall
    assert "first_publish" not in later
    assert later["yields"] == 3 and later["capped"] == 3
    assert later["yield_wait_s"] >= 0.45, later
