"""The port's serving wire (oni_ml_tpu_torch/serving/wire.py) against the
JAX package's, on the CPU: the same payloads, made from a seed with
numpy, through both encoders.

Tolerances: none.  Columnar frames are compared byte for byte and
decoded arrays bit for bit; each package decodes the other's columnar
frames to equal values.  Error cases raise the same exception type with
the same message, except where the port has no pickle codec: the JAX
package's pickle frames and pickled (`opq`) fields are refused."""

import pickle
import socket
import struct

import numpy as np
import pytest

from oni_ml_tpu.dataplane.columns import Column as JColumn
from oni_ml_tpu.scoring import ScoringModel as JScoringModel
from oni_ml_tpu.serving import wire as jwire
from oni_ml_tpu.serving import wire_pickle as jwire_pickle
from oni_ml_tpu_torch.dataplane.columns import Column, ColumnSet
from oni_ml_tpu_torch.scoring import ScoringModel
from oni_ml_tpu_torch.serving import wire

SOCK_TIMEOUT_S = 10.0


def _model(cls, seed: int):
    rng = np.random.default_rng(seed)
    ips = [f"10.0.{i // 7}.{i % 7}" for i in range(9)]
    vocab = [f"w{j}_{'x' * (j % 3)}" for j in range(13)]
    return cls.from_results(ips, rng.dirichlet(np.ones(4), size=len(ips)),
                            vocab,
                            rng.dirichlet(np.ones(len(vocab)), size=4).T,
                            fallback=0.1)


class _Cols:
    """A column set as the wire recognises one: `schema`, `columns`
    (name -> column with `.values`) and `names()`."""

    def __init__(self, columns: dict) -> None:
        self.columns = columns
        self.schema = {n: c.values.dtype.str for n, c in columns.items()}

    def names(self) -> list:
        return list(self.columns)


def _colset(seed: int, jax: bool):
    rng = np.random.default_rng(seed)
    col = JColumn if jax else Column
    return _Cols({
        "doc": col("doc", rng.integers(0, 50, 17).astype(np.int64)),
        "word": col("word", rng.integers(0, 9, 17).astype(np.int32)),
        "count": col("count", rng.integers(1, 5, 17).astype(np.int64))})


def _payloads(jax: bool) -> dict:
    """Every kind of message the router and the replicas exchange, made
    from one seed; `jax` picks the package whose classes carry them."""
    rng = np.random.default_rng(20261018)
    scores = rng.random(7)
    model = _model(JScoringModel if jax else ScoringModel, 3)
    return {
        "scores": [{"id": 5 + i, "score": float(s), "version": i % 3}
                   for i, s in enumerate(scores)],
        "scores_with_errors": [
            {"id": 1, "score": float(scores[0]), "version": 2},
            {"id": 2, "error": "RuntimeError('boom')"},
            {"id": 3, "score": 0.0, "version": 0}],
        "message": {"op": "publish", "id": 17, "tenant": "t0",
                    "source": "router", "router_version": 4,
                    "flag": True, "nothing": None, "ratio": 0.25,
                    "nested": {"a": [1, 2, "x"], "b": {"c": 1.5}},
                    "tup": (1, 2)},
        "arrays": {"op": "x", "f64": rng.random((3, 4)),
                   "i32": rng.integers(0, 99, 11).astype(np.int32),
                   "u8": rng.integers(0, 255, 5).astype(np.uint8),
                   "f32": rng.random((2, 3)).astype(np.float32),
                   "be": rng.random(3).astype(">f8")},
        "submit_many": {"op": "submit_many", "tenant": "t1",
                        "ids": list(range(40, 46)),
                        "raws": [["t", str(i), "é" * i, ""] for i in range(6)]},
        "model": {"op": "add_tenant", "id": 1, "model": model,
                  "spec": {"tenant": "t0", "dsource": "dns"},
                  "router_version": 1},
        "cuts": {"op": "add_tenant", "cuts": (
            [0.0, 1.5, 2.25], np.array([3.0, 4.0]), (5, 6.5), [])[:3]},
        "colset": {"op": "rows", "cols": _colset(9, jax)},
    }


CASES = sorted(_payloads(False))


@pytest.mark.parametrize("case", CASES)
def test_columnar_frames_byte_equal_to_jax(case):
    got = wire.encode_payload(_payloads(False)[case])
    want = jwire.encode_payload(_payloads(True)[case])
    assert got == want


def _norm(v):
    """A decoded value as comparable plain data (models and column sets
    by their contents, arrays by dtype/shape/bytes)."""
    if isinstance(v, np.ndarray):
        return ("nd", v.dtype.str, v.shape, v.tobytes())
    if hasattr(v, "theta") and hasattr(v, "word_index"):
        return ("model", _norm(v.theta), _norm(v.p),
                sorted(v.ip_index.items()), sorted(v.word_index.items()))
    if isinstance(v, dict):
        return {k: _norm(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_norm(x) for x in v]
    return v


@pytest.mark.parametrize("case", [c for c in CASES if c != "colset"])
def test_each_package_decodes_the_others_columnar_frames(case):
    port_frame = wire.encode_payload(_payloads(False)[case])
    jax_frame = jwire.encode_payload(_payloads(True)[case])
    mine = wire.decode_payload(jax_frame)
    theirs = jwire.decode_payload(port_frame)
    assert _norm(mine) == _norm(theirs) == _norm(wire.decode_payload(
        port_frame))
    if case == "model":
        assert isinstance(mine["model"], ScoringModel)


def test_colset_frames_decode_to_a_column_set():
    """The port decodes a colset frame, its own or the JAX package's
    (the same bytes), to a dataplane ColumnSet holding the columns bit
    for bit.  The JAX decoder hands ColumnSet a dict, which its
    constructor refuses, so it raises on any colset frame; the port
    departs from it there."""
    sent = _payloads(False)["colset"]["cols"]
    frame = jwire.encode_payload(_payloads(True)["colset"])
    got = wire.decode_payload(frame)["cols"]
    assert isinstance(got, ColumnSet)
    assert got.names == sent.names()
    for n in sent.names():
        assert got[n].dtype == sent.columns[n].values.dtype
        assert np.array_equal(got[n], sent.columns[n].values)
    with pytest.raises(ConnectionError, match="undecodable"):
        jwire.decode_payload(frame)


PLAIN = ["arrays", "message", "scores", "scores_with_errors",
         "submit_many"]


@pytest.mark.parametrize("case", PLAIN)
def test_port_refuses_the_jax_pickle_codec_frames(case):
    """The JAX package's negotiated pickle fallback is not ported: its
    pickle frame of each plain payload fails the port's decode as a
    ConnectionError instead of reaching an unpickler, while the same
    payload's columnar frame decodes to the values the JAX decoder
    reads."""
    jframe = jwire_pickle.encode_payload(_payloads(True)[case])
    with pytest.raises(ConnectionError, match="only the columnar codec"):
        wire.decode_payload(jframe)
    frame = wire.encode_payload(_payloads(False)[case])
    assert _norm(wire.decode_payload(frame)) == \
        _norm(jwire.decode_payload(frame))


def _dotted_gadget(target: str) -> bytes:
    """A protocol-4 pickle naming `os.makedirs` through a module of the
    port (pickle follows the dotted name); unpickled, it creates
    `target`."""
    def ustr(x: str) -> bytes:
        b = x.encode()
        return b"\x8c" + bytes([len(b)]) + b
    return (b"\x80\x04" + ustr("oni_ml_tpu_torch.runner.route")
            + ustr("os.makedirs") + b"\x93" + ustr(target) + b"\x85"
            + b"R" + b".")


def test_pickled_fields_and_gadgets_are_refused(tmp_path):
    """A field with no columnar encoding is refused at the port's
    sender (the JAX encoder pickles it as `opq`); the JAX package's
    `opq` frame, and a whole frame or an `opq` field holding a
    dotted-name gadget, fail the port's decode and the gadget never
    runs."""
    assert _errors(wire.encode_payload, {"op": "x", "obj": {1: "a"}}) == (
        "TypeError", "wire field 'obj' (dict) has no columnar encoding")
    jopq = jwire.encode_payload({"op": "x", "obj": {1: "a"}})
    with pytest.raises(ConnectionError,
                       match="unknown wire field encoding 'opq'"):
        wire.decode_payload(jopq)
    target = tmp_path / "gadget_ran"
    gadget = _dotted_gadget(str(target))
    opq = wire._frame(wire.KIND_MSG, {"f": {"op": "x"}, "e": {"g": "opq"}},
                      [("g", np.frombuffer(gadget, np.uint8))])
    for frame in (gadget, opq):
        with pytest.raises(ConnectionError):
            wire.decode_payload(frame)
    assert not target.exists()


def _errors(fn, *args, **kw):
    try:
        fn(*args, **kw)
    except Exception as e:
        return type(e).__name__, str(e)
    return None


def _bad_frames() -> dict:
    good = wire.encode_payload(_payloads(False)["arrays"])
    bad_version = bytearray(good)
    bad_version[4] = 9
    bad_kind = bytearray(good)
    bad_kind[5] = 7
    neg = wire._frame(wire.KIND_MSG, {"f": {}, "e": {"a": "nd"}},
                      [("a", np.zeros(2, np.int64))])
    # Patch the one dim (the !q after the descriptor head) to -1.
    pos = wire._HDR.size + 2 + 1 + 1 + len("<i8") + 1
    neg = neg[:pos] + struct.pack("!q", -1) + neg[pos + 8:]
    out = {f"truncated_{n}": good[:n]
           for n in (3, 9, 12, 40, len(good) // 2, len(good) - 1)}
    out.update({"version": bytes(bad_version), "kind": bytes(bad_kind),
                "negative_dim": neg, "trailing": good + b"\0" * 8,
                "not_columnar": pickle.dumps({"op": "ping"}),
                "garbage_json": good[:wire._HDR.size]})
    return out


@pytest.mark.parametrize("case", sorted(_bad_frames()))
def test_malformed_frames_raise_as_jax_does(case):
    """The same ConnectionError with the same message; a frame that does
    not open with the magic gets a message saying that the port has the
    columnar codec only (the JAX one names its pickle fallback)."""
    frame = _bad_frames()[case]
    got = _errors(wire.decode_payload, frame)
    want = _errors(jwire.decode_payload, frame)
    assert got is not None and got[0] == "ConnectionError"
    if frame[:4] != wire.MAGIC:
        assert got[0] == want[0]
        assert got[1] == (f"non-columnar frame ({len(frame)} bytes): this "
                          "wire speaks only the columnar codec")
    else:
        assert got == want


def _socketpair():
    a, b = socket.socketpair()
    for s in (a, b):
        s.settimeout(SOCK_TIMEOUT_S)
    return a, b


@pytest.mark.parametrize("codec", ["columnar", "pickle"])
def test_socket_framing_matches_jax_both_codecs(codec):
    """Columnar: send_frame writes the same bytes as the JAX package's
    and each package's recv_frame reads the other's.  Pickle: the port
    has no such codec, and its recv_frame refuses the JAX package's
    pickle frame."""
    msg = {"op": "ping", "payload": list(range(100)),
           "arr": np.arange(6, dtype=np.int64)}
    if codec == "pickle":
        a, b = _socketpair()
        try:
            jwire.send_frame(a, msg, codec="pickle")
            with pytest.raises(ConnectionError, match="non-columnar"):
                wire.recv_frame(b)
        finally:
            a.close()
            b.close()
        return
    raw = {}
    for name, mod in (("port", wire), ("jax", jwire)):
        a, b = _socketpair()
        try:
            n = mod.send_frame(a, msg)
            raw[name] = wire._recv_exact(b, 4 + n)
        finally:
            a.close()
            b.close()
    assert raw["port"] == raw["jax"]
    for send_mod, recv_mod in ((wire, jwire), (jwire, wire)):
        a, b = _socketpair()
        try:
            send_mod.send_frame(a, msg)
            got = recv_mod.recv_frame(b)
        finally:
            a.close()
            b.close()
        assert _norm(got) == _norm(msg)


def test_recv_refuses_pickle_on_a_columnar_link_and_eof_mid_frame():
    a, b = _socketpair()
    try:
        data = pickle.dumps({"op": "ping"}, protocol=4)
        a.sendall(struct.pack("!I", len(data)) + data)
        with pytest.raises(ConnectionError, match="only the columnar"):
            wire.recv_frame(b)
        # A peer that dies mid-frame: ConnectionError, not a hang.
        a.sendall(struct.pack("!I", 100) + b"\0" * 10)
        a.close()
        with pytest.raises(ConnectionError, match="peer closed mid-frame"):
            wire.recv_frame(b)
    finally:
        b.close()


def test_oversize_guards_match_jax(monkeypatch):
    """An absurd announced length fails before allocating, on both
    sides with the same message; a frame past the bound is refused at
    the sender."""
    msgs = []
    for mod in (wire, jwire):
        a, b = _socketpair()
        try:
            a.sendall(struct.pack("!I", (1 << 31) - 1))
            msgs.append(_errors(mod.recv_frame, b))
        finally:
            a.close()
            b.close()
    assert msgs[0] == msgs[1]
    assert msgs[0][0] == "ConnectionError" and "oversized" in msgs[0][1]
    big = {"op": "x", "a": np.zeros(64, np.float64)}
    sent = []
    for mod in (wire, jwire):
        monkeypatch.setattr(mod, "MAX_FRAME_BYTES", 256)
        a, b = _socketpair()
        try:
            sent.append(_errors(mod.send_frame, a, big))
        finally:
            a.close()
            b.close()
    assert sent[0] == sent[1]
    assert sent[0][0] == "ValueError" and "frame too large" in sent[0][1]
    assert wire.MAX_FRAME_BYTES == 256 and jwire.MAX_FRAME_BYTES == 256


def test_encode_refuses_non_messages_and_mixed_score_batches():
    for bad in ("text", 3, [{"id": 1, "score": 0.5, "extra": 1}]):
        assert _errors(wire.encode_payload, bad) == \
            _errors(jwire.encode_payload, bad)
    assert _errors(wire.encode_payload, "text")[0] == "TypeError"
