"""Columnar serving wire and the same-host shared-memory ring (port of
oni_ml_tpu/serving/wire.py).

Router <-> replica frames carry typed arrays as raw buffers with
dtype/shape descriptors and decode as zero-copy numpy views over the
received frame; everything scalar rides a compact JSON meta blob.  The
frames are byte-identical to the JAX package's for the same payloads.

Frame layout (`encode_payload`):

    header      !4sBBHI — magic b"OCWF", version, kind, ncols, meta_len
    descriptors per column: name (!H + utf8), dtype str (!B + utf8,
                numpy dtype.str, byte order explicit), ndim (!B),
                dims (!q each)
    meta        meta_len bytes of JSON (op name, scalar fields, the
                per-key encoding tags)
    buffers     each column's raw bytes, 8-byte aligned

`decode_payload` decodes columnar frames (``OCWF`` magic) only: this
wire has no pickle codec, so nothing a peer sends reaches an unpickler.
A frame without the magic, version mismatches, truncated buffers,
hostile descriptors and length drift all fail as ConnectionError, the
wire's one failure mode, before any allocation the peer sized.

Typed encodings (tagged per top-level message key):

    ``nd``     numpy array -> one column, zero-copy both ways
    ``i8l``    list[int] (submit_many ids) -> int64 column
    ``s1``     list[str] -> utf8 blob + int64 offsets (decode only)
    ``s2``     list[list[str]] (submit_many raws) -> flattened utf8
               blob + offsets + per-row field counts
    ``cuts``   tuple of numeric sequences -> one float64 column each
    ``model``  ScoringModel -> theta/p columns + key/value columns
    ``colset`` a column set (``schema``, ``columns``, ``names()``) ->
               one column per field; decodes to a dataplane ColumnSet

A field with none of these encodings is refused at the sender
(TypeError).  The JAX package's ``opq`` tag (a pickled field, which its
router uses to push a prebuilt featurizer) and its negotiated
whole-frame pickle fallback are not ported: the port's router pushes a
featurizer as its cuts and top-domains list (serving/router.py), and a
frame carrying ``opq`` fails to decode as an unknown field encoding.

Score batches (the replica resolver's coalesced responses) get a frame
kind of their own: ids/scores/versions as three columns, so float64
scores round-trip bit-identical.

``ShmRing``: a same-host router <-> replica pair whose ``hello``
negotiated ``shm`` moves its data frames onto two of these rings (one a
direction): two fixed shared-memory slabs (``multiprocessing.
shared_memory``) double-buffered under a lock-free seqlock header.  The
producer fills slab ``wseq % 2`` while the consumer drains the other;
publication is a seqlock'd counter bump (the writer makes the guard odd,
writes, makes it even; the reader rereads until it is stable), so
neither side takes a lock the other can die holding, and a SIGKILL'd
peer leaves nothing to clean but the segment.  The 64-byte header, its
``OCWR`` magic and ``WIRE_VERSION`` byte and the slab layout are the JAX
package's, so either package's ring attaches to the other's segment.
The TCP connection stays open as the liveness/EOF signal and carries
any frame larger than a slab.
"""

from __future__ import annotations

import json
import socket
import struct
import threading
import time

import numpy as np


MAGIC = b"OCWF"
WIRE_VERSION = 1
KIND_MSG = 1
KIND_SCORES = 2
_ALIGN = 8
_HDR = struct.Struct("!4sBBHI")
_LEN = struct.Struct("!I")
# One frame holds one op (the bulkiest is add_tenant carrying a
# tenant's model) — bound it so a corrupted length prefix fails loudly
# instead of allocating gigabytes.
MAX_FRAME_BYTES = 256 << 20


# ---------------------------------------------------------------------------
# scalar-field classification
# ---------------------------------------------------------------------------


def _jsonable(v) -> bool:
    """True when `v` survives the JSON meta blob faithfully (tuples
    coerce to lists — accepted and documented; non-str dict keys do
    NOT, so they fall through to a typed encoding or are refused)."""
    if v is None or isinstance(v, (bool, int, float, str)):
        return True
    if isinstance(v, (list, tuple)):
        return all(_jsonable(x) for x in v)
    if isinstance(v, dict):
        return all(isinstance(k, str) and _jsonable(x)
                   for k, x in v.items())
    return False


def _is_model(v) -> bool:
    return (hasattr(v, "theta") and hasattr(v, "p")
            and hasattr(v, "ip_index") and hasattr(v, "word_index"))


def _is_colset(v) -> bool:
    return (hasattr(v, "schema") and hasattr(v, "columns")
            and hasattr(v, "names"))


def _is_cuts(v) -> bool:
    if not isinstance(v, (tuple, list)) or not v:
        return False
    for part in v:
        if isinstance(part, np.ndarray):
            if part.ndim != 1:
                return False
        elif isinstance(part, (list, tuple)):
            if not all(isinstance(x, (int, float)) for x in part):
                return False
        else:
            return False
    return True


def _pack_strs(strs) -> "tuple[np.ndarray, np.ndarray]":
    bs = [s.encode("utf-8") for s in strs]
    off = np.zeros(len(bs) + 1, np.int64)
    if bs:
        np.cumsum([len(b) for b in bs], out=off[1:])
    blob = np.frombuffer(b"".join(bs), np.uint8)
    return blob, off


def _unpack_strs(blob: np.ndarray, off: np.ndarray) -> "list[str]":
    raw = blob.tobytes()
    bounds = off.tolist()
    return [raw[bounds[i]:bounds[i + 1]].decode("utf-8")
            for i in range(len(bounds) - 1)]


# ---------------------------------------------------------------------------
# encode
# ---------------------------------------------------------------------------


def encode_payload(obj) -> bytes:
    """One message -> one columnar frame payload.  Messages are the
    op dicts serving/replica.py and serving/router.py exchange, or the resolver's
    list-of-score-responses batches."""
    if isinstance(obj, list):
        return _encode_scores(obj)
    if not isinstance(obj, dict):
        raise TypeError(
            f"wire payload must be an op dict or a score batch, "
            f"got {type(obj).__name__}")
    fields: dict = {}
    enc: dict = {}
    cuts_n: dict = {}
    cols: "list[tuple[str, np.ndarray]]" = []

    def add(name: str, arr: np.ndarray) -> None:
        cols.append((name, np.ascontiguousarray(arr)))

    for k, v in obj.items():
        if isinstance(v, np.ndarray):
            enc[k] = "nd"
            add(k, v)
        elif _is_model(v):
            enc[k] = "model"
            add(f"{k}.theta", np.asarray(v.theta))
            add(f"{k}.p", np.asarray(v.p))
            ikb, iko = _pack_strs(v.ip_index.keys())
            add(f"{k}.ikb", ikb)
            add(f"{k}.iko", iko)
            add(f"{k}.ikv", np.fromiter(
                v.ip_index.values(), np.int64, len(v.ip_index)))
            wkb, wko = _pack_strs(v.word_index.keys())
            add(f"{k}.wkb", wkb)
            add(f"{k}.wko", wko)
            add(f"{k}.wkv", np.fromiter(
                v.word_index.values(), np.int64, len(v.word_index)))
        elif _is_colset(v):
            enc[k] = "colset"
            for name in v.names():
                add(f"{k}.{name}", v.columns[name].values)
        elif (k == "raws" and isinstance(v, list)
                and all(isinstance(r, (list, tuple)) for r in v)):
            enc[k] = "s2"
            flat = [f for row in v for f in row]
            blob, off = _pack_strs(flat)
            add(f"{k}.b", blob)
            add(f"{k}.o", off)
            add(f"{k}.n", np.fromiter(
                (len(row) for row in v), np.int32, len(v)))
        elif (k == "ids" and isinstance(v, list)
                and all(isinstance(x, int) for x in v)):
            enc[k] = "i8l"
            add(k, np.asarray(v, np.int64))
        elif _is_cuts(v):
            enc[k] = "cuts"
            cuts_n[k] = len(v)
            for i, part in enumerate(v):
                add(f"{k}.{i}", np.asarray(part, np.float64))
        elif _jsonable(v):
            fields[k] = v
        else:
            raise TypeError(
                f"wire field {k!r} ({type(v).__name__}) has no columnar "
                "encoding")
    meta = {"f": fields}
    if enc:
        meta["e"] = enc
    if cuts_n:
        meta["cn"] = cuts_n
    return _frame(KIND_MSG, meta, cols)


def _encode_scores(batch: list) -> bytes:
    n = len(batch)
    ids = np.empty(n, np.int64)
    scores = np.zeros(n, np.float64)
    versions = np.zeros(n, np.int64)
    errors = []
    for i, rsp in enumerate(batch):
        extra = set(rsp) - {"id", "score", "version", "error"}
        if extra:
            raise TypeError(
                f"score batch entry has non-score keys {sorted(extra)}")
        ids[i] = rsp["id"]
        if "error" in rsp:
            errors.append([i, str(rsp["error"])])
        else:
            scores[i] = rsp["score"]
            versions[i] = rsp.get("version", 0)
    meta = {"err": errors} if errors else {}
    return _frame(KIND_SCORES, meta,
                  [("id", ids), ("score", scores), ("ver", versions)])


def _frame(kind: int, meta: dict, cols) -> bytes:
    desc = bytearray()
    for name, arr in cols:
        nb = name.encode("utf-8")
        db = arr.dtype.str.encode("ascii")
        desc += struct.pack("!H", len(nb)) + nb
        desc += struct.pack("!B", len(db)) + db
        desc += struct.pack("!B", arr.ndim)
        for d in arr.shape:
            desc += struct.pack("!q", d)
    mb = json.dumps(meta, separators=(",", ":")).encode("utf-8")
    head = _HDR.pack(MAGIC, WIRE_VERSION, kind, len(cols), len(mb))
    parts = [head, bytes(desc), mb]
    off = len(head) + len(desc) + len(mb)
    for _, arr in cols:
        pad = (-off) % _ALIGN
        if pad:
            parts.append(b"\0" * pad)
            off += pad
        parts.append(memoryview(arr).cast("B"))
        off += arr.nbytes
    return b"".join(parts)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def decode_payload(buf):
    """Frame payload -> message.  Columnar frames (magic match) decode
    as zero-copy views over `buf`; anything else is refused as a
    ConnectionError."""
    mv = memoryview(buf)
    if len(mv) >= 4 and bytes(mv[:4]) == MAGIC:
        return _decode_columnar(mv)
    raise ConnectionError(
        f"non-columnar frame ({len(mv)} bytes): this wire speaks only "
        "the columnar codec")


def _short(mv, need: int, pos: int, what: str) -> None:
    if pos + need > len(mv):
        raise ConnectionError(
            f"truncated wire frame: {what} needs {need} bytes at "
            f"offset {pos}, frame is {len(mv)}")


def _decode_columnar(mv: memoryview):
    """Every decode failure — truncation, hostile descriptors (bad
    dtype strings, negative dims), missing columns, bad UTF-8/JSON —
    surfaces as the wire's uniform ConnectionError, never a
    codec-specific TypeError/ValueError/KeyError that would escape a
    reader's ``except (ConnectionError, OSError)``."""
    try:
        return _decode_columnar_body(mv)
    except ConnectionError:
        raise
    except Exception as e:
        raise ConnectionError(
            f"undecodable columnar frame ({len(mv)} bytes): {e!r}")


def _decode_columnar_body(mv: memoryview):
    _short(mv, _HDR.size, 0, "header")
    magic, ver, kind, ncols, meta_len = _HDR.unpack_from(mv, 0)
    if ver != WIRE_VERSION:
        raise ConnectionError(
            f"wire version mismatch: frame v{ver}, this end speaks "
            f"v{WIRE_VERSION}")
    pos = _HDR.size
    descs = []
    for _ in range(ncols):
        _short(mv, 2, pos, "descriptor")
        (nlen,) = struct.unpack_from("!H", mv, pos)
        pos += 2
        _short(mv, nlen + 2, pos, "descriptor")
        name = bytes(mv[pos:pos + nlen]).decode("utf-8")
        pos += nlen
        (dlen,) = struct.unpack_from("!B", mv, pos)
        pos += 1
        _short(mv, dlen + 1, pos, "descriptor")
        dt = bytes(mv[pos:pos + dlen]).decode("ascii")
        pos += dlen
        (ndim,) = struct.unpack_from("!B", mv, pos)
        pos += 1
        _short(mv, 8 * ndim, pos, "descriptor dims")
        shape = struct.unpack_from(f"!{ndim}q", mv, pos)
        pos += 8 * ndim
        descs.append((name, dt, shape))
    _short(mv, meta_len, pos, "meta")
    meta = json.loads(bytes(mv[pos:pos + meta_len]))
    pos += meta_len
    cols: "dict[str, np.ndarray]" = {}
    for name, dt, shape in descs:
        pos += (-pos) % _ALIGN
        dtype = np.dtype(dt)
        count = 1
        for d in shape:
            if d < 0:
                raise ConnectionError(
                    f"negative dim {d} in column {name!r} descriptor")
            count *= d
        nbytes = count * dtype.itemsize
        _short(mv, nbytes, pos, f"column {name!r}")
        arr = np.frombuffer(mv[pos:pos + nbytes], dtype=dtype)
        if len(shape) != 1:
            arr = arr.reshape(shape)
        cols[name] = arr
        pos += nbytes
    if pos != len(mv):
        raise ConnectionError(
            f"wire frame length drift: decoded {pos} of {len(mv)} "
            "bytes")
    if kind == KIND_SCORES:
        return _decode_scores(meta, cols)
    if kind == KIND_MSG:
        return _decode_msg(meta, cols)
    raise ConnectionError(f"unknown wire frame kind {kind}")


def _decode_scores(meta: dict, cols: dict) -> list:
    ids = cols["id"].tolist()
    scores = cols["score"]
    versions = cols["ver"].tolist()
    errs = {i: msg for i, msg in meta.get("err", [])}
    out = []
    for i, rid in enumerate(ids):
        if i in errs:
            out.append({"id": rid, "error": errs[i]})
        else:
            out.append({"id": rid, "score": float(scores[i]),
                        "version": versions[i]})
    return out


def _decode_msg(meta: dict, cols: dict) -> dict:
    obj = dict(meta.get("f", {}))
    for k, tag in meta.get("e", {}).items():
        if tag == "nd":
            obj[k] = cols[k]
        elif tag == "i8l":
            obj[k] = cols[k].tolist()
        elif tag == "s1":
            obj[k] = _unpack_strs(cols[f"{k}.b"], cols[f"{k}.o"])
        elif tag == "s2":
            flat = _unpack_strs(cols[f"{k}.b"], cols[f"{k}.o"])
            rows = []
            i = 0
            for n in cols[f"{k}.n"].tolist():
                rows.append(flat[i:i + n])
                i += n
            obj[k] = rows
        elif tag == "cuts":
            obj[k] = tuple(
                cols[f"{k}.{i}"].tolist()
                for i in range(meta["cn"][k]))
        elif tag == "model":
            from ..scoring.score import ScoringModel

            ik = _unpack_strs(cols[f"{k}.ikb"], cols[f"{k}.iko"])
            wk = _unpack_strs(cols[f"{k}.wkb"], cols[f"{k}.wko"])
            obj[k] = ScoringModel(
                ip_index=dict(zip(ik, cols[f"{k}.ikv"].tolist())),
                theta=cols[f"{k}.theta"],
                word_index=dict(zip(wk, cols[f"{k}.wkv"].tolist())),
                p=cols[f"{k}.p"],
            )
        elif tag == "colset":
            from ..dataplane.columns import Column, ColumnSet

            # The JAX decoder hands ColumnSet a dict, which its
            # constructor refuses; the port builds the column list, each
            # column declared with its own dtype kind.
            prefix = f"{k}."
            obj[k] = ColumnSet([
                Column(name[len(prefix):], cols[name], cols[name].dtype.kind)
                for name in cols if name.startswith(prefix)])
        else:
            raise ConnectionError(
                f"unknown wire field encoding {tag!r} for key {k!r}")
    return obj


# ---------------------------------------------------------------------------
# socket framing
# ---------------------------------------------------------------------------


def send_frame(sock: socket.socket, obj,
               lock: "threading.Lock | None" = None) -> int:
    """Encode `obj` and write one length-prefixed frame.  `lock`
    serializes concurrent writers on a shared socket (sendall is not
    atomic across threads).  Returns the payload byte count — the
    edges' wire_bytes accounting."""
    data = encode_payload(obj)
    if len(data) > MAX_FRAME_BYTES:
        raise ValueError(f"frame too large: {len(data)} bytes")
    buf = _LEN.pack(len(data)) + data
    if lock is not None:
        with lock:
            sock.sendall(buf)
    else:
        sock.sendall(buf)
    return len(data)


def recv_frame(sock: socket.socket):
    """Read one frame; raises ConnectionError on EOF / short read /
    oversized announcement / malformed or non-columnar payload."""
    head = _recv_exact(sock, _LEN.size)
    (n,) = _LEN.unpack(head)
    if n > MAX_FRAME_BYTES:
        raise ConnectionError(f"oversized frame announced: {n} bytes")
    return decode_payload(_recv_exact(sock, n))


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    parts = []
    while n:
        chunk = sock.recv(min(n, 1 << 20))
        if not chunk:
            raise ConnectionError("peer closed mid-frame")
        parts.append(chunk)
        n -= len(chunk)
    return b"".join(parts)


# ---------------------------------------------------------------------------
# same-host shared-memory ring
# ---------------------------------------------------------------------------

_RING_MAGIC = b"OCWR"


class _RingStuck(ConnectionError):
    """The seqlock guard never stabilized: the peer died between its odd
    and even guard writes (SIGKILL inside _locked_write).  push/pop turn
    this into their closed-ring return values, so callers fall back to
    the TCP path."""


# Header: magic+ver (8) | pseq (8) | wseq (8) | len0 (8) | len1 (8)
#         | cseq (8) | rseq (8) | closed (8)
_RING_HDR = 64
_Q = struct.Struct("<Q")
_OFF_PSEQ, _OFF_WSEQ, _OFF_LEN0, _OFF_LEN1 = 8, 16, 24, 32
_OFF_CSEQ, _OFF_RSEQ, _OFF_CLOSED = 40, 48, 56


class ShmRing:
    """Single-producer single-consumer frame ring over one shared-memory
    segment: two fixed slabs, double-buffered, published through a
    lock-free seqlock header.  The producer fills slab ``wseq % 2`` while
    the consumer drains slab ``rseq % 2``; a slab is reused only after
    the consumer's seqlock'd ``rseq`` bump acknowledges it, so frame
    bytes are never overwritten while the peer may still read them.  No
    locks, no fds, no syscalls on the hot path: a SIGKILL'd peer leaves
    the ring consistent and the survivor's poll simply times out.  The
    one inconsistent death, between the odd and even guard writes of a
    publish, is bounded by ``_SEQLOCK_STUCK_S``: a guard that never
    stabilizes marks the ring closed and the survivor degrades to TCP.

    Both sides wait as the JAX ring does: 64 polls with ``sleep(0)``,
    then sleeps that grow by 10 µs a poll to 1 ms."""

    # How long a reader rereads an odd or unstable guard before declaring
    # the writer dead mid-publish (a live writer holds it odd for a few
    # header stores).
    _SEQLOCK_STUCK_S = 2.0

    def __init__(self, shm, slab_bytes: int, *, owner: bool) -> None:
        self._shm = shm
        self._buf = shm.buf
        self._slab = slab_bytes
        self._owner = owner
        self._unlinked = False
        self.name = shm.name

    # -- construction ------------------------------------------------------

    @classmethod
    def create(cls, slab_bytes: int) -> "ShmRing":
        from multiprocessing import shared_memory

        shm = shared_memory.SharedMemory(
            create=True, size=_RING_HDR + 2 * slab_bytes)
        shm.buf[:_RING_HDR] = bytes(_RING_HDR)
        shm.buf[:4] = _RING_MAGIC
        shm.buf[4] = WIRE_VERSION
        return cls(shm, slab_bytes, owner=True)

    @classmethod
    def attach(cls, name: str, slab_bytes: int) -> "ShmRing":
        from multiprocessing import shared_memory

        shm = shared_memory.SharedMemory(name=name)
        # Before Python 3.13 the attaching side's resource_tracker would
        # unlink the segment when this process exits, pulling it from
        # the owner: unregister it here; the creating side owns cleanup.
        try:
            from multiprocessing import resource_tracker

            resource_tracker.unregister(shm._name, "shared_memory")
        except Exception:
            pass
        if bytes(shm.buf[:4]) != _RING_MAGIC:
            shm.close()
            raise ConnectionError(f"shm segment {name!r} is not a ring")
        if shm.buf[4] != WIRE_VERSION:
            ver = shm.buf[4]
            shm.close()
            raise ConnectionError(
                f"ring version mismatch: segment v{ver}, this end "
                f"speaks v{WIRE_VERSION}")
        if shm.size < _RING_HDR + 2 * slab_bytes:
            shm.close()
            raise ConnectionError(
                f"shm segment {name!r} holds {shm.size} bytes, too few "
                f"for two {slab_bytes}-byte slabs")
        return cls(shm, slab_bytes, owner=False)

    # -- seqlock'd header fields ------------------------------------------

    def _read_u64(self, off: int) -> int:
        return _Q.unpack_from(self._buf, off)[0]

    def _write_u64(self, off: int, value: int) -> None:
        _Q.pack_into(self._buf, off, value)

    def _locked_write(self, seq_off: int, field_writes) -> None:
        """Writer side of the seqlock: guard odd -> fields -> guard even.
        Each guard has one writer (pseq: the producer, cseq: the
        consumer), so no compare-and-swap is needed."""
        seq = self._read_u64(seq_off)
        self._write_u64(seq_off, seq + 1)
        for off, value in field_writes:
            self._write_u64(off, value)
        self._write_u64(seq_off, seq + 2)

    def _stable_read(self, seq_off: int, field_offs) -> "list[int]":
        """Reader side: retry until the guard is even and unchanged across
        the field reads.  Bounded: a guard that stays odd or unstable
        past ``_SEQLOCK_STUCK_S`` means the writer died between its guard
        writes, so the ring is marked closed (for both ends) and
        _RingStuck raised instead of spinning forever."""
        deadline = None
        spin = 0
        while True:
            s0 = self._read_u64(seq_off)
            if not (s0 & 1):
                vals = [self._read_u64(off) for off in field_offs]
                if self._read_u64(seq_off) == s0:
                    return vals
            spin += 1
            if spin <= 64:
                continue    # real contention resolves in a few reads
            if deadline is None:
                deadline = time.monotonic() + self._SEQLOCK_STUCK_S
            elif time.monotonic() > deadline:
                try:
                    self._buf[_OFF_CLOSED] = 1
                except (TypeError, ValueError):
                    pass    # this side's mapping is already released
                raise _RingStuck(
                    f"shm ring seqlock stuck for {self._SEQLOCK_STUCK_S}s: "
                    "the peer died mid-write; ring closed")
            time.sleep(1e-5)

    # -- data path ---------------------------------------------------------

    @property
    def closed(self) -> bool:
        try:
            return bool(self._buf[_OFF_CLOSED])
        except (TypeError, ValueError):
            return True    # this side's mapping is already released

    def capacity(self) -> int:
        return self._slab

    def push(self, payload, timeout_s: float = 5.0) -> bool:
        """Producer: claim the free slab, copy `payload` in, publish.
        False when the peer closed the ring or no slab freed within the
        timeout (the caller falls back to TCP)."""
        try:
            return self._push(payload, timeout_s)
        except _RingStuck:
            return False        # the peer died mid-publish: ring dead
        except (TypeError, ValueError) as e:
            if "released" in str(e):
                return False    # close() raced this push: ring gone
            raise

    def _push(self, payload, timeout_s: float) -> bool:
        n = len(payload)
        if n > self._slab:
            raise ValueError(
                f"frame of {n} bytes exceeds ring slab "
                f"({self._slab} bytes)")
        deadline = time.monotonic() + timeout_s
        spin = 0
        while True:
            if self.closed:
                return False
            wseq = self._stable_read(_OFF_PSEQ, (_OFF_WSEQ,))[0]
            rseq = self._stable_read(_OFF_CSEQ, (_OFF_RSEQ,))[0]
            if wseq - rseq < 2:
                break
            spin += 1
            if spin > 64:
                if time.monotonic() > deadline:
                    return False
                time.sleep(min(1e-3, 1e-5 * spin))
        slab = wseq % 2
        start = _RING_HDR + slab * self._slab
        self._buf[start:start + n] = payload
        self._locked_write(_OFF_PSEQ, (
            (_OFF_LEN0 if slab == 0 else _OFF_LEN1, n),
            (_OFF_WSEQ, wseq + 1),
        ))
        return True

    def pop(self, timeout_s: float = 0.25) -> "bytes | None":
        """Consumer: copy the oldest published slab out and acknowledge
        it.  None on timeout; `closed` tells quiescence from shutdown
        (published slabs still drain after a close)."""
        try:
            return self._pop(timeout_s)
        except ConnectionError:
            return None         # a dead or corrupt writer: ring closed
        except (TypeError, ValueError) as e:
            if "released" in str(e):
                return None     # close() raced this pop: ring gone
            raise

    def _pop(self, timeout_s: float) -> "bytes | None":
        deadline = time.monotonic() + timeout_s
        spin = 0
        while True:
            rseq = self._stable_read(_OFF_CSEQ, (_OFF_RSEQ,))[0]
            wseq, len0, len1 = self._stable_read(
                _OFF_PSEQ, (_OFF_WSEQ, _OFF_LEN0, _OFF_LEN1))
            if wseq > rseq:
                break
            if self.closed or time.monotonic() > deadline:
                return None
            spin += 1
            time.sleep(0 if spin < 64 else min(1e-3, 1e-5 * spin))
        slab = rseq % 2
        n = len0 if slab == 0 else len1
        if n > self._slab:
            self._buf[_OFF_CLOSED] = 1
            raise ConnectionError(
                f"ring slab announces {n} bytes, more than its "
                f"{self._slab}; ring closed")
        start = _RING_HDR + slab * self._slab
        payload = bytes(self._buf[start:start + n])
        self._locked_write(_OFF_CSEQ, ((_OFF_RSEQ, rseq + 1),))
        return payload

    # -- lifecycle ---------------------------------------------------------

    def close(self) -> None:
        """Signal the peer and drop this side's mapping.  The owner also
        unlinks the segment (once)."""
        try:
            self._buf[_OFF_CLOSED] = 1
        except (TypeError, ValueError):
            pass    # mapping already released
        try:
            self._shm.close()
        except Exception:
            pass
        if self._owner and not self._unlinked:
            self._unlinked = True
            # With both ends in one process (in-process replicas) the
            # attaching side's unregister removed the tracker's entry,
            # and unlink() unregisters again, which the tracker logs as
            # a KeyError.  Registering first keeps the owner's unlink
            # clean in both layouts; the once-flag keeps a second close
            # from registering a segment that is gone.
            try:
                from multiprocessing import resource_tracker

                resource_tracker.register(self._shm._name, "shared_memory")
            except Exception:
                pass
            try:
                self._shm.unlink()
            except Exception:
                pass
