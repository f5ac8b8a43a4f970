"""Device featurization for the serving fleet: compile a source's word
grammar into tables, once per (source, pinned cuts, model vocabulary)
(port of oni_ml_tpu/sources/device.py).

Host featurizers (features/flow.py, features/dns.py, sources/generic.py)
build one word string per event in a Python loop and then probe the
model's vocabulary dict: the per-event Python in front of every serving
dispatch.  Here the same word grammar is compiled once:

  * every vocabulary word is reverse-parsed through the source's word
    grammar into (categorical values, bin values);
  * categorical slot values become lookup tables (value -> code);
  * a word's slots pack into one mixed-radix integer code;
  * a code table maps a packed code to its model word row (default: the
    fallback row): a dense LUT while the product space stays small, a
    sorted-code binary probe once it outgrows the vocabulary
    (_CodeTable).

A flush then evaluates the slot values a column at a time (float parses,
ECDF binning, entropy per unique value), packs codes and gathers word
rows: no per-event string assembly and no per-event dict probe.  Tables
pad to powers of two, the stacked scorer's capacity rule (serving/
fleet.py `_pow2`), so vocabulary churn lands in a bounded family of
shapes.

The ECDF binning stays on the host in float64
(`features.quantiles.bin_values`): binning on the card in float32 could
flip the bin of a value within one float32 ulp of a float64 cut.  The
card's part is the fused gather-dot of the "fused" engine
(ops/featurize_kernel.py); the "device" engine gathers rows with numpy
and feeds the unchanged score dispatch (scoring.batched_scores), so its
scores are bit-equal to the host featurizer's.

Parity contract: device-gathered word rows are byte-identical to the
host's `word_rows(words)` for every input row, malformed ones included.
Two rules make that hold by construction:

  * strict-parse gate: if any vocabulary word fails the grammar's strict
    parse (a DNS qtype holding the separator, say) the whole model is
    unlowerable and its tenant keeps the host featurizer
    (`compile_featurizer` returns None with the reason; the fleet
    journals one `featurize_compile` record and counts it).  In a
    lowered model every vocabulary word round-trips through the
    grammar, so a served value holding a separator cannot collide into
    another word on either path: both give the fallback row.
  * unreachable-entry skip: a vocabulary word that parses but whose bin
    lies outside the pinned cuts' range can never be produced by the
    host featurizer either; it is skipped, not gated.

Engines: `resolve_engine` (ONI_ML_TPU_FEATURIZE > ServingConfig >
"device") and `resolve_break_even` (ONI_ML_TPU_FEATURIZE_BREAK_EVEN >
ServingConfig > the plan entry `measure_break_even` records for this
device > 1).  Neither catches anything: a broken plan store raises.
"""

from __future__ import annotations

import os

import numpy as np

from ..features.dns import (DNS_COLUMNS, extract_subdomain, shannon_entropy)
from ..features.flow import FLOW_COLUMNS, _to_double
from ..features.container import index_rows as _index_rows
from ..features.quantiles import bin_values

ENGINES = ("host", "device", "fused")

# Dense/sparse table crossover: up to this packed-code space the table
# is a dense LUT (int32 per slot, 16 MiB at the cap); beyond it the
# mixed-radix product has outgrown the vocabulary it indexes and the
# table switches to the sorted-code binary probe (_CodeTable).  Not a
# tuned knob — a memory-safety rail.
_MAX_CODE_SPACE = 1 << 22

_MISS = object()


def _pow2(n: int) -> int:
    """Smallest power of two >= n (the stacked scorer's tier rule)."""
    return 1 << max(0, int(n) - 1).bit_length()


class Unlowerable(Exception):
    """Raised during compile when the model/grammar combination cannot
    be lowered with provable host parity; carriers fall back to host."""


# ---------------------------------------------------------------------------
# Vectorized host-side column parses (bit-identical to the featurizers')
# ---------------------------------------------------------------------------


def _to_double_array(values) -> np.ndarray:
    """Vectorized `features.flow._to_double`: one C-level parse for the
    all-numeric common case; any garbage cell falls back to the
    per-element NaN-defaulting loop.  Both parsers are correctly-rounded
    IEEE-754 (verified against numpy 2.x), so the fast path is
    bit-identical to the host loop."""
    try:
        return np.asarray(values, dtype=np.float64)
    except (TypeError, ValueError):
        pass
    return np.array([_to_double(v) for v in values], dtype=np.float64)


def _columns(rows, num_columns: int):
    """Transpose row-major string rows into column tuples in one
    C-level pass (every row already validated to num_columns wide)."""
    if not rows:
        return [()] * num_columns
    return list(zip(*rows))


def _dict_codes(table: dict, values, default: int = -1) -> np.ndarray:
    """Value -> slot code via one dict.get pass (scoring.score's
    _index_rows idiom); misses get `default`."""
    get = table.get
    return np.fromiter(
        (get(v, default) for v in values), np.int64, len(values)
    )


# ---------------------------------------------------------------------------
# Canonical-text slot parsers (vocabulary side)
# ---------------------------------------------------------------------------


def _canon_float_str(seg: str) -> "str | None":
    """The segment iff it is the canonical str(float) rendering some
    host word could contain ('80.0', '333333.0', 'nan', '-0.0');
    anything else is host-unproducible."""
    try:
        v = float(seg)
    except (TypeError, ValueError):
        return None
    return seg if str(v) == seg else None


def _jvm_int(seg: str, radix: int) -> "int | None":
    """Parse a bin rendered as a JVM double ('9.0'); None unless it is
    canonical, integral and inside the slot's radix."""
    try:
        v = float(seg)
    except (TypeError, ValueError):
        return None
    if str(v) != seg or not v.is_integer():
        return None
    b = int(v)
    return b if 0 <= b < radix else None


def _digit_int(seg: str, radix: int) -> "int | None":
    """Parse a bin rendered as a bare int ('9'); canonical (no leading
    zeros, no sign) and inside the radix."""
    if not seg.isdigit() or str(int(seg)) != seg:
        return None
    b = int(seg)
    return b if b < radix else None


# ---------------------------------------------------------------------------
# The compiled program
# ---------------------------------------------------------------------------


class DeviceFeaturizer:
    """One compiled (source, pinned cuts, model vocabulary) program:
    `codes(rows)` packs validated rows into LUT codes, `word_rows_local`
    gathers model word rows (local to the model, before any stacked
    word_base offset).  `doc_cols` lists the document-key column per
    pair block, in the source's event_pairs block order."""

    def __init__(self, dsource: str, pairs_per_event: int,
                 doc_cols: "tuple[int, ...]", table: _CodeTable,
                 code_fn, model, info: dict) -> None:
        self.dsource = dsource
        self.pairs_per_event = pairs_per_event
        self.doc_cols = doc_cols
        self.table = table
        self._code_fn = code_fn
        self.model = model
        self.info = info

    def codes(self, rows) -> np.ndarray:
        """Packed table codes (the table's code_dtype — int32 dense,
        int64 sparse), [pairs_per_event * len(rows)], blocks
        concatenated in event_pairs order; rows with any unseen
        categorical value carry the mode's guaranteed-fallback code."""
        return self._code_fn(rows)

    def word_rows_local(self, rows) -> np.ndarray:
        return self.table.rows_of(self.codes(rows))


class DeviceBatch:
    """A flush-sized micro-batch featurized through the compiled
    program.  Carries the pre-split rows from admission (edge columnar
    parse) and the model the program was compiled against; anything the
    device plane does not materialize (featurized_row for flagged-event
    sinks, the word list, cut arrays) delegates lazily to the host
    featurizer — the golden oracle stays one attribute away."""

    def __init__(self, dev: DeviceFeaturizer, featurizer, rows,
                 raws) -> None:
        self._dev = dev
        self._featurizer = featurizer
        self._raws = raws
        self.rows = rows
        self.num_raw_events = len(rows)
        self.model = dev.model

    def codes(self) -> np.ndarray:
        """The batch's packed codes (memoized)."""
        codes = self.__dict__.get("_codes")
        if codes is None:
            codes = self._codes = self._dev.codes(self.rows)
        return codes

    def word_rows_local(self) -> np.ndarray:
        """Model word rows, local to the model (memoized)."""
        w = self.__dict__.get("_w_local")
        if w is None:
            w = self._w_local = self._dev.table.rows_of(self.codes())
        return w

    def _ip_rows(self, ip_base: int) -> np.ndarray:
        model = self._dev.model
        fb = len(model.ip_index)
        blocks = [_index_rows(model.ip_index, [r[col] for r in self.rows],
                              fb)
                  for col in self._dev.doc_cols]
        ip = blocks[0] if len(blocks) == 1 else np.concatenate(blocks)
        if ip_base:
            ip = ip + np.int32(ip_base)
        return ip.astype(np.int32, copy=False)

    def pair_rows(self, ip_base: int = 0, word_base: int = 0):
        """(ip_rows, word_rows, mult): the lookup arrays
        `serving.fleet.tenant_pairs` builds per tenant, from the
        compiled tables instead of word strings."""
        w = self.word_rows_local()
        wr = w if not word_base else w + np.int32(word_base)
        return (self._ip_rows(ip_base), wr.astype(np.int32, copy=False),
                self._dev.pairs_per_event)

    def fused_operands(self, ip_base: int = 0):
        """(featurizer, device codes, ip rows) of the fused flush: the
        row gather moves to the card and word_base rides along as a
        scalar (ops/featurize_kernel.py).  Device codes are int32
        indices into the table's device_rows (a sparse table probes on
        the host; see _CodeTable)."""
        return (self._dev, self._dev.table.device_codes(self.codes()),
                self._ip_rows(ip_base))

    def host_features(self):
        """The host-featurized batch (lazy, memoized) — the golden
        oracle every non-device consumer reads through."""
        f = self.__dict__.get("_host_feats")
        if f is None:
            f = self._featurizer(self._raws)
            self._host_feats = f
        return f

    def featurized_row(self, i: int):
        return self.host_features().featurized_row(i)

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        return getattr(self.host_features(), name)


# ---------------------------------------------------------------------------
# Shared compile helpers
# ---------------------------------------------------------------------------


def _pack(parts, radices) -> np.ndarray:
    """Mixed-radix packing of per-slot int64 arrays (slot 0 most
    significant).  Radix layout is fixed at compile, so identical slot
    values always pack to the identical code."""
    code = parts[0].astype(np.int64, copy=True)
    for p, r in zip(parts[1:], radices[1:]):
        code = code * np.int64(r) + p
    return code


class _CodeTable:
    """Packed-code -> model-word-row lookup, in one of two shapes.

    Below _MAX_CODE_SPACE: a DENSE pow2-padded LUT — one O(1) gather;
    every slot including the pad tail defaults to the fallback row, and
    index L_pad-1 is ALWAYS past the real code space, so rows with
    unseen categorical values route to a guaranteed-fallback slot.

    Above it: sparse probe — a realistic day's mixed-radix product
    (e.g. DNS qtypes x rcodes x five bin fields) can dwarf its actual
    vocabulary by orders of magnitude, so the table becomes the SORTED
    vocabulary codes plus a parallel row array, probed by binary search
    (np.searchsorted).  Unseen codes — and the invalid sentinel -1 —
    miss the probe and take the fallback row.  The sorted arrays pad to
    _pow2(V + 1) with an int64-max sentinel (codes) / the fallback row
    (rows), so probe results stay in-bounds for every input and
    vocabulary churn lands in the same bounded pow2 shape family as the
    dense LUT.

    Device contract (the fused flush gathers with int32 indices, the
    JAX package's contract too, whose x64 is off): `device_codes` maps
    packed codes to int32 indices into `device_rows` — the identity for
    dense mode, the HOST-side binary probe for sparse mode (misses land
    on the padded tail, which holds the fallback row) — and the card
    runs the same int32 gather of `device_rows` for both modes."""

    def __init__(self, entries, radices, fallback_row: int) -> None:
        space = 1
        for r in radices:
            space *= int(r)
        if space >= 1 << 62:
            raise Unlowerable(
                f"packed code space {space} overflows int64 packing"
            )
        self.code_space = space
        self.fallback_row = int(fallback_row)
        by_code: dict = {}
        for entry in entries:
            code = 0
            for v, r in zip(entry[:-1], radices):
                code = code * int(r) + int(v)
            prev = by_code.get(code)
            if prev is not None and prev != entry[-1]:
                raise Unlowerable(
                    f"code collision at {code}: rows {prev} vs {entry[-1]}"
                )
            by_code[code] = entry[-1]
        if space <= _MAX_CODE_SPACE:
            self.mode = "dense"
            self.code_dtype = np.int32
            lut = np.full(_pow2(space + 1), fallback_row, dtype=np.int32)
            for code, row in by_code.items():
                lut[code] = row
            self.lut = lut
            self.device_rows = lut
            self.size = lut.size
            self.invalid_code = np.int32(lut.size - 1)
        else:
            self.mode = "sparse"
            self.code_dtype = np.int64
            n = _pow2(len(by_code) + 1)
            codes = np.full(n, np.iinfo(np.int64).max, dtype=np.int64)
            rows = np.full(n, fallback_row, dtype=np.int32)
            order = sorted(by_code)
            codes[:len(order)] = order
            rows[:len(order)] = [by_code[c] for c in order]
            self.codes_sorted = codes
            self.rows_sorted = rows
            self.device_rows = rows
            self.size = n
            self.invalid_code = np.int64(-1)

    def mask_invalid(self, code: np.ndarray,
                     invalid: np.ndarray) -> np.ndarray:
        """Route rows with unseen categorical values to the mode's
        guaranteed-fallback code (dense pad slot / sparse miss)."""
        return np.where(invalid, self.invalid_code,
                        code).astype(self.code_dtype)

    def device_codes(self, codes: np.ndarray) -> np.ndarray:
        """Packed codes -> int32 indices into `device_rows` (see the
        device contract above)."""
        if self.mode == "dense":
            return codes
        i = np.searchsorted(self.codes_sorted, codes)
        return np.where(
            self.codes_sorted[i] == codes, i, self.size - 1
        ).astype(np.int32)

    def rows_of(self, codes: np.ndarray) -> np.ndarray:
        """codes -> model word rows (the host-side gather the "device"
        engine serves from; the fused program runs the same gather
        on-device from `device_codes`)."""
        return self.device_rows[self.device_codes(codes)]


# ---------------------------------------------------------------------------
# Flow: word = [-1_]port_time_ibyt_ipkt (JVM-double segments)
# ---------------------------------------------------------------------------


def _compile_flow(spec, cuts, model, top_domains) -> DeviceFeaturizer:
    time_cuts, ibyt_cuts, ipkt_cuts = (
        np.asarray(c, np.float64) for c in cuts
    )
    r_time = len(time_cuts) + 1
    r_ibyt = len(ibyt_cuts) + 1
    r_ipkt = len(ipkt_cuts) + 1

    # Pass 1: reverse-parse the vocabulary.  Flow word segments are all
    # str(float) renderings, which never contain '_', so ANY word that
    # fails this parse is host-unproducible and its entry is skipped —
    # flow never gates.  The port table is keyed by the segment TEXT
    # (not the float): str() is injective on floats, which keeps
    # -0.0 vs 0.0 and nan exact without special cases.
    parsed = []           # (flag, port_str, tb, bb, pb, row)
    port_strs = set()
    for word, row in model.word_index.items():
        segs = word.split("_")
        flag = 0
        if len(segs) == 5 and segs[0] == "-1":
            flag, segs = 1, segs[1:]
        if len(segs) != 4:
            continue
        port_s = _canon_float_str(segs[0])
        tb = _jvm_int(segs[1], r_time)
        bb = _jvm_int(segs[2], r_ibyt)
        pb = _jvm_int(segs[3], r_ipkt)
        if port_s is None or tb is None or bb is None or pb is None:
            continue
        port_strs.add(port_s)
        parsed.append((flag, port_s, tb, bb, pb, row))

    port_table = {s: i for i, s in enumerate(sorted(port_strs))}
    n_ports = max(1, len(port_table))
    radices = (2, n_ports, r_time, r_ibyt, r_ipkt)
    entries = [
        (flag, port_table[p], tb, bb, pb, row)
        for flag, p, tb, bb, pb, row in parsed
    ]
    fb_row = len(model.word_index)
    table = _CodeTable(entries, radices, fb_row)
    c = FLOW_COLUMNS
    i_hour, i_min, i_sec = c["hour"], c["minute"], c["second"]
    i_ipkt, i_ibyt = c["ipkt"], c["ibyt"]
    i_c10, i_c11 = c["sport"], c["dport"]   # the reference's swap

    def code_fn(rows):
        n = len(rows)
        if not n:
            return np.zeros(0, dtype=table.code_dtype)
        cols = _columns(rows, spec.num_columns)
        with np.errstate(invalid="ignore"):
            num_time = (_to_double_array(cols[i_hour])
                        + _to_double_array(cols[i_min]) / 60.0
                        + _to_double_array(cols[i_sec]) / 3600.0)
        tb = bin_values(num_time, time_cuts)
        bb = bin_values(_to_double_array(cols[i_ibyt]), ibyt_cuts)
        pb = bin_values(_to_double_array(cols[i_ipkt]), ipkt_cuts)

        # _adjust_port_words vectorized.  dport := col10, sport := col11
        # (the reference's deliberate swap).  pymin/pymax replicate
        # PYTHON min/max NaN propagation (`min(a, b)` keeps `a` unless
        # `b < a`), which numpy minimum/maximum would not.
        d = _to_double_array(cols[i_c10])
        s = _to_double_array(cols[i_c11])
        pymin = np.where(s < d, s, d)
        pymax = np.where(s > d, s, d)
        cond2 = (((d <= 1024) | (s <= 1024))
                 & ((d > 1024) | (s > 1024)) & (pymin != 0))
        cond3 = (d > 1024) & (s > 1024)
        cond4a = (d == 0) & (s != 0)
        cond4b = (s == 0) & (d != 0)
        m2 = cond2
        not23 = ~cond2 & ~cond3
        m4a = not23 & cond4a
        m4b = not23 & ~cond4a & cond4b
        word_port = np.select(
            [m2, ~m2 & cond3, m4a, m4b],
            [pymin, np.float64(333333.0), s, d],
            default=np.where(pymin == 0, pymax, 111111.0),
        )
        src_flag = ((m2 & (s < d)) | m4a).astype(np.int64)
        dest_flag = ((m2 & (d < s)) | m4b).astype(np.int64)

        # Port text interning: str() once per UNIQUE port value.  The
        # unique pass runs over the raw float BITS — value-level unique
        # would collapse -0.0 into 0.0, whose str() renderings (and so
        # host words) differ.
        uq, inv = np.unique(word_port.view(np.int64),
                            return_inverse=True)
        get = port_table.get
        codes_u = np.fromiter(
            (get(str(v), -1) for v in uq.view(np.float64).tolist()),
            np.int64, len(uq),
        )
        pcode = codes_u[inv.reshape(word_port.shape)]
        invalid = pcode < 0
        base = (np.where(invalid, 0, pcode) * r_time + tb) * r_ibyt
        base = (base + bb) * r_ipkt + pb
        span = np.int64(n_ports) * r_time * r_ibyt * r_ipkt
        src = table.mask_invalid(src_flag * span + base, invalid)
        dst = table.mask_invalid(dest_flag * span + base, invalid)
        return np.concatenate([src, dst])

    info = {"entries": len(entries), "ports": len(port_table)}
    return DeviceFeaturizer(
        "flow", 2, (c["sip"], c["dip"]), table, code_fn, model, info
    )


# ---------------------------------------------------------------------------
# DNS: word = top_blen_btime_bsub_bent_bper_qtype_rcode
# ---------------------------------------------------------------------------


def _compile_dns(spec, cuts, model, top_domains) -> DeviceFeaturizer:
    (time_cuts, flen_cuts, sub_cuts, ent_cuts, per_cuts) = (
        np.asarray(c, np.float64) for c in cuts
    )
    r_len = len(flen_cuts) + 1
    r_time = len(time_cuts) + 1
    r_sub = len(sub_cuts) + 1
    r_ent = len(ent_cuts) + 1
    r_per = len(per_cuts) + 1

    parsed = []       # (top, blen, btime, bsub, bent, bper, qt, rc, row)
    qt_vals, rc_vals = set(), set()
    for word, row in model.word_index.items():
        segs = word.split("_")
        if len(segs) > 8:
            # qtype/rcode carried the separator: the slot model cannot
            # represent this word, yet the host CAN produce it -> the
            # whole model keeps the host featurizer.
            raise Unlowerable(
                f"dns vocabulary word has embedded separators: {word!r}"
            )
        if len(segs) < 8:
            continue                      # host-unproducible
        top = _digit_int(segs[0], 3)
        blen = _digit_int(segs[1], r_len)
        btime = _digit_int(segs[2], r_time)
        bsub = _digit_int(segs[3], r_sub)
        bent = _digit_int(segs[4], r_ent)
        bper = _digit_int(segs[5], r_per)
        if None in (top, blen, btime, bsub, bent, bper):
            continue                      # unreachable under pinned cuts
        qt_vals.add(segs[6])
        rc_vals.add(segs[7])
        parsed.append((top, blen, btime, bsub, bent, bper,
                       segs[6], segs[7], row))

    qt_table = {v: i for i, v in enumerate(sorted(qt_vals))}
    rc_table = {v: i for i, v in enumerate(sorted(rc_vals))}
    n_qt, n_rc = max(1, len(qt_table)), max(1, len(rc_table))
    radices = (3, n_qt, n_rc, r_len, r_time, r_sub, r_ent, r_per)
    entries = [
        (top, qt_table[qt], rc_table[rc], blen, btime, bsub, bent, bper,
         row)
        for top, blen, btime, bsub, bent, bper, qt, rc, row in parsed
    ]
    fb_row = len(model.word_index)
    table = _CodeTable(entries, radices, fb_row)
    c = DNS_COLUMNS
    i_ts, i_fl = c["unix_tstamp"], c["frame_len"]
    i_qn, i_qt, i_rc = c["dns_qry_name"], c["dns_qry_type"], \
        c["dns_qry_rcode"]
    top_set = top_domains

    def code_fn(rows):
        n = len(rows)
        if not n:
            return np.zeros(0, dtype=table.code_dtype)
        cols = _columns(rows, spec.num_columns)
        btime = bin_values(_to_double_array(cols[i_ts]), time_cuts)
        blen = bin_values(_to_double_array(cols[i_fl]), flen_cuts)

        # Query-name transforms (subdomain split, entropy, whitelist
        # flag) run once per UNIQUE name via a memo pass — repeated
        # lookups of the same name (the shape of real DNS traffic) cost
        # one dict hit each instead of a fresh entropy loop.
        memo: dict = {}
        sub_len = np.empty(n, np.int64)
        npar = np.empty(n, np.int64)
        ent = np.empty(n, np.float64)
        topv = np.empty(n, np.int64)
        for i, q in enumerate(cols[i_qn]):
            hit = memo.get(q)
            if hit is None:
                dom, sub, sl, np_ = extract_subdomain(q)
                hit = (sl, np_, shannon_entropy(sub),
                       2 if dom == "intel"
                       else (1 if dom in top_set else 0))
                memo[q] = hit
            sub_len[i], npar[i], ent[i], topv[i] = hit
        bsub = bin_values(sub_len, sub_cuts)
        bent = bin_values(ent, ent_cuts)
        bper = bin_values(npar, per_cuts)

        qt = _dict_codes(qt_table, cols[i_qt])
        rc = _dict_codes(rc_table, cols[i_rc])
        invalid = (qt < 0) | (rc < 0)
        code = _pack(
            [topv, np.where(qt < 0, 0, qt), np.where(rc < 0, 0, rc),
             blen, btime, bsub, bent, bper],
            radices,
        )
        return table.mask_invalid(code, invalid)

    info = {"entries": len(entries), "qtypes": len(qt_table),
            "rcodes": len(rc_table)}
    return DeviceFeaturizer(
        "dns", 1, (c["ip_dst"],), table, code_fn, model, info
    )


# ---------------------------------------------------------------------------
# TableSourceSpec: template-driven grammar (proxy and any JSON source)
# ---------------------------------------------------------------------------


def _template_slots(spec):
    """Tokenize the word template into (literals, ordered slots).  Each
    slot is ("bin", cut_index, radix_placeholder) or ("cat", column).
    Gates: format specs/conversions, adjacent slots (ambiguous parse),
    unbinned declared fields (float rendering), unknown placeholders."""
    import string as string_mod

    field_names = {f.name for f in spec.fields}
    cut_index = {cut.field: j for j, cut in enumerate(spec.cuts_spec)}
    literals, slots = [], []
    pending_lit = ""
    for lit, name, fspec, conv in string_mod.Formatter().parse(
            spec.word_template):
        pending_lit += lit
        if name is None:
            continue
        if fspec or conv:
            raise Unlowerable(
                f"template slot {name!r} uses a format spec/conversion"
            )
        if slots and not pending_lit:
            raise Unlowerable(
                f"adjacent template slots at {name!r} parse ambiguously"
            )
        # The word loop writes columns first, then fields OVER them —
        # a name that is both resolves to the field.
        if name in field_names:
            if name not in cut_index:
                raise Unlowerable(
                    f"unbinned field {name!r} in template renders raw "
                    "floats"
                )
            slots.append(("bin", cut_index[name]))
        elif name in spec._col:
            slots.append(("cat", spec._col[name]))
        else:
            raise Unlowerable(f"unknown template placeholder {name!r}")
        literals.append(pending_lit)
        pending_lit = ""
    return literals, slots, pending_lit


def _compile_table(spec, cuts, model, top_domains) -> DeviceFeaturizer:
    import re

    literals, slots, tail = _template_slots(spec)
    cut_arrays = [np.asarray(c, np.float64) for c in cuts]
    sep_chars = set("".join(literals) + tail)
    if not sep_chars and len(slots) > 1:
        raise Unlowerable("multi-slot template with no literal text")
    cat_pat = "[^" + re.escape("".join(sorted(sep_chars))) + "]*" \
        if sep_chars else ".*"
    pattern = ""
    for lit, slot in zip(literals, slots):
        pattern += re.escape(lit)
        pattern += r"(\d+)" if slot[0] == "bin" else f"({cat_pat})"
    pattern += re.escape(tail)
    rx = re.compile(pattern)

    bin_radices = {
        j: len(cut_arrays[j]) + 1 for j in range(len(cut_arrays))
    }
    cat_slot_ids = [k for k, s in enumerate(slots) if s[0] == "cat"]
    cat_values: "dict[int, set]" = {k: set() for k in cat_slot_ids}
    parsed = []
    for word, row in model.word_index.items():
        m = rx.fullmatch(word)
        if m is None:
            # With the char-class slot patterns the grammar is
            # prefix-unambiguous: a non-matching vocabulary word can
            # only have come from values carrying separator characters,
            # which the render path CAN produce -> gate.
            raise Unlowerable(
                f"vocabulary word does not match template grammar: "
                f"{word!r}"
            )
        vals = []
        ok = True
        for k, slot in enumerate(slots):
            g = m.group(k + 1)
            if slot[0] == "bin":
                b = _digit_int(g, bin_radices[slot[1]])
                if b is None:
                    ok = False            # unreachable under pinned cuts
                    break
                vals.append(b)
            else:
                cat_values[k].add(g)
                vals.append(g)
        if ok:
            parsed.append((vals, row))

    cat_tables = {
        k: {v: i for i, v in enumerate(sorted(cat_values[k]))}
        for k in cat_slot_ids
    }
    radices = tuple(
        bin_radices[s[1]] if s[0] == "bin"
        else max(1, len(cat_tables[k]))
        for k, s in enumerate(slots)
    )
    entries = []
    for vals, row in parsed:
        coded = tuple(
            v if slots[k][0] == "bin" else cat_tables[k][v]
            for k, v in enumerate(vals)
        )
        entries.append(coded + (row,))
    fb_row = len(model.word_index)
    table = _CodeTable(entries, radices, fb_row)

    field_by_name = {f.name: f for f in spec.fields}
    binned_fields = [cut.field for cut in spec.cuts_spec]

    def _field_values(f, cols):
        col = cols[spec._col[f.column]]
        if f.kind == "number":
            return _to_double_array(col)
        if f.kind == "hms":
            from .generic import _hms_seconds

            return np.array([_hms_seconds(v) for v in col],
                            dtype=np.float64)
        if f.kind == "entropy":
            uq, inv = np.unique(np.array(col, dtype=object),
                                return_inverse=True)
            vals = np.array([shannon_entropy(v) for v in uq.tolist()],
                            dtype=np.float64)
            return vals[inv.reshape(len(col))]
        return np.fromiter((len(v) for v in col), np.float64, len(col))

    def code_fn(rows):
        n = len(rows)
        if not n:
            return np.zeros(0, dtype=table.code_dtype)
        cols = _columns(rows, spec.num_columns)
        bins = {}
        for j, name in enumerate(binned_fields):
            vals = _field_values(field_by_name[name], cols)
            bins[j] = bin_values(vals, cut_arrays[j])
        parts, invalid = [], np.zeros(n, dtype=bool)
        for k, slot in enumerate(slots):
            if slot[0] == "bin":
                parts.append(bins[slot[1]])
            else:
                codes = _dict_codes(cat_tables[k], cols[slot[1]])
                invalid |= codes < 0
                parts.append(np.where(codes < 0, 0, codes))
        code = _pack(parts, radices)
        return table.mask_invalid(code, invalid)

    info = {"entries": len(entries),
            "cats": {str(k): len(cat_tables[k]) for k in cat_slot_ids}}
    return DeviceFeaturizer(
        spec.name, 1, (spec._col[spec.doc_column],), table, code_fn,
        model, info,
    )


# ---------------------------------------------------------------------------
# Compile entry points + per-model cache
# ---------------------------------------------------------------------------


def compile_featurizer(spec, cuts, model, top_domains=frozenset()):
    """Lower (spec, pinned cuts, model) into a DeviceFeaturizer.

    Returns (featurizer_or_None, info): info always carries the
    journal-ready compile outcome (`lowered`, `reason`, table sizes) —
    the `{"kind": "featurize_compile"}` record the serving fleet emits
    once per compile."""
    from .generic import TableSourceSpec

    info = {"kind": "featurize_compile", "source": spec.name,
            "vocab": len(model.word_index)}
    try:
        if spec.name == "flow":
            dev = _compile_flow(spec, cuts, model, top_domains)
        elif spec.name == "dns":
            dev = _compile_dns(spec, cuts, model, top_domains)
        elif isinstance(spec, TableSourceSpec):
            dev = _compile_table(spec, cuts, model, top_domains)
        else:
            raise Unlowerable(
                f"source {spec.name!r} has no device grammar"
            )
    except Unlowerable as e:
        info.update(lowered=False, reason=str(e), mode="", lut=0,
                    code_space=0, shared=False)
        return None, info
    info.update(lowered=True, reason="", mode=dev.table.mode,
                lut=int(dev.table.size),
                code_space=int(dev.table.code_space), shared=False,
                **dev.info)
    dev.info = info
    return dev, info


def _cuts_key(cuts) -> tuple:
    return tuple(
        tuple(np.asarray(c, np.float64).tolist()) for c in cuts
    )


#: vocabulary-content compile cache: (source, cuts, top_domains,
#: vocab digest) -> a model-free record of the compiled table.  A
#: paged fleet's tenants often share a trained day (same word
#: vocabulary, distinct theta/p) — the table depends ONLY on the
#: vocabulary content, so tenant N's promotion rebinds tenant 0's
#: compile instead of re-parsing the whole vocabulary on the flush
#: path.  Bounded FIFO: a handful of live (day, source) combinations.
_SHARED_TABLES: dict = {}
_SHARED_TABLES_MAX = 32


def _vocab_digest(model) -> str:
    """Content digest of the model's word vocabulary (order-free),
    memoized on the model — the compile-sharing key component."""
    dig = getattr(model, "_vocab_digest", None)
    if dig is None:
        import hashlib

        h = hashlib.blake2b(digest_size=16)
        for w, i in sorted(model.word_index.items()):
            h.update(w.encode())
            h.update(str(i).encode())
            h.update(b";")
        dig = h.hexdigest()
        model._vocab_digest = dig
    return dig


def _rebind(shared: dict, model) -> DeviceFeaturizer:
    """A DeviceFeaturizer over an already-compiled table, bound to a
    DIFFERENT model with the same vocabulary content (theta/p never
    enter the table)."""
    return DeviceFeaturizer(
        shared["dsource"], shared["pairs_per_event"],
        shared["doc_cols"], shared["table"], shared["code_fn"],
        model, {**shared["info"], "shared": True},
    )


def cached_featurizer(model, spec, cuts, top_domains=frozenset()):
    """compile_featurizer through two cache levels.  Per model: the
    cache lives ON the instance (the `scoring.score._device_model`
    idiom: drop the model, drop its tables).  Across models: the
    vocabulary-content table cache (`_SHARED_TABLES`), so same-day
    tenant fleets pay ONE vocabulary parse, and a rebind — not a
    compile — lands on every later tenant's first flush.

    Returns (featurizer_or_None, fresh_info_or_None) — info is
    non-None exactly once per model (journal-ready; rebinds carry
    `"shared": True`) so callers journal without deduplicating."""
    key = (spec.name, _cuts_key(cuts), top_domains)
    cache = getattr(model, "_featurize_cache", None)
    if cache is None:
        cache = {}
        model._featurize_cache = cache
    hit = cache.get(key, _MISS)
    if hit is not _MISS:
        return hit, None
    skey = key + (_vocab_digest(model),)
    shared = _SHARED_TABLES.get(skey)
    if shared is not None:
        dev = _rebind(shared, model) if shared["table"] is not None \
            else None
        info = ({**shared["info"], "shared": True} if dev is None
                else dev.info)
        cache[key] = dev
        return dev, info
    dev, info = compile_featurizer(spec, cuts, model,
                                   top_domains=top_domains)
    while len(_SHARED_TABLES) >= _SHARED_TABLES_MAX:
        _SHARED_TABLES.pop(next(iter(_SHARED_TABLES)))
    _SHARED_TABLES[skey] = {
        "dsource": spec.name,
        "pairs_per_event": spec.pairs_per_event,
        "doc_cols": dev.doc_cols if dev is not None else (),
        "table": dev.table if dev is not None else None,
        "code_fn": dev._code_fn if dev is not None else None,
        "info": dict(info),
    }
    cache[key] = dev
    return dev, info


def device_batch(featurizer, rows, raws, model):
    """Featurize a validated micro-batch through the compiled program.
    Returns (DeviceBatch_or_None, fresh_compile_info_or_None); None
    batch means the model is unlowerable (or the featurizer has no
    registered spec) and the caller keeps the host path."""
    from . import get as get_source

    try:
        spec = get_source(featurizer.dsource)
    except KeyError:
        return None, None
    cuts = getattr(featurizer, "cuts", None)
    if cuts is None:
        return None, None
    top = getattr(featurizer, "top_domains", frozenset())
    dev, info = cached_featurizer(model, spec, cuts, top_domains=top)
    if dev is None:
        return None, info
    return DeviceBatch(dev, featurizer, rows, raws), info


def resolve_engine(config_value: str = "auto",
                   device=None) -> "tuple[str, str]":
    """(engine, source): ONI_ML_TPU_FEATURIZE > ServingConfig.
    featurize_engine > this device's plan entry (knob
    `featurize_engine`) > "device".  "auto" with no plan is "device": an
    unlowerable vocabulary keeps the host featurizer per model anyway."""
    from .. import plans

    env = os.environ.get("ONI_ML_TPU_FEATURIZE", "").strip().lower()
    if env in ENGINES:
        return env, "env"
    if config_value in ENGINES:
        return config_value, "config"
    if config_value not in ("auto", "", None):
        raise ValueError(
            f"featurize_engine must be auto|{'|'.join(ENGINES)}, got "
            f"{config_value!r}")
    value, source = plans.resolve("featurize_engine", None, device=device)
    if isinstance(value, dict) and value.get("engine") in ENGINES:
        return value["engine"], source
    return "device", "default"


# The floor of the device featurize path when nothing measured it: 1 =
# always the device tables.  Below a measured break-even a segment
# featurizes on the host; the break-even is a property of the device, so
# the gate engages only once measure_break_even has recorded it.
DEFAULT_BREAK_EVEN = 1


def resolve_break_even(config_value: int = 0,
                       device=None) -> "tuple[int, str]":
    """(break_even, source): the smallest fleet segment at which the
    device featurize path engages.  ONI_ML_TPU_FEATURIZE_BREAK_EVEN >
    a nonzero ServingConfig.featurize_break_even > this device's plan
    entry (`plans.resolve`) > DEFAULT_BREAK_EVEN."""
    from .. import plans

    env = os.environ.get("ONI_ML_TPU_FEATURIZE_BREAK_EVEN", "").strip()
    if env:
        return max(1, int(env)), "env"
    if config_value:
        return max(1, int(config_value)), "config"
    value, source = plans.resolve("featurize_break_even", None,
                                  device=device)
    if value is None:
        return DEFAULT_BREAK_EVEN, "default"
    return int(value), source


def measure_break_even(featurizer, rows, raws, model,
                       sizes=(16, 32, 64, 128, 256, 512),
                       repeats: int = 3,
                       device=None) -> "tuple[int | None, list]":
    """Time the host featurizer against the device featurize path
    (compile-cached tables + row gather) over segment sizes -> (the
    break-even: the smallest size where the device path wins on the
    median, or None where it never does or the model is unlowerable;
    the per-size samples).  A measured break-even goes to the plan
    cache as `featurize_break_even` for `device`, where
    resolve_break_even reads it."""
    import time

    from .. import plans

    # Warm the compile caches outside the timed region: the measured
    # quantity is the per-flush cost, not the once-per-model compile.
    warm, _ = device_batch(featurizer, rows[:1], raws[:1], model)
    if warm is None:
        return None, []
    warm.pair_rows()
    samples = []
    crossover = None
    for size in sizes:
        if size > len(raws):
            break
        seg_rows, seg_raws = rows[:size], raws[:size]
        host_ts, dev_ts = [], []
        for _ in range(repeats):
            t0 = time.perf_counter()
            featurizer(seg_raws)
            host_ts.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            batch, _info = device_batch(
                featurizer, seg_rows, seg_raws, model)
            if batch is None:
                return None, samples
            batch.pair_rows()
            dev_ts.append(time.perf_counter() - t0)
        host_s = sorted(host_ts)[len(host_ts) // 2]
        dev_s = sorted(dev_ts)[len(dev_ts) // 2]
        samples.append({"size": size,
                        "host_us": round(host_s * 1e6, 2),
                        "device_us": round(dev_s * 1e6, 2)})
        if crossover is None and dev_s < host_s:
            crossover = size
    plans.note_sweep("featurize_break_even")
    if crossover is not None:
        plans.record_value(
            "featurize_break_even", crossover, device=device,
            measurements={s["size"]: {"host_us": s["host_us"],
                                      "device_us": s["device_us"]}
                          for s in samples})
    return crossover, samples
