"""Netflow featurization (port of oni_ml_tpu/features/flow.py, pure
numpy) — replaces flow_pre_lda.scala (and the duplicate
copy inside flow_post_lda.scala:64-224).

Per event (27-column netflow CSV row, schema flow_pre_lda.scala:46-72):
fractional-hour time is appended, decile cuts are taken over time and
ibyt and quintile cuts over ipkt (flow_pre_lda.scala:280-290), each value
is binned, and a word is constructed from a canonicalised port plus the
three bins (adjust_port, flow_pre_lda.scala:317-359).  Every event yields
TWO documents: the source IP sees `src_word`, the destination IP sees
`dest_word`, with a `-1_` prefix marking the side that received the
connection.

Reference quirks reproduced deliberately (word identity must match):
- adjust_port reads column 10 as "dport" and column 11 as "sport" even
  though the schema says 10=sport, 11=dport (flow_pre_lda.scala:321-322).
  Pre and post share the swap so it is self-consistent; we keep it so our
  words equal the reference's on identical data.
- word_port and the three bins are formatted as JVM doubles ("80.0",
  "333333.0", bins like "9.0") because adjust_port round-trips them
  through Double.toString (flow_pre_lda.scala:349).
- ip_pair's intended "canonical unordered pair" check `sip != 0` compares
  a string to an int and is therefore always true (flow_pre_lda.scala:329);
  effectively pair = "sip dip" if sip < dip lexicographically else
  "dip sip".  Computed but unused downstream, kept for row parity.

One deliberate divergence: the reference's feedback-row builder drops its
commas (`buf + ','` discards the result, flow_pre_lda.scala:243-245), so
injected feedback rows never survive the 27-field filter — the flow
feedback loop is silently dead upstream.  We implement the documented
intent (feedback.py builds real 27-column rows).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable, Sequence

import numpy as np

from .container import PythonContainer, csv_blob, index_rows
from .quantiles import DECILES, QUINTILES, bin_values, ecdf_cuts

# Column indices in the 27-column netflow schema (flow_pre_lda.scala:46-72).
FLOW_COLUMNS = {
    "time": 0, "year": 1, "month": 2, "day": 3, "hour": 4, "minute": 5,
    "second": 6, "tdur": 7, "sip": 8, "dip": 9, "sport": 10, "dport": 11,
    "proto": 12, "flag": 13, "fwd": 14, "stos": 15, "ipkt": 16, "ibyt": 17,
    "opkt": 18, "obyt": 19, "input": 20, "output": 21, "sas": 22, "das": 23,
    "dtos": 24, "dir": 25, "rip": 26,
}
NUM_FLOW_COLUMNS = 27


def _jvm_double(x: float) -> str:
    """Format like JVM Double.toString for the values that occur here
    (integral doubles -> '80.0'); Python's repr matches for those."""
    return str(float(x))


def _to_double(s: str) -> float:
    """toDouble with NaN default (flow_pre_lda.scala:15-19)."""
    try:
        return float(s)
    except (TypeError, ValueError):
        return float("nan")


@dataclass
class FlowFeatures(PythonContainer):
    """Featurized day of netflow.  Everything scoring needs rides along so
    the post stage never re-featurizes (removing the SURVEY §1 duplication
    and its nondeterminism risk)."""

    _PACKED = ("rows", "word_port", "ip_pair", "src_word", "dest_word")

    rows: list[list[str]]         # 27-col rows (post-filter, incl. feedback)
    num_time: np.ndarray          # [N] f64 fractional hour
    ibyt_bin: np.ndarray          # [N] int
    ipkt_bin: np.ndarray          # [N] int
    time_bin: np.ndarray          # [N] int
    word_port: list[str]          # [N] JVM-double strings
    ip_pair: list[str]            # [N]
    src_word: list[str]           # [N]
    dest_word: list[str]          # [N]
    # Events [num_raw_events:] are injected feedback duplicates: they train
    # the model (word_counts) but are never scored — the reference's post
    # stage re-reads raw data only (flow_post_lda.scala:127-128).
    num_raw_events: int = 0
    time_cuts: np.ndarray = field(default_factory=lambda: np.zeros(10))
    ibyt_cuts: np.ndarray = field(default_factory=lambda: np.zeros(10))
    ipkt_cuts: np.ndarray = field(default_factory=lambda: np.zeros(5))

    @property
    def num_events(self) -> int:
        return len(self.rows)

    def sip(self, i: int) -> str:
        return self.rows[i][FLOW_COLUMNS["sip"]]

    def dip(self, i: int) -> str:
        return self.rows[i][FLOW_COLUMNS["dip"]]

    def word_counts(self) -> list[tuple[str, str, int]]:
        """Per-IP word counts, both endpoints documents
        (flow_pre_lda.scala:366-373): src counts first, then dest counts,
        each in first-seen order (Spark's reduceByKey order is partition-
        dependent; first-seen is our deterministic substitute)."""
        src: dict[tuple[str, str], int] = {}
        dst: dict[tuple[str, str], int] = {}
        s_col, d_col = FLOW_COLUMNS["sip"], FLOW_COLUMNS["dip"]
        for i, row in enumerate(self.rows):
            ks = (row[s_col], self.src_word[i])
            src[ks] = src.get(ks, 0) + 1
            kd = (row[d_col], self.dest_word[i])
            dst[kd] = dst.get(kd, 0) + 1
        return [(ip, w, c) for (ip, w), c in src.items()] + [
            (ip, w, c) for (ip, w), c in dst.items()
        ]

    def featurized_row(self, i: int) -> list[str]:
        """The row as flow_post_lda sees it pre-scoring: original 27 cols
        + num_time + ibyt_bin/ipkt_bin/time_bin + word_port/ip_pair/
        src_word/dest_word (cols 27-34)."""
        return self.rows[i] + [
            _jvm_double(self.num_time[i]),
            str(int(self.ibyt_bin[i])),
            str(int(self.ipkt_bin[i])),
            str(int(self.time_bin[i])),
            self.word_port[i],
            self.ip_pair[i],
            self.src_word[i],
            self.dest_word[i],
        ]

    def event_indices(self, ip_index: dict, word_index: dict):
        """Model-row index arrays (sip, src word, dip, dest word), int32,
        of every raw event; misses get the fallback row `len(index)`."""
        n = self.num_raw_events
        fb_ip, fb_w = len(ip_index), len(word_index)
        s_col, d_col = FLOW_COLUMNS["sip"], FLOW_COLUMNS["dip"]
        rows = self.rows[:n]
        return (
            index_rows(ip_index, [r[s_col] for r in rows], fb_ip),
            index_rows(word_index, self.src_word[:n], fb_w),
            index_rows(ip_index, [r[d_col] for r in rows], fb_ip),
            index_rows(word_index, self.dest_word[:n], fb_w),
        )

    def results_csv(self, src_scores, dest_scores, order) -> bytes:
        """flow_results.csv's bytes: the rows of `order`, each its 35
        featurized columns + src_score + dest_score."""
        return csv_blob(
            ",".join(self.featurized_row(i)
                     + [str(src_scores[i]), str(dest_scores[i])])
            for i in order)


def _adjust_port_words(
    sip: str, dip: str, col10: float, col11: float,
    ibyt_bin: int, ipkt_bin: int, time_bin: int,
) -> tuple[str, str, str, str]:
    """Word construction (flow_pre_lda.scala:317-359).  col10/col11 keep
    the reference's swapped naming: dport := col10, sport := col11."""
    dport, sport = col10, col11
    if (
        (dport <= 1024 or sport <= 1024)
        and (dport > 1024 or sport > 1024)
        and min(dport, sport) != 0
    ):
        p_case, word_port = 2, min(dport, sport)
    elif dport > 1024 and sport > 1024:
        p_case, word_port = 3, 333333.0
    elif dport == 0 and sport != 0:
        p_case, word_port = 4, sport
    elif sport == 0 and dport != 0:
        p_case, word_port = 4, dport
    else:
        p_case = 1
        word_port = max(dport, sport) if min(dport, sport) == 0 else 111111.0

    # Bin order inside the word is time, ibyt, ipkt — all JVM doubles.
    word = (
        f"{_jvm_double(word_port)}_{_jvm_double(time_bin)}"
        f"_{_jvm_double(ibyt_bin)}_{_jvm_double(ipkt_bin)}"
    )
    src_word = dest_word = word
    if p_case == 2 and dport < sport:
        dest_word = "-1_" + dest_word
    elif p_case == 2 and sport < dport:
        src_word = "-1_" + src_word
    elif p_case == 4 and dport == 0:
        src_word = "-1_" + src_word
    elif p_case == 4 and sport == 0:
        dest_word = "-1_" + dest_word

    # ip_pair (flow_pre_lda.scala:328-329): the `sip != 0` arm is a
    # String-vs-Int comparison, always true on the JVM.
    ip_pair = f"{sip} {dip}" if sip < dip else f"{dip} {sip}"
    return _jvm_double(word_port), ip_pair, src_word, dest_word


def featurize_flow(
    lines: Iterable[str],
    feedback_rows: Sequence[str] = (),
    skip_header: bool = True,
    precomputed_cuts: tuple[np.ndarray, np.ndarray, np.ndarray] | None = None,
) -> FlowFeatures:
    """Full flow featurization pass.

    `lines` are raw CSV lines; the first distinct line is treated as a
    header and all its duplicates dropped (removeHeader,
    flow_pre_lda.scala:22-26).  `feedback_rows` are pre-built 27-column
    CSV strings (already duplicated DUPFACTOR times by feedback.py).
    `precomputed_cuts` = (time_cuts, ibyt_cuts, ipkt_cuts) skips the ECDF
    pass (the reference's vestigial flow_qtiles path, SURVEY §2.7).
    """
    rows: list[list[str]] = []
    header: str | None = None
    for line in lines:
        if skip_header:
            if header is None:
                header = line
                continue
            if line == header:
                continue
        parts = line.strip().split(",")
        if len(parts) == NUM_FLOW_COLUMNS:
            rows.append(parts)
    num_raw_events = len(rows)
    for line in feedback_rows:
        parts = line.strip().split(",")
        if len(parts) == NUM_FLOW_COLUMNS:
            rows.append(parts)

    n = len(rows)
    c = FLOW_COLUMNS
    # Golden-oracle host parse: the reference per-cell NaN-defaulting
    # the device plane's vectorized parse is pinned byte-identical to.
    hour = np.array([_to_double(r[c["hour"]]) for r in rows])
    minute = np.array([_to_double(r[c["minute"]]) for r in rows])
    second = np.array([_to_double(r[c["second"]]) for r in rows])
    ipkt = np.array([_to_double(r[c["ipkt"]]) for r in rows])
    ibyt = np.array([_to_double(r[c["ibyt"]]) for r in rows])
    col10 = np.array([_to_double(r[c["sport"]]) for r in rows])
    col11 = np.array([_to_double(r[c["dport"]]) for r in rows])
    with np.errstate(invalid="ignore"):  # garbage rows carry NaN by design
        num_time = hour + minute / 60.0 + second / 3600.0

    if precomputed_cuts is not None:
        time_cuts, ibyt_cuts, ipkt_cuts = (
            np.asarray(x, dtype=np.float64) for x in precomputed_cuts
        )
    else:
        time_cuts = ecdf_cuts(num_time, DECILES)
        ibyt_cuts = ecdf_cuts(ibyt, DECILES)
        ipkt_cuts = ecdf_cuts(ipkt, QUINTILES)

    if n:
        ibyt_bin = bin_values(ibyt, ibyt_cuts)
        ipkt_bin = bin_values(ipkt, ipkt_cuts)
        time_bin = bin_values(num_time, time_cuts)
    else:
        ibyt_bin = ipkt_bin = time_bin = np.zeros(0, dtype=np.int64)

    word_port: list[str] = []
    ip_pair: list[str] = []
    src_word: list[str] = []
    dest_word: list[str] = []
    for i, row in enumerate(rows):
        wp, pair, sw, dw = _adjust_port_words(
            row[c["sip"]], row[c["dip"]], col10[i], col11[i],
            int(ibyt_bin[i]), int(ipkt_bin[i]), int(time_bin[i]),
        )
        word_port.append(wp)
        ip_pair.append(pair)
        src_word.append(sw)
        dest_word.append(dw)

    return FlowFeatures(
        rows=rows,
        num_time=num_time,
        ibyt_bin=ibyt_bin,
        ipkt_bin=ipkt_bin,
        time_bin=time_bin,
        word_port=word_port,
        ip_pair=ip_pair,
        src_word=src_word,
        dest_word=dest_word,
        time_cuts=time_cuts,
        ibyt_cuts=ibyt_cuts,
        ipkt_cuts=ipkt_cuts,
        num_raw_events=num_raw_events,
    )
