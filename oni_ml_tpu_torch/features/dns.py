"""DNS featurization (port of oni_ml_tpu/features/dns.py, the
pure-Python path; the JAX package pins its native featurizer's bytes
equal to it) — replaces dns_pre_lda.scala (and the duplicate copy
inside dns_post_lda.scala:153-297).

Per DNS event (8 selected columns, dns_pre_lda.scala:149): the query name
is split into domain/subdomain with reverse-DNS and country-code-TLD
handling (extract_subdomain, dns_pre_lda.scala:185-220), the subdomain's
Shannon entropy is the DGA/tunneling signal (dns_pre_lda.scala:278-287),
decile cuts bin unix_tstamp and frame_len and quintile cuts (over the
positive subset) bin subdomain length / entropy / period count
(dns_pre_lda.scala:289-306), a whitelist flag marks known-good domains,
and the word concatenates flag + five bins + query type + rcode
(dns_pre_lda.scala:320-326).  The querying client `ip_dst` is the
document.

Reference quirks reproduced deliberately (word identity must match):
- A missing subdomain is the literal string "None", whose entropy (2.0 —
  four distinct characters) is what gets binned and even feeds the
  entropy-cut ECDF, since "None" passes the > 0 filter
  (dns_pre_lda.scala:286,301).
- `num.periods` is the total dot-separated part count of the full query
  name, not the subdomain's period count (dns_pre_lda.scala:219).
- The country-code set contains the empty string
  (dns_pre_lda.scala:180).
- The hardcoded customer whitelist `domain == "intel" -> "2"`
  (dns_pre_lda.scala:315).

Not reproduced: the reference's file-union loop skips its second input
file (`if (index > 1)`, dns_pre_lda.scala:144-148 — an off-by-one that
silently drops data); we read every input.
"""

from __future__ import annotations

import math
from collections import Counter
from dataclasses import dataclass, field
from typing import Iterable, Sequence

import numpy as np

from ..io.formats import contract_open as _open
from .flow import _to_double
from .container import PythonContainer, csv_blob, index_rows
from .quantiles import DECILES, QUINTILES, bin_values, ecdf_cuts

# The 8 columns selected from the raw source (dns_pre_lda.scala:149).
DNS_COLUMNS = {
    "frame_time": 0, "unix_tstamp": 1, "frame_len": 2, "ip_dst": 3,
    "dns_qry_name": 4, "dns_qry_class": 5, "dns_qry_type": 6,
    "dns_qry_rcode": 7,
}
NUM_DNS_COLUMNS = 8

# ISO country-code TLDs, verbatim from dns_pre_lda.scala:180 (including
# the stray empty string and "krd").
COUNTRY_CODES = frozenset(
    "ac ad ae af ag ai al am an ao aq ar as at au aw ax az ba bb bd be bf bg "
    "bh bi bj bm bn bo bq br bs bt bv bw by bz ca cc cd cf cg ch ci ck cl cm "
    "cn co cr cu cv cw cx cy cz de dj dk dm do dz ec ee eg eh er es et eu fi "
    "fj fk fm fo fr ga gb gd ge gf gg gh gi gl gm gn gp gq gr gs gt gu gw gy "
    "hk hm hn hr ht hu id ie il im in io iq ir is it je jm jo jp ke kg kh ki "
    "km kn kp kr krd kw ky kz la lb lc li lk lr ls lt lu lv ly ma mc md me "
    "mg mh mk ml mm mn mo mp mq mr ms mt mu mv mw mx my mz na nc ne nf ng ni "
    "nl no np nr nu nz om pa pe pf pg ph pk pl pm pn pr ps pt pw py qa re ro "
    "rs ru rw sa sb sc sd se sg sh si sj sk sl sm sn so sr ss st su sv sx sy "
    "sz tc td tf tg th tj tk tl tm tn to tp tr tt tv tw tz ua ug uk us uy uz "
    "va vc ve vg vi vn vu wf ws ye yt za zm zw".split()
) | {""}


def extract_subdomain(url: str) -> tuple[str, str, int, int]:
    """(domain, subdomain, subdomain_length, num_parts) —
    dns_pre_lda.scala:185-220.

    Reverse-DNS names (*.in-addr.arpa) and names with <= 2 parts keep
    domain/subdomain = "None".  A country-code TLD shifts the domain one
    label left (foo.co.uk -> domain "foo").
    """
    parts = url.split(".")
    # JVM String.split drops trailing empty strings ("a.b." -> [a, b]).
    while len(parts) > 1 and parts[-1] == "":
        parts.pop()
    n = len(parts)
    domain = "None"
    subdomain = "None"
    is_ip = n > 2 and parts[-1] == "arpa" and parts[-2] == "in-addr"
    if n > 2 and not is_ip:
        if parts[-1] in COUNTRY_CODES:
            domain = parts[-3]
            if n - 3 >= 1:
                subdomain = ".".join(parts[: n - 3])
        else:
            domain = parts[-2]
            subdomain = ".".join(parts[: n - 2])
    sub_len = len(subdomain) if subdomain != "None" else 0
    return domain, subdomain, sub_len, n


def shannon_entropy(s: str) -> float:
    """Character-level Shannon entropy in bits (dns_pre_lda.scala:278-284).
    entropy('') = 0; entropy of the literal 'None' placeholder = 2.0.

    The accumulation is an explicit Neumaier compensated sum — the same
    algorithm CPython 3.12+'s builtin sum() uses for floats — so the
    result is identical on every interpreter version AND bit-identical
    to the JAX package's native featurizer (which replicates this
    exact loop)."""
    if not s:
        return 0.0
    n = len(s)
    hi = comp = 0.0
    for c in Counter(s).values():
        p = c / n
        x = -(p) * math.log2(p)
        t = hi + x
        if abs(hi) >= abs(x):
            comp += (hi - t) + x
        else:
            comp += (x - t) + hi
        hi = t
    return hi + comp


def load_top_domains(path: str) -> frozenset[str]:
    """Alexa top-1m.csv -> set of base domain names: field 1 of each
    'rank,domain' line, truncated at its first dot
    (dns_pre_lda.scala:62-66): '1,google.com' -> 'google'."""
    out = set()
    with _open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            parts = line.split(",")
            if len(parts) > 1:
                out.add(parts[1].split(".")[0])
    return frozenset(out)


@dataclass
class DnsFeatures(PythonContainer):
    """Featurized day of DNS.  Scoring consumes `word` directly instead of
    re-featurizing (SURVEY §1)."""

    _PACKED = ("rows", "domain", "subdomain", "word")

    rows: list[list[str]]          # 8-col rows (incl. duplicated feedback)
    domain: list[str]
    subdomain: list[str]
    subdomain_length: np.ndarray   # [N] int
    num_periods: np.ndarray        # [N] int
    subdomain_entropy: np.ndarray  # [N] f64
    top_domain: np.ndarray         # [N] int (2 intel / 1 whitelisted / 0)
    word: list[str]
    # Events [num_raw_events:] are injected feedback duplicates: trained
    # on, never scored (the reference's post stage re-reads raw data only,
    # dns_post_lda.scala:108-116).
    num_raw_events: int = 0
    time_cuts: np.ndarray = field(default_factory=lambda: np.zeros(10))
    frame_length_cuts: np.ndarray = field(default_factory=lambda: np.zeros(10))
    subdomain_length_cuts: np.ndarray = field(default_factory=lambda: np.zeros(5))
    entropy_cuts: np.ndarray = field(default_factory=lambda: np.zeros(5))
    numperiods_cuts: np.ndarray = field(default_factory=lambda: np.zeros(5))

    @property
    def num_events(self) -> int:
        return len(self.rows)

    def client_ip(self, i: int) -> str:
        return self.rows[i][DNS_COLUMNS["ip_dst"]]

    def word_counts(self) -> list[tuple[str, str, int]]:
        """Per-client word counts keyed by ip_dst only
        (dns_pre_lda.scala:330), first-seen order."""
        agg: dict[tuple[str, str], int] = {}
        ip_col = DNS_COLUMNS["ip_dst"]
        for i, row in enumerate(self.rows):
            k = (row[ip_col], self.word[i])
            agg[k] = agg.get(k, 0) + 1
        return [(ip, w, c) for (ip, w), c in agg.items()]

    def featurized_row(self, i: int) -> list[str]:
        """Row as dns_post_lda sees it pre-scoring: 8 cols + domain,
        subdomain, subdomain.length, num.periods, subdomain.entropy,
        top_domain, word."""
        return self.rows[i] + [
            self.domain[i],
            self.subdomain[i],
            str(int(self.subdomain_length[i])),
            str(int(self.num_periods[i])),
            str(self.subdomain_entropy[i]),
            str(int(self.top_domain[i])),
            self.word[i],
        ]

    def event_indices(self, ip_index: dict, word_index: dict):
        """Model-row index arrays (client ip, word), int32, of every raw
        event; misses get the fallback row `len(index)`."""
        n = self.num_raw_events
        ip_col = DNS_COLUMNS["ip_dst"]
        return (
            index_rows(ip_index, [r[ip_col] for r in self.rows[:n]],
                       len(ip_index)),
            index_rows(word_index, self.word[:n], len(word_index)),
        )

    def results_rows(self, scores, order) -> "list[str]":
        """dns_results.csv's rows: those of `order`, each its 15
        featurized columns + score."""
        return [",".join(self.featurized_row(i) + [str(scores[i])])
                for i in order]

    def results_csv(self, scores, order) -> bytes:
        return csv_blob(self.results_rows(scores, order))


def featurize_dns(
    rows_in: Iterable[Sequence[str]],
    top_domains: frozenset[str] = frozenset(),
    feedback_rows: Sequence[Sequence[str]] = (),
    precomputed_cuts: "tuple | None" = None,
) -> DnsFeatures:
    """Full DNS featurization pass over 8-column rows (already projected
    from CSV/parquet by the caller; io side is runner's job).
    `feedback_rows` are pre-duplicated 8-column rows from feedback.py.

    `precomputed_cuts` = (time_cuts, frame_length_cuts,
    subdomain_length_cuts, entropy_cuts, numperiods_cuts) skips the
    in-pass ECDF (a serving micro-batch's own ECDF would assign other
    bins than the trained day's, unmapping its words from the model's
    vocabulary)."""
    rows = [list(r) for r in rows_in if len(r) == NUM_DNS_COLUMNS]
    num_raw_events = len(rows)
    rows += [list(r) for r in feedback_rows if len(r) == NUM_DNS_COLUMNS]
    c = DNS_COLUMNS

    domain: list[str] = []
    subdomain: list[str] = []
    sub_len = np.zeros(len(rows), dtype=np.int64)
    n_parts = np.zeros(len(rows), dtype=np.int64)
    entropy = np.zeros(len(rows), dtype=np.float64)
    for i, row in enumerate(rows):
        d, s, sl, np_ = extract_subdomain(row[c["dns_qry_name"]])
        domain.append(d)
        subdomain.append(s)
        sub_len[i] = sl
        n_parts[i] = np_
        entropy[i] = shannon_entropy(s)

    # NaN-defaulting like the flow featurizer: a single malformed field
    # (e.g. a null parquet cell surfaced as "") must not abort the day.
    tstamp = np.array(
        [_to_double(r[c["unix_tstamp"]]) for r in rows], dtype=np.float64
    ) if rows else np.zeros(0)
    frame_len = np.array(
        [_to_double(r[c["frame_len"]]) for r in rows], dtype=np.float64
    ) if rows else np.zeros(0)

    if precomputed_cuts is not None:
        (time_cuts, frame_length_cuts, subdomain_length_cuts,
         entropy_cuts, numperiods_cuts) = (
            np.asarray(x, dtype=np.float64) for x in precomputed_cuts
        )
    else:
        time_cuts = ecdf_cuts(tstamp, DECILES)
        frame_length_cuts = ecdf_cuts(frame_len, DECILES)
        # Quintile cuts over the strictly-positive subset
        # (dns_pre_lda.scala:298-305).
        subdomain_length_cuts = ecdf_cuts(sub_len[sub_len > 0], QUINTILES)
        entropy_cuts = ecdf_cuts(entropy[entropy > 0], QUINTILES)
        numperiods_cuts = ecdf_cuts(n_parts[n_parts > 0], QUINTILES)

    top = np.zeros(len(rows), dtype=np.int64)
    for i, d in enumerate(domain):
        top[i] = 2 if d == "intel" else (1 if d in top_domains else 0)

    if rows:
        b_len = bin_values(frame_len, frame_length_cuts)
        b_time = bin_values(tstamp, time_cuts)
        b_sub = bin_values(sub_len, subdomain_length_cuts)
        b_ent = bin_values(entropy, entropy_cuts)
        b_per = bin_values(n_parts, numperiods_cuts)
    else:
        b_len = b_time = b_sub = b_ent = b_per = np.zeros(0, dtype=np.int64)

    words = [
        f"{top[i]}_{b_len[i]}_{b_time[i]}_{b_sub[i]}_{b_ent[i]}_{b_per[i]}"
        f"_{rows[i][c['dns_qry_type']]}_{rows[i][c['dns_qry_rcode']]}"
        for i in range(len(rows))
    ]

    return DnsFeatures(
        rows=rows,
        domain=domain,
        subdomain=subdomain,
        subdomain_length=sub_len,
        num_periods=n_parts,
        subdomain_entropy=entropy,
        top_domain=top,
        word=words,
        time_cuts=time_cuts,
        frame_length_cuts=frame_length_cuts,
        subdomain_length_cuts=subdomain_length_cuts,
        entropy_cuts=entropy_cuts,
        numperiods_cuts=numperiods_cuts,
        num_raw_events=num_raw_events,
    )
