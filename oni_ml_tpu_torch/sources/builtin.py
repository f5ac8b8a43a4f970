"""Flow and DNS as registered SourceSpecs (port of
oni_ml_tpu/sources/builtin.py).

These specs own no featurization logic: every hook delegates to
features/flow.py, features/dns.py and scoring/score.py, so words,
word counts and scores stay byte-identical to those modules' (and to
the JAX package's).  The pre stage (`featurize_day`) runs the native C++
featurizers (features/native_flow.py, native_dns.py): raw rows stream to
the spill file, and the passes shard over the pre workers;
ONI_ML_TPU_NO_NATIVE=1 runs the pure-Python featurizers, whose bytes are
the same.
"""

from __future__ import annotations

import os
from typing import Iterable, Sequence

import numpy as np

from .spec import SourceSpec


def _split_rows(events: Iterable) -> "list[list[str]]":
    return [e.strip().split(",") if isinstance(e, str) else list(e)
            for e in events]


class FlowSource(SourceSpec):
    """27-column netflow (features/flow.py): both endpoints become
    documents and an event's score is min(src, dest) dot."""

    name = "flow"
    header_probe_col = 4       # hour: numeric on every data row
    pairs_per_event = 2

    def __init__(self) -> None:
        from ..features.flow import NUM_FLOW_COLUMNS

        self.num_columns = NUM_FLOW_COLUMNS

    def featurize(self, events, *, precomputed_cuts=None,
                  skip_header=False, feedback_rows=(),
                  top_domains=frozenset()):
        from ..features.flow import featurize_flow

        return featurize_flow(
            events, feedback_rows=feedback_rows, skip_header=skip_header,
            precomputed_cuts=precomputed_cuts,
        )

    def featurize_day(self, config, spill_path=None, workers=1,
                      timings=None):
        """The whole day through features/native_flow.featurize_flow_file,
        cut at the --qtiles file's cuts when one is configured."""
        from ..features.native_flow import featurize_flow_file

        fb_rows = self.feedback_rows(config)
        features = featurize_flow_file(
            config.flow_path, feedback_rows=fb_rows,
            precomputed_cuts=self.qtiles_cuts(config),
            spill_path=spill_path, workers=workers, timings=timings)
        return features, fb_rows

    def qtiles_cuts(self, config):
        """(time, ibyt, ipkt) cuts of config.qtiles_path, or None."""
        if not config.qtiles_path:
            return None
        from ..features.qtiles import read_flow_qtiles

        return read_flow_qtiles(config.qtiles_path)

    def feedback_rows(self, config) -> Sequence:
        from ..features.feedback import read_flow_feedback_rows

        fb = config.feedback
        return read_flow_feedback_rows(
            os.path.join(config.data_dir, "flow_scores.csv"),
            fb.dup_factor, fb.nonthreatening_severity,
        )

    def matches_features(self, features) -> bool:
        return hasattr(features, "ibyt_cuts")

    def cuts_of(self, features) -> tuple:
        return (features.time_cuts, features.ibyt_cuts,
                features.ipkt_cuts)

    def _derive_cuts_uncached(self, lines, qtiles_path=""):
        if qtiles_path:
            from ..features.qtiles import read_flow_qtiles

            return read_flow_qtiles(qtiles_path)
        return self.cuts_of(self.featurize(lines))

    def event_featurizer(self, cuts, top_domains=frozenset()):
        from ..serving.events import FlowEventFeaturizer

        return FlowEventFeaturizer(cuts)

    def event_time_s(self, line: str) -> float:
        return _flow_time_s(line)

    def event_pairs(self, feats):
        from ..features.flow import FLOW_COLUMNS

        n = feats.num_raw_events
        # The Python container's rows, column-sliced (the instance dict:
        # a native container's `rows` is a property that splits every
        # row); else one lookup per event.
        rows = feats.__dict__.get("rows")
        if rows is not None:
            s_col, d_col = FLOW_COLUMNS["sip"], FLOW_COLUMNS["dip"]
            sips = [r[s_col] for r in rows[:n]]
            dips = [r[d_col] for r in rows[:n]]
        else:
            sips = [feats.sip(i) for i in range(n)]
            dips = [feats.dip(i) for i in range(n)]
        return [(sips, list(feats.src_word[:n])),
                (dips, list(feats.dest_word[:n]))]

    def score_csv(self, features, model, threshold, engine=None,
                  chunk=None, stats=None, device=None, prep=None,
                  mesh=None):
        from ..scoring.score import score_flow_csv

        return score_flow_csv(features, model, threshold, engine=engine,
                              chunk=chunk, stats=stats, device=device,
                              prep=prep, mesh=mesh)

    def synth_benign(self, n_events: int, seed: int) -> "list[str]":
        """Office-hours netflow to a small service mix.  Packet/byte
        volumes draw from a few discrete modes (handshake / page / bulk),
        not continuous ranges: machine traffic is regular, and that
        regularity is what lets rare behavior rank low."""
        rng = np.random.default_rng(seed)
        svc = (80, 443, 22, 53)
        ipkt_modes = (2, 10, 60)
        ibyt_modes = (120, 1460, 64000)
        lines = []
        for _ in range(n_events):
            h = int(rng.integers(8, 18))
            m = int(rng.integers(0, 3))
            lines.append(
                "2016-01-22 00:00:00,2016,1,22,"
                f"{h},{int(rng.integers(0, 60))},"
                f"{int(rng.integers(0, 60))},0.0,"
                f"10.0.0.{int(rng.integers(0, 32))},"
                f"10.1.0.{int(rng.integers(0, 16))},"
                f"{int(rng.integers(1024, 60000))},"
                f"{svc[int(rng.integers(0, len(svc)))]},TCP,,0,0,"
                f"{ipkt_modes[m]},{ibyt_modes[m]},0,0,0,0,0,0,0,0,0"
            )
        lines.sort(key=_flow_time_s)
        return lines


def _flow_time_s(line: str) -> float:
    parts = line.split(",")
    return float(parts[4]) * 3600.0 + float(parts[5]) * 60.0 + float(parts[6])


class DnsSource(SourceSpec):
    """8-column DNS (features/dns.py): the querying client is the one
    document per event."""

    name = "dns"
    header_probe_col = 1       # unix_tstamp

    def __init__(self) -> None:
        from ..features.dns import NUM_DNS_COLUMNS

        self.num_columns = NUM_DNS_COLUMNS

    def featurize(self, events, *, precomputed_cuts=None,
                  skip_header=False, feedback_rows=(),
                  top_domains=frozenset()):
        from ..features.dns import featurize_dns

        rows = _split_rows(events)
        if skip_header and rows:
            try:
                float(rows[0][self.header_probe_col])
            except (ValueError, IndexError):
                rows = rows[1:]
        return featurize_dns(
            rows, top_domains=top_domains, feedback_rows=feedback_rows,
            precomputed_cuts=precomputed_cuts,
        )

    def featurize_day(self, config, spill_path=None, workers=1,
                      timings=None):
        """Every event of `_dns_sources`' paths, in order, through
        features/native_dns.featurize_dns_sources."""
        from ..features.native_dns import featurize_dns_sources

        fb_rows = self.feedback_rows(config)
        features = featurize_dns_sources(
            _dns_sources(config.dns_path),
            top_domains=self.top_domains(config), feedback_rows=fb_rows,
            spill_path=spill_path, workers=workers, timings=timings)
        return features, fb_rows

    def feedback_rows(self, config) -> Sequence:
        from ..features.feedback import read_dns_feedback_rows

        fb = config.feedback
        return read_dns_feedback_rows(
            os.path.join(config.data_dir, "dns_scores.csv"),
            fb.dup_factor, fb.nonthreatening_severity,
        )

    def matches_features(self, features) -> bool:
        return hasattr(features, "entropy_cuts")

    def cuts_of(self, features) -> tuple:
        return (features.time_cuts, features.frame_length_cuts,
                features.subdomain_length_cuts, features.entropy_cuts,
                features.numperiods_cuts)

    def event_featurizer(self, cuts, top_domains=frozenset()):
        from ..serving.events import DnsEventFeaturizer

        return DnsEventFeaturizer(cuts, top_domains=top_domains)

    def event_time_s(self, line: str) -> float:
        return float(line.split(",")[1])

    def event_pairs(self, feats):
        from ..features.dns import DNS_COLUMNS

        n = feats.num_raw_events
        rows = feats.__dict__.get("rows")
        if rows is not None:
            col = DNS_COLUMNS["ip_dst"]
            clients = [r[col] for r in rows[:n]]
        else:
            clients = [feats.client_ip(i) for i in range(n)]
        return [(clients, list(feats.word[:n]))]

    def score_csv(self, features, model, threshold, engine=None,
                  chunk=None, stats=None, device=None, prep=None,
                  mesh=None):
        from ..scoring.score import score_dns_csv

        return score_dns_csv(features, model, threshold, engine=engine,
                             chunk=chunk, stats=stats, device=device,
                             prep=prep, mesh=mesh)

    def top_domains(self, config) -> frozenset:
        if not config.top_domains_path:
            return frozenset()
        from ..features.dns import load_top_domains

        return load_top_domains(config.top_domains_path)

    def synth_benign(self, n_events: int, seed: int) -> "list[str]":
        """Regular client lookups of a small host set with discrete
        frame-length modes (see FlowSource.synth_benign on why benign
        values are modal)."""
        rng = np.random.default_rng(seed)
        hosts = ("www", "mail", "docs", "cdn", "api", "news")
        flen_modes = (60, 128, 512)
        lines = []
        for _ in range(n_events):
            ts = int(rng.integers(1454050000, 1454086400))
            cli = int(rng.integers(0, 24))
            lines.append(
                f"t,{ts},{flen_modes[int(rng.integers(0, 3))]},"
                f"172.16.0.{cli},"
                f"{hosts[int(rng.integers(0, len(hosts)))]}.example.com,"
                "1,1,0"
            )
        lines.sort(key=lambda line: float(line.split(",")[1]))
        return lines


def _dns_sources(path: str) -> list:
    """DNS input spec -> ordered featurizer sources: CSV paths stay
    paths; parquet files become pre-projected row lists (the reference
    reads Hive parquet, dns_pre_lda.scala:142).  The spec takes the same
    forms as FLOW_PATH (comma list, directories, globs) and keeps their
    order: the first-seen id contract depends on event order.  An empty
    expansion raises rather than producing an empty day."""
    from ..features.lineio import expand_flow_paths

    paths = expand_flow_paths(path)
    if not paths:
        raise OSError(f"no DNS input files match {path!r}")
    return [
        _read_parquet_rows(p) if p.endswith(".parquet") else p
        for p in paths
    ]


def _read_parquet_rows(path: str) -> "list[list[str]]":
    cols = [
        "frame_time", "unix_tstamp", "frame_len", "ip_dst", "dns_qry_name",
        "dns_qry_class", "dns_qry_type", "dns_qry_rcode",
    ]
    try:
        import pyarrow.parquet as pq  # optional

        table = pq.read_table(path, columns=cols)
        arrays = [table.column(c).to_pylist() for c in cols]
    except ImportError as e:
        raise RuntimeError(
            f"parquet input {path} requires pyarrow, which is unavailable; "
            "convert to CSV with the 8 DNS columns instead"
        ) from e
    return [
        [str(v) if v is not None else "" for v in row] for row in zip(*arrays)
    ]
