"""The event-source contract the runner resolves through (port of
oni_ml_tpu/sources/spec.py, the batch-day hooks).

A *source* is one raw event schema (netflow, DNS, proxy/HTTP) plus what
the batch day needs to turn its CSV lines into scored output: the
featurizer, the feedback rows, the input paths, the scorer and its
unseen-key fallback, and a synthetic benign-day generator.  The runner
asks the registry (sources/registry.py) for a `SourceSpec` and calls its
hooks instead of branching on ``dsource``.

Two spec families implement it: `builtin.FlowSource` /
`builtin.DnsSource`, which delegate to features/flow.py and
features/dns.py, and `generic.TableSourceSpec`, a declarative spec
(fields, cut strategies, word template); the proxy source is one.

The serving hooks (`cuts_of`, `event_featurizer`, `event_pairs`,
`event_documents`, `event_indices`) let `ml_ops serve` featurize and
score micro-batches with the trained day's cuts; the continuous service
(`ml_ops continuous`) also pins its stream's cuts with `derive_cuts`
and orders raw lines into event-time slices with `event_time_s`.
"""

from __future__ import annotations

from typing import Iterable, Sequence

import numpy as np


class SourceSpec:
    """Abstract event-source declaration: subclasses set the class
    attributes and override the hooks."""

    #: registry key; also the ``dsource`` value on the command line.
    name: str = ""
    #: exact CSV column count a valid event must have.
    num_columns: int = 0
    #: documents each event feeds: 2 = flow (both endpoints, scores
    #: min-combined), 1 = client-keyed sources (dns, proxy).
    pairs_per_event: int = 1
    #: an always-numeric column: probing it on the first line of a
    #: stream detects a header.
    header_probe_col: int = 0

    # -- featurization ----------------------------------------------------

    def featurize(self, events: Iterable, *, precomputed_cuts=None,
                  skip_header: bool = False, feedback_rows: Sequence = (),
                  top_domains: frozenset = frozenset()):
        """Raw CSV lines (or pre-split rows) -> feature container."""
        raise NotImplementedError

    def featurize_day(self, config, spill_path=None, workers=1,
                      timings=None):
        """The pre stage: (features, feedback_rows) for a whole day.
        `spill_path`, `workers` and `timings` serve the native featurizers
        (flow and DNS); a source with none featurizes in Python and says
        so in `timings`."""
        if timings is not None:
            timings["pre_engine"] = "python"
        fb_rows = self.feedback_rows(config)
        lines = self.read_input(self.input_path(config))
        feats = self.featurize(
            lines, skip_header=True, feedback_rows=fb_rows,
            top_domains=self.top_domains(config),
        )
        return feats, fb_rows

    def feedback_rows(self, config) -> Sequence:
        """Analyst-feedback duplicates appended to the training rows
        (flow/dns read <dsource>_scores.csv; default: none)."""
        return ()

    def matches_features(self, features) -> bool:
        """Does this container belong to this source?"""
        return False

    # -- serving ----------------------------------------------------------

    def cuts_of(self, features) -> tuple:
        """The quantile cuts a feature container was binned with (every
        container, native or Python, carries them)."""
        raise NotImplementedError

    def derive_cuts(self, lines: Sequence[str],
                    qtiles_path: str = "") -> tuple:
        """Bootstrap cuts for the continuous service: from a qtiles file
        when the source supports one, else the slice's own ECDF.

        Memoized on the spec (registry specs are singletons): the ECDF
        featurize pass runs once per distinct (line digest, qtiles
        path), and repeat callers pay a hash.  The returned tuple is
        shared and must be treated as immutable."""
        lines = (lines if isinstance(lines, (list, tuple))
                 else list(lines))
        key = self._cuts_memo_key(lines, qtiles_path)
        cache = self.__dict__.setdefault("_derived_cuts", {})
        cuts = cache.get(key)
        if cuts is None:
            cuts = self._derive_cuts_uncached(lines, qtiles_path)
            while len(cache) >= 8:   # a handful of live days, bounded
                cache.pop(next(iter(cache)))
            cache[key] = cuts
        return cuts

    def _cuts_memo_key(self, lines: Sequence, qtiles_path: str) -> str:
        import hashlib

        h = hashlib.blake2b(digest_size=16)
        for ln in lines:
            h.update(ln.encode() if isinstance(ln, str)
                     else repr(ln).encode())
            h.update(b"\n")
        h.update(qtiles_path.encode())
        return h.hexdigest()

    def _derive_cuts_uncached(self, lines: Sequence[str],
                              qtiles_path: str = "") -> tuple:
        """One ECDF featurize pass over the slice (a qtiles path is
        honoured by the sources that support a cut file: flow)."""
        return self.cuts_of(self.featurize(lines, skip_header=False))

    def event_featurizer(self, cuts: tuple,
                         top_domains: frozenset = frozenset()):
        """Serving-side featurizer (validate + __call__) pinned to the
        trained day's cuts; carries ``dsource == self.name``."""
        raise NotImplementedError

    def event_time_s(self, line: str) -> float:
        """Event time in seconds (of day, or epoch: only ordering and
        deltas matter) for slice assignment.  Raises on garbage."""
        raise NotImplementedError

    def event_pairs(self, feats) -> "list[tuple[list[str], list[str]]]":
        """The (document keys, words) blocks of one featurized batch, one
        lookup per raw event in each block; block scores min-combine
        into the event's score."""
        raise NotImplementedError

    def event_documents(self, feats) -> "tuple[list[str], list[str]]":
        """Every (ip, word) training pair a batch gives the online
        refresh: the blocks of event_pairs, concatenated (the corpus
        stage's mapping: flow feeds both endpoints' documents, src block
        then dest block)."""
        ips: "list[str]" = []
        words: "list[str]" = []
        for keys, ws in self.event_pairs(feats):
            ips.extend(keys)
            words.extend(ws)
        return ips, words

    def event_indices(self, features, ip_index: dict,
                      word_index: dict) -> tuple:
        """Model-row index arrays of every raw event, int32, for the
        scoring core: ``2 * pairs_per_event`` arrays (key, word per
        block); misses map to the fallback row ``len(index)``.  The
        feature containers own the mapping (features/container.py)."""
        return features.event_indices(ip_index, word_index)

    # -- scoring ----------------------------------------------------------

    def score_csv(self, features, model, threshold: float, engine=None,
                  chunk=None, stats=None, device=None,
                  prep=None, mesh=None) -> "tuple[bytes, np.ndarray]":
        """The score stage: (results CSV bytes, ascending kept scores).
        `engine` picks the host or device scorer (scoring.score
        scored_events); `chunk`, `stats`, `device` and `mesh` (the run's
        mesh: the device pipeline over its data slots) drive and
        instrument the device pipeline; `prep` is the dataplane's
        ScoringPrep of the day (scoring.score.prep_indices)."""
        raise NotImplementedError

    def fallback(self, scoring_cfg) -> float:
        """The unseen-ip/word fallback probability for this source."""
        return getattr(scoring_cfg, f"{self.name}_fallback")

    # -- input plumbing ---------------------------------------------------

    def input_path(self, config) -> str:
        return getattr(config, f"{self.name}_path", "")

    def top_domains(self, config) -> frozenset:
        return frozenset()

    def read_input(self, path: str) -> Iterable[str]:
        """Input spec -> raw CSV lines (comma lists / dirs / globs, the
        forms of features.lineio.expand_flow_paths)."""
        from ..features.lineio import expand_flow_paths

        paths = expand_flow_paths(path)
        if not paths:
            raise OSError(f"no {self.name} input files match {path!r}")
        for p in paths:
            with open(p) as f:
                yield from f

    # -- synthetic days ---------------------------------------------------

    def synth_benign(self, n_events: int, seed: int) -> "list[str]":
        """A deterministic synthetic benign day (raw CSV lines, event-
        time ordered)."""
        raise NotImplementedError
