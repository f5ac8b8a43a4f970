"""Labeled attack-scenario injection: the detection-quality ground truth
(port of oni_ml_tpu/sources/inject.py; the injected lines are the JAX
package's bytes).

`inject_scenarios` synthesizes a benign day through the source's
`synth_benign` hook, plants labeled attack events from the scenario
table into it, and returns the merged event-time-ordered day plus
per-line ground truth.  `QualityGate` (models/drift.py) evaluates every
publish candidate of the continuous service on a pinned injection suite
(sources/quality.QualitySuite) and vetoes recall regressions.

Everything is deterministic under the seed: the same seed gives the
same day and labels, byte for byte.  Scenarios are plain generator
functions registered per source: adding one is a table entry.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from . import registry


@dataclass
class InjectedDay:
    """One labeled injected day.  `lines[i]` is an attack event iff
    `labels[i]` is set; labels carry the scenario name and the attack
    entity (the document key flagged events join back on)."""

    source: str
    lines: "list[str]" = field(default_factory=list)
    labels: "list[dict | None]" = field(default_factory=list)
    manifest: dict = field(default_factory=dict)

    @property
    def attack_mask(self) -> np.ndarray:
        return np.array([lb is not None for lb in self.labels], bool)

    @property
    def n_attacks(self) -> int:
        return sum(lb is not None for lb in self.labels)

    def label_rows(self) -> "list[dict]":
        """Ground-truth JSONL rows: one per attack line, index into the
        emitted day file."""
        return [
            {"index": i, "scenario": lb["scenario"], "entity": lb["entity"]}
            for i, lb in enumerate(self.labels) if lb is not None
        ]


# -- scenario generators ------------------------------------------------------
# Each returns (lines, entity): attack CSV lines in the source's schema,
# and the attacking document key.  Counts are small (tens of events):
# attacks are rare against the benign day, which is what makes
# rank-based metrics meaningful.


def _beaconing(rng: np.random.Generator, n: int) -> "tuple[list[str], str]":
    """One client polling one C2 host on a high port at a fixed cadence
    with a fixed tiny payload: an implant's heartbeat."""
    sip, dip, port = "10.0.0.5", "203.0.113.77", 4444
    start = 9 * 3600
    lines = []
    for i in range(n):
        t = start + i * 600 + int(rng.integers(0, 5))
        h, m, s = t // 3600, (t // 60) % 60, t % 60
        lines.append(
            "2016-01-22 00:00:00,2016,1,22,"
            f"{h},{m},{s},0.0,{sip},{dip},"
            f"{int(rng.integers(40000, 60000))},{port},TCP,,0,0,"
            "2,118,0,0,0,0,0,0,0,0,0"
        )
    return lines, sip


def _port_scan(rng: np.random.Generator, n: int) -> "tuple[list[str], str]":
    """One source sweeping sequential ports on one target: single
    packets, minimal bytes, seconds apart."""
    sip, dip = "10.0.0.11", "10.1.0.250"
    start = 13 * 3600
    lines = []
    for i in range(n):
        t = start + i * 2
        h, m, s = t // 3600, (t // 60) % 60, t % 60
        lines.append(
            "2016-01-22 00:00:00,2016,1,22,"
            f"{h},{m},{s},0.0,{sip},{dip},"
            f"{int(rng.integers(40000, 60000))},{1 + i},TCP,,0,0,"
            "1,40,0,0,0,0,0,0,0,0,0"
        )
    return lines, sip


def _exfil_burst(rng: np.random.Generator, n: int) -> "tuple[list[str], str]":
    """One client shoving outsized payloads at one external IP over a
    nonstandard high port in a tight late-night burst.  The high port
    matters to the featurizer: decile bins top-code, so exfil volume
    lands in the same top bin as benign bulk transfers; it is the
    ephemeral-to-ephemeral port pattern (p_case 3) that benign service
    traffic never produces."""
    sip, dip = "10.0.0.19", "198.51.100.9"
    start = 23 * 3600 + 1800
    lines = []
    for i in range(n):
        t = start + i * 20 + int(rng.integers(0, 10))
        h, m, s = t // 3600, (t // 60) % 60, t % 60
        lines.append(
            "2016-01-22 00:00:00,2016,1,22,"
            f"{h},{m},{s},0.0,{sip},{dip},"
            f"{int(rng.integers(40000, 60000))},8443,TCP,,0,0,"
            f"{int(rng.integers(5000, 9000))},"
            f"{int(rng.integers(50_000_000, 90_000_000))},"
            "0,0,0,0,0,0,0,0,0"
        )
    return lines, sip


def _dns_tunneling(rng: np.random.Generator,
                   n: int) -> "tuple[list[str], str]":
    """One client issuing TXT queries for long high-entropy subdomains
    of a single domain: data riding the query names."""
    cli = "172.16.0.7"
    alphabet = np.array(list("abcdefghijklmnopqrstuvwxyz0123456789"))
    lines = []
    for i in range(n):
        ts = 1454050000 + i * 30 + int(rng.integers(0, 9))
        sub = "".join(rng.choice(alphabet, size=40))
        lines.append(
            f"t,{ts},{int(rng.integers(200, 400))},{cli},"
            f"{sub}.tunnel.example,1,16,0"
        )
    return lines, cli


def _proxy_c2_polling(rng: np.random.Generator,
                      n: int) -> "tuple[list[str], str]":
    """One client POSTing to a rare high-entropy host at a fixed cadence
    with a fixed tiny response: HTTP beaconing through the proxy."""
    cli = "10.2.0.7"
    host = "x7k2q9zj4w8v.badcdn.example"
    lines = []
    for i in range(n):
        t = 9 * 3600 + i * 300 + int(rng.integers(0, 4))
        h, m, s = t // 3600, (t // 60) % 60, t % 60
        lines.append(
            "2016-01-22,"
            f"{h:02d}:{m:02d}:{s:02d},{cli},{host},POST,"
            f"{404 if int(rng.integers(0, 2)) else 200},"
            f"{int(rng.integers(3, 8))},"
            f"{128 + int(rng.integers(0, 4))},"
            f"{512 + int(rng.integers(0, 8))},"
            "curl/7.1"
        )
    return lines, cli


#: scenario name -> (source name, generator).  The per-source view is
#: `scenarios_for(source)`.
SCENARIOS: "dict[str, tuple[str, object]]" = {
    "beaconing": ("flow", _beaconing),
    "port_scan": ("flow", _port_scan),
    "exfil_burst": ("flow", _exfil_burst),
    "dns_tunneling": ("dns", _dns_tunneling),
    "proxy_c2_polling": ("proxy", _proxy_c2_polling),
}


def scenarios_for(source: str) -> "tuple[str, ...]":
    return tuple(
        name for name, (src, _) in SCENARIOS.items() if src == source
    )


def inject_scenarios(source: str, *, n_events: int = 600, seed: int = 7,
                     scenarios: "tuple[str, ...] | None" = None,
                     attack_events: int = 24) -> InjectedDay:
    """Synthesize a benign day and plant labeled attacks into it.

    Deterministic under (source, n_events, seed, scenarios,
    attack_events).  The merged day is event-time ordered with a stable
    tiebreak, so it replays through `slice_events` exactly as emitted."""
    spec = registry.get(source)
    if scenarios is None:
        scenarios = scenarios_for(source)
    for name in scenarios:
        if name not in SCENARIOS or SCENARIOS[name][0] != source:
            raise ValueError(
                f"scenario {name!r} is not defined for source "
                f"{source!r} (available: {scenarios_for(source)})"
            )
    rng = np.random.default_rng(seed)
    tagged: "list[tuple[str, dict | None]]" = [
        (ln, None) for ln in spec.synth_benign(n_events, seed)
    ]
    for name in scenarios:
        lines, entity = SCENARIOS[name][1](rng, attack_events)
        tagged.extend(
            (ln, {"scenario": name, "entity": entity}) for ln in lines
        )
    order = sorted(
        range(len(tagged)),
        key=lambda i: (spec.event_time_s(tagged[i][0]), i),
    )
    day = InjectedDay(source=source)
    day.lines = [tagged[i][0] for i in order]
    day.labels = [tagged[i][1] for i in order]
    # The manifest doubles as the {"kind": "injection"} journal record
    # the continuous service writes when it builds its quality suite.
    day.manifest = {
        "kind": "injection",
        "source": source,
        "scenarios": list(scenarios),
        "events": len(day.lines),
        "attacks": day.n_attacks,
        "attack_events": attack_events,
        "seed": seed,
    }
    return day
