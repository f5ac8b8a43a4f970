"""Declarative event sources: specs and the registry (port of
oni_ml_tpu/sources/, the batch-day parts).

Importing this package registers the built-in sources, in this order:
flow and dns (wrappers over features/flow.py and features/dns.py) and
proxy (a declarative TableSourceSpec), so the runner resolves every day
through `sources.get(name)` / `sources.names()`.
"""

from .builtin import DnsSource, FlowSource
from .generic import (
    CutDef,
    FieldDef,
    GenericFeatures,
    ProxySource,
    TableSourceSpec,
)
from .registry import get, names, register, spec_for_features
from .spec import SourceSpec

register(FlowSource())
register(DnsSource())
register(ProxySource())

__all__ = [
    "CutDef",
    "DnsSource",
    "FieldDef",
    "FlowSource",
    "GenericFeatures",
    "ProxySource",
    "SourceSpec",
    "TableSourceSpec",
    "get",
    "names",
    "register",
    "spec_for_features",
]
