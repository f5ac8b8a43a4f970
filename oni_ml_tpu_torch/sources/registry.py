"""The source registry: name -> SourceSpec (port of
oni_ml_tpu/sources/registry.py).  Registering a spec is the whole act
of adding a source: the runner takes its `dsource` choices from
``names()``."""

from __future__ import annotations

from .spec import SourceSpec

_REGISTRY: "dict[str, SourceSpec]" = {}


def register(spec: SourceSpec, replace: bool = False) -> SourceSpec:
    """Register a spec under its name.  Duplicate names fail loudly
    unless ``replace``: two specs answering one dsource would split word
    identity silently."""
    if not spec.name:
        raise ValueError("source spec has no name")
    if spec.name in _REGISTRY and not replace:
        raise ValueError(
            f"source {spec.name!r} already registered "
            f"(known: {', '.join(names())})"
        )
    _REGISTRY[spec.name] = spec
    return spec


def get(name: str) -> SourceSpec:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown source {name!r} (registered: {', '.join(names())})"
        ) from None


def names() -> "tuple[str, ...]":
    """Registered source names, in registration order (flow and dns
    first)."""
    return tuple(_REGISTRY)


def spec_for_features(features,
                      top_domains: frozenset = frozenset()) -> SourceSpec:
    """The spec owning a feature container (a loaded features.pkl; each
    spec recognizes its own containers, native or Python).
    `top_domains` is accepted for the JAX package's signature and not
    read: no spec's recognition depends on it."""
    for spec in _REGISTRY.values():
        if spec.matches_features(features):
            return spec
    raise TypeError(
        f"{type(features).__name__} matches no registered source "
        f"(registered: {', '.join(names())})"
    )
