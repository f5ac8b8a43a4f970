"""Raw input reading for the flow day: path-spec expansion and a
buffered line reader (the pure-Python counterparts of the JAX
package's `features/native_flow.expand_flow_paths` and
`features/lineio.iter_raw_lines`)."""

from __future__ import annotations

import glob as _glob
import os
from itertools import chain
from typing import Iterator


def iter_raw_lines(path: str, chunk_size: int = 1 << 22) -> Iterator[str]:
    """Decoded lines of `path` without their '\\n', one trailing '\\r'
    stripped (CRLF); empty lines included (callers filter)."""
    with open(path, "rb") as f:
        pending = b""
        while True:
            chunk = f.read(chunk_size)
            if not chunk:
                break
            pending += chunk
            if b"\n" not in chunk:
                continue
            *lines, pending = pending.split(b"\n")
            for ln in lines:
                if ln.endswith(b"\r"):
                    ln = ln[:-1]
                yield ln.decode("utf-8", "surrogateescape")
        if pending:
            if pending.endswith(b"\r"):
                pending = pending[:-1]
            yield pending.decode("utf-8", "surrogateescape")


def expand_flow_paths(path: str) -> list[str]:
    """A flow input spec -> ordered list of concrete CSV paths.

    The spec is a comma-separated list whose pieces may be files,
    directories (every regular file inside, sorted) or globs (sorted
    expansion).  Listed order is kept: the first-seen id contract
    depends on event order.  Directory and glob expansion skips names
    starting with '_' or '.' (Spark's hidden-file filter)."""

    def visible(p: str) -> bool:
        return not os.path.basename(p).startswith(("_", "."))

    def expand_dir(d: str) -> list[str]:
        return [
            p for p in sorted(os.path.join(d, n) for n in os.listdir(d))
            if os.path.isfile(p) and visible(p)
        ]

    out: list[str] = []
    for piece in path.split(","):
        if not piece:
            continue
        if os.path.isdir(piece):
            out.extend(expand_dir(piece))
        elif _glob.has_magic(piece):
            deliberate = os.path.basename(piece).startswith(("_", "."))
            for p in sorted(_glob.glob(piece)):
                if not (visible(p) or deliberate):
                    continue
                if os.path.isdir(p):
                    out.extend(expand_dir(p))
                else:
                    out.append(p)
        else:
            out.append(piece)
    return out


def iter_flow_lines(path: str) -> Iterator[str]:
    """Every line of every file the spec names, in order.  The first
    line of the first file is the header (featurize_flow drops it and
    any later line equal to it)."""
    paths = expand_flow_paths(path)
    if not paths:
        raise OSError(f"no flow input files match {path!r}")
    return chain.from_iterable(iter_raw_lines(p) for p in paths)
