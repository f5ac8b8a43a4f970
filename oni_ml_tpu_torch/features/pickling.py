"""A compact pickled form for the featurized days (features.pkl).

A 2M-event day holds tens of millions of short strings (the raw rows'
fields and the per-event words).  Pickled one by one, each costs a memo
entry and an opcode, and the dump holds the GIL for seconds.  Packed,
each string list is one NUL-joined string (with the row lengths for a
list of rows): pickling it is one copy, and loading it one split.  A
list in which a string holds NUL pickles as it is, so every day round
trips to equal lists.

The native containers (native_flow.NativeFlowFeatures,
native_dns.NativeDnsFeatures) hold numpy arrays and interned tables, and
their raw rows in the spill file: they pickle that file's path and size
(blob.MmapBlob), not its bytes.
"""

from __future__ import annotations

from itertools import chain

import numpy as np

SEP = "\x00"


class _Packed:
    """A packed list of strings (`lens` None) or of rows of strings."""

    __slots__ = ("flat", "lens", "n")

    def __init__(self, flat: str, lens, n: int) -> None:
        self.flat, self.lens, self.n = flat, lens, n

    def __getstate__(self):
        return self.flat, self.lens, self.n

    def __setstate__(self, state) -> None:
        self.flat, self.lens, self.n = state


def pack(value: list):
    """A list of strings or of lists of strings -> its packed form, or
    the list itself when it is empty or a string holds SEP."""
    if not value:
        return value
    lens = None
    if isinstance(value[0], list):
        lens = np.fromiter(map(len, value), np.int64, len(value))
        n = int(lens.sum())
        flat = SEP.join(chain.from_iterable(value))
    else:
        n = len(value)
        flat = SEP.join(value)
    if n == 0 or flat.count(SEP) != n - 1:
        return value
    return _Packed(flat, lens, n)


def unpack(value):
    """Inverse of pack: the equal list."""
    if not isinstance(value, _Packed):
        return value
    fields = value.flat.split(SEP)
    lens = value.lens
    if lens is None:
        return fields
    if (lens == lens[0]).all():
        w = int(lens[0])
        return [fields[i:i + w] for i in range(0, value.n, w)]
    ends = np.cumsum(lens).tolist()
    return [fields[a:b] for a, b in zip([0] + ends[:-1], ends)]


class PackedPickle:
    """Mixin: pickle the attributes named in `_PACKED` packed."""

    _PACKED: tuple = ()

    def __getstate__(self):
        state = dict(self.__dict__)
        for name in self._PACKED:
            state[name] = pack(state[name])
        return state

    def __setstate__(self, state) -> None:
        self.__dict__.update(
            {k: unpack(v) if k in self._PACKED else v
             for k, v in state.items()})
