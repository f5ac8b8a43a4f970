"""Mmap-backed raw-line storage for the pre stage (port of
oni_ml_tpu/features/blob.py).

The featurizers keep every kept raw line so the scorer can re-emit the
original row of a flagged event.  The native featurizers stream those
lines to a spill file (raw_lines.bin in the day directory) during ingest
(native_src/flow_featurize.cpp ffz_set_spill, dns_featurize.cpp
dfz_set_spill), so the day's bytes never sit in RAM; MmapBlob reads them
back through the OS page cache, and a pickled container stores the
file's path and size, not its bytes.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np


class MmapBlob:
    """Read-only byte blob backed by a file via np.memmap: len(),
    slicing (returns bytes) and a C pointer for the native emitters.
    Pickles as its path and its size at spill time; the runner checks
    the size before it scores against the file again (a stale spill of
    another run would misalign every row offset)."""

    def __init__(self, path: str):
        self.path = path
        self.size: "int | None" = (
            os.path.getsize(path) if os.path.exists(path) else None)
        self._arr: "np.ndarray | None" = None

    def _a(self) -> np.ndarray:
        if self._arr is None:
            if os.path.getsize(self.path):
                self._arr = np.memmap(self.path, dtype=np.uint8, mode="r")
            else:
                self._arr = np.zeros(0, np.uint8)  # mmap rejects length 0
        return self._arr

    def __len__(self) -> int:
        return int(self._a().size)

    def __getitem__(self, key) -> bytes:
        return self._a()[key].tobytes()

    def as_c_char_p(self):
        """Address of the read-only mapping for ctypes (the emitters
        only read)."""
        a = self._a()
        if a.size == 0:
            return b""
        return a.ctypes.data_as(ctypes.c_char_p)

    def __getstate__(self):
        return {"path": self.path, "size": self.size}

    def __setstate__(self, state):
        self.path = state["path"]
        self.size = state.get("size")
        self._arr = None


def spill_bytes(blob: bytes, path: str) -> MmapBlob:
    """Write an in-memory blob to `path` and return its MmapBlob."""
    with open(path, "wb") as f:
        f.write(blob)
    return MmapBlob(path)
