"""Flat-array checkpoints via msgpack, in the reference package's layout.

A checkpoint is one msgpack map {name: {"dtype", "shape", "data"}} with
the names in sorted order — byte-compatible with the reference's
`checkpoint.io.save` of a flat dict, so either package reads what the
other wrote.  `msgpack` is imported inside the functions: the package (and
the GPU smoke test) import without it.
"""
from __future__ import annotations

import os
from typing import Dict

import numpy as np


def save(path: str, arrays: Dict[str, np.ndarray], *,
         fsync: bool = False) -> int:
    """Write a flat {name: ndarray} dict.  Returns bytes written.  With
    `fsync` the file and its parent directory are flushed to storage."""
    import msgpack
    entries = {}
    for key in sorted(arrays):
        arr = np.asarray(arrays[key])
        entries[key] = {"dtype": arr.dtype.str, "shape": list(arr.shape),
                        "data": arr.tobytes()}
    blob = msgpack.packb(entries, use_bin_type=True)
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    with open(path, "wb") as f:
        f.write(blob)
        if fsync:
            f.flush()
            os.fsync(f.fileno())
    if fsync:
        fd = os.open(parent, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
    return len(blob)


def load_raw(path: str) -> Dict[str, np.ndarray]:
    """Load a checkpoint as a flat {name: np.ndarray} dict (writable
    copies); the entries are self-describing (dtype + shape)."""
    import msgpack
    with open(path, "rb") as f:
        entries = msgpack.unpackb(f.read(), raw=False)
    out = {}
    for key, e in entries.items():
        arr = np.frombuffer(e["data"], dtype=np.dtype(e["dtype"]))
        out[key] = arr.reshape(e["shape"]).copy()
    return out
