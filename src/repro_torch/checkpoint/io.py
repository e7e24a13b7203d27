"""Flat-array checkpoints in MessagePack, in the reference package's layout.

A checkpoint is one MessagePack map {name: {"dtype", "shape", "data"}}
with the names in sorted order — byte-compatible with the reference's
`checkpoint.io.save` of a flat dict, so either package reads what the
other wrote.  The encoding is the port's own (`checkpoint/packing.py`):
the `msgpack` package is not needed.
"""
from __future__ import annotations

import os
from typing import Dict

import numpy as np

from repro_torch.checkpoint import faults, packing


def save(path: str, arrays: Dict[str, np.ndarray], *, atomic: bool = False,
         fsync: bool = False) -> int:
    """Write a flat {name: ndarray} dict.  Returns bytes written.

    `atomic=True` routes through `checkpoint.wal.atomic_write_bytes` (tmp
    + fsync + rename + directory fsync), so readers and crash recovery
    only ever see a complete checkpoint under `path`; it implies `fsync`.
    Plain `fsync=True` flushes an in-place write to stable storage and
    fsyncs the parent directory too — a freshly created file whose
    directory entry is not flushed can vanish on power loss even though
    its own fd was fsync'd.  Every write goes through `faults.active()`."""
    entries = {}
    for key in sorted(arrays):
        arr = np.asarray(arrays[key])
        # the array's bytes in C order, handed to the packer uncopied
        data = np.ascontiguousarray(arr).reshape(-1).view(np.uint8)
        entries[key] = {"dtype": arr.dtype.str, "shape": list(arr.shape),
                        "data": memoryview(data)}
    blob = packing.packb(entries)
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    if atomic:
        from repro_torch.checkpoint.wal import atomic_write_bytes
        atomic_write_bytes(path, blob)
        return len(blob)
    faults.active().write_file(path, blob, fsync=fsync)
    if fsync:
        faults.active().fsync_dir(parent)
    return len(blob)


def load_raw(path: str) -> Dict[str, np.ndarray]:
    """Load a checkpoint as a flat {name: np.ndarray} dict (writable
    copies); the entries are self-describing (dtype + shape)."""
    with open(path, "rb") as f:
        entries = packing.unpackb(f.read())
    out = {}
    for key, e in entries.items():
        arr = np.frombuffer(e["data"], dtype=np.dtype(e["dtype"]))
        out[key] = arr.reshape(e["shape"]).copy()
    return out
