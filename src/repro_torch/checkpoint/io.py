"""Flat-array checkpoints in MessagePack, in the reference package's layout.

A checkpoint is one MessagePack map {name: {"dtype", "shape", "data"}}
with the names in sorted order — byte-compatible with the reference's
`checkpoint.io.save` of a flat dict, so either package reads what the
other wrote.  The encoding is the port's own (`checkpoint/packing.py`):
the `msgpack` package is not needed.

A model's parameters go through `save_params` / `load_params`: the port's
per-layer tree restacked into the reference's scanned segments
(`models.model_api.params_to_numpy`) and flattened under the reference's
path keys ("segments/0/0/attn/wq", dict keys and tuple indices joined by
"/"), so the file is the one `repro.checkpoint.io.save(path, params)`
writes for the same weights and each package loads the other's.
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


def _flatten(tree, prefix: str = ""):
    """{path key: leaf} of a tree of dicts and tuples, keys as the
    reference's `_path_key`."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(_flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _unflatten(flat: Dict[str, np.ndarray]):
    """The inverse of `_flatten`: a level whose keys are all indices
    0..n-1 is a tuple."""
    root: dict = {}
    for key, arr in flat.items():
        node = root
        *parents, last = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = arr

    def fix(node):
        if not isinstance(node, dict):
            return node
        node = {k: fix(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return tuple(node[str(i)] for i in range(len(node)))
        return node
    return fix(root)


def save_params(path: str, cfg, params, **kw) -> int:
    """Write a model's parameter tree in the reference's layout and keys
    (see the module docstring).  Returns bytes written; `kw` as `save`."""
    from repro_torch.models.model_api import params_to_numpy
    return save(path, _flatten(params_to_numpy(cfg, params)), **kw)


def load_params(path: str, cfg, like=None, device="cuda"):
    """A parameter tree from a checkpoint in the reference's layout (either
    package's), on `device`, or shaped, typed and placed as `like` (every
    leaf's shape checked against it)."""
    from repro_torch.models.model_api import params_from_numpy
    from repro_torch.common.module import leaves_with_names, unflatten
    if like is not None:
        device = leaves_with_names(like)[0][1].device
    tree = params_from_numpy(cfg, _unflatten(load_raw(path)), device=device)
    if like is None:
        return tree
    got = dict(leaves_with_names(tree))
    want = leaves_with_names(like)
    if set(got) != {name for name, _ in want}:
        raise KeyError(f"{path}: the checkpoint's parameters are not the "
                       "tree's")
    for name, b in want:
        if got[name].shape != b.shape:
            raise ValueError(f"{path}: {'/'.join(map(str, name))}: shape "
                             f"{tuple(got[name].shape)} != {tuple(b.shape)}")
    return unflatten(like, [got[name].to(b.dtype) for name, b in want])


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
