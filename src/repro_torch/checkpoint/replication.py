"""Opening a data directory's write-ahead log.

A data directory is either one plain `WriteAheadLog` or the reference
package's sharded layout (`shard-NN/` subdirectories with per-shard logs
behind a coordinator log).  This slice of the port opens the plain layout
and recognises the sharded one only to refuse it: `ShardedWal`, segment
shipping to a follower and the follower restore come with the sharding
slice of the port.
"""
from __future__ import annotations

import os
import re
from typing import Optional

from repro_torch.checkpoint.wal import WriteAheadLog

SHARD_DIR_RE = re.compile(r"^shard-(\d{2})$")
_SLICE_SHARDING = "the sharding slice of the port"


def detect_shards(dirpath: str) -> int:
    """Shard count a data directory was written with (0 = unsharded), from
    its `shard-NN/` subdirectories.  A gap in the numbering means lost
    shard logs — refuse to guess."""
    if not os.path.isdir(dirpath):
        return 0
    found = []
    for name in os.listdir(dirpath):
        m = SHARD_DIR_RE.match(name)
        if m and os.path.isdir(os.path.join(dirpath, name)):
            found.append(int(m.group(1)))
    if not found:
        return 0
    n = max(found) + 1
    missing = sorted(set(range(n)) - set(found))
    if missing:
        raise ValueError(
            f"{dirpath}: shard dirs present up to shard-{n - 1:02d} but "
            f"missing {missing} — restore them before mounting")
    return n


def open_wal(data_dir: str, shards: Optional[int] = None) -> WriteAheadLog:
    """Open a data directory's log: explicit `shards` wins (validated
    against what's on disk), otherwise autodetect from the `shard-NN/`
    layout, otherwise a plain `WriteAheadLog`.  A sharded layout raises
    NotImplementedError."""
    detected = detect_shards(data_dir)
    if shards is None:
        n = detected
    else:
        n = int(shards)
        if detected and n != detected:
            raise ValueError(
                f"{data_dir} holds {detected}-shard WAL state but "
                f"shards={n} was requested")
    if n > 1:
        raise NotImplementedError(
            f"{data_dir}: a {n}-shard WAL layout (ShardedWal) comes with "
            f"{_SLICE_SHARDING}")
    return WriteAheadLog(data_dir)
