"""Filesystem fault injection for durability testing.

Every crash-durability-relevant filesystem mutation in the checkpoint layer
(`wal.py`, `io.py`, `replication.py`) routes through the module-level active
`FilesystemOps` — `RealFS` in production (a zero-overhead passthrough), or a
`FaultyFS` installed by tests.  `FaultyFS` does two things:

1. **Injects faults** at named crash points.  A `FaultRule` matches an op
   ("write", "fsync", "replace", "fsync_dir", "unlink", "ship") plus a path
   substring, fires on the nth hit, and applies a mode: `crash` (raise
   `InjectedCrash` before the op), `torn` (write a prefix, then crash),
   `bitflip` (silently corrupt one bit and continue), `enospc` (raise
   ENOSPC), `delay` (sleep, for slow-sink latency).

2. **Models the durable view** of the tree under its root — which bytes
   would survive power loss at this instant, per POSIX crash semantics:
   a file's *content* is on stable storage only after its fd is fsync'd,
   and a *directory entry* (creation, rename, unlink) is durable only
   after the parent directory is fsync'd.  `simulate_power_loss()` rewinds
   the real tree to that durable view, so a test can assert exactly what a
   crash at any injected point would leave behind — this is what catches
   the write-without-parent-dir-fsync class of bug.

The model is deliberately conservative: an entry promoted by a dir fsync
whose content was never fsync'd comes back as an empty (torn) file, and an
in-place overwrite without fsync reverts to the old content.
"""
from __future__ import annotations

import errno
import os
import random
import time
from contextlib import contextmanager
from typing import Dict, List, Optional, Set

OPS = ("write", "fsync", "replace", "fsync_dir", "unlink", "ship")
MODES = ("crash", "torn", "bitflip", "enospc", "delay")


class InjectedCrash(Exception):
    """Raised at an injected crash point (stands in for kill -9 at that
    instant: the process stops, the durable view is whatever was synced)."""


class FaultRule:
    """One injection site: fires when `op` matches, `path_substr` is in the
    path, and the match count reaches `nth` (every match >= nth when
    `repeat`)."""

    def __init__(self, op: str, mode: str = "crash", path_substr: str = "",
                 nth: int = 1, delay_s: float = 0.0, repeat: bool = False):
        if op not in OPS:
            raise ValueError(f"op {op!r} not in {OPS}")
        if mode not in MODES:
            raise ValueError(f"mode {mode!r} not in {MODES}")
        self.op = op
        self.mode = mode
        self.path_substr = path_substr
        self.nth = int(nth)
        self.delay_s = float(delay_s)
        self.repeat = repeat
        self.hits = 0     # matching op invocations seen
        self.fired = 0    # times the fault actually triggered

    def matches(self, op: str, path: str) -> bool:
        if op != self.op or self.path_substr not in path:
            return False
        self.hits += 1
        fire = self.hits >= self.nth if self.repeat else self.hits == self.nth
        if fire:
            self.fired += 1
        return fire


class RealFS:
    """Production passthrough: plain os calls, no bookkeeping."""

    def write_file(self, path: str, blob: bytes, fsync: bool = True) -> None:
        with open(path, "wb") as f:
            f.write(blob)
            if fsync:
                f.flush()
                os.fsync(f.fileno())

    def replace(self, src: str, dst: str) -> None:
        os.replace(src, dst)

    def fsync_dir(self, path: str) -> None:
        fd = os.open(path, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)

    def unlink(self, path: str) -> None:
        os.unlink(path)

    def trip(self, op: str, path: str) -> None:
        """Named crash point with no filesystem side effect (e.g. "ship")."""


_TOMB = object()      # directory entry removal awaiting parent-dir fsync
_VOLATILE = object()  # entry whose content was never fsync'd


class FaultyFS(RealFS):
    """Fault-injecting filesystem with a power-loss durable-view model.

    Tracks three layers for every file it touches under `root`:
      - `_durable`: entry + content guaranteed to survive power loss
      - `_synced`: content fsync'd to stable storage (entry maybe not)
      - `_pending[dir]`: entry mutations awaiting that directory's fsync
    Files already on disk at first touch are seeded as durable (they
    predate the faulty window).  Paths outside `root` pass straight
    through to the real ops with no modeling.
    """

    def __init__(self, root: str, rules: Optional[List[FaultRule]] = None,
                 seed: int = 0):
        self.root = os.path.abspath(root)
        self.rules: List[FaultRule] = list(rules or [])
        self.trips: List[tuple] = []          # (op, mode, path) fired log
        self._rng = random.Random(seed)
        self._durable: Dict[str, bytes] = {}
        self._synced: Dict[str, bytes] = {}
        self._pending: Dict[str, Dict[str, object]] = {}
        self._tracked: Set[str] = set()

    def add_rule(self, rule: FaultRule) -> FaultRule:
        self.rules.append(rule)
        return rule

    # -- rule machinery ----------------------------------------------------
    def _inside(self, path: str) -> bool:
        return os.path.abspath(path).startswith(self.root + os.sep) or \
            os.path.abspath(path) == self.root

    def _fire(self, op: str, path: str) -> Optional[FaultRule]:
        for rule in self.rules:
            if rule.matches(op, path):
                self.trips.append((op, rule.mode, path))
                return rule
        return None

    def trip(self, op: str, path: str) -> None:
        rule = self._fire(op, path)
        if rule is None:
            return
        if rule.mode == "delay":
            time.sleep(rule.delay_s)
        elif rule.mode == "enospc":
            raise OSError(errno.ENOSPC, os.strerror(errno.ENOSPC), path)
        else:
            raise InjectedCrash(f"injected {rule.mode} at {op}({path})")

    # -- durable-view bookkeeping ------------------------------------------
    def _seed(self, path: str) -> None:
        """A file that predates our first touch is durable as-is."""
        if path in self._tracked:
            return
        self._tracked.add(path)
        if os.path.isfile(path):
            with open(path, "rb") as f:
                blob = f.read()
            self._durable[path] = blob
            self._synced[path] = blob

    def _pending_of(self, path: str) -> Dict[str, object]:
        return self._pending.setdefault(os.path.dirname(path), {})

    def _note_write(self, path: str, blob: bytes, synced: bool) -> None:
        if synced:
            self._synced[path] = blob
            if path in self._durable:
                # in-place overwrite of a durable entry: content durable now
                self._durable[path] = blob
                self._pending_of(path).pop(path, None)
            else:
                self._pending_of(path)[path] = blob
        else:
            self._synced.pop(path, None)
            if path not in self._durable:
                self._pending_of(path)[path] = _VOLATILE
            # durable file overwritten without fsync: model power loss as
            # reverting to the old durable content

    # -- ops ---------------------------------------------------------------
    def write_file(self, path: str, blob: bytes, fsync: bool = True) -> None:
        path = os.path.abspath(path)
        if not self._inside(path):
            return super().write_file(path, blob, fsync=fsync)
        self._seed(path)
        rule = self._fire("write", path)
        if rule is not None:
            if rule.mode == "delay":
                time.sleep(rule.delay_s)
            elif rule.mode == "enospc":
                raise OSError(errno.ENOSPC, os.strerror(errno.ENOSPC), path)
            elif rule.mode == "bitflip":
                blob = self._flip(blob)           # silent corruption
            elif rule.mode == "torn":
                prefix = blob[: max(1, len(blob) // 2)]
                with open(path, "wb") as f:
                    f.write(prefix)
                self._note_write(path, prefix, synced=True)
                raise InjectedCrash(f"injected torn write at {path}")
            else:                                 # crash before the write
                raise InjectedCrash(f"injected crash at write({path})")
        with open(path, "wb") as f:
            f.write(blob)
            if fsync:
                f.flush()
                try:
                    self.trip("fsync", path)
                except Exception:
                    self._note_write(path, blob, synced=False)
                    raise
                os.fsync(f.fileno())
        self._note_write(path, blob, synced=fsync)

    def replace(self, src: str, dst: str) -> None:
        src, dst = os.path.abspath(src), os.path.abspath(dst)
        if not self._inside(dst):
            return super().replace(src, dst)
        self._seed(src)
        self._seed(dst)
        self.trip("replace", dst)
        os.replace(src, dst)
        content = self._synced.pop(src, None)
        if src in self._durable:
            self._pending_of(src)[src] = _TOMB
        else:
            self._pending_of(src).pop(src, None)
        self._pending_of(dst)[dst] = content if content is not None \
            else _VOLATILE
        if content is not None:
            self._synced[dst] = content

    def fsync_dir(self, path: str) -> None:
        path = os.path.abspath(path)
        if not self._inside(path):
            return super().fsync_dir(path)
        self.trip("fsync_dir", path)
        super().fsync_dir(path)
        for p, content in self._pending.pop(path, {}).items():
            if content is _TOMB:
                self._durable.pop(p, None)
            elif content is _VOLATILE:
                # entry made durable, content never synced: torn file
                self._durable[p] = self._synced.get(p, b"")
            else:
                self._durable[p] = content  # type: ignore[assignment]

    def unlink(self, path: str) -> None:
        path = os.path.abspath(path)
        if not self._inside(path):
            return super().unlink(path)
        self._seed(path)
        self.trip("unlink", path)
        os.unlink(path)
        self._synced.pop(path, None)
        if path in self._durable:
            self._pending_of(path)[path] = _TOMB
        else:
            self._pending_of(path).pop(path, None)

    def _flip(self, blob: bytes) -> bytes:
        if not blob:
            return blob
        buf = bytearray(blob)
        i = self._rng.randrange(len(buf))
        buf[i] ^= 1 << self._rng.randrange(8)
        return bytes(buf)

    # -- power loss --------------------------------------------------------
    def simulate_power_loss(self) -> List[str]:
        """Rewind the real tree under `root` to the durable view: tracked
        files revert to their durable bytes (or vanish if their entry was
        never made durable).  Returns the paths that changed or vanished.
        The model then continues from the post-loss state."""
        changed = []
        for path in sorted(self._tracked):
            if path in self._durable:
                on_disk = None
                if os.path.isfile(path):
                    with open(path, "rb") as f:
                        on_disk = f.read()
                if on_disk != self._durable[path]:
                    os.makedirs(os.path.dirname(path), exist_ok=True)
                    with open(path, "wb") as f:
                        f.write(self._durable[path])
                    changed.append(path)
            elif os.path.isfile(path):
                os.unlink(path)
                changed.append(path)
        self._pending.clear()
        self._synced = dict(self._durable)
        return changed


_ACTIVE: RealFS = RealFS()


def active() -> RealFS:
    """The filesystem ops currently in effect (RealFS unless a test
    installed a FaultyFS)."""
    return _ACTIVE


@contextmanager
def install(fs: RealFS):
    """Swap the active filesystem ops for the duration of the block."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = fs
    try:
        yield fs
    finally:
        _ACTIVE = prev
