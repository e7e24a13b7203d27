"""The subset of MessagePack that the port's on-disk formats use.

Every durable file of the system — WAL segments, the manifest, snapshots —
is MessagePack.  The port keeps its own encoder and decoder so that it
runs where the `msgpack` package is not installed, and writes the same
bytes as `msgpack.packb(obj, use_bin_type=True)`, so either package
restores or replays what the other wrote.

Supported types (anything else raises `TypeError`, as msgpack does):

* `None`, `bool` (tested before `int`: a bool is an int);
* `int` in the smallest fitting encoding (positive/negative fixint,
  uint8/16/32/64, int8/16/32/64; out of range raises `OverflowError`);
* `float`, always as float64 (0xcb);
* `str` as UTF-8 (fixstr, str8/16/32);
* `bytes`, `bytearray` and `memoryview` as bin8/16/32;
* `list` and `tuple` as arrays, `dict` as maps in insertion order (the
  wire order: a WAL envelope relies on `count` preceding `payload`).

`unpackb` follows msgpack's defaults for `raw=False`: str stays str, bin
becomes `bytes`, arrays become lists, a map key that is neither str nor
bytes raises `ValueError` (msgpack's `strict_map_key`), and truncated or
trailing bytes raise `ValueError`.  `Unpacker` is the incremental reader
that peeks at a segment's envelope header (`feed`, `read_map_header`,
`unpack`).

Large blobs: `packb` collects chunks and joins them once, appending a
large bin body as the caller's buffer itself (no copy before the join);
`unpackb` cuts each bin out of one memoryview of the input.
"""
from __future__ import annotations

import struct

__all__ = ["packb", "unpackb", "Unpacker", "OutOfData"]

# bin bodies at least this long become chunks of their own (no copy into
# the small-item buffer)
_BIG = 1 << 12

_U8 = struct.Struct(">BB").pack
_U16 = struct.Struct(">BH").pack
_U32 = struct.Struct(">BI").pack
_U64 = struct.Struct(">BQ").pack
_I8 = struct.Struct(">Bb").pack
_I16 = struct.Struct(">Bh").pack
_I32 = struct.Struct(">Bi").pack
_I64 = struct.Struct(">Bq").pack
_F64 = struct.Struct(">Bd").pack

_R_U16 = struct.Struct(">H").unpack_from
_R_U32 = struct.Struct(">I").unpack_from
_R_U64 = struct.Struct(">Q").unpack_from
_R_I8 = struct.Struct(">b").unpack_from
_R_I16 = struct.Struct(">h").unpack_from
_R_I32 = struct.Struct(">i").unpack_from
_R_I64 = struct.Struct(">q").unpack_from
_R_F32 = struct.Struct(">f").unpack_from
_R_F64 = struct.Struct(">d").unpack_from


class OutOfData(ValueError):
    """The input ended inside an object."""


def _int(o: int) -> bytes:
    if o >= 0:
        if o < 0x80:
            return bytes((o,))
        if o < 0x100:
            return _U8(0xCC, o)
        if o < 0x10000:
            return _U16(0xCD, o)
        if o < 0x100000000:
            return _U32(0xCE, o)
        if o < 0x10000000000000000:
            return _U64(0xCF, o)
    else:
        if o >= -32:
            return bytes((o & 0xFF,))
        if o >= -0x80:
            return _I8(0xD0, o)
        if o >= -0x8000:
            return _I16(0xD1, o)
        if o >= -0x80000000:
            return _I32(0xD2, o)
        if o >= -0x8000000000000000:
            return _I64(0xD3, o)
    raise OverflowError("Integer value out of range")


def _str(o: str) -> bytes:
    b = o.encode("utf-8")
    n = len(b)
    if n < 32:
        return bytes((0xA0 | n,)) + b
    if n < 0x100:
        return _U8(0xD9, n) + b
    if n < 0x10000:
        return _U16(0xDA, n) + b
    if n < 0x100000000:
        return _U32(0xDB, n) + b
    raise ValueError("String is too large")


def _bin_header(n: int) -> bytes:
    if n < 0x100:
        return _U8(0xC4, n)
    if n < 0x10000:
        return _U16(0xC5, n)
    if n < 0x100000000:
        return _U32(0xC6, n)
    raise ValueError("Bytes object is too large")


def _array_header(n: int) -> bytes:
    if n < 16:
        return bytes((0x90 | n,))
    if n < 0x10000:
        return _U16(0xDC, n)
    if n < 0x100000000:
        return _U32(0xDD, n)
    raise ValueError("list is too large")


def _map_header(n: int) -> bytes:
    if n < 16:
        return bytes((0x80 | n,))
    if n < 0x10000:
        return _U16(0xDE, n)
    if n < 0x100000000:
        return _U32(0xDF, n)
    raise ValueError("dict is too large")


def packb(obj) -> bytes:
    """`msgpack.packb(obj, use_bin_type=True)` for the supported types."""
    chunks = []
    buf = bytearray()
    put = buf.extend
    # short strings (map keys, repeated field values) encode once a call
    strs = {}

    def pack_bin(body) -> None:
        nonlocal buf, put
        n = body.nbytes if type(body) is memoryview else len(body)
        put(_bin_header(n))
        if n < _BIG:
            put(body.cast("B") if type(body) is memoryview else body)
            return
        chunks.append(buf)
        chunks.append(body)
        buf = bytearray()
        put = buf.extend

    def pack(o) -> None:
        t = type(o)
        if t is str:
            b = strs.get(o)
            if b is None:
                b = _str(o)
                if len(b) <= 64:
                    strs[o] = b
            put(b)
        elif t is dict:
            put(_map_header(len(o)))
            for k, v in o.items():
                if type(k) is str:
                    b = strs.get(k)
                    if b is None:
                        b = strs[k] = _str(k)
                    put(b)
                else:
                    pack(k)
                # the common values inline: a record's fields are scalars
                tv = type(v)
                if tv is str:
                    b = strs.get(v)
                    if b is None:
                        b = _str(v)
                        if len(b) <= 64:
                            strs[v] = b
                    put(b)
                elif tv is float:
                    put(_F64(0xCB, v))
                else:
                    pack(v)
        elif t is int:
            put(_int(o))
        elif t is float:
            put(_F64(0xCB, o))
        elif t is list or t is tuple:
            put(_array_header(len(o)))
            for v in o:
                pack(v)
        elif o is None:
            put(b"\xc0")
        elif t is bool:
            put(b"\xc3" if o else b"\xc2")
        elif t is bytes or t is bytearray or t is memoryview:
            pack_bin(o)
        else:
            pack_subclass(o)

    def pack_subclass(o) -> None:
        # subclasses, in msgpack's order of checks (bool before int)
        if isinstance(o, bool):
            put(b"\xc3" if o else b"\xc2")
        elif isinstance(o, int):
            put(_int(int(o)))
        elif isinstance(o, float):
            put(_F64(0xCB, float(o)))
        elif isinstance(o, (bytes, bytearray)):
            pack_bin(o)
        elif isinstance(o, str):
            put(_str(str(o)))
        elif isinstance(o, dict):
            pack(dict(o))
        elif isinstance(o, (list, tuple)):
            pack(list(o))
        elif isinstance(o, memoryview):
            pack_bin(o)
        else:
            raise TypeError(f"can not serialize {type(o).__name__!r} object")

    pack(obj)
    if not chunks:
        return bytes(buf)
    chunks.append(buf)
    return b"".join(chunks)


# -- decoding -------------------------------------------------------------------

_FIXED = {
    0xCC: (1, struct.Struct(">B").unpack_from), 0xCD: (2, _R_U16),
    0xCE: (4, _R_U32), 0xCF: (8, _R_U64), 0xD0: (1, _R_I8),
    0xD1: (2, _R_I16), 0xD2: (4, _R_I32), 0xD3: (8, _R_I64),
    0xCA: (4, _R_F32), 0xCB: (8, _R_F64),
}
# str8/16/32, bin8/16/32, array16/32, map16/32: the size of the length field
_LEN_SIZE = {0xD9: 1, 0xC4: 1, 0xDA: 2, 0xC5: 2, 0xDC: 2, 0xDE: 2,
             0xDB: 4, 0xC6: 4, 0xDD: 4, 0xDF: 4}
_LEN_READ = {1: struct.Struct(">B").unpack_from, 2: _R_U16, 4: _R_U32}


def _incomplete() -> OutOfData:
    return OutOfData("Unpack failed: incomplete input")


def _decoder(data: bytes, pos: int = 0):
    """Closures decoding `data` from `pos`: (obj, map_header, tell).  A
    read past the end raises IndexError or struct.error, which the callers
    turn into OutOfData."""
    view = memoryview(data)
    end = len(data)
    keys = {}                      # map keys decode (and intern) once

    def length(b: int) -> int:
        nonlocal pos
        size = _LEN_SIZE[b]
        n = _LEN_READ[size](data, pos)[0]
        pos += size
        return n

    def span(n: int) -> int:
        """Advance past n bytes; returns where they start."""
        nonlocal pos
        p = pos
        if p + n > end:
            raise _incomplete()
        pos = p + n
        return p

    def mapping(n: int) -> dict:
        nonlocal pos
        out = {}
        for _ in range(n):
            b = data[pos]
            if 0xA0 <= b <= 0xBF:            # fixstr key: the common case
                q = pos + 1 + (b & 0x1F)
                if q > end:
                    raise _incomplete()
                raw = data[pos + 1: q]
                pos = q
                k = keys.get(raw)
                if k is None:
                    k = keys[raw] = raw.decode("utf-8")
            else:
                k = obj()
                if type(k) is not str and type(k) is not bytes:
                    raise ValueError(
                        f"{type(k).__name__} is not allowed for map key "
                        "when strict_map_key=True")
            # the common values inline: a record's fields are scalars
            b = data[pos]
            if 0xA0 <= b <= 0xBF:
                q = pos + 1 + (b & 0x1F)
                if q > end:
                    raise _incomplete()
                out[k] = data[pos + 1: q].decode("utf-8")
                pos = q
            elif b == 0xCB:
                out[k] = _R_F64(data, pos + 1)[0]
                pos += 9
            elif b <= 0x7F:
                out[k] = b
                pos += 1
            else:
                out[k] = obj()
        return out

    def obj():
        nonlocal pos
        b = data[pos]
        pos += 1
        if b <= 0x7F:
            return b
        if 0xA0 <= b <= 0xBF:
            p = pos
            q = p + (b & 0x1F)
            if q > end:
                raise _incomplete()
            pos = q
            return data[p: q].decode("utf-8")
        if b <= 0x8F:
            return mapping(b & 0x0F)
        if b <= 0x9F:
            return [obj() for _ in range(b & 0x0F)]
        if b >= 0xE0:
            return b - 0x100
        if b == 0xCB:
            v = _R_F64(data, pos)[0]
            pos += 8
            return v
        if b == 0xC0:
            return None
        if b == 0xC2:
            return False
        if b == 0xC3:
            return True
        size = _LEN_SIZE.get(b)
        if size is not None:
            n = length(b)
            if b in (0xD9, 0xDA, 0xDB):
                p = span(n)
                return data[p: p + n].decode("utf-8")
            if b in (0xC4, 0xC5, 0xC6):
                p = span(n)
                return bytes(view[p: p + n])
            if b in (0xDC, 0xDD):
                return [obj() for _ in range(n)]
            return mapping(n)
        fixed = _FIXED.get(b)
        if fixed is None:
            raise ValueError(f"unsupported MessagePack type 0x{b:02x}")
        size, read = fixed
        v = read(data, pos)[0]
        pos += size
        return v

    def map_header() -> int:
        nonlocal pos
        b = data[pos]
        if 0x80 <= b <= 0x8F:
            pos += 1
            return b & 0x0F
        if b in (0xDE, 0xDF):
            pos += 1
            return length(b)
        raise ValueError("Unexpected type header: expected a map")

    def tell() -> int:
        return pos

    return obj, map_header, tell


def unpackb(data):
    """`msgpack.unpackb(data, raw=False)` for the supported types: exactly
    one object, no trailing bytes."""
    if not isinstance(data, bytes):
        data = bytes(data)
    obj, _, tell = _decoder(data)
    try:
        out = obj()
    except (IndexError, struct.error):
        raise _incomplete() from None
    if tell() != len(data):
        raise ValueError(f"extra data: {len(data) - tell()} bytes after the "
                         "object")
    return out


class Unpacker:
    """Incremental reader over fed bytes (what a segment's header peek
    needs): `feed`, then `read_map_header` and `unpack` consume objects
    in order; running past the fed bytes raises `OutOfData` and consumes
    nothing."""

    def __init__(self):
        self._buf = bytearray()
        self._pos = 0

    def feed(self, data) -> None:
        self._buf += data

    def _run(self, which: int):
        fns = _decoder(bytes(self._buf), self._pos)
        try:
            out = fns[which]()
        except (IndexError, struct.error):
            raise _incomplete() from None
        self._pos = fns[2]()
        return out

    def read_map_header(self) -> int:
        return self._run(1)

    def unpack(self):
        return self._run(0)
