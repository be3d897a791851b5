"""The subset of MessagePack that a checkpoint uses, written as
``msgpack.packb(obj, use_bin_type=True)`` writes it and read as
``msgpack.unpackb(data, raw=False)`` reads it, so the port needs no
``msgpack`` package (the GPU machine has none).

Written: maps (entries in insertion order), ``str`` (UTF-8), ``bytes``
(``bin8``/``bin16``/``bin32`` by length), ``None``, ``bool``, ``int`` in
its smallest encoding, ``float`` as float64, and lists and tuples as
arrays.  Read: the same, and float32 too; any other type tag raises
``ValueError``.
"""
from __future__ import annotations

import struct
from typing import Any, List, Tuple


def _head(out: List[bytes], n: int, fix: int, fix_max: int,
          tags: Tuple[int, int, int]) -> None:
    """A length header: the fix form up to ``fix_max``, else the 8-, 16- or
    32-bit form (``tags[0]`` may be 0 where the type has no 8-bit form)."""
    if n <= fix_max:
        out.append(bytes((fix | n,)))
    elif tags[0] and n < 1 << 8:
        out.append(bytes((tags[0], n)))
    elif n < 1 << 16:
        out.append(struct.pack(">BH", tags[1], n))
    elif n < 1 << 32:
        out.append(struct.pack(">BI", tags[2], n))
    else:
        raise ValueError(f"length {n} does not fit MessagePack")


def _pack_int(out: List[bytes], x: int) -> None:
    if 0 <= x < 0x80:
        out.append(bytes((x,)))
    elif -32 <= x < 0:
        out.append(struct.pack(">b", x))
    elif x >= 0:
        for tag, fmt, top in ((0xCC, ">BB", 1 << 8), (0xCD, ">BH", 1 << 16),
                              (0xCE, ">BI", 1 << 32), (0xCF, ">BQ", 1 << 64)):
            if x < top:
                out.append(struct.pack(fmt, tag, x))
                return
        raise OverflowError(f"integer {x} does not fit MessagePack")
    else:
        for tag, fmt, low in ((0xD0, ">Bb", -(1 << 7)),
                              (0xD1, ">Bh", -(1 << 15)),
                              (0xD2, ">Bi", -(1 << 31)),
                              (0xD3, ">Bq", -(1 << 63))):
            if x >= low:
                out.append(struct.pack(fmt, tag, x))
                return
        raise OverflowError(f"integer {x} does not fit MessagePack")


def _pack(out: List[bytes], obj: Any) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True or obj is False:
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, int):
        _pack_int(out, int(obj))
    elif isinstance(obj, float):
        out.append(struct.pack(">Bd", 0xCB, obj))
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _head(out, len(data), 0xA0, 31, (0xD9, 0xDA, 0xDB))
        out.append(data)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = bytes(obj)
        _head(out, len(data), 0, -1, (0xC4, 0xC5, 0xC6))
        out.append(data)
    elif isinstance(obj, dict):
        _head(out, len(obj), 0x80, 15, (0, 0xDE, 0xDF))
        for k, v in obj.items():
            _pack(out, k)
            _pack(out, v)
    elif isinstance(obj, (list, tuple)):
        _head(out, len(obj), 0x90, 15, (0, 0xDC, 0xDD))
        for v in obj:
            _pack(out, v)
    else:
        raise TypeError(f"cannot serialize {type(obj).__name__!r} "
                        "to MessagePack")


def packb(obj: Any) -> bytes:
    """``obj`` as the bytes ``msgpack.packb(obj, use_bin_type=True)``
    gives."""
    out: List[bytes] = []
    _pack(out, obj)
    return b"".join(out)


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated MessagePack data")
        view = self.data[self.pos:self.pos + n]
        self.pos += n
        return view

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def str_(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def array(self, n: int) -> list:
        return [self.obj() for _ in range(n)]

    def map_(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        return out

    def obj(self) -> Any:
        tag = self.unpack(">B")
        if tag < 0x80:
            return tag
        if tag >= 0xE0:
            return tag - 0x100
        if 0xA0 <= tag <= 0xBF:
            return self.str_(tag & 0x1F)
        if 0x90 <= tag <= 0x9F:
            return self.array(tag & 0x0F)
        if 0x80 <= tag <= 0x8F:
            return self.map_(tag & 0x0F)
        fixed = {0xC0: None, 0xC2: False, 0xC3: True}
        if tag in fixed:
            return fixed[tag]
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H",
                   0xCE: ">I", 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h",
                   0xD2: ">i", 0xD3: ">q"}
        if tag in numbers:
            return self.unpack(numbers[tag])
        sized = {0xC4: (">B", bytes), 0xC5: (">H", bytes),
                 0xC6: (">I", bytes), 0xD9: (">B", self.str_),
                 0xDA: (">H", self.str_), 0xDB: (">I", self.str_),
                 0xDC: (">H", self.array), 0xDD: (">I", self.array),
                 0xDE: (">H", self.map_), 0xDF: (">I", self.map_)}
        if tag in sized:
            fmt, read = sized[tag]
            n = self.unpack(fmt)
            return bytes(self.take(n)) if read is bytes else read(n)
        raise ValueError(f"MessagePack type tag 0x{tag:02x} is not in the "
                         "checkpoint subset")


def unpackb(data: bytes) -> Any:
    """The object ``msgpack.unpackb(data, raw=False)`` gives for data in
    the checkpoint subset."""
    reader = _Reader(data)
    obj = reader.obj()
    if reader.pos != len(reader.data):
        raise ValueError(f"{len(reader.data) - reader.pos} bytes of extra "
                         "data after the MessagePack object")
    return obj
