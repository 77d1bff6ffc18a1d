"""The subset of MessagePack that the checkpoint format uses.

Maps, arrays, str, bin, int, float64, bool and nil, written exactly as
``msgpack.packb(obj, use_bin_type=True)`` writes them (the smallest form of
each), and read as ``msgpack.unpackb(data, raw=False)`` reads them (maps to
dicts, arrays to lists, bin to bytes; float32 is read too).  The port
carries it so that a checkpoint needs no package beyond torch and numpy.
Extension types and timestamps are not part of the format and raise.
"""

from __future__ import annotations

import struct

_U32 = 0xFFFFFFFF


def _length(n: int, fix: int | None, fix_max: int, forms) -> bytes:
    """The header of a sized object: a fix form under ``fix_max``, else the
    first of ``forms`` ((prefix, struct code, max)) that holds ``n``."""
    if fix is not None and n < fix_max:
        return bytes((fix | n,))
    for prefix, code, most in forms:
        if n <= most:
            return bytes((prefix,)) + struct.pack(">" + code, n)
    raise ValueError(f"{n} is too long for MessagePack (at most {_U32})")


_STR = ((0xD9, "B", 0xFF), (0xDA, "H", 0xFFFF), (0xDB, "I", _U32))
_BIN = ((0xC4, "B", 0xFF), (0xC5, "H", 0xFFFF), (0xC6, "I", _U32))
_ARRAY = ((0xDC, "H", 0xFFFF), (0xDD, "I", _U32))
_MAP = ((0xDE, "H", 0xFFFF), (0xDF, "I", _U32))


def _int(n: int) -> bytes:
    if 0 <= n < 0x80:
        return bytes((n,))
    if -32 <= n < 0:
        return struct.pack(">b", n)
    if n >= 0:
        for prefix, code, most in ((0xCC, "B", 0xFF), (0xCD, "H", 0xFFFF),
                                   (0xCE, "I", _U32), (0xCF, "Q", 2**64 - 1)):
            if n <= most:
                return bytes((prefix,)) + struct.pack(">" + code, n)
    else:
        for prefix, code, least in ((0xD0, "b", -2**7), (0xD1, "h", -2**15),
                                    (0xD2, "i", -2**31), (0xD3, "q", -2**63)):
            if n >= least:
                return bytes((prefix,)) + struct.pack(">" + code, n)
    raise OverflowError(f"integer {n} does not fit MessagePack's 64 bits")


def _pack(obj, out: list) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True or obj is False:
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, int):
        out.append(_int(obj))
    elif isinstance(obj, float):
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        out.append(_length(len(data), 0xA0, 32, _STR))
        out.append(data)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        out.append(_length(len(obj), None, 0, _BIN))
        out.append(obj)
    elif isinstance(obj, (list, tuple)):
        out.append(_length(len(obj), 0x90, 16, _ARRAY))
        for item in obj:
            _pack(item, out)
    elif isinstance(obj, dict):
        out.append(_length(len(obj), 0x80, 16, _MAP))
        for key, value in obj.items():
            _pack(key, out)
            _pack(value, out)
    else:
        raise TypeError(f"cannot pack {type(obj).__name__} as MessagePack")


def packb(obj) -> bytes:
    """``obj`` as MessagePack bytes (``msgpack.packb(obj, use_bin_type=True)``)."""
    out: list = []
    _pack(obj, out)
    return b"".join(out)


class _Reader:
    def __init__(self, data):
        self.buf = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated MessagePack data")
        view = self.buf[self.pos:self.pos + n]
        self.pos += n
        return view

    def unpack(self, code: str):
        return struct.unpack(">" + code, self.take(struct.calcsize(code)))[0]

    def items(self, n: int) -> list:
        return [self.read() for _ in range(n)]

    def pairs(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        return out

    def read(self):
        b = self.take(1)[0]
        if b < 0x80:
            return b
        if b >= 0xE0:
            return b - 0x100
        if b < 0x90:
            return self.pairs(b & 0x0F)
        if b < 0xA0:
            return self.items(b & 0x0F)
        if b < 0xC0:
            return str(self.take(b & 0x1F), "utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {0xC4: ("B", bytes), 0xC5: ("H", bytes), 0xC6: ("I", bytes),
                 0xD9: ("B", str), 0xDA: ("H", str), 0xDB: ("I", str),
                 0xDC: ("H", list), 0xDD: ("I", list), 0xDE: ("H", dict), 0xDF: ("I", dict)}
        if b in sized:
            code, kind = sized[b]
            n = self.unpack(code)
            if kind is bytes:
                return bytes(self.take(n))
            if kind is str:
                return str(self.take(n), "utf-8")
            return self.items(n) if kind is list else self.pairs(n)
        numbers = {0xCA: "f", 0xCB: "d", 0xCC: "B", 0xCD: "H", 0xCE: "I", 0xCF: "Q",
                   0xD0: "b", 0xD1: "h", 0xD2: "i", 0xD3: "q"}
        if b in numbers:
            return self.unpack(numbers[b])
        raise ValueError(f"MessagePack type 0x{b:02x} is not part of the checkpoint format")


def unpackb(data):
    """The object of MessagePack ``data`` (``msgpack.unpackb(data, raw=False)``)."""
    reader = _Reader(data)
    obj = reader.read()
    if reader.pos != len(reader.buf):
        raise ValueError(f"{len(reader.buf) - reader.pos} bytes after the MessagePack object")
    return obj
