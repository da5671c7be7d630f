"""The msgpack subset the transport and shm protocols speak (DESIGN.md §11).

The port carries its own codec instead of depending on ``msgpack``. It
handles None, bool, int (64 bits, signed or unsigned), float (float64 out,
float32 or float64 in), str, bytes (also bytearray and memoryview),
list/tuple and dict. :func:`packb` gives the same bytes as
``msgpack.packb(obj, use_bin_type=True)`` and :func:`unpackb` decodes as
``msgpack.unpackb(data, raw=False, strict_map_key=False)``, so a port
endpoint and a JAX-package endpoint share one wire protocol. Anything
outside the subset (ext types, numpy scalars) raises ``TypeError``, or
``ValueError`` when decoding, as msgpack does.
"""
from __future__ import annotations

import struct
from typing import Any, List, Tuple

_BE = {1: ">B", 2: ">H", 4: ">I", 8: ">Q"}


def _pack_int(n: int, out: List[bytes]) -> None:
    if 0 <= n < 0x80:
        out.append(bytes((n,)))
    elif -0x20 <= n < 0:
        out.append(bytes((n & 0xFF,)))
    elif 0 < n <= 0xFF:
        out.append(b"\xcc" + struct.pack(">B", n))
    elif -0x80 <= n < 0:
        out.append(b"\xd0" + struct.pack(">b", n))
    elif 0 < n <= 0xFFFF:
        out.append(b"\xcd" + struct.pack(">H", n))
    elif -0x8000 <= n < 0:
        out.append(b"\xd1" + struct.pack(">h", n))
    elif 0 < n <= 0xFFFFFFFF:
        out.append(b"\xce" + struct.pack(">I", n))
    elif -0x80000000 <= n < 0:
        out.append(b"\xd2" + struct.pack(">i", n))
    elif 0 < n <= 0xFFFFFFFFFFFFFFFF:
        out.append(b"\xcf" + struct.pack(">Q", n))
    elif -0x8000000000000000 <= n < 0:
        out.append(b"\xd3" + struct.pack(">q", n))
    else:
        raise OverflowError(f"integer {n} does not fit in 64 bits")


def _pack_len(n: int, fix_base: int, fix_max: int, codes: Tuple[int, ...],
              widths: Tuple[int, ...], out: List[bytes]) -> None:
    """A length header: the fix form when ``n < fix_max`` (``fix_base``
    unset means there is none), else the first of ``codes`` whose width
    holds ``n``."""
    if fix_base is not None and n < fix_max:
        out.append(bytes((fix_base | n,)))
        return
    for code, width in zip(codes, widths):
        if n < 1 << (8 * width):
            out.append(bytes((code,)) + struct.pack(_BE[width], n))
            return
    raise ValueError(f"length {n} exceeds the msgpack limit")


def _pack(obj: Any, out: List[bytes]) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True:
        out.append(b"\xc3")
    elif obj is False:
        out.append(b"\xc2")
    elif isinstance(obj, int):
        _pack_int(int(obj), out)
    elif isinstance(obj, float):
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        _pack_len(len(raw), 0xA0, 32, (0xD9, 0xDA, 0xDB), (1, 2, 4), out)
        out.append(raw)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        raw = bytes(obj)
        _pack_len(len(raw), None, 0, (0xC4, 0xC5, 0xC6), (1, 2, 4), out)
        out.append(raw)
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), 0x90, 16, (0xDC, 0xDD), (2, 4), out)
        for item in obj:
            _pack(item, out)
    elif isinstance(obj, dict):
        _pack_len(len(obj), 0x80, 16, (0xDE, 0xDF), (2, 4), out)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


def packb(obj: Any) -> bytes:
    """``msgpack.packb(obj, use_bin_type=True)`` for the protocol subset."""
    out: List[bytes] = []
    _pack(obj, out)
    return b"".join(out)


class _Reader:
    __slots__ = ("data", "pos")

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def take(self, n: int) -> bytes:
        end = self.pos + n
        if end > len(self.data):
            raise ValueError("msgpack data truncated")
        chunk = self.data[self.pos:end]
        self.pos = end
        return chunk

    def unpack(self, fmt: str, n: int):
        return struct.unpack(fmt, self.take(n))[0]


# fixed-width codes: byte -> (struct format, width, kind)
_FIXED = {
    0xCC: (">B", 1, "int"), 0xCD: (">H", 2, "int"), 0xCE: (">I", 4, "int"),
    0xCF: (">Q", 8, "int"), 0xD0: (">b", 1, "int"), 0xD1: (">h", 2, "int"),
    0xD2: (">i", 4, "int"), 0xD3: (">q", 8, "int"),
    0xCA: (">f", 4, "float"), 0xCB: (">d", 8, "float"),
    0xD9: (">B", 1, "str"), 0xDA: (">H", 2, "str"), 0xDB: (">I", 4, "str"),
    0xC4: (">B", 1, "bin"), 0xC5: (">H", 2, "bin"), 0xC6: (">I", 4, "bin"),
    0xDC: (">H", 2, "array"), 0xDD: (">I", 4, "array"),
    0xDE: (">H", 2, "map"), 0xDF: (">I", 4, "map"),
}


def _unpack(r: _Reader) -> Any:
    b = r.take(1)[0]
    if b <= 0x7F:
        return b
    if b >= 0xE0:
        return b - 0x100
    if 0x80 <= b <= 0x8F:
        return _unpack_map(r, b & 0x0F)
    if 0x90 <= b <= 0x9F:
        return [_unpack(r) for _ in range(b & 0x0F)]
    if 0xA0 <= b <= 0xBF:
        return r.take(b & 0x1F).decode("utf-8")
    if b == 0xC0:
        return None
    if b == 0xC2:
        return False
    if b == 0xC3:
        return True
    if b not in _FIXED:
        raise ValueError(f"msgpack type byte 0x{b:02x} is outside the protocol")
    fmt, width, kind = _FIXED[b]
    v = r.unpack(fmt, width)
    if kind in ("int", "float"):
        return v
    if kind == "str":
        return r.take(v).decode("utf-8")
    if kind == "bin":
        return r.take(v)
    if kind == "array":
        return [_unpack(r) for _ in range(v)]
    return _unpack_map(r, v)


def _unpack_map(r: _Reader, n: int) -> dict:
    out = {}
    for _ in range(n):
        k = _unpack(r)
        out[k] = _unpack(r)
    return out


def unpackb(data) -> Any:
    """``msgpack.unpackb(data, raw=False, strict_map_key=False)`` for the
    protocol subset; trailing bytes are an error, as in msgpack."""
    r = _Reader(bytes(data))
    obj = _unpack(r)
    if r.pos != len(r.data):
        raise ValueError(f"{len(r.data) - r.pos} bytes of extra data")
    return obj
