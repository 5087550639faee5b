"""The subset of msgpack the checkpoint store writes, encoded and decoded
here so that the port needs no ``msgpack`` package.

Encoding is byte-identical to ``msgpack.packb(obj, use_bin_type=True)``
for: None, bool, int (every form msgpack picks: positive and negative
fixint, uint/int 8-64), float (float64), str (fixstr, str8/16/32),
bytes, bytearray and memoryview (bin 8/16/32), list and tuple (array
fix/16/32) and dict with str keys (map fix/16/32).  Decoding equals
``msgpack.Unpacker(f, raw=False)`` on that subset: arrays come back as
lists, bins as bytearrays.  A bin of up to 2^31 bytes is read from the file into one
buffer (``readinto``), never assembled piece by piece.  Anything outside
the subset raises ``TypeError`` (encoding) or ``ValueError`` (decoding).
"""
from __future__ import annotations

import struct
from typing import Any, BinaryIO, Iterator

# the largest bin the decoder takes (msgpack.Unpacker's max_buffer_size
# in the reference store)
MAX_BIN = 2 ** 31

_U8, _U16, _U32, _U64 = (struct.Struct(f">{c}") for c in "BHIQ")
_I8, _I16, _I32, _I64 = (struct.Struct(f">{c}") for c in "bhiq")
_F64 = struct.Struct(">d")
_SIMPLE = {0xC0: None, 0xC2: False, 0xC3: True}
# type byte -> its fixed-width value
_FIXED = {0xCC: _U8, 0xCD: _U16, 0xCE: _U32, 0xCF: _U64, 0xD0: _I8,
          0xD1: _I16, 0xD2: _I32, 0xD3: _I64, 0xCB: _F64}


def _int(x: int) -> bytes:
    if 0 <= x < 0x80:
        return _U8.pack(x)
    if -0x20 <= x < 0:
        return _I8.pack(x)                  # 0xe0-0xff: negative fixint
    if 0x80 <= x <= 0xFF:
        return b"\xcc" + _U8.pack(x)
    if -0x80 <= x < 0:
        return b"\xd0" + _I8.pack(x)
    if 0xFF < x <= 0xFFFF:
        return b"\xcd" + _U16.pack(x)
    if -0x8000 <= x < -0x80:
        return b"\xd1" + _I16.pack(x)
    if 0xFFFF < x <= 0xFFFFFFFF:
        return b"\xce" + _U32.pack(x)
    if -0x80000000 <= x < -0x8000:
        return b"\xd2" + _I32.pack(x)
    if 0xFFFFFFFF < x <= 0xFFFFFFFFFFFFFFFF:
        return b"\xcf" + _U64.pack(x)
    if -0x8000000000000000 <= x < -0x80000000:
        return b"\xd3" + _I64.pack(x)
    raise ValueError(f"integer {x} is out of msgpack's range")


def _sized(n: int, fix: int, fix_max: int, tags: tuple, what: str) -> bytes:
    """Prefix of a str / bin / array / map of length ``n``: the fix form
    below ``fix_max`` (``fix`` None: none), else the 8/16/32-bit forms
    ``tags`` gives (a None tag: that width does not exist)."""
    if fix is not None and n < fix_max:
        return _U8.pack(fix | n)
    for tag, limit, st in zip(tags, (0x100, 0x10000, 0x100000000),
                              (_U8, _U16, _U32)):
        if tag is not None and n < limit:
            return bytes((tag,)) + st.pack(n)
    raise ValueError(f"{what} of length {n} is too long for msgpack")


def bin_header(n: int) -> bytes:
    """The bin 8/16/32 prefix of an ``n``-byte binary."""
    return _sized(n, None, 0, (0xC4, 0xC5, 0xC6), "bin")


def _pack(obj: Any, out: list) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True:
        out.append(b"\xc3")
    elif obj is False:
        out.append(b"\xc2")
    elif isinstance(obj, int):
        out.append(_int(obj))
    elif isinstance(obj, float):
        out.append(b"\xcb" + _F64.pack(obj))
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        out.append(_sized(len(raw), 0xA0, 32, (0xD9, 0xDA, 0xDB), "str"))
        out.append(raw)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        raw = memoryview(obj).cast("B")
        out.append(bin_header(raw.nbytes))
        out.append(raw)
    elif isinstance(obj, (list, tuple)):
        out.append(_sized(len(obj), 0x90, 16, (None, 0xDC, 0xDD), "array"))
        for x in obj:
            _pack(x, out)
    elif isinstance(obj, dict):
        out.append(_sized(len(obj), 0x80, 16, (None, 0xDE, 0xDF), "map"))
        for k, v in obj.items():
            if not isinstance(k, str):
                raise TypeError(f"map key {k!r} is not a str")
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"cannot pack {type(obj).__name__} (outside the "
                        f"checkpoint store's msgpack subset)")


def packb(obj: Any) -> bytes:
    """``msgpack.packb(obj, use_bin_type=True)`` on the subset."""
    out: list = []
    _pack(obj, out)
    return b"".join(out)


class Unpacker:
    """Iterates the objects of a msgpack stream read from ``f``."""

    def __init__(self, f: BinaryIO):
        self._f = f
        # type byte -> (length field, reader of that many bytes / items)
        self._sized = {0xC4: (_U8, self._bin), 0xC5: (_U16, self._bin),
                       0xC6: (_U32, self._bin), 0xD9: (_U8, self._str),
                       0xDA: (_U16, self._str), 0xDB: (_U32, self._str),
                       0xDC: (_U16, self._array), 0xDD: (_U32, self._array),
                       0xDE: (_U16, self._map), 0xDF: (_U32, self._map)}

    def __iter__(self) -> Iterator[Any]:
        return self

    def __next__(self) -> Any:
        head = self._f.read(1)
        if not head:
            raise StopIteration
        return self._obj(head[0])

    def _read(self, n: int) -> bytes:
        b = self._f.read(n)
        if len(b) != n:
            raise ValueError(f"msgpack stream ends {n - len(b)} bytes early")
        return b

    def _next(self) -> Any:
        return self._obj(self._read(1)[0])

    def _bin(self, n: int) -> bytearray:
        if n > MAX_BIN:
            raise ValueError(f"bin of {n} bytes exceeds {MAX_BIN}")
        buf = bytearray(n)
        view, got = memoryview(buf), 0
        while got < n:
            k = self._f.readinto(view[got:])
            if not k:
                raise ValueError(f"msgpack stream ends {n - got} bytes "
                                 f"early")
            got += k
        return buf

    def _str(self, n: int) -> str:
        return self._read(n).decode("utf-8")

    def _array(self, n: int) -> list:
        return [self._next() for _ in range(n)]

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self._next()
            if not isinstance(k, str):
                raise ValueError(f"map key {k!r} is not a str")
            out[k] = self._next()
        return out

    def _obj(self, t: int) -> Any:
        if t < 0x80:
            return t
        if t >= 0xE0:
            return t - 0x100
        if t < 0x90:
            return self._map(t & 0x0F)
        if t < 0xA0:
            return self._array(t & 0x0F)
        if t < 0xC0:
            return self._str(t & 0x1F)
        if t in _SIMPLE:
            return _SIMPLE[t]
        if t in _FIXED:
            st = _FIXED[t]
            return st.unpack(self._read(st.size))[0]
        if t in self._sized:
            st, fn = self._sized[t]
            return fn(st.unpack(self._read(st.size))[0])
        raise ValueError(f"msgpack type byte 0x{t:02x} is outside the "
                         f"checkpoint store's subset")
