"""A msgpack codec for what ``serialize_record`` packs, in the standard
library only (the card's machine has no ``msgpack``).

``packb(obj, use_bin_type=True)`` writes the bytes ``msgpack.packb``
writes: ``None``, ``bool``, ``int`` in its smallest form (unsigned above
zero, signed at or below it), ``float`` as float64, ``str`` as fixstr /
str8 / str16 / str32, bytes as bin8 / bin16 / bin32, lists and
tuples as arrays and dicts as maps, each in its smallest form. Like
msgpack it checks ``isinstance``, so a subclass of one of these types
(``numpy.float64`` is a ``float``) packs as its base; anything else
(``numpy.int64``, ``numpy.float32``, ``set``) raises ``TypeError`` rather
than being converted, so a record msgpack would refuse is refused here.

``unpackb(data, raw=False, strict_map_key=False)`` reads what msgpack
reads with those options: strings as ``str`` (strict UTF-8), bin as
``bytes``, arrays as lists, maps as dicts whose keys may be of any
hashable type. Incomplete input, a reserved byte, an ext type and
trailing bytes raise ``ValueError``.
"""

import struct

_RECURSE_LIMIT = 511  # msgpack's DEFAULT_RECURSE_LIMIT

_U8, _U16, _U32, _U64 = struct.Struct(">B"), struct.Struct(">H"), struct.Struct(">I"), struct.Struct(">Q")
_I8, _I16, _I32, _I64 = struct.Struct(">b"), struct.Struct(">h"), struct.Struct(">i"), struct.Struct(">q")
_F32, _F64 = struct.Struct(">f"), struct.Struct(">d")


class ExtraData(ValueError):
    """The input holds bytes past its one object."""


class FormatError(ValueError):
    """The input is not msgpack this codec reads."""


def _pack_int(n: int, out: list) -> None:
    if n > 0:
        if n < 0x80:
            out.append(_U8.pack(n))
        elif n <= 0xFF:
            out.append(b"\xcc" + _U8.pack(n))
        elif n <= 0xFFFF:
            out.append(b"\xcd" + _U16.pack(n))
        elif n <= 0xFFFFFFFF:
            out.append(b"\xce" + _U32.pack(n))
        elif n <= 0xFFFFFFFFFFFFFFFF:
            out.append(b"\xcf" + _U64.pack(n))
        else:
            raise OverflowError("Integer value out of range")
    elif n >= -32:
        out.append(_U8.pack(n & 0xFF))
    elif n >= -0x80:
        out.append(b"\xd0" + _I8.pack(n))
    elif n >= -0x8000:
        out.append(b"\xd1" + _I16.pack(n))
    elif n >= -0x80000000:
        out.append(b"\xd2" + _I32.pack(n))
    elif n >= -0x8000000000000000:
        out.append(b"\xd3" + _I64.pack(n))
    else:
        raise OverflowError("Integer value out of range")


def _pack_header(n: int, fix: int, fix_max: int, codes: bytes, out: list) -> None:
    """A length header: ``fix | n`` up to ``fix_max``, then the 8- (where
    ``codes`` has three), 16- and 32-bit forms."""
    if n <= fix_max:
        out.append(_U8.pack(fix | n))
        return
    sizes = ((0xFF, _U8), (0xFFFF, _U16), (0xFFFFFFFF, _U32))[3 - len(codes):]
    for code, (limit, st) in zip(codes, sizes):
        if n <= limit:
            out.append(bytes((code,)) + st.pack(n))
            return
    raise ValueError(f"{n} is too large for msgpack")


def _pack(obj, out: list, depth: int) -> None:
    if depth < 0:
        raise ValueError("recursion limit exceeded.")
    if obj is None:
        out.append(b"\xc0")
    elif obj is True:
        out.append(b"\xc3")
    elif obj is False:
        out.append(b"\xc2")
    elif isinstance(obj, int):
        _pack_int(obj, out)
    elif isinstance(obj, float):
        out.append(b"\xcb" + _F64.pack(obj))
    elif isinstance(obj, (bytes, bytearray)):
        _pack_header(len(obj), 0, -1, b"\xc4\xc5\xc6", out)
        out.append(bytes(obj))
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _pack_header(len(data), 0xA0, 31, b"\xd9\xda\xdb", out)
        out.append(data)
    elif isinstance(obj, dict):
        _pack_header(len(obj), 0x80, 15, b"\xde\xdf", out)
        for k, v in obj.items():
            _pack(k, out, depth - 1)
            _pack(v, out, depth - 1)
    elif isinstance(obj, (list, tuple)):
        _pack_header(len(obj), 0x90, 15, b"\xdc\xdd", out)
        for v in obj:
            _pack(v, out, depth - 1)
    else:
        cls = type(obj)
        name = cls.__qualname__ if cls.__module__ == "builtins" else f"{cls.__module__}.{cls.__qualname__}"
        raise TypeError(f"can not serialize {name!r} object")


def packb(obj, use_bin_type: bool = True) -> bytes:
    if not use_bin_type:
        raise ValueError("this codec packs with use_bin_type=True only")
    out: list = []
    _pack(obj, out, _RECURSE_LIMIT)
    return b"".join(out)


class _Reader:
    def __init__(self, data):
        self.buf = memoryview(data).cast("B")
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.buf):
            raise ValueError("Unpack failed: incomplete input")
        view = self.buf[self.pos : end]
        self.pos = end
        return view

    def read(self, st: struct.Struct):
        return st.unpack(self.take(st.size))[0]

    def obj(self):
        b = self.read(_U8)
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0xA0 <= b <= 0xBF:
            return self.text(b & 0x1F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if b == 0xC0:
            return None
        if b == 0xC2:
            return False
        if b == 0xC3:
            return True
        if b in _SIZED:
            kind, st = _SIZED[b]
            n = self.read(st)
            if kind == "bin":
                return bytes(self.take(n))
            return getattr(self, kind)(n)
        if b in _NUMBERS:
            return self.read(_NUMBERS[b])
        raise FormatError(f"Unpack failed: byte 0x{b:02x} is reserved or an ext type")

    def text(self, n: int) -> str:
        return str(self.take(n), "utf-8")

    def array(self, n: int) -> list:
        return [self.obj() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        return out


_SIZED = {
    0xC4: ("bin", _U8), 0xC5: ("bin", _U16), 0xC6: ("bin", _U32),
    0xD9: ("text", _U8), 0xDA: ("text", _U16), 0xDB: ("text", _U32),
    0xDC: ("array", _U16), 0xDD: ("array", _U32),
    0xDE: ("map", _U16), 0xDF: ("map", _U32),
}
_NUMBERS = {
    0xCA: _F32, 0xCB: _F64,
    0xCC: _U8, 0xCD: _U16, 0xCE: _U32, 0xCF: _U64,
    0xD0: _I8, 0xD1: _I16, 0xD2: _I32, 0xD3: _I64,
}


def unpackb(data, raw: bool = False, strict_map_key: bool = False):
    if raw or strict_map_key:
        raise ValueError("this codec unpacks with raw=False, strict_map_key=False only")
    reader = _Reader(data)
    obj = reader.obj()
    if reader.pos != len(reader.buf):
        raise ExtraData("unpack(b) received extra data.")
    return obj
