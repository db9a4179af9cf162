"""A msgpack writer and reader for the subset the checkpoint format uses.

The checkpoint files are msgpack, as the JAX package writes them with
``msgpack.packb(payload, use_bin_type=True)``. This module writes the same
bytes and reads them back without the ``msgpack`` package: nil, bool,
ints of every width (positive and negative fixint, uint8-64, int8-64),
float32/64, str (fixstr, str8/16/32), bin8/16/32, arrays and maps (fix,
16, 32). Each value takes the smallest encoding msgpack's own packer
picks, so ``packb(obj) == msgpack.packb(obj, use_bin_type=True)``.

* :func:`dump` streams to a file: a bin value (``bytes``, ``bytearray`` or
  a ``memoryview``, e.g. of a numpy array's memory) goes to the file as it
  is, never joined into one payload-sized object.
* :func:`unpackb` parses a buffer by slicing one ``memoryview``; a bin
  value is a zero-copy ``memoryview`` slice of it (equal to the ``bytes``
  that ``msgpack.unpackb`` gives).

Ext types, reserved bytes, truncated input and trailing bytes raise
``ValueError``; a value this subset cannot hold raises ``TypeError`` (an
unsupported type), ``OverflowError`` (an int outside [-2^63, 2^64)) or
``ValueError`` (a str or bin of 2^32 bytes or more).
"""
from __future__ import annotations

import io
import struct

_BIN_MAX = 2**32 - 1
# a header buffer is flushed once it holds this much, and before any bin
# value of at least this size, which is written straight from its buffer
_FLUSH = 1 << 16


def _int_header(v: int) -> bytes:
    if v < 0:
        if v >= -32:
            return struct.pack(">b", v)
        if v >= -(1 << 7):
            return b"\xd0" + struct.pack(">b", v)
        if v >= -(1 << 15):
            return b"\xd1" + struct.pack(">h", v)
        if v >= -(1 << 31):
            return b"\xd2" + struct.pack(">i", v)
        if v >= -(1 << 63):
            return b"\xd3" + struct.pack(">q", v)
        raise OverflowError(f"int {v} is too small for msgpack")
    if v < 128:
        return bytes((v,))
    if v < 1 << 8:
        return b"\xcc" + bytes((v,))
    if v < 1 << 16:
        return b"\xcd" + struct.pack(">H", v)
    if v < 1 << 32:
        return b"\xce" + struct.pack(">I", v)
    if v < 1 << 64:
        return b"\xcf" + struct.pack(">Q", v)
    raise OverflowError(f"int {v} is too big for msgpack")


def _len_header(n: int, fix_base, fix_max, codes, what) -> bytes:
    """The header of a str, bin, array or map of length ``n``: the fix form
    below ``fix_max`` (when there is one), else the 8/16/32-bit length."""
    if fix_base is not None and n < fix_max:
        return bytes((fix_base | n,))
    for code, fmt, top in zip(codes, (">B", ">H", ">I"),
                              (1 << 8, 1 << 16, 1 << 32)):
        if code is not None and n < top:
            return bytes((code,)) + struct.pack(fmt, n)
    raise ValueError(f"{what} object is too large ({n} bytes or items; "
                     f"msgpack holds at most {_BIN_MAX})")


class _Writer:
    def __init__(self, f):
        self.f = f
        self.buf = bytearray()

    def flush(self):
        if self.buf:
            self.f.write(self.buf)
            self.buf = bytearray()

    def put(self, b):
        self.buf += b
        if len(self.buf) >= _FLUSH:
            self.flush()

    def pack(self, obj):
        if obj is None:
            self.put(b"\xc0")
        elif obj is True:
            self.put(b"\xc3")
        elif obj is False:
            self.put(b"\xc2")
        elif isinstance(obj, int):
            self.put(_int_header(int(obj)))
        elif isinstance(obj, float):
            self.put(b"\xcb" + struct.pack(">d", obj))
        elif isinstance(obj, str):
            raw = obj.encode("utf-8")
            self.put(_len_header(len(raw), 0xA0, 32, (0xD9, 0xDA, 0xDB),
                                 "str") + raw)
        elif isinstance(obj, (bytes, bytearray, memoryview)):
            view = memoryview(obj)
            if view.format != "B" or view.ndim != 1:
                view = view.cast("B")
            self.put(_len_header(view.nbytes, None, 0, (0xC4, 0xC5, 0xC6),
                                 type(obj).__name__))
            if view.nbytes >= _FLUSH:
                self.flush()
                self.f.write(view)
            else:
                self.put(view)
        elif isinstance(obj, (list, tuple)):
            self.put(_len_header(len(obj), 0x90, 16, (None, 0xDC, 0xDD),
                                 "list"))
            for item in obj:
                self.pack(item)
        elif isinstance(obj, dict):
            self.put(_len_header(len(obj), 0x80, 16, (None, 0xDE, 0xDF),
                                 "dict"))
            for k, v in obj.items():
                self.pack(k)
                self.pack(v)
        else:
            raise TypeError(f"can not serialize {type(obj).__name__!r} "
                            "object")


def dump(obj, f) -> None:
    """Write ``obj`` to the binary file ``f`` as msgpack."""
    w = _Writer(f)
    w.pack(obj)
    w.flush()


def packb(obj) -> bytes:
    """``obj`` as msgpack bytes (``msgpack.packb(obj, use_bin_type=True)``)."""
    f = io.BytesIO()
    dump(obj, f)
    return f.getvalue()


# first byte -> (struct format of the fixed-size value, its size)
_FIXED = {0xCA: (">f", 4), 0xCB: (">d", 8), 0xCC: (">B", 1),
          0xCD: (">H", 2), 0xCE: (">I", 4), 0xCF: (">Q", 8),
          0xD0: (">b", 1), 0xD1: (">h", 2), 0xD2: (">i", 4), 0xD3: (">q", 8)}
# first byte -> (kind, struct format of the length, its size)
_SIZED = {0xC4: ("bin", ">B", 1), 0xC5: ("bin", ">H", 2),
          0xC6: ("bin", ">I", 4), 0xD9: ("str", ">B", 1),
          0xDA: ("str", ">H", 2), 0xDB: ("str", ">I", 4),
          0xDC: ("array", ">H", 2), 0xDD: ("array", ">I", 4),
          0xDE: ("map", ">H", 2), 0xDF: ("map", ">I", 4)}
_EXT = {0xC7, 0xC8, 0xC9, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8}


class _Reader:
    def __init__(self, buf):
        self.view = memoryview(buf).cast("B")
        self.pos = 0

    def take(self, n):
        end = self.pos + n
        if end > len(self.view):
            raise ValueError(
                f"truncated msgpack: {n} bytes wanted at offset {self.pos}, "
                f"{len(self.view) - self.pos} left")
        out = self.view[self.pos:end]
        self.pos = end
        return out

    def unpack(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F)
        if b == 0xC0:
            return None
        if b == 0xC2:
            return False
        if b == 0xC3:
            return True
        if b in _FIXED:
            fmt, size = _FIXED[b]
            return struct.unpack(fmt, self.take(size))[0]
        if b in _SIZED:
            kind, fmt, size = _SIZED[b]
            n = struct.unpack(fmt, self.take(size))[0]
            return getattr(self, kind)(n)
        if b in _EXT:
            raise ValueError(f"msgpack ext type 0x{b:02x} at offset "
                             f"{self.pos - 1} is not supported")
        raise ValueError(f"reserved msgpack byte 0x{b:02x} at offset "
                         f"{self.pos - 1}")

    def bin(self, n):
        return self.take(n)

    def str(self, n):
        return str(self.take(n), "utf-8")

    def array(self, n):
        return [self.unpack() for _ in range(n)]

    def map(self, n):
        out = {}
        for _ in range(n):
            k = self.unpack()
            out[k] = self.unpack()
        return out


def unpackb(buf):
    """Parse one msgpack object filling all of ``buf`` (any buffer)."""
    r = _Reader(buf)
    obj = r.unpack()
    if r.pos != len(r.view):
        raise ValueError(f"{len(r.view) - r.pos} bytes of trailing data "
                         "after the msgpack object")
    return obj
