"""The subset of the MessagePack format that checkpoints use, written and
read without the ``msgpack`` package (the card's machine has none).

Maps with string keys, arrays, strings, binary blobs (bin 8/16/32) and
non-negative integers, each in the smallest form the format allows: the
bytes of ``pack`` equal ``msgpack.packb(obj, use_bin_type=True)`` for
such objects, in the map's own key order. ``pack`` streams: a ``Blob``
writes its header and then its buffer, so a tensor of a gigabyte is
never copied into one ``bytes`` object with the rest. ``unpack`` reads
one object from a binary file, each bin as a ``bytearray`` filled in
place; anything outside the subset raises ``ValueError``.
"""
from __future__ import annotations

import io
import struct
from typing import Any, Callable


class Blob:
    """A bin value of ``nbytes`` bytes that ``write_to(write)`` writes in
    one or more pieces."""

    def __init__(self, nbytes: int, write_to: Callable[[Callable], None]):
        self.nbytes, self.write_to = int(nbytes), write_to


def _head(small: int, small_max: int, codes, n: int) -> bytes:
    """The header of a sized value: ``small | n`` up to ``small_max``
    (None: no short form), else the 8-, 16- or 32-bit length forms
    ``codes`` (None where the form does not exist)."""
    if small is not None and n <= small_max:
        return bytes([small | n])
    for code, fmt, top in zip(codes, (">B", ">H", ">I"),
                              (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code is not None and n <= top:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"a length of {n} does not fit MessagePack")


def _uint(v: int) -> bytes:
    if v < 0:
        raise ValueError(f"negative integer {v}: not in the subset")
    if v <= 0x7F:
        return bytes([v])
    for code, fmt, top in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                           (0xCE, ">I", 0xFFFFFFFF),
                           (0xCF, ">Q", 0xFFFFFFFFFFFFFFFF)):
        if v <= top:
            return bytes([code]) + struct.pack(fmt, v)
    raise ValueError(f"integer {v} does not fit MessagePack")


def pack(obj: Any, write: Callable[[Any], Any]) -> None:
    """Write ``obj`` to ``write`` in MessagePack."""
    if isinstance(obj, bool) or obj is None or isinstance(obj, float):
        raise ValueError(f"{type(obj).__name__} is not in the subset")
    if isinstance(obj, dict):
        write(_head(0x80, 15, (None, 0xDE, 0xDF), len(obj)))
        for k, v in obj.items():
            if not isinstance(k, str):
                raise ValueError(f"map key {k!r} is not a string")
            pack(k, write)
            pack(v, write)
    elif isinstance(obj, (list, tuple)):
        write(_head(0x90, 15, (None, 0xDC, 0xDD), len(obj)))
        for v in obj:
            pack(v, write)
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        write(_head(0xA0, 31, (0xD9, 0xDA, 0xDB), len(data)))
        write(data)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = memoryview(obj).cast("B")
        write(_head(None, 0, (0xC4, 0xC5, 0xC6), data.nbytes))
        write(data)
    elif isinstance(obj, Blob):
        write(_head(None, 0, (0xC4, 0xC5, 0xC6), obj.nbytes))
        obj.write_to(write)
    elif isinstance(obj, int):
        write(_uint(obj))
    else:
        raise ValueError(f"{type(obj).__name__} is not in the subset")


def packb(obj: Any) -> bytes:
    """``obj`` packed into one bytes object."""
    buf = io.BytesIO()
    pack(obj, buf.write)
    return buf.getvalue()


def _read(f, n: int) -> bytes:
    data = f.read(n)
    if len(data) != n:
        raise ValueError("truncated MessagePack data")
    return data


def unpack(f) -> Any:
    """Read one object from the binary file ``f``."""
    b = _read(f, 1)[0]
    if b <= 0x7F:
        return b
    if 0x80 <= b <= 0x8F or b in (0xDE, 0xDF):
        n = b & 0x0F if b <= 0x8F else struct.unpack(
            ">H" if b == 0xDE else ">I", _read(f, 2 if b == 0xDE else 4))[0]
        out = {}
        for _ in range(n):
            k = unpack(f)
            out[k] = unpack(f)
        return out
    if 0x90 <= b <= 0x9F or b in (0xDC, 0xDD):
        n = b & 0x0F if b <= 0x9F else struct.unpack(
            ">H" if b == 0xDC else ">I", _read(f, 2 if b == 0xDC else 4))[0]
        return [unpack(f) for _ in range(n)]
    if 0xA0 <= b <= 0xBF or b in (0xD9, 0xDA, 0xDB):
        if b <= 0xBF:
            n = b & 0x1F
        else:
            size = {0xD9: 1, 0xDA: 2, 0xDB: 4}[b]
            n = int.from_bytes(_read(f, size), "big")
        return _read(f, n).decode("utf-8")
    if b in (0xC4, 0xC5, 0xC6):
        n = int.from_bytes(_read(f, {0xC4: 1, 0xC5: 2, 0xC6: 4}[b]), "big")
        out = bytearray(n)
        if f.readinto(out) != n:
            raise ValueError("truncated MessagePack data")
        return out
    if b in (0xCC, 0xCD, 0xCE, 0xCF):
        return int.from_bytes(_read(f, {0xCC: 1, 0xCD: 2, 0xCE: 4,
                                        0xCF: 8}[b]), "big")
    raise ValueError(f"MessagePack type byte 0x{b:02x} is not in the subset")


def unpackb(data) -> Any:
    """One object from a bytes-like value."""
    return unpack(io.BytesIO(data))
