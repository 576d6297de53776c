"""Safe tagged binary codec for index persistence.

A restricted, self-describing binary format covering exactly the value
types index snapshots contain: ``None``, ``bool``, ``int``, ``float``,
``str``, ``bytes``, ``list``, ``tuple``, ``dict`` and numeric/bool numpy
arrays. Decoding constructs only these types — unlike pickle there is no
code-execution surface, so loading a tampered index file can at worst
raise :class:`CodecError` (the reference's INFDX2 format is likewise a
pure data format; ``Indexing/IndexPersistence.cs:15-66``).

Layout: every value is ``tag:uint8`` followed by tag-specific payload.
Counts and lengths are unsigned LEB128 varints. Arrays store
``dtype-string, ndim, shape..., raw little-endian bytes``.
"""

from __future__ import annotations

import struct
from typing import Any, BinaryIO

import numpy as np

__all__ = ["encode", "decode", "CodecError"]


class CodecError(Exception):
    """Raised on malformed or out-of-contract data."""


# Tags
_T_NONE = 0x00
_T_FALSE = 0x01
_T_TRUE = 0x02
_T_INT64 = 0x03
_T_BIGINT = 0x04  # length-prefixed signed two's-complement bytes
_T_FLOAT64 = 0x05
_T_STR = 0x06
_T_BYTES = 0x07
_T_LIST = 0x08
_T_TUPLE = 0x09
_T_DICT = 0x0A
_T_NDARRAY = 0x0B
# Homogeneous list-of-str fast path: count, char-length array (uint32 raw),
# one UTF-8 blob. Decoding is one blob decode + count slices instead of
# count tag dispatches — the difference between a 20s and a 2s load of a
# million-document snapshot.
_T_STRLIST = 0x0C

_INT64_MIN = -(1 << 63)
_INT64_MAX = (1 << 63) - 1

# Only plain numeric/bool dtypes may be materialized on decode. Object or
# structured dtypes would reintroduce arbitrary-object construction.
_ALLOWED_DTYPES = frozenset(
    ["b1", "i1", "i2", "i4", "i8", "u1", "u2", "u4", "u8", "f2", "f4", "f8"]
)

_MAX_DEPTH = 64


def _write_varint(out: BinaryIO, value: int) -> None:
    if value < 0:
        raise CodecError("varint must be non-negative")
    while True:
        byte = value & 0x7F
        value >>= 7
        if value:
            out.write(bytes((byte | 0x80,)))
        else:
            out.write(bytes((byte,)))
            return


def _read_varint(buf: memoryview, pos: int) -> tuple:
    result = 0
    shift = 0
    while True:
        if pos >= len(buf):
            raise CodecError("truncated varint")
        byte = buf[pos]
        pos += 1
        result |= (byte & 0x7F) << shift
        if not (byte & 0x80):
            return result, pos
        shift += 7
        if shift > 63:
            raise CodecError("varint too long")


def _encode_value(out: BinaryIO, value: Any, depth: int) -> None:
    if depth > _MAX_DEPTH:
        raise CodecError("value nesting too deep")
    if value is None:
        out.write(bytes((_T_NONE,)))
    elif value is True:
        out.write(bytes((_T_TRUE,)))
    elif value is False:
        out.write(bytes((_T_FALSE,)))
    elif isinstance(value, (int, np.integer)) and not isinstance(value, bool):
        iv = int(value)
        if _INT64_MIN <= iv <= _INT64_MAX:
            out.write(bytes((_T_INT64,)))
            out.write(struct.pack("<q", iv))
        else:
            raw = iv.to_bytes((iv.bit_length() + 8) // 8, "little", signed=True)
            out.write(bytes((_T_BIGINT,)))
            _write_varint(out, len(raw))
            out.write(raw)
    elif isinstance(value, (float, np.floating)):
        out.write(bytes((_T_FLOAT64,)))
        out.write(struct.pack("<d", float(value)))
    elif isinstance(value, str):
        raw = value.encode("utf-8", "surrogatepass")
        out.write(bytes((_T_STR,)))
        _write_varint(out, len(raw))
        out.write(raw)
    elif isinstance(value, (bytes, bytearray)):
        out.write(bytes((_T_BYTES,)))
        _write_varint(out, len(value))
        out.write(bytes(value))
    elif isinstance(value, list):
        if len(value) >= 8 and all(type(item) is str for item in value):
            blob = "".join(value).encode("utf-8", "surrogatepass")
            lengths = np.array([len(s) for s in value], dtype=np.uint32)
            out.write(bytes((_T_STRLIST,)))
            _write_varint(out, len(value))
            out.write(lengths.tobytes())
            _write_varint(out, len(blob))
            out.write(blob)
            return
        out.write(bytes((_T_LIST,)))
        _write_varint(out, len(value))
        for item in value:
            _encode_value(out, item, depth + 1)
    elif isinstance(value, tuple):
        out.write(bytes((_T_TUPLE,)))
        _write_varint(out, len(value))
        for item in value:
            _encode_value(out, item, depth + 1)
    elif isinstance(value, dict):
        out.write(bytes((_T_DICT,)))
        _write_varint(out, len(value))
        for key, item in value.items():
            _encode_value(out, key, depth + 1)
            _encode_value(out, item, depth + 1)
    elif isinstance(value, np.ndarray):
        arr = np.ascontiguousarray(value)
        code = arr.dtype.kind + str(arr.dtype.itemsize)
        if code not in _ALLOWED_DTYPES:
            raise CodecError(f"unsupported array dtype {arr.dtype}")
        if arr.dtype.byteorder == ">":
            arr = arr.astype(arr.dtype.newbyteorder("<"))
        out.write(bytes((_T_NDARRAY,)))
        code_raw = code.encode("ascii")
        _write_varint(out, len(code_raw))
        out.write(code_raw)
        _write_varint(out, arr.ndim)
        for dim in arr.shape:
            _write_varint(out, dim)
        raw = arr.tobytes()
        _write_varint(out, len(raw))
        out.write(raw)
    else:
        raise CodecError(
            f"type {type(value).__name__} is outside the persistence contract")


def _decode_value(buf: memoryview, pos: int, depth: int) -> tuple:
    if depth > _MAX_DEPTH:
        raise CodecError("value nesting too deep")
    if pos >= len(buf):
        raise CodecError("truncated value")
    tag = buf[pos]
    pos += 1
    if tag == _T_NONE:
        return None, pos
    if tag == _T_TRUE:
        return True, pos
    if tag == _T_FALSE:
        return False, pos
    if tag == _T_INT64:
        if pos + 8 > len(buf):
            raise CodecError("truncated int64")
        return struct.unpack_from("<q", buf, pos)[0], pos + 8
    if tag == _T_BIGINT:
        length, pos = _read_varint(buf, pos)
        if pos + length > len(buf):
            raise CodecError("truncated bigint")
        return int.from_bytes(buf[pos : pos + length], "little", signed=True), pos + length
    if tag == _T_FLOAT64:
        if pos + 8 > len(buf):
            raise CodecError("truncated float64")
        return struct.unpack_from("<d", buf, pos)[0], pos + 8
    if tag == _T_STR:
        length, pos = _read_varint(buf, pos)
        if pos + length > len(buf):
            raise CodecError("truncated string")
        return bytes(buf[pos : pos + length]).decode("utf-8", "surrogatepass"), pos + length
    if tag == _T_BYTES:
        length, pos = _read_varint(buf, pos)
        if pos + length > len(buf):
            raise CodecError("truncated bytes")
        return bytes(buf[pos : pos + length]), pos + length
    if tag in (_T_LIST, _T_TUPLE):
        count, pos = _read_varint(buf, pos)
        items = []
        for _ in range(count):
            item, pos = _decode_value(buf, pos, depth + 1)
            items.append(item)
        return (items if tag == _T_LIST else tuple(items)), pos
    if tag == _T_DICT:
        count, pos = _read_varint(buf, pos)
        result = {}
        for _ in range(count):
            key, pos = _decode_value(buf, pos, depth + 1)
            if isinstance(key, (list, dict, np.ndarray)):
                raise CodecError("unhashable dict key in stream")
            value, pos = _decode_value(buf, pos, depth + 1)
            result[key] = value
        return result, pos
    if tag == _T_NDARRAY:
        code_len, pos = _read_varint(buf, pos)
        code = bytes(buf[pos : pos + code_len]).decode("ascii")
        pos += code_len
        if code not in _ALLOWED_DTYPES:
            raise CodecError(f"disallowed array dtype code {code!r}")
        ndim, pos = _read_varint(buf, pos)
        if ndim > 8:
            raise CodecError("array rank too large")
        shape = []
        for _ in range(ndim):
            dim, pos = _read_varint(buf, pos)
            shape.append(dim)
        length, pos = _read_varint(buf, pos)
        if pos + length > len(buf):
            raise CodecError("truncated array data")
        dtype = np.dtype("<" + code[0] + code[1:])
        count = int(np.prod(shape, dtype=np.int64)) if shape else 1
        if count * dtype.itemsize != length:
            raise CodecError("array length does not match shape")
        arr = np.frombuffer(buf[pos : pos + length], dtype=dtype).reshape(shape).copy()
        return arr, pos + length
    if tag == _T_STRLIST:
        count, pos = _read_varint(buf, pos)
        if pos + 4 * count > len(buf):
            raise CodecError("truncated string-list lengths")
        lengths = np.frombuffer(buf[pos : pos + 4 * count], dtype="<u4")
        pos += 4 * count
        blob_len, pos = _read_varint(buf, pos)
        if pos + blob_len > len(buf):
            raise CodecError("truncated string-list blob")
        text = bytes(buf[pos : pos + blob_len]).decode("utf-8", "surrogatepass")
        pos += blob_len
        if int(lengths.sum()) != len(text):
            raise CodecError("string-list lengths do not match blob")
        items = []
        start = 0
        for ln in lengths.tolist():
            items.append(text[start : start + ln])
            start += ln
        return items, pos
    raise CodecError(f"unknown tag 0x{tag:02x}")


def encode(value: Any) -> bytes:
    """Serialize *value* to the safe tagged binary format."""
    import io

    out = io.BytesIO()
    _encode_value(out, value, 0)
    return out.getvalue()


def decode(blob: bytes) -> Any:
    """Deserialize a blob produced by :func:`encode`.

    Raises :class:`CodecError` on any malformed input; never executes code.
    """
    value, pos = _decode_value(memoryview(blob), 0, 0)
    if pos != len(blob):
        raise CodecError(f"{len(blob) - pos} trailing bytes after value")
    return value
