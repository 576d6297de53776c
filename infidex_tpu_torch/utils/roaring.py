"""Roaring bitmap: compressed integer sets with fast set algebra.

Behavioral reference: Infidex ``Internalized/Roaring/`` (~2100 LoC C# with
AVX2/AVX-512/NEON popcount) — 16-bit-key chunking into array containers
(<= 4096 members, sorted uint16 array) or bitmap containers (1024 x uint64),
operations ``| & ^ andnot``, CreateFromSorted bulk build, serialization.

TPU note: on device, candidate sets are dense bool/int32 masks and popcount
is ``jnp.sum`` — this class is the host-side equivalent for WordMatcher doc
sets, fuzzy virtual terms, and delta/tombstone bookkeeping, built on numpy
(vectorized ops play the role of the reference's SIMD intrinsics).
"""

from __future__ import annotations

import struct
from typing import Dict, Iterator, List, Optional

import numpy as np

ARRAY_MAX = 4096          # container flips to bitmap above this cardinality
_BITS = 65536
_WORDS = _BITS // 64


class _Container:
    """One 16-bit chunk: sorted uint16 array or 1024-word bitmap."""

    __slots__ = ("array", "bitmap")

    def __init__(self, array: Optional[np.ndarray] = None,
                 bitmap: Optional[np.ndarray] = None):
        self.array = array        # sorted uint16, or None
        self.bitmap = bitmap      # uint64[1024], or None

    @classmethod
    def from_sorted(cls, vals: np.ndarray) -> "_Container":
        if vals.size <= ARRAY_MAX:
            return cls(array=vals.astype(np.uint16))
        bm = np.zeros(_WORDS, dtype=np.uint64)
        v = vals.astype(np.uint32)
        np.bitwise_or.at(bm, v >> 6, np.uint64(1) << (v & 63).astype(np.uint64))
        return cls(bitmap=bm)

    def cardinality(self) -> int:
        if self.array is not None:
            return int(self.array.size)
        return int(np.bitwise_count(self.bitmap).sum())

    def to_array(self) -> np.ndarray:
        """Members as sorted uint16."""
        if self.array is not None:
            return self.array
        bits = np.unpackbits(self.bitmap.view(np.uint8), bitorder="little")
        return np.nonzero(bits)[0].astype(np.uint16)

    def to_bitmap(self) -> np.ndarray:
        if self.bitmap is not None:
            return self.bitmap
        bm = np.zeros(_WORDS, dtype=np.uint64)
        v = self.array.astype(np.uint32)
        np.bitwise_or.at(bm, v >> 6, np.uint64(1) << (v & 63).astype(np.uint64))
        return bm

    def contains(self, low: int) -> bool:
        if self.array is not None:
            i = np.searchsorted(self.array, low)
            return bool(i < self.array.size and self.array[i] == low)
        return bool((self.bitmap[low >> 6] >> np.uint64(low & 63)) & np.uint64(1))

    @classmethod
    def _normalize(cls, c: "_Container") -> "_Container":
        n = c.cardinality()
        if c.bitmap is not None and n <= ARRAY_MAX:
            return cls(array=c.to_array())
        if c.array is not None and n > ARRAY_MAX:
            return cls(bitmap=c.to_bitmap())
        return c

    def op(self, other: "_Container", kind: str) -> Optional["_Container"]:
        if self.array is not None and other.array is not None:
            a, b = self.array, other.array
            if kind == "and":
                out = np.intersect1d(a, b, assume_unique=True)
            elif kind == "or":
                out = np.union1d(a, b)
            elif kind == "xor":
                out = np.setxor1d(a, b, assume_unique=True)
            else:
                out = np.setdiff1d(a, b, assume_unique=True)
            if out.size == 0:
                return None
            return _Container._normalize(_Container(array=out.astype(np.uint16)))
        x, y = self.to_bitmap(), other.to_bitmap()
        if kind == "and":
            bm = x & y
        elif kind == "or":
            bm = x | y
        elif kind == "xor":
            bm = x ^ y
        else:
            bm = x & ~y
        c = _Container(bitmap=bm)
        if c.cardinality() == 0:
            return None
        return _Container._normalize(c)


class RoaringBitmap:
    """Set of uint32 doc ids in roaring layout (RoaringBitmap.cs)."""

    def __init__(self) -> None:
        self._containers: Dict[int, _Container] = {}

    # ---------------- construction -----------------------------------
    @classmethod
    def from_sorted(cls, values) -> "RoaringBitmap":
        """Bulk build from an ascending array (CreateFromSorted)."""
        rb = cls()
        vals = np.asarray(values, dtype=np.uint32)
        if vals.size == 0:
            return rb
        keys = vals >> 16
        bounds = np.nonzero(np.diff(keys))[0] + 1
        starts = np.concatenate([[0], bounds, [vals.size]])
        for i in range(len(starts) - 1):
            seg = vals[starts[i] : starts[i + 1]]
            rb._containers[int(seg[0] >> 16)] = _Container.from_sorted(
                (seg & 0xFFFF).astype(np.uint32))
        return rb

    @classmethod
    def from_iterable(cls, values) -> "RoaringBitmap":
        vals = np.unique(np.asarray(list(values), dtype=np.uint32))
        return cls.from_sorted(vals)

    # ---------------- queries -----------------------------------------
    def __contains__(self, value: int) -> bool:
        c = self._containers.get(value >> 16)
        return c is not None and c.contains(value & 0xFFFF)

    def __len__(self) -> int:
        return sum(c.cardinality() for c in self._containers.values())

    def __iter__(self) -> Iterator[int]:
        for key in sorted(self._containers):
            base = key << 16
            for low in self._containers[key].to_array():
                yield base | int(low)

    def to_array(self) -> np.ndarray:
        parts: List[np.ndarray] = []
        for key in sorted(self._containers):
            arr = self._containers[key].to_array().astype(np.uint32)
            parts.append((np.uint32(key << 16) | arr))
        if not parts:
            return np.zeros(0, np.uint32)
        return np.concatenate(parts)

    # ---------------- set algebra --------------------------------------
    def _binary(self, other: "RoaringBitmap", kind: str) -> "RoaringBitmap":
        out = RoaringBitmap()
        if kind in ("or", "xor"):
            keys = set(self._containers) | set(other._containers)
        elif kind == "and":
            keys = set(self._containers) & set(other._containers)
        else:  # andnot
            keys = set(self._containers)
        for key in keys:
            a = self._containers.get(key)
            b = other._containers.get(key)
            if a is None:
                c = b if kind in ("or", "xor") else None
            elif b is None:
                c = a if kind in ("or", "xor", "andnot") else None
            else:
                c = a.op(b, kind)
            if c is not None:
                out._containers[key] = c
        return out

    def __or__(self, other):
        return self._binary(other, "or")

    def __and__(self, other):
        return self._binary(other, "and")

    def __xor__(self, other):
        return self._binary(other, "xor")

    def and_not(self, other):
        return self._binary(other, "andnot")

    # ---------------- serialization ------------------------------------
    MAGIC = b"ROAR"

    def serialize(self) -> bytes:
        out = bytearray(self.MAGIC)
        out += struct.pack("<I", len(self._containers))
        for key in sorted(self._containers):
            arr = self._containers[key].to_array()
            out += struct.pack("<HI", key, arr.size)
            out += arr.tobytes()
        return bytes(out)

    @classmethod
    def deserialize(cls, data: bytes) -> "RoaringBitmap":
        assert data[:4] == cls.MAGIC, "bad roaring magic"
        (n,) = struct.unpack_from("<I", data, 4)
        rb = cls()
        pos = 8
        for _ in range(n):
            key, size = struct.unpack_from("<HI", data, pos)
            pos += 6
            arr = np.frombuffer(data, dtype=np.uint16, count=size, offset=pos)
            pos += size * 2
            rb._containers[key] = _Container._normalize(
                _Container(array=arr.copy()))
        return rb
