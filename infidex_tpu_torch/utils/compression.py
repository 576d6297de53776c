"""L0 compression kernels: BitSet, CompactArray, DArray select, Elias-Fano,
GroupVarInt.

Behavioral reference: Infidex ``Indexing/Compression/*``:

* ``BitSet`` — plain 64-bit word bitset (BitSet.cs).
* ``CompactArray`` — n-bit packed integers (CompactArray.cs, "ported from
  CompactArray.zig"): width = bit length of the max value.
* ``DArray`` — constant-time select1 over a BitSet (DArray.cs): block
  inventory every 1024 set bits (position, or overflow pointer when a block
  spans > 2^16 bits), 16-bit sub-block offsets every 32 set bits.
* ``EliasFano`` — monotone sequences split into low bits (CompactArray,
  l = floor(log2(u/n)) + 1) and high bits (unary in a BitSet) with DArray
  select for O(1) ``get`` (EliasFano.cs).
* ``GroupVarInt`` — VarInt-GB: 4 ints per 1-byte tag, little-endian
  (GroupVarInt.cs). The numpy decode plays the role of the reference's
  SSSE3 shuffle-table decode.

These serve the on-disk segment format (index/segments.py); on device,
postings are stored decoded (HBM bandwidth is the budget, not capacity).
"""

from __future__ import annotations

import struct
from typing import List, Optional, Sequence, Tuple

import numpy as np

try:  # C++ GroupVarInt codec (native/_lib.cpp), same byte format
    from .. import native as _native
    if not _native.available:
        _native = None
except Exception:  # pragma: no cover
    _native = None


class BitSet:
    def __init__(self, length: int, words: Optional[np.ndarray] = None):
        self.length = length
        n_words = (length + 63) // 64
        if words is None:
            self.words = np.zeros(n_words, dtype=np.uint64)
        else:
            self.words = words.astype(np.uint64)

    def set(self, pos: int) -> None:
        self.words[pos >> 6] |= np.uint64(1) << np.uint64(pos & 63)

    def get(self, pos: int) -> bool:
        return bool((self.words[pos >> 6] >> np.uint64(pos & 63)) & np.uint64(1))

    def set_positions(self) -> np.ndarray:
        """All set-bit positions, ascending (vectorized)."""
        out = []
        for i, w in enumerate(self.words):
            w = int(w)
            base = i * 64
            while w:
                tz = (w & -w).bit_length() - 1
                pos = base + tz
                if pos < self.length:
                    out.append(pos)
                w &= w - 1
        return np.array(out, dtype=np.int64)


class CompactArray:
    """n-bit packed non-negative integers."""

    def __init__(self, data: np.ndarray, width: int, count: int):
        self.data = data.astype(np.uint64)
        self.width = width
        self.count = count
        self._mask = np.uint64((1 << width) - 1) if width < 64 else np.uint64(2**64 - 1)

    @staticmethod
    def create(values: Sequence[int]) -> "CompactArray":
        values = list(values)
        if not values:
            return CompactArray(np.zeros(0, np.uint64), 1, 0)
        max_v = max(values)
        width = max(max_v.bit_length(), 1)
        total_bits = len(values) * width
        data = np.zeros((total_bits + 63) // 64, dtype=np.uint64)
        for i, v in enumerate(values):
            CompactArray.set_from_zero(data, width, i, v)
        return CompactArray(data, width, len(values))

    @staticmethod
    def set_from_zero(data: np.ndarray, width: int, index: int, value: int) -> None:
        pos = index * width
        block = pos >> 6
        shift = pos & 63
        data[block] |= np.uint64((value << shift) & 0xFFFFFFFFFFFFFFFF)
        if shift + width > 64:
            data[block + 1] |= np.uint64(value >> (64 - shift))

    def get(self, index: int) -> int:
        pos = index * self.width
        block = pos >> 6
        shift = pos & 63
        if shift + self.width <= 64:
            return int((self.data[block] >> np.uint64(shift)) & self._mask)
        res_shift = 64 - shift
        lo = int(self.data[block]) >> shift
        hi = int(self.data[block + 1]) << res_shift
        return (lo | hi) & int(self._mask)

    def get_many(self, indices: np.ndarray) -> np.ndarray:
        """Vectorized get."""
        pos = indices.astype(np.int64) * self.width
        block = pos >> 6
        shift = (pos & 63).astype(np.uint64)
        data = self.data
        lo = data[block] >> shift
        next_block = np.minimum(block + 1, len(data) - 1) if len(data) else block
        spill = (shift.astype(np.int64) + self.width) > 64
        res_shift = (np.uint64(64) - shift) & np.uint64(63)
        hi = np.where(spill, data[next_block] << res_shift, np.uint64(0))
        return ((lo | hi) & self._mask).astype(np.int64)


class DArray:
    """Constant-time select1 (position of the i-th set bit)."""

    BLOCK_SIZE = 1024
    SUB_BLOCK_SIZE = 32
    MAX_IN_BLOCK_DISTANCE = 1 << 16

    def __init__(self, block_inventory: np.ndarray, sub_block_inventory: np.ndarray,
                 overflow_positions: np.ndarray, select1: bool = True):
        self.block_inventory = block_inventory      # int64: pos or -(ovf_idx+1)
        self.sub_block_inventory = sub_block_inventory  # uint16
        self.overflow_positions = overflow_positions    # int64
        self.select1 = select1
        self._positions: Optional[np.ndarray] = None

    @staticmethod
    def build(bitset: BitSet, select1: bool = True) -> "DArray":
        positions = bitset.set_positions()
        if not select1:
            all_pos = np.arange(bitset.length, dtype=np.int64)
            mask = np.ones(bitset.length, dtype=bool)
            mask[positions[positions < bitset.length]] = False
            positions = all_pos[mask]

        block_inv: List[int] = []
        sub_inv: List[int] = []
        overflow: List[int] = []
        n = len(positions)
        for b_start in range(0, n, DArray.BLOCK_SIZE):
            block = positions[b_start : b_start + DArray.BLOCK_SIZE]
            first, last = int(block[0]), int(block[-1])
            if last - first < DArray.MAX_IN_BLOCK_DISTANCE:
                block_inv.append(first)
                for s in range(0, len(block), DArray.SUB_BLOCK_SIZE):
                    sub_inv.append(int(block[s]) - first)
            else:
                block_inv.append(-(len(overflow) + 1))
                overflow.extend(int(p) for p in block)
                for s in range(0, len(block), DArray.SUB_BLOCK_SIZE):
                    sub_inv.append(0)
        d = DArray(np.array(block_inv, np.int64),
                   np.array(sub_inv, np.uint16),
                   np.array(overflow, np.int64), select1)
        d._positions = positions
        return d

    def select(self, bitset: BitSet, rank: int) -> int:
        block = rank // self.BLOCK_SIZE
        inv = int(self.block_inventory[block])
        if inv < 0:
            ovf_start = -inv - 1
            return int(self.overflow_positions[ovf_start + rank % self.BLOCK_SIZE])
        sub = rank // self.SUB_BLOCK_SIZE
        start = inv + int(self.sub_block_inventory[sub])
        remaining = rank % self.SUB_BLOCK_SIZE
        # scan from `start` for the `remaining`-th matching bit
        pos = start
        words = bitset.words
        while True:
            wi = pos >> 6
            w = int(words[wi])
            if not self.select1:
                w = ~w & 0xFFFFFFFFFFFFFFFF
            w >>= pos & 63
            while w:
                if w & 1:
                    if remaining == 0:
                        return pos
                    remaining -= 1
                w >>= 1
                pos += 1
            pos = (wi + 1) * 64  # rest of word wi is zero; resume at next word

    def select_many(self, ranks: np.ndarray) -> np.ndarray:
        """Vectorized select using the cached position table."""
        if self._positions is not None:
            return self._positions[ranks]
        raise ValueError("select_many requires a built DArray")


class EliasFano:
    """Monotone integer sequence with O(1) random access."""

    def __init__(self, high_bits: BitSet, high_select: Optional[DArray],
                 low_bits: CompactArray, count: int, l: int):
        self.high_bits = high_bits
        self.high_select = high_select
        self.low_bits = low_bits
        self.count = count
        self.l = l

    @staticmethod
    def encode(data: Sequence[int]) -> "EliasFano":
        data = list(data)
        if not data:
            return EliasFano(BitSet(0), None, CompactArray(np.zeros(0, np.uint64), 0, 0), 0, 0)
        u = data[-1]
        n = len(data)
        l = 0
        if u > n:
            l = (u // n).bit_length()
        l_mask = (1 << l) - 1
        max_h = u >> l
        high = BitSet(max_h + n)
        low_data = np.zeros((n * l + 63) // 64, dtype=np.uint64)
        for i, val in enumerate(data):
            if l > 0:
                CompactArray.set_from_zero(low_data, l, i, val & l_mask)
            high.set((val >> l) + i)
        low = CompactArray(low_data, l, n) if l > 0 else CompactArray(low_data, 0, n)
        sel = DArray.build(high, select1=True)
        return EliasFano(high, sel, low, n, l)

    def get(self, index: int) -> int:
        if index < 0 or index >= self.count:
            raise IndexError(index)
        pos = self.high_select.select(self.high_bits, index)
        high = pos - index
        if self.l == 0:
            return high
        return (high << self.l) | self.low_bits.get(index)

    def get_many(self, indices: np.ndarray) -> np.ndarray:
        pos = self.high_select.select_many(indices)
        high = pos - indices
        if self.l == 0:
            return high.astype(np.int64)
        return (high.astype(np.int64) << self.l) | self.low_bits.get_many(indices)

    def to_list(self) -> List[int]:
        return [self.get(i) for i in range(self.count)]

    # -- serialization ---------------------------------------------------
    def write(self) -> bytes:
        out = bytearray()
        out += struct.pack("<ii", self.count, self.l)
        out += struct.pack("<ii", self.high_bits.length, len(self.high_bits.words))
        out += self.high_bits.words.tobytes()
        out += struct.pack("<iii", len(self.high_select.block_inventory)
                           if self.high_select else 0,
                           len(self.high_select.sub_block_inventory)
                           if self.high_select else 0,
                           len(self.high_select.overflow_positions)
                           if self.high_select else 0)
        if self.high_select:
            out += self.high_select.block_inventory.tobytes()
            out += self.high_select.sub_block_inventory.tobytes()
            out += self.high_select.overflow_positions.tobytes()
        out += struct.pack("<ii", self.low_bits.width, self.low_bits.count)
        out += struct.pack("<i", len(self.low_bits.data))
        out += self.low_bits.data.tobytes()
        return bytes(out)

    @staticmethod
    def read(buf: bytes, offset: int = 0) -> Tuple["EliasFano", int]:
        count, l = struct.unpack_from("<ii", buf, offset); offset += 8
        hb_len, hb_words = struct.unpack_from("<ii", buf, offset); offset += 8
        words = np.frombuffer(buf, np.uint64, hb_words, offset); offset += hb_words * 8
        high = BitSet(hb_len, words.copy())
        nb, ns, no = struct.unpack_from("<iii", buf, offset); offset += 12
        bi = np.frombuffer(buf, np.int64, nb, offset).copy(); offset += nb * 8
        si = np.frombuffer(buf, np.uint16, ns, offset).copy(); offset += ns * 2
        ov = np.frombuffer(buf, np.int64, no, offset).copy(); offset += no * 8
        sel = DArray(bi, si, ov, True)
        sel._positions = high.set_positions()
        width, cnt = struct.unpack_from("<ii", buf, offset); offset += 8
        (nd,) = struct.unpack_from("<i", buf, offset); offset += 4
        data = np.frombuffer(buf, np.uint64, nd, offset).copy(); offset += nd * 8
        low = CompactArray(data, width, cnt)
        return EliasFano(high, sel, low, count, l), offset


# ----------------------------------------------------------------------
# GroupVarInt (VarInt-GB)


def group_varint_encode(data: Sequence[int]) -> bytes:
    """4 ints per 1-byte tag; final partial group writes only `count` ints."""
    if _native is not None:
        return _native.gvi_encode(np.asarray(data, dtype=np.uint32))
    out = bytearray()
    data = list(data)
    i = 0
    n = len(data)
    while i < n:
        remaining = n - i
        group = data[i : i + 4] + [0] * max(0, 4 - remaining)
        lens = [max(1, (v.bit_length() + 7) // 8) for v in group]
        lens = [min(le, 4) for le in lens]
        tag = ((lens[0] - 1) << 6) | ((lens[1] - 1) << 4) | \
              ((lens[2] - 1) << 2) | (lens[3] - 1)
        out.append(tag)
        count = min(4, remaining)
        for k in range(count):
            v = group[k]
            for b in range(lens[k]):
                out.append((v >> (8 * b)) & 0xFF)
        i += count
    return bytes(out)


_GV_LENS = np.zeros((256, 4), dtype=np.int64)
for _tag in range(256):
    _GV_LENS[_tag] = [(_tag >> 6) + 1, ((_tag >> 4) & 3) + 1,
                      ((_tag >> 2) & 3) + 1, (_tag & 3) + 1]


def group_varint_decode(buf: bytes, count: int) -> Tuple[np.ndarray, int]:
    """Decode `count` ints; returns (values, bytes_read)."""
    if _native is not None and count > 0:
        vals, consumed = _native.gvi_decode(bytes(buf), count)
        return vals.astype(np.int64), consumed
    out = np.zeros(count, dtype=np.int64)
    data = np.frombuffer(buf, dtype=np.uint8)
    pos = 0
    i = 0
    while i < count:
        tag = int(data[pos])
        pos += 1
        lens = _GV_LENS[tag]
        take = min(4, count - i)
        for k in range(take):
            le = int(lens[k])
            v = 0
            for b in range(le):
                v |= int(data[pos + b]) << (8 * b)
            pos += le
            out[i] = v
            i += 1
    return out, pos


def delta_encode(sorted_ids: np.ndarray) -> np.ndarray:
    """Monotone doc ids -> first value + gaps."""
    if sorted_ids.size == 0:
        return sorted_ids
    out = np.empty_like(sorted_ids)
    out[0] = sorted_ids[0]
    np.subtract(sorted_ids[1:], sorted_ids[:-1], out=out[1:])
    return out


def delta_decode(deltas: np.ndarray) -> np.ndarray:
    return np.cumsum(deltas)


# ----------------------------------------------------------------------
# Byte<->float weight quantization (Utilities/ByteAsFloat.cs): posting
# weights live as uint8 (4x memory saving); floats recovered on demand.
# The device path keeps weights as uint8 tensors and casts on the VPU.


def float_to_byte(value: float) -> int:
    """[0,1]-ish weight -> byte with banker's rounding (ByteAsFloat.cs)."""
    import math
    v = value * 255.0
    f = math.floor(v)
    frac = v - f
    if frac > 0.5 or (frac == 0.5 and f % 2 == 1):
        f += 1
    return max(0, min(int(f), 255))


def byte_to_float(b: int) -> float:
    return (b & 0xFF) / 255.0
