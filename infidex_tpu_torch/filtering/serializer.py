"""INFISCRIPT-V1 portable bytecode serialization.

Behavioral reference: Infidex ``Filtering/BytecodeSerializer.cs`` and
``ConstantPool.Serialize`` — magic "INFISCRIPT-V1" (ASCII) + ushort version,
length-prefixed constant pool (type-tagged: 1=string, 2=double, 3=array of
strings), instruction stream (opcode byte [+ int32 operand for
PUSH_FIELD/PUSH_CONST/JUMP*]). Strings use .NET BinaryWriter's 7-bit-encoded
length prefix + UTF-8 so bytecode round-trips byte-compatibly with the
reference format.
"""

from __future__ import annotations

import io
import struct
from typing import List

from .compiler import (OPERAND_OPCODES, CompiledFilter, ConstantPool,
                       Instruction, Opcode)

MAGIC = b"INFISCRIPT-V1"
VERSION = 1

_CONST_STRING = 1
_CONST_NUMBER = 2
_CONST_ARRAY = 3


def _write_7bit(out: io.BytesIO, value: int) -> None:
    while value >= 0x80:
        out.write(bytes([(value & 0x7F) | 0x80]))
        value >>= 7
    out.write(bytes([value]))


def _read_7bit(buf: io.BytesIO) -> int:
    shift = 0
    result = 0
    while True:
        b = buf.read(1)
        if not b:
            raise ValueError("truncated 7-bit encoded int")
        byte = b[0]
        result |= (byte & 0x7F) << shift
        if not byte & 0x80:
            return result
        shift += 7


def _write_string(out: io.BytesIO, s: str) -> None:
    data = s.encode("utf-8")
    _write_7bit(out, len(data))
    out.write(data)


def _read_string(buf: io.BytesIO) -> str:
    length = _read_7bit(buf)
    return buf.read(length).decode("utf-8")


def _serialize_pool(pool: ConstantPool) -> bytes:
    out = io.BytesIO()
    items = pool.items()
    out.write(struct.pack("<i", len(items)))
    for c in items:
        if isinstance(c, str):
            out.write(bytes([_CONST_STRING]))
            _write_string(out, c)
        elif isinstance(c, float):
            out.write(bytes([_CONST_NUMBER]))
            out.write(struct.pack("<d", c))
        elif isinstance(c, list):
            out.write(bytes([_CONST_ARRAY]))
            out.write(struct.pack("<i", len(c)))
            for item in c:
                _write_string(out, "" if item is None else str(item))
        else:
            raise TypeError(f"Unsupported constant type: {type(c)}")
    return out.getvalue()


def _deserialize_pool(data: bytes) -> ConstantPool:
    buf = io.BytesIO(data)
    pool = ConstantPool()
    (count,) = struct.unpack("<i", buf.read(4))
    for _ in range(count):
        tag = buf.read(1)[0]
        if tag == _CONST_STRING:
            pool.add_string(_read_string(buf))
        elif tag == _CONST_NUMBER:
            (num,) = struct.unpack("<d", buf.read(8))
            pool.add_number(num)
        elif tag == _CONST_ARRAY:
            (n,) = struct.unpack("<i", buf.read(4))
            pool.add_array([_read_string(buf) for _ in range(n)])
        else:
            raise ValueError(f"Unknown constant type: {tag}")
    return pool


def serialize(compiled: CompiledFilter) -> bytes:
    out = io.BytesIO()
    out.write(MAGIC)
    out.write(struct.pack("<H", VERSION))
    pool_data = _serialize_pool(compiled.constants)
    out.write(struct.pack("<i", len(pool_data)))
    out.write(pool_data)
    out.write(struct.pack("<i", len(compiled.instructions)))
    for inst in compiled.instructions:
        out.write(bytes([int(inst.opcode)]))
        if inst.opcode in OPERAND_OPCODES:
            out.write(struct.pack("<i", inst.operand1))
            if inst.operand2 != 0:
                out.write(struct.pack("<i", inst.operand2))
    return out.getvalue()


def deserialize(data: bytes) -> CompiledFilter:
    buf = io.BytesIO(data)
    magic = buf.read(len(MAGIC))
    if magic != MAGIC:
        raise ValueError(
            f"Invalid magic header: expected {MAGIC!r}, got {magic!r}")
    (version,) = struct.unpack("<H", buf.read(2))
    if version != VERSION:
        raise ValueError(f"Unsupported version: {version}, expected {VERSION}")
    (pool_size,) = struct.unpack("<i", buf.read(4))
    pool = _deserialize_pool(buf.read(pool_size))
    (count,) = struct.unpack("<i", buf.read(4))
    valid_opcodes = {int(o) for o in Opcode}
    instructions: List[Instruction] = []
    for i in range(count):
        opcode = Opcode(buf.read(1)[0])
        operand1 = 0
        operand2 = 0
        if opcode in OPERAND_OPCODES:
            (operand1,) = struct.unpack("<i", buf.read(4))
            # Optional second operand: present iff next byte is not a valid
            # opcode (BytecodeSerializer.cs:96-110).
            pos = buf.tell()
            nxt = buf.read(1)
            buf.seek(pos)
            if nxt and nxt[0] not in valid_opcodes:
                (operand2,) = struct.unpack("<i", buf.read(4))
        instructions.append(Instruction(opcode, operand1, operand2))
    return CompiledFilter(pool, instructions)


def is_valid_bytecode(data: bytes) -> bool:
    return len(data) >= len(MAGIC) + 2 and data[: len(MAGIC)] == MAGIC


def get_version(data: bytes) -> int:
    if len(data) < len(MAGIC) + 2:
        raise ValueError("Data too short to contain version")
    (version,) = struct.unpack_from("<H", data, len(MAGIC))
    return version


def save_to_file(compiled: CompiledFilter, path: str) -> None:
    with open(path, "wb") as fh:
        fh.write(serialize(compiled))


def load_from_file(path: str) -> CompiledFilter:
    with open(path, "rb") as fh:
        return deserialize(fh.read())
