"""Filter AST -> stack-machine bytecode.

Behavioral reference: Infidex ``Filtering/FilterCompiler.cs`` (short-circuit
AND/OR via DUP + JUMP_IF_*, ternary via jump patching, constants deduped),
``Filtering/BytecodeInstruction.cs`` (opcode values), and
``Filtering/ConstantPool.cs``.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Any, List


class Opcode(enum.IntEnum):
    PUSH_FIELD = 0x01
    PUSH_CONST = 0x02
    POP = 0x03
    DUP = 0x04

    EQ = 0x10
    NEQ = 0x11
    LT = 0x12
    LTE = 0x13
    GT = 0x14
    GTE = 0x15

    AND = 0x20
    OR = 0x21
    NOT = 0x22

    CONTAINS = 0x30
    STARTS_WITH = 0x31
    ENDS_WITH = 0x32
    LIKE = 0x33
    MATCHES = 0x34

    IN = 0x40
    BETWEEN = 0x41

    IS_NULL = 0x50
    IS_NOT_NULL = 0x51

    JUMP = 0x60
    JUMP_IF_FALSE = 0x61
    JUMP_IF_TRUE = 0x62

    HALT = 0xFF


OPERAND_OPCODES = frozenset({
    Opcode.PUSH_FIELD, Opcode.PUSH_CONST,
    Opcode.JUMP, Opcode.JUMP_IF_FALSE, Opcode.JUMP_IF_TRUE,
})


@dataclass
class Instruction:
    opcode: Opcode
    operand1: int = 0
    operand2: int = 0

    def __str__(self) -> str:
        if self.operand1 == 0 and self.operand2 == 0:
            return self.opcode.name
        if self.operand2 == 0:
            return f"{self.opcode.name} {self.operand1}"
        return f"{self.opcode.name} {self.operand1}, {self.operand2}"


class ConstantPool:
    """Deduplicating pool of strings / numbers / arrays."""

    def __init__(self) -> None:
        self._constants: List[Any] = []
        self._index: dict = {}

    @property
    def count(self) -> int:
        return len(self._constants)

    def add_string(self, value: str) -> int:
        key = ("s", value)
        idx = self._index.get(key)
        if idx is not None:
            return idx
        idx = len(self._constants)
        self._constants.append(value)
        self._index[key] = idx
        return idx

    def add_number(self, value: float) -> int:
        key = ("n", float(value))
        idx = self._index.get(key)
        if idx is not None:
            return idx
        idx = len(self._constants)
        self._constants.append(float(value))
        self._index[key] = idx
        return idx

    def add_array(self, values) -> int:
        idx = len(self._constants)
        self._constants.append(list(values))
        return idx

    def get(self, index: int) -> Any:
        if index < 0 or index >= len(self._constants):
            raise IndexError(f"Invalid constant pool index: {index}")
        return self._constants[index]

    def items(self) -> List[Any]:
        return list(self._constants)


class CompiledFilter:
    def __init__(self, constants: ConstantPool, instructions: List[Instruction]):
        self.constants = constants
        self.instructions = list(instructions)

    def disassemble(self) -> str:
        lines = ["=== Constant Pool ==="]
        for i, c in enumerate(self.constants.items()):
            if isinstance(c, list):
                lines.append(f"  [{i}] Array: [{', '.join(map(str, c))}]")
            else:
                lines.append(f"  [{i}] {c}")
        lines.append("")
        lines.append("=== Instructions ===")
        for i, inst in enumerate(self.instructions):
            lines.append(f"  {i:04d}: {inst}")
        return "\n".join(lines)


class FilterCompiler:
    def __init__(self) -> None:
        self._pool = ConstantPool()
        self._instructions: List[Instruction] = []

    def compile(self, filter_obj) -> CompiledFilter:
        self._pool = ConstantPool()
        self._instructions = []
        self._compile(filter_obj)
        self._instructions.append(Instruction(Opcode.HALT))
        return CompiledFilter(self._pool, self._instructions)

    def _compile(self, f) -> None:
        from ..api.filters import (CompositeFilter, DerivedFilter, InFilter,
                                   LiteralFilter, NullFilter, RangeFilter,
                                   RegexFilter, StringFilter, StringOperation,
                                   TernaryFilter, ValueFilter)

        if isinstance(f, CompositeFilter):
            self._compile_composite(f)
        elif isinstance(f, ValueFilter):
            self._emit(Opcode.PUSH_FIELD, self._pool.add_string(f.field_name))
            self._emit(Opcode.PUSH_CONST,
                       self._pool.add_string("" if f.value is None else str(f.value)))
            self._emit(Opcode.EQ)
        elif isinstance(f, RangeFilter):
            self._compile_range(f)
        elif isinstance(f, InFilter):
            self._emit(Opcode.PUSH_FIELD, self._pool.add_string(f.field_name))
            self._emit(Opcode.PUSH_CONST, self._pool.add_array(f.values))
            self._emit(Opcode.IN)
        elif isinstance(f, StringFilter):
            self._emit(Opcode.PUSH_FIELD, self._pool.add_string(f.field_name))
            self._emit(Opcode.PUSH_CONST, self._pool.add_string(f.pattern))
            op = {StringOperation.CONTAINS: Opcode.CONTAINS,
                  StringOperation.STARTS_WITH: Opcode.STARTS_WITH,
                  StringOperation.ENDS_WITH: Opcode.ENDS_WITH,
                  StringOperation.LIKE: Opcode.LIKE}[f.operation]
            self._emit(op)
        elif isinstance(f, RegexFilter):
            self._emit(Opcode.PUSH_FIELD, self._pool.add_string(f.field_name))
            self._emit(Opcode.PUSH_CONST, self._pool.add_string(f.pattern))
            self._emit(Opcode.MATCHES)
        elif isinstance(f, NullFilter):
            self._emit(Opcode.PUSH_FIELD, self._pool.add_string(f.field_name))
            self._emit(Opcode.IS_NULL if f.is_null else Opcode.IS_NOT_NULL)
        elif isinstance(f, TernaryFilter):
            self._compile_ternary(f)
        elif isinstance(f, LiteralFilter):
            self._compile_literal(f)
        elif isinstance(f, DerivedFilter):
            raise NotImplementedError(
                "DerivedFilter (custom predicates) cannot be compiled to bytecode")
        else:
            raise TypeError(f"Unknown filter type: {type(f).__name__}")

    def _emit(self, opcode: Opcode, operand1: int = 0, operand2: int = 0) -> None:
        self._instructions.append(Instruction(opcode, operand1, operand2))

    def _compile_composite(self, f) -> None:
        from ..api.filters import BooleanOperator

        if f.operator == BooleanOperator.AND:
            self._compile(f.left_filter)
            self._emit(Opcode.DUP)
            jump_pos = len(self._instructions)
            self._emit(Opcode.JUMP_IF_FALSE, 0)
            self._emit(Opcode.POP)
            self._compile(f.right_filter)
            self._instructions[jump_pos] = Instruction(
                Opcode.JUMP_IF_FALSE, len(self._instructions))
        elif f.operator == BooleanOperator.OR:
            self._compile(f.left_filter)
            self._emit(Opcode.DUP)
            jump_pos = len(self._instructions)
            self._emit(Opcode.JUMP_IF_TRUE, 0)
            self._emit(Opcode.POP)
            self._compile(f.right_filter)
            self._instructions[jump_pos] = Instruction(
                Opcode.JUMP_IF_TRUE, len(self._instructions))
        elif f.operator == BooleanOperator.NOT:
            self._compile(f.left_filter)
            self._emit(Opcode.NOT)
        else:
            raise ValueError(f"Unknown boolean operator: {f.operator}")

    def _compile_range(self, f) -> None:
        field_idx = self._pool.add_string(f.field_name)
        if f.min_value is not None and f.max_value is not None:
            self._emit(Opcode.PUSH_FIELD, field_idx)
            self._emit(Opcode.PUSH_CONST, self._pool.add_string(str(f.min_value)))
            self._emit(Opcode.PUSH_CONST, self._pool.add_string(str(f.max_value)))
            self._emit(Opcode.BETWEEN)
        elif f.min_value is not None:
            self._emit(Opcode.PUSH_FIELD, field_idx)
            self._emit(Opcode.PUSH_CONST, self._pool.add_string(str(f.min_value)))
            self._emit(Opcode.GTE if f.include_min else Opcode.GT)
        elif f.max_value is not None:
            self._emit(Opcode.PUSH_FIELD, field_idx)
            self._emit(Opcode.PUSH_CONST, self._pool.add_string(str(f.max_value)))
            self._emit(Opcode.LTE if f.include_max else Opcode.LT)

    def _compile_ternary(self, f) -> None:
        self._compile(f.condition)
        false_jump_pos = len(self._instructions)
        self._emit(Opcode.JUMP_IF_FALSE, 0)
        self._emit(Opcode.POP)
        self._compile(f.true_value)
        end_jump_pos = len(self._instructions)
        self._emit(Opcode.JUMP, 0)
        self._instructions[false_jump_pos] = Instruction(
            Opcode.JUMP_IF_FALSE, len(self._instructions))
        self._emit(Opcode.POP)
        self._compile(f.false_value)
        self._instructions[end_jump_pos] = Instruction(
            Opcode.JUMP, len(self._instructions))

    def _compile_literal(self, f) -> None:
        v = f.value
        if isinstance(v, str):
            idx = self._pool.add_string(v)
        elif isinstance(v, bool):
            idx = self._pool.add_string(str(v))
        elif isinstance(v, (int, float)):
            idx = self._pool.add_number(float(v))
        elif v is None:
            idx = self._pool.add_string("null")
        else:
            idx = self._pool.add_string(str(v))
        self._emit(Opcode.PUSH_CONST, idx)
