"""Stack-machine executor for filter bytecode.

Behavioral reference: Infidex ``Filtering/FilterVM.cs`` — per-document
execution over DocumentFields; EQ is case-insensitive string equality;
comparisons try numeric first then case-insensitive string; LIKE converts
%-wildcards to regex; MATCHES is regex (invalid regex -> false); IS NULL
treats empty string as null; JUMP_IF_* peeks (does not pop).
"""

from __future__ import annotations

import re
from typing import Any, List, Optional

from .compiler import CompiledFilter, Opcode


def _are_equal(left: Any, right: Any) -> bool:
    if left is None and right is None:
        return True
    if left is None or right is None:
        return False
    return _to_str(left).lower() == _to_str(right).lower()


def _to_str(v: Any) -> str:
    # .NET double.ToString() prints integral doubles without a trailing .0
    if isinstance(v, float) and v.is_integer():
        return str(int(v))
    if isinstance(v, bool):
        return "True" if v else "False"
    return str(v)


def _try_float(v: Any) -> Optional[float]:
    try:
        return float(str(v))
    except (TypeError, ValueError):
        return None


def _compare(left: Any, right: Any) -> int:
    if left is None and right is None:
        return 0
    if left is None:
        return -1
    if right is None:
        return 1
    lf, rf = _try_float(left), _try_float(right)
    if lf is not None and rf is not None:
        return -1 if lf < rf else (1 if lf > rf else 0)
    ls, rs = _to_str(left).lower(), _to_str(right).lower()
    return -1 if ls < rs else (1 if ls > rs else 0)


class FilterVM:
    def __init__(self) -> None:
        self._stack: List[Any] = []

    def execute(self, compiled: CompiledFilter, document_fields) -> bool:
        stack = self._stack
        stack.clear()
        constants = compiled.constants
        instructions = compiled.instructions
        ip = 0
        n = len(instructions)

        while ip < n:
            inst = instructions[ip]
            op = inst.opcode

            if op == Opcode.PUSH_FIELD:
                field_name = constants.get(inst.operand1)
                field = document_fields.get_field(field_name)
                stack.append(field.value if field is not None else None)
            elif op == Opcode.PUSH_CONST:
                stack.append(constants.get(inst.operand1))
            elif op == Opcode.POP:
                stack.pop()
            elif op == Opcode.DUP:
                stack.append(stack[-1])
            elif op == Opcode.EQ:
                r, l = stack.pop(), stack.pop()
                stack.append(_are_equal(l, r))
            elif op == Opcode.NEQ:
                r, l = stack.pop(), stack.pop()
                stack.append(not _are_equal(l, r))
            elif op == Opcode.LT:
                r, l = stack.pop(), stack.pop()
                stack.append(_compare(l, r) < 0)
            elif op == Opcode.LTE:
                r, l = stack.pop(), stack.pop()
                stack.append(_compare(l, r) <= 0)
            elif op == Opcode.GT:
                r, l = stack.pop(), stack.pop()
                stack.append(_compare(l, r) > 0)
            elif op == Opcode.GTE:
                r, l = stack.pop(), stack.pop()
                stack.append(_compare(l, r) >= 0)
            elif op == Opcode.AND:
                r = stack.pop() is True
                l = stack.pop() is True
                stack.append(l and r)
            elif op == Opcode.OR:
                r = stack.pop() is True
                l = stack.pop() is True
                stack.append(l or r)
            elif op == Opcode.NOT:
                v = stack.pop() is True
                stack.append(not v)
            elif op == Opcode.CONTAINS:
                pattern = _pop_str(stack)
                text = _pop_str(stack)
                stack.append(pattern.lower() in text.lower())
            elif op == Opcode.STARTS_WITH:
                pattern = _pop_str(stack)
                text = _pop_str(stack)
                stack.append(text.lower().startswith(pattern.lower()))
            elif op == Opcode.ENDS_WITH:
                pattern = _pop_str(stack)
                text = _pop_str(stack)
                stack.append(text.lower().endswith(pattern.lower()))
            elif op == Opcode.LIKE:
                pattern = _pop_str(stack)
                text = _pop_str(stack)
                regex = "^" + re.escape(pattern).replace("%", ".*").replace("_", ".") + "$"
                stack.append(re.match(regex, text, re.IGNORECASE) is not None)
            elif op == Opcode.MATCHES:
                pattern = _pop_str(stack)
                text = _pop_str(stack)
                try:
                    stack.append(re.search(pattern, text, re.IGNORECASE) is not None)
                except re.error:
                    stack.append(False)
            elif op == Opcode.IN:
                array = stack.pop()
                value = stack.pop()
                if not isinstance(array, (list, tuple)):
                    stack.append(False)
                else:
                    stack.append(any(_are_equal(value, item) for item in array))
            elif op == Opcode.BETWEEN:
                max_v = stack.pop()
                min_v = stack.pop()
                value = stack.pop()
                stack.append(_compare(value, min_v) >= 0 and _compare(value, max_v) <= 0)
            elif op == Opcode.IS_NULL:
                v = stack.pop()
                stack.append(v is None or (isinstance(v, str) and v == ""))
            elif op == Opcode.IS_NOT_NULL:
                v = stack.pop()
                stack.append(not (v is None or (isinstance(v, str) and v == "")))
            elif op == Opcode.JUMP:
                ip = inst.operand1 - 1
            elif op == Opcode.JUMP_IF_FALSE:
                if stack[-1] is False:
                    ip = inst.operand1 - 1
            elif op == Opcode.JUMP_IF_TRUE:
                if stack[-1] is True:
                    ip = inst.operand1 - 1
            elif op == Opcode.HALT:
                ip = n
                continue
            else:
                raise ValueError(f"Unknown opcode: {op}")
            ip += 1

        if not stack:
            return False
        return stack.pop() is True


def _pop_str(stack: List[Any]) -> str:
    v = stack.pop()
    return "" if v is None else _to_str(v)
