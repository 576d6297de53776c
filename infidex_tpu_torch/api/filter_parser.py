"""Infiscript parser: tokenizer + recursive descent.

Behavioral reference: Infidex ``Api/FilterParser.cs`` and
``Api/Infiscript.bnf``. Grammar (precedence low->high):

    ternary := expression [ '?' ternary ':' ternary ]
    expression := term { OR term }
    term := factor { AND factor }
    factor := NOT factor | '(' ternary ')' | literal-value | condition
    condition := field ( IN (...) | CONTAINS v | STARTS WITH v | ENDS WITH v
                       | LIKE v | MATCHES v | IS [NOT] NULL
                       | BETWEEN v AND v | (=|!=|<|<=|>|>=) v )

Operators are case-insensitive; AND/&&/&, OR/||/|, NOT/! aliases. Errors
carry character position + a suggestion (FilterParseException).
"""

from __future__ import annotations

import enum
from typing import List, Optional

from .filters import (CompositeFilter, Filter, FilterParseException, InFilter,
                      LiteralFilter, NullFilter, RangeFilter, RegexFilter,
                      StringFilter, StringOperation, TernaryFilter,
                      ValueFilter)


class _T(enum.Enum):
    IDENTIFIER = "Identifier"
    OPERATOR = "Operator"
    VALUE = "Value"
    AND = "And"
    OR = "Or"
    NOT = "Not"
    BETWEEN = "Between"
    IN = "In"
    CONTAINS = "Contains"
    STARTS = "Starts"
    ENDS = "Ends"
    LIKE = "Like"
    MATCHES = "Matches"
    IS = "Is"
    NULL = "Null"
    WITH = "With"
    COMMA = "Comma"
    LPAREN = "LeftParen"
    RPAREN = "RightParen"
    QUESTION = "Question"
    COLON = "Colon"


_KEYWORDS = {
    "AND": _T.AND, "OR": _T.OR, "NOT": _T.NOT, "BETWEEN": _T.BETWEEN,
    "IN": _T.IN, "CONTAINS": _T.CONTAINS, "STARTS": _T.STARTS,
    "ENDS": _T.ENDS, "LIKE": _T.LIKE, "MATCHES": _T.MATCHES,
    "IS": _T.IS, "NULL": _T.NULL, "WITH": _T.WITH,
}


class _Token:
    __slots__ = ("type", "value", "pos")

    def __init__(self, type_: _T, value: str, pos: int):
        self.type = type_
        self.value = value
        self.pos = pos


def _tokenize(expression: str) -> List[_Token]:
    tokens: List[_Token] = []
    i, n = 0, len(expression)
    while i < n:
        c = expression[i]
        if c.isspace():
            i += 1
            continue
        if c == "(":
            tokens.append(_Token(_T.LPAREN, "(", i)); i += 1; continue
        if c == ")":
            tokens.append(_Token(_T.RPAREN, ")", i)); i += 1; continue
        if c == ",":
            tokens.append(_Token(_T.COMMA, ",", i)); i += 1; continue
        if c == "?":
            tokens.append(_Token(_T.QUESTION, "?", i)); i += 1; continue
        if c == ":":
            tokens.append(_Token(_T.COLON, ":", i)); i += 1; continue
        if expression[i : i + 2] == "&&":
            tokens.append(_Token(_T.AND, "&&", i)); i += 2; continue
        if expression[i : i + 2] == "||":
            tokens.append(_Token(_T.OR, "||", i)); i += 2; continue
        if c == "&":
            tokens.append(_Token(_T.AND, "&", i)); i += 1; continue
        if c == "|":
            tokens.append(_Token(_T.OR, "|", i)); i += 1; continue
        if c in "=<>":
            start = i
            op = c
            i += 1
            if i < n and expression[i] == "=":
                op += "="
                i += 1
            tokens.append(_Token(_T.OPERATOR, op, start))
            continue
        if c == "!":
            start = i
            i += 1
            if i < n and expression[i] == "=":
                tokens.append(_Token(_T.OPERATOR, "!=", start))
                i += 1
            else:
                tokens.append(_Token(_T.NOT, "!", start))
            continue
        if c in ("'", '"'):
            quote = c
            start = i
            i += 1
            buf = []
            while i < n and expression[i] != quote:
                buf.append(expression[i])
                i += 1
            if i >= n:
                raise FilterParseException(
                    "Unterminated string literal - missing closing quote.",
                    expression, i - 1,
                    "String literals must be enclosed in matching quotes: "
                    "'text' or \"text\"")
            i += 1
            tokens.append(_Token(_T.VALUE, "".join(buf), start))
            continue
        if c.isalpha() or c == "_":
            start = i
            buf = []
            while i < n and (expression[i].isalnum() or expression[i] == "_"):
                buf.append(expression[i])
                i += 1
            word = "".join(buf)
            tokens.append(_Token(_KEYWORDS.get(word.upper(), _T.IDENTIFIER),
                                 word, start))
            continue
        if c.isdigit():
            start = i
            buf = []
            while i < n and (expression[i].isdigit() or expression[i] == "."):
                buf.append(expression[i])
                i += 1
            tokens.append(_Token(_T.VALUE, "".join(buf), start))
            continue
        raise FilterParseException(
            f"Unexpected character: '{c}'", expression, i,
            "Only letters, numbers, quotes, operators (= < > !), parentheses, "
            "and special characters (? : , & |) are allowed.")
    return tokens


class _Parser:
    def __init__(self, expression: str, tokens: List[_Token]):
        self.expression = expression
        self.tokens = tokens
        self.pos = 0

    def _char_pos(self) -> int:
        if self.pos < len(self.tokens):
            return self.tokens[self.pos].pos
        return len(self.expression)

    def _peek(self) -> Optional[_Token]:
        return self.tokens[self.pos] if self.pos < len(self.tokens) else None

    def _at(self, t: _T) -> bool:
        tok = self._peek()
        return tok is not None and tok.type == t

    def _err(self, message: str, suggestion: str):
        raise FilterParseException(message, self.expression, self._char_pos(),
                                   suggestion)

    def parse(self) -> Filter:
        result = self.parse_ternary()
        if self.pos < len(self.tokens):
            tok = self.tokens[self.pos]
            raise FilterParseException(
                f"Unexpected token '{tok.value}' after complete expression.",
                self.expression, tok.pos,
                "Check for extra closing parentheses ')' or misplaced operators.")
        return result

    def parse_ternary(self) -> Filter:
        condition = self.parse_expression()
        if self._at(_T.QUESTION):
            self.pos += 1
            true_value = self.parse_ternary()
            if not self._at(_T.COLON):
                self._err(
                    "Expected ':' (colon) in ternary expression after true value.",
                    "Ternary format is: condition ? true_value : false_value")
            self.pos += 1
            false_value = self.parse_ternary()
            return TernaryFilter(condition, true_value, false_value)
        return condition

    def parse_expression(self) -> Filter:
        left = self.parse_term()
        while self._at(_T.OR):
            self.pos += 1
            left = CompositeFilter.or_(left, self.parse_term())
        return left

    def parse_term(self) -> Filter:
        left = self.parse_factor()
        while self._at(_T.AND):
            self.pos += 1
            left = CompositeFilter.and_(left, self.parse_factor())
        return left

    def parse_factor(self) -> Filter:
        if self._at(_T.NOT):
            self.pos += 1
            return CompositeFilter.not_(self.parse_factor())
        if self._at(_T.LPAREN):
            self.pos += 1
            inner = self.parse_ternary()
            if not self._at(_T.RPAREN):
                self._err("Expected closing parenthesis ')'.",
                          "Make sure every '(' has a matching ')'.")
            self.pos += 1
            return inner
        if self._at(_T.VALUE):
            value = self.tokens[self.pos].value
            self.pos += 1
            try:
                return LiteralFilter(float(value))
            except ValueError:
                return LiteralFilter(value)
        return self.parse_condition()

    def parse_condition(self) -> Filter:
        tok = self._peek()
        if tok is None or tok.type != _T.IDENTIFIER:
            found = "end of expression" if tok is None else f"'{tok.value}'"
            self._err(
                f"Expected field name, but found {found}.",
                "Field names must start with a letter or underscore, like: "
                "age, user_name, _id")
        field_name = tok.value
        self.pos += 1

        if self._at(_T.IN):
            self.pos += 1
            if not self._at(_T.LPAREN):
                self._err("Expected '(' after IN keyword.",
                          "IN syntax: field IN ('value1', 'value2', ...)")
            self.pos += 1
            values = []
            while self._peek() is not None and not self._at(_T.RPAREN):
                if not self._at(_T.VALUE):
                    raise FilterParseException(
                        "Expected value in IN clause", self.expression,
                        self._char_pos(),
                        "IN syntax: field IN ('value1', 'value2', ...)")
                values.append(self.tokens[self.pos].value)
                self.pos += 1
                if self._at(_T.COMMA):
                    self.pos += 1
            if not self._at(_T.RPAREN):
                self._err("Expected ')' after IN clause values.",
                          "IN syntax: field IN ('value1', 'value2', ...)")
            self.pos += 1
            return InFilter(field_name, values)

        if self._at(_T.CONTAINS):
            self.pos += 1
            if not self._at(_T.VALUE):
                self._err("Expected string value after CONTAINS.",
                          "CONTAINS syntax: field CONTAINS 'text'")
            value = self.tokens[self.pos].value
            self.pos += 1
            return StringFilter(field_name, StringOperation.CONTAINS, value)

        for kw, op, name in ((_T.STARTS, StringOperation.STARTS_WITH, "STARTS"),
                             (_T.ENDS, StringOperation.ENDS_WITH, "ENDS")):
            if self._at(kw):
                self.pos += 1
                if not self._at(_T.WITH):
                    self._err(f"Expected WITH after {name} keyword.",
                              f"String matching syntax: field {name} WITH 'text'")
                self.pos += 1
                if not self._at(_T.VALUE):
                    self._err(f"Expected string value after {name} WITH.",
                              f"{name} WITH syntax: field {name} WITH 'text'")
                value = self.tokens[self.pos].value
                self.pos += 1
                return StringFilter(field_name, op, value)

        if self._at(_T.LIKE):
            self.pos += 1
            if not self._at(_T.VALUE):
                raise FilterParseException(
                    "Expected value after LIKE", self.expression,
                    self._char_pos(), "LIKE syntax: field LIKE '%pattern%'")
            value = self.tokens[self.pos].value
            self.pos += 1
            return StringFilter(field_name, StringOperation.LIKE, value)

        if self._at(_T.MATCHES):
            self.pos += 1
            if not self._at(_T.VALUE):
                raise FilterParseException(
                    "Expected regex pattern after MATCHES", self.expression,
                    self._char_pos(), "MATCHES syntax: field MATCHES 'pattern'")
            value = self.tokens[self.pos].value
            self.pos += 1
            return RegexFilter(field_name, value)

        if self._at(_T.IS):
            self.pos += 1
            is_not = False
            if self._at(_T.NOT):
                is_not = True
                self.pos += 1
            if not self._at(_T.NULL):
                raise FilterParseException(
                    "Expected NULL after IS [NOT]", self.expression,
                    self._char_pos(), "Syntax: field IS NULL or field IS NOT NULL")
            self.pos += 1
            return NullFilter(field_name, not is_not)

        if self._at(_T.BETWEEN):
            self.pos += 1
            if not self._at(_T.VALUE):
                self._err("Expected minimum value after BETWEEN.",
                          "BETWEEN syntax: field BETWEEN min_value AND max_value")
            min_value = self.tokens[self.pos].value
            self.pos += 1
            if not self._at(_T.AND):
                self._err("Expected AND keyword in BETWEEN clause.",
                          "BETWEEN syntax: field BETWEEN min_value AND max_value")
            self.pos += 1
            if not self._at(_T.VALUE):
                self._err("Expected maximum value after AND in BETWEEN clause.",
                          "BETWEEN syntax: field BETWEEN min_value AND max_value")
            max_value = self.tokens[self.pos].value
            self.pos += 1
            return RangeFilter(field_name, min_value, max_value)

        tok = self._peek()
        if tok is None or tok.type != _T.OPERATOR:
            found = "end of expression" if tok is None else f"'{tok.value}'"
            self._err(
                f"Expected comparison operator (=, !=, <, <=, >, >=), "
                f"but found {found}.",
                "Valid operators: =, !=, <, <=, >, >=, IN, BETWEEN, "
                "CONTAINS, LIKE, etc.")
        op = tok.value
        self.pos += 1

        if not self._at(_T.VALUE):
            self._err(
                f"Expected value after operator '{op}'.",
                "Values should be numbers (42) or strings ('text'). "
                "Strings must be in quotes.")
        value = self.tokens[self.pos].value
        self.pos += 1

        if op == "=":
            return ValueFilter(field_name, value)
        if op == "!=":
            return CompositeFilter.not_(ValueFilter(field_name, value))
        if op == ">":
            return RangeFilter(field_name, min_value=value, include_min=False)
        if op == ">=":
            return RangeFilter(field_name, min_value=value, include_min=True)
        if op == "<":
            return RangeFilter(field_name, max_value=value, include_max=False)
        if op == "<=":
            return RangeFilter(field_name, max_value=value, include_max=True)
        raise FilterParseException(
            f"Unknown or unsupported operator: '{op}'.",
            self.expression, tok.pos,
            "Valid operators: =, !=, <, <=, >, >=. For other operations use: "
            "IN, BETWEEN, CONTAINS, LIKE, MATCHES")


def parse(expression: str) -> Filter:
    if not expression or expression.isspace():
        raise FilterParseException(
            "Filter expression cannot be empty or whitespace.",
            expression or "", 0,
            "Provide a valid filter expression like: field = 'value' or age >= 18")
    return _Parser(expression, _tokenize(expression)).parse()
