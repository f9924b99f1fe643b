"""SQL tokenizer for the Reflex dialect: the port's own copy of
``repro.sql.lexer``, with the same tokens and the same error messages.

Dependency-free: a hand-rolled scanner producing ``Token(kind, value, pos)``
triples. Keywords are case-insensitive; identifiers keep their case (the
HealthLnK catalog is lower-case). Literals are integers only — strings enter
the MPC engine dictionary-encoded (data/healthlnk.py), so the dialect never
sees a quoted string.
"""
from __future__ import annotations

import dataclasses
from typing import List

__all__ = ["Token", "SqlError", "tokenize", "KEYWORDS"]

KEYWORDS = {
    "select",
    "distinct",
    "count",
    "sum",
    "avg",
    "min",
    "max",
    "from",
    "join",
    "on",
    "where",
    "and",
    "or",
    "group",
    "having",
    "order",
    "by",
    "asc",
    "desc",
    "limit",
    "as",
}

_PUNCT = {
    "<=": "LE",
    ">=": "GE",
    "<>": "NE",
    "!=": "NE",
    "=": "EQ",
    "<": "LT",
    ">": "GT",
    "(": "LPAREN",
    ")": "RPAREN",
    ",": "COMMA",
    ".": "DOT",
    "*": "STAR",
    ";": "SEMI",
}


class SqlError(ValueError):
    """Lex/parse/compile error with a position-annotated message.

    ``str(e)`` renders the offending SQL with a caret under the error
    position so parser tests (and users) see exactly where things broke.
    """

    def __init__(self, message: str, sql: str = "", pos: int = -1):
        self.message = message
        self.sql = sql
        self.pos = pos
        super().__init__(self._render())

    def _render(self) -> str:
        if not self.sql or self.pos < 0:
            return self.message
        line_start = self.sql.rfind("\n", 0, self.pos) + 1
        line_end = self.sql.find("\n", self.pos)
        line = self.sql[line_start : line_end if line_end != -1 else len(self.sql)]
        caret = " " * (self.pos - line_start) + "^"
        return f"{self.message} (at position {self.pos})\n  {line}\n  {caret}"


@dataclasses.dataclass(frozen=True)
class Token:
    kind: str  # keyword name (upper), IDENT, INT, or a punct kind
    value: str
    pos: int

    def __repr__(self) -> str:  # compact in parser error paths
        return f"{self.kind}({self.value!r}@{self.pos})"


def tokenize(sql: str) -> List[Token]:
    out: List[Token] = []
    i, n = 0, len(sql)
    while i < n:
        c = sql[i]
        if c.isspace():
            i += 1
            continue
        if c == "-" and sql[i : i + 2] == "--":  # line comment
            j = sql.find("\n", i)
            i = n if j == -1 else j + 1
            continue
        two = sql[i : i + 2]
        if two in _PUNCT:
            out.append(Token(_PUNCT[two], two, i))
            i += 2
            continue
        if c in _PUNCT:
            out.append(Token(_PUNCT[c], c, i))
            i += 1
            continue
        if c.isdigit():
            j = i
            while j < n and sql[j].isdigit():
                j += 1
            if j < n and (sql[j].isalpha() or sql[j] == "_"):
                raise SqlError(f"malformed number {sql[i:j + 1]!r}", sql, i)
            out.append(Token("INT", sql[i:j], i))
            i = j
            continue
        if c.isalpha() or c == "_":
            j = i
            while j < n and (sql[j].isalnum() or sql[j] == "_"):
                j += 1
            word = sql[i:j]
            low = word.lower()
            kind = low.upper() if low in KEYWORDS else "IDENT"
            out.append(Token(kind, word, i))
            i = j
            continue
        raise SqlError(f"unexpected character {c!r}", sql, i)
    out.append(Token("EOF", "", n))
    return out
