"""SQL lexer.

Reference parity: the reference extends Spark's SQL parser only for extra
commands (`EXPLAIN DRUID REWRITE`, clear-cache — SURVEY.md §2 SQL-commands row
`[U]`) and otherwise rides Catalyst's parser.  Standalone, we need our own:
a compact hand-rolled lexer + recursive-descent parser covering the OLAP
subset the reference accelerates (aggregate SELECTs over star schemas).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional


@dataclasses.dataclass(frozen=True)
class Token:
    kind: str  # IDENT | NUMBER | STRING | OP | KW | EOF
    value: str
    pos: int


KEYWORDS = {
    "select", "from", "where", "group", "by", "having", "order", "limit",
    "offset", "as", "and", "or", "not", "in", "like", "between", "is",
    "null", "asc", "desc", "distinct", "join", "inner", "left", "on",
    "cube", "rollup", "grouping", "sets", "date", "timestamp", "interval",
    "case", "when", "then", "else", "end", "cast", "extract", "filter",
    "explain", "rewrite", "union", "all", "true", "false", "exists",
    "intersect", "except",
}

_TWO_CHAR = {"<=", ">=", "<>", "!=", "=="}


class LexError(Exception):
    pass


def tokenize(sql: str) -> List[Token]:
    out: List[Token] = []
    i, n = 0, len(sql)
    while i < n:
        c = sql[i]
        if c.isspace():
            i += 1
            continue
        if c == "-" and i + 1 < n and sql[i + 1] == "-":  # comment
            while i < n and sql[i] != "\n":
                i += 1
            continue
        if c.isalpha() or c == "_":
            j = i
            while j < n and (sql[j].isalnum() or sql[j] == "_"):
                j += 1
            word = sql[i:j]
            kind = "KW" if word.lower() in KEYWORDS else "IDENT"
            out.append(Token(kind, word, i))
            i = j
            continue
        if c.isdigit() or (c == "." and i + 1 < n and sql[i + 1].isdigit()):
            j = i
            seen_dot = False
            while j < n and (sql[j].isdigit() or (sql[j] == "." and not seen_dot)):
                if sql[j] == ".":
                    seen_dot = True
                j += 1
            if j < n and sql[j] in "eE":
                j += 1
                if j < n and sql[j] in "+-":
                    j += 1
                while j < n and sql[j].isdigit():
                    j += 1
            out.append(Token("NUMBER", sql[i:j], i))
            i = j
            continue
        if c == "'":
            j = i + 1
            buf = []
            while j < n:
                if sql[j] == "'" and j + 1 < n and sql[j + 1] == "'":
                    buf.append("'")
                    j += 2
                elif sql[j] == "'":
                    break
                else:
                    buf.append(sql[j])
                    j += 1
            if j >= n:
                raise LexError(f"unterminated string at {i}")
            out.append(Token("STRING", "".join(buf), i))
            i = j + 1
            continue
        if c == '"':
            j = sql.find('"', i + 1)
            if j < 0:
                raise LexError(f"unterminated quoted identifier at {i}")
            out.append(Token("IDENT", sql[i + 1 : j], i))
            i = j + 1
            continue
        two = sql[i : i + 2]
        if two in _TWO_CHAR:
            out.append(Token("OP", two, i))
            i += 2
            continue
        if c in "(),.*+-/%<>=;":
            out.append(Token("OP", c, i))
            i += 1
            continue
        raise LexError(f"unexpected character {c!r} at {i}")
    out.append(Token("EOF", "", n))
    return out
