"""Tokenizer for the StarPlat-Dynamic DSL (paper appendix syntax)."""
from __future__ import annotations

import dataclasses
import re
from typing import Iterator, List

KEYWORDS = {
    # function kinds
    "Static", "Dynamic", "Incremental", "Decremental",
    # types
    "Graph", "node", "edge", "int", "long", "float", "double", "bool",
    "propNode", "propEdge", "updates",
    # control
    "if", "else", "while", "do", "for", "forall", "return",
    "fixedPoint", "until", "in", "filter",
    # dynamic constructs
    "Batch", "OnAdd", "OnDelete",
    # builtins / literals
    "Min", "Max", "True", "False", "INF",
}

_TOKEN_RE = re.compile(r"""
      (?P<comment>//[^\n]*|/\*.*?\*/)
    | (?P<num>\d+\.\d+|\.\d+|\d+)
    | (?P<ident>[A-Za-z_][A-Za-z_0-9]*)
    | (?P<op><=|>=|==|!=|&&|\|\||\+=|-=|\*=|/=|<|>|=|\+|-|\*|/|%|!|\.|,|;|:|
         \(|\)|\{|\}|\[|\])
    | (?P<ws>[ \t\r\n]+)
    | (?P<bad>.)
""", re.VERBOSE | re.DOTALL)


class LexError(SyntaxError):
    pass


@dataclasses.dataclass(frozen=True)
class Token:
    kind: str        # 'kw' | 'ident' | 'num' | 'op' | 'eof'
    text: str
    line: int
    col: int

    def __repr__(self):
        return f"{self.kind}:{self.text!r}@{self.line}"


def tokenize(src: str) -> List[Token]:
    toks: List[Token] = []
    line, col = 1, 1
    pos = 0
    while pos < len(src):
        m = _TOKEN_RE.match(src, pos)
        if m is None:  # pragma: no cover - regex has catch-all
            raise LexError(f"cannot tokenize at {line}:{col}")
        text = m.group(0)
        kind = m.lastgroup
        if kind == "bad":
            raise LexError(f"unexpected character {text!r} at {line}:{col}")
        if kind not in ("ws", "comment"):
            if kind == "ident" and text in KEYWORDS:
                toks.append(Token("kw", text, line, col))
            elif kind == "ident":
                toks.append(Token("ident", text, line, col))
            elif kind == "num":
                toks.append(Token("num", text, line, col))
            else:
                toks.append(Token("op", text, line, col))
        nl = text.count("\n")
        if nl:
            line += nl
            col = len(text) - text.rfind("\n")
        else:
            col += len(text)
        pos = m.end()
    toks.append(Token("eof", "", line, col))
    return toks
