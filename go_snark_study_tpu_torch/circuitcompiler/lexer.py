"""Tokenizer for the flat-code circuit DSL.

Copy of ``go_snark_study_tpu/circuitcompiler/lexer.py`` (reference:
circuitcompiler/lexer.go).  Tokens are: whitespace runs, identifier
runs (letters+digits — so signal names like ``s0`` and bare integers are both
"identifiers"), and single-character operators ``= + - * / ^``.  The keywords
``var`` and ``out`` are recognised by the reference lexer but treated as plain
identifiers by the parser, which is the observable behaviour we mirror.

The parser also needs *raw* reads (up to ``:``, ``)`` or newline) interleaved
with tokenisation — the reference reaches into the bufio.Reader for those
(parser.go:70, 104, 150) — so the Scanner exposes ``read_until`` too.
"""

from __future__ import annotations

__all__ = ["Scanner", "TOK_EOF", "TOK_WS", "TOK_IDENT", "TOK_OP", "TOK_ILLEGAL"]

TOK_EOF = "EOF"
TOK_WS = "WS"
TOK_IDENT = "IDENT"
TOK_OP = "OP"
TOK_ILLEGAL = "ILLEGAL"

_OPS = set("=+-*/^")


def _is_word(ch: str) -> bool:
    return ch.isascii() and (ch.isalpha() or ch.isdigit())


class Scanner:
    """Cursor over the full source text."""

    def __init__(self, text: str):
        self.text = text
        self.pos = 0

    def _peek(self) -> str:
        return self.text[self.pos] if self.pos < len(self.text) else ""

    def scan(self):
        """Next (kind, literal).  Whitespace is returned as a single token,
        like the reference's scanWhitespace."""
        ch = self._peek()
        if ch == "":
            return TOK_EOF, ""
        if ch.isspace():
            start = self.pos
            while self._peek() != "" and self._peek().isspace():
                self.pos += 1
            return TOK_WS, self.text[start : self.pos]
        if _is_word(ch):
            start = self.pos
            while _is_word(self._peek()):
                self.pos += 1
            return TOK_IDENT, self.text[start : self.pos]
        self.pos += 1
        if ch in _OPS:
            return TOK_OP, ch
        return TOK_ILLEGAL, ch

    def scan_ignore_ws(self):
        kind, lit = self.scan()
        if kind == TOK_WS:
            kind, lit = self.scan()
        return kind, lit

    def read_until(self, stop: str) -> str:
        """Raw read through (and including) the next ``stop`` character, or to
        EOF — the parser's ReadString analog."""
        idx = self.text.find(stop, self.pos)
        if idx == -1:
            out = self.text[self.pos :]
            self.pos = len(self.text)
            return out
        out = self.text[self.pos : idx + 1]
        self.pos = idx + 1
        return out
