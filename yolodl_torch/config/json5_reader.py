"""A reader of JSON5 (https://spec.json5.org), standard library only.

Every config of the repo is JSON5: the NEWSLAB model files and the
``train.json5`` / ``detect.json5`` application configs.  The port reads them
with this module on every machine, so that a config means the same thing on
the CPU and on the card, and so that no third-party package is needed.

The grammar is JSON plus:

- ``//`` line comments and ``/* */`` block comments;
- trailing commas in objects and arrays;
- object keys as ECMAScript identifier names (``$``, ``_``, Unicode
  letters and ``\\uXXXX`` escapes), or single- or double-quoted strings;
- single-quoted strings, escaped line breaks inside strings, and the escapes
  ``\\v``, ``\\0``, ``\\xHH``; any other escaped character stands for itself;
- numbers in hex (``0x1F``), with a leading or trailing decimal point
  (``.5``, ``5.``), a leading ``+``, and ``Infinity`` / ``NaN``;
- the whitespace of ECMAScript (``\\u00a0``, ``\\ufeff``, the Zs category,
  the line and paragraph separators).

Results follow the ``json5`` package's: an integer literal (decimal or hex)
gives an ``int`` and any other number a ``float``; a key given twice keeps its
last value (at its first position); ``\\uXXXX`` escapes are not combined into
surrogate pairs; a raw line terminator inside a string is an error.  Every
syntax error raises ``ValueError`` naming its line and column.
"""

from __future__ import annotations

import unicodedata
from typing import Any, List

_LINE_TERMINATORS = "\n\r\u2028\u2029"
_WHITESPACE = "\t\n\v\f\r \u00a0\u2028\u2029\ufeff"
_SIMPLE_ESCAPES = {"b": "\b", "f": "\f", "n": "\n", "r": "\r", "t": "\t",
                   "v": "\v", "'": "'", '"': '"', "\\": "\\", "/": "/"}
_HEX = "0123456789abcdefABCDEF"
_DIGITS = "0123456789"
_LITERALS = (("true", True), ("false", False), ("null", None))


def _is_id_start(ch: str) -> bool:
    return ch in "$_" or unicodedata.category(ch) in ("Lu", "Ll", "Lt", "Lm", "Lo", "Nl")


def _is_id_part(ch: str) -> bool:
    return (_is_id_start(ch) or ch in "\u200c\u200d"
            or unicodedata.category(ch) in ("Mn", "Mc", "Nd", "Pc"))


class _Reader:
    def __init__(self, text: str, source: str):
        self.text = text
        self.pos = 0
        self.source = source

    # -- errors ------------------------------------------------------------

    def error(self, message: str, pos: int = -1) -> ValueError:
        pos = self.pos if pos < 0 else pos
        line = self.text.count("\n", 0, pos) + 1
        column = pos - (self.text.rfind("\n", 0, pos) + 1) + 1
        return ValueError(f"{self.source}:{line}:{column}: {message}")

    def unexpected(self) -> ValueError:
        if self.pos >= len(self.text):
            return self.error("unexpected end of input")
        return self.error(f"unexpected {self.text[self.pos]!r}")

    # -- lexing ------------------------------------------------------------

    def peek(self) -> str:
        return self.text[self.pos] if self.pos < len(self.text) else ""

    def skip(self) -> None:
        """Whitespace and comments."""
        text, n = self.text, len(self.text)
        while self.pos < n:
            ch = text[self.pos]
            if ch in _WHITESPACE or unicodedata.category(ch) == "Zs":
                self.pos += 1
            elif text.startswith("//", self.pos):
                self.pos += 2
                while self.pos < n and text[self.pos] not in _LINE_TERMINATORS:
                    self.pos += 1
            elif text.startswith("/*", self.pos):
                end = text.find("*/", self.pos + 2)
                if end < 0:
                    self.pos = n
                    raise self.error("unterminated block comment")
                self.pos = end + 2
            else:
                return

    def expect(self, ch: str) -> None:
        if self.peek() != ch:
            raise self.unexpected()
        self.pos += 1

    # -- values ------------------------------------------------------------

    def value(self) -> Any:
        self.skip()
        ch = self.peek()
        if ch == "{":
            return self.object()
        if ch == "[":
            return self.array()
        if ch in "'\"":
            return self.string()
        if ch and (ch in _DIGITS or ch in "+-.IN"):
            return self.number()
        for word, result in _LITERALS:
            if self.text.startswith(word, self.pos):
                self.pos += len(word)
                return result
        raise self.unexpected()

    def object(self) -> dict:
        self.expect("{")
        out: dict = {}
        while True:
            self.skip()
            if self.peek() == "}":
                self.pos += 1
                return out
            key = self.string() if self.peek() in ("'", '"') else self.identifier()
            self.skip()
            self.expect(":")
            out[key] = self.value()
            self.skip()
            if self.peek() == ",":
                self.pos += 1
            elif self.peek() == "}":
                self.pos += 1
                return out
            else:
                raise self.unexpected()

    def array(self) -> list:
        self.expect("[")
        out: List[Any] = []
        while True:
            self.skip()
            if self.peek() == "]":
                self.pos += 1
                return out
            out.append(self.value())
            self.skip()
            if self.peek() == ",":
                self.pos += 1
            elif self.peek() == "]":
                self.pos += 1
                return out
            else:
                raise self.unexpected()

    def hex_digits(self, count: int) -> int:
        digits = self.text[self.pos:self.pos + count]
        for i, d in enumerate(digits):
            if d not in _HEX:
                self.pos += i
                raise self.unexpected()
        if len(digits) < count:
            self.pos += len(digits)
            raise self.unexpected()
        self.pos += count
        return int(digits, 16)

    def escape(self) -> str:
        """The character(s) after a backslash; '' for an escaped line break."""
        ch = self.peek()
        if not ch:
            raise self.unexpected()
        if ch in _SIMPLE_ESCAPES:
            self.pos += 1
            return _SIMPLE_ESCAPES[ch]
        if ch == "0":
            self.pos += 1
            if self.peek() and self.peek() in _DIGITS:
                raise self.unexpected()
            return "\0"
        if ch in _DIGITS:
            raise self.unexpected()
        if ch == "x":
            self.pos += 1
            return chr(self.hex_digits(2))
        if ch == "u":
            self.pos += 1
            return chr(self.hex_digits(4))
        if ch in _LINE_TERMINATORS:
            self.pos += 1
            if ch == "\r" and self.peek() == "\n":
                self.pos += 1
            return ""
        self.pos += 1
        return ch

    def string(self) -> str:
        quote = self.peek()
        self.pos += 1
        parts: List[str] = []
        text, n = self.text, len(self.text)
        while True:
            start = self.pos
            while self.pos < n and text[self.pos] not in ("\\", quote) \
                    and text[self.pos] not in _LINE_TERMINATORS:
                self.pos += 1
            parts.append(text[start:self.pos])
            if self.pos >= n or text[self.pos] in _LINE_TERMINATORS:
                raise self.unexpected()
            if text[self.pos] == quote:
                self.pos += 1
                return "".join(parts)
            self.pos += 1  # the backslash
            parts.append(self.escape())

    def identifier(self) -> str:
        out: List[str] = []
        while True:
            ch = self.peek()
            if ch == "\\":
                at = self.pos
                self.pos += 1
                if self.peek() != "u":
                    raise self.unexpected()
                self.pos += 1
                ch = chr(self.hex_digits(4))
                ok = _is_id_part(ch) if out else _is_id_start(ch)
                if not ok:
                    raise self.error(f"invalid identifier character {ch!r}", at)
                out.append(ch)
            elif ch and (_is_id_part(ch) if out else _is_id_start(ch)):
                out.append(ch)
                self.pos += 1
            elif out:
                return "".join(out)
            else:
                raise self.unexpected()

    def number(self) -> Any:
        text = self.text
        start = self.pos
        sign = 1
        if self.peek() in ("+", "-"):
            sign = -1 if self.peek() == "-" else 1
            self.pos += 1
        for word, value in (("Infinity", float("inf")), ("NaN", float("nan"))):
            if text.startswith(word, self.pos):
                self.pos += len(word)
                return sign * value
        if text.startswith(("0x", "0X"), self.pos):
            self.pos += 2
            digits_at = self.pos
            while self.peek() and self.peek() in _HEX:
                self.pos += 1
            if self.pos == digits_at:
                raise self.unexpected()
            return sign * int(text[digits_at:self.pos], 16)
        is_float = False
        if self.peek() == "0":
            self.pos += 1
        elif self.peek() and self.peek() in _DIGITS:
            self._digits()
        elif self.peek() != ".":
            raise self.unexpected()
        int_end = self.pos
        if self.peek() == ".":
            is_float = True
            self.pos += 1
            if self._digits() == 0 and int_end == start + (text[start] in "+-"):
                raise self.unexpected()  # a lone "." has no digits
        if self.peek() in ("e", "E"):
            is_float = True
            self.pos += 1
            if self.peek() in ("+", "-"):
                self.pos += 1
            if self._digits() == 0:
                raise self.unexpected()
        literal = text[start:self.pos]
        return float(literal) if is_float else int(literal)

    def _digits(self) -> int:
        at = self.pos
        while self.peek() and self.peek() in _DIGITS:
            self.pos += 1
        return self.pos - at

    def document(self) -> Any:
        self.skip()
        if self.pos >= len(self.text):
            raise self.error("empty document: no JSON5 value")
        out = self.value()
        self.skip()
        if self.pos < len(self.text):
            raise self.unexpected()
        return out


def loads(text: str, source: str = "<string>") -> Any:
    """Parse one JSON5 document; ``source`` names it in error messages."""
    return _Reader(text, source).document()


def load(fp) -> Any:
    """Parse the JSON5 document read from the open text file ``fp``; errors
    name the file."""
    return loads(fp.read(), getattr(fp, "name", "<file>"))

