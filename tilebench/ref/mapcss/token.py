"""MapCSS tokenizer.

Grammar-compatible with the reference lexer (`src/mapcss/token.rs`):
identifiers (which may contain ``- . /``), quoted strings, numbers with
an explicit hand-rolled decimal accumulator, ``#RGB``/``#RRGGBB`` colors,
``@import``/``@colorref`` directives, zoom ranges ``|z12-14``, comparison
operators, ``//`` and ``/* */`` comments, and (line, column) tracking.

The number parser deliberately replicates the reference's digit
accumulation (``n = 10*n + d``; fraction = ``frac / 10^k``) so parsed
floats are bit-identical with the reference — the parser golden test
compares formatted output byte-for-byte.

Provenance: the token set, the two-char operator table, and every
accept/reject decision are pinned to the reference grammar (the golden
suite needs byte-exact agreement on everything the shipped stylesheets
exercise, and identical error positions on the malformed inputs the
reference unit-tests), so this module necessarily mirrors
``token.rs``'s decomposition.  Error message *wording* is this
implementation's own; only positions and the accept/reject behavior
are contract.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum, auto
from typing import Iterator, NamedTuple, Optional, Tuple, Union

from tilebench.ref.core.color import Color
from tilebench.ref.mapcss import MapcssError


class TokKind(Enum):
    IMPORT = auto()
    IDENTIFIER = auto()
    STRING = auto()
    NUMBER = auto()
    ZOOM_RANGE = auto()
    COLOR_REF = auto()
    COLOR = auto()

    LEFT_PAREN = auto()
    RIGHT_PAREN = auto()
    LEFT_BRACKET = auto()
    RIGHT_BRACKET = auto()
    LEFT_BRACE = auto()
    RIGHT_BRACE = auto()

    EQUAL = auto()
    NOT_EQUAL = auto()
    LESS = auto()
    GREATER = auto()
    LESS_OR_EQUAL = auto()
    GREATER_OR_EQUAL = auto()
    REGEX_MATCH = auto()

    BANG = auto()
    QUESTION_MARK = auto()
    COLON = auto()
    DOUBLE_COLON = auto()
    SEMI_COLON = auto()
    COMMA = auto()


class InputPosition(NamedTuple):
    line: int
    character: int


@dataclass(frozen=True)
class Token:
    kind: TokKind
    # IMPORT/IDENTIFIER/STRING/COLOR_REF -> str; NUMBER -> float;
    # COLOR -> Color; ZOOM_RANGE -> (min_zoom, max_zoom) Optional[int] pair.
    value: object = None

    def __str__(self) -> str:
        simple = _SIMPLE_TOKEN_TEXT.get(self.kind)
        if simple is not None:
            return simple
        return f"{self.kind.name}({self.value!r})"


class TokenWithPosition(NamedTuple):
    token: Token
    position: InputPosition


_TWO_CHAR = {
    ("!", "="): TokKind.NOT_EQUAL,
    ("<", "="): TokKind.LESS_OR_EQUAL,
    (">", "="): TokKind.GREATER_OR_EQUAL,
    ("=", "~"): TokKind.REGEX_MATCH,
    (":", ":"): TokKind.DOUBLE_COLON,
}

_ONE_CHAR = {
    "(": TokKind.LEFT_PAREN,
    ")": TokKind.RIGHT_PAREN,
    "[": TokKind.LEFT_BRACKET,
    "]": TokKind.RIGHT_BRACKET,
    "{": TokKind.LEFT_BRACE,
    "}": TokKind.RIGHT_BRACE,
    "=": TokKind.EQUAL,
    "<": TokKind.LESS,
    ">": TokKind.GREATER,
    "!": TokKind.BANG,
    "?": TokKind.QUESTION_MARK,
    ":": TokKind.COLON,
    ";": TokKind.SEMI_COLON,
    ",": TokKind.COMMA,
}

_SIMPLE_TOKEN_TEXT = {v: "".join(k) for k, v in _TWO_CHAR.items()}
_SIMPLE_TOKEN_TEXT.update({v: k for k, v in _ONE_CHAR.items()})


def _can_be_in_at_directive(ch: str) -> bool:
    return ch == "_" or "a" <= ch <= "z" or "0" <= ch <= "9"


def _can_start_identifier(ch: str) -> bool:
    return ch == "_" or "a" <= ch <= "z" or "A" <= ch <= "Z"


def _can_continue_identifier(ch: str) -> bool:
    return ch in "-./" or "0" <= ch <= "9" or _can_start_identifier(ch)


class Tokenizer:
    def __init__(self, text: str):
        self.text = text
        self.idx = 0
        self.line = 1
        self.character = 0
        self.had_newline = False

    # -- low-level cursor ops (mirror the reference's position tracking) --

    def position(self) -> InputPosition:
        return InputPosition(self.line, self.character)

    def _next_char_with_pos(self) -> Optional[Tuple[int, str]]:
        if self.idx >= len(self.text):
            return None
        i = self.idx
        ch = self.text[i]
        self.idx += 1
        if self.had_newline:
            self.line += 1
            self.character = 0
            self.had_newline = False
        self.character += 1
        self.had_newline = ch == "\n"
        return i, ch

    def _next_char(self) -> Optional[str]:
        r = self._next_char_with_pos()
        return None if r is None else r[1]

    def _advance(self) -> None:
        self._next_char()

    def _peek(self) -> Optional[str]:
        if self.idx >= len(self.text):
            return None
        return self.text[self.idx]

    def _error(self, message: str):
        raise MapcssError(message, self.line, self.character)

    def _expect_char(self, expected: str) -> None:
        ch = self._next_char()
        if ch != expected:
            self._error(f"expected '{expected}' here")

    # -- token readers --

    def __iter__(self) -> Iterator[TokenWithPosition]:
        while True:
            nxt = self._next_significant_char()
            if nxt is None:
                return
            idx, ch = nxt
            pos = self.position()
            yield TokenWithPosition(self._read_token(idx, ch), pos)

    def _next_significant_char(self) -> Optional[Tuple[int, str]]:
        while True:
            r = self._next_char_with_pos()
            if r is None:
                return None
            idx, ch = r
            if ch.isspace():
                continue
            if ch == "/" and self._try_skip_comment():
                continue
            return idx, ch

    def _try_skip_comment(self) -> bool:
        nxt = self._peek()
        if nxt == "/":
            self._advance()
            while True:
                ch = self._next_char()
                if ch is None or ch == "\n":
                    return True
        if nxt == "*":
            self._advance()
            while True:
                ch = self._next_char()
                if ch is None:
                    self._error("block comment is never closed")
                if ch == "*" and self._peek() == "/":
                    self._advance()
                    return True
        return False

    def _read_token(self, idx: int, ch: str) -> Token:
        nxt = self._peek()
        if nxt is not None and (ch, nxt) in _TWO_CHAR:
            kind = _TWO_CHAR[(ch, nxt)]
            self._advance()
            return Token(kind)
        if ch in _ONE_CHAR:
            return Token(_ONE_CHAR[ch])
        if ch == "@":
            return self._read_at_directive()
        if ch == "*":
            return Token(TokKind.IDENTIFIER, "*")
        if _can_start_identifier(ch):
            return self._read_identifier(idx)
        if ch == '"':
            return self._read_string(idx + 1)
        if "0" <= ch <= "9" or ch in "+.":
            return self._read_number(ch)
        if ch == "-":
            if nxt is not None and "0" <= nxt <= "9":
                return self._read_number(ch)
            if nxt is not None and _can_continue_identifier(nxt):
                return self._read_identifier(idx)
            self._error("'-' must begin a negative number or an identifier")
        if ch == "|":
            return self._read_zoom_range()
        if ch == "#":
            return self._read_color()
        self._error(f"cannot tokenize '{ch}'")

    def _read_at_directive(self) -> Token:
        r = self._next_char_with_pos()
        if r is None or not _can_be_in_at_directive(r[1]):
            self._error("'@' must be followed by a directive or color name")
        start_idx = r[0]
        end_idx = start_idx
        while True:
            nxt = self._peek()
            if nxt is not None and _can_be_in_at_directive(nxt):
                end_idx = self.idx
                self._advance()
            else:
                break
        directive_text = self.text[start_idx : end_idx + 1]
        if directive_text != "import":
            return Token(TokKind.COLOR_REF, directive_text)

        nxt = self._peek()
        if nxt is not None and (nxt.isspace() or nxt == "("):
            self._advance()
        r = self._next_char_with_pos()
        if r is None or r[1] != '"':
            self._error("@import requires a quoted file name")
        import_text = self._read_string(r[0] + 1).value
        nxt = self._peek()
        if nxt is not None and (nxt.isspace() or nxt == ")"):
            self._advance()
        return Token(TokKind.IMPORT, import_text)

    def _read_identifier(self, start_idx: int) -> Token:
        end_idx = start_idx
        while True:
            nxt = self._peek()
            if nxt is not None and _can_continue_identifier(nxt):
                end_idx = self.idx
                self._advance()
            else:
                break
        return Token(TokKind.IDENTIFIER, self.text[start_idx : end_idx + 1])

    def _read_string(self, start_idx: int) -> Token:
        end_idx = start_idx
        terminated = False
        while True:
            r = self._next_char_with_pos()
            if r is None:
                break
            end_idx = r[0]
            if r[1] == '"':
                terminated = True
                break
        if not terminated:
            self._error("string literal is never closed")
        return Token(TokKind.STRING, self.text[start_idx:end_idx])

    def _read_number(self, first_ch: str) -> Token:
        sign = 1.0
        if first_ch in "+-":
            nxt = self._next_char()
            if nxt is None:
                self._error("a numeric sign must be followed by digits")
            sign = -1.0 if first_ch == "-" else 1.0
            first_ch = nxt

        had_dot = False
        if "0" <= first_ch <= "9":
            number = float(int(first_ch))
        elif first_ch == ".":
            had_dot = True
            number = 0.0
        else:
            self._error(f"'{first_ch}' cannot start a number")

        number_after_dot = 0.0
        digits_after_dot = 0

        while True:
            nxt = self._peek()
            if nxt is not None and "0" <= nxt <= "9":
                d = float(int(nxt))
                if had_dot:
                    digits_after_dot += 1
                    number_after_dot = 10.0 * number_after_dot + d
                else:
                    number = 10.0 * number + d
                self._advance()
            elif nxt == "." and not had_dot:
                had_dot = True
                self._advance()
            else:
                break

        if had_dot and digits_after_dot == 0:
            self._error("a decimal point needs at least one digit after it")
        if digits_after_dot > 0:
            number += number_after_dot / (10.0**digits_after_dot)
        return Token(TokKind.NUMBER, sign * number)

    def _read_color(self) -> Token:
        digits = []
        while True:
            nxt = self._peek()
            if nxt is not None and nxt in "0123456789abcdefABCDEF":
                digits.append(int(nxt, 16))
                self._advance()
            else:
                break
        if len(digits) == 6:
            color = Color(
                digits[0] * 16 + digits[1],
                digits[2] * 16 + digits[3],
                digits[4] * 16 + digits[5],
            )
        elif len(digits) == 3:
            color = Color(digits[0] * 17, digits[1] * 17, digits[2] * 17)
        else:
            self._error("a hex color has exactly 3 or 6 digits")
        return Token(TokKind.COLOR, color)

    def _read_zoom_range(self) -> Token:
        self._expect_char("z")
        min_zoom = self._read_zoom_level()
        had_hyphen = False
        if self._peek() == "-":
            self._advance()
            had_hyphen = True
        max_zoom = self._read_zoom_level()
        if min_zoom is None and max_zoom is None:
            self._error("a zoom range needs at least one bound (|zN, |zN-M, |zN-, |z-M)")
        return Token(
            TokKind.ZOOM_RANGE, (min_zoom, max_zoom if had_hyphen else min_zoom)
        )

    def _read_zoom_level(self) -> Optional[int]:
        d1 = self._read_digit()
        if d1 is None:
            return None
        d2 = self._read_digit()
        return d1 if d2 is None else 10 * d1 + d2

    def _read_digit(self) -> Optional[int]:
        nxt = self._peek()
        if nxt is not None and "0" <= nxt <= "9":
            self._advance()
            return int(nxt)
        return None
