"""MapCSS recursive-descent parser.

Produces the same AST shape as the reference (`src/mapcss/parser.rs`):
``Rule { selectors, properties }`` where a selector is an object type
(``*``/canvas/meta/node/way|line/area), an optional zoom range, a list of
``[...]`` tag tests, an optional ``::layer`` id (``:pseudo`` classes are
parsed and dropped), and property values are identifiers, strings,
colors, number lists, or the single supported ``eval`` form
``eval(prop("width") + X)`` -> ``WidthDelta``.

`format_rules` reproduces the reference's `Display` output byte-for-byte
(verified against `tests/mapcss/mapnik.parsed.canonical`).

Provenance: the grammar, the AST shape, and the Display format are all
contract (byte-exact golden vs the reference's canonical dump), so the
production rules here necessarily mirror ``parser.rs``'s.  Error
message wording is this implementation's own; only error positions and
accept/reject behavior follow the reference.
"""

from __future__ import annotations

import decimal
import math
import os
from dataclasses import dataclass, field
from enum import Enum
from typing import Dict, List, Optional, Union

from tilebench.ref.core.color import Color
from tilebench.ref.mapcss import MapcssError
from tilebench.ref.mapcss.token import (
    InputPosition,
    TokKind,
    Token,
    Tokenizer,
    TokenWithPosition,
)


class ObjectType(Enum):
    ALL = "*"
    CANVAS = "canvas"
    META = "meta"
    NODE = "node"
    WAY = "way"
    AREA = "area"

    def __str__(self) -> str:
        return self.value


class UnaryTestType(Enum):
    EXISTS = "exists"
    NOT_EXISTS = "not_exists"
    TRUE = "true"
    FALSE = "false"


class BinaryStringTestType(Enum):
    EQUAL = "="
    NOT_EQUAL = "!="


class BinaryNumericTestType(Enum):
    LESS = "<"
    LESS_OR_EQUAL = "<="
    GREATER = ">"
    GREATER_OR_EQUAL = ">="


def _quote_tag(tag_name: str) -> str:
    return f'"{tag_name}"' if ":" in tag_name else tag_name


def fmt_f64(x: float) -> str:
    """Format a float exactly like Rust's `Display` for f64: shortest
    round-trip decimal, no trailing `.0`, never exponent notation."""
    if math.isinf(x):
        return "inf" if x > 0 else "-inf"
    if math.isnan(x):
        return "NaN"
    if x == int(x) and abs(x) < 1e17:
        # Preserve the sign of -0.0 like Rust does.
        if x == 0 and math.copysign(1.0, x) < 0:
            return "-0"
        return str(int(x))
    r = repr(x)
    if "e" in r or "E" in r:
        return format(decimal.Decimal(r), "f")
    return r


@dataclass
class UnaryTest:
    tag_name: str
    test_type: UnaryTestType

    def __str__(self) -> str:
        q = _quote_tag(self.tag_name)
        inner = {
            UnaryTestType.EXISTS: q,
            UnaryTestType.NOT_EXISTS: f"!{q}",
            UnaryTestType.TRUE: f"{q}?",
            UnaryTestType.FALSE: f"!{q}?",
        }[self.test_type]
        return f"[{inner}]"


@dataclass
class BinaryStringTest:
    tag_name: str
    value: str
    test_type: BinaryStringTestType

    def __str__(self) -> str:
        return f"[{_quote_tag(self.tag_name)}{self.test_type.value}{self.value}]"


@dataclass
class BinaryNumericTest:
    tag_name: str
    value: float
    test_type: BinaryNumericTestType

    def __str__(self) -> str:
        return (
            f"[{_quote_tag(self.tag_name)}{self.test_type.value}{fmt_f64(self.value)}]"
        )


Test = Union[UnaryTest, BinaryStringTest, BinaryNumericTest]


@dataclass
class PropIdentifier:
    value: str

    def __str__(self) -> str:
        return self.value


@dataclass
class PropString:
    value: str

    def __str__(self) -> str:
        return f'"{self.value}"'


@dataclass
class PropColor:
    value: Color

    def __str__(self) -> str:
        c = self.value
        return f"#{c.r:02x}{c.g:02x}{c.b:02x}"


@dataclass
class PropNumbers:
    value: List[float]

    def __str__(self) -> str:
        return ",".join(fmt_f64(n) for n in self.value)


@dataclass
class PropWidthDelta:
    value: float

    def __str__(self) -> str:
        return f'eval(prop("width")) + {fmt_f64(self.value)}'


PropertyValue = Union[PropIdentifier, PropString, PropColor, PropNumbers, PropWidthDelta]


@dataclass
class Property:
    name: str
    value: PropertyValue

    def __str__(self) -> str:
        return f"{self.name}: {self.value};"


@dataclass
class Selector:
    object_type: ObjectType
    min_zoom: Optional[int] = None
    max_zoom: Optional[int] = None
    tests: List[Test] = field(default_factory=list)
    layer_id: Optional[str] = None

    def __str__(self) -> str:
        if self.min_zoom is None and self.max_zoom is None:
            zoom = ""
        elif self.max_zoom is None:
            zoom = f"{self.min_zoom}-"
        elif self.min_zoom is None:
            zoom = f"-{self.max_zoom}"
        elif self.min_zoom != self.max_zoom:
            zoom = f"{self.min_zoom}-{self.max_zoom}"
        else:
            zoom = f"{self.min_zoom}"
        layer = f"::{self.layer_id}" if self.layer_id is not None else ""
        tests = "".join(str(t) for t in self.tests)
        z_prefix = "|z" if zoom else ""
        return f"{self.object_type}{z_prefix}{zoom}{tests}{layer}"


@dataclass
class Rule:
    selectors: List[Selector] = field(default_factory=list)
    properties: List[Property] = field(default_factory=list)

    def __str__(self) -> str:
        sels = ",\n".join(str(s) for s in self.selectors)
        props = "\n".join(str(p) for p in self.properties)
        return f"{sels} {{\n{props}\n}}"


def format_rules(rules: List[Rule]) -> str:
    return "\n\n".join(str(r) for r in rules)


_ID_TO_OBJECT_TYPE = {
    "*": ObjectType.ALL,
    "canvas": ObjectType.CANVAS,
    "meta": ObjectType.META,
    "node": ObjectType.NODE,
    "way": ObjectType.WAY,
    "line": ObjectType.WAY,
    "area": ObjectType.AREA,
}

_BINARY_STRING_OPS = {
    TokKind.EQUAL: BinaryStringTestType.EQUAL,
    TokKind.NOT_EQUAL: BinaryStringTestType.NOT_EQUAL,
}

_BINARY_NUMERIC_OPS = {
    TokKind.LESS: BinaryNumericTestType.LESS,
    TokKind.LESS_OR_EQUAL: BinaryNumericTestType.LESS_OR_EQUAL,
    TokKind.GREATER: BinaryNumericTestType.GREATER,
    TokKind.GREATER_OR_EQUAL: BinaryNumericTestType.GREATER_OR_EQUAL,
}


def parse_file(base_path: str, file_name: str) -> List[Rule]:
    """Parse a stylesheet (resolving `@import`s relative to `base_path`)."""
    content = _read_stylesheet(base_path, file_name)
    parser = _Parser(content, base_path, file_name, {})
    return parser.parse()


def parse_string(content: str, file_name: str = "<string>") -> List[Rule]:
    return _Parser(content, "", file_name, {}).parse()


def _read_stylesheet(base_path: str, file_name: str) -> str:
    with open(os.path.join(base_path, file_name), "r", encoding="utf-8") as f:
        return f.read()


class _Parser:
    def __init__(self, content: str, base_path: str, file_name: str, color_defs: Dict[str, Color]):
        self.tokenizer = Tokenizer(content)
        self.tokens = iter(self.tokenizer)
        self.base_path = base_path
        self.file_name = file_name
        self.color_defs = dict(color_defs)

    def parse(self) -> List[Rule]:
        result: List[Rule] = []
        while True:
            twp = self._read_optional_token()
            if twp is None:
                break
            tok = twp.token
            if tok.kind == TokKind.IMPORT:
                self._expect_simple(TokKind.SEMI_COLON)
                rules, color_defs = self._import_file(tok.value)
                result.extend(rules)
                self.color_defs.update(color_defs)
            elif tok.kind == TokKind.COLOR_REF:
                self._read_color_def(tok.value)
            else:
                result.append(self._read_rule(twp))
        return result

    def _import_file(self, file_name: str):
        content = _read_stylesheet(self.base_path, file_name)
        sub = _Parser(content, self.base_path, file_name, self.color_defs)
        rules = sub.parse()
        return rules, sub.color_defs

    def _read_color_def(self, color_name: str) -> None:
        self._expect_simple(TokKind.COLON)
        value_token = self._read_mandatory_token().token
        color = value_token.value if value_token.kind == TokKind.COLOR else None
        self._expect_simple(TokKind.SEMI_COLON)
        if color is not None:
            self.color_defs[color_name] = color

    def _read_rule(self, selector_start: TokenWithPosition) -> Rule:
        rule = Rule()
        while True:
            if selector_start.token.kind == TokKind.LEFT_BRACE:
                break
            # Skip the auxiliary `colors { ... }` section from Maps.ME MapCSS.
            if (
                selector_start.token.kind == TokKind.IDENTIFIER
                and selector_start.token.value == "colors"
            ):
                while self._read_mandatory_token().token.kind != TokKind.RIGHT_BRACE:
                    pass
                return rule
            selector, expect_more = self._read_selector(selector_start)
            rule.selectors.append(selector)
            if not expect_more:
                break
            selector_start = self._read_mandatory_token()
        rule.properties = self._read_properties()
        return rule

    def _read_selector(self, first: TokenWithPosition):
        tok = first.token
        if tok.kind != TokKind.IDENTIFIER:
            self._unexpected_token(first)
        object_type = _ID_TO_OBJECT_TYPE.get(tok.value)
        if object_type is None:
            self._parse_error(f"'{tok.value}' is not a selectable object type", first.position)
        selector = Selector(object_type)

        while True:
            current = self._read_mandatory_token()
            kind = current.token.kind
            if kind == TokKind.LEFT_BRACE:
                return selector, False
            if kind == TokKind.COMMA:
                return selector, True
            if kind == TokKind.ZOOM_RANGE:
                selector.min_zoom, selector.max_zoom = current.token.value
            elif kind == TokKind.LEFT_BRACKET:
                selector.tests.append(self._read_test())
            elif kind == TokKind.COLON:
                # Pseudo-class: parsed, then dropped.
                self._read_identifier()
            elif kind == TokKind.DOUBLE_COLON:
                selector.layer_id = self._read_identifier()
            else:
                self._unexpected_token(current)

    def _read_test(self) -> Test:
        starts_with_bang = False
        current = self._read_mandatory_token()

        if current.token.kind == TokKind.IDENTIFIER:
            lhs = current.token.value
        elif current.token.kind == TokKind.STRING:
            lhs = current.token.value
        elif current.token.kind == TokKind.BANG:
            starts_with_bang = True
            lhs = self._read_identifier()
        else:
            self._unexpected_token(current)

        current = self._read_mandatory_token()
        if current.token.kind == TokKind.COLON:
            lhs = lhs + ":" + self._read_identifier()
            current = self._read_mandatory_token()

        if not starts_with_bang:
            if current.token.kind in _BINARY_STRING_OPS:
                op = _BINARY_STRING_OPS[current.token.kind]
                current = self._read_mandatory_token()
                if current.token.kind == TokKind.IDENTIFIER:
                    rhs = current.token.value
                elif current.token.kind == TokKind.NUMBER:
                    rhs = fmt_f64(current.token.value)
                else:
                    self._unexpected_token(current)
                self._expect_simple(TokKind.RIGHT_BRACKET)
                return BinaryStringTest(lhs, rhs, op)

            if current.token.kind in _BINARY_NUMERIC_OPS:
                op = _BINARY_NUMERIC_OPS[current.token.kind]
                current = self._read_mandatory_token()
                if current.token.kind != TokKind.NUMBER:
                    self._unexpected_token(current)
                rhs = current.token.value
                self._expect_simple(TokKind.RIGHT_BRACKET)
                return BinaryNumericTest(lhs, rhs, op)

        if current.token.kind == TokKind.RIGHT_BRACKET:
            tt = UnaryTestType.NOT_EXISTS if starts_with_bang else UnaryTestType.EXISTS
        elif current.token.kind == TokKind.QUESTION_MARK:
            current = self._read_mandatory_token()
            if current.token.kind == TokKind.RIGHT_BRACKET:
                tt = UnaryTestType.FALSE if starts_with_bang else UnaryTestType.TRUE
            elif current.token.kind == TokKind.BANG and not starts_with_bang:
                self._expect_simple(TokKind.RIGHT_BRACKET)
                tt = UnaryTestType.FALSE
            else:
                self._unexpected_token(current)
        else:
            self._unexpected_token(current)
        return UnaryTest(lhs, tt)

    def _read_properties(self) -> List[Property]:
        result: List[Property] = []
        while True:
            twp = self._read_mandatory_token()
            if twp.token.kind == TokKind.IDENTIFIER:
                self._expect_simple(TokKind.COLON)
                result.append(Property(twp.token.value, self._read_property_value(twp)))
            elif twp.token.kind == TokKind.RIGHT_BRACE:
                break
            else:
                self._unexpected_token(twp)
        return result

    def _read_property_value(self, name_token: TokenWithPosition) -> PropertyValue:
        twp = self._read_mandatory_token()
        tok = twp.token
        expect_semicolon = True
        if tok.kind == TokKind.IDENTIFIER:
            expect_semicolon = False
            if tok.value == "eval":
                result = self._read_simple_eval(twp.position)
            else:
                full_id = tok.value
                nxt = self._read_mandatory_token()
                if nxt.token.kind == TokKind.COLON:
                    full_id = full_id + ":" + self._read_identifier()
                    self._expect_simple(TokKind.SEMI_COLON)
                elif nxt.token.kind == TokKind.SEMI_COLON:
                    pass
                else:
                    self._unexpected_token(nxt)
                result = PropIdentifier(full_id)
        elif tok.kind == TokKind.STRING:
            result = PropString(tok.value)
        elif tok.kind == TokKind.COLOR:
            result = PropColor(tok.value)
        elif tok.kind == TokKind.COLOR_REF:
            color = self.color_defs.get(tok.value)
            if color is None:
                self._parse_error(
                    f"color reference @{tok.value} was never defined", self.tokenizer.position()
                )
            result = PropColor(color)
        elif tok.kind == TokKind.NUMBER:
            expect_semicolon = False
            result = PropNumbers(self._read_number_list(tok.value))
        else:
            self._unexpected_token(twp)
        if expect_semicolon:
            self._expect_simple(TokKind.SEMI_COLON)
        return result

    # Support the only eval() form used by Maps.ME: eval(prop("width") + X);
    def _read_simple_eval(self, position: InputPosition) -> PropertyValue:
        tokens: List[Token] = []
        while True:
            twp = self._read_mandatory_token()
            if twp.token.kind == TokKind.SEMI_COLON:
                break
            tokens.append(twp.token)

        expected_prefix = [
            (TokKind.LEFT_PAREN, None),
            (TokKind.IDENTIFIER, "prop"),
            (TokKind.LEFT_PAREN, None),
            (TokKind.STRING, "width"),
            (TokKind.RIGHT_PAREN, None),
        ]
        width_increment: Optional[float] = None
        if len(tokens) > len(expected_prefix) and all(
            t.kind == k and (v is None or t.value == v)
            for t, (k, v) in zip(tokens, expected_prefix)
        ):
            suffix = tokens[len(expected_prefix) :]
            if suffix and suffix[-1].kind == TokKind.RIGHT_PAREN:
                if len(suffix) == 1:
                    width_increment = 0.0
                elif len(suffix) == 2 and suffix[0].kind == TokKind.NUMBER:
                    width_increment = suffix[0].value

        if width_increment is None:
            self._parse_error("only eval(prop(\"width\") [+ N]) is supported", position)
        return PropWidthDelta(width_increment)

    def _read_number_list(self, first_num: float) -> List[float]:
        numbers = [first_num]
        consumed_number = True
        while True:
            twp = self._read_mandatory_token()
            kind = twp.token.kind
            if kind == TokKind.COMMA and consumed_number:
                consumed_number = False
            elif kind == TokKind.SEMI_COLON and consumed_number:
                break
            elif kind == TokKind.NUMBER and not consumed_number:
                consumed_number = True
                numbers.append(twp.token.value)
            else:
                self._unexpected_token(twp)
        return numbers

    def _read_identifier(self) -> str:
        twp = self._read_mandatory_token()
        if twp.token.kind != TokKind.IDENTIFIER:
            self._unexpected_token(twp)
        return twp.token.value

    def _read_mandatory_token(self) -> TokenWithPosition:
        twp = self._read_optional_token()
        if twp is None:
            self._parse_error("stylesheet ended mid-construct", self.tokenizer.position())
        return twp

    def _read_optional_token(self) -> Optional[TokenWithPosition]:
        return next(self.tokens, None)

    def _expect_simple(self, expected: TokKind) -> None:
        twp = self._read_mandatory_token()
        if twp.token.kind != expected:
            self._parse_error(
                f"wanted '{Token(expected)}' but got '{twp.token}'",
                twp.position,
            )

    def _unexpected_token(self, twp: TokenWithPosition):
        self._parse_error(f"'{twp.token}' does not fit here", twp.position)

    def _parse_error(self, message: str, position: InputPosition):
        raise MapcssError(message, position.line, position.character, self.file_name)
