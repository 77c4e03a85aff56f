"""RGB color type and CSS-name lookup (reference: `src/mapcss/color.rs`)."""

from __future__ import annotations

from typing import NamedTuple, Optional


class Color(NamedTuple):
    r: int
    g: int
    b: int


_NAMED_COLORS = {
    "white": Color(255, 255, 255),
    "black": Color(0, 0, 0),
    "blue": Color(0, 0, 255),
    "brown": Color(165, 42, 42),
    "green": Color(0, 255, 0),
    "grey": Color(128, 128, 128),
    "pink": Color(255, 192, 203),
    "purple": Color(128, 0, 128),
    "red": Color(255, 0, 0),
    "salmon": Color(250, 128, 114),
}


def from_color_name(name: str) -> Optional[Color]:
    return _NAMED_COLORS.get(name)
