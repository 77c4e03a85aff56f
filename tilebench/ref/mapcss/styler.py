"""MapCSS style cascade engine.

Matches every rule x selector against entity tags and zoom, builds
per-``::layer`` property maps (a ``*`` layer broadcasts into all
layers), and converts them to `Style` records, replicating the
reference's semantics (`src/mapcss/styler.rs`):

* casing width = base width + multiplier * casing-width
  (JOSM multiplier 2.0, Maps.ME 1.0, `styler.rs:98-101`);
* default z-index: node 4.0, closed way/multipolygon 1.0, open way 3.0;
* paint-order sort key: (layer tag, is_foreground_fill [skipped for
  labels], z-index, global id), stable (`styler.rs:246-272`);
* canvas color: JOSM reads `fill-color`, Maps.ME `background-color`
  from the `canvas` selector;
* only the property set consumed by `property_map_to_style`
  (`styler.rs:277-429`) is honored — everything else (halos, linejoin,
  font-family, ...) is parsed but deliberately dropped, exactly like
  the reference, to stay pixel-compatible.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, field
from enum import Enum
from functools import cmp_to_key
from typing import Dict, List, Optional, Tuple, Union

from tilebench.ref.core.color import Color, from_color_name
from tilebench.ref.geodata.reader import Multipolygon, Node, Way
from tilebench.ref.mapcss.parser import (
    BinaryNumericTest,
    BinaryNumericTestType,
    BinaryStringTest,
    BinaryStringTestType,
    ObjectType,
    PropColor,
    PropIdentifier,
    PropNumbers,
    PropString,
    PropWidthDelta,
    Rule,
    Selector,
    UnaryTest,
    UnaryTestType,
)
from tilebench.ref.mapcss.style_cache import StyleCache


class LineCap(Enum):
    BUTT = "butt"
    ROUND = "round"
    SQUARE = "square"


class TextPosition(Enum):
    CENTER = "center"
    LINE = "line"


def is_non_trivial_cap(line_cap: Optional[LineCap]) -> bool:
    return line_cap in (LineCap.ROUND, LineCap.SQUARE)


@dataclass
class TextStyle:
    text: str
    text_color: Optional[Color]
    text_position: Optional[TextPosition]
    font_size: Optional[float]


@dataclass
class Style:
    layer: Optional[int] = None
    z_index: float = 0.0

    color: Optional[Color] = None
    fill_color: Optional[Color] = None
    is_foreground_fill: bool = True
    background_color: Optional[Color] = None
    opacity: Optional[float] = None
    fill_opacity: Optional[float] = None

    width: Optional[float] = None
    dashes: Optional[List[float]] = None
    line_cap: Optional[LineCap] = None

    casing_color: Optional[Color] = None
    casing_width: Optional[float] = None
    casing_dashes: Optional[List[float]] = None
    casing_line_cap: Optional[LineCap] = None

    icon_image: Optional[str] = None
    fill_image: Optional[str] = None
    text_style: Optional[TextStyle] = None


BASE_LAYER_NAME = "default"


def default_z_index(entity) -> float:
    if isinstance(entity, Node):
        return 4.0
    return 1.0 if entity.is_closed() else 3.0


def matches_object_type(entity, object_type: ObjectType) -> bool:
    if isinstance(entity, Node):
        return object_type == ObjectType.NODE
    if object_type == ObjectType.WAY:
        return True
    if object_type == ObjectType.AREA:
        return entity.is_closed()
    return False


def cache_slot(entity) -> int:
    if isinstance(entity, Node):
        return 0
    if isinstance(entity, Multipolygon):
        return 3
    return 1 if entity.is_closed() else 2


def _is_true_value(x: str) -> bool:
    return x in ("yes", "true", "1")


def matches_by_tags(entity, test) -> bool:
    tags = entity.tags()
    if isinstance(test, UnaryTest):
        tag_val = tags.get_by_key(test.tag_name)
        tt = test.test_type
        if tt == UnaryTestType.EXISTS:
            return tag_val is not None
        if tt == UnaryTestType.NOT_EXISTS:
            return tag_val is None
        if tt == UnaryTestType.TRUE:
            return tag_val is not None and _is_true_value(tag_val)
        return not (tag_val is not None and _is_true_value(tag_val))
    if isinstance(test, BinaryStringTest):
        tag_val = tags.get_by_key(test.tag_name)
        if test.test_type == BinaryStringTestType.EQUAL:
            return tag_val == test.value
        return tag_val != test.value
    # BinaryNumericCompare: non-numeric tag values never match.
    tag_val = tags.get_by_key(test.tag_name)
    if tag_val is None:
        return False
    try:
        num = _rust_parse_f64(tag_val)
    except ValueError:
        return False
    tt = test.test_type
    if tt == BinaryNumericTestType.LESS:
        return num < test.value
    if tt == BinaryNumericTestType.LESS_OR_EQUAL:
        return num <= test.value
    if tt == BinaryNumericTestType.GREATER:
        return num > test.value
    return num >= test.value


def _rust_parse_f64(s: str) -> float:
    """Rust's `str::parse::<f64>` (no leading/trailing whitespace, no
    underscores, optional inf/NaN)."""
    t = s.strip()
    if t != s or not s:
        raise ValueError(s)
    low = s.lower()
    if low in ("inf", "+inf", "-inf", "infinity", "+infinity", "-infinity", "nan", "+nan", "-nan"):
        return float(low.replace("infinity", "inf"))
    # Reject Python-isms Rust rejects.
    if "_" in s or s.startswith("0x") or s.startswith("0X") or " " in s:
        raise ValueError(s)
    return float(s)


def _rust_parse_i64(s: str) -> Optional[int]:
    """Rust's `str::parse::<i64>`: optional sign + ASCII digits only."""
    t = s
    if not t:
        return None
    body = t[1:] if t[0] in "+-" else t
    if not body or not all("0" <= c <= "9" for c in body):
        return None
    v = int(t)
    if not (-(2**63) <= v < 2**63):
        return None
    return v


def area_matches(entity, selector: Selector, zoom: int) -> bool:
    if selector.min_zoom is not None and zoom < selector.min_zoom:
        return False
    if selector.max_zoom is not None and zoom > selector.max_zoom:
        return False
    if not matches_object_type(entity, selector.object_type):
        return False
    return all(matches_by_tags(entity, t) for t in selector.tests)


def _get_layer_id(selector: Selector) -> str:
    return selector.layer_id if selector.layer_id is not None else BASE_LAYER_NAME


class Styler:
    def __init__(
        self,
        rules: List[Rule],
        style_type: str = "josm",
        font_size_multiplier: Optional[float] = None,
    ):
        if style_type not in ("josm", "mapsme"):
            raise ValueError(f"Unknown stylesheet type: {style_type}")
        self.rules = rules
        self.use_caps_for_dashes = style_type == "josm"
        self.canvas_fill_color = _extract_canvas_fill_color(rules, style_type)
        self.casing_width_multiplier = 1.0 if style_type == "mapsme" else 2.0
        self.font_size_multiplier = font_size_multiplier
        self.style_cache = StyleCache(rules)
        # Styled-row memo: (entity class, local id, zoom) -> list of
        # ((entity, style), sort_key, labels_sort_key), weakly keyed by
        # reader.  An entity is styled in up to 9 neighboring tiles per
        # batch; this skips cache-key reconstruction AND per-sort key()
        # calls on every revisit (the serving cold path's hottest loop).
        # The memoized entity view is reused verbatim — views are value
        # objects over the mmap (reader + local id), so identity reuse
        # is safe and lets downstream id()-keyed memos hit across tiles.
        import weakref

        self._rows_memo: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()

    def _styled_rows(self, entities, zoom: int):
        rows: list = []
        memo_all = self._rows_memo
        d = None
        for entity in entities:
            if d is None:
                d = memo_all.get(entity.reader)
                if d is None:
                    d = {}
                    memo_all[entity.reader] = d
            k = (entity.__class__, entity.local_id, zoom)
            got = d.get(k)
            if got is None:
                cached = self.style_cache.get(entity, zoom)
                if cached is None:
                    cached = self._compute_styles(entity, zoom)
                    self.style_cache.insert(entity, zoom, cached)
                gid = entity.global_id
                got = [
                    (
                        (entity, s),
                        (
                            s.layer if s.layer is not None else 0,
                            s.is_foreground_fill,
                            s.z_index,
                            gid,
                        ),
                        (s.layer if s.layer is not None else 0, s.z_index, gid),
                    )
                    for s in cached
                ]
                d[k] = got
            rows.extend(got)
        return rows

    def style_entities(self, entities, zoom: int, for_labels: bool):
        import operator

        rows = self._styled_rows(entities, zoom)
        rows.sort(key=operator.itemgetter(2 if for_labels else 1))
        return [r[0] for r in rows]

    def style_areas(self, ways, multipolygons, zoom: int, for_labels: bool):
        """Merge independently-styled ways and multipolygons into one
        paint-order list (`styler.rs:168-203`); ties prefer the
        multipolygon, matching the reference's merge."""
        import operator

        col = 2 if for_labels else 1
        key = operator.itemgetter(col)
        rw = self._styled_rows(ways, zoom)
        rw.sort(key=key)
        rm = self._styled_rows(multipolygons, zoom)
        rm.sort(key=key)
        result = []
        wi = mi = 0
        nw, nm = len(rw), len(rm)
        while wi < nw or mi < nm:
            if mi >= nm:
                result.append(rw[wi][0]); wi += 1
            elif wi >= nw:
                result.append(rm[mi][0]); mi += 1
            elif rm[mi][col] <= rw[wi][col]:
                result.append(rm[mi][0]); mi += 1
            else:
                result.append(rw[wi][0]); wi += 1
        return result

    def _compute_styles(self, entity, zoom: int) -> List[Style]:
        all_property_maps = self._style_area(entity, zoom)
        base_layer = all_property_maps.get(BASE_LAYER_NAME)
        dzi = default_z_index(entity)
        styles = []
        for layer, prop_map in all_property_maps.items():
            if layer != "*":
                styles.append(
                    _property_map_to_style(
                        prop_map,
                        base_layer,
                        dzi,
                        self.casing_width_multiplier,
                        self.font_size_multiplier,
                        entity,
                    )
                )
        return styles

    def _style_area(self, entity, zoom: int) -> Dict[str, Dict[str, object]]:
        result: Dict[str, Dict[str, object]] = {}
        for rule in self.rules:
            for sel in rule.selectors:
                if not area_matches(entity, sel, zoom):
                    continue
                layer_id = _get_layer_id(sel)
                if layer_id not in result:
                    parent = dict(result.get("*", ()))
                    result[layer_id] = parent
                layer = result[layer_id]
                for prop in rule.properties:
                    layer[prop.name] = prop.value
                if layer_id == "*":
                    for k, v in result.items():
                        if k != "*":
                            for prop in rule.properties:
                                v[prop.name] = prop.value
        return result


def _warn(entity, prop_name: str, val, msg: str) -> None:
    print(
        f'Entity #{entity.global_id}, property "{prop_name}" (value {val}): {msg}',
        file=sys.stderr,
    )


def _property_map_to_style(
    current, base_layer, dzi: float, casing_width_multiplier: float,
    font_size_multiplier: Optional[float], entity,
) -> Style:
    def get_color(prop_name: str) -> Optional[Color]:
        v = current.get(prop_name)
        if isinstance(v, PropColor):
            return v.value
        if isinstance(v, PropIdentifier):
            color = from_color_name(v.value)
            if color is None:
                _warn(entity, prop_name, v, "unknown color")
            return color
        if v is not None:
            _warn(entity, prop_name, v, "expected a valid color")
        return None

    def get_num(prop_map, prop_name: str) -> Optional[float]:
        v = prop_map.get(prop_name)
        if isinstance(v, PropNumbers) and len(v.value) == 1:
            return v.value[0]
        if v is not None:
            _warn(entity, prop_name, v, "expected a number")
        return None

    def get_id(prop_name: str) -> Optional[str]:
        v = current.get(prop_name)
        return v.value if isinstance(v, PropIdentifier) else None

    def get_string(prop_name: str) -> Optional[str]:
        v = current.get(prop_name)
        if isinstance(v, (PropIdentifier, PropString)):
            return v.value
        if v is not None:
            _warn(entity, prop_name, v, "expected a string")
        return None

    def get_line_cap(prop_name: str) -> Optional[LineCap]:
        v = get_id(prop_name)
        if v in ("none", "butt"):
            return LineCap.BUTT
        if v == "round":
            return LineCap.ROUND
        if v == "square":
            return LineCap.SQUARE
        if current.get(prop_name) is not None:
            _warn(entity, prop_name, current.get(prop_name), "unknown line cap value")
        return None

    def get_text_position(prop_name: str) -> Optional[TextPosition]:
        v = get_id(prop_name)
        if v == "center":
            return TextPosition.CENTER
        if v == "line":
            return TextPosition.LINE
        if current.get(prop_name) is not None:
            _warn(entity, prop_name, current.get(prop_name), "unknown text position type")
        return None

    def get_dashes(prop_name: str) -> Optional[List[float]]:
        v = current.get(prop_name)
        if isinstance(v, PropNumbers):
            return list(v.value)
        if v is not None:
            _warn(entity, prop_name, v, "expected a sequence of numbers")
        return None

    layer_tag = entity.tags().get_by_key("layer")
    layer = _rust_parse_i64(layer_tag) if layer_tag is not None else None

    z_index = get_num(current, "z-index")
    if z_index is None:
        z_index = dzi

    fp = current.get("fill-position")
    is_foreground_fill = not (isinstance(fp, PropIdentifier) and fp.value == "background")

    width = get_num(current, "width")

    base_width_for_casing = width
    if base_width_for_casing is None and base_layer is not None:
        base_width_for_casing = get_num(base_layer, "width")
    if base_width_for_casing is None:
        base_width_for_casing = 0.0

    cw = current.get("casing-width")
    if isinstance(cw, PropNumbers) and len(cw.value) == 1:
        casing_only_width = cw.value[0]
    elif isinstance(cw, PropWidthDelta):
        casing_only_width = base_width_for_casing + cw.value
    else:
        if cw is not None:
            _warn(entity, "casing-width", cw, "expected a number or an eval(...) statement")
        casing_only_width = None
    full_casing_width = (
        base_width_for_casing + casing_width_multiplier * casing_only_width
        if casing_only_width is not None
        else None
    )

    text = get_string("text")
    font_size = get_num(current, "font-size")
    if font_size is not None:
        font_size *= font_size_multiplier if font_size_multiplier is not None else 1.0

    text_style = (
        TextStyle(
            text=text,
            text_color=get_color("text-color"),
            text_position=get_text_position("text-position"),
            font_size=font_size,
        )
        if text is not None
        else None
    )

    return Style(
        layer=layer,
        z_index=z_index,
        color=get_color("color"),
        fill_color=get_color("fill-color"),
        is_foreground_fill=is_foreground_fill,
        background_color=get_color("background-color"),
        opacity=get_num(current, "opacity"),
        fill_opacity=get_num(current, "fill-opacity"),
        width=width,
        dashes=get_dashes("dashes"),
        line_cap=get_line_cap("linecap"),
        casing_color=get_color("casing-color"),
        casing_width=full_casing_width,
        casing_dashes=get_dashes("casing-dashes"),
        casing_line_cap=get_line_cap("casing-linecap"),
        icon_image=get_string("icon-image"),
        fill_image=get_string("fill-image"),
        text_style=text_style,
    )


def _extract_canvas_fill_color(rules: List[Rule], style_type: str) -> Optional[Color]:
    color_prop = "fill-color" if style_type == "josm" else "background-color"
    for r in rules:
        for selector in r.selectors:
            if selector.object_type == ObjectType.CANVAS:
                for prop in r.properties:
                    if prop.name == color_prop and isinstance(prop.value, PropColor):
                        return prop.value.value
    return None
