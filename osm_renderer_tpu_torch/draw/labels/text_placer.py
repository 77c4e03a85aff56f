"""Text shaping and placement (reference: `font/text_placer.rs`).

Two modes: Line (glyphs walked and rotated along a way, skipped when
the text is wider than the way) and Center (word wrap at
MAX_TEXT_WIDTH = 32px, rows centered at the label anchor).  Glyph
outlines are emitted into the oracle's scanline coverage rasterizer,
with the same reversed per-segment traversal as the reference.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from osm_renderer_tpu_torch.draw.labels.font import CURVE_TO, LINE_TO, MOVE_TO, FontEngine
from osm_renderer_tpu_torch.draw.oracle import GlyphRasterizer, OracleTile
from osm_renderer_tpu_torch.mapcss.styler import TextPosition, TextStyle

MAX_TEXT_WIDTH = 256.0 / 8.0

_DEFAULT_FONT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))),
    "assets", "fonts", "NotoSans-Regular.ttf",
)


@dataclass
class _Glyph:
    ch: str
    width: float
    shape: Optional[tuple]


class TextPlacer:
    def __init__(self, font_path: Optional[str] = None):
        self.font = FontEngine(font_path or _DEFAULT_FONT)

    def enumerate_placements(
        self,
        entity,
        text_style: TextStyle,
        tile,
        global_scale: float,
        y_offset: int,
        default_text_position: TextPosition,
    ):
        """Shaping + placement without rasterization.

        Returns (placements, scale, rgb) where each placement is
        (glyph, kind, params):
          kind "center": params = (x_off, baseline)
          kind "line":   params = (wx, wy, sin_a, cos_a, gcx, gcy)
        or (None, 0, rgb) when the label trivially succeeds with no
        glyphs (missing text tag / font size / too-wide-for-way).
        Both the exact oracle path and the glyph-atlas path consume
        this, so placement math lives in exactly one place."""
        from osm_renderer_tpu_torch.draw.labels import labelable

        color = text_style.text_color
        rgb = (color.r, color.g, color.b) if color is not None else (0, 0, 0)

        if text_style.font_size is None:
            return None, 0.0, rgb
        font_size = text_style.font_size * global_scale

        text = entity.tags().get_by_key(text_style.text)
        if text is None:
            return None, 0.0, rgb

        text_pos = text_style.text_position or default_text_position
        scale = self.font.scale_for_pixel_height(font_size)
        glyphs, total_width = self._text_to_glyphs(text, scale)

        vm = self.font.v_metrics()
        ascent = vm.ascent * scale
        descent = vm.descent * scale
        line_gap = vm.line_gap * scale

        placements = []
        if text_pos == TextPosition.LINE:
            points = labelable.get_waypoints(entity, tile, global_scale)
            if points is not None:
                if points.shape[0] < 2:
                    return None, 0.0, rgb
                if points[0, 0] > points[-1, 0]:
                    points = points[::-1]
                seg_lens = [
                    math.sqrt(
                        float(
                            (points[i, 0] - points[i - 1, 0]) ** 2
                            + (points[i, 1] - points[i - 1, 1]) ** 2
                        )
                    )
                    for i in range(1, points.shape[0])
                ]
                total_way_length = sum(seg_lens)
                if total_width > total_way_length:
                    return None, 0.0, rgb
                cur_dist = (total_way_length - total_width) / 2.0
                glyph_center_y = (descent + ascent) / 2.0
                angles = [
                    math.atan2(
                        float(points[i + 1, 1] - points[i, 1]),
                        float(points[i + 1, 0] - points[i, 0]),
                    )
                    for i in range(points.shape[0] - 1)
                ]
                for glyph in glyphs:
                    glyph_center_x = glyph.width / 2.0
                    wx, wy, angle = _compute_way_position(
                        points, cur_dist + glyph_center_x, seg_lens, angles
                    )
                    sin_a = math.sin(-angle)
                    cos_a = math.cos(-angle)
                    placements.append(
                        (glyph, "line",
                         (wx, wy, sin_a, cos_a, glyph_center_x, glyph_center_y))
                    )
                    cur_dist += glyph.width
        else:  # Center
            pos = labelable.get_label_position(entity, tile, global_scale)
            if pos is not None:
                center_x, center_y = pos
                rows: List[Tuple[List[_Glyph], float]] = []
                current: List[_Glyph] = []
                current_width = 0.0
                for idx, glyph in enumerate(glyphs):
                    current.append(glyph)
                    current_width += glyph.width
                    is_last = idx + 1 == len(glyphs)
                    should_break = glyph.ch.isspace() and (
                        current_width + glyph.width > MAX_TEXT_WIDTH
                    )
                    if current and (should_break or is_last):
                        rows.append((list(current), current_width))
                        current.clear()
                        current_width = 0.0

                row_height = ascent - descent + line_gap
                total_height = row_height * len(rows)
                cur_y = center_y
                if y_offset > 0:
                    cur_y += float(y_offset)
                else:
                    cur_y -= total_height / 2.0

                for row, row_width in rows:
                    cur_x = center_x - row_width / 2.0
                    for glyph in row:
                        placements.append((glyph, "center", (cur_x, cur_y + ascent)))
                        cur_x += glyph.width
                    cur_y += row_height

        return placements, scale, rgb

    @staticmethod
    def make_tr(kind: str, params):
        """The per-point transform for a placement — the exact
        arithmetic golden images were canonized with."""
        if kind == "center":
            x_off, baseline = params

            def tr(p, _x=x_off, _b=baseline):
                return (_x + p[0], _b - p[1])

            return tr
        wx, wy, sin_a, cos_a, gcx, gcy = params

        def tr(p, _wx=wx, _wy=wy, _s=sin_a, _c=cos_a, _gcx=gcx, _gcy=gcy):
            tx = p[0] - _gcx
            ty = p[1] - _gcy
            rx = tx * _c - ty * _s
            ry = ty * _c + tx * _s
            return (_wx + rx, _wy - ry)

        return tr

    def place(
        self,
        entity,
        text_style: TextStyle,
        tile,
        global_scale: float,
        y_offset: int,
        default_text_position: TextPosition,
        pixels: OracleTile,
    ) -> bool:
        placements, scale, rgb = self.enumerate_placements(
            entity, text_style, tile, global_scale, y_offset, default_text_position
        )
        if placements is None:
            return True
        rasterizer = GlyphRasterizer(rgb)
        for glyph, kind, params in placements:
            self._rasterize(glyph, rasterizer, scale, self.make_tr(kind, params))
        return rasterizer.save_to_figure(pixels)

    def _text_to_glyphs(self, text: str, scale: float):
        glyphs: List[_Glyph] = []
        total_width = 0.0
        prev_gid: Optional[int] = None
        for ch in text:
            gid = self.font.find_glyph_index(ord(ch))
            width = float(self.font.advance_width(gid)) * scale
            if prev_gid is not None:
                width += float(self.font.kern_advance(prev_gid, gid)) * scale
            glyphs.append(_Glyph(ch, width, self.font.glyph_shape(gid)))
            total_width += width
            prev_gid = gid
        return glyphs, total_width

    @staticmethod
    def _rasterize(glyph: _Glyph, rasterizer: GlyphRasterizer, scale: float, tr):
        if glyph.shape is None:
            return
        # Per-point transform math is kept identical to the scalar form
        # (golden images are bit-exact); only the native call is batched
        # (one per glyph instead of one per curve).
        flat: List[float] = []
        push = flat.extend
        fx = fy = 0.0
        for v in glyph.shape:
            tox, toy = v.x * scale, v.y * scale
            if v.kind == LINE_TO:
                p1 = tr((fx, fy))
                p0 = tr((tox, toy))
                push((0.0, p0[0], p0[1], p1[0], p1[1], 0.0, 0.0))
            elif v.kind == CURVE_TO:
                mx, my = v.cx * scale, v.cy * scale
                p2 = tr((fx, fy))
                p1 = tr((mx, my))
                p0 = tr((tox, toy))
                push((1.0, p0[0], p0[1], p1[0], p1[1], p2[0], p2[1]))
            fx, fy = tox, toy
        if flat:
            rasterizer.draw_path(np.array(flat, dtype=np.float64).reshape(-1, 7))


def _compute_way_position(
    points: np.ndarray, advance_by: float, seg_lens, angles
):
    """Arc-length walk along integer waypoints (`text_placer.rs:270-296`).

    `seg_lens`/`angles` are precomputed once per way; the per-glyph
    walk keeps the reference's exact sequential `to_travel -= seg`
    arithmetic (seg lengths are sqrt of exact integer sums, so the
    precomputed values are bit-identical to recomputing them here)."""
    to_travel = advance_by
    idx = 0
    n = points.shape[0]
    while to_travel > 0.0 and idx + 1 < n:
        seg = seg_lens[idx]
        if seg >= to_travel:
            ratio = to_travel / seg
            dx = float(points[idx + 1, 0] - points[idx, 0])
            dy = float(points[idx + 1, 1] - points[idx, 1])
            return (
                float(points[idx, 0]) + dx * ratio,
                float(points[idx, 1]) + dy * ratio,
                angles[idx],
            )
        to_travel -= seg
        idx += 1
    return float(points[-1, 0]), float(points[-1, 1]), angles[n - 2]
