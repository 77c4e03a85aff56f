"""Glyph atlas + fast label compositor.

The serving-path replacement for per-tile per-glyph scanline
rasterization: each (glyph, font scale, quantized transform) is
rasterized ONCE (through the exact native coverage accumulator,
native/oracle.cpp `GlyphRasterizer` — font/rasterizer.rs semantics) into
a small alpha patch, and labels become numpy blits with the reference's
all-or-nothing collision rule (tile_pixels.rs:131-148, labeler.rs:16-37).

Deviation (documented, sanctioned by the glyph-atlas design note in
SURVEY §2 row 18): glyph transforms are quantized — subpixel phase to
1/PHASE_Q px and line-mode rotation to 2*pi/ANGLE_Q — so positions are
exact to within 1/(2*PHASE_Q) px; only anti-aliased boundary pixels
differ from the exact scanline path, by at most that phase fraction of
coverage.  Everything else (collision, ordering, blending) matches the
exact path, and interior (full-coverage) pixels are identical.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np

from osm_renderer_tpu_torch.draw.oracle import GlyphRasterizer

PHASE_Q = 16     # subpixel phase bins per axis
ANGLE_Q = 4096   # rotation bins over 2*pi


def _split_phase(v: float) -> Tuple[int, int]:
    """v -> (integer part, quantized-phase bin); bin PHASE_Q wraps to
    (int+1, bin 0) so the position error is at most 1/(2*PHASE_Q)."""
    iv = math.floor(v)
    q = round((v - iv) * PHASE_Q)
    if q >= PHASE_Q:
        return int(iv) + 1, 0
    return int(iv), int(q)


class GlyphAtlas:
    """Cache of rasterized glyph alpha patches.

    Patches are baked through the same native trapezoidal coverage
    accumulator as the exact path, at the quantized transform."""

    def __init__(self):
        self._cache: Dict[tuple, Optional[Tuple[np.ndarray, int, int]]] = {}
        self.hits = 0
        self.misses = 0

    def _bake(self, glyph, scale: float, tr):
        if glyph.shape is None:
            return None
        from osm_renderer_tpu_torch.draw.labels.text_placer import TextPlacer

        g = GlyphRasterizer((0, 0, 0))
        TextPlacer._rasterize(glyph, g, scale, tr)
        b = g.bounds()
        if b is None:
            return None
        x0, x1, y0, y1 = b
        patch = g.export_patch(x0, y0, x1 - x0 + 1, y1 - y0 + 1)
        if not patch.any():
            return None
        return patch, x0, y0

    def get_center(self, gid: int, glyph, scale: float, x_off: float, baseline: float):
        """Translation-only placement (Center mode).  Returns
        (alpha_patch, x, y) anchored at integer (x, y), or None."""
        ix, qx = _split_phase(x_off)
        iy, qy = _split_phase(baseline)
        key = (gid, scale, qx, qy)
        got = self._cache.get(key, False)
        if got is not False:
            self.hits += 1
        else:
            self.misses += 1
            fx = qx / PHASE_Q
            fy = qy / PHASE_Q

            def tr(p, _x=fx, _b=fy):
                return (_x + p[0], _b - p[1])

            got = self._bake(glyph, scale, tr)
            self._cache[key] = got
        if got is None:
            return None
        patch, px0, py0 = got
        return patch, ix + px0, iy + py0

    def get_line(
        self, gid: int, glyph, scale: float,
        wx: float, wy: float, sin_a: float, cos_a: float, gcx: float, gcy: float,
    ):
        """Rotated placement (Line mode).  The transform
        (text_placer.make_tr) is rotation about the glyph center plus
        translation; decomposed as X = Tx + px*c - py*(-s)... i.e. a
        pure rotation of (px, py) plus translation
        T = (wx - gcx*c + gcy*s, wy + gcy*c + gcx*s), so the cache key
        only needs the quantized angle and T's phase."""
        tx = wx - gcx * cos_a + gcy * sin_a
        ty = wy + gcy * cos_a + gcx * sin_a
        qa = round(math.atan2(sin_a, cos_a) / (2.0 * math.pi) * ANGLE_Q) % ANGLE_Q
        itx, qtx = _split_phase(tx)
        ity, qty = _split_phase(ty)
        key = (gid, scale, qa, qtx, qty, "r")
        got = self._cache.get(key, False)
        if got is not False:
            self.hits += 1
        else:
            self.misses += 1
            ang = qa * 2.0 * math.pi / ANGLE_Q
            s, c = math.sin(ang), math.cos(ang)
            ftx = qtx / PHASE_Q
            fty = qty / PHASE_Q

            def tr(p, _s=s, _c=c, _tx=ftx, _ty=fty):
                rx = p[0] * _c - p[1] * _s
                ry = p[1] * _c + p[0] * _s
                return (_tx + rx, _ty - ry)

            got = self._bake(glyph, scale, tr)
            self._cache[key] = got
        if got is None:
            return None
        patch, px0, py0 = got
        return patch, itx + px0, ity + py0


class LabelLayer:
    """All-or-nothing label compositing on the extended label canvas
    ([-ts, 2ts) both axes — tile_pixels.rs:67-72).

    Successful labels have pairwise-disjoint pixel sets (a later label
    touching an earlier successful one aborts), so the committed layer
    is a plain union; within one label, later writes win
    (SetLabelPixel overwrite semantics)."""

    def __init__(self, ts: int):
        self.ts = ts
        n = 3 * ts
        self.occ = np.zeros((n, n), dtype=bool)
        self.color = np.zeros((n, n, 4), dtype=np.float64)
        self._staged: List[Tuple[slice, slice, np.ndarray, np.ndarray]] = []

    def stage(
        self,
        x: int,
        y: int,
        rgba: np.ndarray,
        touched: np.ndarray,
        accumulate: bool = False,
    ) -> None:
        """Stage a patch for the current label at tile-relative (x, y);
        out-of-canvas pixels are silently dropped (GlobalCoordsToIdx)."""
        n = 3 * self.ts
        gx, gy = x + self.ts, y + self.ts
        h, w = touched.shape
        sy0, sy1 = max(0, -gy), min(h, n - gy)
        sx0, sx1 = max(0, -gx), min(w, n - gx)
        if sy0 >= sy1 or sx0 >= sx1:
            return
        self._staged.append(
            (
                slice(gy + sy0, gy + sy1),
                slice(gx + sx0, gx + sx1),
                rgba[sy0:sy1, sx0:sx1],
                touched[sy0:sy1, sx0:sx1],
                accumulate,
            )
        )

    def commit_label(self) -> bool:
        """Commit the staged label unless any touched pixel collides
        with an earlier successful label.

        `accumulate` patches (text glyphs) SUM their premultiplied
        coverage and are then clipped to alpha 1 — glyphs of one label
        share a color, so this reproduces the exact path's shared
        stripe map (`GlyphRasterizer`: min(sum, 1)) where rotated glyph
        boxes overlap; non-accumulating patches (icons) overwrite."""
        staged, self._staged = self._staged, []
        for ys, xs, _, touched, _ in staged:
            if np.any(self.occ[ys, xs] & touched):
                return False
        acc_boxes = []
        for ys, xs, rgba, touched, acc in staged:
            self.occ[ys, xs] |= touched
            if acc:
                self.color[ys, xs] += rgba
                acc_boxes.append((ys, xs))
            else:
                self.color[ys, xs] = np.where(
                    touched[..., None], rgba, self.color[ys, xs]
                )
        if acc_boxes:
            y0 = min(b[0].start for b in acc_boxes)
            y1 = max(b[0].stop for b in acc_boxes)
            x0 = min(b[1].start for b in acc_boxes)
            x1 = max(b[1].stop for b in acc_boxes)
            region = self.color[y0:y1, x0:x1]
            a = region[..., 3]
            over = a > 1.0
            if np.any(over):
                # Collision keeps this label's pixels disjoint from all
                # committed ones, so only its own sums can exceed 1.
                f = np.where(over, 1.0 / np.maximum(a, 1e-12), 1.0)
                region *= f[..., None]
        return True

    def abort_label(self) -> None:
        self._staged = []

    def export_center(self) -> np.ndarray:
        """Committed premultiplied RGBA over the served tile window."""
        ts = self.ts
        return self.color[ts : 2 * ts, ts : 2 * ts]
