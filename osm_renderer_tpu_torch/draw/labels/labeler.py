"""Label orchestration: icons + text with all-or-nothing collision.

Mirrors `labeler.rs` + the label part of `drawer.rs:221-262`:

* per styled entity: draw the icon at the anchor (centered), then text
  below it; any rejected pixel aborts the whole label;
* earlier successful labels win collisions (per label generation);
* label pass order: styled areas (ways: line text, multipolygons:
  center text), then styled nodes (center text).
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Optional

import numpy as np

from osm_renderer_tpu_torch.core.tile import Tile
from osm_renderer_tpu_torch.draw.labels.icons import IconCache
from osm_renderer_tpu_torch.draw.labels.text_placer import TextPlacer
from osm_renderer_tpu_torch.draw.labels import labelable
from osm_renderer_tpu_torch.draw.oracle import OracleTile
from osm_renderer_tpu_torch.geodata.reader import Multipolygon, Way
from osm_renderer_tpu_torch.mapcss.styler import Style, Styler, TextPosition


class Labeler:
    def __init__(
        self,
        icon_base_path: Optional[str] = None,
        font_path: Optional[str] = None,
        use_atlas: bool = True,
        label_cache_tiles: int = 0,
    ):
        self.text_placer = TextPlacer(font_path)
        self.icon_cache = IconCache(icon_base_path) if icon_base_path else None
        # Glyph-atlas fast path (draw/labels/atlas.py): ~92% of glyph
        # rasterizations repeat across tiles; atlas patches turn them
        # into numpy blits.  use_atlas=False keeps the exact per-glyph
        # scanline path (parity tests compare the two).
        self.use_atlas = use_atlas
        self._atlas = None
        # Optional per-tile committed-label-layer LRU (serving: slippy
        # clients re-request the same tiles constantly).
        self.label_cache_tiles = label_cache_tiles
        self._layer_cache = OrderedDict()
        self._layer_lock = threading.RLock()  # server threads share this cache

    # -- per-entity --

    def label_entity(
        self,
        entity,
        style: Style,
        tile: Tile,
        scale: float,
        default_text_position: TextPosition,
        pixels: OracleTile,
    ) -> None:
        y_offset = self._label_with_icon(entity, style, tile, scale, pixels)
        if y_offset is not None:
            succeeded = self._label_with_text(
                entity, style, tile, scale, y_offset, default_text_position, pixels
            )
        else:
            succeeded = False
        pixels.bump_label_generation(succeeded)

    def _label_with_icon(self, entity, style, tile, scale, pixels) -> Optional[int]:
        if style.icon_image is None or self.icon_cache is None:
            return 0
        icon = self.icon_cache.get(style.icon_image)
        if icon is None:
            return 0
        pos = labelable.get_label_position(entity, tile, scale)
        if pos is None:
            return 0
        center_x, center_y = pos
        start_x = int(center_x - icon.width / 2.0)
        start_y = int(center_y - icon.height / 2.0)
        if pixels.label_icon(start_x, start_y, icon.rgba):
            return icon.height // 2
        return None

    def _label_with_text(
        self, entity, style, tile, scale, y_offset, default_text_position, pixels
    ) -> bool:
        if style.text_style is None:
            return True
        return self.text_placer.place(
            entity, style.text_style, tile, scale, y_offset,
            default_text_position, pixels,
        )

    # -- per-tile --

    def draw_labels(
        self, pixels: OracleTile, entities, tile: Tile, scale: float, styler: Styler
    ) -> None:
        styled_areas = styler.style_areas(
            entities.ways, entities.multipolygons, tile.zoom, True
        )
        styled_nodes = styler.style_entities(entities.nodes, tile.zoom, True)

        for entity, style in styled_areas:
            default_pos = (
                TextPosition.LINE if isinstance(entity, Way) else TextPosition.CENTER
            )
            self.label_entity(entity, style, tile, scale, default_pos, pixels)
        for entity, style in styled_nodes:
            self.label_entity(entity, style, tile, scale, TextPosition.CENTER, pixels)

    # -- glyph-atlas fast path (serving) --

    def _label_entity_atlas(
        self, entity, style, tile, scale, default_text_position, layer, atlas
    ) -> None:
        """All-or-nothing label via atlas blits; mirrors label_entity
        exactly except that glyph transforms are phase/angle-quantized
        (documented in draw/labels/atlas.py)."""
        y_offset = 0
        if style.icon_image is not None and self.icon_cache is not None:
            icon = self.icon_cache.get(style.icon_image)
            if icon is not None:
                pos = labelable.get_label_position(entity, tile, scale)
                if pos is not None:
                    center_x, center_y = pos
                    start_x = int(center_x - icon.width / 2.0)
                    start_y = int(center_y - icon.height / 2.0)
                    # Icons occupy their whole rect for collision
                    # (osmr_label_icon writes every pixel).
                    layer.stage(
                        start_x, start_y, icon.rgba,
                        np.ones(icon.rgba.shape[:2], dtype=bool),
                    )
                    y_offset = icon.height // 2

        if style.text_style is not None:
            placements, gscale, rgb = self.text_placer.enumerate_placements(
                entity, style.text_style, tile, scale, y_offset,
                default_text_position,
            )
            if placements:
                r, g, b = rgb
                # Atlas patches are cached for the atlas's lifetime, so
                # the colored premultiplied buffers (and the coverage
                # masks) can be memoized per (patch, color) — text color
                # repeats constantly, and coloring was ~a third of the
                # per-glyph blit cost.
                colored = getattr(self, "_colored_patches", None)
                if colored is None:
                    colored = self._colored_patches = {}
                for glyph, kind, params in placements:
                    if kind == "center":
                        got = atlas.get_center(glyph.ch, glyph, gscale, *params)
                    else:
                        got = atlas.get_line(glyph.ch, glyph, gscale, *params)
                    if got is None:
                        continue
                    patch, px, py = got
                    ckey = (id(patch), r, g, b)
                    cached = colored.get(ckey)
                    if cached is None:
                        rgba = np.empty(patch.shape + (4,), dtype=np.float64)
                        rgba[..., 0] = (r / 255.0) * patch
                        rgba[..., 1] = (g / 255.0) * patch
                        rgba[..., 2] = (b / 255.0) * patch
                        rgba[..., 3] = patch
                        cached = (rgba, patch > 0.0)
                        colored[ckey] = cached
                    layer.stage(px, py, cached[0], cached[1], accumulate=True)
        layer.commit_label()

    def _label_layer_atlas(
        self, entities, tile: Tile, scale: float, styler: Styler, ts: int
    ) -> np.ndarray:
        from osm_renderer_tpu_torch.draw.labels.atlas import GlyphAtlas, LabelLayer

        if self._atlas is None:
            self._atlas = GlyphAtlas()
        layer = LabelLayer(ts)
        styled_areas = styler.style_areas(
            entities.ways, entities.multipolygons, tile.zoom, True
        )
        styled_nodes = styler.style_entities(entities.nodes, tile.zoom, True)
        for entity, style in styled_areas:
            default_pos = (
                TextPosition.LINE if isinstance(entity, Way) else TextPosition.CENTER
            )
            self._label_entity_atlas(
                entity, style, tile, scale, default_pos, layer, self._atlas
            )
        for entity, style in styled_nodes:
            self._label_entity_atlas(
                entity, style, tile, scale, TextPosition.CENTER, layer, self._atlas
            )
        return layer.export_center()

    def has_cached_layer(self, tile: Tile, ts: int) -> bool:
        with self._layer_lock:
            return (tile.zoom, tile.x, tile.y, ts) in self._layer_cache

    def cache_clear(self) -> None:
        with self._layer_lock:
            self._layer_cache.clear()

    def ensure_layer(
        self, entities, tile: Tile, scale: float, styler: Styler, ts: int
    ):
        """Build (or fetch from the LRU) the tile's compact committed
        label layer.  Returns None when the tile carries no labels —
        the serving path then skips compositing entirely (and may emit
        the tile straight from the indexed wire as PNG-8)."""
        key = (tile.zoom, tile.x, tile.y, ts)
        compact = _MISS = object()
        if self.label_cache_tiles:
            with self._layer_lock:
                compact = self._layer_cache.get(key, _MISS)
                if compact is not _MISS:
                    self._layer_cache.move_to_end(key)
        if compact is _MISS:
            layer = self._label_layer_atlas(entities, tile, scale, styler, ts)
            compact = _compact_label_layer(layer)
            if self.label_cache_tiles:
                with self._layer_lock:
                    self._layer_cache[key] = compact
                    while len(self._layer_cache) > self.label_cache_tiles:
                        self._layer_cache.popitem(last=False)
        return compact

    def composite_labels(
        self, base_rgb: np.ndarray, entities, tile: Tile, scale: float, styler: Styler
    ) -> np.ndarray:
        """Render labels and src-over them onto a device-rendered RGB
        tile (the base is fully opaque, so compositing over u8 stays
        within 1/255 of the exact path).

        Default path: glyph atlas + numpy label layer, with an optional
        per-tile committed-layer LRU for serving.  use_atlas=False runs
        the exact per-glyph scanline path."""
        ts = base_rgb.shape[0]
        if self.use_atlas:
            compact = self.ensure_layer(entities, tile, scale, styler, ts)
            # Most tiles carry no labels (or a small cluster): composite
            # only the non-zero-alpha bounding box, and skip entirely
            # when the layer is empty.
            if compact is None:
                return base_rgb
            y0, y1, x0, x1, rgb255, alpha = compact
            out = np.ascontiguousarray(base_rgb)
            if out is base_rgb:
                out = base_rgb.copy()
            from osm_renderer_tpu_torch.draw.png_writer import _get_native

            lib = _get_native()
            if lib is not None:
                # Native src-over of the compact patch, bit-identical to
                # the numpy expression below (same f64 operation order;
                # pinned by tests/test_labels.py) — the warm serving
                # pipeline's composite stage shares one host core with
                # PNG encode, so this stage is C++ like the encoder.
                lib.osmr_label_composite(
                    out, out.shape[1], y0, y1, x0, x1, rgb255,
                    np.ascontiguousarray(alpha[..., 0]),
                )
                return out
            sub = rgb255 + (1.0 - alpha) * base_rgb[y0:y1, x0:x1].astype(
                np.float64
            )
            out[y0:y1, x0:x1] = np.clip(
                np.trunc(sub + 1e-9), 0, 255
            ).astype(np.uint8)
            return out
        else:
            scale_i = ts // 256
            # Native tile buffers are expensive to allocate; reuse per
            # scale (thread-unsafe reuse is fine: the device compositor
            # runs the batch loop on one thread).
            cache = getattr(self, "_scratch_tiles", None)
            if cache is None:
                cache = self._scratch_tiles = {}
            scratch = cache.get(scale_i)
            if scratch is None:
                scratch = cache[scale_i] = OracleTile(scale_i)
            scratch.reset(None)
            self.draw_labels(scratch, entities, tile, scale, styler)
            layer = scratch.export_label_layer()  # (ts, ts, 4) premult f64

        a = layer[..., 3:4]
        out = layer[..., :3] * 255.0 + (1.0 - a) * base_rgb.astype(np.float64)
        return np.clip(np.trunc(out + 1e-9), 0, 255).astype(np.uint8)


def _compact_label_layer(layer: np.ndarray):
    """(ts, ts, 4) premultiplied f64 label layer -> None (no labels) or
    (y0, y1, x0, x1, rgb*255 f64, alpha f64) restricted to the non-zero
    alpha bounding box.  The compact form is what the serving layer
    cache stores: compositing then touches only the labeled pixels."""
    a = layer[..., 3]
    rows = np.nonzero(a.any(axis=1))[0]
    if rows.size == 0:
        return None
    cols = np.nonzero(a.any(axis=0))[0]
    y0, y1 = int(rows[0]), int(rows[-1]) + 1
    x0, x1 = int(cols[0]), int(cols[-1]) + 1
    sub = layer[y0:y1, x0:x1]
    return (y0, y1, x0, x1,
            np.ascontiguousarray(sub[..., :3] * 255.0),
            np.ascontiguousarray(sub[..., 3:4]))
