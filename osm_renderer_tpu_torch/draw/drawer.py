"""Per-tile rendering orchestration.

Two interchangeable backends with identical output:

* `CpuDrawer` — drives the C++ oracle rasterizer entity-by-entity,
  replicating the reference's `Drawer::draw_to_pixels` exactly
  (drawer.rs:60-131): reset -> fills -> casings -> strokes -> blend ->
  labels -> blend -> RGB.
* `DeviceDrawer` — assembles the same paint-ordered primitives into a
  chunk stream and renders fills/strokes on the device with the dense
  exact renderer (ops/render_dense.py; on a CUDA device its kernels,
  csrc/dense.cu via ops/dense_cuda.py); labels are placed and
  composited on the host over the device output.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from osm_renderer_tpu_torch.core.tile import Tile
from osm_renderer_tpu_torch.draw import primitives as prim_mod
from osm_renderer_tpu_torch.draw.oracle import OracleTile
from osm_renderer_tpu_torch.draw.primitives import FillPrim, StrokePrim, assemble_tile_prims
from osm_renderer_tpu_torch.mapcss.styler import Styler


class CpuDrawer:
    """Oracle-backed CPU rendering path (the reference-parity baseline)."""

    def __init__(self, labeler=None, icon_cache=None, stylesheet_dir=None):
        self.labeler = labeler
        if icon_cache is None and stylesheet_dir is not None:
            from osm_renderer_tpu_torch.draw.labels.icons import IconCache

            icon_cache = IconCache(stylesheet_dir)
        self.icon_cache = icon_cache
        self._tile_cache: dict = {}

    def _tile_for_scale(self, scale: int) -> OracleTile:
        tile = self._tile_cache.get(scale)
        if tile is None:
            tile = OracleTile(scale)
            self._tile_cache[scale] = tile
        return tile

    def draw_to_pixels(self, entities, tile: Tile, scale: int, styler: Styler) -> np.ndarray:
        from osm_renderer_tpu_torch import perfstats

        pixels = self._tile_for_scale(scale)
        with perfstats.measure("Resetting TilePixels"):
            pixels.reset(styler.canvas_fill_color)

        with perfstats.measure("Style areas"):
            prims = assemble_tile_prims(entities, tile, float(scale), styler)

        with perfstats.measure("Fill and draw areas"):
            for p in prims:
                if isinstance(p, FillPrim):
                    if p.edges.shape[0]:
                        edges32 = np.clip(p.edges, -(2**31), 2**31 - 1).astype(np.int32)
                        if p.fill_image is not None:
                            icon = (
                                self.icon_cache.get(p.fill_image)
                                if self.icon_cache is not None
                                else None
                            )
                            if icon is not None:
                                pixels.fill_contour_icon(edges32, icon.rgba)
                        else:
                            pixels.fill_contour(edges32, p.color, p.opacity)
                else:
                    if p.segs.shape[0]:
                        self._draw_stroke(pixels, p)
                pixels.bump_generation()

        with perfstats.measure("Blend after areas"):
            pixels.blend_unfinished(False)

        if self.labeler is not None:
            with perfstats.measure("Draw labels"):
                self.labeler.draw_labels(pixels, entities, tile, float(scale), styler)

        with perfstats.measure("Blend after labels"):
            pixels.blend_unfinished(True)
        return pixels.to_rgb()

    @staticmethod
    def _draw_stroke(pixels: OracleTile, p: StrokePrim) -> None:
        # The oracle's draw_lines reconstructs caps/traveled itself, so feed
        # it the original consecutive point pairs (incl. degenerate ones —
        # they matter for the first/last cap decision).
        body = p.raw_pairs if p.raw_pairs is not None else p.segs[~p.outer]
        pixels.draw_lines(
            np.clip(body, -(2**31), 2**31 - 1).astype(np.int32),
            p.half_width * 2.0,
            p.color,
            p.opacity,
            list(p.dashes) if p.dashes is not None else None,
            p.cap,
            p.use_caps_for_dashes,
        )



class DeviceDrawer:
    """Device rendering path: batched fills/strokes on one device
    (`device="cpu"` runs the dense renderer on the CPU; only the tests
    ask for it)."""

    def __init__(
        self,
        labeler=None,
        chunk_size: int = 64,
        stylesheet_dir=None,
        device: str = "cuda",
    ):
        from osm_renderer_tpu_torch.utils.torch_setup import resolve_device

        self.labeler = labeler
        self.chunk_size = chunk_size
        self.device = resolve_device(device)
        self.icon_cache = None
        if stylesheet_dir is not None:
            from osm_renderer_tpu_torch.draw.labels.icons import IconCache

            self.icon_cache = IconCache(stylesheet_dir)

    def render_tiles(
        self, tiles_entities: List[Tuple[object, Tile]], scale: int, styler: Styler
    ) -> np.ndarray:
        """Render a batch of tiles -> (T, ts, ts, 3) uint8."""
        import torch

        from osm_renderer_tpu_torch.ops.dense_cuda import pack_plan
        from osm_renderer_tpu_torch.ops.render_dense import (
            PIXEL_BUDGET,
            TileBatch,
            plan_batch,
            render_batch,
        )

        profiles = prim_mod.ProfileTable()
        patterns = prim_mod.PatternTable(self.icon_cache, 256 * scale)
        streams = []
        all_prims = []
        chunk = self.chunk_size
        for entities, tile in tiles_entities:
            prims = assemble_tile_prims(entities, tile, float(scale), styler)
            all_prims.append(prims)
            max_fill = max(
                (p.edges.shape[0] for p in prims if isinstance(p, FillPrim)),
                default=0,
            )
            while chunk < max_fill:
                chunk *= 2
        for prims in all_prims:
            streams.append(prim_mod.stream_tile(prims, profiles, chunk, patterns))

        batch = prim_mod.build_batch(
            streams, profiles, chunk, patterns=patterns, ts=256 * scale
        )
        canvas = styler.canvas_fill_color
        if canvas is None:
            canvas_rgb = torch.zeros(3, dtype=torch.float64)
        else:
            canvas_rgb = torch.tensor(
                [canvas.r / 255.0, canvas.g / 255.0, canvas.b / 255.0],
                dtype=torch.float64,
            )
        ts = 256 * scale
        plan = plan_batch(batch, ts, chunk, "exact", PIXEL_BUDGET[self.device.type])
        pack = None
        if self.device.type == "cuda":
            pack = pack_plan(plan, len(streams)).to(self.device)
        out = render_batch(
            TileBatch.from_numpy(batch, self.device), canvas_rgb.to(self.device), ts, chunk,
            chain=profiles.has_round_caps(), plan=plan, pack=pack,
        ).cpu().numpy()

        if self.labeler is not None:
            for i, (entities, tile) in enumerate(tiles_entities):
                out[i] = self.labeler.composite_labels(
                    out[i], entities, tile, float(scale), styler
                )
        return out
