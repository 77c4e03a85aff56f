"""The plain reference: a served tile's pixels, worked out again.

It imports nothing of the program: the city comes from the benchmark's
own importer (`city.CityFiles.reference_bin`), the stylesheet is the
configuration's copy under `tilebench/configs/`, and the cascade,
geometry and raster are the frozen copies under `tilebench/ref/`
(`render_dense.render_batch_plain`, the program's closed-form dense
renderer in plain PyTorch, which is a different rasterizer from the
served path's chunk-stream kernel).  Precision "exact" is int64/f64;
"bf16", the control, computes the same in int32/bfloat16.  One tile is
rendered at a time, so the reference's memory stays small.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np
import torch

from tilebench.ref.core.tile import Tile
from tilebench.ref.draw import primitives as prim
from tilebench.ref.geodata.reader import GeodataReader
from tilebench.ref.mapcss.parser import parse_file
from tilebench.ref.mapcss.styler import Styler
from tilebench.ref.ops import render_dense as RD


class Reference:
    def __init__(self, geodata_bin: str, stylesheet: str, style_type: str, device: str):
        self.reader = GeodataReader.load(geodata_bin)
        base, name = os.path.split(stylesheet)
        self.styler = Styler(parse_file(base, name), style_type, None)
        self.device = torch.device(device)

    def _canvas(self, dtype: torch.dtype) -> torch.Tensor:
        c = self.styler.canvas_fill_color
        rgb = [c.r, c.g, c.b] if c is not None else [0, 0, 0]
        return (torch.tensor(rgb, dtype=torch.float64) / 255.0).to(dtype).to(self.device)

    def render(self, key: Tuple[int, int, int, int], precision: str = "exact") -> np.ndarray:
        """The tile `key` = (zoom, x, y, scale) -> (ts, ts, 3) u8."""
        z, x, y, scale = key
        tile = Tile(z, x, y)
        ts = 256 * scale
        entities = self.reader.get_entities_in_tile_with_neighbors(tile, None)
        prims = prim.assemble_tile_prims(entities, tile, float(scale), self.styler)
        chunk = 64
        max_fill = max((p.edges.shape[0] for p in prims if isinstance(p, prim.FillPrim)),
                       default=0)
        while chunk < max_fill:
            chunk *= 2
        profiles = prim.ProfileTable()
        patterns = prim.PatternTable(None, ts)
        stream = prim.stream_tile(prims, profiles, chunk, patterns)
        if stream.has_icon_fills:
            raise ValueError(f"tile {key} has icon fills, which the reference does not draw")
        arrays = prim.build_batch([stream], profiles, chunk,
                                  dtype=np.float64 if precision == "exact" else np.float32,
                                  patterns=patterns, ts=ts)
        plan = RD.plan_batch(arrays, ts, chunk, precision, RD.PIXEL_BUDGET[self.device.type])
        batch = RD.TileBatch.from_numpy(arrays, self.device)
        _, ff = RD._dtypes(precision)
        batch = batch._replace(**{f: getattr(batch, f).to(ff) for f in (
            "geom_traveled", "chunk_color", "chunk_opacity", "chunk_hw", "profiles",
            "profile_total", "patterns")})
        out = RD.render_batch_plain(batch, self._canvas(ff), ts, chunk, precision,
                                    profiles.has_round_caps(), plan)
        return out[0].cpu().numpy()
