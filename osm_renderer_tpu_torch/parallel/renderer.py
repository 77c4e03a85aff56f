"""Batched device rendering on one CUDA device.

Counterpart of the kernel half of
`osm_renderer_tpu.parallel.renderer.BatchRenderer` on its plain-upload
entry: per-tile chunk arrays (cached per tile) are concatenated into one
batch, uploaded, and rendered by the CUDA kernel
(`ops.render_cuda.render_batch_planar`) into a u8 planar
(T, 4, ts, ts) batch that is read back raw.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from osm_renderer_tpu.core.tile import Tile
from osm_renderer_tpu.draw import primitives as prim_mod
from osm_renderer_tpu.draw.primitives import FAST_COORD_BOUND, assemble_tile_prims
from osm_renderer_tpu.mapcss.styler import Styler
from osm_renderer_tpu_torch.draw import native_assembler as _na
from osm_renderer_tpu_torch.ops import chunk_layout as L
from osm_renderer_tpu_torch.ops import render_cuda as RC
from osm_renderer_tpu_torch.utils.torch_setup import next_pow2, resolve_device


class PreparedBatch(NamedTuple):
    batch: RC.CudaBatch
    canvas_rgb: torch.Tensor
    ts: int
    chunk: int  # n_tiles
    cpu_fallback_tiles: tuple = ()  # tile indices the device path can't draw


class BatchRenderer:
    """One CUDA device's renderer (`device="cpu"` runs the kernel's plain
    twin; only the tests ask for it)."""

    # Host-rasterized layers (out-of-bound prims) accumulate in a
    # persistent pattern table as their tiles churn through the cache;
    # past this bound both are rebuilt from scratch.
    MAX_PERSISTED_PATTERNS = 48

    # The TPU kernel's scalar-prefetch SMEM bound, kept so that the
    # server's split path (it keys on this error text) behaves the same;
    # the CUDA kernel itself has no such limit.
    MAX_BATCH_CHUNKS = 8192

    def __init__(
        self,
        styler: Styler,
        stylesheet_dir: Optional[str] = None,
        tile_bucket: bool = False,
        chunk_cache_tiles: int = 0,
        device: str = "cuda",
    ):
        self.device = resolve_device(device) if isinstance(device, str) else device
        self.styler = styler
        self.tile_bucket = tile_bucket
        self.chunk_cache_tiles = chunk_cache_tiles
        self._chunk_cache: "OrderedDict" = OrderedDict()
        self._cache_lock = threading.RLock()
        self._persist_tables: dict = {}   # scale -> (ProfileTable, PatternTable)
        self._patterns_dev: dict = {}     # scale -> (n_tiles_in_table, tensor)
        self._empty_chunks: dict = {}     # ts -> TileChunks (PAD-only)
        self.icon_cache = None
        if stylesheet_dir is not None:
            from osm_renderer_tpu.draw.labels.icons import IconCache

            self.icon_cache = IconCache(stylesheet_dir)
        _na.get_native()

    def prepare(
        self, tiles_entities: Sequence[Tuple[object, Tile]], scale: int = 1
    ) -> PreparedBatch:
        ts_px = 256 * scale
        profiles, patterns = self._tables_for(scale)
        tile_chunks = []
        fallback = []
        cache_on = bool(self.chunk_cache_tiles)
        for idx, (entities, tile) in enumerate(tiles_entities):
            key = (tile.zoom, tile.x, tile.y, scale)
            if cache_on:
                with self._cache_lock:
                    hit = self._chunk_cache.get(key)
                    if hit is not None:
                        self._chunk_cache.move_to_end(key)
                if hit is not None:
                    chunks, has_icon_fills = hit
                    if has_icon_fills:
                        fallback.append(idx)
                    tile_chunks.append(chunks)
                    continue
            if entities is None:
                raise ValueError(f"no cached chunks and no entities for {tile}")
            got = _na.assemble_tile_chunks_native(
                entities, tile, float(scale), self.styler, profiles, patterns, ts_px,
            )
            if got is not None:
                chunks, has_icon_fills = got
            else:
                prims = assemble_tile_prims(entities, tile, float(scale), self.styler)
                stream = prim_mod.stream_tile_packed(prims, profiles, L.CH, patterns)
                chunks = L.build_tile_chunks(stream, ts_px, profiles.chain_free_mask())
                has_icon_fills = stream.has_icon_fills
            self._check_coords(chunks.geom)
            if has_icon_fills:
                fallback.append(idx)
            if cache_on:
                with self._cache_lock:
                    self._chunk_cache[key] = (chunks, has_icon_fills)
                    while len(self._chunk_cache) > self.chunk_cache_tiles:
                        self._chunk_cache.popitem(last=False)
                if len(patterns.tiles) > self.MAX_PERSISTED_PATTERNS:
                    # The rest of this batch renders with the (still
                    # consistent) local tables; nothing more may enter the
                    # cache, whose entries would otherwise pair with the
                    # next batch's fresh tables.
                    self.cache_clear()
                    cache_on = False
            tile_chunks.append(chunks)
        total_chunks = sum(int(c.kind.shape[0]) for c in tile_chunks)
        if total_chunks > self.MAX_BATCH_CHUNKS:
            raise ValueError(
                f"batch has {total_chunks} chunks > MAX_BATCH_CHUNKS "
                f"({self.MAX_BATCH_CHUNKS}); split the tile batch"
            )
        n_tiles = len(tiles_entities)
        if self.tile_bucket:
            bucket = next_pow2(max(n_tiles, 4), 4)
            empty = self._empty_chunks.get(ts_px)
            if empty is None:
                empty = L.build_tile_chunks(prim_mod.TileStream(), ts_px)
                self._empty_chunks[ts_px] = empty
            tile_chunks.extend([empty] * (bucket - len(tile_chunks)))
            n_tiles = bucket
        pb = L.concat_pallas_batch(tile_chunks, profiles, ts_px, patterns)
        pat_dev = None
        if cache_on:
            # Ship the (potentially multi-MB) pattern planes once per
            # table version, not once per batch.
            ver = len(patterns.tiles)
            got = self._patterns_dev.get(scale)
            if got is not None and got[0] == ver:
                pat_dev = got[1]
            else:
                pat_dev = torch.from_numpy(np.ascontiguousarray(pb.patterns)).to(self.device)
                self._patterns_dev[scale] = (ver, pat_dev)
        batch, canvas = RC.from_numpy_batch(
            pb, self._canvas(), self.device, n_tiles, patterns=pat_dev
        )
        return PreparedBatch(batch, canvas, ts_px, n_tiles, tuple(fallback))

    def _canvas(self) -> np.ndarray:
        canvas = self.styler.canvas_fill_color
        rgb = [canvas.r, canvas.g, canvas.b] if canvas is not None else [0, 0, 0]
        return np.array(rgb, dtype=np.float32) / np.float32(255.0)

    def _check_coords(self, geom) -> None:
        max_coord = int(np.abs(geom).max()) if geom.size else 0
        if max_coord >= FAST_COORD_BOUND:
            raise ValueError(
                f"the int32 kernel requires |coords| < {FAST_COORD_BOUND}, got {max_coord}"
            )

    def _tables_for(self, scale: int):
        """Per-scale (ProfileTable, PatternTable): fresh per batch without
        the chunk cache, persistent (index-stable) with it."""
        if not self.chunk_cache_tiles:
            return prim_mod.ProfileTable(), prim_mod.PatternTable(self.icon_cache, 256 * scale)
        got = self._persist_tables.get(scale)
        if got is None:
            got = (prim_mod.ProfileTable(), prim_mod.PatternTable(self.icon_cache, 256 * scale))
            self._persist_tables[scale] = got
        return got

    def has_cached_chunks(self, tile: Tile, scale: int) -> bool:
        with self._cache_lock:
            return (tile.zoom, tile.x, tile.y, scale) in self._chunk_cache

    def cache_clear(self) -> None:
        with self._cache_lock:
            self._chunk_cache.clear()
            self._persist_tables.clear()
            self._patterns_dev.clear()

    def render_prepared_planar(self, prepared: PreparedBatch) -> torch.Tensor:
        """(T, 4, ts, ts) u8 on the device, not synchronised."""
        return RC.render_batch_planar(prepared.batch, prepared.canvas_rgb, prepared.ts)

    def render_prepared(self, prepared: PreparedBatch) -> torch.Tensor:
        """(T, ts, ts, 3) u8 view of the planar output."""
        return self.render_prepared_planar(prepared)[:, :3].permute(0, 2, 3, 1)


class RleTileView:
    """Per-tile view of a fetched batch.  The port reads batches back raw,
    so only the RGB form exists; `png8` always defers to the RGB path."""

    def __init__(self, T: int, ts: int, rgb: np.ndarray):
        self.T = T
        self.ts = ts
        self._rgb = rgb

    def rgb(self, i: int) -> np.ndarray:
        return self._rgb[i]

    def png8(self, i: int, level: int) -> Optional[bytes]:
        return None


def pad_batch_to(tiles: int, prepared: PreparedBatch) -> PreparedBatch:
    """Pad the batch's tile axis to `tiles` with empty tiles (each renders
    the canvas): a fixed batch shape for callers that want one."""
    T = prepared.batch.tile_range.shape[0]
    if T >= tiles:
        return prepared
    b = prepared.batch
    ts = prepared.ts
    dev = b.geom.device
    empty = L.build_tile_chunks(prim_mod.TileStream(), ts)
    n = empty.kind.shape[0]
    C = b.geom.shape[0]
    pad = tiles - T
    IT = b.items.shape[1]

    def rep(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(np.concatenate([a] * pad), dtype)).to(dev)

    chunk_i = np.stack(
        [empty.kind, empty.cnt, empty.last, empty.y0, empty.nb, empty.prim_y0,
         empty.prim_nb, empty.pat, np.eye(1, n, dtype=np.int32)[0]], axis=1,
    )
    chunk_f = np.concatenate([empty.color, empty.opacity[:, None], empty.hw[:, None]], axis=1)
    items = np.full((n, IT), -1, np.int32)
    items[:, : min(IT, empty.items.shape[2])] = empty.items[:, 0, :IT]
    begins = C + n * np.arange(pad, dtype=np.int32)
    ranges = np.stack([begins, begins + n], axis=1).astype(np.int32)
    new = RC.CudaBatch(
        geom=torch.cat([b.geom, rep(empty.geom, np.int32)]),
        trav=torch.cat([b.trav, rep(empty.trav.reshape(n, L.CH), np.float32)]),
        sprof=torch.cat([b.sprof, rep(empty.sprof.reshape(n, L.CH), np.int32)]),
        aux=torch.cat([b.aux, rep(empty.aux, np.float32)]),
        items=torch.cat([b.items, rep(items, np.int32)]),
        isec=torch.cat([b.isec, rep(empty.isec, np.int32)]),
        chunk_i=torch.cat([b.chunk_i, rep(chunk_i, np.int32)]),
        chunk_f=torch.cat([b.chunk_f, rep(chunk_f, np.float32)]),
        profiles=b.profiles, prof_total=b.prof_total, patterns=b.patterns,
        tile_range=torch.cat([b.tile_range, torch.from_numpy(ranges).to(dev)]),
    )
    return prepared._replace(batch=new, chunk=tiles)
