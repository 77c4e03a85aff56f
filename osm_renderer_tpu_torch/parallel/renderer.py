"""Batched device rendering: one renderer a CUDA device.

Counterpart of `osm_renderer_tpu.parallel.renderer.BatchRenderer` and
`MeshTileRenderer` (one `BatchRenderer` a device, the tiles split
round-robin).  `backend="dense"` is the reference's "jnp" backend: each
batch streams its tiles' primitives (`draw.primitives.stream_tile`), stacks
them with `build_batch` and renders them with `ops.render_dense` in the
batch's `precision` ("exact": int64/f64, the only way to draw geometry
past the fast path's coordinate bound; "fast": int32/f32): on a CUDA
device through the dense kernels (`ops.dense_cuda`, their arguments
packed in `prepare`), on the CPU through the plain version.  The
(T, ts, ts, 3) batch is read back raw.  The default backend, "cuda", is
the kernels' path described below.

Per-tile chunk arrays are cached per tile.  With the chunk arena on
(`arena=True`, the server's default), a batch uploads one small packed
buffer and gathers the tiles' big chunk fields from the device-resident
arena (`parallel.arena`); otherwise the batch's chunk
arrays are concatenated and uploaded.  The CUDA render kernel
(`ops.render_cuda`) writes a u8 planar (T, 4, ts, ts) batch, and the run
emit and palette expand kernels (`ops.rle_cuda`) turn it into one wire
array that crosses to the host (`RleRendered`, `fetch_tile_view`).  On
the arena path, tiles given a committed label layer have it staged in
the device label slab (`parallel.label_slab`) and blended over the
render before the wire is encoded (`PreparedBatch.device_labeled`).
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from osm_renderer_tpu_torch.core.tile import Tile
from osm_renderer_tpu_torch.draw.png8 import decode_packed, decode_words, words_to_png_pal
from osm_renderer_tpu_torch.draw import primitives as prim_mod
from osm_renderer_tpu_torch.draw.primitives import FAST_COORD_BOUND, FillPrim, assemble_tile_prims
from osm_renderer_tpu_torch.mapcss.styler import Styler
from osm_renderer_tpu_torch.draw import native_assembler as _na
from osm_renderer_tpu_torch.ops import chunk_layout as L
from osm_renderer_tpu_torch.ops import dense_cuda as DC
from osm_renderer_tpu_torch.ops import render_dense as RD
from osm_renderer_tpu_torch.ops import render_cuda as RC
from osm_renderer_tpu_torch.ops import rle_cuda as RLE
from osm_renderer_tpu_torch.ops import rle_layout
from osm_renderer_tpu_torch.parallel.arena import ChunkArena
from osm_renderer_tpu_torch.parallel.label_slab import LabelSlab
from osm_renderer_tpu_torch.utils.torch_setup import next_pow2, resolve_device


class PreparedBatch(NamedTuple):
    batch: object  # RC.CudaBatch, RD.TileBatch (dense), or None on the arena path
    canvas_rgb: torch.Tensor
    ts: int
    chunk: int  # n_tiles; the chunk size on the dense backend
    cpu_fallback_tiles: tuple = ()  # tile indices the device path can't draw
    # Arena path: the packed small-field buffer is the only per-batch
    # upload, and the big chunk fields are gathered from the arena.
    arena_packed: Optional[np.ndarray] = None  # (N_SMALL, C) i32 host buffer
    arena_ctx: object = None                   # (arena, prof, tot, pat, generation)
    # Device label blit: the (T, 3) (off, y0, n) slab-row map rides in the
    # packed upload; these tiles come back with their labels blended.
    label_rows: Optional[np.ndarray] = None     # (T, 3) i32, or None
    label_ctx: object = None                    # (slab, slab.generation)
    device_labeled: tuple = ()                  # tile indices blitted on the device
    # Dense backend: "exact" or "fast" ("cuda" on the kernels' path), the
    # walk-chain flag (round-capped dashes), the host schedule and, on a
    # CUDA device, the dense kernels' packed arguments (uploaded).
    precision: str = "cuda"
    chain: bool = False
    plan: Optional[RD.BatchPlan] = None
    pack: Optional[DC.DensePack] = None


class RleRendered(NamedTuple):
    """A rendered batch and its run-length wire, both on the device.

    Only `wire` crosses to the host (`start_wire_copy` queues the copy);
    when the batch overflowed the wire's cap the host reads `planar`
    instead."""
    planar: torch.Tensor  # (T, 4, ts, ts) u8
    wire: torch.Tensor    # v1: (2 + T + rtot,) i32; v2: indexed-word wire
    ts: int
    rtot: int             # v1: run cap; v2: word cap
    fmt: str = "v1"       # "v2" = indexed-colour 16-bit-word wire
    host: Optional[torch.Tensor] = None        # pinned copy of `wire` in flight
    executed: Optional[torch.cuda.Event] = None  # after the kernels
    copied: Optional[torch.cuda.Event] = None    # after the copy


def start_wire_copy(res: RleRendered) -> RleRendered:
    """Queue the wire's device-to-host copy into pinned host memory
    behind the kernels, without waiting (the counterpart of
    `copy_to_host_async`).  Both events are recorded on the current
    stream of the wire's own device, the stream its kernels ran on, not
    on the calling thread's current device.  A CPU wire is already on
    the host."""
    if not res.wire.is_cuda:
        return res
    dev = res.wire.device
    stream = torch.cuda.current_stream(dev)
    with torch.cuda.device(dev):
        executed = torch.cuda.Event()
        executed.record(stream)
        host = torch.empty(res.wire.shape, dtype=res.wire.dtype, pin_memory=True)
        host.copy_(res.wire, non_blocking=True)
        copied = torch.cuda.Event()
        copied.record(stream)
    return res._replace(host=host, executed=executed, copied=copied)


def wait_executed(res: RleRendered) -> None:
    """Block until the batch's kernels have run (a wire from
    `start_wire_copy`; a CPU wire is ready)."""
    if res.executed is not None:
        res.executed.synchronize()


class BatchRenderer:
    """One CUDA device's renderer (`device="cpu"` runs the kernels' plain
    versions, or the dense renderer on the CPU; only the tests ask for
    it).  backend="cuda" (the kernels, default) or "dense" (the
    reference's jnp renderer); `precision` and `chunk_size` apply to the
    dense backend."""

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
        arena: bool = False,
        backend: str = "cuda",
        precision: str = "fast",
        chunk_size: int = 64,
    ):
        if backend not in ("cuda", "dense"):
            raise ValueError(f"unknown backend {backend!r} (use 'cuda' or 'dense')")
        if backend == "dense":
            RD._dtypes(precision)  # raises on an unknown precision
        self.device = resolve_device(device) if isinstance(device, str) else device
        self.backend = backend
        self.precision = precision
        self.chunk_size = chunk_size
        self.styler = styler
        self.tile_bucket = tile_bucket
        self.chunk_cache_tiles = chunk_cache_tiles
        self._chunk_cache: "OrderedDict" = OrderedDict()
        self._cache_lock = threading.RLock()
        self._rtot_by_key: dict = {}      # (ts, T) -> adaptive v1 run cap
        self._wtot_by_key: dict = {}      # (ts, T) -> adaptive v2 word cap
        # Adaptive serving palette: learned from the first v1 batch's run
        # colours, relearned by demoting to v1 for one batch when the
        # literal fraction drifts too high.
        self._pal_table: Optional[np.ndarray] = None
        self._pal_dev: Optional[torch.Tensor] = None
        self._pal_cooldown = 0  # v2 batches before a relearn may trigger
        self._persist_tables: dict = {}   # scale -> (ProfileTable, PatternTable)
        self._patterns_dev: dict = {}     # scale -> (n_tiles_in_table, tensor)
        self._profiles_dev: dict = {}     # scale -> (n_rows, rows, totals)
        self._canvas_dev: dict = {}       # numpy dtype -> canvas tensor
        self._empty_chunks: dict = {}     # ts -> TileChunks (PAD-only)
        # Device-resident chunk arena, tied to the chunk cache's lifecycle.
        self.chunk_arena = (
            ChunkArena(device=self.device) if arena and chunk_cache_tiles else None
        )
        # Device label slabs, one per tile size; filled when prepare() is
        # given label layers on the arena path.
        self._label_slabs: dict = {}
        # Batches by path, tiles labeled on the device, and bytes read
        # back: the wires, and the raw planar batches they stand for (the
        # server logs both).
        self.batch_counts = {"arena": 0, "plain": 0, "dense": 0, "v1": 0, "v2": 0, "raw": 0,
                             "labeled_tiles": 0}
        self.readback_bytes = {"wire": 0, "planar": 0}
        # Tiles dropped from the chunk cache to make room (their arena
        # rows freed).
        self.evictions = 0
        self.icon_cache = None
        if stylesheet_dir is not None:
            from osm_renderer_tpu_torch.draw.labels.icons import IconCache

            self.icon_cache = IconCache(stylesheet_dir)
        if backend == "cuda":
            _na.get_native()

    def prepare(
        self, tiles_entities: Sequence[Tuple[object, Tile]], scale: int = 1,
        label_layers: Optional[Sequence] = None,
    ) -> PreparedBatch:
        """label_layers: optional per-tile compact committed label layers
        (`Labeler.ensure_layer` results, None = unlabeled).  On the arena
        path labeled tiles are blended on the device
        (`PreparedBatch.device_labeled`); elsewhere the hint is ignored
        and callers keep the host composite."""
        if self.backend == "dense":
            return self._prepare_dense(tiles_entities, scale)
        ts_px = 256 * scale
        profiles, patterns = self._tables_for(scale)
        tile_chunks = []
        tile_keys = []
        fallback = []
        cache_on = bool(self.chunk_cache_tiles)
        for idx, (entities, tile) in enumerate(tiles_entities):
            key = (tile.zoom, tile.x, tile.y, scale)
            tile_keys.append(key)
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
                        ev_key, _ = self._chunk_cache.popitem(last=False)
                        self.evictions += 1
                        if self.chunk_arena is not None:
                            self.chunk_arena.free(ev_key)
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
            tile_keys.extend([("__pad__", ts_px)] * (bucket - len(tile_keys)))
            n_tiles = bucket
        if self.chunk_arena is not None and cache_on:
            try:
                self.chunk_arena.insert(list(zip(tile_keys, tile_chunks)))
            except MemoryError:
                # Arena exhausted: rebuild lazily; this batch takes the
                # plain upload path.
                self.chunk_arena.clear()
            else:
                return self._finalize_arena(
                    tile_chunks, tile_keys, profiles, patterns, ts_px, n_tiles, fallback,
                    scale, label_layers,
                )
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

    def _prepare_dense(self, tiles_entities, scale: int) -> PreparedBatch:
        """The reference's jnp prepare: fresh tables, the chunk doubled
        until it holds the largest fill (every fill is one chunk), tiles
        with icon fills left to the oracle, coordinates checked only for
        the fast precision.  The schedule is planned, and on a CUDA device
        packed for the dense kernels, before the upload."""
        dtype = np.float32 if self.precision == "fast" else np.float64
        ts_px = 256 * scale
        profiles = prim_mod.ProfileTable()
        patterns = prim_mod.PatternTable(self.icon_cache, ts_px)
        all_prims = []
        chunk = self.chunk_size
        for entities, tile in tiles_entities:
            prims = assemble_tile_prims(entities, tile, float(scale), self.styler)
            all_prims.append(prims)
            max_fill = max(
                (p.edges.shape[0] for p in prims if isinstance(p, FillPrim)), default=0
            )
            while chunk < max_fill:
                chunk *= 2
        streams = [prim_mod.stream_tile(prims, profiles, chunk, patterns) for prims in all_prims]
        fallback = tuple(i for i, st in enumerate(streams) if st.has_icon_fills)
        arrays = prim_mod.build_batch(streams, profiles, chunk, dtype=dtype, patterns=patterns,
                                      ts=ts_px)
        if self.precision == "fast":
            self._check_coords(arrays.geom)
        plan = RD.plan_batch(arrays, ts_px, chunk, self.precision,
                             RD.PIXEL_BUDGET[self.device.type])
        pack = None
        if self.device.type == "cuda":
            pack = DC.pack_plan(plan, len(streams)).to(self.device)
        return PreparedBatch(
            RD.TileBatch.from_numpy(arrays, self.device), self._canvas_tensor(dtype), ts_px,
            chunk, fallback, precision=self.precision, chain=profiles.has_round_caps(),
            plan=plan, pack=pack,
        )

    def _finalize_arena(
        self, tile_chunks, tile_keys, profiles, patterns, ts_px, n_tiles, fallback, scale,
        label_layers=None,
    ) -> PreparedBatch:
        """Arena-path batch finalize, after the tiles' big chunk fields
        are in the arena: pack the per-chunk scalars and gather rows into
        the small host buffer.  Labeled tiles (not the CPU-fallback ones)
        get their committed label layers staged in the device label slab
        and a slab-row map for the packed upload.  A slab that cannot hold
        the batch is cleared and filled again; a second MemoryError
        raises."""
        arena = self.chunk_arena
        offsets = [arena.offset(k) for k in tile_keys]
        packed = L.pack_small_arena(tile_chunks, offsets)

        label_rows = label_ctx = None
        device_labeled: tuple = ()
        labeled = [
            (ti, tile_keys[ti], compact)
            for ti, compact in enumerate(label_layers or ())
            if compact is not None and ti not in fallback
        ]
        if labeled:
            slab = self._label_slab(ts_px)
            try:
                slab.insert([(k, c) for _, k, c in labeled])
            except MemoryError:
                slab.clear()
                slab.insert([(k, c) for _, k, c in labeled])
            label_rows = slab.ltriples(n_tiles, [(ti, k) for ti, k, _ in labeled])
            label_ctx = (slab, slab.generation)
            device_labeled = tuple(ti for ti, _, _ in labeled)

        ver = len(profiles.rows)
        got = self._profiles_dev.get(scale)
        if got is None or got[0] != ver:
            rows, tots = profiles.arrays(np.float32)
            got = (ver, torch.from_numpy(rows).to(self.device),
                   torch.from_numpy(tots).to(self.device))
            self._profiles_dev[scale] = got
        _, prof_dev, tot_dev = got

        pver = len(patterns.tiles)
        gp = self._patterns_dev.get(scale)
        if gp is None or gp[0] != pver:
            if patterns.tiles:
                pat_arr = patterns.array()
            else:
                pat_arr = np.zeros((1, 4, ts_px, ts_px), dtype=np.float32)
            gp = (pver, torch.from_numpy(np.ascontiguousarray(pat_arr)).to(self.device))
            self._patterns_dev[scale] = gp

        return PreparedBatch(
            None, self._canvas_tensor(), ts_px, n_tiles, tuple(fallback),
            arena_packed=packed,
            arena_ctx=(arena, prof_dev, tot_dev, gp[1], arena.generation),
            label_rows=label_rows, label_ctx=label_ctx, device_labeled=device_labeled,
        )

    def _label_slab(self, ts_px: int) -> LabelSlab:
        got = self._label_slabs.get(ts_px)
        if got is None:
            got = self._label_slabs[ts_px] = LabelSlab(ts_px, device=self.device)
        return got

    def _canvas(self, dtype=np.float32) -> np.ndarray:
        canvas = self.styler.canvas_fill_color
        rgb = [canvas.r, canvas.g, canvas.b] if canvas is not None else [0, 0, 0]
        return np.array(rgb, dtype=dtype) / 255.0

    def _canvas_tensor(self, dtype=np.float32) -> torch.Tensor:
        got = self._canvas_dev.get(dtype)
        if got is None:
            got = self._canvas_dev[dtype] = torch.from_numpy(self._canvas(dtype)).to(self.device)
        return got

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
            self._profiles_dev.clear()
            if self.chunk_arena is not None:
                self.chunk_arena.clear()
            for slab in self._label_slabs.values():
                slab.clear()

    def render_prepared_planar(self, prepared: PreparedBatch) -> torch.Tensor:
        """(T, 4, ts, ts) u8 on the device, not synchronised (kernels'
        path only)."""
        if prepared.precision != "cuda":
            raise ValueError("a dense batch has no planar output; use render_prepared")
        if prepared.arena_packed is not None:
            arena, prof_dev, tot_dev, pat_dev, gen = prepared.arena_ctx
            if gen != arena.generation:
                # The arena was cleared between prepare and render (cache
                # reset); offsets are stale.  ValueError routes the server
                # to its per-batch CPU fallback.
                raise ValueError("chunk arena reset between prepare and render")
            if prepared.label_rows is not None:
                slab, sgen = prepared.label_ctx
                if sgen != slab.generation:
                    raise ValueError("label slab reset between prepare and render")
                out = RC.render_arena_planar_labeled(
                    prepared.arena_packed, prepared.label_rows, arena, prof_dev, tot_dev,
                    pat_dev, prepared.canvas_rgb, prepared.ts, prepared.chunk, slab.plane,
                )
                self.batch_counts["labeled_tiles"] += len(prepared.device_labeled)
            else:
                out = RC.render_arena_planar(
                    prepared.arena_packed, arena, prof_dev, tot_dev, pat_dev,
                    prepared.canvas_rgb, prepared.ts, prepared.chunk,
                )
            self.batch_counts["arena"] += 1
            return out
        out = RC.render_batch_planar(prepared.batch, prepared.canvas_rgb, prepared.ts)
        self.batch_counts["plain"] += 1
        return out

    def render_prepared(self, prepared: PreparedBatch) -> torch.Tensor:
        """(T, ts, ts, 3) u8 on the device, not synchronised: the dense
        render, or a view of the kernels' planar output."""
        if prepared.precision != "cuda":
            out = RD.render_batch(prepared.batch, prepared.canvas_rgb, prepared.ts,
                                  prepared.chunk, prepared.precision, prepared.chain,
                                  prepared.plan, prepared.pack)
            self.batch_counts["dense"] += 1
            return out
        return self.render_prepared_planar(prepared)[:, :3].permute(0, 2, 3, 1)

    def render(self, tiles_entities: Sequence[Tuple[object, Tile]], scale: int = 1) -> np.ndarray:
        """Prepare, render and read back -> (T, ts, ts, 3) u8."""
        return self.render_prepared(self.prepare(tiles_entities, scale)).cpu().numpy()

    # ------------------------------------------------------------- wire --

    def _pick_rtot(self, ts: int, T: int) -> int:
        """v1 wire capacity (total runs) for a (tile size, batch size)
        signature: adapted from the last observed total, generous cold
        default (overflow costs one raw planar batch fetch)."""
        got = self._rtot_by_key.get((ts, T))
        if got is not None:
            return got
        return L.next_bucket(T * 12 * 1024, 4096)

    def _note_total_runs(self, ts: int, T: int, total: int) -> None:
        want = L.next_bucket(max(int(total * 1.25), T * 1024), 4096)
        cur = self._rtot_by_key.get((ts, T))
        # Hysteresis, as the JAX package keeps it: grow monotonically;
        # shrink only on a clear regime change (>= 2x smaller).
        if cur is not None and want <= cur and want * 2 > cur:
            return
        self._rtot_by_key[(ts, T)] = want

    def _pick_wtot(self, ts: int, T: int) -> int:
        """v2 wire capacity (16-bit words, stored as i32 pairs); seeded
        from the observed run cap when available."""
        got = self._wtot_by_key.get((ts, T))
        if got is not None:
            return got
        seed = self._rtot_by_key.get((ts, T))
        if seed is not None:
            return L.next_bucket(seed * 2, 8192)
        return L.next_bucket(T * 16 * 1024, 8192)

    def _note_total_words(self, ts: int, T: int, total: int) -> None:
        want = L.next_bucket(max(int(total * 1.25), T * 2048), 8192)
        cur = self._wtot_by_key.get((ts, T))
        if cur is not None and want <= cur and want * 2 > cur:
            return
        self._wtot_by_key[(ts, T)] = want

    def render_prepared_rle(self, prepared: PreparedBatch) -> RleRendered:
        """Render, then run-length encode on the device: the v2 wire once
        a serving palette is learned (from the first v1 batch), else v1.
        Not synchronised."""
        T = prepared.chunk
        planar = self.render_prepared_planar(prepared)
        if self._pal_dev is not None:
            wcap = self._pick_wtot(prepared.ts, T)
            wire = RLE.encode_wire_indexed(planar, wcap, self._pal_dev)
            self.batch_counts["v2"] += 1
            return RleRendered(planar, wire, prepared.ts, wcap, "v2")
        cap = self._pick_rtot(prepared.ts, T)
        wire = RLE.encode_batch_wire(planar, cap)
        self.batch_counts["v1"] += 1
        return RleRendered(planar, wire, prepared.ts, cap)

    def fetch_tile_view(self, res: RleRendered) -> "RleTileView":
        """Host fetch of the wire as a lazy per-tile view: tiles decode to
        RGB on demand, and v2 tiles can skip RGB entirely and emit a
        palette PNG straight from the words (`RleTileView.png8`).  Falls
        back to the raw planar fetch when the batch overflowed the wire's
        cap (and grows the next cap)."""
        if res.copied is not None:
            res.copied.synchronize()
            wire = res.host.numpy()
        else:
            wire = res.wire.cpu().numpy()
        self.readback_bytes["wire"] += wire.nbytes
        self.readback_bytes["planar"] += res.planar.numel()
        T = int(wire[0])
        total = int(wire[1])
        ts = res.ts
        if res.fmt == "v2":
            total_runs = int(wire[2])
            if total > res.rtot:
                # A run emits at most 3 words, so 3 * total_runs is a
                # sound bound for the next cap.
                self._note_total_words(ts, T, min(total, 3 * max(total_runs, 1)))
                return self._raw_view(res)
            self._note_total_words(ts, T, total)
            n_words = wire[3 : 3 + T]
            table = wire[3 + T : 3 + T + rle_layout.PAL_CAP]
            packed32 = wire[3 + T + rle_layout.PAL_CAP :]
            offs = np.zeros(T + 1, np.int64)
            np.cumsum(n_words, out=offs[1:])
            # Palette drift: too many literal escapes -> relearn by
            # demoting the next batch to v1 (its fetch rebuilds the table
            # from full run colours).  Cooldown-gated, so a corpus whose
            # tail colours exceed the palette does not flip every batch.
            self._pal_cooldown -= 1
            lit_runs = (total - total_runs) // 2
            if total_runs and lit_runs * 100 > total_runs * 45 and self._pal_cooldown <= 0:
                self._pal_table = None
                self._pal_dev = None
            return RleTileView(T, ts, words=(packed32, offs, table))
        self._note_total_runs(ts, T, total)
        if total > res.rtot:
            return self._raw_view(res)
        n_runs = wire[2 : 2 + T]
        packed = wire[2 + T :]
        offs = np.zeros(T + 1, np.int64)
        np.cumsum(n_runs, out=offs[1:])
        # Learn the serving palette from this batch's run colours; the
        # next batch ships indexed.
        if self._pal_table is None and total > 0:
            colors, counts = np.unique(packed[:total] & 0xFFFFFF, return_counts=True)
            self._pal_table = rle_layout.build_palette(colors, counts)
            self._pal_dev = torch.from_numpy(self._pal_table).to(self.device)
            self._pal_cooldown = 16
        return RleTileView(T, ts, runs=(packed, offs))

    def _raw_view(self, res: RleRendered) -> "RleTileView":
        """Overflow fallback, as the JAX package does it: read the raw
        planar batch back."""
        self.batch_counts["raw"] += 1
        rgb = L.planar_to_rgb(res.planar.cpu().numpy())
        return RleTileView(rgb.shape[0], res.ts, rgb=rgb)

    def fetch_rgb_rle(self, res: RleRendered) -> np.ndarray:
        """Host fetch + decode of the wire -> (T, ts, ts, 3) u8."""
        view = self.fetch_tile_view(res)
        out = np.empty((view.T, view.ts, view.ts, 3), np.uint8)
        for i in range(view.T):
            out[i] = view.rgb(i)
        return out


class RleTileView:
    """Per-tile view of one fetched wire.

    Exactly one of `rgb` (raw fallback batch), `words` (v2: packed32,
    word offsets, palette table) or `runs` (v1: packed runs, run offsets)
    is set; `wire_fmt(i)` names which ("raw", "v2" or "v1").  `rgb(i)`
    decodes tile i; `png8(i, level)` emits a palette PNG straight from the
    v2 words (None when the tile needs the RGB path: a v1 or raw batch, or
    more than 256 colours in the tile).  Both go through the port's host
    codec (`draw/png8.py`)."""

    def __init__(self, T: int, ts: int, rgb=None, words=None, runs=None):
        self.T = T
        self.ts = ts
        self._rgb = rgb
        self.words = words
        self._runs = runs

    def wire_fmt(self, i: int) -> str:
        """The wire tile i came on (every tile of a view comes on one)."""
        return "raw" if self._rgb is not None else "v2" if self.words is not None else "v1"

    def rgb(self, i: int) -> np.ndarray:
        if self._rgb is not None:
            return self._rgb[i]
        ts = self.ts
        if self.words is not None:
            packed32, offs, table = self.words
            return decode_words(packed32, int(offs[i]), int(offs[i + 1] - offs[i]), table,
                                ts, ts)
        packed, offs = self._runs
        return decode_packed(packed[int(offs[i]) : int(offs[i + 1])], ts, ts)

    def png8(self, i: int, level: int) -> Optional[bytes]:
        if self.words is None:
            return None
        packed32, offs, table = self.words
        return words_to_png_pal(
            packed32, int(offs[i]), int(offs[i + 1] - offs[i]), table, self.ts, self.ts, level,
        )


def pad_batch_to(tiles: int, prepared: PreparedBatch) -> PreparedBatch:
    """Pad the batch's tile axis to `tiles` with empty tiles (each renders
    the canvas): a fixed batch shape for callers that want one.  Plain
    upload batches only."""
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


class MeshTileRenderer:
    """Tile data parallelism over several devices: one `BatchRenderer` a
    device (the full one-device program each, its own caches and arena
    when asked for), the batch split round-robin and gathered on the
    host.  Counterpart of `osm_renderer_tpu.parallel.renderer.
    MeshTileRenderer`.

    `devices=None` is every visible CUDA device and raises when there is
    none.  A list may name a device more than once: each entry gets a
    renderer of its own."""

    def __init__(self, styler: Styler, devices=None, **kwargs):
        if devices is None:
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            if n == 0:
                raise RuntimeError("MeshTileRenderer: no CUDA device is visible")
            devices = [torch.device("cuda", i) for i in range(n)]
        if not devices:
            raise ValueError("MeshTileRenderer needs at least one device")
        self.renderers = [BatchRenderer(styler, device=d, **kwargs) for d in devices]
        self.devices = [r.device for r in self.renderers]

    def render(self, tiles_entities: Sequence[Tuple[object, Tile]], scale: int = 1) -> np.ndarray:
        """-> (T, ts, ts, 3) u8 in request order.  Every shard is launched
        before any is read back, so the devices render together."""
        n = len(self.renderers)
        outs = [
            (d, r.render_prepared(r.prepare(tiles_entities[d::n], scale)))
            for d, r in enumerate(self.renderers) if tiles_entities[d::n]
        ]
        T, ts = len(tiles_entities), 256 * scale
        result = np.empty((T, ts, ts, 3), dtype=np.uint8)
        for d, out in outs:
            result[d::n] = out[: len(range(d, T, n))].cpu().numpy()
        return result
