"""Slippy-tile HTTP server: CUDA devices, or the C++ oracle on the CPU.

The port's server, with the URL contract and serving loop of
`osm_renderer_tpu.server.http`.  `backend = "cpu"` renders each request
on its own thread with the C++ oracle (`CpuDrawer`), as the original's
CPU backend does.  `backend = "device"`: an async micro-batcher groups concurrent
tile requests, `render_tiles_device` folds them per scale into batches
(cold-heavy groups stream in pipelined sub-batches; chunk-dense groups
halve on MAX_BATCH_CHUNKS).  With `gpus = N` there is one renderer a
device, each with its own arena, label slab, caches, palette and wire
caps; a tile always goes to the same one (`_dev_idx`), and each
(sub-)batch is split by renderer, launched on all of them, then read
back through one view (`_ShardedTileView`).  Unlike the original, whose
groups over several devices take one batch and go to the oracle on
MAX_BATCH_CHUNKS, they stream and halve here as on one.  A batch renders from
the chunk arena (unless `osm_ids` is set), is run-length encoded on the device and
crosses to the host as one wire array.  On the arena path, labeled
tiles have their committed label layers blended on the device (the
renderer's label slab).  Unlabeled and device-labeled tiles ship as
PNG-8 straight from the v2 wire, through the port's host codec
(`draw/png8.py`: its own wire decoder, then zlib); a service whose codec
cannot be built or loaded does not start.  The others decode to RGB
through the same codec and ship as RGB PNGs: tiles
of a v1 or raw batch, tiles of more than 256 colours, and labeled tiles
the device did not label (plain upload batches under `osm_ids`), which
get their labels composited on the host.  `containers` counts the
device tiles served each way.  The codec work of a sub-batch's device
tiles runs on the service's encode pool, a thread a CPU the process may
use but two (`encode_pool_width`), since the codec's ctypes calls and
zlib release the interpreter lock; the tiles are recorded in order on
the render thread once every task has ended.

Each tile's perfstats record holds, besides its spans, the request's
wait in the batcher's queue, its share of the device dispatch it rode
in and of that dispatch's device time (CUDA events), and whether it
came from a raw batch and shipped as an RGB PNG (counts).  A service
whose `perf_stats` keeps an interval log (`PerfStats(intervals=N)`)
also logs each batch's phases on the profiler's clock, tagged with the
batcher's batch id.

`precision = "exact"` serves as the original does: a dense renderer
(`BatchRenderer(backend="dense", precision="exact")`, int64/f64) on the
service's device, with no chunk cache, no arena and no icon patterns
(tiles with icon fills go to the oracle); each batch is read back raw
and its labeled tiles are composited on the host.  It serves on the
first device only, as the original does.

Both backends label with the port's fontTools-free labeler.
"""

from __future__ import annotations

import asyncio
import itertools
import os
import threading
import time
from collections import Counter, OrderedDict
from concurrent.futures import ThreadPoolExecutor, wait
from contextlib import nullcontext
from contextvars import ContextVar
from dataclasses import dataclass
from typing import Dict, List, Optional, Set, Tuple

import torch

from osm_renderer_tpu_torch import perfstats
from osm_renderer_tpu_torch.core.tile import MAX_ZOOM, Tile
from osm_renderer_tpu_torch.draw.drawer import CpuDrawer
from osm_renderer_tpu_torch.draw import png8
from osm_renderer_tpu_torch.draw.png_writer import rgb_to_png
from osm_renderer_tpu_torch.geodata.reader import GeodataReader
from osm_renderer_tpu_torch.mapcss.styler import Styler
from osm_renderer_tpu_torch.parallel.renderer import (
    BatchRenderer,
    RleTileView,
    start_wire_copy,
    wait_executed,
)
from osm_renderer_tpu_torch.utils.torch_setup import build_native_host_libs, resolve_device


# The PNG containers of device tiles: "png8", or RGB for the reason
# ("rgb_overflow": more than 256 colours in the tile; "rgb_v1",
# "rgb_raw": the batch's wire; "rgb_host_labels": labels composited on
# the host).
CONTAINERS = ("png8", "rgb_overflow", "rgb_v1", "rgb_raw", "rgb_host_labels")


@dataclass
class _Batch:
    """The micro-batch a render call serves: the batcher's id for it,
    each request's `time.time_ns()` at its put on the batcher's queue,
    and the render call's start (`render_tiles_device` sets it)."""

    id: int
    enqueued_ns: List[int]
    start_ns: int = 0


# Set by `run_server`'s batcher; `asyncio.to_thread` carries it into the
# render thread.  A direct call of `render_tiles_device` finds it unset.
_BATCH: ContextVar[Optional[_Batch]] = ContextVar("osmr_batch", default=None)


def _batch_id() -> Optional[int]:
    batch = _BATCH.get()
    return None if batch is None else batch.id


def encode_pool_width() -> int:
    """Threads of a service's encode pool: the CPUs the calling thread
    may run on, less two for the HTTP event loop and the render thread,
    and at least 1 (1: no pool, tiles encode on the render thread)."""
    return max(len(os.sched_getaffinity(0)) - 2, 1)


def _encode_device_tile(view, gi: int, level: int) -> Tuple[bytes, Optional[str], float]:
    """Tile `gi` of a fetched view -> (PNG, wire, seconds of work): PNG-8
    straight from the v2 wire when its colours fit a palette (wire None),
    else its RGB pixels as an RGB PNG (wire: the format of the wire it
    came on).  A pure function of the view, which nothing writes after
    `fetch_tile_view`, so the encode pool runs it on any thread: the
    codec's ctypes calls and zlib release the interpreter lock."""
    t0 = time.perf_counter()
    png = view.png8(gi, level)
    wire = None
    if png is None:
        wire = view.wire_fmt(gi)
        png = rgb_to_png(view.rgb(gi), level)
    return png, wire, time.perf_counter() - t0


def extract_tile_from_path(path: str) -> Optional[Tuple[Tile, int]]:
    """Parse `/{z}/{x}/{y}[@Nx].png[?query]` -> (tile, scale)."""
    qpos = path.rfind("?")
    real_path = path[:qpos] if qpos >= 0 else path
    if real_path.endswith(".png"):
        real_path = real_path[: -len(".png")]
    tokens = real_path.rsplit("/", 3)
    if len(tokens) < 3:
        return None
    z_str, x_str, y_str = tokens[-3:]
    scale = 1
    if "@" in y_str:
        y_str, _, scale_str = y_str.partition("@")
        try:
            scale = int(scale_str.rstrip("x"))
        except ValueError:
            return None
    try:
        z, x, y = int(z_str), int(x_str), int(y_str)
    except ValueError:
        return None
    if z < 0 or z > MAX_ZOOM or scale < 1 or scale > 4:
        return None
    return Tile(z, x, y), scale


def _serving_devices(first: torch.device, gpus: int) -> List[torch.device]:
    """The `gpus` devices a service renders on: CUDA devices `first`,
    `first + 1`, ...; on the CPU (tests only), the CPU `gpus` times.
    Raises ValueError when fewer CUDA devices are visible from `first`
    on, so a service never serves on fewer devices than it was asked
    for."""
    if first.type == "cpu":
        return [first] * gpus
    visible = torch.cuda.device_count()
    if first.index + gpus > visible:
        raise ValueError(
            f"gpus = {gpus} from cuda:{first.index} on, but {visible - first.index} CUDA "
            f"device(s) are visible from cuda:{first.index} on ({visible} in all)"
        )
    return [torch.device("cuda", first.index + i) for i in range(gpus)]


class _ShardedTileView:
    """Per-tile view over the per-renderer views of a batch split by
    renderer: shard k holds the batch's tiles `shard_idxs[k]`, in order."""

    def __init__(self, views, shard_idxs):
        self._views = views
        self._remap = {i: (k, j) for k, idxs in enumerate(shard_idxs)
                       for j, i in enumerate(idxs)}

    def rgb(self, i: int):
        k, j = self._remap[i]
        return self._views[k].rgb(j)

    def png8(self, i: int, level: int):
        k, j = self._remap[i]
        return self._views[k].png8(j, level)

    def wire_fmt(self, i: int) -> str:
        k, j = self._remap[i]
        return self._views[k].wire_fmt(j)


class TileService:
    """Tile service.  `backend="device"` renders on `gpus` CUDA devices
    from `device` on, one renderer each (`device="cpu"` runs the
    kernels' plain versions, `gpus` renderers on the CPU; only the tests
    ask for it): `precision="fast"` through the kernels, `"exact"`
    through the dense renderer on the first device.  `backend="cpu"`
    renders each tile with the C++ oracle."""

    # Cold-heavy groups stream in sub-batches of this many tiles: host
    # assembly of sub-batch N+1 overlaps the device work of sub-batch N.
    COLD_SUB = 16

    def __init__(
        self,
        geodata_file: str,
        styler: Styler,
        stylesheet_dir: str,
        backend: str = "device",
        osm_ids: Optional[Set[int]] = None,
        enable_labels: bool = True,
        precision: str = "fast",
        png_level: int = 1,
        png_cache_tiles: int = 512,
        device: str = "cuda",
        gpus: int = 1,
    ):
        if backend not in ("device", "cpu"):
            raise ValueError(f"unknown backend {backend!r} (use 'device' or 'cpu')")
        if backend == "device" and gpus < 1:
            raise ValueError(f"gpus = {gpus}: serving needs at least one GPU")
        if precision not in ("fast", "exact"):
            raise ValueError(f"unknown precision {precision!r} (use 'fast' or 'exact')")
        build_native_host_libs()
        self.reader = GeodataReader.load(geodata_file)
        self.styler = styler
        self.osm_ids = osm_ids
        self.backend = backend
        self.png_level = png_level
        # Served-PNG LRU: geodata and stylesheet are immutable for the
        # server's lifetime (off under the osm_ids debug filter, and on
        # the CPU backend to keep the reference's semantics).
        self._png_cache: "OrderedDict" = OrderedDict()
        self._png_cache_lock = threading.Lock()
        self.png_cache_tiles = 0 if (osm_ids or backend != "device") else png_cache_tiles
        self.labeler = None
        if enable_labels:
            from osm_renderer_tpu_torch.draw.labels.labeler import Labeler

            # The CPU backend places labels per glyph, uncached, like the
            # reference.
            self.labeler = Labeler(
                icon_base_path=stylesheet_dir, use_atlas=backend == "device",
                label_cache_tiles=0 if (osm_ids or backend != "device") else 512,
            )
        self.perf_stats = perfstats.PerfStats()
        self._perf_lock = threading.Lock()
        self._local = threading.local()
        self._stylesheet_dir = stylesheet_dir
        self.batch_renderer = None
        self.batch_renderers: List[BatchRenderer] = []
        # Tiles handed to each renderer, by its index in batch_renderers;
        # tiles served from a device view ("device") or by the C++ oracle
        # ("oracle"); chunk-dense batches halved on MAX_BATCH_CHUNKS.
        self.tiles_by_renderer: Counter = Counter()
        self.tiles_served: Counter = Counter()
        # Device tiles by PNG container (CONTAINERS).
        self.containers: Counter = Counter()
        self.halvings = 0
        # The encode pool (`_encode_pool`): started on first use, stopped
        # by `close`.
        self._pool: Optional[ThreadPoolExecutor] = None
        self._pool_lock = threading.Lock()
        if backend == "cpu":
            return
        # The host codec every device-path tile is decoded and encoded
        # through; raises when it cannot be built or loaded.
        png8.library()
        self.device = resolve_device(device)
        devices = _serving_devices(self.device, gpus)
        if precision == "exact":
            # As the original: the dense renderer serves on the first
            # device only.
            self.batch_renderer = BatchRenderer(
                styler, backend="dense", precision="exact", device=devices[0])
            self.batch_renderers = [self.batch_renderer]
            return
        self.batch_renderers = [self.fast_renderer(d) for d in devices]
        self.batch_renderer = self.batch_renderers[0]

    def fast_renderer(self, device: torch.device) -> BatchRenderer:
        """A serving renderer of the kernels' path on `device`, with its own
        chunk cache, device-resident chunk arena (warm batches assemble on
        the device from one packed upload), label slabs, palette and wire
        caps."""
        return BatchRenderer(
            self.styler, stylesheet_dir=self._stylesheet_dir, tile_bucket=True,
            chunk_cache_tiles=0 if self.osm_ids else 512, device=device,
            arena=not self.osm_ids,
        )

    def warmup(self, n_tiles: int = 16) -> int:
        """Render up to `n_tiles` real z15 tiles through the full device
        path before accepting traffic, twice: the first pass builds the
        kernels, fills the chunk and label caches and learns the serving
        palette from its v1 wire; the second takes the v2 wire.
        Failures raise."""
        if self.backend != "device" or not len(self.reader.tiles):
            return 0
        xs = self.reader.tiles["x"] >> 3
        ys = self.reader.tiles["y"] >> 3
        seen = list(dict.fromkeys(zip(xs.tolist(), ys.tolist())))[:n_tiles]
        for _ in range(2):
            self.render_tiles_device([(Tile(15, x, y), 1) for x, y in seen])
            with self._png_cache_lock:
                self._png_cache.clear()
        return len(seen)

    def _encode_pool(self) -> Optional[ThreadPoolExecutor]:
        """The pool that encodes a sub-batch's device tiles, started on
        first use from the calling thread (the render thread), whose CPUs
        its threads inherit, `encode_pool_width()` threads wide; None when
        that width is 1."""
        with self._pool_lock:
            if self._pool is None:
                width = encode_pool_width()
                if width > 1:
                    self._pool = ThreadPoolExecutor(width, thread_name_prefix="osmr-encode")
            return self._pool

    def close(self) -> None:
        """Stop the encode pool and join its threads (a later render call
        starts a new one)."""
        with self._pool_lock:
            pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown(wait=True)

    def png_cache_get(self, tile: Tile, scale: int) -> Optional[bytes]:
        if not self.png_cache_tiles:
            return None
        key = (tile.zoom, tile.x, tile.y, scale)
        with self._png_cache_lock:
            png = self._png_cache.get(key)
            if png is not None:
                self._png_cache.move_to_end(key)
            return png

    def _png_cache_put(self, tile: Tile, scale: int, png: bytes) -> None:
        if not self.png_cache_tiles:
            return
        key = (tile.zoom, tile.x, tile.y, scale)
        with self._png_cache_lock:
            self._png_cache[key] = png
            while len(self._png_cache) > self.png_cache_tiles:
                self._png_cache.popitem(last=False)

    def _cpu_drawer(self) -> CpuDrawer:
        drawer = getattr(self._local, "drawer", None)
        if drawer is None:
            drawer = CpuDrawer(labeler=self.labeler, stylesheet_dir=self._stylesheet_dir)
            self._local.drawer = drawer
        return drawer

    def render_tile_cpu(self, tile: Tile, scale: int) -> bytes:
        perfstats.start_tile(tile.zoom)
        with perfstats.measure("Get tile entities"):
            entities = self.reader.get_entities_in_tile_with_neighbors(tile, self.osm_ids)
        with perfstats.measure("Draw tile"):
            rgb = self._cpu_drawer().draw_to_pixels(entities, tile, scale, self.styler)
        with perfstats.measure("RGB triples to PNG"):
            png = rgb_to_png(rgb, self.png_level)
        with self._perf_lock:
            perfstats.finish_tile(self.perf_stats)
        return png

    def _dev_idx(self, tile: Tile) -> int:
        """Stable tile -> renderer map, the original's hash: a tile always
        renders on the renderer whose chunk cache and arena hold it."""
        n = len(self.batch_renderers)
        if n <= 1:
            return 0
        return ((tile.x * 0x9E3779B1) ^ (tile.y * 0x85EBCA77) ^ tile.zoom) % n

    def _dispatch_group_device(self, tiles_entities, scale: int, t_prep0: int,
                               compacts=None):
        """Split the batch by renderer (`_dev_idx`; one shard with one
        renderer), prepare every shard, then launch every shard's kernels
        and queue its wire's copy to the host, without waiting for the
        devices, so they run together.  `t_prep0`: `time.time_ns()` as
        the dispatch began.  `compacts`: the tiles' committed label
        layers, blended on the device on the arena path.  A dense batch is
        queued as its raw (T, ts, ts, 3) output.  A shard on a CUDA device
        carries the `DeviceClock` of its kernel launches (render and wire,
        or the dense kernels; None on the CPU).  A shard's ValueError
        (MAX_BATCH_CHUNKS) raises before anything launches."""
        by_dev: Dict[int, List[int]] = {}
        for i, (_, t) in enumerate(tiles_entities):
            by_dev.setdefault(self._dev_idx(t), []).append(i)
        needs_cpu: Set[int] = set()
        device_labeled: Set[int] = set()
        staged = []
        for d, idxs in by_dev.items():
            prepared = self._prepare_shard(
                self.batch_renderers[d], [tiles_entities[i] for i in idxs], scale,
                [compacts[i] for i in idxs] if compacts is not None else None)
            needs_cpu.update(idxs[f] for f in prepared.cpu_fallback_tiles)
            device_labeled.update(idxs[f] for f in prepared.device_labeled)
            staged.append((d, idxs, prepared))
        prep_dt = (time.time_ns() - t_prep0) / 1e9
        shards = []
        for d, idxs, prepared in staged:
            r = self.batch_renderers[d]
            clock = perfstats.DeviceClock() if r.device.type == "cuda" else None
            with clock.running() if clock is not None else nullcontext():
                if prepared.precision != "cuda":
                    res = r.render_prepared(prepared)
                else:
                    res = start_wire_copy(r.render_prepared_rle(prepared))
            self.tiles_by_renderer[d] += len(idxs)
            shards.append((d, idxs, res, clock))
        self.perf_stats.log("Dispatch", t_prep0, time.time_ns(), _batch_id())
        return shards, needs_cpu, prep_dt, device_labeled

    def _prepare_shard(self, renderer: BatchRenderer, tiles_entities, scale: int, compacts):
        """`renderer.prepare`, with the entities of every tile fetched
        again when a tile that was cached as its group began has been
        evicted since (by an earlier sub-batch of the group, or by the
        inserts of this batch before its turn), so that it renders on the
        device instead of sending the batch to the oracle."""
        try:
            return renderer.prepare(tiles_entities, scale, label_layers=compacts)
        except ValueError as e:
            if "no cached chunks and no entities" not in str(e):
                raise
        tiles_entities = [
            (e if e is not None
             else self.reader.get_entities_in_tile_with_neighbors(t, self.osm_ids), t)
            for e, t in tiles_entities]
        return renderer.prepare(tiles_entities, scale, label_layers=compacts)

    def _collect_group_device(self, pending):
        """Wait for every shard of a dispatched batch and fetch its wire:
        (view, needs_cpu, prep_dt, dispatch, d2h_dt, device_labeled), the
        view a `_ShardedTileView` over several shards.  `dispatch[i]`:
        the number of tiles in tile i's shard, and the device seconds of
        that shard's kernel launches by CUDA events (None on the CPU),
        read after the wait.  `d2h_dt`: the readback's seconds (wire copy
        and parse, or the raw planar fetch on overflow)."""
        shards, needs_cpu, prep_dt, device_labeled = pending
        bid = _batch_id()
        t0 = time.time_ns()
        for _, _, res, _ in shards:
            if not isinstance(res, torch.Tensor):
                wait_executed(res)
            elif res.is_cuda:
                torch.cuda.synchronize(res.device)
        self.perf_stats.log("Device wait", t0, time.time_ns(), bid)
        dispatch = [None] * sum(len(idxs) for _, idxs, _, _ in shards)
        for _, idxs, _, clock in shards:
            dev_s = None if clock is None else clock.seconds()
            for i in idxs:
                dispatch[i] = (len(idxs), dev_s)
        t1 = time.time_ns()
        views = []
        for d, _, res, _ in shards:
            if isinstance(res, torch.Tensor):
                # Dense batch: one device-to-host copy.
                rgb = res.cpu().numpy()
                views.append(RleTileView(rgb.shape[0], rgb.shape[1], rgb=rgb))
            else:
                views.append(self.batch_renderers[d].fetch_tile_view(res))
        d2h_dt = (time.time_ns() - t1) / 1e9
        view = views[0] if len(views) == 1 else _ShardedTileView(
            views, [idxs for _, idxs, _, _ in shards])
        return view, needs_cpu, prep_dt, dispatch, d2h_dt, device_labeled

    def render_tiles_device(self, requests: List[Tuple[Tile, int]]) -> List[bytes]:
        """Batched device render; one dispatch per scale group, split by
        renderer when there are several (tiles the batch cannot represent
        fall back to the C++ oracle).  Called by `run_server`'s batcher
        (`_BATCH` set), it adds each request's queue wait to its tile's
        record and tags the batch's logged intervals with its id."""
        t_start = time.time_ns()
        batch = _BATCH.get()
        bid = None
        if batch is not None:
            bid, batch.start_ns = batch.id, t_start
            for t in batch.enqueued_ns:
                self.perf_stats.log("Queue wait", t, t_start, bid)
        out: Dict[int, bytes] = {}
        by_scale: Dict[int, List[Tuple[int, Tile]]] = {}
        for i, (tile, scale) in enumerate(requests):
            by_scale.setdefault(scale, []).append((i, tile))

        for scale, group in by_scale.items():
            t0 = time.time_ns()
            ts = 256 * scale

            # Entity fetch is skipped when both the tile's renderer's chunk
            # cache and (with labels) the label-layer cache hit.
            def _need_entities(t: Tile) -> bool:
                if not self.batch_renderers[self._dev_idx(t)].has_cached_chunks(t, scale):
                    return True
                return self.labeler is not None and not self.labeler.has_cached_layer(t, ts)

            tiles_entities = [
                (self.reader.get_entities_in_tile_with_neighbors(t, self.osm_ids)
                 if _need_entities(t) else None, t)
                for _, t in group
            ]
            compacts = None
            if self.labeler is not None:
                compacts = []
                for gi, (entities, t) in enumerate(tiles_entities):
                    if entities is None and not self.labeler.has_cached_layer(t, ts):
                        # Evicted since the check above: re-fetch.
                        entities = self.reader.get_entities_in_tile_with_neighbors(t, self.osm_ids)
                        tiles_entities[gi] = (entities, t)
                    compacts.append(
                        self.labeler.ensure_layer(entities, t, float(scale), self.styler, ts)
                    )
            ent_dt = (time.time_ns() - t0) / 1e9
            n = len(group)
            n_uncached = sum(1 for e, _ in tiles_entities if e is not None)
            if n > self.COLD_SUB and 2 * n_uncached > self.COLD_SUB:
                bounds = list(range(0, n, self.COLD_SUB)) + [n]
                subs = [slice(a, b) for a, b in zip(bounds, bounds[1:])]
            else:
                subs = [slice(0, n)]

            def sub_compacts(sl):
                return compacts[sl] if compacts is not None else None

            inflight = None
            for sl in subs + [None]:
                pending = None
                if sl is not None:
                    t0 = time.time_ns()
                    try:
                        pending = ("dispatched", self._dispatch_group_device(
                            tiles_entities[sl], scale, t0, sub_compacts(sl)))
                    except ValueError as e:
                        pending = ("err", (time.time_ns() - t0) / 1e9, str(e))
                if inflight is not None:
                    psl, pp = inflight
                    if pp[0] == "dispatched":
                        res = self._collect_group_device(pp[1])
                    elif "MAX_BATCH_CHUNKS" in pp[2]:
                        # Chunk-dense sub-batch: halve and retry on the device
                        # (the failed prepare already filled the chunk cache).
                        self._encode_split_sub(group[psl], tiles_entities[psl], scale, out,
                                               ent_dt / n, sub_compacts(psl))
                        inflight = (sl, pending) if sl is not None else None
                        continue
                    else:
                        res = (None, set(range(psl.stop - psl.start)), pp[1], None, None, set())
                    self._encode_sub(group[psl], tiles_entities[psl], scale, out, ent_dt / n,
                                     sub_compacts(psl), *res)
                inflight = (sl, pending) if sl is not None else None
        self.perf_stats.log("Batch", t_start, time.time_ns(), bid)
        return [out[i] for i in range(len(requests))]

    def _encode_split_sub(self, sub_group, sub_te, scale, out, ent_share, sub_compacts) -> None:
        """Render a chunk-dense sub-batch by recursive halving; a single
        tile that alone overflows the bound falls back to the oracle."""
        n = len(sub_group)
        if n == 1:
            self._encode_sub(sub_group, sub_te, scale, out, ent_share, sub_compacts,
                             None, {0}, 0.0, None, None, set())
            return
        self.halvings += 1
        mid = n // 2
        for sl in (slice(0, mid), slice(mid, n)):
            sc = sub_compacts[sl] if sub_compacts is not None else None
            t0 = time.time_ns()
            try:
                res = self._collect_group_device(
                    self._dispatch_group_device(sub_te[sl], scale, t0, sc))
            except ValueError as e:
                if "MAX_BATCH_CHUNKS" not in str(e):
                    raise
                self._encode_split_sub(sub_group[sl], sub_te[sl], scale, out, ent_share, sc)
                continue
            self._encode_sub(sub_group[sl], sub_te[sl], scale, out, ent_share, sc, *res)

    def _encode_sub(self, sub_group, sub_te, scale, out, ent_share, sub_compacts,
                    view, needs_cpu, prep_dt, dispatch, d2h_dt, device_labeled) -> None:
        """Encode a collected sub-batch and finish each tile's perfstats
        record, with request i's wait in the batcher's queue when the
        batcher made the call (`_BATCH`).  `dispatch`, `d2h_dt`: as
        `_collect_group_device` gives them, None when nothing was
        dispatched.

        The device tiles whose PNG the view alone decides (all but the
        oracle's and those that take the host label composite) encode on
        the service's encode pool, every task done before the tiles are
        recorded in order on this thread; a sub-batch of one such tile,
        or a pool of width 1, encodes them here.  A tile's "Compose and
        encode" is its own work, wherever it ran; "Compose and encode
        wall (batch share)" is this thread's wall time from the first
        task to the last result, split over the sub-batch."""
        t_enc0 = time.time_ns()
        batch = _BATCH.get()
        n = len(sub_group)

        def host_labels(gi: int) -> bool:
            return (sub_compacts is not None and sub_compacts[gi] is not None
                    and gi not in device_labeled)

        codec = [] if view is None else [
            gi for gi in range(n) if gi not in needs_cpu and not host_labels(gi)]
        pool = self._encode_pool() if len(codec) > 1 else None
        t_wall0 = time.perf_counter()
        if pool is None:
            coded = {gi: _encode_device_tile(view, gi, self.png_level) for gi in codec}
        else:
            futures = [pool.submit(_encode_device_tile, view, gi, self.png_level)
                       for gi in codec]
            # Every task ends before a failed one's error leaves this call.
            wait(futures)
            coded = {gi: f.result() for gi, f in zip(codec, futures)}
        wall_share = (time.perf_counter() - t_wall0) / n
        for gi, ((i, t), (entities, _)) in enumerate(zip(sub_group, sub_te)):
            # The device renders the whole sub-batch at once, so its phases are
            # attributed to its tiles as equal shares of measured spans.
            perfstats.start_tile(t.zoom)
            if batch is not None:
                perfstats.add_span("Queue wait", (batch.start_ns - batch.enqueued_ns[i]) / 1e9,
                                   perfstats.WAIT)
            perfstats.add_span("Get tile entities (batch share)", ent_share)
            perfstats.add_span("Prepare device batch (batch share)", prep_dt / n)
            if dispatch is not None:
                shard_n, dev_s = dispatch[gi]
                perfstats.count("Device dispatches (batch share)", 1.0 / shard_n)
                perfstats.count("Dispatched tiles")
                if dev_s is not None:
                    perfstats.add_span("Device time (batch share)", dev_s / shard_n)
                perfstats.add_span("Device readback (batch share)", d2h_dt / n)
            perfstats.add_span("Compose and encode wall (batch share)", wall_share)
            # A device tile's (RGB PNG, from a raw batch); None for the oracle's.
            shipped = None
            if gi in coded:
                self.tiles_served["device"] += 1
                out[i], wire, work_s = coded[gi]
                perfstats.add_span("Compose and encode", work_s)
                if wire is None:
                    self.containers["png8"] += 1
                    shipped = (0.0, 0.0)
                else:
                    self.containers["rgb_overflow" if wire == "v2" else f"rgb_{wire}"] += 1
                    shipped = (1.0, float(wire == "raw"))
            else:
                with perfstats.measure("Compose and encode"):
                    if gi in needs_cpu or view is None:
                        self.tiles_served["oracle"] += 1
                        if entities is None:
                            entities = self.reader.get_entities_in_tile_with_neighbors(
                                t, self.osm_ids)
                        img = self._cpu_drawer().draw_to_pixels(entities, t, scale, self.styler)
                    else:
                        # Host composite: batches without the label slab
                        # (the plain upload under osm_ids).
                        self.tiles_served["device"] += 1
                        self.containers["rgb_host_labels"] += 1
                        shipped = (1.0, float(view.wire_fmt(gi) == "raw"))
                        img = self.labeler.composite_labels(
                            view.rgb(gi), entities, t, float(scale), self.styler)
                    out[i] = rgb_to_png(img, self.png_level)
            if shipped is not None:
                # Every device tile counts 1 or 0, so a window with none reads 0.
                perfstats.count("Tiles as RGB PNG", shipped[0])
                perfstats.count("Tiles from raw batches", shipped[1])
            self._png_cache_put(t, scale, out[i])
            with self._perf_lock:
                perfstats.finish_tile(self.perf_stats)
        self.perf_stats.log("Compose and encode", t_enc0, time.time_ns(), _batch_id())


async def run_server(
    address: str, service: TileService, batch_window_ms: float = 5.0, max_batch: int = 32,
) -> None:
    host, _, port_str = address.rpartition(":")
    shutdown_event = asyncio.Event()
    loop = asyncio.get_running_loop()
    batch_queue: asyncio.Queue = asyncio.Queue()

    async def batcher():
        for batch_id in itertools.count():
            items = [await batch_queue.get()]
            try:
                deadline = loop.time() + batch_window_ms / 1e3
                while len(items) < max_batch:
                    timeout = deadline - loop.time()
                    if timeout <= 0:
                        break
                    items.append(await asyncio.wait_for(batch_queue.get(), timeout))
            except asyncio.TimeoutError:
                pass
            reqs = [(t, s) for (t, s, _, _) in items]
            # Read on the render thread: `to_thread` runs the call in a
            # copy of this task's context.
            _BATCH.set(_Batch(batch_id, [enq for (_, _, _, enq) in items]))
            try:
                pngs = await asyncio.to_thread(service.render_tiles_device, reqs)
                for (_, _, fut, _), png in zip(items, pngs):
                    if not fut.done():
                        fut.set_result(png)
            except Exception as e:  # handed to every waiting request
                for (_, _, fut, _) in items:
                    if not fut.done():
                        fut.set_exception(e)

    batcher_task = asyncio.create_task(batcher()) if service.backend == "device" else None

    async def handle(reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        try:
            tokens = (await reader.readline()).decode("latin-1").strip().split(" ")
            if len(tokens) != 3 or tokens[0] != "GET" or tokens[2] not in ("HTTP/1.1", "HTTP/1.0"):
                return
            path = tokens[1]
            if path == "/shutdown":
                shutdown_event.set()
                await _respond(writer, b"shutting down\n", "text/plain")
                return
            if path == "/perf_stats":
                with service._perf_lock:
                    html = service.perf_stats.to_html()
                await _respond(writer, html.encode(), "text/html")
                return
            parsed = extract_tile_from_path(path)
            if parsed is None:
                await _respond(writer, b"not a tile\n", "text/plain", status="404 Not Found")
                return
            tile, scale = parsed
            png = service.png_cache_get(tile, scale)
            if png is None and service.backend == "device":
                fut = loop.create_future()
                await batch_queue.put((tile, scale, fut, time.time_ns()))
                png = await fut
            elif png is None:
                png = await asyncio.to_thread(service.render_tile_cpu, tile, scale)
            await _respond(writer, png, "image/png")
        except (ConnectionResetError, BrokenPipeError):
            pass
        finally:
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionResetError, BrokenPipeError):
                pass

    server = await asyncio.start_server(handle, host or "127.0.0.1", int(port_str))
    try:
        await shutdown_event.wait()
    finally:
        if batcher_task is not None:
            batcher_task.cancel()
        server.close()
        await server.wait_closed()


async def _respond(writer, data: bytes, content_type: str, status: str = "200 OK"):
    header = (
        f"HTTP/1.1 {status}\r\n"
        f"Content-Type: {content_type}\r\n"
        f"Content-Length: {len(data)}\r\n"
        "Access-Control-Allow-Origin: *\r\n"
        "Connection: close\r\n"
        "\r\n"
    ).encode()
    writer.write(header + data)
    await writer.drain()
