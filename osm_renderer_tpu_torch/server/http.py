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
device tiles served each way.

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
import threading
import time
from collections import Counter, OrderedDict
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

    def _dispatch_group_device(self, tiles_entities, scale: int, t_prep0: float,
                               compacts=None):
        """Split the batch by renderer (`_dev_idx`; one shard with one
        renderer), prepare every shard, then launch every shard's kernels
        and queue its wire's copy to the host, without waiting for the
        devices, so they run together.  `compacts`: the tiles' committed
        label layers, blended on the device on the arena path.  A dense
        batch is queued as its raw (T, ts, ts, 3) output.  A shard's
        ValueError (MAX_BATCH_CHUNKS) raises before anything launches."""
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
        prep_dt = time.perf_counter() - t_prep0
        t0 = time.perf_counter()
        shards = []
        for d, idxs, prepared in staged:
            r = self.batch_renderers[d]
            if prepared.precision != "cuda":
                res = r.render_prepared(prepared)
            else:
                res = start_wire_copy(r.render_prepared_rle(prepared))
            self.tiles_by_renderer[d] += len(idxs)
            shards.append((d, idxs, res))
        return shards, needs_cpu, prep_dt, t0, device_labeled

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
        (view, needs_cpu, prep_dt, exec_dt, d2h_dt, device_labeled), the
        view a `_ShardedTileView` over several shards.  Execute (dispatch
        to kernels done) and readback (wire copy and parse, or the raw
        planar fetch on overflow) are separate spans."""
        shards, needs_cpu, prep_dt, t0, device_labeled = pending
        for _, _, res in shards:
            if not isinstance(res, torch.Tensor):
                wait_executed(res)
            elif res.is_cuda:
                torch.cuda.synchronize(res.device)
        exec_dt = time.perf_counter() - t0
        t1 = time.perf_counter()
        views = []
        for d, _, res in shards:
            if isinstance(res, torch.Tensor):
                # Dense batch: one device-to-host copy.
                rgb = res.cpu().numpy()
                views.append(RleTileView(rgb.shape[0], rgb.shape[1], rgb=rgb))
            else:
                views.append(self.batch_renderers[d].fetch_tile_view(res))
        d2h_dt = time.perf_counter() - t1
        view = views[0] if len(views) == 1 else _ShardedTileView(
            views, [idxs for _, idxs, _ in shards])
        return view, needs_cpu, prep_dt, exec_dt, d2h_dt, device_labeled

    def render_tiles_device(self, requests: List[Tuple[Tile, int]]) -> List[bytes]:
        """Batched device render; one dispatch per scale group, split by
        renderer when there are several (tiles the batch cannot represent
        fall back to the C++ oracle)."""
        out: Dict[int, bytes] = {}
        by_scale: Dict[int, List[Tuple[int, Tile]]] = {}
        for i, (tile, scale) in enumerate(requests):
            by_scale.setdefault(scale, []).append((i, tile))

        for scale, group in by_scale.items():
            t0 = time.perf_counter()
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
            ent_dt = time.perf_counter() - t0
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
                    t0 = time.perf_counter()
                    try:
                        pending = ("dispatched", self._dispatch_group_device(
                            tiles_entities[sl], scale, t0, sub_compacts(sl)))
                    except ValueError as e:
                        pending = ("err", time.perf_counter() - t0, str(e))
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
            t0 = time.perf_counter()
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
                    view, needs_cpu, prep_dt, exec_dt, d2h_dt, device_labeled) -> None:
        n = len(sub_group)
        for gi, ((i, t), (entities, _)) in enumerate(zip(sub_group, sub_te)):
            # The device renders the whole sub-batch at once, so its phases are
            # attributed to its tiles as equal shares of measured spans.
            perfstats.start_tile(t.zoom)
            perfstats.add_span("Get tile entities (batch share)", ent_share)
            perfstats.add_span("Prepare device batch (batch share)", prep_dt / n)
            if exec_dt is not None and d2h_dt is not None:
                perfstats.add_span("Device execute (batch share)", exec_dt / n)
                perfstats.add_span("Device readback (batch share)", d2h_dt / n)
            with perfstats.measure("Compose and encode"):
                if gi in needs_cpu or view is None:
                    self.tiles_served["oracle"] += 1
                    if entities is None:
                        entities = self.reader.get_entities_in_tile_with_neighbors(
                            t, self.osm_ids)
                    img = self._cpu_drawer().draw_to_pixels(entities, t, scale, self.styler)
                    out[i] = rgb_to_png(img, self.png_level)
                else:
                    self.tiles_served["device"] += 1
                    compact = sub_compacts[gi] if sub_compacts is not None else None
                    png = None
                    host_labels = compact is not None and gi not in device_labeled
                    if not host_labels:
                        # Unlabeled, or labeled on the device: PNG-8
                        # straight from the v2 wire when the tile's
                        # colours fit a PNG palette.
                        png = view.png8(gi, self.png_level)
                    if png is None:
                        fmt = view.wire_fmt(gi)
                        self.containers["rgb_host_labels" if host_labels else
                                        "rgb_overflow" if fmt == "v2" else f"rgb_{fmt}"] += 1
                        img = view.rgb(gi)
                        if host_labels:
                            # Host composite: batches without the label
                            # slab (the plain upload under osm_ids).
                            img = self.labeler.composite_labels(
                                img, entities, t, float(scale), self.styler)
                        png = rgb_to_png(img, self.png_level)
                    else:
                        self.containers["png8"] += 1
                    out[i] = png
            self._png_cache_put(t, scale, out[i])
            with self._perf_lock:
                perfstats.finish_tile(self.perf_stats)


async def run_server(
    address: str, service: TileService, batch_window_ms: float = 5.0, max_batch: int = 32,
) -> None:
    host, _, port_str = address.rpartition(":")
    shutdown_event = asyncio.Event()
    loop = asyncio.get_running_loop()
    batch_queue: asyncio.Queue = asyncio.Queue()

    async def batcher():
        while True:
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
            reqs = [(t, s) for (t, s, _) in items]
            try:
                pngs = await asyncio.to_thread(service.render_tiles_device, reqs)
                for (_, _, fut), png in zip(items, pngs):
                    if not fut.done():
                        fut.set_result(png)
            except Exception as e:  # handed to every waiting request
                for (_, _, fut) in items:
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
                await batch_queue.put((tile, scale, fut))
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
