"""The port's serving state under cache and arena pressure, on the CPU.

Counterpart of `tests/test_scale_pressure.py` (marked slow there: its
renders run the Pallas kernel in interpret mode) on the port's plain
twin: ~80 mixed z14/z15/z16 tiles of the 24-block synthetic city in
shuffled batches of 6, an 8-tile chunk cache, a 256-row arena, cold
sub-batches of 4 and a cache reset mid-sweep.

Bars: the port's pressured `BatchRenderer.prepare` sequence equals the
JAX package's (arena offsets, free list, tail, capacity, generation,
the batch's item width and the packed upload, after every batch); the
pressured service leaks no arena row, keeps the arena bounded and its
free list short, and serves the pixels of an unpressured control, each
tile within 1/255 of `CpuDrawer`; with a `MAX_BATCH_CHUNKS` that every
sub-batch overflows and no tile alone does, the server halves and
serves the same pixels; `scale_sweep.sweep_corpus` takes the JAX tool's
tiles.
"""

import io
import os

import numpy as np
import pytest

from osm_renderer_tpu.core.tile import Tile as JaxTile
from osm_renderer_tpu.geodata.importer import import_osm as jax_import_osm
from osm_renderer_tpu.geodata.reader import GeodataReader as JaxReader
from osm_renderer_tpu.mapcss.parser import parse_file as jax_parse_file
from osm_renderer_tpu.mapcss.styler import Styler as JaxStyler
from osm_renderer_tpu.parallel.arena import ChunkArena as JaxArena
from osm_renderer_tpu.parallel.renderer import BatchRenderer as JaxBatchRenderer
from osm_renderer_tpu_torch.core.tile import Tile
from osm_renderer_tpu_torch.draw.drawer import CpuDrawer
from osm_renderer_tpu_torch.geodata.importer import import_osm
from osm_renderer_tpu_torch.geodata.reader import GeodataReader
from osm_renderer_tpu_torch.parallel.arena import ChunkArena
from osm_renderer_tpu_torch.parallel.renderer import BatchRenderer
from osm_renderer_tpu_torch.server.http import TileService
from osm_renderer_tpu_torch.tools import scale_sweep

from tests.test_torch_helpers import (
    STYLESHEET_DIR,
    make_minicity_osm,
    port_styler,
    torch_threads,
)

BATCH = 6
COLD_SUB = 4
CACHE_TILES = 8
ARENA_ROWS = 256
CLEAR_AT = 3 * BATCH  # the batch start at which the cache is reset


@pytest.fixture(scope="module")
def city(tmp_path_factory):
    """The 24-block city imported by each package -> (port .bin, JAX .bin)."""
    d = tmp_path_factory.mktemp("pressure")
    osm = make_minicity_osm(d, blocks=24)
    port_bin, jax_bin = os.path.join(str(d), "port.bin"), os.path.join(str(d), "jax.bin")
    import_osm(osm, port_bin)
    jax_import_osm(osm, jax_bin)
    return port_bin, jax_bin


def _corpus(reader, tile_cls):
    """The JAX test's tiles: every z14 tile, a spread of z15 and z16, in a
    seeded shuffle."""
    tiles = []
    for zoom, cap in ((14, 99), (15, 24), (16, 24)):
        sh = 18 - zoom
        zt = sorted(set(zip((reader.tiles["x"] >> sh).tolist(),
                            (reader.tiles["y"] >> sh).tolist())))
        tiles += [tile_cls(zoom, x, y) for x, y in zt[:: max(1, len(zt) // cap)][:cap]]
    order = np.random.default_rng(0).permutation(len(tiles))
    return [tiles[i] for i in order]


@pytest.fixture(scope="module")
def tiles(city):
    return _corpus(GeodataReader.load(city[0]), Tile)


def _sub_batches(renderer, batch):
    """The server's cold streaming (`render_tiles_device`): a group with
    more than COLD_SUB / 2 uncached tiles goes in COLD_SUB-tile
    sub-batches."""
    uncached = sum(not renderer.has_cached_chunks(t, 1) for t in batch)
    if len(batch) > COLD_SUB and 2 * uncached > COLD_SUB:
        return [batch[i: i + COLD_SUB] for i in range(0, len(batch), COLD_SUB)]
    return [batch]


def _state(a):
    return dict(offsets=dict(a._offsets), free=list(a._free), tail=a._tail, cap=a.cap,
                generation=a.generation)


def test_pressured_prepare_sequence_equals_the_jax_package(city, tiles, monkeypatch):
    """Both packages' renderers, each from its own reader and styler, take
    the pressured sequence of prepares; after every one their arenas,
    item widths and packed uploads are equal.  The port keeps no item
    width (its kernel reads IT_ARENA-wide rows), so its side is the JAX
    bucketing over the chunks the port packed."""
    port_bin, jax_bin = city
    port_reader, jax_reader = GeodataReader.load(port_bin), JaxReader.load(jax_bin)
    port = BatchRenderer(port_styler(), stylesheet_dir=STYLESHEET_DIR, tile_bucket=True,
                         chunk_cache_tiles=CACHE_TILES, arena=True, device="cpu")
    port.chunk_arena = ChunkArena(min_cap=ARENA_ROWS, device="cpu")
    ref = JaxBatchRenderer(JaxStyler(jax_parse_file(STYLESHEET_DIR, "default.mapcss"), "josm"),
                           backend="pallas", interpret=True, stylesheet_dir=STYLESHEET_DIR,
                           tile_bucket=True, chunk_cache_tiles=CACHE_TILES, arena=True)
    ref.chunk_arena = JaxArena(min_cap=ARENA_ROWS)

    packed_chunks = []
    real_finalize = BatchRenderer._finalize_arena

    def spy(self, tile_chunks, *args, **kwargs):
        packed_chunks.append(list(tile_chunks))
        return real_finalize(self, tile_chunks, *args, **kwargs)

    monkeypatch.setattr(BatchRenderer, "_finalize_arena", spy)
    n_prepares = 0
    with torch_threads(1):
        for start in range(0, len(tiles), BATCH):
            for sub in _sub_batches(port, tiles[start: start + BATCH]):
                jsub = [JaxTile(t.zoom, t.x, t.y) for t in sub]
                assert [port.has_cached_chunks(t, 1) for t in sub] == \
                    [ref.has_cached_chunks(t, 1) for t in jsub]
                got = port.prepare([(port_reader.get_entities_in_tile_with_neighbors(t), t)
                                    for t in sub])
                want = ref.prepare([(jax_reader.get_entities_in_tile_with_neighbors(t), t)
                                    for t in jsub])
                assert _state(port.chunk_arena) == _state(ref.chunk_arena), sub
                assert (got.arena_packed is None) == (want.arena_packed is None)
                if got.arena_packed is not None:
                    it = max(c.items.shape[2] for c in packed_chunks[-1])
                    assert max(256, 1 << (it - 1).bit_length()) == want.arena_it
                    assert got.arena_packed.tobytes() == np.asarray(want.arena_packed).tobytes()
                n_prepares += 1
            if start == CLEAR_AT:
                port.cache_clear()
                ref.cache_clear()
    arena = port.chunk_arena
    assert n_prepares > len(tiles) // BATCH and arena.generation == 1
    # Every tile but those resident at the reset and at the end was evicted.
    assert port.evictions >= len(tiles) - 2 * CACHE_TILES, port.evictions


def _decode(png: bytes) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(png)).convert("RGB"))


def _service(binf, cache_tiles: int, arena_rows: int) -> TileService:
    svc = TileService(binf, port_styler(), STYLESHEET_DIR, backend="device", device="cpu",
                      enable_labels=False)
    r = svc.batch_renderer
    r.chunk_cache_tiles = cache_tiles
    if arena_rows:
        r.chunk_arena = ChunkArena(min_cap=arena_rows, device="cpu")
    return svc


def _serve(svc, tiles, batch: int, clear_at=None):
    got = {}
    for start in range(0, len(tiles), batch):
        group = tiles[start: start + batch]
        for t, p in zip(group, svc.render_tiles_device([(t, 1) for t in group])):
            got[t] = _decode(p)
        if start == clear_at:
            # Mid-sweep invalidation: the generation guard must keep
            # in-flight state coherent across a full cache reset.
            svc.batch_renderer.cache_clear()
    return got


@pytest.fixture(scope="module")
def control(city, tiles):
    """The unpressured service's pixels: a 4096-tile cache, the default
    arena, groups of 16."""
    with torch_threads(1):
        return _serve(_service(city[0], 4096, 0), tiles, 16)


def _pressured(binf, tiles, max_batch_chunks=None):
    svc = _service(binf, CACHE_TILES, ARENA_ROWS)
    svc.COLD_SUB = COLD_SUB
    if max_batch_chunks is not None:
        svc.batch_renderer.MAX_BATCH_CHUNKS = max_batch_chunks
    with torch_threads(1):
        got = _serve(svc, tiles, BATCH, clear_at=CLEAR_AT)
    return svc, got


def _assert_arena_bounded(svc):
    arena = svc.batch_renderer.chunk_arena
    live = sum(n for _, n in arena._offsets.values())
    free = sum(n for _, n in arena._free)
    # No leak: every allocated row is either live or on the free list.
    assert live + free == arena._tail - 1, (live, free, arena._tail)
    # Eviction bounded the arena instead of letting it grow per request.
    assert len(arena._offsets) <= CACHE_TILES + 1
    assert arena.cap <= 1024, arena.cap
    # Coalescing keeps the free list far shorter than the evictions.
    assert len(arena._free) < 24, len(arena._free)
    assert svc.batch_renderer.evictions > 24


def test_pressured_service_serves_the_unpressured_pixels(city, tiles, control):
    svc, got = _pressured(city[0], tiles)
    _assert_arena_bounded(svc)
    assert svc.tiles_served == {"device": len(tiles)}
    assert svc.batch_renderer.batch_counts["arena"] > 0
    for t in tiles:
        np.testing.assert_array_equal(got[t], control[t], err_msg=str(t))
    # Every tile within 1/255 of the C++ oracle (labels off).
    reader, styler = GeodataReader.load(city[0]), port_styler()
    cpu = CpuDrawer(stylesheet_dir=STYLESHEET_DIR)
    for t in tiles:
        want = cpu.draw_to_pixels(reader.get_entities_in_tile_with_neighbors(t), t, 1, styler)
        assert int(np.abs(want.astype(int) - got[t].astype(int)).max()) <= 1, t


def test_pressured_halving_serves_the_unpressured_pixels(city, tiles, control):
    """A MAX_BATCH_CHUNKS that every sub-batch of two or more of the
    densest tiles overflows, and no tile alone (with its bucket's three
    empty tiles): the server halves under pressure, sends no tile to the
    oracle, and serves the control's pixels."""
    from osm_renderer_tpu_torch.draw import native_assembler as na
    from osm_renderer_tpu_torch.draw import primitives as P
    from osm_renderer_tpu_torch.draw.labels.icons import IconCache
    from osm_renderer_tpu_torch.ops import chunk_layout as L

    reader, styler = GeodataReader.load(city[0]), port_styler()
    profiles, patterns = P.ProfileTable(), P.PatternTable(IconCache(STYLESHEET_DIR), 256)
    sizes = sorted(
        na.assemble_tile_chunks_native(reader.get_entities_in_tile_with_neighbors(t), t, 1.0,
                                       styler, profiles, patterns, 256)[0].kind.shape[0]
        for t in tiles)
    empty = L.build_tile_chunks(P.TileStream(), 256).kind.shape[0]
    bound = sizes[-1] + 3 * empty  # the densest tile in a bucket of 4
    assert sizes[-1] + sizes[-2] > bound
    svc, got = _pressured(city[0], tiles, max_batch_chunks=bound)
    _assert_arena_bounded(svc)
    assert svc.halvings > 0
    assert svc.tiles_served == {"device": len(tiles)}
    for t in tiles:
        np.testing.assert_array_equal(got[t], control[t], err_msg=str(t))


def test_sweep_corpus_takes_the_jax_tools_tiles(city):
    """`sweep_corpus` on the port's reader against the JAX tool's rule
    (tools/scale_sweep.py), written out here and run on the JAX
    package's reader of the same city."""
    jax_reader = JaxReader.load(city[1])
    want, want_zoom = [], {}
    for zoom in (12, 13, 14, 15, 16, 17):
        sh = 18 - zoom
        zt = sorted(set(zip((jax_reader.tiles["x"] >> sh).tolist(),
                            (jax_reader.tiles["y"] >> sh).tolist())))
        cap = {12: 16, 13: 32, 14: 128, 16: 128, 17: 128}.get(zoom)
        if cap and len(zt) > cap:
            step = len(zt) // cap
            zt = zt[::step][:cap]
        want_zoom[zoom] = len(zt)
        want += [(zoom, x, y) for x, y in zt]
    got, per_zoom = scale_sweep.sweep_corpus(GeodataReader.load(city[0]))
    assert [(t.zoom, t.x, t.y) for t in got] == want
    assert per_zoom == want_zoom
    assert want_zoom[17] == 128  # a capped zoom: the stride rule ran


@pytest.mark.parametrize("case", ["earlier_sub_batch", "same_batch"])
def test_tiles_evicted_within_their_group_render_on_the_device(city, case):
    """A tile whose chunks were cached when its group began, and which is
    evicted before its own prepare (by an earlier sub-batch of the group,
    or by the inserts of its own batch), still renders on the device:
    the server fetches its entities again instead of sending its whole
    (sub-)batch to the oracle."""
    reader = GeodataReader.load(city[0])
    z16 = sorted(set(zip((reader.tiles["x"] >> 2).tolist(), (reader.tiles["y"] >> 2).tolist())))
    old = [Tile(16, x, y) for x, y in z16[:CACHE_TILES]]
    new = [Tile(16, x, y) for x, y in z16[CACHE_TILES: 2 * CACHE_TILES]]
    # earlier_sub_batch: 8 new tiles stream first (2 x COLD_SUB) and evict
    # the 4 oldest, which come last.  same_batch: one new tile's insert
    # evicts the oldest cached tile of the same 2-tile batch.
    group = new + old[:COLD_SUB] if case == "earlier_sub_batch" else new[:1] + old[:1]
    svc, control = _service(city[0], CACHE_TILES, 0), _service(city[0], 4096, 0)
    svc.COLD_SUB = COLD_SUB
    with torch_threads(1):
        svc.render_tiles_device([(t, 1) for t in old])
        assert all(svc.batch_renderer.has_cached_chunks(t, 1) for t in old)
        got = svc.render_tiles_device([(t, 1) for t in group])
        want = control.render_tiles_device([(t, 1) for t in group])
    assert svc.tiles_served == {"device": len(old) + len(group)}
    for t, a, b in zip(group, got, want):
        np.testing.assert_array_equal(_decode(a), _decode(b), err_msg=str(t))
