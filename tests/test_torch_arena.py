"""The port's device chunk arena (parallel/arena.py), the packed upload
(ops/chunk_layout.pack_small_arena) and the arena render entry
(ops/render_cuda.render_arena_planar) on the CPU.

Bars: the port's ChunkArena and the JAX package's, driven through the
same insert / free / grow script, agree on offsets, free list, tail,
capacity and generation, and hold equal rows; pack_small_arena is
byte-identical to the original; the arena entry renders byte-identical
to the plain-upload entry (the render kernel's plain twin), through
eviction and re-insert, growth, tile-bucket padding and @2x.
"""

import numpy as np
import pytest
import torch

from osm_renderer_tpu.ops import render_pallas as RP
from osm_renderer_tpu.parallel.arena import ChunkArena as JaxArena
from osm_renderer_tpu_torch.core.tile import Tile, coords_to_max_zoom_tile
from osm_renderer_tpu_torch.draw import native_assembler as port_na
from osm_renderer_tpu_torch.draw import primitives as P
from osm_renderer_tpu_torch.ops import chunk_layout as CL
from osm_renderer_tpu_torch.parallel.arena import ChunkArena
from osm_renderer_tpu_torch.parallel.renderer import BatchRenderer

from tests.test_torch_helpers import STYLESHEET_DIR, port_mini_reader, port_styler


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    reader = port_mini_reader(tmp_path_factory.mktemp("arena"))
    styler = port_styler()
    t18 = coords_to_max_zoom_tile(47.1412, 9.5215)
    tiles = [Tile(z, t18.x >> (18 - z), t18.y >> (18 - z)) for z in range(13, 19)]
    te = [(reader.get_entities_in_tile_with_neighbors(t), t) for t in tiles]
    return styler, te


@pytest.fixture(scope="module")
def tile_chunks(scene):
    """[(key, TileChunks)] for every scene tile at 1x and 2x.  Both arenas
    below take these same numpy arrays."""
    from osm_renderer_tpu_torch.draw.labels.icons import IconCache

    styler, te = scene
    out = []
    for scale in (1, 2):
        profiles = P.ProfileTable()
        patterns = P.PatternTable(IconCache(STYLESHEET_DIR), 256 * scale)
        for ents, t in te:
            tc, _ = port_na.assemble_tile_chunks_native(
                ents, t, float(scale), styler, profiles, patterns, 256 * scale
            )
            out.append(((t.zoom, t.x, t.y, scale), tc))
    return out


def _state(a):
    return dict(offsets=dict(a._offsets), free=list(a._free), tail=a._tail, cap=a.cap,
                generation=a.generation)


def _assert_same_rows(port, jax_arena):
    assert port.cap == jax_arena.cap
    for name in ("geom", "trav", "sprof", "aux", "items"):
        want = np.asarray(getattr(jax_arena, name))
        got = getattr(port, name).numpy()
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want.reshape(got.shape), err_msg=name)


def test_arena_matches_jax_arena(tile_chunks):
    """One scripted insert / free / grow / clear sequence through both
    arenas: the same allocation decisions and the same rows."""
    port, ref = ChunkArena(min_cap=16, device="cpu"), JaxArena(min_cap=16)
    n = len(tile_chunks)
    script = [
        ("insert", range(0, 4)),        # grows from 0 rows, then doubles
        ("insert", range(2, 7)),        # duplicates skipped
        ("free", (1, 3)),               # two holes
        ("insert", (7,)),               # first fit into a hole or the tail
        ("free", (0, 2)),               # coalesces with the holes
        ("insert", range(8, n)),        # more growth
        ("insert", (1, 3, 0)),          # re-insert into recycled rows
        ("free", range(4, 9)),
        ("insert", range(4, 6)),
    ]
    for op, idx in script:
        for arena in (port, ref):
            if op == "insert":
                arena.insert([tile_chunks[i] for i in idx])
            else:
                for i in idx:
                    arena.free(tile_chunks[i][0])
        assert _state(port) == _state(ref), op
    assert port.cap > 16
    _assert_same_rows(port, ref)
    for key, _ in tile_chunks:
        if key in ref:
            assert port.offset(key) == ref.offset(key)
    port.clear()
    ref.clear()
    assert _state(port) == _state(ref)
    assert port.generation == 1 and not port._offsets


def test_arena_exhaustion_raises(tile_chunks):
    port, ref = ChunkArena(min_cap=16, device="cpu"), JaxArena(min_cap=16)
    for arena in (port, ref):
        arena.MAX_CAP = 32
        with pytest.raises(MemoryError):
            arena.insert(tile_chunks)


def test_pack_small_arena_byte_identical(tile_chunks):
    port = ChunkArena(min_cap=16, device="cpu")
    port.insert(tile_chunks)
    for scale in (1, 2):
        pairs = [(k, c) for k, c in tile_chunks if k[3] == scale]
        for sub in (pairs, pairs[:1], pairs[2:5]):
            chunks = [c for _, c in sub]
            offs = [port.offset(k) for k, _ in sub]
            got = CL.pack_small_arena(chunks, offs)
            want, _ = RP.pack_small_arena(chunks, offs)
            assert got.dtype == want.dtype and got.shape == want.shape
            assert got.tobytes() == want.tobytes()
    assert CL.N_SMALL == RP.N_SMALL


def _renderer(styler, **kw):
    kw.setdefault("chunk_cache_tiles", 16)
    return BatchRenderer(styler, stylesheet_dir=STYLESHEET_DIR, device="cpu", **kw)


def test_arena_entry_matches_plain_entry(scene):
    styler, te = scene
    plain = _renderer(styler)
    arena = _renderer(styler, arena=True)
    for scale in (1, 2):
        ref = plain.render_prepared_planar(plain.prepare(te, scale))
        prep = arena.prepare(te, scale)
        assert prep.batch is None and prep.arena_packed is not None
        assert np.array_equal(arena.render_prepared_planar(prep).numpy(), ref.numpy())
        # Warm: cache hits, no entities, one packed upload.
        warm = arena.prepare([(None, t) for _, t in te], scale)
        assert np.array_equal(arena.render_prepared_planar(warm).numpy(), ref.numpy())
    assert arena.batch_counts["arena"] == 4 and arena.batch_counts["plain"] == 0


def test_arena_eviction_reinsert_and_growth(scene):
    """A chunk cache of 2 over a 6-tile batch: every prepare evicts,
    frees arena rows and re-inserts into recycled rows.  A tiny first
    capacity forces growth."""
    styler, te = scene
    plain = _renderer(styler)
    ref = plain.render_prepared_planar(plain.prepare(te, 1)).numpy()
    small = _renderer(styler, chunk_cache_tiles=2, arena=True)
    small.chunk_arena.min_cap = 8
    for _ in range(3):
        got = small.render_prepared_planar(small.prepare(te, 1)).numpy()
        np.testing.assert_array_equal(got, ref)
    a = small.chunk_arena
    used = a._tail - 1 - sum(n for _, n in a._free)
    assert used == sum(a.offset(k)[1] for k in a._offsets)
    assert a.cap >= a._tail and a.cap > 8


def test_arena_tile_bucket_padding_and_generation_guard(scene):
    styler, te = scene
    plain = _renderer(styler, tile_bucket=True)
    bucketed = _renderer(styler, tile_bucket=True, arena=True)
    sub = te[:3]  # pads to 4 tiles
    ref = plain.render_prepared_planar(plain.prepare(sub, 1)).numpy()
    prep = bucketed.prepare(sub, 1)
    assert prep.chunk == 4
    np.testing.assert_array_equal(bucketed.render_prepared_planar(prep).numpy(), ref)
    bucketed.cache_clear()
    with pytest.raises(ValueError, match="arena reset"):
        bucketed.render_prepared_planar(prep)


def test_arena_exhaustion_takes_the_plain_upload(scene):
    """MemoryError from the arena clears it, and the batch takes the
    plain upload path with the same pixels."""
    styler, te = scene
    plain = _renderer(styler)
    ref = plain.render_prepared_planar(plain.prepare(te, 1)).numpy()
    tight = _renderer(styler, arena=True)
    tight.chunk_arena.MAX_CAP = 8
    tight.chunk_arena.min_cap = 8
    gen = tight.chunk_arena.generation
    prep = tight.prepare(te, 1)
    assert prep.batch is not None and prep.arena_packed is None
    assert tight.chunk_arena.generation == gen + 1
    np.testing.assert_array_equal(tight.render_prepared_planar(prep).numpy(), ref)


def test_arena_and_slab_default_to_the_card():
    """The device arena and the label slab run on CUDA unless the caller
    names the CPU: on a host without a usable card their defaults raise
    instead of falling back."""
    from osm_renderer_tpu_torch.parallel.label_slab import LabelSlab

    assert ChunkArena(min_cap=16, device="cpu").device == torch.device("cpu")
    assert LabelSlab(32, min_cap=8, device="cpu").device == torch.device("cpu")
    if torch.cuda.is_available():
        pytest.skip("this host has a usable CUDA device")
    with pytest.raises(RuntimeError):
        ChunkArena(min_cap=16)
    with pytest.raises(RuntimeError):
        LabelSlab(32, min_cap=8)
