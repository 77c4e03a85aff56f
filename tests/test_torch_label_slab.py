"""The port's device label slab (parallel/label_slab.py) and the labeled
arena entry (ops/render_cuda.render_arena_planar_labeled) on the CPU,
against the JAX package's.

Bars: both slabs, driven through one insert / evict / grow / clear
script, agree on offsets (LRU order included), free list, tail,
capacity and generation, and hold byte-identical planes; exhaustion
raises the same MemoryError.  `quantize_compact` and `blit_planar` are
byte-identical (integer math).  `expand_ltriples(ltriples(...))` equals
`lrow(...)` in both packages.  The torch blit over the JAX unlabeled
arena output is byte-identical to the JAX labeled entry (Pallas
interpret), and the port's labeled entry is within 1 per channel of it
with identical membership outside the label rows.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from osm_renderer_tpu.parallel import label_slab as JLS
from osm_renderer_tpu_torch.core.tile import Tile, coords_to_max_zoom_tile
from osm_renderer_tpu_torch.parallel import label_slab as LS

from tests.test_torch_helpers import STYLESHEET_DIR, port_mini_reader, port_styler


def _cpu(mod):
    """The port's slab takes its device explicitly (it defaults to the
    card); the JAX one uses jax's default device."""
    return {"device": "cpu"} if mod is LS else {}


def _random_compact(rng, ts: int):
    """A compact label layer with exact 0 and 1 alphas mixed in."""
    y0, x0 = rng.integers(0, ts - 16, 2)
    h, w = rng.integers(4, 16, 2)
    y1, x1 = min(ts, y0 + h), min(ts, x0 + w)
    alpha = rng.random((y1 - y0, x1 - x0, 1))
    alpha[rng.random(alpha.shape) < 0.25] = 0.0
    alpha[rng.random(alpha.shape) < 0.25] = 1.0
    rgb255 = alpha * rng.integers(0, 256, 3).astype(np.float64)
    return (int(y0), int(y1), int(x0), int(x1), rgb255, alpha)


def _state(s):
    return dict(offsets=list(s._offsets.items()), free=list(s._free), tail=s._tail,
                cap=s.cap, generation=s.generation)


def _same_plane(port, ref):
    assert port.plane.dtype == torch.int32
    np.testing.assert_array_equal(port.plane.numpy(), np.asarray(ref.plane))


def test_slab_script_matches_jax_slab():
    """One scripted sequence through both slabs (exact: allocation
    decisions, LRU order and plane bytes)."""
    ts = 32
    rng = np.random.default_rng(5)
    compacts = {i: _random_compact(rng, ts) for i in range(14)}
    port = LS.LabelSlab(ts, min_cap=8, max_tiles=6, device="cpu")
    ref = JLS.LabelSlab(ts, min_cap=8, max_tiles=6)
    script = [
        ("insert", (0, 1)),          # grows from 0 rows
        ("insert", (1, 2, 3, 2)),    # resident key touched, duplicate skipped
        ("free", (0, 2)),            # holes
        ("insert", (4,)),            # first fit into a hole or the tail
        ("insert", (5, 6, 7, 8)),    # max_tiles evicts LRU keys; growth
        ("offset", (5,)),            # touch: LRU order moves
        ("insert", (9, 10, 11)),
        ("free", (9, 10)),           # coalesce
        ("insert", (12, 13)),
        ("clear", ()),
        ("insert", (3, 0)),
    ]
    for op, keys in script:
        for slab in (port, ref):
            if op == "insert":
                slab.insert([((k,), compacts[k]) for k in keys])
            elif op == "free":
                for k in keys:
                    slab.free((k,))
            elif op == "offset":
                for k in keys:
                    slab.offset((k,))
            else:
                slab.clear()
        assert _state(port) == _state(ref), op
        _same_plane(port, ref)
    assert port.cap > 8 and port.generation == 1


def test_slab_exhaustion_raises_like_jax():
    ts = 32
    tall = (0, 7, 0, ts, np.zeros((7, ts, 3)), np.ones((7, ts, 1)))
    errors = []
    for mod in (LS, JLS):
        slab = mod.LabelSlab(ts, min_cap=8, **_cpu(mod))
        slab.MAX_CAP = 8
        slab.insert([(("a",), tall)])
        with pytest.raises(MemoryError) as pinned:
            slab._alloc_evicting(8, pinned={("a",)})
        with pytest.raises(MemoryError) as too_big:
            slab.insert([(("b",), tall), (("c",), tall)])
        errors.append((str(pinned.value), str(too_big.value), _state(slab)))
    assert errors[0] == errors[1]


def test_quantize_compact_matches_jax():
    rng = np.random.default_rng(9)
    for ts in (32, 256):
        for _ in range(4):
            c = _random_compact(rng, ts)
            got, y0 = LS.quantize_compact(c, ts)
            want, y0_want = JLS.quantize_compact(c, ts)
            assert y0 == y0_want and got.dtype == want.dtype
            assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("ts,T", [(32, 5), (256, 3), (512, 2)])
def test_blit_planar_byte_identical_to_jax(ts, T):
    """Random planes, random slab contents (any i32 value a quantized
    row can hold) and a row map mixing identity and slab rows."""
    rng = np.random.default_rng(ts + T)
    cap = 16
    planar = rng.integers(0, 256, (T, 4, ts, ts)).astype(np.uint8)
    c = rng.integers(0, 256, (cap, ts, 3)).astype(np.int32)
    plane = np.empty((cap, 2, ts), np.int32)
    plane[:, 0] = c[..., 0] | (c[..., 1] << 8) | (c[..., 2] << 16)
    plane[:, 1] = rng.integers(0, 65536, (cap, ts))
    plane[0, 0], plane[0, 1] = 0, LS.IDENTITY_A16P
    lrow = rng.integers(0, cap, (T, ts)).astype(np.int32)
    lrow[:, : ts // 4] = 0
    got = LS.blit_planar(torch.from_numpy(planar), torch.from_numpy(plane),
                         torch.from_numpy(lrow))
    want = np.asarray(JLS.blit_planar(jnp.asarray(planar), jnp.asarray(plane),
                                      jnp.asarray(lrow)))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    # Identity rows pass the base through exactly.
    np.testing.assert_array_equal(got.numpy()[:, :, : ts // 4], planar[:, :, : ts // 4])


@pytest.mark.parametrize("package", ["port", "jax"])
def test_expand_ltriples_equals_lrow(package):
    """The device row map from the compact triples equals the host
    oracle `lrow` for a batch mixing labeled and unlabeled tiles."""
    mod = LS if package == "port" else JLS
    ts, T = 64, 7
    rng = np.random.default_rng(13)
    slab = mod.LabelSlab(ts, min_cap=8, **_cpu(mod))
    keys = [("t", i) for i in range(5)]
    slab.insert([(k, _random_compact(rng, ts)) for k in keys])
    slab.free(keys[1])
    keyed = [(0, keys[0]), (2, keys[2]), (3, keys[3]), (6, keys[4])]  # tiles 1, 4, 5 unlabeled
    tri = slab.ltriples(T, keyed)
    want = slab.lrow(T, keyed)
    if package == "port":
        got = LS.expand_ltriples(torch.from_numpy(tri), ts).numpy()
    else:
        got = np.asarray(JLS.expand_ltriples(jnp.asarray(tri), ts))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert not got[[1, 4, 5]].any() and got[[0, 2, 3, 6]].any()


@pytest.fixture(scope="module")
def labeled_scene(tmp_path_factory):
    """Mini-fixture tiles z14-z17 (z14 carries no labels) with their
    compact label layers from the port's labeler."""
    from osm_renderer_tpu_torch.draw.labels.labeler import Labeler

    reader = port_mini_reader(tmp_path_factory.mktemp("slab"))
    styler = port_styler()
    t18 = coords_to_max_zoom_tile(47.1412, 9.5215)
    tiles = [Tile(z, t18.x >> (18 - z), t18.y >> (18 - z)) for z in range(14, 18)]
    te = [(reader.get_entities_in_tile_with_neighbors(t), t) for t in tiles]
    labeler = Labeler(icon_base_path=STYLESHEET_DIR)
    compacts = [labeler.ensure_layer(e, t, 1.0, styler, 256) for e, t in te]
    assert compacts[0] is None and all(c is not None for c in compacts[1:])
    return styler, te, compacts, labeler


def test_labeled_entry_matches_jax_interpret(labeled_scene, tmp_path):
    """Tolerances: the torch blit over the JAX unlabeled output is
    byte-identical to the JAX labeled entry; the port's labeled entry is
    within 1 per channel of it (the render twin's bar), with the same
    painted pixels outside the label rows.  The JAX side takes its own
    reader, styler and labeler's layers."""
    from osm_renderer_tpu.core.tile import Tile as JaxTile
    from osm_renderer_tpu.draw.labels.labeler import Labeler as JaxLabeler
    from osm_renderer_tpu.mapcss.parser import parse_file
    from osm_renderer_tpu.mapcss.styler import Styler
    from osm_renderer_tpu.ops.render_pallas import render_arena_planar_labeled as jax_labeled
    from osm_renderer_tpu.parallel.renderer import BatchRenderer as JaxRenderer
    from osm_renderer_tpu_torch.parallel.renderer import BatchRenderer
    from tests.fixtures import build_mini_reader

    styler, te, compacts, _ = labeled_scene
    jreader = build_mini_reader(tmp_path)
    jstyler = Styler(parse_file(STYLESHEET_DIR, "default.mapcss"), "josm")
    jte = [(jreader.get_entities_in_tile_with_neighbors(JaxTile(t.zoom, t.x, t.y)),
            JaxTile(t.zoom, t.x, t.y)) for _, t in te]
    jlabeler = JaxLabeler(icon_base_path=STYLESHEET_DIR)
    jcompacts = [jlabeler.ensure_layer(e, t, 1.0, jstyler, 256) for e, t in jte]
    ref = JaxRenderer(jstyler, backend="pallas", interpret=True, stylesheet_dir=STYLESHEET_DIR,
                      chunk_cache_tiles=16, arena=True)
    port = BatchRenderer(styler, stylesheet_dir=STYLESHEET_DIR, chunk_cache_tiles=16,
                         device="cpu", arena=True)
    jp = ref.prepare(jte, 1, label_layers=jcompacts)
    pp = port.prepare(te, 1, label_layers=compacts)
    assert pp.device_labeled == jp.device_labeled == (1, 2, 3)
    np.testing.assert_array_equal(pp.arena_packed, jp.arena_packed)
    np.testing.assert_array_equal(pp.label_rows, jp.label_rows)
    jslab, pslab = jp.label_ctx[0], pp.label_ctx[0]
    _same_plane(pslab, jslab)

    want = np.asarray(ref.render_prepared_planar(jp))
    # The JAX unlabeled output, from the same compiled entry with every
    # tile on the identity row (an exact passthrough).
    arena, prof, tot, pat, _ = jp.arena_ctx
    combined = np.concatenate([jp.arena_packed.reshape(-1),
                               np.zeros_like(jp.label_rows).reshape(-1)])
    base = np.array(jax_labeled(combined, arena, prof, tot, pat, jp.canvas_rgb, jp.ts,
                                jp.chunk, jp.arena_it, jslab.plane, True))
    lrow = LS.expand_ltriples(torch.from_numpy(jp.label_rows), jp.ts)
    blit = LS.blit_planar(torch.from_numpy(base), pslab.plane, lrow).numpy()
    np.testing.assert_array_equal(blit, want)
    assert not np.array_equal(base, want)

    got = port.render_prepared_planar(pp).numpy()
    assert port.batch_counts["labeled_tiles"] == 3
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    canvas = np.array([styler.canvas_fill_color.r, styler.canvas_fill_color.g,
                       styler.canvas_fill_color.b], np.uint8)[None, :, None, None]
    unlabeled_rows = (lrow.numpy() == 0)[:, :, None]
    painted_got = (got[:, :3] != canvas).any(axis=1)
    painted_want = (want[:, :3] != canvas).any(axis=1)
    np.testing.assert_array_equal(painted_got & unlabeled_rows, painted_want & unlabeled_rows)


def test_renderer_labels_match_host_composite(labeled_scene):
    """The port renderer's device-labeled tiles against its own unlabeled
    render plus `composite_labels`: unlabeled tiles and pixels outside each
    layer's bbox byte-identical, labeled pixels within 1/255, alpha = 1
    cores byte-identical.  A full slab is cleared and refilled; a stale
    slab generation raises."""
    from osm_renderer_tpu_torch.parallel.renderer import BatchRenderer

    styler, te, compacts, labeler = labeled_scene
    r = BatchRenderer(styler, stylesheet_dir=STYLESHEET_DIR, chunk_cache_tiles=16,
                      device="cpu", arena=True)
    base = r.render_prepared_planar(r.prepare(te, 1)).numpy()
    slab = r._label_slab(256)
    slab.min_cap = 8
    slab.MAX_CAP = sum(c[1] - c[0] for c in compacts if c is not None) + 1
    # 30 resident rows: the batch's first layer then cannot grow the slab
    # past MAX_CAP (MemoryError), and the renderer clears and refills it.
    slab.insert([(("other",), (0, 30, 0, 256, np.zeros((30, 256, 3)), np.ones((30, 256, 1))))])
    prep = r.prepare(te, 1, label_layers=compacts)
    assert slab.generation == 1 and ("other",) not in slab
    out = r.render_prepared_planar(prep).numpy()
    for i, ((e, t), c) in enumerate(zip(te, compacts)):
        b = np.ascontiguousarray(base[i, :3].transpose(1, 2, 0))
        g = np.ascontiguousarray(out[i, :3].transpose(1, 2, 0))
        if c is None:
            np.testing.assert_array_equal(g, b)
            continue
        want = labeler.composite_labels(b, e, t, 1.0, styler)
        assert np.abs(want.astype(int) - g.astype(int)).max() <= 1
        y0, y1, x0, x1, _, alpha = c
        outside = np.ones(b.shape[:2], bool)
        outside[y0:y1, x0:x1] = False
        np.testing.assert_array_equal(g[outside], want[outside])
        core = alpha[..., 0] >= 1.0
        np.testing.assert_array_equal(g[y0:y1, x0:x1][core], want[y0:y1, x0:x1][core])
    stale = r.prepare(te, 1, label_layers=compacts)
    slab.clear()
    with pytest.raises(ValueError, match="label slab reset"):
        r.render_prepared_planar(stale)


def test_labeled_entry_refuses_bad_rows(labeled_scene):
    from osm_renderer_tpu_torch.ops import render_cuda as RC
    from osm_renderer_tpu_torch.parallel.renderer import BatchRenderer

    styler, te, compacts, _ = labeled_scene
    r = BatchRenderer(styler, stylesheet_dir=STYLESHEET_DIR, chunk_cache_tiles=16,
                      device="cpu", arena=True)
    p = r.prepare(te, 1, label_layers=compacts)
    arena, prof, tot, pat, _ = p.arena_ctx
    plane = p.label_ctx[0].plane
    bad = p.label_rows.copy()
    bad[1, 1] = 250  # y0 + n runs past the tile
    for rows, pl in ((bad, plane), (p.label_rows[:2], plane), (p.label_rows, plane[:, :1])):
        with pytest.raises(RC.BatchLayoutError):
            RC.render_arena_planar_labeled(p.arena_packed, rows, arena, prof, tot, pat,
                                           p.canvas_rgb, p.ts, p.chunk, pl)
