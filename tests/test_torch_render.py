"""The CUDA render kernel's plain PyTorch twin (ops/render_cuda.py) on
the CPU, held to the Pallas kernel in interpret mode and to the C++
oracle on the same host-built PallasBatch.

Bars: against Pallas interpret, max |diff| <= 1 per channel with the
same set of painted pixels (the twin evaluates Pallas' bf16-matmul
predicates directly; f32 roundings may differ by one u8 step at
truncation boundaries, never in membership).  Against the oracle, the
test_pallas.py bars: <= 1/255 with its per-scene mismatch fractions.
A fraction of 1.0 marks the scenes where test_pallas.py bounds only the
maximum.  The kernel itself is held to the twin on the card by
chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from osm_renderer_tpu.draw import primitives as JP
from osm_renderer_tpu.ops import render_pallas as RP
from osm_renderer_tpu_torch.draw import primitives as P
from osm_renderer_tpu_torch.ops import chunk_layout as CL
from osm_renderer_tpu_torch.ops.coverage_np import LINE_CAP_BUTT, LINE_CAP_ROUND, LINE_CAP_SQUARE
from osm_renderer_tpu_torch.ops import render_cuda as RC
from osm_renderer_tpu_torch.parallel.renderer import PreparedBatch, pad_batch_to

from tests.test_coverage_parity import CANVAS, make_polygon, make_polyline, oracle_render, rand_color


def _stroke(prim, pairs, w, c, dashes, cap, op=1.0):
    o = {"kind": "stroke", "pairs": pairs, "color": c, "opacity": op, "width": w,
         "dashes": dashes, "cap": cap, "use_caps_for_dashes": True}
    return o, prim.make_stroke_prim(pairs, w, c, op, dashes, cap, True)


def _fill(prim, edges, c, op):
    return ({"kind": "fill", "edges": edges, "color": c, "opacity": op},
            prim.FillPrim(kind="fill", color=c, opacity=op, edges=edges))


def _scene(pairs_list):
    oracle, dev = zip(*pairs_list)
    return list(oracle), list(dev)


# Scene builders (the tests/test_pallas.py scenes).  Each returns
# (oracle prims, device prims, ts, packed); the device prims are built by
# `prim`, the port's primitives module unless the JAX package's is given.

def scene_mixed(prim=P):
    rng = np.random.default_rng(5)
    items = [_fill(prim, make_polygon(rng), rand_color(rng), 0.9) for _ in range(4)]
    for _ in range(4):
        pairs = make_polyline(rng)
        c = rand_color(rng)
        cap = int(rng.choice([LINE_CAP_BUTT, LINE_CAP_ROUND, LINE_CAP_SQUARE]))
        dashes = [6.0, 3.0] if rng.integers(0, 2) else None
        w = float(rng.choice([1.0, 3.0, 6.5]))
        items.append(_stroke(prim, pairs, w, c, dashes, cap))
    return (*_scene(items), 256, False)


def scene_round_capped_dash(prim=P):
    """Round-capped dashes: per-segment KIND_STROKE with the walk chain."""
    items = [
        _stroke(prim, np.array([[111, 202], [219, 34]]).reshape(1, 4), 6.0, (200, 10, 10),
                [12.0, 6.0], LINE_CAP_ROUND),
        _stroke(prim, np.array([[20, 30, 240, 60], [240, 60, 180, 230]]), 3.0, (20, 90, 200),
                [6.0, 3.0], LINE_CAP_ROUND),
    ]
    return (*_scene(items), 256, True)


def scene_row_blocks(prim=P):
    edges = np.array([[10, 31, 250, 31], [250, 31, 250, 97], [250, 97, 10, 97],
                      [10, 97, 10, 31]], dtype=np.int64)
    items = [_fill(prim, edges, (40, 90, 160), 1.0),
             _stroke(prim, np.array([[0, 64, 255, 64], [255, 64, 255, 255]]), 7.0, (200, 30, 30),
                     None, LINE_CAP_ROUND, 0.8)]
    return (*_scene(items), 256, False)


def scene_packed(prim=P):
    rng = np.random.default_rng(21)
    items = [_fill(prim, make_polygon(rng), (217, 208, 201), 1.0) for _ in range(30)]
    items += [_stroke(prim, make_polyline(rng), 3.0, (255, 255, 255), None, LINE_CAP_BUTT)
              for _ in range(12)]
    return (*_scene(items), 256, True)


def scene_2x(prim=P):
    rng = np.random.default_rng(17)
    items = [_fill(prim, (make_polygon(rng) * 2).astype(np.int64), rand_color(rng), 1.0)
             for _ in range(3)]
    items += [_stroke(prim, (make_polyline(rng) * 2).astype(np.int64), 6.0, rand_color(rng),
                      [12.0, 6.0], LINE_CAP_ROUND) for _ in range(3)]
    return (*_scene(items), 512, True)


def scene_fuzz(seed, prim=P):
    rng = np.random.default_rng(seed)
    dash_choices = [None, [6.0, 3.0], [2.0, 2.0], [10.0, 4.0, 2.0, 4.0]]
    items = []
    for _ in range(int(rng.integers(3, 8))):
        edges = make_polygon(rng)
        c = rand_color(rng)
        items.append(_fill(prim, edges, c, float(rng.choice([1.0, 0.7]))))
    for _ in range(int(rng.integers(3, 8))):
        pairs = make_polyline(rng)
        c = rand_color(rng)
        cap = int(rng.choice([LINE_CAP_BUTT, LINE_CAP_ROUND, LINE_CAP_SQUARE]))
        dashes = dash_choices[int(rng.integers(0, len(dash_choices)))]
        w = float(rng.choice([0.5, 1.0, 2.4, 3.0, 6.5, 11.0]))
        items.append(_stroke(prim, pairs, w, c, dashes, cap))
    return (*_scene(items), 256, True)


def scene_4x_strokes(prim=P):
    """ts = 1024 (@4x): every stroke takes the per-segment path."""
    rng = np.random.default_rng(41)
    items = [_fill(prim, (make_polygon(rng) * 4).astype(np.int64), rand_color(rng), 1.0)]
    items += [_stroke(prim, (make_polyline(rng) * 4).astype(np.int64), w, rand_color(rng), d, cap)
              for w, d, cap in ((8.0, None, LINE_CAP_BUTT), (12.0, [24.0, 12.0], LINE_CAP_ROUND),
                                (4.0, [8.0, 8.0], LINE_CAP_SQUARE))]
    return (*_scene(items), 1024, True)


def host_batch(prims_dev, ts, packed=True, patterns=None):
    profiles = P.ProfileTable()
    stream = (P.stream_tile_packed(prims_dev, profiles, CL.CH, patterns, size=ts)
              if packed else P.stream_tile(prims_dev, profiles, CL.CH))
    return CL.build_pallas_batch([stream], profiles, ts, patterns)


def twin_rgb(pb, ts, n_tiles=None):
    canvas = np.array([c / 255.0 for c in CANVAS], np.float32)
    b, c = RC.from_numpy_batch(pb, canvas, "cpu", n_tiles)
    return CL.planar_to_rgb(RC.render_batch_planar(b, c, ts).numpy())


def painted(rgb):
    return (rgb != np.array(CANVAS, np.uint8)).any(axis=-1)


@pytest.mark.parametrize("scene", [scene_mixed, scene_round_capped_dash])
def test_twin_matches_pallas_interpret(scene):
    _, prims_dev, ts, packed = scene()
    pb = host_batch(prims_dev, ts, packed)
    if scene is scene_round_capped_dash:
        assert CL.KIND_STROKE in pb.kind.tolist()
    got = twin_rgb(pb, ts)[0]
    _, prims_jax, _, _ = scene(JP)
    jprofiles = JP.ProfileTable()
    jstream = (JP.stream_tile_packed(prims_jax, jprofiles, RP.CH, None, size=ts)
               if packed else JP.stream_tile(prims_jax, jprofiles, RP.CH))
    pbj = RP.PallasBatch(*(jnp.asarray(x) for x in RP.build_pallas_batch([jstream], jprofiles,
                                                                         ts, None)))
    canvas = jnp.array([c / 255.0 for c in CANVAS], dtype=jnp.float32)
    want = np.asarray(RP.render_batch_pallas(pbj, canvas, ts, 1, True))[0]
    diff = np.abs(want.astype(int) - got.astype(int))
    assert diff.max() <= 1
    np.testing.assert_array_equal(painted(got), painted(want))


@pytest.mark.parametrize(
    "scene,frac",
    [(scene_mixed, 1e-3), (scene_round_capped_dash, 1.0), (scene_row_blocks, 1.0),
     (scene_packed, 1.0), (scene_2x, 2e-3), (lambda: scene_fuzz(3), 2e-3),
     (lambda: scene_fuzz(11), 2e-3), (lambda: scene_fuzz(29), 2e-3),
     (scene_4x_strokes, 2e-3)],
    ids=["mixed", "round_capped_dash", "row_blocks", "packed", "2x", "fuzz3", "fuzz11",
         "fuzz29", "4x_strokes"],
)
def test_twin_matches_oracle(scene, frac):
    prims_oracle, prims_dev, ts, packed = scene()
    want = oracle_render(prims_oracle, ts_scale=ts // 256)
    got = twin_rgb(host_batch(prims_dev, ts, packed), ts)[0]
    diff = np.abs(want.astype(int) - got.astype(int))
    assert got.shape == (ts, ts, 3)
    assert diff.max() <= 1
    assert (diff > 0).mean() < frac


def _icon(tmp_path, seed, shape, lo):
    """-> (rng, the port's icon cache for the twin, the JAX package's
    icon for the oracle)."""
    from PIL import Image

    from osm_renderer_tpu.draw.labels.icons import IconCache as JaxIconCache
    from osm_renderer_tpu_torch.draw.labels.icons import IconCache

    rng = np.random.default_rng(seed)
    px = rng.integers(0, 256, size=shape + (4,), dtype=np.uint8)
    px[..., 3] = rng.integers(lo, 256, size=shape, dtype=np.uint8)
    Image.fromarray(px, "RGBA").save(tmp_path / "pat.png")
    return rng, IconCache(str(tmp_path)), JaxIconCache(str(tmp_path)).get("pat.png")


def test_twin_icon_fill_matches_oracle(tmp_path):
    """KIND_FILL_IMAGE: premultiplied icon pattern under the fill mask."""
    from osm_renderer_tpu.draw.oracle import OracleTile

    rng, cache, icon = _icon(tmp_path, 7, (10, 12), 60)
    polys = [make_polygon(rng) for _ in range(3)]
    stroke_pairs = make_polyline(rng)
    tile = OracleTile(1)
    tile.reset(CANVAS)
    tile.fill_contour(polys[0], (60, 120, 60), 0.8)
    tile.bump_generation()
    tile.fill_contour_icon(polys[1], icon.rgba)
    tile.bump_generation()
    tile.draw_lines(stroke_pairs, 3.0, (255, 255, 255), 1.0, None, LINE_CAP_BUTT, True)
    tile.bump_generation()
    tile.fill_contour_icon(polys[2], icon.rgba)
    tile.bump_generation()
    tile.blend_unfinished(False)
    tile.blend_unfinished(True)
    want = tile.to_rgb()
    prims = [
        P.FillPrim(kind="fill", color=(60, 120, 60), opacity=0.8, edges=polys[0]),
        P.FillPrim(kind="fill", color=None, opacity=1.0, edges=polys[1], fill_image="pat.png"),
        P.make_stroke_prim(stroke_pairs, 3.0, (255, 255, 255), 1.0, None, LINE_CAP_BUTT, True),
        P.FillPrim(kind="fill", color=None, opacity=1.0, edges=polys[2], fill_image="pat.png"),
    ]
    pb = host_batch(prims, 256, True, P.PatternTable(cache, 256))
    assert CL.KIND_FILL_IMAGE in pb.kind.tolist()
    diff = np.abs(want.astype(int) - twin_rgb(pb, 256)[0].astype(int))
    assert diff.max() <= 1
    assert (diff > 0).mean() < 5e-3


def test_twin_oversize_fill_matches_oracle(tmp_path):
    """Fills of more than CH edges split into several span chunks."""
    from osm_renderer_tpu.draw.oracle import OracleTile

    def big_star(cx, cy, n, r_out, r_in):
        ang = np.linspace(0, 2 * np.pi, 2 * n, endpoint=False)
        r = np.where(np.arange(2 * n) % 2 == 0, r_out, r_in)
        pts = np.stack([np.round(cx + r * np.cos(ang)), np.round(cy + r * np.sin(ang))], 1)
        pts = np.concatenate([pts, pts[:1]], 0).astype(np.int64)
        return np.concatenate([pts[:-1], pts[1:]], axis=1)

    rng, cache, icon = _icon(tmp_path, 13, (8, 9), 120)
    star_a, star_b, small = big_star(90, 110, 100, 85, 40), big_star(180, 170, 80, 70, 30), \
        make_polygon(rng)
    tile = OracleTile(1)
    tile.reset(CANVAS)
    tile.fill_contour(star_a, (50, 90, 180), 0.75)
    tile.bump_generation()
    tile.fill_contour(small, (200, 60, 60), 1.0)
    tile.bump_generation()
    tile.fill_contour_icon(star_b, icon.rgba)
    tile.bump_generation()
    tile.blend_unfinished(False)
    tile.blend_unfinished(True)
    want = tile.to_rgb()
    prims = [
        P.FillPrim(kind="fill", color=(50, 90, 180), opacity=0.75, edges=star_a),
        P.FillPrim(kind="fill", color=(200, 60, 60), opacity=1.0, edges=small),
        P.FillPrim(kind="fill", color=None, opacity=1.0, edges=star_b, fill_image="pat.png"),
    ]
    pb = host_batch(prims, 256, True, P.PatternTable(cache, 256))
    assert pb.kind.tolist().count(CL.KIND_FILL) >= 2
    diff = np.abs(want.astype(int) - twin_rgb(pb, 256)[0].astype(int))
    assert diff.max() <= 1
    assert (diff > 0).mean() < 5e-3


def test_twin_out_of_bound_layers_match_oracle():
    """Out-of-bound prims arrive as host-rasterized KIND_LAYER chunks."""
    from osm_renderer_tpu.draw.oracle import OracleTile

    far = 5 * P.FAST_COORD_BOUND
    tri = np.array([[-far, -100, 200, 90], [200, 90, 120, far], [120, far, -far, -100]],
                   dtype=np.int64)
    pairs = np.array([[-far, 60, far, 180]], dtype=np.int64)
    small = make_polygon(np.random.default_rng(3))
    tile = OracleTile(1)
    tile.reset(CANVAS)
    tile.fill_contour(tri, (70, 130, 70), 0.9)
    tile.bump_generation()
    tile.draw_lines(pairs, 5.0, (250, 250, 240), 1.0, [8.0, 4.0], LINE_CAP_ROUND, True)
    tile.bump_generation()
    tile.fill_contour(small, (180, 40, 40), 1.0)
    tile.bump_generation()
    tile.blend_unfinished(False)
    tile.blend_unfinished(True)
    want = tile.to_rgb()
    prims = [
        P.FillPrim(kind="fill", color=(70, 130, 70), opacity=0.9, edges=tri),
        P.make_stroke_prim(pairs, 5.0, (250, 250, 240), 1.0, [8.0, 4.0], LINE_CAP_ROUND, True),
        P.FillPrim(kind="fill", color=(180, 40, 40), opacity=1.0, edges=small),
    ]
    pb = host_batch(prims, 256, True, P.PatternTable(None, 256))
    assert pb.kind.tolist().count(CL.KIND_LAYER) == 2
    diff = np.abs(want.astype(int) - twin_rgb(pb, 256)[0].astype(int))
    assert diff.max() <= 1
    assert (diff > 0).mean() < 5e-3


def test_multi_tile_batch_equals_solo_renders():
    """Tiles of one batch render exactly as they do alone (the kernel
    walks each tile's own chunk range)."""
    scenes = [scene_fuzz(3), scene_fuzz(11), scene_row_blocks()]
    profiles = P.ProfileTable()
    streams = [P.stream_tile_packed(dev, profiles, CL.CH) for _, dev, _, _ in scenes]
    batch = twin_rgb(CL.build_pallas_batch(streams, profiles, 256), 256)
    assert batch.shape[0] == 3
    for i, (_, dev, ts, _) in enumerate(scenes):
        np.testing.assert_array_equal(batch[i], twin_rgb(host_batch(dev, ts), ts)[0])


def test_pad_batch_to_adds_canvas_tiles():
    _, dev, ts, _ = scene_fuzz(29)
    pb = host_batch(dev, ts)
    b, canvas = RC.from_numpy_batch(pb, np.array(CANVAS, np.float32) / 255.0, "cpu")
    prep = pad_batch_to(4, PreparedBatch(b, canvas, ts, 1))
    assert prep.chunk == 4 and prep.batch.tile_range.shape[0] == 4
    out = CL.planar_to_rgb(RC.render_batch_planar(prep.batch, prep.canvas_rgb, ts).numpy())
    np.testing.assert_array_equal(out[0], twin_rgb(pb, ts)[0])
    for i in (1, 2, 3):
        assert not painted(out[i]).any()


def test_wrapper_checks_inputs_and_counts_only_kernel_launches():
    _, dev, ts, _ = scene_row_blocks()
    b, canvas = RC.from_numpy_batch(host_batch(dev, ts), np.zeros(3, np.float32), "cpu")
    before = RC.RENDER_KERNEL_LAUNCHES
    RC.render_batch_planar(b, canvas, ts)
    assert RC.RENDER_KERNEL_LAUNCHES == before  # CPU tensors: the twin, no launch
    bad = [
        b._replace(geom=b.geom.to(torch.int64)),
        b._replace(aux=b.aux.transpose(1, 2).contiguous().transpose(1, 2)),
        b._replace(isec=b.isec[:, :4].contiguous()),
        b._replace(trav=b.trav.to("meta")),
    ]
    for case in bad:
        with pytest.raises(RC.BatchLayoutError):
            RC.render_batch_planar(case, canvas, ts)
    with pytest.raises(RC.BatchLayoutError):
        RC.render_batch_planar(b, canvas, 300)


def test_from_numpy_batch_tile_ranges():
    profiles = P.ProfileTable()
    streams = [P.stream_tile_packed(dev, profiles, CL.CH)
               for _, dev, _, _ in (scene_fuzz(3), scene_row_blocks())]
    pb = CL.build_pallas_batch(streams, profiles, 256)
    b, _ = RC.from_numpy_batch(pb, np.zeros(3, np.float32), "cpu")
    rng = b.tile_range.numpy()
    assert rng[0, 0] == 0 and rng[0, 1] == rng[1, 0] and rng[1, 1] == pb.kind.shape[0]
    assert (pb.tile_id[rng[0, 0]:rng[0, 1]] == 0).all()
    assert pb.first[rng[1, 0]] == 1


@pytest.mark.parametrize("scene", [scene_mixed, scene_round_capped_dash, scene_packed,
                                   lambda: scene_fuzz(11)],
                         ids=["mixed", "round_capped_dash", "packed", "fuzz11"])
def test_render_ignores_bytes_outside_the_bound(scene):
    """chip_smoke.render_bound leaves out aux row 3, every lane of a
    padding chunk, the lane fields a chunk's kind never reads and the
    items past a chunk's last section end: scrambling them leaves the
    render as it was."""
    _, dev, ts, packed = scene()
    pb = host_batch(dev, ts, packed)
    b, canvas = RC.from_numpy_batch(pb, np.array(CANVAS, np.float32) / 255.0, "cpu")
    want = RC.render_batch_planar(b, canvas, ts)
    rng = np.random.default_rng(1)
    geom, aux, trav, sprof, items = (t.clone() for t in (b.geom, b.aux, b.trav, b.sprof, b.items))
    kind = b.chunk_i[:, RC.CI_KIND].numpy()

    def scramble(t, sel, lo=-2**20, hi=2**20):
        t[sel] = torch.from_numpy(rng.integers(lo, hi, t[sel].shape).astype(
            np.float32 if t.dtype == torch.float32 else np.int32))

    scramble(aux, (slice(None), 3))
    fills = np.isin(kind, (CL.KIND_FILL, CL.KIND_FILL_IMAGE))
    for t, sel in ((geom, kind == CL.KIND_PAD), (aux, kind == CL.KIND_PAD),
                   (trav, ~np.isin(kind, (CL.KIND_STROKE, CL.KIND_STROKE_SOLID,
                                          CL.KIND_STROKE_DASH))),
                   (sprof, ~np.isin(kind, (CL.KIND_STROKE, CL.KIND_STROKE_DASH))),
                   (aux, fills)):
        if sel.any():
            scramble(t, torch.from_numpy(sel))
    geom[torch.from_numpy(fills), 3] = -7
    # Solid items name no profile: any valid index renders the same.
    solid = torch.from_numpy(kind == CL.KIND_STROKE_SOLID)
    if solid.any():
        scramble(sprof, solid, 0, b.profiles.shape[0])
    end = b.isec[:, -1].numpy()
    for c in range(items.shape[0]):
        n = end[c] if kind[c] in (CL.KIND_STROKE_SOLID, CL.KIND_STROKE_DASH) else 0
        scramble(items, (c, slice(int(n), None)))
    got = RC.render_batch_planar(b._replace(geom=geom, aux=aux, trav=trav, sprof=sprof,
                                            items=items), canvas, ts)
    assert torch.equal(got, want)
