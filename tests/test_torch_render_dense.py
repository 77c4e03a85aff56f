"""The port's dense renderer (ops/render_dense.py) on the CPU, held to
`render_jnp.render_batch` under x64 on small scenes (the reference runs
in a child process: `test_torch_helpers.run_jax`).

Each side streams its scene with its own package (primitives,
ProfileTable, PatternTable, build_batch); the arrays are equal, and the
renders are byte-identical (max |diff| 0) in both precisions.  This file
holds the scene builders and the helpers the other
test_torch_render_dense_*.py files share, the oversize-coordinate scene,
the icon-fill scene (its strokes are butt-capped and solid: the walk
chain is off), and the port's own checks: the two-phase evaluation
against the step-by-step one, and the host schedule.  The chain, fuzz,
@2x, window-margin and DeviceDrawer cases live in their own files so
that `--dist loadfile` spreads them.
"""

import numpy as np
import pytest
import torch

from osm_renderer_tpu_torch.draw import primitives as P
from osm_renderer_tpu_torch.ops import render_dense as RD
from osm_renderer_tpu_torch.ops.coverage_np import LINE_CAP_BUTT, LINE_CAP_ROUND, LINE_CAP_SQUARE

from tests.test_coverage_parity import CANVAS, make_polygon, rand_color
from tests.test_torch_helpers import run_jax, torch_threads
from tests.test_torch_render import _fill, _stroke

# The chunk size of the scene batches (the reference's default is 64;
# the DeviceDrawer test runs at it).  Small chunks keep the reference's
# scan, which evaluates every slot of every chunk over the whole tile,
# inside the tests' time.
CHUNK = 8


def _prims(items):
    return [dev for _, dev in items]


def _star(cx, cy, n, r_out, r_in, phase=0.0):
    """A concave star polygon's closed edge list."""
    ang = phase + np.linspace(0, 2 * np.pi, 2 * n, endpoint=False)
    r = np.where(np.arange(2 * n) % 2 == 0, r_out, r_in)
    pts = np.stack([np.round(cx + r * np.cos(ang)), np.round(cy + r * np.sin(ang))], 1)
    pts = np.concatenate([pts, pts[:1]], 0).astype(np.int64)
    return np.concatenate([pts[:-1], pts[1:]], axis=1)


def scene_window_fuzz(seed, prim=P, ts=256):
    """Where a too-small window would show: half-widths up to 20 px,
    segments on, touching and crossing the tile's edges, long diagonals,
    axis-parallel and degenerate segments, round-capped dashes, concave
    polygons and polygons crossing the tile.  -> device prims."""
    rng = np.random.default_rng(seed)
    items = []
    for _ in range(3):
        cx, cy = rng.integers(-30, ts + 30, 2)
        edges = _star(cx, cy, int(rng.integers(3, 5)), int(rng.integers(30, 110)),
                      int(rng.integers(8, 30)), float(rng.uniform(0, 1)))
        items.append(_fill(prim, edges, rand_color(rng), float(rng.choice([1.0, 0.6]))))
    ell = np.array([[-20, 200], [120, 200], [120, 140], [60, 140], [60, -15], [-20, -15]])
    ell = np.concatenate([ell, np.roll(ell, -1, 0)], 1).astype(np.int64)
    items.append(_fill(prim, ell, rand_color(rng), 0.8))
    edge_x = [0, ts - 1, -1, ts, -12, ts + 12]
    dash_choices = [None, [6.0, 3.0], [20.0, 8.0], [2.0, 2.0], [10.0, 4.0, 2.0, 4.0]]
    for k in range(10):
        n = int(rng.integers(2, 6))
        pts = rng.integers(-45, ts + 45, (n, 2))
        if k % 3 == 0:  # a point on or just past an edge of the tile
            pts[0, int(rng.integers(0, 2))] = edge_x[int(rng.integers(0, len(edge_x)))]
        if k % 4 == 1:  # axis-parallel
            pts[1, int(rng.integers(0, 2))] = pts[0, int(rng.integers(0, 2))]
        if k % 5 == 2:  # degenerate
            pts[1] = pts[0]
        pairs = np.concatenate([pts[:-1], pts[1:]], 1).astype(np.int64)
        w = float(rng.choice([1.0, 3.0, 8.5, 15.0, 24.0, 33.0, 40.0]))
        cap = int(rng.choice([LINE_CAP_BUTT, LINE_CAP_ROUND, LINE_CAP_SQUARE]))
        dashes = dash_choices[int(rng.integers(0, len(dash_choices)))]
        items.append(_stroke(prim, pairs, w, rand_color(rng), dashes, cap,
                             float(rng.choice([1.0, 0.7]))))
    for p in ([-50, -40, ts + 50, ts + 30], [ts + 20, -30, -25, ts + 40]):
        items.append(_stroke(prim, np.array([p], np.int64), float(rng.choice([6.0, 40.0])),
                             rand_color(rng), [30.0, 10.0], LINE_CAP_ROUND))
    return _prims(items)


def scene_oversize(prim=P):
    """Coordinates past 2**14: only the exact precision renders them
    directly (the fast path's integer bounds do not hold)."""
    far = 5 * P.FAST_COORD_BOUND
    tri = np.array([[-far, -100, 200, 90], [200, 90, 120, far], [120, far, -far, -100]],
                   np.int64)
    rng = np.random.default_rng(3)
    return [
        prim.FillPrim(kind="fill", color=(70, 130, 70), opacity=0.9, edges=tri),
        prim.make_stroke_prim(np.array([[-far, 60, far, 180]], np.int64), 5.0,
                              (250, 250, 240), 1.0, [8.0, 4.0], LINE_CAP_ROUND, True),
        prim.make_stroke_prim(np.array([[30, -far, 90, far]], np.int64), 9.0,
                              (40, 40, 200), 0.8, None, LINE_CAP_BUTT, True),
        prim.FillPrim(kind="fill", color=(180, 40, 40), opacity=1.0, edges=make_polygon(rng)),
    ]


def scene_icon(prim=P):
    """Tiled icon fills (kind 5) around a plain fill and a stroke; the
    icon is `pat.png` of the batch's icon cache."""
    rng = np.random.default_rng(7)
    polys = [make_polygon(rng) for _ in range(3)]
    return [
        prim.FillPrim(kind="fill", color=(60, 120, 60), opacity=0.8, edges=polys[0]),
        prim.FillPrim(kind="fill", color=None, opacity=1.0, edges=polys[1], fill_image="pat.png"),
        prim.make_stroke_prim(np.array([[0, 100, 255, 140]], np.int64), 3.0, (255, 255, 255),
                              1.0, None, LINE_CAP_BUTT, True),
        prim.FillPrim(kind="fill", color=None, opacity=1.0, edges=polys[2], fill_image="pat.png"),
    ]


def write_icon(path):
    from PIL import Image

    rng = np.random.default_rng(11)
    px = rng.integers(0, 256, size=(10, 12, 4), dtype=np.uint8)
    px[..., 3] = rng.integers(60, 256, size=(10, 12), dtype=np.uint8)
    Image.fromarray(px, "RGBA").save(path / "pat.png")


def build(mod, scenes, ts, chunk, precision, icon_cache=None):
    """One batch of the scenes (one tile each) through package `mod`'s
    stream_tile and build_batch -> (numpy TileBatch, chain)."""
    dtype = np.float64 if precision == "exact" else np.float32
    profiles = mod.ProfileTable()
    patterns = mod.PatternTable(icon_cache, ts)
    streams = [mod.stream_tile(prims, profiles, chunk, patterns) for prims in scenes]
    assert not any(s.has_icon_fills for s in streams)
    arrays = mod.build_batch(streams, profiles, chunk, dtype=dtype, patterns=patterns, ts=ts)
    return arrays, profiles.has_round_caps()


def canvas(precision):
    dtype = np.float64 if precision == "exact" else np.float32
    return np.array(CANVAS, dtype) / 255.0


def jax_render(arrays, ts, chunk, precision, chain):
    """`render_jnp.render_batch` on the JAX package's own arrays (in a
    child process: `test_torch_helpers.run_jax`)."""
    import tempfile

    code = (
        "import jax.numpy as jnp\n"
        "from osm_renderer_tpu.ops import render_jnp as RJ\n"
        "batch = RJ.TileBatch(*(jnp.asarray(inp[f]) for f in RJ.TileBatch._fields))\n"
        f"out['rgb'] = np.asarray(RJ.render_batch(batch, jnp.asarray(inp['canvas']), {ts}, "
        f"{chunk}, {precision!r}, chain={chain}))\n"
    )
    with tempfile.TemporaryDirectory() as tmp:
        return run_jax(code, tmp, canvas=canvas(precision), **arrays._asdict())["rgb"]


def port_render(arrays, ts, chunk, precision, chain):
    batch = RD.TileBatch.from_numpy(arrays, "cpu")
    with torch_threads(1):
        out = RD.render_batch(batch, torch.from_numpy(canvas(precision)), ts, chunk,
                              precision, chain)
    assert out.dtype == torch.uint8 and out.shape == (len(arrays.geom), ts, ts, 3)
    return out.numpy()


def both(scene_fns, ts, chunk, precision, icon_cache_pair=(None, None)):
    """Build the scenes with each package, check the arrays equal and
    render each side with its own package -> (want, got, chain)."""
    from osm_renderer_tpu.draw import primitives as JP

    jarr, jchain = build(JP, [f(JP) for f in scene_fns], ts, chunk, precision,
                         icon_cache_pair[0])
    parr, pchain = build(P, [f(P) for f in scene_fns], ts, chunk, precision,
                         icon_cache_pair[1])
    assert pchain == jchain
    for name, a, b in zip(RD.TileBatch._fields, jarr, parr):
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    return (jax_render(jarr, ts, chunk, precision, jchain),
            port_render(parr, ts, chunk, precision, pchain), pchain)


def assert_same(want, got, what=""):
    """Byte-identical, or a message naming the first differing pixel."""
    diff = np.abs(want.astype(int) - got.astype(int))
    if diff.max():
        t, y, x = np.argwhere(diff.max(-1) > 0)[0]
        raise AssertionError(f"{what}: {int((diff.max(-1) > 0).sum())} pixels differ, max "
                             f"{diff.max()}; first tile {t} (y={y}, x={x}): reference "
                             f"{want[t, y, x]} port {got[t, y, x]}")


# ---------------------------------------------------------------- vs JAX --

@pytest.mark.parametrize("precision", ["exact", "fast"])
def test_oversize_coordinates_match_render_jnp(precision):
    """Coordinates five times the fast path's bound: the exact closed
    forms draw them directly; the fast ones overflow as the reference's
    do, so the port evaluates such chunks over the whole tile."""
    want, got, _ = both([scene_oversize], 256, CHUNK, precision)
    assert_same(want, got, precision)
    assert (got != np.array(CANVAS, np.uint8)).any(axis=-1).mean() > 0.05


@pytest.mark.parametrize("precision", ["exact", "fast"])
def test_icon_fill_matches_render_jnp(tmp_path, precision):
    """Kind 5: the pattern blend (premultiplied icon under the fill mask)."""
    from osm_renderer_tpu.draw.labels.icons import IconCache as JaxIconCache
    from osm_renderer_tpu_torch.draw.labels.icons import IconCache

    write_icon(tmp_path)
    caches = (JaxIconCache(str(tmp_path)), IconCache(str(tmp_path)))
    arrays, _ = build(P, [scene_icon(P)], 256, CHUNK, precision, caches[1])
    assert RD.KIND_FILL_IMAGE in arrays.chunk_kind.tolist()[0]
    want, got, chain = both([scene_icon], 256, CHUNK, precision, caches)
    assert not chain
    assert_same(want, got, precision)


# ------------------------------------------------------------ port only --

@pytest.mark.parametrize("precision", ["exact", "fast"])
def test_two_phase_equals_stepwise_evaluation(precision):
    """The windowed two-phase evaluation against the port's plain dense
    step-by-step one (every slot of every chunk over the whole tile), on
    one small scene with wide strokes at the tile's edges, round-capped
    dashes, a degenerate segment and a concave fill; also with a pixel
    budget so small that every item is a pass of its own."""
    ts = 64
    prims = [
        P.FillPrim(kind="fill", color=(10, 120, 200), opacity=0.7,
                   edges=_star(20, 30, 4, 30, 9)),
        P.make_stroke_prim(np.array([[-5, 60, 30, 70], [30, 70, 30, 70], [30, 70, 70, 2]],
                                    np.int64), 21.0, (200, 40, 40), 0.8, [9.0, 4.0],
                           LINE_CAP_ROUND, True),
        P.make_stroke_prim(np.array([[63, 0, 63, 63]], np.int64), 3.0, (20, 20, 20), 1.0,
                           None, LINE_CAP_SQUARE, True),
    ]
    arrays, chain = build(P, [prims], ts, CHUNK, precision)
    assert chain
    batch = RD.TileBatch.from_numpy(arrays, "cpu")
    c = torch.from_numpy(canvas(precision))
    tiny = RD.plan_batch(arrays, ts, CHUNK, precision, budget=1)
    assert len(tiny.stroke_passes) == tiny.strokes.shape[0] > 4
    with torch_threads(1):
        want = RD.render_batch_stepwise(batch, c, ts, CHUNK, precision, chain)
        assert (want != torch.tensor(CANVAS, dtype=torch.uint8)).any(-1).float().mean() > 0.3
        assert torch.equal(RD.render_batch(batch, c, ts, CHUNK, precision, chain), want)
        assert torch.equal(RD.render_batch(batch, c, ts, CHUNK, precision, chain, plan=tiny),
                           want)


def test_plan_windows_and_levels():
    """Every painted pixel lies in its group's window; groups whose
    windows share a grid cell blend in paint order; chunks past a tile's
    last blend, degenerate segments and pad chunks take no item."""
    prims = [
        P.FillPrim(kind="fill", color=(1, 2, 3), opacity=1.0,
                   edges=np.array([[10, 10, 40, 10], [40, 10, 40, 30], [40, 30, 10, 10]])),
        P.FillPrim(kind="fill", color=(1, 2, 3), opacity=1.0,
                   edges=np.array([[200, 200, 240, 200], [240, 200, 240, 230],
                                   [240, 230, 200, 200]])),
        P.make_stroke_prim(np.array([[0, 20, 255, 20], [255, 20, 255, 20]], np.int64), 8.0,
                           (4, 5, 6), 1.0, None, LINE_CAP_BUTT, True),
    ]
    arrays, _ = build(P, [prims], 256, CHUNK, "exact")
    plan = RD.plan_batch(arrays, 256, CHUNK, "exact")
    g = plan.groups
    assert g.shape[0] == 3 and len(plan.levels) == 2
    # The two fills share level 0; the stroke crosses the first one.
    assert [lv[1] - lv[0] for lv in plan.levels] == [2, 1]
    assert g[2, 1] == 2 and g[2, 2] == 20 - 7 and g[2, 4] == 15 and g[2, 5] == 256
    assert plan.pending_size == int((g[:, 4] * g[:, 5]).sum())
    out = port_render(arrays, 256, CHUNK, "exact", False)[0]
    inside = np.zeros((256, 256), bool)
    for _, _, y0, x0, h, w, _ in g:
        inside[y0:y0 + h, x0:x0 + w] = True
    painted = (out != np.array(CANVAS, np.uint8)).any(-1)
    assert painted.any() and not (painted & ~inside).any()
    # A degenerate segment takes no item, and the group it leaves empty
    # no window; nor do chunks after a tile's last blend.
    off = int(arrays.chunk_off[0, 2])
    seg = arrays.geom[0, off].copy()
    arrays.geom[0, off, 2:] = seg[:2]
    plan = RD.plan_batch(arrays, 256, CHUNK, "exact")
    assert plan.strokes.shape[0] == 0 and plan.groups.shape[0] == 2
    arrays.geom[0, off] = seg
    arrays.chunk_last[0, 2] = False
    plan = RD.plan_batch(arrays, 256, CHUNK, "exact")
    assert plan.strokes.shape[0] == 0 and plan.groups.shape[0] == 2
    with pytest.raises(ValueError):
        RD.plan_batch(arrays, 256, CHUNK, "double")
