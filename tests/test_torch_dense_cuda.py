"""The dense kernels' plain version and host packing (ops/dense_cuda.py)
on the CPU.

`render_batch_twin`, fed the kernels' packed arguments (`pack_plan`),
is held byte for byte to `render_jnp.render_batch` under x64 (the
reference in a child process, as test_torch_render_dense.py runs it) in
both precisions, on one batch with the walk chain on: the window-margin
fuzz scene, the oversize-coordinate scene and the mixed and round-capped
dash scenes, one tile each.  The chain-off icon-fill batch and the @2x
batch are in test_torch_dense_cuda_scenes.py.  Here too: the packing
(paint-order group lists, prefix sums and stroke and fill units that
cover every window once),
the counted stable rank against `torch.argsort(stable=True)`, the
wrappers' CPU route, and that rendering dense on the CPU neither builds
nor loads the CUDA library.  The kernels themselves run only on the
card (`chip_smoke.py` phase 4c).
"""

import numpy as np
import pytest
import torch

from osm_renderer_tpu_torch.draw import primitives as P
from osm_renderer_tpu_torch.ops import dense_cuda as DC
from osm_renderer_tpu_torch.ops import render_dense as RD
from osm_renderer_tpu_torch.ops.render_cuda import BatchLayoutError

from tests.test_torch_helpers import torch_threads
from tests.test_torch_render import scene_mixed, scene_round_capped_dash
from tests.test_torch_render_dense import (
    CHUNK, assert_same, build, canvas, jax_render, scene_oversize, scene_window_fuzz,
)

CHAIN_SCENES = [
    lambda prim: scene_window_fuzz(1, prim),
    scene_oversize,
    lambda prim: scene_mixed(prim)[1],
    lambda prim: scene_round_capped_dash(prim)[1],
]


def twin_render(arrays, ts, chunk, precision, chain):
    """render_batch_twin on the port's arrays, from the packed plan."""
    plan = RD.plan_batch(arrays, ts, chunk, precision)
    pack = DC.pack_plan(plan, len(arrays.geom))
    batch = RD.TileBatch.from_numpy(arrays, "cpu")
    with torch_threads(1):
        out = DC.render_batch_twin(batch, torch.from_numpy(canvas(precision)), pack, chain)
    assert out.dtype == torch.uint8 and out.shape == (len(arrays.geom), ts, ts, 3)
    return out.numpy()


def twin_and_jax(scene_fns, ts, precision, icon_cache_pair=(None, None)):
    """Each package builds the scenes; the arrays are equal -> (JAX's
    render, the twin's render, chain)."""
    from osm_renderer_tpu.draw import primitives as JP

    jarr, jchain = build(JP, [f(JP) for f in scene_fns], ts, CHUNK, precision,
                         icon_cache_pair[0])
    parr, pchain = build(P, [f(P) for f in scene_fns], ts, CHUNK, precision,
                         icon_cache_pair[1])
    assert pchain == jchain
    for name, a, b in zip(RD.TileBatch._fields, jarr, parr):
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    return (jax_render(jarr, ts, CHUNK, precision, jchain),
            twin_render(parr, ts, CHUNK, precision, pchain), pchain)


@pytest.fixture(scope="module", params=["exact", "fast"])
def chain_batch(request):
    want, got, chain = twin_and_jax(CHAIN_SCENES, 256, request.param)
    assert chain
    return request.param, want, got


@pytest.mark.parametrize("tile", range(len(CHAIN_SCENES)),
                         ids=["window_fuzz", "oversize", "mixed", "round_capped_dash"])
def test_twin_matches_render_jnp_chain_on(chain_batch, tile):
    precision, want, got = chain_batch
    assert_same(want[tile:tile + 1], got[tile:tile + 1], f"{precision} tile {tile}")


# ------------------------------------------------------------ packing --


def _scene_plan(precision="exact", ts=256, scenes=CHAIN_SCENES):
    arrays, chain = build(P, [f(P) for f in scenes], ts, CHUNK, precision)
    return arrays, chain, RD.plan_batch(arrays, ts, CHUNK, precision)


def test_pack_groups_in_paint_order_per_tile():
    arrays, _, plan = _scene_plan()
    T = len(arrays.geom)
    pack = DC.pack_plan(plan, T)
    groups, tile_ptr = [v.numpy() for v in pack.views()[3:]]
    assert tile_ptr[0] == 0 and tile_ptr[-1] == pack.n_groups == plan.groups.shape[0]
    for t in range(T):
        g = groups[tile_ptr[t]:tile_ptr[t + 1]]
        assert (g[:, 0] == t).all()
        # Strictly increasing chunk index: the reference's blend order.
        assert (np.diff(g[:, 1]) > 0).all()
        mine = plan.groups[plan.groups[:, 0] == t]
        assert sorted(map(tuple, mine.tolist())) == sorted(map(tuple, g.tolist()))
        # The chunk each group blends at is a last chunk of its tile.
        assert arrays.chunk_last[t, g[:, 1]].all()


def test_pack_prefix_sums_cover_every_window_once():
    _, _, plan = _scene_plan()
    pack = DC.pack_plan(plan, 4)
    strokes, sprefix, fills = [v.numpy() for v in pack.views()[:3]]
    assert pack.n_strokes == plan.strokes.shape[0] > 0 and pack.n_fills > 0
    # Strokes: flat pixel index -> (item, y, x), as the kernel maps it.
    idx = np.arange(pack.stroke_px)
    item = np.searchsorted(sprefix, idx, "right") - 1
    local = idx - sprefix[item]
    ly, lx = local // strokes[item, 6], local % strokes[item, 6]
    seen = np.zeros(pack.stroke_px, np.int64)
    for i, (h, w) in enumerate(strokes[:, 5:7]):
        sel = item == i
        assert sel.sum() == h * w
        np.add.at(seen, ly[sel] * w + lx[sel] + sprefix[i], 1)
        assert ly[sel].max() == h - 1 and lx[sel].max() == w - 1
    assert (seen == 1).all()
    # Fills: the bucket E holds its edges (the rows: the fill units' test).
    assert pack.fill_rows == fills[:, 6].sum()
    assert ((fills[:, 10] >= fills[:, 3]) & (fills[:, 10] >= 4)).all()
    assert pack.e_max == fills[:, 10].max()
    assert sorted(map(tuple, fills[:, :10].tolist())) == sorted(
        map(tuple, np.concatenate([it for _, it, _ in plan.fills]).tolist()))


def test_pack_units_cover_every_window_pixel_once():
    """The stroke kernel's work units: rectangles of at most UNIT_SIDE x
    UNIT_SIDE pixels that tile each item's window exactly, items in
    order; the pack's tail holds them."""
    _, _, plan = _scene_plan(ts=512)
    pack = DC.pack_plan(plan, 4)
    units = pack.units().numpy()
    assert units.size == pack.n_units > pack.n_strokes
    assert np.array_equal(units, DC.stroke_units(plan.strokes))
    item, uy, ux = units >> 32, (units >> 16) & 0xFFFF, units & 0xFFFF
    assert (np.diff(item) >= 0).all() and (uy % DC.UNIT_SIDE == 0).all()
    h, w = plan.strokes[item, 5], plan.strokes[item, 6]
    nh, nw = np.minimum(DC.UNIT_SIDE, h - uy), np.minimum(DC.UNIT_SIDE, w - ux)
    assert (nh > 0).all() and (nw > 0).all()
    assert np.array_equal(np.bincount(item, weights=nh * nw, minlength=pack.n_strokes),
                          plan.strokes[:, 5] * plan.strokes[:, 6])
    assert len(set(zip(item.tolist(), uy.tolist(), ux.tolist()))) == units.size
    assert pack.buf.numel() == (sum(v.numel() for v in pack.views()) + pack.n_units
                                + pack.n_fill_units)


@pytest.mark.parametrize("ts", [256, 512])
def test_pack_fill_units_cover_every_window_row_once(ts):
    """The fill kernel's units: runs of at most fill_unit_rows(E) rows
    (R x E <= FILL_PAIRS, R <= FILL_MAX_ROWS; one row past FILL_PAIRS)
    and FILL_UNIT_PX pixels (one row at least) that tile each item's
    window rows exactly, in order within the item, the widest bucket
    first; the pack's tail holds them."""
    _, _, plan = _scene_plan(ts=ts)
    pack = DC.pack_plan(plan, 4)
    fills = pack.views()[2].numpy()
    units = pack.fill_units().numpy()
    assert units.size == pack.n_fill_units >= pack.n_fills > 0
    assert np.array_equal(units, DC.fill_units(fills))
    item, r0, nr = units >> 32, (units >> 8) & 0xFFFFFF, units & 0xFF
    E, h, w = fills[item, 10], fills[item, 6], fills[item, 7]
    R = DC.fill_unit_rows(E)
    assert ((R * E <= DC.FILL_PAIRS) | (R == 1)).all() and (R <= DC.FILL_MAX_ROWS).all()
    assert (R == np.where(E > DC.FILL_PAIRS, 1,
                          np.minimum(DC.FILL_MAX_ROWS, DC.FILL_PAIRS // E))).all()
    # Runs of R rows, fewer where FILL_UNIT_PX pixels end them first.
    run = np.clip(DC.FILL_UNIT_PX // w, 1, R)
    assert (r0 % run == 0).all() and (nr == np.minimum(run, h - r0)).all() and (nr > 0).all()
    assert ((nr * w <= DC.FILL_UNIT_PX) | (nr == 1)).all() and (np.diff(E) <= 0).all()
    seen = np.zeros(pack.fill_rows, np.int64)
    base = np.concatenate([[0], np.cumsum(fills[:, 6])])
    for i, a, n in zip(item.tolist(), r0.tolist(), nr.tolist()):
        seen[base[i] + a:base[i] + a + n] += 1
    assert (seen == 1).all()
    first = np.flatnonzero(np.concatenate([[True], item[1:] != item[:-1]]))
    assert np.unique(item).size == first.size == pack.n_fills
    assert all((np.diff(r0[a:b]) > 0).all() for a, b in zip(first, list(first[1:]) + [item.size]))


def test_fill_units_refuse_what_the_kernel_does_not_take():
    """Buckets that are not powers of two, or wider than 65536 lanes (the
    kernel's 16-bit edge tag)."""
    fills = np.zeros((2, DC.FILL_COLS), np.int64)
    fills[:, 6] = 10
    for E in (12, 1 << 17):
        fills[:, 10] = [4, E]
        with pytest.raises(BatchLayoutError):
            DC.fill_units(fills)


def test_pass_one_keeps_every_stroke_pixel_with_an_alpha():
    """The exact stroke kernel's pass 1 keeps the pixels with cd <
    fmax(sqrt(hw * hw) + 0.5, 1) (`tools/dense_counts.kept_pixels` counts
    them as it does, in f64): every pixel to which the plain version gives
    a stroke alpha (the walk chain off, which only removes pixels) is
    among them."""
    from osm_renderer_tpu_torch.tools import dense_counts

    arrays, _, plan = _scene_plan("exact")
    batch = RD.TileBatch.from_numpy(arrays, "cpu")
    with torch_threads(1):
        pend = RD.alphas(batch, plan._replace(fills=[]), False).numpy()
    kept = np.concatenate([idx for idx, _ in dense_counts.kept_pixels(arrays, plan)])
    painted = np.flatnonzero(pend > 0)
    assert painted.size and np.isin(painted, kept).all()
    assert kept.size < int(plan.strokes[:, 5] @ plan.strokes[:, 6])


@pytest.mark.parametrize("E", [4, 8, 64])
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_counted_stable_rank_equals_argsort(E, dtype):
    """Ties included, and keys at and above the inactive key `big`."""
    rng = np.random.default_rng(E)
    big = RD.FILL_RANK_BIG[dtype]
    keys = rng.integers(-3, 4, size=(300, E))
    keys = np.where(rng.random((300, E)) < 0.2, big, keys)
    keys = np.where(rng.random((300, E)) < 0.05, big + 1, keys)
    keys = torch.from_numpy(keys).to(dtype)
    order = torch.argsort(keys, dim=-1, stable=True)
    want = torch.zeros_like(order).scatter_(
        -1, order, torch.arange(E).expand_as(order).contiguous())
    assert torch.equal(DC.stable_rank_counted(keys), want)


# --------------------------------------------------------- CPU route --


def test_cpu_render_neither_builds_nor_loads_the_library(monkeypatch):
    """On CPU tensors the wrappers run their plain versions: no nvcc, no
    ctypes load of csrc/dense.cu, no launch counted; render_dense routes
    CPU batches to its plain version."""
    from osm_renderer_tpu_torch.ops import build as B

    def refuse(*a, **k):
        raise AssertionError("the CPU path tried to build or load a CUDA library")

    monkeypatch.setattr(B, "load_library", refuse)
    monkeypatch.setattr(B, "nvcc_path", refuse)
    monkeypatch.setattr(B, "dense_library", refuse)
    before = dict(DC.DENSE_KERNEL_LAUNCHES)
    arrays, chain, plan = _scene_plan("fast", scenes=CHAIN_SCENES[2:3])
    assert plan.strokes.shape[0] and plan.fills
    batch = RD.TileBatch.from_numpy(arrays, "cpu")
    c = torch.from_numpy(canvas("fast"))
    pack = DC.pack_plan(plan, len(arrays.geom))
    with torch_threads(1):
        via_wrappers = DC.render_batch(batch, c, pack, chain)
        plain = RD.render_batch(batch, c, 256, CHUNK, "fast", chain, plan, pack)
        twin = DC.render_batch_twin(batch, c, pack, chain)
    assert torch.equal(via_wrappers, twin) and torch.equal(plain, twin)
    assert "dense.cu" not in B._libs and "dense.cu" not in B.BUILD_SECONDS
    assert DC.DENSE_KERNEL_LAUNCHES == before


def test_wrappers_refuse_what_the_kernels_do_not_take():
    arrays, chain, plan = _scene_plan("exact")
    batch = RD.TileBatch.from_numpy(arrays, "cpu")
    pack = DC.pack_plan(plan, len(arrays.geom))
    pending = DC.new_pending(batch, pack)
    # A fast pack over an exact (f64) batch.
    fast = pack._replace(precision="fast")
    with pytest.raises(BatchLayoutError):
        DC.stroke_alpha(batch, fast, pending.float(), chain)
    with pytest.raises(BatchLayoutError):
        DC.fill_alpha(batch, pack, pending[:-1])
    with pytest.raises(BatchLayoutError):
        DC.blend_finalize(batch, torch.zeros(3, dtype=torch.float32), pack, pending)
    with pytest.raises(BatchLayoutError):
        DC.render_batch(batch._replace(geom=batch.geom.long()), torch.zeros(3, dtype=torch.float64),
                        pack, chain)
