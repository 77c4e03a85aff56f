"""csrc/dense.cu's own arithmetic on the CPU.

g++ compiles the kernel source behind tests/cuda_host/cuda_runtime.h, a
header that stands in for the few CUDA pieces it uses (qualifiers,
thread indices, a block's threads as coroutines, a warp's 32 lanes
meeting at its ballots, barriers and shuffles, atomics), with each
`kernel<<<...>>>(...)` launch rewritten to run its blocks on the host,
one block at a time.
Its three entry points, called through ops/dense_cuda.py's own argument
packing (`_launch`), must give `render_dense.render_batch_plain`'s
pending buffer and bytes (its `alphas`, then its `blend`), in both
precisions: on the chained scenes of test_torch_dense_cuda.py, the
icon-fill scene, one fill of 700 edges (a 1024-lane bucket: the fill
kernel's global scratch), combs whose every edge is active on every
row (a fill unit's list full), crossings that tie (rank ties), fills
taller than a unit on a 512 px tile and scenes at @2x, @3x and @4x (ts
512, 768, 1024).  The stroke kernel's band tables are held entry by
entry to band_start, start_alive and chain_alive evaluated directly,
and the units past WINDOW_COORD_BOUND (the oversize scene) to the
per-pixel rules; the reciprocal floor division to Python's `//`.  This
checks the kernels' integer and float semantics where no card is: the
wrapping arithmetic, floor division, the five FMA sites, the counted
rank over each row's compacted active edges, the band tables, the
paint-order walk.  What only the card shows (nvcc's code, the launch
configuration, the device's conversions) is `chip_smoke.py`
phase 4c's.
"""

import contextlib
import ctypes
import os
import re
import subprocess

import numpy as np
import pytest
import torch

from osm_renderer_tpu_torch.draw import primitives as P
from osm_renderer_tpu_torch.ops import dense_cuda as DC
from osm_renderer_tpu_torch.ops import render_dense as RD
from osm_renderer_tpu_torch.ops.build import CSRC_DIR
from osm_renderer_tpu_torch.ops.coverage_np import LINE_CAP_ROUND

from tests.test_coverage_parity import make_polygon, make_polyline, rand_color
from tests.test_torch_dense_cuda import CHAIN_SCENES
from tests.test_torch_helpers import torch_threads
from tests.test_torch_render import _fill, _scene, _stroke, scene_2x
from tests.test_torch_render_dense import CHUNK, build, canvas, scene_icon, write_icon

HERE = os.path.dirname(os.path.abspath(__file__))
# kernel<<<grid, block, 0, s>>>(args);
_LAUNCH = re.compile(r"(dense_\w+<[^<>]*>)<<<(.*?), (\w+(?: \* \w+)?), 0, s>>>\((.*?)\);",
                     re.S)

# Entry points for the tests only, compiled into the same translation
# unit: the reciprocal floor division, and every band-table entry the
# stroke kernel wrote checked against the rules evaluated directly.
_CHECKS = r"""
extern "C" void host_floor_div64(const int64_t* n, int64_t count, int64_t d, int64_t* out) {
  const FloorDiv64 f(d);
  for (int64_t i = 0; i < count; ++i) out[i] = f(Wrap<int64_t>(n[i])).v;
}

// counts: entries checked, chained entries checked, mismatches, then the
// units in each mode (UNIT_EMPTY, UNIT_TABLE, UNIT_PER_PIXEL), then the
// lookups the tables lacked.
template <typename I, typename F>
void check_tables(const Params& p, bool chain, int64_t* counts) {
  const Wrap<I> jvs[] = {Wrap<I>::min(), -2, -1, 0, 1, 2, 3, 5, 8, 11, 12, 13, 40,
                         Wrap<I>::max()};
  for (int64_t u = 0; u < p.d[D_NU]; ++u) {
    const int64_t* rec = p.tables + u * TABLE_COLS;
    ++counts[3 + rec[0]];
    counts[6] += rec[3];
    if (rec[0] != UNIT_TABLE) continue;
    const Unit<I, F> un = load_unit<I, F>(p, u);
    const bool chained = chain && un.s.any_orig;
    if (!un.in_bound || rec[2] > NB_CAP) ++counts[2];
    for (int64_t j = 0; j < rec[2]; ++j) {
      const Wrap<I> b = (I)(rec[1] + j);
      const Band<I> bt = band_start(un.s, b);
      const bool alive = start_alive(un.s, bt.mn, bt.mx);
      const I mn = (I)rec[4 + j];
      const uint16_t rule = (uint16_t)rec[4 + NB_CAP + j];
      const BandTable<I> tab = {&mn, &rule, b, 1};
      ++counts[0];
      counts[2] += (bt.mn.v != rec[4 + j]) + (alive != tab.alive(0));
      if (!alive || !chained) continue;
      ++counts[1];
      for (const Wrap<I> jv : jvs)
        for (int plus = 0; plus < 2; ++plus)
          counts[2] += chain_alive(un.s, bt, plus ? 1 : -1, jv) != tab.chain_ok(0, plus, jv);
    }
  }
}

extern "C" void host_check_tables(const void* const* ptrs, const int64_t* dims, int exact,
                                  int chain, int64_t* counts) {
  const Params p = make_params(ptrs, dims);
  if (exact) check_tables<int64_t, double>(p, chain != 0, counts);
  else check_tables<int32_t, float>(p, chain != 0, counts);
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """csrc/dense.cu built by g++ for the host -> the loaded library."""
    src = open(os.path.join(CSRC_DIR, "dense.cu")).read()
    assert len(_LAUNCH.findall(src)) == 6, "dense.cu's launches changed; update _LAUNCH"
    src = _LAUNCH.sub(lambda m: (f"host_launch(dim3({m[2]}), dim3({m[3]}), 0, "
                                 f"[&] {{ (void)s; {m[1]}({m[4]}); }});"), src)
    src += _CHECKS  # in the same translation unit: they see the anonymous namespace
    tmp = tmp_path_factory.mktemp("dense_host")
    cpp, so = tmp / "dense_host.cpp", tmp / "libdense_host.so"
    cpp.write_text(src)
    proc = subprocess.run(
        ["g++", "-std=c++17", "-O2", "-ffp-contract=off", "-fPIC", "-shared",
         "-I", os.path.join(HERE, "cuda_host"), "-o", str(so), str(cpp)],
        capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-4000:]
    lib = ctypes.CDLL(str(so))
    Pt, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.osmr_dense_stroke_alpha.argtypes = [Pt, Pt, I, I, Pt, Pt, Pt]
    lib.osmr_dense_fill_alpha.argtypes = [Pt, Pt, I, Pt, Pt, Pt]
    lib.osmr_dense_blend_finalize.argtypes = [Pt, Pt, I, Pt, Pt, Pt]
    lib.host_floor_div64.argtypes = [Pt, L, L, Pt]
    lib.host_check_tables.argtypes = [Pt, Pt, I, I, Pt]
    return lib


@pytest.fixture
def host_launch(host_lib, monkeypatch):
    """dense_cuda._launch, pointed at the host build: no stream, no device."""
    from osm_renderer_tpu_torch.ops import build as B

    class _Stream:
        cuda_stream = None

    monkeypatch.setattr(B, "dense_library", lambda *a: host_lib)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: _Stream())
    monkeypatch.setattr(torch.cuda, "device", lambda *a: contextlib.nullcontext())
    return DC._launch


def _large_fill(prim):
    ang = np.linspace(0, 2 * np.pi, 700, endpoint=False)
    r = 100 + 20 * np.sin(37 * ang)
    pts = np.stack([np.round(128 + r * np.cos(ang)), np.round(128 + r * np.sin(ang))], 1)
    pts = np.concatenate([pts, pts[:1]]).astype(np.int64)
    return [prim.FillPrim(kind="fill", color=(20, 80, 160), opacity=0.9,
                          edges=np.concatenate([pts[:-1], pts[1:]], 1))]


def _closed(pts):
    """A closed polygon's edge list from its vertices."""
    pts = np.asarray(list(pts) + [pts[0]], np.int64)
    return np.concatenate([pts[:-1], pts[1:]], 1)


def _comb(x0, n, top, bottom, step):
    """A closed zigzag of n edges (n even) between rows top and bottom:
    every edge, the closing diagonal too, spans the rows (top, bottom],
    so all n are active on each of them."""
    k = np.arange(n)
    return _closed(np.stack([x0 + step * k, np.where(k % 2 == 0, top, bottom)], 1))


def scene_comb(prim):
    """Combs of 8, 16, 32 and 64 near-vertical edges, 2 px apart: in
    each bucket E a unit of R rows (R x E = FILL_PAIRS, narrow enough
    for FILL_UNIT_PX) holds R x E active crossings, a warp's list full."""
    return [prim.FillPrim(kind="fill", color=(40 + 40 * i, 120, 60 + 30 * i), opacity=0.9,
                          edges=_comb(x0, n, 20 + 3 * i, 230 - 5 * i, 2))
            for i, (x0, n) in enumerate(((10, 8), (30, 16), (70, 32), (120, 64)))]


def scene_ties(prim):
    """Crossings that tie on a row: a bow tie whose diagonals (the
    shallow rule: adx == ady) cross at (100, 100), and two squares in one
    fill sharing a side, whose two edges cross every row at x = 210."""
    bow = _closed([(50, 50), (150, 150), (150, 50), (50, 150)])
    shared = np.concatenate([_closed([(170, 20), (210, 20), (210, 90), (170, 90)]),
                             _closed([(210, 20), (250, 20), (250, 90), (210, 90)])])
    return [prim.FillPrim(kind="fill", color=(200, 60, 30), opacity=0.8, edges=bow),
            prim.FillPrim(kind="fill", color=(30, 60, 200), opacity=1.0, edges=shared)]


def scene_tall(prim):
    """Fills of 460 and 400 rows on a 512 px tile: many units each."""
    return [prim.FillPrim(kind="fill", color=(90, 90, 20), opacity=1.0,
                          edges=_closed([(100, 30), (180, 40), (170, 490), (90, 470)])),
            prim.FillPrim(kind="fill", color=(20, 90, 90), opacity=0.7,
                          edges=_closed([(300, 60), (420, 300), (330, 459), (380, 250)]))]


def scene_at(scale):
    """A tile at @3x or @4x (ts 768, 1024): two fills, round-capped dashes
    (the walk chain) and a segment leaving the tile, widths and dashes
    scaled as the server scales them."""
    def make(prim):
        rng = np.random.default_rng(17 + scale)
        items = [_fill(prim, (make_polygon(rng) * scale).astype(np.int64), rand_color(rng), 0.9)
                 for _ in range(2)]
        for pairs, w, dashes, cap in (
                ([[40, 200, 90, 185], [90, 185, 120, 140]], 3.0, [6.0, 3.0], LINE_CAP_ROUND),
                ([[150, 20, 230, 50]], 2.0, [4.0, 2.0], LINE_CAP_ROUND),
                ([[215, 240, 262, 222]], 4.0, None, LINE_CAP_ROUND)):
            items.append(_stroke(prim, np.array(pairs, np.int64) * scale, w * scale,
                                 rand_color(rng), dashes and [d * scale for d in dashes], cap))
        return _scene(items)[1]
    return make


def scene_far(prim):
    """A round-capped dash whose ends lie past WINDOW_COORD_BOUND in both
    precisions (2**29 > 2**28): its window is the whole tile, its
    products wrap, and its units take the per-pixel rules."""
    far = 1 << 29
    return [prim.make_stroke_prim(np.array([[-far, 90, far, 170]], np.int64), 4.0,
                                  (30, 60, 200), 1.0, [9.0, 5.0], LINE_CAP_ROUND, True)]


SCENES = {
    "chain": (CHAIN_SCENES, 256, CHUNK),
    "far": ([scene_far], 256, CHUNK),
    "icon": ([scene_icon], 256, CHUNK),
    "large_fill": ([_large_fill], 256, 1024),
    "comb": ([scene_comb], 256, 64),
    "ties": ([scene_ties], 256, CHUNK),
    "tall": ([scene_tall], 512, CHUNK),
    "2x": ([lambda prim: scene_2x(prim)[1]], 512, CHUNK),
    "3x": ([scene_at(3)], 768, CHUNK),
    "4x": ([scene_at(4)], 1024, CHUNK),
}


def _prepared(tmp_path, scene, precision):
    from osm_renderer_tpu_torch.draw.labels.icons import IconCache

    fns, ts, chunk = SCENES[scene]
    write_icon(tmp_path)
    arrays, chain = build(P, [f(P) for f in fns], ts, chunk, precision,
                          IconCache(str(tmp_path)))
    plan = RD.plan_batch(arrays, ts, chunk, precision)
    pack = DC.pack_plan(plan, len(arrays.geom))
    return arrays, chain, plan, pack, RD.TileBatch.from_numpy(arrays, "cpu")


@pytest.mark.parametrize("precision", ["exact", "fast"])
@pytest.mark.parametrize("scene", list(SCENES))
def test_host_build_of_the_kernels_equals_the_plain_version(host_launch, tmp_path, scene,
                                                            precision):
    arrays, chain, plan, pack, batch = _prepared(tmp_path, scene, precision)
    ts = plan.ts
    c = torch.from_numpy(canvas(precision))
    fills, units = pack.views()[2].numpy(), pack.fill_units().numpy()
    E, nr = fills[units >> 32, 10], units & 0xFF
    assert {"large_fill": pack.e_max > DC.FILL_PAIRS,
            "comb": {8, 16, 32, 64} <= set(E[nr * E == DC.FILL_PAIRS].tolist()),
            "tall": (fills[:, 6] > 10 * DC.FILL_MAX_ROWS).sum() == 2}.get(scene, True)
    # The kernels, launched as dense_cuda.render_batch launches them on a
    # card (a small fill grid: its warps stride over the rows).
    pending = DC.new_pending(batch, pack)
    host_launch("dense_stroke_alpha", batch, pack, pending, chain=chain)
    blocks = 2
    host_launch("dense_fill_alpha", batch, pack, pending, fill_blocks=blocks,
                scratch=DC.fill_scratch(pack, blocks, "cpu"))
    out = torch.empty((pack.n_tiles, ts, ts, 3), dtype=torch.uint8)
    host_launch("dense_blend_finalize", batch, pack, pending, canvas=c, out=out)
    with torch_threads(1):
        want_pending = RD.alphas(batch, plan, chain)  # render_batch_plain's two phases
        want = RD.blend(batch, c, plan, want_pending)
    assert torch.equal(pending, want_pending)
    n = int((out != want).any(-1).sum())
    assert n == 0, f"{scene} {precision}: {n} pixels differ from the plain version"
    assert (want != want[0, 0, 0]).any()


@pytest.mark.parametrize("precision", ["exact", "fast"])
@pytest.mark.parametrize("scene", ["chain", "far", "4x"])
def test_band_tables_equal_the_rules_evaluated_directly(host_lib, host_launch, tmp_path, scene,
                                                        precision):
    """Every entry of every unit's band table (the stroke kernel's, as it
    wrote it) equals band_start's minor coordinate and start_alive
    evaluated directly, and its walk word gives chain_alive for both
    walk directions and every jv; no kept pixel's band is missing from
    its unit's table; exactly the units whose segment reaches past
    WINDOW_COORD_BOUND (the oversize scene's in the fast precision, the
    far scene's in both) take the per-pixel rules."""
    arrays, chain, plan, pack, batch = _prepared(tmp_path, scene, precision)
    assert chain
    pending = DC.new_pending(batch, pack)
    tables = torch.zeros((pack.n_units, DC.TABLE_COLS), dtype=torch.int64)
    host_launch("dense_stroke_alpha", batch, pack, pending, chain=chain, tables=tables)
    ptrs, dims = DC.kernel_arguments(batch, pack, pending, tables=tables)
    counts = (ctypes.c_int64 * 7)()
    host_lib.host_check_tables(ptrs, dims, int(precision == "exact"), int(chain), counts)
    entries, chained, wrong, empty, table, per_pixel, missed = counts
    assert wrong == 0 and missed == 0
    assert entries > 0 and chained > 0 and table > 0 or scene == "far"
    # The per-pixel rules: exactly the units (with a pixel kept) of the
    # segments past the bound.
    mode = tables[:, 0].numpy()
    item = pack.units().numpy() >> 32
    st = plan.strokes[item]
    seg = arrays.geom[st[:, 0], st[:, 2]].astype(np.int64)
    past = (np.abs(seg) >= RD.WINDOW_COORD_BOUND[precision]).any(axis=1)
    kept = mode != DC.UNIT_EMPTY
    assert np.array_equal(mode[kept] == DC.UNIT_PER_PIXEL, past[kept])
    assert per_pixel == int((kept & past).sum())
    assert (per_pixel > 0) == (scene == "far" or (scene == "chain" and precision == "fast"))
    assert (tables[:, 2] <= 2 * DC.UNIT_SIDE).all()


def test_host_build_shares_the_packing_constants(host_lib):
    """The constants csrc/dense.cu reports (osmr_dense_constants, checked
    against ops/dense_cuda.py when the card's build loads) agree with the
    packing's, the fill unit's list and rows among them."""
    from osm_renderer_tpu_torch.ops.build import dense_constants

    host_lib.osmr_dense_constants.argtypes = [ctypes.c_void_p]
    got = (ctypes.c_int64 * len(dense_constants()))()
    host_lib.osmr_dense_constants(got)
    assert tuple(got) == dense_constants()


def test_reciprocal_floor_division_equals_python(host_lib):
    """FloorDiv64 (the exact stroke rules' division by two_mx) against
    Python's `//`, divisors 2 ... 2**40, on the edge numerators and on
    random and wrapped (product modulo 2**64) ones."""
    rng = np.random.default_rng(5)
    lo, hi = -(1 << 63), (1 << 63) - 1
    divisors = set(range(2, 70))
    for k in range(2, 41):
        divisors |= {(1 << k) - 1, 1 << k, (1 << k) + 1}
    divisors |= set(int(d) for d in rng.integers(2, (1 << 40) + 1, 150))
    rand = rng.integers(lo, hi, 400, dtype=np.int64, endpoint=True)
    with np.errstate(over="ignore"):
        wrapped = (rng.integers(lo, hi, 300, dtype=np.int64, endpoint=True)
                   * rng.integers(-(1 << 40), 1 << 40, 300, dtype=np.int64))
    for d in sorted(divisors):
        edge = [0, 1, -1, d, -d, d - 1, 1 - d, d + 1, -d - 1, 2 * d, -2 * d, lo, hi, lo + 1,
                hi - 1, lo + d, hi - d, -(-lo // d) * d, -(-lo // d) * d + 1, (hi // d) * d,
                (hi // d) * d - 1]
        n = np.concatenate([np.array(edge, np.int64), rand, wrapped])
        out = np.empty_like(n)
        host_lib.host_floor_div64(n.ctypes.data, n.size, d, out.ctypes.data)
        want = np.array([int(v) // d for v in n.tolist()], np.int64)
        bad = np.flatnonzero(out != want)
        assert bad.size == 0, f"d={d}: {n[bad[0]]} // d gave {out[bad[0]]}, want {want[bad[0]]}"
