"""csrc/dense.cu's own arithmetic on the CPU.

g++ compiles the kernel source behind tests/cuda_host/cuda_runtime.h, a
header that stands in for the few CUDA pieces it uses (qualifiers,
thread indices, warp ballots as 32 host threads, atomicMax), with each
`kernel<<<...>>>(...)` launch rewritten to run its blocks on the host.
Its three entry points, called through ops/dense_cuda.py's own argument
packing (`_launch`), must give `render_dense.render_batch_plain`'s
pending buffer and bytes (its `alphas`, then its `blend`), in both
precisions: on the chained scenes of test_torch_dense_cuda.py, the
icon-fill scene, one fill of 700 edges (a 1024-lane bucket: the fill
kernel's global scratch) and the @2x scene.  This checks the kernels' integer and float
semantics where no card is: the wrapping arithmetic, floor division, the
five FMA sites, the counted rank over the compacted active edges, the
paint-order walk.  What only the card shows (nvcc's code, the launch
configuration, the device's conversions) is `chip_smoke.py` phase 4c's.
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

from tests.test_torch_dense_cuda import CHAIN_SCENES
from tests.test_torch_helpers import torch_threads
from tests.test_torch_render import scene_2x
from tests.test_torch_render_dense import CHUNK, build, canvas, scene_icon, write_icon

HERE = os.path.dirname(os.path.abspath(__file__))
# kernel<<<grid, block, 0, s>>>(args);
_LAUNCH = re.compile(r"(dense_\w+<[^<>]*>)<<<(.*?), (\w+(?: \* \w+)?), 0, s>>>\((.*?)\);",
                     re.S)


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """csrc/dense.cu built by g++ for the host -> the loaded library."""
    src = open(os.path.join(CSRC_DIR, "dense.cu")).read()
    assert len(_LAUNCH.findall(src)) == 6, "dense.cu's launches changed; update _LAUNCH"
    src = _LAUNCH.sub(lambda m: (f"host_launch(dim3({m[2]}), dim3({m[3]}), "
                                 f"{'true' if 'fill' in m[1] else 'false'}, "
                                 f"[&] {{ (void)s; {m[1]}({m[4]}); }});"), src)
    tmp = tmp_path_factory.mktemp("dense_host")
    cpp, so = tmp / "dense_host.cpp", tmp / "libdense_host.so"
    cpp.write_text(src)
    proc = subprocess.run(
        ["g++", "-std=c++17", "-O2", "-ffp-contract=off", "-fPIC", "-shared", "-pthread",
         "-I", os.path.join(HERE, "cuda_host"), "-o", str(so), str(cpp)],
        capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-4000:]
    lib = ctypes.CDLL(str(so))
    Pt, I = ctypes.c_void_p, ctypes.c_int
    lib.osmr_dense_stroke_alpha.argtypes = [Pt, Pt, I, I, Pt]
    lib.osmr_dense_fill_alpha.argtypes = [Pt, Pt, I, Pt]
    lib.osmr_dense_blend_finalize.argtypes = [Pt, Pt, I, Pt]
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


SCENES = {
    "chain": (CHAIN_SCENES, 256, CHUNK),
    "icon": ([scene_icon], 256, CHUNK),
    "large_fill": ([_large_fill], 256, 1024),
    "2x": ([lambda prim: scene_2x(prim)[1]], 512, CHUNK),
}


@pytest.mark.parametrize("precision", ["exact", "fast"])
@pytest.mark.parametrize("scene", list(SCENES))
def test_host_build_of_the_kernels_equals_the_plain_version(host_launch, tmp_path, scene,
                                                            precision):
    from osm_renderer_tpu_torch.draw.labels.icons import IconCache

    fns, ts, chunk = SCENES[scene]
    write_icon(tmp_path)
    arrays, chain = build(P, [f(P) for f in fns], ts, chunk, precision,
                          IconCache(str(tmp_path)))
    plan = RD.plan_batch(arrays, ts, chunk, precision)
    pack = DC.pack_plan(plan, len(arrays.geom))
    batch = RD.TileBatch.from_numpy(arrays, "cpu")
    c = torch.from_numpy(canvas(precision))
    if scene == "large_fill":
        assert pack.e_max > DC.SMEM_EDGES
    # The kernels, launched as dense_cuda.render_batch launches them on a
    # card (a small fill grid: its warps stride over the rows).
    pending = DC.new_pending(batch, pack)
    host_launch("dense_stroke_alpha", batch, pack, pending, chain=chain)
    blocks = 2
    scratch = None
    if pack.e_max > DC.SMEM_EDGES:
        isz = 8 if precision == "exact" else 4
        scratch = torch.zeros(blocks * DC.FILL_WARPS * pack.e_max * (2 * isz + 4),
                              dtype=torch.uint8)
    host_launch("dense_fill_alpha", batch, pack, pending, scratch=scratch, fill_blocks=blocks)
    out = torch.empty((pack.n_tiles, ts, ts, 3), dtype=torch.uint8)
    host_launch("dense_blend_finalize", batch, pack, pending, canvas=c, out=out)
    with torch_threads(1):
        want_pending = RD.alphas(batch, plan, chain)  # render_batch_plain's two phases
        want = RD.blend(batch, c, plan, want_pending)
    assert torch.equal(pending, want_pending)
    n = int((out != want).any(-1).sum())
    assert n == 0, f"{scene} {precision}: {n} pixels differ from the plain version"
    assert (want != want[0, 0, 0]).any()
