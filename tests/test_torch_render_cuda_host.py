"""csrc/render.cu's own arithmetic on the CPU.

g++ compiles the kernel source behind tests/cuda_host/cuda_runtime.h, a
header that stands in for the CUDA pieces it uses (qualifiers, thread
and block indices, a block's threads as coroutines meeting at their
warp's ballots and at __syncthreads, the launch's dynamic shared
memory), with the one `render_kernel<<<...>>>` launch rewritten to run
its blocks on the host and the kernel's `extern __shared__` array
pointed at the launch's buffer; the PTX cp.async copies are plain
copies there (render.cu's `#ifdef __CUDA_ARCH__`).  With
ops/render_cuda.py's CUDA branch pointed at that build for CPU tensors
(its argument packing and ops/build.py's ctypes declarations as on the
card), the plain entry (`render_batch_planar`), the arena entry
(`render_arena_planar`, the arena's rows read through the batch's
index) and the labeled arena entry (`render_arena_planar_labeled`, the
label blend in the kernel's finalize) must give the CPU path's bytes
exactly: the twin, and for the labeled entry the twin followed by
`label_slab.expand_ltriples` and `blit_planar`.  Batches: minicity z15
tiles at ts 256 and @2x at ts 512 with their label layers from the
port's labeler, the oversize scene (host-rasterized KIND_LAYER chunks
between fills) and the icon-fill scene (KIND_FILL_IMAGE); label triples
that start and stop inside a 32-row band, span two bands, cover a whole
tile, are empty (n = 0) or read the slab's identity row 0.  What only
the card shows (nvcc's code, cp.async, the launch configuration, blocks
in parallel) is chip_smoke.py's, phases 3 and 4b.
"""

import contextlib
import ctypes
import os
import re
import subprocess

import numpy as np
import pytest
import torch

import chip_smoke
from osm_renderer_tpu_torch.ops import build as B
from osm_renderer_tpu_torch.ops import chunk_layout as CL
from osm_renderer_tpu_torch.ops import render_cuda as RC
from osm_renderer_tpu_torch.parallel import label_slab as LS

from tests.test_torch_helpers import STYLESHEET_DIR, make_minicity_osm, port_styler, torch_threads

HERE = os.path.dirname(os.path.abspath(__file__))
# render_kernel<<<grid, NTHREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(p);
_LAUNCH = re.compile(
    r"(render_kernel)<<<(\w+), (\w+), (\w+), static_cast<cudaStream_t>\(stream\)>>>\((\w+)\);")
# extern __shared__ __align__(16) float smem[];
_SHARED = re.compile(r"extern __shared__ __align__\(16\) float (\w+)\[\];")

# Minicity z15 tiles (zoom_tiles order): 0 unlabeled, 1, 2, 6 and 7
# labeled, 6 and 7 with 112-128 chunks; 6 and 7 again at @2x.
CITY_BATCHES = {"minicity_z15": ((0, 1, 2, 6, 7), 1), "minicity_z15_2x": ((6, 7), 2)}
# Label triples (off, y0, n) per tile of each city batch: inside band 0
# (rows 5-24), across the band edges at 64 (rows 40-69), empty, the
# identity row 0 and rows 1-2 (rows 100-102), the tile's last 56 rows;
# at ts 512 rows 300-339 (bands 9 and 10, mid-band both ends) and the
# whole tile.
TRIPLES = {"minicity_z15": [(7, 5, 20), (30, 40, 30), (0, 0, 0), (0, 100, 3), (60, 200, 56)],
           "minicity_z15_2x": [(3, 300, 40), (50, 0, 512)]}


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """csrc/render.cu built by g++ for the host -> the loaded library,
    declared as ops/build.py declares the card's."""
    src = open(os.path.join(B.CSRC_DIR, "render.cu")).read()
    assert len(_LAUNCH.findall(src)) == 1, "render.cu's launch changed; update _LAUNCH"
    assert len(_SHARED.findall(src)) == 1, "render.cu's shared array changed; update _SHARED"
    src = _LAUNCH.sub(lambda m: (f"host_launch({m[2]}, dim3({m[3]}), {m[4]}, "
                                 f"[&] {{ (void)stream; {m[1]}({m[5]}); }});"), src)
    src = _SHARED.sub(lambda m: f"float* {m[1]} = static_cast<float*>(host_dynamic_shared());",
                      src)
    tmp = tmp_path_factory.mktemp("render_host")
    cpp, so = tmp / "render_host.cpp", tmp / "librender_host.so"
    cpp.write_text(src)
    proc = subprocess.run(
        ["g++", "-std=c++17", "-O2", "-ffp-contract=off", "-fPIC", "-shared",
         "-I", os.path.join(HERE, "cuda_host"), "-o", str(so), str(cpp)],
        capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return B.bind_render(ctypes.CDLL(str(so)))


@pytest.fixture
def on_host(host_lib):
    """-> a context manager under which render_cuda takes its CUDA branch
    for CPU tensors, launching the host build: no stream, no device."""

    class _Stream:
        cuda_stream = None

    @contextlib.contextmanager
    def kernel():
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(B, "render_library", lambda *a: host_lib)
            mp.setattr(RC, "on_cuda", lambda t, what: True)
            mp.setattr(torch.cuda, "current_stream", lambda *a: _Stream())
            mp.setattr(torch.cuda, "device", lambda *a: contextlib.nullcontext())
            yield

    return kernel


@pytest.fixture(scope="module")
def batches(tmp_path_factory):
    """Every batch of this file on the CPU, with its twin's output:
    name -> {plain, arena, ts, twin} and, for the city batches, the
    labeled PreparedBatch (`labeled`); the scenes are chip_smoke.py's."""
    from osm_renderer_tpu_torch.draw.labels.labeler import Labeler
    from osm_renderer_tpu_torch.geodata.importer import import_osm
    from osm_renderer_tpu_torch.geodata.reader import GeodataReader
    from osm_renderer_tpu_torch.parallel.renderer import BatchRenderer
    from osm_renderer_tpu_torch.tools.corpus import zoom_tiles

    tmp = tmp_path_factory.mktemp("render_host_city")
    bin_path = str(tmp / "minicity.bin")
    import_osm(make_minicity_osm(tmp), bin_path)
    reader = GeodataReader.load(bin_path)
    styler = port_styler()
    labeler = Labeler(icon_base_path=STYLESHEET_DIR)
    tiles = zoom_tiles(reader, 15)
    arena_r = BatchRenderer(styler, stylesheet_dir=STYLESHEET_DIR, chunk_cache_tiles=64,
                            device="cpu", arena=True)
    plain_r = BatchRenderer(styler, stylesheet_dir=STYLESHEET_DIR, chunk_cache_tiles=64,
                            device="cpu", arena=False)
    out = {}
    with torch_threads(1):
        for name, (idx, scale) in CITY_BATCHES.items():
            te = [(reader.get_entities_in_tile_with_neighbors(tiles[i]), tiles[i]) for i in idx]
            ts = 256 * scale
            compacts = [labeler.ensure_layer(e, t, float(scale), styler, ts) for e, t in te]
            pa, pp = arena_r.prepare(te, scale), plain_r.prepare(te, scale)
            pl = arena_r.prepare(te, scale, label_layers=compacts)
            assert pa.arena_packed is not None and pp.arena_packed is None
            assert pl.label_rows is not None and len(pl.device_labeled) >= 2
            out[name] = dict(plain=(pp.batch, pp.canvas_rgb), ts=ts, labeled=pl,
                             arena=lambda r=arena_r, p=pa: r.render_prepared_planar(p))
        for kind, want_kind in (("oversize", CL.KIND_LAYER), ("icon", CL.KIND_FILL_IMAGE)):
            prep, arena, _ = chip_smoke.scene_batch("cpu", kind == "icon",
                                                    str(tmp_path_factory.mktemp(kind)))
            assert want_kind in prep.batch.chunk_i[:, RC.CI_KIND].tolist()
            out[kind] = dict(plain=(prep.batch, prep.canvas_rgb), ts=256, arena=arena)
        for d in out.values():
            b, c = d["plain"]
            d["twin"] = RC.render_batch_planar_reference(b, c, d["ts"])
    return out


@pytest.mark.parametrize("name", [*CITY_BATCHES, "oversize", "icon"])
def test_host_build_plain_and_arena_entries_equal_the_twin(batches, on_host, name):
    d = batches[name]
    b, c = d["plain"]
    before = RC.RENDER_KERNEL_LAUNCHES
    with on_host():
        got_plain = RC.render_batch_planar(b, c, d["ts"])
        got_arena = d["arena"]()
    assert RC.RENDER_KERNEL_LAUNCHES == before + 2
    want = d["twin"]
    for entry, got in (("plain", got_plain), ("arena", got_arena)):
        n = int((got != want).sum())
        assert n == 0, f"{name}: the {entry} entry differs from the twin in {n} bytes"
    assert (want[:, :3] != want[:, :3, :1, :1]).any()  # something painted


def _plane(rng, cap, ts):
    """A slab plane: random colour words (the top byte too, which the
    blend masks off) and A - 1 in [0, 65535]; row 0 the identity row."""
    plane = np.empty((cap, 2, ts), np.int32)
    plane[:, 0] = rng.integers(-2**31, 2**31, (cap, ts), dtype=np.int64).astype(np.int32)
    plane[:, 1] = rng.integers(0, 65536, (cap, ts))
    plane[0, 0], plane[0, 1] = 0, LS.IDENTITY_A16P
    return torch.from_numpy(plane)


@pytest.mark.parametrize("name", list(CITY_BATCHES))
def test_host_build_labeled_entry_equals_twin_then_blit(batches, on_host, name):
    """The labeler's layers through the renderer's slab, then the
    synthetic triples over a random plane."""
    d = batches[name]
    pl, ts, twin = d["labeled"], d["ts"], d["twin"]
    arena, prof, tot, pat, _ = pl.arena_ctx
    slab_plane = pl.label_ctx[0].plane
    synthetic = np.array(TRIPLES[name], np.int32)
    rng = np.random.default_rng(ts)
    cases = [(pl.label_rows, slab_plane),
             (synthetic, _plane(rng, int((synthetic[:, 0] + synthetic[:, 2]).max()) + 8, ts))]
    for i, (tri, plane) in enumerate(cases):
        with on_host():
            got = RC.render_arena_planar_labeled(pl.arena_packed, tri, arena, prof, tot, pat,
                                                 pl.canvas_rgb, ts, pl.chunk, plane)
        lrow = LS.expand_ltriples(torch.from_numpy(tri), ts)
        want = LS.blit_planar(twin, plane, lrow)
        n = int((got != want).sum())
        assert n == 0, f"{name} case {i}: the labeled entry differs from twin + blit in {n} bytes"
        labeled = (lrow != 0)[:, None, :, None].expand_as(want)
        assert torch.equal(want[~labeled], twin[~labeled])
        assert not torch.equal(want[labeled], twin[labeled])


def test_host_build_refuses_half_a_label_pair(batches, on_host):
    """The C entry refuses triples without a plane (cudaErrorInvalidValue,
    raised by the wrapper); the wrapper's check refuses it first."""
    d = batches["icon"]
    b, c = d["plain"]
    tri = torch.zeros((1, 3), dtype=torch.int32)
    with on_host():
        with pytest.raises(RuntimeError, match="cudaError_t 1"):
            RC._launch(b, c, 256, None, tri, None)
        with pytest.raises(RC.BatchLayoutError):
            RC.render_batch_planar(b, c, 256, label_tri=tri)
        with pytest.raises(RC.BatchLayoutError):
            RC.render_batch_planar(b, c, 256, label_tri=tri,
                                   label_plane=torch.zeros((4, 2, 128), dtype=torch.int32))


def test_labeled_cuda_branch_is_one_launch_with_the_labels(batches, monkeypatch):
    """The CUDA branch of render_arena_planar_labeled, with a fake render
    library that records its arguments: one launch, handed the batch's
    triples (uploaded with the packed buffer) and the slab plane itself;
    neither expand_ltriples nor blit_planar runs, and no torch op follows
    the launch.  The unlabeled entry hands null label pointers."""
    from torch.utils._python_dispatch import TorchDispatchMode

    pl = batches["minicity_z15"]["labeled"]
    arena, prof, tot, pat, _ = pl.arena_ctx
    plane = pl.label_ctx[0].plane
    calls, ops = [], []

    class FakeLib:
        def osmr_render_planar(self, *args):
            tri_ptr, plane_ptr, cap = args[15:18]
            tri = None if tri_ptr is None else np.ctypeslib.as_array(
                (ctypes.c_int32 * (3 * pl.chunk)).from_address(tri_ptr)).reshape(-1, 3).copy()
            calls.append(dict(tri=tri, plane_ptr=plane_ptr, cap=cap, out_ptr=args[18]))
            ops.append("launch")
            return 0

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            ops.append(str(func))
            return func(*args, **(kwargs or {}))

    class _Stream:
        cuda_stream = None

    def refuse(*a, **k):
        raise AssertionError("the CUDA branch ran the blit's plain version")

    monkeypatch.setattr(B, "render_library", lambda *a: FakeLib())
    monkeypatch.setattr(RC, "on_cuda", lambda t, what: True)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: _Stream())
    monkeypatch.setattr(torch.cuda, "device", lambda *a: contextlib.nullcontext())
    monkeypatch.setattr(LS, "blit_planar", refuse)
    monkeypatch.setattr(LS, "expand_ltriples", refuse)
    before = RC.RENDER_KERNEL_LAUNCHES
    with Record():
        out = RC.render_arena_planar_labeled(pl.arena_packed, pl.label_rows, arena, prof, tot,
                                             pat, pl.canvas_rgb, pl.ts, pl.chunk, plane)
    assert RC.RENDER_KERNEL_LAUNCHES == before + 1 and len(calls) == 1
    assert ops.count("launch") == 1 and ops[-1] == "launch", ops[-5:]
    got = calls[0]
    np.testing.assert_array_equal(got["tri"], pl.label_rows)
    assert got["plane_ptr"] == plane.data_ptr() and got["cap"] == plane.shape[0]
    assert got["out_ptr"] == out.data_ptr() and tuple(out.shape) == (pl.chunk, 4, pl.ts, pl.ts)
    RC.render_arena_planar(pl.arena_packed, arena, prof, tot, pat, pl.canvas_rgb, pl.ts,
                           pl.chunk)
    assert calls[1]["tri"] is None and calls[1]["plane_ptr"] is None and calls[1]["cap"] == 0
