#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on NVIDIA GPUs (one is enough).

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase is skipped):

1. Card and toolchain: nvidia-smi name and power limit, torch and CUDA
   versions; the three kernel sources (csrc/render.cu, csrc/rle.cu,
   csrc/dense.cu) built by nvcc at once, with build times and ptxas
   reports; the host libraries built with g++ (csrc/wire_host.cpp among
   them) and the png writer of the served path printed.
2. Fixtures: the synthetic cities (tools/make_fixture.py --blocks 24 and
   48, then the port's geodata.importer.import_osm) under
   assets/fixtures/.
3. Render kernel against its plain PyTorch twin on the card, on real
   batches: every minicity z15 tile, the bigcity z15 tiles (split under
   MAX_BATCH_CHUNKS the way the server splits), @2x, @3x and @4x batches,
   a z13/z14 batch (per-segment strokes), an oversize-fill scene (host
   layers) and an icon-fill scene (pattern blend).
   Bar: byte-identical (max |diff| 0, no pixel painted by one and not
   the other).  Kernel time (CUDA events, mean of 5 after a warm launch,
   and device time with the host's enqueue hidden, `device_ms`) beside
   the twin's time on the same batch, the batch's bound (the bytes
   the function needs from the batch's data and writes, over 3.35 TB/s,
   or its blend operations over 67 TFLOP/s f32, the larger) and the
   kernel's share of it.  Every batch
   also renders through the arena entry (one packed upload; the kernel
   reads the device chunk arena's rows through the batch's row index);
   bar: byte-identical to the plain-upload entry, and its ms.
3b. The render kernel's device ms by chunk kind on the bigcity z15
   batch (osm_renderer_tpu_torch.tools.kdecomp_device: full, floor_only,
   fills_only, spans_only, items_only, seg_only, layers_only; the other
   kinds' chunks turned into padding; torch.profiler's kernel time, 8
   calls).  Bars: `full` byte-identical to the unmodified batch, and
   within 10 % of phase 3's device_ms for it.
4. Wire kernels against their plain versions on the card, on every
   phase-3 planar batch and three synthetic ones (a uniform T=1 ts=1024
   batch, a T=2 ts=256 per-pixel checkerboard, a T=3 ts=768 batch of
   random runs): the v1 wire (one launch, the run emit's work) and the
   v2 wire (one launch, the run emit's and the palette expand's work)
   with a palette learned from the batch's own runs, a half palette and
   an all-PAL_PAD palette, each at a cap that fits and at one that
   overflows; on the bigcity z15 and minicity @2x batches also at the
   edge caps (rtot = total_runs and total_runs - 1; a wcap right after a
   literal's header word, right after its lo16 word, on a tile boundary,
   and below total_runs).  Bar: bit-identical wires, and on overflow a
   header total above the cap.  The fitting wires decode to the planar
   batch's pixels.  On those two batches, each wire's wrapper ms
   (`time_ms`) and device ms (`device_ms`) beside plain ms and its byte
   bound; wire bytes against raw planar bytes.  Every tile of the
   learned v2 wire decodes to the batch's pixels through the numpy plain
   version and through the served view (RleTileView over the host codec,
   draw/png8.py); the view's PNG-8 of every tile of at most 256 colours
   is colour type 3 and decodes to those pixels, and the other tiles
   (palette overflows, served as RGB) are counted.  On the timed batches,
   host ms per tile of the port's v2 and v1 decoders beside the numpy
   ones, of its v2 decode to palette-index rows alone, of its PNG-8 writer beside png_writer's RGB PNG (zlib over
   unfiltered rows), and PNG bytes per tile by container.
4b. The labeled arena entry (one render-kernel launch whose u8
   finalize also blends the device label slab's rows) on the minicity
   z15 batch, its @2x batch, two of its labeled tiles at @4x (ts 1024)
   and the bigcity z15 halves, with label layers from the port's
   fontTools-free labeler; every batch carries labeled tiles.  Bars: (a)
   byte-identical to blit_planar run on the CPU over the unlabeled arena
   entry's output with a CPU copy of the slab plane; (b) every tile
   within 1/255 of the host composite (composite_labels) over that
   unlabeled output; (c) alpha = 1 label cores and every pixel outside a
   layer's bbox byte-identical to it; (d) byte-identical to the
   unlabeled entry followed by expand_ltriples and blit_planar on the
   card; (e) the unlabeled entry's torch operators (views aside), none
   after the render launch (a TorchDispatchMode records them), with
   each entry's device operations a call by torch.profiler printed
   beside (a trace can drop records, so they are not a bar).  Labeled-entry ms beside
   unlabeled-entry ms (CUDA events, and device ms with the enqueue
   hidden), the blend's plain version's ms on the card, the epilogue's
   byte bound (labeled rows x 2 x ts x 4 bytes over 3.35 TB/s), slab
   rows and bytes.
4c. The dense renderer of `precision = exact` and its fast twin: its
   three kernels (csrc/dense.cu: dense_stroke_alpha, dense_fill_alpha,
   dense_blend_finalize, via ops/dense_cuda.py) against the plain
   version (ops/render_dense.py::render_batch_plain).  (a) In both
   precisions, on the oversize-coordinate, icon-fill (walk chain off)
   and large-fill (a 1024-lane edge bucket: the fill kernel's global
   scratch) scenes, 4 minicity z15 tiles and 2 at @2x, @3x and @4x,
   all 30 minicity z15 tiles and 12 at @2x, the first 16 and all 97
   bigcity z15 tiles and the production stylesheet's 30 minicity z15
   tiles (chain printed for each): the kernels byte-identical to the
   plain version on the card and, but for minicity x30, @2x x12 and
   bigcity x97 (the CPU takes ~0.3-1.3 s a tile), on the CPU, and each
   kernel to its plain function on the card; (b) the
   kernels' exact minicity z15 tiles within 1/255 of CpuDrawer, < 1 % of
   values off; (c) on minicity z15 x30, its 12 tiles @2x and bigcity
   z15 x97, both precisions: each kernel's device ms (enqueue hidden)
   beside its bound (`dense_bounds`), its plain function's ms and the
   first design's ms (`EARLIER_DENSE_MS`), and its registers, spill
   bytes, static shared memory and resident CTAs an SM (the fill's in
   both precisions on a line of their own), the fill kernel's units and
   rows a unit beside its time; the batch's ms
   through the kernels and through the plain version, its device
   operations (torch.profiler; at most 5 through the kernels) and peak
   memory, each way.
5. The served path: `python -m osm_renderer_tpu_torch.cli.renderer_main`
   with backend = device, device = cuda, labels = yes on the minicity,
   under the import guard of phase 7; >= 32 distinct
   tiles requested concurrently (z13-z17, @1x and @2x); every response
   HTTP 200 with a valid PNG; unlabeled tiles within 1/255 of the C++
   oracle (CpuDrawer), labeled tiles within 2/255 of the oracle plus the
   host composite; while serving, the server launched the render, emit
   and expand kernels, served at least one arena batch and one v2 wire
   batch, and labeled at least one tile on the device.  Its shutdown
   line `png writer: ...; containers while serving: ...` is printed, its
   writer must be the port's (`port (zlib)`), and its containers are
   held to the responses (`check_containers`): no host label composite,
   the PNGs of colour type 3 are its png8 tiles, and an RGB PNG of at
   most 256 colours is a v1, raw or oracle tile; palette overflows are
   counted.
5b. The same server with precision = exact (labels = yes), the dense
   kernels' main path: >= 16 distinct tiles (z13-z17, @1x and @2x), the
   same bars, only dense batches, no launch of the render, emit or
   expand kernels, and every dense kernel launched while serving (the
   server's `dense kernel launches` lines); its tiles/s printed.  Its
   containers (`check_exact_containers`): raw batches and host labels
   only, so no PNG-8, and its rgb_raw and rgb_host_labels tiles sum to
   the tiles its renderer drew.  (The
   fast servers of phases 5, 8 and 10 launch no dense kernel.)
6. Warm served path in this process (PNG cache off): per-tile spans of
   warm minicity z15 and bigcity z15 batches with labels off, and of
   minicity z15 with labels on.
6b. The serving path's own records on the card:
   tests/test_torch_trace_card.py in a fresh process.  Bars: on one
   traced warm batch, every render and wire kernel inside its dispatch's
   logged intervals (0.5 ms either way), and the CUDA-event "Device time
   (batch share)" within 15 % of the profiler's render, memset and wire
   operations.
8. Serving on several renderers: one a GPU when the host has G >= 2,
   else two on cuda:0 (the split, each renderer's own arena, slab,
   palette and wires, and the gather).  (a) MeshTileRenderer
   byte-identical to one BatchRenderer on the 30 minicity and 97
   bigcity z15 tiles; (b) a multi-renderer TileService (labels on, PNG
   cache off) serves 52 minicity tiles (z13-z17, @2x) byte-identical to
   a one-renderer service, cold and warm, or, where a v1 and a v2 wire
   met, with the same pixels in another container, and each service's
   PNGs held to its count of containers as in phase 5; (c) more than one renderer
   rendered, each used one holds arena rows and ran v1 batches until
   its first wire was read back (two: the cold group streams in
   sub-batches), then v2 batches, and the kernel launch counters, set to 0 just before,
   equal the renderers' batches; (d) G >= 2: the CLI with gpus = G
   passes phase 5's bars and spreads tiles over renderers; G = 1:
   TileService(gpus=2) and the CLI with gpus = 2 fail with the
   ValueError; (e) warm bigcity z15 x32 per-tile wall, device execute
   and compose-and-encode shares, one renderer against several; (f) a
   wire made on the last renderer's device (cuda:G-1), a sleep queued
   there behind its kernels, its copy queued while the current device
   is cuda:0: both of its events
   still pending right after start_wire_copy, and the wire read back
   after the wait equal to the batch's pixels (G >= 2 holds the
   events' device; G = 1 only their stream order).
9. The port's tools at scale (osm_renderer_tpu_torch/tools/): (a)
   scale_sweep --labels: the 112-block city (tools/make_fixture.py
   --blocks 112, the port's importer), 915 tiles of z12-z17 served cold,
   warm1 and warm2 through a 160-tile chunk cache, then a dense z14
   group cold and warm; bars: no renderer's arena leaks a row, warm1 and
   warm2 give PNGs of equal sizes, evictions > 0 and halvings > 0, every
   served tile came from the device but the oracle tiles the tool
   counts, and the render, emit and expand kernels launched (their
   counters set to 0 just before, read just after, the render launches
   equal to the renderers' batches); tiles/s of each pass and the
   counters printed; (b) the same 915 tiles on an unpressured service
   (a 4096-tile cache, the default arena) decode to warm2's pixels; (c)
   parity_check --all-z 13 on the same city, labels off: worst <=
   1/255; (d) warmup, profile_serving, cold_profile, ktime and kdecomp
   (the last two, which read torch.profiler, in processes of their own)
   at their defaults exit 0, and kdecomp's `full` is within 10 % of
   phase 3's device ms on bigcity z15.  Each sub-phase's wall time is
   printed with the card's name and power limit.
10. The reference's production stylesheet (tests/fixtures/mapcss/
   osmosnimki-minimal.mapcss, type mapsme), then the port's benchmark.
   (a) The render kernel against its twin on minicity z15, z16 and
   z17 @2x (12 middle tiles) and bigcity z15, split as the server
   splits, with phase 3's bars, times and bounds, and every tile but
   the oracle's within 1/255 of CpuDrawer, labels off; both wires on
   those batches with phase 4's bars (bigcity z15 also at the edge caps,
   and timed); the labeled entry with phase 4b's bars; renderer_main
   with type = mapsme with phase 5's bars (log
   build/smoke/server_mapsme.log).  Prints the chunk-kind counts beside
   phase 3's, the halvings, slab rows, the blit's ms and the raw-wire
   batches.  (b) The render kernel against its twin, with phase 3's
   bars, on each render batch of the bench's that phase 3 does not
   hold, at the bench's shapes: its default-stylesheet minicity
   pyramid (z12, z13, z14, z15, z16, z17, and the z12-z17 fold, split
   as the server splits) and its 16-tile @2x batch; then
   `python -m osm_renderer_tpu_torch.bench` in a subprocess under the
   import guard (stderr in build/smoke/bench.log), its JSON line
   printed on a line of its own.  Bars: exit 0, correct true (its
   served tiles held to their wires and to CpuDrawer among its checks),
   every metric a positive number, each kernel launched, and the card
   it names the one phase 1 names; its png writer and
   e2e_png_containers printed.
7. None of jax, jaxlib, fontTools or the JAX package osm_renderer_tpu
   was loaded (the import guard refuses all four here and in the
   server).  Phase 7 runs last.

The second-to-last line is the kernels JSON object (each kernel's "ms"
is its device ms on the bigcity z15 batch: the render kernel's, the v1
wire's for rle_emit, the whole v2 wire's for rle_expand, each dense
kernel's in the exact precision; "max_abs_err" covers phases 3, 4 and
10, the bench's render batches among them, and phase 4c for the dense
kernels; "launches" are phase 10 (b)'s, the bench's, and for the dense
kernels phase 5b's, the exact server's;
the sweep's and the mapsme server's are printed in phase 10;
render_planar's entry also has a "note": on the labeled arena entry its
finalize blends the label slab), the last line
{"ok": true, "device": {...}}.  Without a CUDA device, or outside a
checkout of the repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import concurrent.futures
import io
import json
import os
import subprocess
import sys
import time
import urllib.request

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "build", "smoke")
STYLESHEET_DIR = os.path.join(ROOT, "assets", "stylesheets")
# The reference's production stylesheet (phase 10).
PROD_DIR = os.path.join(ROOT, "tests", "fixtures", "mapcss")
PROD_SHEET = "osmosnimki-minimal.mapcss"
# (directory, file, type) of each stylesheet the smoke run serves.
DEFAULT_STYLE = (STYLESHEET_DIR, "default.mapcss", "josm")
PROD_STYLE = (PROD_DIR, PROD_SHEET, "mapsme")
MINI_OSM = os.path.join(ROOT, "assets", "fixtures", "minicity.osm")
MINI_BIN = os.path.join(ROOT, "assets", "fixtures", "minicity.bin")
BIG_OSM = os.path.join(ROOT, "assets", "fixtures", "bigcity.osm")
BIG_BIN = os.path.join(ROOT, "assets", "fixtures", "bigcity.bin")
# name -> (source, the TPU kernel it replaces)
KERNELS = {
    "render_planar": ("osm_renderer_tpu_torch/csrc/render.cu",
                      "osm_renderer_tpu/ops/render_pallas.py:1281"),
    "rle_emit": ("osm_renderer_tpu_torch/csrc/rle.cu",
                 "osm_renderer_tpu/ops/rle_pallas.py:56"),
    "rle_expand": ("osm_renderer_tpu_torch/csrc/rle.cu",
                   "osm_renderer_tpu/ops/rle_pallas.py:312"),
}

# What a kernel does beyond the TPU kernel it replaces, printed beside it.
KERNEL_NOTES = {
    "render_planar": "on the labeled arena entry its u8 finalize also blends the label "
                     "slab's rows (label_slab.blit_planar's work, which the JAX package ran "
                     "in XLA after its kernel)",
}

# The dense kernels of `precision = exact` (phase 4c, served in phase 5b):
# name -> (source, the function of the JAX package's jitted exact
# program, render_jnp.render_batch, whose work it does; that program
# reaches no Pallas kernel).
DENSE_KERNELS = {
    "dense_stroke_alpha": ("osm_renderer_tpu_torch/csrc/dense.cu",
                           "osm_renderer_tpu/ops/render_jnp.py:158"),
    "dense_fill_alpha": ("osm_renderer_tpu_torch/csrc/dense.cu",
                         "osm_renderer_tpu/ops/render_jnp.py:308"),
    "dense_blend_finalize": ("osm_renderer_tpu_torch/csrc/dense.cu",
                             "osm_renderer_tpu/ops/render_jnp.py:402"),
}

# Top-level packages the port must not load: jax, the JAX package
# itself, and fontTools (so the port's own font reader is what runs, on a
# card that has fontTools as on one that lacks it).
REFUSED = ("jax", "jaxlib", "fontTools", "osm_renderer_tpu")
# Installed in this process and in the server subprocess: any import of a
# refused package fails loudly instead of loading.
_NO_JAX = f"""
import importlib.abc, sys
class _NoJax(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in {REFUSED!r}:
            raise ImportError("the CUDA port must not import " + name)
        return None
sys.meta_path.insert(0, _NoJax())
"""


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    return 1


def build_fixtures() -> None:
    from osm_renderer_tpu_torch.tools.corpus import build_fixture

    for osm, binf, blocks in ((MINI_OSM, MINI_BIN, 24), (BIG_OSM, BIG_BIN, 48)):
        build_fixture(osm, binf, blocks)


def painted(planar, canvas_u8):
    """(T, ts, ts) bool: pixels whose RGB differs from the canvas."""
    import torch

    c = torch.tensor(canvas_u8, dtype=torch.uint8, device=planar.device)[None, :, None, None]
    return (planar[:, :3] != c).any(dim=1)


def time_ms(fn, reps: int = 5) -> float:
    """Mean ms of `reps` launches of fn() after one warm launch (CUDA
    events around the run)."""
    import torch

    fn()
    torch.cuda.synchronize()
    ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    ev0.record()
    for _ in range(reps):
        fn()
    ev1.record()
    torch.cuda.synchronize()
    return ev0.elapsed_time(ev1) / reps


# The card's published peaks (NVIDIA H100 SXM data sheet): HBM3 bytes/s
# and float32 operations/s outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def render_bound(b, canvas, ts):
    """Least time the card could take for one render batch -> (ms, "bytes"
    or "operations", bytes, ops).

    Bytes: what the function needs from this batch's data, each read
    once, and the u8 output.  Every chunk's int header; the float header
    of each chunk that is not padding; the column window (isec slot 0) of
    fill and tent-lane chunks, and the section ends and the items up to
    the last section end of work-item chunks.  Over each chunk's CI_CNT
    live lanes only, the lane fields its kind reads: fill spans geom rows
    0-2; tent lanes geom and aux rows 0-2; work items geom, aux rows 0-2
    and trav (and sprof when dashed); per-segment strokes all of these.
    The profile rows those segments name, and of each pattern the rows a
    blend reads.  Aux row 3, padding chunks' lanes, the item columns past
    a chunk's last section end and the dead lanes are never needed.

    Operations: the src-over blends that every CI_LAST chunk applies over
    its primitive's rows (8 f32 operations a pixel) and the finalize (7 a
    pixel), which no evaluation order avoids."""
    import numpy as np

    from osm_renderer_tpu_torch.ops import chunk_layout as CL
    from osm_renderer_tpu_torch.ops import render_cuda as RC

    T = b.tile_range.shape[0]
    ci = b.chunk_i.cpu().numpy()
    isec = b.isec.cpu().numpy()
    kind, cnt = ci[:, RC.CI_KIND], ci[:, RC.CI_CNT].astype(np.int64)
    nbytes = ci.nbytes + 4 * RC.NCF * int((kind != CL.KIND_PAD).sum())
    nbytes += 4 * canvas.numel() + 4 * b.tile_range.numel() + T * 4 * ts * ts
    # Bytes of one live lane that each kind reads (geom rows, aux rows,
    # trav, sprof; 4 bytes each).
    lane_bytes = {CL.KIND_FILL: 12, CL.KIND_FILL_IMAGE: 12, CL.KIND_STROKE_SPAN: 28,
                  CL.KIND_STROKE_SOLID: 32, CL.KIND_STROKE_DASH: 36, CL.KIND_STROKE: 36}
    for k, w in lane_bytes.items():
        nbytes += w * int(cnt[kind == k].sum())
    windowed = np.isin(kind, (CL.KIND_FILL, CL.KIND_FILL_IMAGE, CL.KIND_STROKE_SPAN))
    nbytes += 4 * int(windowed.sum())
    itemized = np.isin(kind, (CL.KIND_STROKE_SOLID, CL.KIND_STROKE_DASH))
    nbytes += 4 * CL.NSEC * int(itemized.sum()) + 4 * int(isec[itemized, -1].sum())
    profiled = np.isin(kind, (CL.KIND_STROKE, CL.KIND_STROKE_DASH))
    live = np.arange(CL.CH)[None, :] < cnt[:, None]
    used = np.unique(b.sprof.cpu().numpy()[profiled[:, None] & live])
    nbytes += int(used.size) * 4 * (CL.DS * 8 + 1)
    last = (ci[:, RC.CI_LAST] == 1) & (kind != CL.KIND_PAD)
    pat = ci[:, RC.CI_PAT]
    for q in np.unique(pat[last & (pat >= 0)]):
        blocks = set()
        for y0, nb in ci[last & (pat == q)][:, [RC.CI_PRIM_Y0, RC.CI_PRIM_NB]]:
            blocks.update(range(y0, y0 + nb))
        nbytes += len(blocks) * 32 * ts * 4 * 4
    blend_px = int(ci[last, RC.CI_PRIM_NB].clip(min=0).sum()) * 32 * ts
    ops = 8 * blend_px + 7 * T * ts * ts
    bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    if bytes_ms >= ops_ms:
        return bytes_ms, "bytes", nbytes, ops
    return ops_ms, "operations", nbytes, ops


def compare(name, prepared, canvas_u8, kinds_seen, rows):
    """Kernel vs twin on one prepared batch; appends a result row and
    returns the kernel's output."""
    import torch

    from osm_renderer_tpu_torch.ops import render_cuda as RC
    from osm_renderer_tpu_torch.tools.kdevice import device_ms

    b, canvas, ts = prepared.batch, prepared.canvas_rgb, prepared.ts
    kinds = torch.bincount(b.chunk_i[:, RC.CI_KIND].long(), minlength=10).cpu().tolist()
    for k, n in enumerate(kinds):
        if n:
            kinds_seen.add(k)
    kernel_ms = time_ms(lambda: RC.render_batch_planar(b, canvas, ts))
    kernel_dev_ms = device_ms(lambda: RC.render_batch_planar(b, canvas, ts))
    out_k = RC.render_batch_planar(b, canvas, ts)
    ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    ev0.record()
    out_t = RC.render_batch_planar_reference(b, canvas, ts)
    ev1.record()
    torch.cuda.synchronize()
    twin_ms = ev0.elapsed_time(ev1)
    diff = (out_k.int() - out_t.int()).abs()
    max_diff = int(diff.max().item())
    member = int((painted(out_k, canvas_u8) != painted(out_t, canvas_u8)).sum().item())
    T = b.tile_range.shape[0]
    C = b.chunk_i.shape[0]
    bound_ms, bound_by, nbytes, ops = render_bound(b, canvas, ts)
    log(f"  {name}: T={T} ts={ts} chunks={C} kinds={kinds} max|diff|={max_diff} "
        f"membership_mismatch={member} kernel_ms={kernel_ms:.4f} "
        f"kernel_device_ms={kernel_dev_ms:.4f} twin_ms={twin_ms:.1f} "
        f"bound_ms={bound_ms:.6f} ({bound_by}: {nbytes} B, {ops} f32 ops) "
        f"device share of bound={100 * bound_ms / kernel_dev_ms:.3f}%")
    rows.append(dict(name=name, T=T, ts=ts, chunks=C, kinds=kinds, max_diff=max_diff,
                     member=member,
                     kernel_ms=kernel_ms, kernel_dev_ms=kernel_dev_ms, twin_ms=twin_ms,
                     bound_ms=bound_ms,
                     bound_by=bound_by))
    if max_diff != 0 or member != 0:
        raise AssertionError(f"{name}: kernel disagrees with its twin "
                             f"(max|diff| {max_diff}, membership mismatches {member})")
    return out_k


def compare_arena(name, render_arena, plain_out, rows):
    """The arena entry's output must equal the plain-upload entry's byte
    for byte; records the arena entry's ms (upload, gather and kernel)."""
    import torch

    got = render_arena()
    torch.cuda.synchronize()
    if not torch.equal(got, plain_out):
        n = int((got != plain_out).sum().item())
        raise AssertionError(f"{name}: arena entry differs from the plain entry in {n} bytes")
    arena_ms = time_ms(render_arena)
    rows[-1]["arena_ms"] = arena_ms
    log(f"    arena entry (rows read through the index): byte-identical, "
        f"arena_ms={arena_ms:.4f}")


def scene_prims(icon: bool, out_dir: str = OUT_DIR):
    """The synthetic one-tile scene's primitives -> (prims, the icon
    cache of its fill pattern, written into `out_dir`, or None)."""
    import numpy as np
    from PIL import Image

    from osm_renderer_tpu_torch.draw import primitives as P
    from osm_renderer_tpu_torch.draw.labels.icons import IconCache
    from osm_renderer_tpu_torch.ops.coverage_np import LINE_CAP_BUTT, LINE_CAP_ROUND

    box = np.array([[30, 30, 90, 30], [90, 30, 90, 80], [90, 80, 30, 80], [30, 80, 30, 30]],
                   np.int64)
    if icon:
        rng = np.random.default_rng(7)
        px = rng.integers(0, 256, size=(10, 12, 4), dtype=np.uint8)
        px[..., 3] = rng.integers(60, 256, size=(10, 12), dtype=np.uint8)
        os.makedirs(out_dir, exist_ok=True)
        Image.fromarray(px, "RGBA").save(os.path.join(out_dir, "pattern.png"))
        tri = np.array([[120, 20, 240, 200], [240, 200, 20, 230], [20, 230, 120, 20]], np.int64)
        return [
            P.FillPrim(kind="fill", color=None, opacity=1.0, edges=tri, fill_image="pattern.png"),
            P.make_stroke_prim(np.array([[0, 100, 255, 140]], np.int64), 3.0, (255, 255, 255),
                               1.0, None, LINE_CAP_BUTT, True),
            P.FillPrim(kind="fill", color=None, opacity=1.0, edges=box, fill_image="pattern.png"),
        ], IconCache(out_dir)
    far = 5 * P.FAST_COORD_BOUND
    tri = np.array([[-far, -100, 200, 90], [200, 90, 120, far], [120, far, -far, -100]],
                   np.int64)
    return [
        P.FillPrim(kind="fill", color=(70, 130, 70), opacity=0.9, edges=tri),
        P.make_stroke_prim(np.array([[-far, 60, far, 180]], np.int64), 5.0, (250, 250, 240),
                           1.0, [8.0, 4.0], LINE_CAP_ROUND, True),
        P.FillPrim(kind="fill", color=(180, 40, 40), opacity=1.0, edges=box),
    ], None


def scene_batch(device, icon: bool, out_dir: str = OUT_DIR):
    """A synthetic one-tile scene for the chunk kinds the cities lack:
    an oversize-coordinate fill and round-capped dashed stroke (host
    layers, KIND_LAYER) between two plain fills, or (icon=True) two
    tiled icon fills (KIND_FILL_IMAGE) around a stroke.  -> (plain
    PreparedBatch, arena render callable, canvas u8)."""
    import numpy as np
    import torch

    from osm_renderer_tpu_torch.draw import primitives as P
    from osm_renderer_tpu_torch.ops import chunk_layout as CL
    from osm_renderer_tpu_torch.ops import render_cuda as RC
    from osm_renderer_tpu_torch.parallel.arena import ChunkArena
    from osm_renderer_tpu_torch.parallel.renderer import PreparedBatch

    prims, icon_cache = scene_prims(icon, out_dir)
    patterns = P.PatternTable(icon_cache, 256)
    profiles = P.ProfileTable()
    stream = P.stream_tile_packed(prims, profiles, CL.CH, patterns)
    tc = CL.build_tile_chunks(stream, 256, profiles.chain_free_mask())
    pb = CL.concat_pallas_batch([tc], profiles, 256, patterns)
    canvas = np.array([241, 238, 232], np.float32) / np.float32(255.0)
    b, c = RC.from_numpy_batch(pb, canvas, device)

    arena = ChunkArena(min_cap=64, device=device)
    arena.insert([("scene", tc)])
    packed = CL.pack_small_arena([tc], [arena.offset("scene")])
    prof, tot = (torch.from_numpy(a).to(device) for a in profiles.arrays(np.float32))

    def render_arena():
        return RC.render_arena_planar(packed, arena, prof, tot, b.patterns, c, 256, 1)

    return PreparedBatch(b, c, 256, 1), render_arena, (241, 238, 232)


def default_batches(city, reader):
    """Phase 3's batches of a city: every z15 tile; on the minicity also
    @2x, @3x and @4x batches, on the bigcity a z13+z14 batch (per-segment
    strokes)."""
    from osm_renderer_tpu_torch.tools.corpus import with_entities, zoom_tiles

    z15 = with_entities(reader, zoom_tiles(reader, 15))
    if city == "minicity":
        return [(f"{city}_z15", z15, 1), (f"{city}_z15_2x", z15[:12], 2),
                (f"{city}_z15_3x", z15[:3], 3), (f"{city}_z15_4x", z15[:2], 4)]
    return [(f"{city}_z15", z15, 1),
            (f"{city}_z13_z14", with_entities(reader, zoom_tiles(reader, 13)
                                              + zoom_tiles(reader, 14)), 1)]


def production_batches(city, reader):
    """Phase 10 (a)'s batches: every z15 tile; on the minicity also every
    z16 tile and the 12 middle z17 tiles @2x."""
    from osm_renderer_tpu_torch.tools.corpus import with_entities, zoom_tiles

    batches = [(f"prod_{city}_z15", with_entities(reader, zoom_tiles(reader, 15)), 1)]
    if city == "minicity":
        z17 = zoom_tiles(reader, 17)
        mid = len(z17) // 2
        batches += [(f"prod_{city}_z16", with_entities(reader, zoom_tiles(reader, 16)), 1),
                    (f"prod_{city}_z17_2x", with_entities(reader, z17[mid - 6:mid + 6]), 2)]
    return batches


def bench_batches(city, reader):
    """Phase 10 (b)'s batches: the bench's own default-stylesheet render
    batches on the minicity, its z12-z17 pyramid, their fold and its
    @2x batch (`osm_renderer_tpu_torch.bench`)."""
    from osm_renderer_tpu_torch.bench import AT2X_TILES, pyramid_groups

    if city != "minicity":
        return []
    groups = pyramid_groups(reader)
    return ([(f"bench_{key}", group, 1) for key, group in groups.items()]
            + [("bench_z15_2x", groups["z15"][:AT2X_TILES], 2)])


def phase_kernel(device, style, plan, rows, kinds_seen, planars=None, arena=True,
                 oracle=False, kept=None):
    """Render kernel vs twin (`compare`) on the batches `plan(city,
    reader)` names for each synthetic city, each split as the server
    splits it -> the halvings.  Each city has its own renderers: the
    chunk cache is keyed by tile address, and both cities cover the same
    tiles.  arena: the arena entry against the plain entry as well
    (`compare_arena`).  oracle: every tile but the oracle's within 1/255
    of CpuDrawer, labels off.  The kernel's planar batches go to
    `planars` as (name, tensor on the card), and the plain-upload batch
    of bigcity z15 to `kept` (phase 3b)."""
    import numpy as np

    from osm_renderer_tpu_torch.draw.drawer import CpuDrawer
    from osm_renderer_tpu_torch.geodata.reader import GeodataReader
    from osm_renderer_tpu_torch.mapcss.parser import parse_file
    from osm_renderer_tpu_torch.mapcss.styler import Styler
    from osm_renderer_tpu_torch.ops import chunk_layout as CL
    from osm_renderer_tpu_torch.parallel.renderer import BatchRenderer
    from osm_renderer_tpu_torch.tools.corpus import split_prepare

    sdir, sheet, stype = style
    styler = Styler(parse_file(sdir, sheet), stype)
    canvas = styler.canvas_fill_color
    canvas_u8 = (canvas.r, canvas.g, canvas.b)
    drawer = CpuDrawer(stylesheet_dir=sdir) if oracle else None
    halvings = 0
    for city, path in (("minicity", MINI_BIN), ("bigcity", BIG_BIN)):
        reader = GeodataReader.load(path)
        renderers = [BatchRenderer(styler, stylesheet_dir=sdir, chunk_cache_tiles=1024,
                                   device=str(device), arena=a) for a in (False, True)[:1 + arena]]
        for name, tiles_entities, scale in plan(city, reader):
            plain, *arenas = [split_prepare(r, tiles_entities, scale) for r in renderers]
            halvings += len(plain) - 1
            if arenas and (len(arenas[0]) != len(plain)
                           or any(p.arena_packed is None for p, _, _ in arenas[0])):
                raise AssertionError(f"{name}: the arena renderer did not take the arena path")
            worst = oracle_tiles = 0
            for i, (p, pte, _) in enumerate(plain):
                out = compare(f"{name}[{i}]", p, canvas_u8, kinds_seen, rows)
                if arenas:
                    pa = arenas[0][i][0]
                    compare_arena(f"{name}[{i}]", lambda: renderers[1].render_prepared_planar(pa),
                                  out, rows)
                if planars is not None:
                    planars.append((f"{name}[{i}]", out))
                if kept is not None and f"{name}[{i}]" == "bigcity_z15[0]":
                    kept["bigcity_z15[0]"] = p
                if drawer is None:
                    continue
                rgb = CL.planar_to_rgb(out.cpu().numpy())
                for k, (ents, t) in enumerate(pte):
                    if k in p.cpu_fallback_tiles:
                        oracle_tiles += 1
                        continue
                    want = drawer.draw_to_pixels(ents, t, scale, styler)
                    d = int(np.abs(rgb[k].astype(int) - want.astype(int)).max())
                    worst = max(worst, d)
                    if d > 1:
                        raise AssertionError(f"{name} {t}: {d}/255 off CpuDrawer")
            log(f"  {name}: {len(tiles_entities)} tiles in {len(plain)} batch(es) "
                f"({len(plain) - 1} halvings)" + (
                    f"; every tile within {worst}/255 of CpuDrawer, labels off "
                    f"({oracle_tiles} left to the oracle)" if drawer is not None else ""))
    return halvings


def phase_scenes(device, rows, kinds_seen, planars):
    """Render kernel vs twin and arena entry vs plain entry on the two
    synthetic scenes; then every chunk kind must have been seen."""
    from osm_renderer_tpu_torch.ops import chunk_layout as CL

    for name, icon in (("oversize_layer_scene", False), ("icon_fill_scene", True)):
        prep, render_arena, cu8 = scene_batch(device, icon=icon)
        out = compare(name, prep, cu8, kinds_seen, rows)
        compare_arena(name, render_arena, out, rows)
        planars.append((name, out))
    need = {CL.KIND_FILL, CL.KIND_STROKE_SPAN, CL.KIND_STROKE, CL.KIND_STROKE_SOLID,
            CL.KIND_STROKE_DASH, CL.KIND_LAYER, CL.KIND_FILL_IMAGE}
    missing = need - kinds_seen
    if missing:
        raise AssertionError(f"real batches never reached chunk kinds {sorted(missing)}")


# Batches whose wires are timed (wrapper ms and device ms beside plain
# ms and the byte bound) and cut at the edge caps.
WIRE_TIMED = ("bigcity_z15[0]", "minicity_z15_2x[0]", "prod_bigcity_z15[0]")


def synthetic_planars(device):
    """Planar batches the cities do not give: a uniform T=1 ts=1024 batch
    (one run a 256-pixel block), a T=2 ts=256 per-pixel checkerboard
    (every run 1 pixel long, every segment full of runs) and a T=3
    ts=768 batch of random runs (geometric lengths of mean 6 over 400
    colours from a seed, so a learned palette leaves literals)."""
    import numpy as np
    import torch

    def planar(vals):
        p = np.full((vals.shape[0], 4) + vals.shape[1:], 255, np.uint8)
        for c in range(3):
            p[:, c] = (vals >> (16 - 8 * c)) & 0xFF
        return torch.from_numpy(p).to(device)

    rng = np.random.default_rng(5)
    yy, xx = np.indices((256, 256))
    n = 3 * 768 * 768
    colors = rng.integers(0, 1 << 24, 400)[rng.integers(0, 400, size=n)]
    runs = np.repeat(colors, rng.geometric(1 / 6, size=n))[:n]
    return [
        ("uniform_T1_ts1024", planar(np.full((1, 1024, 1024), 0x4D7A2E, np.int64))),
        ("checker_T2_ts256", planar(np.where((yy + xx) % 2 == 0, 0xF1EEE8, 0x3050A0)[None]
                                    .repeat(2, 0))),
        ("random_T3_ts768", planar(runs.reshape(3, 768, 768))),
    ]


def phase_wire(device, planars, wire_rows, decode):
    """Both wires vs their plain versions on every planar batch, at
    fitting and overflowing caps, and at the edge caps on the timed
    batches."""
    import numpy as np
    import torch

    from osm_renderer_tpu_torch.ops import chunk_layout as CL
    from osm_renderer_tpu_torch.ops import rle_cuda as RLE
    from osm_renderer_tpu_torch.ops import rle_layout as RL

    worst = {"rle_emit": 0, "rle_expand": 0}

    def check(name, kernel, what, got, want, cap):
        err = int((got.long() - want.long()).abs().max().item()) if got.shape == want.shape else -1
        if err != 0:
            raise AssertionError(f"{name} {what}: kernel wire differs from the plain version "
                                 f"(shape {tuple(got.shape)} vs {tuple(want.shape)}, "
                                 f"max |diff| {err})")
        worst[kernel] = max(worst[kernel], err)
        total = int(got[1])
        return total, total > cap

    for name, planar in planars:
        T, ts = planar.shape[0], planar.shape[2]
        runs, nb = RLE.runs_reference(planar)
        total_runs = runs.numel()
        rgb = CL.planar_to_rgb(planar.cpu().numpy())
        # v1: a cap that fits, and one that overflows.
        rtot = RL.rcap_bucket(total_runs)
        v1 = RLE.encode_batch_wire(planar, rtot)
        check(name, "rle_emit", "v1", v1, RLE.encode_batch_wire_reference(planar, rtot), rtot)
        small = max(total_runs // 2, 1)
        _, over = check(name, "rle_emit", "v1 overflow", RLE.encode_batch_wire(planar, small),
                        RLE.encode_batch_wire_reference(planar, small), small)
        if not over:
            raise AssertionError(f"{name}: v1 cap {small} did not overflow")
        host_v1 = v1.cpu().numpy()
        tiles = RL.decode_wire_numpy(host_v1, ts)
        if tiles is None or not all(np.array_equal(t, r) for t, r in zip(tiles, rgb)):
            raise AssertionError(f"{name}: the v1 wire does not decode to the planar batch")
        # v2: learned, half and all-PAL_PAD palettes.
        colors, counts = (a.cpu().numpy() for a in torch.unique(runs & 0xFFFFFF,
                                                                return_counts=True))
        half = max(1, len(colors) // 2)
        palettes = {
            "learned": RL.build_palette(colors, counts),
            "half": RL.build_palette(colors[:half], counts[:half]),
            "pad": np.full(RL.PAL_CAP, RL.PAL_PAD, np.int32),
        }
        wcap = CL.next_bucket(3 * total_runs + 2, 8192)
        words = {}
        for pal, table in palettes.items():
            tab = torch.from_numpy(table).to(device)
            v2 = RLE.encode_wire_indexed(planar, wcap, tab)
            total_words, over = check(name, "rle_expand", f"v2 {pal}", v2,
                                      RLE.encode_wire_indexed_reference(planar, wcap, tab), wcap)
            if over:
                raise AssertionError(f"{name}: v2 {pal} overflowed its cap {wcap}")
            words[pal] = total_words
            if pal == "learned":
                host_v2 = v2.cpu().numpy()
                n_png8, n_over = _check_v2_decode(name, host_v2, rgb, ts)
        # A one-colour batch has no literal under a palette that holds it.
        if words["pad"] != 3 * total_runs or not (words["half"] > total_runs or len(colors) == 1):
            raise AssertionError(f"{name}: palettes did not give both word forms: {words}")
        wsmall = max(total_runs // 2 & ~1, 2)
        tab = torch.from_numpy(palettes["learned"]).to(device)
        _, over = check(name, "rle_expand", "v2 overflow", RLE.encode_wire_indexed(planar, wsmall, tab),
                        RLE.encode_wire_indexed_reference(planar, wsmall, tab), wsmall)
        if not over:
            raise AssertionError(f"{name}: v2 cap {wsmall} did not overflow")
        raw = planar.numel()
        row = dict(name=name, T=T, ts=ts, runs=total_runs, words=words["learned"],
                   png8_tiles=n_png8, overflow_tiles=n_over,
                   raw_bytes=raw, v1_bytes=4 * (2 + T + total_runs),
                   v2_bytes=4 * (3 + T + RL.PAL_CAP) + 2 * words["learned"])
        edges = ""
        if name in WIRE_TIMED:
            caps = _edge_caps(name, planar, torch.from_numpy(palettes["half"]).to(device), check)
            edges = "; edge caps bit-identical: " + ", ".join(f"{k} {v}" for k, v in caps.items())
            row.update(_time_wire(planar, rtot, wcap, tab))
            # Bytes each wire must move: the RGB planes in (and the
            # palette, v2), the live wire out.  Both are bound by bytes.
            rgb_bytes = 3 * T * ts * ts
            row["v1_bound_ms"] = (rgb_bytes + row["v1_bytes"]) / HBM_BYTES_PER_S * 1e3
            row["v2_bound_ms"] = (rgb_bytes + 4 * RL.PAL_CAP + row["v2_bytes"]
                                  ) / HBM_BYTES_PER_S * 1e3
            decode[name] = _time_decode(host_v1, host_v2, rgb, ts)
        wire_rows.append(row)
        timing = ""
        if "v1_ms" in row:
            timing = "".join(
                f" {w}: wrapper_ms={row[w + '_ms']:.4f} device_ms={row[w + '_dev_ms']:.4f} "
                f"(plain {row[w + '_plain_ms']:.2f}, bound {row[w + '_bound_ms']:.6f}, "
                f"device share of bound {100 * row[w + '_bound_ms'] / row[w + '_dev_ms']:.2f}%)"
                for w in ("v1", "v2"))
        log(f"  {name}: T={T} ts={ts} segment={RLE.segment_px(planar)} px runs={total_runs} "
            f"words(learned/half/pad)={words['learned']}/{words['half']}/{words['pad']} "
            f"bytes raw={raw} v1={row['v1_bytes']} v2={row['v2_bytes']}: bit-identical, "
            f"overflow flagged{edges}{timing}; PNG-8 from the learned v2 wire for {n_png8} "
            f"tiles, {n_over} palette overflows (> 256 colours, RGB)")
    return worst


def _edge_caps(name, planar, table, check):
    """Both wires at the caps where the cut falls on an edge: v1 at
    total_runs (fits exactly) and total_runs - 1 (overflows by one); v2
    under `table` right after a literal's header word, right after a
    literal's lo16 word, on a tile boundary, and below total_runs (the
    run cap bites).  -> {edge: wcap}."""
    import torch

    from osm_renderer_tpu_torch.ops import rle_cuda as RLE
    from osm_renderer_tpu_torch.ops import rle_layout as RL

    runs, _ = RLE.runs_reference(planar)
    total_runs = runs.numel()
    T = planar.shape[0]
    for rtot, fits in ((total_runs, True), (total_runs - 1, False)):
        _, over = check(name, "rle_emit", f"v1 rtot={rtot}", RLE.encode_batch_wire(planar, rtot),
                        RLE.encode_batch_wire_reference(planar, rtot), rtot)
        if over == fits:
            raise AssertionError(f"{name}: v1 rtot={rtot} overflow flag {over}, want {not fits}")
    # Word offsets of the runs under `table`, as the plain version has them.
    vals = runs & 0xFFFFFF
    tab = table.to(torch.int64)
    pi = torch.searchsorted(tab, vals)
    hit = (pi < RL.PAL_CAP) & (tab[pi.clamp(max=RL.PAL_CAP - 1)] == vals)
    wc = torch.where(hit, 1, 3)
    woff = torch.cumsum(wc, 0) - wc
    literals = torch.nonzero(~hit).squeeze(1)
    lit_off = woff[literals[literals.numel() // 2:]]
    odd, even = lit_off[lit_off % 2 == 1], lit_off[lit_off % 2 == 0]
    full = RLE.encode_wire_indexed_reference(planar, 3 * total_runs + 2 + total_runs % 2, table)
    ends = torch.cumsum(full[3 : 3 + T].long(), 0)[:-1]
    ends = ends[ends % 2 == 0]
    if not odd.numel() or not even.numel() or not ends.numel():
        raise AssertionError(f"{name}: no literal at an odd and an even word offset, or no "
                             "tile boundary at an even word offset")
    caps = {
        "after a literal's header word": int(odd[0]) + 1,
        "after a literal's lo16 word": int(even[0]) + 2,
        "on a tile boundary": int(ends[ends.numel() // 2]),
        "below total_runs": (total_runs - 1) & ~1,
    }
    for what, wcap in caps.items():
        _, over = check(name, "rle_expand", f"v2 wcap={wcap} ({what})",
                        RLE.encode_wire_indexed(planar, wcap, table),
                        RLE.encode_wire_indexed_reference(planar, wcap, table), wcap)
        if not over:
            raise AssertionError(f"{name}: v2 wcap={wcap} ({what}) did not overflow")
    return {"rtot": f"{total_runs} and {total_runs - 1}", **caps}


def _words_view(wire, ts):
    """A v2 wire read back -> its RleTileView (the served path's view)."""
    import numpy as np

    from osm_renderer_tpu_torch.ops import rle_layout as RL
    from osm_renderer_tpu_torch.parallel.renderer import RleTileView

    T = int(wire[0])
    offs = np.concatenate([[0], np.cumsum(wire[3 : 3 + T])]).astype(np.int64)
    table = wire[3 + T : 3 + T + RL.PAL_CAP]
    return RleTileView(T, ts, words=(wire[3 + T + RL.PAL_CAP :], offs, table))


def _check_v2_decode(name, wire, rgb, ts):
    """Every tile of a v2 wire decodes to the planar batch's pixels through
    the numpy plain version and through the served view (the host codec);
    the view's PNG-8 is a colour type 3 PNG that decodes to those pixels
    for every tile of at most 256 colours, and None for every other
    (an overflow: the tile ships as RGB) -> (PNG-8 tiles, overflows)."""
    import numpy as np
    from PIL import Image

    from osm_renderer_tpu_torch.ops import rle_layout as RL

    view = _words_view(wire, ts)
    packed32, offs, table = view.words
    n_png8 = n_over = 0
    for t in range(view.T):
        got = RL.decode_words_numpy(packed32, int(offs[t]), int(offs[t + 1] - offs[t]), table,
                                    ts, ts)
        px = view.rgb(t)
        if not (np.array_equal(got, rgb[t]) and np.array_equal(px, rgb[t])):
            raise AssertionError(f"{name}: v2 tile {t} does not decode to the planar batch")
        png = view.png8(t, 1)
        fits = len(np.unique(px.reshape(-1, 3), axis=0)) <= 256
        if png is None:
            if fits:
                raise AssertionError(f"{name}: tile {t} of at most 256 colours has no PNG-8")
            n_over += 1
            continue
        img = Image.open(io.BytesIO(png))
        if png[25] != 3 or img.mode != "P" or not np.array_equal(
                np.asarray(img.convert("RGB")), px):
            raise AssertionError(f"{name}: tile {t}'s PNG-8 (colour type {png[25]}) does not "
                                 "decode to its view.rgb pixels")
        n_png8 += 1
    return n_png8, n_over


def _time_wire(planar, rtot, wcap, tab):
    """The v1 and the whole v2 wire: wrapper ms (time_ms, the host's
    enqueue included), device ms (device_ms, the enqueue hidden) and the
    plain version's ms."""
    from osm_renderer_tpu_torch.ops import rle_cuda as RLE
    from osm_renderer_tpu_torch.tools.kdevice import device_ms

    def v1():
        return RLE.encode_batch_wire(planar, rtot)

    def v2():
        return RLE.encode_wire_indexed(planar, wcap, tab)

    return dict(
        v1_ms=time_ms(v1), v1_dev_ms=device_ms(v1),
        v1_plain_ms=time_ms(lambda: RLE.encode_batch_wire_reference(planar, rtot)),
        v2_ms=time_ms(v2), v2_dev_ms=device_ms(v2),
        v2_plain_ms=time_ms(lambda: RLE.encode_wire_indexed_reference(planar, wcap, tab)),
    )


def _time_decode(v1, v2, rgb, ts):
    """Host ms per tile of one batch's decode and encode, and PNG bytes
    per tile by container: v2 decoded to RGB through the port's decoder
    (draw/png8.py), the vectorised numpy plain version and the per-word
    loop of png_writer's numpy fallback (a few tiles), v2 decoded to
    palette-index rows through the port's decoder (every tile, None for
    the overflows), v1 through the port's decoder; the PNG-8 of every tile that fits a palette through
    the port's writer, and every tile as an RGB PNG through png_writer
    without libdeflate (zlib over unfiltered rows: the RGB PNG of the
    served path on a host without libdeflate)."""
    import numpy as np

    from osm_renderer_tpu_torch.draw import png8, png_writer
    from osm_renderer_tpu_torch.ops import rle_layout as RL

    view = _words_view(v2, ts)
    packed32, offs, table = view.words
    T = view.T

    def per_tile(fn, tiles):
        fn(tiles[0])  # warm
        t0 = time.perf_counter()
        out = [fn(i) for i in tiles]
        return (time.perf_counter() - t0) * 1e3 / len(tiles), out

    def words(i):
        return packed32, int(offs[i]), int(offs[i + 1] - offs[i]), table

    every = list(range(T))
    port_ms, got = per_tile(lambda i: png8.decode_words(*words(i), ts, ts), every)
    if not all(np.array_equal(g, r) for g, r in zip(got, rgb)):
        raise AssertionError("the port's v2 decode differs from the planar batch")
    numpy_ms, _ = per_tile(lambda i: RL.decode_words_numpy(*words(i), ts, ts), every)
    idx_ms, _ = per_tile(lambda i: png8.decode_words_idx(*words(i), ts, ts), every)
    saved = png_writer._native, png_writer._native_failed
    png_writer._native, png_writer._native_failed = None, True
    try:
        loop_ms, _ = per_tile(lambda i: png_writer.rle_decode_words(*words(i), ts, ts),
                              every[:3])
    finally:
        png_writer._native, png_writer._native_failed = saved
    roffs = np.concatenate([[0], np.cumsum(v1[2 : 2 + T])])
    runs = v1[2 + T :]
    v1_ms, _ = per_tile(lambda i: png8.decode_packed(runs[roffs[i] : roffs[i + 1]], ts, ts),
                        every)
    pngs = [png8.words_to_png_pal(*words(i), ts, ts, 1) for i in every]
    fit = [i for i in every if pngs[i] is not None]
    png8_ms, _ = (per_tile(lambda i: png8.words_to_png_pal(*words(i), ts, ts, 1), fit)
                  if fit else (None, None))
    saved = png_writer._native, png_writer._native_failed
    png_writer._native, png_writer._native_failed = None, True
    try:
        zlib_ms, zlib_pngs = per_tile(lambda i: png_writer.rgb_to_png(rgb[i], 1), every)
    finally:
        png_writer._native, png_writer._native_failed = saved

    def mean_len(items):
        return sum(map(len, items)) / len(items) if items else None

    return dict(writer=png8.WRITER, v2_ms=port_ms, v2_numpy_ms=numpy_ms, v2_idx_ms=idx_ms,
                v2_loop_ms=loop_ms, v1_ms=v1_ms, words_per_tile=float(v2[3 : 3 + T].mean()),
                png8_tiles=len(fit), png8_ms=png8_ms,
                png8_bytes=mean_len([pngs[i] for i in fit]),
                zlib_rgb_png_ms=zlib_ms, zlib_rgb_png_bytes=mean_len(zlib_pngs),
                zlib_rgb_png_bytes_fit=mean_len([zlib_pngs[i] for i in fit]))


def phase_labeled(device, styler, stylesheet_dir=STYLESHEET_DIR, prefix=""):
    """The labeled arena entry (one render-kernel launch whose u8
    finalize also blends the label slab's rows) on the minicity z15
    batch, its @2x batch, two of its labeled tiles at @4x and the
    bigcity z15 halves, with label layers from the port's labeler.
    Bars: (a) byte-identical to blit_planar run on the CPU over the
    unlabeled arena entry's output with a CPU copy of the slab plane;
    (b) every tile within 1/255 of composite_labels over that unlabeled
    output; (c) alpha = 1 cores and pixels outside each layer's bbox
    byte-identical to it; (d) byte-identical to the unlabeled entry
    followed by expand_ltriples and blit_planar on the card; (e) the
    unlabeled entry's torch operators (views aside), none dispatched
    after the render launch: nothing runs after it.  Prints each
    entry's device operations a call (torch.profiler, not a bar: a
    trace can drop records), the labeled and unlabeled entries' ms
    (CUDA events around the calls, and device ms with the host's
    enqueue hidden, the least of four readings taken in turn), the
    kernel's device ms alone with and without the labels
    (the same way), the blend's plain version's ms on the card
    (`blit_ms`), and the epilogue's byte bound: the labeled
    rows' slab words (rows x 2 x ts x 4 bytes) over 3.35 TB/s."""
    import numpy as np
    import torch

    from osm_renderer_tpu_torch.tools.corpus import split_prepare, zoom_tiles
    from osm_renderer_tpu_torch.geodata.reader import GeodataReader
    from osm_renderer_tpu_torch.draw.labels.labeler import Labeler
    from osm_renderer_tpu_torch.ops import render_cuda as RC
    from osm_renderer_tpu_torch.parallel import label_slab as LS
    from osm_renderer_tpu_torch.parallel.renderer import BatchRenderer

    labeler = Labeler(icon_base_path=stylesheet_dir, use_atlas=True, label_cache_tiles=4096)
    for city, path in (("minicity", MINI_BIN), ("bigcity", BIG_BIN)):
        reader = GeodataReader.load(path)
        r = BatchRenderer(styler, stylesheet_dir=stylesheet_dir, chunk_cache_tiles=1024,
                          device=str(device), arena=True)
        z15 = [(reader.get_entities_in_tile_with_neighbors(t), t) for t in zoom_tiles(reader, 15)]
        if city == "minicity":
            # Two tiles with a label layer at @4x (ts 1024), the server's
            # largest scale.
            at4x = [(e, t) for e, t in z15
                    if labeler.ensure_layer(e, t, 4.0, styler, 1024) is not None][:2]
            batches = [(f"{prefix}{city}_z15", z15, 1), (f"{prefix}{city}_z15_2x", z15[:12], 2),
                       (f"{prefix}{city}_z15_4x", at4x, 4)]
        else:
            mid = len(z15) // 2
            batches = [(f"{prefix}{city}_z15_half0", z15[:mid], 1),
                       (f"{prefix}{city}_z15_half1", z15[mid:], 1)]
        for name, tiles_entities, scale in batches:
            ts = 256 * scale
            compacts = [labeler.ensure_layer(e, t, float(scale), styler, ts)
                        for e, t in tiles_entities]
            for i, (pl, te, cs) in enumerate(split_prepare(r, tiles_entities, scale, compacts)):
                bname = f"{name}[{i}]"
                want_labeled = tuple(k for k, c in enumerate(cs)
                                     if c is not None and k not in pl.cpu_fallback_tiles)
                if pl.label_rows is None or not want_labeled:
                    raise AssertionError(f"{bname}: no labeled tile on the labeled entry")
                if pl.device_labeled != want_labeled:
                    raise AssertionError(f"{bname}: device-labeled tiles {pl.device_labeled}, "
                                         f"want {want_labeled}")
                pu = r.prepare(te, scale)
                if pu.arena_packed is None or pu.label_rows is not None:
                    raise AssertionError(f"{bname}: the unlabeled batch left the arena path")
                base = r.render_prepared_planar(pu)
                got = r.render_prepared_planar(pl)
                torch.cuda.synchronize()
                slab = pl.label_ctx[0]
                tri = torch.from_numpy(pl.label_rows)
                lrow = LS.expand_ltriples(tri, ts)
                cpu_blit = LS.blit_planar(base.cpu(), slab.plane.cpu(), lrow)
                got_h, base_h = got.cpu(), base.cpu().numpy()
                if not torch.equal(got_h, cpu_blit):
                    n = int((got_h != cpu_blit).sum().item())
                    raise AssertionError(f"{bname}: labeled entry differs from the CPU blit "
                                         f"in {n} bytes")
                tri_dev = tri.to(device)

                def card_blit():
                    return LS.blit_planar(base, slab.plane, LS.expand_ltriples(tri_dev, ts))

                if not torch.equal(got, card_blit()):
                    n = int((got != card_blit()).sum().item())
                    raise AssertionError(f"{bname}: labeled entry differs from the blit on the "
                                         f"card in {n} bytes")
                got_h = got_h.numpy()
                worst = 0
                for k, ((ents, t), c) in enumerate(zip(te, cs)):
                    if k in pl.cpu_fallback_tiles:
                        continue
                    b = np.ascontiguousarray(base_h[k, :3].transpose(1, 2, 0))
                    g = np.ascontiguousarray(got_h[k, :3].transpose(1, 2, 0))
                    want = labeler.composite_labels(b, ents, t, float(scale), styler)
                    d = int(np.abs(g.astype(int) - want.astype(int)).max())
                    worst = max(worst, d)
                    if d > 1:
                        raise AssertionError(f"{bname} tile {k}: {d}/255 off the host composite")
                    exact = np.ones(b.shape[:2], bool)
                    if c is not None:
                        y0, y1, x0, x1, _, alpha = c
                        exact[y0:y1, x0:x1] = alpha[..., 0] >= 1.0
                    if not np.array_equal(g[exact], want[exact]):
                        raise AssertionError(f"{bname} tile {k}: an alpha = 1 core or a pixel "
                                             "outside the label bbox differs from the composite")
                torch_l, launches_l = _dispatched_ops(lambda: r.render_prepared_planar(pl))
                torch_u, launches_u = _dispatched_ops(lambda: r.render_prepared_planar(pu))
                if (launches_l, launches_u) != (1, 1) or torch_l != torch_u or any(
                        n for _, n in torch_l):
                    raise AssertionError(f"{bname}: the labeled entry dispatched {torch_l} "
                                         f"around {launches_l} render launches, the unlabeled "
                                         f"{torch_u} around {launches_u}")
                kinds_l = list(map(_op_label, _profiled_call_ops(
                    lambda: r.render_prepared_planar(pl))))
                kinds_u = list(map(_op_label, _profiled_call_ops(
                    lambda: r.render_prepared_planar(pu))))
                labeled_ms = time_ms(lambda: r.render_prepared_planar(pl))
                plain_ms = time_ms(lambda: r.render_prepared_planar(pu))
                labeled_dev, plain_dev = _alternating_device_ms(
                    lambda: r.render_prepared_planar(pl), lambda: r.render_prepared_planar(pu))
                # The kernel alone, with and without the labels, on the
                # labeled batch's one upload.
                arena, prof, tot, pat, _ = pl.arena_ctx
                kb, krows, ktri = RC.arena_batch(pl.arena_packed, arena, prof, tot, pat,
                                                 pl.chunk, pl.label_rows)
                kern_l, kern_u = _alternating_device_ms(
                    lambda: RC.render_batch_planar(kb, pl.canvas_rgb, ts, krows, ktri, slab.plane),
                    lambda: RC.render_batch_planar(kb, pl.canvas_rgb, ts, krows))
                blit_ms = time_ms(card_blit)
                label_rows = int(pl.label_rows[:, 2].sum())
                epi_bytes = label_rows * 2 * ts * 4
                epi_ms = epi_bytes / HBM_BYTES_PER_S * 1e3
                rows = sum(n for _, n, _ in slab._offsets.values())
                log(f"  {bname}: T={pl.chunk} ts={ts} labeled tiles={len(pl.device_labeled)} "
                    f"(a) CPU blit byte-identical, (b) max |diff| vs host composite={worst}, "
                    f"(c) cores and outside bbox exact, (d) card blit byte-identical, (e) torch "
                    f"ops labeled={len(torch_l)} unlabeled={len(torch_u)} "
                    f"({' | '.join(n for n, _ in torch_l)}), none after the render launch; "
                    f"device ops a call (profiler) labeled={len(kinds_l)} unlabeled="
                    f"{len(kinds_u)} ({' | '.join(kinds_l)}); "
                    f"labeled_ms={labeled_ms:.4f} unlabeled_ms={plain_ms:.4f} "
                    f"(labeled - unlabeled {labeled_ms - plain_ms:.4f}); device ms labeled="
                    f"{labeled_dev:.4f} unlabeled={plain_dev:.4f} (labeled - unlabeled "
                    f"{labeled_dev - plain_dev:.4f}); the kernel alone, device ms labeled="
                    f"{kern_l:.4f} unlabeled={kern_u:.4f} (epilogue {kern_l - kern_u:.4f}); "
                    f"blit_ms={blit_ms:.4f} (plain version on the card); epilogue bound "
                    f"{epi_ms:.6f} ms ({label_rows} labeled rows, "
                    f"{epi_bytes} B of slab words); slab rows={rows} of cap {slab.cap} "
                    f"({slab.plane.numel() * slab.plane.element_size()} bytes)")


def _alternating_device_ms(fa, fb, rounds: int = 4, reps: int = 10):
    """-> (ms of fa, ms of fb): each the least of `rounds` device_ms
    readings (`reps` calls, the enqueue hidden), taken a, b, a, b, ..."""
    from osm_renderer_tpu_torch.tools.kdevice import device_ms

    a, b = [], []
    for _ in range(rounds):
        a.append(device_ms(fa, reps))
        b.append(device_ms(fb, reps))
    return min(a), min(b)


def _dense_scene(device, scene: str, precision: str):
    """A synthetic one-tile scene as a dense batch on `device` -> (TileBatch,
    canvas, ts, chunk, chain, plan).  scene: "oversize" (coordinates past
    the fast bound), "icon" (kind 5 fills) or "large_fill" (one fill of
    700 edges: a 1024-lane edge bucket, past the fill kernel's shared
    memory, so its active lists live in global scratch)."""
    import numpy as np
    import torch

    from osm_renderer_tpu_torch.draw import primitives as P
    from osm_renderer_tpu_torch.ops import render_dense as RD

    chunk, icon_cache = 64, None
    if scene == "large_fill":
        ang = np.linspace(0, 2 * np.pi, 700, endpoint=False)
        r = 100 + 20 * np.sin(37 * ang)
        pts = np.stack([np.round(128 + r * np.cos(ang)), np.round(128 + r * np.sin(ang))], 1)
        pts = np.concatenate([pts, pts[:1]]).astype(np.int64)
        prims, chunk = [P.FillPrim(kind="fill", color=(20, 80, 160), opacity=0.9,
                                   edges=np.concatenate([pts[:-1], pts[1:]], 1))], 1024
    else:
        prims, icon_cache = scene_prims(scene == "icon")
    dtype = np.float64 if precision == "exact" else np.float32
    profiles, patterns = P.ProfileTable(), P.PatternTable(icon_cache, 256)
    stream = P.stream_tile(prims, profiles, chunk, patterns)
    arrays = P.build_batch([stream], profiles, chunk, dtype=dtype, patterns=patterns, ts=256)
    kinds = set(arrays.chunk_kind.ravel().tolist())
    lacks = {"icon": RD.KIND_FILL_IMAGE not in kinds,
             "oversize": np.abs(arrays.geom).max() < 1 << 14,
             "large_fill": arrays.chunk_cnt.max() < 700}[scene]
    if lacks:
        raise AssertionError(f"dense scene {scene} lacks what it is for: kinds "
                             f"{sorted(kinds)}, max |coord| {np.abs(arrays.geom).max()}, "
                             f"max edges {arrays.chunk_cnt.max()}")
    canvas = torch.from_numpy(np.array([241, 238, 232], dtype) / 255.0).to(device)
    plan = RD.plan_batch(arrays, 256, chunk, precision, RD.PIXEL_BUDGET["cuda"])
    return (RD.TileBatch.from_numpy(arrays, device), canvas, 256, chunk,
            profiles.has_round_caps(), plan)


# Device ms of the dense kernels' first design (a thread a stroke window
# pixel, a warp a fill window row found by binary search, a thread eight
# blend pixels walking every group of its tile; PERF.md section 5,
# NVIDIA H100 80GB HBM3 at 700 W), printed beside this run's: (precision,
# batch) -> stroke, fill, blend.
EARLIER_DENSE_MS = {
    ("exact", "minicity_z15_x30"): (0.5288, 0.0333, 0.4008),
    ("fast", "minicity_z15_x30"): (0.2544, 0.0220, 0.3514),
    ("exact", "minicity_z15_2x_x12"): (0.4733, 0.0307, 0.6033),
    ("fast", "minicity_z15_2x_x12"): (0.2338, 0.0227, 0.5504),
    ("exact", "bigcity_z15_x97"): (2.1232, 0.1359, 1.5079),
    ("fast", "bigcity_z15_x97"): (0.9930, 0.0783, 1.4844),
}
# Device operations a batch through the kernels: the pending memset and
# the three kernels, and room for one more.
DENSE_MAX_OPS = 5


def _event_ms(fn, reps: int = 3) -> float:
    """Mean ms of `reps` calls after one warm call, CUDA events around
    the calls."""
    import torch

    fn()
    torch.cuda.synchronize()
    ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    ev0.record()
    for _ in range(reps):
        fn()
    ev1.record()
    torch.cuda.synchronize()
    return ev0.elapsed_time(ev1) / reps


def _traces(fn, reps: int, n: int = 3) -> list:
    """`n` torch.profiler traces of `reps` calls of fn() each -> each
    trace's device operations (kernels, copies, memsets) by name, in the
    order they started."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    # A trace can miss operations after other device work (as
    # tools/kdevice.py found; phase 4b's traces lost a render entry's
    # first operations, whole calls, or one render kernel mid-trace):
    # one thrown-away trace first.
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts):
        fn()
        torch.cuda.synchronize()
    out = []
    for _ in range(n):
        with profile(activities=acts) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ev = sorted((e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
        out.append([e.name for e in ev])
    return out


def _device_ops(fn, reps: int = 1) -> list:
    """Names of the device operations `reps` calls of fn() ran, from the
    fullest of `_traces` that holds a whole multiple of `reps`; [] when
    none does."""
    best = []
    for ev in _traces(fn, reps):
        if len(ev) % reps == 0 and len(ev) > len(best):
            best = ev
    return best


def _profiled_call_ops(fn, calls: int = 3) -> list:
    """The device operations of one call of fn(), a render entry, by
    torch.profiler: the most common run of operations that follows one
    render kernel and ends at the next, over four traces of `calls`
    calls.  A trace can drop records, so this is printed, not held to a
    bar ([] when no trace held two render kernels)."""
    from collections import Counter

    seen = Counter()
    for ev in _traces(fn, calls, n=4):
        ends = [i for i, name in enumerate(ev) if "render_kernel" in name]
        for a, b in zip(ends, ends[1:]):
            seen[tuple(ev[a + 1:b + 1])] += 1
    return list(seen.most_common(1)[0][0]) if seen else []


def _dispatched_ops(fn) -> tuple:
    """-> (the torch operators fn() dispatched that are not views, in
    order, each with the render-kernel launches made before it; the
    launches fn() made).  Every device operation of a render entry is
    one of these or the launch, on one stream, so this is the order the
    card runs them in."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from osm_renderer_tpu_torch.ops import render_cuda as RC

    before = RC.RENDER_KERNEL_LAUNCHES
    ops = []

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if not func.is_view:
                ops.append((str(func), RC.RENDER_KERNEL_LAUNCHES - before))
            return func(*args, **(kwargs or {}))

    with Record():
        fn()
    return ops, RC.RENDER_KERNEL_LAUNCHES - before


def _op_label(name: str) -> str:
    """A device operation's name, short: the port's kernel, a copy or
    memset as the profiler names it, or the kind of a PyTorch kernel."""
    if name.startswith(("Memcpy", "Memset")):
        return name
    for key in ("render_kernel", "gather", "copy", "index"):
        if key in name:
            return key
    return name[:40]


def _device_launches(fn, reps: int = 1) -> int:
    """Device operations one call of fn() ran (`_device_ops` over `reps`
    calls); -1 when no trace held a whole multiple of `reps`."""
    ops = _device_ops(fn, reps)
    return len(ops) // reps if ops else -1


def _peak_bytes(fn) -> int:
    """Device memory fn() allocated at its peak, above what was live."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


# The card's f64 rate outside the tensor cores (NVIDIA H100 SXM data
# sheet), for the dense kernels' exact precision.
F64_OPS_PER_S = 34e12


def dense_bounds(batch, plan, pack, stroke_pend, fill_pend) -> dict:
    """Least time the card could take for each dense kernel on this batch
    -> {kernel: (ms, "bytes" or "operations")}.

    Bytes: each input read once (the packed items, the segments, edges,
    profiles, colours and pending values they read) and each output
    written once (the pending values an alpha kernel leaves above zero,
    the u8 tiles).  Operations: the float operations every stroke window
    pixel runs before its first early exit (the centre and start
    distances and `_stroke_opacity`: 32 + 7 DS in f64, 24 + 7 DS in f32),
    the blends (12 a window pixel) and the finalize (7 a pixel), over the
    f64 rate (exact) or the f32 rate (fast).  Integer work (the int64
    divisions of the band and chain rules) is not counted, so the bound
    is lower than any kernel could reach."""
    exact = pack.precision == "exact"
    fsz, rate = (8, F64_OPS_PER_S) if exact else (4, F32_OPS_PER_S)
    ds = batch.profiles.shape[1]
    ns, nf, ng, T, ts = pack.n_strokes, pack.n_fills, pack.n_groups, pack.n_tiles, pack.ts
    n_prof = batch.profiles.shape[0]
    stroke_bytes = (ns * (9 + 1) * 8 + ns * (16 + fsz + 4 + 2 * fsz)
                    + n_prof * (ds * 8 + 1) * fsz + int((stroke_pend > 0).sum()) * fsz)
    stroke_ops = pack.stroke_px * ((32 if exact else 24) + 7 * ds)
    edges = int(sum(int(items[:, 3].sum()) for _, items, _ in plan.fills))
    fill_bytes = nf * (11 + 1) * 8 + edges * 16 + nf * fsz + int((fill_pend > 0).sum()) * fsz
    blend_bytes = (pack.pending_size * fsz + ng * (7 * 8 + 3 * fsz + 4) + (T + 1) * 8
                   + T * ts * ts * 3)
    blend_ops = pack.pending_size * 12 + T * ts * ts * 7
    out = {}
    for name, nbytes, ops in (("dense_stroke_alpha", stroke_bytes, stroke_ops),
                              ("dense_fill_alpha", fill_bytes, 0),
                              ("dense_blend_finalize", blend_bytes, blend_ops)):
        b_ms, o_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / rate * 1e3
        out[name] = (max(b_ms, o_ms), "operations" if o_ms > b_ms else "bytes")
    return out


def phase_dense(device, styler, smi, out):
    """The dense renderer of `precision = exact` (ops/render_dense.py) and
    its kernels (csrc/dense.cu via ops/dense_cuda.py) on the card.

    (a) In both precisions, on the oversize-coordinate, icon-fill and
    large-fill scenes, 4 minicity z15 tiles, 2 of them at @2x, 2 at @3x
    and @4x (ts 768, 1024), every minicity z15 tile, 12 at @2x, the
    first 16 and all 97 bigcity z15 tiles and the production
    stylesheet's minicity z15 tiles:
    `render_batch` (the three kernels) byte-identical to
    `render_batch_plain` on the card and, but for the three largest
    batches, on the CPU, and each kernel to its plain function on the
    card (the stroke and fill alphas to `alphas` over the plan's strokes
    or fills alone, the blend to `blend` over the full pending), max
    |diff| 0.  (b) The
    kernels' exact minicity z15 tiles within 1/255 of CpuDrawer, < 1 % of
    values off.  (c) On minicity z15 x30, its 12 tiles @2x and bigcity
    z15 x97, in both precisions: each kernel's device ms beside its bound,
    its plain function's ms, the first design's ms and its registers,
    spill bytes, static shared memory and resident CTAs an SM; the
    batch's ms, device operations (at most DENSE_MAX_OPS) and peak
    memory through the kernels, and through the plain version (its
    operations and memory on minicity z15 x30; -1: not traced)."""
    import numpy as np
    import torch

    from osm_renderer_tpu_torch.draw.drawer import CpuDrawer
    from osm_renderer_tpu_torch.geodata.reader import GeodataReader
    from osm_renderer_tpu_torch.mapcss.parser import parse_file
    from osm_renderer_tpu_torch.mapcss.styler import Styler
    from osm_renderer_tpu_torch.ops import dense_cuda as DC
    from osm_renderer_tpu_torch.ops import render_dense as RD
    from osm_renderer_tpu_torch.parallel.renderer import BatchRenderer
    from osm_renderer_tpu_torch.tools.corpus import zoom_tiles
    from osm_renderer_tpu_torch.tools.kdevice import device_ms

    mini = GeodataReader.load(MINI_BIN)
    z15 = [(mini.get_entities_in_tile_with_neighbors(t), t) for t in zoom_tiles(mini, 15)]
    big = GeodataReader.load(BIG_BIN)
    big15 = [(big.get_entities_in_tile_with_neighbors(t), t) for t in zoom_tiles(big, 15)]
    prod_styler = Styler(parse_file(PROD_DIR, PROD_SHEET), "mapsme")
    renderers = {(p, sheet): BatchRenderer(st, stylesheet_dir=d, backend="dense", precision=p,
                                           device=str(device))
                 for p in ("exact", "fast")
                 for sheet, st, d in (("default", styler, None),
                                      ("production", prod_styler, PROD_DIR))}

    def prepared(precision, tiles_entities, scale, sheet="default"):
        p = renderers[(precision, sheet)].prepare(tiles_entities, scale)
        return p.batch, p.canvas_rgb, p.ts, p.chunk, p.chain, p.plan

    worst = 0.0
    timed: dict = {}
    for precision in ("exact", "fast"):
        # (name, batch, also held to the plain version on the CPU).  The
        # CPU takes ~0.3-1.3 s a tile here, so the three largest batches
        # are held to it through bigcity z15's first 16 tiles.
        batches = [
            ("oversize_scene", lambda: _dense_scene(device, "oversize", precision), True),
            ("icon_fill_scene", lambda: _dense_scene(device, "icon", precision), True),
            ("large_fill_scene", lambda: _dense_scene(device, "large_fill", precision), True),
            ("minicity_z15_x4", lambda: prepared(precision, z15[:4], 1), True),
            ("minicity_z15_2x_x2", lambda: prepared(precision, z15[:2], 2), True),
            # Two tiles of middling load at the server's other scales.
            ("minicity_z15_3x_x2", lambda: prepared(precision, z15[2:4], 3), True),
            ("minicity_z15_4x_x2", lambda: prepared(precision, z15[2:4], 4), True),
            ("minicity_z15_x30", lambda: prepared(precision, z15, 1), False),
            ("minicity_z15_2x_x12", lambda: prepared(precision, z15[:12], 2), False),
            ("bigcity_z15_x16", lambda: prepared(precision, big15[:16], 1), True),
            ("bigcity_z15_x97", lambda: prepared(precision, big15, 1), False),
            ("production_minicity_z15_x30", lambda: prepared(precision, z15, 1, "production"),
             True),
        ]
        for name, make, on_cpu in batches:
            t_batch = time.perf_counter()
            batch, canvas, ts, chunk, chain, plan = make()
            pack = DC.pack_plan(plan, batch.geom.shape[0]).to(device)
            got = RD.render_batch(batch, canvas, ts, chunk, precision, chain, plan, pack)
            # The plain version on the card phase by phase (render_batch_plain
            # is `blend` over `alphas`), so the blend kernel meets its own.
            pend = RD.alphas(batch, plan, chain)
            plain = RD.blend(batch, canvas, plan, pend)
            cpu, cpu_ms = plain.cpu(), None
            if on_cpu:
                host = RD.TileBatch(*(t.cpu() for t in batch))
                t0 = time.perf_counter()
                cpu = RD.render_batch_plain(host, canvas.cpu(), ts, chunk, precision, chain, plan)
                cpu_ms = (time.perf_counter() - t0) * 1e3
            # Each kernel against its plain function on the same inputs.
            strokes_only = plan._replace(fills=[])
            fills_only = plan._replace(strokes=plan.strokes[:0], stroke_passes=[])
            sp, fp = DC.new_pending(batch, pack), DC.new_pending(batch, pack)
            DC.stroke_alpha(batch, pack, sp, chain)
            DC.fill_alpha(batch, pack, fp)
            sp_want = RD.alphas(batch, strokes_only, chain)
            fp_want = RD.alphas(batch, fills_only, chain)
            bl = DC.blend_finalize(batch, canvas, pack, pend)
            errs = {
                "dense_stroke_alpha": float((sp - sp_want).abs().max()) if sp.numel() else 0.0,
                "dense_fill_alpha": float((fp - fp_want).abs().max()) if fp.numel() else 0.0,
                "dense_blend_finalize": float((bl.int() - plain.int()).abs().max()),
            }
            for k, v in errs.items():
                out.setdefault("max_abs_err", {}).setdefault(k, 0.0)
                out["max_abs_err"][k] = max(out["max_abs_err"][k], v)
            same = (torch.equal(got, plain) and torch.equal(got.cpu(), cpu)
                    and not any(errs.values()))
            if not same:
                n_gpu = int((got != plain).any(-1).sum().item())
                n_cpu = int((got.cpu() != cpu).any(-1).sum().item())
                raise AssertionError(f"dense kernels {precision} {name}: {n_gpu} pixels differ "
                                     f"from the plain version on the card, {n_cpu} from the "
                                     f"CPU; per kernel max |diff| {errs}")
            worst = max(worst, *errs.values())
            painted = float((got != got[0, 0, 0]).any(-1).float().mean())
            where = (f"on the card and on the CPU (CPU ms={cpu_ms:.1f})" if on_cpu
                     else "on the card")
            log(f"  (a) {precision} {name}: T={got.shape[0]} ts={ts} chunk={chunk} "
                f"chain={chain} e_max={pack.e_max} units={pack.n_units} fill units="
                f"{pack.n_fill_units}: kernels byte-identical "
                f"to the plain version {where}, each kernel to its plain function; painted {painted:.3f}; "
                f"{time.perf_counter() - t_batch:.1f} s")
            if name in ("minicity_z15_x30", "minicity_z15_2x_x12", "bigcity_z15_x97"):
                timed[(precision, name)] = (batch, canvas, ts, chunk, chain, plan, pack, sp_want,
                                            fp_want, pend)

    drawer = CpuDrawer(stylesheet_dir=STYLESHEET_DIR)
    p = renderers[("exact", "default")].prepare(z15, 1)
    got = renderers[("exact", "default")].render_prepared(p).cpu().numpy()
    worst_px, frac, checked = 0, 0.0, 0
    for i, (ents, t) in enumerate(z15):
        if i in p.cpu_fallback_tiles:
            continue
        want = drawer.draw_to_pixels(ents, t, 1, styler)
        d = np.abs(want.astype(int) - got[i].astype(int))
        worst_px, frac = max(worst_px, int(d.max())), max(frac, float((d > 0).mean()))
        checked += 1
        if d.max() > 1 or (d > 0).mean() >= 0.01:
            raise AssertionError(f"dense exact {t}: max |diff| {d.max()}, "
                                 f"{100 * (d > 0).mean():.3f} % of values off the oracle")
    log(f"  (b) exact minicity z15 x{len(z15)} through the kernels vs CpuDrawer: {checked} tiles "
        f"checked ({len(p.cpu_fallback_tiles)} left to the oracle), max |diff| {worst_px}, "
        f"worst tile {100 * frac:.4f} % of values off")

    attrs = {p: DC.kernel_attributes(p) for p in ("exact", "fast")}
    log("  (c) dense_fill_alpha: " + "; ".join(
        f"{p} {a['regs']} registers, {a['local_bytes']} spill bytes, {a['shared_bytes']} static "
        f"shared bytes, {a['blocks_per_sm']} CTAs an SM"
        for p, a in ((p, attrs[p]["dense_fill_alpha"]) for p in ("exact", "fast"))))
    for (precision, name), args in timed.items():
        t_batch = time.perf_counter()
        batch, canvas, ts, chunk, chain, plan, pack, sp_want, fp_want, pend = args
        bounds = dense_bounds(batch, plan, pack, sp_want, fp_want)
        scratch = DC.new_pending(batch, pack)
        dev_ms = {
            "dense_stroke_alpha": device_ms(lambda: DC.stroke_alpha(batch, pack, scratch, chain),
                                            10),
            "dense_fill_alpha": device_ms(lambda: DC.fill_alpha(batch, pack, scratch), 10),
            "dense_blend_finalize": device_ms(lambda: DC.blend_finalize(batch, canvas, pack,
                                                                        pend), 10),
        }
        strokes_only = plan._replace(fills=[])
        fills_only = plan._replace(strokes=plan.strokes[:0], stroke_passes=[])
        plain_ms = {
            "dense_stroke_alpha": _event_ms(lambda: RD.alphas(batch, strokes_only, chain), 1),
            "dense_fill_alpha": _event_ms(lambda: RD.alphas(batch, fills_only, chain), 1),
            "dense_blend_finalize": _event_ms(lambda: RD.blend(batch, canvas, plan, pend), 1),
        }

        def kernels():
            return RD.render_batch(batch, canvas, ts, chunk, precision, chain, plan, pack)

        def plain():
            return RD.render_batch_plain(batch, canvas, ts, chunk, precision, chain, plan)

        total = _event_ms(kernels, 5)
        total_dev = device_ms(kernels, 10)
        plain_total = _event_ms(plain, 1)
        ops, peak = _device_launches(kernels, 5), _peak_bytes(kernels)
        # The plain version's operations and memory: on the 30-tile batch
        # only (PR 6's reference); a 97-tile trace takes ~10 s.
        plain_ops = plain_peak = -1
        if name == "minicity_z15_x30":
            plain_ops, plain_peak = _device_launches(plain), _peak_bytes(plain)
        if ops > DENSE_MAX_OPS:
            raise AssertionError(f"dense {precision} {name}: {ops} device operations a batch "
                                 f"through the kernels, more than {DENSE_MAX_OPS}")
        earlier = dict(zip(DC.KERNELS, EARLIER_DENSE_MS[(precision, name)]))
        row = dict(total_ms=total, total_dev_ms=total_dev, plain_ms=plain_total, launches=ops,
                   plain_launches=plain_ops, peak_bytes=peak, plain_peak_bytes=plain_peak,
                   fill_units=pack.n_fill_units,
                   rows_per_unit=pack.fill_rows / max(pack.n_fill_units, 1),
                   kernels={k: dict(ms=dev_ms[k], plain_ms=plain_ms[k], bound_ms=bounds[k][0],
                                    bound_by=bounds[k][1], earlier_ms=earlier[k])
                            for k in dev_ms})
        out.setdefault("timed", {})[(precision, name)] = row
        log(f"  (c) {smi}: {precision} {name} (C={batch.chunk_kind.shape[1]}, "
            f"{pack.n_strokes} segments over {pack.stroke_px} px, {pack.n_fills} fills over "
            f"{pack.fill_rows} rows, {pack.n_groups} groups, pending {pack.pending_size}): "
            f"kernels {total:.4f} ms a batch ({total_dev:.4f} device, enqueue hidden), plain "
            f"{plain_total:.2f} ms; device operations {ops} (plain {plain_ops}); peak memory "
            f"{peak / 2**20:.1f} MiB (plain {max(plain_peak, 0) / 2**20:.1f}); "
            f"{time.perf_counter() - t_batch:.1f} s")
        for k in DC.KERNELS:
            r, a = row["kernels"][k], attrs[precision][k]
            units = (f"; {row['fill_units']} units, {row['rows_per_unit']:.2f} rows a unit"
                     if k == "dense_fill_alpha" else "")
            log(f"      {k}: {r['ms']:.4f} ms device (first design {r['earlier_ms']:.4f}), "
                f"bound {r['bound_ms']:.6f} ms ({r['bound_by']}), "
                f"{100 * r['bound_ms'] / r['ms']:.2f} % of it; plain function "
                f"{r['plain_ms']:.2f} ms; {a['regs']} registers, {a['local_bytes']} spill "
                f"bytes, {a['shared_bytes']} static shared bytes, {a['blocks_per_sm']} CTAs an SM"
                f"{units}")
    out["worst"] = worst


def fetch(url: str, timeout: float = 300.0):
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.status, resp.read()


# The CLI under the import guard: `python -c LAUNCHER CONF`.
LAUNCHER = _NO_JAX + (
    "import runpy\nsys.argv = ['renderer_main', sys.argv[1]]\n"
    "runpy.run_module('osm_renderer_tpu_torch.cli.renderer_main', run_name='__main__')\n"
)


def server_conf(name, device="cuda", precision="fast", gpus=1, style=DEFAULT_STYLE):
    """An INI for the CLI on a free port, serving the minicity with
    labels under `style` (directory, file, type) -> (path, port)."""
    import socket

    os.makedirs(OUT_DIR, exist_ok=True)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    conf = os.path.join(OUT_DIR, f"{name}.conf")
    with open(conf, "w") as f:
        f.write(
            f"[http]\naddress = 127.0.0.1:{port}\n[geodata]\nfile = {MINI_BIN}\n"
            f"[style]\nfile = {os.path.join(style[0], style[1])}\ntype = {style[2]}\n"
            f"[render]\nbackend = device\ndevice = {device}\nprecision = {precision}\n"
            f"gpus = {gpus}\nlabels = yes\npng-level = 1\nwarmup = yes\n"
        )
    return conf, port


def phase_server(styler, rows_out, device="cuda", precision="fast", gpus=1,
                 style=DEFAULT_STYLE):
    """renderer_main serving the minicity (labels = yes) under the import
    guard.  precision "fast": the kernels' path, >= 32 distinct tiles;
    "exact": the dense renderer, >= 16 distinct tiles, and no kernel or
    wire may run.  gpus > 1: every renderer listed at shutdown, and more
    than one of them rendered tiles."""
    import numpy as np
    from PIL import Image

    from osm_renderer_tpu_torch.tools.corpus import zoom_tiles
    from osm_renderer_tpu_torch.draw.drawer import CpuDrawer
    from osm_renderer_tpu_torch.geodata.reader import GeodataReader

    exact = precision == "exact"
    name = {"fast": "server", "exact": "server_exact"}[precision]
    if gpus > 1:
        name += f"_gpus{gpus}"
    if style != DEFAULT_STYLE:
        name += f"_{style[2]}"
    conf, port = server_conf(name, device, precision, gpus, style)
    log_path = os.path.join(OUT_DIR, f"{name}.log")
    launcher = LAUNCHER
    reader = GeodataReader.load(MINI_BIN)
    from osm_renderer_tpu_torch.core.tile import Tile

    z15 = zoom_tiles(reader, 15)
    n15, n2x, nz = (8, 3, 2) if exact else (20, 6, 3)
    reqs = [(t, 1) for t in z15[:n15]] + [(t, 2) for t in z15[:n2x]]
    for z in (13, 14, 16, 17):
        reqs += [(t, 1) for t in zoom_tiles(reader, z)[:nz]]
    reqs += [(Tile(16, z15[0].x * 2, z15[0].y * 2), 2)]
    if len(set(reqs)) < (16 if exact else 32):
        raise AssertionError(f"only {len(set(reqs))} distinct tiles to request")

    with open(log_path, "w") as logf:
        proc = subprocess.Popen(
            [sys.executable, "-c", launcher, conf], cwd=ROOT, stdout=logf,
            stderr=subprocess.STDOUT,
        )
    try:
        t0 = time.time()
        while True:
            with open(log_path) as f:
                text = f.read()
            if "Serving tiles" in text:
                break
            if proc.poll() is not None:
                raise AssertionError(f"server exited with {proc.returncode}:\n{text[-4000:]}")
            if time.time() - t0 > 600:
                raise AssertionError("server did not start within 600 s")
            time.sleep(0.5)
        log(f"  server up after {time.time() - t0:.1f} s (warmup included)")

        def get(req):
            t, s = req
            suffix = f"@{s}x" if s > 1 else ""
            return fetch(f"http://127.0.0.1:{port}/{t.zoom}/{t.x}/{t.y}{suffix}.png")

        t1 = time.time()
        with concurrent.futures.ThreadPoolExecutor(max_workers=len(reqs)) as ex:
            got = list(ex.map(get, reqs))
        serve_s = time.time() - t1
        status, perf_html = fetch(f"http://127.0.0.1:{port}/perf_stats", 60)
        if status != 200 or b"Device time (batch share)" not in perf_html:
            raise AssertionError("/perf_stats did not report device spans")
        fetch(f"http://127.0.0.1:{port}/shutdown", 60)
        proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    with open(log_path) as f:
        text = f.read()
    if proc.returncode != 0:
        raise AssertionError(f"server exited with {proc.returncode}:\n{text[-4000:]}")
    launches, counts, dense, writer = {}, {}, None, None
    for line in text.splitlines():
        if line.startswith("png writer: "):
            writer, _, rest = line[len("png writer: "):].partition("; containers while serving:")
            counts["containers"] = {k: int(v) for k, v in
                                    (kv.rsplit("=", 1) for kv in rest.split())}
        for kernel in ("render", "emit", "expand"):
            if line.startswith(f"{kernel} kernel launches while serving:"):
                launches[kernel] = int(line.rsplit(":", 1)[1])
        if line.startswith("dense kernel launches while serving:"):
            dense = int(line.rsplit(":", 1)[1])
        if line.startswith("dense kernel launches by kernel while serving:"):
            pairs = (kv.rsplit("=", 1) for kv in line.split(":", 1)[1].split())
            counts["dense by kernel"] = {k: int(v) for k, v in pairs}
        for what in ("batches", "readback bytes", "tiles by renderer"):
            if line.startswith(f"{what} while serving:"):
                counts[what] = {k: int(v) for k, v in
                                (kv.rsplit("=", 1) for kv in line.split(":", 1)[1].split())}
    batches = counts.get("batches", {})
    by_renderer = counts.get("tiles by renderer", {})
    if len(by_renderer) != (1 if exact else gpus):
        raise AssertionError(f"the server listed renderers {by_renderer}, want "
                             f"{1 if exact else gpus}")
    if gpus > 1 and sum(1 for v in by_renderer.values() if v) < 2:
        raise AssertionError(f"gpus = {gpus}: fewer than two renderers rendered tiles "
                             f"({by_renderer})")
    by_kernel = counts.get("dense by kernel", {})
    if dense is None or sum(by_kernel.values()) != dense:
        raise AssertionError(f"the server printed dense launches {dense}, by kernel {by_kernel}")
    if exact:
        if len(launches) != 3 or any(launches.values()):
            raise AssertionError(f"the exact server launched kernels ({launches}):"
                                 f"\n{text[-4000:]}")
        if not all(by_kernel.get(k) for k in ("dense_stroke_alpha", "dense_fill_alpha",
                                              "dense_blend_finalize")):
            raise AssertionError(f"the exact server did not launch every dense kernel "
                                 f"({by_kernel}):\n{text[-4000:]}")
        if not batches.get("dense") or any(batches.get(k) for k in ("arena", "plain", "v1",
                                                                    "v2", "labeled_tiles")):
            raise AssertionError(f"the exact server did not serve dense batches only "
                                 f"({batches})")
    else:
        if dense:
            raise AssertionError(f"the fast server launched dense kernels ({by_kernel})")
        if not all(launches.get(k) for k in ("render", "emit", "expand")):
            raise AssertionError(f"server did not launch every kernel while serving "
                                 f"({launches}):\n{text[-4000:]}")
        if not batches.get("arena") or not batches.get("v2"):
            raise AssertionError(f"server served no arena batch or no v2 wire batch "
                                 f"({batches})")
        if not batches.get("labeled_tiles"):
            raise AssertionError(f"server labeled no tile on the device ({batches})")

    from osm_renderer_tpu_torch.draw.labels.labeler import Labeler

    labeler = Labeler(icon_base_path=style[0], use_atlas=True, label_cache_tiles=0)
    drawer = CpuDrawer(labeler=None, stylesheet_dir=style[0])
    worst_unlabeled = worst_labeled = 0
    n_unlabeled = n_labeled = 0
    for (t, s), (status, png) in zip(reqs, got):
        if status != 200 or png[:8] != b"\x89PNG\r\n\x1a\n":
            raise AssertionError(f"{t}@{s}x: HTTP {status}, not a PNG")
        img = np.asarray(Image.open(io.BytesIO(png)).convert("RGB"))
        if img.shape != (256 * s, 256 * s, 3):
            raise AssertionError(f"{t}@{s}x: PNG of shape {img.shape}")
        ents = reader.get_entities_in_tile_with_neighbors(t)
        want = drawer.draw_to_pixels(ents, t, s, styler)
        if labeler.ensure_layer(ents, t, float(s), styler, 256 * s) is None:
            d = int(np.abs(img.astype(int) - want.astype(int)).max())
            worst_unlabeled = max(worst_unlabeled, d)
            n_unlabeled += 1
            bar = 1
        else:
            # 1/255 for the render, 1/255 for the blit's quantization.
            want = labeler.composite_labels(want, ents, t, float(s), styler)
            d = int(np.abs(img.astype(int) - want.astype(int)).max())
            worst_labeled = max(worst_labeled, d)
            n_labeled += 1
            bar = 2
        if d > bar:
            raise AssertionError(f"{t}@{s}x: served tile is {d}/255 off the C++ oracle "
                                 f"(labels composited on the host for the labeled ones)")
    if n_unlabeled == 0 or n_labeled == 0:
        raise AssertionError(f"{n_unlabeled} unlabeled and {n_labeled} labeled tiles served: "
                             "both kinds are needed")
    from osm_renderer_tpu_torch.draw.png8 import WRITER

    if writer != WRITER:
        raise AssertionError(f"{name}: png writer {writer!r}, want {WRITER!r}")
    pngs = [png for _, png in got]
    if exact:  # raw batches, labels composited on the host
        containers = check_exact_containers(name, counts.get("containers"), pngs,
                                            sum(by_renderer.values()))
    else:
        containers = check_containers(name, counts.get("containers"), pngs, len(reqs))
    rb = counts.get("readback bytes", {})
    log(f"  served {len(reqs)} distinct tiles ({precision}) in {serve_s:.2f} s: "
        "all HTTP 200 + PNG; "
        f"{n_unlabeled} unlabeled tiles max |diff| vs oracle = {worst_unlabeled}; "
        f"{n_labeled} labeled tiles max |diff| vs oracle + host composite = {worst_labeled}")
    log(f"  png writer: {writer}; containers while serving: {containers}")
    log(f"  kernel launches while serving: {launches}; dense kernel launches while serving: "
        f"{dense} {by_kernel}; batches: {batches}; "
        f"readback bytes: wire {rb.get('wire')} for raw planar {rb.get('planar')}; "
        f"tiles by renderer: {by_renderer}")
    if exact:
        log(f"  exact CLI: {len(reqs) / serve_s:.2f} tiles/s ({len(reqs)} distinct tiles "
            f"requested at once, cold, labels on)")
    rows_out.update(launches=launches, dense_launches=by_kernel,
                    tiles_per_s=len(reqs) / serve_s)


def check_exact_containers(name, containers, pngs, device_tiles):
    """The exact server's containers: it reads its dense batches back raw
    and composites labels on the host, so no PNG is colour type 3, no
    tile is counted as png8, an overflow or a v1 tile, and its raw and
    host-labeled tiles are the `device_tiles` its renderer drew.  -> the
    counts, printed by the caller."""
    if containers is None:
        raise AssertionError(f"{name}: the server printed no containers line")
    type3 = sum(p[25] == 3 for p in pngs)
    other = {k: v for k, v in containers.items() if k not in ("rgb_raw", "rgb_host_labels") and v}
    raw = containers.get("rgb_raw", 0) + containers.get("rgb_host_labels", 0)
    if type3 or other or raw != device_tiles:
        raise AssertionError(f"{name}: {type3} PNGs of colour type 3, containers {containers} "
                             f"for {device_tiles} device tiles (want only rgb_raw and "
                             "rgb_host_labels, summing to them)")
    return dict(containers, device_tiles=device_tiles)


def check_containers(name, containers, pngs, n_tiles, oracle=None):
    """The served PNGs' containers against the server's count of its
    device tiles by container (server/http.py CONTAINERS): no tile had its
    labels composited on the host; the PNGs of colour type 3 (IHDR byte
    25) are the png8 tiles, each decoding to a palette image; an RGB PNG
    of at most 256 colours is a tile of a v1 or raw batch or an oracle
    tile (`oracle` of them where the caller knows, else every tile not
    counted as a device tile), and at least `rgb_overflow` RGB PNGs have
    more than 256 colours.  -> the counts, printed by the caller."""
    import numpy as np
    from PIL import Image

    if containers is None:
        raise AssertionError(f"{name}: the server printed no containers line")
    if containers.get("rgb_host_labels"):
        raise AssertionError(f"{name}: {containers['rgb_host_labels']} tiles had their labels "
                             "composited on the host")
    type3 = [p for p in pngs if p[25] == 3]
    if len(type3) != containers.get("png8", 0):
        raise AssertionError(f"{name}: {len(type3)} PNGs of colour type 3, the server counted "
                             f"{containers}")
    if any(Image.open(io.BytesIO(p)).mode != "P" for p in type3):
        raise AssertionError(f"{name}: a PNG-8 does not decode to a palette image")
    few = many = 0
    for p in pngs:
        if p[25] != 3:
            colours = len(np.unique(np.asarray(Image.open(io.BytesIO(p)).convert("RGB"))
                                    .reshape(-1, 3), axis=0))
            few, many = few + (colours <= 256), many + (colours > 256)
    if oracle is None:
        oracle = n_tiles - sum(containers.values())
    allowed = oracle + containers.get("rgb_v1", 0) + containers.get("rgb_raw", 0)
    if few > allowed or many < containers.get("rgb_overflow", 0):
        raise AssertionError(f"{name}: {few} RGB PNGs of at most 256 colours (allowed "
                             f"{allowed}: v1, raw and oracle tiles) and {many} of more "
                             f"(overflows counted {containers.get('rgb_overflow', 0)})")
    return dict(containers, oracle=oracle, rgb_fitting_a_palette=few)


def warm_tile_ms(svc, n: int, reps: int = 5):
    """Warm-up, then the first `n` z15 tiles twice (cold: assembly and
    caps; then the caps settle), then `reps` timed passes with every
    renderer's batch counts and the perf stats reset -> (wall ms a tile,
    {span: ms a tile}, tiles a pass)."""
    from osm_renderer_tpu_torch.tools.corpus import zoom_tiles
    from osm_renderer_tpu_torch.core.tile import Tile
    from osm_renderer_tpu_torch.perfstats import PerfStats

    svc.warmup()
    tiles = [(Tile(15, t.x, t.y), 1) for t in zoom_tiles(svc.reader, 15)[:n]]
    svc.render_tiles_device(tiles)
    svc.render_tiles_device(tiles)
    svc.perf_stats = PerfStats()
    for r in svc.batch_renderers:
        r.batch_counts.update(dict.fromkeys(r.batch_counts, 0))
    t0 = time.perf_counter()
    for _ in range(reps):
        svc.render_tiles_device(tiles)
    wall = (time.perf_counter() - t0) * 1e3 / (reps * len(tiles))
    root = svc.perf_stats.by_zoom[15]
    count = svc.perf_stats.tile_counts[15]
    return wall, {k: 1e3 * v.total / count for k, v in root.children.items()
                  if v.kind == "span"}, len(tiles)


def phase_inprocess(styler, device):
    """Warm served path in this process: the server's per-tile spans over
    warm batches (PNG cache off; labels off, and on for minicity)."""
    from osm_renderer_tpu_torch.server.http import TileService

    for city, path, n, labels in (("minicity", MINI_BIN, 30, False),
                                  ("bigcity", BIG_BIN, 32, False),
                                  ("minicity", MINI_BIN, 30, True)):
        svc = TileService(path, styler, STYLESHEET_DIR, enable_labels=labels, png_cache_tiles=0,
                          device=str(device))
        wall, spans, n = warm_tile_ms(svc, n)
        counts = svc.batch_renderer.batch_counts
        if labels and not counts["labeled_tiles"]:
            raise AssertionError(f"{city}: warm labeled batches labeled no tile on the device")
        log(f"  {city} z15 x{n} warm, labels {'on' if labels else 'off'}: "
            f"{wall:.3f} ms/tile wall; per tile "
            + ", ".join(f"{k} {v:.3f} ms" for k, v in spans.items())
            + f"; batches {counts}")


def phase_trace_card(smi):
    """tests/test_torch_trace_card.py in a fresh process (its own
    profiler; without the suite's conftest, which imports jax); its
    device-time line is logged."""
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "--noconftest", "-q", "-s", "-p", "no:cacheprovider",
         os.path.join("tests", "test_torch_trace_card.py")],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    lines = proc.stdout.strip().splitlines()
    for line in lines if proc.returncode else [ln for ln in lines if "device time" in ln]:
        log(f"    | {line} ({smi})")
    if proc.returncode != 0 or "1 passed" not in proc.stdout:
        raise AssertionError(f"tests/test_torch_trace_card.py failed (exit {proc.returncode})")


def phase_decomp(prepared, row, smi):
    """The render kernel's device time by chunk kind on the bigcity z15
    batch (osm_renderer_tpu_torch.tools.kdecomp_device, torch.profiler):
    `full` byte-identical to the unmodified batch (the tool checks it)
    and within 10 % of phase 3's device_ms for the same batch."""
    from osm_renderer_tpu_torch.tools import kdecomp_device

    rows = kdecomp_device.decompose(prepared, reps=8)
    T = prepared.batch.tile_range.shape[0]
    for r in rows:
        log(f"  {r['name']:>12}: {r['ms']:.4f} ms device ({T / r['ms'] * 1e3:.0f} t/s), "
            f"{r['launches']} launches in 8 calls, live chunks by kind {r['chunks']}")
    full = rows[0]["ms"]
    off = abs(full - row["kernel_dev_ms"]) / row["kernel_dev_ms"]
    log(f"  full {full:.4f} ms (profiler) vs phase 3's device_ms {row['kernel_dev_ms']:.4f}: "
        f"{100 * off:.1f} % apart; byte-identical to the unmodified batch ({smi})")
    if off > 0.10:
        raise AssertionError(f"full variant {full:.4f} ms is {100 * off:.1f} % off phase 3's "
                             f"device_ms {row['kernel_dev_ms']:.4f}")


def phase_multi(styler, smi, device):
    """Several renderers, one a GPU (G = torch.cuda.device_count() >= 2),
    or two renderers on `device` (cuda:0) when G = 1.  (a) MeshTileRenderer equals
    one BatchRenderer on minicity and bigcity z15; (b) a multi-renderer
    TileService (labels on, PNG cache off) serves minicity z15, z13-z17
    and @2x tiles byte-identical to a one-renderer service, cold and warm;
    (c) more than one renderer rendered, each one used holds arena rows
    and ran v1 batches until its first wire was read back (its first two
    batches: the group streams; one more for each raw fallback) and then
    v2 batches, and the launch counters, set to 0 just before, equal the
    renderers' batches; (d) G >= 2: the CLI serves with gpus = G and
    phase 5's bars; G = 1: TileService(gpus=2) and the CLI with gpus = 2
    fail with the ValueError; (e) warm per-tile wall and spans on bigcity
    z15, one renderer against several; (f) start_wire_copy records on
    the wire's device, whatever the current device is."""
    import numpy as np
    import torch
    from PIL import Image

    from osm_renderer_tpu_torch.draw import png8
    from osm_renderer_tpu_torch.tools.corpus import zoom_tiles
    from osm_renderer_tpu_torch.geodata.reader import GeodataReader
    from osm_renderer_tpu_torch.ops import render_cuda, rle_cuda
    from osm_renderer_tpu_torch.parallel.renderer import (
        BatchRenderer,
        MeshTileRenderer,
        start_wire_copy,
        wait_executed,
    )
    from osm_renderer_tpu_torch.server.http import TileService

    G = torch.cuda.device_count() if device.type == "cuda" else 1
    if G >= 2:
        devices = [torch.device("cuda", i) for i in range(G)]
        log(f"  case: {G} GPUs, one renderer on each")
    else:
        devices = [device] * 2
        log(f"  case: 1 GPU, two renderers on {device} (the split, each renderer's own arena, "
            "slab, palette and wires, and the gather)")

    for city, path in (("minicity", MINI_BIN), ("bigcity", BIG_BIN)):
        reader = GeodataReader.load(path)
        te = [(reader.get_entities_in_tile_with_neighbors(t), t) for t in zoom_tiles(reader, 15)]
        want = BatchRenderer(styler, stylesheet_dir=STYLESHEET_DIR, device=devices[0]).render(te)
        got = MeshTileRenderer(styler, devices=devices, stylesheet_dir=STYLESHEET_DIR).render(te)
        if got.shape != want.shape or not np.array_equal(got, want):
            raise AssertionError(f"(a) {city}: MeshTileRenderer differs from one BatchRenderer")
        log(f"  (a) {city} z15 x{len(te)}: MeshTileRenderer over {len(devices)} renderers "
            "byte-identical to one BatchRenderer")

    def service(path, labels, several):
        kw = dict(enable_labels=labels, png_cache_tiles=0, device=str(device))
        if not several:
            return TileService(path, styler, STYLESHEET_DIR, **kw)
        if G >= 2:
            return TileService(path, styler, STYLESHEET_DIR, gpus=G, **kw)
        svc = TileService(path, styler, STYLESHEET_DIR, **kw)
        svc.batch_renderers = [svc.batch_renderer, svc.fast_renderer(devices[1])]
        return svc

    one, multi = service(MINI_BIN, True, False), service(MINI_BIN, True, True)
    z15 = zoom_tiles(multi.reader, 15)
    reqs = [(t, 1) for t in z15] + [(t, 2) for t in z15[:6]]
    for z in (13, 14, 16, 17):
        reqs += [(t, 1) for t in zoom_tiles(multi.reader, z)[:4]]
    render_cuda.RENDER_KERNEL_LAUNCHES = 0
    rle_cuda.EMIT_KERNEL_LAUNCHES = 0
    rle_cuda.EXPAND_KERNEL_LAUNCHES = 0
    got = [multi.render_tiles_device(reqs) for _ in range(2)]
    launched = (render_cuda.RENDER_KERNEL_LAUNCHES, rle_cuda.EMIT_KERNEL_LAUNCHES,
                rle_cuda.EXPAND_KERNEL_LAUNCHES)
    want = [one.render_tiles_device(reqs) for _ in range(2)]
    # PNG colour type (IHDR byte 25): every host ships PNG-8 from v2
    # wires (through the port's host codec) and RGB from v1 wires, and each
    # renderer's first batch takes the v1 wire, so one renderer and
    # several take v1 and v2 wires at other tiles.  Such pairs must
    # decode to the same pixels; all others must be equal.
    def pixels(png):
        return np.asarray(Image.open(io.BytesIO(png)).convert("RGB"))

    recoded = 0
    for when, g, w in zip(("cold", "warm"), got, want):
        bad = []
        for (t, s), a, b in zip(reqs, g, w):
            if a == b:
                continue
            if a[25] != b[25] and np.array_equal(pixels(a), pixels(b)):
                recoded += 1
                continue
            bad.append(f"{t}@{s}x")
        if bad:
            raise AssertionError(f"(b) {when}: {len(bad)} PNGs differ from one renderer's: "
                                 f"{bad[:4]}")
    log(f"  (b) {len(reqs)} minicity tiles (z13-z17, {sum(s == 2 for _, s in reqs)} @2x), "
        f"labels on: PNGs byte-identical to one renderer's, cold and warm ({recoded} of "
        f"{2 * len(reqs)} in another PNG type, their pixels identical)")
    for who, svc, pngs in (("one renderer", one, want), ("several", multi, got)):
        counted = check_containers(f"(b) {who}", dict(svc.containers), pngs[0] + pngs[1],
                                   2 * len(reqs), oracle=svc.tiles_served["oracle"])
        log(f"  (b) {who}: png writer {png8.WRITER}; containers of the cold and warm "
            f"passes {counted} ({smi})")

    used = [d for d in range(len(multi.batch_renderers)) if multi.tiles_by_renderer[d]]
    if len(used) < 2:
        raise AssertionError(f"(c) only renderers {used} rendered tiles")
    per = {}
    for d in used:
        r = multi.batch_renderers[d]
        c = r.batch_counts
        if r.chunk_arena is None or not r.chunk_arena._offsets:
            raise AssertionError(f"(c) renderer {d} holds no arena rows")
        # The cold group streams in sub-batches, and each renderer's
        # second batch is dispatched before its first wire (which teaches
        # it the palette) is read back: v1 twice, then v2.
        if not (1 <= c["v1"] <= 2 + c["raw"]) or not c["v2"]:
            raise AssertionError(f"(c) renderer {d} did not run its first two batches on v1, "
                                 f"then v2: {c}")
        per[d] = dict(c, tiles=multi.tiles_by_renderer[d], arena_rows=len(r.chunk_arena._offsets))
    total = {k: sum(multi.batch_renderers[d].batch_counts[k] for d in used)
             for k in ("arena", "plain", "v1", "v2")}
    want_launches = (total["arena"] + total["plain"], total["v1"] + total["v2"], total["v2"])
    if launched != want_launches or not all(launched):
        raise AssertionError(f"(c) launches {launched} (render, emit, expand), want the "
                             f"renderers' batches {want_launches}")
    log(f"  (c) renderers used {used} of {len(multi.batch_renderers)}: {per}; launches "
        f"(render, emit, expand) {launched} = the renderers' batches")

    r = multi.batch_renderers[-1]
    te = [(multi.reader.get_entities_in_tile_with_neighbors(t), t) for t in z15[:8]]
    rendered = r.render_prepared_rle(r.prepare(te, 1))
    # ~0.1 s on the wire's device's stream, queued behind its kernels (not
    # before them: the launch's pageable upload would wait it out).
    with torch.cuda.device(r.device):
        torch.cuda._sleep(200_000_000)
    with torch.cuda.device(devices[0]):
        res = start_wire_copy(rendered)
        pending = (not res.executed.query(), not res.copied.query())
    wait_executed(res)
    view = r.fetch_tile_view(res)
    planar = res.planar[:len(te), :3].permute(0, 2, 3, 1).cpu().numpy()
    same = all(np.array_equal(view.rgb(i), planar[i]) for i in range(len(te)))
    if pending != (True, True) or not same:
        raise AssertionError(f"(f) wire on {r.device}, current device {devices[0]}: events "
                             f"pending {pending}, read-back wire equal to the pixels: {same}")
    log(f"  (f) {res.fmt} wire of {len(te)} tiles on {r.device}, copy queued with the current "
        f"device {devices[0]}: both events pending behind the sleep, the read-back wire equal "
        "to the batch's pixels")

    if G >= 2:
        phase_server(styler, {}, gpus=G)
    else:
        try:
            TileService(MINI_BIN, styler, STYLESHEET_DIR, device=str(device), gpus=2)
        except ValueError as e:
            log(f"  (d) TileService(gpus=2) refused: ValueError: {e}")
        else:
            raise AssertionError("(d) TileService(gpus=2) served on one GPU")
        conf, _ = server_conf("server_gpus2", device=str(device), gpus=2)
        proc = subprocess.run([sys.executable, "-c", LAUNCHER, conf], cwd=ROOT,
                              capture_output=True, text=True, timeout=300)
        if (proc.returncode == 0 or "ValueError: gpus = 2" not in proc.stderr
                or "Serving tiles" in proc.stdout):
            raise AssertionError(f"(d) the CLI with gpus = 2 did not fail with the ValueError "
                                 f"(exit {proc.returncode}):\n{proc.stdout[-2000:]}"
                                 f"{proc.stderr[-2000:]}")
        log(f"  (d) the CLI with gpus = 2 exited {proc.returncode}: "
            f"{proc.stderr.strip().splitlines()[-1]}")

    for several in (False, True):
        svc = service(BIG_BIN, False, several)
        wall, spans, n = warm_tile_ms(svc, 32)
        ex = spans.get("Device time (batch share)", 0.0)
        ce = spans.get("Compose and encode", 0.0)
        log(f"  (e) bigcity z15 x{n} warm, labels off, {len(svc.batch_renderers)} "
            f"renderer(s): {wall:.3f} ms/tile wall; device time {ex:.3f} ms "
            f"({100 * ex / wall:.1f} %), compose and encode {ce:.3f} ms ({100 * ce / wall:.1f} %); "
            "per tile " + ", ".join(f"{k} {v:.3f} ms" for k, v in spans.items()) + f" ({smi})")


def _run_tool(main_fn, argv):
    """A tool's main(argv) in this process -> (exit status, its stdout
    lines), each line logged indented."""
    import contextlib

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main_fn(argv)
    lines = buf.getvalue().strip().splitlines()
    for line in lines:
        log(f"    | {line}")
    return rc, lines


def _run_tool_process(module, argv):
    """`python -m osm_renderer_tpu_torch.tools.<module>` in a fresh
    process -> (exit status, its stdout lines), each line logged
    indented.  The tools that read torch.profiler run so: after the
    sweep, this process's profiler once saw no device event in three
    traces in a row, and a fresh process starts with its own."""
    proc = subprocess.run([sys.executable, "-m", f"osm_renderer_tpu_torch.tools.{module}",
                           *argv], cwd=ROOT, capture_output=True, text=True, timeout=600)
    lines = proc.stdout.strip().splitlines()
    for line in lines + (proc.stderr.strip().splitlines()[-20:] if proc.returncode else []):
        log(f"    | {line}")
    return proc.returncode, lines


def phase_tools(smi, device, phase3_dev_ms, out):
    """The port's tools at scale (osm_renderer_tpu_torch/tools/):
    (a) scale_sweep --labels on the 112-block city, 915 tiles through a
    160-tile chunk cache, the launch counters set to 0 just before and
    read just after; bars: no arena leaks a row on any renderer, warm1
    and warm2 sizes equal, evictions > 0 and halvings > 0, every served
    tile from the device but the oracle tiles the tool counts, and each
    kernel launched; (b) the same tiles on an unpressured control service
    (4096-tile cache, the default arena) decode to warm2's pixels; (c)
    parity_check --all-z 13 on that city, labels off: worst <= 1/255;
    (d) warmup, profile_serving, cold_profile, ktime and kdecomp (these
    two as `python -m` processes: `_run_tool_process`) at their defaults
    exit 0, and kdecomp's `full` is within 10 % of phase 3's device ms on
    bigcity z15."""
    import numpy as np

    from osm_renderer_tpu_torch.ops import render_cuda, rle_cuda
    from osm_renderer_tpu_torch.tools import (
        cold_profile,
        parity_check,
        profile_serving,
        scale_sweep,
        warmup,
    )

    t0 = time.perf_counter()
    args = scale_sweep.parse_args(["--labels", "--device", str(device)])
    scale_sweep.ensure_fixture(args.blocks)
    log(f"  (a) fixture hugecity{args.blocks} ready in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    render_cuda.RENDER_KERNEL_LAUNCHES = 0
    rle_cuda.EMIT_KERNEL_LAUNCHES = 0
    rle_cuda.EXPAND_KERNEL_LAUNCHES = 0
    res = scale_sweep.run_sweep(args)
    launches = {"render": render_cuda.RENDER_KERNEL_LAUNCHES,
                "emit": rle_cuda.EMIT_KERNEL_LAUNCHES,
                "expand": rle_cuda.EXPAND_KERNEL_LAUNCHES}
    c, n = res["counters"], len(res["tiles"])
    served = sum(len(p) for p in res["pngs"].values())
    rates = ", ".join(f"{k} {len(res['pngs'][k]) / v:.1f} t/s ({v:.2f} s)"
                      for k, v in res["seconds"].items())
    log(f"  (a) {n} tiles {res['per_zoom']}, cache {args.cache_tiles} tiles a renderer, labels on: "
        f"{rates}; kernel launches {launches}; counters {c}; arenas {res['arenas']}; "
        f"warm1/warm2 size mismatches {res['mismatches']} (all size differences {res['sized']}) "
        f"({smi})")
    bad = scale_sweep.failures(res)
    if c["evictions"] <= 0 or c["halvings"] <= 0:
        bad.append(f"evictions {c['evictions']} and halvings {c['halvings']} must both be > 0")
    if c["device_tiles"] + c["oracle_tiles"] != served:
        bad.append(f"{c['device_tiles']} device and {c['oracle_tiles']} oracle tiles for "
                   f"{served} served")
    if launches["render"] != c["arena_batches"] + c["plain_batches"]:
        bad.append(f"render launches {launches['render']} != the renderers' batches")
    if min(launches.values()) <= 0:
        bad.append(f"a kernel of the path was not launched: {launches}")
    if bad:
        raise AssertionError("(a) " + "; ".join(bad))
    out["sweep_launches"] = launches
    log(f"  (a) took {time.perf_counter() - t0:.1f} s ({smi})")

    t0 = time.perf_counter()
    control = scale_sweep.make_service(res["binf"], res["styler"], 4096, True, str(device))
    pngs, dt = scale_sweep.serve(control, res["tiles"], args.batch)
    warm2 = res["pngs"]["warm2"]
    differ = [t for t in res["tiles"]
              if not np.array_equal(scale_sweep.decode_png(pngs[t]),
                                    scale_sweep.decode_png(warm2[t]))]
    log(f"  (b) unpressured control (cache 4096 tiles, default arena): {n} tiles in {dt:.2f} s "
        f"({n / dt:.1f} t/s), {len(differ)} decode to other pixels than warm2's; "
        f"counters {scale_sweep.counters(control)} ({smi})")
    if differ:
        raise AssertionError(f"(b) {len(differ)} tiles differ from the control, first "
                             f"{differ[:3]}")
    binf = res["binf"]
    del res, control, pngs, warm2
    log(f"  (b) took {time.perf_counter() - t0:.1f} s ({smi})")

    t0 = time.perf_counter()
    sheet = os.path.join(STYLESHEET_DIR, "default.mapcss")
    rc, lines = _run_tool(parity_check.main, [binf, sheet, "--all-z", "13",
                                              "--device", str(device)])
    worst = int(lines[-1].split()[1].split("/")[0])
    if rc != 0 or worst > 1:
        raise AssertionError(f"(c) parity_check exited {rc}, worst {worst}/255")
    log(f"  (c) took {time.perf_counter() - t0:.1f} s ({smi})")

    for name, main_fn, argv in (
            ("warmup", warmup.main, [MINI_BIN, sheet]),
            ("profile_serving", profile_serving.main, []),
            ("cold_profile", cold_profile.main, []),
            ("ktime", None, []),
            ("kdecomp", None, [])):
        t0 = time.perf_counter()
        log(f"  (d) {name}")
        rc, lines = (_run_tool(main_fn, argv) if main_fn is not None
                     else _run_tool_process(name, argv))
        if rc != 0:
            raise AssertionError(f"(d) {name} exited {rc}")
        if name == "kdecomp":
            full = float(next(line for line in lines
                              if line.strip().startswith("full:")).split()[1])
            off = abs(full - phase3_dev_ms) / phase3_dev_ms
            log(f"  (d) kdecomp full {full:.4f} ms vs phase 3's device_ms {phase3_dev_ms:.4f}: "
                f"{100 * off:.1f} % apart")
            if off > 0.10:
                raise AssertionError(f"(d) kdecomp full {full:.4f} ms is {100 * off:.1f} % off "
                                     f"phase 3's {phase3_dev_ms:.4f}")
        log(f"  (d) {name} took {time.perf_counter() - t0:.1f} s ({smi})")


def phase_production(device, smi, phase3_rows, out):
    """Phase 10 (a): the reference's production stylesheet
    (osmosnimki-minimal.mapcss, type mapsme) on the card.  The render
    kernel against its twin (`phase_kernel` over `production_batches`:
    minicity z15, z16 and z17 @2x, bigcity z15), every tile but the
    oracle's within 1/255 of CpuDrawer, labels off; both wires against
    their plain versions on those planar batches (`phase_wire`: bigcity
    z15 also at the edge caps, and timed); the labeled entry against the
    CPU blit (`phase_labeled`); renderer_main with type = mapsme held to
    phase 5's bars (`phase_server`).  Prints the chunk-kind counts beside
    phase 3's, the halvings, and (in the phases it calls) the slab rows,
    the blit's ms and the raw-wire batches."""
    from osm_renderer_tpu_torch.mapcss.parser import parse_file
    from osm_renderer_tpu_torch.mapcss.styler import Styler

    rows, planars = [], []
    halvings = phase_kernel(device, PROD_STYLE, production_batches, rows, set(), planars,
                            arena=False, oracle=True)
    for name in ("minicity_z15[0]", "bigcity_z15[0]"):
        mine = next(x for x in rows if x["name"] == f"prod_{name}")
        theirs = next(x for x in phase3_rows if x["name"] == name)
        log(f"  chunk kinds (0-9) {name}: default.mapcss {theirs['kinds']} ({theirs['chunks']} "
            f"chunks), production {mine['kinds']} ({mine['chunks']} chunks)")
    log(f"  halvings in phase 10 (a): {halvings}")

    wire_rows: list = []
    decode: dict = {}
    out["worst"] = phase_wire(device, planars, wire_rows, decode)
    for name, d in decode.items():
        log(f"  host decode {name}: v2 {d['v2_ms']:.3f} ms/tile through the serving view, "
            f"v1 {d['v1_ms']:.3f} ms/tile; {d['words_per_tile']:.0f} words/tile")
    del planars
    styler = Styler(parse_file(PROD_DIR, PROD_SHEET), "mapsme")
    phase_labeled(device, styler, PROD_DIR, prefix="prod_")
    server: dict = {}
    phase_server(styler, server, style=PROD_STYLE)
    out.update(rows=rows, wire_rows=wire_rows, halvings=halvings,
               server_launches=server["launches"])


# The port's benchmark under the import guard: `python -c BENCH_LAUNCHER`.
BENCH_LAUNCHER = _NO_JAX + (
    "import runpy\nsys.argv = ['bench']\n"
    "runpy.run_module('osm_renderer_tpu_torch.bench', run_name='__main__')\n"
)


def phase_bench(device, smi, out):
    """Phase 10 (b): first the render kernel against its twin
    (`phase_kernel` over `bench_batches`) on the bench's own render
    batches that phase 3 does not hold (its z12-z17 pyramid, their fold
    and its @2x batch, at the bench's shapes); then
    `python -m osm_renderer_tpu_torch.bench` in a subprocess under the
    import guard (its stderr in build/smoke/bench.log), its JSON line
    printed on a line of its own.  Bars: phase 3's on each batch; the
    bench exits 0, correct true, every metric a positive number, the
    render, emit and expand kernels launched, and the card it names the
    one nvidia-smi named in phase 1."""
    import math

    from osm_renderer_tpu_torch.bench import metric_values

    rows: list = []
    halvings = phase_kernel(device, DEFAULT_STYLE, bench_batches, rows, set(), arena=False)
    log(f"  the bench's {len(rows)} render batches byte-identical to the twin "
        f"({halvings} halvings)")
    out["rows"] = rows
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "bench.log"), "w") as errf:
        proc = subprocess.run([sys.executable, "-c", BENCH_LAUNCHER], cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=errf, text=True, timeout=600)
    lines = proc.stdout.strip().splitlines()
    if not lines:
        raise AssertionError(f"the bench exited {proc.returncode} and printed nothing")
    line = json.loads(lines[-1])
    print(json.dumps(line), flush=True)
    bad = [k for k, v in metric_values(line).items()
           if isinstance(v, bool) or not isinstance(v, (int, float)) or not math.isfinite(v)
           or v <= 0]
    launches = line["detail"].get("kernel_launches", {})
    name = smi.rsplit(",", 1)[0].strip()
    if (proc.returncode != 0 or line["correct"] is not True or bad
            or line["device"].get("name") != name or len(launches) != 3
            or min(launches.values()) <= 0):
        raise AssertionError(f"the bench exited {proc.returncode}, correct "
                             f"{line['correct']}, metrics not positive {bad}, device "
                             f"{line['device']} (phase 1: {name!r}), launches {launches}; "
                             f"error {line['detail'].get('error')}")
    out.update(launches=launches, line=line)
    log(f"  the bench exited 0, correct, every metric positive, on {line['device']['name']} "
        f"at {line['device']['power_limit']}; kernel launches {launches}")
    log(f"  the bench's png writer: {line['detail'].get('png_writer')}; e2e_png_containers: "
        f"{line['detail'].get('e2e_png_containers')}")


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, "osm_renderer_tpu_torch")):
        return fail("run from a checkout of the repository (osm_renderer_tpu_torch/ missing)")
    sys.path.insert(0, ROOT)
    exec(_NO_JAX, {})
    import torch

    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is False: this run needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    log("phase 1: build (one nvcc per source, started together)")
    from osm_renderer_tpu_torch.ops import build

    t0 = time.perf_counter()
    build.build_all(ptxas_verbose=True)
    log(f"  all kernels built in {time.perf_counter() - t0:.2f} s")
    for source, seconds in sorted(build.BUILD_SECONDS.items()):
        log(f"  {source} nvcc build: {seconds:.2f} s")
        for line in build.PTXAS_REPORT[source].splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"  ptxas: {line.strip()}")
    import ctypes

    occ = [ctypes.c_int() for _ in range(3)]
    rc = build.render_library().osmr_render_occupancy(*(ctypes.byref(v) for v in occ))
    if rc != 0:
        return fail(f"render kernel occupancy query failed with cudaError_t {rc}")
    threads, smem, blocks = (v.value for v in occ)
    log(f"  render kernel: {threads} threads and {smem} B of dynamic shared memory a block, "
        f"{blocks} blocks ({blocks * threads // 32} warps) resident per SM")
    from osm_renderer_tpu_torch.utils.torch_setup import build_native_host_libs

    build_native_host_libs()
    from osm_renderer_tpu_torch.draw import png8

    png8.library()
    log(f"  png writer: {png8.WRITER} (host libraries built with g++ from "
        "native/ and osm_renderer_tpu_torch/csrc/wire_host.cpp)")

    log("phase 2: fixtures")
    build_fixtures()
    from osm_renderer_tpu_torch.mapcss.parser import parse_file
    from osm_renderer_tpu_torch.mapcss.styler import Styler

    styler = Styler(parse_file(STYLESHEET_DIR, "default.mapcss"), "josm")

    log("phase 3: render kernel vs its plain twin on the card "
        "(bar: byte-identical, max |diff| 0 and 0 membership mismatches), "
        "and the arena entry vs the plain entry (bar: byte-identical)")
    rows: list = []
    kinds_seen: set = set()
    planars: list = []
    kept: dict = {}
    phase_kernel(device, DEFAULT_STYLE, default_batches, rows, kinds_seen, planars, kept=kept)
    phase_scenes(device, rows, kinds_seen, planars)

    log("phase 3b: the render kernel's device ms by chunk kind on bigcity z15 "
        "(tools/kdecomp_device; bars: full byte-identical, within 10 % of phase 3)")
    phase_decomp(kept.pop("bigcity_z15[0]"),
                 next(r for r in rows if r["name"] == "bigcity_z15[0]"), smi)

    log("phase 4: wire kernels vs their plain versions on every phase-3 batch and three "
        "synthetic ones (bar: bit-identical wires; overflow flagged)")
    wire_rows: list = []
    decode: dict = {}
    worst = phase_wire(device, planars + synthetic_planars(device), wire_rows, decode)
    for name, d in decode.items():
        png8_part = (f"PNG-8 {d['png8_ms']:.4f} ms/tile and {d['png8_bytes']:.0f} B/tile on "
                     f"its {d['png8_tiles']} tiles that fit a palette (RGB through png_writer "
                     f"{d['zlib_rgb_png_bytes_fit']:.0f} B/tile on those)"
                     if d["png8_tiles"] else "no tile fits a palette")
        log(f"  host decode and encode {name} (png writer: {d['writer']}; {smi}): v2 "
            f"{d['v2_ms']:.4f} ms/tile through the port's decoder, {d['v2_numpy_ms']:.4f} "
            f"through the numpy plain version, {d['v2_loop_ms']:.3f} through the per-word "
            f"loop; v2 to index rows {d['v2_idx_ms']:.4f} ms/tile; v1 {d['v1_ms']:.4f} ms/tile; {d['words_per_tile']:.0f} words/tile; "
            f"{png8_part}; RGB PNG {d['zlib_rgb_png_ms']:.4f} ms/tile and "
            f"{d['zlib_rgb_png_bytes']:.0f} B/tile through png_writer (zlib, unfiltered)")
    del planars

    log("phase 4b: labeled arena entry (one render-kernel launch, the label blend in its "
        "finalize) (bars: (a) byte-identical to the CPU blit over the unlabeled entry, (b) "
        "<= 1/255 of the host composite, (c) alpha = 1 cores and outside the label bbox exact, "
        "(d) byte-identical to the blit on the card, (e) the unlabeled entry's torch "
        f"operators, none after the render launch) ({smi})")
    phase_labeled(device, styler)

    log("phase 4c: the dense renderer's kernels (csrc/dense.cu) on the card "
        "(bars: (a) byte-identical to the plain version on the card and on the CPU, each kernel "
        "to its plain function, exact and fast; (b) exact <= 1/255 of CpuDrawer with < 1 % of "
        "values off)")
    dense: dict = {}
    t0 = time.perf_counter()
    phase_dense(device, styler, smi, dense)
    log(f"  phase 4c took {time.perf_counter() - t0:.1f} s ({smi})")

    log("phase 5: served path (renderer_main, backend = device, labels = yes)")
    phase_server(styler, {})

    log("phase 5b: served exact (renderer_main, precision = exact, labels = yes; the dense "
        "kernels' main path)")
    t0 = time.perf_counter()
    exact_server: dict = {}
    phase_server(styler, exact_server, precision="exact")
    log(f"  phase 5b took {time.perf_counter() - t0:.1f} s ({smi})")

    log("phase 6: warm served path in process (PNG cache off; labels off, then on)")
    phase_inprocess(styler, device)

    log("phase 6b: the serving path's records on the card (tests/test_torch_trace_card.py; "
        "bars: every kernel inside its dispatch's logged intervals, the CUDA-event device "
        "time within 15 % of the profiler's device operations)")
    phase_trace_card(smi)

    log("phase 8: serving on several renderers (bars: (a) MeshTileRenderer byte-identical "
        "to one renderer, (b) served PNGs byte-identical to one renderer's, (c) the split "
        "used several renderers and every launch is a renderer's batch, (d) the CLI's gpus, "
        "(f) the wire's events on its device)")
    t0 = time.perf_counter()
    phase_multi(styler, smi, device)
    log(f"  phase 8 took {time.perf_counter() - t0:.1f} s ({smi})")

    log("phase 9: the tools at scale (bars: (a) the 915-tile sweep under a 160-tile cache, "
        "labels on: no arena leak, warm1 = warm2 sizes, evictions and halvings, tiles from the "
        "device; (b) = an unpressured control's pixels; (c) parity_check --all-z 13 <= 1/255; "
        "(d) warmup, profile_serving, cold_profile, ktime, kdecomp exit 0, kdecomp's full "
        "within 10 % of phase 3)")
    t0 = time.perf_counter()
    tools_out: dict = {}
    big = next(r for r in rows if r["name"] == "bigcity_z15[0]")
    phase_tools(smi, device, big["kernel_dev_ms"], tools_out)
    log(f"  phase 9 took {time.perf_counter() - t0:.1f} s ({smi})")

    log("phase 10: the production stylesheet (osmosnimki-minimal, mapsme) and the bench "
        "(bars: (a) the render kernel and both wires equal their plain versions, tiles within "
        "1/255 of CpuDrawer, the labeled entry equals the CPU blit, renderer_main with type = "
        "mapsme holds phase 5's bars; (b) the render kernel equals its twin on the bench's "
        "batches, the bench exits 0, correct, every metric positive)")
    t0 = time.perf_counter()
    prod: dict = {}
    phase_production(device, smi, rows, prod)
    log(f"  phase 10 (a) took {time.perf_counter() - t0:.1f} s ({smi})")
    t0 = time.perf_counter()
    bench_out: dict = {}
    phase_bench(device, smi, bench_out)
    log(f"  phase 10 (b) took {time.perf_counter() - t0:.1f} s ({smi})")
    log(f"  kernel launches by main path: sweep (phase 9 (a)) {tools_out['sweep_launches']}; "
        f"renderer_main mapsme (phase 10 (a)) {prod['server_launches']}; bench (phase 10 (b)) "
        f"{bench_out['launches']}")

    log("phase 7: no jax, no fontTools, no osm_renderer_tpu")
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in REFUSED)
    if loaded:
        return fail(f"imported {loaded[:5]}")
    log(f"  none of {', '.join(REFUSED)} in sys.modules")

    head = next(r for r in rows if r["name"] == "bigcity_z15[0]")
    wire_head = next(r for r in wire_rows if r["name"] == "bigcity_z15[0]")
    measured = {
        "render_planar": (max(r["max_diff"] for r in rows + prod["rows"] + bench_out["rows"]),
                          head["kernel_dev_ms"],
                          head["twin_ms"], head["bound_ms"], head["bound_by"]),
        "rle_emit": (max(worst["rle_emit"], prod["worst"]["rle_emit"]), wire_head["v1_dev_ms"],
                     wire_head["v1_plain_ms"], wire_head["v1_bound_ms"], "bytes"),
        "rle_expand": (max(worst["rle_expand"], prod["worst"]["rle_expand"]),
                       wire_head["v2_dev_ms"], wire_head["v2_plain_ms"],
                       wire_head["v2_bound_ms"], "bytes"),
    }
    big_exact = dense["timed"][("exact", "bigcity_z15_x97")]["kernels"]
    for name in DENSE_KERNELS:
        k = big_exact[name]
        measured[name] = (dense["max_abs_err"][name], k["ms"], k["plain_ms"], k["bound_ms"],
                          k["bound_by"])
    # Launches in each slice's main path: the bench's (phase 10 (b)) for
    # the render and wire kernels, the exact server's (phase 5b) for the
    # dense kernels.
    ran = bench_out["launches"]
    launches = {"render_planar": ran["render"], "rle_emit": ran["emit"],
                "rle_expand": ran["expand"], **exact_server["dense_launches"]}
    kernels = {"kernels": [
        {"name": name, "route": "cuda", "source": source, "replaces": replaces,
         "launches": launches[name], "max_abs_err": measured[name][0],
         "ms": measured[name][1], "plain_ms": measured[name][2],
         "bound_ms": measured[name][3], "bound_by": measured[name][4],
         # No single PyTorch call computes any of these functions.
         "library_ms": None, **({"note": KERNEL_NOTES[name]} if name in KERNEL_NOTES else {})}
        for name, (source, replaces) in {**KERNELS, **DENSE_KERNELS}.items()
    ]}
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
