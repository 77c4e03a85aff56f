#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase is skipped):

1. Card and toolchain: nvidia-smi name and power limit, torch and CUDA
   versions, the render kernel's nvcc build time and ptxas report.
2. Fixtures: the synthetic cities (tools/make_fixture.py --blocks 24 and
   48, then geodata.importer.import_osm) under assets/fixtures/.
3. Kernel against its plain PyTorch twin on the card, on real batches:
   every minicity z15 tile, the bigcity z15 tiles (split under
   MAX_BATCH_CHUNKS the way the server splits), @2x, @3x and @4x batches,
   a z13/z14 batch (per-segment strokes), an oversize-fill scene (host
   layers) and an icon-fill scene (pattern blend).
   Bar: max |diff| <= 1 per channel and no pixel painted by one and not
   the other.  Kernel time (CUDA events, after a warm run) beside the
   twin's time on the same batch.
4. The served path: `python -m osm_renderer_tpu_torch.cli.renderer_main`
   with backend = device, device = cuda on the minicity, labels = yes
   where fontTools (which the label renderer needs) is installed and
   labels = no otherwise, under an import guard that refuses jax;
   >= 32 distinct tiles requested
   concurrently (z13-z17, @1x and @2x); every response HTTP 200 with a
   valid PNG; unlabeled tiles within 1/255 of the C++ oracle (CpuDrawer);
   the server's render-kernel launch count while serving > 0.
5. No jax module was loaded.

The second-to-last line is the kernels JSON object, the last line
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
MINI_OSM = os.path.join(ROOT, "assets", "fixtures", "minicity.osm")
MINI_BIN = os.path.join(ROOT, "assets", "fixtures", "minicity.bin")
BIG_OSM = os.path.join(ROOT, "assets", "fixtures", "bigcity.osm")
BIG_BIN = os.path.join(ROOT, "assets", "fixtures", "bigcity.bin")
TPU_KERNEL = "osm_renderer_tpu/ops/render_pallas.py:1281"
KERNEL_SOURCE = "osm_renderer_tpu_torch/csrc/render.cu"

# Installed in this process and in the server subprocess: any import of
# jax fails loudly instead of loading.
_NO_JAX = """
import importlib.abc, sys
class _NoJax(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name == "jax" or name.startswith(("jax.", "jaxlib")):
            raise ImportError("jax must not be imported by the CUDA port: " + name)
        return None
sys.meta_path.insert(0, _NoJax())
"""


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    return 1


def build_fixtures() -> None:
    from osm_renderer_tpu.geodata.importer import import_osm

    for osm, binf, blocks in ((MINI_OSM, MINI_BIN, 24), (BIG_OSM, BIG_BIN, 48)):
        if not os.path.exists(binf):
            os.makedirs(os.path.dirname(osm), exist_ok=True)
            subprocess.run(
                [sys.executable, os.path.join(ROOT, "tools", "make_fixture.py"), osm,
                 "--blocks", str(blocks)],
                check=True, cwd=ROOT, stdout=subprocess.DEVNULL,
            )
            import_osm(osm, binf)


def z_tiles(reader, zoom: int):
    from osm_renderer_tpu.core.tile import Tile

    sh = 18 - zoom
    xs = reader.tiles["x"] >> sh
    ys = reader.tiles["y"] >> sh
    return [Tile(zoom, x, y) for x, y in sorted(set(zip(xs.tolist(), ys.tolist())))]


def painted(planar, canvas_u8):
    """(T, ts, ts) bool: pixels whose RGB differs from the canvas."""
    import torch

    c = torch.tensor(canvas_u8, dtype=torch.uint8, device=planar.device)[None, :, None, None]
    return (planar[:, :3] != c).any(dim=1)


def compare(name, prepared, canvas_u8, kinds_seen, rows):
    """Kernel vs twin on one prepared batch; appends a result row."""
    import torch

    from osm_renderer_tpu_torch.ops import render_cuda as RC

    b, canvas, ts = prepared.batch, prepared.canvas_rgb, prepared.ts
    kinds = torch.bincount(b.chunk_i[:, RC.CI_KIND].long(), minlength=10).cpu().tolist()
    for k, n in enumerate(kinds):
        if n:
            kinds_seen.add(k)
    out_k = RC.render_batch_planar(b, canvas, ts)       # warm run (and build)
    torch.cuda.synchronize()
    reps = 5
    ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    ev0.record()
    for _ in range(reps):
        out_k = RC.render_batch_planar(b, canvas, ts)
    ev1.record()
    torch.cuda.synchronize()
    kernel_ms = ev0.elapsed_time(ev1) / reps
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
    log(f"  {name}: T={T} ts={ts} chunks={C} kinds={kinds} max|diff|={max_diff} "
        f"membership_mismatch={member} kernel_ms={kernel_ms:.4f} twin_ms={twin_ms:.1f}")
    rows.append(dict(name=name, T=T, ts=ts, chunks=C, max_diff=max_diff, member=member,
                     kernel_ms=kernel_ms, twin_ms=twin_ms))
    if max_diff > 1 or member != 0:
        raise AssertionError(f"{name}: kernel disagrees with its twin "
                             f"(max|diff| {max_diff}, membership mismatches {member})")


def split_prepare(renderer, tiles_entities, scale):
    """Prepared batches under MAX_BATCH_CHUNKS, halving like the server."""
    try:
        return [renderer.prepare(tiles_entities, scale)]
    except ValueError as e:
        if "MAX_BATCH_CHUNKS" not in str(e) or len(tiles_entities) == 1:
            raise
    mid = len(tiles_entities) // 2
    return (split_prepare(renderer, tiles_entities[:mid], scale)
            + split_prepare(renderer, tiles_entities[mid:], scale))


def scene_batch(device, icon: bool):
    """A synthetic one-tile scene for the chunk kinds the cities lack:
    an oversize-coordinate fill and round-capped dashed stroke (host
    layers, KIND_LAYER) between two plain fills, or (icon=True) two
    tiled icon fills (KIND_FILL_IMAGE) around a stroke."""
    import numpy as np
    from PIL import Image

    from osm_renderer_tpu.draw import primitives as P
    from osm_renderer_tpu.draw.labels.icons import IconCache
    from osm_renderer_tpu.ops.coverage_np import LINE_CAP_BUTT, LINE_CAP_ROUND
    from osm_renderer_tpu_torch.ops import chunk_layout as CL
    from osm_renderer_tpu_torch.ops import render_cuda as RC
    from osm_renderer_tpu_torch.parallel.renderer import PreparedBatch

    box = np.array([[30, 30, 90, 30], [90, 30, 90, 80], [90, 80, 30, 80], [30, 80, 30, 30]],
                   np.int64)
    if icon:
        rng = np.random.default_rng(7)
        px = rng.integers(0, 256, size=(10, 12, 4), dtype=np.uint8)
        px[..., 3] = rng.integers(60, 256, size=(10, 12), dtype=np.uint8)
        os.makedirs(OUT_DIR, exist_ok=True)
        Image.fromarray(px, "RGBA").save(os.path.join(OUT_DIR, "pattern.png"))
        patterns = P.PatternTable(IconCache(OUT_DIR), 256)
        tri = np.array([[120, 20, 240, 200], [240, 200, 20, 230], [20, 230, 120, 20]], np.int64)
        prims = [
            P.FillPrim(kind="fill", color=None, opacity=1.0, edges=tri, fill_image="pattern.png"),
            P.make_stroke_prim(np.array([[0, 100, 255, 140]], np.int64), 3.0, (255, 255, 255),
                               1.0, None, LINE_CAP_BUTT, True),
            P.FillPrim(kind="fill", color=None, opacity=1.0, edges=box, fill_image="pattern.png"),
        ]
    else:
        patterns = P.PatternTable(None, 256)
        far = 5 * P.FAST_COORD_BOUND
        tri = np.array([[-far, -100, 200, 90], [200, 90, 120, far], [120, far, -far, -100]],
                       np.int64)
        prims = [
            P.FillPrim(kind="fill", color=(70, 130, 70), opacity=0.9, edges=tri),
            P.make_stroke_prim(np.array([[-far, 60, far, 180]], np.int64), 5.0, (250, 250, 240),
                               1.0, [8.0, 4.0], LINE_CAP_ROUND, True),
            P.FillPrim(kind="fill", color=(180, 40, 40), opacity=1.0, edges=box),
        ]
    profiles = P.ProfileTable()
    stream = P.stream_tile_packed(prims, profiles, CL.CH, patterns)
    pb = CL.build_pallas_batch([stream], profiles, 256, patterns)
    canvas = np.array([241, 238, 232], np.float32) / np.float32(255.0)
    b, c = RC.from_numpy_batch(pb, canvas, device)
    return PreparedBatch(b, c, 256, 1), (241, 238, 232)


def phase_kernel(device, styler, rows, kinds_seen):
    from osm_renderer_tpu.geodata.reader import GeodataReader
    from osm_renderer_tpu_torch.ops import chunk_layout as CL
    from osm_renderer_tpu_torch.parallel.renderer import BatchRenderer

    canvas = styler.canvas_fill_color
    canvas_u8 = (canvas.r, canvas.g, canvas.b)
    def te(reader, tiles):
        return [(reader.get_entities_in_tile_with_neighbors(t), t) for t in tiles]

    # One renderer per city: the chunk cache is keyed by tile address,
    # and both synthetic cities cover the same tiles.
    for city, path in (("minicity", MINI_BIN), ("bigcity", BIG_BIN)):
        reader = GeodataReader.load(path)
        r = BatchRenderer(styler, stylesheet_dir=STYLESHEET_DIR, chunk_cache_tiles=1024,
                          device=str(device))
        z15 = te(reader, z_tiles(reader, 15))
        batches = [(f"{city}_z15", z15, 1)]
        if city == "minicity":
            batches += [(f"{city}_z15_2x", z15[:12], 2), (f"{city}_z15_3x", z15[:3], 3),
                        (f"{city}_z15_4x", z15[:2], 4)]
        else:
            batches.append((f"{city}_z13_z14", te(reader, z_tiles(reader, 13)
                                                  + z_tiles(reader, 14)), 1))
        for name, tiles_entities, scale in batches:
            for i, p in enumerate(split_prepare(r, tiles_entities, scale)):
                compare(f"{name}[{i}]", p, canvas_u8, kinds_seen, rows)
    prep, cu8 = scene_batch(device, icon=False)
    compare("oversize_layer_scene", prep, cu8, kinds_seen, rows)
    prep, cu8 = scene_batch(device, icon=True)
    compare("icon_fill_scene", prep, cu8, kinds_seen, rows)
    need = {CL.KIND_FILL, CL.KIND_STROKE_SPAN, CL.KIND_STROKE, CL.KIND_STROKE_SOLID,
            CL.KIND_STROKE_DASH, CL.KIND_LAYER, CL.KIND_FILL_IMAGE}
    missing = need - kinds_seen
    if missing:
        raise AssertionError(f"real batches never reached chunk kinds {sorted(missing)}")


def fetch(url: str, timeout: float = 300.0):
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.status, resp.read()


def phase_server(styler, rows_out, labels: bool, device="cuda"):
    import socket

    import numpy as np
    from PIL import Image

    from osm_renderer_tpu.draw.drawer import CpuDrawer
    from osm_renderer_tpu.geodata.reader import GeodataReader

    os.makedirs(OUT_DIR, exist_ok=True)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    conf = os.path.join(OUT_DIR, "server.conf")
    with open(conf, "w") as f:
        f.write(
            f"[http]\naddress = 127.0.0.1:{port}\n[geodata]\nfile = {MINI_BIN}\n"
            f"[style]\nfile = {os.path.join(STYLESHEET_DIR, 'default.mapcss')}\ntype = josm\n"
            f"[render]\nbackend = device\ndevice = {device}\nlabels = {'yes' if labels else 'no'}\n"
            "png-level = 1\n"
            "warmup = yes\n"
        )
    log_path = os.path.join(OUT_DIR, "server.log")
    launcher = _NO_JAX + (
        "import runpy\nsys.argv = ['renderer_main', sys.argv[1]]\n"
        "runpy.run_module('osm_renderer_tpu_torch.cli.renderer_main', run_name='__main__')\n"
    )
    reader = GeodataReader.load(MINI_BIN)
    from osm_renderer_tpu.core.tile import Tile

    z15 = z_tiles(reader, 15)
    reqs = [(t, 1) for t in z15[:20]] + [(t, 2) for t in z15[:6]]
    for z in (13, 14, 16, 17):
        reqs += [(t, 1) for t in z_tiles(reader, z)[:3]]
    reqs += [(Tile(16, z15[0].x * 2, z15[0].y * 2), 2)]
    if len(set(reqs)) < 32:
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
        if status != 200 or b"Device execute" not in perf_html:
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
    launches = None
    for line in text.splitlines():
        if line.startswith("render kernel launches while serving:"):
            launches = int(line.rsplit(":", 1)[1])
    if not launches:
        raise AssertionError(f"server made no render-kernel launch while serving:\n{text[-4000:]}")

    labeler = None
    if labels:
        from osm_renderer_tpu.draw.labels.labeler import Labeler

        labeler = Labeler(icon_base_path=STYLESHEET_DIR, use_atlas=True, label_cache_tiles=0)
    drawer = CpuDrawer(labeler=None, stylesheet_dir=STYLESHEET_DIR)
    worst_unlabeled = 0
    n_unlabeled = 0
    for (t, s), (status, png) in zip(reqs, got):
        if status != 200 or png[:8] != b"\x89PNG\r\n\x1a\n":
            raise AssertionError(f"{t}@{s}x: HTTP {status}, not a PNG")
        img = np.asarray(Image.open(io.BytesIO(png)).convert("RGB"))
        if img.shape != (256 * s, 256 * s, 3):
            raise AssertionError(f"{t}@{s}x: PNG of shape {img.shape}")
        ents = reader.get_entities_in_tile_with_neighbors(t)
        if labeler is not None and labeler.ensure_layer(
            ents, t, float(s), styler, 256 * s
        ) is not None:
            continue
        want = drawer.draw_to_pixels(ents, t, s, styler)
        d = int(np.abs(img.astype(int) - want.astype(int)).max())
        worst_unlabeled = max(worst_unlabeled, d)
        n_unlabeled += 1
        if d > 1:
            raise AssertionError(f"{t}@{s}x: served tile is {d}/255 off the C++ oracle")
    if n_unlabeled == 0:
        raise AssertionError("no unlabeled tile to hold against the oracle")
    log(f"  served {len(reqs)} distinct tiles in {serve_s:.2f} s: all HTTP 200 + PNG; "
        f"{n_unlabeled} unlabeled tiles max |diff| vs oracle = {worst_unlabeled}; "
        f"render kernel launches while serving = {launches}")
    rows_out["launches"] = launches


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

    log("phase 1: build")
    from osm_renderer_tpu_torch.ops import build

    build.render_library(ptxas_verbose=True)
    log(f"  render.cu nvcc build: {build.BUILD_SECONDS['render.cu']:.2f} s")
    for line in build.PTXAS_REPORT["render.cu"].splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")
    from osm_renderer_tpu_torch.utils.torch_setup import build_native_host_libs

    build_native_host_libs()

    log("phase 2: fixtures")
    build_fixtures()
    from osm_renderer_tpu.mapcss.parser import parse_file
    from osm_renderer_tpu.mapcss.styler import Styler

    styler = Styler(parse_file(STYLESHEET_DIR, "default.mapcss"), "josm")

    log("phase 3: render kernel vs its plain twin on the card "
        "(bar: max |diff| <= 1 per channel, 0 membership mismatches)")
    rows: list = []
    kinds_seen: set = set()
    phase_kernel(device, styler, rows, kinds_seen)

    import importlib.util

    labels = importlib.util.find_spec("fontTools") is not None
    log(f"phase 4: served path (renderer_main, backend = device, "
        f"labels = {'yes' if labels else 'no: fontTools is not installed'})")
    served: dict = {}
    phase_server(styler, served, labels)

    log("phase 5: no jax")
    if any(m == "jax" or m.startswith("jax.") for m in sys.modules):
        return fail("jax was imported")
    log("  jax not in sys.modules")

    head = next(r for r in rows if r["name"].startswith("bigcity_z15"))
    kernels = {"kernels": [{
        "name": "render_planar",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": TPU_KERNEL,
        "launches": served["launches"],
        "max_abs_err": max(r["max_diff"] for r in rows),
        "ms": head["kernel_ms"],
        "plain_ms": head["twin_ms"],
    }]}
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
