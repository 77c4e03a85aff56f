"""The port's served path on the CPU (the kernels' plain versions)
against the JAX package's device server (Pallas interpret) on the mini
fixture: the same tiles labeled on the device and decoded tiles within
1/255 per channel, host-composited labels where the batch has no label
slab, split batches equal to solo renders, the run-length wire (v1, v2
and the raw planar fallback) equal to the raw batch, and the HTTP front
end end to end."""

import asyncio
import io
import os
import socket
import threading
import time
import urllib.request

import numpy as np
import pytest
from PIL import Image

from osm_renderer_tpu_torch.core.tile import Tile, coords_to_max_zoom_tile
from osm_renderer_tpu_torch.server.http import TileService, extract_tile_from_path, run_server

from tests.conftest import REPO_ROOT
from tests.test_torch_helpers import STYLESHEET_DIR, port_bin, port_styler


def _rgb(png: bytes) -> np.ndarray:
    assert png[:8] == b"\x89PNG\r\n\x1a\n"
    return np.asarray(Image.open(io.BytesIO(png)).convert("RGB"))


@pytest.fixture(scope="module")
def mini_bin(tmp_path_factory):
    """The mini fixture imported by the port's importer."""
    return port_bin(tmp_path_factory.mktemp("serve"))


@pytest.fixture(scope="module")
def jax_mini_bin(tmp_path_factory):
    """The same scene imported by the JAX package's importer."""
    from osm_renderer_tpu.geodata.importer import import_osm
    from tests.test_torch_helpers import write_osm

    tmp = tmp_path_factory.mktemp("serve_jax")
    bin_path = os.path.join(str(tmp), "mini.bin")
    import_osm(write_osm(tmp), bin_path)
    return bin_path


@pytest.fixture(scope="module")
def styler():
    return port_styler()


def _jax_styler():
    from osm_renderer_tpu.mapcss.parser import parse_file
    from osm_renderer_tpu.mapcss.styler import Styler

    return Styler(parse_file(STYLESHEET_DIR, "default.mapcss"), "josm")


def _jax_tile(t):
    from osm_renderer_tpu.core.tile import Tile as JaxTile

    return JaxTile(t.zoom, t.x, t.y)


def _zoom_tiles():
    t18 = coords_to_max_zoom_tile(47.1412, 9.5215)
    return [Tile(z, t18.x >> (18 - z), t18.y >> (18 - z)) for z in range(12, 18)]


def _spy_device_labeled(renderer) -> list:
    """Records the tiles each prepared batch labels on the device."""
    seen = []
    prepare = renderer.prepare

    def spy(tiles_entities, scale=1, label_layers=None):
        prepared = prepare(tiles_entities, scale, label_layers=label_layers)
        seen.extend(tiles_entities[i][1] for i in prepared.device_labeled)
        return prepared

    renderer.prepare = spy
    return seen


def test_port_server_matches_jax_device_server(mini_bin, jax_mini_bin, styler):
    """Same tiles through the port and the JAX device backend (both: arena
    and device label blit; the JAX one in Pallas interpret, with its own
    geodata and styler): the same tiles labeled on the device, <= 1/255
    per channel."""
    from osm_renderer_tpu.parallel.renderer import BatchRenderer as JaxBatchRenderer
    from osm_renderer_tpu.server.http import TileService as JaxTileService

    tiles = _zoom_tiles()
    jstyler = _jax_styler()
    port = TileService(mini_bin, styler, STYLESHEET_DIR, device="cpu", png_cache_tiles=0)
    ref = JaxTileService(jax_mini_bin, jstyler, STYLESHEET_DIR, backend="device",
                         png_cache_tiles=0)
    ref.devices = ref.devices[:1]
    ref.batch_renderer = JaxBatchRenderer(
        jstyler, backend="pallas", interpret=True, stylesheet_dir=STYLESHEET_DIR,
        tile_bucket=True, chunk_cache_tiles=512, arena=True,
    )
    ref.batch_renderers = [ref.batch_renderer]
    port_labeled = _spy_device_labeled(port.batch_renderer)
    ref_labeled = _spy_device_labeled(ref.batch_renderer)
    got = port.render_tiles_device([(t, 1) for t in tiles])
    want = ref.render_tiles_device([(_jax_tile(t), 1) for t in tiles])
    assert port_labeled and [tuple(t) for t in port_labeled] == [tuple(t) for t in ref_labeled]
    # The first batch learned the palette (v1 wire); the second, warm
    # from the chunk arena, ships on the v2 wire.
    got_v2 = port.render_tiles_device([(t, 1) for t in tiles])
    counts = port.batch_renderer.batch_counts
    assert counts["arena"] == 2 and counts["v1"] == 1 and counts["v2"] == 1, counts
    assert counts["labeled_tiles"] == 2 * len(ref_labeled)
    labeled = 0
    for t, p_g, p_v2, p_w in zip(tiles, got, got_v2, want):
        for png in (p_g, p_v2):
            d = np.abs(_rgb(png).astype(int) - _rgb(p_w).astype(int))
            assert d.max() <= 1, (t, d.max())
        labeled += port.labeler.has_cached_layer(t, 256)
    assert labeled, "no tile carried labels"
    html = port.perf_stats.to_html()
    # The device-time span comes from CUDA events: on the card only.
    assert ("Device time (batch share)" in html) == (port.device.type == "cuda")
    assert "Compose and encode" in html


def test_port_osm_ids_batch_composites_labels_on_host(mini_bin, styler):
    """Under osm_ids the batch takes the plain upload, which has no label
    slab: its labeled tiles get the host composite, exactly the port's
    labeler over the unlabeled served tile."""
    t = _zoom_tiles()[4]
    reader = TileService(mini_bin, styler, STYLESHEET_DIR, device="cpu").reader
    ents = reader.get_entities_in_tile_with_neighbors(t)
    ids = {e.global_id for e in list(ents.nodes) + ents.ways + ents.multipolygons}
    labeled = TileService(mini_bin, styler, STYLESHEET_DIR, device="cpu", osm_ids=ids)
    bare = TileService(mini_bin, styler, STYLESHEET_DIR, device="cpu", osm_ids=ids,
                       enable_labels=False)
    got = _rgb(labeled.render_tiles_device([(t, 1)])[0])
    base = _rgb(bare.render_tiles_device([(t, 1)])[0])
    counts = labeled.batch_renderer.batch_counts
    assert counts["plain"] == 1 and counts["arena"] == 0 and counts["labeled_tiles"] == 0
    want = labeled.labeler.composite_labels(
        base, reader.get_entities_in_tile_with_neighbors(t, ids), t, 1.0, styler)
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, base)


def test_port_slab_reset_between_prepare_and_render_raises(mini_bin, styler):
    """Clearing the renderer's caches between prepare and render leaves a
    labeled batch's slab rows stale: rendering it raises."""
    port = TileService(mini_bin, styler, STYLESHEET_DIR, device="cpu")
    tiles = _zoom_tiles()[3:]
    te = [(port.reader.get_entities_in_tile_with_neighbors(t), t) for t in tiles]
    compacts = [port.labeler.ensure_layer(e, t, 1.0, styler, 256) for e, t in te]
    r = port.batch_renderer
    prepared = r.prepare(te, 1, label_layers=compacts)
    assert prepared.device_labeled and prepared.label_rows is not None
    slab = prepared.label_ctx[0]
    slab.clear()
    with pytest.raises(ValueError, match="label slab reset between prepare and render"):
        r.render_prepared_planar(prepared)
    # A fresh prepare stages the layers again and renders.
    again = r.prepare(te, 1, label_layers=compacts)
    assert again.label_ctx[1] == slab.generation
    assert r.render_prepared_planar(again).shape == (prepared.chunk, 4, 256, 256)


def test_port_server_matches_oracle_at_2x(mini_bin, jax_mini_bin, styler):
    """Unlabeled @2x tiles equal the C++ oracle (the JAX package's
    CpuDrawer over its own geodata and styler) within 1/255."""
    from osm_renderer_tpu.draw.drawer import CpuDrawer
    from osm_renderer_tpu.geodata.reader import GeodataReader as JaxReader

    port = TileService(mini_bin, styler, STYLESHEET_DIR, device="cpu", enable_labels=False)
    tiles = _zoom_tiles()
    pngs = port.render_tiles_device([(t, 2) for t in tiles])
    drawer = CpuDrawer(stylesheet_dir=STYLESHEET_DIR)
    jreader, jstyler = JaxReader.load(jax_mini_bin), _jax_styler()
    for t, png in zip(tiles, pngs):
        jt = _jax_tile(t)
        want = drawer.draw_to_pixels(jreader.get_entities_in_tile_with_neighbors(jt), jt, 2,
                                     jstyler)
        got = _rgb(png)
        assert got.shape == (512, 512, 3)
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1, t


def test_port_split_batches_equal_solo_renders(mini_bin, styler, monkeypatch):
    """Chunk-dense groups halve on MAX_BATCH_CHUNKS and cold groups
    stream in sub-batches; served pixels equal solo renders."""
    port = TileService(mini_bin, styler, STYLESHEET_DIR, device="cpu", png_cache_tiles=0)
    t18 = coords_to_max_zoom_tile(47.1412, 9.5215)
    base = Tile(16, t18.x >> 2, t18.y >> 2)
    tiles = [Tile(16, base.x + dx, base.y + dy) for dy in range(2) for dx in range(3)]
    solo = [port.render_tiles_device([(t, 1)])[0] for t in tiles]
    counts = [port.batch_renderer._chunk_cache[(t.zoom, t.x, t.y, 1)][0].kind.shape[0]
              for t in tiles]
    port.batch_renderer.MAX_BATCH_CHUNKS = max(counts) * 2 + 8
    splits = []
    orig = TileService._encode_split_sub

    def spy(self, *a, **kw):
        splits.append(len(a[0]))
        return orig(self, *a, **kw)

    monkeypatch.setattr(TileService, "_encode_split_sub", spy)
    grouped = port.render_tiles_device([(t, 1) for t in tiles])
    assert splits, "oversized group never took the split path"
    for t, p_g, p_s in zip(tiles, grouped, solo):
        np.testing.assert_array_equal(_rgb(p_g), _rgb(p_s), err_msg=str(t))

    cold = TileService(mini_bin, styler, STYLESHEET_DIR, device="cpu", png_cache_tiles=0)
    monkeypatch.setattr(TileService, "COLD_SUB", 2)
    streamed = cold.render_tiles_device([(t, 1) for t in tiles])
    for t, p_c, p_s in zip(tiles, streamed, solo):
        np.testing.assert_array_equal(_rgb(p_c), _rgb(p_s), err_msg=str(t))


def test_port_service_failures_surface(mini_bin, styler, monkeypatch):
    """Warmup does not swallow failures; unsupported setups raise."""
    from osm_renderer_tpu_torch.parallel.renderer import BatchRenderer

    with pytest.raises(ValueError):
        TileService(mini_bin, styler, STYLESHEET_DIR, device="cpu", gpus=0)
    with pytest.raises(ValueError):
        TileService(mini_bin, styler, STYLESHEET_DIR, device="cpu", precision="double")
    port = TileService(mini_bin, styler, STYLESHEET_DIR, device="cpu")
    assert port.warmup() == 1  # the mini fixture spans one z15 tile

    def boom(self, prepared):
        raise RuntimeError("render failed")

    monkeypatch.setattr(BatchRenderer, "render_prepared_planar", boom)
    fresh = TileService(mini_bin, styler, STYLESHEET_DIR, device="cpu")
    with pytest.raises(RuntimeError, match="render failed"):
        fresh.warmup()


def test_port_exact_service_matches_oracle(mini_bin, styler):
    """precision = "exact" serves through the dense renderer (no chunk
    cache, no arena, a raw readback), within 1/255 of the C++ oracle at
    @1x and @2x; an unknown precision raises."""
    from osm_renderer_tpu_torch.draw.drawer import CpuDrawer

    port = TileService(mini_bin, styler, STYLESHEET_DIR, device="cpu", precision="exact",
                       enable_labels=False, png_cache_tiles=0)
    r = port.batch_renderer
    assert r.backend == "dense" and r.precision == "exact" and r.chunk_arena is None
    reqs = [(t, 1) for t in _zoom_tiles()[1:5]] + [(_zoom_tiles()[5], 2)]
    pngs = port.render_tiles_device(reqs)
    assert r.batch_counts["dense"] == 2 and r.batch_counts["arena"] == 0, r.batch_counts
    drawer = CpuDrawer(stylesheet_dir=STYLESHEET_DIR)
    for (t, s), png in zip(reqs, pngs):
        want = drawer.draw_to_pixels(port.reader.get_entities_in_tile_with_neighbors(t), t, s,
                                     styler)
        got = _rgb(png)
        assert got.shape == (256 * s, 256 * s, 3)
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1, (t, s)
    with pytest.raises(ValueError, match="precision"):
        TileService(mini_bin, styler, STYLESHEET_DIR, device="cpu", precision="f64")


def test_exact_entry_points_default_to_the_card(mini_bin, styler):
    """The exact service, the dense BatchRenderer and the DeviceDrawer run
    on CUDA unless the caller names the CPU: without a usable card their
    defaults raise instead of falling back."""
    import torch

    from osm_renderer_tpu_torch.draw.drawer import DeviceDrawer
    from osm_renderer_tpu_torch.parallel.renderer import BatchRenderer

    if torch.cuda.is_available():
        pytest.skip("this host has a usable CUDA device")
    with pytest.raises(RuntimeError):
        TileService(mini_bin, styler, STYLESHEET_DIR, precision="exact")
    with pytest.raises(RuntimeError):
        BatchRenderer(styler, backend="dense", precision="exact")
    with pytest.raises(RuntimeError):
        DeviceDrawer()
    assert DeviceDrawer(device="cpu").device == torch.device("cpu")
    with pytest.raises(ValueError):
        BatchRenderer(styler, backend="jnp", device="cpu")


def test_extract_tile_from_path():
    assert extract_tile_from_path("/15/100/200.png") == (Tile(15, 100, 200), 1)
    assert extract_tile_from_path("/tiles/15/100/200.png?nonce=7") == (Tile(15, 100, 200), 1)
    assert extract_tile_from_path("/18/1/2@2x.png") == (Tile(18, 1, 2), 2)
    assert extract_tile_from_path("/19/1/2.png") is None
    assert extract_tile_from_path("/a/b/c.png") is None
    assert extract_tile_from_path("/shutdown") is None


def test_port_http_end_to_end(mini_bin, styler):
    """The micro-batching HTTP front end over the port's service."""
    service = TileService(mini_bin, styler, STYLESHEET_DIR, device="cpu")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    thread = threading.Thread(
        target=lambda: asyncio.run(run_server(f"127.0.0.1:{port}", service)), daemon=True)
    thread.start()
    for _ in range(100):
        try:
            with socket.create_connection(("127.0.0.1", port), timeout=0.2):
                break
        except OSError:
            time.sleep(0.05)
    url = f"http://127.0.0.1:{port}"
    try:
        import concurrent.futures

        reqs = [(t, s) for t in _zoom_tiles() for s in (1, 2)]

        def get(req):
            t, s = req
            suffix = f"@{s}x" if s > 1 else ""
            with urllib.request.urlopen(f"{url}/{t.zoom}/{t.x}/{t.y}{suffix}.png",
                                        timeout=120) as resp:
                assert resp.status == 200
                assert resp.headers["Access-Control-Allow-Origin"] == "*"
                return resp.read()

        with concurrent.futures.ThreadPoolExecutor(len(reqs)) as ex:
            pngs = list(ex.map(get, reqs))
        for (t, s), png in zip(reqs, pngs):
            assert _rgb(png).shape == (256 * s, 256 * s, 3)
        with urllib.request.urlopen(f"{url}/perf_stats", timeout=30) as resp:
            html = resp.read().decode()
        assert ("Device time (batch share)" in html) == (service.device.type == "cuda")
        assert "Compose and encode" in html and "Queue wait" in html
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(f"{url}/1/2/x.png", timeout=30)
    finally:
        urllib.request.urlopen(f"{url}/shutdown", timeout=10).read()
        thread.join(timeout=10)
    assert not thread.is_alive()


def test_port_cli_serves_and_reports_launches(mini_bin, tmp_path):
    """`python -m osm_renderer_tpu_torch.cli.renderer_main` with
    backend = device on the CPU twin: warm-up, serve, shut down, and
    report the kernel launches made while serving (none on the CPU) and
    the tiles it labeled on the device."""
    import subprocess
    import sys

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    conf = tmp_path / "server.conf"
    conf.write_text(
        f"[http]\naddress = 127.0.0.1:{port}\n[geodata]\nfile = {mini_bin}\n"
        f"[style]\nfile = {os.path.join(STYLESHEET_DIR, 'default.mapcss')}\ntype = josm\n"
        "[render]\nbackend = device\ndevice = cpu\nlabels = yes\nwarmup = yes\n"
    )
    log = tmp_path / "server.log"
    with open(log, "w") as f:
        proc = subprocess.Popen(
            [sys.executable, "-m", "osm_renderer_tpu_torch.cli.renderer_main", str(conf)],
            cwd=REPO_ROOT, stdout=f, stderr=subprocess.STDOUT,
        )
    try:
        deadline = time.time() + 120
        while "Serving tiles" not in log.read_text():
            assert proc.poll() is None, log.read_text()
            assert time.time() < deadline, log.read_text()
            time.sleep(0.2)
        url = f"http://127.0.0.1:{port}"
        for t in _zoom_tiles()[2:4]:
            with urllib.request.urlopen(f"{url}/{t.zoom}/{t.x}/{t.y}.png", timeout=60) as r:
                assert _rgb(r.read()).shape == (256, 256, 3)
        urllib.request.urlopen(f"{url}/shutdown", timeout=10).read()
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    text = log.read_text()
    assert "Warmed 1 tiles" in text
    assert "render kernel launches while serving: 0" in text
    batches = next(line for line in text.splitlines() if line.startswith("batches while"))
    counts = dict(kv.split("=") for kv in batches.split(":", 1)[1].split())
    assert int(counts["arena"]) >= 1 and int(counts["labeled_tiles"]) >= 1, batches


def test_port_cli_serves_exact(mini_bin, tmp_path):
    """`precision = exact` through the port's CLI with device = cpu and
    labels = yes: it serves dense batches, launches no kernel (the dense
    kernels' count printed as 0) and reads back no wire."""
    import subprocess
    import sys

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    conf = tmp_path / "server.conf"
    conf.write_text(
        f"[http]\naddress = 127.0.0.1:{port}\n[geodata]\nfile = {mini_bin}\n"
        f"[style]\nfile = {os.path.join(STYLESHEET_DIR, 'default.mapcss')}\ntype = josm\n"
        "[render]\nbackend = device\ndevice = cpu\nprecision = exact\nlabels = yes\n"
        "warmup = no\n"
    )
    log = tmp_path / "server.log"
    with open(log, "w") as f:
        proc = subprocess.Popen(
            [sys.executable, "-m", "osm_renderer_tpu_torch.cli.renderer_main", str(conf)],
            cwd=REPO_ROOT, stdout=f, stderr=subprocess.STDOUT,
        )
    try:
        deadline = time.time() + 120
        while "Serving tiles" not in log.read_text():
            assert proc.poll() is None, log.read_text()
            assert time.time() < deadline, log.read_text()
            time.sleep(0.2)
        url = f"http://127.0.0.1:{port}"
        for t in _zoom_tiles()[3:5]:
            with urllib.request.urlopen(f"{url}/{t.zoom}/{t.x}/{t.y}.png", timeout=120) as r:
                assert _rgb(r.read()).shape == (256, 256, 3)
        urllib.request.urlopen(f"{url}/shutdown", timeout=10).read()
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    text = log.read_text()
    assert "render kernel launches while serving: 0" in text
    # The dense kernels' plain versions ran on the CPU: no launch.
    assert "dense kernel launches while serving: 0" in text
    batches = next(line for line in text.splitlines() if line.startswith("batches while"))
    counts = dict(kv.split("=") for kv in batches.split(":", 1)[1].split())
    assert int(counts["dense"]) >= 1 and int(counts["arena"]) == 0, batches
    assert int(counts["v1"]) == int(counts["v2"]) == 0, batches


def _wire_renderer(styler):
    from osm_renderer_tpu_torch.parallel.renderer import BatchRenderer

    return BatchRenderer(styler, stylesheet_dir=STYLESHEET_DIR, chunk_cache_tiles=16,
                         device="cpu", arena=True)


def _tiles_entities(mini_bin):
    from osm_renderer_tpu_torch.geodata.reader import GeodataReader

    reader = GeodataReader.load(mini_bin)
    return [(reader.get_entities_in_tile_with_neighbors(t), t) for t in _zoom_tiles()[2:]]


def test_port_renderer_v1_then_v2_serving_equality(mini_bin, styler):
    """The renderer learns the palette from its first (v1) fetch and
    ships the next batches on the v2 wire; both decode to the raw planar
    bytes (the counterpart of test_rle.py's
    test_renderer_v1_then_v2_serving_equality)."""
    from osm_renderer_tpu_torch.ops.chunk_layout import planar_to_rgb

    dev = _wire_renderer(styler)
    te = _tiles_entities(mini_bin)
    res1 = dev.render_prepared_rle(dev.prepare(te, 1))
    assert res1.fmt == "v1"
    ref = planar_to_rgb(res1.planar.numpy())
    np.testing.assert_array_equal(dev.fetch_rgb_rle(res1), ref)
    assert dev._pal_dev is not None  # palette learned
    res2 = dev.render_prepared_rle(dev.prepare(te, 1))
    assert res2.fmt == "v2"
    np.testing.assert_array_equal(dev.fetch_rgb_rle(res2), ref)
    assert dev.readback_bytes["wire"] < dev.readback_bytes["planar"]


def test_port_forced_small_cap_falls_back_to_raw(mini_bin, styler):
    """A cap too small for the batch: the raw planar fallback serves the
    same pixels, and the next cap regrows (v1 and v2)."""
    from osm_renderer_tpu_torch.ops.chunk_layout import planar_to_rgb

    dev = _wire_renderer(styler)
    te = _tiles_entities(mini_bin)
    T = len(te)
    dev._rtot_by_key[(256, T)] = 64
    res = dev.render_prepared_rle(dev.prepare(te, 1))
    assert res.fmt == "v1" and res.rtot == 64
    ref = planar_to_rgb(res.planar.numpy())
    np.testing.assert_array_equal(dev.fetch_rgb_rle(res), ref)
    assert dev._rtot_by_key[(256, T)] > 64
    assert dev._pal_dev is None  # no palette from an overflowed wire
    dev.fetch_rgb_rle(dev.render_prepared_rle(dev.prepare(te, 1)))  # learns it
    dev._wtot_by_key[(256, T)] = 256
    res = dev.render_prepared_rle(dev.prepare(te, 1))
    assert res.fmt == "v2" and res.rtot == 256
    np.testing.assert_array_equal(dev.fetch_rgb_rle(res), ref)
    assert dev._wtot_by_key[(256, T)] > 256  # cap regrew
    assert dev.batch_counts["raw"] == 2
    res = dev.render_prepared_rle(dev.prepare(te, 1))
    np.testing.assert_array_equal(dev.fetch_rgb_rle(res), ref)
    assert dev.batch_counts["raw"] == 2


def test_port_server_without_native_decoder(mini_bin, styler, monkeypatch):
    """Where the native PNG library is missing, the server still serves
    through the port's host codec (draw/png8.py): v2 tiles never reach
    png_writer's per-word loop, warm device tiles ship as PNG-8 (colour
    type 3), and every tile has the pixels of a server that has the
    library."""
    from osm_renderer_tpu_torch.draw import png_writer

    tiles = [(t, s) for t in _zoom_tiles() for s in (1, 2)]
    with_native = TileService(mini_bin, styler, STYLESHEET_DIR, device="cpu",
                              enable_labels=False, png_cache_tiles=0)
    want = [with_native.render_tiles_device(tiles) for _ in range(2)][-1]

    def loop_decoder(*a, **kw):
        raise AssertionError("the per-word fallback decoder was called")

    monkeypatch.setattr(png_writer, "_get_native", lambda: None)
    monkeypatch.setattr(png_writer, "rle_decode_words", loop_decoder)
    bare = TileService(mini_bin, styler, STYLESHEET_DIR, device="cpu", enable_labels=False,
                       png_cache_tiles=0)
    for _ in range(2):
        got = bare.render_tiles_device(tiles)
    assert bare.batch_renderer.batch_counts["v2"] >= 2
    assert bare.containers["png8"] > 0
    assert sum(png[25] == 3 for png in got) == sum(png[25] == 3 for png in want) > 0
    for (t, s), p_g, p_w in zip(tiles, got, want):
        np.testing.assert_array_equal(_rgb(p_g), _rgb(p_w), err_msg=f"{t}@{s}x")


def test_wire_wrappers_refuse_cuda_on_cpu_host(mini_bin, styler, monkeypatch):
    """A CUDA request raises on a host without a usable card: the renderer
    refuses the device, the wrappers refuse other devices, and a wrapper
    on its kernel route raises when the kernel cannot be built or
    launched instead of falling back to its plain version."""
    import torch

    from osm_renderer_tpu_torch.ops import rle_cuda as RLE
    from osm_renderer_tpu_torch.ops.render_cuda import BatchLayoutError
    from osm_renderer_tpu_torch.parallel.renderer import BatchRenderer

    if torch.cuda.is_available():
        pytest.skip("this host has a usable CUDA device")
    with pytest.raises(RuntimeError):
        BatchRenderer(styler, device="cuda")
    with pytest.raises(RuntimeError):
        TileService(mini_bin, styler, STYLESHEET_DIR, device="cuda")
    meta = torch.empty((1, 4, 256, 256), dtype=torch.uint8, device="meta")
    table = torch.full((255,), 0x7F7F7F7F, dtype=torch.int32, device="meta")
    with pytest.raises(BatchLayoutError):
        RLE.encode_batch_wire(meta, 1024)
    with pytest.raises(BatchLayoutError):
        RLE.encode_wire_indexed(meta, 1024, table)
    planar = torch.zeros((1, 4, 256, 256), dtype=torch.uint8)
    cpu_table = torch.full((255,), 0x7F7F7F7F, dtype=torch.int32)
    monkeypatch.setattr(RLE, "_route", lambda planar: True)  # as for a CUDA tensor
    emits, expands = RLE.EMIT_KERNEL_LAUNCHES, RLE.EXPAND_KERNEL_LAUNCHES
    with pytest.raises(RuntimeError):
        RLE.encode_batch_wire(planar, 1024)
    with pytest.raises(RuntimeError):
        RLE.encode_wire_indexed(planar, 1024, cpu_table)
    assert (RLE.EMIT_KERNEL_LAUNCHES, RLE.EXPAND_KERNEL_LAUNCHES) == (emits, expands)


def test_cli_serves_from_the_device_by_default(mini_bin, tmp_path):
    """An INI without a `backend` line builds the device-path service
    (here on the kernels' plain versions, `device = cpu`), not the C++
    oracle; `backend = cpu` still asks for the oracle."""
    import configparser

    from osm_renderer_tpu_torch.cli.renderer_main import service_from_config

    ini = tmp_path / "server.conf"
    ini.write_text(
        f"[http]\naddress = 127.0.0.1:0\n[geodata]\nfile = {mini_bin}\n"
        f"[style]\nfile = {os.path.join(STYLESHEET_DIR, 'default.mapcss')}\ntype = josm\n"
        "[render]\ndevice = cpu\nlabels = no\n"
    )
    config = configparser.ConfigParser()
    assert config.read(ini)
    service, backend = service_from_config(config)
    assert backend == service.backend == "device"
    assert service.batch_renderer is not None
    config["render"]["backend"] = "cpu"
    service, backend = service_from_config(config)
    assert backend == service.backend == "cpu"
    assert service.batch_renderer is None
