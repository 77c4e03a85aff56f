"""The port's serving on several devices: the stable tile -> renderer map
and the multi-renderer TileService against the JAX package's
multi-device server (Pallas interpret on conftest's virtual CPU
devices), the multi-renderer service, MeshTileRenderer and the CLI
against one renderer, the refusals, and the wire copy's events on the
wire's own device."""

import io
import os
import socket
import subprocess
import sys
import time
import types
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

from osm_renderer_tpu_torch.core.tile import Tile, coords_to_max_zoom_tile
from osm_renderer_tpu_torch.parallel.renderer import BatchRenderer, MeshTileRenderer
from osm_renderer_tpu_torch.server.http import TileService

from tests.conftest import REPO_ROOT
from tests.test_torch_helpers import STYLESHEET_DIR, port_bin, port_styler


def _rgb(png: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(png)).convert("RGB"))


def _tiles():
    """Four z16 tiles and their z15 parent over the mini fixture."""
    t18 = coords_to_max_zoom_tile(47.1412, 9.5215)
    base = Tile(16, t18.x >> 2, t18.y >> 2)
    return [Tile(16, base.x + dx, base.y + dy) for dx in range(2) for dy in range(2)] + [
        Tile(15, base.x >> 1, base.y >> 1)]


@pytest.fixture(scope="module")
def mini_bin(tmp_path_factory):
    return port_bin(tmp_path_factory.mktemp("multi"))


@pytest.fixture(scope="module")
def styler():
    return port_styler()


def _service(mini_bin, styler, **kw):
    return TileService(mini_bin, styler, STYLESHEET_DIR, device="cpu", png_cache_tiles=0, **kw)


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_dev_idx_matches_the_jax_server(n):
    """The same tile -> shard index as the JAX server's hash, on a grid of
    tiles over several zooms (both called on a stub with n renderers)."""
    from osm_renderer_tpu.core.tile import Tile as JaxTile
    from osm_renderer_tpu.server.http import TileService as JaxTileService

    stub = types.SimpleNamespace(batch_renderers=[None] * n)
    grid = [(z, x, y) for z in (3, 12, 15, 17) for x in range(1000, 1012)
            for y in range(5000 + z, 5012 + z)]
    assert len(grid) >= 500
    got = [TileService._dev_idx(stub, Tile(*t)) for t in grid]
    want = [JaxTileService._dev_idx(stub, JaxTile(*t)) for t in grid]
    assert got == want
    assert set(got) == set(range(n))


def _spy_labeled(renderers) -> list:
    """Records (renderer index, tile) for each tile a renderer's prepared
    batch labels on the device."""
    seen = []
    for d, r in enumerate(renderers):
        def spy(tiles_entities, scale=1, label_layers=None, _prepare=r.prepare, _d=d):
            prepared = _prepare(tiles_entities, scale, label_layers=label_layers)
            seen.extend((_d, tuple(tiles_entities[i][1])) for i in prepared.device_labeled)
            return prepared
        r.prepare = spy
    return seen


def test_multi_service_matches_jax_multi_device_server(mini_bin, styler, tmp_path):
    """gpus = 4 on the CPU against the JAX server on 4 virtual CPU devices
    (one Pallas-interpret renderer each, arena on): the same renderer for
    each tile, the same tiles labeled on the device, every tile within
    1/255 per channel."""
    import jax

    from osm_renderer_tpu.core.tile import Tile as JaxTile
    from osm_renderer_tpu.geodata.importer import import_osm
    from osm_renderer_tpu.mapcss.parser import parse_file
    from osm_renderer_tpu.mapcss.styler import Styler as JaxStyler
    from osm_renderer_tpu.parallel.renderer import BatchRenderer as JaxBatchRenderer
    from osm_renderer_tpu.server.http import TileService as JaxTileService
    from tests.test_torch_helpers import write_osm

    jax_bin = str(tmp_path / "mini.bin")
    import_osm(write_osm(tmp_path), jax_bin)
    jstyler = JaxStyler(parse_file(STYLESHEET_DIR, "default.mapcss"), "josm")
    ref = JaxTileService(jax_bin, jstyler, STYLESHEET_DIR, backend="device", png_cache_tiles=0)
    ref.devices = jax.devices()[:4]
    ref.batch_renderers = [
        JaxBatchRenderer(jstyler, backend="pallas", interpret=True, stylesheet_dir=STYLESHEET_DIR,
                         tile_bucket=True, chunk_cache_tiles=64, arena=True, device=d)
        for d in ref.devices
    ]
    ref.batch_renderer = ref.batch_renderers[0]
    port = _service(mini_bin, styler, gpus=4)
    assert len(port.batch_renderers) == 4
    tiles = _tiles()
    jtiles = [JaxTile(t.zoom, t.x, t.y) for t in tiles]
    assert [port._dev_idx(t) for t in tiles] == [ref._dev_idx(t) for t in jtiles]
    assert len({port._dev_idx(t) for t in tiles}) > 1
    port_labeled = _spy_labeled(port.batch_renderers)
    ref_labeled = _spy_labeled(ref.batch_renderers)
    got = port.render_tiles_device([(t, 1) for t in tiles])
    want = ref.render_tiles_device([(t, 1) for t in jtiles])
    assert port_labeled and sorted(port_labeled) == sorted(ref_labeled)
    for t, p_g, p_w in zip(tiles, got, want):
        d = np.abs(_rgb(p_g).astype(int) - _rgb(p_w).astype(int))
        assert d.max() <= 1, (t, d.max())


def test_multi_service_equals_single_cold_and_warm(mini_bin, styler, monkeypatch):
    """gpus = 4 serves the PNGs of gpus = 1 byte for byte, cold and warm
    (the counterpart of test_multi_device_serving_matches_single), @1x
    and @2x: more than one renderer is used, each used one holds arena
    rows and ran one v1 batch and then v2 batches, and the tile counts
    add up.  A cold group streamed in sub-batches is split by renderer
    sub-batch by sub-batch, with the same pixels."""
    one = _service(mini_bin, styler)
    many = _service(mini_bin, styler, gpus=4)
    reqs = [(t, s) for t in _tiles() for s in (1, 2)]
    cold = [svc.render_tiles_device(reqs) for svc in (one, many)]
    warm = [svc.render_tiles_device(reqs) for svc in (one, many)]
    assert cold[0] == cold[1]
    assert warm[0] == warm[1]
    for p_c, p_w in zip(cold[1], warm[1]):
        np.testing.assert_array_equal(_rgb(p_c), _rgb(p_w))
    used = {many._dev_idx(t) for t, _ in reqs}
    assert len(used) > 1
    assert set(many.tiles_by_renderer) == used
    assert sum(many.tiles_by_renderer.values()) == 2 * len(reqs) == sum(
        one.tiles_by_renderer.values())
    for d, r in enumerate(many.batch_renderers):
        counts = r.batch_counts
        if d in used:
            assert r.chunk_arena is not None and len(r.chunk_arena._offsets) > 0
            # Two passes over two scale groups, every tile at both scales.
            assert counts["arena"] == 4 and counts["v1"] == 1 and counts["v2"] == 3, counts
        else:
            assert counts["arena"] == 0 and not many.tiles_by_renderer[d]
    monkeypatch.setattr(TileService, "COLD_SUB", 2)
    streamed = _service(mini_bin, styler)
    split = _service(mini_bin, styler, gpus=4)
    for svc in (streamed, split):
        for p_g, p_w in zip(svc.render_tiles_device(reqs), cold[0]):
            np.testing.assert_array_equal(_rgb(p_g), _rgb(p_w))
    tiles = _tiles()
    subs = [tiles[a:a + 2] for a in range(0, len(tiles), 2)]
    assert streamed.batch_renderer.batch_counts["arena"] == 2 * len(subs) == 6
    # A renderer takes one batch for each sub-batch that holds one of its
    # tiles, in each of the two scale groups.
    assert [r.batch_counts["arena"] for r in split.batch_renderers] == [
        2 * sum(any(split._dev_idx(t) == d for t in sub) for sub in subs) for d in range(4)]


def test_multi_service_warmup_leaves_renderers_on_v2(mini_bin, styler):
    """warmup's two passes leave every renderer that received tiles on its
    v2 wire; a MAX_BATCH_CHUNKS error in one renderer's shard halves the
    group and renders every tile on the renderers, with the same
    pixels; a tile that alone overflows goes to the C++ oracle."""
    many = _service(mini_bin, styler, gpus=4, enable_labels=False)
    assert many.warmup() == 1
    used = [r for r in many.batch_renderers if r.batch_counts["arena"]]
    assert used and all(r.batch_counts["v1"] == 1 and r.batch_counts["v2"] == 1 for r in used)
    assert all(r._pal_dev is not None for r in used)
    tiles = _tiles()
    reqs = [(t, 1) for t in tiles]
    want = many.render_tiles_device(reqs)
    counts = {t: many.batch_renderers[many._dev_idx(t)]._chunk_cache[
        (t.zoom, t.x, t.y, 1)][0].kind.shape[0] for t in tiles}
    bound = max(counts.values())
    shard_chunks = [sum(c for t, c in counts.items() if many._dev_idx(t) == d) for d in range(4)]
    assert max(shard_chunks) > bound  # one shard overflows, every tile alone fits
    for r in many.batch_renderers:
        r.MAX_BATCH_CHUNKS = bound
    served = sum(r.batch_counts["arena"] for r in many.batch_renderers)
    n_used = len({many._dev_idx(t) for t in tiles})
    before = sum(many.tiles_by_renderer.values())
    got = many.render_tiles_device(reqs)
    assert sum(many.tiles_by_renderer.values()) - before == len(tiles)
    assert sum(r.batch_counts["arena"] for r in many.batch_renderers) - served > n_used
    for t, p_g, p_w in zip(tiles, got, want):
        np.testing.assert_array_equal(_rgb(p_g), _rgb(p_w), err_msg=str(t))
    for r in many.batch_renderers:
        r.MAX_BATCH_CHUNKS = 1
    served = sum(r.batch_counts["arena"] for r in many.batch_renderers)
    got = many.render_tiles_device(reqs)
    assert sum(r.batch_counts["arena"] for r in many.batch_renderers) == served
    for t, p_g, p_w in zip(tiles, got, want):
        assert np.abs(_rgb(p_g).astype(int) - _rgb(p_w).astype(int)).max() <= 1, t


def test_mesh_renderer_matches_one_renderer(mini_bin, styler):
    """MeshTileRenderer over 4 CPU renderers (one device named 4 times)
    equals one BatchRenderer and a one-renderer mesh, in request order and
    without the bucket's padding tiles, @1x and @2x; with no CUDA device,
    devices=None raises."""
    from osm_renderer_tpu_torch.geodata.reader import GeodataReader

    reader = GeodataReader.load(mini_bin)
    te = [(reader.get_entities_in_tile_with_neighbors(t), t) for t in _tiles()]
    kw = dict(stylesheet_dir=STYLESHEET_DIR, tile_bucket=True)
    for scale in (1, 2):
        want = BatchRenderer(styler, device="cpu", **kw).render(te, scale)[: len(te)]
        for devices in (["cpu"], ["cpu"] * 4):
            mesh = MeshTileRenderer(styler, devices=devices, **kw)
            assert len(mesh.renderers) == len(devices)
            np.testing.assert_array_equal(mesh.render(te, scale), want)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            MeshTileRenderer(styler)
    with pytest.raises(ValueError):
        MeshTileRenderer(styler, devices=[])


def test_gpus_refusals(mini_bin, styler, monkeypatch):
    """gpus < 1 raises; gpus above the CUDA devices visible from `device`
    on raises with both counts, before any renderer is built."""
    with pytest.raises(ValueError, match="gpus = 0"):
        _service(mini_bin, styler, gpus=0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    built = []
    monkeypatch.setattr(BatchRenderer, "__init__", lambda self, *a, **kw: built.append(kw))
    for device, gpus, visible in (("cuda:0", 3, 2), ("cuda:1", 2, 1)):
        with pytest.raises(ValueError, match=f"gpus = {gpus} .* {visible} CUDA device"):
            TileService(mini_bin, styler, STYLESHEET_DIR, device=device, gpus=gpus)
        with pytest.raises(ValueError, match=f"gpus = {gpus}"):
            TileService(mini_bin, styler, STYLESHEET_DIR, device=device, gpus=gpus,
                        precision="exact")
    assert not built
    TileService(mini_bin, styler, STYLESHEET_DIR, device="cuda:0", gpus=2)
    assert [kw["device"] for kw in built] == [torch.device("cuda", 0), torch.device("cuda", 1)]


def test_exact_serves_on_the_first_renderer_only(mini_bin, styler, tmp_path, capsys):
    """precision = exact with gpus = 2 builds one dense renderer and serves
    on it; the CLI's service says so when it starts."""
    import configparser

    from osm_renderer_tpu_torch.cli.renderer_main import service_from_config

    svc = _service(mini_bin, styler, gpus=2, precision="exact", enable_labels=False)
    assert len(svc.batch_renderers) == 1 and svc.batch_renderer.backend == "dense"
    reqs = [(t, 1) for t in _tiles()[:2]]
    pngs = svc.render_tiles_device(reqs)
    assert all(_rgb(p).shape == (256, 256, 3) for p in pngs)
    assert svc.batch_renderer.batch_counts["dense"] == 1
    assert dict(svc.tiles_by_renderer) == {0: 2}
    ini = tmp_path / "exact.conf"
    ini.write_text(
        f"[http]\naddress = 127.0.0.1:0\n[geodata]\nfile = {mini_bin}\n"
        f"[style]\nfile = {os.path.join(STYLESHEET_DIR, 'default.mapcss')}\ntype = josm\n"
        "[render]\ndevice = cpu\ngpus = 2\nprecision = exact\nlabels = no\n"
    )
    config = configparser.ConfigParser()
    assert config.read(ini)
    service, _ = service_from_config(config)
    assert len(service.batch_renderers) == 1
    assert "precision = exact serves on the first device only" in capsys.readouterr().out


def test_cli_serves_on_two_renderers(mini_bin, tmp_path):
    """The CLI with gpus = 2 and device = cpu: it starts two renderers,
    serves, and its shutdown lines sum over them, with each renderer's
    tile count; gpus = 0 fails with the ValueError, not by serving."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    conf = tmp_path / "server.conf"
    ini = (f"[http]\naddress = 127.0.0.1:{port}\n[geodata]\nfile = {mini_bin}\n"
           f"[style]\nfile = {os.path.join(STYLESHEET_DIR, 'default.mapcss')}\ntype = josm\n"
           "[render]\nbackend = device\ndevice = cpu\ngpus = {gpus}\nlabels = yes\n"
           "png-cache = 0\nwarmup = yes\n")
    conf.write_text(ini.format(gpus=0))
    bad = subprocess.run([sys.executable, "-m", "osm_renderer_tpu_torch.cli.renderer_main",
                          str(conf)], cwd=REPO_ROOT, capture_output=True, text=True, timeout=120)
    assert bad.returncode == 1 and "ValueError: gpus = 0" in bad.stderr
    assert "Serving tiles" not in bad.stdout
    conf.write_text(ini.format(gpus=2))
    log = tmp_path / "server.log"
    with open(log, "w") as f:
        proc = subprocess.Popen(
            [sys.executable, "-m", "osm_renderer_tpu_torch.cli.renderer_main", str(conf)],
            cwd=REPO_ROOT, stdout=f, stderr=subprocess.STDOUT,
        )
    tiles = _tiles()
    try:
        deadline = time.time() + 120
        while "Serving tiles" not in log.read_text():
            assert proc.poll() is None, log.read_text()
            assert time.time() < deadline, log.read_text()
            time.sleep(0.2)
        url = f"http://127.0.0.1:{port}"
        for t in tiles:
            with urllib.request.urlopen(f"{url}/{t.zoom}/{t.x}/{t.y}.png", timeout=60) as r:
                assert _rgb(r.read()).shape == (256, 256, 3)
        urllib.request.urlopen(f"{url}/shutdown", timeout=10).read()
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    text = log.read_text()
    assert "2 renderer(s) on cpu, cpu" in text
    lines = {line.split(" while serving:")[0]: line.split(":", 1)[1].split()
             for line in text.splitlines() if " while serving:" in line}
    batches = dict(kv.split("=") for kv in lines["batches"])
    by_renderer = dict(kv.rsplit("=", 1) for kv in lines["tiles by renderer"])
    assert list(by_renderer) == ["0@cpu", "1@cpu"]
    # One request a batch here: every tile is one arena batch of its
    # renderer, and the launch lines count nothing on the CPU.
    assert sum(int(v) for v in by_renderer.values()) == len(tiles)
    assert int(batches["arena"]) == len(tiles), batches
    want = {0: 0, 1: 0}
    for t in tiles:
        want[TileService._dev_idx(types.SimpleNamespace(batch_renderers=[0, 0]), t)] += 1
    assert [int(v) for v in by_renderer.values()] == [want[0], want[1]]
    assert lines["render kernel launches"] == ["0"]


def test_start_wire_copy_records_on_the_wire_device(monkeypatch):
    """A wire on cuda:1 while the current device is cuda:0: both events
    are recorded on cuda:1's current stream and the pinned buffer is
    allocated under cuda:1; the current device is restored.  (Fake CUDA
    calls: this host need have no card.)"""
    from osm_renderer_tpu_torch.parallel import renderer as R

    current = [0]

    class FakeDevice:
        def __init__(self, dev):
            self.idx = torch.device(dev).index if not isinstance(dev, int) else dev

        def __enter__(self):
            self.prev, current[0] = current[0], self.idx

        def __exit__(self, *exc):
            current[0] = self.prev

    def current_stream(device=None):
        return ("stream", current[0] if device is None else torch.device(device).index)

    class FakeEvent:
        def __init__(self, *a, **kw):
            self.stream = None

        def record(self, stream=None):
            self.stream = stream if stream is not None else current_stream()

    class FakeHost:
        def __init__(self):
            self.device_at_alloc = current[0]
            self.copied = None

        def copy_(self, src, non_blocking=False):
            self.copied = (src, non_blocking)

    empty = torch.empty

    def fake_empty(*a, pin_memory=False, **kw):
        return FakeHost() if pin_memory else empty(*a, **kw)

    wire = types.SimpleNamespace(is_cuda=True, device=torch.device("cuda", 1), shape=(64,),
                                 dtype=torch.int32)
    monkeypatch.setattr(torch.cuda, "device", FakeDevice)
    monkeypatch.setattr(torch.cuda, "current_stream", current_stream)
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch, "empty", fake_empty)
    res = R.start_wire_copy(R.RleRendered(planar=None, wire=wire, ts=256, rtot=0))
    assert res.executed.stream == ("stream", 1)
    assert res.copied.stream == ("stream", 1)
    assert res.host.device_at_alloc == 1 and res.host.copied == (wire, True)
    assert current[0] == 0
