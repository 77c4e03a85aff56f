"""The reference's production stylesheet (osmosnimki-minimal.mapcss,
MAPS.ME type) end to end on the port, on the CPU, over the minicity
(tools/make_fixture.py --blocks 24) imported by each package's own
importer.

Bars: the port's `CpuDrawer`, with its own `Labeler`, renders the three
production goldens of `tests/test_production_stylesheet.py` byte for
byte; on the z16 and z17@2x tiles of those goldens the port's
`BatchRenderer(device="cpu")` (the kernels' plain versions) is within
1/255 of `CpuDrawer` with no tile left to the oracle, its labeled arena
entry equals `blit_planar` over its unlabeled output, and its render is
within 1 per channel of the JAX package's Pallas kernel in interpret
mode with the same painted pixels (the render twin's bar,
`tests/test_torch_render.py`).
"""

import os

import numpy as np
import pytest
import torch

from osm_renderer_tpu_torch.core.tile import Tile
from osm_renderer_tpu_torch.draw.drawer import CpuDrawer
from osm_renderer_tpu_torch.draw.labels.labeler import Labeler
from osm_renderer_tpu_torch.draw.png_writer import rgb_to_png
from osm_renderer_tpu_torch.geodata.importer import import_osm
from osm_renderer_tpu_torch.geodata.reader import GeodataReader
from osm_renderer_tpu_torch.mapcss.parser import parse_file
from osm_renderer_tpu_torch.mapcss.styler import Styler
from osm_renderer_tpu_torch.parallel import label_slab as LS
from osm_renderer_tpu_torch.parallel.renderer import BatchRenderer

from tests.conftest import REPO_ROOT
from tests.test_torch_helpers import make_minicity_osm, torch_threads

PROD_DIR = os.path.join(REPO_ROOT, "tests", "fixtures", "mapcss")
SHEET = "osmosnimki-minimal.mapcss"
GOLDEN_DIR = os.path.join(REPO_ROOT, "tests", "rendered")
RED = np.array([255, 0, 0], np.uint8)
# key -> (zoom, tiles a side (x, y) from the centre tile, scale), as the
# JAX package's goldens are cut.
PROD_CONFIGS = {
    "prod_15": (15, (2, 2), 1),
    "prod_16": (16, (2, 2), 1),
    "prod_17_2x": (17, (1, 1), 2),
}
DEVICE_CONFIGS = ["prod_16", "prod_17_2x"]


@pytest.fixture(scope="module")
def city(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("production_city")
    osm = make_minicity_osm(tmp)
    binf = str(tmp / "minicity.bin")
    import_osm(osm, binf)
    return dict(osm=osm, reader=GeodataReader.load(binf),
                styler=Styler(parse_file(PROD_DIR, SHEET), "mapsme"))


def _config_tiles(reader, key):
    """The golden's tiles in row order -> ([Tile], (nx, ny), scale)."""
    zoom, (nx, ny), scale = PROD_CONFIGS[key]
    sh = 18 - zoom
    u = sorted(set(zip((reader.tiles["x"] >> sh).tolist(), (reader.tiles["y"] >> sh).tolist())))
    cx, cy = u[len(u) // 2]
    return [Tile(zoom, cx + ix, cy + iy) for iy in range(ny) for ix in range(nx)], (nx, ny), scale


def _tiles_entities(city, key):
    tiles, _, scale = _config_tiles(city["reader"], key)
    return [(city["reader"].get_entities_in_tile_with_neighbors(t), t) for t in tiles], scale


@pytest.mark.parametrize("key", list(PROD_CONFIGS))
def test_production_golden(city, key, tmp_path):
    """The golden's canvas, as `render_production` of the JAX package's
    test stitches it: tiles in rows, red lines on the tile edges."""
    tiles, (nx, ny), scale = _config_tiles(city["reader"], key)
    drawer = CpuDrawer(labeler=Labeler(icon_base_path=PROD_DIR))
    ts = 256 * scale
    canvas = np.zeros((ny * ts, nx * ts, 3), np.uint8)
    for k, t in enumerate(tiles):
        iy, ix = divmod(k, nx)
        ents = city["reader"].get_entities_in_tile_with_neighbors(t)
        canvas[iy * ts:(iy + 1) * ts, ix * ts:(ix + 1) * ts] = drawer.draw_to_pixels(
            ents, t, scale, city["styler"])
    for iy in range(ny):
        canvas[iy * ts] = RED
    for ix in range(nx):
        canvas[:, ix * ts] = RED
    from PIL import Image

    want = np.asarray(Image.open(os.path.join(GOLDEN_DIR, f"{key}_expected.png")).convert("RGB"))
    assert canvas.shape == want.shape
    bad = (canvas != want).any(axis=-1)
    if bad.any():
        diff = np.zeros_like(canvas)
        diff[bad] = RED
        path = tmp_path / f"{key}_diff.png"
        path.write_bytes(rgb_to_png(diff))
        raise AssertionError(f"{key}: {int(bad.sum())} pixels differ from the golden; see {path}")


@pytest.mark.parametrize("key", DEVICE_CONFIGS)
def test_plain_render_within_oracle(city, key):
    te, scale = _tiles_entities(city, key)
    with torch_threads():
        r = BatchRenderer(city["styler"], stylesheet_dir=PROD_DIR, device="cpu")
        p = r.prepare(te, scale)
        got = r.render_prepared(p).numpy()
    assert p.cpu_fallback_tiles == ()
    drawer = CpuDrawer(stylesheet_dir=PROD_DIR)
    for (ents, t), g in zip(te, got):
        want = drawer.draw_to_pixels(ents, t, scale, city["styler"])
        assert np.abs(g.astype(int) - want.astype(int)).max() <= 1, t
    assert len(te) == (4 if key == "prod_16" else 1)


@pytest.mark.parametrize("key", DEVICE_CONFIGS)
def test_labeled_entry_equals_cpu_blit(city, key):
    """Every tile of the golden carries labels under this stylesheet; the
    labeled arena entry is the unlabeled entry's output with the slab's
    rows blitted on."""
    te, scale = _tiles_entities(city, key)
    ts = 256 * scale
    labeler = Labeler(icon_base_path=PROD_DIR)
    layers = [labeler.ensure_layer(e, t, float(scale), city["styler"], ts) for e, t in te]
    assert all(c is not None for c in layers)
    with torch_threads():
        r = BatchRenderer(city["styler"], stylesheet_dir=PROD_DIR, chunk_cache_tiles=16,
                          device="cpu", arena=True)
        pl = r.prepare(te, scale, label_layers=layers)
        pu = r.prepare(te, scale)
        assert pl.device_labeled == tuple(range(len(te))) and pu.label_rows is None
        got = r.render_prepared_planar(pl)
        base = r.render_prepared_planar(pu)
        lrow = LS.expand_ltriples(torch.from_numpy(pl.label_rows), ts)
        want = LS.blit_planar(base, pl.label_ctx[0].plane, lrow)
    assert torch.equal(got, want)
    assert not torch.equal(got, base)


@pytest.mark.parametrize("key", DEVICE_CONFIGS)
def test_plain_render_matches_pallas_interpret(city, key, tmp_path):
    """The golden's first tile through the JAX package's renderer (its
    importer, reader and styler; the Pallas kernel in interpret mode), as
    `test_production_device_parity` renders it, against the port's."""
    from osm_renderer_tpu.core.tile import Tile as JaxTile
    from osm_renderer_tpu.geodata.importer import import_osm as jax_import
    from osm_renderer_tpu.geodata.reader import GeodataReader as JaxReader
    from osm_renderer_tpu.mapcss.parser import parse_file as jax_parse_file
    from osm_renderer_tpu.mapcss.styler import Styler as JaxStyler
    from osm_renderer_tpu.parallel.renderer import BatchRenderer as JaxRenderer

    te, scale = _tiles_entities(city, key)
    ents, t = te[0]
    jbin = str(tmp_path / "jax.bin")
    jax_import(city["osm"], jbin)
    jreader = JaxReader.load(jbin)
    jt = JaxTile(t.zoom, t.x, t.y)
    jr = JaxRenderer(JaxStyler(jax_parse_file(PROD_DIR, SHEET), "mapsme"), backend="pallas",
                     interpret=True, stylesheet_dir=PROD_DIR)
    jp = jr.prepare([(jreader.get_entities_in_tile_with_neighbors(jt), jt)], scale=scale)
    assert not jp.cpu_fallback_tiles
    want = np.asarray(jr.render_prepared(jp))[0]
    with torch_threads():
        got = BatchRenderer(city["styler"], stylesheet_dir=PROD_DIR, device="cpu").render(
            [(ents, t)], scale)[0]
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    canvas = city["styler"].canvas_fill_color
    c = np.array([canvas.r, canvas.g, canvas.b], np.uint8)
    np.testing.assert_array_equal((got != c).any(-1), (want != c).any(-1))
