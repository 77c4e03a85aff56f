"""The port's DeviceDrawer (draw/drawer.py, the dense exact renderer on
the CPU) against the JAX package's DeviceDrawer on the tests/fixtures.py
mini scene with tests/test_drawer_e2e.py's STYLE (dashes and round caps
at z17): four z17 tiles in one batch and one @2x tile.  Each side reads,
styles and assembles with its own package (the JAX side in a child
process: `test_torch_helpers.run_jax`).  Bar: byte-identical."""

import numpy as np
import pytest

from tests.test_drawer_e2e import STYLE, _tiles_around_fixture
from tests.test_torch_helpers import port_mini_reader, run_jax, torch_threads

_JAX_SIDE = """
from osm_renderer_tpu.core.tile import Tile
from osm_renderer_tpu.draw.drawer import DeviceDrawer
from osm_renderer_tpu.mapcss.parser import parse_string
from osm_renderer_tpu.mapcss.styler import Styler
from tests.fixtures import build_mini_reader
reader = build_mini_reader({tmp!r})
styler = Styler(parse_string({style!r}), "josm")
tiles = [Tile(int(z), int(x), int(y)) for z, x, y in inp["tiles"]]
te = [(reader.get_entities_in_tile_with_neighbors(t), t) for t in tiles]
out["rgb"] = DeviceDrawer().render_tiles(te, {scale}, styler)
"""


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    from osm_renderer_tpu_torch.draw.drawer import DeviceDrawer
    from osm_renderer_tpu_torch.mapcss.parser import parse_string
    from osm_renderer_tpu_torch.mapcss.styler import Styler

    tmp = tmp_path_factory.mktemp("dense_drawer")
    reader = port_mini_reader(tmp)
    styler = Styler(parse_string(STYLE), "josm")

    def render(tiles, scale):
        jtmp = tmp / f"jax{scale}"
        jtmp.mkdir()
        zxy = np.array([[t.zoom, t.x, t.y] for t in tiles], np.int64)
        want = run_jax(_JAX_SIDE.format(tmp=str(jtmp), style=STYLE, scale=scale), jtmp,
                       tiles=zxy)["rgb"]
        with torch_threads(1):
            got = DeviceDrawer(device="cpu").render_tiles(
                [(reader.get_entities_in_tile_with_neighbors(t), t) for t in tiles], scale,
                styler)
        return want, got

    return render


def test_device_drawer_z17_batch_byte_identical(sides):
    want, got = sides(_port_tiles(17), 1)
    assert got.shape == want.shape == (4, 256, 256, 3)
    assert got.tobytes() == want.tobytes()
    assert (got != got[0, 0, 0]).any(-1).mean() > 0.05


def test_device_drawer_2x_byte_identical(sides):
    want, got = sides(_port_tiles(17)[1:2], 2)
    assert got.shape == want.shape == (1, 512, 512, 3)
    assert got.tobytes() == want.tobytes()


def _port_tiles(zoom):
    from osm_renderer_tpu_torch.core.tile import Tile

    return [Tile(t.zoom, t.x, t.y) for t in _tiles_around_fixture(zoom)]
