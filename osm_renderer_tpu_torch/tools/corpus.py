"""The synthetic cities and their batches, shared by the benchmark, the
tools and `chip_smoke.py`: a city built once by `tools/make_fixture.py`
and the port's importer, every tile of a zoom the geodata covers, and a
tile batch prepared under `BatchRenderer.MAX_BATCH_CHUNKS` by halving,
as the server halves it.
"""

from __future__ import annotations

import contextlib
import os
import subprocess
import sys

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def build_fixture(osm: str, binf: str, blocks: int) -> str:
    """The synthetic city of `blocks` blocks a side at `osm`, imported by
    the port's importer into `binf`, each made once -> binf.  The
    importer's progress lines go to stderr."""
    from osm_renderer_tpu_torch.geodata.importer import import_osm

    if not os.path.exists(binf):
        os.makedirs(os.path.dirname(osm), exist_ok=True)
        subprocess.run([sys.executable, os.path.join(REPO_ROOT, "tools", "make_fixture.py"), osm,
                        "--blocks", str(blocks)], check=True, cwd=REPO_ROOT,
                       stdout=subprocess.DEVNULL)
        with contextlib.redirect_stdout(sys.stderr):
            import_osm(osm, binf)
    return binf


def zoom_tiles(reader, zoom: int):
    """Every tile of `zoom` the geodata covers, sorted."""
    from osm_renderer_tpu_torch.core.tile import Tile

    sh = 18 - zoom
    xs, ys = reader.tiles["x"] >> sh, reader.tiles["y"] >> sh
    return [Tile(zoom, x, y) for x, y in sorted(set(zip(xs.tolist(), ys.tolist())))]


def with_entities(reader, tiles):
    """[(entities of the tile and its neighbours, tile)] for `tiles`."""
    return [(reader.get_entities_in_tile_with_neighbors(t), t) for t in tiles]


def split_prepare(renderer, tiles_entities, scale, label_layers=None):
    """Prepared batches under MAX_BATCH_CHUNKS, halving like the server
    -> [(prepared, its tiles_entities, its label layers)]."""
    try:
        return [(renderer.prepare(tiles_entities, scale, label_layers=label_layers),
                 tiles_entities, label_layers)]
    except ValueError as e:
        if "MAX_BATCH_CHUNKS" not in str(e) or len(tiles_entities) == 1:
            raise
    mid = len(tiles_entities) // 2
    halves = (slice(0, mid), slice(mid, None))
    return [got for sl in halves for got in split_prepare(
        renderer, tiles_entities[sl], scale,
        label_layers[sl] if label_layers is not None else None)]
