"""The port's jax-free host layout (ops/chunk_layout.py) and native
assembly (draw/native_assembler.py) against the JAX package's
render_pallas / native_assembler: every TileChunks and PallasBatch field
byte-identical, dtypes included."""

import os

import numpy as np
import pytest

from osm_renderer_tpu.core.tile import Tile, coords_to_max_zoom_tile
from osm_renderer_tpu.draw import native_assembler as ref_na
from osm_renderer_tpu.draw import primitives as JP
from osm_renderer_tpu.mapcss.parser import parse_file
from osm_renderer_tpu.mapcss.styler import Styler
from osm_renderer_tpu.ops import render_pallas as RP
from osm_renderer_tpu_torch.draw import native_assembler as port_na
from osm_renderer_tpu_torch.draw import primitives as P
from osm_renderer_tpu_torch.ops import chunk_layout as CL

from tests.fixtures import build_mini_reader
from tests.test_torch_helpers import STYLESHEET_DIR, port_mini_reader, port_styler
from tests.test_torch_render import (
    scene_2x,
    scene_4x_strokes,
    scene_fuzz,
    scene_mixed,
    scene_packed,
    scene_round_capped_dash,
    scene_row_blocks,
)

def assert_same(a, b, fields):
    assert len(a) == len(b)
    for name, x, y in zip(fields, a, b):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype, name
        assert x.shape == y.shape, name
        assert x.tobytes() == y.tobytes(), name


def test_layout_constants_match():
    for name in ("CH", "RB", "RB_F", "RB_I", "RB16", "DS", "GROUP", "NSEC", "IT_CAP",
                 "SPAN_TOL", "TOL255", "SPAN_ROW_MERGE", "SPAN_VS_ITEM", "STROKE_SPANS",
                 "KIND_PAD", "KIND_FILL", "KIND_STROKE", "KIND_STROKE_SOLID",
                 "KIND_FILL_IMAGE", "KIND_LAYER", "KIND_STROKE_DASH", "KIND_STROKE_SPAN"):
        assert getattr(CL, name) == getattr(RP, name), name
    assert CL.TileChunks._fields == RP.TileChunks._fields
    assert CL.PallasBatch._fields == RP.PallasBatch._fields
    assert [CL.next_bucket(n) for n in range(1, 3000, 7)] == [
        RP.next_bucket(n) for n in range(1, 3000, 7)
    ]


@pytest.mark.parametrize(
    "scene",
    [scene_mixed, scene_round_capped_dash, scene_row_blocks, scene_packed, scene_2x,
     lambda prim=P: scene_fuzz(3, prim), lambda prim=P: scene_fuzz(11, prim),
     lambda prim=P: scene_fuzz(29, prim), scene_4x_strokes],
    ids=["mixed", "round_capped_dash", "row_blocks", "packed", "2x", "fuzz3", "fuzz11",
         "fuzz29", "4x_strokes"],
)
@pytest.mark.parametrize("dash_items", [True, False])
def test_build_pallas_batch_byte_identical(scene, dash_items):
    """Each package streams its own primitives of the same scene."""
    batches = []
    for prim, layout in ((JP, RP), (P, CL)):
        _, prims, ts, packed = scene(prim)
        profiles = prim.ProfileTable()
        stream = (prim.stream_tile_packed(prims, profiles, CL.CH, size=ts)
                  if packed else prim.stream_tile(prims, profiles, CL.CH))
        batches.append(layout.build_pallas_batch([stream], profiles, ts, dash_items=dash_items))
    want, got = batches
    assert_same(got, want, RP.PallasBatch._fields)
    planar = np.random.default_rng(0).integers(0, 256, (2, 4, ts, ts), dtype=np.uint8)
    np.testing.assert_array_equal(CL.planar_to_rgb(planar), RP.planar_to_rgb(planar))


# A primary road and a forest whose far nodes lie ~20 km out: at z17/z18
# their tile coordinates exceed the int32-safe bound, so the native
# assembler returns placeholders that _splice_layers turns into host
# layers (KIND_LAYER).
FAR_WAYS = """  <node id="30" lat="47.0400" lon="9.3200"/>
  <node id="31" lat="47.2400" lon="9.7200"/>
  <node id="32" lat="47.1413" lon="9.5213"/>
  <way id="104"><nd ref="30"/><nd ref="32"/><nd ref="31"/><tag k="highway" v="primary"/></way>
  <way id="105"><nd ref="30"/><nd ref="31"/><nd ref="12"/><nd ref="30"/>
    <tag k="landuse" v="forest"/></way>
</osm>"""


@pytest.fixture(scope="module")
def readers(tmp_path_factory):
    """{fixture: (JAX-package reader, port reader)}, each imported by its
    own package."""
    from osm_renderer_tpu.geodata.importer import import_osm
    from osm_renderer_tpu.geodata.reader import GeodataReader
    from tests.fixtures import MINI_OSM

    tmp = tmp_path_factory.mktemp("mini")
    far_osm = os.path.join(str(tmp), "far.osm")
    with open(far_osm, "w") as f:
        f.write(MINI_OSM.replace("</osm>", FAR_WAYS))
    import_osm(far_osm, os.path.join(str(tmp), "far.bin"))
    port_tmp = tmp_path_factory.mktemp("mini_port")
    return {
        "mini": (build_mini_reader(tmp), port_mini_reader(port_tmp)),
        "far": (GeodataReader.load(os.path.join(str(tmp), "far.bin")),
                port_mini_reader(port_tmp, MINI_OSM.replace("</osm>", FAR_WAYS), "far")),
    }


@pytest.mark.parametrize("scale", [1, 2])
@pytest.mark.parametrize("fixture", ["mini", "far"])
def test_native_assembly_byte_identical(readers, fixture, scale):
    """Per-tile native assembly, then batch concatenation, through both
    packages, each with its own reader, styler, icon cache and
    (identically built) profile and pattern tables."""
    from osm_renderer_tpu.draw.labels.icons import IconCache as JaxIconCache
    from osm_renderer_tpu_torch.draw.labels.icons import IconCache

    sides = (
        (ref_na, readers[fixture][0], Styler(parse_file(STYLESHEET_DIR, "default.mapcss"), "josm"),
         JP, JaxIconCache),
        (port_na, readers[fixture][1], port_styler(), P, IconCache),
    )
    t18 = coords_to_max_zoom_tile(47.1412, 9.5215)
    tiles = [Tile(z, t18.x >> (18 - z), t18.y >> (18 - z)) for z in range(12, 19)]
    assert port_na.get_native() is not None
    ts = 256 * scale
    tables = []
    results = []
    for mod, reader, styler, prim, icons in sides:
        profiles = prim.ProfileTable()
        patterns = prim.PatternTable(icons(STYLESHEET_DIR), ts)
        chunks = []
        for t in tiles:
            ents = reader.get_entities_in_tile_with_neighbors(t)
            tc, icon = mod.assemble_tile_chunks_native(
                ents, t, float(scale), styler, profiles, patterns, ts
            )
            chunks.append((tc, icon))
        tables.append((profiles, patterns))
        results.append(chunks)
    for (want, icon_w), (got, icon_g) in zip(*results):
        assert icon_w == icon_g
        assert_same(got, want, RP.TileChunks._fields)
    if fixture == "far":
        assert any(RP.KIND_LAYER in c.kind for c, _ in results[1])
    (pr_w, pa_w), (pr_g, pa_g) = tables
    want = RP.concat_pallas_batch([c for c, _ in results[0]], pr_w, ts, pa_w)
    got = CL.concat_pallas_batch([c for c, _ in results[1]], pr_g, ts, pa_g)
    assert_same(got, want, RP.PallasBatch._fields)


def test_host_layer_batch_byte_identical():
    """Out-of-bound prims become host-layer chunks on the Python path."""
    far = 5 * P.FAST_COORD_BOUND
    tri = np.array([[-far, -100, 200, 90], [200, 90, 120, far], [120, far, -far, -100]],
                   dtype=np.int64)
    box = np.array([[30, 30, 90, 30], [90, 30, 90, 80], [90, 80, 30, 80], [30, 80, 30, 30]],
                   np.int64)
    out = []
    for prim, mod in ((JP, RP), (P, CL)):
        stream_prims = [
            prim.FillPrim(kind="fill", color=(70, 130, 70), opacity=0.9, edges=tri),
            prim.FillPrim(kind="fill", color=(180, 40, 40), opacity=1.0, edges=box),
        ]
        profiles = prim.ProfileTable()
        patterns = prim.PatternTable(None, 256)
        stream = prim.stream_tile_packed(stream_prims, profiles, CL.CH, patterns)
        out.append(mod.build_pallas_batch([stream], profiles, 256, patterns))
    assert np.asarray(out[0].kind).tolist().count(RP.KIND_LAYER) == 1
    assert_same(out[1], out[0], RP.PallasBatch._fields)
