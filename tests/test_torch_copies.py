"""The port's copies of the JAX package's jax-free host modules, pinned to
their originals on the minicity fixture (tools/make_fixture.py --blocks
24), and the port's imports.

Each side is built wholly from its own package (importer, reader,
styler, primitives, drawer, oracle, icons, labeler, PNG writer,
labelable, perfstats); only files and plain values cross.  Bars, all
exact: the importers write byte-identical .bin files (through the
importer CLIs from the .osm, and from a .pbf each package's writer
encodes); the readers return the same entities for every z15 tile; the
stylers give equal styles for every entity of those tiles
(default.mapcss, josm; and the reference's production stylesheet,
osmosnimki-minimal.mapcss, mapsme, in the `_production` tests);
`assemble_tile_prims` gives equal primitives; `CpuDrawer` gives
byte-identical pixels at @1x and @2x, labels included; `rgb_to_png`
gives equal bytes (native encoder and zlib); `labelable` gives equal
waypoints and label positions; the perfstats
span trees of the drawer runs are equal; `build_batch` stacks equal
arrays from both packages' streams.  No file of the port imports
the JAX package.
"""

import ast
import dataclasses
import enum
import os
import subprocess
import sys

import numpy as np
import pytest

from osm_renderer_tpu import perfstats as jax_perfstats
from osm_renderer_tpu.core.tile import Tile as JaxTile
from osm_renderer_tpu.draw import png_writer as jax_png
from osm_renderer_tpu.draw import primitives as JP
from osm_renderer_tpu.draw.drawer import CpuDrawer as JaxCpuDrawer
from osm_renderer_tpu.draw.labels import labelable as jax_labelable
from osm_renderer_tpu.draw.labels.labeler import Labeler as JaxLabeler
from osm_renderer_tpu.geodata import pbf as jax_pbf
from osm_renderer_tpu.geodata.importer import import_osm as jax_import, parse_osm_xml as jax_parse
from osm_renderer_tpu.geodata.reader import GeodataReader as JaxReader
from osm_renderer_tpu.mapcss.parser import parse_file as jax_parse_file
from osm_renderer_tpu.mapcss.styler import Styler as JaxStyler
from osm_renderer_tpu_torch import perfstats
from osm_renderer_tpu_torch.core.tile import Tile
from osm_renderer_tpu_torch.draw import png_writer
from osm_renderer_tpu_torch.draw import primitives as P
from osm_renderer_tpu_torch.draw.drawer import CpuDrawer
from osm_renderer_tpu_torch.draw.labels import labelable
from osm_renderer_tpu_torch.draw.labels.labeler import Labeler
from osm_renderer_tpu_torch.geodata import pbf
from osm_renderer_tpu_torch.geodata.importer import import_osm, parse_osm_xml
from osm_renderer_tpu_torch.geodata.reader import GeodataReader

from osm_renderer_tpu_torch.mapcss.parser import parse_file
from osm_renderer_tpu_torch.mapcss.styler import Styler

from tests.conftest import REPO_ROOT
from tests.test_torch_helpers import STYLESHEET_DIR, make_minicity_osm, port_styler, write_osm

PROD_DIR = os.path.join(REPO_ROOT, "tests", "fixtures", "mapcss")
PROD_SHEET = "osmosnimki-minimal.mapcss"


@pytest.fixture(scope="module")
def city(tmp_path_factory):
    """Both packages' readers, stylers and z15 tiles over one minicity
    .osm; the port imports it through its importer CLI."""
    tmp = tmp_path_factory.mktemp("copies_city")
    osm = make_minicity_osm(tmp)
    jax_bin, port_bin = str(tmp / "jax.bin"), str(tmp / "port.bin")
    jax_import(osm, jax_bin)
    subprocess.run([sys.executable, "-m", "osm_renderer_tpu_torch.cli.importer_main", osm,
                    port_bin], cwd=REPO_ROOT, check=True, stdout=subprocess.DEVNULL)
    reader = GeodataReader.load(port_bin)
    xs, ys = reader.tiles["x"] >> 3, reader.tiles["y"] >> 3
    xy = sorted(set(zip(xs.tolist(), ys.tolist())))
    return dict(
        bins=(jax_bin, port_bin),
        readers=(JaxReader.load(jax_bin), reader),
        stylers=(JaxStyler(jax_parse_file(STYLESHEET_DIR, "default.mapcss"), "josm"),
                 port_styler()),
        tiles=[(JaxTile(15, x, y), Tile(15, x, y)) for x, y in xy],
        sheet_dir=STYLESHEET_DIR,
    )


@pytest.fixture(scope="module")
def prod_city(city):
    """The same city under the production stylesheet (mapsme): the
    dash caps, casing widths and canvas fill of the MAPS.ME type."""
    return dict(city, sheet_dir=PROD_DIR,
                stylers=(JaxStyler(jax_parse_file(PROD_DIR, PROD_SHEET), "mapsme"),
                         Styler(parse_file(PROD_DIR, PROD_SHEET), "mapsme")))


def _entities(city, i):
    """[(JAX-package entities, port entities, JAX tile, port tile)] of
    every z15 tile, or of tile i."""
    (jr, pr), tiles = city["readers"], city["tiles"]
    pick = tiles if i is None else tiles[i: i + 1]
    return [(jr.get_entities_in_tile_with_neighbors(jt), pr.get_entities_in_tile_with_neighbors(t),
             jt, t) for jt, t in pick]


def _plain(v):
    """A package-free value: dataclasses and named tuples as field
    tuples, enums by name, arrays as (dtype, shape, bytes)."""
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return (type(v).__name__,) + tuple((f.name, _plain(getattr(v, f.name)))
                                           for f in dataclasses.fields(v))
    if isinstance(v, enum.Enum):
        return (type(v).__name__, v.name)
    if isinstance(v, np.ndarray):
        return (str(v.dtype), v.shape, v.tobytes())
    if isinstance(v, (list, tuple)):
        return (type(v).__name__ if hasattr(v, "_fields") else "seq",) + tuple(map(_plain, v))
    if isinstance(v, np.generic):
        return v.item()
    return v


def _entity_key(e):
    kind = type(e).__name__
    tags = tuple(e.tags().items())
    if kind == "Node":
        return (kind, e.global_id, e.lat, e.lon, tags)
    if kind == "Way":
        return (kind, e.global_id, e.node_ids.tobytes(), tags)
    polys = tuple(e.get_polygon(k).node_ids.tobytes() for k in range(e.polygon_count()))
    return (kind, e.global_id, polys, tags)


def _all(ents):
    return list(ents.nodes) + list(ents.ways) + list(ents.multipolygons)


def test_importer_cli_writes_the_same_bin(city):
    jax_bin, port_bin = city["bins"]
    with open(jax_bin, "rb") as a, open(port_bin, "rb") as b:
        want, got = a.read(), b.read()
    assert len(want) > 100_000 and got == want


def test_pbf_writers_and_imports_byte_identical(tmp_path):
    """Each package encodes the mini scene as PBF with its own writer and
    imports that file with its own importer."""
    osm = write_osm(tmp_path)
    outs = []
    for name, parse, mod, importer in (("jax", jax_parse, jax_pbf, jax_import),
                                        ("port", parse_osm_xml, pbf, import_osm)):
        st = parse(osm)
        gids = [n.global_id for n in st.node_storage.entities]
        path = str(tmp_path / f"{name}.osm.pbf")
        w = mod.PbfWriter(path)
        w.write_dense_nodes((n.global_id, n.lat, n.lon, n.tags) for n in st.node_storage.entities)
        w.write_ways((wy.global_id, [gids[i] for i in wy.node_ids], wy.tags)
                     for wy in st.way_storage.entities)
        w.write_relations([(200, [(mod.MEMBER_WAY, 102, "outer"), (mod.MEMBER_WAY, 103, "inner")],
                            {"type": "multipolygon", "natural": "water"})])
        w.close()
        importer(path, str(tmp_path / f"{name}.bin"))
        outs.append([open(p, "rb").read() for p in (path, str(tmp_path / f"{name}.bin"))])
    assert outs[1] == outs[0]


def test_reader_entities_equal(city):
    n = 0
    for jents, pents, _, _ in _entities(city, None):
        want = [_entity_key(e) for e in _all(jents)]
        assert [_entity_key(e) for e in _all(pents)] == want
        n += len(want)
    assert len(city["tiles"]) >= 20 and n > 1000


def test_styles_equal(city):
    """style_entities (paint and label order) and style_areas."""
    _styles_equal(city)


def test_styles_equal_production(prod_city):
    assert not prod_city["stylers"][1].use_caps_for_dashes
    _styles_equal(prod_city)


def _styles_equal(city):
    jstyler, pstyler = city["stylers"]
    n = 0
    for jents, pents, jt, t in _entities(city, None):
        for for_labels in (False, True):
            got = [(e.global_id, _plain(s))
                   for e, s in pstyler.style_entities(_all(pents), t.zoom, for_labels)]
            want = [(e.global_id, _plain(s))
                    for e, s in jstyler.style_entities(_all(jents), jt.zoom, for_labels)]
            assert got == want
            n += len(want)
        got = pstyler.style_areas(pents.ways, pents.multipolygons, t.zoom, False)
        want = jstyler.style_areas(jents.ways, jents.multipolygons, jt.zoom, False)
        assert [(e.global_id, _plain(s)) for e, s in got] == \
            [(e.global_id, _plain(s)) for e, s in want]
    assert n > 1000


@pytest.mark.parametrize("scale", [1, 2])
def test_assemble_tile_prims_equal(city, scale):
    _assemble_equal(city, scale)


@pytest.mark.parametrize("scale", [1, 2])
def test_assemble_tile_prims_equal_production(prod_city, scale):
    _assemble_equal(prod_city, scale)


def _assemble_equal(city, scale):
    jstyler, pstyler = city["stylers"]
    n = 0
    for jents, pents, jt, t in _entities(city, None):
        got = P.assemble_tile_prims(pents, t, float(scale), pstyler)
        want = JP.assemble_tile_prims(jents, jt, float(scale), jstyler)
        assert [_plain(p) for p in got] == [_plain(p) for p in want]
        n += len(want)
    assert n > 1000


def _draw_both(city, scale, labels, tiles):
    """Both CpuDrawers (with their own labelers when `labels`) over the
    given z15 tiles, each run inside its own perfstats tile run ->
    [(JAX pixels, port pixels)], (JAX stats, port stats)."""
    jstyler, pstyler = city["stylers"]
    sheet_dir = city["sheet_dir"]
    jd = JaxCpuDrawer(labeler=JaxLabeler(icon_base_path=sheet_dir, use_atlas=False)
                      if labels else None, stylesheet_dir=sheet_dir)
    pd = CpuDrawer(labeler=Labeler(icon_base_path=sheet_dir, use_atlas=False)
                   if labels else None, stylesheet_dir=sheet_dir)
    stats = (jax_perfstats.PerfStats(), perfstats.PerfStats())
    out = []
    for i in tiles:
        ((jents, pents, jt, t),) = _entities(city, i)
        pair = []
        for mod, st, drawer, ents, tile, styler in (
                (jax_perfstats, stats[0], jd, jents, jt, jstyler),
                (perfstats, stats[1], pd, pents, t, pstyler)):
            mod.start_tile(tile.zoom)
            pair.append(drawer.draw_to_pixels(ents, tile, scale, styler))
            mod.finish_tile(st)
        out.append(tuple(pair))
    return out, stats


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["exact", "fast"])
def test_build_batch_equal(city, dtype):
    """`stream_tile` then `build_batch` over every z15 tile, each side with
    its own tables and the chunk doubled to hold the largest fill, as the
    dense BatchRenderer does: equal arrays, dtypes and shapes."""
    jstyler, pstyler = city["stylers"]
    ents = _entities(city, None)
    sides = []
    for mod, styler, tiles in ((JP, jstyler, [(je, jt) for je, _, jt, _ in ents]),
                               (P, pstyler, [(pe, t) for _, pe, _, t in ents])):
        profiles, patterns = mod.ProfileTable(), mod.PatternTable(None, 256)
        prims = [mod.assemble_tile_prims(e, t, 1.0, styler) for e, t in tiles]
        chunk = 64
        while chunk < max((p.edges.shape[0] for ps in prims for p in ps
                           if isinstance(p, mod.FillPrim)), default=0):
            chunk *= 2
        streams = [mod.stream_tile(ps, profiles, chunk, patterns) for ps in prims]
        sides.append((mod.build_batch(streams, profiles, chunk, dtype=dtype,
                                      patterns=patterns, ts=256), profiles.has_round_caps()))
    (want, want_chain), (got, got_chain) = sides
    assert got_chain == want_chain
    assert type(got).__name__ == type(want).__name__ == "TileBatch"
    assert got._fields == want._fields
    for name, a, b in zip(want._fields, want, got):
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), name
    assert got.geom.shape[0] == len(city["tiles"]) and (got.chunk_kind > 0).sum() > 10000


# Every third z15 tile (the drawer is the slow part of this file).
DRAWN = range(0, 30, 3)


@pytest.mark.parametrize("scale", [1, 2])
def test_cpu_drawer_pixels_identical(city, scale):
    """Fills, strokes and labels through the C++ oracle: byte-identical."""
    pairs, _ = _draw_both(city, scale, True, [i for i in DRAWN if i < len(city["tiles"])])
    assert len(pairs) >= 8
    for want, got in pairs:
        assert got.shape == want.shape == (256 * scale, 256 * scale, 3)
        assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("scale", [1, 2])
def test_cpu_drawer_pixels_identical_production(prod_city, scale):
    """Dashes with butt caps, mapsme casings and the canvas fill, with the
    production labels, on every sixth z15 tile."""
    tiles = [i for i in range(0, len(prod_city["tiles"]), 6)]
    pairs, _ = _draw_both(prod_city, scale, True, tiles)
    assert len(pairs) >= 5
    for want, got in pairs:
        assert got.shape == want.shape == (256 * scale, 256 * scale, 3)
        assert got.tobytes() == want.tobytes()


def _tree(node):
    return (node.name, tuple(sorted((k, _tree(v)) for k, v in node.children.items())))


def test_perfstats_span_trees_equal(city):
    _, (jstats, pstats) = _draw_both(city, 1, True, [0, 1])
    assert pstats.tile_counts == jstats.tile_counts == {15: 2}
    assert _tree(pstats.by_zoom[15]) == _tree(jstats.by_zoom[15])
    assert "Draw labels" in dict(_tree(pstats.by_zoom[15])[1])
    assert pstats.to_html().count("<li") == jstats.to_html().count("<li")


@pytest.mark.parametrize("encoder", ["native", "zlib"])
def test_rgb_to_png_equal_bytes(city, encoder, monkeypatch):
    pairs, _ = _draw_both(city, 1, False, [3, 4])
    if encoder == "zlib":
        monkeypatch.setattr(jax_png, "_get_native", lambda: None)
        monkeypatch.setattr(png_writer, "_get_native", lambda: None)
    for want_px, got_px in pairs:
        for level in (1, 6):
            want = jax_png.rgb_to_png(want_px, level)
            assert png_writer.rgb_to_png(got_px, level) == want
            assert want[:8] == b"\x89PNG\r\n\x1a\n"


def test_labelable_equal(city):
    n = 0
    for jents, pents, jt, t in _entities(city, None)[::4]:
        for je, pe in zip(_all(jents), _all(pents)):
            for scale in (1.0, 2.0):
                got = labelable.get_label_position(pe, t, scale)
                want = jax_labelable.get_label_position(je, jt, scale)
                assert _plain(got) == _plain(want)
                if type(pe).__name__ != "Node":
                    assert _plain(labelable.get_waypoints(pe, t, scale)) == \
                        _plain(jax_labelable.get_waypoints(je, jt, scale))
                n += want is not None
    assert n > 100


def test_labelable_equal_production(prod_city):
    """Label positions and waypoints of the entities the production
    stylesheet labels at z15 (style_entities for labels)."""
    jstyler, pstyler = prod_city["stylers"]
    n = 0
    for jents, pents, jt, t in _entities(prod_city, None)[::4]:
        want = [(e, s) for e, s in jstyler.style_entities(_all(jents), jt.zoom, True)
                if s.text_style is not None]
        got = [(e, s) for e, s in pstyler.style_entities(_all(pents), t.zoom, True)
               if s.text_style is not None]
        assert [e.global_id for e, _ in got] == [e.global_id for e, _ in want]
        for (je, _), (pe, _) in zip(want, got):
            for scale in (1.0, 2.0):
                assert _plain(labelable.get_label_position(pe, t, scale)) == \
                    _plain(jax_labelable.get_label_position(je, jt, scale))
                if type(pe).__name__ != "Node":
                    assert _plain(labelable.get_waypoints(pe, t, scale)) == \
                        _plain(jax_labelable.get_waypoints(je, jt, scale))
            n += 1
    assert n > 20


def _port_files():
    root = os.path.join(REPO_ROOT, "osm_renderer_tpu_torch")
    files = [os.path.join(REPO_ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(root):
        files += [os.path.join(d, f) for f in sorted(names) if f.endswith(".py")]
    return files


def test_no_port_file_imports_the_jax_package():
    """An AST scan of every file of the port and of chip_smoke.py: no
    import of `osm_renderer_tpu` or any module of it, at any depth."""
    bad = []
    files = _port_files()
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
                names = [node.module]
            for name in names:
                if name.split(".")[0] == "osm_renderer_tpu":
                    bad.append(f"{os.path.relpath(path, REPO_ROOT)}:{node.lineno}: {name}")
    assert len(files) > 40
    tools = os.path.join(REPO_ROOT, "osm_renderer_tpu_torch", "tools")
    assert {os.path.join(tools, f"{name}.py") for name in (
        "kdevice", "kdecomp_device", "scale_sweep", "parity_check", "warmup", "profile_serving",
        "cold_profile", "ktime", "kdecomp")} <= set(files)
    assert os.path.join(REPO_ROOT, "osm_renderer_tpu_torch", "bench.py") in files
    assert os.path.join(REPO_ROOT, "osm_renderer_tpu_torch", "ops", "dense_cuda.py") in files
    assert not bad, bad
