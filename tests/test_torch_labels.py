"""The port's fontTools-free label stack (draw/labels/) against the JAX
package's, which reads the font through fontTools.

Bars, all exact: the port's `FontEngine` equals the original on every
glyph of the bundled font (vertex streams, advances), on every
codepoint of its cmap and on absent ones, on the vertical metrics and
the pixel-height scale; on a font rebuilt with a format-12 cmap and a
format-0 kern table; the port's `Labeler.ensure_layer` compact layers
are byte-identical to the original's on minicity tiles z13-z17 at @1x
and @2x; and the exact (use_atlas=False) `composite_labels` is
identical on two tiles.
"""

import os

import numpy as np
import pytest

from osm_renderer_tpu.core.tile import Tile as JaxTile
from osm_renderer_tpu.draw.labels import font as jfont
from osm_renderer_tpu.mapcss.parser import parse_file
from osm_renderer_tpu.mapcss.styler import Styler as JaxStyler
from osm_renderer_tpu_torch.core.tile import Tile
from osm_renderer_tpu_torch.draw.labels import font as pfont

from tests.conftest import REPO_ROOT
from tests.test_torch_helpers import STYLESHEET_DIR, make_minicity_osm, port_styler

FONT = os.path.join(REPO_ROOT, "assets", "fonts", "NotoSans-Regular.ttf")
N_GLYPH_SLICES = 4


@pytest.fixture(scope="module")
def engines():
    return pfont.FontEngine(FONT), jfont.FontEngine(FONT)


def test_font_tables_match(engines):
    port, ref = engines
    assert port.num_glyphs == len(ref.glyph_order) == 3246
    assert port.v_metrics() == ref.v_metrics()
    for h in (8.0, 11.5, 13.0, 17.25, 26.0, 64.0):
        assert port.scale_for_pixel_height(h) == ref.scale_for_pixel_height(h)
    codes = sorted(ref.cmap)
    absent = [cp for cp in (0x1, 0x7F, 0x378, 0xE000, 0xFFFE, 0x1F600, 0x10FFFF)
              if cp not in ref.cmap]
    assert len(absent) >= 5
    for cp in codes + absent:
        assert port.find_glyph_index(cp) == ref.find_glyph_index(cp), hex(cp)
    gids = range(port.num_glyphs)
    assert [port.advance_width(g) for g in gids] == [ref.advance_width(g) for g in gids]
    assert port.kern_advance(36, 37) == ref.kern_advance(36, 37) == 0


@pytest.mark.parametrize("part", range(N_GLYPH_SLICES))
def test_glyph_shapes_match(engines, part):
    """Every glyph's vertex stream, composites (scaled, 2x2 and nested
    components) included."""
    port, ref = engines
    n = port.num_glyphs
    lo, hi = part * n // N_GLYPH_SLICES, (part + 1) * n // N_GLYPH_SLICES
    for g in range(lo, hi):
        assert port.glyph_shape(g) == ref.glyph_shape(g), g


def test_font_with_format12_cmap_and_kern(tmp_path):
    """The bundled font rebuilt by fontTools with a (3, 10) format-12 cmap
    (fontTools' first preference) mapping astral codepoints, and a
    format-0 kern table."""
    from fontTools.ttLib import TTFont, newTable
    from fontTools.ttLib.tables._c_m_a_p import CmapSubtable
    from fontTools.ttLib.tables._k_e_r_n import KernTable_format_0

    font = TTFont(FONT)
    order = font.getGlyphOrder()
    mapping = dict(font.getBestCmap())
    mapping.update({0x1F600: order[40], 0x1F601: order[41], 0x10FFF0: order[3000]})
    sub = CmapSubtable.newSubtable(12)
    sub.platformID, sub.platEncID, sub.language = 3, 10, 0
    sub.cmap = mapping
    font["cmap"].tables.append(sub)
    kern = newTable("kern")
    kern.version = 0
    kt = KernTable_format_0()
    kt.version, kt.coverage, kt.format = 0, 1, 0
    kt.kernTable = {(order[36], order[37]): -40, (order[37], order[36]): 25,
                    (order[50], order[3000]): -7}
    kern.kernTables = [kt]
    font["kern"] = kern
    path = str(tmp_path / "rebuilt.ttf")
    font.save(path)

    port, ref = pfont.FontEngine(path), jfont.FontEngine(path)
    for cp in sorted(mapping) + [0x1F602, 0x7F]:
        assert port.find_glyph_index(cp) == ref.find_glyph_index(cp), hex(cp)
    assert port.find_glyph_index(0x10FFF0) == 3000
    for g1, g2 in ((36, 37), (37, 36), (50, 3000), (36, 36), (0, 1)):
        assert port.kern_advance(g1, g2) == ref.kern_advance(g1, g2)
    assert port.kern_advance(36, 37) == -40
    for g in (0, 36, 37, 3000, port.num_glyphs - 1):
        assert port.glyph_shape(g) == ref.glyph_shape(g)


def test_font_refuses_unsupported_cmap(tmp_path):
    """A best cmap subtable of a format the engine cannot read raises; it
    never maps every codepoint to glyph 0."""
    import struct

    data = bytearray(open(FONT, "rb").read())
    n_tables = struct.unpack_from(">H", data, 4)[0]
    cmap_off = next(off for tag, _, off, _ in (struct.unpack_from(">4sIII", data, 12 + 16 * i)
                                               for i in range(n_tables)) if tag == b"cmap")
    n_sub = struct.unpack_from(">H", data, cmap_off + 2)[0]
    for i in range(n_sub):
        pid, eid, off = struct.unpack_from(">HHI", data, cmap_off + 4 + 8 * i)
        if (pid, eid) == (3, 1):
            struct.pack_into(">H", data, cmap_off + off, 6)
    bad = tmp_path / "bad.ttf"
    bad.write_bytes(bytes(data))
    with pytest.raises(pfont.FontError, match="format 6"):
        pfont.FontEngine(str(bad))
    with pytest.raises(pfont.FontError, match="not a TrueType"):
        (tmp_path / "junk.ttf").write_bytes(b"OTTO" + bytes(64))
        pfont.FontEngine(str(tmp_path / "junk.ttf"))


@pytest.fixture(scope="module")
def city(tmp_path_factory):
    """(port reader, JAX-package reader) of the minicity, each imported by
    its own package."""
    from osm_renderer_tpu.geodata.importer import import_osm as jax_import
    from osm_renderer_tpu.geodata.reader import GeodataReader as JaxReader
    from osm_renderer_tpu_torch.geodata.importer import import_osm
    from osm_renderer_tpu_torch.geodata.reader import GeodataReader

    tmp = tmp_path_factory.mktemp("labels_city")
    osm = make_minicity_osm(tmp)
    import_osm(osm, str(tmp / "minicity.bin"))
    jax_import(osm, str(tmp / "minicity_jax.bin"))
    return (GeodataReader.load(str(tmp / "minicity.bin")),
            JaxReader.load(str(tmp / "minicity_jax.bin")))


@pytest.fixture(scope="module")
def styler():
    """(port styler, JAX-package styler)."""
    return port_styler(), JaxStyler(parse_file(STYLESHEET_DIR, "default.mapcss"), "josm")


def _tiles(reader, zoom, n):
    """[(port tile, JAX-package tile)] near the middle of the city."""
    tx = reader.tiles["x"] >> (18 - zoom)
    ty = reader.tiles["y"] >> (18 - zoom)
    u = sorted(set(zip(tx.tolist(), ty.tolist())))
    mid = len(u) // 2
    return [(Tile(zoom, *xy), JaxTile(zoom, *xy))
            for xy in u[max(0, mid - n // 2): mid - n // 2 + n]]


def _same_compact(got, want):
    if want is None:
        assert got is None
        return
    assert got[:4] == want[:4]
    for g, w in zip(got[4:], want[4:]):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()


@pytest.mark.parametrize("scale", [1, 2])
def test_label_layers_byte_identical(city, styler, scale):
    from osm_renderer_tpu.draw.labels.labeler import Labeler as JaxLabeler
    from osm_renderer_tpu_torch.draw.labels.labeler import Labeler

    port = Labeler(icon_base_path=STYLESHEET_DIR, use_atlas=True)
    ref = JaxLabeler(icon_base_path=STYLESHEET_DIR, use_atlas=True)
    (reader, jreader), (pstyler, jstyler) = city, styler
    n_labeled = 0
    for zoom in range(13, 18):
        for t, jt in _tiles(reader, zoom, 8 if scale == 1 else 4):
            ents = reader.get_entities_in_tile_with_neighbors(t)
            jents = jreader.get_entities_in_tile_with_neighbors(jt)
            got = port.ensure_layer(ents, t, float(scale), pstyler, 256 * scale)
            want = ref.ensure_layer(jents, jt, float(scale), jstyler, 256 * scale)
            _same_compact(got, want)
            n_labeled += want is not None
    assert n_labeled >= 8


def test_exact_composite_identical(city, styler):
    """use_atlas=False: the per-glyph scanline path through the port's
    text placer equals the original's."""
    from osm_renderer_tpu.draw.labels.labeler import Labeler as JaxLabeler
    from osm_renderer_tpu_torch.draw.labels.labeler import Labeler

    port = Labeler(icon_base_path=STYLESHEET_DIR, use_atlas=False)
    ref = JaxLabeler(icon_base_path=STYLESHEET_DIR, use_atlas=False)
    (reader, jreader), (pstyler, jstyler) = city, styler
    rng = np.random.default_rng(3)
    for t, jt in _tiles(reader, 16, 1) + _tiles(reader, 17, 1):
        ents = reader.get_entities_in_tile_with_neighbors(t)
        jents = jreader.get_entities_in_tile_with_neighbors(jt)
        base = rng.integers(0, 256, (256, 256, 3)).astype(np.uint8)
        got = port.composite_labels(base, ents, t, 1.0, pstyler)
        want = ref.composite_labels(base, jents, jt, 1.0, jstyler)
        np.testing.assert_array_equal(got, want)
        assert not np.array_equal(got, base)
