"""The port's host codec (`draw/png8.py` over `csrc/wire_host.cpp`) on the
CPU: run-length wires made by the port's wire encoders decoded to RGB,
to palette-index rows and to palette PNGs (PNG-8).

Bars: the decodes equal the numpy plain versions
(`rle_layout.decode_words_numpy`, png_writer's numpy loops) and the
batch's pixels; the index rows and palettes equal the JAX package's
native decoder's (`native/pngenc.cpp`); a PNG-8's IHDR and PLTE bytes
equal the JAX package's `png_writer.words_to_png_pal`, its IDAT inflates
to the same bytes at levels 1 and 6 (only the deflate encoder differs),
and to the Up-filtered index rows of a numpy filter, and it decodes to
the tile's pixels; a palette overflow or a short wire gives None on both
sides.  The tile view and the server serve through the port's library
with or without libdeflate, never through the numpy decoders, and a
library that cannot be had raises.

The wires: minicity (tools/make_fixture.py --blocks 24) z15 tiles at ts
256 and 512, rendered by the render kernel's plain twin, under a learned
palette, half of it and no palette (every run a literal escape), and
synthetic tiles of exactly 256 and of 257 colours.  The comparisons with
the JAX package's native library skip where it does not build.
"""

import io
import struct
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from osm_renderer_tpu_torch.draw import png8, png_writer
from osm_renderer_tpu_torch.ops import chunk_layout as CL
from osm_renderer_tpu_torch.ops import rle_cuda as RLE
from osm_renderer_tpu_torch.ops import rle_layout as RL

from tests.test_torch_helpers import STYLESHEET_DIR, port_bin, port_styler


def _planar(rgb: np.ndarray) -> np.ndarray:
    T, h, w, _ = rgb.shape
    p = np.zeros((T, 4, h, w), np.uint8)
    p[:, :3] = rgb.transpose(0, 3, 1, 2)
    p[:, 3] = 255
    return p


def _rgb_of(vals: np.ndarray) -> np.ndarray:
    """0xRRGGBB ints (T, h, w) -> (T, h, w, 3) u8."""
    return np.stack([(vals >> 16) & 0xFF, (vals >> 8) & 0xFF, vals & 0xFF], -1).astype(np.uint8)


def _palettes(planar: np.ndarray) -> dict:
    p = planar.astype(np.int64)
    v = ((p[:, 0] << 16) | (p[:, 1] << 8) | p[:, 2]).reshape(-1)
    colors, counts = np.unique(v, return_counts=True)
    half = max(1, len(colors) // 2)
    return {
        "learned": RL.build_palette(colors, counts),
        "half": RL.build_palette(colors[:half], counts[:half]),
        "literal": np.full(RL.PAL_CAP, RL.PAL_PAD, np.int32),
    }


class Wires:
    """A batch's pixels and its v1 and v2 wires, split by tile."""

    def __init__(self, planar: np.ndarray, palette: str):
        self.T, self.ts = planar.shape[0], planar.shape[2]
        self.rgb = planar[:, :3].transpose(0, 2, 3, 1).copy()
        p = planar[:, :3].astype(np.int64)
        vals = ((p[:, 0] << 16) | (p[:, 1] << 8) | p[:, 2]).reshape(self.T, -1)
        # Whether each tile fits a PNG palette (at most 256 colours).
        self.fits = [len(np.unique(v)) <= 256 for v in vals]
        pt = torch.from_numpy(planar)
        total_runs = RLE.runs_reference(pt)[0].numel()
        rtot = RL.rcap_bucket(total_runs)
        v1 = RLE.encode_batch_wire(pt, rtot).numpy()
        assert int(v1[1]) <= rtot
        self.n_runs = v1[2 : 2 + self.T]
        self.packed = v1[2 + self.T :]
        self.roffs = np.concatenate([[0], np.cumsum(self.n_runs)]).astype(np.int64)
        wcap = CL.next_bucket(3 * total_runs + 2, 8192)
        table = torch.from_numpy(_palettes(planar)[palette])
        v2 = RLE.encode_wire_indexed(pt, wcap, table).numpy()
        assert int(v2[1]) <= wcap
        self.n_words = v2[3 : 3 + self.T]
        self.table = v2[3 + self.T : 3 + self.T + RL.PAL_CAP]
        self.packed32 = v2[3 + self.T + RL.PAL_CAP :]
        self.woffs = np.concatenate([[0], np.cumsum(self.n_words)]).astype(np.int64)

    def words(self, i: int):
        """Tile i's slice of the v2 wire as the codecs take it."""
        return self.packed32, int(self.woffs[i]), int(self.n_words[i]), self.table

    def runs(self, i: int) -> np.ndarray:
        return self.packed[self.roffs[i] : self.roffs[i + 1]]


@pytest.fixture(scope="module")
def minicity_planars(tmp_path_factory):
    """Minicity z15: all 30 tiles at ts 256, six at ts 512."""
    from osm_renderer_tpu_torch.geodata.importer import import_osm
    from osm_renderer_tpu_torch.geodata.reader import GeodataReader
    from osm_renderer_tpu_torch.parallel.renderer import BatchRenderer
    from osm_renderer_tpu_torch.tools.corpus import zoom_tiles

    from tests.test_torch_helpers import make_minicity_osm, torch_threads

    tmp = tmp_path_factory.mktemp("png8")
    bin_path = str(tmp / "minicity.bin")
    import_osm(make_minicity_osm(tmp), bin_path)
    reader = GeodataReader.load(bin_path)
    tiles = zoom_tiles(reader, 15)
    r = BatchRenderer(port_styler(), stylesheet_dir=STYLESHEET_DIR, device="cpu")
    out = {}
    with torch_threads(1):
        for scale, n in ((1, len(tiles)), (2, 6)):
            te = [(reader.get_entities_in_tile_with_neighbors(t), t) for t in tiles[:n]]
            out[256 * scale] = r.render_prepared_planar(r.prepare(te, scale)).numpy()
    return out


def _synthetic(n_colours: int, ts: int) -> np.ndarray:
    """One tile: `n_colours` - 1 colours whose G is 0xFF (their literal
    payload words look like escape headers), one on every other pixel
    from the first, and one background colour everywhere else."""
    rng = np.random.default_rng(n_colours)
    cols = rng.choice(1 << 16, n_colours - 1, replace=False)
    cols = ((cols & 0xFF00) << 8) | 0x00FF00 | (cols & 0xFF)
    vals = np.full(ts * ts, 0x102030, np.int64)
    vals[::2][: n_colours - 1] = cols
    return _planar(_rgb_of(vals.reshape(1, ts, ts)))


WIRE_CASES = [f"minicity{ts}_{pal}" for ts in (256, 512) for pal in ("learned", "half", "literal")]
WIRE_CASES += ["colours256_half", "colours256_literal", "colours257_half", "colours257_literal"]


@pytest.fixture(scope="module")
def wires(minicity_planars):
    out = {}
    for name in WIRE_CASES:
        what, pal = name.split("_")
        if what.startswith("minicity"):
            planar = minicity_planars[int(what[len("minicity"):])]
        else:
            planar = _synthetic(int(what[len("colours"):]), 32)
        out[name] = Wires(planar, pal)
    return out


@pytest.fixture(scope="module")
def jax_native():
    """The JAX package's native PNG library, or a skip where it does not
    build here."""
    from osm_renderer_tpu.draw import png_writer as jax_png

    lib = jax_png._get_native()
    if lib is None:
        pytest.skip("the JAX package's native PNG library (libdeflate) does not build here")
    return jax_png


@pytest.fixture
def numpy_png_writer(monkeypatch):
    """png_writer with its native library forced absent: its numpy loops."""
    monkeypatch.setattr(png_writer, "_get_native", lambda: None)
    return png_writer


def _chunks(png: bytes) -> dict:
    assert png[:8] == b"\x89PNG\r\n\x1a\n"
    out, pos = {}, 8
    while pos < len(png):
        n, tag = struct.unpack(">I4s", png[pos : pos + 8])
        payload = png[pos + 8 : pos + 8 + n]
        assert struct.unpack(">I", png[pos + 8 + n : pos + 12 + n])[0] == zlib.crc32(tag + payload)
        out.setdefault(tag.decode(), []).append(payload)
        pos += 12 + n
    assert list(out) == ["IHDR", "PLTE", "IDAT", "IEND"] or list(out) == ["IHDR", "IDAT", "IEND"]
    return out


def _pixels(png: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(png)).convert("RGB"))


@pytest.mark.parametrize("name", WIRE_CASES)
def test_decodes_equal_the_plain_versions(name, wires, numpy_png_writer):
    """Tile by tile, RGB from both wires equals the numpy decoders and the
    batch's pixels."""
    w = wires[name]
    for i in range(w.T):
        got_v2 = png8.decode_words(*w.words(i), w.ts, w.ts)
        np.testing.assert_array_equal(got_v2, w.rgb[i])
        np.testing.assert_array_equal(got_v2, RL.decode_words_numpy(*w.words(i), w.ts, w.ts))
        got_v1 = png8.decode_packed(w.runs(i), w.ts, w.ts)
        np.testing.assert_array_equal(got_v1, w.rgb[i])
        np.testing.assert_array_equal(got_v1, numpy_png_writer.rle_decode_packed(
            w.runs(i), w.ts, w.ts))
    for i in range(min(w.T, 2)):  # the per-word Python loop
        np.testing.assert_array_equal(
            numpy_png_writer.rle_decode_words(*w.words(i), w.ts, w.ts), w.rgb[i])


@pytest.mark.parametrize("name", WIRE_CASES)
def test_index_rows_and_decodes_equal_the_jax_native(name, wires, jax_native):
    lib = jax_native._get_native()
    w = wires[name]
    for i in range(w.T):
        np.testing.assert_array_equal(png8.decode_words(*w.words(i), w.ts, w.ts),
                                      jax_native.rle_decode_words(*w.words(i), w.ts, w.ts))
        np.testing.assert_array_equal(png8.decode_packed(w.runs(i), w.ts, w.ts),
                                      jax_native.rle_decode_packed(w.runs(i), w.ts, w.ts))
        idx = np.empty((w.ts, w.ts), np.uint8)
        plte = np.zeros(256, np.int32)
        packed32, off, n, table = w.words(i)
        n_pal = lib.osmr_rle_decode_words_idx(packed32, off, n, table, table.shape[0],
                                              w.ts, w.ts, idx, plte)
        got = png8.decode_words_idx(*w.words(i), w.ts, w.ts)
        assert (got is None) == (n_pal == 0) == (not w.fits[i])
        if got is not None:
            np.testing.assert_array_equal(got[0], idx)
            np.testing.assert_array_equal(got[1], plte[:n_pal])


@pytest.mark.parametrize("level", [1, 6])
@pytest.mark.parametrize("name", WIRE_CASES)
def test_png8_equals_the_jax_native(name, level, wires, jax_native):
    """Equal IHDR and PLTE, IDATs that inflate to the same bytes, None
    on the same tiles."""
    w = wires[name]
    for i in range(w.T):
        got = png8.words_to_png_pal(*w.words(i), w.ts, w.ts, level)
        want = jax_native.words_to_png_pal(*w.words(i), w.ts, w.ts, level)
        assert (got is None) == (want is None) == (not w.fits[i])
        if got is None:
            continue
        g, r = _chunks(got), _chunks(want)
        assert g["IHDR"] == r["IHDR"] and g["PLTE"] == r["PLTE"] and g["IEND"] == r["IEND"]
        assert zlib.decompress(b"".join(g["IDAT"])) == zlib.decompress(b"".join(r["IDAT"]))


@pytest.mark.parametrize("name", WIRE_CASES)
def test_png8_is_the_filtered_index_rows(name, wires):
    """Each PNG-8 decodes to the tile's pixels; its IHDR says 8-bit
    palette; its IDAT, inflated, is the index rows through a numpy Up
    filter, the palette being the tile's colours in order of first use."""
    w = wires[name]
    n_png8 = 0
    for i in range(w.T):
        png = png8.words_to_png_pal(*w.words(i), w.ts, w.ts, 1)
        if not w.fits[i]:
            assert png is None
            continue
        n_png8 += 1
        np.testing.assert_array_equal(_pixels(png), w.rgb[i])
        c = _chunks(png)
        assert c["IHDR"] == [struct.pack(">IIBBBBB", w.ts, w.ts, 8, 3, 0, 0, 0)]
        flat = w.rgb[i].reshape(-1, 3).astype(np.int64)
        vals = (flat[:, 0] << 16) | (flat[:, 1] << 8) | flat[:, 2]
        first, inverse = np.unique(vals, return_index=True, return_inverse=True)[1:]
        order = np.argsort(first)
        rank = np.empty_like(order)
        rank[order] = np.arange(order.size)
        idx = rank[inverse].astype(np.uint8).reshape(w.ts, w.ts)
        assert c["PLTE"] == [_rgb_of(vals[np.sort(first)]).tobytes()]
        raw = np.empty((w.ts, w.ts + 1), np.uint8)
        raw[:, 0] = 2
        raw[0, 0] = 0
        raw[0, 1:] = idx[0]
        raw[1:, 1:] = idx[1:] - idx[:-1]
        assert zlib.decompress(b"".join(c["IDAT"])) == raw.tobytes()
    if name.startswith(("minicity256", "colours256")):
        assert n_png8


@pytest.mark.parametrize("cut", ["inside_a_literal", "a_word_short", "a_word_long"])
def test_short_and_long_wires(cut, wires, numpy_png_writer):
    """A slice that ends inside a literal, covers one run too few pixels
    or runs into the next tile: None from the PNG-8 writer, ValueError
    from the decoders, as from the plain version."""
    w = wires["minicity256_half"]
    packed32, off, n, table = w.words(0)
    words = packed32.view(np.uint16)[off : off + n].astype(np.int32)
    headers = np.flatnonzero(RL.header_mask(words))
    if cut == "inside_a_literal":
        n = int(headers[(words[headers] >> 8) == 0xFF][0]) + 2
    elif cut == "a_word_short":
        n = int(headers[-1])  # drops the last run
    else:
        n += 1
    assert png8.words_to_png_pal(packed32, off, n, table, w.ts, w.ts, 1) is None
    assert png8.decode_words_idx(packed32, off, n, table, w.ts, w.ts) is None
    with pytest.raises(ValueError):
        png8.decode_words(packed32, off, n, table, w.ts, w.ts)
    with pytest.raises(ValueError):
        RL.decode_words_numpy(packed32, off, n, table, w.ts, w.ts)
    runs = w.runs(0)
    with pytest.raises(ValueError):
        png8.decode_packed(runs[:-1], w.ts, w.ts)
    with pytest.raises(ValueError):
        numpy_png_writer.rle_decode_packed(runs[:-1], w.ts, w.ts)


def _without_libdeflate(monkeypatch):
    """This process as on a host without libdeflate, and the numpy
    decoders refusing to run."""
    from osm_renderer_tpu_torch.ops import rle_layout

    def refuse(*a, **kw):
        raise AssertionError("a numpy decoder was called on the served path")

    monkeypatch.setattr(png_writer, "_get_native", lambda: None)
    for mod, fn in ((rle_layout, "decode_words_numpy"), (png_writer, "rle_decode_words"),
                    (png_writer, "rle_decode_packed")):
        monkeypatch.setattr(mod, fn, refuse)


def test_tile_view_takes_the_port_library_without_libdeflate(wires, monkeypatch):
    from osm_renderer_tpu_torch.parallel.renderer import RleTileView

    _without_libdeflate(monkeypatch)
    for name in ("minicity512_half", "colours257_literal"):
        w = wires[name]
        v2 = RleTileView(w.T, w.ts, words=(w.packed32, w.woffs, w.table))
        v1 = RleTileView(w.T, w.ts, runs=(w.packed, w.roffs))
        assert (v2.wire_fmt(0), v1.wire_fmt(0)) == ("v2", "v1")
        for i in range(w.T):
            np.testing.assert_array_equal(v2.rgb(i), w.rgb[i])
            np.testing.assert_array_equal(v1.rgb(i), w.rgb[i])
            assert v1.png8(i, 1) is None
            png = v2.png8(i, 1)
            assert png == png8.words_to_png_pal(*w.words(i), w.ts, w.ts, 1)
            assert (png is None) == (not w.fits[i])


def test_codec_raises_without_either_library(tmp_path, monkeypatch):
    """No silent fallback: with the port's library failing to build, the
    codec and the device service raise, whether libdeflate builds or not."""
    from osm_renderer_tpu_torch.server.http import TileService
    from osm_renderer_tpu_torch.utils import torch_setup

    (tmp_path / "broken.cpp").write_text("extern \"C\" int osmr_rle_decode_packed(\n")
    monkeypatch.setattr(png8, "_lib", None)
    monkeypatch.setitem(torch_setup._HOST_LIBS, "wirehost", (str(tmp_path), "broken.cpp", ()))
    monkeypatch.delitem(torch_setup._host_paths, "wirehost", raising=False)
    with pytest.raises(RuntimeError, match="broken.cpp failed"):
        png8.library()
    with pytest.raises(RuntimeError, match="broken.cpp failed"):
        TileService(port_bin(tmp_path), port_styler(), STYLESHEET_DIR, device="cpu")
    monkeypatch.setattr(png_writer, "_get_native", lambda: None)
    with pytest.raises(RuntimeError, match="broken.cpp failed"):
        png8.library()
    assert png8._lib is None


def test_cpu_server_without_libdeflate_ships_png8(tmp_path, monkeypatch):
    """The CPU server (labels on, device = cpu) on a host without
    libdeflate: the port's codec; warm device tiles as colour type 3,
    counted as png8, but for tiles of more than 256 colours, counted as
    overflows; the PNG-8 bytes and the pixels of a server that has
    libdeflate, which serves through the same codec."""
    from osm_renderer_tpu_torch.core.tile import Tile, coords_to_max_zoom_tile
    from osm_renderer_tpu_torch.server.http import TileService

    mini_bin = port_bin(tmp_path)
    styler = port_styler()
    t18 = coords_to_max_zoom_tile(47.1412, 9.5215)
    tiles = [(Tile(z, t18.x >> (18 - z), t18.y >> (18 - z)), s)
             for z in range(12, 18) for s in (1, 2)]
    kw = dict(device="cpu", png_cache_tiles=0)
    with_native = TileService(mini_bin, styler, STYLESHEET_DIR, **kw)
    want = [with_native.render_tiles_device(tiles) for _ in range(2)][-1]

    _without_libdeflate(monkeypatch)
    bare = TileService(mini_bin, styler, STYLESHEET_DIR, **kw)
    bare.render_tiles_device(tiles)  # the first batch's v1 wire teaches the palette
    first = dict(bare.containers)
    bare.containers.clear()
    served = dict(bare.tiles_served)
    got = bare.render_tiles_device(tiles)
    device_tiles = bare.tiles_served["device"] - served.get("device", 0)
    assert first.get("rgb_v1") and device_tiles > 0
    assert set(bare.containers) <= {"png8", "rgb_overflow"} and bare.containers["png8"] > 0
    assert sum(bare.containers.values()) == device_tiles
    assert sum(png[25] == 3 for png in got) == bare.containers["png8"]
    for (t, s), p_g, p_w in zip(tiles, got, want):
        px = _pixels(p_g)
        np.testing.assert_array_equal(px, _pixels(p_w), err_msg=f"{t}@{s}x")
        if p_g[25] == 3:  # the same codec on both
            assert p_g == p_w, f"{t}@{s}x"
        else:  # an overflow: more colours than a palette holds
            assert len(np.unique(px.reshape(-1, 3), axis=0)) > 256, f"{t}@{s}x"
