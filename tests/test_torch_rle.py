"""The port's run-length wire (ops/rle_layout.py, ops/rle_cuda.py) on the
CPU, held to the JAX package's XLA encoders (ops/rle.py) under jax CPU.

Bars: the plain v1 and v2 encoders are bit-identical to
`encode_batch_wire` and `encode_wire_indexed` whenever the batch fits
its cap; on overflow the header [T, total_runs] and the overflow flag
(total > cap) agree (past the cap both sides cut the content, and the
XLA encoder's last slot then carries a length it never finished).  The
copied constants, `build_palette` and the numpy decoders equal the
originals, and the vectorised v2 decode equals
`decode_wire_indexed_numpy`.  The CUDA kernels are held to the plain
versions on the card by chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from osm_renderer_tpu.ops import rle
from osm_renderer_tpu_torch.core.tile import Tile, coords_to_max_zoom_tile
from osm_renderer_tpu_torch.ops import rle_cuda as RLE
from osm_renderer_tpu_torch.ops import rle_layout as RL
from osm_renderer_tpu_torch.ops.render_cuda import BatchLayoutError

from tests.test_rle import _planar_from_rgb, _random_tiles
from tests.test_torch_helpers import STYLESHEET_DIR, port_mini_reader, port_styler


def _rgb_cases():
    rng = np.random.default_rng(21)
    cases = {}
    for T in (1, 4):
        for ts in (256, 512):
            rgb = _random_tiles(rng, T=T, ts=ts)
            # Literal colours with G = 0xFF: their rgb & 0xFFFF word looks
            # like a literal escape header.
            rgb[0, : ts // 8, : ts // 4, 1] = 255
            cases[f"random_T{T}_ts{ts}"] = _planar_from_rgb(rgb)
    cases["uniform_T2_ts256"] = _planar_from_rgb(np.full((2, 256, 256, 3), 77, np.uint8))
    return cases


CASES = _rgb_cases()


@pytest.fixture(scope="module")
def rendered():
    """Planar batches rendered by the port (the render kernel's plain
    twin) from the mini fixture, at 1x and 2x."""
    import tempfile

    from osm_renderer_tpu_torch.parallel.renderer import BatchRenderer

    reader = port_mini_reader(tempfile.mkdtemp())
    styler = port_styler()
    t18 = coords_to_max_zoom_tile(47.1412, 9.5215)
    tiles = [Tile(z, t18.x >> (18 - z), t18.y >> (18 - z)) for z in (15, 16, 17)]
    te = [(reader.get_entities_in_tile_with_neighbors(t), t) for t in tiles]
    r = BatchRenderer(styler, stylesheet_dir=STYLESHEET_DIR, device="cpu")
    return {
        f"rendered_{s}x": r.render_prepared_planar(r.prepare(te, s)).numpy() for s in (1, 2)
    }


def _planar(name, rendered):
    return rendered[name] if name.startswith("rendered") else CASES[name]


ALL_CASES = list(CASES) + ["rendered_1x", "rendered_2x"]


def _palettes(planar):
    p = planar.astype(np.int64)
    v = ((p[:, 0] << 16) | (p[:, 1] << 8) | p[:, 2]).reshape(-1)
    colors, counts = np.unique(v, return_counts=True)
    half = max(1, len(colors) // 2)
    return {
        "learned": RL.build_palette(colors, counts),
        "half": RL.build_palette(colors[:half], counts[:half]),
        "literal": np.full(RL.PAL_CAP, RL.PAL_PAD, np.int32),
    }


def _total_runs(planar) -> int:
    return int(np.asarray(rle.encode_wire_device(planar, 1 << 16))[1])


@pytest.mark.parametrize("name", ALL_CASES)
def test_plain_v1_matches_xla(name, rendered):
    planar = _planar(name, rendered)
    total = _total_runs(planar)
    rtot = RL.rcap_bucket(total)
    want = np.asarray(rle.encode_wire_device(planar, rtot))
    got = RLE.encode_batch_wire(torch.from_numpy(planar), rtot).numpy()
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    if name.startswith("uniform"):
        assert total == planar.shape[0] * planar.shape[2] ** 2 // RL.BLOCK  # one run a block
    # Overflow: the header and the flag agree.
    small = RL.rcap_bucket(total // 4, minimum=256)
    want_o = np.asarray(rle.encode_wire_device(planar, small))
    got_o = RLE.encode_batch_wire(torch.from_numpy(planar), small).numpy()
    T = planar.shape[0]
    np.testing.assert_array_equal(got_o[: 2 + T], want_o[: 2 + T])
    assert int(got_o[1]) > small and int(want_o[1]) > small
    assert RL.decode_wire_numpy(got_o, planar.shape[2]) is None


@pytest.mark.parametrize("palette", ["learned", "half", "literal"])
@pytest.mark.parametrize("name", ALL_CASES)
def test_plain_v2_matches_xla(name, palette, rendered):
    planar = _planar(name, rendered)
    table = _palettes(planar)[palette]
    total = _total_runs(planar)
    wcap = RL.rcap_bucket(3 * total + 2, minimum=8192)
    assert wcap <= 65536  # the XLA encoder's compile time grows with wcap
    want = np.asarray(rle.encode_wire_indexed_device(planar, wcap, table))
    got = RLE.encode_wire_indexed(torch.from_numpy(planar), wcap, torch.from_numpy(table))
    got = got.numpy()
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    total_words, total_runs = int(got[1]), int(got[2])
    if palette == "literal":
        assert total_words == 3 * total_runs
    elif palette == "half" and not name.startswith("uniform"):
        assert total_words > total_runs  # both word forms occur
    T = planar.shape[0]
    tiles = RL.decode_wire_indexed_numpy(got, planar.shape[2])
    for t in range(T):
        np.testing.assert_array_equal(tiles[t], planar[t, :3].transpose(1, 2, 0))


@pytest.mark.parametrize("name", ["random_T4_ts256", "rendered_2x"])
def test_plain_v2_overflow_matches_xla(name, rendered):
    """A word cap below the batch's needs: [T, total_runs] and the
    overflow flag agree with the XLA encoder."""
    planar = _planar(name, rendered)
    table = _palettes(planar)["half"]
    wcap = 1024
    want = np.asarray(rle.encode_wire_indexed_device(planar, wcap, table))
    got = RLE.encode_wire_indexed(torch.from_numpy(planar), wcap, torch.from_numpy(table))
    got = got.numpy()
    assert int(got[0]) == int(want[0])
    assert int(got[2]) == int(want[2])
    assert int(got[1]) > wcap and int(want[1]) > wcap
    assert RL.decode_wire_indexed_numpy(got, planar.shape[2]) is None


def test_layout_copies_match_originals():
    assert (RL.BLOCK, RL.PAL_CAP, RL.PAL_PAD) == (rle.BLOCK, rle.PAL_CAP, rle.PAL_PAD)
    for n in list(range(0, 5000, 37)) + [4096, 4097, 1 << 20]:
        for minimum in (1024, 256, 8192):
            assert RL.rcap_bucket(n, minimum) == rle.rcap_bucket(n, minimum)
    rng = np.random.default_rng(4)
    for n_colors in (1, 100, 255, 256, 2000):
        colors = np.unique(rng.integers(0, 1 << 24, n_colors))
        counts = rng.integers(1, 50, colors.shape[0])
        got, want = RL.build_palette(colors, counts), rle.build_palette(colors, counts)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    planar = CASES["random_T4_ts256"]
    table = _palettes(planar)["half"]
    for cap in (1 << 14, 256):
        v1 = np.asarray(rle.encode_wire_device(planar, cap))
        v2 = np.asarray(rle.encode_wire_indexed_device(planar, 4 * cap, table))
        for port_fn, ref_fn, wire in ((RL.decode_wire_numpy, rle.decode_wire_numpy, v1),
                                      (RL.decode_wire_indexed_numpy,
                                       rle.decode_wire_indexed_numpy, v2)):
            got, want = port_fn(wire, 256), ref_fn(wire, 256)
            assert (got is None) == (want is None)
            for a, b in zip(got or [], want or []):
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("rounds", [RL._FIXPOINT_ROUNDS, 0], ids=["fixpoint", "scan"])
@pytest.mark.parametrize("palette", ["half", "literal"])
def test_vectorised_v2_decode_matches_reference(palette, rounds, monkeypatch, rendered):
    """Tile by tile, bit-identical to decode_wire_indexed_numpy, on wires
    whose literal colours have G = 0xFF (escape-looking payload words),
    through the direct recurrence and through the prefix scan."""
    monkeypatch.setattr(RL, "_FIXPOINT_ROUNDS", rounds)
    for planar in (CASES["random_T4_ts512"], CASES["random_T1_ts256"], rendered["rendered_1x"]):
        T, ts = planar.shape[0], planar.shape[2]
        table = _palettes(planar)[palette]
        wire = RLE.encode_wire_indexed(torch.from_numpy(planar), 1 << 16, torch.from_numpy(table))
        wire = wire.numpy()
        want = RL.decode_wire_indexed_numpy(wire, ts)
        n_words = wire[3 : 3 + T]
        tab = wire[3 + T : 3 + T + RL.PAL_CAP]
        packed32 = wire[3 + T + RL.PAL_CAP :]
        off = 0
        escape_like = 0
        for t in range(T):
            got = RL.decode_words_numpy(packed32, off, int(n_words[t]), tab, ts, ts)
            assert got.shape == (ts, ts, 3) and got.dtype == np.uint8
            np.testing.assert_array_equal(got, want[t])
            words = packed32.view(np.uint16)[off : off + int(n_words[t])]
            escape_like += int(((words >> 8) == 0xFF).sum())
            off += int(n_words[t])
        assert escape_like > 0


def test_vectorised_decode_long_escape_chain():
    """A tile of single-pixel literal runs, every payload word escape-like:
    the recurrence cannot settle in its rounds, the scan decodes it."""
    ts = 16
    rng = np.random.default_rng(9)
    vals = rng.integers(0, 1 << 24, ts * ts) | 0x00FF00   # G = 0xFF
    vals[1::2] = vals[::2]  # runs of two
    planar = _planar_from_rgb(
        np.stack([(vals >> 16) & 0xFF, (vals >> 8) & 0xFF, vals & 0xFF], 1)
        .astype(np.uint8).reshape(1, ts, ts, 3)
    )
    table = np.full(RL.PAL_CAP, RL.PAL_PAD, np.int32)
    wire = RLE.encode_wire_indexed(torch.from_numpy(planar), 1024, torch.from_numpy(table))
    wire = wire.numpy()
    assert int(wire[1]) == 3 * int(wire[2]) == 3 * ts * ts // 2
    packed32 = wire[3 + 1 + RL.PAL_CAP :]
    got = RL.decode_words_numpy(packed32, 0, int(wire[3]), wire[4 : 4 + RL.PAL_CAP], ts, ts)
    np.testing.assert_array_equal(got, RL.decode_wire_indexed_numpy(wire, ts)[0])
    with pytest.raises(ValueError):
        RL.decode_words_numpy(packed32, 0, int(wire[3]) - 1, wire[4 : 4 + RL.PAL_CAP], ts, ts)


def test_wrappers_check_their_inputs():
    planar = torch.from_numpy(CASES["random_T1_ts256"])
    table = torch.full((RL.PAL_CAP,), RL.PAL_PAD, dtype=torch.int32)
    with pytest.raises(BatchLayoutError):
        RLE.encode_batch_wire(planar.to(torch.int32), 1024)
    with pytest.raises(BatchLayoutError):
        RLE.encode_batch_wire(planar[:, :3].contiguous(), 1024)
    with pytest.raises(BatchLayoutError):
        RLE.encode_batch_wire(planar.transpose(2, 3), 1024)
    with pytest.raises(BatchLayoutError):
        RLE.encode_batch_wire(planar, 0)
    with pytest.raises(BatchLayoutError):
        RLE.encode_wire_indexed(planar, 1023, table)
    with pytest.raises(BatchLayoutError):
        RLE.encode_wire_indexed(planar, 1024, table[:-1].contiguous())
    with pytest.raises(BatchLayoutError):
        RLE.encode_wire_indexed(planar, 1024, table.to(torch.int64))
