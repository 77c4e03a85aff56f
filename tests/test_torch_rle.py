"""The port's run-length wire (ops/rle_layout.py, ops/rle_cuda.py) on the
CPU, held to the JAX package's XLA encoders (ops/rle.py) under jax CPU.

Bars: the plain v1 and v2 encoders are bit-identical to
`encode_batch_wire` and `encode_wire_indexed` whenever the batch fits
its cap; on overflow the header [T, total_runs] and the overflow flag
(total > cap) agree (past the cap both sides cut the content, and the
XLA encoder's last slot then carries a length it never finished).  On
overflow too, at the caps where the cut falls on an edge, the plain
wires equal a per-run loop encoder written from the format's
definition, content and zero tail included.  The
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
    cases.update(_synthetic_cases(rng))
    return cases


def _synthetic_cases(rng):
    """The shapes the card's wire kernels are driven at, cut to keep the
    XLA encoders' word cap at or under 65536: one colour over a 1024 px
    tile (one run a 256-pixel block), a per-pixel checkerboard (every
    run one pixel long) and random runs of geometric lengths (mean 6)
    over 400 colours (a learned palette leaves literals)."""
    def planar(vals):
        rgb = np.stack([(vals >> 16) & 0xFF, (vals >> 8) & 0xFF, vals & 0xFF], -1)
        return _planar_from_rgb(rgb.astype(np.uint8))

    yy, xx = np.indices((64, 64))
    n = 3 * 128 * 128
    colors = rng.integers(0, 1 << 24, 400)[rng.integers(0, 400, size=n)]
    runs = np.repeat(colors, rng.geometric(1 / 6, size=n))[:n]
    return {
        "uniform_T1_ts1024": planar(np.full((1, 1024, 1024), 0x4D7A2E, np.int64)),
        "checker_T2_ts64": planar(np.where((yy + xx) % 2 == 0, 0xF1EEE8, 0x3050A0)[None]
                                  .repeat(2, 0)),
        "runs_T3_ts128": planar(runs.reshape(3, 128, 128)),
    }


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


def _loop_runs(planar):
    """Every run of the batch as (tile, colour, length), by a loop over the
    format's definition: pixels tile-major then row-major as 0x00RRGGBB;
    a run ends at a colour change and at every BLOCK-th pixel."""
    runs = []
    for t in range(planar.shape[0]):
        p = planar[t, :3].astype(np.int64)
        v = ((p[0] << 16) | (p[1] << 8) | p[2]).reshape(-1)
        for b0 in range(0, v.size, RL.BLOCK):
            block = v[b0 : b0 + RL.BLOCK]
            cuts = [0, *(np.flatnonzero(block[1:] != block[:-1]) + 1).tolist(), RL.BLOCK]
            runs += [(t, int(block[a]), b - a) for a, b in zip(cuts[:-1], cuts[1:])]
    return runs


def _as_i32(words):
    return np.array(words, np.int64).astype(np.uint32).view(np.int32)


def _loop_v1(runs, T, rtot):
    """[T, total_runs, n_runs[T], packed[rtot]]: runs past rtot are cut;
    the header counts them all."""
    n_runs = [0] * T
    packed = [0] * rtot
    for i, (t, color, length) in enumerate(runs):
        n_runs[t] += 1
        if i < rtot:
            packed[i] = ((length - 1) << 24) | color
    return _as_i32([T, len(runs), *n_runs, *packed])


def _loop_v2(runs, T, wcap, table):
    """[T, total_words, total_runs, n_words[T], table, packed32[wcap/2]]:
    a palette hit is one word (index << 8 | len - 1), a miss three
    (0xFF00 | len - 1, colour & 0xFFFF, colour >> 16).  Runs at index
    >= wcap count no words; words at offset >= wcap are dropped;
    total_words = max(words counted, total_runs)."""
    first = {}
    for i, c in enumerate(table.tolist()):
        first.setdefault(c, i)
    words = [0] * wcap
    n_words = [0] * T
    o = 0
    for i, (t, color, length) in enumerate(runs):
        if i >= wcap:
            break
        if color in first:
            seq = [(first[color] << 8) | (length - 1)]
        else:
            seq = [0xFF00 | (length - 1), color & 0xFFFF, color >> 16]
        for w in seq:
            if o < wcap:
                words[o] = w
            o += 1
        n_words[t] += len(seq)
    packed32 = [lo | (hi << 16) for lo, hi in zip(words[0::2], words[1::2])]
    return _as_i32([T, max(o, len(runs)), len(runs), *n_words, *table.tolist(), *packed32])


def _edge_caps(runs, T, table):
    """The caps where the cut falls on an edge (all even): right after a
    literal's header word and right after its lo16 word, on a boundary
    between tiles, below total_runs, and at total_words (fits
    exactly)."""
    first = set(table.tolist())
    offs, o = [], 0
    for _, color, _ in runs:
        offs.append((o, color in first))
        o += 1 if color in first else 3
    lit = [w for w, hit in offs if not hit]
    ends = np.cumsum([sum(1 if c in first else 3 for t2, c, _ in runs if t2 == t)
                      for t in range(T)])[:-1]
    caps = {
        "after a literal's header word": next((w + 1 for w in lit if w % 2), None),
        "after a literal's lo16 word": next((w + 2 for w in lit if w % 2 == 0), None),
        "on a tile boundary": next((int(e) for e in ends if e % 2 == 0), None),
        "below total_runs": (len(runs) - 1) & ~1,
        "fits exactly": o + o % 2,
    }
    return {k: v for k, v in caps.items() if v}


@pytest.mark.parametrize("name", list(_synthetic_cases(np.random.default_rng(21)))
                         + ["rendered_1x", "rendered_2x"])
def test_plain_wires_match_loop_encoder(name, rendered):
    """The plain v1 and v2 wires, header, content and zero tail, equal a
    per-run loop encoder written from the format's definition, at the
    edge caps, overflowing ones included (the card's kernels are held
    to the plain versions on the whole wire)."""
    planar = _planar(name, rendered)
    T = planar.shape[0]
    runs = _loop_runs(planar)
    total = len(runs)
    pt = torch.from_numpy(planar)
    for rtot in (total, total - 1, max(total // 2, 1), RL.rcap_bucket(total)):
        np.testing.assert_array_equal(RLE.encode_batch_wire(pt, rtot).numpy(),
                                      _loop_v1(runs, T, rtot), err_msg=f"v1 rtot={rtot}")
    pal = _palettes(planar)
    # A palette with literals at both word parities: the half palette,
    # or all PAL_PAD where the half palette holds every colour.
    table = pal["half"] if len({c for _, c, _ in runs}) > 1 else pal["literal"]
    caps = _edge_caps(runs, T, table)
    assert {"after a literal's header word", "after a literal's lo16 word"} <= set(caps)
    for what, wcap in caps.items():
        got = RLE.encode_wire_indexed(pt, wcap, torch.from_numpy(table)).numpy()
        np.testing.assert_array_equal(got, _loop_v2(runs, T, wcap, table),
                                      err_msg=f"v2 wcap={wcap} ({what})")
        assert (int(got[1]) > wcap) == (wcap < caps["fits exactly"])


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
