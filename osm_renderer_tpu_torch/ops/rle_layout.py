"""Host half of the run-length wire: constants, the serving palette and
the numpy decoders.

A jax-free copy of the host parts of `osm_renderer_tpu.ops.rle`
(`BLOCK`, `PAL_CAP`, `PAL_PAD`, `rcap_bucket`, `build_palette`,
`decode_wire_numpy`, `decode_wire_indexed_numpy`): that module imports
jax at module level, and the GPU host has none.  tests/test_torch_rle.py
pins every copy to its original.

The formats (the device half is `ops.rle_cuda`):

* v1 wire, one i32 array: [T, total_runs, n_runs[T], packed[rtot]].
  A run never crosses a BLOCK-pixel boundary, so each run packs into
  one word, (len - 1) << 24 | 0xRRGGBB, tile-major then row-major.
* v2 wire, one i32 array: [T, total_words, total_runs, n_words[T],
  table[PAL_CAP], packed32[wcap / 2]].  A run whose colour is in the
  sorted palette `table` is one 16-bit word, idx << 8 | (len - 1); any
  other run is a literal escape of three words, 0xFF00 | (len - 1),
  rgb & 0xFFFF, rgb >> 16.  Words pack two per i32, low half first.

A total above the cap means the batch overflowed the wire and the
caller reads the raw planar batch instead.

`decode_words_numpy` is not a copy: it is a vectorised plain version of
the v2 decode, which the tests hold the host codecs of `draw/png8.py`
to; the served path decodes through those codecs and never reaches it.
"""

from __future__ import annotations

import numpy as np

BLOCK = 256  # forced-boundary period; run length <= BLOCK fits the top byte

PAL_CAP = 255       # palette entries; index 255 is the literal escape
PAL_PAD = 0x7F7F7F7F  # table padding; > any 0x00RRGGBB so lookups miss


def rcap_bucket(n: int, minimum: int = 1024) -> int:
    """Static-shape bucket for run caps: pow2, floor `minimum`."""
    return max(minimum, 1 << (max(n, 1) - 1).bit_length())


def build_palette(colors: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """Top-PAL_CAP colors by count -> sorted (PAL_CAP,) i32 table
    (padded with PAL_PAD)."""
    order = np.argsort(counts)[::-1][:PAL_CAP]
    top = colors[order]
    table = np.full(PAL_CAP, PAL_PAD, np.int32)
    table[: top.shape[0]] = np.sort(top).astype(np.int32)
    table.sort()
    return table


def decode_wire_indexed_numpy(wire: np.ndarray, ts: int):
    """v2 wire -> list of (ts, ts, 3) u8 tiles, or None on overflow.

    Reference decode for tests; serving decodes per tile natively
    (native/pngenc.cpp osmr_rle_decode_words)."""
    T = int(wire[0])
    total_words = int(wire[1])
    n_words = wire[3 : 3 + T]
    table = wire[3 + T : 3 + T + PAL_CAP]
    packed32 = wire[3 + T + PAL_CAP :]
    if total_words > 2 * packed32.shape[0]:
        return None
    w16 = np.empty(2 * packed32.shape[0], np.int64)
    w16[0::2] = packed32 & 0xFFFF
    w16[1::2] = (packed32 >> 16) & 0xFFFF
    out = []
    pos = 0
    for t in range(T):
        nw = int(n_words[t])
        words = w16[pos : pos + nw]
        pos += nw
        flat = np.empty(ts * ts, np.int64)
        fp = 0
        i = 0
        while i < nw:
            hdr = int(words[i])
            pidx = hdr >> 8
            ln = (hdr & 0xFF) + 1
            if pidx == 0xFF:
                val = int(words[i + 1]) | ((int(words[i + 2]) & 0xFF) << 16)
                i += 3
            else:
                val = int(table[pidx])
                i += 1
            flat[fp : fp + ln] = val
            fp += ln
        assert fp == ts * ts, (fp, ts * ts)
        rgb = np.empty((ts * ts, 3), np.uint8)
        rgb[:, 0] = (flat >> 16) & 0xFF
        rgb[:, 1] = (flat >> 8) & 0xFF
        rgb[:, 2] = flat & 0xFF
        out.append(rgb.reshape(ts, ts, 3))
    return out


def decode_wire_numpy(wire: np.ndarray, ts: int):
    """Wire buffer -> (list of (ts, ts, 3) u8 tiles) or None on overflow.

    Reference decode for tests; serving decodes per tile natively."""
    T = int(wire[0])
    total = int(wire[1])
    n_runs = wire[2 : 2 + T]
    packed = wire[2 + T :]
    if total > packed.shape[0]:
        return None
    out = []
    pos = 0
    for t in range(T):
        n = int(n_runs[t])
        runs = packed[pos : pos + n]
        pos += n
        lens = ((runs >> 24) & 0xFF).astype(np.int64) + 1
        vals = runs & 0xFFFFFF
        flat = np.repeat(vals, lens)
        assert flat.shape[0] == ts * ts
        rgb = np.empty((ts * ts, 3), np.uint8)
        rgb[:, 0] = (flat >> 16) & 0xFF
        rgb[:, 1] = (flat >> 8) & 0xFF
        rgb[:, 2] = flat & 0xFF
        out.append(rgb.reshape(ts, ts, 3))
    return out


# Word parser as a 3-state automaton: the state is the number of literal
# payload words still to come (0 means the next word is a header).  A
# palette header keeps 0, a literal header moves 0 -> 2, and a payload
# word counts down.  Each word is one of two maps of the states; their
# compositions form a small closed set, numbered here once, so that
# composing two maps is one lookup in _COMPOSE.
def _map_closure():
    palette_or_payload = (0, 0, 1)   # word whose high byte is not 0xFF
    escape_like = (2, 0, 1)          # word whose high byte is 0xFF
    maps = [palette_or_payload, escape_like]
    i = 0
    while i < len(maps):
        for j in range(i + 1):
            for a, b in ((maps[i], maps[j]), (maps[j], maps[i])):
                ab = tuple(b[a[s]] for s in range(3))   # a first, then b
                if ab not in maps:
                    maps.append(ab)
        i += 1
    n = len(maps)
    compose = np.empty(n * n, np.int16)
    for a, ma in enumerate(maps):
        for b, mb in enumerate(maps):
            compose[a * n + b] = maps.index(tuple(mb[ma[s]] for s in range(3)))
    return n, compose, np.array([m[0] for m in maps], np.int8)


# _COMPOSE[a * _N_MAPS + b]: map a, then map b.  _FROM_HEADER[m]: m(0).
_N_MAPS, _COMPOSE, _FROM_HEADER = _map_closure()

# Rounds of the direct recurrence tried before the prefix scan.
_FIXPOINT_ROUNDS = 8


def header_mask(words: np.ndarray) -> np.ndarray:
    """Bool mask of the header words of one tile's v2 word stream.

    Whether a word is a header depends on the words before it: a word
    whose high byte is 0xFF is a literal escape only where it is a
    header, and a literal's rgb & 0xFFFF word can look the same.  Word j
    is a header iff j == 0 or neither word j-1 nor j-2 is a header that
    looks like an escape.  Iterated from all-headers, that recurrence
    settles in as many rounds as the longest chain of escape-looking
    words, which is a few on map tiles.  Where it has not settled after
    _FIXPOINT_ROUNDS, the per-word maps are composed by a Hillis-Steele
    prefix scan instead: log2(n) rounds, whatever the chains."""
    n = words.shape[0]
    lit = ((words >> 8) & 0xFF) == 0xFF
    hdr = np.ones(n, bool)
    for _ in range(_FIXPOINT_ROUNDS):
        esc = hdr & lit
        nxt = np.ones(n, bool)
        nxt[1:] &= ~esc[:-1]
        nxt[2:] &= ~esc[:-2]
        if np.array_equal(nxt, hdr):
            return hdr
        hdr = nxt
    maps = lit.astype(np.int16)  # map ids 0 and 1 are the two word maps
    d = 1
    while d < n:
        # maps[j] <- maps[j - d] then maps[j]: covers words (j - 2d, j].
        maps[d:] = np.take(_COMPOSE, maps[:-d] * _N_MAPS + maps[d:])
        d *= 2
    state_before = np.zeros(n, np.int8)
    state_before[1:] = _FROM_HEADER[maps[:-1]]
    return state_before == 0


def decode_words_numpy(
    packed32: np.ndarray, word_off: int, n_words: int, table: np.ndarray,
    h: int, w: int,
) -> np.ndarray:
    """One tile's slice of the v2 word stream -> (h, w, 3) u8, without a
    per-word Python loop (same contract as png_writer.rle_decode_words)."""
    lo = word_off // 2
    hi = -(-(word_off + n_words) // 2)
    # Two words per little-endian i32, low half first.
    pairs = np.ascontiguousarray(np.asarray(packed32)[lo:hi], dtype="<i4")
    first = word_off - 2 * lo
    words = pairs.view("<u2")[first : first + n_words].astype(np.int32)
    if words.shape[0] != n_words:
        raise ValueError("indexed RLE words do not cover the tile")
    hdr_at = np.flatnonzero(header_mask(words))
    hdr = words[hdr_at]
    lit = (hdr >> 8) == 0xFF
    lit_at = hdr_at[lit]
    if lit_at.size and int(lit_at[-1]) + 2 >= n_words:
        raise ValueError("indexed RLE words do not cover the tile")
    table = np.asarray(table, dtype=np.int32)
    vals = np.empty(hdr.shape[0], np.int32)
    vals[~lit] = table[hdr[~lit] >> 8]
    vals[lit] = words[lit_at + 1] | ((words[lit_at + 2] & 0xFF) << 16)
    lens = (hdr & 0xFF) + 1
    if int(lens.sum()) != h * w:
        raise ValueError("indexed RLE words do not cover the tile")
    # Big-endian 0x00RRGGBB is the bytes 0, R, G, B: repeat whole words,
    # then view the last three bytes of each (a strided (h, w, 3) view).
    flat = np.repeat(vals.astype(">u4"), lens)
    return flat.view(np.uint8).reshape(h, w, 4)[:, :, 1:]
