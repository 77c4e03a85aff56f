"""Least device time of the render kernel and of the wire kernel.

Frozen copies of `chip_smoke.py::render_bound`'s byte rule and of its
wire bytes (phase 4), so that the roofline shares cannot change with
the program.  The layout constants are the chunk layout's
(`ops/chunk_layout.py`, `ops/render_cuda.py`, `ops/rle_layout.py`) as
this benchmark was written; a program that changes its layout reads a
different share here, which is what a roofline of a fixed rule should
show.  The peaks are NVIDIA's data sheet for the H100 SXM.
"""

from __future__ import annotations

import numpy as np

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

# Chunk kinds and layout sizes.
KIND_PAD, KIND_FILL, KIND_STROKE, KIND_STROKE_SOLID = 0, 1, 2, 3
KIND_FILL_IMAGE, KIND_STROKE_DASH, KIND_STROKE_SPAN = 5, 7, 9
CH, DS, NSEC = 128, 4, 12
NCI, NCF = 9, 5
PAL_CAP = 255

# Lanes of the arena entry's packed small-field buffer.
P_KIND, P_CNT, P_LAST, P_PRIM_Y0, P_PRIM_NB, P_PAT, P_ROW, P_ISEC = 2, 3, 4, 7, 8, 9, 15, 16

# Bytes of one live lane that each kind reads (geom rows, aux rows,
# trav, sprof; 4 bytes each).
LANE_BYTES = {KIND_FILL: 12, KIND_FILL_IMAGE: 12, KIND_STROKE_SPAN: 28,
              KIND_STROKE_SOLID: 32, KIND_STROKE_DASH: 36, KIND_STROKE: 36}


def profiled_lanes(packed: np.ndarray):
    """(arena rows, live-lane mask) of the chunks whose lanes name a
    dash profile: the rows of `sprof` the byte rule has to look at."""
    kind, cnt = packed[P_KIND], packed[P_CNT].astype(np.int64)
    sel = np.isin(kind, (KIND_STROKE, KIND_STROKE_DASH))
    live = np.arange(CH)[None, :] < cnt[sel][:, None]
    return packed[P_ROW][sel], live


def render_bound_s(packed: np.ndarray, used_profiles: int, ts: int, n_tiles: int,
                   label_rows: int = 0) -> float:
    """Least seconds of one arena render launch: the larger of the bytes
    this batch needs (each input byte read once, the u8 planar output
    written once) over the HBM peak and of its blend and finalize
    operations over the f32 peak.  `packed`: the (N_SMALL, C) buffer;
    `used_profiles`: distinct dash profiles its profiled lanes name;
    `label_rows`: slab rows the label epilogue reads."""
    kind, cnt = packed[P_KIND], packed[P_CNT].astype(np.int64)
    C, T = kind.shape[0], int(n_tiles)
    nbytes = 4 * NCI * C + 4 * NCF * int((kind != KIND_PAD).sum())
    nbytes += 4 * 3 + 4 * 2 * T + T * 4 * ts * ts
    for k, w in LANE_BYTES.items():
        nbytes += w * int(cnt[kind == k].sum())
    windowed = np.isin(kind, (KIND_FILL, KIND_FILL_IMAGE, KIND_STROKE_SPAN))
    nbytes += 4 * int(windowed.sum())
    itemized = np.isin(kind, (KIND_STROKE_SOLID, KIND_STROKE_DASH))
    nbytes += 4 * NSEC * int(itemized.sum()) + 4 * int(packed[P_ISEC + NSEC - 1][itemized].sum())
    nbytes += int(used_profiles) * 4 * (DS * 8 + 1)
    last = (packed[P_LAST] == 1) & (kind != KIND_PAD)
    pat = packed[P_PAT]
    for q in np.unique(pat[last & (pat >= 0)]):
        blocks = set()
        m = last & (pat == q)
        for y0, nb in zip(packed[P_PRIM_Y0][m], packed[P_PRIM_NB][m]):
            blocks.update(range(int(y0), int(y0) + int(nb)))
        nbytes += len(blocks) * 32 * ts * 4 * 4
    nbytes += int(label_rows) * 2 * ts * 4
    blend_px = int(packed[P_PRIM_NB][last].clip(min=0).sum()) * 32 * ts
    ops = 8 * blend_px + 7 * T * ts * ts
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S)


def wire_bound_s(fmt: str, n_tiles: int, ts: int, live_words: int) -> float:
    """Least seconds of one wire launch: the RGB planes in (and the
    palette, v2), the live wire out.  `live_words`: v2 16-bit words or
    v1 runs."""
    rgb = 3 * int(n_tiles) * ts * ts
    if fmt == "v2":
        out = 4 * (3 + n_tiles + PAL_CAP) + 2 * int(live_words)
        return (rgb + 4 * PAL_CAP + out) / HBM_BYTES_PER_S
    return (rgb + 4 * (2 + n_tiles + int(live_words))) / HBM_BYTES_PER_S
