"""Host-side chunk layout of the render kernel (numpy only).

A jax-free copy of the host half of `osm_renderer_tpu.ops.render_pallas`:
the layout constants, `TileChunks` / `PallasBatch`, `build_tile_chunks`
and its helpers, `concat_pallas_batch`, `build_pallas_batch` and
`planar_to_rgb`, and the arena path's `N_SMALL` / `pack_small_arena`.
The CUDA machine has no jax, so the port cannot import
the original module; the code below is kept line-for-line identical to
it, so both packages render from byte-identical inputs
(tests/test_torch_chunk_layout.py pins that).

The constants are shaped for the TPU kernel (CH = 128 lanes, GROUP = 8,
32-row blocks, IT_CAP, NSEC); the CUDA kernel consumes the layout as it
is.
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import numpy as np

CH = 128          # geometry slots per chunk (= TPU lane width)
RB = 32           # rows per stroke processing block
RB_F = 32         # rows per fill/blend processing block
DS = 4            # dash-profile rows per profile
GROUP = 8         # chunks per TPU grid step (tiles pad to a multiple of
                  # GROUP; at most one pattern index per step).  The
                  # CUDA kernel walks chunks one by one and only needs
                  # the padding to stay byte-identical to the reference.

KIND_PAD = 0
KIND_FILL = 1
KIND_STROKE = 2
KIND_STROKE_SOLID = 3
KIND_STROKE_SOLID_WIDE = 4  # legacy (r2): no longer emitted — wide/thin
                            # routing is now per-segment via item sections
KIND_FILL_IMAGE = 5
KIND_LAYER = 6      # host-rasterized premultiplied layer (src-over of a pattern)
# Dashed strokes whose profiles have no round-cap originals: walk
# aliveness is purely geometric (identical to solid — the chain rule
# only exists because round caps shrink the half-width along the arc),
# so they ride the work-item path with the dash profile evaluated in
# the alpha.  Round-capped dashes keep the per-segment KIND_STROKE path.
KIND_STROKE_DASH = 7
KIND_STROKE_DASH_WIDE = 8   # legacy (r2): no longer emitted
# Solid strokes whose walk starts are all provably alive paint, per
# pixel row, a piecewise-LINEAR alpha in x (the feather is linear in
# the integer cross product, which is linear in x along a row; the
# slab/edge-band rules only clip the row interval).  The host
# rasterizes the exact per-pixel alpha once (kernel-identical f32
# formulas), pre-merges the generation's overlaps with fmax (max of
# linears is piecewise linear) and compresses each row into gradient
# spans (y, x0, x1, a0, da); the kernel paints a whole 128-span chunk
# with ONE f32 coverage matmul per 32-row block — painted-volume-bound
# (~1 span per ~12 painted px) instead of window-bound like the item
# path (DESIGN.md §5 round-5).  Dead-start segments keep the exact
# item path; cross-chunk overlap stays exact because pending is fmax.
KIND_STROKE_SPAN = 9

# Span tolerances.  SPAN_TOL bounds the first-stage linear-piece
# extraction (alpha domain); TOL255 bounds the final per-lane verify in
# the kernel's 255-scaled domain (every emitted lane is checked
# per-pixel against the rasterized truth with the exact f32 expression
# the kernel evaluates, so the served alpha error is <= TOL255/255 +
# 2^-9/255 from the bf16 int/frac matmul split — ~0.03 of a u8 step).
SPAN_TOL = np.float32(2.0 ** -15)
TOL255 = np.float32(2.0 ** -5)
# Row-range merge cap: identical consecutive rows (verticals) collapse
# into one lane covering up to this many rows (bounded so a chunk's
# row-block loop stays local).
SPAN_ROW_MERGE = 32

NSEC = 12         # item section slots per chunk: [0,4) shallow alive
                  # (8x128 windows; subsumes axis-aligned — mn = 0
                  # collapses the general formulas), [4,8) steep alive
                  # (16x64 windows, sub-half bit 14 in the item word),
                  # [8,12) segments with (possibly) dead walk starts
                  # (8x128, full dead-start machinery); within each
                  # family one slot per 128-column half


class PallasBatch(NamedTuple):
    """Flat chunk stream over all tiles; grid = (total chunks,).

    tile_id routes each chunk to its tile's output block; `first` marks
    a tile's first chunk (accumulator init)."""
    geom: np.ndarray        # (Ctot, 4, CH) int32
    traveled: np.ndarray    # (Ctot, 1, CH) f32
    seg_prof: np.ndarray    # (Ctot, 1, CH) int32
    seg_aux: np.ndarray     # (Ctot, 4, CH) f32: inv_denom, ratio, hK, spare
    tile_id: np.ndarray     # (Ctot,) int32
    first: np.ndarray       # (Ctot,) int32
    kind: np.ndarray        # (Ctot,) int32
    cnt: np.ndarray         # (Ctot,) int32
    last: np.ndarray        # (Ctot,) int32
    y0: np.ndarray          # (Ctot,) int32  first row block (in RB units)
    nb: np.ndarray          # (Ctot,) int32  number of row blocks
    prim_y0: np.ndarray     # (Ctot,) int32  blend bbox (in RB units, on last)
    prim_nb: np.ndarray     # (Ctot,) int32
    color: np.ndarray       # (Ctot, 3) f32
    opacity: np.ndarray     # (Ctot,) f32
    hw: np.ndarray          # (Ctot,) f32
    profiles: np.ndarray    # (NP, DS, 8) f32
    profile_total: np.ndarray  # (NP,) f32
    pat: np.ndarray         # (Ctot,) int32  pattern index (-1 = plain color)
    patterns: np.ndarray    # (NPat, 4, ts, ts) f32 premultiplied tiled icons
    items: np.ndarray       # (Ctot, 1, IT) i32 solid-stroke work items
    isec: np.ndarray        # (Ctot, NSEC) i32 cumulative item-section ends


def _f32_bits(x: np.ndarray) -> np.ndarray:
    return x.astype(np.float32).view(np.int32)


def _convert_tile_chunks(s, ts: int):
    """Per-tile chunk list with fill chunks converted to scanline-span
    chunks (draw/spans.py), split at CH spans.  Returns tuples
    (kind, geom(n,4), traveled, profile, last, color, opacity, hw, pat).

    Fill geometry columns become (y, x_from, x_to, 0); membership is
    decided on the host in exact integer arithmetic, the kernel only
    paints (fill.rs:16-47 semantics live in fill_spans)."""
    from osm_renderer_tpu_torch.draw.spans import fill_spans

    out = []
    zero_f = np.zeros(0)
    zero_i = np.zeros(0, dtype=np.int64)
    for ci in range(len(s.chunk_kind)):
        k = s.chunk_kind[ci]
        g = s.geom[ci]
        meta = (s.chunk_color[ci], s.chunk_opacity[ci], s.chunk_hw[ci], s.chunk_pat[ci])
        if k in (KIND_FILL, KIND_FILL_IMAGE):
            if s.chunk_spans and s.chunk_spans[ci]:
                spans = g[:, :3].astype(np.int64)  # pre-extracted
            elif g.shape[0]:
                spans = fill_spans(g, ts).astype(np.int64)
            else:
                spans = np.zeros((0, 3), dtype=np.int64)
            S = spans.shape[0]
            last = s.chunk_last[ci]
            if S == 0:
                out.append((k, np.zeros((0, 4), np.int64), zero_f, zero_i, last) + meta)
                continue
            g4 = np.concatenate([spans, np.zeros((S, 1), np.int64)], axis=1)
            for off in range(0, S, CH):
                end = min(off + CH, S)
                nf = end - off
                out.append(
                    (k, g4[off:end], np.zeros(nf), np.zeros(nf, np.int64),
                     last and end == S) + meta
                )
        else:
            out.append((k, g, s.traveled[ci], s.profile[ci], s.chunk_last[ci]) + meta)
    return out


def next_bucket(n: int, minimum: int = 8) -> int:
    """Quarter-octave size buckets (p, 1.25p, 1.5p, 1.75p, 2p ...): at
    most 12.5% padding with a bounded set of jit signatures per octave
    (vs plain pow2's up-to-2x padding)."""
    v = max(n, minimum)
    p = 1 << max(v.bit_length() - 1, 3)
    if v == p:
        return v
    for num in (5, 6, 7, 8):
        b = (p * num) // 4
        if v <= b:
            return b
    return 2 * p


class TileChunks(NamedTuple):
    """One tile's device-ready chunk arrays.

    Independent of batch composition (chunk indices are tile-local and
    pattern/profile indices come from tables that persist across
    batches), so serving caches these per (tile, zoom, scale) and
    batches become pure concatenation (`concat_pallas_batch`)."""
    geom: np.ndarray      # (c, 4, CH) int32
    trav: np.ndarray      # (c, 1, CH) f32
    sprof: np.ndarray     # (c, 1, CH) int32
    aux: np.ndarray       # (c, 4, CH) f32
    kind: np.ndarray      # (c,) int32
    cnt: np.ndarray       # (c,) int32
    last: np.ndarray      # (c,) int32
    y0: np.ndarray        # (c,) int32
    nb: np.ndarray        # (c,) int32
    prim_y0: np.ndarray   # (c,) int32
    prim_nb: np.ndarray   # (c,) int32
    color: np.ndarray     # (c, 3) f32
    opacity: np.ndarray   # (c,) f32
    hw: np.ndarray        # (c,) f32
    pat: np.ndarray       # (c,) int32
    items: np.ndarray     # (c, 1, IT) i32 solid-stroke work items (-1 pad)
    isec: np.ndarray      # (c, NSEC) i32 cumulative item-section ends

    @property
    def nbytes(self) -> int:
        return sum(a.nbytes for a in self)


RB_I = 8        # rows per shallow/dead stroke work-item window
RB16 = 16       # rows per steep (16, 64) work-item window
IT_CAP = 2048   # max work items per chunk (SMEM staging bound); chunks
                # exceeding it are split (same generation, last on tail)


def _seg_sub_blocks(gi: np.ndarray, m: int, ts: int, colw: int, rowb: int):
    """Per-(segment, column subrange of width `colw`) row-block ranges
    for work items, with `rowb`-row blocks.

    For each subrange the relevant segment portion is x in
    [c0 - m, c0 + colw - 1 + m]; the y-extent of that portion
    (diagonals only touch part of their global y-span inside one
    subrange) gives the block range, conservatively widened by one
    pixel to absorb the f64 interpolation rounding (the C++ assembler
    evaluates the bit-identical expression — native/assembler.cpp
    seg_sub_blocks).

    Returns (b0w, nblkw) int64 arrays of shape (n, ts // colw); a
    non-overlapping or degenerate (point) entry has nblkw == 0."""
    n = gi.shape[0]
    n_sub = ts // colw
    x1, y1, x2, y2 = gi[:, 0], gi[:, 1], gi[:, 2], gi[:, 3]
    nondeg = ~((x1 == x2) & (y1 == y2))
    xa = np.minimum(x1, x2)
    xb = np.maximum(x1, x2)
    ya = np.minimum(y1, y2)
    yb = np.maximum(y1, y2)
    vert = x1 == x2
    dx = x2 - x1
    dy = y2 - y1
    b0w = np.zeros((n, n_sub), dtype=np.int64)
    nblkw = np.zeros((n, n_sub), dtype=np.int64)
    for h in range(n_sub):
        c0 = h * colw
        lo = np.maximum(xa, c0 - m)
        hi = np.minimum(xb, c0 + colw - 1 + m)
        overlap = nondeg & (lo <= hi)
        # y at the clipped x endpoints (exact int64 products, one f64
        # division; +-1 guard absorbs its rounding).
        dxs = np.where(vert, 1, dx)
        y_lo = y1 + (lo - x1) * dy / dxs
        y_hi = y1 + (hi - x1) * dy / dxs
        sel_lo = np.floor(np.minimum(y_lo, y_hi)) - 1
        sel_hi = np.ceil(np.maximum(y_lo, y_hi)) + 1
        sel_lo = np.maximum(sel_lo, ya).astype(np.int64)
        sel_hi = np.minimum(sel_hi, yb).astype(np.int64)
        sel_lo = np.where(vert, ya, sel_lo)
        sel_hi = np.where(vert, yb, sel_hi)
        blo = np.clip(sel_lo - m, 0, ts - 1) // rowb
        bhi = np.clip(sel_hi + m, 0, ts - 1) // rowb
        b0w[:, h] = np.where(overlap, blo, 0)
        nblkw[:, h] = np.where(overlap, bhi - blo + 1, 0)
    return b0w, nblkw


def _seg_half_blocks(gi: np.ndarray, m: int, ts: int):
    """(8-row, 128-col) window ranges — see _seg_sub_blocks."""
    return _seg_sub_blocks(gi, m, ts, 128, RB_I)


def _stroke_item_counts(g: np.ndarray, c_hw: float, ts: int) -> np.ndarray:
    """Per-segment raw work-item count (before section padding),
    matching _stroke_items' window emission: steep alive segments get
    (16-row, 64-col) windows, everything else (8-row, 128-col)."""
    n = g.shape[0]
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    gi = g.astype(np.int64)
    m = int(np.ceil(c_hw)) + 1
    steep = np.abs(gi[:, 3] - gi[:, 1]) > np.abs(gi[:, 2] - gi[:, 0])
    alive = _seg_all_alive(g, c_hw)
    use16 = steep & alive
    _, nblk8 = _seg_sub_blocks(gi, m, ts, 128, RB_I)
    _, nblk16 = _seg_sub_blocks(gi, m, ts, 64, RB16)
    # Steep segments emit whichever shape is cheaper per half (see
    # _stroke_items); the per-seg min lower-bounds either choice, which
    # is what the IT_CAP chunk-split budget needs.
    s8 = nblk8.sum(axis=1)
    return np.where(use16, np.minimum(nblk16.sum(axis=1), s8), s8)


def _seg_alive_exact(x1, y1, x2, y2, mn, mx, den, ft) -> bool:
    """Exact dead-start scan for one segment: enumerate the gap-band
    owner starts (the staircase-skip positions `c(k)+1`; on-line starts
    have |cross| <= (mx-1)/2 so cd < 0.5 and are always alive) and test
    each against the feather cutoff.  Mirrors the kernel's invert()
    owner assignment: gap band in (h(k), h(k+1)) is owned by start
    (c(k)+1, k)."""
    k = np.arange(mx + 1, dtype=np.int64)
    c = (2 * k * mn + mx - 1) // (2 * mx)
    gk = (2 * c * mn + mx - 1) // (2 * mx)
    h = k + gk
    gap = (h[1:] - h[:-1]) == 2
    if not gap.any():
        return True
    ks = k[:-1][gap]
    cs = c[:-1][gap] + 1
    swap = abs(x2 - x1) > abs(y2 - y1)
    mn0 = y1 if swap else x1
    mx0 = x1 if swap else y1
    x_inc = 1 if x1 <= x2 else -1
    y_inc = 1 if y1 <= y2 else -1
    mn_i = y_inc if swap else x_inc
    mx_i = x_inc if swap else y_inc
    s_mn = mn0 + mn_i * cs
    s_mx = mx0 + mx_i * ks
    sx = s_mx if swap else s_mn
    sy = s_mn if swap else s_mx
    cross = (x2 * y1 - y2 * x1) + (y2 - y1) * sx - (x2 - x1) * sy
    cd = np.abs(cross).astype(np.float64) / den
    return bool((cd < ft).all())


def _seg_all_alive(g: np.ndarray, c_hw: float) -> np.ndarray:
    """Per-segment bool: True iff every perpendicular-walk owner start
    is provably alive (center distance < feather_to, with an epsilon
    guard), replicating the reference walk's aliveness rule
    (opacity_calculator.rs feather cutoff) in exact integer cross
    products + f64.  Alive segments ride the invert-free general-alive
    item path; anything uncertain routes to the exact general-dead
    path, so conservatism here costs speed, never parity."""
    n = g.shape[0]
    if n == 0:
        return np.zeros(0, dtype=bool)
    if c_hw <= 0.0:
        # opacity_mul = min(2*hw, 1) == 0: the reference paints nothing;
        # the dead path's alive_at gate reproduces that exactly.
        return np.zeros(n, dtype=bool)
    ft = max(c_hw + 0.5, 1.0) - 1e-6
    gi = g.astype(np.int64)
    x1, y1, x2, y2 = gi[:, 0], gi[:, 1], gi[:, 2], gi[:, 3]
    dx = np.abs(x2 - x1)
    dy = np.abs(y2 - y1)
    mn = np.minimum(dx, dy)
    mx = np.maximum(np.maximum(dx, dy), 1)
    den = np.sqrt((dx * dx + dy * dy).astype(np.float64))
    # No gap bands at all (g(K) = 0, near-axis): on-line starts only.
    gK = (2 * mn * mn + mx - 1) // (2 * mx)
    alive = gK == 0
    # Worst-case gap-start cross is (3*mx - 1)/2 (on-line bound
    # (mx-1)/2 plus the one-step mn shift's mx): if even that is
    # inside the feather, every start is alive.
    alive |= (3 * mx - 1).astype(np.float64) < 2.0 * ft * den
    for i in np.flatnonzero(~alive & (den > 0)):
        alive[i] = _seg_alive_exact(
            int(x1[i]), int(y1[i]), int(x2[i]), int(y2[i]),
            int(mn[i]), int(mx[i]), float(den[i]), ft,
        )
    return alive


def _stroke_span_raster(g: np.ndarray, c_hw: float, c_op: float, ts: int):
    """Exact per-pixel alpha of a generation's alive solid segments,
    fmax-merged into one canvas.

    Every formula is the f32 expression the alive-mode item kernel
    evaluates (eval_group in make_render_kernel), so per-pixel values
    match the item path bit-for-bit: integer cross product -> f32
    feather -> alive-path visited rules (in_slab / edge-band ok_edge).
    Returns (acc (ts, ts) f32, ylo, yhi) with [ylo, yhi] the touched
    row range (ylo > yhi when nothing painted)."""
    acc = np.zeros((ts, ts), dtype=np.float32)
    row_lo, row_hi = ts, -1
    hwf = np.float32(c_hw)
    opf = np.float32(c_op)
    feather_from = np.maximum(hwf - np.float32(0.5), np.float32(0.0))
    feather_to = np.maximum(hwf + np.float32(0.5), np.float32(1.0))
    om = np.minimum(np.float32(2.0) * hwf, np.float32(1.0))
    dfe = feather_to - feather_from
    m = int(np.ceil(c_hw)) + 2
    gi = g.astype(np.int64)
    for s in range(gi.shape[0]):
        x1, y1, x2, y2 = (int(v) for v in gi[s])
        if x1 == x2 and y1 == y2:
            continue  # degenerate: the walk paints nothing
        dx = abs(x2 - x1)
        dy = abs(y2 - y1)
        mn = min(dx, dy)
        mx = max(dx, dy, 1)
        den = np.sqrt(np.float32(dx * dx + dy * dy))
        inv = np.float32(1.0) / np.maximum(den, np.float32(1e-9))
        swap = dx > dy
        mn0, mx0 = (y1, x1) if swap else (x1, y1)
        x_inc = 1 if x1 <= x2 else -1
        y_inc = 1 if y1 <= y2 else -1
        mn_i, mx_i = (y_inc, x_inc) if swap else (x_inc, y_inc)
        nc = x2 * y1 - y2 * x1
        sdx = x2 - x1
        sdy = y2 - y1
        cK = (2 * mx * mn + mx - 1) // (2 * mx)
        gK = (2 * cK * mn + mx - 1) // (2 * mx)
        hK = mx + gK
        ylo = max(min(y1, y2) - m, 0)
        yhi = min(max(y1, y2) + m, ts - 1)
        xlo = max(min(x1, x2) - m, 0)
        xhi = min(max(x1, x2) + m, ts - 1)
        if ylo > yhi or xlo > xhi:
            continue
        ys = np.arange(ylo, yhi + 1, dtype=np.int64)[:, None]
        xs = np.arange(xlo, xhi + 1, dtype=np.int64)[None, :]
        raw = nc + sdy * xs - sdx * ys
        cd = np.abs(raw).astype(np.float32) * inv
        vr = np.where(
            cd < feather_from,
            np.float32(1.0),
            np.where(cd < feather_to, (feather_to - cd) / dfe, np.float32(0.0)),
        )
        op = om * vr
        in_line = op > np.float32(0.0)
        MN = ys if swap else xs
        MX = xs if swap else ys
        n0 = (MN - mn0) * mn_i
        m0 = (MX - mx0) * mx_i
        A = 2 * mn * n0 + 2 * mx * m0 + (mx - 1)
        T = A // (2 * mx)  # int64 floor division (A may be negative)
        edge = (A - T * (2 * mx)) == (2 * mx - 1)
        in_slab = (A >= 0) & (T <= hK)
        ok_edge = (
            (in_slab & (T < hK))
            | ((T == hK) & (n0 >= mn))
            | ((A == -1) & (n0 <= 0))
        )
        visited = in_line & np.where(edge, ok_edge, in_slab)
        v = np.where(visited, opf * op, np.float32(0.0))
        np.maximum(acc[ylo : yhi + 1, xlo : xhi + 1], v,
                   out=acc[ylo : yhi + 1, xlo : xhi + 1])
        row_lo = min(row_lo, ylo)
        row_hi = max(row_hi, yhi)
    return acc, row_lo, row_hi


def _span_plat255(c_hw: float, c_op: float) -> np.float32:
    """The plateau value opacity * opacity_mul * 255 in the exact f32
    order the kernel computes it from its per-chunk scalars."""
    hwf = np.float32(c_hw)
    om = np.minimum(np.float32(2.0) * hwf, np.float32(1.0))
    return np.float32(np.float32(np.float32(c_op) * om) * np.float32(255.0))


def _tent_verify(vals255, x0: int, a: np.float32, b: np.float32,
                 xc: np.float32, plat255: np.float32) -> bool:
    """Per-pixel check of the kernel's f32 tent reconstruction
    max(min(a - b*|x - xc|, plat255), 0) against the rasterized truth
    (255-domain)."""
    xs = np.arange(x0, x0 + vals255.shape[0], dtype=np.int32).astype(np.float32)
    t = a - b * np.abs(xs - xc)
    t = np.maximum(np.minimum(t, plat255), np.float32(0.0))
    return bool((np.abs(t - vals255) <= TOL255).all())


def _emit_run_tents(y: int, x0: int, vals: np.ndarray,
                    plat255: np.float32, out: list) -> None:
    """One maximal nonzero run -> verified tent lanes.

    Stage 1 splits the run into greedy linear pieces (first-difference
    slope, SPAN_TOL in the alpha domain).  Stage 2 merges each
    [rising, plateau?, falling] piece group into ONE clipped tent
    (apex from the f64 intersection of the end lines) when the
    255-domain verify passes; every other piece emits as a one-sided
    tent (xc at the falling end), halved recursively in the (never
    observed) case its verify fails.  Deterministic scalar order —
    mirrored bit-for-bit by native/assembler.cpp."""
    L = vals.shape[0]
    vals255 = vals * np.float32(255.0)
    pieces = []  # (p0 rel, p1 rel, a0, da)
    i = 0
    while i < L:
        if i + 1 == L:
            pieces.append((i, i, vals[i], np.float32(0.0)))
            break
        da = vals[i + 1] - vals[i]
        j = i + 1
        while j + 1 < L:
            pred = vals[i] + da * np.float32(j + 1 - i)
            if abs(vals[j + 1] - pred) > SPAN_TOL:
                break
            j += 1
        pieces.append((i, j, vals[i], da))
        i = j + 1

    def emit_piece(p0: int, p1: int):
        # One-sided tent: a linear piece a0 + da*(x - p0) is the tent
        # a - b*|x - xc| with xc at the high-value end.
        a0 = vals[p0]
        if p1 == p0:
            cand = (np.float32(vals255[p0]), np.float32(0.0),
                    np.float32(x0 + p0))
        else:
            da = vals[p0 + 1] - vals[p0]
            if da <= np.float32(0.0):
                a = a0 * np.float32(255.0)
                b = (-da) * np.float32(255.0)
                xc = np.float32(x0 + p0)
            else:
                a = (a0 + da * np.float32(p1 - p0)) * np.float32(255.0)
                b = da * np.float32(255.0)
                xc = np.float32(x0 + p1)
            cand = (a, b, xc)
        if _tent_verify(vals255[p0 : p1 + 1], x0 + p0, *cand, plat255):
            out.append((y, x0 + p0, x0 + p1) + cand)
        else:  # split and retry (exact at 1 px by construction)
            mid = (p0 + p1) // 2
            emit_piece(p0, mid)
            emit_piece(mid + 1, p1)

    gi = 0
    while gi < len(pieces):
        p = pieces[gi]
        group_end = gi
        if p[3] > np.float32(0.0):
            k = gi + 1
            if k < len(pieces) and pieces[k][3] == np.float32(0.0):
                k += 1  # clipped plateau between the ramps
            if k < len(pieces) and pieces[k][3] < np.float32(0.0):
                group_end = k
        if group_end > gi:
            up = pieces[gi]
            dn = pieces[group_end]
            # Apex = intersection of the two end lines, in f64 (exact
            # enough; verified in f32 below).
            dau = float(up[3])
            dad = float(dn[3])
            xu = float(x0 + up[0])
            xd = float(x0 + dn[0])
            xstar = (float(dn[2]) - dad * xd - float(up[2]) + dau * xu) / (
                dau - dad
            )
            astar = float(up[2]) + dau * (xstar - xu)
            a = np.float32(astar * 255.0)
            b = np.float32(dau * 255.0)
            xc = np.float32(xstar)
            p0 = up[0]
            p1 = dn[1]
            if _tent_verify(vals255[p0 : p1 + 1], x0 + p0, a, b, xc, plat255):
                out.append((y, x0 + p0, x0 + p1, a, b, xc))
                gi = group_end + 1
                continue
        emit_piece(p[0], p[1])
        gi += 1


def _compress_span_rows(acc: np.ndarray, row_lo: int, row_hi: int,
                        plat255: np.float32):
    """Painted canvas -> verified tent lanes with row-range merging.

    Per row, maximal nonzero runs emit tent lanes (_emit_run_tents);
    consecutive rows whose lanes are bit-identical (vertical strokes:
    the per-row computation repeats exactly) merge into one lane
    covering up to SPAN_ROW_MERGE rows.

    Returns (spans (S, 4) int64 rows (y0, y1, xlo, xhi), a (S,) f32,
    b (S,) f32, xc (S,) f32) in row-major emission order (255-domain
    payload)."""
    lanes = []  # [y0, y1, xlo, xhi, a, b, xc] (mutable for the merge)
    prev_row: list = []  # indices into lanes with y1 == previous row
    prev_y = None
    zero = np.float32(0.0)
    for y in range(row_lo, row_hi + 1):
        line = acc[y]
        nz = np.flatnonzero(line > zero)
        if nz.size == 0:
            prev_row = []
            prev_y = None
            continue
        brk = np.flatnonzero(np.diff(nz) > 1)
        starts = np.concatenate(([0], brk + 1))
        ends = np.concatenate((brk, [nz.size - 1]))
        row_out: list = []
        for r0, r1 in zip(starts, ends):
            x0 = int(nz[r0])
            _emit_run_tents(y, x0, line[x0 : int(nz[r1]) + 1], plat255, row_out)
        cur_row = []
        cand = list(prev_row) if prev_y == y - 1 else []
        for lane in row_out:
            yy, xlo, xhi, a, b, xc = lane
            merged = False
            for ci, li in enumerate(cand):
                L = lanes[li]
                if (
                    L[2] == xlo and L[3] == xhi
                    and L[4].tobytes() == a.tobytes()
                    and L[5].tobytes() == b.tobytes()
                    and L[6].tobytes() == xc.tobytes()
                    and (y - L[0]) < SPAN_ROW_MERGE
                ):
                    L[1] = y
                    cur_row.append(li)
                    cand.pop(ci)
                    merged = True
                    break
            if not merged:
                lanes.append([yy, yy, xlo, xhi, a, b, xc])
                cur_row.append(len(lanes) - 1)
        prev_row = cur_row
        prev_y = y
    if not lanes:
        return (
            np.zeros((0, 4), np.int64),
            np.zeros(0, np.float32),
            np.zeros(0, np.float32),
            np.zeros(0, np.float32),
        )
    spans = np.asarray([L[:4] for L in lanes], np.int64)
    a = np.asarray([L[4] for L in lanes], np.float32)
    b = np.asarray([L[5] for L in lanes], np.float32)
    xc = np.asarray([L[6] for L in lanes], np.float32)
    return spans, a, b, xc


# Module flag for A/B benchmarking (tools/, bench comparisons); the
# production default routes alive solid strokes to the span path.
STROKE_SPANS = True

# Per-segment path choice: a segment routes to tent lanes when its
# lane estimate is within SPAN_VS_ITEM x its item-window count.  The
# ratio was tuned for the TPU kernel, where it routes essentially all
# alive solid geometry to lanes; the finite ratio remains as a guard
# for pathological shapes (enormous-hw casings whose rows dwarf their
# window count).  Pure count arithmetic, mirrored bit-for-bit by the
# C++ assembler.
SPAN_VS_ITEM = 32


def _stroke_span_cost_est(g: np.ndarray, c_hw: float, ts: int) -> np.ndarray:
    """Per-segment estimate of emitted tent lanes: ~1 per touched row
    (a run compresses to one clipped tent); vertical segments row-merge
    their (identical) body rows in SPAN_ROW_MERGE blocks, keeping ~2m
    distinct end rows."""
    gi = g.astype(np.int64)
    m = int(np.ceil(c_hw)) + 2
    ylo = np.clip(np.minimum(gi[:, 1], gi[:, 3]) - m, 0, ts - 1)
    yhi = np.clip(np.maximum(gi[:, 1], gi[:, 3]) + m, 0, ts - 1)
    rows = yhi - ylo + 1
    vert = gi[:, 0] == gi[:, 2]
    est = np.where(vert, (rows + SPAN_ROW_MERGE - 1) // SPAN_ROW_MERGE + 2 * m, rows)
    nondeg = ~(vert & (gi[:, 1] == gi[:, 3]))
    return np.where(nondeg, est, 0)


def _route_stroke_spans(chunks, ts: int):
    """Replace each solid KIND_STROKE chunk with gradient-span chunks
    for its provably-alive, span-cheaper segments plus (if any) one
    KIND_STROKE remainder chunk for the rest (dead-start segments and
    item-cheaper alive ones) — same generation, `last` only on the
    final piece.  Cross-piece overlap is exact because the kernel
    merges a generation's chunks with fmax."""
    if not STROKE_SPANS:
        return chunks
    out = []
    for tup in chunks:
        k, g, trav, prof, last = tup[:5]
        meta = tup[5:]
        c_color, c_op, c_hw, c_pat = meta
        n = g.shape[0]
        if k != KIND_STROKE or n == 0:
            out.append(tup)
            continue
        if np.any(np.asarray(prof)[:n]):
            out.append(tup)  # dashed: item / per-segment path
            continue
        alive = _seg_all_alive(g, c_hw)
        span_est = _stroke_span_cost_est(g, c_hw, ts)
        item_est = _stroke_item_counts(g, c_hw, ts)
        span_sel = alive & (span_est <= SPAN_VS_ITEM * item_est)
        acc, rlo, rhi = (
            _stroke_span_raster(g[span_sel], c_hw, c_op, ts)
            if span_sel.any()
            else (None, 0, -1)
        )
        if rhi >= rlo:
            spans, sa, sb, sxc = _compress_span_rows(
                acc, rlo, rhi, _span_plat255(c_hw, c_op)
            )
        else:
            spans = np.zeros((0, 4), np.int64)
            sa = sb = sxc = np.zeros(0, np.float32)
        abc = np.stack([sa, sb, sxc], axis=1)  # (S, 3) trav-slot payload
        rest = ~span_sel
        pieces = []
        # One chunk per CH lanes, full tile width, row-walk order.
        # Dead ends on the TPU kernel: static 128-col
        # half sectioning dropped occupancy ~25%; re-ORDERING lanes by
        # column half (pure, or keyed by 64/128-row superblocks)
        # traded the width-128 window (_derive_col_windows) against an
        # equal-or-larger nb growth — every variant was a wash or
        # worse than row-walk order.  The window still fires on the
        # ~20% of chunks that are naturally x-local (more at @2x).
        S = spans.shape[0]
        for off in range(0, S, CH):
            end = min(off + CH, S)
            pieces.append(
                (KIND_STROKE_SPAN, spans[off:end], abc[off:end],
                 np.zeros(end - off, np.int64))
            )
        if rest.any():
            pieces.append(
                (KIND_STROKE, g[rest], np.asarray(trav)[:n][rest],
                 np.asarray(prof)[:n][rest])
            )
        if not pieces:  # nothing painted and no dead segs: keep an
            # empty span chunk so the generation's `last` still blends.
            pieces.append((KIND_STROKE_SPAN, np.zeros((0, 4), np.int64),
                           abc[:0], np.zeros(0, np.int64)))
        for pi, p in enumerate(pieces):
            is_tail = pi + 1 == len(pieces)
            out.append(p + (last if is_tail else False,) + meta)
    return out


def _emit_windows(seg_ids, b0col, nbcol):
    """Flat item words `sg | (block << 8)` for one column subrange."""
    tot = int(nbcol.sum())
    if not tot:
        return np.zeros(0, dtype=np.int32)
    sg_rep = np.repeat(seg_ids, nbcol)
    starts = np.repeat(b0col, nbcol)
    offs = np.concatenate(([0], np.cumsum(nbcol)[:-1]))
    pos = np.arange(tot, dtype=np.int64) - np.repeat(offs, nbcol)
    return (sg_rep | ((starts + pos) << 8)).astype(np.int32)


def _stroke_items(g: np.ndarray, c_hw: float, ts: int):
    """Work items for a solid (or chain-free dashed) stroke chunk.

    An item is one window that the segment's paint margin can touch.
    Window shape is chosen per segment for lane occupancy — the
    predicates the kernel evaluates (in-line, ownership, aliveness) are
    global geometry, so a window only partitions work; evaluating a
    pixel from any window paints exactly the reference value, which is
    what makes duplicate padding and shape choices output-invariant:

    * shallow alive segments (|dy| <= |dx|, incl. horizontal axis):
      (8-row, 128-col half) windows, `sg | (r8 << 8)`, section slots
      [0, n_halves) — 4 items per (32, 128) vector tile;
    * steep alive segments (|dy| > |dx|, incl. vertical axis):
      (16-row, 64-col) windows, `sg | (r16 << 8) | (sub << 14)` with
      `sub` the 64-col parity inside the 128-half, slots
      [4, 4 + n_halves) — 4 items per (32, 128) tile as 2 row-pairs x
      2 lane-halves (verticals paint ~5 of 128 columns, so half-width
      windows quarter their evaluated pixels);
    * segments with (possibly) dead walk starts: (8, 128) windows in
      slots [8, 8 + n_halves) (full dead-start machinery).

    Axis-aligned segments need no special section: with mn = 0 the
    general ownership math collapses (T = m0, no gap/edge bands) and
    every owner start lies on the line, so _seg_all_alive routes them
    alive and the general-alive formulas reproduce the old axis path
    bit-for-bit.

    Steep sections interleave sub-half lists as group quadruples
    (sub0, sub0, sub1, sub1); a missing side is padded with duplicates
    from the other (safe by the global-predicate argument above).

    Returns (items int32 (IT,), isec int32 (NSEC,) cumulative section
    ends)."""
    n = g.shape[0]
    n_halves = ts // 128
    assert n_halves <= 4, "item path supports ts <= 512"
    isec = np.zeros(NSEC, dtype=np.int32)
    if n == 0:
        return np.zeros(0, dtype=np.int32), isec
    gi = g.astype(np.int64)
    x1, y1, x2, y2 = gi[:, 0], gi[:, 1], gi[:, 2], gi[:, 3]
    m = int(np.ceil(c_hw)) + 1
    b0w8, nblkw8 = _seg_sub_blocks(gi, m, ts, 128, RB_I)
    b0w16, nblkw16 = _seg_sub_blocks(gi, m, ts, 64, RB16)

    steep = np.abs(y2 - y1) > np.abs(x2 - x1)
    alive = _seg_all_alive(g, c_hw)
    cls = np.where(~alive, 2, np.where(steep, 1, 0))
    seg_ids = np.arange(n, dtype=np.int64)

    if int(np.where(cls == 1, nblkw16.sum(axis=1), nblkw8.sum(axis=1)).sum()) == 0:
        return np.zeros(0, dtype=np.int32), isec

    # Per (steep segment, half): the (16, 64) emission pays only when
    # its paired-and-padded cost beats plain (8, 128) windows (a lone
    # street's items all land in one 64-col sub-half, and equalizing the
    # two sub-half lists with duplicates can double them).  The choice
    # is purely count-arithmetic, so the C++ assembler reproduces it
    # bit-for-bit (native/assembler.cpp stroke_items).
    steep_secs = []   # per half: interleaved quadruple array
    spill8 = []       # per half: bool mask of steep segs spilled to (8,128)
    for h in range(n_halves):
        subs = []
        for sub in range(2):
            nb = np.where(cls == 1, nblkw16[:, 2 * h + sub], 0)
            sec_s = _emit_windows(seg_ids, b0w16[:, 2 * h + sub], nb)
            subs.append(sec_s | np.int32(sub << 14))
        L0, L1 = subs
        n_pairs = max((len(L0) + 1) // 2, (len(L1) + 1) // 2)
        cost16 = 4 * n_pairs
        raw8 = int(np.where(cls == 1, nblkw8[:, h], 0).sum())
        if n_pairs and cost16 < raw8:
            fill0 = L0[-1] if len(L0) else L1[-1]
            fill1 = L1[-1] if len(L1) else L0[-1]
            A = np.concatenate(
                [L0, np.full(2 * n_pairs - len(L0), fill0, np.int32)]
            )
            B = np.concatenate(
                [L1, np.full(2 * n_pairs - len(L1), fill1, np.int32)]
            )
            sec = np.empty(4 * n_pairs, np.int32)
            sec[0::4] = A[0::2]
            sec[1::4] = A[1::2]
            sec[2::4] = B[0::2]
            sec[3::4] = B[1::2]
            steep_secs.append(sec)
            spill8.append(False)
        else:
            steep_secs.append(np.zeros(0, dtype=np.int32))
            spill8.append(raw8 > 0)

    parts = []
    end = 0
    for path_cls in range(3):
        slot_base = 4 * path_cls
        for h in range(n_halves):
            if path_cls == 1:
                sec = steep_secs[h]
            else:
                cmask = cls == path_cls
                if path_cls == 0 and spill8[h]:
                    cmask = cmask | (cls == 1)
                nb = np.where(cmask, nblkw8[:, h], 0)
                sec = _emit_windows(seg_ids, b0w8[:, h], nb)
                pad = (-len(sec)) % 4
                if pad:
                    # Pad with DUPLICATES of the last real item: the
                    # kernel emit is an fmax, so re-evaluating an item
                    # is a no-op, and the kernel drops per-group pad
                    # masking.
                    sec = np.concatenate([sec, np.repeat(sec[-1:], pad)])
            parts.append(sec)
            end += len(sec)
            isec[slot_base + h] = end
        # empty high slots keep the running end so [start, end) is empty
        for h in range(n_halves, 4):
            isec[slot_base + h] = end
    return np.concatenate(parts), isec


def _split_big_stroke_chunks(chunks, ts: int, prof_chain_free=None):
    """Split item-path stroke chunks (solid, or chain-free dashed)
    whose work-item total exceeds IT_CAP into several chunks of the
    same generation (last only on the tail)."""
    out = []
    for tup in chunks:
        k, g, trav, prof, last = tup[:5]
        meta = tup[5:]
        c_hw = meta[2]
        if k != KIND_STROKE or g.shape[0] == 0:
            out.append(tup)
            continue
        pr = np.asarray(prof)[: g.shape[0]]
        if np.any(pr) and not (
            prof_chain_free is not None and np.all(prof_chain_free[pr])
        ):
            out.append(tup)
            continue
        counts = _stroke_item_counts(g, c_hw, ts)
        if counts.sum() <= IT_CAP:
            out.append(tup)
            continue
        cum = np.cumsum(counts)
        start = 0
        while start < g.shape[0]:
            base = cum[start - 1] if start else 0
            endi = int(np.searchsorted(cum, base + IT_CAP, side="right"))
            endi = max(endi, start + 1)
            is_tail = endi >= g.shape[0]
            out.append(
                (k, g[start:endi], trav[start:endi], prof[start:endi],
                 last if is_tail else False) + meta
            )
            start = endi
    return out


def build_tile_chunks(stream, ts: int, prof_chain_free=None) -> TileChunks:
    """One TileStream -> device-ready per-tile chunk arrays (fills
    converted to scanline spans, stroke aux scalars precomputed).

    `prof_chain_free`: optional bool array per dash-profile index (True
    = no round-cap originals); chain-free dashed chunks then take the
    work-item path (KIND_STROKE_DASH*).

    An empty stream still yields one PAD chunk so the tile's canvas is
    initialized."""
    chunks = _convert_tile_chunks(stream, ts)
    if ts <= 512:
        chunks = _route_stroke_spans(chunks, ts)
        chunks = _split_big_stroke_chunks(chunks, ts, prof_chain_free)
    n_chunks = max(len(chunks), 1)

    geom = np.zeros((n_chunks, 4, CH), dtype=np.int32)
    trav = np.zeros((n_chunks, 1, CH), dtype=np.float32)
    sprof = np.zeros((n_chunks, 1, CH), dtype=np.int32)
    aux = np.zeros((n_chunks, 4, CH), dtype=np.float32)
    kind = np.zeros((n_chunks,), dtype=np.int32)
    cnt = np.zeros((n_chunks,), dtype=np.int32)
    last = np.zeros((n_chunks,), dtype=np.int32)
    y0 = np.zeros((n_chunks,), dtype=np.int32)
    nb = np.zeros((n_chunks,), dtype=np.int32)
    prim_y0 = np.zeros((n_chunks,), dtype=np.int32)
    prim_nb = np.zeros((n_chunks,), dtype=np.int32)
    color = np.zeros((n_chunks, 3), dtype=np.float32)
    opacity = np.zeros((n_chunks,), dtype=np.float32)
    hw = np.zeros((n_chunks,), dtype=np.float32)
    pat = np.full((n_chunks,), -1, dtype=np.int32)
    item_lists: dict = {}
    isec = np.zeros((n_chunks, NSEC), dtype=np.int32)

    if chunks:
        chunk_meta = []
        for ci in range(n_chunks):
            k, g, _, _, _, _, _, c_hw, _ = chunks[ci]
            n = g.shape[0]
            assert n <= CH, f"chunk of {n} exceeds CH={CH}"
            if k == KIND_STROKE_SPAN:
                # Tent lanes: row range in columns 0 (y0) / 1 (y1).
                ylo = g[:, 0].min() if n else 0
                yhi = g[:, 1].max() if n else 0
            elif k in (KIND_FILL, KIND_FILL_IMAGE):
                # Span chunks: y in column 0.
                ylo = g[:, 0].min() if n else 0
                yhi = g[:, 0].max() if n else 0
            elif k == KIND_LAYER:
                ylo = g[:, [1, 3]].min() if n else 0
                yhi = g[:, [1, 3]].max() if n else 0
            else:
                m = int(np.ceil(c_hw)) + 2
                ylo = (g[:, [1, 3]].min() - m) if n else 0
                yhi = (g[:, [1, 3]].max() + m) if n else 0
            ylo = int(max(min(ylo, ts - 1), 0))
            yhi = int(max(min(yhi, ts - 1), 0))
            b0 = ylo // RB_F
            nblocks = yhi // RB_F - b0 + 1 if n else 0
            chunk_meta.append((b0, nblocks))

        prim_rows = {}
        start = 0
        for ci in range(n_chunks):
            if chunks[ci][4]:
                blocks = [chunk_meta[j] for j in range(start, ci + 1) if chunk_meta[j][1]]
                if blocks:
                    p0 = min(b for b, _ in blocks)
                    pn = max(b + n_ for b, n_ in blocks) - p0
                else:
                    p0, pn = 0, 0
                prim_rows[ci] = (p0, pn)
                start = ci + 1

        for ci in range(n_chunks):
            k, g, c_trav, c_prof, c_last, c_color, c_op, c_hw, c_pat = chunks[ci]
            n = g.shape[0]
            o = ci
            kind[o] = k
            cnt[o] = n
            last[o] = int(c_last)
            y0[o], nb[o] = chunk_meta[ci]
            if c_last:
                prim_y0[o], prim_nb[o] = prim_rows[ci]
            color[o] = c_color
            opacity[o] = c_op
            hw[o] = c_hw
            pat[o] = c_pat
            if n and k in (KIND_FILL, KIND_FILL_IMAGE):
                geom[o, :, :n] = g.T.astype(np.int32)
                # Pad lanes so they cover nothing: no row match and an
                # empty x interval.
                geom[o, 0, n:] = -1
                geom[o, 1, n:] = 1
            elif n and k == KIND_STROKE_SPAN:
                # Tent lanes: geometry (y0, y1, xlo, xhi); (a, b, xc)
                # ride the f32 aux lanes 0..2 (the trav-slot of the
                # routed tuple is the (n, 3) payload), read vectorized
                # by the kernel.  Pad lanes cover no row and an empty
                # x interval.
                geom[o, :, :n] = g.T.astype(np.int32)
                geom[o, 0, n:] = -1
                geom[o, 1, n:] = -2
                geom[o, 2, n:] = 1
                aux[o, 0:3, :n] = np.asarray(c_trav, np.float32).T
            elif n:
                geom[o, :, :n] = g.T.astype(np.int32)
                trav[o, 0, :n] = c_trav
                sprof[o, 0, :n] = c_prof
                if k == KIND_STROKE:
                    # Host-precomputed per-segment scalars (exact in f32
                    # under the coordinate bound): 1/|d|, the staircase
                    # inversion ratio, and h(K) = K + g(K).
                    gi = g.astype(np.int64)
                    dx = np.abs(gi[:, 2] - gi[:, 0])
                    dy = np.abs(gi[:, 3] - gi[:, 1])
                    mn = np.minimum(dx, dy)
                    mx = np.maximum(np.maximum(dx, dy), 1)
                    den = np.sqrt((dx * dx + dy * dy).astype(np.float32))
                    aux[o, 0, :n] = np.where(den > 0, 1.0 / np.maximum(den, 1e-9), 0.0)
                    aux[o, 1, :n] = (mx * mx).astype(np.float32) / (
                        (mx * mx + mn * mn).astype(np.float32)
                    )
                    cK = (2 * mx * mn + mx - 1) // (2 * mx)
                    gK = (2 * cK * mn + mx - 1) // (2 * mx)
                    aux[o, 2, :n] = (mx + gK).astype(np.float32)
                    pr = np.asarray(c_prof)[:n]
                    is_solid = not np.any(pr)
                    is_chain_free_dash = (
                        not is_solid
                        and prof_chain_free is not None
                        and bool(np.all(prof_chain_free[pr]))
                    )
                    if (is_solid or is_chain_free_dash) and ts <= 512:
                        # Solid and chain-free dashed strokes take the
                        # work-item path (4 packed (8, 128) windows per
                        # vector tile); per-SEGMENT routing into the
                        # axis / general-alive / general-dead sections
                        # happens inside _stroke_items (_seg_all_alive),
                        # so there is no per-chunk wide/thin kind split
                        # anymore.
                        kind[o] = KIND_STROKE_SOLID if is_solid else KIND_STROKE_DASH
                        it, sec = _stroke_items(g, c_hw, ts)
                        item_lists[o] = it
                        isec[o] = sec

    it_tile = max([len(v) for v in item_lists.values()] + [4])
    it_tile = -(-it_tile // 4) * 4
    items = np.full((n_chunks, 1, it_tile), -1, dtype=np.int32)
    for o, v in item_lists.items():
        items[o, 0, : len(v)] = v

    return _pad_group(
        TileChunks(
            geom, trav, sprof, aux, kind, cnt, last, y0, nb,
            prim_y0, prim_nb, color, opacity, hw, pat, items, isec,
        )
    )


def _group_align_indices(pat: np.ndarray, group: int) -> List[int]:
    """Order-preserving chunk index list (with -1 pads) whose length is
    a multiple of `group` and where each group-block contains at most
    one distinct pattern index >= 0 (the kernel fetches one pattern
    block per grid step)."""
    idx: List[int] = []
    cur = -1
    for i, p in enumerate(pat.tolist()):
        if len(idx) % group == 0:
            cur = -1
        if p >= 0:
            if cur >= 0 and p != cur:
                while len(idx) % group:
                    idx.append(-1)
                cur = -1
            if cur < 0:
                cur = p
        idx.append(i)
    while len(idx) % group:
        idx.append(-1)
    return idx


def _derive_col_windows(tc: TileChunks) -> TileChunks:
    """Write each fill/span chunk's 128-column window into slot 0 of
    its (item-only, otherwise unused) isec row: 1 + half index when
    every lane's x-interval lands inside one 128-col half of the tile,
    0 for full width.  The kernel branches on this SMEM scalar to run
    the coverage matmuls at width 128 (bench corpus: 93% of fill
    chunks; ~20% of span chunks are naturally x-local, more at @2x —
    re-ordering span lanes to raise that measured worse, see
    _route_stroke_spans).  Derived here, after assembly, so both the
    Python and native assembly paths share one implementation."""
    kind = tc.kind
    sel = (
        (kind == KIND_FILL) | (kind == KIND_FILL_IMAGE)
        | (kind == KIND_STROKE_SPAN)
    )
    if not sel.any():
        return tc
    is_span = kind == KIND_STROKE_SPAN
    xlo = np.where(is_span[:, None], tc.geom[:, 2, :], tc.geom[:, 1, :])
    xhi = np.where(is_span[:, None], tc.geom[:, 3, :], tc.geom[:, 2, :])
    ok = xlo <= xhi  # pad lanes carry the empty interval (1, 0)
    big = np.int64(1) << 30
    xmn = np.where(ok, xlo, big).min(axis=1)
    xmx = np.where(ok, xhi, -1).max(axis=1)
    one = sel & (xmn >= 0) & (xmx >= 0) & ((xmn >> 7) == (xmx >> 7))
    isec = tc.isec.copy()
    isec[:, 0] = np.where(
        one, (xmn >> 7) + 1, np.where(sel, 0, isec[:, 0])
    ).astype(isec.dtype)
    return tc._replace(isec=isec)


def _pad_group(tc: TileChunks, group: int = GROUP) -> TileChunks:
    """Pad a tile's chunk list to a multiple of GROUP with PAD chunks
    (and pattern-align it) so grid steps never straddle tiles."""
    tc = _derive_col_windows(tc)
    idx = _group_align_indices(tc.pat, group)
    if len(idx) == tc.kind.shape[0]:
        return tc
    take = np.array([i if i >= 0 else 0 for i in idx], dtype=np.int64)
    pad_row = np.array([i < 0 for i in idx], dtype=bool)

    def gather(a, pad_value=0):
        out = a[take].copy()
        out[pad_row] = pad_value
        return out

    return TileChunks(
        gather(tc.geom), gather(tc.trav), gather(tc.sprof), gather(tc.aux),
        gather(tc.kind), gather(tc.cnt), gather(tc.last), gather(tc.y0),
        gather(tc.nb), gather(tc.prim_y0), gather(tc.prim_nb),
        gather(tc.color), gather(tc.opacity), gather(tc.hw),
        gather(tc.pat, -1), gather(tc.items, -1), gather(tc.isec),
    )


def concat_pallas_batch(
    tile_chunks: List[TileChunks], profiles, ts: int, patterns=None
) -> PallasBatch:
    """Stack per-tile chunk arrays into one flat batch (pure
    concatenation — the serving path's per-request cost on cache hits).
    The chunk total is bucketed (next_bucket) for stable jit
    signatures; PAD rows route to the last tile's (already resident)
    output block and do nothing."""
    T = len(tile_chunks)
    counts = [c.kind.shape[0] for c in tile_chunks]
    total = sum(counts)
    # Per-tile counts are GROUP-aligned (_pad_group); the global bucket
    # must stay a multiple of GROUP so trailing pads form whole steps.
    # A misaligned tile would let a grid step straddle tiles and render
    # into the wrong output block — fail loudly instead.
    assert all(c % GROUP == 0 for c in counts), (
        f"per-tile chunk counts not GROUP={GROUP}-aligned: {counts}"
    )
    Ctot = -(-next_bucket(max(total, 8), 8) // GROUP) * GROUP
    pad = Ctot - total

    tile_id = np.repeat(np.arange(T, dtype=np.int32), counts)
    if pad:
        tile_id = np.concatenate(
            [tile_id, np.full(pad, max(T - 1, 0), dtype=np.int32)]
        )
    first = np.zeros((Ctot,), dtype=np.int32)
    first[np.concatenate(([0], np.cumsum(counts)[:-1]))] = 1

    def cat(field: str, pad_value=0):
        parts = [getattr(c, field) for c in tile_chunks]
        out = np.concatenate(parts, axis=0)
        if pad:
            widths = [(0, pad)] + [(0, 0)] * (out.ndim - 1)
            out = np.pad(out, widths, constant_values=pad_value)
        return out

    # Work items: per-tile IT widths differ; right-pad every tile's
    # items to the batch maximum.  Bucket to powers of two (min 256) so
    # serving sees a handful of jit signatures, not one per distinct
    # width — each Mosaic compile costs minutes on some hosts.  Padding
    # beyond isec[NSEC-1] is never read by the kernel, so wider buckets cost
    # only the (DMA-ed, tiny) dead lanes.
    IT = max(c.items.shape[2] for c in tile_chunks)
    IT = max(256, 1 << (IT - 1).bit_length())
    item_parts = [
        c.items
        if c.items.shape[2] == IT
        else np.pad(
            c.items, ((0, 0), (0, 0), (0, IT - c.items.shape[2])),
            constant_values=-1,
        )
        for c in tile_chunks
    ]
    items = np.concatenate(item_parts, axis=0)
    if pad:
        items = np.pad(items, ((0, pad), (0, 0), (0, 0)), constant_values=-1)

    prof_rows, prof_totals = profiles.arrays(np.float32)
    if patterns is not None and patterns.tiles:
        pat_arr = patterns.array()
    else:
        pat_arr = np.zeros((1, 4, ts, ts), dtype=np.float32)
    return PallasBatch(
        cat("geom"), cat("trav"), cat("sprof"), cat("aux"),
        tile_id, first,
        cat("kind"), cat("cnt"), cat("last"), cat("y0"), cat("nb"),
        cat("prim_y0"), cat("prim_nb"), cat("color"), cat("opacity"),
        cat("hw"), prof_rows, prof_totals, cat("pat", -1), pat_arr,
        items, cat("isec"),
    )


def build_pallas_batch(
    tile_streams, profiles, ts: int, patterns=None, dash_items: bool = True
) -> PallasBatch:
    """Convert TileStream chunk lists into the flat chunk-aligned layout
    (no per-tile padding).  Fill chunks are converted to scanline-span
    chunks (see _convert_tile_chunks).

    `patterns` is an optional PatternTable (draw/primitives.py) holding
    the batch's tiled fill-image icons; chunk kind KIND_FILL_IMAGE
    references it by index.  `dash_items=False` keeps chain-free dashes
    on the per-segment KIND_STROKE path (test harness for comparing the
    two implementations)."""
    mask = profiles.chain_free_mask() if dash_items else None
    return concat_pallas_batch(
        [build_tile_chunks(s, ts, mask) for s in tile_streams],
        profiles, ts, patterns,
    )


def planar_to_rgb(planar: np.ndarray) -> np.ndarray:
    """(T, 4, ts, ts) u8 host array -> contiguous (T, ts, ts, 3)."""
    return np.ascontiguousarray(planar[:, :3].transpose(0, 2, 3, 1))


# ---------------------------------------------------------------------------
# Arena path (parallel/arena.py): warm serving uploads ONE small packed
# buffer per batch; the big per-chunk fields stay device-resident and the
# render jit assembles the batch with a row gather.
# ---------------------------------------------------------------------------

N_SMALL = 16 + NSEC  # i32 lanes in the packed small-field buffer


def pack_small_arena(
    tile_chunks: List[TileChunks], offsets: List[Tuple[int, int]]
) -> np.ndarray:
    """Host side of a warm batch: per-chunk scalars + arena gather rows
    packed into one (N_SMALL, C) i32 buffer.  Lane layout:

      0 tile_id  1 first  2 kind  3 cnt  4 last  5 y0  6 nb
      7 prim_y0  8 prim_nb  9 pat  10-12 color rgb (f32 bits)
      13 opacity (f32 bits)  14 hw (f32 bits)  15 gather row
      16.. isec (NSEC lanes)

    Mirrors concat_pallas_batch's bucketing/padding exactly (pads:
    kind=KIND_PAD, pat=-1, tile_id=last tile, gather row 0 = the
    arena's reserved zero row)."""
    T = len(tile_chunks)
    counts = [c.kind.shape[0] for c in tile_chunks]
    total = sum(counts)
    assert all(c % GROUP == 0 for c in counts), (
        f"per-tile chunk counts not GROUP={GROUP}-aligned: {counts}"
    )
    Ctot = -(-next_bucket(max(total, 8), 8) // GROUP) * GROUP

    packed = np.zeros((N_SMALL, Ctot), np.int32)
    packed[9] = -1  # pat pad
    pos = 0
    for ti, (c, (off, n)) in enumerate(zip(tile_chunks, offsets)):
        e = pos + n
        packed[0, pos:e] = ti
        packed[1, pos] = 1
        packed[2, pos:e] = c.kind
        packed[3, pos:e] = c.cnt
        packed[4, pos:e] = c.last
        packed[5, pos:e] = c.y0
        packed[6, pos:e] = c.nb
        packed[7, pos:e] = c.prim_y0
        packed[8, pos:e] = c.prim_nb
        packed[9, pos:e] = c.pat
        packed[10:13, pos:e] = np.ascontiguousarray(
            c.color.astype(np.float32).T
        ).view(np.int32)
        packed[13, pos:e] = c.opacity.astype(np.float32).view(np.int32)
        packed[14, pos:e] = c.hw.astype(np.float32).view(np.int32)
        packed[15, pos:e] = np.arange(off, off + n, dtype=np.int32)
        packed[16:, pos:e] = c.isec.astype(np.int32).T
        pos = e
    if pos < Ctot:
        packed[0, pos:] = max(T - 1, 0)
    return packed
