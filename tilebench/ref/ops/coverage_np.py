"""Dense per-pixel coverage evaluation — numpy float64 reference.

This module re-expresses the reference renderer's *sequential* rasterize
loops (scanline fill, Murphy thick-line walk) as **closed-form dense
per-pixel formulas** suitable for data-parallel evaluation on TPU.  The
numpy implementation here is the f64/int64 "device reference": it is
pixel-parity-validated against the C++ oracle (native/oracle.cpp) and
serves as the blueprint for the jnp/Pallas kernels.

Key derivations (validated exhaustively in tests):

Fill (fill.rs): the symmetric Bresenham edge walk visits, for a shallow
edge (adx >= ady), pixels (x1 + sx*i, y1 + sy*floor((2*i*ady + adx) /
(2*adx)))) and for a steep edge one pixel per row at
x1 + sx*floor((2*j*adx + ady)/(2*ady)).  Per row this yields a span
[a_e(y), b_e(y)]; the top row of every edge is "poisoned" (excluded).
The reference sorts a row's edges by x_min and fills [a_2k, b_{2k+1}]
pairwise; equivalently a pixel is filled iff

    odd(N) and not (N == n_active and odd(n_active))   # parity bands
    or exists odd-rank edge j with a_j <= x <= b_j     # b-extension

where N = #{edges with a_e <= x} and rank is the stable sort index.

Stroke (line.rs): the thick-line walk tiles a slab with discrete
perpendiculars (main ones per major step k with phase p_error_k, plus
gap fillers).  With
    c_k = floor((2k*mn + mx - 1)/(2mx))            # minor progress
    g_k = floor((2*c_k*mn + mx - 1)/(2mx))         # p_error corrections
    h_k = k + g_k                                  # band index staircase
    pe_k = 2*c_k*mn - 2*g_k*mx                     # p_error at step k
a pixel at (major, minor) offsets (m0, n0) from p1 has band functional
A = 2*mn*n0 + 2*mx*m0 + mx - 1 and lives in band T = floor(A / (2mx))
(with pixels at A = -1 mod 2mx belonging to band T+1 via the mul=-1
branch).  The pixel is visited iff its band's owner perpendicular
(main k with h_k == T, else the gap perp between k and k+1) has a
*live* start pixel (is_in_line holds there) — this reproduces the
walk's early-stop dropouts on thin lines exactly.

Per-pixel opacity replicates opacity_calculator.rs: min(dash profile
along arc length, 0.5px feather by exact perpendicular distance), with
round caps shrinking the effective half-width by the circle equation.
Rust's f64::min/max ignore NaN, hence np.fmin/np.fmax throughout.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

LINE_CAP_BUTT = 0
LINE_CAP_ROUND = 1
LINE_CAP_SQUARE = 2


# --------------------------------------------------------------------------
# Dash profile preprocessing (host side; opacity_calculator.rs:98-143)
# --------------------------------------------------------------------------

@dataclass
class DashProfile:
    # (DS, 8) rows: start_from, start_to, end_from, end_to, opacity_mul,
    #              has_original, orig_a, orig_b
    segments: np.ndarray
    total_len: float

    @property
    def empty(self) -> bool:
        return self.segments.shape[0] == 0


def compute_dash_profile(
    half_width: float, dashes: Optional[List[float]], cap: int
) -> DashProfile:
    if dashes is None:
        return DashProfile(np.zeros((0, 8), dtype=np.float64), 0.0)
    rows = []
    total = 0.0
    n = len(dashes)
    for pass_i in range(n + (1 if n > 0 else 0)):
        idx = pass_i if pass_i < n else 0
        dash = dashes[idx]
        start = total
        if idx != 0 or not rows:
            total += dash
        if idx % 2 != 0:
            continue
        end = start + dash
        has_orig = 1.0 if cap == LINE_CAP_ROUND else 0.0
        orig_a, orig_b = start, end
        if cap in (LINE_CAP_ROUND, LINE_CAP_SQUARE):
            start -= half_width
            end += half_width
        mid = (start + end) / 2.0
        rows.append([
            min(start - 0.5, mid - 1.0),
            min(start + 0.5, mid),
            max(end - 0.5, mid),
            max(end + 0.5, mid + 1.0),
            min(end - start, 1.0),
            has_orig, orig_a, orig_b,
        ])
    return DashProfile(np.asarray(rows, dtype=np.float64).reshape(-1, 8), total)


# --------------------------------------------------------------------------
# Stroke opacity field (dense form of OpacityCalculator::calculate)
# --------------------------------------------------------------------------

def _opacity_by_center_distance(cd, hlw):
    feather_from = np.fmax(hlw - 0.5, 0.0)
    feather_to = np.fmax(hlw + 0.5, 1.0)
    feather_dist = feather_to - feather_from
    opacity_mul = np.fmin(2.0 * hlw, 1.0)
    v = np.where(
        cd < feather_from,
        1.0,
        np.where(cd < feather_to, (feather_to - cd) / feather_dist, 0.0),
    )
    return opacity_mul * v


def stroke_opacity(cd, start_dist, half_width: float, profile: DashProfile, traveled: float):
    """Per-pixel (opacity, is_in_line) given exact center distance `cd`
    and mirrored start distance `start_dist` (arrays)."""
    if profile.empty:
        sd_op = np.ones_like(cd)
        cap_dist = np.zeros_like(cd)
    else:
        dist_rem = traveled + start_dist
        if profile.total_len > 0.0:
            dist_rem = np.fmod(dist_rem, profile.total_len)
        segs = profile.segments  # (DS, 8)
        d = dist_rem[..., None]  # (..., DS)
        s_from, s_to = segs[:, 0], segs[:, 1]
        e_from, e_to = segs[:, 2], segs[:, 3]
        mul, has_orig = segs[:, 4], segs[:, 5]
        orig_a, orig_b = segs[:, 6], segs[:, 7]

        in_range = (d >= s_from) & (d <= e_to)
        # Ramp widths are exactly 1.0 by construction, so no div-by-zero.
        ramp_in = (d - s_from) / (s_to - s_from)
        ramp_out = (e_to - d) / (e_to - e_from)
        base = np.where(d <= s_to, ramp_in, np.where(d < e_from, 1.0, ramp_out))
        # `opacity` starts at 0.0 and takes the max over in-range dashes.
        sd_op = np.max(np.where(in_range, mul * base, 0.0), axis=-1)

        cap_d = np.where(d < orig_a, orig_a - d, np.where(d <= orig_b, 0.0, d - orig_b))
        cap_valid = in_range & (has_orig > 0.0)
        cap_dist = np.min(np.where(cap_valid, cap_d, np.inf), axis=-1)
        cap_dist = np.where(np.isinf(cap_dist), 0.0, cap_dist)

    with np.errstate(invalid="ignore"):
        hlw = np.sqrt(half_width * half_width - cap_dist * cap_dist)
    cd_op = _opacity_by_center_distance(cd, hlw)
    return np.fmin(sd_op, cd_op), cd_op > 0.0


# --------------------------------------------------------------------------
# Stroke slab/ownership membership (dense form of the Murphy walk)
# --------------------------------------------------------------------------

def stroke_segment_alpha(
    p1: Tuple[int, int],
    p2: Tuple[int, int],
    half_width: float,
    opacity: float,
    profile: DashProfile,
    traveled: float,
    ts: int,
) -> Optional[Tuple[np.ndarray, Tuple[int, int, int, int]]]:
    """Alpha field of one stroked segment over the tile [0, ts)^2.

    Returns (alpha block, (x0, y0, w, h)) for the segment's clipped
    bbox, or None if it cannot touch the tile.  Alpha includes the
    `opacity * op(pixel)` factor (color premultiplication happens at
    blend time).
    """
    p1x, p1y = p1
    p2x, p2y = p2
    if p1 == p2:
        return None

    margin = int(np.ceil(half_width)) + 2
    bx0 = max(min(p1x, p2x) - margin, 0)
    bx1 = min(max(p1x, p2x) + margin, ts - 1)
    by0 = max(min(p1y, p2y) - margin, 0)
    by1 = min(max(p1y, p2y) + margin, ts - 1)
    if bx0 > bx1 or by0 > by1:
        return None

    px = np.arange(bx0, bx1 + 1, dtype=np.int64)[None, :]
    py = np.arange(by0, by1 + 1, dtype=np.int64)[:, None]

    dx = abs(p2x - p1x)
    dy = abs(p2y - p1y)
    swap = dx > dy
    if swap:
        mn0, mx0 = p1y, p1x
        mn_d, mx_d = dy, dx
    else:
        mn0, mx0 = p1x, p1y
        mn_d, mx_d = dx, dy
    x_inc = 1 if p1x <= p2x else -1
    y_inc = 1 if p1y <= p2y else -1
    mn_i, mx_i = (y_inc, x_inc) if swap else (x_inc, y_inc)

    # Exact center/start distances (line.rs:102-121).
    numer_const = p2x * p1y - p2y * p1x
    sdx, sdy = p2x - p1x, p2y - p1y
    denom = np.sqrt(float(dx * dx + dy * dy))
    raw = numer_const + sdy * px - sdx * py
    cd = np.abs(raw.astype(np.float64)) / denom
    dxp = (px - p1x).astype(np.float64)
    dyp = (py - p1y).astype(np.float64)
    # Reference computes long = sqrt(dx^2+dy^2) and then squares it again
    # (line.rs:120-121); replicate that rounding chain exactly.
    long_d = np.sqrt(dxp * dxp + dyp * dyp)
    start_dist = np.sqrt(np.fmax(long_d * long_d - cd * cd, 0.0))

    op, in_line = stroke_opacity(cd, start_dist, half_width, profile, traveled)

    # Band functional and owner inversion.
    MN = py if swap else px
    MX = px if swap else py
    n0 = (MN - mn0) * mn_i
    m0 = (MX - mx0) * mx_i
    A = 2 * mn_d * n0 + 2 * mx_d * m0 + (mx_d - 1)
    two_mx = 2 * mx_d
    T = A // two_mx
    r = A - T * two_mx
    edge_band = r == two_mx - 1

    def c_of(k):
        return (2 * k * mn_d + mx_d - 1) // two_mx

    def g_of(k):
        return (2 * c_of(k) * mn_d + mx_d - 1) // two_mx

    def h_of(k):
        return k + g_of(k)

    K = mx_d
    hK = h_of(K)

    def band_start(b):
        """Vectorized: start pixel (mn, mx) of the perp owning band b.
        Caller masks invalid bands."""
        bc = np.clip(b, 0, hK)
        # Float estimate (overflow-safe) + staircase adjustment.
        ratio = float(mx_d) * float(mx_d) / (float(mx_d) * mx_d + float(mn_d) * mn_d)
        k = (bc.astype(np.float64) * ratio).astype(np.int64)
        k = np.clip(k, 0, K)
        # staircase inversion: adjust k so h(k) <= b < h(k+1)
        for _ in range(6):
            k = np.where((k > 0) & (h_of(k) > bc), k - 1, k)
        for _ in range(6):
            k = np.where((k < K) & (h_of(k + 1) <= bc), k + 1, k)
        is_gap = h_of(k) != bc
        c_sel = np.where(is_gap, c_of(k + 1), c_of(k))
        s_mn = mn0 + mn_i * c_sel
        s_mx = mx0 + mx_i * k
        return s_mn, s_mx, c_sel

    def start_alive(s_mn, s_mx):
        s_x = np.where(swap, s_mx, s_mn)
        s_y = np.where(swap, s_mn, s_mx)
        raw_s = numer_const + sdy * s_x - sdx * s_y
        cd_s = np.abs(raw_s.astype(np.float64)) / denom
        dxs = (s_x - p1x).astype(np.float64)
        dys = (s_y - p1y).astype(np.float64)
        long_s = np.sqrt(dxs * dxs + dys * dys)
        sd_s = np.sqrt(np.fmax(long_s * long_s - cd_s * cd_s, 0.0))
        _, alive = stroke_opacity(cd_s, sd_s, half_width, profile, traveled)
        return alive

    in_slab = (A >= 0) & (T <= hK)

    # The walk stops a perpendicular at its FIRST not-in-line pixel
    # (oracle DrawThickLine / line.rs:125-127).  For solid strokes (and
    # non-round dash caps) in_line is monotone along the perpendicular,
    # so owner-start aliveness is exact.  Round caps on dashes shrink
    # the effective half-width as a function of start-distance, which
    # drifts along the staircase perpendicular — so every intermediate
    # perpendicular pixel must be in-line too.  Their positions are in
    # closed form: step j of branch `mul` from start (s_mn, s_mx) with
    # phase pe sits at minor s_mn + mul*mn_i*j and major
    # s_mx - mul*mx_i*C(j), C(j) = max(0, ceil((mul*pe + 2j*mn - mx)/2mx)),
    # pe = 2c*mn - 2mx*Gamma(c), Gamma(c) = C(c) with pe=0 (validated
    # exhaustively against the walk).
    needs_chain = (not profile.empty) and bool(np.any(profile.segments[:, 5] > 0))

    def gamma_of(c):
        return np.maximum(0, -((-(2 * c * mn_d - mx_d)) // two_mx))

    def chain_alive(s_mn, s_mx, c_sel, mul, j):
        if not needs_chain:
            return True
        pe = 2 * c_sel * mn_d - two_mx * gamma_of(c_sel)
        e0 = mul * pe
        # Perp minor-steps until out-of-line: up to (hw+0.5)/cos(angle),
        # worst case sqrt(2) for diagonal segments.
        jmax = int(np.ceil(max(half_width + 0.5, 1.0) * 1.4143)) + 2
        ok = np.ones(np.broadcast(s_mn, s_mx).shape, dtype=bool)
        for jp in range(1, jmax):
            mask = jp < j
            if not np.any(mask):
                break
            Cjp = np.maximum(0, -((-(e0 + 2 * jp * mn_d - mx_d)) // two_mx))
            minor = s_mn + mul * mn_i * jp
            major = s_mx - mul * mx_i * Cjp
            ok &= np.where(mask, start_alive(minor, major), True)
        return ok

    s_mn_T, s_mx_T, c_sel_T = band_start(T)
    dn_T = (MN - s_mn_T) * mn_i
    mul_T = np.where(dn_T >= 0, 1, -1)
    ok_T = (
        in_slab
        & start_alive(s_mn_T, s_mx_T)
        & chain_alive(s_mn_T, s_mx_T, c_sel_T, mul_T, np.abs(dn_T))
    )
    # Band-edge pixels may instead belong to band T+1 via its mul=-1 branch.
    if np.any(edge_band):
        s_mn_N, s_mx_N, c_sel_N = band_start(T + 1)
        dn_N = (MN - s_mn_N) * mn_i
        ok_T = ok_T & np.where(edge_band, dn_T >= 0, True)
        ok_N = (
            edge_band
            & (A + 1 >= 0)
            & (T + 1 <= hK)
            & (dn_N <= 0)
            & start_alive(s_mn_N, s_mx_N)
            & chain_alive(s_mn_N, s_mx_N, c_sel_N, -1, -dn_N)
        )
        visited = in_line & (ok_T | ok_N)
    else:
        visited = in_line & ok_T

    alpha = np.where(visited, opacity * op, 0.0)
    return alpha, (bx0, by0, bx1 - bx0 + 1, by1 - by0 + 1)


# --------------------------------------------------------------------------
# Fill coverage (dense form of fill_contour)
# --------------------------------------------------------------------------

def _ceil_div(a, b):
    return -((-a) // b)


def fill_edge_spans(edges: np.ndarray, ts: int):
    """Per-(edge, row) spans of the Bresenham-walked contour edges.

    edges: int64 (E, 4) of (x1, y1, x2, y2).
    Returns (active (E, ts) bool, a (E, ts) int64, b (E, ts) int64)
    where [a, b] is the edge's x-extent on that row; rows outside
    (top_row, bottom_row] are inactive (the poisoned-vertex rule).
    """
    E = edges.shape[0]
    x1 = edges[:, 0][:, None]
    y1 = edges[:, 1][:, None]
    x2 = edges[:, 2][:, None]
    y2 = edges[:, 3][:, None]
    ys = np.arange(ts, dtype=np.int64)[None, :]

    adx = np.abs(x2 - x1)
    ady = np.abs(y2 - y1)
    sx = np.where(x1 < x2, 1, -1)
    sy = np.where(y1 < y2, 1, -1)

    ytop = np.minimum(y1, y2)
    ybot = np.maximum(y1, y2)
    active = (ys > ytop) & (ys <= ybot)

    j = np.abs(ys - y1)

    # Steep: one pixel per row.
    with np.errstate(divide="ignore", invalid="ignore"):
        steep_x = x1 + sx * ((2 * j * adx + ady) // np.maximum(2 * ady, 1))

    # Shallow: contiguous column run [i_min, i_max] mapping to this row.
    ady_nz = np.maximum(ady, 1)
    i_min = _ceil_div(adx * (2 * j - 1), 2 * ady_nz)
    i_max = _ceil_div(adx * (2 * j + 1), 2 * ady_nz) - 1
    i_min = np.clip(i_min, 0, adx)
    i_max = np.clip(i_max, 0, adx)
    sh_lo = x1 + sx * i_min
    sh_hi = x1 + sx * i_max
    sh_a = np.minimum(sh_lo, sh_hi)
    sh_b = np.maximum(sh_lo, sh_hi)

    steep = ady > adx
    a = np.where(steep, steep_x, sh_a)
    b = np.where(steep, steep_x, sh_b)
    return active, a, b


def fill_alpha(edges: np.ndarray, fill_opacity: float, ts: int) -> np.ndarray:
    """Dense (ts, ts) coverage alpha of one fill contour."""
    edges = np.asarray(edges, dtype=np.int64)
    if edges.shape[0] == 0:
        return np.zeros((ts, ts), dtype=np.float64)
    active, a, b = fill_edge_spans(edges, ts)  # (E, ts)
    E = edges.shape[0]

    # Stable rank of each active edge within its row, by (a, edge index):
    # argsort is stable, so equal a's keep edge order.
    a_masked = np.where(active, a, np.iinfo(np.int64).max)
    order = np.argsort(a_masked, axis=0, kind="stable")  # (E, ts)
    rank = np.empty_like(order)
    np.put_along_axis(rank, order, np.arange(E, dtype=order.dtype)[:, None], axis=0)
    odd_rank = active & (rank % 2 == 1)

    n_active = active.sum(axis=0)  # (ts,)

    # N(x) = #active edges with a <= x, per row, via delta + cumsum.
    rows = np.broadcast_to(np.arange(ts, dtype=np.int64)[None, :], (E, ts))
    start_delta = np.zeros((ts, ts + 1), dtype=np.int64)
    sel = active & (a < ts)
    np.add.at(start_delta, (rows[sel], np.maximum(a[sel], 0)), 1)
    N = np.cumsum(start_delta[:, :ts], axis=1)
    parity = (N % 2 == 1) & ~(
        (N == n_active[:, None]) & (n_active[:, None] % 2 == 1)
    )

    # Tail: union of odd-rank [a, b] intervals, via interval deltas.
    tail_delta = np.zeros((ts, ts + 1), dtype=np.int64)
    tsel = odd_rank & (a < ts) & (b >= 0)
    np.add.at(tail_delta, (rows[tsel], np.maximum(a[tsel], 0)), 1)
    np.add.at(tail_delta, (rows[tsel], np.minimum(b[tsel], ts - 1) + 1), -1)
    tail = np.cumsum(tail_delta[:, :ts], axis=1) > 0

    filled = parity | tail
    return np.where(filled, fill_opacity, 0.0)


# --------------------------------------------------------------------------
# Full-primitive helpers
# --------------------------------------------------------------------------

def polyline_stroke_alpha(
    pairs: np.ndarray,
    half_width: float,
    opacity: float,
    dashes: Optional[List[float]],
    cap: int,
    use_caps_for_dashes: bool,
    ts: int,
) -> np.ndarray:
    """Alpha field for a whole polyline (line.rs draw_lines): max over
    its segments plus outer cap segments, with dash continuity."""
    pairs = np.asarray(pairs, dtype=np.int64)
    alpha = np.zeros((ts, ts), dtype=np.float64)
    cap_for_dashes = cap if use_caps_for_dashes else LINE_CAP_BUTT
    profile = compute_dash_profile(half_width, dashes, cap_for_dashes)
    outer_profile = compute_dash_profile(half_width, [0.0], cap)
    has_caps = cap in (LINE_CAP_ROUND, LINE_CAP_SQUARE)

    def accum(block_info):
        if block_info is None:
            return
        block, (x0, y0, w, h) = block_info
        region = alpha[y0 : y0 + h, x0 : x0 + w]
        np.fmax(region, block, out=region)

    traveled = 0.0
    n = pairs.shape[0]
    for i in range(n):
        p1 = (int(pairs[i, 0]), int(pairs[i, 1]))
        p2 = (int(pairs[i, 2]), int(pairs[i, 3]))
        accum(stroke_segment_alpha(p1, p2, half_width, opacity, profile, traveled, ts))
        # Match Point::dist exactly: sqrt(dx*dx + dy*dy), not hypot.
        seg_len = float(
            np.sqrt(float((p2[0] - p1[0]) ** 2 + (p2[1] - p1[1]) ** 2))
        )
        if p1 != p2 and has_caps:
            if i == 0:
                ce = _push_away_from(p1, p2, half_width)
                accum(stroke_segment_alpha(p1, ce, half_width, opacity, outer_profile, 0.0, ts))
            if i + 1 == n:
                ce = _push_away_from(p2, p1, half_width)
                accum(stroke_segment_alpha(p2, ce, half_width, opacity, outer_profile, 0.0, ts))
        traveled += seg_len
    return alpha


def _push_away_from(p, other, by: float) -> Tuple[int, int]:
    dist = float(np.sqrt(float((p[0] - other[0]) ** 2 + (p[1] - other[1]) ** 2)))
    f = by / dist
    return (
        p[0] + int(np.round((p[0] - other[0]) * f)),
        p[1] + int(np.round((p[1] - other[1]) * f)),
    )


def blend_src_over(base_rgba: np.ndarray, alpha: np.ndarray, color: Tuple[int, int, int]) -> None:
    """In-place src-over of a coverage field with a uniform color onto a
    premultiplied RGBA f64 buffer (tile_pixels.rs:205-223)."""
    r, g, b = (c / 255.0 for c in color)
    keep = 1.0 - alpha
    base_rgba[..., 0] = alpha * r + keep * base_rgba[..., 0]
    base_rgba[..., 1] = alpha * g + keep * base_rgba[..., 1]
    base_rgba[..., 2] = alpha * b + keep * base_rgba[..., 2]
    base_rgba[..., 3] = alpha + keep * base_rgba[..., 3]


def rgba_to_rgb_u8(base_rgba: np.ndarray) -> np.ndarray:
    """Un-premultiply and truncate to u8 (tile_pixels.rs:164-181)."""
    a = base_rgba[..., 3]
    with np.errstate(divide="ignore", invalid="ignore"):
        mul = np.where(a == 0.0, 0.0, 1.0 / a)
    v = 255.0 * base_rgba[..., :3] * mul[..., None]
    v = np.where(np.isnan(v), 0.0, np.clip(v, 0.0, 255.0))
    return np.trunc(v).astype(np.uint8)
