"""Dense batch tile renderer in plain PyTorch.

Counterpart of `osm_renderer_tpu/ops/render_jnp.py`: the closed-form
dense coverage model over a host-built chunk stream (`TileBatch`, from
`draw.primitives.build_batch`), composited per primitive as max-alpha
then src-over, and the u8 finalize.  `precision="exact"` computes in
int64/f64 and `precision="fast"` in int32/f32; the dtypes are explicit.
The result is byte-identical to `render_jnp.render_batch`.

The reference scans the chunks of each tile and evaluates every slot of
every chunk over the whole tile.  Here the same function is evaluated in
two phases, because a chunk's alpha depends on its geometry alone:

1. `alphas`: every stroke segment over its window (its bbox grown by
   `ceil(half_width) + 3` px, where the closed forms can paint) and
   every fill over its edges' bbox (no pixel outside it is filled), as
   flat pixel lists in a few batched passes.  A primitive's pending
   alpha is the max of its chunks' alphas (all >= 0), scattered into
   its window.
2. `blend`: the primitives in paint order.  A primitive blends inside its
   window only: outside it, pending is 0 and the blend is the identity
   bit for bit.  Primitives whose windows touch none of an earlier
   unblended primitive's pixels share a level, and a level blends in one
   pass.

The schedule (`plan_batch`) is built on the host from the numpy batch,
so neither phase waits on the device.  Geometry past
`WINDOW_COORD_BOUND` is evaluated over the whole tile, where the window
argument's integer bounds would not hold.  `render_batch_stepwise` is
the reference's step-by-step order, kept for the tests.

This is the plain version (`render_batch_plain`), which runs on any
device: the benchmark's frozen copy of the program's
`ops/render_dense.py`, without its route to the CUDA kernels, and with
one more precision, "bf16" (int32/bfloat16), the step below the served
path's f32 that the benchmark's control computes in.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

KIND_PAD = 0
KIND_FILL = 1
KIND_STROKE = 2
KIND_FILL_IMAGE = 5  # tiled fill-image (pattern-sourced generation)

# Coordinates (tile pixels) under which the window bounds hold: no
# intermediate of the closed forms overflows its integer type.
WINDOW_COORD_BOUND = {"exact": 1 << 28, "fast": 12000, "bf16": 12000}

# Pixels a phase-1 pass evaluates at once (a chained stroke pixel holds
# about 1 KB of temporaries in the exact precision).
PIXEL_BUDGET = {"cuda": 1 << 22, "cpu": 1 << 18}

_HEIGHT_CELL = 8  # px; the level schedule's grid


class TileBatch(NamedTuple):
    geom: torch.Tensor           # (T, G, 4) int32
    geom_traveled: torch.Tensor  # (T, G) float
    geom_profile: torch.Tensor   # (T, G) int32
    chunk_kind: torch.Tensor     # (T, C) int32
    chunk_off: torch.Tensor      # (T, C) int32
    chunk_cnt: torch.Tensor      # (T, C) int32
    chunk_last: torch.Tensor     # (T, C) bool
    chunk_color: torch.Tensor    # (T, C, 3) float
    chunk_opacity: torch.Tensor  # (T, C) float
    chunk_hw: torch.Tensor       # (T, C) float
    profiles: torch.Tensor       # (NP, DS, 8) float
    profile_total: torch.Tensor  # (NP,) float
    chunk_pat: torch.Tensor      # (T, C) int32  fill-image index, -1 = none
    patterns: torch.Tensor       # (NPat, ts, ts, 4) float premultiplied tiled icons

    @classmethod
    def from_numpy(cls, arrays, device) -> "TileBatch":
        """The numpy batch of `build_batch` -> tensors on `device`, dtypes
        kept."""
        return cls(*(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in arrays))


def _dtypes(precision: str):
    if precision == "exact":
        return torch.int64, torch.float64
    if precision == "fast":
        return torch.int32, torch.float32
    if precision == "bf16":
        return torch.int32, torch.bfloat16
    raise ValueError(f"unknown precision {precision!r} (use 'exact', 'fast' or 'bf16')")


def _const(like: torch.Tensor, value: float) -> torch.Tensor:
    """A 0-dim tensor of `like`'s dtype and device (for fmax/fmin)."""
    return torch.full((), value, dtype=like.dtype, device=like.device)


# --------------------------------------------------------------------------
# Stroke coverage (render_jnp.py:78-297)
# --------------------------------------------------------------------------


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded square root.  PyTorch's CPU kernel is not (it
    misses the nearest double for ~0.7 % of inputs); numpy's is, and so
    is the CUDA kernel."""
    if x.device.type == "cpu" and x.dtype != torch.bfloat16:
        with np.errstate(invalid="ignore"):
            return torch.from_numpy(np.sqrt(x.numpy()))
    return torch.sqrt(x)


_SPLIT = 134217729.0  # 2**27 + 1: Veltkamp's split of a double


def _two_sum(a, b):
    """a + b = s + e exactly (Knuth)."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _two_prod(a, b):
    """a * b = p + e exactly (Dekker; doubles, no overflow)."""
    p = a * b
    ca, cb = _SPLIT * a, _SPLIT * b
    ah, bh = ca - (ca - a), cb - (cb - b)
    al, bl = a - ah, b - bh
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def _odd_sum(a, b):
    """a + b rounded to odd (doubles): the nearest double, moved to its
    odd neighbour towards the exact sum when it is inexact and even."""
    s, e = _two_sum(a, b)
    bits = s.view(torch.int64)
    step = torch.where((e > 0) == (s > 0), 1, -1)
    bits = bits + torch.where((e != 0) & ((bits & 1) == 0), step, 0)
    return bits.view(torch.float64)


def _fma(a, b, c):
    """a * b + c with one rounding, from plain IEEE operations (Boldo and
    Melquiond's emulation by rounding to odd).  Float32 rounds to odd in
    double, which holds the product exactly, then to float32.

    The reference's CPU compiler contracts a multiply feeding an add into
    one fused multiply-add (XLA's CPU backend always allows it), at the
    four places that use this: the cap-shrunk half-width, the start
    distance, and both blends.  Evaluated unfused, those round
    differently and move u8 outputs by one."""
    if c.dtype == torch.bfloat16 or a.dtype == torch.bfloat16:
        return a * b + c  # the control's precision: rounded twice
    if c.dtype == torch.float32 or a.dtype == torch.float32:
        p = a.to(torch.float64) * b.to(torch.float64)
        return _odd_sum(p, c.to(torch.float64)).to(torch.float32)
    uh, ul = _two_prod(a, b)
    th, tl = _two_sum(c, uh)
    return th + _odd_sum(tl, ul)


def _floor_div(u, v, fi, ff):
    """Exact floor division; on the fast int32 path a float estimate plus
    four exact integer corrections, as the reference computes it."""
    if fi == torch.int64:
        return torch.div(u, v, rounding_mode="floor")
    q = torch.floor(u.to(ff) / v.to(ff)).to(fi)
    r = u - q * v
    q = torch.where(r < 0, q - 1, q)
    r = u - q * v
    q = torch.where(r < 0, q - 1, q)
    r = u - q * v
    q = torch.where(r >= v, q + 1, q)
    r = u - q * v
    q = torch.where(r >= v, q + 1, q)
    return q


def _ceil_div2(a, b, fi, ff):
    return -_floor_div(-a, b, fi, ff)


def _sign(cond, fi):
    """`jnp.where(cond, 1, -1)` in the integer dtype `fi`."""
    return torch.where(cond, 1, -1).to(fi)


def _sq_diff(a, b):
    """`a * a - b * b` as the reference's compiled code rounds it."""
    return _fma(a, a, -(b * b))


def _color_blend(color, m, C):
    """`concat([color * m, m]) + (1 - m) * C`, the src-over of a colour,
    as the reference's compiled code rounds it."""
    one_m = 1.0 - m
    rgb = _fma(color, m.expand_as(color), one_m * C[..., :3])
    return torch.cat([rgb, _fma(one_m, C[..., 3:], m)], dim=-1)


def _pattern_blend(tile_pat, m, C):
    """`m * pat + (1 - m * pat_alpha) * C`, the src-over of a pattern.
    Its masks are 0 or 1, so every rounding of it gives these bits."""
    one_a = _fma(-m, tile_pat[..., 3:4], torch.ones_like(m))
    return _fma(m.expand_as(tile_pat), tile_pat, one_a * C)


def _opacity_by_center_distance(cd, hlw):
    feather_from = torch.fmax(hlw - 0.5, _const(hlw, 0.0))
    feather_to = torch.fmax(hlw + 0.5, _const(hlw, 1.0))
    feather_dist = feather_to - feather_from
    opacity_mul = torch.fmin(2.0 * hlw, _const(hlw, 1.0))
    v = torch.where(
        cd < feather_from,
        1.0,
        torch.where(cd < feather_to, (feather_to - cd) / feather_dist, 0.0),
    )
    return opacity_mul * v


def _stroke_opacity(cd, start_dist, half_width, prof, prof_total, traveled):
    """prof: (..., DS, 8) broadcasting with cd.  -> (opacity, in_line)."""
    dist_rem = traveled + start_dist
    d = torch.where(prof_total > 0.0, torch.fmod(dist_rem, prof_total), dist_rem)

    sd_op = torch.zeros_like(d)
    cap_dist = torch.full_like(d, float("inf"))
    inf = _const(d, float("inf"))
    any_rows = torch.zeros_like(d, dtype=torch.bool)
    for i in range(prof.shape[-2]):
        s_from, s_to = prof[..., i, 0], prof[..., i, 1]
        e_from, e_to = prof[..., i, 2], prof[..., i, 3]
        mul, has_orig = prof[..., i, 4], prof[..., i, 5]
        orig_a, orig_b = prof[..., i, 6], prof[..., i, 7]
        in_range = (d >= s_from) & (d <= e_to)
        base = torch.where(
            d <= s_to,
            (d - s_from) / (s_to - s_from),
            torch.where(d < e_from, 1.0, (e_to - d) / (e_to - e_from)),
        )
        sd_op = torch.fmax(sd_op, torch.where(in_range, mul * base, 0.0))
        cap_d = torch.where(
            d < orig_a, orig_a - d, torch.where(d <= orig_b, 0.0, d - orig_b)
        )
        cap_dist = torch.fmin(cap_dist, torch.where(in_range & (has_orig > 0.0), cap_d, inf))
        any_rows = any_rows | (s_from < float("inf"))
    # Empty profile (all rows disabled): plain opacity 1, no cap shrink.
    sd_op = torch.where(any_rows, sd_op, 1.0)
    cap_dist = torch.where(torch.isinf(cap_dist), 0.0, cap_dist)

    hlw = _sqrt(_fma(-cap_dist, cap_dist, half_width * half_width))
    cd_op = _opacity_by_center_distance(cd, hlw)
    return torch.fmin(sd_op, cd_op), cd_op > 0.0


def _stroke_segment_alpha(p1x, p1y, p2x, p2y, hw, opacity, prof, prof_total, traveled,
                          xs, ys, fi, ff, chain=False):
    """Alpha of one stroke segment at pixels (xs, ys).

    Every argument broadcasts to the pixels' shape: the segment's
    endpoints and scalars as (1, 1) for a dense (ts, ts) grid, or one
    value a pixel for a flat pixel list.  prof: (..., DS, 8)."""
    degenerate = (p1x == p2x) & (p1y == p2y)

    dx = torch.abs(p2x - p1x)
    dy = torch.abs(p2y - p1y)
    swap = dx > dy
    mn0 = torch.where(swap, p1y, p1x)
    mx0 = torch.where(swap, p1x, p1y)
    mn_d = torch.where(swap, dy, dx)
    mx_d = torch.where(swap, dx, dy)
    mx_d = torch.clamp(mx_d, min=1)  # degenerate guard (masked out at the end)
    x_inc = _sign(p1x <= p2x, fi)
    y_inc = _sign(p1y <= p2y, fi)
    mn_i = torch.where(swap, y_inc, x_inc)
    mx_i = torch.where(swap, x_inc, y_inc)

    numer_const = p2x * p1y - p2y * p1x
    sdx, sdy = p2x - p1x, p2y - p1y
    denom = _sqrt((dx * dx + dy * dy).to(ff))
    raw = numer_const + sdy * xs - sdx * ys
    cd = torch.abs(raw.to(ff)) / denom
    if ff == torch.float64:
        # Exact path: the reference's rounding chain (line.rs:120-121).
        dxp = (xs - p1x).to(ff)
        dyp = (ys - p1y).to(ff)
        long_d = _sqrt(dxp * dxp + dyp * dyp)
        start_dist = _sqrt(torch.fmax(_sq_diff(long_d, cd), _const(cd, 0.0)))
    else:
        dot = (xs - p1x) * sdx + (ys - p1y) * sdy
        start_dist = torch.abs(dot.to(ff)) / denom

    op, in_line = _stroke_opacity(cd, start_dist, hw, prof, prof_total, traveled)

    MN = torch.where(swap, ys, xs)
    MX = torch.where(swap, xs, ys)
    n0 = (MN - mn0) * mn_i
    m0 = (MX - mx0) * mx_i
    two_mx = 2 * mx_d
    A = 2 * mn_d * n0 + two_mx * m0 + (mx_d - 1)
    T = _floor_div(A, two_mx, fi, ff)
    r = A - T * two_mx
    edge_band = r == two_mx - 1

    def c_of(k):
        return _floor_div(2 * k * mn_d + mx_d - 1, two_mx, fi, ff)

    def h_of(k):
        return k + _floor_div(2 * c_of(k) * mn_d + mx_d - 1, two_mx, fi, ff)

    K = mx_d
    hK = h_of(K)

    def band_start(b):
        bc = torch.minimum(torch.clamp(b, min=0), hK)
        ratio = (mx_d * mx_d).to(ff) / (mx_d * mx_d + mn_d * mn_d).to(ff)
        k = (bc.to(ff) * ratio).to(fi)
        k = torch.minimum(torch.clamp(k, min=0), K)
        for _ in range(6):
            k = torch.where((k > 0) & (h_of(k) > bc), k - 1, k)
        for _ in range(6):
            k = torch.where((k < K) & (h_of(k + 1) <= bc), k + 1, k)
        is_gap = h_of(k) != bc
        c_sel = torch.where(is_gap, c_of(k + 1), c_of(k))
        return mn0 + mn_i * c_sel, mx0 + mx_i * k, c_sel

    def start_alive(s_mn, s_mx):
        s_x = torch.where(swap, s_mx, s_mn)
        s_y = torch.where(swap, s_mn, s_mx)
        raw_s = numer_const + sdy * s_x - sdx * s_y
        cd_s = torch.abs(raw_s.to(ff)) / denom
        if ff == torch.float64:
            dxs = (s_x - p1x).to(ff)
            dys = (s_y - p1y).to(ff)
            long_s = _sqrt(dxs * dxs + dys * dys)
            sd_s = _sqrt(torch.fmax(_sq_diff(long_s, cd_s), _const(cd_s, 0.0)))
        else:
            dot_s = (s_x - p1x) * sdx + (s_y - p1y) * sdy
            sd_s = torch.abs(dot_s.to(ff)) / denom
        _, alive = _stroke_opacity(cd_s, sd_s, hw, prof, prof_total, traveled)
        return alive

    in_slab = (A >= 0) & (T <= hK)
    s_mn_T, s_mx_T, c_sel_T = band_start(T)
    ok_T = in_slab & start_alive(s_mn_T, s_mx_T)

    s_mn_N, s_mx_N, c_sel_N = band_start(T + 1)
    dn_T = (MN - s_mn_T) * mn_i
    dn_N = (MN - s_mn_N) * mn_i

    if chain:
        # Walk-chain rule for round-capped dashes: every intermediate
        # perpendicular pixel must be in-line too.
        any_orig = ((prof[..., 0] < 1e30) & (prof[..., 5] > 0)).any(dim=-1)

        def ceil_div(a, b):
            return _floor_div(a + b - 1, b, fi, ff)

        def chain_alive(s_mn_v, s_mx_v, c_sel_v, mul_v, jv):
            tcm = 2 * c_sel_v * mn_d
            G = torch.clamp(ceil_div(tcm - mx_d, two_mx), min=0)
            e0 = mul_v * (tcm - two_mx * G)
            ok = torch.ones_like(jv, dtype=torch.bool)
            for jp in range(1, 12):
                Cjp = torch.clamp(ceil_div(e0 + 2 * jp * mn_d - mx_d, two_mx), min=0)
                minor = s_mn_v + mul_v * mn_i * jp
                major = s_mx_v - mul_v * mx_i * Cjp
                ok = ok & (start_alive(minor, major) | (jp >= jv))
            return ok

        mul_T = _sign(dn_T >= 0, fi)
        ok_T = ok_T & (
            ~any_orig | chain_alive(s_mn_T, s_mx_T, c_sel_T, mul_T, torch.abs(dn_T))
        )
        chain_N = ~any_orig | chain_alive(
            s_mn_N, s_mx_N, c_sel_N, torch.full((), -1, dtype=fi, device=dn_N.device), -dn_N
        )
    else:
        chain_N = True

    ok_T = ok_T & torch.where(edge_band, dn_T >= 0, True)
    ok_N = (
        edge_band
        & (A + 1 >= 0)
        & (T + 1 <= hK)
        & (dn_N <= 0)
        & start_alive(s_mn_N, s_mx_N)
        & chain_N
    )
    visited = in_line & (ok_T | ok_N) & ~degenerate
    return torch.where(visited, opacity * op, 0.0)


# --------------------------------------------------------------------------
# Fill coverage (render_jnp.py:304-372)
# --------------------------------------------------------------------------


def _fill_crossings(x1, y1, x2, y2, mask, rows, fi, ff):
    """Per (row, edge) crossing positions of a fill's edges (edges on the
    last axis; rows broadcast as (..., 1)) -> (a, b, active)."""
    adx = torch.abs(x2 - x1)
    ady = torch.abs(y2 - y1)
    sx = _sign(x1 < x2, fi)

    ytop = torch.minimum(y1, y2)
    ybot = torch.maximum(y1, y2)
    active = (rows > ytop) & (rows <= ybot) & mask

    j = torch.abs(rows - y1)

    steep_x = x1 + sx * _floor_div(2 * j * adx + ady, torch.clamp(2 * ady, min=1), fi, ff)

    ady_nz = torch.clamp(ady, min=1)
    i_min = torch.minimum(
        torch.clamp(_ceil_div2(adx * (2 * j - 1), 2 * ady_nz, fi, ff), min=0), adx)
    i_max = torch.minimum(
        torch.clamp(_ceil_div2(adx * (2 * j + 1), 2 * ady_nz, fi, ff) - 1, min=0), adx)
    sh_lo = x1 + sx * i_min
    sh_hi = x1 + sx * i_max
    sh_a = torch.minimum(sh_lo, sh_hi)
    sh_b = torch.maximum(sh_lo, sh_hi)

    steep = ady > adx
    return torch.where(steep, steep_x, sh_a), torch.where(steep, steep_x, sh_b), active


# The sort key of an inactive edge in a row's stable rank.
FILL_RANK_BIG = {torch.int64: 2**60, torch.int32: 2**30}


def _fill_rows(x1, y1, x2, y2, mask, rows, fi, ff):
    """`_fill_crossings` and the stable rank of each edge within its row
    by (a, edge index) -> (a, b, active, odd_rank, n_active)."""
    a, b, active = _fill_crossings(x1, y1, x2, y2, mask, rows, fi, ff)
    a_masked = torch.where(active, a, torch.full((), FILL_RANK_BIG[fi], dtype=fi, device=a.device))
    order = torch.argsort(a_masked, dim=-1, stable=True)
    idx = torch.arange(order.shape[-1], dtype=order.dtype, device=order.device)
    rank = torch.zeros_like(order).scatter_(-1, order, idx.expand_as(order))
    odd_rank = active & ((rank & 1) == 1)
    n_active = active.sum(dim=-1, dtype=torch.int32)
    return a, b, active, odd_rank, n_active


def _fill_pixels(a, b, active, odd_rank, n_active, xs, fill_opacity):
    """Fill alpha at pixels: a/b/active/odd_rank (..., E) of each pixel's
    row, n_active (...), xs (..., 1)."""
    le = a <= xs
    N = (active & le).sum(dim=-1, dtype=torch.int32)
    tail = (odd_rank & le & (xs <= b)).any(dim=-1)
    parity = ((N & 1) == 1) & ~((N == n_active) & ((n_active & 1) == 1))
    filled = parity | tail
    return torch.where(filled, fill_opacity, 0.0)


def _finalize_rgb(C):
    a = C[..., 3]
    mul = torch.where(a == 0.0, 0.0, 1.0 / a)
    v = 255.0 * C[..., :3] * mul[..., None]
    v = torch.where(torch.isnan(v), 0.0, torch.clamp(v, 0.0, 255.0))
    return torch.trunc(v).to(torch.uint8)


# --------------------------------------------------------------------------
# The reference's order: a scan over each tile's chunks (the tests' bar)
# --------------------------------------------------------------------------


def render_batch_stepwise(batch: TileBatch, canvas_rgb, ts: int, chunk: int = 64,
                          precision: str = "exact", chain: bool = False) -> torch.Tensor:
    """`render_jnp.render_batch` transcribed step by step: every slot of
    every chunk over the whole tile, one chunk after another.  Slow; only
    the tests run it, on small scenes."""
    fi, ff = _dtypes(precision)
    dev = batch.geom.device
    T, G = batch.geom.shape[:2]
    xs = torch.arange(ts, dtype=fi, device=dev)[None, :]
    ys = torch.arange(ts, dtype=fi, device=dev)[:, None]
    rows = ys  # (ts, 1)
    NP = batch.profiles.shape[0]
    out = []
    for t in range(T):
        geom = batch.geom[t].to(fi)
        C = torch.cat([canvas_rgb.expand(ts, ts, 3),
                       torch.ones((ts, ts, 1), dtype=canvas_rgb.dtype, device=dev)], dim=-1)
        pending = torch.zeros((ts, ts), dtype=canvas_rgb.dtype, device=dev)
        for c in range(batch.chunk_kind.shape[1]):
            kind = min(max(int(batch.chunk_kind[t, c]), 0), 3)
            start = min(max(int(batch.chunk_off[t, c]), 0), G - chunk)
            cnt = int(batch.chunk_cnt[t, c])
            if kind == KIND_STROKE:
                alpha = torch.zeros((ts, ts), dtype=batch.profiles.dtype, device=dev)
                for i in range(min(max(cnt, 0), chunk)):
                    g = geom[start + i].reshape(4, 1, 1)
                    pidx = min(max(int(batch.geom_profile[t, start + i]), 0), NP - 1)
                    one = lambda v: v.reshape(1, 1)  # noqa: E731
                    alpha = torch.fmax(alpha, _stroke_segment_alpha(
                        g[0], g[1], g[2], g[3], one(batch.chunk_hw[t, c]),
                        one(batch.chunk_opacity[t, c]), batch.profiles[pidx][None, None],
                        one(batch.profile_total[pidx]), one(batch.geom_traveled[t, start + i]),
                        xs, ys, fi, ff, chain))
            elif kind != KIND_PAD:
                e = geom[start:start + chunk]
                mask = (torch.arange(chunk, device=dev) < cnt)[None, :]
                a, b, act, odd, nact = _fill_rows(e[None, :, 0], e[None, :, 1], e[None, :, 2],
                                                  e[None, :, 3], mask, rows, fi, ff)
                alpha = _fill_pixels(a[:, None], b[:, None], act[:, None], odd[:, None],
                                     nact[:, None], xs[..., None],
                                     batch.chunk_opacity[t, c].reshape(1, 1))
            else:
                alpha = torch.zeros((ts, ts), dtype=C.dtype, device=dev)
            pending = torch.fmax(pending, alpha)
            if bool(batch.chunk_last[t, c]):
                pat = int(batch.chunk_pat[t, c])
                m = pending[..., None]
                if pat >= 0:
                    C = _pattern_blend(batch.patterns[min(pat, batch.patterns.shape[0] - 1)],
                                       m, C)
                else:
                    C = _color_blend(batch.chunk_color[t, c].expand(ts, ts, 3), m, C)
                pending = torch.zeros_like(pending)
        out.append(_finalize_rgb(C))
    return torch.stack(out)


# --------------------------------------------------------------------------
# The host schedule
# --------------------------------------------------------------------------


class BatchPlan(NamedTuple):
    """Where each chunk can paint and the order of the blends, built on
    the host from the numpy batch (`plan_batch`).

    Windows are pixel boxes (y0, x0, h, w) inside the tile.  Pending
    alphas live in one flat buffer: each group's window row-major from
    its `base`, the groups in blend order (level, tile, paint order), so
    a level's pending is one contiguous range."""
    ts: int
    precision: str
    # Stroke segments: (t, c, geom slot, y0, x0, h, w, pend_off, pend_w).
    strokes: np.ndarray
    stroke_passes: List[Tuple[int, int, int]]   # (item begin, end, pixels)
    # Fill chunks: (t, c, first geom slot, count, y0, x0, h, w, pend_off,
    # pend_w), by edge bucket E: [(E, items, [(begin, end, rows, pixels)])].
    fills: List[Tuple[int, np.ndarray, List[Tuple[int, int, int, int]]]]
    # Groups in blend order: (t, c of the blending chunk, y0, x0, h, w, base).
    groups: np.ndarray
    levels: List[Tuple[int, int, int, int]]     # (group begin, end, pixel begin, end)
    pending_size: int
    has_patterns: bool  # some group blends a pattern (kind 5)


def _passes(pixels: np.ndarray, budget: int) -> List[Tuple[int, int, int]]:
    """Greedy split of consecutive items into passes of <= budget pixels
    (an item larger than the budget is a pass of its own)."""
    out = []
    begin, acc = 0, 0
    for i, n in enumerate(pixels.tolist()):
        if acc and acc + n > budget:
            out.append((begin, i, acc))
            begin, acc = i, 0
        acc += n
    if acc:
        out.append((begin, len(pixels), acc))
    return out


def plan_batch(arrays, ts: int, chunk: int = 64, precision: str = "exact",
               budget: int = PIXEL_BUDGET["cpu"]) -> BatchPlan:
    """The two-phase schedule of one batch from its numpy arrays (the
    fields of `TileBatch`; only geometry, kinds, offsets, counts, last
    flags, half-widths and pattern indices are read)."""
    _dtypes(precision)
    geom = np.asarray(arrays.geom).astype(np.int64)
    kind = np.clip(np.asarray(arrays.chunk_kind), 0, 3)
    last = np.asarray(arrays.chunk_last).astype(bool)
    T, G = geom.shape[:2]
    C = kind.shape[1]
    bound = WINDOW_COORD_BOUND[precision]
    # dynamic_slice_in_dim clamps its start; slots past cnt are masked.
    start = np.clip(np.minimum(np.asarray(arrays.chunk_off).astype(np.int64), G - chunk), 0, None)
    cnt = np.clip(np.asarray(arrays.chunk_cnt).astype(np.int64), 0, chunk)
    # Group = the chunks up to and including a last chunk; chunks after a
    # tile's final last chunk never blend.
    lasts = np.cumsum(last, axis=1)
    gid = lasts - last
    blended = gid < lasts[:, -1:]
    hi = ts - 1

    # Stroke segments, one item each.
    ct, cc = np.nonzero((kind == KIND_STROKE) & (cnt > 0) & blended)
    n = cnt[ct, cc]
    rep = np.repeat(np.arange(ct.size), n)
    slot = start[ct, cc][rep] + (np.arange(rep.size) - np.repeat(np.cumsum(n) - n, n))
    st, sc = ct[rep], cc[rep]
    seg = geom[st, slot]
    keep = ~((seg[:, 0] == seg[:, 2]) & (seg[:, 1] == seg[:, 3]))
    st, sc, slot, seg = st[keep], sc[keep], slot[keep], seg[keep]
    m = np.ceil(np.asarray(arrays.chunk_hw)[st, sc].astype(np.float64)).astype(np.int64) + 3
    sx0 = np.minimum(seg[:, 0], seg[:, 2]) - m
    sx1 = np.maximum(seg[:, 0], seg[:, 2]) + m
    sy0 = np.minimum(seg[:, 1], seg[:, 3]) - m
    sy1 = np.maximum(seg[:, 1], seg[:, 3]) + m
    full = (np.abs(seg) >= bound).any(axis=1)

    # Fill chunks (kinds 1, 5 and the other kinds the scan maps to its
    # fill branch): the bbox of their edges' rows (ytop, ybot] and columns.
    ft, fc = np.nonzero(((kind == KIND_FILL) | (kind == 3)) & (cnt > 0) & blended)
    fn = cnt[ft, fc]
    frep = np.repeat(np.arange(ft.size), fn)
    fslot = start[ft, fc][frep] + (np.arange(frep.size) - np.repeat(np.cumsum(fn) - fn, fn))
    edges = geom[ft[frep], fslot]
    firsts = np.cumsum(fn) - fn
    if ft.size:
        ex0 = np.minimum.reduceat(np.minimum(edges[:, 0], edges[:, 2]), firsts)
        ex1 = np.maximum.reduceat(np.maximum(edges[:, 0], edges[:, 2]), firsts)
        ey0 = np.minimum.reduceat(np.minimum(edges[:, 1], edges[:, 3]), firsts) + 1
        ey1 = np.maximum.reduceat(np.maximum(edges[:, 1], edges[:, 3]), firsts)
        ffull = np.maximum.reduceat(np.abs(edges).max(axis=1), firsts) >= bound
    else:
        ex0 = ex1 = ey0 = ey1 = np.zeros(0, np.int64)
        ffull = np.zeros(0, bool)

    def clip(x0, x1, y0, y1, whole):
        x0 = np.where(whole, 0, np.maximum(x0, 0))
        y0 = np.where(whole, 0, np.maximum(y0, 0))
        x1 = np.where(whole, hi, np.minimum(x1, hi))
        y1 = np.where(whole, hi, np.minimum(y1, hi))
        return x0, x1, y0, y1, (x0 <= x1) & (y0 <= y1)

    sx0, sx1, sy0, sy1, sk = clip(sx0, sx1, sy0, sy1, full)
    ex0, ex1, ey0, ey1, fk = clip(ex0, ex1, ey0, ey1, ffull)
    st, sc, slot = st[sk], sc[sk], slot[sk]
    sx0, sx1, sy0, sy1 = sx0[sk], sx1[sk], sy0[sk], sy1[sk]
    ft, fc, fstart, fn = ft[fk], fc[fk], start[ft, fc][fk], fn[fk]
    ex0, ex1, ey0, ey1 = ex0[fk], ex1[fk], ey0[fk], ey1[fk]

    # Groups with at least one item, in paint order; their windows are
    # the union of their items'.
    it_t = np.concatenate([st, ft])
    it_key = it_t * (C + 1) + np.concatenate([gid[st, sc], gid[ft, fc]])
    keys, inv = np.unique(it_key, return_inverse=True)
    NG = keys.size
    g_t = keys // (C + 1)
    g_gid = keys % (C + 1)
    gy0 = np.full(NG, ts, np.int64)
    gx0 = np.full(NG, ts, np.int64)
    gy1 = np.full(NG, -1, np.int64)
    gx1 = np.full(NG, -1, np.int64)
    np.minimum.at(gy0, inv, np.concatenate([sy0, ey0]))
    np.minimum.at(gx0, inv, np.concatenate([sx0, ex0]))
    np.maximum.at(gy1, inv, np.concatenate([sy1, ey1]))
    np.maximum.at(gx1, inv, np.concatenate([sx1, ex1]))
    # The chunk whose colour and pattern the group blends with.
    last_c = np.zeros((T, C + 1), np.int64)
    lt, lc = np.nonzero(last)
    last_c[lt, gid[lt, lc]] = lc
    g_c = last_c[g_t, g_gid]

    # Levels: a group blends after every earlier group of its tile whose
    # window shares a grid cell with its own.
    level = np.zeros(NG, np.int64)
    cells = -(-ts // _HEIGHT_CELL)
    cy0, cy1 = gy0 // _HEIGHT_CELL, gy1 // _HEIGHT_CELL + 1
    cx0, cx1 = gx0 // _HEIGHT_CELL, gx1 // _HEIGHT_CELL + 1
    height = np.zeros((cells, cells), np.int64)
    prev_t = -1
    for g in range(NG):
        if g_t[g] != prev_t:
            height[:] = 0
            prev_t = g_t[g]
        win = height[cy0[g]:cy1[g], cx0[g]:cx1[g]]
        lv = int(win.max())
        level[g] = lv
        win[...] = lv + 1
    # Blend order (level, tile, paint order); the pending buffer follows it.
    order = np.lexsort((keys, level))
    gh, gw = gy1 - gy0 + 1, gx1 - gx0 + 1
    area = (gh * gw)[order]
    end = np.cumsum(area)
    base = np.zeros(NG, np.int64)
    base[order] = end - area
    cuts = np.flatnonzero(np.diff(level[order])) + 1
    gb = np.concatenate([[0], cuts, [NG]]).tolist() if NG else [0]
    levels = [(a, b, int(end[a] - area[a]), int(end[b - 1])) for a, b in zip(gb[:-1], gb[1:])]
    pat = np.asarray(arrays.chunk_pat)
    groups = np.stack([g_t, g_c, gy0, gx0, gh, gw, base], axis=1)[order]
    has_patterns = bool(NG and (pat[g_t, g_c] >= 0).any())

    # Items point at their group's window in the pending buffer.
    pend_w = gw[inv]
    pend_off = base[inv] - gy0[inv] * pend_w - gx0[inv]
    ns = st.size
    strokes = np.stack([st, sc, slot, sy0, sx0, sy1 - sy0 + 1, sx1 - sx0 + 1,
                        pend_off[:ns], pend_w[:ns]], axis=1).astype(np.int64)
    stroke_passes = _passes(strokes[:, 5] * strokes[:, 6], budget)
    fill_items = np.stack([ft, fc, fstart, fn, ey0, ex0, ey1 - ey0 + 1, ex1 - ex0 + 1,
                           pend_off[ns:], pend_w[ns:]], axis=1).astype(np.int64)
    fills = []
    bucket = np.maximum(4, 1 << np.ceil(np.log2(np.maximum(fn, 1))).astype(np.int64))
    for E in np.unique(bucket).tolist():
        items = fill_items[bucket == E]
        px = items[:, 6] * items[:, 7]
        passes = []
        for b0, b1, npx in _passes(px * E, budget):
            passes.append((b0, b1, int(items[b0:b1, 6].sum()), npx // E))
        fills.append((E, items, passes))
    return BatchPlan(ts, precision, strokes, stroke_passes, fills, groups, levels,
                     int(area.sum()), has_patterns)


# --------------------------------------------------------------------------
# Phase 1: every chunk's alpha, scattered into its group's window
# --------------------------------------------------------------------------


def _pixels(items: torch.Tensor, y0c: int, npx: int):
    """Flat pixel list of items' windows (columns y0c..y0c+3 = y0, x0, h,
    w) -> (item of each pixel, y, x, local row index within the item)."""
    dev = items.device
    h, w = items[:, y0c + 2], items[:, y0c + 3]
    count = h * w
    start = torch.cumsum(count, 0) - count
    item = torch.repeat_interleave(torch.arange(items.shape[0], device=dev), count,
                                   output_size=npx)
    local = torch.arange(npx, device=dev) - start[item]
    wi = w[item]
    ly = torch.div(local, wi, rounding_mode="floor")
    lx = local - ly * wi
    return item, items[item, y0c] + ly, items[item, y0c + 1] + lx, ly


def alphas(batch: TileBatch, plan: BatchPlan, chain: bool = False) -> torch.Tensor:
    """Phase 1: the pending alpha of every group over its window, as the
    flat buffer the plan lays out (float, the batch's float dtype)."""
    fi, ff = _dtypes(plan.precision)
    dev = batch.geom.device
    pending = torch.zeros(plan.pending_size, dtype=batch.chunk_opacity.dtype, device=dev)
    NP = batch.profiles.shape[0]
    if plan.strokes.shape[0]:
        strokes = torch.from_numpy(plan.strokes).to(dev)
        for b0, b1, npx in plan.stroke_passes:
            it = strokes[b0:b1]
            t, c, slot = it[:, 0], it[:, 1], it[:, 2]
            seg = batch.geom[t, slot].to(fi)
            pidx = batch.geom_profile[t, slot].long().clamp(0, NP - 1)
            item, ys, xs, _ = _pixels(it, 3, npx)
            s = seg[item]
            alpha = _stroke_segment_alpha(
                s[:, 0], s[:, 1], s[:, 2], s[:, 3], batch.chunk_hw[t, c][item],
                batch.chunk_opacity[t, c][item], batch.profiles[pidx[item]],
                batch.profile_total[pidx][item], batch.geom_traveled[t, slot][item],
                xs.to(fi), ys.to(fi), fi, ff, chain)
            pending.scatter_reduce_(0, it[item, 7] + ys * it[item, 8] + xs, alpha, "amax")
    G = batch.geom.shape[1]
    for E, items_np, passes in plan.fills:
        items_all = torch.from_numpy(items_np).to(dev)
        lanes = torch.arange(E, device=dev)
        for b0, b1, nrows, npx in passes:
            it = items_all[b0:b1]
            t, c = it[:, 0], it[:, 1]
            slot = (it[:, 2:3] + lanes).clamp(max=G - 1)
            e = batch.geom[t[:, None], slot].to(fi)            # (n, E, 4)
            mask = lanes < it[:, 3:4]
            # One entry a window row, then one a pixel.
            rcount = it[:, 6]
            rstart = torch.cumsum(rcount, 0) - rcount
            ritem = torch.repeat_interleave(torch.arange(it.shape[0], device=dev), rcount,
                                            output_size=nrows)
            rows = (it[ritem, 4] + torch.arange(nrows, device=dev) - rstart[ritem]).to(fi)
            er = e[ritem]
            a, b, act, odd, nact = _fill_rows(er[..., 0], er[..., 1], er[..., 2], er[..., 3],
                                              mask[ritem], rows[:, None], fi, ff)
            item, ys, xs, ly = _pixels(it, 4, npx)
            r = rstart[item] + ly
            alpha = _fill_pixels(a[r], b[r], act[r], odd[r], nact[r], xs.to(fi)[:, None],
                                 batch.chunk_opacity[t, c][item])
            pending.scatter_reduce_(0, it[item, 8] + ys * it[item, 9] + xs, alpha, "amax")
    return pending


# --------------------------------------------------------------------------
# Phase 2: the blends in paint order, a level at a time
# --------------------------------------------------------------------------


def blend(batch: TileBatch, canvas_rgb, plan: BatchPlan, pending: torch.Tensor) -> torch.Tensor:
    """Phase 2: src-over of every group's pending over the canvas, then
    the u8 finalize -> (T, ts, ts, 3) uint8."""
    ts = plan.ts
    dev = batch.geom.device
    T = batch.geom.shape[0]
    C = torch.cat([canvas_rgb.expand(T * ts * ts, 3),
                   torch.ones((T * ts * ts, 1), dtype=canvas_rgb.dtype, device=dev)], dim=1)
    if plan.groups.shape[0]:
        groups = torch.from_numpy(plan.groups).to(dev)
        g_t, g_c = groups[:, 0], groups[:, 1]
        color = batch.chunk_color[g_t, g_c]
        pat = batch.chunk_pat[g_t, g_c].long()
        area = groups[:, 4] * groups[:, 5]
        npat = batch.patterns.shape[0]
        for gs, ge, ps, pe in plan.levels:
            n = pe - ps
            gi = gs + torch.repeat_interleave(torch.arange(ge - gs, device=dev), area[gs:ge],
                                              output_size=n)
            g = groups[gi]
            local = torch.arange(ps, pe, device=dev) - g[:, 6]
            ly = torch.div(local, g[:, 5], rounding_mode="floor")
            y = g[:, 2] + ly
            x = g[:, 3] + (local - ly * g[:, 5])
            cidx = (g[:, 0] * ts + y) * ts + x
            m = pending[ps:pe, None]
            Cs = C[cidx]
            new = _color_blend(color[gi], m, Cs)
            if plan.has_patterns:
                # fill.rs:36-40: a premultiplied icon sample a pixel, the
                # fill opacity ignored.
                p = pat[gi]
                tile_pat = batch.patterns[p.clamp(0, npat - 1), y, x]
                new = torch.where((p >= 0)[:, None], _pattern_blend(tile_pat, m, Cs), new)
            C[cidx] = new
    return _finalize_rgb(C.reshape(T, ts, ts, 4))


def _plan_for(batch: TileBatch, ts: int, chunk: int, precision: str,
              plan: Optional[BatchPlan]) -> BatchPlan:
    """`plan`, checked against ts and precision; without it the schedule
    read back from the batch (one device-to-host copy)."""
    if plan is None:
        host = batch._replace(**{f: getattr(batch, f).cpu().numpy() for f in (
            "geom", "chunk_kind", "chunk_off", "chunk_cnt", "chunk_last", "chunk_hw",
            "chunk_pat")})
        return plan_batch(host, ts, chunk, precision,
                          PIXEL_BUDGET["cuda" if batch.geom.is_cuda else "cpu"])
    if (plan.ts, plan.precision) != (ts, precision):
        raise ValueError(f"plan for ts={plan.ts} {plan.precision!r}, asked for ts={ts} "
                         f"{precision!r}")
    return plan


def render_batch_plain(batch: TileBatch, canvas_rgb, ts: int, chunk: int = 64,
                       precision: str = "exact", chain: bool = False,
                       plan: Optional[BatchPlan] = None) -> torch.Tensor:
    """The plain PyTorch version, on any device: phase 1 (`alphas`), then
    phase 2 (`blend`) -> (T, ts, ts, 3) uint8."""
    plan = _plan_for(batch, ts, chunk, precision, plan)
    return blend(batch, canvas_rgb, plan, alphas(batch, plan, chain))
