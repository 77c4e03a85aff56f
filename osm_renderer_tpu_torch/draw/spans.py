"""Host-side scanline span extraction for polygon fills.

Converts a fill contour's edge list into the exact set of filled row
spans the reference's scanline fill would paint (`fill.rs:16-47`):
each edge is rasterized to per-row x-extents with the minimal
symmetric Bresenham (`fill.rs:49-104`), start/end pixels are
"poisoned" (start iff p1.y <= p2.y, end iff p2.y <= p1.y), poisoned
entries are dropped, the rest are stable-sorted by x_min per row and
filled pairwise [pair[i].x_min, pair[i+1].x_max].

The device kernel then paints spans with a coverage matmul
(ops/render_pallas.py) — membership is decided entirely here, on the
host, in exact integer arithmetic, so fills are byte-exact by
construction.

Two implementations:
* `fill_spans` — vectorized numpy closed form (the Bresenham row span
  [a, b] of an edge has a closed form; see ops/coverage_np.py and
  docs/DESIGN.md §2), validated against the walk;
* `fill_spans_walk` — direct transcription of the sequential walk,
  kept as the executable spec for fuzz tests.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def _ceil_div(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Ceiling division for positive b (ints)."""
    return -((-a) // b)


def _edge_row_entries(edges: np.ndarray, ts: int):
    """Per-(edge, row) Bresenham x-extents for rows clipped to [0, ts).

    Returns (eid, y, a, b, poisoned) flat arrays; each edge contributes
    one entry per covered row (the walk visits each row in one
    contiguous x-run).
    """
    e = np.asarray(edges, dtype=np.int64)
    if e.size == 0:
        z = np.zeros(0, dtype=np.int64)
        return z, z, z, z, z.astype(bool)
    x1, y1, x2, y2 = e[:, 0], e[:, 1], e[:, 2], e[:, 3]
    ytop = np.minimum(y1, y2)
    ybot = np.maximum(y1, y2)
    r_lo = np.maximum(ytop, 0)
    r_hi = np.minimum(ybot, ts - 1)
    counts = np.maximum(r_hi - r_lo + 1, 0)
    total = int(counts.sum())
    if total == 0:
        z = np.zeros(0, dtype=np.int64)
        return z, z, z, z, z.astype(bool)

    eid = np.repeat(np.arange(e.shape[0], dtype=np.int64), counts)
    offs = np.concatenate(([0], np.cumsum(counts)[:-1]))
    intra = np.arange(total, dtype=np.int64) - np.repeat(offs, counts)
    y = np.repeat(r_lo, counts) + intra

    ex1 = x1[eid]
    ey1 = y1[eid]
    adx = np.abs(x2 - x1)[eid]
    ady = np.abs(y2 - y1)[eid]
    sx = np.where(x1 < x2, 1, -1)[eid]
    j = np.abs(y - ey1)

    ady_nz = np.maximum(ady, 1)
    steep = ady > adx

    # Non-steep: i-range [ceil(adx(2j-1)/2ady), ceil(adx(2j+1)/2ady)-1]
    # clipped to [0, adx]; steep: the single x at floor((2j*adx+ady)/2ady).
    i_min = np.clip(_ceil_div(adx * (2 * j - 1), 2 * ady_nz), 0, adx)
    i_max = np.clip(_ceil_div(adx * (2 * j + 1), 2 * ady_nz) - 1, 0, adx)
    lo = ex1 + sx * i_min
    hi = ex1 + sx * i_max
    a_shallow = np.minimum(lo, hi)
    b_shallow = np.maximum(lo, hi)
    x_steep = ex1 + sx * ((2 * j * adx + ady) // (2 * ady_nz))
    a = np.where(steep, x_steep, a_shallow)
    b = np.where(steep, x_steep, b_shallow)

    ey2 = y2[eid]
    e_y1 = y1[eid]
    poisoned = ((y == e_y1) & (e_y1 <= ey2)) | ((y == ey2) & (ey2 <= e_y1))
    return eid, y, a, b, poisoned


def fill_spans(edges: np.ndarray, ts: int) -> np.ndarray:
    """Edge list (E, 4) int -> filled spans (S, 3) int32 rows of
    (y, x_from, x_to) inclusive, clipped to the [0, ts) window.

    Matches `FillContour` (native/oracle.cpp / fill.rs:16-47) exactly:
    validated against `fill_spans_walk` by fuzz tests.
    """
    return fill_spans_multi([edges], ts)[0]


def fill_spans_multi(edge_arrays, ts: int):
    """`fill_spans` for many contours in one vectorized pass (one
    lexsort over all (edge, row) entries instead of per-prim numpy
    calls — the host-assembly hot path).  Pairing is grouped per
    (contour, row).  Returns one (S, 3) int32 span array per input."""
    n_prims = len(edge_arrays)
    if n_prims == 0:
        return []
    counts = [np.asarray(e).shape[0] for e in edge_arrays]
    nonzero = [i for i, c in enumerate(counts) if c]
    outs = [np.zeros((0, 3), dtype=np.int32)] * n_prims
    if not nonzero:
        return outs
    all_edges = np.concatenate(
        [np.asarray(edge_arrays[i], dtype=np.int64) for i in nonzero], axis=0
    )
    prim_of_edge = np.repeat(
        np.arange(len(nonzero), dtype=np.int64), [counts[i] for i in nonzero]
    )

    eid, y, a, b, poisoned = _edge_row_entries(all_edges, ts)
    keep = ~poisoned
    eid, y, a, b = eid[keep], y[keep], a[keep], b[keep]
    if y.size == 0:
        return outs
    pid = prim_of_edge[eid]

    order = np.lexsort((eid, a, y, pid))
    p_s, y_s, a_s, b_s = pid[order], y[order], a[order], b[order]

    n = y_s.size
    same_next = np.zeros(n, dtype=bool)
    same_next[:-1] = (y_s[1:] == y_s[:-1]) & (p_s[1:] == p_s[:-1])
    grp_start = np.ones(n, dtype=bool)
    grp_start[1:] = ~same_next[:-1]
    idxs = np.arange(n, dtype=np.int64)
    start_idx = np.maximum.accumulate(np.where(grp_start, idxs, 0))
    pos = idxs - start_idx

    first = (pos % 2 == 0) & same_next
    fi = np.flatnonzero(first)
    lo = np.maximum(a_s[fi], 0)
    hi = np.minimum(b_s[fi + 1], ts - 1)
    ok = lo <= hi
    fi = fi[ok]
    spans = np.stack([y_s[fi], lo[ok], hi[ok]], axis=1).astype(np.int32)
    span_pid = p_s[fi]

    # Entries are sorted by pid, so spans split contiguously per prim.
    split_at = np.searchsorted(span_pid, np.arange(1, len(nonzero)))
    for k, part in enumerate(np.split(spans, split_at)):
        outs[nonzero[k]] = part
    return outs


def fill_spans_walk(edges: np.ndarray, ts: int) -> np.ndarray:
    """Sequential-walk reference implementation (executable spec;
    transcribes FillRasterizeEdge/FillContour, native/oracle.cpp)."""
    rows: dict = {}
    e = np.asarray(edges, dtype=np.int64)
    for i in range(e.shape[0]):
        x1, y1, x2, y2 = (int(v) for v in e[i])
        dx = abs(x2 - x1)
        dy = -abs(y2 - y1)
        sx = 1 if x1 < x2 else -1
        sy = 1 if y1 < y2 else -1
        err = dx + dy
        cx, cy = x1, y1
        while True:
            is_start = cx == x1 and cy == y1
            is_end = cx == x2 and cy == y2
            pois = (y1 <= y2) if is_start else ((y2 <= y1) if is_end else False)
            if 0 <= cy < ts:
                row = rows.setdefault(cy, {})
                ent = row.get(i)
                if ent is None:
                    row[i] = [cx, cx, pois]
                else:
                    ent[0] = min(ent[0], cx)
                    ent[1] = max(ent[1], cx)
                    ent[2] = ent[2] or pois
            if is_end:
                break
            e2 = 2 * err
            if e2 >= dy:
                err += dy
                cx += sx
            if e2 <= dx:
                err += dx
                cy += sy
    spans: List[Tuple[int, int, int]] = []
    for y in sorted(rows):
        good = [ent for _, ent in sorted(rows[y].items()) if not ent[2]]
        good.sort(key=lambda ent: ent[0])  # stable
        for k in range(0, len(good) - 1, 2):
            lo = max(good[k][0], 0)
            hi = min(good[k + 1][1], ts - 1)
            if lo <= hi:
                spans.append((y, lo, hi))
    return np.asarray(spans, dtype=np.int32).reshape(-1, 3)
