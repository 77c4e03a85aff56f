"""Primitive packing: merge small same-style primitives into shared chunks.

A z15 city tile has hundreds of 4-edge buildings and dozens of
same-class road strokes; giving each its own 128-slot chunk leaves the
kernel >90% idle.  Primitives may share a chunk (= one "generation":
per-pixel max-alpha, then one src-over blend) when that cannot change
the output:

* identical style payload (kind, color, opacity, and for strokes the
  half-width/dash/cap parameters), and
* pairwise disjoint bounding boxes (inflated by the stroke margin), so
  no pixel is touched by two members — max-within vs. src-over-between
  is then indistinguishable.

Fully-opaque color fills don't even need disjointness: with alpha 1,
max-within-generation and src-over-between-generations produce the
same pixel, so a whole same-style run shares one generation (fill
coverage is extracted per primitive as scanline spans — draw/spans.py
— so merging never mixes contours).

Within a maximal same-style run of the paint order, members may be
reordered (disjoint primitives' blends commute; overlapping ones stay
in separate chunks and keep their relative order).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from osm_renderer_tpu_torch.draw.primitives import FAST_COORD_BOUND, FillPrim, StrokePrim


def _style_key(p):
    if isinstance(p, FillPrim):
        return ("fill", p.color, p.opacity, p.fill_image)
    return (
        "stroke", p.color, p.opacity, p.half_width, p.dashes, p.cap,
        p.use_caps_for_dashes,
    )


def _bbox(p) -> Optional[Tuple[int, int, int, int]]:
    if isinstance(p, FillPrim):
        g = p.edges
        margin = 0
    else:
        g = p.segs
        margin = int(np.ceil(p.half_width)) + 2
    if g.shape[0] == 0:
        return None
    xs = g[:, [0, 2]]
    ys = g[:, [1, 3]]
    return (
        int(xs.min()) - margin,
        int(xs.max()) + margin,
        int(ys.min()) - margin,
        int(ys.max()) + margin,
    )


def _disjoint(a, b) -> bool:
    return a[1] < b[0] or b[1] < a[0] or a[3] < b[2] or b[3] < a[2]


def _geom_count(p) -> int:
    return p.edges.shape[0] if isinstance(p, FillPrim) else p.segs.shape[0]


def _precompute_pack_attrs(prims: List[object]):
    """Vectorized `_bbox` over the whole prim list.

    One concatenate + `reduceat` sweep replaces per-prim numpy reductions
    (which dominate host assembly time on dense tiles).  Results match
    the scalar helper exactly; it remains as the executable spec."""
    n = len(prims)
    geoms = [(p.edges if isinstance(p, FillPrim) else p.segs) for p in prims]
    lens = np.fromiter((g.shape[0] for g in geoms), np.int64, n)
    total = int(lens.sum())
    bboxes: List[Optional[Tuple[int, int, int, int]]] = [None] * n
    if total == 0:
        return lens, bboxes

    margins = np.fromiter(
        (
            0 if isinstance(p, FillPrim) else int(np.ceil(p.half_width)) + 2
            for p in prims
        ),
        np.int64,
        n,
    )
    allg = np.concatenate([g for g in geoms if g.shape[0]], axis=0)
    offs = np.zeros(n + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    nz = lens > 0
    starts_nz = offs[:-1][nz]

    xlo = np.minimum(allg[:, 0], allg[:, 2])
    xhi = np.maximum(allg[:, 0], allg[:, 2])
    ylo = np.minimum(allg[:, 1], allg[:, 3])
    yhi = np.maximum(allg[:, 1], allg[:, 3])
    m_nz = margins[nz]
    box_arr = np.stack(
        [
            np.minimum.reduceat(xlo, starts_nz) - m_nz,
            np.maximum.reduceat(xhi, starts_nz) + m_nz,
            np.minimum.reduceat(ylo, starts_nz) - m_nz,
            np.maximum.reduceat(yhi, starts_nz) + m_nz,
        ],
        axis=1,
    ).tolist()
    for k, i in enumerate(np.flatnonzero(nz)):
        bboxes[i] = tuple(box_arr[k])
    return lens, bboxes


def pack_prims(prims: List[object], capacity: int) -> List[List[object]]:
    """Paint-ordered primitives -> list of chunk groups (lists of prims).

    Oversize primitives (> capacity geometry) are returned as singleton
    groups and handled by the caller's chunk splitting.
    """
    lens, bboxes = _precompute_pack_attrs(prims)
    # Prims with coordinates beyond the int32-safe bound are flagged for
    # the host-layer path (stream_tile_packed) and never packed; so are
    # round-capped strokes wider than the walk-chain exactness bound
    # (primitives.CHAIN_EXACT_HALF_WIDTH).
    from osm_renderer_tpu_torch.draw.primitives import CHAIN_EXACT_HALF_WIDTH
    from osm_renderer_tpu_torch.ops.coverage_np import LINE_CAP_ROUND

    for k, bb in enumerate(bboxes):
        if bb is not None and (
            max(abs(bb[0]), abs(bb[1]), abs(bb[2]), abs(bb[3])) >= FAST_COORD_BOUND
        ):
            prims[k]._coord_oob = True
        p = prims[k]
        if (
            isinstance(p, StrokePrim)
            and p.cap == LINE_CAP_ROUND
            and p.half_width > CHAIN_EXACT_HALF_WIDTH
        ):
            p._coord_oob = True  # exact f64 host-layer path
        if (
            isinstance(p, StrokePrim)
            and p.dashes
            and p.raw_pairs is not None
            and p.raw_pairs.size
            and int(np.abs(p.raw_pairs).max()) >= FAST_COORD_BOUND
        ):
            # Dash phases depend on arc length over the WHOLE polyline;
            # the view cull can leave only small-coordinate segments of
            # a far-reaching way, whose f32 `traveled` would lose the
            # byte-exactness the coordinate bound guards.  Route by the
            # raw (pre-cull) extent, as before the cull existed.
            p._coord_oob = True
    groups: List[List[object]] = []
    i = 0
    n = len(prims)
    while i < n:
        key = _style_key(prims[i])
        j = i
        while j < n and _style_key(prims[j]) == key:
            j += 1

        is_fill_run = isinstance(prims[i], FillPrim)
        small = []
        big = []
        for k in range(i, j):
            if getattr(prims[k], "fill_image", None) is not None or getattr(
                prims[k], "_coord_oob", False
            ):
                big.append(k)
            elif is_fill_run:
                # Fill chunks split freely across span chunks, so no
                # capacity constraint applies.
                (small if lens[k] > 0 else big).append(k)
            elif lens[k] <= capacity:
                small.append(k)
            else:
                big.append(k)

        if is_fill_run and small and prims[i].opacity == 1.0:
            # Fully-opaque fills: one generation for the whole style
            # run, no disjointness scan (see module docstring).
            groups.append([prims[k] for k in small])
            for k in big:
                groups.append([prims[k]])
            i = j
            continue

        # Spatial sort improves row-block locality.
        with_bb = [k for k in small if bboxes[k] is not None]
        with_bb.sort(key=lambda k: (bboxes[k][2] // 64, bboxes[k][0]))

        # First-fit over packs, vectorized: every placed member's bbox
        # lives in one flat array tagged with its pack id; a candidate
        # overlaps pack p iff it overlaps any member tagged p.
        n_small = len(with_bb)
        mem_bb = np.empty((n_small, 4), dtype=np.int64)
        mem_pack = np.empty(n_small, dtype=np.int64)
        pack_counts = np.empty(n_small, dtype=np.int64)
        m = 0
        n_packs = 0
        pack_members: List[List[object]] = []
        for k in with_bb:
            bb = np.asarray(bboxes[k], dtype=np.int64)
            cnt = int(lens[k])
            ok = pack_counts[:n_packs] + cnt <= capacity
            if m and ok.any():
                B = mem_bb[:m]
                overlap = ~(
                    (bb[1] < B[:, 0]) | (B[:, 1] < bb[0])
                    | (bb[3] < B[:, 2]) | (B[:, 3] < bb[2])
                )
                ok[mem_pack[:m][overlap]] = False
            cand = np.flatnonzero(ok)
            if cand.size:
                pi = int(cand[0])
                pack_members[pi].append(prims[k])
                pack_counts[pi] += cnt
            else:
                pi = n_packs
                pack_members.append([prims[k]])
                pack_counts[pi] = cnt
                n_packs += 1
            mem_bb[m] = bb
            mem_pack[m] = pi
            m += 1

        for members in pack_members:
            groups.append(members)
        for k in big:
            groups.append([prims[k]])
        i = j
    return groups
