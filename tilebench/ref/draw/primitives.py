"""Host-side primitive assembly: styled entities -> device chunk stream.

Converts one tile's paint-ordered styled entities into the flat,
statically-shaped arrays consumed by the device renderers
(`ops/render_jnp.py` / `ops/render_pallas.py`).  This replaces the
reference's per-entity mutate-a-buffer loop (drawer.rs) with an
explicit command stream:

  passes: Fill (ways + multipolygons) -> Casing (ways) -> Stroke (ways)
  (drawer.rs:93-100), each styled entity one primitive = one
  "generation" (max-alpha within, src-over between).

Projection matches Point::from_node (tile.rs:103-106, point.rs:11-19):
tile-relative f64 Mercator, scaled, rounded half-away-from-zero to i32.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from tilebench.ref.core.tile import Tile, coords_to_xy
from tilebench.ref.geodata.reader import Multipolygon, Way
from tilebench.ref.mapcss.styler import LineCap, Style, Styler
from tilebench.ref.ops.coverage_np import (
    LINE_CAP_BUTT,
    LINE_CAP_ROUND,
    LINE_CAP_SQUARE,
    compute_dash_profile,
)

_CAP_TO_INT = {
    None: LINE_CAP_BUTT,
    LineCap.BUTT: LINE_CAP_BUTT,
    LineCap.ROUND: LINE_CAP_ROUND,
    LineCap.SQUARE: LINE_CAP_SQUARE,
}


def round_half_away(x: np.ndarray) -> np.ndarray:
    """Rust f64::round(): half cases away from zero (np.round is banker's)."""
    return np.sign(x) * np.floor(np.abs(x) + 0.5)


def project_points(lats, lons, tile: Tile, scale: float) -> np.ndarray:
    """(N, 2) int32 tile-relative pixel coordinates."""
    x, y = coords_to_xy(lats, lons, tile.zoom)
    x = x - float(tile.x * 256)
    y = y - float(tile.y * 256)
    pts = np.stack([round_half_away(x * scale), round_half_away(y * scale)], axis=-1)
    return np.clip(pts, -(2**31), 2**31 - 1).astype(np.int64)


@dataclass
class StrokePrim:
    kind: str  # "stroke"
    color: Tuple[int, int, int]
    opacity: float
    half_width: float
    # Per segment: (x1, y1, x2, y2), traveled-before, uses-outer-profile.
    segs: np.ndarray
    traveled: np.ndarray
    outer: np.ndarray
    dashes: Optional[Tuple[float, ...]]
    cap: int
    use_caps_for_dashes: bool
    raw_pairs: Optional[np.ndarray] = None  # original consecutive point pairs


@dataclass
class FillPrim:
    kind: str  # "fill"
    color: Optional[Tuple[int, int, int]]
    opacity: float
    edges: np.ndarray  # (E, 4)
    fill_image: Optional[str] = None  # tiled icon fill (PatternTable / oracle)


Prim = object  # FillPrim | StrokePrim

# |tile-relative coordinate| bound under which every int32 closed form in
# the device kernels is overflow-free (see ops/render_pallas.py).  Prims
# beyond it are rendered through the exact f64 host layer path.
FAST_COORD_BOUND = 12000

# Round caps make in_line non-monotone along the walk's perpendiculars;
# the device kernels check JMAX_CHAIN-1 = 11 intermediate positions
# (render_pallas.py), which is exact for round-capped half-widths up to
# ~7.5 px (PARITY.md).  Wider round-capped strokes route to the exact
# f64 host-layer path so the byte-exactness guarantee never silently
# lapses.
CHAIN_EXACT_HALF_WIDTH = 7.0


def _entity_point_pairs(entity, tile: Tile, scale: float) -> np.ndarray:
    """(N, 4) consecutive point pairs (way polyline / mp ring edges)."""
    if isinstance(entity, Multipolygon):
        chunks = []
        for pi in range(entity.polygon_count()):
            poly = entity.get_polygon(pi)
            lats, lons = poly.node_latlons()
            pts = project_points(lats, lons, tile, scale)
            if len(pts) >= 2:
                chunks.append(np.concatenate([pts[:-1], pts[1:]], axis=1))
        if not chunks:
            return np.zeros((0, 4), dtype=np.int64)
        return np.concatenate(chunks, axis=0)
    lats, lons = entity.node_latlons()
    pts = project_points(lats, lons, tile, scale)
    if len(pts) < 2:
        return np.zeros((0, 4), dtype=np.int64)
    return np.concatenate([pts[:-1], pts[1:]], axis=1)


def _push_away_from(p, other, by: float) -> Tuple[int, int]:
    dist = float(np.sqrt(float((p[0] - other[0]) ** 2 + (p[1] - other[1]) ** 2)))
    f = by / dist
    return (
        int(p[0] + round_half_away(np.float64((p[0] - other[0]) * f))),
        int(p[1] + round_half_away(np.float64((p[1] - other[1]) * f))),
    )


def _cull_view(segs, travs, outer, hw: float, view_px: int):
    """Drop segments whose bbox (with the kernel's paint margin) cannot
    touch the [0, view_px) canvas.  Painted pixels of a segment lie
    within ceil(hw)+1 of its endpoint bbox (feather reach hw+0.5, round
    caps <= hw), so this is output-invariant; neighbor-tile geometry
    routinely leaves >50% of a polyline out of view.  The oracle/CPU
    path renders from `raw_pairs` and is unaffected."""
    m = int(np.ceil(hw)) + 3
    x1, y1, x2, y2 = segs[:, 0], segs[:, 1], segs[:, 2], segs[:, 3]
    keep = (
        (np.minimum(x1, x2) - m < view_px)
        & (np.maximum(x1, x2) + m >= 0)
        & (np.minimum(y1, y2) - m < view_px)
        & (np.maximum(y1, y2) + m >= 0)
    )
    if keep.all():
        return segs, travs, outer
    return segs[keep], travs[keep], outer[keep]


def make_stroke_prim(
    pairs: np.ndarray,
    width: float,
    color: Tuple[int, int, int],
    opacity: float,
    dashes: Optional[Sequence[float]],
    cap: int,
    use_caps_for_dashes: bool,
    view_px: Optional[int] = None,
) -> StrokePrim:
    """Expand a polyline into body + outer-cap segments with arc-length
    phases (line.rs:9-61)."""
    hw = width / 2.0
    has_caps = cap in (LINE_CAP_ROUND, LINE_CAP_SQUARE)
    n = pairs.shape[0]
    pairs = np.asarray(pairs, dtype=np.int64)
    d = (pairs[:, 2:] - pairs[:, :2]).astype(np.float64)
    seg_lens = np.sqrt(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1])
    nondeg = (pairs[:, 0] != pairs[:, 2]) | (pairs[:, 1] != pairs[:, 3])
    trav_before = np.concatenate(([0.0], np.cumsum(seg_lens)[:-1]))

    segs_arr = pairs[nondeg]
    travs_arr = trav_before[nondeg]

    cap_rows = []
    if has_caps and n:
        if nondeg[0]:
            p1 = (int(pairs[0, 0]), int(pairs[0, 1]))
            p2 = (int(pairs[0, 2]), int(pairs[0, 3]))
            ce = _push_away_from(p1, p2, hw)
            if ce != p1:
                cap_rows.append((*p1, *ce))
        if nondeg[-1]:
            p1 = (int(pairs[-1, 0]), int(pairs[-1, 1]))
            p2 = (int(pairs[-1, 2]), int(pairs[-1, 3]))
            ce = _push_away_from(p2, p1, hw)
            if ce != p2:
                cap_rows.append((*p2, *ce))
    nb = segs_arr.shape[0]
    if cap_rows:
        segs_out = np.concatenate(
            [segs_arr, np.asarray(cap_rows, dtype=np.int64)], axis=0
        )
        travs_out = np.concatenate([travs_arr, np.zeros(len(cap_rows))])
        outer_out = np.concatenate(
            [np.zeros(nb, dtype=bool), np.ones(len(cap_rows), dtype=bool)]
        )
    else:
        segs_out = segs_arr
        travs_out = travs_arr
        outer_out = np.zeros(nb, dtype=bool)
    segs_out = segs_out.reshape(-1, 4)
    if view_px is not None:
        segs_out, travs_out, outer_out = _cull_view(
            segs_out, travs_out, outer_out, hw, view_px
        )
    return StrokePrim(
        kind="stroke",
        color=color,
        opacity=opacity,
        half_width=hw,
        segs=segs_out,
        traveled=travs_out,
        outer=outer_out,
        dashes=tuple(dashes) if dashes is not None else None,
        cap=cap,
        use_caps_for_dashes=use_caps_for_dashes,
        raw_pairs=pairs,
    )


def make_stroke_prims_batch(requests, view_px: Optional[int] = None) -> List[StrokePrim]:
    """Vectorized `make_stroke_prim` over many polylines (the host
    assembly hot path): one concatenated diff/sqrt pass, per-row 2D
    cumsum for the arc-length phases (identical left-to-right addition
    order as the per-prim cumsum, so results match bit-for-bit), and
    vectorized cap extension.

    `requests` rows: (pairs, width, color, opacity, dashes, cap,
    use_caps_for_dashes).  Equivalent to
    `[make_stroke_prim(*r) for r in requests]`.
    """
    n_req = len(requests)
    if n_req == 0:
        return []
    pairs_list = [np.asarray(r[0], dtype=np.int64).reshape(-1, 4) for r in requests]
    lens = np.fromiter((p.shape[0] for p in pairs_list), np.int64, n_req)
    total = int(lens.sum())
    if total == 0:
        return [make_stroke_prim(*r, view_px=view_px) for r in requests]
    if n_req > 1 and n_req * int(lens.max()) > 4_000_000:
        # One huge polyline would blow up the padded cumsum matrix;
        # split (order-preserving — results are per-request).
        mid = n_req // 2
        return make_stroke_prims_batch(requests[:mid], view_px) + make_stroke_prims_batch(
            requests[mid:], view_px
        )
    allp = np.concatenate([p for p in pairs_list if p.shape[0]], axis=0)
    offs = np.zeros(n_req + 1, np.int64)
    np.cumsum(lens, out=offs[1:])

    d = (allp[:, 2:] - allp[:, :2]).astype(np.float64)
    seg_lens = np.sqrt(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1])
    nondeg = (allp[:, 0] != allp[:, 2]) | (allp[:, 1] != allp[:, 3])

    # Exclusive per-prim cumsum with the exact per-prim addition order:
    # rows of a padded 2D matrix accumulate independently.
    max_len = int(lens.max())
    mat = np.zeros((n_req, max_len))
    row_idx = np.repeat(np.arange(n_req), lens)
    col_idx = np.arange(total) - np.repeat(offs[:-1], lens)
    mat[row_idx, col_idx] = seg_lens
    np.cumsum(mat, axis=1, out=mat)
    trav_before = np.empty(total)
    trav_before[col_idx == 0] = 0.0
    nz = col_idx > 0
    trav_before[nz] = mat[row_idx[nz], col_idx[nz] - 1]

    out: List[StrokePrim] = []
    for ri, (pairs, width, color, opacity, dashes, cap, use_caps) in enumerate(requests):
        hw = width / 2.0
        s, e = int(offs[ri]), int(offs[ri + 1])
        pr = allp[s:e]
        nd = nondeg[s:e]
        segs_arr = pr[nd]
        travs_arr = trav_before[s:e][nd]
        cap_rows = []
        if cap in (LINE_CAP_ROUND, LINE_CAP_SQUARE) and e > s:
            if nd[0]:
                p1 = (int(pr[0, 0]), int(pr[0, 1]))
                p2 = (int(pr[0, 2]), int(pr[0, 3]))
                ce = _push_away_from(p1, p2, hw)
                if ce != p1:
                    cap_rows.append((*p1, *ce))
            if nd[-1]:
                p1 = (int(pr[-1, 0]), int(pr[-1, 1]))
                p2 = (int(pr[-1, 2]), int(pr[-1, 3]))
                ce = _push_away_from(p2, p1, hw)
                if ce != p2:
                    cap_rows.append((*p2, *ce))
        nb = segs_arr.shape[0]
        if cap_rows:
            segs_out = np.concatenate(
                [segs_arr, np.asarray(cap_rows, dtype=np.int64)], axis=0
            )
            travs_out = np.concatenate([travs_arr, np.zeros(len(cap_rows))])
            outer_out = np.concatenate(
                [np.zeros(nb, dtype=bool), np.ones(len(cap_rows), dtype=bool)]
            )
        else:
            segs_out = segs_arr
            travs_out = travs_arr
            outer_out = np.zeros(nb, dtype=bool)
        segs_out = segs_out.reshape(-1, 4)
        if view_px is not None:
            segs_out, travs_out, outer_out = _cull_view(
                segs_out, travs_out, outer_out, hw, view_px
            )
        out.append(
            StrokePrim(
                kind="stroke",
                color=color,
                opacity=opacity,
                half_width=hw,
                segs=segs_out,
                traveled=travs_out,
                outer=outer_out,
                dashes=tuple(dashes) if dashes is not None else None,
                cap=cap,
                use_caps_for_dashes=use_caps,
                raw_pairs=pairs_list[ri],
            )
        )
    return out


def assemble_tile_prims(
    entities, tile: Tile, scale: float, styler: Styler
) -> List[Prim]:
    """Paint-ordered fill/casing/stroke primitives for one tile.

    Mirrors Drawer::draw_to_pixels passes (labels are handled separately
    on the host).  Entities styled once; geometry projected once per
    entity and reused across passes.
    """
    styled = styler.style_areas(entities.ways, entities.multipolygons, tile.zoom, False)
    prims: List[Prim] = []
    pair_cache: Dict[int, np.ndarray] = {}

    # Project every referenced node once (batched trig beats per-entity
    # calls by an order of magnitude on dense tiles).
    id_arrays = [w.node_ids for w in entities.ways]
    for mp in entities.multipolygons:
        for pi in range(mp.polygon_count()):
            id_arrays.append(mp.get_polygon(pi).node_ids)
    if id_arrays:
        all_ids = np.unique(np.concatenate(id_arrays))
        lats, lons = entities.ways[0].reader.node_coords(all_ids) if entities.ways else (
            entities.multipolygons[0].reader.node_coords(all_ids)
        )
        all_pts = project_points(lats, lons, tile, scale)
    else:
        all_ids = np.zeros(0, dtype=np.int64)
        all_pts = np.zeros((0, 2), dtype=np.int64)

    def pts_for_ids(node_ids) -> np.ndarray:
        idx = np.searchsorted(all_ids, node_ids)
        return all_pts[idx]

    def pairs_for(entity) -> np.ndarray:
        key = id(entity)
        got = pair_cache.get(key)
        if got is not None:
            return got
        if isinstance(entity, Multipolygon):
            chunks = []
            for pi in range(entity.polygon_count()):
                pts = pts_for_ids(entity.get_polygon(pi).node_ids)
                if len(pts) >= 2:
                    chunks.append(np.concatenate([pts[:-1], pts[1:]], axis=1))
            got = (
                np.concatenate(chunks, axis=0)
                if chunks
                else np.zeros((0, 4), dtype=np.int64)
            )
        else:
            pts = pts_for_ids(entity.node_ids)
            got = (
                np.concatenate([pts[:-1], pts[1:]], axis=1)
                if len(pts) >= 2
                else np.zeros((0, 4), dtype=np.int64)
            )
        pair_cache[key] = got
        return got

    scale_dashes = lambda dashes: (
        [d * scale for d in dashes] if dashes is not None else None
    )

    # Pass 1: fills (ways + multipolygons).
    for entity, style in styled:
        if style.fill_color is not None:
            prims.append(
                FillPrim(
                    kind="fill",
                    color=style.fill_color,
                    opacity=style.fill_opacity if style.fill_opacity is not None else 1.0,
                    edges=pairs_for(entity),
                )
            )
        elif style.fill_image is not None:
            prims.append(
                FillPrim(
                    kind="fill",
                    color=None,
                    opacity=style.fill_opacity if style.fill_opacity is not None else 1.0,
                    edges=pairs_for(entity),
                    fill_image=style.fill_image,
                )
            )

    # Pass 2: casings (ways only); pass 3: strokes (ways only).
    # Collected first, then built in one vectorized batch.
    stroke_reqs = []
    for entity, style in styled:
        if isinstance(entity, Way) and style.casing_color is not None and style.casing_width is not None:
            stroke_reqs.append(
                (
                    pairs_for(entity),
                    style.casing_width * scale,
                    style.casing_color,
                    1.0,
                    scale_dashes(style.casing_dashes),
                    _CAP_TO_INT[style.casing_line_cap],
                    styler.use_caps_for_dashes,
                )
            )
    for entity, style in styled:
        if isinstance(entity, Way) and style.color is not None:
            stroke_reqs.append(
                (
                    pairs_for(entity),
                    scale * (style.width if style.width is not None else 1.0),
                    style.color,
                    style.opacity if style.opacity is not None else 1.0,
                    scale_dashes(style.dashes),
                    _CAP_TO_INT[style.line_cap],
                    styler.use_caps_for_dashes,
                )
            )
    prims.extend(make_stroke_prims_batch(stroke_reqs, view_px=int(round(256 * scale))))

    return prims


# --------------------------------------------------------------------------
# Batch building for the device path
# --------------------------------------------------------------------------

class ProfileTable:
    """Deduplicated dash-profile table for one batch; index 0 = no dashes."""

    def __init__(self, ds_max: int = 4):
        self.ds_max = ds_max
        self._keys: Dict[Tuple, int] = {None: 0}
        self.rows: List[np.ndarray] = [np.full((ds_max, 8), np.inf)]
        self.totals: List[float] = [0.0]

    def index_for(
        self, half_width: float, dashes: Optional[Tuple[float, ...]], cap: int
    ) -> int:
        if dashes is None:
            return 0
        key = (round(half_width, 9), dashes, cap)
        idx = self._keys.get(key)
        if idx is not None:
            return idx
        prof = compute_dash_profile(half_width, list(dashes), cap)
        padded = np.full((self.ds_max, 8), np.inf)
        n = min(prof.segments.shape[0], self.ds_max)
        if prof.segments.shape[0] > self.ds_max:
            raise ValueError(
                f"dash profile with {prof.segments.shape[0]} segments exceeds ds_max={self.ds_max}"
            )
        padded[:n] = prof.segments[:n]
        idx = len(self.rows)
        self._keys[key] = idx
        self.rows.append(padded)
        self.totals.append(prof.total_len)
        return idx

    def arrays(self, dtype=np.float64) -> Tuple[np.ndarray, np.ndarray]:
        return (
            np.stack(self.rows).astype(dtype),
            np.asarray(self.totals, dtype=dtype),
        )

    def has_round_caps(self) -> bool:
        """True if any profile row carries a round-cap original interval
        (the only case where the walk-chain visited rule is needed)."""
        return any(
            bool(np.any((r[:, 0] < np.inf) & (r[:, 5] > 0))) for r in self.rows
        )

    def chain_free_mask(self) -> np.ndarray:
        """Per-profile bool: True iff no round-cap originals, i.e. walk
        aliveness is purely geometric and the profile may ride the
        work-item path (render_pallas KIND_STROKE_DASH*)."""
        return np.asarray(
            [
                not bool(np.any((r[:, 0] < np.inf) & (r[:, 5] > 0)))
                for r in self.rows
            ],
            dtype=bool,
        )


class PatternTable:
    """Deduplicated tiled fill-image table for one batch.

    Icons are decoded (premultiplied f64, labels/icons.py), tiled by
    coordinate modulo to the full canvas (the reference samples
    `icon[(y % h, x % w)]`, fill.rs:36-40), and stored as (4, ts, ts)
    f32 channel-major planes the Pallas kernel can block-load."""

    def __init__(self, icon_cache, ts: int):
        self.icon_cache = icon_cache
        self.ts = ts
        self._idx: Dict[str, Optional[int]] = {}
        self.tiles: List[np.ndarray] = []

    def index_for(self, icon_name: str) -> Optional[int]:
        """Pattern index, or None if the icon can't be loaded (the
        reference silently draws nothing then)."""
        if icon_name in self._idx:
            return self._idx[icon_name]
        icon = self.icon_cache.get(icon_name) if self.icon_cache is not None else None
        idx: Optional[int] = None
        if icon is not None and icon.width > 0 and icon.height > 0:
            reps_y = -(-self.ts // icon.height)
            reps_x = -(-self.ts // icon.width)
            tiled = np.tile(icon.rgba, (reps_y, reps_x, 1))[: self.ts, : self.ts]
            self.tiles.append(
                np.ascontiguousarray(tiled.transpose(2, 0, 1).astype(np.float32))
            )
            idx = len(self.tiles) - 1
        self._idx[icon_name] = idx
        return idx

    def add_layer(self, layer: np.ndarray) -> int:
        """Register a host-rasterized premultiplied (4, ts, ts) layer
        (used for fills too large for one kernel chunk)."""
        self.tiles.append(np.ascontiguousarray(layer.astype(np.float32)))
        return len(self.tiles) - 1

    def array(self) -> np.ndarray:
        """Stacked (N, 4, ts, ts) planes, cached per table version — a
        persistent serving table would otherwise re-stack tens of MB on
        every warm batch."""
        if not self.tiles:
            return np.zeros((1, 4, self.ts, self.ts), dtype=np.float32)
        cached = getattr(self, "_stack_cache", None)
        if cached is not None and cached[0] == len(self.tiles):
            return cached[1]
        out = np.stack(self.tiles)
        self._stack_cache = (len(self.tiles), out)
        return out


@dataclass
class TileStream:
    """Flat per-tile chunk stream (numpy; padded/stacked by build_batch)."""
    geom: List[np.ndarray] = field(default_factory=list)
    traveled: List[np.ndarray] = field(default_factory=list)
    profile: List[np.ndarray] = field(default_factory=list)
    chunk_kind: List[int] = field(default_factory=list)
    chunk_off: List[int] = field(default_factory=list)
    chunk_cnt: List[int] = field(default_factory=list)
    chunk_last: List[bool] = field(default_factory=list)
    chunk_color: List[Tuple[float, float, float]] = field(default_factory=list)
    chunk_opacity: List[float] = field(default_factory=list)
    chunk_hw: List[float] = field(default_factory=list)
    chunk_pat: List[int] = field(default_factory=list)  # fill-image index, -1 = none
    # True where a fill chunk's geometry is already scanline spans
    # (y, x_from, x_to, 0) rather than edges (see draw/spans.py).
    chunk_spans: List[bool] = field(default_factory=list)
    geom_len: int = 0
    has_icon_fills: bool = False  # icon fills present but no PatternTable


def _push_fill_spans(
    ts: TileStream, group, spans_by_id: Dict[int, np.ndarray],
    kind: int = 1, pat: int = -1, opacity: Optional[float] = None,
) -> None:
    """Concatenate the group's pre-extracted scanline spans
    (draw/spans.py), sort by row, and push one span chunk per
    generation (split at CH downstream)."""
    parts = [spans_by_id[id(p)] for p in group if id(p) in spans_by_id]
    parts = [s for s in parts if s.shape[0]]
    if not parts:
        return
    spans = np.concatenate(parts, axis=0) if len(parts) > 1 else parts[0]
    spans = spans[np.argsort(spans[:, 0], kind="stable")]
    g4 = np.concatenate(
        [spans.astype(np.int64), np.zeros((spans.shape[0], 1), np.int64)], axis=1
    )
    first = group[0]
    z = np.zeros(g4.shape[0])
    _push_chunk(
        ts, kind, g4, z, z.astype(np.int64), True,
        first.color if first.color is not None else (0, 0, 0),
        first.opacity if opacity is None else opacity,
        0.0, pat=pat, spans=True,
    )


def _push_chunk(
    ts: TileStream, kind, geom, traveled, profile, last, color, opacity, hw,
    pat=-1, spans=False,
):
    ts.geom.append(geom)
    ts.traveled.append(traveled)
    ts.profile.append(profile)
    ts.chunk_kind.append(kind)
    ts.chunk_off.append(ts.geom_len)
    ts.chunk_cnt.append(geom.shape[0])
    ts.chunk_last.append(last)
    ts.chunk_color.append(tuple(c / 255.0 for c in color))
    ts.chunk_opacity.append(opacity)
    ts.chunk_hw.append(hw)
    ts.chunk_pat.append(pat)
    ts.chunk_spans.append(spans)
    ts.geom_len += geom.shape[0]


def _stream_fill_layer(
    ts: TileStream, prim, patterns: Optional[PatternTable]
) -> None:
    """Fill primitive too large for one kernel chunk (> CH edges; the
    parity/rank fill rule needs every edge at once, so it cannot split
    across chunks).  Rasterized on the host by the exact f64 dense model
    (ops/coverage_np.py) into a premultiplied layer that the kernel
    src-overs as a pattern block (KIND_LAYER) at the correct paint
    position.  Also bypasses the int32 coordinate bound."""
    from tilebench.ref.ops import coverage_np as cov

    if patterns is None:
        ts.has_icon_fills = True
        return
    if prim.edges.shape[0] == 0:
        return
    size = patterns.ts
    if prim.fill_image is not None:
        if patterns.icon_cache is None:
            ts.has_icon_fills = True  # no icon source here: CPU fallback
            return
        icon_idx = patterns.index_for(prim.fill_image)
        if icon_idx is None:
            return  # unloadable icon: the reference draws nothing
        mask = cov.fill_alpha(prim.edges, 1.0, size)
        layer = patterns.tiles[icon_idx].astype(np.float64) * mask[None]
    else:
        alpha = cov.fill_alpha(prim.edges, prim.opacity, size)
        layer = np.empty((4, size, size))
        for c in range(3):
            layer[c] = (prim.color[c] / 255.0) * alpha
        layer[3] = alpha
    nz_r = np.flatnonzero(layer[3].any(axis=1))
    if nz_r.size == 0:
        return
    nz_c = np.flatnonzero(layer[3].any(axis=0))
    idx = patterns.add_layer(layer)
    bbox_geom = np.array(
        [[int(nz_c[0]), int(nz_r[0]), int(nz_c[-1]), int(nz_r[-1])]], dtype=np.int64
    )
    z = np.zeros(1)
    _push_chunk(
        ts, 6, bbox_geom, z, z.astype(np.int64), True, (0, 0, 0), 1.0, 0.0, pat=idx
    )


def _stream_stroke_layer(
    ts: TileStream, prim, patterns: Optional[PatternTable]
) -> None:
    """Stroke with coordinates beyond the int32-safe bound: rasterized
    on the host by the exact f64 dense model (polyline semantics incl.
    dash continuity and caps, ops/coverage_np.py) and blended as a
    KIND_LAYER pattern block."""
    from tilebench.ref.ops import coverage_np as cov

    if patterns is None:
        ts.has_icon_fills = True
        return
    pairs = prim.raw_pairs if prim.raw_pairs is not None else prim.segs[~prim.outer]
    if pairs.shape[0] == 0:
        return
    size = patterns.ts
    alpha = cov.polyline_stroke_alpha(
        pairs,
        prim.half_width,
        prim.opacity,
        list(prim.dashes) if prim.dashes is not None else None,
        prim.cap,
        prim.use_caps_for_dashes,
        size,
    )
    nz_r = np.flatnonzero(alpha.any(axis=1))
    if nz_r.size == 0:
        return
    nz_c = np.flatnonzero(alpha.any(axis=0))
    layer = np.empty((4, size, size))
    for c in range(3):
        layer[c] = (prim.color[c] / 255.0) * alpha
    layer[3] = alpha
    idx = patterns.add_layer(layer)
    bbox_geom = np.array(
        [[int(nz_c[0]), int(nz_r[0]), int(nz_c[-1]), int(nz_r[-1])]], dtype=np.int64
    )
    z = np.zeros(1)
    _push_chunk(
        ts, 6, bbox_geom, z, z.astype(np.int64), True, (0, 0, 0), 1.0, 0.0, pat=idx
    )


def _stream_icon_fill(
    ts: TileStream, prim, patterns: Optional[PatternTable],
    spans_by_id: Dict[int, np.ndarray],
) -> None:
    """Tiled fill-image primitive -> KIND_FILL_IMAGE span chunk (or CPU
    fallback flag when no pattern table).  The coverage mask is binary
    (the reference ignores fill-opacity for images, fill.rs:36-40), so
    the chunk opacity is forced to 1."""
    if prim.edges.shape[0] == 0:
        return
    if patterns is None or patterns.icon_cache is None:
        ts.has_icon_fills = True
        return
    pidx = patterns.index_for(prim.fill_image)
    if pidx is None:
        # Unloadable icon: the reference draws nothing for this area.
        return
    _push_fill_spans(ts, [prim], spans_by_id, kind=5, pat=pidx, opacity=1.0)


def _stream_prim(ts: TileStream, prim, profiles: ProfileTable, chunk_size: int) -> None:
    if isinstance(prim, FillPrim):
        if prim.fill_image is not None:
            ts.has_icon_fills = True
            return
        edges = prim.edges
        if edges.shape[0] == 0:
            return
        if edges.shape[0] > chunk_size:
            raise ValueError(
                f"fill primitive with {edges.shape[0]} edges exceeds chunk size {chunk_size}"
            )
        z = np.zeros(edges.shape[0])
        _push_chunk(ts, 1, edges, z, z.astype(np.int64), True,
                    prim.color, prim.opacity, 0.0)
    else:
        segs = prim.segs
        if segs.shape[0] == 0:
            return
        cap_for_dashes = prim.cap if prim.use_caps_for_dashes else LINE_CAP_BUTT
        body_idx = profiles.index_for(prim.half_width, prim.dashes, cap_for_dashes)
        outer_idx = profiles.index_for(prim.half_width, (0.0,), prim.cap)
        pidx = np.where(prim.outer, outer_idx, body_idx).astype(np.int64)
        n = segs.shape[0]
        for off in range(0, n, chunk_size):
            end = min(off + chunk_size, n)
            _push_chunk(ts, 2, segs[off:end], prim.traveled[off:end], pidx[off:end],
                        end == n, prim.color, prim.opacity, prim.half_width)


def stream_tile(
    prims: List[Prim],
    profiles: ProfileTable,
    chunk_size: int,
    patterns: Optional[PatternTable] = None,
) -> TileStream:
    ts = TileStream()

    def push_chunk(kind, geom, traveled, profile, last, color, opacity, hw, pat=-1):
        _push_chunk(ts, kind, geom, traveled, profile, last, color, opacity, hw, pat)

    for prim in prims:
        if isinstance(prim, FillPrim):
            if prim.fill_image is not None:
                edges = prim.edges
                if edges.shape[0] == 0:
                    continue
                if patterns is None or patterns.icon_cache is None:
                    # No icon source: fall back to the CPU path per tile.
                    ts.has_icon_fills = True
                    continue
                if edges.shape[0] > chunk_size:
                    raise ValueError(
                        f"fill primitive with {edges.shape[0]} edges exceeds chunk size {chunk_size}"
                    )
                pidx = patterns.index_for(prim.fill_image)
                if pidx is None:
                    continue  # unloadable icon: the reference draws nothing
                z = np.zeros(edges.shape[0])
                push_chunk(5, edges, z, z.astype(np.int64), True,
                           (0, 0, 0), 1.0, 0.0, pat=pidx)
                continue
            edges = prim.edges
            if edges.shape[0] == 0:
                continue
            if edges.shape[0] > chunk_size:
                raise ValueError(
                    f"fill primitive with {edges.shape[0]} edges exceeds chunk size {chunk_size}"
                )
            z = np.zeros(edges.shape[0])
            push_chunk(1, edges, z, z.astype(np.int64), True, prim.color, prim.opacity, 0.0)
        else:
            segs = prim.segs
            if segs.shape[0] == 0:
                continue
            cap_for_dashes = prim.cap if prim.use_caps_for_dashes else LINE_CAP_BUTT
            body_idx = profiles.index_for(prim.half_width, prim.dashes, cap_for_dashes)
            outer_idx = profiles.index_for(prim.half_width, (0.0,), prim.cap)
            pidx = np.where(prim.outer, outer_idx, body_idx).astype(np.int64)
            n = segs.shape[0]
            for off in range(0, n, chunk_size):
                end = min(off + chunk_size, n)
                push_chunk(
                    2, segs[off:end], prim.traveled[off:end], pidx[off:end],
                    end == n, prim.color, prim.opacity, prim.half_width,
                )
    return ts


def build_batch(
    tile_streams: List[TileStream],
    profiles: ProfileTable,
    chunk_size: int,
    dtype=np.float64,
    patterns: Optional[PatternTable] = None,
    ts: int = 256,
):
    """Stack per-tile streams into the padded TileBatch arrays."""
    from tilebench.ref.ops.render_dense import TileBatch
    from tilebench.ref.util import next_pow2

    T = len(tile_streams)
    # Bucket shapes to powers of two for stable jit signatures (the
    # persistent compilation cache then makes compiles one-time).
    C = next_pow2(max((len(s.chunk_kind) for s in tile_streams), default=1), 8)
    G = next_pow2(
        max((s.geom_len for s in tile_streams), default=1) + chunk_size, 64
    )

    geom = np.zeros((T, G, 4), dtype=np.int32)
    traveled = np.zeros((T, G), dtype=dtype)
    gprof = np.zeros((T, G), dtype=np.int32)
    kind = np.zeros((T, C), dtype=np.int32)
    off = np.zeros((T, C), dtype=np.int32)
    cnt = np.zeros((T, C), dtype=np.int32)
    last = np.zeros((T, C), dtype=bool)
    color = np.zeros((T, C, 3), dtype=dtype)
    opacity = np.zeros((T, C), dtype=dtype)
    hw = np.zeros((T, C), dtype=dtype)
    pat = np.full((T, C), -1, dtype=np.int32)

    for t, s in enumerate(tile_streams):
        if s.geom_len:
            g = np.concatenate(s.geom, axis=0)
            geom[t, : s.geom_len] = g
            traveled[t, : s.geom_len] = np.concatenate(s.traveled)
            gprof[t, : s.geom_len] = np.concatenate(s.profile)
        n = len(s.chunk_kind)
        if n:
            kind[t, :n] = s.chunk_kind
            off[t, :n] = s.chunk_off
            cnt[t, :n] = s.chunk_cnt
            last[t, :n] = s.chunk_last
            color[t, :n] = s.chunk_color
            opacity[t, :n] = s.chunk_opacity
            hw[t, :n] = s.chunk_hw
            pat[t, :n] = s.chunk_pat

    if patterns is not None and patterns.tiles:
        pat_arr = patterns.array().transpose(0, 2, 3, 1).astype(dtype)
        ts = patterns.ts
    else:
        pat_arr = np.zeros((1, ts, ts, 4), dtype=dtype)

    prof_rows, prof_totals = profiles.arrays(dtype)
    return TileBatch(
        geom=geom,
        geom_traveled=traveled,
        geom_profile=gprof,
        chunk_kind=kind,
        chunk_off=off,
        chunk_cnt=cnt,
        chunk_last=last,
        chunk_color=color,
        chunk_opacity=opacity,
        chunk_hw=hw,
        profiles=prof_rows,
        profile_total=prof_totals,
        chunk_pat=pat,
        patterns=pat_arr,
    )
