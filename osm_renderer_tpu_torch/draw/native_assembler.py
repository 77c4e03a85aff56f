"""Native (C++) tile assembly: styled entities -> TileChunks.

Drives `native/assembler.cpp`, an exact transcription of the Python
pipeline assemble_tile_prims -> stream_tile_packed -> build_tile_chunks
(draw/primitives.py, draw/packing.py, draw/spans.py,
ops/render_pallas.py).  Python keeps styling, projection, profile /
pattern table management and the rare host-rasterized layer path
(out-of-bound or oversize primitives, returned by the native call as
placeholder chunks and spliced back here).

Cold host assembly is the serving path's bottleneck (VERDICT r2 #2:
~23 ms/tile of per-primitive numpy); the native assembler does the
same work in ~1-2 ms/tile.  Byte-exact equality with the Python path
is pinned by tests/test_native_assembler.py.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import numpy as np

from osm_renderer_tpu_torch.core.tile import Tile
from osm_renderer_tpu_torch.draw import primitives as prim_mod
from osm_renderer_tpu_torch.draw.primitives import (
    CHAIN_EXACT_HALF_WIDTH,
    FillPrim,
    StrokePrim,
    _CAP_TO_INT,
    make_stroke_prim,
    project_points,
)
from osm_renderer_tpu_torch.geodata.reader import Multipolygon, Way
from osm_renderer_tpu_torch.ops.coverage_np import LINE_CAP_ROUND
from osm_renderer_tpu_torch.ops.chunk_layout import TileChunks, _pad_group, build_tile_chunks
from osm_renderer_tpu_torch.utils.torch_setup import host_lib_path

_I64 = np.ctypeslib.ndpointer(dtype=np.int64, flags="C_CONTIGUOUS")
_I32 = np.ctypeslib.ndpointer(dtype=np.int32, flags="C_CONTIGUOUS")
_F64 = np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS")
_F32 = np.ctypeslib.ndpointer(dtype=np.float32, flags="C_CONTIGUOUS")
_U8 = np.ctypeslib.ndpointer(dtype=np.uint8, flags="C_CONTIGUOUS")

_native = None
_native_failed = False
_lock = threading.Lock()

IT_CAP = 2048


def get_native():
    global _native, _native_failed
    if _native is not None or _native_failed:
        return _native
    with _lock:
        if _native is not None or _native_failed:
            return _native
        try:
            lib = ctypes.CDLL(host_lib_path("assembler"))
            lib.osmr_assemble_tile.restype = ctypes.c_int64
            lib.osmr_assemble_tile.argtypes = [
                _I64, _I64, _I64, ctypes.c_int64, ctypes.c_int32,
                _U8, _I64, _F64, _F64, _F64, _I32, _I32, _U8, _U8, _I32,
                _I64, _U8, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                ctypes.c_int64,
                _I32, _F32, _I32, _F32,
                _I32, _I32, _I32, _I32, _I32, _I32, _I32,
                _F32, _F32, _F32, _I32, _I32, _I32, _I32, _I32,
            ]
            _native = lib
        except Exception:
            _native_failed = True
    return _native


class _Requests:
    """Flat request arrays in paint order."""

    def __init__(self):
        self.kind = []
        self.style_key = []
        self.color = []
        self.opacity = []
        self.hw = []
        self.body_pidx = []
        self.outer_pidx = []
        self.cap = []
        self.force_layer = []
        self.pat = []
        self.req_rings = []   # (ring_off, ring_cnt)
        self.rings = []       # (refs_off, refs_len)
        self.entity = []      # entity per request (for the layer path)
        self.dashes = []      # scaled dashes tuple or None (layer path)
        self.use_caps = []
        self._key_map = {}

    def key_for(self, tup) -> int:
        got = self._key_map.get(tup)
        if got is None:
            got = len(self._key_map)
            self._key_map[tup] = got
        return got


class _OutBuffers:
    """Reusable per-thread output arrays (allocation dominates small
    tiles otherwise)."""

    def __init__(self, cap: int):
        self.cap = cap
        z = lambda *shape: np.zeros(shape, np.int32)
        self.geom = z(cap, 4, 128)
        self.trav = np.zeros((cap, 1, 128), np.float32)
        self.sprof = z(cap, 1, 128)
        self.aux = np.zeros((cap, 4, 128), np.float32)
        self.kind, self.cnt, self.last = z(cap), z(cap), z(cap)
        self.y0, self.nb, self.py0, self.pnb = z(cap), z(cap), z(cap), z(cap)
        self.color = np.zeros((cap, 3), np.float32)
        self.op = np.zeros((cap,), np.float32)
        self.hw = np.zeros((cap,), np.float32)
        self.pat = z(cap)
        self.items = z(cap, IT_CAP)
        self.item_len = z(cap)
        self.isec = z(cap, 12)
        self.ph = z(cap)


_tls = threading.local()


def _buffers(cap_needed: int) -> _OutBuffers:
    buf = getattr(_tls, "buf", None)
    if buf is None or buf.cap < cap_needed:
        cap = 256
        while cap < cap_needed:
            cap *= 2
        buf = _OutBuffers(cap)
        _tls.buf = buf
    return buf


def assemble_tile_chunks_native(
    entities, tile: Tile, scale: float, styler, profiles, patterns, ts_px: int
):
    """Native counterpart of
    `build_tile_chunks(stream_tile_packed(assemble_tile_prims(...)))`.

    Returns (TileChunks, has_icon_fills) or None when the native library
    is unavailable."""
    lib = get_native()
    if lib is None:
        return None

    # Measure points mirror the reference's drawer.rs:51-123 spans; the
    # contextmanager is a no-op unless a perfstats tile run is active
    # (tools/cold_profile.py, /perf_stats).
    from osm_renderer_tpu_torch.perfstats.spans import measure

    with measure("Style areas"):
        styled = styler.style_areas(
            entities.ways, entities.multipolygons, tile.zoom, False
        )

    # Project every referenced node once (same as assemble_tile_prims).
    with measure("Project nodes"):
        id_arrays = [w.node_ids for w in entities.ways]
        for mp in entities.multipolygons:
            for pi in range(mp.polygon_count()):
                id_arrays.append(mp.get_polygon(pi).node_ids)
        if id_arrays:
            all_ids = np.unique(np.concatenate(id_arrays))
            lats, lons = (
                entities.ways[0].reader.node_coords(all_ids)
                if entities.ways
                else entities.multipolygons[0].reader.node_coords(all_ids)
            )
            all_pts = project_points(lats, lons, tile, scale)
        else:
            all_ids = np.zeros(0, dtype=np.int64)
            all_pts = np.zeros((0, 2), dtype=np.int64)

    # "Build requests" covers the styled-row walk through request-array
    # packing; an ExitStack keeps the ~150-line block un-reindented.
    from contextlib import ExitStack

    _req_span = ExitStack()
    _req_span.enter_context(measure("Build requests"))

    rq = _Requests()
    refs_parts = []
    refs_len = 0
    has_icon_fills = False
    ring_cache: dict = {}  # id(entity) -> (ring_off, ring_cnt)

    def add_rings(entity):
        nonlocal refs_len
        key = id(entity)
        got = ring_cache.get(key)
        if got is not None:
            return got
        ring_off = len(rq.rings)
        if isinstance(entity, Multipolygon):
            for pi in range(entity.polygon_count()):
                ids = entity.get_polygon(pi).node_ids
                refs_parts.append(ids)
                rq.rings.append((refs_len, ids.shape[0]))
                refs_len += ids.shape[0]
        else:
            ids = entity.node_ids
            refs_parts.append(ids)
            rq.rings.append((refs_len, ids.shape[0]))
            refs_len += ids.shape[0]
        got = (ring_off, len(rq.rings) - ring_off)
        ring_cache[key] = got
        return got

    def c3(color):
        return (color[0] / 255.0, color[1] / 255.0, color[2] / 255.0)

    # Request building: ONE pass over the styled list with a per-Style
    # memo (styles are shared objects via the style cache, so the
    # payload — keys, profile indices, colors, flags — resolves once per
    # distinct style; per (entity, style) work is a dict hit plus list
    # appends).  Rows collect into three lists that concatenate in the
    # reference's pass order Fill -> Casing -> Stroke (drawer.rs:93-100);
    # within each pass the styled order is preserved.
    use_caps = styler.use_caps_for_dashes

    def stroke_meta(width, color, opacity, dashes, cap):
        hw = width / 2.0
        dashes_t = tuple(dashes) if dashes is not None else None
        key = rq.key_for(("stroke", color, opacity, hw, dashes_t, cap, use_caps))
        cap_for_dashes = cap if use_caps else 0
        body = profiles.index_for(hw, dashes_t, cap_for_dashes) if dashes_t else 0
        outer = profiles.index_for(hw, (0.0,), cap)
        force = int(cap == LINE_CAP_ROUND and hw > CHAIN_EXACT_HALF_WIDTH)
        r, g, b = c3(color)
        return (
            (1, key, r, g, b, opacity, hw, body, outer, cap, force, -1),
            dashes_t,
            use_caps,
        )

    _ICON_SKIP = "icon-skip"  # icon fill with no pattern table: CPU fallback
    _ICON_NONE = "icon-none"  # unloadable icon: the reference draws nothing

    def fill_meta(style):
        op = style.fill_opacity if style.fill_opacity is not None else 1.0
        pat_idx = -1
        if style.fill_color is None:
            if patterns is None or patterns.icon_cache is None:
                return _ICON_SKIP
            got = patterns.index_for(style.fill_image)
            if got is None:
                return None  # unloadable icon: the reference draws nothing
            pat_idx = got
        color = style.fill_color if style.fill_color is not None else (0, 0, 0)
        key = rq.key_for(("fill", color, op, style.fill_image))
        r, g, b = c3(color)
        return ((0, key, r, g, b, op, 0.0, -1, -1, 0, 0, pat_idx), None, False)

    fill_memo: dict = {}
    casing_memo: dict = {}
    stroke_memo: dict = {}
    fill_rows: list = []
    casing_rows: list = []
    stroke_rows: list = []
    # Per-style dispatch memo: one dict hit replaces five attribute
    # loads + None tests per styled row (the row loop is the cold
    # path's hottest Python — tools/cold_profile.py).
    flags_memo: dict = {}
    ring_get = ring_cache.get
    for entity, style in styled:
        sid = id(style)
        fl = flags_memo.get(sid)
        if fl is None:
            fl = flags_memo[sid] = (
                style.fill_color is not None or style.fill_image is not None,
                style.casing_color is not None
                and style.casing_width is not None,
                style.color is not None,
            )
        want_fill, has_c, has_s = fl
        if want_fill:
            fm = fill_memo.get(sid)
            if fm is None:
                fm = fill_memo[sid] = fill_meta(style)
                if fm is None:
                    fm = fill_memo[sid] = _ICON_NONE
            if fm is _ICON_SKIP:
                has_icon_fills = True
            elif fm is not _ICON_NONE:
                fill_rows.append(
                    (fm, ring_get(id(entity)) or add_rings(entity), entity)
                )
        if (has_c or has_s) and type(entity) is Way:
            rings = ring_get(id(entity)) or add_rings(entity)
            # Profile-table indices must be assigned in the Python
            # pipeline's pass order (every casing profile before any
            # stroke profile), so the memo cells here are resolved
            # in a deferred pass below, in first-encounter order.
            if has_c:
                cm = casing_memo.get(sid)
                if cm is None:
                    cm = casing_memo[sid] = [None, style]
                casing_rows.append((cm, rings, entity))
            if has_s:
                sm = stroke_memo.get(sid)
                if sm is None:
                    sm = stroke_memo[sid] = [None, style]
                stroke_rows.append((sm, rings, entity))

    for cell in casing_memo.values():
        st = cell[1]
        cell[0] = stroke_meta(
            st.casing_width * scale, st.casing_color, 1.0,
            [d * scale for d in st.casing_dashes]
            if st.casing_dashes is not None
            else None,
            _CAP_TO_INT[st.casing_line_cap],
        )
    for cell in stroke_memo.values():
        st = cell[1]
        cell[0] = stroke_meta(
            scale * (st.width if st.width is not None else 1.0),
            st.color,
            st.opacity if st.opacity is not None else 1.0,
            [d * scale for d in st.dashes] if st.dashes is not None else None,
            _CAP_TO_INT[st.line_cap],
        )

    all_rows = fill_rows + [
        (cell[0], r, e) for (cell, r, e) in casing_rows
    ] + [(cell[0], r, e) for (cell, r, e) in stroke_rows]
    if all_rows:
        c = list(zip(*(m[0] for (m, _, _) in all_rows)))
        rq.kind.extend(c[0])
        rq.style_key.extend(c[1])
        rq.color.extend(zip(c[2], c[3], c[4]))
        rq.opacity.extend(c[5])
        rq.hw.extend(c[6])
        rq.body_pidx.extend(c[7])
        rq.outer_pidx.extend(c[8])
        rq.cap.extend(c[9])
        rq.force_layer.extend(c[10])
        rq.pat.extend(c[11])
        rq.req_rings.extend(r for (_, r, _) in all_rows)
        rq.entity.extend(e for (_, _, e) in all_rows)
        rq.dashes.extend(m[1] for (m, _, _) in all_rows)
        rq.use_caps.extend(m[2] for (m, _, _) in all_rows)

    n_req = len(rq.kind)
    refs_ids = (
        np.concatenate(refs_parts) if refs_parts else np.zeros(0, np.int64)
    )
    refs_idx = np.searchsorted(all_ids, refs_ids).astype(np.int64)
    rings = np.asarray(rq.rings, np.int64).reshape(-1, 2)
    req_rings = np.asarray(rq.req_rings, np.int64).reshape(-1, 2)
    cf_mask = profiles.chain_free_mask().astype(np.uint8)

    _req_span.close()

    geom_total = refs_idx.shape[0]
    cap_needed = max(64, n_req * 2 + geom_total // 32 + 16)
    _nat_span = ExitStack()
    _nat_span.enter_context(measure("Native assemble"))
    while True:
        buf = _buffers(cap_needed)
        C_cap = buf.cap
        o_geom, o_trav, o_sprof, o_aux = buf.geom, buf.trav, buf.sprof, buf.aux
        o_kind, o_cnt, o_last = buf.kind, buf.cnt, buf.last
        o_y0, o_nb, o_py0, o_pnb = buf.y0, buf.nb, buf.py0, buf.pnb
        o_color, o_op, o_hw, o_pat = buf.color, buf.op, buf.hw, buf.pat
        o_items, o_item_len, o_isec, o_ph = (
            buf.items, buf.item_len, buf.isec, buf.ph
        )
        n_chunks = lib.osmr_assemble_tile(
            np.ascontiguousarray(all_pts, np.int64).reshape(-1),
            refs_idx, rings.reshape(-1), rings.shape[0], n_req,
            np.asarray(rq.kind, np.uint8),
            np.asarray(rq.style_key, np.int64),
            np.asarray(rq.color, np.float64).reshape(-1),
            np.asarray(rq.opacity, np.float64),
            np.asarray(rq.hw, np.float64),
            np.asarray(rq.body_pidx, np.int32),
            np.asarray(rq.outer_pidx, np.int32),
            np.asarray(rq.cap, np.uint8),
            np.asarray(rq.force_layer, np.uint8),
            np.asarray(rq.pat, np.int32),
            req_rings.reshape(-1), cf_mask, cf_mask.shape[0],
            ts_px, ts_px, C_cap,
            o_geom.reshape(-1), o_trav.reshape(-1), o_sprof.reshape(-1),
            o_aux.reshape(-1), o_kind, o_cnt, o_last, o_y0, o_nb,
            o_py0, o_pnb, o_color.reshape(-1), o_op, o_hw, o_pat,
            o_items.reshape(-1), o_item_len, o_isec.reshape(-1), o_ph,
        )
        if n_chunks >= 0:
            break
        cap_needed = C_cap * 2
    _nat_span.close()

    _pack_span = ExitStack()
    _pack_span.enter_context(measure("Pack chunks"))
    n = int(n_chunks)
    placeholders = np.flatnonzero(o_ph[:n] >= 0)

    # Per-tile item width bucket (matches build_tile_chunks).
    it_tile = max(int(o_item_len[:n].max()) if n else 0, 4)
    it_tile = -(-it_tile // 4) * 4
    items = np.full((n, 1, it_tile), -1, np.int32)
    w = min(it_tile, IT_CAP)
    items[:, 0, :w] = o_items[:n, :w]

    # Copies: the output buffers are reused across calls, while the
    # returned TileChunks live on in the serving chunk cache.
    tc = TileChunks(
        o_geom[:n].copy(), o_trav[:n].copy(), o_sprof[:n].copy(),
        o_aux[:n].copy(), o_kind[:n].copy(), o_cnt[:n].copy(),
        o_last[:n].copy(), o_y0[:n].copy(), o_nb[:n].copy(),
        o_py0[:n].copy(), o_pnb[:n].copy(), o_color[:n].copy(),
        o_op[:n].copy(), o_hw[:n].copy(), o_pat[:n].copy(), items,
        o_isec[:n].copy(),
    )

    if placeholders.size:
        tc, extra_icon = _splice_layers(
            tc, placeholders, o_ph, rq, tile, scale, profiles, patterns, ts_px
        )
        has_icon_fills = has_icon_fills or extra_icon
    # The C++ assembler emits the raw chunk sequence; GROUP alignment
    # and pattern-per-step alignment (chunk_layout._pad_group) are
    # host-side layout concerns applied here — skipping this at
    # GROUP > 1 lets grid steps straddle tiles, which routes a tile's
    # chunks into its neighbor's output block.
    tc = _pad_group(tc)
    _pack_span.close()
    return tc, has_icon_fills


def _splice_layers(tc, placeholders, o_ph, rq, tile, scale, profiles, patterns, ts_px):
    """Replace placeholder chunks with host-rasterized KIND_LAYER rows
    (built by the existing Python layer path)."""
    from osm_renderer_tpu_torch.draw.primitives import TileStream, _stream_fill_layer, _stream_stroke_layer

    has_icon = False
    parts = []  # (position, TileChunks or None)
    for ci in placeholders:
        r = int(o_ph[ci])
        entity = rq.entity[r]
        stream = TileStream()
        if rq.kind[r] == 0:
            prim = FillPrim(
                kind="fill",
                color=tuple(int(round(c * 255)) for c in rq.color[r])
                if rq.pat[r] < 0
                else None,
                opacity=rq.opacity[r],
                edges=_entity_edges(entity, tile, scale),
                fill_image=_pat_name(patterns, rq.pat[r]),
            )
            _stream_fill_layer(stream, prim, patterns)
        else:
            pairs = _entity_edges(entity, tile, scale)
            prim = make_stroke_prim(
                pairs,
                rq.hw[r] * 2.0,
                tuple(int(round(c * 255)) for c in rq.color[r]),
                rq.opacity[r],
                rq.dashes[r],
                rq.cap[r],
                rq.use_caps[r],
            )
            _stream_stroke_layer(stream, prim, patterns)
        if stream.has_icon_fills:
            has_icon = True
        sub = (
            build_tile_chunks(stream, ts_px) if stream.chunk_kind else None
        )
        parts.append((int(ci), sub))

    # Rebuild arrays with placeholder rows substituted / dropped.
    n = tc.kind.shape[0]
    keep = np.ones(n, bool)
    subs = {}
    for ci, sub in parts:
        keep[ci] = False
        if sub is not None and int(sub.kind[0]) != 0:
            subs[ci] = sub

    it_widths = [tc.items.shape[2]] + [s.items.shape[2] for s in subs.values()]
    it_tile = max(it_widths)

    def pad_items(a):
        if a.shape[2] == it_tile:
            return a
        return np.pad(a, ((0, 0), (0, 0), (0, it_tile - a.shape[2])), constant_values=-1)

    out = [[] for _ in TileChunks._fields]
    for ci in range(n):
        src = None
        if keep[ci]:
            src = TileChunks(*(a[ci : ci + 1] for a in tc))
            src = src._replace(items=pad_items(src.items))
        elif ci in subs:
            src = subs[ci]._replace(items=pad_items(subs[ci].items))
        if src is None:
            continue
        for fi, a in enumerate(src):
            out[fi].append(a)
    if not out[0]:
        return build_tile_chunks(TileStream(), ts_px), has_icon
    return TileChunks(*(np.concatenate(p, axis=0) for p in out)), has_icon


def _entity_edges(entity, tile, scale) -> np.ndarray:
    return prim_mod._entity_point_pairs(entity, tile, scale)


def _pat_name(patterns, pat_idx: int) -> Optional[str]:
    if pat_idx < 0 or patterns is None:
        return None
    for name, idx in patterns._idx.items():
        if idx == pat_idx:
            return name
    return None
