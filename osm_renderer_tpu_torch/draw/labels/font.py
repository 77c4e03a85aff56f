"""TrueType font engine with stb_truetype-compatible semantics, without
fontTools.

Counterpart of `osm_renderer_tpu.draw.labels.font.FontEngine`, with the
same API and the same outputs.  The original reads its tables through
fontTools, which the GPU host lacks; this one reads them from the file's
bytes: `head` (indexToLocFormat), `maxp`, `hhea`, `hmtx`, `loca`,
`glyf`, `cmap` (formats 4 and 12, subtable picked in fontTools'
`getBestCmap` order) and the legacy `kern` table (format 0 subtables).

Outlines resolve composite glyphs the way fontTools'
`Glyph.getCoordinates` does, so the vertex streams are bit-identical:
F2Dot14 values are v / 16384; a component's 2x2 transform is applied
in float64 (x*t00 + y*t10, x*t01 + y*t11) before its offset is added,
or after when SCALED_COMPONENT_OFFSET is set; nested components resolve
recursively; truncation toward zero happens only when a contour becomes
vertices.
"""

from __future__ import annotations

import functools
import struct
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np

MOVE_TO = 1
LINE_TO = 2
CURVE_TO = 3

# glyf component flags
_ARG_1_AND_2_ARE_WORDS = 0x0001
_ARGS_ARE_XY_VALUES = 0x0002
_WE_HAVE_A_SCALE = 0x0008
_MORE_COMPONENTS = 0x0020
_WE_HAVE_AN_X_AND_Y_SCALE = 0x0040
_WE_HAVE_A_TWO_BY_TWO = 0x0080
_SCALED_COMPONENT_OFFSET = 0x0800

# Simple-glyph point flags
_ON_CURVE = 0x01
_X_SHORT = 0x02
_Y_SHORT = 0x04
_REPEAT = 0x08
_X_SAME = 0x10
_Y_SAME = 0x20

# fontTools' getBestCmap preference order (platformID, platEncID).
_CMAP_PREFERENCES = ((3, 10), (0, 6), (0, 4), (3, 1), (0, 3), (0, 2), (0, 1), (0, 0))


class Vertex(NamedTuple):
    kind: int
    x: int
    y: int
    cx: int = 0
    cy: int = 0


class VMetrics(NamedTuple):
    ascent: int
    descent: int
    line_gap: int


class FontError(ValueError):
    """A font file this engine cannot read."""


class FontEngine:
    def __init__(self, path: str):
        with open(path, "rb") as f:
            self._data = data = f.read()
        sfnt, num_tables = struct.unpack_from(">IH", data, 0)
        if sfnt not in (0x00010000, 0x74727565):  # TrueType outlines ('true')
            raise FontError(f"{path}: not a TrueType font (sfnt version {sfnt:#010x})")
        self._tables: Dict[bytes, Tuple[int, int]] = {}
        for i in range(num_tables):
            tag, _, off, length = struct.unpack_from(">4sIII", data, 12 + 16 * i)
            self._tables[tag] = (off, length)

        head = self._table(b"head")
        index_to_loc_format = struct.unpack_from(">h", head, 50)[0]
        self.num_glyphs = struct.unpack_from(">H", self._table(b"maxp"), 4)[0]
        hhea = self._table(b"hhea")
        ascent, descent, line_gap = struct.unpack_from(">hhh", hhea, 4)
        n_hmetrics = struct.unpack_from(">H", hhea, 34)[0]
        self._vm = VMetrics(ascent, descent, line_gap)

        hmtx = self._table(b"hmtx")
        adv = np.frombuffer(hmtx, ">u2", count=2 * n_hmetrics)[0::2].astype(np.int64)
        self._advance = np.empty(self.num_glyphs, np.int64)
        self._advance[:n_hmetrics] = adv[: self.num_glyphs]
        self._advance[n_hmetrics:] = adv[-1]  # glyphs past the metrics take the last

        loca = self._table(b"loca")
        if index_to_loc_format == 0:
            self._loca = np.frombuffer(loca, ">u2", count=self.num_glyphs + 1).astype(np.int64) * 2
        else:
            self._loca = np.frombuffer(loca, ">u4", count=self.num_glyphs + 1).astype(np.int64)
        self._glyf_off = self._tables[b"glyf"][0]

        self.cmap = self._load_cmap()
        self._kern = self._load_kern()

    def _table(self, tag: bytes) -> bytes:
        got = self._tables.get(tag)
        if got is None:
            raise FontError(f"font has no {tag.decode()!r} table")
        off, length = got
        return self._data[off : off + length]

    # --- tables ---

    def _load_cmap(self) -> Dict[int, int]:
        cmap = self._table(b"cmap")
        n = struct.unpack_from(">H", cmap, 2)[0]
        subtables = {}
        for i in range(n):
            pid, eid, off = struct.unpack_from(">HHI", cmap, 4 + 8 * i)
            subtables.setdefault((pid, eid), off)  # the first of a pair wins
        for pref in _CMAP_PREFERENCES:
            off = subtables.get(pref)
            if off is None:
                continue
            fmt = struct.unpack_from(">H", cmap, off)[0]
            if fmt == 4:
                return _cmap_format4(cmap, off)
            if fmt == 12:
                return _cmap_format12(cmap, off)
            raise FontError(f"unsupported best cmap subtable {pref} of format {fmt}")
        raise FontError("font has no Unicode cmap subtable")

    def _load_kern(self) -> Dict[Tuple[int, int], int]:
        if b"kern" not in self._tables:
            return {}
        data = self._table(b"kern")
        version, n_tables = struct.unpack_from(">HH", data, 0)
        if version != 0:
            raise FontError(f"unsupported kern table version {version} (only the OpenType 0)")
        pos = 4
        table: Dict[Tuple[int, int], int] = {}
        for _ in range(n_tables):
            _, length, fmt, _coverage = struct.unpack_from(">HHBB", data, pos)
            body = pos + 6
            if n_tables == 1 and fmt == 0:
                # Some fonts understate a lone subtable's length;
                # fontTools trusts nPairs instead.
                length = struct.unpack_from(">H", data, pos + 6)[0] * 6 + 14
            if fmt == 0:
                n_pairs = struct.unpack_from(">H", data, body)[0]
                pairs = np.frombuffer(data, ">u2", count=3 * n_pairs, offset=body + 8)
                pairs = pairs.reshape(n_pairs, 3).astype(np.int64)
                values = np.where(pairs[:, 2] >= 32768, pairs[:, 2] - 65536, pairs[:, 2])
                for (l, r), v in zip(pairs[:, :2].tolist(), values.tolist()):
                    table[(l, r)] = v
            pos += length
        return table

    def _glyph_bytes(self, glyph_id: int) -> bytes:
        a, b = int(self._loca[glyph_id]), int(self._loca[glyph_id + 1])
        return self._data[self._glyf_off + a : self._glyf_off + b] if b > a else b""

    def _coordinates(self, glyph_id: int, depth: int = 0):
        """(coords (n, 2) f64, end points, on-curve flags) with composite
        glyphs flattened, as fontTools' `getCoordinates` returns them."""
        if depth > 32:
            raise FontError(f"glyph {glyph_id}: component nesting too deep")
        data = self._glyph_bytes(glyph_id)
        if len(data) < 10:
            return np.zeros((0, 2)), [], []
        n_contours = struct.unpack_from(">h", data, 0)[0]
        if n_contours > 0:
            return _simple_glyph(data, n_contours)
        if n_contours == 0:
            return np.zeros((0, 2)), [], []
        all_coords, all_ends, all_flags = [], [], []
        n_points = 0
        pos = 10
        while True:
            flags, gid = struct.unpack_from(">HH", data, pos)
            pos += 4
            if not flags & _ARGS_ARE_XY_VALUES:
                raise FontError(f"glyph {glyph_id}: point-matched components are not supported")
            if flags & _ARG_1_AND_2_ARE_WORDS:
                dx, dy = struct.unpack_from(">hh", data, pos)
                pos += 4
            else:
                dx, dy = struct.unpack_from(">bb", data, pos)
                pos += 2
            t = None
            if flags & _WE_HAVE_A_SCALE:
                s = struct.unpack_from(">h", data, pos)[0] / 16384
                t = ((s, 0), (0, s))
                pos += 2
            elif flags & _WE_HAVE_AN_X_AND_Y_SCALE:
                sx, sy = struct.unpack_from(">hh", data, pos)
                t = ((sx / 16384, 0), (0, sy / 16384))
                pos += 4
            elif flags & _WE_HAVE_A_TWO_BY_TWO:
                a, b, c, d = struct.unpack_from(">hhhh", data, pos)
                t = ((a / 16384, b / 16384), (c / 16384, d / 16384))
                pos += 8
            coords, ends, pflags = self._coordinates(gid, depth + 1)
            coords = coords.copy()
            if t is None:
                coords += (dx, dy)
            elif flags & _SCALED_COMPONENT_OFFSET:
                coords += (dx, dy)
                coords = _transform(coords, t)
            else:
                coords = _transform(coords, t)
                coords += (dx, dy)
            all_coords.append(coords)
            all_ends.extend(e + n_points for e in ends)
            all_flags.extend(pflags)
            n_points += coords.shape[0]
            if not flags & _MORE_COMPONENTS:
                break
        return np.concatenate(all_coords), all_ends, all_flags

    # --- stb-compatible API ---

    def scale_for_pixel_height(self, height: float) -> float:
        # stb computes this in f32 (FontInfo scale is f32 in the crate).
        return float(
            np.float32(height) / np.float32(self._vm.ascent - self._vm.descent)
        )

    def find_glyph_index(self, codepoint: int) -> int:
        return self.cmap.get(codepoint, 0)

    def advance_width(self, glyph_id: int) -> int:
        return int(self._advance[glyph_id])

    def kern_advance(self, g1: int, g2: int) -> int:
        if not self._kern:
            return 0
        return self._kern.get((g1, g2), 0)

    def v_metrics(self) -> VMetrics:
        return self._vm

    @functools.lru_cache(maxsize=4096)
    def glyph_shape(self, glyph_id: int) -> Optional[Tuple[Vertex, ...]]:
        """stb GetGlyphShape: vertex stream in font units."""
        if not 0 <= glyph_id < self.num_glyphs:
            raise IndexError(f"glyph id {glyph_id} out of range [0, {self.num_glyphs})")
        data = self._glyph_bytes(glyph_id)
        if len(data) < 10 or struct.unpack_from(">h", data, 0)[0] == 0:
            return None
        coords, end_pts, flags = self._coordinates(glyph_id)
        if len(coords) == 0:
            return None

        verts: List[Vertex] = []
        start = 0
        for end in end_pts:
            self._contour_to_vertices(coords.tolist(), flags, start, end, verts)
            start = end + 1
        return tuple(verts)

    @staticmethod
    def _contour_to_vertices(coords, flags, i0: int, i1: int, out: List[Vertex]):
        """One contour -> stb vertex stream (integer midpoint arithmetic)."""
        n = i1 - i0 + 1
        if n <= 0:
            return
        on = [bool(flags[i] & 1) for i in range(i0, i1 + 1)]
        pts = [tuple(map(int, coords[i])) for i in range(i0, i1 + 1)]

        start_off = not on[0]
        if start_off:
            scx, scy = pts[0]
            if n > 1 and not on[1]:
                sx = (pts[0][0] + pts[1][0]) >> 1
                sy = (pts[0][1] + pts[1][1]) >> 1
                first = 1
            else:
                if n > 1:
                    sx, sy = pts[1]
                    first = 2
                else:
                    sx, sy = scx, scy
                    first = 1
        else:
            sx, sy = pts[0]
            scx = scy = 0
            first = 1

        out.append(Vertex(MOVE_TO, sx, sy))
        was_off = False
        cx = cy = 0
        for i in range(first, n):
            x, y = pts[i]
            if not on[i]:
                if was_off:
                    out.append(Vertex(CURVE_TO, (cx + x) >> 1, (cy + y) >> 1, cx, cy))
                cx, cy = x, y
                was_off = True
            else:
                if was_off:
                    out.append(Vertex(CURVE_TO, x, y, cx, cy))
                else:
                    out.append(Vertex(LINE_TO, x, y))
                was_off = False

        # close the shape
        if start_off:
            if was_off:
                out.append(Vertex(CURVE_TO, (cx + scx) >> 1, (cy + scy) >> 1, cx, cy))
            out.append(Vertex(CURVE_TO, sx, sy, scx, scy))
        else:
            if was_off:
                out.append(Vertex(CURVE_TO, sx, sy, cx, cy))
            else:
                out.append(Vertex(LINE_TO, sx, sy))


def _transform(coords: np.ndarray, t) -> np.ndarray:
    """fontTools' GlyphCoordinates.transform, in the same float64 order."""
    x, y = coords[:, 0], coords[:, 1]
    return np.stack([x * t[0][0] + y * t[1][0], x * t[0][1] + y * t[1][1]], axis=1)


def _simple_glyph(data: bytes, n_contours: int):
    ends = list(struct.unpack_from(f">{n_contours}H", data, 10))
    pos = 10 + 2 * n_contours
    n_instr = struct.unpack_from(">H", data, pos)[0]
    pos += 2 + n_instr
    n = ends[-1] + 1
    flags = []
    while len(flags) < n:
        f = data[pos]
        pos += 1
        flags.append(f)
        if f & _REPEAT:
            flags.extend([f] * data[pos])
            pos += 1
    del flags[n:]
    coords = np.zeros((n, 2))
    for axis, short, same in ((0, _X_SHORT, _X_SAME), (1, _Y_SHORT, _Y_SAME)):
        v = 0
        for i, f in enumerate(flags):
            if f & short:
                d = data[pos]
                pos += 1
                v += d if f & same else -d
            elif not f & same:
                v += struct.unpack_from(">h", data, pos)[0]
                pos += 2
            coords[i, axis] = v
    return coords, ends, [f & _ON_CURVE for f in flags]


def _cmap_format4(cmap: bytes, off: int) -> Dict[int, int]:
    seg_x2 = struct.unpack_from(">H", cmap, off + 6)[0]
    seg = seg_x2 // 2
    length = struct.unpack_from(">H", cmap, off + 2)[0]
    words = np.frombuffer(cmap, ">u2", count=(length - 14) // 2, offset=off + 14).astype(np.int64)
    end = words[:seg]
    start = words[seg + 1 : 2 * seg + 1]
    delta = words[2 * seg + 1 : 3 * seg + 1]
    range_off = words[3 * seg + 1 : 4 * seg + 1]
    gia = words[4 * seg + 1 :]
    out: Dict[int, int] = {}
    for i in range(seg - 1):  # fontTools skips the final (0xFFFF) segment
        codes = np.arange(start[i], end[i] + 1)
        if range_off[i] == 0:
            gids = (codes + delta[i]) & 0xFFFF
        else:
            idx = codes + (range_off[i] // 2 - start[i] + i - seg)
            if idx.size and idx.max() >= gia.size:
                raise FontError(f"cmap format 4 segment {i} indexes past its glyph array")
            raw = gia[idx]
            gids = np.where(raw != 0, (raw + delta[i]) & 0xFFFF, 0)
        out.update(zip(codes.tolist(), gids.tolist()))
    return out


def _cmap_format12(cmap: bytes, off: int) -> Dict[int, int]:
    n_groups = struct.unpack_from(">I", cmap, off + 12)[0]
    groups = np.frombuffer(cmap, ">u4", count=3 * n_groups, offset=off + 16)
    out: Dict[int, int] = {}
    for s, e, g in groups.reshape(n_groups, 3).astype(np.int64).tolist():
        out.update(zip(range(s, e + 1), range(g, g + e - s + 1)))
    return out
