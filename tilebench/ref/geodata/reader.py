"""Zero-copy binary geodata reader.

Memory-maps the `.bin` produced by `saver.py` (same format as the
reference, `src/geodata/reader.rs:301-336`) into numpy structured views,
and serves per-tile entity queries over the sorted (x, y) MAX_ZOOM tile
index (`reader.rs:60-180`).  Query results are numpy id arrays plus
lightweight entity views; bulk coordinate/ref gathers are vectorized so
the drawing pipeline can feed flat arrays straight to the device path.
"""

from __future__ import annotations

import mmap
from typing import Dict, Iterator, List, NamedTuple, Optional, Set, Tuple

import numpy as np

from tilebench.ref.core.tile import (
    MAX_ZOOM,
    Tile,
    tile_to_max_zoom_tile_range,
)

_MISSING = object()

_NODE_DTYPE = np.dtype(
    [("id", "<u8"), ("lat", "<f8"), ("lon", "<f8"), ("tags", "<u4", (2,))]
)
_WAY_DTYPE = np.dtype([("id", "<u8"), ("refs", "<u4", (2,)), ("tags", "<u4", (2,))])
_POLY_DTYPE = np.dtype([("refs", "<u4", (2,))])
_TILE_DTYPE = np.dtype(
    [
        ("x", "<u4"),
        ("y", "<u4"),
        ("nodes", "<u4", (2,)),
        ("ways", "<u4", (2,)),
        ("mps", "<u4", (2,)),
    ]
)


def gather_slices(pool: np.ndarray, offsets: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """Concatenate pool[o:o+l] for each (o, l) pair, vectorized."""
    offsets = np.asarray(offsets, dtype=np.int64)
    lengths = np.asarray(lengths, dtype=np.int64)
    total = int(lengths.sum())
    if total == 0:
        return np.zeros(0, dtype=pool.dtype)
    starts = np.repeat(offsets, lengths)
    ends = np.cumsum(lengths)
    within = np.arange(total, dtype=np.int64) - np.repeat(ends - lengths, lengths)
    return pool[starts + within]


class Tags:
    """Sorted key/value view into the shared string pool.

    `get_by_key` binary-searches by UTF-8 byte order, matching the
    BTreeMap ordering used at import time (`reader.rs:350-373`).
    """

    __slots__ = ("kv_refs", "strings")

    def __init__(self, kv_refs: np.ndarray, strings: memoryview):
        self.kv_refs = kv_refs
        self.strings = strings

    def __len__(self) -> int:
        return len(self.kv_refs) // 4

    def _str_at(self, slot: int) -> bytes:
        off = int(self.kv_refs[slot])
        length = int(self.kv_refs[slot + 1])
        return bytes(self.strings[off : off + length])

    def get_by_key(self, key: str) -> Optional[str]:
        kb = key.encode("utf-8")
        lo, hi = 0, len(self)
        while lo < hi:
            mid = (lo + hi) // 2
            k = self._str_at(mid * 4)
            if k < kb:
                lo = mid + 1
            elif k > kb:
                hi = mid
            else:
                return self._str_at(mid * 4 + 2).decode("utf-8")
        return None

    def items(self) -> Iterator[Tuple[str, str]]:
        for i in range(len(self)):
            yield (
                self._str_at(i * 4).decode("utf-8"),
                self._str_at(i * 4 + 2).decode("utf-8"),
            )

    def key_value_offsets(self) -> np.ndarray:
        """Raw (k_off, k_len, v_off, v_len) u32 rows — used by the style cache."""
        return self.kv_refs.reshape(-1, 4)


class Node:
    __slots__ = ("reader", "local_id")

    def __init__(self, reader: "GeodataReader", local_id: int):
        self.reader = reader
        self.local_id = local_id

    @property
    def global_id(self) -> int:
        return int(self.reader.nodes["id"][self.local_id])

    @property
    def lat(self) -> float:
        return float(self.reader.nodes["lat"][self.local_id])

    @property
    def lon(self) -> float:
        return float(self.reader.nodes["lon"][self.local_id])

    def tags(self) -> Tags:
        return self.reader._tags(self.reader.nodes["tags"][self.local_id])

    @property
    def is_node(self) -> bool:
        return True


class Way:
    __slots__ = ("reader", "local_id", "node_ids")

    def __init__(self, reader: "GeodataReader", local_id: int):
        self.reader = reader
        self.local_id = local_id
        self.node_ids = reader.ints_slice(reader.ways["refs"][local_id])

    @property
    def global_id(self) -> int:
        return int(self.reader.ways["id"][self.local_id])

    def tags(self) -> Tags:
        return self.reader._tags(self.reader.ways["tags"][self.local_id])

    def node_count(self) -> int:
        return len(self.node_ids)

    def get_node(self, idx: int) -> Node:
        return Node(self.reader, int(self.node_ids[idx]))

    def node_latlons(self) -> Tuple[np.ndarray, np.ndarray]:
        r = self.reader
        ids = self.node_ids
        return r.nodes["lat"][ids], r.nodes["lon"][ids]

    def is_closed(self) -> bool:
        if len(self.node_ids) <= 2:
            return False
        lats, lons = self.node_latlons()
        return lats[0] == lats[-1] and lons[0] == lons[-1]


class Polygon:
    __slots__ = ("reader", "node_ids")

    def __init__(self, reader: "GeodataReader", local_id: int):
        self.reader = reader
        self.node_ids = reader.ints_slice(reader.polygons["refs"][local_id])

    def node_count(self) -> int:
        return len(self.node_ids)

    def get_node(self, idx: int) -> Node:
        return Node(self.reader, int(self.node_ids[idx]))

    def node_latlons(self) -> Tuple[np.ndarray, np.ndarray]:
        r = self.reader
        return r.nodes["lat"][self.node_ids], r.nodes["lon"][self.node_ids]


class Multipolygon:
    __slots__ = ("reader", "local_id", "polygon_ids")

    def __init__(self, reader: "GeodataReader", local_id: int):
        self.reader = reader
        self.local_id = local_id
        self.polygon_ids = reader.ints_slice(reader.mps["refs"][local_id])

    @property
    def global_id(self) -> int:
        return int(self.reader.mps["id"][self.local_id])

    def tags(self) -> Tags:
        return self.reader._tags(self.reader.mps["tags"][self.local_id])

    def polygon_count(self) -> int:
        return len(self.polygon_ids)

    def get_polygon(self, idx: int) -> Polygon:
        return Polygon(self.reader, int(self.polygon_ids[idx]))

    def is_closed(self) -> bool:
        return True


class OsmEntities:
    """Entity views for one 3x3 tile query (`reader.rs:60-100`).

    Node views materialize lazily: only the label path styles nodes
    (`drawer.rs:107-116`), and a z15 batch query returns ~3k node ids
    per tile whose eager materialization used to dominate the fetch.
    Way/multipolygon views come memoized from the reader, so the 3x3
    neighborhood overlap across a tile batch reuses the same view
    objects (and downstream id()-keyed memos hit)."""

    __slots__ = ("_reader", "_node_ids", "_osm_ids", "_nodes", "ways", "multipolygons")

    def __init__(self, reader, node_ids, ways, multipolygons, osm_ids=None):
        self._reader = reader
        self._node_ids = node_ids
        self._osm_ids = osm_ids
        self._nodes = None
        self.ways = ways
        self.multipolygons = multipolygons

    @property
    def nodes(self) -> List[Node]:
        if self._nodes is None:
            nodes = [Node(self._reader, int(i)) for i in self._node_ids]
            if self._osm_ids is not None:
                nodes = [n for n in nodes if n.global_id in self._osm_ids]
            self._nodes = nodes
        return self._nodes


class OsmEntityIds(NamedTuple):
    nodes: np.ndarray
    ways: np.ndarray
    multipolygons: np.ndarray


class GeodataReader:
    def __init__(self, file_name: str):
        with open(file_name, "rb") as f:
            self._mmap = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        buf = memoryview(self._mmap)
        pos = 0

        def read_storage(dtype: np.dtype):
            nonlocal pos
            count = int(np.frombuffer(buf, "<u4", 1, pos)[0])
            pos += 4
            arr = np.frombuffer(buf, dtype, count, pos)
            pos += dtype.itemsize * count
            return arr

        self.nodes = read_storage(_NODE_DTYPE)
        self.ways = read_storage(_WAY_DTYPE)
        self.polygons = read_storage(_POLY_DTYPE)
        self.mps = read_storage(_WAY_DTYPE)
        self.tiles = read_storage(_TILE_DTYPE)
        int_count = int(np.frombuffer(buf, "<u4", 1, pos)[0])
        pos += 4
        self.ints = np.frombuffer(buf, "<u4", int_count, pos)
        pos += 4 * int_count
        self.strings = buf[pos:]
        # Memoized way/multipolygon views (local id -> view); entity
        # views are immutable value objects over the mmap, so reuse
        # across tile queries is safe (empty multipolygons memo None).
        self._way_views: dict = {}
        self._mp_views: dict = {}

        # Combined sort key for the (x, y)-sorted tile index.
        self._tile_keys = (self.tiles["x"].astype(np.uint64) << np.uint64(32)) | self.tiles[
            "y"
        ].astype(np.uint64)

    @classmethod
    def load(cls, file_name: str) -> "GeodataReader":
        return cls(file_name)

    # -- low-level helpers --

    def ints_slice(self, ref: np.ndarray) -> np.ndarray:
        off, length = int(ref[0]), int(ref[1])
        return self.ints[off : off + length]

    def _tags(self, ref: np.ndarray) -> Tags:
        return Tags(self.ints_slice(ref), self.strings)

    # -- tile queries --

    def tile_entity_ids(self, t: Tile) -> OsmEntityIds:
        """Entity ids referenced by MAX_ZOOM tiles covered by `t`."""
        bounds = tile_to_max_zoom_tile_range(t)
        return self._range_entity_ids(
            bounds.min_x, bounds.max_x, bounds.min_y, bounds.max_y
        )

    def _range_entity_ids(
        self, min_x: int, max_x: int, min_y: int, max_y: int
    ) -> OsmEntityIds:
        keys = self._tile_keys
        lo = int(np.searchsorted(keys, np.uint64((min_x << 32) | min_y), "left"))
        hi = int(np.searchsorted(keys, np.uint64((max_x << 32) | max_y), "right"))
        if lo >= hi:
            empty = np.zeros(0, dtype=np.uint32)
            return OsmEntityIds(empty, empty, empty)
        span = self.tiles[lo:hi]
        mask = (span["y"] >= min_y) & (span["y"] <= max_y)
        matched = span[mask]

        def collect(field: str) -> np.ndarray:
            refs = matched[field]
            return gather_slices(self.ints, refs[:, 0], refs[:, 1])

        return OsmEntityIds(collect("nodes"), collect("ways"), collect("mps"))

    def get_entities_in_tile_with_neighbors(
        self, t: Tile, osm_ids: Optional[Set[int]] = None
    ) -> OsmEntities:
        """Entities in the 3x3 neighborhood of `t` (`reader.rs:60-100`)."""
        shift = MAX_ZOOM - t.zoom
        min_x = max(0, (t.x - 1)) << shift
        max_x = ((t.x + 2) << shift) - 1
        min_y = max(0, (t.y - 1)) << shift
        max_y = ((t.y + 2) << shift) - 1
        ids = self._range_entity_ids(min_x, max_x, min_y, max_y)

        node_ids = np.unique(ids.nodes)
        way_ids = np.unique(ids.ways)
        mp_ids = np.unique(ids.multipolygons)

        wmemo = self._way_views
        ways = []
        for i in way_ids.tolist():
            w = wmemo.get(i)
            if w is None:
                w = wmemo[i] = Way(self, i)
            ways.append(w)
        mmemo = self._mp_views
        mps = []
        for i in mp_ids.tolist():
            m = mmemo.get(i, _MISSING)
            if m is _MISSING:
                mp = Multipolygon(self, i)
                m = mmemo[i] = mp if mp.polygon_count() > 0 else None
            if m is not None:
                mps.append(m)

        if osm_ids is not None:
            ways = [w for w in ways if w.global_id in osm_ids]
            mps = [m for m in mps if m.global_id in osm_ids]
        return OsmEntities(self, node_ids, ways, mps, osm_ids)

    # -- bulk accessors for the device feed --

    def node_coords(self, node_ids: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        return self.nodes["lat"][node_ids], self.nodes["lon"][node_ids]
