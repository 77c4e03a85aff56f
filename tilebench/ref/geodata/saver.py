"""Binary geodata serializer.

Writes the same little-endian flat format as the reference
(`src/geodata/saver.rs` / `reader.rs:301-336`):

    [u32 node_count]  node records   (u64 id, f64 lat, f64 lon, intref tags)
    [u32 way_count]   way records    (u64 id, intref node_ids, intref tags)
    [u32 poly_count]  polygon records(intref node_ids)
    [u32 mp_count]    mp records     (u64 id, intref polygon_ids, intref tags)
    [u32 tile_count]  tile records   (u32 x, u32 y, intref nodes, ways, mps)
    [u32 int_count]   u32 int pool
    string pool bytes (deduplicated, referenced as (offset, len) int pairs)

An `intref` is (u32 offset, u32 length) into the shared int pool.
Tags are stored as 4 ints per kv: key offset/len + value offset/len into
the string pool, sorted by UTF-8 byte order.  The tile index maps every
entity to all MAX_ZOOM tiles in its bounding box and is sorted by (x, y).
"""

from __future__ import annotations

import struct
from array import array
from typing import BinaryIO, Dict, List, Tuple

import numpy as np

from tilebench.ref.core.tile import coords_arrays_to_max_zoom_tiles

_U32_LIMIT = 2**32


def _to_u32_safe(num: int) -> int:
    if num >= _U32_LIMIT or num < 0:
        raise ValueError(f"{num} doesn't fit into u32")
    return num


class _BufferedData:
    def __init__(self):
        self.all_ints = array("I")
        self.string_to_offset: Dict[bytes, int] = {}
        self.all_strings = bytearray()
        self.tags_memo: Dict[tuple, List[int]] = {}

    def add_string(self, s: str) -> Tuple[int, int]:
        b = s.encode("utf-8")
        offset = self.string_to_offset.get(b)
        if offset is None:
            offset = len(self.all_strings)
            self.string_to_offset[b] = offset
            self.all_strings.extend(b)
        return offset, len(b)

    def save(self, writer: BinaryIO) -> None:
        writer.write(struct.pack("<I", _to_u32_safe(len(self.all_ints))))
        writer.write(self.all_ints.tobytes())
        writer.write(bytes(self.all_strings))


def _save_refs(writer: BinaryIO, refs, data: _BufferedData) -> None:
    offset = len(data.all_ints)
    if isinstance(refs, np.ndarray):
        if refs.size and (int(refs.min()) < 0 or int(refs.max()) >= _U32_LIMIT):
            raise ValueError("ref doesn't fit into u32")
        data.all_ints.frombytes(refs.astype("<u4").tobytes())
    else:
        try:
            # array("I") range-checks each element in C; same u32 bound
            # as _to_u32_safe, ~10x faster than a Python append loop.
            data.all_ints.extend(refs)
        except OverflowError as e:
            raise ValueError(f"ref doesn't fit into u32: {e}") from e
    writer.write(struct.pack("<II", _to_u32_safe(offset), len(data.all_ints) - offset))


def _save_tags(writer: BinaryIO, tags: Dict[str, str], data: _BufferedData) -> None:
    # Tag dicts repeat massively across entities ({'building': 'yes'}
    # etc.); the interned (offset, len) quads are stable once the
    # strings enter the pool, so memoize per distinct sorted kv tuple.
    key = tuple(sorted(tags.items(), key=lambda kv: kv[0].encode("utf-8")))
    kv_refs = data.tags_memo.get(key)
    if kv_refs is None:
        kv_refs = []
        for k, v in key:
            k_off, k_len = data.add_string(k)
            v_off, v_len = data.add_string(v)
            kv_refs.extend((k_off, k_len, v_off, v_len))
        data.tags_memo[key] = kv_refs
    _save_refs(writer, kv_refs, data)


def save_to_internal_format(writer: BinaryIO, storages) -> None:
    data = _BufferedData()

    nodes = storages.node_storage.entities
    writer.write(struct.pack("<I", _to_u32_safe(len(nodes))))
    for node in nodes:
        writer.write(struct.pack("<Qdd", node.global_id, node.lat, node.lon))
        _save_tags(writer, node.tags, data)

    ways = storages.way_storage.entities
    writer.write(struct.pack("<I", _to_u32_safe(len(ways))))
    for way in ways:
        writer.write(struct.pack("<Q", way.global_id))
        _save_refs(writer, way.node_ids, data)
        _save_tags(writer, way.tags, data)

    polygons = storages.polygon_storage
    writer.write(struct.pack("<I", _to_u32_safe(len(polygons))))
    for polygon in polygons:
        _save_refs(writer, polygon, data)

    multipolygons = storages.multipolygon_storage.entities
    writer.write(struct.pack("<I", _to_u32_safe(len(multipolygons))))
    for mp in multipolygons:
        writer.write(struct.pack("<Q", mp.global_id))
        _save_refs(writer, mp.polygon_ids, data)
        _save_tags(writer, mp.tags, data)

    tile_keys, slots = _get_tile_references(storages)
    writer.write(struct.pack("<I", _to_u32_safe(len(tile_keys))))
    bounds = [
        (
            np.searchsorted(skeys, tile_keys, side="left"),
            np.searchsorted(skeys, tile_keys, side="right"),
            sids,
        )
        for skeys, sids in slots
    ]
    pack_ii = struct.Struct("<II").pack
    for i, key in enumerate(tile_keys.tolist()):
        writer.write(pack_ii(key >> 32, key & 0xFFFFFFFF))
        for a_all, b_all, sids in bounds:
            _save_refs(writer, sids[a_all[i] : b_all[i]], data)

    data.save(writer)


def _bbox_triplets(ref_lists, ntx, nty):
    """(key = x<<32|y, entity id) pairs for every MAX_ZOOM tile in each
    entity's node bounding box, vectorized across entities."""
    counts = np.array([len(r) for r in ref_lists], dtype=np.int64)
    live = np.nonzero(counts)[0]
    if live.size == 0:
        return (np.zeros(0, np.int64), np.zeros(0, np.int64))
    flat = np.concatenate(
        [np.asarray(ref_lists[i], dtype=np.int64) for i in live]
    )
    offs = np.zeros(live.size, dtype=np.int64)
    offs[1:] = np.cumsum(counts[live])[:-1]
    xmin = np.minimum.reduceat(ntx[flat], offs)
    xmax = np.maximum.reduceat(ntx[flat], offs)
    ymin = np.minimum.reduceat(nty[flat], offs)
    ymax = np.maximum.reduceat(nty[flat], offs)
    w = xmax - xmin + 1
    h = ymax - ymin + 1
    cells = w * h
    total = int(cells.sum())
    ent_rep = np.repeat(live, cells)
    starts = np.zeros(live.size, dtype=np.int64)
    starts[1:] = np.cumsum(cells)[:-1]
    local = np.arange(total, dtype=np.int64) - np.repeat(starts, cells)
    h_rep = np.repeat(h, cells)
    x = np.repeat(xmin, cells) + local // h_rep
    y = np.repeat(ymin, cells) + local % h_rep
    return ((x << 32) | y, ent_rep)


def _get_tile_references(storages):
    """Sorted tile keys plus per-slot (sorted keys, ids) arrays.

    Entity-to-tile assignment matches `saver.rs:167-226`: a node goes to
    its MAX_ZOOM tile; ways/multipolygons go to every tile in the
    bounding box of their nodes' tiles.  Keys are x << 32 | y so key
    order is the reference's (x, y) tile order; within a tile each
    slot's ids are ascending (the reference's sorted-set iteration)."""
    nodes = storages.node_storage.entities
    lat = np.array([n.lat for n in nodes], dtype=np.float64)
    lon = np.array([n.lon for n in nodes], dtype=np.float64)
    if len(nodes):
        ntx, nty = coords_arrays_to_max_zoom_tiles(lat, lon)
        ntx = ntx.astype(np.int64)
        nty = nty.astype(np.int64)
    else:
        ntx = nty = np.zeros(0, dtype=np.int64)

    node_keys = (ntx << 32) | nty
    node_ids = np.arange(len(nodes), dtype=np.int64)
    way_keys, way_ids = _bbox_triplets(
        [w.node_ids for w in storages.way_storage.entities], ntx, nty
    )
    polygons = storages.polygon_storage
    mp_keys, mp_ids = _bbox_triplets(
        [
            [nid for pid in mp.polygon_ids for nid in polygons[pid]]
            for mp in storages.multipolygon_storage.entities
        ],
        ntx, nty,
    )

    slots = []
    for keys, ids in ((node_keys, node_ids), (way_keys, way_ids), (mp_keys, mp_ids)):
        order = np.lexsort((ids, keys))
        slots.append((keys[order], ids[order]))

    tile_keys = np.unique(
        np.concatenate([node_keys, way_keys, mp_keys])
    )
    return tile_keys, slots
