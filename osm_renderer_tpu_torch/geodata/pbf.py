"""OSM PBF reading (and writing, for tests) without external deps.

Implements the OSM PBF container (BlobHeader/Blob framing with zlib)
and the OSMPBF protobuf messages needed for import — DenseNodes with
delta-coded ids/coords and 0-separated key/value indexes, Ways with
delta-coded refs, Relations with member types/roles — using a minimal
hand-rolled protobuf wire codec.  Semantics mirror the reference's
`parse_pbf` (`importer.rs:89-184`, osmpbf crate): coordinates are
`1e-9 * (offset + granularity * value)` as f64.

The writer exists so PBF import is round-trip testable in this
offline environment (no osmium and no sample .pbf available).
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, Iterator, List, Optional, Tuple

# --------------------------------------------------------------------------
# Minimal protobuf wire codec
# --------------------------------------------------------------------------


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _zigzag_decode(v: int) -> int:
    return (v >> 1) ^ -(v & 1)


def _iter_fields(buf: bytes) -> Iterator[Tuple[int, int, object]]:
    """Yields (field_number, wire_type, value) where value is int for
    varint/fixed and bytes for length-delimited."""
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            v, pos = _read_varint(buf, pos)
            yield field, wire, v
        elif wire == 2:
            ln, pos = _read_varint(buf, pos)
            yield field, wire, buf[pos : pos + ln]
            pos += ln
        elif wire == 5:
            yield field, wire, struct.unpack_from("<I", buf, pos)[0]
            pos += 4
        elif wire == 1:
            yield field, wire, struct.unpack_from("<Q", buf, pos)[0]
            pos += 8
        else:
            raise ValueError(f"unsupported wire type {wire}")


def _packed_varints(data: bytes, signed: bool = False) -> List[int]:
    out = []
    pos = 0
    while pos < len(data):
        v, pos = _read_varint(data, pos)
        out.append(_zigzag_decode(v) if signed else v)
    return out


def _write_varint(out: bytearray, v: int) -> None:
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _zigzag_encode(v: int) -> int:
    return (v << 1) ^ (v >> 63) if v < 0 else v << 1


def _field(out: bytearray, num: int, wire: int) -> None:
    _write_varint(out, (num << 3) | wire)


def _put_bytes(out: bytearray, num: int, data: bytes) -> None:
    _field(out, num, 2)
    _write_varint(out, len(data))
    out.extend(data)


def _put_varint(out: bytearray, num: int, v: int) -> None:
    _field(out, num, 0)
    _write_varint(out, v)


def _put_packed(out: bytearray, num: int, values, signed: bool = False) -> None:
    payload = bytearray()
    for v in values:
        _write_varint(payload, _zigzag_encode(v) if signed else v)
    _put_bytes(out, num, bytes(payload))


# --------------------------------------------------------------------------
# Reader
# --------------------------------------------------------------------------


class PbfNode:
    __slots__ = ("id", "lat", "lon", "tags")

    def __init__(self, id, lat, lon, tags):
        self.id, self.lat, self.lon, self.tags = id, lat, lon, tags


class PbfWay:
    __slots__ = ("id", "refs", "tags")

    def __init__(self, id, refs, tags):
        self.id, self.refs, self.tags = id, refs, tags


class PbfRelation:
    __slots__ = ("id", "members", "tags")  # members: (type, member_id, role)

    def __init__(self, id, members, tags):
        self.id, self.members, self.tags = id, members, tags


MEMBER_NODE, MEMBER_WAY, MEMBER_RELATION = 0, 1, 2


def _iter_blobs(path: str) -> Iterator[Tuple[str, bytes]]:
    with open(path, "rb") as f:
        while True:
            head = f.read(4)
            if len(head) < 4:
                return
            (hlen,) = struct.unpack(">I", head)
            header = f.read(hlen)
            btype = ""
            datasize = 0
            for num, wire, val in _iter_fields(header):
                if num == 1:
                    btype = val.decode("utf-8")
                elif num == 3:
                    datasize = val
            blob = f.read(datasize)
            raw = None
            for num, wire, val in _iter_fields(blob):
                if num == 1:
                    raw = val
                elif num == 3:
                    raw = zlib.decompress(val)
            if raw is None:
                raise ValueError("blob without raw or zlib data")
            yield btype, raw


def iter_entities(path: str) -> Iterator[object]:
    """Yields PbfNode / PbfWay / PbfRelation in file order."""
    for btype, raw in _iter_blobs(path):
        if btype != "OSMData":
            continue
        strings: List[str] = []
        groups: List[bytes] = []
        granularity = 100
        lat_offset = 0
        lon_offset = 0
        for num, wire, val in _iter_fields(raw):
            if num == 1:
                for n2, w2, v2 in _iter_fields(val):
                    if n2 == 1:
                        strings.append(v2.decode("utf-8"))
            elif num == 2:
                groups.append(val)
            elif num == 17:
                granularity = val
            elif num == 19:
                lat_offset = val
            elif num == 20:
                lon_offset = val
        coord = lambda off, g, v: 1e-9 * (off + g * v)

        for group in groups:
            for num, wire, val in _iter_fields(group):
                if num == 2:  # DenseNodes
                    ids = lats = lons = kv = []
                    for n2, w2, v2 in _iter_fields(val):
                        if n2 == 1:
                            ids = _packed_varints(v2, signed=True)
                        elif n2 == 8:
                            lats = _packed_varints(v2, signed=True)
                        elif n2 == 9:
                            lons = _packed_varints(v2, signed=True)
                        elif n2 == 10:
                            kv = _packed_varints(v2)
                    cid = clat = clon = 0
                    ki = 0
                    for i in range(len(ids)):
                        cid += ids[i]
                        clat += lats[i]
                        clon += lons[i]
                        tags = {}
                        while ki < len(kv) and kv[ki] != 0:
                            tags[strings[kv[ki]]] = strings[kv[ki + 1]]
                            ki += 2
                        ki += 1  # skip the 0 separator
                        yield PbfNode(
                            cid,
                            coord(lat_offset, granularity, clat),
                            coord(lon_offset, granularity, clon),
                            tags,
                        )
                elif num == 3:  # Way
                    wid = 0
                    keys = vals = refs = []
                    for n2, w2, v2 in _iter_fields(val):
                        if n2 == 1:
                            wid = v2
                        elif n2 == 2:
                            keys = _packed_varints(v2)
                        elif n2 == 3:
                            vals = _packed_varints(v2)
                        elif n2 == 8:
                            refs = _packed_varints(v2, signed=True)
                    acc = 0
                    abs_refs = []
                    for d in refs:
                        acc += d
                        abs_refs.append(acc)
                    tags = {strings[k]: strings[v] for k, v in zip(keys, vals)}
                    yield PbfWay(wid, abs_refs, tags)
                elif num == 4:  # Relation
                    rid = 0
                    keys = vals = roles = memids = types = []
                    for n2, w2, v2 in _iter_fields(val):
                        if n2 == 1:
                            rid = v2
                        elif n2 == 2:
                            keys = _packed_varints(v2)
                        elif n2 == 3:
                            vals = _packed_varints(v2)
                        elif n2 == 8:
                            roles = _packed_varints(v2)
                        elif n2 == 9:
                            memids = _packed_varints(v2, signed=True)
                        elif n2 == 10:
                            types = _packed_varints(v2)
                    acc = 0
                    members = []
                    for i in range(len(memids)):
                        acc += memids[i]
                        members.append((types[i], acc, strings[roles[i]]))
                    tags = {strings[k]: strings[v] for k, v in zip(keys, vals)}
                    yield PbfRelation(rid, members, tags)


# --------------------------------------------------------------------------
# Writer (tests/tools)
# --------------------------------------------------------------------------


class PbfWriter:
    GRANULARITY = 100

    def __init__(self, path: str):
        self.f = open(path, "wb")
        self._write_blob("OSMHeader", self._header_block())

    def _header_block(self) -> bytes:
        out = bytearray()
        _put_bytes(out, 4, b"DenseNodes")  # required_features
        return bytes(out)

    def _write_blob(self, btype: str, payload: bytes) -> None:
        blob = bytearray()
        _put_varint(blob, 2, len(payload))
        _put_bytes(blob, 3, zlib.compress(payload))
        header = bytearray()
        _put_bytes(header, 1, btype.encode())
        _put_varint(header, 3, len(blob))
        self.f.write(struct.pack(">I", len(header)))
        self.f.write(bytes(header))
        self.f.write(bytes(blob))

    @staticmethod
    def _string_table(strings: List[str]) -> bytes:
        out = bytearray()
        for s in strings:
            _put_bytes(out, 1, s.encode("utf-8"))
        return bytes(out)

    def _block(self, strings: List[str], group: bytes) -> bytes:
        out = bytearray()
        _put_bytes(out, 1, self._string_table(strings))
        _put_bytes(out, 2, group)
        _put_varint(out, 17, self.GRANULARITY)
        return bytes(out)

    def write_dense_nodes(self, nodes) -> None:
        """nodes: iterable of (id, lat, lon, tags dict)."""
        strings = [""]
        sidx: Dict[str, int] = {}

        def intern(s: str) -> int:
            i = sidx.get(s)
            if i is None:
                i = len(strings)
                strings.append(s)
                sidx[s] = i
            return i

        ids, lats, lons, kv = [], [], [], []
        pid = plat = plon = 0
        for nid, lat, lon, tags in nodes:
            ilat = round(lat * 1e9 / self.GRANULARITY)
            ilon = round(lon * 1e9 / self.GRANULARITY)
            ids.append(nid - pid)
            lats.append(ilat - plat)
            lons.append(ilon - plon)
            pid, plat, plon = nid, ilat, ilon
            for k, v in tags.items():
                kv.append(intern(k))
                kv.append(intern(v))
            kv.append(0)
        dense = bytearray()
        _put_packed(dense, 1, ids, signed=True)
        _put_packed(dense, 8, lats, signed=True)
        _put_packed(dense, 9, lons, signed=True)
        _put_packed(dense, 10, kv)
        group = bytearray()
        _put_bytes(group, 2, bytes(dense))
        self._write_blob("OSMData", self._block(strings, bytes(group)))

    def write_ways(self, ways) -> None:
        """ways: iterable of (id, refs, tags)."""
        strings = [""]
        sidx: Dict[str, int] = {}

        def intern(s: str) -> int:
            i = sidx.get(s)
            if i is None:
                i = len(strings)
                strings.append(s)
                sidx[s] = i
            return i

        group = bytearray()
        for wid, refs, tags in ways:
            way = bytearray()
            _put_varint(way, 1, wid)
            _put_packed(way, 2, [intern(k) for k in tags])
            _put_packed(way, 3, [intern(v) for v in tags.values()])
            deltas = []
            prev = 0
            for r in refs:
                deltas.append(r - prev)
                prev = r
            _put_packed(way, 8, deltas, signed=True)
            _put_bytes(group, 3, bytes(way))
        self._write_blob("OSMData", self._block(strings, bytes(group)))

    def write_relations(self, relations) -> None:
        """relations: iterable of (id, members [(type, id, role)], tags)."""
        strings = [""]
        sidx: Dict[str, int] = {}

        def intern(s: str) -> int:
            i = sidx.get(s)
            if i is None:
                i = len(strings)
                strings.append(s)
                sidx[s] = i
            return i

        group = bytearray()
        for rid, members, tags in relations:
            rel = bytearray()
            _put_varint(rel, 1, rid)
            _put_packed(rel, 2, [intern(k) for k in tags])
            _put_packed(rel, 3, [intern(v) for v in tags.values()])
            _put_packed(rel, 8, [intern(role) for (_, _, role) in members])
            deltas = []
            prev = 0
            for (_, mid, _) in members:
                deltas.append(mid - prev)
                prev = mid
            _put_packed(rel, 9, deltas, signed=True)
            _put_packed(rel, 10, [t for (t, _, _) in members])
            _put_bytes(group, 4, bytes(rel))
        self._write_blob("OSMData", self._block(strings, bytes(group)))

    def close(self) -> None:
        self.f.close()
