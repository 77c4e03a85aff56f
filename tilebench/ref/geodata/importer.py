"""OSM XML importer -> in-memory entity storages -> binary geodata file.

Semantics match the reference importer (`src/geodata/importer.rs`):

* streaming XML event parsing (raw `xml.parsers.expat` callbacks — no
  per-element DOM objects);
* way node refs are translated from global to local ids, dropping refs
  to nodes that were not seen;
* consecutive duplicate node pairs are removed (`postprocess_node_refs`,
  `importer.rs:334-353`);
* relations tagged type=multipolygon are decomposed into closed rings
  via `find_polygons` and stored as polygons + a multipolygon record;
* tags are stored sorted by UTF-8 byte order (Rust BTreeMap order).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from tilebench.ref.geodata.find_polygons import (
    NodeDesc,
    NodeDescPair,
    find_polygons_in_multipolygon,
)
from tilebench.ref.geodata.saver import save_to_internal_format

RawTags = Dict[str, str]


@dataclass
class RawNode:
    global_id: int
    lat: float
    lon: float
    tags: RawTags = field(default_factory=dict)


@dataclass
class RawWay:
    global_id: int
    node_ids: List[int] = field(default_factory=list)
    tags: RawTags = field(default_factory=dict)


@dataclass
class Multipolygon:
    global_id: int
    polygon_ids: List[int] = field(default_factory=list)
    tags: RawTags = field(default_factory=dict)


class OsmEntityStorage:
    def __init__(self):
        self.global_id_to_local_id: Dict[int, int] = {}
        self.entities: List = []

    def add(self, global_id: int, entity) -> None:
        self.global_id_to_local_id[global_id] = len(self.entities)
        self.entities.append(entity)

    def translate_id(self, global_id: int) -> Optional[int]:
        return self.global_id_to_local_id.get(global_id)


@dataclass
class EntityStorages:
    node_storage: OsmEntityStorage = field(default_factory=OsmEntityStorage)
    way_storage: OsmEntityStorage = field(default_factory=OsmEntityStorage)
    polygon_storage: List[List[int]] = field(default_factory=list)
    multipolygon_storage: OsmEntityStorage = field(default_factory=OsmEntityStorage)


def postprocess_node_refs(refs: List[int]) -> List[int]:
    if not refs:
        return refs
    seen_node_pairs = set()
    out = [refs[0]]
    for idx in range(1, len(refs)):
        cur, prev = refs[idx], refs[idx - 1]
        if (cur, prev) not in seen_node_pairs and (prev, cur) not in seen_node_pairs:
            seen_node_pairs.add((cur, prev))
            out.append(cur)
    return out


def _relation_to_segments(
    way_refs: List[Tuple[int, bool]], storages: EntityStorages
) -> List[NodeDescPair]:
    segments: List[NodeDescPair] = []
    nodes = storages.node_storage.entities
    for way_id, is_inner in way_refs:
        way = storages.way_storage.entities[way_id]
        ids = way.node_ids
        for i in range(1, len(ids)):
            n1, n2 = nodes[ids[i - 1]], nodes[ids[i]]
            segments.append(
                NodeDescPair(
                    NodeDesc.new(ids[i - 1], n1.lat, n1.lon),
                    NodeDesc.new(ids[i], n2.lat, n2.lon),
                    is_inner,
                )
            )
    return segments


def _print_storage_stats(storages: EntityStorages) -> None:
    print(
        f"Got {len(storages.node_storage.entities)} nodes, "
        f"{len(storages.way_storage.entities)} ways and "
        f"{len(storages.multipolygon_storage.entities)} multipolygon relations so far"
    )


def _finish_relation(
    global_id: int,
    tags: RawTags,
    way_refs: List[Tuple[int, bool]],
    storages: EntityStorages,
) -> None:
    if tags.get("type") != "multipolygon":
        return
    segments = _relation_to_segments(way_refs, storages)
    polygons = find_polygons_in_multipolygon(global_id, segments)
    if polygons is None:
        return
    mp = Multipolygon(global_id=global_id, tags=tags)
    for poly in polygons:
        mp.polygon_ids.append(len(storages.polygon_storage))
        storages.polygon_storage.append(poly)
    storages.multipolygon_storage.add(global_id, mp)


def parse_osm_xml(path: str) -> EntityStorages:
    """Streaming parse via raw expat callbacks.

    `iterparse` builds (and clears) an Element per XML element; for an
    OSM file that is millions of throwaway objects.  Direct expat
    handlers keep the same semantics (start sets the current entity,
    empty children attach on their start event, end finalizes) at a
    fraction of the cost."""
    import xml.parsers.expat as _expat

    storages = EntityStorages()
    elem_count = 0
    print("Parsing XML")

    node_xlat = storages.node_storage.global_id_to_local_id.get
    way_xlat = storages.way_storage.global_id_to_local_id.get

    # Current entity being assembled (set on start, completed on end).
    cur_node: Optional[RawNode] = None
    cur_way: Optional[RawWay] = None
    cur_rel_id: Optional[int] = None
    cur_rel_tags: Optional[RawTags] = None
    cur_rel_ways: Optional[List[Tuple[int, bool]]] = None

    def start(name, attrs):
        nonlocal cur_node, cur_way, cur_rel_id, cur_rel_tags, cur_rel_ways
        name = name.rpartition(":")[2]  # strip any namespace prefix
        if name == "nd":
            if cur_way is not None:
                local = node_xlat(int(attrs["ref"]))
                if local is not None:
                    cur_way.node_ids.append(local)
        elif name == "tag":
            if cur_node is not None:
                cur_node.tags[attrs["k"]] = attrs["v"]
            elif cur_way is not None:
                cur_way.tags[attrs["k"]] = attrs["v"]
            elif cur_rel_tags is not None:
                cur_rel_tags[attrs["k"]] = attrs["v"]
        elif name == "node":
            cur_node = RawNode(
                global_id=int(attrs["id"]),
                lat=float(attrs["lat"]),
                lon=float(attrs["lon"]),
            )
        elif name == "way":
            cur_way = RawWay(global_id=int(attrs["id"]))
        elif name == "member":
            if cur_rel_ways is not None and attrs.get("type") == "way":
                local = way_xlat(int(attrs["ref"]))
                if local is not None:
                    cur_rel_ways.append((local, attrs.get("role") == "inner"))
        elif name == "relation":
            cur_rel_id = int(attrs["id"])
            cur_rel_tags = {}
            cur_rel_ways = []

    def end(name):
        nonlocal cur_node, cur_way, cur_rel_id, cur_rel_tags, cur_rel_ways
        nonlocal elem_count
        name = name.rpartition(":")[2]
        if name == "node":
            storages.node_storage.add(cur_node.global_id, cur_node)
            cur_node = None
        elif name == "way":
            cur_way.node_ids = postprocess_node_refs(cur_way.node_ids)
            storages.way_storage.add(cur_way.global_id, cur_way)
            cur_way = None
        elif name == "relation":
            _finish_relation(cur_rel_id, cur_rel_tags, cur_rel_ways, storages)
            cur_rel_id = cur_rel_tags = cur_rel_ways = None
        else:
            return
        elem_count += 1
        if elem_count % 100_000 == 0:
            _print_storage_stats(storages)

    parser = _expat.ParserCreate()
    parser.buffer_text = True
    parser.StartElementHandler = start
    parser.EndElementHandler = end
    with open(path, "rb") as f:
        parser.ParseFile(f)

    _print_storage_stats(storages)
    return storages


def import_osm(input_path: str, output_path: str) -> None:
    """Importer entry point (reference: `importer.rs:19-43`)."""
    ext = os.path.splitext(input_path)[1].lower()
    if ext in (".osm", ".xml"):
        parsed = parse_osm_xml(input_path)
    else:
        raise ValueError("Extension not supported")

    print("Converting geodata to internal format")
    with open(output_path, "wb") as writer:
        save_to_internal_format(writer, parsed)
