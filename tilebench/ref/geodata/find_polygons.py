"""Multipolygon ring assembly.

Stitches a relation's way segments into closed rings (>= 3 segments),
separately for inner/outer roles, with the same greedy walk and
vertex-reuse rules as the reference (`src/geodata/find_polygons.rs`):
if any segment cannot be matched into a ring, the whole relation is
dropped with a warning.

Node positions are keyed by the *bit patterns* of (lat, lon) so that
distinct-but-equal floats (and -0.0 vs 0.0) behave identically to the
reference.
"""

from __future__ import annotations

import struct
import sys
from typing import Dict, List, NamedTuple, Optional, Set, Tuple

NodePos = Tuple[int, int]  # (lat_bits, lon_bits)


def _f64_bits(v: float) -> int:
    return struct.unpack("<Q", struct.pack("<d", v))[0]


class NodeDesc(NamedTuple):
    id: int
    pos: NodePos

    @staticmethod
    def new(node_id: int, lat: float, lon: float) -> "NodeDesc":
        return NodeDesc(node_id, (_f64_bits(lat), _f64_bits(lon)))


class NodeDescPair(NamedTuple):
    node1: NodeDesc
    node2: NodeDesc
    is_inner: bool


class _ConnectedSegment(NamedTuple):
    other_side: NodePos
    segment_index: int
    is_inner: bool


def find_polygons_in_multipolygon(
    relation_id: int, relation_segments: List[NodeDescPair]
) -> Optional[List[List[int]]]:
    """Returns a list of polygons (each a list of node local-ids forming a
    closed ring) or None if the relation is not a valid multipolygon."""
    connections = _get_connections(relation_segments)
    available = [True] * len(relation_segments)
    all_rings = _find_rings(relation_id, relation_segments, connections, available)
    if all_rings is None:
        return None

    polygons: List[List[int]] = []
    for ring in all_rings:
        polygon: List[int] = []
        for idx, seg_idx in enumerate(ring):
            seg = relation_segments[seg_idx]
            if idx == 0:
                polygon.append(seg.node1.id)
            last_node = polygon[-1]
            polygon.append(seg.node2.id if last_node == seg.node1.id else seg.node1.id)
        polygons.append(polygon)
    return polygons


def _get_connections(segments: List[NodeDescPair]) -> Dict[NodePos, List[_ConnectedSegment]]:
    connections: Dict[NodePos, List[_ConnectedSegment]] = {}
    for idx, seg in enumerate(segments):
        connections.setdefault(seg.node1.pos, []).append(
            _ConnectedSegment(seg.node2.pos, idx, seg.is_inner)
        )
        connections.setdefault(seg.node2.pos, []).append(
            _ConnectedSegment(seg.node1.pos, idx, seg.is_inner)
        )
    return connections


def _find_rings(
    relation_id: int,
    segments: List[NodeDescPair],
    connections: Dict[NodePos, List[_ConnectedSegment]],
    available: List[bool],
) -> Optional[List[List[int]]]:
    res: List[List[int]] = []
    unmatched_count = len(segments)
    for start_idx in range(len(available)):
        if not available[start_idx]:
            continue
        available[start_idx] = False
        start_segment = segments[start_idx]
        used_segments = [start_idx]
        used_vertices: Set[NodePos] = {start_segment.node1.pos, start_segment.node2.pos}

        first_pos = start_segment.node1.pos
        is_inner = start_segment.is_inner

        if not _find_ring_from(
            start_segment.node2.pos,
            first_pos,
            is_inner,
            connections,
            available,
            used_segments,
            used_vertices,
        ):
            print(
                f"Relation #{relation_id} is not a valid multipolygon "
                f"(built {len(res)} complete rings, but {unmatched_count} segments are unmatched)",
                file=sys.stderr,
            )
            return None

        unmatched_count -= len(used_segments)
        res.append(used_segments)
    return res


def _find_ring_from(
    start_pos: NodePos,
    first_pos: NodePos,
    is_inner: bool,
    connections: Dict[NodePos, List[_ConnectedSegment]],
    available: List[bool],
    used_segments: List[int],
    used_vertices: Set[NodePos],
) -> bool:
    while True:
        seg = None
        for cand in connections.get(start_pos, ()):  # insertion order, like the reference
            can_use = cand.is_inner == is_inner and available[cand.segment_index]
            is_duplicate = cand.other_side in used_vertices and cand.other_side != first_pos
            if can_use and not is_duplicate:
                seg = cand
                break
        if seg is None:
            return False
        available[seg.segment_index] = False
        used_segments.append(seg.segment_index)
        used_vertices.add(seg.other_side)
        if first_pos == seg.other_side:
            return len(used_segments) >= 3
        start_pos = seg.other_side
