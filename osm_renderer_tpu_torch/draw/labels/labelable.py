"""Label anchor placement (pole of inaccessibility).

Mapnik-variant polylabel matching the reference (`labelable.rs:121-189`):
cell-subdivision search over the largest outer ring (plus rings fully
inside it), fitness = distance-to-polygon * (1 - dist-to-centroid /
max_dim), precision = max(bb dims) / 100 * scale.
"""

from __future__ import annotations

import heapq
import math
from typing import List, Optional, Tuple

import numpy as np

from osm_renderer_tpu_torch.core.tile import Tile, coords_to_xy
from osm_renderer_tpu_torch.geodata.reader import Multipolygon, Node, Way
from osm_renderer_tpu_torch.draw.primitives import project_points

PointF = Tuple[float, float]


def nodes_to_points_f(lats, lons, tile: Tile, scale: float) -> List[PointF]:
    x, y = coords_to_xy(lats, lons, tile.zoom)
    x = (x - float(tile.x * 256)) * scale
    y = (y - float(tile.y * 256)) * scale
    return list(zip(x.tolist(), y.tolist()))


def get_waypoints(entity, tile: Tile, scale: float) -> Optional[np.ndarray]:
    """Integer waypoints for line-text placement (ways only)."""
    if not isinstance(entity, Way):
        return None
    lats, lons = entity.node_latlons()
    return project_points(lats, lons, tile, scale)


def get_label_position(entity, tile: Tile, scale: float) -> Optional[PointF]:
    if isinstance(entity, Node):
        pts = project_points(
            np.array([entity.lat]), np.array([entity.lon]), tile, scale
        )
        return float(pts[0, 0]), float(pts[0, 1])
    if isinstance(entity, Way):
        lats, lons = entity.node_latlons()
        polygons = [nodes_to_points_f(lats, lons, tile, scale)]
    elif isinstance(entity, Multipolygon):
        polygons = []
        for pi in range(entity.polygon_count()):
            poly = entity.get_polygon(pi)
            lats, lons = poly.node_latlons()
            polygons.append(nodes_to_points_f(lats, lons, tile, scale))
    else:
        return None
    return _get_label_position(polygons, scale)


def _iterate_polygon(poly: List[PointF]):
    for idx in range(1, len(poly)):
        yield poly[idx], poly[idx - 1]


def _cross(a: PointF, b: PointF) -> float:
    return a[0] * b[1] - b[0] * a[1]


def _polygon_area(poly: List[PointF]) -> float:
    return abs(sum(_cross(a, b) for a, b in _iterate_polygon(poly)))


def _segment_dist_sq(point: PointF, a: PointF, b: PointF) -> float:
    x, y = a
    dx = b[0] - x
    dy = b[1] - y
    if dx != 0.0 or dy != 0.0:
        t = ((point[0] - x) * dx + (point[1] - y) * dy) / (dx * dx + dy * dy)
        if t > 1.0:
            x, y = b
        elif t > 0.0:
            x += dx * t
            y += dy * t
    dx = point[0] - x
    dy = point[1] - y
    return dx * dx + dy * dy


def point_to_polygon_dist(point: PointF, polygons: List[List[PointF]]) -> float:
    inside = False
    min_dist_sq = math.inf
    for poly in polygons:
        for a, b in _iterate_polygon(poly):
            if (a[1] > point[1]) != (b[1] > point[1]) and (
                point[0] < (b[0] - a[0]) * (point[1] - a[1]) / (b[1] - a[1]) + a[0]
            ):
                inside = not inside
            min_dist_sq = min(min_dist_sq, _segment_dist_sq(point, a, b))
    return (1.0 if inside else -1.0) * math.sqrt(min_dist_sq)


def _centroid(poly: List[PointF]) -> PointF:
    area = 0.0
    cx = cy = 0.0
    for a, b in _iterate_polygon(poly):
        comp = _cross(a, b)
        cx += (a[0] + b[0]) * comp
        cy += (a[1] + b[1]) * comp
        area += comp * 3.0
    if area == 0.0:
        return poly[0]
    return cx / area, cy / area


def _filter_polygons(polygons: List[List[PointF]]) -> List[List[PointF]]:
    largest_idx = 0
    largest_area = _polygon_area(polygons[0])
    for i in range(1, len(polygons)):
        area = _polygon_area(polygons[i])
        if area > largest_area:
            largest_idx, largest_area = i, area
    polygons[0], polygons[largest_idx] = polygons[largest_idx], polygons[0]

    good = 1
    for i in range(1, len(polygons)):
        if all(point_to_polygon_dist(p, polygons[:1]) >= 0.0 for p in polygons[i]):
            polygons[i], polygons[good] = polygons[good], polygons[i]
            good += 1
    return polygons[:good]


def _get_label_position(polygons: List[List[PointF]], scale: float) -> Optional[PointF]:
    if not polygons or not polygons[0]:
        return None
    polygons = _filter_polygons(polygons)

    xs = [p[0] for p in polygons[0]]
    ys = [p[1] for p in polygons[0]]
    min_x, max_x = min(xs), max(xs)
    min_y, max_y = min(ys), max(ys)
    precision = max(max_x - min_x, max_y - min_y) / 100.0 * scale
    return _polylabel(polygons, (min_x, max_x, min_y, max_y), precision)


def _polylabel(polygons, bb, precision: float) -> PointF:
    min_x, max_x, min_y, max_y = bb
    width, height = max_x - min_x, max_y - min_y
    cell_size = min(width, height)
    max_size = max(width, height)
    half = cell_size / 2.0

    if cell_size == 0.0:
        return (min_x, min_y)

    centroid = _centroid(polygons[0])

    def fitness(center: PointF, distance_polygon: float) -> float:
        if distance_polygon <= 0.0:
            return distance_polygon
        d0 = center[0] - centroid[0]
        d1 = center[1] - centroid[1]
        distance_centroid = math.sqrt(d0 * d0 + d1 * d1)
        return distance_polygon * (1.0 - distance_centroid / max_size)

    def make_cell(center: PointF, half_size: float):
        d = point_to_polygon_dist(center, polygons)
        max_fit_dist = d + half_size * math.sqrt(2.0)
        return (fitness(center, d), fitness(center, max_fit_dist), center, half_size)

    heap: list = []
    counter = 0

    def push(cell):
        nonlocal counter
        heapq.heappush(heap, (-cell[1], counter, cell))
        counter += 1

    x = min_x
    while x < max_x:
        y = min_y
        while y < max_y:
            push(make_cell((x + half, y + half), half))
            y += cell_size
        x += cell_size

    best = make_cell(centroid, 0.0)
    while heap:
        _, _, cell = heapq.heappop(heap)
        if cell[0] > best[0]:
            best = cell
        if cell[1] - best[0] <= precision:
            continue
        h = cell[3] / 2.0
        cx, cy = cell[2]
        for dx in (-1.0, 1.0):
            for dy in (-1.0, 1.0):
                push(make_cell((cx + dx * h, cy + dy * h), h))
    return best[2]
