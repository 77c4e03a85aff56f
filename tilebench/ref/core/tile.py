"""Web-Mercator projection and tile math.

Semantics match the reference renderer (`src/tile.rs:1-107` in
dfyz/osm-renderer): slippy-map tiles, 256 px base tile size, a fixed
maximum zoom of 18 used for the spatial index, and the standard
spherical-Mercator forward projection.

All functions are vectorized over numpy arrays in float64 — projection
at z18 spans a ~2^26 pixel range, which exceeds float32's 24-bit
mantissa, so the *global* projection always runs in f64 on the host.
Tile-relative coordinates (small) are safe to ship to the device in f32
(see `osm_renderer_tpu.ops.projection` for the jax variant).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np

MAX_ZOOM = 18
TILE_SIZE = 256

_U32_MAX = np.float64(2**32 - 1)


class Tile(NamedTuple):
    zoom: int
    x: int
    y: int


class TileRange(NamedTuple):
    min_x: int
    max_x: int
    min_y: int
    max_y: int


def coords_to_xy(lat, lon, zoom: int):
    """Project (lat, lon) degrees to global pixel x/y at `zoom`.

    Matches `tile.rs:88-101`:
        x = lon_rad + pi;  y = pi - ln(tan(pi/4 + lat_rad/2))
    rescaled by 256 * 2^zoom / (2*pi).

    Test vectors (from the reference doc-tests, `tile.rs:76-87`):
        (55.747764, 37.437745) @ z5  -> (4947, 2561) after floor
        (55.747764, 37.437745) @ z18 -> (40533333, 20981065)
        (40.1222, 20.6852) @ z0      -> (142, 96)
        (-35.306536, 149.126545) @ z10 -> (239662, 158582)
    """
    lat_rad = np.radians(np.asarray(lat, dtype=np.float64))
    lon_rad = np.radians(np.asarray(lon, dtype=np.float64))

    x = lon_rad + math.pi
    y = math.pi - np.log(np.tan(math.pi / 4.0 + lat_rad / 2.0))

    dimension_in_pixels = float(TILE_SIZE * (1 << zoom))
    factor = dimension_in_pixels / (2.0 * math.pi)
    return x * factor, y * factor


def _f64_as_u32(v):
    """Replicate Rust's `f64 as u32` cast: truncate toward zero,
    saturating to [0, u32::MAX]; NaN maps to 0."""
    v = np.asarray(v, dtype=np.float64)
    v = np.where(np.isnan(v), 0.0, v)
    v = np.clip(np.trunc(v), 0.0, _U32_MAX)
    return v.astype(np.uint32)


def coords_to_max_zoom_tile(lat, lon) -> "Tile":
    """Tile id at MAX_ZOOM containing the point (`tile.rs:30-38`)."""
    x, y = coords_to_xy(lat, lon, MAX_ZOOM)
    tx = _f64_as_u32(x) // TILE_SIZE
    ty = _f64_as_u32(y) // TILE_SIZE
    if np.ndim(tx) == 0:
        return Tile(MAX_ZOOM, int(tx), int(ty))
    return Tile(MAX_ZOOM, tx, ty)


def coords_arrays_to_max_zoom_tiles(lat: np.ndarray, lon: np.ndarray):
    """Vectorized variant returning (tx, ty) uint32 arrays."""
    x, y = coords_to_xy(lat, lon, MAX_ZOOM)
    return _f64_as_u32(x) // TILE_SIZE, _f64_as_u32(y) // TILE_SIZE


def tile_to_max_zoom_tile_range(tile: Tile) -> TileRange:
    """Range of MAX_ZOOM tiles covered by `tile` (`tile.rs:63-73`)."""
    shift = MAX_ZOOM - tile.zoom
    min_x = tile.x << shift
    min_y = tile.y << shift
    delta = (1 << shift) - 1
    return TileRange(min_x, min_x + delta, min_y, min_y + delta)


def coords_to_xy_tile_relative(lat, lon, tile: Tile):
    """Pixel coordinates relative to a tile's top-left corner
    (`tile.rs:103-106`)."""
    x, y = coords_to_xy(lat, lon, tile.zoom)
    return x - float(tile.x * TILE_SIZE), y - float(tile.y * TILE_SIZE)
