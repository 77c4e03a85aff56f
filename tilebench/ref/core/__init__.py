from tilebench.ref.core.tile import (
    MAX_ZOOM,
    TILE_SIZE,
    Tile,
    TileRange,
    coords_to_max_zoom_tile,
    coords_to_xy,
    coords_to_xy_tile_relative,
    tile_to_max_zoom_tile_range,
)

__all__ = [
    "MAX_ZOOM",
    "TILE_SIZE",
    "Tile",
    "TileRange",
    "coords_to_max_zoom_tile",
    "coords_to_xy",
    "coords_to_xy_tile_relative",
    "tile_to_max_zoom_tile_range",
]
