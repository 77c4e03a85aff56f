"""The arithmetic of the metrics read from the program's own records.

The program's tile service keeps, in each tile's perfstats record, spans
(seconds) and counts (events) at its serving boundaries; the harness
sums each top-level node over the window (`run.perf_snapshot`), and
these readers divide the window's differences (`w.spans`) by the tiles
finished in it (`w.tiles_done`).  A reader returns None when the window
holds no tile or the program records no such node (a program older than
the node).
"""

from __future__ import annotations

from typing import Optional

QUEUE_WAIT = "Queue wait"
DISPATCHES = "Device dispatches (batch share)"
DISPATCHED_TILES = "Dispatched tiles"
DEVICE_TIME = "Device time (batch share)"
RAW_TILES = "Tiles from raw batches"
RGB_TILES = "Tiles as RGB PNG"


def _per_tile(w, node: str, scale: float) -> Optional[float]:
    if not w.tiles_done or node not in w.spans:
        return None
    return scale * w.spans[node] / w.tiles_done


def queue_wait_ms_per_tile(w) -> Optional[float]:
    return _per_tile(w, QUEUE_WAIT, 1e3)


def dispatch_tiles_mean(w) -> Optional[float]:
    if not w.tiles_done or DISPATCHED_TILES not in w.spans or not w.spans.get(DISPATCHES):
        return None
    return w.spans[DISPATCHED_TILES] / w.spans[DISPATCHES]


def device_ms_per_tile(w) -> Optional[float]:
    return _per_tile(w, DEVICE_TIME, 1e3)


def raw_tile_share(w) -> Optional[float]:
    return _per_tile(w, RAW_TILES, 100.0)


def rgb_tile_share(w) -> Optional[float]:
    return _per_tile(w, RGB_TILES, 100.0)
