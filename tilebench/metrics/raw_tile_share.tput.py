"""Program count "Tiles from raw batches" (the wire cap's overflow fallback) over the tiles served in the window, in %."""

from tilebench.program_readers import raw_tile_share as read  # noqa: F401
