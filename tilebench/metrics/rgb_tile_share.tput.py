"""Program count "Tiles as RGB PNG" over the tiles served in the window, in %."""

from tilebench.program_readers import rgb_tile_share as read  # noqa: F401
