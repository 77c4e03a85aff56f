"""PNG tiles answered with status 200 inside the window, over the window's seconds."""

from tilebench.readers import tiles_per_s as read  # noqa: F401
