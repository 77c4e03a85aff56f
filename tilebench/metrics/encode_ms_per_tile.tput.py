"""Span "Compose and encode" summed over the window, per tile served."""

from tilebench.readers import encode_ms_per_tile as read  # noqa: F401
