"""Span "Get tile entities (batch share)" summed over the window, per tile served."""

from tilebench.readers import entities_ms_per_tile as read  # noqa: F401
