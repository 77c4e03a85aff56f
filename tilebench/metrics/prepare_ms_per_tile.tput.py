"""Span "Prepare device batch (batch share)" summed over the window, per tile served."""

from tilebench.readers import prepare_ms_per_tile as read  # noqa: F401
