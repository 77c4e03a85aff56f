"""Requests a render call of the micro-batcher took, mean over the window (closed loop)."""

from tilebench.readers import batch_tiles_mean as read  # noqa: F401
