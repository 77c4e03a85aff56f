"""Tiles a device dispatch carried, mean over the window: program counts "Dispatched tiles" over "Device dispatches (batch share)"."""

from tilebench.program_readers import dispatch_tiles_mean as read  # noqa: F401
