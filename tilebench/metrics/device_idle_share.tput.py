"""Share of the traced window in which no operation ran on the device (closed loop)."""

from tilebench.readers import device_idle_share as read  # noqa: F401
