"""The wire launches' least time (bounds.wire_bound_s) over the wire kernel's device time."""

from tilebench.readers import wire_roofline as read  # noqa: F401
