"""The render launches' least time (bounds.render_bound_s) over the render kernel's device time."""

from tilebench.readers import render_roofline as read  # noqa: F401
