"""Process start to the window's first request: city, service, kernels, the hot set's warm passes."""

from tilebench.readers import setup_s as read  # noqa: F401
