"""Program span "Queue wait" (a request's put on the batcher's queue to its render call's start) summed over the window, per tile served."""

from tilebench.program_readers import queue_wait_ms_per_tile as read  # noqa: F401
