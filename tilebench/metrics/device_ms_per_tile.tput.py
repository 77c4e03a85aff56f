"""Program span "Device time (batch share)" (CUDA timing events that each kernel launch entry records just before and just after its launch, summed over a dispatch) summed over the window, per tile served."""

from tilebench.program_readers import device_ms_per_tile as read  # noqa: F401
