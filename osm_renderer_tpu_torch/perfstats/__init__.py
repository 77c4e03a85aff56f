from osm_renderer_tpu_torch.perfstats.spans import (
    WAIT,
    DeviceClock,
    PerfStats,
    add_span,
    count,
    finish_tile,
    launch_events,
    measure,
    start_tile,
)

__all__ = ["WAIT", "DeviceClock", "PerfStats", "add_span", "count", "finish_tile",
           "launch_events", "measure", "start_tile"]
