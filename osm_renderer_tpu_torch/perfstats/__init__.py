from osm_renderer_tpu_torch.perfstats.spans import (
    PerfStats,
    add_span,
    finish_tile,
    measure,
    start_tile,
)

__all__ = ["PerfStats", "add_span", "finish_tile", "measure", "start_tile"]
