"""On the card: the serving path's interval log is on the profiler's
clock, and its CUDA-event device time (`perfstats.DeviceClock`, events
that each launch entry records just before and just after its launch)
agrees with the device operations the profiler records.  Skips without
a CUDA device.  `chip_smoke.py` runs it on the card.  It imports
neither JAX nor the suite's conftest (which does), so it runs alone:

    python -m pytest --noconftest tests/test_torch_trace_card.py -q -p no:cacheprovider

The CPU side of the same records is `test_torch_serving_trace.py`.
"""

import os

import pytest
import torch

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL_NS = 500_000  # 0.5 ms: how far a device event may lie outside its host interval
TRACES = 3  # traced batches tried for one whose trace holds every kernel


def _device_ops(prof):
    """(name, start, end) of each device operation, Unix ns."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if str(e.device_type()).split(".")[-1] == "CUDA" and e.duration_ns() > 0:
            out.append((e.name(), e.start_ns(), e.start_ns() + e.duration_ns()))
    return out


def _inside(s, e, windows):
    return any(w0 - TOL_NS <= s and e <= w1 + TOL_NS for w0, w1 in windows)


def test_device_work_lies_inside_its_batch_intervals(tmp_path):
    """One warm batch of the 48-block city's 29 z14 tiles @1x and @2x
    (two dispatches, ~0.5-1 ms of kernels each), traced: every render and
    wire kernel starts after its dispatch's interval opens and ends
    before its device wait closes, and the batch's "Device time (batch
    share)" is within 15 % of the device operations the profiler saw
    between the clock's events: the render kernel, and the wire's memset
    and kernel.  The events are recorded in the C launch entries, so a
    pair holds no host code; what it holds beyond the operations is the
    gap from an event to its launch on an idle stream, microseconds."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; test_torch_serving_trace.py holds the CPU side")
    from torch.profiler import ProfilerActivity, profile

    from osm_renderer_tpu_torch.mapcss.parser import parse_file
    from osm_renderer_tpu_torch.mapcss.styler import Styler
    from osm_renderer_tpu_torch.perfstats import PerfStats
    from osm_renderer_tpu_torch.server.http import TileService
    from osm_renderer_tpu_torch.tools.corpus import build_fixture, zoom_tiles

    sheets = os.path.join(REPO_ROOT, "assets", "stylesheets")
    binf = build_fixture(str(tmp_path / "city.osm"), str(tmp_path / "city.bin"), 48)
    svc = TileService(binf, Styler(parse_file(sheets, "default.mapcss"), "josm"), sheets,
                      device="cuda", png_cache_tiles=0, enable_labels=False)
    reqs = [(t, s) for s in (1, 2) for t in zoom_tiles(svc.reader, 14)]
    for _ in range(3):  # cold assembly, the palette, the wire caps
        svc.render_tiles_device(reqs)
    with profile(activities=[ProfilerActivity.CUDA]):  # a first trace can miss operations
        svc.render_tiles_device(reqs)
    seen = []
    for _ in range(TRACES):
        svc.perf_stats = PerfStats(intervals=100)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            svc.render_tiles_device(reqs)
        log = list(svc.perf_stats.intervals)
        starts = [s for name, s, _, _ in log if name == "Dispatch"]
        ends = [e for name, _, e, _ in log if name == "Device wait"]
        assert len(starts) == len(ends) == 2, log
        windows = list(zip(starts, ends))
        ops = _device_ops(prof)
        kernels = [op for op in ops if "render_kernel" in op[0] or "wire_kernel" in op[0]]
        seen.append(len(kernels))
        if len(kernels) == 2 * len(windows):  # the profiler kept every launch
            break
    else:
        pytest.fail(f"no trace held one render and one wire kernel a dispatch: {seen}")
    for name, s, e in kernels:
        assert _inside(s, e, windows), (name, s, e, windows)
    device_s = sum(root.children["Device time (batch share)"].total
                   for root in svc.perf_stats.by_zoom.values())
    timed = ("render_kernel", "wire_kernel", "Memset")
    between = [(n, s, e) for n, s, e in ops
               if _inside(s, e, windows) and any(k in n for k in timed)]
    traced_s = sum(e - s for _, s, e in between) / 1e9
    others_s = sum(e - s for n, s, e in ops if _inside(s, e, windows)) / 1e9 - traced_s
    print(f"device time {device_s * 1e3:.4f} ms; the profiler's {len(between)} render, memset "
          f"and wire operations {traced_s * 1e3:.4f} ms, its other operations in the windows "
          f"{others_s * 1e3:.4f} ms")
    assert abs(device_s - traced_s) <= 0.15 * traced_s, (device_s, traced_s, between)
