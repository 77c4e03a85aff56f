"""The serving path's own measurements, on the CPU (the kernels' plain
versions): perfstats counts and the interval log, the spans and counts a
micro-batch of @1x and @2x requests leaves in its tiles' records through
`run_server`, and a direct render call, outside the batcher, which
records no queue wait.  `test_torch_trace_card.py` holds the interval
log and the CUDA-event device time to the profiler's trace on the card."""

import asyncio
import concurrent.futures
import socket
import threading
import time
import urllib.request
from collections import Counter

import pytest

from osm_renderer_tpu_torch import perfstats
from osm_renderer_tpu_torch.core.tile import Tile, coords_to_max_zoom_tile
from osm_renderer_tpu_torch.perfstats import PerfStats
from osm_renderer_tpu_torch.server.http import TileService, run_server

from tests.test_torch_helpers import STYLESHEET_DIR, port_bin, port_styler, torch_threads

BATCH_INTERVALS = {"Dispatch", "Device wait", "Compose and encode", "Batch"}


@pytest.fixture(scope="module")
def mini_bin(tmp_path_factory):
    return port_bin(tmp_path_factory.mktemp("trace"))


@pytest.fixture(scope="module")
def styler():
    return port_styler()


def _tiles(n):
    t18 = coords_to_max_zoom_tile(47.1412, 9.5215)
    return [Tile(z, t18.x >> (18 - z), t18.y >> (18 - z)) for z in range(15, 15 + n)]


def _nodes(stats: PerfStats) -> dict:
    """Each top-level node's total summed over zooms, as the benchmark
    reads them."""
    out: dict = {}
    for root in stats.by_zoom.values():
        for name, node in root.children.items():
            out[name] = out.get(name, 0.0) + node.total
    return out


def _check_shipping(nodes, containers_before, containers_after, n_tiles):
    """Every tile rode in a dispatch, and the RGB and raw counts are the
    change in the service's containers."""
    got = containers_after - containers_before
    assert sum(got.values()) == n_tiles, got
    assert nodes["Dispatched tiles"] == n_tiles
    assert nodes["Tiles as RGB PNG"] + got["png8"] == n_tiles
    assert nodes["Tiles from raw batches"] == got["rgb_raw"]
    assert "Device time (batch share)" not in nodes  # no CUDA events on the CPU


def test_perfstats_counts_merge_and_stay_out_of_the_percentages():
    """Counts and waits (time before the tile's work, outside its root)
    merge like spans and show without a percentage or heat."""
    stats = PerfStats()
    perfstats.count("Outside a tile run")  # ignored, as add_span is
    for share in (0.25, 0.75):
        perfstats.start_tile(12)
        perfstats.add_span("Work", 0.002)
        perfstats.add_span("Waiting", 0.1, perfstats.WAIT)
        perfstats.count("Dispatches (batch share)", share)
        perfstats.count("Tiles")
        perfstats.finish_tile(stats)
    root = stats.by_zoom[12]
    assert set(root.children) == {"Work", "Waiting", "Dispatches (batch share)", "Tiles"}
    assert root.children["Dispatches (batch share)"].total == pytest.approx(1.0)
    assert root.children["Tiles"].total == 2.0
    assert root.children["Waiting"].total == pytest.approx(0.2)
    assert [c.kind for c in root.children.values()] == ["span", "wait", "count", "count"]
    lines = stats.to_html().split("\n")
    assert "<li><b>Dispatches (batch share)</b> 0.500 a tile</li>" in lines
    assert "<li><b>Tiles</b> 1.000 a tile</li>" in lines
    assert "<li><b>Waiting</b> 100.00 ms/tile (before the tile's work)</li>" in lines
    (work,) = [ln for ln in lines if "<b>Work</b>" in ln]
    pct = 100.0 * root.children["Work"].total / root.total
    assert f"2.00 ms/tile ({pct:.1f}%)" in work and "background-color" in work


@pytest.mark.parametrize("bound", [0, 3])
def test_interval_log_keeps_at_most_its_bound(bound):
    stats = PerfStats(intervals=bound)
    for i in range(5):
        stats.log("Dispatch", 10 * i, 10 * i + 5, i)
    if bound == 0:
        assert stats.intervals is None
    else:
        assert list(stats.intervals) == [("Dispatch", 10 * i, 10 * i + 5, i) for i in (2, 3, 4)]


def _serve(service, reqs):
    """Every request of `reqs` at once through `run_server`, whose batcher
    waits for all of them -> (PNGs, time.time_ns() before and after)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    thread = threading.Thread(target=lambda: asyncio.run(run_server(
        f"127.0.0.1:{port}", service, batch_window_ms=60_000, max_batch=len(reqs))),
        daemon=True)
    thread.start()
    for _ in range(200):
        try:
            with socket.create_connection(("127.0.0.1", port), timeout=0.2):
                break
        except OSError:
            time.sleep(0.05)
    url = f"http://127.0.0.1:{port}"

    def get(req):
        t, s = req
        suffix = f"@{s}x" if s > 1 else ""
        with urllib.request.urlopen(f"{url}/{t.zoom}/{t.x}/{t.y}{suffix}.png",
                                    timeout=300) as resp:
            assert resp.status == 200
            return resp.read()

    try:
        t0 = time.time_ns()
        with concurrent.futures.ThreadPoolExecutor(len(reqs)) as ex:
            pngs = list(ex.map(get, reqs))
        t1 = time.time_ns()
    finally:
        urllib.request.urlopen(f"{url}/shutdown", timeout=10).read()
        thread.join(timeout=30)
    assert not thread.is_alive()
    return pngs, t0, t1


def test_a_micro_batch_records_its_queue_waits_dispatches_and_containers(mini_bin, styler):
    """One micro-batch of @1x and @2x requests through the HTTP server:
    two dispatches (one a scale), a queue wait for each request, every
    interval of the batch tagged with one batch id and inside the time
    the requests took, and the RGB count the change in `containers`."""
    service = TileService(mini_bin, styler, STYLESHEET_DIR, device="cpu", png_cache_tiles=0)
    service.perf_stats = PerfStats(intervals=1000)
    tiles = _tiles(3)
    reqs = [(t, s) for s in (1, 2) for t in tiles]
    before = Counter(service.containers)
    with torch_threads(1):
        pngs, t0, t1 = _serve(service, reqs)
    assert all(p[:8] == b"\x89PNG\r\n\x1a\n" for p in pngs)
    nodes = _nodes(service.perf_stats)
    assert nodes["Device dispatches (batch share)"] == pytest.approx(2.0)
    _check_shipping(nodes, before, Counter(service.containers), len(reqs))
    log = list(service.perf_stats.intervals)
    waits = [iv for iv in log if iv[0] == "Queue wait"]
    assert len(waits) == len(reqs)
    assert {bid for *_, bid in log} == {waits[0][3]} and waits[0][3] is not None
    assert all(t0 <= s <= e <= t1 for _, s, e, _ in log)
    assert nodes["Queue wait"] == pytest.approx(sum(e - s for _, s, e, _ in waits) / 1e9)
    assert Counter(name for name, *_ in log) == Counter(
        {"Queue wait": 6, "Dispatch": 2, "Device wait": 2, "Compose and encode": 2, "Batch": 1})
    html = service.perf_stats.to_html()
    assert "<li><b>Queue wait</b>" in html and "<b>Tiles as RGB PNG</b>" in html


@pytest.mark.parametrize("cap", ["fits", "overflows"])
def test_a_direct_render_call_records_no_queue_wait(mini_bin, styler, monkeypatch, cap):
    """`render_tiles_device` called outside the batcher (as a warm-up is):
    no queue wait, untagged intervals inside the call, and raw batches
    counted when the wire's cap overflows."""
    service = TileService(mini_bin, styler, STYLESHEET_DIR, device="cpu", png_cache_tiles=0)
    reqs = [(t, 1) for t in _tiles(3)] + [(t, 2) for t in _tiles(2)]
    renderer = service.batch_renderer
    with torch_threads(1):
        if cap == "overflows":
            monkeypatch.setattr(renderer, "_pick_rtot", lambda ts, T: 64)
        else:
            service.render_tiles_device(reqs)  # learns the palette: the next wires are v2
        service.perf_stats = PerfStats(intervals=100)
        before = Counter(service.containers)
        t0 = time.time_ns()
        pngs = service.render_tiles_device(reqs)
        t1 = time.time_ns()
    assert len(pngs) == len(reqs)
    nodes = _nodes(service.perf_stats)
    assert "Queue wait" not in nodes
    assert nodes["Device dispatches (batch share)"] == pytest.approx(2.0)
    _check_shipping(nodes, before, Counter(service.containers), len(reqs))
    assert nodes["Tiles from raw batches"] == (len(reqs) if cap == "overflows" else 0)
    log = list(service.perf_stats.intervals)
    assert {name for name, *_ in log} == BATCH_INTERVALS
    assert all(bid is None and t0 <= s <= e <= t1 for _, s, e, bid in log)
