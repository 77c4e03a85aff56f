"""The encode pool of the device path, on the CPU (the kernels' plain
versions): a sub-batch's device tiles encode on `TileService`'s pool of
threads, and serve the same bytes and the same perfstats records as when
they encode one after another on the render thread.

Each run serves one sequence of batches of @1x and @2x tiles on a fresh
service.  The @1x batches overflow the wire's cap (raw batches, RGB
PNGs); the first @2x batch comes on the v1 wire, the later ones on v2
(PNG-8 and RGB tiles of more than 256 colours), and each @2x batch sends
its first tile to the oracle (a fallback the prepare reports).  The pool's
width is set through `encode_pool_width`, the function that reads the
CPUs the process may use."""

import concurrent.futures
import os
import sys
import threading
import time
from collections import Counter

import pytest

from osm_renderer_tpu_torch.core.tile import Tile
from osm_renderer_tpu_torch.parallel.renderer import RleTileView
from osm_renderer_tpu_torch.perfstats.spans import COUNT
from osm_renderer_tpu_torch.server import http
from osm_renderer_tpu_torch.server.http import TileService

from tests.test_torch_helpers import STYLESHEET_DIR, make_minicity_osm, port_styler, torch_threads

WALL = "Compose and encode wall (batch share)"
RECORDED = ("Compose and encode", WALL, "Tiles as RGB PNG", "Tiles from raw batches")
BATCHES = 3


@pytest.fixture(scope="module")
def city_bin(tmp_path_factory):
    from osm_renderer_tpu_torch.geodata.importer import import_osm

    tmp = tmp_path_factory.mktemp("encode_pool")
    bin_path = str(tmp / "city.bin")
    import_osm(make_minicity_osm(tmp, blocks=4), bin_path)
    return bin_path


@pytest.fixture(scope="module")
def styler():
    return port_styler()


def _requests(service):
    """Every z15 tile of the city and three of its z16 tiles, @1x and @2x."""
    xs, ys = service.reader.tiles["x"].tolist(), service.reader.tiles["y"].tolist()
    z15 = list(dict.fromkeys((x >> 3, y >> 3) for x, y in zip(xs, ys)))
    z16 = list(dict.fromkeys((x >> 2, y >> 2) for x, y in zip(xs, ys)))[:3]
    tiles = [Tile(15, x, y) for x, y in z15] + [Tile(16, x, y) for x, y in z16]
    return [(t, s) for s in (1, 2) for t in tiles]


def _records(stats):
    """Per zoom: tiles finished, and each node's kind, with its total
    where it is a count."""
    return {z: (stats.tile_counts[z],
                {name: (node.kind, node.total if node.kind == COUNT else None)
                 for name, node in root.children.items()})
            for z, root in stats.by_zoom.items()}


def _serve_sequence(city_bin, styler, width, batches=BATCHES):
    """Serve `batches` batches on a fresh service whose pool is `width`
    threads wide -> (PNGs of each batch, perfstats records, tiles served,
    containers, the names of the threads that ran the codec tasks)."""
    service = TileService(city_bin, styler, STYLESHEET_DIR, device="cpu", png_cache_tiles=0,
                          enable_labels=False)
    renderer = service.batch_renderer
    pick_rtot, prepare, encode = renderer._pick_rtot, renderer.prepare, http._encode_device_tile
    threads = Counter()

    def overflowing_rtot(ts, T):
        return 64 if ts == 256 else pick_rtot(ts, T)

    def prepare_with_fallback(tiles_entities, scale, **kwargs):
        prepared = prepare(tiles_entities, scale, **kwargs)
        return prepared._replace(cpu_fallback_tiles=(0,)) if scale == 2 else prepared

    def encode_on(view, gi, level):
        threads[threading.current_thread().name.rpartition("_")[0] or "render"] += 1
        return encode(view, gi, level)

    reqs = _requests(service)
    try:
        with pytest.MonkeyPatch.context() as mp, torch_threads(1):
            mp.setattr(http, "encode_pool_width", lambda: width)
            mp.setattr(http, "_encode_device_tile", encode_on)
            mp.setattr(renderer, "_pick_rtot", overflowing_rtot)
            mp.setattr(renderer, "prepare", prepare_with_fallback)
            pngs = [service.render_tiles_device(reqs) for _ in range(batches)]
    finally:
        service.close()
    return (pngs, _records(service.perf_stats), Counter(service.tiles_served),
            Counter(service.containers), threads)


@pytest.fixture(scope="module")
def serial(city_bin, styler):
    return _serve_sequence(city_bin, styler, 1)


def test_the_pool_serves_the_serial_bytes_and_records(city_bin, styler, serial):
    """Width 4 against width 1: the same PNG bytes, tile for tile, and
    the same perfstats nodes with the same counts; the codec tasks ran on
    the pool's threads in the one and on the render thread in the other."""
    pngs, records, served, containers, threads = _serve_sequence(city_bin, styler, 4)
    s_pngs, s_records, s_served, s_containers, s_threads = serial
    assert pngs == s_pngs
    assert records == s_records
    assert (served, containers) == (s_served, s_containers)
    # The mix the sequence was built to give.
    assert all(containers[k] for k in ("png8", "rgb_overflow", "rgb_v1", "rgb_raw"))
    assert served["oracle"] == BATCHES
    for _, nodes in records.values():
        assert all(name in nodes for name in RECORDED)
    assert set(s_threads) == {"render"} and set(threads) == {"osmr-encode"}
    assert sum(threads.values()) == served["device"]


def test_a_worker_error_leaves_the_render_call(city_bin, styler, monkeypatch):
    """A v2 wire whose words end short of a tile's pixels: the codec task
    raises on the pool, and the error leaves `render_tiles_device` (the
    batcher hands it to every waiting request), but only once every task
    of the sub-batch has ended, the slow last one too, so none reads the
    wire after the call.  The next call serves."""
    service = TileService(city_bin, styler, STYLESHEET_DIR, device="cpu", png_cache_tiles=0,
                          enable_labels=False)
    renderer = service.batch_renderer
    reqs = [(t, s) for t, s in _requests(service) if s == 2]
    fetch, encode = renderer.fetch_tile_view, http._encode_device_tile
    ended = []

    def encode_slow_last(view, gi, level):
        if gi == len(reqs) - 1:
            time.sleep(0.3)
        try:
            return encode(view, gi, level)
        finally:
            ended.append(gi)

    def short_wire(res):
        view = fetch(res)
        packed32, offs, table = view.words
        offs = offs.copy()
        offs[2:] = offs[1] + 1  # tile 1 keeps one word of its run stream
        return RleTileView(view.T, view.ts, words=(packed32, offs, table))

    monkeypatch.setattr(http, "encode_pool_width", lambda: 4)
    monkeypatch.setattr(http, "_encode_device_tile", encode_slow_last)
    try:
        with torch_threads(1):
            first = service.render_tiles_device(reqs)  # learns the palette: v2 next
            monkeypatch.setattr(renderer, "fetch_tile_view", short_wire)
            ended.clear()
            with pytest.raises(ValueError, match="do not cover the tile"):
                service.render_tiles_device(reqs)
            assert sorted(ended) == list(range(len(reqs)))
            monkeypatch.setattr(renderer, "fetch_tile_view", fetch)
            again = service.render_tiles_device(reqs)
    finally:
        service.close()
    assert len(first) == len(again) == len(reqs)
    assert service._pool is None


def test_stress_more_workers_than_cores_under_a_short_switch_interval(city_bin, styler, serial):
    """More pool threads than CPUs and the interpreter switching threads
    every microsecond: several batches serve the serial path's bytes,
    and the service counts every tile asked for once."""
    width = 2 * len(os.sched_getaffinity(0)) + 2
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    ex = concurrent.futures.ThreadPoolExecutor(1)
    try:
        got = ex.submit(_serve_sequence, city_bin, styler, width).result(timeout=600)
    finally:
        sys.setswitchinterval(interval)
        ex.shutdown(wait=False)
    pngs, _, served, containers, threads = got
    s_pngs, _, s_served, s_containers, _ = serial
    assert pngs == s_pngs
    asked = BATCHES * len(pngs[0])
    assert sum(served.values()) == asked and served == s_served
    assert sum(containers.values()) == served["device"] and containers == s_containers
    assert set(threads) == {"osmr-encode"}
