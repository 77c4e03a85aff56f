"""The readers of the program's own spans and counts: window differences
over tiles finished, and nothing where the program has no such node (a
program older than the node) or the window finished no tile."""

import pytest

from tilebench import program_readers as pr
from tilebench.run import Window, metric_reader

NAMES = ["queue_wait_ms_per_tile.tput", "dispatch_tiles_mean.tput", "device_ms_per_tile.tput",
         "raw_tile_share.tput", "rgb_tile_share.tput"]


def window(spans, tiles):
    w = Window(seconds=40.0, t0=0.0, records=[], setup_s=0.0)
    w.spans, w.tiles_done = spans, tiles
    return w


def test_each_reader_divides_the_window_by_its_tiles():
    w = window({pr.QUEUE_WAIT: 0.8, pr.DISPATCHES: 50.0, pr.DISPATCHED_TILES: 800.0,
                pr.DEVICE_TIME: 0.04, pr.RAW_TILES: 96.0, pr.RGB_TILES: 640.0}, 800)
    got = [metric_reader(n)(w) for n in NAMES]
    assert got == pytest.approx([1.0, 16.0, 0.05, 12.0, 80.0])


def test_a_window_with_no_raw_tile_reads_zero():
    w = window({pr.RAW_TILES: 0.0, pr.RGB_TILES: 0.0}, 10)
    assert pr.raw_tile_share(w) == 0.0 and pr.rgb_tile_share(w) == 0.0


@pytest.mark.parametrize("spans,tiles", [
    ({"Compose and encode": 3.0}, 800),   # a program without the nodes
    ({pr.QUEUE_WAIT: 0.8, pr.DISPATCHES: 50.0, pr.DISPATCHED_TILES: 800.0,
      pr.DEVICE_TIME: 0.04, pr.RAW_TILES: 96.0, pr.RGB_TILES: 640.0}, 0),  # no tile finished
])
def test_nothing_to_read_reads_none(spans, tiles):
    w = window(spans, tiles)
    assert [metric_reader(n)(w) for n in NAMES] == [None] * len(NAMES)
