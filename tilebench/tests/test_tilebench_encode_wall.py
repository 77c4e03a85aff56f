"""The reader of the encode pool's wall span: the window's difference of
"Compose and encode wall (batch share)" over tiles finished, in ms, and
nothing where the program has no such span (a program older than it) or
the window finished no tile; the harness finds it by its name."""

import os

import pytest

from tilebench import run
from tilebench.run import Window, metric_reader

NAME = "encode_wall_ms_per_tile.tput"
WALL = "Compose and encode wall (batch share)"


def window(spans, tiles):
    w = Window(seconds=40.0, t0=0.0, records=[], setup_s=0.0)
    w.spans, w.tiles_done = spans, tiles
    return w


def test_the_wall_reads_ms_a_tile():
    w = window({"Compose and encode": 3.2, WALL: 0.8}, 800)
    assert metric_reader(NAME)(w) == pytest.approx(1.0)


@pytest.mark.parametrize("spans,tiles", [
    ({WALL: 0.8}, 0),                       # no tile finished
    ({"Compose and encode": 3.2}, 800),     # a program without the span
])
def test_nothing_to_read_reads_none(spans, tiles):
    assert metric_reader(NAME)(window(spans, tiles)) is None


def test_the_cell_reports_it():
    bench = run.load_json(os.path.join(run.ROOT, "BENCHMARK.json"))
    cell = run.find_cell(bench, "metro112-osmosnimki-base.overview")
    assert NAME in [m["name"] for m in cell.per_layer]
