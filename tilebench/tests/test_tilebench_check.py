"""The comparison that decides `correct`, at a size a CPU test run holds:
a run with the control (the reference one precision down) served in the
program's place is not correct, a sound run is, and a run whose timed
path is broken underneath is not.  The
harness's look for a chip is skipped: the program runs its kernels'
plain versions on the CPU, a small city, the z14 tiles at @1x."""

import json
import os
import subprocess
import sys

import pytest
import torch

from tilebench import control, run

SMALL_CITY = {"blocks": 8, "seed": 20260816}
CELL = "metro112-osmosnimki-base.overview"


def small_cell():
    cell = run.find_cell(run.load_json(os.path.join(run.ROOT, "BENCHMARK.json")), CELL)
    cell.traffic = dict(cell.traffic, zooms=[13, 14], scales=[1], clients=8)
    return cell


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def small_run(seed, fault=None):
    return run.run_cell(small_cell(), seed, 3.0, False, "cpu", city=SMALL_CITY, sample_tiles=3,
                        fault=fault)


def test_the_control_served_in_the_programs_place_is_not_correct_on_three_seeds():
    cell = small_cell()
    serve = control.ServeControl(cell, "cpu", city=SMALL_CITY)
    limit = cell.config["check"]["ref_gap_limit"]
    for seed in (11, 12, 2**31 + 13):
        res = run.run_cell(cell, seed, 3.0, False, "cpu", city=SMALL_CITY, sample_tiles=3,
                           fault=serve)
        assert not res["correct"], res["check"]
        assert res["check"]["ref_gap"]["value"] > limit, res["check"]
        assert res["failed"] == 0 and res["check"]["unanswered"]["value"] == 0


def test_a_sound_run_is_correct():
    res = small_run(2**31 + 5)
    assert res["correct"], res["check"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert list(res)[-1] == "check"
    assert set(res["metrics"]) == {"tiles_per_s", "setup_s"}


def alter_answers(monkeypatch):
    """An answer altered where it is produced: one pixel of every tile."""
    from osm_renderer_tpu_torch.parallel import renderer as R

    orig = R.RleTileView.rgb

    def rgb(self, i):
        img = orig(self, i).copy()
        img[0, 0] ^= 0x80
        return img

    def fault(service):
        monkeypatch.setattr(R.RleTileView, "rgb", rgb)
        monkeypatch.setattr(R.RleTileView, "png8", lambda self, i, level: None)
    return fault


def leave_half_out(monkeypatch):
    """Half of each batch left out: the rest are answered with no tile."""
    def fault(service):
        orig = service.render_tiles_device

        def half(reqs):
            done = orig(reqs[: (len(reqs) + 1) // 2])
            return done + [b""] * (len(reqs) - len(done))
        monkeypatch.setattr(service, "render_tiles_device", half)
    return fault


@pytest.mark.parametrize("make_fault", [alter_answers, leave_half_out])
def test_a_broken_timed_path_is_not_correct(make_fault, monkeypatch):
    res = small_run(77, fault=make_fault(monkeypatch))
    assert not res["correct"], res["check"]


@pytest.mark.cuda
def test_a_cell_runs_correct_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the harness's runs on the card are its check")
    out = subprocess.run(
        [sys.executable, "-m", "tilebench.run", "--workload", CELL, "--seed", "3",
         "--seconds", "5", "--trace", "0"], cwd=run.ROOT, capture_output=True, text=True,
        timeout=1200)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]


def test_the_load_generator_and_the_server_get_cpus_of_their_own():
    code = ("import json, os, threading; from tilebench import run;"
            "before = sorted(os.sched_getaffinity(0)); load = run.split_cpus();"
            "seen = [];"
            "t = threading.Thread(target=lambda: seen.append(sorted(os.sched_getaffinity(0))));"
            "t.start(); t.join(); print(json.dumps([before, load, seen[0]]))")
    out = subprocess.run([sys.executable, "-c", code], cwd=run.ROOT, capture_output=True,
                         text=True, check=True).stdout
    before, load, server = json.loads(out)
    if len(before) < 4:
        assert load is None and server == before
    else:
        assert load == before[-2:] and server == before[:-2]
