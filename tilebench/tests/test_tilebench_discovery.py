"""Discovery by name: a new configuration, traffic mix or metric is a new
file and a new entry, and no file that is there changes."""

import json
import os
import shutil

import pytest

from tilebench import run

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def bench():
    return run.load_json(os.path.join(run.ROOT, "BENCHMARK.json"))


def test_every_cell_of_the_benchmark_finds_its_files():
    b = bench()
    for w in b["workloads"]:
        cell = run.find_cell(b, w["name"])
        assert cell.config["style"]["file"] and cell.traffic["clients"] > 0
        names = [m["name"] for m in cell.end_to_end]
        assert "setup_s" in names and len(names) >= 2 and cell.per_layer
        for m in cell.end_to_end + cell.per_layer:
            assert callable(run.metric_reader(m["name"]))
        assert os.path.exists(os.path.join(HERE, "configs", cell.config["style"]["file"]))
    for c in b["configs"]:
        assert os.path.exists(os.path.join(run.ROOT, c["file"]))


def test_each_configuration_file_lists_its_cuts_as_the_benchmark_does():
    for c in bench()["configs"]:
        cfg = run.load_json(os.path.join(run.ROOT, c["file"]))
        assert cfg["reduced"] == c["reduced"]
        assert all(k in cfg for k in cfg["reduced"])


def test_every_per_layer_metric_moves_a_metric_its_cells_report():
    b = bench()
    e2e = {m["name"]: m for m in b["end_to_end"]}
    for m in b["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m.get("workloads", [w["name"] for w in b["workloads"]]):
            assert "workloads" not in moved or cell in moved["workloads"], (m["name"], cell)


def test_a_new_cell_is_files_and_entries_only(tmp_path):
    base = tmp_path / "tilebench"
    shutil.copytree(HERE, base, ignore=shutil.ignore_patterns("cache", "__pycache__", "tests"))
    before = {p: p.read_bytes() for p in base.rglob("*") if p.is_file()}
    cfg = json.loads((base / "configs" / "metro112-osmosnimki-base.json").read_text())
    cfg["city"] = dict(cfg["city"], blocks=48)
    (base / "configs" / "metro48-osmosnimki-base.json").write_text(json.dumps(cfg))
    (base / "traffic" / "street.json").write_text(json.dumps(
        {"clients": 64, "zooms": [15, 16, 17], "scales": [1, 2], "zipf_s": 1.0,
         "ranking_seed": 3}))
    (base / "metrics" / "tiles_served.street.py").write_text(
        "def read(w):\n    return float(len(w.records))\n")
    b = bench()
    b["configs"].append({"name": "metro48-osmosnimki-base", "source": "x",
                         "file": "tilebench/configs/metro48-osmosnimki-base.json",
                         "reduced": ["city"], "why": "x"})
    b["workloads"].append({"name": "metro48-osmosnimki-base.street",
                           "config": "metro48-osmosnimki-base", "traffic": "street",
                           "chips": 1, "why": "x"})
    b["per_layer"].append({"name": "tiles_served.street", "unit": "tiles", "better": "higher",
                           "source": "host_clock", "layer": "HTTP + micro-batcher",
                           "moves": "tiles_per_s", "workloads": ["metro48-osmosnimki-base.street"]})
    b["end_to_end"][0]["workloads"].append("metro48-osmosnimki-base.street")
    cell = run.find_cell(b, "metro48-osmosnimki-base.street", base=str(base))
    assert cell.config["city"]["blocks"] == 48 and cell.traffic["zooms"] == [15, 16, 17]
    assert [m["name"] for m in cell.per_layer] == ["tiles_served.street"]
    read = run.metric_reader("tiles_served.street", base=str(base))
    assert read(run.Window(1.0, 0.0, [[0] * 7] * 3, 0.0)) == 3.0
    after = {p: p.read_bytes() for p in before}
    assert after == before


def test_an_unknown_cell_or_metric_stops_the_run():
    with pytest.raises(SystemExit):
        run.find_cell(bench(), "no-such-cell")
    with pytest.raises(SystemExit):
        run.metric_reader("no_such_metric")
