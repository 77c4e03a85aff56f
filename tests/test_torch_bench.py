"""The port's benchmark (`python -m osm_renderer_tpu_torch.bench`) on the
CPU, through the kernels' plain versions, on tiny cities
(tools/make_fixture.py --blocks 3 and 4, the port's importer): the line
carries every key of the JAX bench and the keys the port adds, and
`correct` holds; each city has its own renderer, so a bigcity tile at a
minicity address renders from bigcity's entities; asking for the card
on a host without one raises; a failed check (a fresh renderer's
bigcity, or a served tile against its wire and the C++ oracle) makes
`main()` return 1."""

import json

import numpy as np
import pytest
import torch

from osm_renderer_tpu_torch import bench
from osm_renderer_tpu_torch.tools.corpus import zoom_tiles

from tests.test_torch_helpers import torch_threads

# The JAX bench's keys (bench.py), then the ones the port adds.
DETAIL_KEYS = (
    "n_tiles", "big_ms_per_batch", "big_device_kernel_ms", "minicity_30tile_tiles_per_sec",
    "cpu_oracle_tiles_per_sec_1core", "cpu_cores", "device_ms_per_batch",
    "assembly_cold_ms_per_batch", "assembly_warm_ms_per_batch", "png_encode_tiles_per_sec_1core",
    "at2x_device_tiles_per_sec", "prod_stylesheet_warm_labels_tiles_per_sec",
    "prod_stylesheet_warm_nolabels_tiles_per_sec", "e2e_tiles_per_sec", "pyramid_tiles_per_sec",
    "backend", "big_device_ms_render_wire", "e2e_png_containers", "spread", "checks",
    "kernel_launches",
)
PYRAMID = ("z12", "z13", "z14", "z15", "z16", "z17", "mixed_z12_z17")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The tiny cities, in a directory of their own."""
    d = tmp_path_factory.mktemp("bench_fixtures")
    return {city: (str(d / f"{city}.osm"), str(d / f"{city}.bin"), blocks)
            for city, blocks in (("minicity", 3), ("bigcity", 4))}


@pytest.fixture(scope="module")
def ran(corpus):
    with torch_threads():
        return bench.run(["--device", "cpu"], corpus=corpus, runs=2, reps=1)


def test_line_has_every_key_and_is_correct(ran):
    line, _ = ran
    assert json.loads(json.dumps(line)) == line
    assert line["metric"] == "z15_tiles_per_sec_per_chip" and line["unit"] == "tiles/s"
    assert line["correct"] is True, line["detail"].get("error") or line["detail"]["checks"]
    assert line["device"] == {"platform": "cpu", "name": "cpu", "power_limit": None, "count": 0}
    d = line["detail"]
    assert set(DETAIL_KEYS) <= set(d)
    assert set(d["e2e_tiles_per_sec"]) == set(bench.E2E_KINDS)
    assert set(d["pyramid_tiles_per_sec"]) == set(PYRAMID)
    # The CPU run holds no device metric under a device name.
    for key in bench.DEVICE_KEYS:
        assert d[key] is None and key not in d["spread"]
    # Every other metric is a positive number.
    values = bench.metric_values(line)
    assert len(values) == 2 + len(bench.METRICS) - 2 + len(bench.E2E_KINDS) + len(PYRAMID)
    for key, v in values.items():
        assert (v is None) == (key in bench.DEVICE_KEYS), key
        assert v is None or v > 0, key
    assert line["value"] == d["z15_tiles_per_sec_per_chip"] > 0
    assert line["vs_baseline"] == pytest.approx(line["value"] / d["cpu_oracle_tiles_per_sec_1core"])
    for key, s in d["spread"].items():
        assert s["runs"] == 2 and 0 < s["min"] <= s["median"] <= s["max"], key
        node = d
        for part in key.split("."):
            node = node[part]
        assert node == s["median"], key
    assert {c["name"] for c in d["checks"]} == {
        "minicity_z15_oracle", "bigcity_z15_fresh_renderer", "production_z16_oracle"
    } | SERVED_CHECKS
    # Each timed pass's tiles, counted by PNG container (RGB or PNG-8).
    served = {k: sum(c.values()) for k, c in d["e2e_png_containers"].items()}
    n = d["n_mini_tiles"]
    assert served == {"cold": 2 * n, "warm": 4 * n, "labels_cold": 2 * n, "labels_warm": 4 * n}
    assert {k: sum(c.values()) for k, c in d["prod_png_containers"].items()} == {
        "warm": 2 * n, "labels_warm": 2 * n}
    # The plain versions launch no kernel.
    assert d["kernel_launches"] == {"render": 0, "emit": 0, "expand": 0}


def test_cities_have_their_own_renderers(ran):
    """A z15 address both cities cover renders, through bigcity's cached
    chunks, bigcity's entities, not minicity's."""
    from osm_renderer_tpu_torch.geodata.reader import GeodataReader

    _, b = ran
    mini, big = b.renderers["minicity"], b.renderers["bigcity"]
    assert len({id(r) for r in b.renderers.values()}) == len(b.renderers) == 4
    assert mini._chunk_cache is not big._chunk_cache
    fixture = b.detail["fixture_bins"]
    readers = {k: GeodataReader.load(v) for k, v in fixture.items()}
    shared = set(zoom_tiles(readers["minicity"], 15)) & set(zoom_tiles(readers["bigcity"], 15))
    assert shared
    t = sorted(shared)[0]
    assert mini.has_cached_chunks(t, 1) and big.has_cached_chunks(t, 1)
    got = big.render([(None, t)])  # from bigcity's chunk cache
    want = {k: bench.fresh_render(big.styler, bench.STYLESHEET_DIR,
                                  [(r.get_entities_in_tile_with_neighbors(t), t)], "cpu")
            for k, r in readers.items()}
    assert np.array_equal(got, want["bigcity"])
    assert not np.array_equal(want["bigcity"], want["minicity"])


def test_cuda_without_a_card_raises(corpus, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        bench.main([], corpus=corpus)


def _spoil_fresh_render(out):
    out[0, 0, 0] ^= 0xFF
    return out


def _spoil_decode_png(out):
    out = out.copy()
    out[0, 0, 0] ^= 0x80
    return out


SERVED_CHECKS = {f"{name}_{kind}_{what}"
                 for name, kinds in (("e2e", bench.E2E_KINDS), ("prod", ("warm", "labels_warm")))
                 for kind in kinds for what in ("pngs", "oracle")}


@pytest.mark.parametrize("target, spoil, want_failed", [
    ("fresh_render", _spoil_fresh_render, {"bigcity_z15_fresh_renderer"}),
    ("decode_png", _spoil_decode_png, SERVED_CHECKS),
], ids=["fresh_render", "served_png"])
def test_failed_check_exits_nonzero(corpus, monkeypatch, capsys, target, spoil, want_failed):
    """A fresh renderer that disagrees with the timed one, or served PNGs
    that decode 128/255 off their wires (and so off the oracle), fail
    exactly the checks they touch: main() prints the line with correct
    false and returns 1."""
    real = getattr(bench, target)
    monkeypatch.setattr(bench, target, lambda *args: spoil(real(*args)))
    with torch_threads():
        assert bench.main(["--device", "cpu"], corpus=corpus, runs=1, reps=1) == 1
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"] is False
    failed = {c["name"] for c in line["detail"]["checks"] if not c["ok"]}
    assert failed == want_failed
