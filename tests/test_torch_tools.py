"""The port's device-time tools on the CPU (the kernels' plain versions):
kdecomp_device's variants against the JAX tool's masking rule on the
JAX package's batch, its `full` check, and both command lines on the
mini fixture."""

import numpy as np
import pytest
import torch

from osm_renderer_tpu_torch.core.tile import Tile, coords_to_max_zoom_tile
from osm_renderer_tpu_torch.ops import render_cuda as RC
from osm_renderer_tpu_torch.parallel.renderer import BatchRenderer
from osm_renderer_tpu_torch.tools import kdecomp_device, kdevice

from tests.test_torch_helpers import STYLESHEET_DIR, port_bin, port_styler


def _tiles():
    t18 = coords_to_max_zoom_tile(47.1412, 9.5215)
    base = Tile(16, t18.x >> 2, t18.y >> 2)
    return [Tile(16, base.x + dx, base.y + dy) for dx in range(2) for dy in range(2)] + [
        Tile(15, base.x >> 1, base.y >> 1)]


@pytest.fixture(scope="module")
def mini_bin(tmp_path_factory):
    return port_bin(tmp_path_factory.mktemp("tools"))


@pytest.fixture(scope="module")
def prepared(mini_bin):
    """The plain-upload batch of the five tiles, on the CPU."""
    from osm_renderer_tpu_torch.geodata.reader import GeodataReader

    reader = GeodataReader.load(mini_bin)
    te = [(reader.get_entities_in_tile_with_neighbors(t), t) for t in _tiles()]
    return BatchRenderer(port_styler(), stylesheet_dir=STYLESHEET_DIR, device="cpu").prepare(te)


def test_variant_kinds_follow_the_jax_tools_rule(prepared, tmp_path):
    """The JAX tool's masking (tools/kdecomp_device.py), written out here
    and run on the JAX package's batch of the same tiles, gives the
    port's variants: names, kinds and which clear the work items."""
    from osm_renderer_tpu.core.tile import Tile as JaxTile
    from osm_renderer_tpu.mapcss.parser import parse_file
    from osm_renderer_tpu.mapcss.styler import Styler
    from osm_renderer_tpu.ops import render_pallas as rp
    from osm_renderer_tpu.parallel.renderer import BatchRenderer as JaxBatchRenderer
    from tests.fixtures import build_mini_reader

    reader = build_mini_reader(tmp_path)
    styler = Styler(parse_file(STYLESHEET_DIR, "default.mapcss"), "josm")
    jtiles = [JaxTile(t.zoom, t.x, t.y) for t in _tiles()]
    te = [(reader.get_entities_in_tile_with_neighbors(t), t) for t in jtiles]
    jprep = JaxBatchRenderer(styler, backend="pallas", interpret=True,
                             stylesheet_dir=STYLESHEET_DIR).prepare(te, scale=1)
    kind0 = np.asarray(jprep.batch.kind)
    port_kind0 = prepared.batch.chunk_i[:, RC.CI_KIND].numpy()
    np.testing.assert_array_equal(port_kind0, kind0)

    def variant(keep):
        kind = kind0.copy()
        mask = ~np.isin(kind, np.asarray(keep, kind.dtype))
        kind[mask & (kind != rp.KIND_PAD)] = rp.KIND_PAD
        return kind

    want = [
        ("full", variant(tuple(int(k) for k in np.unique(kind0))), False),
        ("floor_only", variant(()), True),
        ("fills_only", variant((rp.KIND_FILL,)), False),
        ("spans_only", variant((rp.KIND_STROKE_SPAN,)), False),
        ("items_only", variant((rp.KIND_STROKE_SOLID, rp.KIND_STROKE_DASH)), False),
        ("seg_only", variant((rp.KIND_STROKE,)), False),
        ("layers_only", variant((rp.KIND_LAYER,)), False),
    ]
    got = kdecomp_device.variant_kinds(port_kind0)
    assert [(n, i) for n, _, i in got] == [(n, i) for n, _, i in want]
    for (name, g, _), (_, w, _) in zip(got, want):
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert len(np.unique(kind0)) > 2  # more than padding and one kind


def test_decompose_checks_full_against_the_unmodified_render(prepared, monkeypatch):
    """`full` renders byte-identical to the batch on the CPU twin, each
    variant keeps only its kinds' chunks, and a `full` that differed
    would raise."""
    rows = kdecomp_device.decompose(prepared, reps=1)
    assert [r["name"] for r in rows] == [name for name, _, _ in kdecomp_device.VARIANTS]
    assert all(r["clock"] == "cpu" and r["launches"] == 0 and r["ms"] > 0 for r in rows)
    full = rows[0]["chunks"]
    assert sum(full.values()) > 0 and rows[1]["chunks"] == {}
    for r, (_, keep, _) in zip(rows[2:], kdecomp_device.VARIANTS[2:]):
        assert r["chunks"] == {k: n for k, n in full.items() if k in keep}, r["name"]

    real = kdecomp_device.variant_kinds

    def spoiled(kind0):
        out = real(kind0)
        name, kind, no_items = out[0]
        return [(name, np.where(kind == 1, 0, kind).astype(kind.dtype), no_items)] + out[1:]

    monkeypatch.setattr(kdecomp_device, "variant_kinds", spoiled)
    with pytest.raises(RuntimeError, match="full variant differs"):
        kdecomp_device.decompose(prepared, reps=1)


def test_kdecomp_device_cli_on_the_cpu(mini_bin, capsys):
    assert kdecomp_device.main(["--device", "cpu", "--reps", "1", "--geodata", mini_bin,
                                "--zoom", "16"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("z16 batch of 2 tiles on cpu")
    assert [line.split(":")[0].strip() for line in lines[1:]] == [
        name for name, _, _ in kdecomp_device.VARIANTS]
    assert all("CPU operator time (not device)" in line for line in lines[1:])


def test_kdevice_cli_and_cpu_clock(mini_bin, capsys):
    """The CLI times the arena entry and its v2 wire on the CPU twin and
    labels the number as CPU time; on the CPU no launch is counted."""
    assert kdevice.main(["--device", "cpu", "--reps", "2", "--geodata", mini_bin]) == 0
    out = capsys.readouterr().out
    assert out.startswith("cpu: ") and "not a device time; 1 tiles" in out
    got = kdevice.device_ms_per_call(lambda: torch.ones(64).sum(), 3, device=torch.device("cpu"))
    assert got["clock"] == "cpu" and got["launches"] == 0 and got["ms"] >= 0
