"""The port's tools on the CPU (the kernels' plain versions):
kdecomp_device's and kdecomp's variants against the JAX tools' masking
rules on the JAX package's batch, their `full` checks, and every tool's
command line on the mini fixture (scale_sweep on a 4-block city)."""

import io
import os

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


def test_kdevice_cli_dense_on_the_cpu(mini_bin, capsys):
    """--dense exact times the dense renderer's batch (its plain version
    on the CPU, labelled as CPU time)."""
    assert kdevice.main(["--device", "cpu", "--reps", "1", "--geodata", mini_bin,
                         "--dense", "exact"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("cpu: ") and "not a device time; 1 tiles" in out


def test_dense_counts_cli_on_the_cpu(mini_bin, capsys):
    """tools/dense_counts prints the dense kernels' work on a batch."""
    from osm_renderer_tpu_torch.tools import dense_counts

    assert dense_counts.main(["--zoom", "16", "--geodata", mini_bin]) == 0
    out = capsys.readouterr().out
    got = dict(kv.split("=") for kv in out.split(": ", 1)[1].split())
    assert int(got["kept_px"]) <= int(got["window_px"]) and int(got["units"]) > 0
    assert int(got["groups"]) > 0 and float(got["groups_per_strip"]) > 0
    assert int(got["fill_px"]) >= int(got["fill_rows"]) and int(got["fill_units"]) > 0


def test_dense_counts_pins_the_fill_work_of_minicity_z15(tmp_path, capsys):
    """The fill counts of the fill kernel's prediction, on minicity z15
    x30 (tools/make_fixture.py's 24-block city, the port's importer):
    fills by bucket, window rows and pixels, active (row, edge) pairs a
    row, and the units fill_units cuts."""
    from osm_renderer_tpu_torch.geodata.importer import import_osm
    from osm_renderer_tpu_torch.ops import dense_cuda as DC
    from osm_renderer_tpu_torch.tools import dense_counts

    from tests.test_torch_helpers import make_minicity_osm, torch_threads

    bin_path = str(tmp_path / "minicity.bin")
    import_osm(make_minicity_osm(tmp_path), bin_path)
    capsys.readouterr()  # the importer's progress lines
    with torch_threads(1):
        assert dense_counts.main(["--zoom", "15", "--geodata", bin_path]) == 0
    out = capsys.readouterr().out
    assert out.startswith("30 tiles z15 @1x: ")
    got = dict(kv.split("=") for kv in out.split(": ", 1)[1].split())
    assert got["fills"] == "2039" and got["fills_by_E"] == "4:2003,8:14,16:4,64:18"
    assert (got["fill_rows"], got["fill_px"]) == ("19832", "630193")
    assert (got["active_per_row"], got["active_per_row_max"]) == ("2.08", "4")
    # Units: runs of up to 32 rows at E = 4 and 8, 16 at E = 16, 4 at E =
    # 64 (R x E <= FILL_PAIRS), of at most FILL_UNIT_PX pixels.
    assert [int(DC.fill_unit_rows(e)) for e in (4, 8, 16, 64)] == [32, 32, 16, 4]
    assert int(got["fill_units"]) == 2948 and got["rows_per_unit"] == "6.73"


# ---------------------------------------------------------------------------
# The operator and profiling tools (scale_sweep, parity_check, warmup,
# profile_serving, cold_profile, ktime, kdecomp) on the CPU.


def _lines(capsys):
    return capsys.readouterr().out.strip().splitlines()


def test_scale_sweep_cli_on_the_cpu(tmp_path, monkeypatch, capsys):
    """The sweep on a 4-block city with an 8-tile cache: every pass and
    the dense group served, counters printed as numbers, no leak, no
    size mismatch that counts."""
    from osm_renderer_tpu_torch.tools import scale_sweep

    from tests.test_torch_helpers import torch_threads

    monkeypatch.setattr(scale_sweep, "FIXTURE_DIR", str(tmp_path))
    with torch_threads(1):
        assert scale_sweep.main(["--blocks", "4", "--cache-tiles", "8", "--batch", "6",
                                 "--labels", "--device", "cpu"]) == 0
    lines = [line for line in _lines(capsys) if not line.startswith(("Parsing", "Got", "Conv"))]
    assert os.path.exists(os.path.join(str(tmp_path), "hugecity4.bin"))
    corpus = next(line for line in lines if line.startswith("corpus:"))
    n = int(corpus.split("} = ")[1].split()[0])
    for name in scale_sweep.PASSES + ("dense_cold", "dense_warm"):
        line = next(line for line in lines if line.split()[0] == name)
        assert " t/s; evictions=" in line
    assert sum(int(line.split()[1]) for line in lines
               if line.split()[0] in scale_sweep.PASSES) == 3 * n
    assert any(line.startswith("arena[0]:") and line.endswith("no-leak=OK") for line in lines)
    assert any(line.startswith("warm1-vs-warm2 size mismatches: 0 ") for line in lines)
    counts = dict(kv.split("=") for kv in lines[-1].split("[")[0].split()[1:])
    assert lines[-1].startswith("counters:") and int(counts["evictions"]) > 0
    assert int(counts["device_tiles"]) + int(counts["oracle_tiles"]) == 3 * n + 2 * int(
        next(line for line in lines if line.startswith("dense_cold")).split()[1])


def test_scale_sweep_failures_and_size_mismatches():
    """A leak fails the sweep; a size difference counts unless the two
    PNGs differ in colour type and decode to the same pixels."""
    from PIL import Image

    from osm_renderer_tpu_torch.tools import scale_sweep

    rgb = np.zeros((4, 4, 3), np.uint8)
    rgb[1, 2] = (200, 10, 10)

    def png(img, mode):
        buf = io.BytesIO()
        Image.fromarray(img).convert(mode, palette=Image.Palette.ADAPTIVE).save(buf, "PNG")
        return buf.getvalue()

    other = rgb.copy()
    other[0, 0] = (1, 2, 3)
    a = {"same": png(rgb, "RGB"), "container": png(rgb, "RGB"), "pixels": png(rgb, "RGB")}
    b = {"same": png(rgb, "RGB"), "container": png(rgb, "P"), "pixels": png(other, "P")}
    assert a["container"][25] != b["container"][25]
    assert scale_sweep.size_mismatches(a, b) == (2, 1)
    ok = {"arenas": [dict(no_leak=True)], "mismatches": 0}
    assert scale_sweep.failures(ok) == []
    assert len(scale_sweep.failures({"arenas": [dict(no_leak=False)], "mismatches": 1})) == 2


def test_parity_check_cli_passes_and_catches_a_step_of_two(mini_bin, monkeypatch, capsys):
    """0 on the twin's real output, with a line a tile and the worst; 1
    when one channel of one pixel is off by 2."""
    from osm_renderer_tpu_torch.tools import parity_check

    sheet = os.path.join(STYLESHEET_DIR, "default.mapcss")
    assert parity_check.main([mini_bin, sheet, "--all-z", "16", "--device", "cpu"]) == 0
    lines = _lines(capsys)
    assert len(lines) == 3 and all("[OK]" in line for line in lines[:2])
    assert lines[-1].startswith("worst: ") and "within the 1/255 parity bound" in lines[-1]

    real = RC.render_batch_planar

    def off_by_two(b, canvas, ts, rows=None):
        out = real(b, canvas, ts, rows).clone()
        v = int(out[0, 1, 100, 100])
        out[0, 1, 100, 100] = v + 2 if v < 254 else v - 2
        return out

    monkeypatch.setattr(RC, "render_batch_planar", off_by_two)
    diff_png = os.path.join(os.path.dirname(mini_bin), "diff.png")
    assert parity_check.main([mini_bin, sheet, "--all-z", "16", "--device", "cpu",
                              "--diff-png", diff_png]) == 1
    lines = _lines(capsys)
    assert "max diff 2/255" in lines[0] and "[FAIL]" in lines[0]
    assert "EXCEEDS" in lines[-1] and os.path.exists(diff_png)


def test_warmup_cli_on_the_cpu(mini_bin, capsys):
    from osm_renderer_tpu_torch.tools import warmup

    assert warmup.main([mini_bin, os.path.join(STYLESHEET_DIR, "default.mapcss"),
                        "--zooms", "15,16", "--buckets", "1,4", "--device", "cpu"]) == 0
    lines = _lines(capsys)
    assert lines[1] == "cpu: no kernel to build (the plain versions run)"
    warmed = [line for line in lines if line.startswith("warmed ")]
    assert [line.split(" (")[0] for line in warmed] == [
        f"warmed scale=1 zoom={z} tiles<={b}" for z in (15, 16) for b in (1, 4)]
    assert all("(batch 4, chunks " in line for line in warmed)
    assert lines[-1] == "warmup complete"


@pytest.mark.parametrize("arena", [True, False])
def test_profile_serving_cli_on_the_cpu(mini_bin, capsys, arena):
    from osm_renderer_tpu_torch.tools import profile_serving

    argv = ["--reps", "2", "--geodata", mini_bin, "--device", "cpu"]
    assert profile_serving.main(argv + ([] if arena else ["--no-arena"])) == 0
    lines = _lines(capsys)
    assert [line.split()[0] for line in lines[:5]] == list(profile_serving.STAGES)
    assert all(len(line.split()) == 2 + 2 + 2 for line in lines[:5])  # 2 reps, median
    assert lines[5].startswith("n=1 tiles; median total -> ")
    if arena:
        assert lines[6].startswith("arena packed upload: ")
    else:
        assert lines[6].startswith("concat ") and lines[7].startswith("batch bytes: ")
    assert lines[-2].startswith("encode: png writer ") and " plain path: v2 decode " in lines[-2]
    assert lines[-1].startswith("wire d2h ")


def test_cold_profile_cli_on_the_cpu(mini_bin, capsys):
    from osm_renderer_tpu_torch.tools import cold_profile

    assert cold_profile.main(["--reps", "2", "--bin", mini_bin, "--device", "cpu"]) == 0
    lines = _lines(capsys)
    assert lines[0] == "cold assembly, 2 tile renders (2 reps x 1 tiles; prepare on cpu)"
    names = [line.split()[0] + (" " + line.split()[1] if not line.split()[1][0].isdigit() else "")
             for line in lines[1:]]
    assert names[:2] == ["total wall", "full cold"]
    assert {"Fetch entities", "Assemble", "Place labels"} <= set(names)


def test_ktime_cli_on_the_cpu(mini_bin, capsys):
    from osm_renderer_tpu_torch.tools import ktime

    assert ktime.main(["--reps", "2", "--zoom", "16", "--geodata", mini_bin,
                       "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("z16: 2 tiles, ") and "not a device time" in out


@pytest.fixture(scope="module")
def jax_prepared(tmp_path_factory):
    """The JAX package's plain-upload batch of the five tiles."""
    from osm_renderer_tpu.core.tile import Tile as JaxTile
    from osm_renderer_tpu.mapcss.parser import parse_file
    from osm_renderer_tpu.mapcss.styler import Styler
    from osm_renderer_tpu.parallel.renderer import BatchRenderer as JaxBatchRenderer
    from tests.fixtures import build_mini_reader

    reader = build_mini_reader(tmp_path_factory.mktemp("jax_tools"))
    styler = Styler(parse_file(STYLESHEET_DIR, "default.mapcss"), "josm")
    te = [(reader.get_entities_in_tile_with_neighbors(JaxTile(t.zoom, t.x, t.y)),
           JaxTile(t.zoom, t.x, t.y)) for t in _tiles()]
    return JaxBatchRenderer(styler, backend="pallas", interpret=True,
                            stylesheet_dir=STYLESHEET_DIR).prepare(te, scale=1)


def test_kdecomp_variants_follow_the_jax_tools_rule(prepared, jax_prepared):
    """tools/kdecomp.py's masking of kind, isec and last, written out here
    and run on the JAX package's batch, gives the port's variant arrays
    from the port's batch of the same tiles (and full_no_blend, which the
    JAX tool lacks, keeps every kind and zeroes last); so do the section
    counts."""
    from osm_renderer_tpu.ops import render_pallas as rp
    from osm_renderer_tpu_torch.tools import kdecomp

    jb = jax_prepared.batch
    kind, isec, last = (np.asarray(jb.kind), np.asarray(jb.isec), np.asarray(jb.last))
    ci = prepared.batch.chunk_i.numpy()
    np.testing.assert_array_equal(ci[:, RC.CI_KIND], kind)
    np.testing.assert_array_equal(ci[:, RC.CI_LAST], last)
    np.testing.assert_array_equal(prepared.batch.isec.numpy(), isec)

    items = (rp.KIND_STROKE_SOLID, rp.KIND_STROKE_DASH)

    def variant(keep):
        nk = kind.copy()
        drop = ~np.isin(nk, keep) & (nk != rp.KIND_PAD)
        nk[drop] = rp.KIND_PAD
        return nk

    isec_axis = isec.copy()
    isec_axis[:, 4:] = isec_axis[:, 3:4]
    isec_ad = isec.copy()
    isec_ad[:, 8:] = isec_ad[:, 7:8]
    want = [("full", kind.copy(), isec, last),
            ("steps_only", variant(()), isec, np.zeros_like(last)),
            # The port's own variant: every chunk kept, no blend.
            ("full_no_blend", kind.copy(), isec, np.zeros_like(last)),
            ("items_shallow", variant(items), isec_axis, last),
            ("items_shallow_steep", variant(items), isec_ad, last)]
    got = kdecomp.variant_arrays(ci[:, RC.CI_KIND], prepared.batch.isec.numpy(),
                                 ci[:, RC.CI_LAST])
    assert [g[0] for g in got] == [w[0] for w in want] == list(kdecomp.VARIANTS)
    for g, w in zip(got, want):
        for a, b in zip(g[1:], w[1:]):
            np.testing.assert_array_equal(a, b, err_msg=g[0])
    item_chunks = np.isin(kind, items)
    assert kdecomp.item_counts(ci[:, RC.CI_KIND], prepared.batch.isec.numpy()) == {
        "shallow": int(isec[item_chunks, 3].sum()),
        "steep16": int((isec[item_chunks, 7] - isec[item_chunks, 3]).sum()),
        "dead": int((isec[item_chunks, 11] - isec[item_chunks, 7]).sum())}


def test_kdecomp_decompose_and_cli_on_the_cpu(prepared, mini_bin, monkeypatch, capsys):
    """Every variant renders on the twin and is timed on the CPU clock; a
    `full` that differed from the batch's render raises; the CLI prints
    the section counts and a line a variant."""
    from osm_renderer_tpu_torch.tools import kdecomp

    rows = kdecomp.decompose(prepared, reps=1)
    assert [r["name"] for r in rows] == list(kdecomp.VARIANTS)
    assert all(r["clock"] == "cpu" and r["launches"] == 0 and r["ms"] > 0 for r in rows)
    assert rows[1]["chunks"] == {}
    assert kdecomp.main(["--device", "cpu", "--reps", "1", "--geodata", mini_bin,
                         "--zoom", "16"]) == 0
    lines = _lines(capsys)
    assert lines[0].startswith("z16 batch of 2 tiles on cpu") and "items: shallow " in lines[0]
    assert [line.split(":")[0].strip() for line in lines[1:]] == list(kdecomp.VARIANTS)

    real = kdecomp.variant_arrays

    def spoiled(*arrays):
        out = real(*arrays)
        name, kind, isec, last = out[0]
        return [(name, np.where(kind == 1, 0, kind).astype(kind.dtype), isec, last)] + out[1:]

    monkeypatch.setattr(kdecomp, "variant_arrays", spoiled)
    with pytest.raises(RuntimeError, match="full variant differs"):
        kdecomp.decompose(prepared, reps=1)
