"""The port imports without jax, fontTools or the JAX package, serves
with both backends under that guard, and asks for no device it cannot
get."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests.conftest import REPO_ROOT
from tests.fixtures import MINI_OSM


def _port_modules():
    """Every module of the port (found on disk, imported by nothing here),
    then chip_smoke."""
    root = os.path.join(REPO_ROOT, "osm_renderer_tpu_torch")
    mods = []
    for d, _, names in os.walk(root):
        pkg = os.path.relpath(d, REPO_ROOT).replace(os.sep, ".")
        mods += [pkg if f == "__init__.py" else f"{pkg}.{f[:-3]}"
                 for f in sorted(names) if f.endswith(".py")]
    return sorted(mods) + ["chip_smoke"]


PORT_MODULES = _port_modules()

# Refuses the named top-level packages: always jax and the JAX package,
# and for the second case fontTools, which the GPU host may lack (the
# servers must import, and label a tile, without it).
_GUARD = """
import importlib, importlib.abc, sys
BLOCKED = {blocked!r}
class Guard(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked import: " + name)
        return None
sys.meta_path.insert(0, Guard())
sys.path.insert(0, {root!r})
for m in {modules!r}:
    importlib.import_module(m)
{serve}
assert not [m for m in sys.modules if m.split(".")[0] in BLOCKED]
print("IMPORTED", len({modules!r}))
"""

# With the guard still in place: the port's importer, styler and labeler
# on the mini fixture, then one labeled z16 tile from each backend of the
# port's server (backend = device on the kernels' plain versions, and
# backend = cpu, the C++ oracle); both PNGs go to files.
_SERVE = """
import tempfile
from osm_renderer_tpu_torch.core.tile import Tile, coords_to_max_zoom_tile
from osm_renderer_tpu_torch.draw.labels.labeler import Labeler
from osm_renderer_tpu_torch.geodata.importer import import_osm
from osm_renderer_tpu_torch.mapcss.parser import parse_file
from osm_renderer_tpu_torch.mapcss.styler import Styler
from osm_renderer_tpu_torch.server.http import TileService
sheets = {sheets!r}
tmp = tempfile.mkdtemp()
with open(tmp + "/mini.osm", "w") as f:
    f.write({osm!r})
import_osm(tmp + "/mini.osm", tmp + "/mini.bin")
styler = Styler(parse_file(sheets, "default.mapcss"), "josm")
t18 = coords_to_max_zoom_tile(47.1412, 9.5215)
tile = Tile(16, t18.x >> 2, t18.y >> 2)
device = TileService(tmp + "/mini.bin", styler, sheets, backend="device", device="cpu")
cpu = TileService(tmp + "/mini.bin", styler, sheets, backend="cpu")
ents = cpu.reader.get_entities_in_tile_with_neighbors(tile)
compact = Labeler(icon_base_path=sheets).ensure_layer(ents, tile, 1.0, styler, 256)
assert compact is not None and compact[5].max() > 0, "no label placed"
print("LABELED", compact[1] - compact[0], "rows")
png_dev = device.render_tiles_device([(tile, 1)])[0]
assert device.batch_renderer.batch_counts["labeled_tiles"] == 1
assert cpu.batch_renderer is None and cpu.warmup() == 0
png_cpu = cpu.render_tile_cpu(tile, 1)
for path, png in (({out_dev!r}, png_dev), ({out_cpu!r}, png_cpu)):
    with open(path, "wb") as f:
        f.write(png)
print("SERVED", len(png_dev), len(png_cpu))
"""


def _jax_cpu_server_png(tmp_path):
    """The JAX package's CPU server on the same labeled tile."""
    from osm_renderer_tpu.core.tile import Tile, coords_to_max_zoom_tile
    from osm_renderer_tpu.mapcss.parser import parse_file
    from osm_renderer_tpu.mapcss.styler import Styler
    from osm_renderer_tpu.server.http import TileService
    from tests.fixtures import build_mini_reader

    sheets = os.path.join(REPO_ROOT, "assets", "stylesheets")
    tmp_path.mkdir()
    build_mini_reader(tmp_path)
    styler = Styler(parse_file(sheets, "default.mapcss"), "josm")
    svc = TileService(str(tmp_path / "mini.bin"), styler, sheets, backend="cpu")
    t18 = coords_to_max_zoom_tile(47.1412, 9.5215)
    return svc.render_tile_cpu(Tile(16, t18.x >> 2, t18.y >> 2), 1)


@pytest.mark.parametrize("blocked", [("jax", "jaxlib", "osm_renderer_tpu"),
                                     ("jax", "jaxlib", "fontTools", "osm_renderer_tpu")],
                         ids=["no_jax", "no_jax_no_fonttools"])
def test_port_imports_without_jax(blocked, tmp_path):
    """Every port module imports under the guard.  With fontTools refused
    too, both backends serve a labeled tile: the CPU backend's PNG is
    byte-identical to the JAX package's CPU server.  (The device
    backend's labels come from the glyph atlas, not the per-glyph path of
    the CPU backend; test_torch_serving.py holds its pixels to the JAX
    device server.)"""
    serve = ""
    out_dev, out_cpu = str(tmp_path / "device.png"), str(tmp_path / "cpu.png")
    if "fontTools" in blocked:
        serve = _SERVE.format(sheets=os.path.join(REPO_ROOT, "assets", "stylesheets"),
                              osm=MINI_OSM, out_dev=out_dev, out_cpu=out_cpu)
    code = _GUARD.format(blocked=set(blocked), root=REPO_ROOT, modules=PORT_MODULES,
                         serve=serve)
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert f"IMPORTED {len(PORT_MODULES)}" in proc.stdout
    assert len(PORT_MODULES) > 40
    assert ("SERVED" in proc.stdout) == ("fontTools" in blocked)
    if "fontTools" not in blocked:
        return
    from PIL import Image

    want = _jax_cpu_server_png(tmp_path / "jax")
    with open(out_cpu, "rb") as f:
        assert f.read() == want
    dev, cpu = (np.asarray(Image.open(p).convert("RGB")) for p in (out_dev, out_cpu))
    assert dev.shape == cpu.shape == (256, 256, 3)


def test_resolve_device_never_falls_back():
    from osm_renderer_tpu_torch.utils.torch_setup import resolve_device

    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            resolve_device("cuda")
        with pytest.raises(RuntimeError):
            resolve_device("cuda:0")


def test_build_dir_and_next_pow2(tmp_path, monkeypatch):
    from osm_renderer_tpu_torch.utils import torch_setup

    monkeypatch.setenv("OSMR_TORCH_BUILD_DIR", str(tmp_path / "k"))
    assert torch_setup.build_dir() == str(tmp_path / "k")
    assert os.path.isdir(tmp_path / "k")
    monkeypatch.delenv("OSMR_TORCH_BUILD_DIR")
    assert torch_setup.build_dir() == os.path.join(REPO_ROOT, "build", "kernels")
    assert [torch_setup.next_pow2(n, 4) for n in (1, 4, 5, 8, 9, 97)] == [4, 4, 8, 8, 16, 128]


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """Outside a checkout (only the script) it fails and prints no result;
    in the checkout it fails here for want of a CUDA device."""
    import shutil

    shutil.copy(os.path.join(REPO_ROOT, "chip_smoke.py"), tmp_path / "chip_smoke.py")
    alone = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                           capture_output=True, text=True, timeout=120)
    assert alone.returncode != 0 and '"ok"' not in alone.stdout
    if not torch.cuda.is_available():
        here = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO_ROOT,
                              capture_output=True, text=True, timeout=300)
        assert here.returncode != 0 and '"ok"' not in here.stdout
