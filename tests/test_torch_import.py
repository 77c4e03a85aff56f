"""The port imports without jax, and asks for no device it cannot get."""

import os
import subprocess
import sys

import pytest
import torch

from tests.conftest import REPO_ROOT

PORT_MODULES = [
    "osm_renderer_tpu_torch",
    "osm_renderer_tpu_torch.utils.torch_setup",
    "osm_renderer_tpu_torch.ops.chunk_layout",
    "osm_renderer_tpu_torch.ops.build",
    "osm_renderer_tpu_torch.ops.render_cuda",
    "osm_renderer_tpu_torch.ops.rle_layout",
    "osm_renderer_tpu_torch.ops.rle_cuda",
    "osm_renderer_tpu_torch.parallel.arena",
    "osm_renderer_tpu_torch.parallel.label_slab",
    "osm_renderer_tpu_torch.draw.labels.font",
    "osm_renderer_tpu_torch.draw.labels.text_placer",
    "osm_renderer_tpu_torch.draw.labels.atlas",
    "osm_renderer_tpu_torch.draw.labels.labeler",
    "osm_renderer_tpu_torch.draw.native_assembler",
    "osm_renderer_tpu_torch.parallel.renderer",
    "osm_renderer_tpu_torch.server.http",
    "osm_renderer_tpu_torch.cli.renderer_main",
    "chip_smoke",
]

# Refuses jax (and, for the second case, fontTools, which the GPU host
# may lack: the device server must import, and label a tile, without it).
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
{label}
assert not [m for m in sys.modules if m.split(".")[0] in BLOCKED]
print("IMPORTED", len({modules!r}))
"""

# The port's labeler places the mini fixture's labels (a z16 tile that
# carries some) with the guard still in place.
_LABEL = """
import tempfile
from osm_renderer_tpu.core.tile import Tile, coords_to_max_zoom_tile
from osm_renderer_tpu.mapcss.parser import parse_file
from osm_renderer_tpu.mapcss.styler import Styler
from osm_renderer_tpu_torch.draw.labels.labeler import Labeler
from tests.fixtures import build_mini_reader
sheets = {sheets!r}
reader = build_mini_reader(tempfile.mkdtemp())
styler = Styler(parse_file(sheets, "default.mapcss"), "josm")
t18 = coords_to_max_zoom_tile(47.1412, 9.5215)
tile = Tile(16, t18.x >> 2, t18.y >> 2)
ents = reader.get_entities_in_tile_with_neighbors(tile)
compact = Labeler(icon_base_path=sheets).ensure_layer(ents, tile, 1.0, styler, 256)
assert compact is not None and compact[5].max() > 0, "no label placed"
print("LABELED", compact[1] - compact[0], "rows")
"""


@pytest.mark.parametrize("blocked", [("jax", "jaxlib"), ("jax", "jaxlib", "fontTools")],
                         ids=["no_jax", "no_jax_no_fonttools"])
def test_port_imports_without_jax(blocked):
    label = ""
    if "fontTools" in blocked:
        label = _LABEL.format(sheets=os.path.join(REPO_ROOT, "assets", "stylesheets"))
    code = _GUARD.format(blocked=set(blocked), root=REPO_ROOT, modules=PORT_MODULES,
                         label=label)
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert f"IMPORTED {len(PORT_MODULES)}" in proc.stdout
    assert ("LABELED" in proc.stdout) == ("fontTools" in blocked)


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
