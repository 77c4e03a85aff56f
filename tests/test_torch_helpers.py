"""Fixtures shared by the test_torch_* files (this file holds no tests).

The port's side of every comparison is built wholly from
`osm_renderer_tpu_torch`: its importer, reader, styler and primitives.
The JAX package's objects serve the reference side only, because the
stylers, `labelable` and the assemblers test entities with `isinstance`
against their own package's classes: a JAX-package `Styler` handed the
port's entities styles nothing and raises nothing.
"""

import os
import subprocess
import sys

from osm_renderer_tpu_torch.geodata.importer import import_osm
from osm_renderer_tpu_torch.geodata.reader import GeodataReader
from osm_renderer_tpu_torch.mapcss.parser import parse_file
from osm_renderer_tpu_torch.mapcss.styler import Styler

from tests.conftest import REPO_ROOT
from tests.fixtures import MINI_OSM

STYLESHEET_DIR = os.path.join(REPO_ROOT, "assets", "stylesheets")


def write_osm(tmp_path, text: str = MINI_OSM, name: str = "mini") -> str:
    path = os.path.join(str(tmp_path), f"{name}.osm")
    with open(path, "w") as f:
        f.write(text)
    return path


def port_bin(tmp_path, text: str = MINI_OSM, name: str = "mini") -> str:
    """The scene imported by the port's importer -> path of the .bin."""
    bin_path = os.path.join(str(tmp_path), f"{name}.bin")
    import_osm(write_osm(tmp_path, text, name), bin_path)
    return bin_path


def port_mini_reader(tmp_path, text: str = MINI_OSM, name: str = "mini") -> GeodataReader:
    return GeodataReader.load(port_bin(tmp_path, text, name))


def port_styler(sheet: str = "default.mapcss", kind: str = "josm") -> Styler:
    return Styler(parse_file(STYLESHEET_DIR, sheet), kind)


def make_minicity_osm(tmp_path, blocks: int = 24) -> str:
    """The synthetic city of tools/make_fixture.py -> path of its .osm."""
    osm = os.path.join(str(tmp_path), "minicity.osm")
    subprocess.run([sys.executable, os.path.join(REPO_ROOT, "tools", "make_fixture.py"), osm,
                    "--blocks", str(blocks)], check=True, stdout=subprocess.DEVNULL)
    return osm


# The reference renders of the dense-renderer tests run in a child
# process with XLA on one thread: under a loaded host (the tests run
# six workers on eight cores), XLA's fork-join thread pool waits on
# descheduled shards and a render that takes 20 s alone took 20 times
# as long.  The child enables x64 as tests/conftest.py does.
_JAX_CHILD = """
import sys
import numpy as np
sys.path.insert(0, {root!r})
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
inp = dict(np.load({src!r}, allow_pickle=False))
out = {{}}
{code}
np.savez({dst!r}, **out)
"""


def run_jax(code: str, tmp_dir, **arrays) -> dict:
    """Run `code` (it reads the dict `inp` of `arrays` and fills the dict
    `out` with numpy arrays) in a child process with jax on the CPU, x64
    and one XLA thread -> `out`."""
    import tempfile

    import numpy as np

    fd, src = tempfile.mkstemp(suffix=".npz", dir=str(tmp_dir))
    os.close(fd)
    dst = src[:-4] + "_out.npz"
    np.savez(src, **arrays)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1")
    proc = subprocess.run(
        [sys.executable, "-c", _JAX_CHILD.format(root=REPO_ROOT, src=src, dst=dst, code=code)],
        cwd=REPO_ROOT, env=env, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with np.load(dst) as f:
        return {k: f[k] for k in f.files}


class torch_threads:
    """Run a block with PyTorch's CPU ops on `n` threads (the tests' port
    side, for the same reason as `run_jax`)."""

    def __init__(self, n: int = 1):
        import torch

        self._torch, self._n = torch, n

    def __enter__(self):
        self._saved = self._torch.get_num_threads()
        self._torch.set_num_threads(self._n)

    def __exit__(self, *exc):
        self._torch.set_num_threads(self._saved)
