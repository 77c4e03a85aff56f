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
