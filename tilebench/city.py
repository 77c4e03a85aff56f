"""The benchmark's city: one synthetic metro, built once per checkout.

A configuration names its city by generator parameters (`city.blocks`,
`city.seed`).  The OSM XML comes from the benchmark's frozen copy of the
fixture generator (`tilebench/ref/make_fixture.py`).  The program gets
the `.bin` that its own importer makes of it; the reference gets the
`.bin` that the benchmark's frozen importer makes, so it reads nothing
the program made.  All three files live in `tilebench/cache/`, which git
ignores, under a name made of the parameters alone, and are written
under a temporary name and renamed, so a run that dies half way leaves
nothing that a later run would take for a city.
"""

from __future__ import annotations

import contextlib
import os
import sys
from typing import NamedTuple

HERE = os.path.dirname(os.path.abspath(__file__))
CACHE = os.path.join(HERE, "cache")


class CityFiles(NamedTuple):
    osm: str
    program_bin: str
    reference_bin: str


def _build(path: str, make) -> None:
    if os.path.exists(path):
        return
    tmp = f"{path}.partial"
    with contextlib.redirect_stdout(sys.stderr):
        make(tmp)
    os.replace(tmp, path)


def ensure_city(city: dict, cache: str = CACHE) -> CityFiles:
    """Build (or find) the city `city` = {"blocks": N, "seed": S} ->
    its three files.  The importers print to standard error, so that a
    run's standard output holds only its result."""
    blocks, seed = int(city["blocks"]), int(city["seed"])
    os.makedirs(cache, exist_ok=True)
    stem = os.path.join(cache, f"city-b{blocks}-s{seed}")
    files = CityFiles(f"{stem}.osm", f"{stem}.program.bin", f"{stem}.reference.bin")

    def make_osm(out):
        from tilebench.ref import make_fixture

        make_fixture.main([out, "--blocks", str(blocks), "--seed", str(seed)])

    def import_program(out):
        from osm_renderer_tpu_torch.geodata.importer import import_osm

        import_osm(files.osm, out)

    def import_reference(out):
        from tilebench.ref.geodata.importer import import_osm

        import_osm(files.osm, out)

    _build(files.osm, make_osm)
    _build(files.program_bin, import_program)
    _build(files.reference_bin, import_reference)
    return files
