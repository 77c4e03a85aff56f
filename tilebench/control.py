"""The control: the plain reference in the program's place, one precision down.

    python3 -m tilebench.control --workload CELL --seeds 11,12,13 --seconds 5

The served path computes in f32 (`precision = fast`); the control is the
reference computed in bfloat16 (`reference.Reference.render(key,
"bf16")`).  It is served in the program's place: after the warm-up, the
service's `render_tiles_device` answers every request with the PNG of
the control's tile, so the window's answers pass the HTTP server, the
load generator, the PNG decoder and `run.judge` as a run's do, and the
run's own `correct` and `ref_gap` are the control's readings.  Each seed
is one run of the cell with a short window, all in one process; the
benchmark's runs never run this.  Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from tilebench import pngdec, run


class ServeControl:
    """A fault for `run.run_cell`: the reference in bfloat16 answers every
    request of the hot set.  Its tiles are rendered when it is installed,
    in the run's set-up, and kept for the next run."""

    def __init__(self, cell: run.Cell, device: str, city=None):
        self.cell, self.device, self.city = cell, device, city
        self.pngs = {}

    def __call__(self, service) -> None:
        from tilebench import traffic as traffic_mod
        from tilebench.city import ensure_city
        from tilebench.ref.geodata.reader import GeodataReader
        from tilebench.reference import Reference

        cfg, tr = self.cell.config, self.cell.traffic
        files = ensure_city(self.city or cfg["city"])
        if not self.pngs:
            reader = GeodataReader.load(files.reference_bin)
            xy = list(zip(reader.tiles["x"].tolist(), reader.tiles["y"].tolist()))
            ref = Reference(files.reference_bin,
                            os.path.join(run.HERE, "configs", cfg["style"]["file"]),
                            cfg["style"]["type"], self.device)
            for key in traffic_mod.hot_keys(xy, tr["zooms"], tr["scales"]):
                self.pngs[key] = pngdec.encode(ref.render(key, "bf16"))
        pngs = self.pngs

        def render_tiles_device(requests):
            return [pngs[(t.zoom, t.x, t.y, int(s))] for t, s in requests]

        service.render_tiles_device = render_tiles_device


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="The control's readings of one cell.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    cell = run.find_cell(run.load_json(os.path.join(run.ROOT, "BENCHMARK.json")), args.workload)
    run.use_checkout_caches()
    cpus = run.split_cpus()
    import torch

    if not torch.cuda.is_available():
        print("tilebench.control: no CUDA device visible", file=sys.stderr)
        return 2
    control = ServeControl(cell, "cuda")
    readings = []
    for seed in (int(s) for s in args.seeds.split(",")):
        res = run.run_cell(cell, seed, args.seconds, False, "cuda", fault=control,
                           loadgen_cpus=cpus)
        readings.append({"seed": seed, "correct": res["correct"], "attempted": res["attempted"],
                         "check": res["check"]})
        print(json.dumps(readings[-1]), file=sys.stderr, flush=True)
    print(json.dumps({"workload": cell.name, "control": readings}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
