"""Quick timing of the render kernel on one zoom of a city.

Counterpart of `tools/ktime.py`: the render kernel alone (no wire, no
end to end) on the plain-upload batch of every tile of `--zoom`, for
fast iteration on kernel changes.  Two clocks side by side:

  events    CUDA events around `--reps` back-to-back launches, over the
            count: the host's enqueue included where it is the longer
  profiler  `kdevice.device_ms_per_call`: the kernel's own device time a
            call, from a torch.profiler trace

    python -m osm_renderer_tpu_torch.tools.ktime [--reps 16] [--zoom 15] \\
        [--geodata assets/fixtures/minicity.bin] [--device cuda]

On the card by default; `--device cpu` (for the tests) times the plain
twin with the host clock, which is not a device time.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import torch

from osm_renderer_tpu_torch.tools.kdevice import (
    REPO_ROOT,
    STYLESHEET_DIR,
    device_ms_per_call,
    zoom_tiles_entities,
)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--reps", type=int, default=16)
    ap.add_argument("--zoom", type=int, default=15)
    ap.add_argument("--geodata",
                    default=os.path.join(REPO_ROOT, "assets", "fixtures", "minicity.bin"))
    ap.add_argument("--device", default="cuda", help="cuda, cuda:N, or cpu (the plain twin)")
    args = ap.parse_args(argv)

    from osm_renderer_tpu_torch.ops import render_cuda as RC
    from osm_renderer_tpu_torch.parallel.renderer import BatchRenderer
    from osm_renderer_tpu_torch.utils.torch_setup import resolve_device

    device = resolve_device(args.device)
    te, styler = zoom_tiles_entities(args.geodata, args.zoom)
    n = len(te)
    prep = BatchRenderer(styler, stylesheet_dir=STYLESHEET_DIR, chunk_cache_tiles=256,
                         device=device).prepare(te, scale=1)
    b, canvas, ts = prep.batch, prep.canvas_rgb, prep.ts

    def launch():
        return RC.render_batch_planar(b, canvas, ts)

    if device.type == "cpu":
        launch()
        t0 = time.perf_counter()
        for _ in range(args.reps):
            launch()
        dt = (time.perf_counter() - t0) * 1e3 / args.reps
        print(f"z{args.zoom}: {n} tiles, {dt:.2f} ms/batch, {n / dt * 1e3:.0f} tiles/s "
              "(cpu: the plain twin, host clock; not a device time)")
        return 0
    launch()
    torch.cuda.synchronize(device)
    ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    ev0.record()
    for _ in range(args.reps):
        launch()
    ev1.record()
    torch.cuda.synchronize(device)
    dt = ev0.elapsed_time(ev1) / args.reps
    prof = device_ms_per_call(launch, args.reps, ("render_kernel",), device)["ms"]
    print(f"z{args.zoom}: {n} tiles, {dt:.4f} ms/batch (events), {n / dt * 1e3:.0f} tiles/s; "
          f"profiler {prof:.4f} ms/batch, {n / prof * 1e3:.0f} tiles/s "
          f"[{args.reps} launches, {torch.cuda.get_device_name(device)}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
