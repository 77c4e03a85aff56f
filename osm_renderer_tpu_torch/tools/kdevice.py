"""Device time of the port's kernels, read from a torch.profiler trace.

Counterpart of `tools/kdevice.py`.  A loop of launches timed on the
host folds the host's enqueue and synchronisation into every number;
this runs a call `reps` times under `torch.profiler` and sums, per call,
the device time of the named kernels only (`render_kernel` of
`csrc/render.cu`, `wire_kernel` of `csrc/rle.cu`).  `device_ms` times
a call's whole device work with CUDA events instead, the host's enqueue
hidden behind a sleep on the card.  The command line
times the z15 batch of a city through the arena entry, then the v2 wire
behind it; with `--dense exact` (or `fast`) it times the same batch on
the dense renderer of `precision = exact` instead, by kernel
(`dense_stroke_alpha`, `dense_fill_alpha`, `dense_blend_finalize` of
`csrc/dense.cu`):

    python -m osm_renderer_tpu_torch.tools.kdevice [--reps 8] [--zoom 15] \\
        [--geodata assets/fixtures/bigcity.bin] [--device cuda] [--dense exact|fast]

It runs on the card by default.  `--device cpu` (for the tests) runs the
kernels' plain versions and reports their CPU operator time, which is
not a device time.  The fixtures come from `python3 chip_smoke.py` or
`tools/make_fixture.py` and the port's importer.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Callable, Dict, Sequence

import torch

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
STYLESHEET_DIR = os.path.join(REPO_ROOT, "assets", "stylesheets")
KERNELS = ("render_kernel", "wire_kernel")


def device_ms_per_call(fn: Callable[[], object], reps: int,
                       kernel_names: Sequence[str] = KERNELS,
                       device: torch.device = torch.device("cuda")) -> Dict[str, object]:
    """fn() once to warm, then `reps` times under torch.profiler ->
    {"ms": per call, "launches": launches seen, "by_kernel": {name: ms
    per call}, "clock": "cuda"}: the summed device time of the kernels
    whose names contain one of `kernel_names`, each of which fn()
    launches once a call.

    The trace can lack some launches when much other device work ran
    since the last trace (seen on an H100 after the render twin's
    kernels and after a long serving run: half or none of the launches).
    The warm call therefore runs under a trace of its own, which is
    thrown away, and a trace that holds fewer than `reps` launches of a
    named kernel is taken again, up to 3 times; then this raises.

    On the CPU (`device.type == "cpu"`) the call runs the plain versions,
    once, unwarmed, and "ms" is their CPU operator time per call
    ("clock": "cpu", no launches)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if device.type == "cpu":
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for _ in range(reps):
                fn()
        us = sum(e.self_cpu_time_total for e in prof.key_averages())
        return {"ms": us / 1e3 / reps, "launches": 0, "by_kernel": {}, "clock": "cpu"}
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=activities):
        fn()
        torch.cuda.synchronize(device)
    for _ in range(3):
        with profile(activities=activities) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize(device)
        by_kernel: Dict[str, float] = {}
        counts: Dict[str, int] = dict.fromkeys(kernel_names, 0)
        seen = set()
        for e in prof.events():
            if e.device_type != DeviceType.CUDA:
                continue
            seen.add(e.name)
            name = next((k for k in kernel_names if k in e.name), None)
            if name is not None:
                by_kernel[name] = by_kernel.get(name, 0.0) + e.time_range.elapsed_us() / 1e3 / reps
                counts[name] += 1
        if min(counts.values()) >= reps:
            return {"ms": sum(by_kernel.values()), "launches": sum(counts.values()),
                    "by_kernel": by_kernel, "clock": "cuda"}
    raise RuntimeError(f"three profiler traces of {reps} calls held too few launches of "
                       f"{list(kernel_names)}: {counts} (device events: {sorted(seen)[:8]})")


def device_ms(fn: Callable[[], object], reps: int = 20) -> float:
    """Mean device ms of `reps` back-to-back calls of fn() on the current
    CUDA device, the host's enqueue hidden: the card first sleeps
    (torch.cuda._sleep, its cycles a ms measured here) for longer than
    the host took to queue the same calls, then CUDA events time the
    queued calls as the card runs them."""
    ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    ev0.record()
    torch.cuda._sleep(10_000_000)
    ev1.record()
    torch.cuda.synchronize()
    cycles_per_ms = 10_000_000 / ev0.elapsed_time(ev1)
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda._sleep(int(cycles_per_ms * (2 * host_ms + 1)))
    ev0.record()
    for _ in range(reps):
        fn()
    ev1.record()
    torch.cuda.synchronize()
    return ev0.elapsed_time(ev1) / reps


def device_name(device: torch.device) -> str:
    """The card's name, or "cpu"."""
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def zoom_tiles_entities(geodata: str, zoom: int):
    """Every tile of `zoom` the geodata covers, with its entities, and
    the default stylesheet's styler -> (tiles_entities, styler)."""
    from osm_renderer_tpu_torch.geodata.reader import GeodataReader
    from osm_renderer_tpu_torch.mapcss.parser import parse_file
    from osm_renderer_tpu_torch.mapcss.styler import Styler
    from osm_renderer_tpu_torch.tools.corpus import with_entities, zoom_tiles

    reader = GeodataReader.load(geodata)
    styler = Styler(parse_file(STYLESHEET_DIR, "default.mapcss"), "josm")
    return with_entities(reader, zoom_tiles(reader, zoom)), styler


def parse_args(argv, description: str, dense: bool = False) -> argparse.Namespace:
    """The tools' shared options; `dense` adds kdevice's --dense."""
    ap = argparse.ArgumentParser(description=description)
    if dense:
        ap.add_argument("--dense", choices=("exact", "fast"),
                        help="time the dense renderer's kernels in this precision instead")
    ap.add_argument("--reps", type=int, default=8)
    ap.add_argument("--zoom", type=int, default=15)
    ap.add_argument("--geodata", default=os.path.join(REPO_ROOT, "assets", "fixtures", "bigcity.bin"))
    ap.add_argument("--device", default="cuda", help="cuda, cuda:N, or cpu (the plain versions)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    from osm_renderer_tpu_torch.parallel.renderer import BatchRenderer, start_wire_copy
    from osm_renderer_tpu_torch.utils.torch_setup import resolve_device

    args = parse_args(argv, "Device ms of the render kernel and the v2 wire on one batch.",
                      dense=True)
    device = resolve_device(args.device)
    te, styler = zoom_tiles_entities(args.geodata, args.zoom)
    n = len(te)
    if args.dense:
        from osm_renderer_tpu_torch.ops.dense_cuda import KERNELS as DENSE_KERNELS

        r = BatchRenderer(styler, stylesheet_dir=STYLESHEET_DIR, device=device,
                          backend="dense", precision=args.dense)
        prep = r.prepare(te, 1)
        got = device_ms_per_call(lambda: r.render_prepared(prep), args.reps, DENSE_KERNELS,
                                 device)
    else:
        r = BatchRenderer(styler, stylesheet_dir=STYLESHEET_DIR, chunk_cache_tiles=4 * n,
                          device=device, arena=True)
        prep = r.prepare(te, 1)
        # The first wire is v1 and teaches the renderer its palette; the
        # timed calls ship the v2 wire, as warm serving does.
        r.fetch_tile_view(start_wire_copy(r.render_prepared_rle(prep)))
        got = device_ms_per_call(lambda: r.render_prepared_rle(prep), args.reps, KERNELS,
                                 device)
    ms = got["ms"]
    if got["clock"] == "cpu":
        print(f"cpu: {ms:9.3f} ms/batch of CPU operator time in the plain versions "
              f"(not a device time; {n} tiles)")
        return 0
    by = got["by_kernel"]
    print(f"device: {ms:7.4f} ms/batch ({n} tiles, {n / ms * 1e3:7.0f} t/s): "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in by.items())
          + f" [{got['launches']} launches in {args.reps} calls, {torch.cuda.get_device_name(device)}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
