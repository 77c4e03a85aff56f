"""Build the port's kernels and run every serving batch shape once.

Counterpart of `tools/warmup.py`, which fills JAX's persistent compile
cache with the Pallas kernel's signatures.  The port compiles nothing
per shape: its kernels take the batch's sizes as arguments.  What it
warms instead:

* the three kernel libraries (render, wires, and the dense kernels of
  `precision = exact`), built by nvcc into the kernel build directory
  (`ops/build.py::build_all`; `build/kernels/` unless
  `OSMR_TORCH_BUILD_DIR` says otherwise), named by a hash of source and
  flags, so every later process on this checkout loads them without
  building;
* the native host libraries (the chunk assembler and the oracle);
* one batch of every (scale, zoom, tile bucket) through a
  `BatchRenderer` as the server runs it: the arena entry, then a wire
  read back, each timed.

It cannot warm what a server process learns for itself: each renderer's
serving palette (its first batch ships the v1 wire), its adaptive wire
caps, and its chunk, label and PNG caches start empty in every new
process.

    python -m osm_renderer_tpu_torch.tools.warmup GEODATA.bin STYLESHEET.mapcss \\
        [--scales 1,2] [--zooms 13,15,17] [--buckets 4,8,16,32] [--device cuda]

`--device cpu` (for the tests) builds nothing and runs the plain
versions.
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("geodata")
    ap.add_argument("stylesheet")
    ap.add_argument("--scales", default="1")
    ap.add_argument("--zooms", default="13,15,17")
    ap.add_argument("--buckets", default="4,8,16,32")
    ap.add_argument("--device", default="cuda", help="cuda, cuda:N, or cpu (the plain versions)")
    args = ap.parse_args(argv)

    from osm_renderer_tpu_torch.geodata.reader import GeodataReader
    from osm_renderer_tpu_torch.mapcss.parser import parse_file
    from osm_renderer_tpu_torch.mapcss.styler import Styler
    from osm_renderer_tpu_torch.parallel.renderer import BatchRenderer, start_wire_copy
    from osm_renderer_tpu_torch.tools.corpus import zoom_tiles
    from osm_renderer_tpu_torch.utils.torch_setup import build_native_host_libs, resolve_device

    device = resolve_device(args.device)
    t0 = time.perf_counter()
    build_native_host_libs()
    print(f"native host libraries ready in {time.perf_counter() - t0:.1f}s")
    if device.type == "cuda":
        from osm_renderer_tpu_torch.ops import build
        from osm_renderer_tpu_torch.utils.torch_setup import build_dir

        t0 = time.perf_counter()
        build.build_all()
        nvcc = ", ".join(f"{k} {v:.1f}s" for k, v in sorted(build.BUILD_SECONDS.items()))
        print(f"kernels ready in {build_dir()} in {time.perf_counter() - t0:.1f}s (nvcc: {nvcc})")
    else:
        print("cpu: no kernel to build (the plain versions run)")

    reader = GeodataReader.load(args.geodata)
    base, name = os.path.split(args.stylesheet)
    styler = Styler(parse_file(base, name), "josm")
    # As the server's renderers: tile buckets, a chunk cache, the arena.
    renderer = BatchRenderer(styler, stylesheet_dir=base, tile_bucket=True,
                             chunk_cache_tiles=512, device=device, arena=True)

    if reader.tiles.shape[0] == 0:
        print("geodata has no tile index entries; nothing to warm")
        return 0

    scales = [int(s) for s in args.scales.split(",")]
    zooms = [int(z) for z in args.zooms.split(",")]
    buckets = sorted({int(b) for b in args.buckets.split(",")})

    for scale in scales:
        for zoom in zooms:
            zt = zoom_tiles(reader, zoom)
            for bucket in buckets:
                tiles = zt[:bucket]
                if not tiles:
                    continue
                te = [(reader.get_entities_in_tile_with_neighbors(t), t) for t in tiles]
                t0 = time.perf_counter()
                prepared = renderer.prepare(te, scale)
                view = renderer.fetch_tile_view(
                    start_wire_copy(renderer.render_prepared_rle(prepared)))
                chunks = (prepared.arena_packed.shape[1] if prepared.arena_packed is not None
                          else prepared.batch.chunk_i.shape[0])
                print(f"warmed scale={scale} zoom={zoom} tiles<={bucket} "
                      f"(batch {view.T}, chunks {chunks}) in {time.perf_counter() - t0:.1f}s")
    print("warmup complete")
    return 0


if __name__ == "__main__":
    sys.exit(main())
