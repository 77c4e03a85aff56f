"""Where a cold tile's host time goes.

Counterpart of `tools/cold_profile.py`.  Cold serving assembles every
tile on the host (milliseconds a tile) where warm serving reuses its
cached chunks.  This walks every z15 tile of a city with empty caches,
`--reps` times, each time with a fresh styler and renderer, and prints
the span tree of the port's `perfstats` (the server's `/perf_stats`
profiler) a tile:

  Fetch entities   reader.get_entities_in_tile_with_neighbors (3x3)
  Assemble         draw/native_assembler.assemble_tile_chunks_native
                   (styling, projection, requests, the C++ assembly)
  Place labels     Labeler.ensure_layer, the host label placement a cold
                   labeled tile pays (no label cache)

then the full cold `prepare` a tile (assembly, arena insert, packed
upload; the styler's cache warm from the walk), after one throwaway
prepare, ending in `torch.cuda.synchronize`.

    python -m osm_renderer_tpu_torch.tools.cold_profile [--reps 3] \\
        [--bin assets/fixtures/minicity.bin] [--stylesheet PATH] [--device cuda]

On the card by default (only the prepare touches it); `--device cpu`
(for the tests) uploads to the CPU.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import torch

from osm_renderer_tpu_torch.tools.kdevice import REPO_ROOT, device_name


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--bin", default=os.path.join(REPO_ROOT, "assets", "fixtures", "minicity.bin"))
    ap.add_argument("--stylesheet",
                    default=os.path.join(REPO_ROOT, "assets", "stylesheets", "default.mapcss"))
    ap.add_argument("--style-type", default=None, help="josm|mapsme")
    ap.add_argument("--device", default="cuda", help="cuda, cuda:N, or cpu")
    args = ap.parse_args(argv)

    from osm_renderer_tpu_torch import perfstats
    from osm_renderer_tpu_torch.core.tile import Tile
    from osm_renderer_tpu_torch.draw.labels.labeler import Labeler
    from osm_renderer_tpu_torch.draw.native_assembler import assemble_tile_chunks_native
    from osm_renderer_tpu_torch.geodata.reader import GeodataReader
    from osm_renderer_tpu_torch.mapcss.parser import parse_file
    from osm_renderer_tpu_torch.mapcss.styler import Styler
    from osm_renderer_tpu_torch.parallel.renderer import BatchRenderer
    from osm_renderer_tpu_torch.utils.torch_setup import resolve_device

    device = resolve_device(args.device)
    reader = GeodataReader.load(args.bin)
    base, name = os.path.split(args.stylesheet)
    stype = args.style_type or ("mapsme" if "osmosnimki" in name else "josm")

    tx = reader.tiles["x"] >> 3
    ty = reader.tiles["y"] >> 3
    tiles = [Tile(15, x, y) for x, y in sorted(set(zip(tx.tolist(), ty.tolist())))]
    n = len(tiles)

    def renderer(styler):
        return BatchRenderer(styler, chunk_cache_tiles=256, arena=True, stylesheet_dir=base,
                             device=device)

    stats = perfstats.PerfStats()
    wall = 0.0
    prep_cold = 0.0
    for _ in range(args.reps):
        # Fresh styler, renderer and labeler a rep: cold style cache,
        # cold chunk cache, cold profile and pattern tables, no layers.
        styler = Styler(parse_file(base, name), stype)
        profiles, patterns = renderer(styler)._tables_for(1)
        labeler = Labeler(icon_base_path=base)
        t0 = time.perf_counter()
        for t in tiles:
            perfstats.start_tile(t.zoom)
            with perfstats.measure("Fetch entities"):
                ents = reader.get_entities_in_tile_with_neighbors(t)
            with perfstats.measure("Assemble"):
                assemble_tile_chunks_native(ents, t, 1.0, styler, profiles, patterns, 256)
            with perfstats.measure("Place labels"):
                labeler.ensure_layer(ents, t, 1.0, styler, 256)
            perfstats.finish_tile(stats)
        wall += time.perf_counter() - t0
        # The batch's remainder (a fresh renderer; the styler's cache is
        # warm from the walk above): assembly, arena insert, packed
        # upload.  One throwaway prepare first: first-touch costs are
        # once a process, not a tile.
        dev2 = renderer(styler)
        te = [(reader.get_entities_in_tile_with_neighbors(t), t) for t in tiles]
        dev2.prepare(te, scale=1)
        dev2.cache_clear()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        dev2.prepare(te, scale=1)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        prep_cold += time.perf_counter() - t0

    root = stats.by_zoom[15]
    count = stats.tile_counts[15]
    print(f"cold assembly, {count} tile renders ({args.reps} reps x {n} tiles; "
          f"prepare on {device_name(device)})")
    print(f"  total wall        {1e3 * wall / count:8.3f} ms/tile")
    print(f"  full cold prepare {1e3 * prep_cold / count:8.3f} ms/tile "
          f"(warm style cache; + arena insert and packed upload)")

    def walk(node, depth):
        for ch in node.children.values():
            print(f"  {'  ' * depth}{ch.name:<18}{1e3 * ch.total / count:8.3f} "
                  f"ms/tile ({100.0 * ch.total / root.total:.1f}%)")
            walk(ch, depth + 1)

    walk(root, 0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
