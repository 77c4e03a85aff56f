"""Real-extract-size serving sweep under cache and arena pressure.

Counterpart of `tools/scale_sweep.py`.  Makes (once) a synthetic city of
a real metro extract's size (`tools/make_fixture.py --blocks 112`, then
the port's importer: 12 z12 ... 7,446 z17 tiles), builds a mixed z12-z17
corpus (`sweep_corpus`: 915 tiles at 112 blocks) and serves it through
the port's `TileService` (backend = device: the chunk arena, the render
kernel, the run-length wires, the device label blit with `--labels`)
with a chunk cache far smaller than the corpus on every renderer, so
that eviction, free-list coalescing, arena growth and the generation
guard run on the live path.  Three passes, cold, warm1 and warm2, each
shuffled by `random.Random(0)` and served in `--batch` batches; then
the first `--batch` tiles of the densest zoom (z14) twice in one group,
cold then warm: the warm group holds more chunks than
`BatchRenderer.MAX_BATCH_CHUNKS`, so the server halves it.  (Inside
the three passes a group halves only when it is served whole, i.e. is
nearly all cached, which the small cache makes rare: a group with more
than `COLD_SUB / 2` uncached tiles streams in `COLD_SUB`-tile
sub-batches, which the densest tiles keep far under the bound.)

Checks, each failing the run (exit 1): every response is a PNG; no
renderer's arena leaks a row (`live + free == tail - 1`); warm1 and
warm2 give PNGs of the same sizes (apart from PNG-8 against RGB of the
same pixels, `size_mismatches`).  Prints each pass's tiles/s, the
server's spans a tile (`span_ms`), and the counts of the state
machinery, for each pass and in all: chunk-cache
evictions, `MAX_BATCH_CHUNKS` halvings, tiles served by the C++ oracle
(a tile that alone overflows, or one with icon fills), arena grows,
arena generation bumps (a cache reset, or the plain upload of an
exhausted arena) and batches by path.

    python -m osm_renderer_tpu_torch.tools.scale_sweep [--blocks 112] \\
        [--cache-tiles 160] [--batch 96] [--labels] [--device cuda]

On the card by default; `--device cpu` (for the tests) serves through
the kernels' plain versions.  The fixture goes to
`assets/fixtures/hugecity<blocks>.{osm,bin}` (git-ignored).
"""

from __future__ import annotations

import argparse
import os
import random
import sys
import time
from typing import Dict, List, Tuple

from osm_renderer_tpu_torch.tools.kdevice import REPO_ROOT, STYLESHEET_DIR, device_name

FIXTURE_DIR = os.path.join(REPO_ROOT, "assets", "fixtures")
PASSES = ("cold", "warm1", "warm2")
# Tiles kept a zoom (every tile of an uncapped zoom), as the JAX tool
# takes them: z15 whole, the others thinned by a stride.
ZOOM_CAPS = {12: 16, 13: 32, 14: 128, 16: 128, 17: 128}
DENSE_ZOOM = 14
PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def ensure_fixture(blocks: int) -> str:
    """The city of `blocks` blocks a side, generated and imported on
    first use -> path of its .bin."""
    from osm_renderer_tpu_torch.tools.corpus import build_fixture

    osm = os.path.join(FIXTURE_DIR, f"hugecity{blocks}.osm")
    binf = osm[:-4] + ".bin"
    if not os.path.exists(binf):
        t0 = time.perf_counter()
        build_fixture(osm, binf, blocks)
        print(f"fixture gen and import: {time.perf_counter() - t0:.1f} s")
    return binf


def sweep_corpus(reader) -> Tuple[List[object], Dict[int, int]]:
    """The mixed-zoom corpus of the JAX tool (`tools/scale_sweep.py`):
    for z12-z17 every tile the geodata covers, sorted, and for a capped
    zoom every `len // cap`-th of them up to the cap -> (tiles, tiles a
    zoom)."""
    from osm_renderer_tpu_torch.tools.corpus import zoom_tiles

    tiles, per_zoom = [], {}
    for zoom in (12, 13, 14, 15, 16, 17):
        zt = zoom_tiles(reader, zoom)
        cap = ZOOM_CAPS.get(zoom)
        if cap and len(zt) > cap:
            zt = zt[:: len(zt) // cap][:cap]
        per_zoom[zoom] = len(zt)
        tiles += zt
    return tiles, per_zoom


def counters(svc) -> Dict[str, int]:
    """The service's state-machine counts, summed over its renderers."""
    rs = svc.batch_renderers
    arenas = [r.chunk_arena for r in rs if r.chunk_arena is not None]
    out = {
        "evictions": sum(r.evictions for r in rs),
        "halvings": svc.halvings,
        "oracle_tiles": svc.tiles_served["oracle"],
        "device_tiles": svc.tiles_served["device"],
        "arena_grows": sum(a.grows for a in arenas),
        "generation_bumps": sum(a.generation for a in arenas),
    }
    for k in ("arena", "plain", "v1", "v2", "raw", "labeled_tiles"):
        out[k if k == "labeled_tiles" else f"{k}_batches"] = sum(r.batch_counts[k] for r in rs)
    return out


def arena_states(svc) -> List[Dict[str, int]]:
    """Each renderer's arena: cap, rows live and free, tail, free-list
    length and whether every allocated row is live or free."""
    out = []
    for r in svc.batch_renderers:
        a = r.chunk_arena
        if a is None:
            continue
        live = sum(n for _, n in a._offsets.values())
        free = sum(n for _, n in a._free)
        out.append(dict(cap=a.cap, live=live, free=free, tail=a._tail, freelist=len(a._free),
                        resident=len(a._offsets), no_leak=live + free == a._tail - 1))
    return out


def span_ms(stats) -> Dict[str, float]:
    """The server's top-level spans (`perfstats`; its counts left out),
    ms a tile over every zoom: entities and label placement, prepare
    (cold assembly, arena insert, packed upload), device time, readback,
    compose and encode."""
    n = sum(stats.tile_counts.values())
    out: Dict[str, float] = {}
    for root in stats.by_zoom.values():
        for name, node in root.children.items():
            if node.kind == "span":
                out[name] = out.get(name, 0.0) + 1e3 * node.total / n
    return out


def make_service(binf: str, styler, cache_tiles: int, labels: bool, device: str):
    """The production service with a chunk cache of `cache_tiles` tiles on
    every renderer, set before its first batch."""
    from osm_renderer_tpu_torch.server.http import TileService

    svc = TileService(binf, styler, STYLESHEET_DIR, backend="device", enable_labels=labels,
                      png_level=1, device=device)
    for r in svc.batch_renderers:
        r.chunk_cache_tiles = cache_tiles
    return svc


def serve(svc, tiles, batch: int) -> Tuple[Dict[object, bytes], float]:
    """Serve `tiles` in order in groups of `batch` -> ({tile: PNG}, wall
    seconds).  Raises on a response that is not a PNG."""
    pngs = {}
    t0 = time.perf_counter()
    for s in range(0, len(tiles), batch):
        group = tiles[s: s + batch]
        for t, p in zip(group, svc.render_tiles_device([(t, 1) for t in group])):
            if p[:8] != PNG_SIGNATURE:
                raise AssertionError(f"{t.zoom}/{t.x}/{t.y}: the response is not a PNG")
            pngs[t] = p
    return pngs, time.perf_counter() - t0


def run_sweep(args) -> Dict[str, object]:
    """Fixture, corpus, the three passes and the dense group; prints as it
    goes -> the service, corpus, each pass's PNGs, seconds and counter
    deltas, the arenas, and the warm1/warm2 size mismatches."""
    from osm_renderer_tpu_torch.geodata.reader import GeodataReader
    from osm_renderer_tpu_torch.mapcss.parser import parse_file
    from osm_renderer_tpu_torch.mapcss.styler import Styler
    from osm_renderer_tpu_torch.perfstats import PerfStats
    from osm_renderer_tpu_torch.utils.torch_setup import resolve_device

    device = resolve_device(args.device)
    binf = ensure_fixture(args.blocks)
    reader = GeodataReader.load(binf)
    tiles, per_zoom = sweep_corpus(reader)
    print(f"corpus: {per_zoom} = {len(tiles)} tiles (cache {args.cache_tiles} tiles => "
          f"eviction pressure {len(tiles) / args.cache_tiles:.1f}x)")
    styler = Styler(parse_file(STYLESHEET_DIR, "default.mapcss"), "josm")
    svc = make_service(binf, styler, args.cache_tiles, args.labels, str(device))

    rng = random.Random(0)
    dense = [t for t in tiles if t.zoom == DENSE_ZOOM][: args.batch]
    res = {"svc": svc, "tiles": tiles, "per_zoom": per_zoom, "pngs": {}, "seconds": {},
           "deltas": {}, "spans": {}, "binf": binf, "styler": styler}
    steps = [(name, None) for name in PASSES] + [("dense_cold", dense), ("dense_warm", dense)]
    for name, order in steps:
        if order is None:
            order = list(tiles)
            rng.shuffle(order)
        before = counters(svc)
        svc.perf_stats = PerfStats()
        pngs, dt = serve(svc, order, args.batch)
        after = counters(svc)
        res["pngs"][name], res["seconds"][name] = pngs, dt
        res["deltas"][name] = {k: after[k] - before[k] for k in after}
        res["spans"][name] = span_ms(svc.perf_stats)
        print(f"{name:10s} {len(order)} tiles in {dt:7.2f} s -> {len(order) / dt:7.1f} t/s; "
              + " ".join(f"{k}={v}" for k, v in res["deltas"][name].items()))
        print(f"{'':10s} ms a tile: " + ", ".join(
            f"{k} {v:.3f}" for k, v in res["spans"][name].items()))
    res["counters"] = counters(svc)
    res["arenas"] = arena_states(svc)
    res["sized"], res["mismatches"] = size_mismatches(res["pngs"]["warm1"], res["pngs"]["warm2"])
    for i, a in enumerate(res["arenas"]):
        print(f"arena[{i}]: cap={a['cap']} live={a['live']} free={a['free']} tail={a['tail']} "
              f"freelist={a['freelist']} resident={a['resident']} "
              f"no-leak={'OK' if a['no_leak'] else 'LEAK'}")
    print(f"warm1-vs-warm2 size mismatches: {res['mismatches']} (expect 0); "
          f"{res['sized'] - res['mismatches']} more differ only in PNG colour type, "
          "with equal pixels")
    print("counters: " + " ".join(f"{k}={v}" for k, v in res["counters"].items())
          + f" [{len(svc.batch_renderers)} renderer(s) on {device_name(device)}]")
    return res


def decode_png(png: bytes):
    import io

    import numpy as np
    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(png)).convert("RGB"))


def size_mismatches(a: Dict[object, bytes], b: Dict[object, bytes]) -> Tuple[int, int]:
    """Tiles whose PNGs differ in size between two passes -> (all of
    them, those that count).  A pair whose PNG colour types (IHDR byte
    25) differ and whose pixels are equal does not count: where the
    native encoder is built, a tile ships as PNG-8 from a v2 wire and as
    RGB from a v1 wire or a raw fallback, and which wire a batch takes
    depends on the order of the batches before it."""
    sized = [t for t in a if len(a[t]) != len(b[t])]
    bad = [t for t in sized
           if a[t][25] == b[t][25] or not (decode_png(a[t]) == decode_png(b[t])).all()]
    return len(sized), len(bad)


def failures(res) -> List[str]:
    """The sweep's checks that failed (empty when all hold)."""
    out = [f"arena[{i}] leaks: {a}" for i, a in enumerate(res["arenas"]) if not a["no_leak"]]
    if res["mismatches"]:
        out.append(f"{res['mismatches']} tiles differ in size between warm1 and warm2")
    return out


def parse_args(argv) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="Real-extract-size serving sweep under cache "
                                             "and arena pressure.")
    ap.add_argument("--blocks", type=int, default=112)
    ap.add_argument("--cache-tiles", type=int, default=160,
                    help="chunk-cache tiles a renderer (<< corpus so eviction fires)")
    ap.add_argument("--batch", type=int, default=96)
    ap.add_argument("--labels", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda, cuda:N, or cpu (the plain versions)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    res = run_sweep(parse_args(argv))
    bad = failures(res)
    for msg in bad:
        print(f"FAIL: {msg}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
