"""Stage timing of the warm serving loop, a batch at a time.

Counterpart of `tools/profile_serving.py`.  Every z15 tile of a city
(the minicity by default) is prepared once cold to fill the chunk cache
and the arena, then served warm `--reps` times, each batch timed by
stage, each stage ending in `torch.cuda.synchronize` so its device work
lands in it:

    prepare   the chunk cache and the packed upload (the arena's row
              index and the per-chunk scalars), or with `--no-arena` the
              chunk arrays concatenated and uploaded
    dispatch  the render kernel and the wire, with the wire's pinned
              copy to the host started (`start_wire_copy`), as the server
              dispatches
    fetch     the wire's host view (`fetch_tile_view`)
    encode    the server's compose and encode: a PNG-8 a tile straight
              from the v2 wire through the port's host codec
              (`draw/png8.py`), or where the tile needs one, an RGB PNG
              of its RGB decoded through the codec

Each rep also runs the plain path on the same view, outside the stages:
the numpy plain decode (`rle_layout.decode_words_numpy`) and
`png_writer.rgb_to_png` for every tile (without libdeflate, the path
such a host served before the port had a codec of its own), first on odd
reps and last on even ones.  Then the arena's packed upload size, or
with `--no-arena` the plain upload split into concat and upload; the
PNG bytes a tile and containers of the last batch on both paths, with
the plain path's median ms; and the wire's device-to-host copy against
its decode.

The stages moved with the port's codec: `fetch` no longer decodes (it
was `fetch_rgb_rle`), and `encode`, which was one RGB PNG a tile,
includes the decode, so neither matches the fetch and png of earlier
runs on its own; their sum does.

    python -m osm_renderer_tpu_torch.tools.profile_serving [--no-arena] [--reps 6] \\
        [--geodata assets/fixtures/minicity.bin] [--device cuda]

On the card by default; `--device cpu` (for the tests) runs the plain
versions, and its times are CPU times.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from osm_renderer_tpu_torch.tools.kdevice import REPO_ROOT, STYLESHEET_DIR, device_name

STAGES = ("prepare", "dispatch", "fetch", "encode", "total")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--no-arena", action="store_true",
                    help="the plain upload (the JAX tool's OSMR_ARENA=0)")
    ap.add_argument("--reps", type=int, default=6)
    ap.add_argument("--geodata",
                    default=os.path.join(REPO_ROOT, "assets", "fixtures", "minicity.bin"))
    ap.add_argument("--device", default="cuda", help="cuda, cuda:N, or cpu (the plain versions)")
    args = ap.parse_args(argv)

    from osm_renderer_tpu_torch.draw.png8 import WRITER
    from osm_renderer_tpu_torch.draw.png_writer import rgb_to_png
    from osm_renderer_tpu_torch.ops.rle_layout import decode_words_numpy
    from osm_renderer_tpu_torch.ops import chunk_layout as L
    from osm_renderer_tpu_torch.ops import render_cuda as RC
    from osm_renderer_tpu_torch.parallel.renderer import BatchRenderer, start_wire_copy
    from osm_renderer_tpu_torch.tools.kdevice import zoom_tiles_entities
    from osm_renderer_tpu_torch.utils.torch_setup import resolve_device

    device = resolve_device(args.device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    te, styler = zoom_tiles_entities(args.geodata, 15)
    tiles = [t for _, t in te]
    n = len(te)
    arena = not args.no_arena
    dev = BatchRenderer(styler, stylesheet_dir=STYLESHEET_DIR, chunk_cache_tiles=256,
                        arena=arena, device=device)
    prepared = dev.prepare(te, scale=1)  # cold: fills the cache
    def encode(view, i):
        png = view.png8(i, 1)
        return ("png8", png) if png is not None else ("rgb", rgb_to_png(view.rgb(i), 1))

    def plain(view):
        """The plain path over every tile -> (decode s, PNG s, PNGs)."""
        t0 = time.perf_counter()
        if view.wire_fmt(0) == "v2":
            packed32, offs, table = view.words
            rgb = [decode_words_numpy(packed32, int(offs[i]), int(offs[i + 1] - offs[i]), table,
                                      view.ts, view.ts) for i in range(n)]
        else:
            rgb = [view.rgb(i) for i in range(n)]
        t1 = time.perf_counter()
        pngs = [rgb_to_png(img, 1) for img in rgb]
        return t1 - t0, time.perf_counter() - t1, pngs

    # The first wire is v1 and teaches the palette; the second is v2,
    # and warms both encodes.
    dev.fetch_rgb_rle(start_wire_copy(dev.render_prepared_rle(prepared)))
    view = dev.fetch_tile_view(start_wire_copy(dev.render_prepared_rle(prepared)))
    [encode(view, i) for i in range(n)]
    plain(view)

    te_none = [(None, t) for t in tiles]
    stages = {k: [] for k in STAGES}
    plain_runs = []
    for rep in range(args.reps):
        sync()
        t0 = time.perf_counter()
        p = dev.prepare(te_none, scale=1)
        sync()
        t1 = time.perf_counter()
        r = start_wire_copy(dev.render_prepared_rle(p))
        sync()
        t2 = time.perf_counter()
        view = dev.fetch_tile_view(r)
        t3 = time.perf_counter()
        if rep % 2:
            plain_runs.append(plain(view))
        t4 = time.perf_counter()
        served = [encode(view, i) for i in range(n)]
        t5 = time.perf_counter()
        if not rep % 2:
            plain_runs.append(plain(view))
        spans = (t1 - t0, t2 - t1, t3 - t2, t5 - t4)
        for k, v in zip(STAGES, spans + (sum(spans),)):
            stages[k].append(v)

    def median(v):
        return sorted(v)[len(v) // 2]

    for k, v in stages.items():
        ms = " ".join(f"{x * 1e3:7.1f}" for x in v)
        print(f"{k:9s} {ms}   median {median(v) * 1e3:7.1f} ms")
    wires = {k: dev.batch_counts[k] for k in ("v1", "v2")}
    print(f"n={n} tiles; median total -> {n / median(stages['total']):.1f} t/s "
          f"(unpipelined) on {device_name(device)}; wires {wires}")

    if not arena:
        # The plain upload's prepare, split: concat against upload.
        profiles, patterns = dev._tables_for(1)
        chunks = [dev._chunk_cache[(t.zoom, t.x, t.y, 1)][0] for t in tiles]
        t0 = time.perf_counter()
        pb = L.concat_pallas_batch(chunks, profiles, 256, patterns)
        t1 = time.perf_counter()
        RC.from_numpy_batch(pb, dev._canvas(), device, n)
        sync()
        t2 = time.perf_counter()
        print(f"concat {1e3 * (t1 - t0):.1f} ms  h2d+wait {1e3 * (t2 - t1):.1f} ms")
        sizes = {f: np.asarray(a).nbytes for f, a in zip(L.PallasBatch._fields, pb)}
        tot = sum(sizes.values())
        print(f"batch bytes: {tot / 1e6:.2f} MB  " + "  ".join(
            f"{k}={v / 1e3:.0f}K" for k, v in sorted(sizes.items(), key=lambda x: -x[1])[:8]))
    else:
        p = dev.prepare(te_none, scale=1)
        print(f"arena packed upload: {p.arena_packed.nbytes / 1e3:.1f} KB "
              f"({p.arena_packed.shape[1]} chunks)")

    # The last batch's PNGs on both paths, and the plain path's medians.
    rgb_pngs = plain_runs[-1][2]
    kinds = {k: sum(kind == k for kind, _ in served) for k in ("png8", "rgb")}
    print(f"encode: png writer {WRITER}; containers {kinds}; "
          f"{sum(len(p) for _, p in served) / n:.0f} B a tile; plain path: "
          f"{view.wire_fmt(0)} decode {1e3 * median([d for d, _, _ in plain_runs]):.1f} ms + "
          f"png_writer RGB PNG {1e3 * median([e for _, e, _ in plain_runs]):.1f} ms a batch "
          f"(medians of {len(plain_runs)}), {sum(map(len, rgb_pngs)) / n:.0f} B a tile")

    # Fetch, split: the wire's copy to the host against the decode.
    r = dev.render_prepared_rle(dev.prepare(te_none, scale=1))
    sync()
    t0 = time.perf_counter()
    wire = r.wire.cpu().numpy()
    t1 = time.perf_counter()
    dev.fetch_rgb_rle(r)
    t2 = time.perf_counter()
    print(f"wire d2h {1e3 * (t1 - t0):.1f} ms ({wire.nbytes / 1e3:.0f} KB)  "
          f"decode(+refetch) {1e3 * (t2 - t1):.1f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
