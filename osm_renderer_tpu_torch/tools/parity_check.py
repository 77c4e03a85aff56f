"""Render tiles through the render kernel and the C++ oracle and report
pixel differences.

Counterpart of `tools/parity_check.py`.  The device side is the port's
`BatchRenderer` (the CUDA render kernel; on `--device cpu`, its plain
twin), the reference the port's `CpuDrawer`.  Tiles the device path
leaves to the oracle (`cpu_fallback_tiles`) are skipped.  For each tile
it prints the largest per-channel difference and the share of pixels
that differ; any difference above 1/255 is a bug and the exit status is
1.  The tiles render in batches of at most `BATCH` tiles, halved while a
batch holds more than `BatchRenderer.MAX_BATCH_CHUNKS` chunks.

    python -m osm_renderer_tpu_torch.tools.parity_check GEODATA.bin STYLESHEET.mapcss Z X Y \\
        [--scale N] [--diff-png out.png] [--device cuda]
    python -m osm_renderer_tpu_torch.tools.parity_check GEODATA.bin STYLESHEET.mapcss --all-z Z \\
        [--scale N] [--device cuda]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

BATCH = 16


def render_split(dev, te, scale: int):
    """[(rendered (T, ts, ts, 3) u8, cpu_fallback_tiles)] in order, a
    batch at a time, halving a batch over MAX_BATCH_CHUNKS."""
    from osm_renderer_tpu_torch.tools.corpus import split_prepare

    out = []
    for s in range(0, len(te), BATCH):
        for prepared, part, _ in split_prepare(dev, te[s: s + BATCH], scale):
            got = dev.render_prepared(prepared).cpu().numpy()
            out.append((got[: len(part)], set(prepared.cpu_fallback_tiles)))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("geodata")
    ap.add_argument("stylesheet")
    ap.add_argument("zxy", nargs="*", type=int, help="Z X Y")
    ap.add_argument("--all-z", type=int, default=None,
                    help="check every tile of the geodata at this zoom")
    ap.add_argument("--scale", type=int, default=1)
    ap.add_argument("--diff-png", default=None)
    ap.add_argument("--device", default="cuda", help="cuda, cuda:N, or cpu (the plain twin)")
    args = ap.parse_args(argv)

    from osm_renderer_tpu_torch.core.tile import Tile
    from osm_renderer_tpu_torch.draw.drawer import CpuDrawer
    from osm_renderer_tpu_torch.geodata.reader import GeodataReader
    from osm_renderer_tpu_torch.mapcss.parser import parse_file
    from osm_renderer_tpu_torch.mapcss.styler import Styler
    from osm_renderer_tpu_torch.parallel.renderer import BatchRenderer
    from osm_renderer_tpu_torch.tools.corpus import zoom_tiles
    from osm_renderer_tpu_torch.tools.kdevice import device_name
    from osm_renderer_tpu_torch.utils.torch_setup import resolve_device

    device = resolve_device(args.device)
    reader = GeodataReader.load(args.geodata)
    base, name = os.path.split(args.stylesheet)
    styler = Styler(parse_file(base, name), "josm")
    cpu = CpuDrawer(stylesheet_dir=base)
    dev = BatchRenderer(styler, stylesheet_dir=base, device=device)

    if args.all_z is not None:
        tiles = zoom_tiles(reader, args.all_z)
    elif len(args.zxy) == 3:
        tiles = [Tile(args.zxy[0], args.zxy[1], args.zxy[2])]
    else:
        ap.error("pass Z X Y or --all-z Z")

    te = [(reader.get_entities_in_tile_with_neighbors(t), t) for t in tiles]
    rendered = [(got[j], j in needs_cpu) for got, needs_cpu in render_split(dev, te, args.scale)
                for j in range(got.shape[0])]

    worst = 0
    status = 0
    for (entities, t), (got, needs_cpu) in zip(te, rendered):
        if needs_cpu:
            print(f"{t.zoom}/{t.x}/{t.y}: CPU-fallback tile (skipped)")
            continue
        want = cpu.draw_to_pixels(entities, t, args.scale, styler)
        diff = np.abs(want.astype(int) - got.astype(int))
        mx = int(diff.max())
        frac = float((diff > 0).mean())
        worst = max(worst, mx)
        flag = "OK" if mx <= 1 else "FAIL"
        if mx > 1:
            status = 1
        print(f"{t.zoom}/{t.x}/{t.y}: max diff {mx}/255, {100 * frac:.3f}% pixels differ  [{flag}]")
        if args.diff_png and mx > 0:
            from PIL import Image

            amp = np.clip(diff.max(axis=-1) * 32, 0, 255).astype(np.uint8)
            Image.fromarray(amp, "L").save(args.diff_png)
            print(f"  diff heatmap -> {args.diff_png}")
    where = "cpu (plain twin)" if device.type == "cpu" else device_name(device)
    print(f"worst: {worst}/255 over {len(te)} tiles on {where} "
          f"({'within' if worst <= 1 else 'EXCEEDS'} the 1/255 parity bound)")
    return status


if __name__ == "__main__":
    sys.exit(main())
