"""The dense kernels' work on one batch of `precision = exact`, counted
on the host: what the stroke kernel's warps, the fill kernel's warps
and the blend kernel's strips of `csrc/dense.cu` meet.  No device is
used.

    python -m osm_renderer_tpu_torch.tools.dense_counts [--zoom 15] \\
        [--scale 1] [--tiles N] [--geodata assets/fixtures/bigcity.bin]

One line of counts over the first `--tiles` tiles of `--zoom` (all of
them by default), rendered at `--scale`:

  window_px      the stroke segments' window pixels
  units          the stroke work units (dense_cuda.stroke_units), and
                 `units_empty`, those that keep no pixel
  kept_px        the pixels the stroke kernel's pass 1 keeps: centre
                 distance cd < fmax(sqrt(hw * hw) + 0.5, 1), in f64
  bands          over the units that keep a pixel, T_max + 2 -
                 max(T_min, 0) (at least 0) with T = floor(A / two_mx)
                 over their kept pixels: the table's band range before
                 its clip at hK; and `bands_per_unit`
  groups_per_tile   mean and max of the blend groups a tile
  groups_per_strip  the groups whose window meets a blend warp's strip
                 of BLEND_ROWS x RECT pixels, a strip on average
  fills_by_E     the fill items by edge bucket E, as E:count
  fill_rows, fill_px  the fills' window rows and window pixels
  active_per_row the active (row, edge) pairs a fill window row, mean
                 and `active_per_row_max`
  fill_units     the fill kernel's units (dense_cuda.fill_units) and
                 `rows_per_unit`, their mean rows
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Iterator, Tuple

import numpy as np

from osm_renderer_tpu_torch.ops import dense_cuda as DC
from osm_renderer_tpu_torch.tools.kdevice import REPO_ROOT, zoom_tiles_entities

BLEND_ROWS, RECT = 4, 32  # a blend warp's strip (csrc/dense.cu)


def kept_pixels(arrays, plan) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """For each stroke work unit in order: the pending index of each
    pixel pass 1 keeps, and its band T = floor(A / two_mx) (int64)."""
    st = plan.strokes
    g = np.asarray(arrays.geom)[st[:, 0], st[:, 2]].astype(np.int64)
    p1x, p1y, p2x, p2y = g.T
    dx, dy = np.abs(p2x - p1x), np.abs(p2y - p1y)
    swap = dx > dy
    hw = np.asarray(arrays.chunk_hw)[st[:, 0], st[:, 1]].astype(np.float64)
    lim = np.maximum(np.sqrt(hw * hw) + 0.5, 1.0)
    denom = np.sqrt((dx * dx + dy * dy).astype(np.float64))
    mn0, mx0 = np.where(swap, p1y, p1x), np.where(swap, p1x, p1y)
    mn_d, mx_d = np.where(swap, dy, dx), np.maximum(np.where(swap, dx, dy), 1)
    x_inc, y_inc = np.where(p1x <= p2x, 1, -1), np.where(p1y <= p2y, 1, -1)
    mn_i, mx_i = np.where(swap, y_inc, x_inc), np.where(swap, x_inc, y_inc)
    for code in DC.stroke_units(st).tolist():
        i, uy, ux = code >> 32, (code >> 16) & 0xFFFF, code & 0xFFFF
        y0, x0, h, w, off, pw = st[i, 3:9]
        ys = y0 + uy + np.arange(min(DC.UNIT_SIDE, h - uy))[:, None]
        xs = x0 + ux + np.arange(min(DC.UNIT_SIDE, w - ux))[None, :]
        raw = p2x[i] * p1y[i] - p2y[i] * p1x[i] + (p2y[i] - p1y[i]) * xs - (p2x[i] - p1x[i]) * ys
        keep = np.abs(raw.astype(np.float64)) / denom[i] < lim[i]
        ys, xs = np.broadcast_to(ys, keep.shape)[keep], np.broadcast_to(xs, keep.shape)[keep]
        mn, mx = (ys, xs) if swap[i] else (xs, ys)
        a = (2 * mn_d[i] * (mn - mn0[i]) * mn_i[i] + 2 * mx_d[i] * (mx - mx0[i]) * mx_i[i]
             + mx_d[i] - 1)
        yield off + ys * pw + xs, a // (2 * mx_d[i])


def fill_counts(arrays, plan) -> dict:
    """The fill counts of the module's docstring for one batch."""
    fills = DC.pack_plan(plan, np.asarray(arrays.geom).shape[0]).views()[2].numpy()
    geom = np.asarray(arrays.geom).astype(np.int64)
    G = geom.shape[1]
    h, E = fills[:, 6], fills[:, 10]
    n = np.minimum(fills[:, 3], E)
    rep = np.repeat(np.arange(n.size), n)
    slot = fills[rep, 2] + np.arange(rep.size) - np.repeat(np.cumsum(n) - n, n)
    g = geom[fills[rep, 0], np.minimum(slot, G - 1)]
    # The window rows each edge is active on: (ytop, ybot] within the window.
    y0, y1 = fills[rep, 4], fills[rep, 4] + h[rep] - 1
    lo = np.maximum(np.minimum(g[:, 1], g[:, 3]) + 1, y0)
    hi = np.minimum(np.maximum(g[:, 1], g[:, 3]), y1)
    ok = lo <= hi
    base = (np.cumsum(h) - h)[rep] - y0
    diff = np.zeros(int(h.sum()) + 1, np.int64)
    np.add.at(diff, (base + lo)[ok], 1)
    np.add.at(diff, (base + hi + 1)[ok], -1)
    per_row = np.cumsum(diff)[:-1]
    units = DC.fill_units(fills).size
    buckets, count = np.unique(E, return_counts=True)
    return dict(fills=int(fills.shape[0]),
                fills_by_E=",".join(f"{b}:{c}" for b, c in zip(buckets.tolist(), count.tolist())),
                fill_rows=int(h.sum()), fill_px=int((h * fills[:, 7]).sum()),
                active_per_row=float(per_row.mean()) if per_row.size else 0.0,
                active_per_row_max=int(per_row.max(initial=0)), fill_units=units,
                rows_per_unit=float(h.sum()) / max(units, 1))


def counts(arrays, plan) -> dict:
    """The counts of the module's docstring for one batch."""
    st = plan.strokes
    units = empty = kept = bands = 0
    for idx, t in kept_pixels(arrays, plan):
        units += 1
        kept += idx.size
        if not idx.size:
            empty += 1
            continue
        bands += max(0, int(t.max()) + 2 - max(int(t.min()), 0))
    gr = plan.groups
    per_tile = np.bincount(gr[:, 0], minlength=np.asarray(arrays.geom).shape[0])
    ts = plan.ts
    hits = (((gr[:, 2] + gr[:, 4] - 1) // BLEND_ROWS - gr[:, 2] // BLEND_ROWS + 1)
            * ((gr[:, 3] + gr[:, 5] - 1) // RECT - gr[:, 3] // RECT + 1)).sum()
    strips = per_tile.size * -(-ts // BLEND_ROWS) * -(-ts // RECT)
    return dict(window_px=int((st[:, 5] * st[:, 6]).sum()), units=units, units_empty=empty,
                kept_px=kept, bands=bands, bands_per_unit=bands / max(units - empty, 1),
                groups=int(gr.shape[0]), groups_per_tile=float(per_tile.mean()),
                groups_per_tile_max=int(per_tile.max(initial=0)),
                groups_per_strip=float(hits) / strips, pending=int(plan.pending_size),
                **fill_counts(arrays, plan))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--zoom", type=int, default=15)
    ap.add_argument("--scale", type=int, default=1)
    ap.add_argument("--tiles", type=int, default=0, help="the first N tiles (0: all)")
    ap.add_argument("--geodata",
                    default=os.path.join(REPO_ROOT, "assets", "fixtures", "bigcity.bin"))
    args = ap.parse_args(argv)

    from osm_renderer_tpu_torch.parallel.renderer import BatchRenderer
    from osm_renderer_tpu_torch.tools.kdevice import STYLESHEET_DIR

    te, styler = zoom_tiles_entities(args.geodata, args.zoom)
    te = te[:args.tiles or None]
    prep = BatchRenderer(styler, stylesheet_dir=STYLESHEET_DIR, device="cpu", backend="dense",
                         precision="exact").prepare(te, args.scale)
    arrays = prep.batch._replace(**{f: getattr(prep.batch, f).numpy()
                                    for f in ("geom", "chunk_hw")})
    got = counts(arrays, prep.plan)
    print(f"{len(te)} tiles z{args.zoom} @{args.scale}x: " + " ".join(
        f"{k}={v:.2f}" if isinstance(v, float) else f"{k}={v}" for k, v in got.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
