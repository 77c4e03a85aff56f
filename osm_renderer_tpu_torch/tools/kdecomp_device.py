"""The render kernel's device time split by chunk kind.

Counterpart of `tools/kdecomp_device.py`.  The same variants of one
batch, each with every chunk of the other kinds turned into padding
(the kind is data, so every variant runs the same kernel), each timed by
`kdevice.device_ms_per_call` through `ops.render_cuda.render_batch_planar`:

    full         the batch as it is
    floor_only   every chunk padding and every work item -1: the fixed
                 cost (launch, tile clear, finalize)
    fills_only   fills (KIND_FILL)
    spans_only   stroke tent lanes (KIND_STROKE_SPAN)
    items_only   stroke work items (KIND_STROKE_SOLID, KIND_STROKE_DASH)
    seg_only     per-segment strokes (KIND_STROKE)
    layers_only  host layers (KIND_LAYER)

`full` must render byte-identical to the unmodified batch; the tool
raises, and exits non-zero, otherwise.

    python -m osm_renderer_tpu_torch.tools.kdecomp_device [--reps 8] [--zoom 15] \\
        [--geodata assets/fixtures/bigcity.bin] [--device cuda]

On the card by default; `--device cpu` (for the tests) runs the plain
twin and reports CPU operator time, which is not a device time.
"""

from __future__ import annotations

import sys
from typing import Dict, List

import numpy as np
import torch

from osm_renderer_tpu_torch.ops import chunk_layout as L
from osm_renderer_tpu_torch.tools.kdevice import (
    STYLESHEET_DIR,
    device_ms_per_call,
    parse_args,
    zoom_tiles_entities,
)

# (name, kinds kept (None: every kind of the batch), work items cleared)
VARIANTS = (
    ("full", None, False),
    ("floor_only", (), True),
    ("fills_only", (L.KIND_FILL,), False),
    ("spans_only", (L.KIND_STROKE_SPAN,), False),
    ("items_only", (L.KIND_STROKE_SOLID, L.KIND_STROKE_DASH), False),
    ("seg_only", (L.KIND_STROKE,), False),
    ("layers_only", (L.KIND_LAYER,), False),
)


def variant_kinds(kind0: np.ndarray):
    """[(name, kind array, items cleared)] for the batch's chunk kinds
    `kind0`: each chunk of a kind the variant does not keep becomes
    KIND_PAD."""
    out = []
    for name, keep, no_items in VARIANTS:
        keep = np.unique(kind0) if keep is None else np.asarray(keep, kind0.dtype)
        kind = kind0.copy()
        kind[~np.isin(kind, keep) & (kind != L.KIND_PAD)] = L.KIND_PAD
        out.append((name, kind, no_items))
    return out


def decompose(prepared, reps: int) -> List[Dict[str, object]]:
    """Time every variant of a plain-upload PreparedBatch -> one row a
    variant: name, ms per call, its clock ("cuda" or "cpu"), launches
    seen and the live chunks of each kind.  Raises when `full` differs
    from the unmodified batch's render."""
    from osm_renderer_tpu_torch.ops import render_cuda as RC

    b, canvas, ts = prepared.batch, prepared.canvas_rgb, prepared.ts
    device = b.geom.device
    want = RC.render_batch_planar(b, canvas, ts)
    kind0 = b.chunk_i[:, RC.CI_KIND].cpu().numpy()
    rows = []
    for name, kind, no_items in variant_kinds(kind0):
        ci = b.chunk_i.clone()
        ci[:, RC.CI_KIND] = torch.from_numpy(kind).to(device)
        vb = b._replace(chunk_i=ci)
        if no_items:
            vb = vb._replace(items=torch.full_like(b.items, -1))
        if name == "full" and not torch.equal(RC.render_batch_planar(vb, canvas, ts), want):
            raise RuntimeError("the full variant differs from the unmodified batch's render")
        got = device_ms_per_call(lambda: RC.render_batch_planar(vb, canvas, ts), reps,
                                 ("render_kernel",), device)
        kinds, counts = np.unique(kind[kind != L.KIND_PAD], return_counts=True)
        rows.append(dict(name=name, ms=got["ms"], clock=got["clock"],
                         launches=got["launches"],
                         chunks={int(k): int(c) for k, c in zip(kinds, counts)}))
    return rows


def main(argv=None) -> int:
    from osm_renderer_tpu_torch.parallel.renderer import BatchRenderer
    from osm_renderer_tpu_torch.utils.torch_setup import resolve_device

    args = parse_args(argv, "The render kernel's device ms by chunk kind on one batch.")
    device = resolve_device(args.device)
    te, styler = zoom_tiles_entities(args.geodata, args.zoom)
    n = len(te)
    prepared = BatchRenderer(styler, stylesheet_dir=STYLESHEET_DIR, device=device).prepare(te, 1)
    rows = decompose(prepared, args.reps)
    unit = "ms device" if rows[0]["clock"] == "cuda" else "ms of CPU operator time (not device)"
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"z{args.zoom} batch of {n} tiles on {where}, chunks by kind "
          f"{rows[0]['chunks']} (full byte-identical to the unmodified batch)")
    for r in rows:
        print(f"{r['name']:>12}: {r['ms']:9.4f} {unit} ({n / r['ms'] * 1e3:8.0f} t/s), "
              f"live chunks {sum(r['chunks'].values())} {r['chunks']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
