"""The render kernel's device time without the blend, and by work-item
section.

Counterpart of the variants of `tools/kdecomp.py` that
`kdecomp_device` does not run.  Each is one batch with its data changed,
so every variant runs the same kernel:

    full                 the batch as it is
    steps_only           every chunk padding and `last` zeroed (column
                         CI_LAST of the batch's `chunk_i`), so no
                         primitive is blended: launch, tile clear, chunk
                         walk and finalize
    full_no_blend        every chunk as it is and `last` zeroed: every
                         primitive painted into the pending plane, none
                         blended (no variant of the JAX tool; full minus
                         this is the blends' share, which steps_only,
                         with no primitive left, cannot show)
    items_shallow        the work-item chunks only (KIND_STROKE_SOLID,
                         KIND_STROKE_DASH), with the isec slots from 4 on
                         set to slot 3's end: the steep and dead sections
                         empty
    items_shallow_steep  the work-item chunks only, with the slots from 8
                         on set to slot 7's end: the dead sections empty

`kdecomp_device`'s `floor_only` and `items_only` are the rows to read
these against.  The batch's `isec` is the (C, NSEC) section-end table of
`ops.render_cuda.CudaBatch`, laid out as the TPU batch's.  It also
prints the items of each section over the work-item chunks (shallow:
slot 3, steep16: slots 3-7, dead: slots 7-11), as the JAX tool does.

On the card every variant is held byte for byte against the plain twin
(`render_batch_planar_reference`) on the same inputs before it is timed
with `kdevice.device_ms_per_call`, and `full` against the unmodified
batch; the tool raises, and exits non-zero, on a difference.

    python -m osm_renderer_tpu_torch.tools.kdecomp [--reps 8] [--zoom 15] \\
        [--geodata assets/fixtures/bigcity.bin] [--device cuda]

`--device cpu` (for the tests) runs the twin alone and reports CPU
operator time, which is not a device time.
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
    device_name,
    parse_args,
    zoom_tiles_entities,
)

ITEM_KINDS = (L.KIND_STROKE_SOLID, L.KIND_STROKE_DASH)
VARIANTS = ("full", "steps_only", "full_no_blend", "items_shallow", "items_shallow_steep")


def variant_arrays(kind0: np.ndarray, isec0: np.ndarray, last0: np.ndarray):
    """[(name, kind, isec, last)] for a batch's chunk kinds, section ends
    and last flags, as the JAX tool masks them (full_no_blend is the
    port's own): a chunk of a kind the variant does not keep becomes
    KIND_PAD."""
    def keep_only(keep):
        kind = kind0.copy()
        kind[~np.isin(kind, np.asarray(keep, kind.dtype)) & (kind != L.KIND_PAD)] = L.KIND_PAD
        return kind

    shallow = isec0.copy()
    shallow[:, 4:] = shallow[:, 3:4]
    shallow_steep = isec0.copy()
    shallow_steep[:, 8:] = shallow_steep[:, 7:8]
    return [
        ("full", kind0.copy(), isec0.copy(), last0.copy()),
        ("steps_only", keep_only(()), isec0.copy(), np.zeros_like(last0)),
        ("full_no_blend", kind0.copy(), isec0.copy(), np.zeros_like(last0)),
        ("items_shallow", keep_only(ITEM_KINDS), shallow, last0.copy()),
        ("items_shallow_steep", keep_only(ITEM_KINDS), shallow_steep, last0.copy()),
    ]


def item_counts(kind0: np.ndarray, isec0: np.ndarray) -> Dict[str, int]:
    """Work items of each section over the work-item chunks."""
    s = isec0[np.isin(kind0, ITEM_KINDS)].astype(np.int64)
    return {"shallow": int(s[:, 3].sum()), "steep16": int((s[:, 7] - s[:, 3]).sum()),
            "dead": int((s[:, 11] - s[:, 7]).sum())}


def decompose(prepared, reps: int) -> List[Dict[str, object]]:
    """Check and time every variant of a plain-upload PreparedBatch ->
    one row a variant: name, ms per call, its clock, launches seen and the
    live chunks of each kind.  Raises when a variant's kernel output
    differs from the twin's, or `full` from the unmodified batch."""
    from osm_renderer_tpu_torch.ops import render_cuda as RC

    b, canvas, ts = prepared.batch, prepared.canvas_rgb, prepared.ts
    device = b.geom.device
    want = RC.render_batch_planar(b, canvas, ts)
    ci = b.chunk_i.cpu().numpy()
    rows = []
    for name, kind, isec, last in variant_arrays(ci[:, RC.CI_KIND], b.isec.cpu().numpy(),
                                                 ci[:, RC.CI_LAST]):
        vci = ci.copy()
        vci[:, RC.CI_KIND] = kind
        vci[:, RC.CI_LAST] = last
        vb = b._replace(chunk_i=torch.from_numpy(vci).to(device),
                        isec=torch.from_numpy(np.ascontiguousarray(isec)).to(device))
        got = RC.render_batch_planar(vb, canvas, ts)
        if device.type == "cuda" and not torch.equal(
                got, RC.render_batch_planar_reference(vb, canvas, ts)):
            raise RuntimeError(f"{name}: the render kernel differs from its twin")
        if name == "full" and not torch.equal(got, want):
            raise RuntimeError("the full variant differs from the unmodified batch's render")
        t = device_ms_per_call(lambda: RC.render_batch_planar(vb, canvas, ts), reps,
                               ("render_kernel",), device)
        kinds, counts = np.unique(kind[kind != L.KIND_PAD], return_counts=True)
        rows.append(dict(name=name, ms=t["ms"], clock=t["clock"], launches=t["launches"],
                         chunks={int(k): int(c) for k, c in zip(kinds, counts)}))
    return rows


def main(argv=None) -> int:
    from osm_renderer_tpu_torch.ops import render_cuda as RC
    from osm_renderer_tpu_torch.parallel.renderer import BatchRenderer
    from osm_renderer_tpu_torch.utils.torch_setup import resolve_device

    args = parse_args(argv, "The render kernel's device ms without the blend and by "
                            "work-item section on one batch.")
    device = resolve_device(args.device)
    te, styler = zoom_tiles_entities(args.geodata, args.zoom)
    n = len(te)
    prepared = BatchRenderer(styler, stylesheet_dir=STYLESHEET_DIR, device=device).prepare(te, 1)
    b = prepared.batch
    counts = item_counts(b.chunk_i[:, RC.CI_KIND].cpu().numpy(), b.isec.cpu().numpy())
    rows = decompose(prepared, args.reps)
    cuda = rows[0]["clock"] == "cuda"
    unit = "ms device" if cuda else "ms of CPU operator time (not device)"
    held = "each variant byte-identical to the twin" if cuda else "twin only"
    print(f"z{args.zoom} batch of {n} tiles on {device_name(device)}, {b.chunk_i.shape[0]} chunks; "
          f"items: " + ", ".join(f"{k} {v}" for k, v in counts.items()) + f" ({held})")
    for r in rows:
        print(f"{r['name']:>19}: {r['ms']:9.4f} {unit} ({n / r['ms'] * 1e3:8.0f} t/s), "
              f"{r['launches']} launches in {args.reps} calls, "
              f"live chunks {sum(r['chunks'].values())} {r['chunks']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
