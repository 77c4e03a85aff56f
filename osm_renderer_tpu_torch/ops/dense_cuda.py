"""Dense renderer kernels (`precision = exact` and its fast twin): the
host packing, the CUDA kernels' wrappers and their plain PyTorch
versions.

Counterpart of the JAX package's jitted device program for precision =
exact, `osm_renderer_tpu.ops.render_jnp.render_batch` (it reaches no
Pallas kernel).  The kernels are `csrc/dense.cu`; its design notes and
the places where the bits are at risk are there.  They run the two
phases of `ops/render_dense.py` (the plain version) from the schedule
that `render_dense.plan_batch` builds on the host:

* `pack_plan(plan, n_tiles)` -> `DensePack`: the kernels' arguments as
  one int64 buffer, made on the host before the upload: the stroke
  items with the prefix sums of their window areas, the fill items with
  their edge bucket, the groups in paint order per tile, the stroke
  kernel's work units (each window cut into rectangles of at most
  UNIT_SIDE x UNIT_SIDE pixels, one a warp) and the fill kernel's
  (each window's rows cut into runs of at most `fill_unit_rows(E)`
  rows and FILL_UNIT_PX pixels, one a warp).
* `stroke_alpha`, `fill_alpha`: phase 1, max-reduced into the flat
  pending buffer (`new_pending`); `blend_finalize`: phase 2 and the u8
  finalize -> (T, ts, ts, 3) uint8; `render_batch`: the three.  For
  CUDA tensors each launches its kernel on the current stream (no
  synchronisation) and raises if the build or the launch fails; for CPU
  tensors each runs its plain version.  None falls back from a CUDA
  tensor.
* `render_batch_twin`: the plain versions, on any device: the kernels'
  function computed with PyTorch from the same packed arguments (the
  counted stable rank, the paint-order walk).  The tests hold it byte
  for byte to `render_jnp.render_batch`; the chip smoke run holds the
  kernels to `render_dense.render_batch_plain` on the card and the CPU.
"""

from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from osm_renderer_tpu_torch import perfstats
from osm_renderer_tpu_torch.ops import render_dense as RD
from osm_renderer_tpu_torch.ops.render_cuda import BatchLayoutError, on_cuda

KERNELS = ("dense_stroke_alpha", "dense_fill_alpha", "dense_blend_finalize")
# Kernel launches made by the wrappers (CUDA tensors only), by kernel.
DENSE_KERNEL_LAUNCHES = dict.fromkeys(KERNELS, 0)
_launch_lock = threading.Lock()

# Columns of the packed items; csrc/dense.cu reads them by the same names.
STROKE_COLS = 9  # t c slot y0 x0 h w pend_off pend_w (BatchPlan.strokes)
FILL_COLS = 11   # t c first count y0 x0 h w pend_off pend_w E
GROUP_COLS = 7   # t c y0 x0 h w base (BatchPlan.groups)
# Constants shared with csrc/dense.cu (checked when the library loads).
N_PTRS, N_DIMS = 21, 14
FILL_PAIRS = 256  # a fill warp's list of (row, edge) crossings in shared memory
FILL_MAX_ROWS = 32  # rows a fill unit holds at most
FILL_WARPS = 4
UNIT_SIDE = 32    # a stroke work unit: at most UNIT_SIDE x UNIT_SIDE window pixels
# A unit's band table as the stroke kernel writes it when asked (the
# tests): mode (UNIT_EMPTY, UNIT_TABLE, UNIT_PER_PIXEL), first band,
# bands, lookups it lacked, then 2 * UNIT_SIDE minor coordinates and as
# many rule words.
TABLE_COLS = 4 + 4 * UNIT_SIDE
UNIT_EMPTY, UNIT_TABLE, UNIT_PER_PIXEL = 0, 1, 2
# Fill CTAs: enough to fill the card; fewer when a bucket is wider than
# FILL_PAIRS (its units' lists live in global scratch, a slice of e_max
# entries a warp).
FILL_BLOCKS = 132 * 16
FILL_BLOCKS_SCRATCH = 132 * 2
# Window pixels a fill unit holds at most (a one-row unit may hold more):
# the host's bound on a fill warp's pixel rounds, for wide windows.
FILL_UNIT_PX = 512


class DensePack(NamedTuple):
    """The kernels' packed arguments (int64, one buffer):
    strokes (n_strokes, STROKE_COLS), their window-pixel prefix sums
    (n_strokes + 1), fills (n_fills, FILL_COLS), groups (n_groups,
    GROUP_COLS) sorted by (tile, chunk), each tile's group range
    (n_tiles + 1), the stroke work units (n_units,): item << 32 | row
    << 16 | column of the unit's first pixel in its item's window, and
    the fill units (n_fill_units,): item << 32 | first row << 8 | rows
    of the unit in its item's window.  fill_rows: the fills' window
    rows."""
    buf: torch.Tensor
    ts: int
    precision: str
    n_tiles: int
    n_strokes: int
    stroke_px: int
    n_fills: int
    fill_rows: int
    e_max: int
    n_groups: int
    pending_size: int
    n_units: int
    n_fill_units: int

    def to(self, device) -> "DensePack":
        return self._replace(buf=self.buf.to(device))

    def views(self) -> Tuple[torch.Tensor, ...]:
        """(strokes, stroke_prefix, fills, groups, tile_ptr)."""
        shapes = ((self.n_strokes, STROKE_COLS), (self.n_strokes + 1,),
                  (self.n_fills, FILL_COLS), (self.n_groups, GROUP_COLS),
                  (self.n_tiles + 1,))
        out, at = [], 0
        for shape in shapes:
            n = int(np.prod(shape))
            out.append(self.buf[at:at + n].view(shape))
            at += n
        return tuple(out)

    def units(self) -> torch.Tensor:
        """The stroke work units."""
        end = self.buf.numel() - self.n_fill_units
        return self.buf[end - self.n_units:end]

    def fill_units(self) -> torch.Tensor:
        """The fill units, the buffer's last n_fill_units values."""
        return self.buf[self.buf.numel() - self.n_fill_units:]


def pack_plan(plan: RD.BatchPlan, n_tiles: int) -> DensePack:
    """The kernels' arguments from a host plan -> a DensePack on the CPU
    (`.to(device)` uploads it in one copy)."""
    strokes = np.asarray(plan.strokes, np.int64).reshape(-1, STROKE_COLS)
    spx = strokes[:, 5] * strokes[:, 6]
    fills = [np.concatenate([items, np.full((items.shape[0], 1), E, np.int64)], axis=1)
             for E, items, _ in plan.fills]
    fills = np.concatenate(fills, axis=0) if fills else np.zeros((0, FILL_COLS), np.int64)
    groups = np.asarray(plan.groups, np.int64).reshape(-1, GROUP_COLS)
    # Paint order within a tile: by the chunk each group blends at.
    groups = groups[np.lexsort((groups[:, 1], groups[:, 0]))]
    tile_ptr = np.searchsorted(groups[:, 0], np.arange(n_tiles + 1), "left")
    units = stroke_units(strokes)
    funits = fill_units(fills)
    buf = np.concatenate([
        strokes.ravel(), np.concatenate([[0], np.cumsum(spx)]), fills.ravel(),
        groups.ravel(), tile_ptr, units, funits,
    ]).astype(np.int64)
    return DensePack(torch.from_numpy(buf), plan.ts, plan.precision, int(n_tiles),
                     strokes.shape[0], int(spx.sum()), fills.shape[0], int(fills[:, 6].sum()),
                     int(fills[:, 10].max(initial=0)), groups.shape[0], int(plan.pending_size),
                     units.size, funits.size)


def stroke_units(strokes: np.ndarray) -> np.ndarray:
    """Each stroke item's window (columns 5, 6: h, w) cut into rectangles
    of at most UNIT_SIDE x UNIT_SIDE pixels, row-major within the item,
    items in order -> (n_units,) int64 item << 32 | row << 16 | column."""
    h, w = strokes[:, 5], strokes[:, 6]
    if h.size and max(h.max(), w.max()) > 1 << 16:
        raise BatchLayoutError(f"a stroke window of {h.max()} x {w.max()} px; at most 65536")
    nux = -(-w // UNIT_SIDE)
    count = -(-h // UNIT_SIDE) * nux
    item = np.repeat(np.arange(h.size, dtype=np.int64), count)
    j = np.arange(item.size, dtype=np.int64) - np.repeat(np.cumsum(count) - count, count)
    return (item << 32) | ((j // nux[item] * UNIT_SIDE) << 16) | (j % nux[item] * UNIT_SIDE)


def fill_unit_rows(E: np.ndarray) -> np.ndarray:
    """Rows a fill unit of edge bucket E holds: the most, up to
    FILL_MAX_ROWS, whose R x E crossings fit a warp's FILL_PAIRS with
    every edge active on every row; past FILL_PAIRS, 1 (its list in
    global scratch).  csrc/dense.cu::fill_unit_rows computes the same."""
    E = np.asarray(E, np.int64)
    return np.where(E > FILL_PAIRS, 1, np.minimum(FILL_MAX_ROWS, FILL_PAIRS // np.maximum(E, 1)))


def fill_units(fills: np.ndarray) -> np.ndarray:
    """Each fill item's window rows (column 6: h) cut into runs of at
    most fill_unit_rows(E) rows (column 10: E) and FILL_UNIT_PX pixels
    (column 7: w; one row at least), in order within the item, the items
    of the widest bucket first (their units take the longest) ->
    (n_fill_units,) int64 item << 32 | first row << 8 | rows."""
    h, w, E = fills[:, 6], fills[:, 7], fills[:, 10]
    if E.size and (E.min() < 4 or E.max() > 1 << 16 or (E & (E - 1)).any()):
        raise BatchLayoutError(f"fill buckets {sorted(set(E.tolist()))}: want powers of two "
                               "from 4 to 65536")
    if h.size and h.max() >= 1 << 24:
        raise BatchLayoutError(f"a fill window of {h.max()} rows; at most 2**24 - 1")
    rows = np.clip(FILL_UNIT_PX // np.maximum(w, 1), 1, fill_unit_rows(E))
    count = -(-h // rows)
    order = np.argsort(-E, kind="stable")
    item = np.repeat(order, count[order])
    j = np.arange(item.size, dtype=np.int64) - np.repeat(np.cumsum(count[order]) - count[order],
                                                         count[order])
    r0 = j * rows[item]
    return (item << 32) | (r0 << 8) | np.minimum(rows[item], h[item] - r0)


def new_pending(batch: RD.TileBatch, pack: DensePack) -> torch.Tensor:
    """The zeroed flat pending buffer of `pack`'s plan, on the batch's
    device, in its float dtype."""
    return torch.zeros(pack.pending_size, dtype=batch.chunk_opacity.dtype,
                       device=batch.geom.device)


# ---------------------------------------------------------------------------
# The kernels' wrappers
# ---------------------------------------------------------------------------


def _check(batch: RD.TileBatch, pack: DensePack, pending: torch.Tensor,
           canvas: Optional[torch.Tensor] = None) -> None:
    """Raise BatchLayoutError on anything the kernels do not take."""
    fi, ff = RD._dtypes(pack.precision)
    dev = batch.geom.device
    T, G = batch.geom.shape[:2]
    C = batch.chunk_kind.shape[1]
    want = {
        "geom": (torch.int32, (T, G, 4)), "geom_traveled": (ff, (T, G)),
        "geom_profile": (torch.int32, (T, G)), "chunk_color": (ff, (T, C, 3)),
        "chunk_opacity": (ff, (T, C)), "chunk_hw": (ff, (T, C)),
        "chunk_pat": (torch.int32, (T, C)), "profiles": (ff, None), "profile_total": (ff, None),
        "patterns": (ff, None),
    }
    for name, (dtype, shape) in want.items():
        t = getattr(batch, name)
        if t.device != dev or t.dtype != dtype or not t.is_contiguous():
            raise BatchLayoutError(f"{name}: want a contiguous {dtype} tensor on {dev}, got "
                                   f"{t.dtype} on {t.device}")
        if shape is not None and tuple(t.shape) != shape:
            raise BatchLayoutError(f"{name} has shape {tuple(t.shape)}, want {shape}")
    NP = batch.profiles.shape[0]
    if batch.profiles.dim() != 3 or batch.profiles.shape[2] != 8 or NP < 1 \
            or tuple(batch.profile_total.shape) != (NP,):
        raise BatchLayoutError("profiles must be (NP, DS, 8) with profile_total (NP,), NP >= 1")
    ts = pack.ts
    if batch.patterns.dim() != 4 or batch.patterns.shape[0] < 1 \
            or tuple(batch.patterns.shape[1:]) != (ts, ts, 4):
        raise BatchLayoutError(f"patterns has shape {tuple(batch.patterns.shape)}, want "
                               f"(P, {ts}, {ts}, 4)")
    if T > 65535:  # the blend kernel's grid has a row of blocks a tile
        raise BatchLayoutError(f"{T} tiles in one batch; at most 65535")
    if pack.n_tiles != T or pack.buf.device != dev or pack.buf.dtype != torch.int64:
        raise BatchLayoutError(f"pack for {pack.n_tiles} tiles on {pack.buf.device}, batch of "
                               f"{T} on {dev}")
    if pending.device != dev or pending.dtype != ff or tuple(pending.shape) != (pack.pending_size,):
        raise BatchLayoutError(f"pending must be a ({pack.pending_size},) {ff} tensor on {dev}")
    if canvas is not None and (canvas.device != dev or canvas.dtype != ff
                               or tuple(canvas.shape) != (3,)):
        raise BatchLayoutError(f"canvas must be a (3,) {ff} tensor on {dev}")


def kernel_arguments(batch, pack, pending, *, canvas=None, out=None, scratch=None,
                     fill_blocks: int = 0, tables=None):
    """csrc/dense.cu's (ptrs, dims) arrays for these tensors (ctypes).
    `tables`: a zeroed (n_units, TABLE_COLS) int64 tensor the stroke
    kernel fills with each unit's band table (the tests'; None in the
    wrappers)."""
    strokes, _, fills, groups, tile_ptr = pack.views()
    b = batch
    ptrs = [b.geom, b.geom_traveled, b.geom_profile, b.chunk_color, b.chunk_opacity,
            b.chunk_hw, b.chunk_pat, b.profiles, b.profile_total, b.patterns, canvas,
            strokes, fills, pack.fill_units(), groups, tile_ptr, pending, out, scratch,
            pack.units(), tables]
    ptr_arr = (ctypes.c_void_p * N_PTRS)(*[t.data_ptr() if t is not None and t.numel() else None
                                           for t in ptrs])
    dims = [b.geom.shape[0], b.geom.shape[1], b.chunk_kind.shape[1], b.profiles.shape[0],
            b.profiles.shape[1], b.patterns.shape[0], pack.ts, pack.n_strokes, pack.n_fills,
            pack.n_fill_units, pack.e_max, pack.n_groups, fill_blocks, pack.n_units]
    return ptr_arr, (ctypes.c_int64 * N_DIMS)(*dims)


def _launch(name: str, batch, pack, pending, *, chain: Optional[bool] = None, **tensors) -> None:
    """One call into csrc/dense.cu on the current stream of the batch's
    device; raises on a failed build or launch.  `tensors`: the keyword
    arguments of `kernel_arguments`."""
    from osm_renderer_tpu_torch.ops.build import dense_library

    lib = dense_library()
    dev = batch.geom.device
    ptr_arr, dim_arr = kernel_arguments(batch, pack, pending, **tensors)
    exact = int(pack.precision == "exact")
    current = torch.cuda.current_stream(dev)
    stream = (current.cuda_stream, *perfstats.launch_events(current))
    fn = getattr(lib, f"osmr_{name}")
    with torch.cuda.device(dev):
        if chain is None:
            rc = fn(ptr_arr, dim_arr, exact, *stream)
        else:
            rc = fn(ptr_arr, dim_arr, exact, int(chain), *stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed with cudaError_t {rc}")
    with _launch_lock:
        DENSE_KERNEL_LAUNCHES[name] += 1


def kernel_attributes(precision: str) -> dict:
    """{kernel: {regs, local_bytes, shared_bytes, blocks_per_sm}} of the
    built kernels in `precision` (cudaFuncGetAttributes and the
    occupancy calculator; local bytes are spills).  Needs a card."""
    from osm_renderer_tpu_torch.ops.build import dense_library

    out = (ctypes.c_int64 * (4 * len(KERNELS)))()
    rc = dense_library().osmr_dense_kernel_attrs(int(precision == "exact"), out)
    if rc != 0:
        raise RuntimeError(f"cudaFuncGetAttributes failed with cudaError_t {rc}")
    keys = ("regs", "local_bytes", "shared_bytes", "blocks_per_sm")
    return {k: dict(zip(keys, out[4 * i:4 * i + 4])) for i, k in enumerate(KERNELS)}


def stroke_alpha(batch: RD.TileBatch, pack: DensePack, pending: torch.Tensor,
                 chain: bool) -> None:
    """Phase 1 for the stroke segments: each segment's alpha over its
    window, max-reduced into `pending` in place."""
    _check(batch, pack, pending)
    if not on_cuda(pending, "stroke_alpha"):
        stroke_alpha_plain(batch, pack, pending, chain)
    elif pack.n_strokes:
        _launch("dense_stroke_alpha", batch, pack, pending, chain=chain)


def fill_alpha(batch: RD.TileBatch, pack: DensePack, pending: torch.Tensor) -> None:
    """Phase 1 for the fills: each fill's alpha over its window,
    max-reduced into `pending` in place."""
    _check(batch, pack, pending)
    if not on_cuda(pending, "fill_alpha"):
        fill_alpha_plain(batch, pack, pending)
    elif pack.n_fill_units:
        blocks = FILL_BLOCKS if pack.e_max <= FILL_PAIRS else FILL_BLOCKS_SCRATCH
        blocks = min(blocks, -(-pack.n_fill_units // FILL_WARPS))
        _launch("dense_fill_alpha", batch, pack, pending, fill_blocks=blocks,
                scratch=fill_scratch(pack, blocks, pending.device))


def fill_scratch(pack: DensePack, blocks: int, device) -> Optional[torch.Tensor]:
    """The fill kernel's global lists when a bucket is wider than
    FILL_PAIRS (e_max entries of a, b and a 16-bit tag a warp), else
    None."""
    if pack.e_max <= FILL_PAIRS:
        return None
    isz = 8 if pack.precision == "exact" else 4
    return torch.empty(blocks * FILL_WARPS * pack.e_max * (2 * isz + 2), dtype=torch.uint8,
                       device=device)


def blend_finalize(batch: RD.TileBatch, canvas: torch.Tensor, pack: DensePack,
                   pending: torch.Tensor) -> torch.Tensor:
    """Phase 2: every group's src-over in paint order, then the u8
    finalize -> (T, ts, ts, 3) uint8."""
    _check(batch, pack, pending, canvas)
    if not on_cuda(pending, "blend_finalize"):
        return blend_finalize_plain(batch, canvas, pack, pending)
    out = torch.empty((pack.n_tiles, pack.ts, pack.ts, 3), dtype=torch.uint8,
                      device=pending.device)
    if pack.n_tiles:
        _launch("dense_blend_finalize", batch, pack, pending, canvas=canvas, out=out)
    return out


def render_batch(batch: RD.TileBatch, canvas: torch.Tensor, pack: DensePack,
                 chain: bool) -> torch.Tensor:
    """Both phases -> (T, ts, ts, 3) uint8 on the batch's device: the
    three kernels for CUDA tensors, their plain versions for CPU ones."""
    pending = new_pending(batch, pack)
    stroke_alpha(batch, pack, pending, chain)
    fill_alpha(batch, pack, pending)
    return blend_finalize(batch, canvas, pack, pending)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def _budget(device: torch.device) -> int:
    return RD.PIXEL_BUDGET["cuda" if device.type == "cuda" else "cpu"]


def stroke_alpha_plain(batch: RD.TileBatch, pack: DensePack, pending: torch.Tensor,
                       chain: bool) -> None:
    """`stroke_alpha`'s function: one evaluation a window pixel, the item
    found in the prefix sums, in passes of the pixel budget."""
    fi, ff = RD._dtypes(pack.precision)
    dev = pending.device
    strokes, prefix = pack.views()[:2]
    NP = batch.profiles.shape[0]
    step = _budget(dev)
    for i0 in range(0, pack.stroke_px, step):
        idx = torch.arange(i0, min(i0 + step, pack.stroke_px), device=dev)
        item = torch.searchsorted(prefix, idx, right=True) - 1
        it = strokes[item]
        local = idx - prefix[item]
        ly = torch.div(local, it[:, 6], rounding_mode="floor")
        y, x = it[:, 3] + ly, it[:, 4] + (local - ly * it[:, 6])
        t, c, slot = it[:, 0], it[:, 1], it[:, 2]
        seg = batch.geom[t, slot].to(fi)
        pidx = batch.geom_profile[t, slot].long().clamp(0, NP - 1)
        alpha = RD._stroke_segment_alpha(
            seg[:, 0], seg[:, 1], seg[:, 2], seg[:, 3], batch.chunk_hw[t, c],
            batch.chunk_opacity[t, c], batch.profiles[pidx], batch.profile_total[pidx],
            batch.geom_traveled[t, slot], x.to(fi), y.to(fi), fi, ff, chain)
        pending.scatter_reduce_(0, it[:, 7] + y * it[:, 8] + x, alpha, "amax")


def stable_rank_counted(keys: torch.Tensor) -> torch.Tensor:
    """The stable argsort rank along the last axis, by counting: the
    entries with a smaller key, or the same key and a lower index."""
    n = keys.shape[-1]
    j = torch.arange(n, device=keys.device)
    ki, kj = keys[..., :, None], keys[..., None, :]
    return ((kj < ki) | ((kj == ki) & (j[None, :] < j[:, None]))).sum(dim=-1)


def fill_alpha_plain(batch: RD.TileBatch, pack: DensePack, pending: torch.Tensor) -> None:
    """`fill_alpha`'s function: per window row, every lane's crossing and
    its counted stable rank; then every pixel of the row."""
    fi, ff = RD._dtypes(pack.precision)
    dev = pending.device
    fills = pack.views()[2]
    G = batch.geom.shape[1]
    big = torch.full((), RD.FILL_RANK_BIG[fi], dtype=fi, device=dev)
    for E in torch.unique(fills[:, 10]).tolist():
        items = fills[fills[:, 10] == E]
        lanes = torch.arange(E, device=dev)
        rcount = items[:, 6]
        nrows = int(rcount.sum())
        ritem = torch.repeat_interleave(torch.arange(items.shape[0], device=dev), rcount,
                                        output_size=nrows)
        rrow = items[ritem, 4] + torch.arange(nrows, device=dev) - (torch.cumsum(rcount, 0)
                                                                  - rcount)[ritem]
        step = max(1, _budget(dev) // (E * E))
        for r0 in range(0, nrows, step):
            it, y = items[ritem[r0:r0 + step]], rrow[r0:r0 + step]
            e = batch.geom[it[:, 0:1], (it[:, 2:3] + lanes).clamp(max=G - 1)].to(fi)
            a, b, act = RD._fill_crossings(e[..., 0], e[..., 1], e[..., 2], e[..., 3],
                                           lanes < it[:, 3:4], y.to(fi)[:, None], fi, ff)
            odd = act & ((stable_rank_counted(torch.where(act, a, big)) & 1) == 1)
            nact = act.sum(dim=-1, dtype=torch.int32)
            w = it[:, 7]
            npx = int(w.sum())
            prow = torch.repeat_interleave(torch.arange(it.shape[0], device=dev), w,
                                           output_size=npx)
            x = it[prow, 5] + torch.arange(npx, device=dev) - (torch.cumsum(w, 0) - w)[prow]
            alpha = RD._fill_pixels(a[prow], b[prow], act[prow], odd[prow], nact[prow],
                                    x.to(fi)[:, None], batch.chunk_opacity[it[prow, 0],
                                                                           it[prow, 1]])
            pending.scatter_reduce_(0, it[prow, 8] + y[prow] * it[prow, 9] + x, alpha, "amax")


def blend_finalize_plain(batch: RD.TileBatch, canvas: torch.Tensor, pack: DensePack,
                         pending: torch.Tensor) -> torch.Tensor:
    """`blend_finalize`'s function: each tile's groups one after another
    in paint order, each over its window."""
    ts, T = pack.ts, pack.n_tiles
    dev = pending.device
    C = torch.cat([canvas.expand(T, ts, ts, 3),
                   torch.ones((T, ts, ts, 1), dtype=canvas.dtype, device=dev)], dim=-1)
    groups = pack.views()[3]
    npat = batch.patterns.shape[0]
    pats = batch.chunk_pat[groups[:, 0], groups[:, 1]].tolist()
    for (t, c, y0, x0, h, w, base), pat in zip(groups.tolist(), pats):
        m = pending[base:base + h * w].view(h, w, 1)
        win = C[t, y0:y0 + h, x0:x0 + w]
        if pat >= 0:
            new = RD._pattern_blend(batch.patterns[min(pat, npat - 1), y0:y0 + h, x0:x0 + w],
                                    m, win)
        else:
            new = RD._color_blend(batch.chunk_color[t, c].expand(h, w, 3), m, win)
        C[t, y0:y0 + h, x0:x0 + w] = new
    return RD._finalize_rgb(C)


def render_batch_twin(batch: RD.TileBatch, canvas: torch.Tensor, pack: DensePack,
                      chain: bool) -> torch.Tensor:
    """The kernels' plain version, on any device -> (T, ts, ts, 3) uint8."""
    pending = new_pending(batch, pack)
    stroke_alpha_plain(batch, pack, pending, chain)
    fill_alpha_plain(batch, pack, pending)
    return blend_finalize_plain(batch, canvas, pack, pending)
