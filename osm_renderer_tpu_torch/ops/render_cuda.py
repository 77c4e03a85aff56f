"""Chunk-stream rasterizer: the CUDA kernel's wrapper and its plain
PyTorch twin.

Counterpart of the device half of `osm_renderer_tpu.ops.render_pallas`
(`_render_body`, `_render_jit`, `render_batch_pallas_planar`, and the
arena entries `_arena_render_jit` and `_arena_render_label_jit`).  The
kernel itself is `csrc/render.cu`; its design notes are there.

* `from_numpy_batch` turns the host layout (a numpy `PallasBatch` from
  `ops.chunk_layout`, the canvas colour, the profile and pattern
  tables) into the port's tensors on a device.
* `render_batch_planar` checks its inputs and launches the kernel for
  CUDA tensors (raising if the launch fails); for CPU tensors it runs
  the twin.  It never falls back from a CUDA tensor.  Given a label
  slab's triples and plane, the kernel's u8 finalize also blends the
  slab's rows over its output; the twin's output goes through
  `parallel.label_slab`'s `expand_ltriples` and `blit_planar`, the
  blend's plain version.
* `render_arena_planar` builds the batch from one packed upload and a
  row gather from the device chunk arena (`parallel.arena`), then
  renders it through `render_batch_planar`;
  `render_arena_planar_labeled` also hands it the device label slab
  (`parallel.label_slab`), so a labeled batch is one kernel launch.
* `render_batch_planar_reference` is the twin: the TPU kernel's f32 /
  int32 formulas, vectorized per chunk over the pixel windows the TPU
  kernel evaluated.  The tests hold it to Pallas interpret mode and to
  the C++ oracle; the chip smoke run holds the kernel to it.
"""

from __future__ import annotations

import threading
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from osm_renderer_tpu_torch import perfstats
from osm_renderer_tpu_torch.ops import chunk_layout as L
from osm_renderer_tpu_torch.parallel import label_slab as LS

# Kernel launches made by render_batch_planar (CUDA tensors only).
RENDER_KERNEL_LAUNCHES = 0
_launch_lock = threading.Lock()

NCI = 9   # chunk_i columns
CI_KIND, CI_CNT, CI_LAST, CI_Y0, CI_NB, CI_PRIM_Y0, CI_PRIM_NB, CI_PAT, CI_FIRST = range(NCI)
NCF = 5   # chunk_f columns
CF_R, CF_G, CF_B, CF_OPACITY, CF_HW = range(NCF)

_PAINT_KINDS = (
    L.KIND_FILL, L.KIND_FILL_IMAGE, L.KIND_STROKE_SPAN, L.KIND_STROKE,
    L.KIND_STROKE_SOLID, L.KIND_STROKE_DASH,
)


class BatchLayoutError(RuntimeError):
    """A batch the kernel cannot take.  Not a ValueError: the server maps
    ValueError from a batch to its per-tile CPU fallback, and a malformed
    batch must surface instead."""


class CudaBatch(NamedTuple):
    """One render batch on a device (C chunks, T tiles)."""
    geom: torch.Tensor        # (C, 4, CH) i32
    trav: torch.Tensor        # (C, CH) f32
    sprof: torch.Tensor       # (C, CH) i32
    aux: torch.Tensor         # (C, 4, CH) f32
    items: torch.Tensor       # (C, IT) i32
    isec: torch.Tensor        # (C, NSEC) i32
    chunk_i: torch.Tensor     # (C, NCI) i32: kind cnt last y0 nb prim_y0 prim_nb pat first
    chunk_f: torch.Tensor     # (C, NCF) f32: r g b opacity hw
    profiles: torch.Tensor    # (NP, DS, 8) f32
    prof_total: torch.Tensor  # (NP,) f32
    patterns: torch.Tensor    # (NPat, 4, ts, ts) f32 premultiplied
    tile_range: torch.Tensor  # (T, 2) i32 [begin, end) chunk range per tile


def from_numpy_batch(
    pb: L.PallasBatch, canvas_rgb, device, n_tiles: Optional[int] = None,
    patterns: Optional[torch.Tensor] = None,
) -> Tuple[CudaBatch, torch.Tensor]:
    """Host layout -> (CudaBatch, canvas (3,) f32) on `device`.

    `patterns`, when given, is an already-resident pattern tensor used
    instead of `pb.patterns` (the renderer uploads the table once per
    version)."""
    tile_id = np.asarray(pb.tile_id)
    T = int(n_tiles) if n_tiles is not None else int(tile_id.max()) + 1
    if np.any(np.diff(tile_id) < 0):
        raise BatchLayoutError("tile_id must be non-decreasing (tiles' chunks contiguous)")
    tiles = np.arange(T)
    tile_range = np.stack(
        [np.searchsorted(tile_id, tiles, "left"), np.searchsorted(tile_id, tiles, "right")],
        axis=1,
    ).astype(np.int32)
    chunk_i = np.stack(
        [pb.kind, pb.cnt, pb.last, pb.y0, pb.nb, pb.prim_y0, pb.prim_nb, pb.pat, pb.first],
        axis=1,
    ).astype(np.int32)
    chunk_f = np.concatenate(
        [np.asarray(pb.color, np.float32),
         np.asarray(pb.opacity, np.float32)[:, None],
         np.asarray(pb.hw, np.float32)[:, None]],
        axis=1,
    )
    n_prof = pb.profiles.shape[0]
    n_pat = (patterns if patterns is not None else pb.patterns).shape[0]
    if chunk_i[:, CI_PAT].max(initial=-1) >= n_pat:
        raise BatchLayoutError("chunk pattern index out of range of the pattern table")
    if np.asarray(pb.seg_prof).max(initial=0) >= n_prof or np.asarray(pb.seg_prof).min(initial=0) < 0:
        raise BatchLayoutError("segment profile index out of range of the profile table")

    def up(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(device)

    C = chunk_i.shape[0]
    batch = CudaBatch(
        geom=up(pb.geom, np.int32),
        trav=up(np.asarray(pb.traveled).reshape(C, L.CH), np.float32),
        sprof=up(np.asarray(pb.seg_prof).reshape(C, L.CH), np.int32),
        aux=up(pb.seg_aux, np.float32),
        items=up(np.asarray(pb.items).reshape(C, -1), np.int32),
        isec=up(pb.isec, np.int32),
        chunk_i=up(chunk_i, np.int32),
        chunk_f=up(chunk_f, np.float32),
        profiles=up(pb.profiles, np.float32),
        prof_total=up(pb.profile_total, np.float32),
        patterns=patterns if patterns is not None else up(pb.patterns, np.float32),
        tile_range=up(tile_range, np.int32),
    )
    return batch, up(np.asarray(canvas_rgb, np.float32).reshape(3), np.float32)


def _check(b: CudaBatch, canvas: torch.Tensor, ts: int, rows: Optional[torch.Tensor],
           label_tri: Optional[torch.Tensor] = None,
           label_plane: Optional[torch.Tensor] = None) -> None:
    dev = b.geom.device
    C = b.chunk_i.shape[0]
    R = C if rows is None else b.geom.shape[0]
    want = {
        "geom": (torch.int32, (R, 4, L.CH)),
        "trav": (torch.float32, (R, L.CH)),
        "sprof": (torch.int32, (R, L.CH)),
        "aux": (torch.float32, (R, 4, L.CH)),
        "items": (torch.int32, None),
        "isec": (torch.int32, (C, L.NSEC)),
        "chunk_i": (torch.int32, (C, NCI)),
        "chunk_f": (torch.float32, (C, NCF)),
        "profiles": (torch.float32, None),
        "prof_total": (torch.float32, None),
        "patterns": (torch.float32, None),
        "tile_range": (torch.int32, None),
    }
    for name, (dtype, shape) in want.items():
        t = getattr(b, name)
        if t.device != dev:
            raise BatchLayoutError(f"{name} is on {t.device}, geom on {dev}")
        if t.dtype != dtype:
            raise BatchLayoutError(f"{name} has dtype {t.dtype}, want {dtype}")
        if not t.is_contiguous():
            raise BatchLayoutError(f"{name} is not contiguous")
        if shape is not None and tuple(t.shape) != shape:
            raise BatchLayoutError(f"{name} has shape {tuple(t.shape)}, want {shape}")
    if b.items.dim() != 2 or b.items.shape[0] != R:
        raise BatchLayoutError(f"items has shape {tuple(b.items.shape)}, want ({R}, IT)")
    if rows is not None and (rows.device != dev or rows.dtype != torch.int32
                             or tuple(rows.shape) != (C,) or not rows.is_contiguous()):
        raise BatchLayoutError(f"rows must be a contiguous ({C},) int32 tensor on {dev}")
    # The kernel stages lanes with 16-byte asynchronous copies.
    if any(t.data_ptr() % 16 for t in (b.geom, b.trav, b.sprof, b.aux)):
        raise BatchLayoutError("geom, trav, sprof and aux must start on 16-byte boundaries")
    NP = b.profiles.shape[0]
    if tuple(b.profiles.shape) != (NP, L.DS, 8) or tuple(b.prof_total.shape) != (NP,) or NP < 1:
        raise BatchLayoutError("profiles must be (NP, DS, 8) with prof_total (NP,), NP >= 1")
    if b.patterns.dim() != 4 or b.patterns.shape[0] < 1 or tuple(b.patterns.shape[1:]) != (4, ts, ts):
        raise BatchLayoutError(f"patterns has shape {tuple(b.patterns.shape)}, want (P, 4, {ts}, {ts})")
    if b.tile_range.dim() != 2 or b.tile_range.shape[1] != 2 or not 1 <= b.tile_range.shape[0] <= 65535:
        raise BatchLayoutError(f"tile_range has shape {tuple(b.tile_range.shape)}, want (T, 2)")
    if canvas.device != dev or canvas.dtype != torch.float32 or tuple(canvas.shape) != (3,):
        raise BatchLayoutError("canvas must be a (3,) float32 tensor on the batch's device")
    if ts % 128 or not 128 <= ts <= 1024:
        raise BatchLayoutError(f"tile size {ts} must be a multiple of 128 in [128, 1024]")
    if (label_tri is None) != (label_plane is None):
        raise BatchLayoutError("label_tri and label_plane go together")
    if label_tri is not None:
        T = b.tile_range.shape[0]
        if (label_tri.device != dev or label_tri.dtype != torch.int32
                or tuple(label_tri.shape) != (T, 3) or not label_tri.is_contiguous()):
            raise BatchLayoutError(f"label_tri must be a contiguous ({T}, 3) int32 tensor on {dev}")
        if (label_plane.device != dev or label_plane.dtype != torch.int32
                or label_plane.dim() != 3 or tuple(label_plane.shape[1:]) != (2, ts)
                or label_plane.shape[0] < 1 or not label_plane.is_contiguous()):
            raise BatchLayoutError(f"label_plane must be a contiguous (cap, 2, {ts}) int32 "
                                   f"tensor on {dev}")


def render_batch_planar(
    b: CudaBatch, canvas: torch.Tensor, ts: int, rows: Optional[torch.Tensor] = None,
    label_tri: Optional[torch.Tensor] = None, label_plane: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """-> (T, 4, ts, ts) uint8 planar (channel 3 is 255 padding).

    `rows`, when given, is the (C,) i32 row of each chunk in `b.geom`,
    `trav`, `sprof`, `aux` and `items` (the chunk arena's tensors); the
    caller guarantees every row is in range.  `label_tri` and
    `label_plane`, when given, are a label slab's (T, 3) i32 (off, y0, n)
    triples and its (cap, 2, ts) i32 plane: the output's rows y0 .. y0 +
    n - 1 of each tile take the blend of slab rows off .. off + n - 1
    (`label_slab.blit_planar`); the caller guarantees every triple lies
    in the tile and the plane.  CUDA tensors launch the kernel on the
    current stream (no synchronisation), which reads the rows through
    the index and blends the labels in its finalize; CPU tensors gather
    the rows with `index_select`, run the plain twin and then the
    blend's plain version."""
    _check(b, canvas, ts, rows, label_tri, label_plane)
    if on_cuda(b.geom, "render_batch_planar"):
        return _launch(b, canvas, ts, rows, label_tri, label_plane)
    if rows is not None:
        idx = rows.long()
        b = b._replace(**{name: getattr(b, name).index_select(0, idx)
                          for name in ("geom", "trav", "sprof", "aux", "items")})
    out = render_batch_planar_reference(b, canvas, ts)
    if label_tri is not None:
        out = LS.blit_planar(out, label_plane, LS.expand_ltriples(label_tri, ts))
    return out


def on_cuda(t: torch.Tensor, what: str) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises otherwise."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise BatchLayoutError(f"{what}: unsupported device {t.device}")
    return True


def _launch(b: CudaBatch, canvas: torch.Tensor, ts: int, rows: Optional[torch.Tensor],
            label_tri: Optional[torch.Tensor], label_plane: Optional[torch.Tensor]
            ) -> torch.Tensor:
    """One launch of csrc/render.cu on the current stream of the batch's
    device -> the (T, 4, ts, ts) u8 output; raises on a failed build or
    launch.  Nothing runs on the device after the launch."""
    global RENDER_KERNEL_LAUNCHES
    from osm_renderer_tpu_torch.ops.build import render_library

    lib = render_library()
    dev = b.geom.device
    T = b.tile_range.shape[0]
    out = torch.empty((T, 4, ts, ts), dtype=torch.uint8, device=dev)
    ptr = lambda t: t.data_ptr() if t is not None else None
    current = torch.cuda.current_stream(dev)
    with torch.cuda.device(dev):
        rc = lib.osmr_render_planar(
            b.geom.data_ptr(), b.trav.data_ptr(), b.sprof.data_ptr(), b.aux.data_ptr(),
            b.items.data_ptr(), b.items.shape[1], ptr(rows), b.isec.data_ptr(),
            b.chunk_i.data_ptr(), b.chunk_f.data_ptr(), b.profiles.data_ptr(),
            b.prof_total.data_ptr(), b.patterns.data_ptr(), canvas.data_ptr(),
            b.tile_range.data_ptr(), ptr(label_tri), ptr(label_plane),
            label_plane.shape[0] if label_plane is not None else 0, out.data_ptr(), T, ts,
            current.cuda_stream, *perfstats.launch_events(current),
        )
    if rc != 0:
        raise RuntimeError(f"render kernel launch failed with cudaError_t {rc}")
    with _launch_lock:
        RENDER_KERNEL_LAUNCHES += 1
    return out


def render_arena_planar(
    packed: np.ndarray, arena, prof_rows: torch.Tensor, prof_total: torch.Tensor,
    patterns: torch.Tensor, canvas: torch.Tensor, ts: int, n_tiles: int,
) -> torch.Tensor:
    """-> (T, 4, ts, ts) u8 planar, assembled on the arena's device.

    Counterpart of `render_pallas._arena_render_jit`.  `packed` is the
    host (N_SMALL, C) buffer of `chunk_layout.pack_small_arena`; it and
    the tiles' chunk ranges, derived here from its tile lane, are the
    batch's only upload (one copy).  The profile, pattern and canvas
    tensors are already resident.  The render kernel reads the arena's
    rows through lane 15, the batch's row index, where the JAX package
    gathered them in XLA outside its kernel."""
    batch, rows, _ = arena_batch(packed, arena, prof_rows, prof_total, patterns, n_tiles)
    return render_batch_planar(batch, canvas, ts, rows=rows)


def render_arena_planar_labeled(
    packed: np.ndarray, label_rows: np.ndarray, arena, prof_rows: torch.Tensor,
    prof_total: torch.Tensor, patterns: torch.Tensor, canvas: torch.Tensor, ts: int,
    n_tiles: int, label_plane: torch.Tensor,
) -> torch.Tensor:
    """`render_arena_planar` with the device label slab blended in.

    Counterpart of `render_pallas._arena_render_label_jit`.  `label_rows`
    is the (T, 3) i32 (off, y0, n) slab-row map of
    `LabelSlab.ltriples`; it rides appended to the packed buffer in the
    batch's one upload, and the render kernel's finalize blends the slab
    plane's rows over its output (on the CPU: the twin, then
    `parallel.label_slab.expand_ltriples` and `blit_planar`)."""
    tri = np.ascontiguousarray(label_rows, dtype=np.int32)
    if tri.shape != (n_tiles, 3):
        raise BatchLayoutError(f"label_rows has shape {tri.shape}, want ({n_tiles}, 3)")
    off, y0, n = tri.T
    # off, y0 and n >= 0, y0 + n <= ts, off + n <= the plane's rows.
    if n_tiles and (tri.min() < 0 or (y0 + n).max() > ts
                    or (off + n).max() > label_plane.shape[0]):
        raise BatchLayoutError("label_rows out of range of the tile or the slab plane")
    batch, rows, up_tri = arena_batch(packed, arena, prof_rows, prof_total, patterns, n_tiles,
                                      tri)
    return render_batch_planar(batch, canvas, ts, rows=rows, label_tri=up_tri,
                               label_plane=label_plane)


def arena_batch(
    packed: np.ndarray, arena, prof_rows, prof_total, patterns, n_tiles: int,
    label_tri: Optional[np.ndarray] = None,
) -> Tuple[CudaBatch, torch.Tensor, Optional[torch.Tensor]]:
    """The arena entry's batch from its one upload -> (CudaBatch over the
    arena's tensors, the (C,) row index, the (T, 3) label triples on the
    device or None).  A labeled batch's `label_tri` rides in the same
    upload, behind the tiles' chunk ranges."""
    packed = np.ascontiguousarray(packed, dtype=np.int32)
    if packed.ndim != 2 or packed.shape[0] != L.N_SMALL:
        raise BatchLayoutError(f"packed has shape {packed.shape}, want ({L.N_SMALL}, C)")
    tile_id, rows = packed[0], packed[15]
    if np.any(np.diff(tile_id) < 0):
        raise BatchLayoutError("tile_id must be non-decreasing (tiles' chunks contiguous)")
    if rows.min(initial=0) < 0 or rows.max(initial=0) >= arena.cap:
        raise BatchLayoutError("arena row index out of range of the arena")
    if packed[9].max(initial=-1) >= patterns.shape[0]:
        raise BatchLayoutError("chunk pattern index out of range of the pattern table")
    tiles = np.arange(n_tiles)
    tile_range = np.stack(
        [np.searchsorted(tile_id, tiles, "left"), np.searchsorted(tile_id, tiles, "right")],
        axis=1,
    ).astype(np.int32)
    N, C = packed.shape
    tail = [] if label_tri is None else [label_tri.reshape(-1)]
    up = torch.from_numpy(np.concatenate([packed.reshape(-1), tile_range.reshape(-1), *tail]))
    up = up.to(arena.geom.device)
    pk = up[: N * C].view(N, C)
    batch = CudaBatch(
        geom=arena.geom, trav=arena.trav, sprof=arena.sprof, aux=arena.aux, items=arena.items,
        isec=pk[16:].T.contiguous(),
        # lanes: 2 kind 3 cnt 4 last 5 y0 6 nb 7 prim_y0 8 prim_nb 9 pat 1 first
        chunk_i=pk[[2, 3, 4, 5, 6, 7, 8, 9, 1]].T.contiguous(),
        # lanes 10-12 colour, 13 opacity, 14 hw: f32 bits
        chunk_f=pk[10:15].T.contiguous().view(torch.float32),
        profiles=prof_rows, prof_total=prof_total, patterns=patterns,
        tile_range=up[N * C : N * C + 2 * n_tiles].view(n_tiles, 2),
    )
    up_tri = None if label_tri is None else up[N * C + 2 * n_tiles :].view(n_tiles, 3)
    return batch, pk[15], up_tri


# ---------------------------------------------------------------------------
# Plain PyTorch twin
# ---------------------------------------------------------------------------

_I32 = torch.int32
_F32 = torch.float32
_BLOCK_ELEMS = 1 << 18   # pixel evaluations per vectorized step


def _fdiv(a, b):
    return torch.div(a, b, rounding_mode="floor")


def _i32(v, ref):
    return torch.as_tensor(v, dtype=_I32, device=ref.device)


class _Consts:
    def __init__(self, device):
        f = lambda v: torch.tensor(v, dtype=_F32, device=device)
        self.zero, self.one, self.inf = f(0.0), f(1.0), f(np.inf)
        self.big = f(np.float32(1e30))
        self.inv255 = f(np.float32(1.0 / 255.0))


def _feather(K: _Consts, cd, hlw):
    ff = torch.fmax(hlw - 0.5, K.zero)
    ft = torch.fmax(hlw + 0.5, K.one)
    om = torch.fmin(2.0 * hlw, K.one)
    v = torch.where(cd < ff, K.one, torch.where(cd < ft, (ft - cd) / (ft - ff), K.zero))
    return om * v


def _seg_table(g: torch.Tensor, aux: torch.Tensor, trav: torch.Tensor,
               sprof: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Per-lane segment scalars of one chunk (the kernel's Seg)."""
    p1x, p1y, p2x, p2y = g[0], g[1], g[2], g[3]
    dxs = (p2x - p1x).abs()
    dys = (p2y - p1y).abs()
    swap = dxs > dys
    one = _i32(1, g)
    x_inc = torch.where(p1x <= p2x, one, -one)
    y_inc = torch.where(p1y <= p2y, one, -one)
    mn_d = torch.where(swap, dys, dxs)
    mx_d = torch.clamp_min(torch.where(swap, dxs, dys), 1)
    return {
        "p1x": p1x, "p1y": p1y, "p2x": p2x, "p2y": p2y, "swap": swap,
        "mn0": torch.where(swap, p1y, p1x), "mx0": torch.where(swap, p1x, p1y),
        "mn_d": mn_d, "mx_d": mx_d,
        "mn_i": torch.where(swap, y_inc, x_inc), "mx_i": torch.where(swap, x_inc, y_inc),
        "two_mn": 2 * mn_d, "two_mx": 2 * mx_d,
        "nc": p2x * p1y - p2y * p1x, "sdx": p2x - p1x, "sdy": p2y - p1y,
        "inv": aux[0], "ratio": aux[1], "hK": aux[2].to(_I32),
        "trav": trav, "pidx": sprof.long(),
    }


def _take(S: Dict[str, torch.Tensor], idx) -> Dict[str, torch.Tensor]:
    return {k: v[idx] for k, v in S.items()}


class _Pix:
    """Pixel evaluations: segment scalars gathered per element plus the
    pixel's (x, y) and its dash-profile rows."""

    def __init__(self, S, x, y, prof, ptot):
        self.S, self.x, self.y, self.prof, self.ptot = S, x, y, prof, ptot

    def take(self, idx):
        return _Pix(_take(self.S, idx), self.x[idx], self.y[idx],
                    None if self.prof is None else self.prof[idx],
                    None if self.ptot is None else self.ptot[idx])


def _dash_dist(trav, sd, ptot):
    dist = trav + sd
    return torch.where(ptot > 0.0, dist - torch.floor(dist / ptot) * ptot, dist)


def _stroke_opacity(K, P: _Pix, hw, cd, sd):
    """Per-segment path opacity with the round-cap half-width shrink."""
    dist = _dash_dist(P.S["trav"], sd, P.ptot)
    sd_op = torch.zeros_like(cd)
    cap = torch.full_like(cd, np.inf)
    any_rows = torch.zeros_like(cd, dtype=torch.bool)
    for i in range(L.DS):
        s_from, s_to, e_from, e_to, mul, has_orig, oa, ob = P.prof[:, i, :].unbind(1)
        in_range = (dist >= s_from) & (dist <= e_to)
        basev = torch.where(
            dist <= s_to, (dist - s_from) / (s_to - s_from),
            torch.where(dist < e_from, K.one, (e_to - dist) / (e_to - e_from)),
        )
        sd_op = torch.fmax(sd_op, torch.where(in_range, mul * basev, K.zero))
        cap_d = torch.where(dist < oa, oa - dist, torch.where(dist <= ob, K.zero, dist - ob))
        cap = torch.fmin(cap, torch.where(in_range & (has_orig > 0.0), cap_d, K.inf))
        any_rows = any_rows | (s_from < K.inf)
    sd_op = torch.where(any_rows, sd_op, K.one)
    cap = torch.where(torch.isinf(cap), K.zero, cap)
    hlw = torch.sqrt(hw * hw - cap * cap)
    cd_op = _feather(K, cd, hlw)
    return torch.fmin(sd_op, cd_op), cd_op > 0.0


def _start_xy(S, s_mn, s_mx):
    return torch.where(S["swap"], s_mx, s_mn), torch.where(S["swap"], s_mn, s_mx)


def _alive_dash(K, P: _Pix, hw, s_mn, s_mx):
    S = P.S
    sx, sy = _start_xy(S, s_mn, s_mx)
    cd = (S["nc"] + S["sdy"] * sx - S["sdx"] * sy).to(_F32).abs() * S["inv"]
    sd = ((sx - S["p1x"]) * S["sdx"] + (sy - S["p1y"]) * S["sdy"]).to(_F32).abs() * S["inv"]
    return _stroke_opacity(K, P, hw, cd, sd)[1]


def _alive_solid(S, hw, s_mn, s_mx, feather_to, om_pos):
    sx, sy = _start_xy(S, s_mn, s_mx)
    cd = (S["nc"] + S["sdy"] * sx - S["sdx"] * sy).to(_F32).abs() * S["inv"]
    return (cd < feather_to) & om_pos


def _step_up(S, st):
    k, c, rc, g, rg = st
    rc = rc + S["two_mn"]
    carry = rc >= S["two_mx"]
    rc = torch.where(carry, rc - S["two_mx"], rc)
    rg2 = torch.where(carry, rg + S["two_mn"], rg)
    gcarry = rg2 >= S["two_mx"]
    rg2 = torch.where(gcarry, rg2 - S["two_mx"], rg2)
    return (k + 1, torch.where(carry, c + 1, c), rc,
            torch.where(carry & gcarry, g + 1, g), torch.where(carry, rg2, rg))


def _step_down(S, st):
    k, c, rc, g, rg = st
    rc = rc - S["two_mn"]
    borrow = rc < 0
    rc = torch.where(borrow, rc + S["two_mx"], rc)
    rg2 = torch.where(borrow, rg - S["two_mn"], rg)
    gborrow = rg2 < 0
    rg2 = torch.where(gborrow, rg2 + S["two_mx"], rg2)
    return (k - 1, torch.where(borrow, c - 1, c), rc,
            torch.where(borrow & gborrow, g - 1, g), torch.where(borrow, rg2, rg))


def _select(mask, new, old):
    return tuple(torch.where(mask, n, o) for n, o in zip(new, old))


def _invert(S, bc):
    K = S["mx_d"]
    k = torch.minimum(torch.clamp_min((bc.to(_F32) * S["ratio"]).to(_I32), 0), K)
    uc = S["two_mn"] * k + S["mx_d"] - 1
    c = _fdiv(uc, S["two_mx"])
    ug = S["two_mn"] * c + S["mx_d"] - 1
    g = _fdiv(ug, S["two_mx"])
    st = (k, c, uc - c * S["two_mx"], g, ug - g * S["two_mx"])
    st = _select((st[0] > 0) & (st[0] + st[3] > bc), _step_down(S, st), st)
    nxt = _step_up(S, st)
    return _select((st[0] < K) & (nxt[0] + nxt[3] <= bc), nxt, st)


def _next_owner(S, st, T):
    """Band T+1's owner start (c_sel2, k2) for band-edge pixels."""
    bc2 = torch.minimum(torch.clamp_min(T + 1, 0), S["hK"])
    nxt = _step_up(S, st)
    take2 = (st[0] < S["mx_d"]) & (nxt[0] + nxt[3] <= bc2)
    k2 = torch.where(take2, nxt[0], st[0])
    c2 = torch.where(take2, nxt[1], st[1])
    g2 = torch.where(take2, nxt[3], st[3])
    return torch.where((k2 + g2) != bc2, c2 + 1, c2), k2


def _bands(S, x, y):
    MN = torch.where(S["swap"], y, x)
    MX = torch.where(S["swap"], x, y)
    n0 = (MN - S["mn0"]) * S["mn_i"]
    m0 = (MX - S["mx0"]) * S["mx_i"]
    A = S["two_mn"] * n0 + S["two_mx"] * m0 + (S["mx_d"] - 1)
    T = _fdiv(A, S["two_mx"])
    edge = (A - T * S["two_mx"]) == (S["two_mx"] - 1)
    return MN, n0, A, T, edge


def _chain_alive(K, P: _Pix, hw, s_mn, s_mx, c_sel, mul, jv):
    S = P.S
    tcm = 2 * c_sel * S["mn_d"]
    G = torch.clamp_min(_fdiv(tcm - S["mx_d"] + S["two_mx"] - 1, S["two_mx"]), 0)
    e0 = mul * (tcm - S["two_mx"] * G)
    ok = jv < (1 << 30)
    for jp in range(1, 12):
        Cjp = torch.clamp_min(
            _fdiv(e0 + 2 * jp * S["mn_d"] - S["mx_d"] + S["two_mx"] - 1, S["two_mx"]), 0
        )
        minor = s_mn + mul * S["mn_i"] * jp
        major = s_mx - mul * S["mx_i"] * Cjp
        ok = ok & (_alive_dash(K, P, hw, minor, major) | (jp >= jv))
    return ok


def _segment_alpha(K, P: _Pix, chain_on, hw, opacity):
    """KIND_STROKE pixels (the TPU kernel's per-segment _general_impl)."""
    S, x, y = P.S, P.x, P.y
    cd = (S["nc"] + S["sdy"] * x - S["sdx"] * y).to(_F32).abs() * S["inv"]
    sd = ((x - S["p1x"]) * S["sdx"] + (y - S["p1y"]) * S["sdy"]).to(_F32).abs() * S["inv"]
    op, in_line = _stroke_opacity(K, P, hw, cd, sd)
    alpha = torch.zeros_like(cd)
    keep = in_line.nonzero().squeeze(1)
    if keep.numel() == 0:
        return alpha
    P, op, chain_on = P.take(keep), op[keep], chain_on[keep]
    S = P.S
    MN, _, A, T, edge = _bands(S, P.x, P.y)
    bc = torch.minimum(torch.clamp_min(T, 0), S["hK"])
    st = _invert(S, bc)
    c_sel = torch.where((st[0] + st[3]) != bc, st[1] + 1, st[1])
    s_mn_T = S["mn0"] + S["mn_i"] * c_sel
    s_mx_T = S["mx0"] + S["mx_i"] * st[0]
    dn_T = (MN - s_mn_T) * S["mn_i"]
    ok_T = (A >= 0) & (T <= S["hK"]) & _alive_dash(K, P, hw, s_mn_T, s_mx_T)
    sel = (ok_T & chain_on).nonzero().squeeze(1)
    if sel.numel():
        one = _i32(1, dn_T)
        ok_T[sel] = _chain_alive(
            K, P.take(sel), hw, s_mn_T[sel], s_mx_T[sel], c_sel[sel],
            torch.where(dn_T[sel] >= 0, one, -one), dn_T[sel].abs(),
        )
    visited = ok_T & (~edge | (dn_T >= 0))
    c_sel2, k2 = _next_owner(S, st, T)
    s_mn_N = S["mn0"] + S["mn_i"] * c_sel2
    s_mx_N = S["mx0"] + S["mx_i"] * k2
    dn_N = (MN - s_mn_N) * S["mn_i"]
    cand = edge & ~visited & (A + 1 >= 0) & (T + 1 <= S["hK"]) & (dn_N <= 0)
    ok_N = torch.zeros_like(cand)
    sel = cand.nonzero().squeeze(1)
    if sel.numel():
        Pn = P.take(sel)
        ok = _alive_dash(K, Pn, hw, s_mn_N[sel], s_mx_N[sel])
        chain_sel = chain_on[sel]
        if bool(chain_sel.any()):
            ok = ok & (~chain_sel | _chain_alive(
                K, Pn, hw, s_mn_N[sel], s_mx_N[sel], c_sel2[sel], -_i32(1, dn_N), -dn_N[sel],
            ))
        ok_N[sel] = ok
    alpha[keep] = torch.where(visited | ok_N, opacity * op, K.zero)
    return alpha


def _item_alpha(K, P: _Pix, dead: bool, dashed: bool, hw, opacity):
    """KIND_STROKE_SOLID / KIND_STROKE_DASH pixels (eval_group)."""
    S, x, y = P.S, P.x, P.y
    cd = (S["sdy"] * x + (S["nc"] - S["sdx"] * y)).to(_F32).abs() * S["inv"]
    op = _feather(K, cd, hw)
    in_line = op > 0.0
    op_emit = op
    if dashed:
        sd = ((x - S["p1x"]) * S["sdx"] + (y - S["p1y"]) * S["sdy"]).to(_F32).abs() * S["inv"]
        dist = _dash_dist(S["trav"], sd, P.ptot)
        sd_op = torch.zeros_like(cd)
        any_rows = torch.zeros_like(cd, dtype=torch.bool)
        for i in range(L.DS):
            s_from, s_to, e_from, e_to, mul = P.prof[:, i, :5].unbind(1)
            in_range = (dist >= s_from) & (dist <= e_to)
            basev = torch.where(
                dist <= s_to, (dist - s_from) / (s_to - s_from),
                torch.where(dist < e_from, K.one, (e_to - dist) / (e_to - e_from)),
            )
            sd_op = torch.fmax(sd_op, torch.where(in_range, mul * basev, K.zero))
            any_rows = any_rows | (s_from < K.big)
        op_emit = torch.fmin(torch.where(any_rows, sd_op, K.one), op)
    MN, n0, A, T, edge = _bands(S, x, y)
    hK = S["hK"]
    in_slab = (A >= 0) & (T <= hK)
    if not dead:
        ok_edge = (in_slab & (T < hK)) | ((T == hK) & (n0 >= S["mn_d"])) | ((A == -1) & (n0 <= 0))
        mask = torch.where(edge, ok_edge, in_slab)
    else:
        feather_to = torch.fmax(hw + 0.5, K.one)
        om_pos = torch.fmin(2.0 * hw, K.one) > 0.0
        bc = torch.minimum(torch.clamp_min(T, 0), hK)
        st = _invert(S, bc)
        c_sel = torch.where((st[0] + st[3]) != bc, st[1] + 1, st[1])
        s_mn_T = S["mn0"] + S["mn_i"] * c_sel
        s_mx_T = S["mx0"] + S["mx_i"] * st[0]
        dn_T = (MN - s_mn_T) * S["mn_i"]
        ok_T = in_slab & _alive_solid(S, hw, s_mn_T, s_mx_T, feather_to, om_pos)
        c_sel2, k2 = _next_owner(S, st, T)
        s_mn_N = S["mn0"] + S["mn_i"] * c_sel2
        s_mx_N = S["mx0"] + S["mx_i"] * k2
        dn_N = (MN - s_mn_N) * S["mn_i"]
        ok_N = (edge & (A + 1 >= 0) & (T + 1 <= hK) & (dn_N <= 0)
                & _alive_solid(S, hw, s_mn_N, s_mx_N, feather_to, om_pos))
        mask = (ok_T & (~edge | (dn_T >= 0))) | ok_N
    return torch.where(in_line & mask, opacity * op_emit, K.zero)


def _window_pixels(sidx: np.ndarray, r0: np.ndarray, c0: np.ndarray, rows: int, cols: int,
                   device):
    """Flat (segment, x, y) for windows [r0, r0+rows) x [c0, c0+cols)."""
    dr = np.arange(rows, dtype=np.int32)
    dc = np.arange(cols, dtype=np.int32)
    n = sidx.shape[0]
    ys = np.broadcast_to((r0.astype(np.int32)[:, None, None] + dr[None, :, None]), (n, rows, cols))
    xs = np.broadcast_to((c0.astype(np.int32)[:, None, None] + dc[None, None, :]), (n, rows, cols))
    ss = np.broadcast_to(sidx.astype(np.int64)[:, None, None], (n, rows, cols))
    t = lambda a, d: torch.from_numpy(np.ascontiguousarray(a).reshape(-1)).to(device=device, dtype=d)
    return t(ss, torch.int64), t(xs, _I32), t(ys, _I32)


def _paint_windows(K, pending, ts, S_all, prof_all, ptot_all, sidx, x, y, evaluate):
    """Evaluate `evaluate(_Pix)` over the elements and fmax the alphas
    into `pending` (scatter-max; alphas are finite and >= 0)."""
    flat = pending.view(-1)
    for s in range(0, sidx.shape[0], _BLOCK_ELEMS):
        e = slice(s, s + _BLOCK_ELEMS)
        si = sidx[e]
        pidx = S_all["pidx"][si]
        P = _Pix(_take(S_all, si), x[e], y[e], prof_all[pidx], ptot_all[pidx])
        alpha = evaluate(P)
        idx = (P.y.long() * ts + P.x.long())
        flat.scatter_reduce_(0, idx, alpha, reduce="amax")


def _stroke_chunk(K, b, gh, ch, pending, ts, hw_h, hw, opacity, cnt):
    """KIND_STROKE: every segment over its 32-row blocks x 128-column halves."""
    m = int(np.ceil(hw_h)) + 2
    sg_l, r0_l, c0_l = [], [], []
    for sg in range(cnt):
        p1x, p1y, p2x, p2y = (int(v) for v in gh[:, sg])
        ylo = max(min(p1y, p2y) - m, 0)
        yhi = min(max(p1y, p2y) + m, ts - 1)
        blk0 = ylo // L.RB
        nbs = 0 if (p1x == p2x and p1y == p2y) else (yhi - blk0 * L.RB) // L.RB + 1
        sxlo, sxhi = min(p1x, p2x) - m, max(p1x, p2x) + m
        for bb in range(max(nbs, 0)):
            for h in range(ts // 128):
                if sxlo < h * 128 + 128 and sxhi >= h * 128:
                    sg_l.append(sg)
                    r0_l.append((blk0 + bb) * L.RB)
                    c0_l.append(h * 128)
    if not sg_l:
        return
    S = _seg_table(b.geom[ch], b.aux[ch], b.trav[ch], b.sprof[ch])
    prof = b.profiles
    any_orig = ((prof[:, :, 0] < K.big) & (prof[:, :, 5] > 0.0)).any(dim=1)
    S["chain_on"] = any_orig[S["pidx"]]
    sidx, x, y = _window_pixels(np.asarray(sg_l), np.asarray(r0_l), np.asarray(c0_l),
                                L.RB, 128, pending.device)

    def evaluate(P):
        return _segment_alpha(K, P, P.S["chain_on"], hw, opacity)

    _paint_windows(K, pending, ts, S, prof, b.prof_total, sidx, x, y, evaluate)


def _items_chunk(K, b, ih, sec, ch, pending, ts, hw, opacity, dashed):
    """KIND_STROKE_SOLID / KIND_STROKE_DASH: each work item over the
    window its section gives it."""
    S = _seg_table(b.geom[ch], b.aux[ch], b.trav[ch], b.sprof[ch])
    for half in range(min(ts // 128, 4)):
        for fam in range(3):
            slot = 4 * fam + half
            start = int(sec[slot - 1]) if slot > 0 else 0
            n4 = ((int(sec[slot]) - start) >> 2) << 2
            if n4 <= 0:
                continue
            w = ih[start:start + n4].astype(np.int64)
            sg = w & 127
            rb = (w >> 8) & 63
            if fam == 1:   # steep: 16 x 64, column half from the group position
                j = np.arange(n4) & 3
                sidx, x, y = _window_pixels(sg, rb * L.RB16, half * 128 + 64 * (j >> 1),
                                            L.RB16, 64, pending.device)
            else:
                sidx, x, y = _window_pixels(sg, rb * L.RB_I, np.full(n4, half * 128),
                                            L.RB_I, 128, pending.device)

            def evaluate(P, dead=fam == 2):
                return _item_alpha(K, P, dead, dashed, hw, opacity)

            _paint_windows(K, pending, ts, S, b.profiles, b.prof_total, sidx, x, y, evaluate)


def render_batch_planar_reference(b: CudaBatch, canvas: torch.Tensor, ts: int) -> torch.Tensor:
    """Plain PyTorch twin of the render kernel -> (T, 4, ts, ts) uint8 on
    the batch's device."""
    dev = b.geom.device
    K = _Consts(dev)
    ci = b.chunk_i.cpu().numpy()
    cf = b.chunk_f.cpu().numpy()
    isec = b.isec.cpu().numpy()
    geom_h = b.geom.cpu().numpy()
    items_h = b.items.cpu().numpy()
    rng = b.tile_range.cpu().numpy()
    T = rng.shape[0]
    n_halves = ts // 128
    out = torch.empty((T, 4, ts, ts), dtype=torch.uint8, device=dev)
    canvas = canvas.to(_F32)

    for t in range(T):
        acc = torch.empty((4, ts, ts), dtype=_F32, device=dev)
        pending = torch.zeros((ts, ts), dtype=_F32, device=dev)
        acc[:3] = canvas[:, None, None]
        acc[3] = 1.0
        for ch in range(int(rng[t, 0]), int(rng[t, 1])):
            kind = int(ci[ch, CI_KIND])
            if ci[ch, CI_FIRST] == 1:
                acc[:3] = canvas[:, None, None]
                acc[3] = 1.0
                pending.zero_()
            if kind == L.KIND_PAD:
                continue
            opacity = b.chunk_f[ch, CF_OPACITY]
            hw = b.chunk_f[ch, CF_HW]
            if kind in _PAINT_KINDS and ci[ch, CI_NB] > 0:
                r0 = int(ci[ch, CI_Y0]) * L.RB_F
                r1 = min((int(ci[ch, CI_Y0]) + int(ci[ch, CI_NB])) * L.RB_F, ts)
                colp1 = int(isec[ch, 0])
                c0, c1 = ((colp1 - 1) * 128, colp1 * 128) if 1 <= colp1 <= n_halves else (0, ts)
                ys = torch.arange(r0, r1, device=dev, dtype=_I32)[:, None]
                xs = torch.arange(c0, c1, device=dev, dtype=_I32)[:, None]
                g = b.geom[ch]
                if kind in (L.KIND_FILL, L.KIND_FILL_IMAGE):
                    U = (ys == g[0][None, :]).to(_F32)                          # (R, CH)
                    Wt = ((xs >= g[1][None, :]) & (xs <= g[2][None, :])).to(_F32)  # (W, CH)
                    C = U @ Wt.T
                    alpha = torch.where(C > 0.5, opacity, K.zero)
                    pending[r0:r1, c0:c1] = torch.fmax(pending[r0:r1, c0:c1], alpha)
                elif kind == L.KIND_STROKE_SPAN:
                    a_l, b_l, xc_l = b.aux[ch, 0], b.aux[ch, 1], b.aux[ch, 2]
                    plat255 = opacity * torch.fmin(2.0 * hw, K.one) * 255.0
                    cov = (xs >= g[2][None, :]) & (xs <= g[3][None, :])         # (W, CH)
                    tent = a_l - b_l * torch.abs(xs.to(_F32) - xc_l)
                    M = torch.where(cov, torch.fmax(torch.fmin(tent, plat255), K.zero), K.zero)
                    Mint = torch.floor(M)
                    Mlo = (M - Mint).to(torch.bfloat16).to(_F32)
                    U = ((ys >= g[0][None, :]) & (ys <= g[1][None, :])).to(_F32)
                    alpha = (U @ Mint.T + U @ Mlo.T) * K.inv255
                    pending[r0:r1, c0:c1] = torch.fmax(pending[r0:r1, c0:c1], alpha)
                elif kind == L.KIND_STROKE:
                    _stroke_chunk(K, b, geom_h[ch], ch, pending, ts, float(cf[ch, CF_HW]),
                                  hw, opacity, int(ci[ch, CI_CNT]))
                else:
                    _items_chunk(K, b, items_h[ch], isec[ch], ch, pending, ts, hw, opacity,
                                 kind == L.KIND_STROKE_DASH)
            if ci[ch, CI_LAST] == 1:
                p0 = int(ci[ch, CI_PRIM_Y0]) * L.RB_F
                p1 = min((int(ci[ch, CI_PRIM_Y0]) + int(ci[ch, CI_PRIM_NB])) * L.RB_F, ts)
                pat = int(ci[ch, CI_PAT])
                if p1 <= p0:
                    continue
                rows = slice(p0, p1)
                if pat < 0:
                    a = pending[rows]
                    keep = 1.0 - a
                    for c in range(3):
                        acc[c, rows] = a * b.chunk_f[ch, c] + keep * acc[c, rows]
                    acc[3, rows] = a + keep * acc[3, rows]
                    pending[rows] = 0.0
                elif kind == L.KIND_LAYER:
                    pl = b.patterns[pat, :, rows]
                    keep = 1.0 - pl[3]
                    for c in range(3):
                        acc[c, rows] = pl[c] + keep * acc[c, rows]
                    acc[3, rows] = pl[3] + keep * acc[3, rows]
                else:
                    pl = b.patterns[pat, :, rows]
                    mask = pending[rows]
                    keep = 1.0 - mask * pl[3]
                    for c in range(3):
                        acc[c, rows] = mask * pl[c] + keep * acc[c, rows]
                    acc[3, rows] = mask * pl[3] + keep * acc[3, rows]
                    pending[rows] = 0.0
        a = acc[3]
        mul = torch.where(a == 0.0, K.zero, torch.div(K.one, a))
        for c in range(3):
            v = 255.0 * acc[c] * mul
            v = torch.where(torch.isnan(v), K.zero, torch.clamp(v, 0.0, 255.0))
            out[t, c] = torch.trunc(v).to(_I32).to(torch.uint8)
        out[t, 3] = 255
    return out
