"""Device-resident committed-label-layer slab for warm labeled serving.

Counterpart of `osm_renderer_tpu.parallel.label_slab`, which imports jax
at module level.  The host places each tile's labels once (the port's
`draw.labels.labeler`); the committed layer is then kept on the device,
and warm labeled batches blend it over the render's planar u8 output
instead of compositing on the host: on the card inside the render
kernel's finalize (`ops.render_cuda.render_arena_planar_labeled`), on
the CPU through `expand_ltriples` and `blit_planar`, the blend's plain
version.

Storage: one (cap, 2, ts) i32 plane per tile size.  A label layer's
non-zero-alpha bbox rows occupy consecutive slab rows at full tile
width; per pixel

  plane0 = c_r | c_g << 8 | c_b << 16   (premultiplied colour, u8)
  plane1 = A - 1, A = clamp(round((1 - alpha) * 65536), 1, 65536)

Row 0 is the reserved identity row (plane0 = 0, plane1 = 65535): its
blend passes the base pixel through exactly, so unlabeled rows map to
row 0.  Opaque pixels store c = trunc(rgb255 + 1e-9), the host
composite's value; partial-alpha pixels store c = round(rgb255), so the
blend is at most 1/255 off the host composite (PARITY.md).

The allocator is the original's: first-fit free list with coalescing,
LRU eviction under row pressure (the current batch's keys pinned),
`max_tiles` eviction, `MAX_CAP` and a `generation` bumped on clear.  The
plane is a torch tensor on the renderer's device, updated in place:
`insert` makes one host-to-device upload of the bucketed payload and
writes it with `index_copy_`, and growing allocates the larger plane and
copies the old rows over.  Not thread-safe; callers serialize
(BatchRenderer holds its cache lock).
"""

from __future__ import annotations

from bisect import insort
from collections import OrderedDict
from typing import List, Optional, Tuple

import numpy as np
import torch

from osm_renderer_tpu_torch.utils.torch_setup import resolve_device

IDENTITY_A16P = 65535  # plane1 value whose blend is an exact passthrough


def quantize_compact(compact, ts: int) -> Tuple[np.ndarray, int]:
    """(y0, y1, x0, x1, rgb255 f64, alpha f64) from
    labeler._compact_label_layer -> ((n_rows, 2, ts) i32 slab rows, y0).
    Full tile width; pixels outside [x0, x1) are identity."""
    y0, y1, x0, x1, rgb255, alpha = compact
    n = y1 - y0
    rows = np.empty((n, 2, ts), np.int32)
    rows[:, 0, :] = 0
    rows[:, 1, :] = IDENTITY_A16P
    a = alpha[..., 0]
    opaque = a >= 1.0
    c = np.where(
        opaque[..., None],
        np.trunc(rgb255 + 1e-9),
        np.floor(rgb255 + 0.5),
    )
    c = np.clip(c, 0.0, 255.0).astype(np.int32)
    A = np.floor((1.0 - a) * 65536.0 + 0.5)
    A = np.clip(A, 1.0, 65536.0).astype(np.int32)
    rows[:, 0, x0:x1] = c[..., 0] | (c[..., 1] << 8) | (c[..., 2] << 16)
    rows[:, 1, x0:x1] = A - 1
    return rows, y0


def blit_planar(planar: torch.Tensor, plane: torch.Tensor, lrow: torch.Tensor) -> torch.Tensor:
    """Blend slab rows over a planar u8 render -> a new (T, 4, ts, ts) u8.

    planar: (T, 4, ts, ts) u8 (channel 3 passes through)
    plane:  (cap, 2, ts) i32 label slab
    lrow:   (T, ts) i32 slab row per output row (0 = identity)

    Integer math only: (c * 65536 + A * base) >> 16, at most 33.4M, so
    int32 holds it.  The plain version of the blend in csrc/render.cu's
    finalize, which computes the same int32 math."""
    patch = plane[lrow.long()]               # (T, y, 2, x) i32
    p0 = patch[:, :, 0, :]                   # (T, y, x)
    A = patch[:, :, 1, :] + 1                # [1, 65536]
    c = torch.stack([p0 & 255, (p0 >> 8) & 255, (p0 >> 16) & 255], dim=1)  # (T, 3, y, x)
    base = planar[:, :3].to(torch.int32)
    blended = (c * 65536 + A[:, None] * base) >> 16
    out3 = torch.clamp(blended, max=255).to(torch.uint8)
    return torch.cat([out3, planar[:, 3:]], dim=1)


def expand_ltriples(tri: torch.Tensor, ts: int) -> torch.Tensor:
    """(T, 3) i32 (off, y0, n) -> (T, ts) i32 row map (row 0 = identity
    for rows outside [y0, y0 + n))."""
    off = tri[:, 0:1]
    y0 = tri[:, 1:2]
    n = tri[:, 2:3]
    ys = torch.arange(ts, dtype=torch.int32, device=tri.device)[None, :]
    inside = (ys >= y0) & (ys < y0 + n)
    return torch.where(inside, off + (ys - y0), torch.zeros_like(ys))


class LabelSlab:
    """Slab-allocated device rows of quantized committed label layers."""

    MAX_CAP = 65536  # rows; 2 KB/row at ts=256 -> 128 MB of device memory

    def __init__(self, ts: int, min_cap: int = 1024, device="cuda", max_tiles: int = 4096):
        self.ts = ts
        self.device = resolve_device(device) if isinstance(device, str) else device
        self.min_cap = min_cap
        self.max_tiles = max_tiles
        self.cap = 0
        self.plane: Optional[torch.Tensor] = None  # (cap, 2, ts) i32
        # key -> (row offset, n_rows, y0); LRU order = insertion/touch.
        self._offsets: "OrderedDict[object, Tuple[int, int, int]]" = OrderedDict()
        self._free: List[Tuple[int, int]] = []
        self._tail = 1  # row 0 reserved as the identity row
        self.generation = 0

    # ---------------------------------------------------------- alloc --

    def __contains__(self, key) -> bool:
        return key in self._offsets

    def offset(self, key) -> Tuple[int, int, int]:
        self._offsets.move_to_end(key)
        return self._offsets[key]

    def free(self, key) -> None:
        got = self._offsets.pop(key, None)
        if got is None:
            return
        off, n, _ = got
        insort(self._free, (off, n))
        self._coalesce_at(off)

    def _coalesce_at(self, off: int) -> None:
        i = next((j for j, (o, _) in enumerate(self._free) if o == off), None)
        if i is None:
            return
        if i + 1 < len(self._free):
            o, n = self._free[i]
            o2, n2 = self._free[i + 1]
            if o + n == o2:
                self._free[i : i + 2] = [(o, n + n2)]
        if i > 0:
            o0, n0 = self._free[i - 1]
            o, n = self._free[i]
            if o0 + n0 == o:
                self._free[i - 1 : i + 1] = [(o0, n0 + n)]

    def clear(self) -> None:
        self._offsets.clear()
        self._free = []
        self._tail = 1
        self.generation += 1

    def _alloc(self, n: int) -> Optional[int]:
        for i, (off, fn) in enumerate(self._free):
            if fn >= n:
                if fn == n:
                    del self._free[i]
                else:
                    self._free[i] = (off + n, fn - n)
                return off
        if self.cap and self._tail + n <= self.cap:
            off = self._tail
            self._tail += n
            return off
        return None

    def _alloc_evicting(self, n: int, pinned) -> int:
        """Allocate n rows, LRU-evicting unpinned tiles under pressure.
        Raises MemoryError when eviction can't free enough (callers
        clear + retry, like the chunk arena's overflow path)."""
        while True:
            off = self._alloc(n)
            if off is not None:
                return off
            if self.cap < self.MAX_CAP:
                self._grow(n)
                continue
            victim = next((k for k in self._offsets if k not in pinned), None)
            if victim is None:
                raise MemoryError("label slab exhausted by pinned batch")
            self.free(victim)

    # --------------------------------------------------------- device --

    def _grow(self, need_rows: int) -> None:
        new_cap = max(self.cap * 2 if self.cap else self.min_cap, self.min_cap)
        while new_cap < self._tail + need_rows:
            new_cap *= 2
        new_cap = min(new_cap, self.MAX_CAP)
        if new_cap < self._tail + need_rows:
            raise MemoryError(
                f"label slab would exceed MAX_CAP ({self._tail + need_rows} rows)"
            )
        new = torch.zeros((new_cap, 2, self.ts), dtype=torch.int32, device=self.device)
        new[:, 1, :] = IDENTITY_A16P
        if self.cap:
            new[: self.cap].copy_(self.plane)
        self.plane = new
        self.cap = new_cap

    def insert(self, pairs) -> None:
        """Insert [(key, compact)]: ONE host-to-device upload for all of
        them.  Keys already resident are touched (LRU), not re-uploaded."""
        pinned = set(k for k, _ in pairs)
        deduped = []
        seen = set()
        for k, c in pairs:
            if k in self._offsets:
                self._offsets.move_to_end(k)
                continue
            if k in seen:
                continue
            seen.add(k)
            deduped.append((k, c))
        if not deduped:
            return
        quantized = [(k, quantize_compact(c, self.ts)) for k, c in deduped]
        rows_total = sum(q.shape[0] for _, (q, _) in quantized)
        offs = []
        for k, (q, y0) in quantized:
            n = q.shape[0]
            off = self._alloc_evicting(n, pinned)
            offs.append(off)
            self._offsets[k] = (off, n, y0)
        while len(self._offsets) > self.max_tiles:
            victim = next((k for k in self._offsets if k not in pinned), None)
            if victim is None:
                break
            self.free(victim)

        # Bucketed like the original's insert jit; pad rows are identity
        # rows written to row 0, which is the identity row already.
        n_bucket = max(8, 1 << (rows_total - 1).bit_length())
        data = np.zeros((n_bucket, 2, self.ts), np.int32)
        data[:, 1, :] = IDENTITY_A16P
        dst = np.zeros(n_bucket, np.int32)
        pos = 0
        for (k, (q, _)), off in zip(quantized, offs):
            n = q.shape[0]
            data[pos : pos + n] = q
            dst[pos : pos + n] = np.arange(off, off + n, dtype=np.int32)
            pos += n
        payload = torch.from_numpy(np.concatenate([data.reshape(-1), dst])).to(self.device)
        split = n_bucket * 2 * self.ts
        self.plane.index_copy_(
            0, payload[split:].long(), payload[:split].view(n_bucket, 2, self.ts)
        )

    def lrow(self, n_tiles: int, keyed: List[Tuple[int, object]]) -> np.ndarray:
        """(T, ts) i32 slab-row map for a batch: [(tile_index, key)]
        entries point their layer's bbox rows at the slab; everything
        else maps to the identity row 0.  A test oracle of
        `expand_ltriples(ltriples(...))`."""
        lr = np.zeros((n_tiles, self.ts), np.int32)
        for ti, key in keyed:
            off, n, y0 = self._offsets[key]
            self._offsets.move_to_end(key)
            lr[ti, y0 : y0 + n] = np.arange(off, off + n, dtype=np.int32)
        return lr

    def ltriples(self, n_tiles: int, keyed: List[Tuple[int, object]]) -> np.ndarray:
        """(T, 3) i32 compact slab-row map [(off, y0, n) per tile;
        n = 0 -> unlabeled].  A layer's rows are consecutive in the slab,
        so the (T, ts) row map expands on the device (`expand_ltriples`)
        and the batch's upload carries 12 bytes per tile."""
        tri = np.zeros((n_tiles, 3), np.int32)
        for ti, key in keyed:
            off, n, y0 = self._offsets[key]
            self._offsets.move_to_end(key)
            tri[ti] = (off, y0, n)
        return tri
