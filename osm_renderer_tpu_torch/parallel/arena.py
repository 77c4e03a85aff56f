"""Device-resident chunk arena for the warm serving path.

Counterpart of `osm_renderer_tpu.parallel.arena.ChunkArena`, which
imports jax at module level.  The arena keeps the five large per-chunk
fields (geom / trav / sprof / aux / items) of every cached tile resident
on the device, so a warm batch uploads one small packed buffer
(`ops.chunk_layout.pack_small_arena`) and gathers its rows on the device
(`ops.render_cuda.render_arena_planar`) instead of re-uploading every
chunk array.

The host allocator is the original's: first-fit over a sorted free list
that coalesces neighbours, a tail pointer, row 0 reserved as the all-zero
pad row, a `generation` bumped on `clear()`, `MAX_CAP` rows and
`MemoryError` past it.  The fields are torch tensors on the renderer's
device, updated in place: `index_copy_` writes inserted rows (JAX's
insert jit scattered into donated buffers), and growing allocates the
larger tensors and copies the old rows over (JAX's grow jit).  At
MAX_CAP the arena holds 65,536 rows of ~13 KB, about 870 MB.

Layout differs from the original only by dropping the unit axes: trav
and sprof are (cap, CH) and items (cap, IT_ARENA), the shapes the CUDA
render kernel reads.

Not thread-safe; callers serialize.
"""

from __future__ import annotations

from bisect import insort
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from osm_renderer_tpu_torch.ops.chunk_layout import CH, IT_CAP
from osm_renderer_tpu_torch.utils.torch_setup import resolve_device

IT_ARENA = IT_CAP  # arena item width: every per-tile width fits


def _next_pow2(n: int, minimum: int) -> int:
    return max(minimum, 1 << (max(n, 1) - 1).bit_length())


class ChunkArena:
    """Slab-allocated device tensors of per-chunk rows.

    Row 0 is a reserved all-zero pad row (batch padding gathers it; its
    chunk kind is KIND_PAD in the packed small fields, so the kernel
    never reads the payload).
    """

    MAX_CAP = 65536  # 65k rows x ~13 KB/row ~= 870 MB of device memory

    def __init__(self, min_cap: int = 4096, device="cuda"):
        self.device = resolve_device(device) if isinstance(device, str) else device
        self.min_cap = min_cap
        self.cap = 0
        self.geom: Optional[torch.Tensor] = None   # (cap, 4, CH) i32
        self.trav: Optional[torch.Tensor] = None   # (cap, CH) f32
        self.sprof: Optional[torch.Tensor] = None  # (cap, CH) i32
        self.aux: Optional[torch.Tensor] = None    # (cap, 4, CH) f32
        self.items: Optional[torch.Tensor] = None  # (cap, IT_ARENA) i32
        self._offsets: Dict[object, Tuple[int, int]] = {}  # key -> (off, n)
        self._free: List[Tuple[int, int]] = []  # (off, n), sorted by off
        self._tail = 1  # row 0 reserved as the pad row
        self.generation = 0  # bumped on clear(); cached idx must match
        self.grows = 0  # times the tensors were reallocated larger

    # ---------------------------------------------------------- alloc --

    def __contains__(self, key) -> bool:
        return key in self._offsets

    def offset(self, key) -> Tuple[int, int]:
        return self._offsets[key]

    def free(self, key) -> None:
        got = self._offsets.pop(key, None)
        if got is None:
            return
        off, n = got
        insort(self._free, (off, n))
        self._coalesce_at(off)

    def _coalesce_at(self, off: int) -> None:
        i = next(
            (j for j, (o, _) in enumerate(self._free) if o == off), None
        )
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
        """Drop every allocation (device tensors stay; rows are dead)."""
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

    # --------------------------------------------------------- device --

    def _new_fields(self, cap: int):
        dev = self.device
        return (
            torch.zeros((cap, 4, CH), dtype=torch.int32, device=dev),
            torch.zeros((cap, CH), dtype=torch.float32, device=dev),
            torch.zeros((cap, CH), dtype=torch.int32, device=dev),
            torch.zeros((cap, 4, CH), dtype=torch.float32, device=dev),
            torch.full((cap, IT_ARENA), -1, dtype=torch.int32, device=dev),
        )

    def _grow(self, need_rows: int) -> None:
        new_cap = max(self.cap * 2 if self.cap else self.min_cap, self.min_cap)
        while new_cap < self._tail + need_rows:
            new_cap *= 2
        if new_cap > self.MAX_CAP:
            raise MemoryError(
                f"chunk arena would exceed MAX_CAP ({new_cap} rows)"
            )
        new = self._new_fields(new_cap)
        if self.cap:
            old = (self.geom, self.trav, self.sprof, self.aux, self.items)
            for dst, src in zip(new, old):
                dst[: self.cap].copy_(src)
        self.geom, self.trav, self.sprof, self.aux, self.items = new
        self.cap = new_cap
        self.grows += 1

    def insert(self, pairs) -> None:
        """Insert [(key, TileChunks)]: ONE host-to-device upload for all
        of them, unpacked and written into the arena rows on the device."""
        seen = set()
        deduped = []
        for k, c in pairs:
            if k in self._offsets or k in seen:
                continue
            seen.add(k)
            deduped.append((k, c))
        pairs = deduped
        if not pairs:
            return
        rows = sum(int(c.kind.shape[0]) for _, c in pairs)
        offs = []
        for k, c in pairs:
            n = int(c.kind.shape[0])
            off = self._alloc(n)
            if off is None:
                # _grow sizes the new cap to fit _tail + rows, so the
                # tail allocation below always succeeds.
                self._grow(rows)
                off = self._alloc(n)
                assert off is not None
            offs.append(off)
            self._offsets[k] = (off, n)

        it_new = _next_pow2(max(int(c.items.shape[2]) for _, c in pairs), 256)
        dst = np.concatenate(
            [np.arange(off, off + int(c.kind.shape[0]), dtype=np.int32)
             for (_, c), off in zip(pairs, offs)]
        )
        geom = np.concatenate([c.geom for _, c in pairs])
        trav = np.concatenate([c.trav for _, c in pairs]).reshape(rows, CH)
        sprof = np.concatenate([c.sprof for _, c in pairs]).reshape(rows, CH)
        aux = np.concatenate([c.aux for _, c in pairs])
        items = np.full((rows, it_new), -1, np.int32)
        pos = 0
        for _, c in pairs:
            n = int(c.kind.shape[0])
            items[pos : pos + n, : c.items.shape[2]] = c.items[:, 0]
            pos += n
        # geom / sprof / items ride as i16 pairs, as in the original:
        # |geom| is bounded by FAST_COORD_BOUND (12000) at assembly, sprof
        # holds small profile-table indices, and an item word is
        # sg | (blk << 8) [| sub << 14 for steep16] <= 24447 < 0x8000 (pad
        # -1 round-trips as i16 -1).  Halves the upload for those fields.
        assert int(np.abs(sprof).max(initial=0)) < 32768
        parts = [
            geom.astype(np.int16).reshape(-1).view(np.int32),
            trav.astype(np.float32).reshape(-1).view(np.int32),
            sprof.astype(np.int16).reshape(-1).view(np.int32),
            aux.astype(np.float32).reshape(-1).view(np.int32),
            items.astype(np.int16).reshape(-1).view(np.int32),
            dst,
        ]
        sizes = [p.shape[0] for p in parts]
        payload = torch.from_numpy(np.concatenate(parts)).to(self.device)
        seg = list(torch.split(payload, sizes))

        def i16(t: torch.Tensor, shape) -> torch.Tensor:
            return t.view(torch.int16).to(torch.int32).reshape(shape)

        it_full = torch.full((rows, IT_ARENA), -1, dtype=torch.int32, device=self.device)
        it_full[:, :it_new] = i16(seg[4], (rows, it_new))
        index = seg[5].long()
        self.geom.index_copy_(0, index, i16(seg[0], (rows, 4, CH)))
        self.trav.index_copy_(0, index, seg[1].view(torch.float32).reshape(rows, CH))
        self.sprof.index_copy_(0, index, i16(seg[2], (rows, CH)))
        self.aux.index_copy_(0, index, seg[3].view(torch.float32).reshape(rows, 4, CH))
        self.items.index_copy_(0, index, it_full)
