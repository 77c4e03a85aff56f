"""Run-length wire encoders: the CUDA kernels' wrappers and their plain
PyTorch versions.

Counterpart of the device half of `osm_renderer_tpu.ops.rle`
(`encode_batch_wire`, `encode_wire_indexed`) and of the Pallas kernels
that replace them there (`ops/rle_pallas.py`).  The kernels are
`csrc/rle.cu`; its design notes are there.  The formats are described
in `ops/rle_layout.py`.

* `encode_batch_wire(planar, rtot)` -> the v1 wire
  [T, total_runs, n_runs[T], packed[rtot]].
* `encode_wire_indexed(planar, wcap, table)` -> the v2 wire
  [T, total_words, total_runs, n_words[T], table[PAL_CAP], packed32[wcap/2]].

Both check their inputs and run the plain versions for CPU tensors.  For
CUDA tensors each allocates the wire with a small scratch behind it and
makes one call into the library, which clears both with one memset and
launches one kernel; a failed build or launch raises.  They never fall
back from a CUDA tensor.  The plain versions (`*_reference`) work on
any device; the tests hold them bit for bit to the XLA encoders and to
a per-run loop encoder, and the chip smoke run holds the kernels to
them.

Overflow: when a batch has more runs than `rtot` (v1) or more words than
`wcap` (v2), the header's total exceeds the cap and the content is cut at
the cap.  The caller then reads the raw planar batch.
"""

from __future__ import annotations

import threading
from typing import Optional

import torch

from osm_renderer_tpu_torch import perfstats
from osm_renderer_tpu_torch.ops.render_cuda import BatchLayoutError
from osm_renderer_tpu_torch.ops.rle_layout import BLOCK, PAL_CAP

# Launches made by the wrappers on CUDA tensors, counted by the TPU
# kernel whose work they do: a v1 wire counts one emit; a v2 wire's one
# kernel counts one emit and one expand.
EMIT_KERNEL_LAUNCHES = 0
EXPAND_KERNEL_LAUNCHES = 0
_launch_lock = threading.Lock()


def _check_planar(planar: torch.Tensor) -> None:
    if planar.dtype != torch.uint8:
        raise BatchLayoutError(f"planar has dtype {planar.dtype}, want torch.uint8")
    if planar.dim() != 4 or planar.shape[1] != 4 or planar.shape[2] != planar.shape[3]:
        raise BatchLayoutError(f"planar has shape {tuple(planar.shape)}, want (T, 4, ts, ts)")
    if planar.shape[0] < 1 or (planar.shape[2] * planar.shape[3]) % BLOCK:
        raise BatchLayoutError(f"planar shape {tuple(planar.shape)}: need T >= 1 and "
                               f"ts * ts a multiple of {BLOCK}")
    if not planar.is_contiguous():
        raise BatchLayoutError("planar is not contiguous")


def _check_cap(name: str, cap: int, even: bool = False) -> None:
    if cap < 1 or cap >= 2 ** 31 or (even and cap % 2):
        raise BatchLayoutError(f"{name} = {cap} must be {'even, ' if even else ''}"
                               f"in [1, 2**31)")


def _check_table(table: torch.Tensor, planar: torch.Tensor) -> None:
    if table.device != planar.device or table.dtype != torch.int32:
        raise BatchLayoutError("table must be int32 on the planar batch's device")
    if tuple(table.shape) != (PAL_CAP,) or not table.is_contiguous():
        raise BatchLayoutError(f"table has shape {tuple(table.shape)}, want ({PAL_CAP},), "
                               "contiguous")


def _route(planar: torch.Tensor) -> bool:
    """True for the kernel (CUDA), False for the plain version (CPU)."""
    if planar.device.type == "cuda":
        return True
    if planar.device.type == "cpu":
        return False
    raise BatchLayoutError(f"unsupported device {planar.device}")


def encode_batch_wire(planar: torch.Tensor, rtot: int) -> torch.Tensor:
    """(T, 4, ts, ts) u8 -> v1 wire, (2 + T + rtot,) i32 on the planar's
    device.  CUDA: one call, one kernel launch; not synchronised."""
    global EMIT_KERNEL_LAUNCHES
    _check_planar(planar)
    _check_cap("rtot", rtot)
    if not _route(planar):
        return encode_batch_wire_reference(planar, rtot)
    wire = _launch_wire("osmr_rle_wire_v1", planar, 2 + planar.shape[0] + rtot, rtot)
    with _launch_lock:
        EMIT_KERNEL_LAUNCHES += 1
    return wire


def encode_wire_indexed(planar: torch.Tensor, wcap: int, table: torch.Tensor) -> torch.Tensor:
    """(T, 4, ts, ts) u8 + sorted (PAL_CAP,) i32 palette -> v2 wire,
    (3 + T + PAL_CAP + wcap / 2,) i32 on the planar's device.  CUDA: one
    call, one kernel launch that does the work of the emit and the
    expand (counted as one of each); not synchronised."""
    global EMIT_KERNEL_LAUNCHES, EXPAND_KERNEL_LAUNCHES
    _check_planar(planar)
    _check_cap("wcap", wcap, even=True)
    _check_table(table, planar)
    if not _route(planar):
        return encode_wire_indexed_reference(planar, wcap, table)
    n = 3 + planar.shape[0] + PAL_CAP + wcap // 2
    wire = _launch_wire("osmr_rle_wire_v2", planar, n, wcap, table)
    with _launch_lock:
        EMIT_KERNEL_LAUNCHES += 1
        EXPAND_KERNEL_LAUNCHES += 1
    return wire


def segment_px(planar: torch.Tensor) -> int:
    """Pixels a CTA of the wire kernels covers: 4096 (16 a thread, one
    16-byte load a plane) where ts * ts is a multiple of 4096 and the
    batch is 16-byte aligned, else one 256-pixel block."""
    n_px = planar.shape[2] * planar.shape[3]
    return 4096 if n_px % 4096 == 0 and planar.data_ptr() % 16 == 0 else BLOCK


def _launch_wire(entry: str, planar: torch.Tensor, n_wire: int, cap: int,
                 table: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One call into the wire library, which clears the wire and the
    kernel's scratch with one memset on the current stream and launches
    its kernel once.  The scratch (a ticket counter and one status word
    a segment) follows the wire in one allocation; the wire returned is
    a view of its head."""
    from osm_renderer_tpu_torch.ops.build import rle_library

    lib = rle_library()
    T, ts = planar.shape[0], planar.shape[2]
    if 3 * T * ts * ts >= 2 ** 31:
        raise BatchLayoutError(f"batch of {T} tiles of {ts} px: the wire kernels' run and "
                               "word counts need 3 * T * ts * ts < 2**31")
    dev = planar.device
    seg = segment_px(planar)
    lead = n_wire + n_wire % 2
    buf = torch.empty(lead + 2 * (1 + T * ts * ts // seg), dtype=torch.int32, device=dev)
    current = torch.cuda.current_stream(dev)
    args = [planar.data_ptr(), T, ts, seg]
    if table is not None:
        args.append(table.data_ptr())
    args += [buf.data_ptr(), cap, current.cuda_stream, *perfstats.launch_events(current)]
    with torch.cuda.device(dev):
        rc = getattr(lib, entry)(*args)
    if rc != 0:
        raise RuntimeError(f"RLE wire kernel ({entry}) failed with cudaError_t {rc}")
    return buf[:n_wire]


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------

def _to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 holding uint32 bit patterns -> the same bits as int32."""
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(torch.int32)


def runs_reference(planar: torch.Tensor):
    """All runs of the batch -> (packed (R,) i64 as uint32 bits, nb per
    256-px block (nblk,) i32)."""
    p = planar[:, :3].to(torch.int64)
    v = ((p[:, 0] << 16) | (p[:, 1] << 8) | p[:, 2]).reshape(-1)
    TN = v.numel()
    start = torch.ones(TN, dtype=torch.bool, device=v.device)
    start[1:] = v[1:] != v[:-1]
    start.view(-1, BLOCK)[:, 0] = True
    starts = torch.nonzero(start).squeeze(1)
    ends = torch.cat([starts[1:], torch.full((1,), TN, dtype=starts.dtype, device=v.device)])
    packed = ((ends - starts - 1) << 24) | v[starts]
    nb = start.view(-1, BLOCK).sum(1, dtype=torch.int32)
    return packed, nb


def encode_batch_wire_reference(planar: torch.Tensor, rtot: int) -> torch.Tensor:
    """Plain version of `encode_batch_wire` (boundary flags, nonzero)."""
    T = planar.shape[0]
    packed, nb = runs_reference(planar)
    total = packed.numel()
    out = torch.zeros(rtot, dtype=torch.int64, device=planar.device)
    n = min(total, rtot)
    out[:n] = packed[:n]
    head = torch.tensor([T, total], dtype=torch.int64, device=planar.device)
    n_runs_tile = nb.view(T, -1).sum(1, dtype=torch.int64)
    return _to_i32(torch.cat([head, n_runs_tile, out]))


def encode_wire_indexed_reference(
    planar: torch.Tensor, wcap: int, table: torch.Tensor
) -> torch.Tensor:
    """Plain version of `encode_wire_indexed`."""
    packed, nb = runs_reference(planar)
    return expand_reference(packed, nb, planar.shape[0], wcap, table)


def _words_per_tile(n_runs_tile: torch.Tensor, cum_w: torch.Tensor, n_live: int) -> torch.Tensor:
    """Per-tile word counts from the inclusive word cumsum at each tile's
    last run (tile starts are forced run boundaries); on overflow the
    run index clamps to the last slot, as the XLA encoder does."""
    run_ends = (torch.cumsum(n_runs_tile, 0) - 1).clamp(0, n_live - 1)
    words_end = cum_w[run_ends.long()]
    zero = torch.zeros(1, dtype=words_end.dtype, device=words_end.device)
    return torch.diff(words_end, prepend=zero).to(torch.int32)


def expand_reference(packed: torch.Tensor, nb: torch.Tensor, T: int, wcap: int,
                     table: torch.Tensor) -> torch.Tensor:
    """Plain version of the expand half: all runs of the batch (i64 as
    uint32 bits) and the per-block run counts -> the v2 wire
    (searchsorted palette lookup, cumsum word offsets, scatter of the
    words)."""
    dev = packed.device
    total_runs = packed.numel()
    n = min(total_runs, wcap)  # runs that fit the cap (words >= runs)
    runs = packed[:n]
    vals = runs & 0xFFFFFF
    len1 = runs >> 24
    tab = table.to(torch.int64)
    pi = torch.searchsorted(tab, vals)            # entries < val
    hit = (pi < PAL_CAP) & (tab[pi.clamp(max=PAL_CAP - 1)] == vals)
    wc = torch.where(hit, 1, 3)
    cum_w = torch.cumsum(wc, 0)
    woff = cum_w - wc
    total_words = max(int(cum_w[-1]), total_runs)
    hdr = torch.where(hit, (pi << 8) | len1, 0xFF00 | len1)
    miss = ~hit
    pos = torch.cat([woff, woff[miss] + 1, woff[miss] + 2])
    word = torch.cat([hdr, vals[miss] & 0xFFFF, vals[miss] >> 16])
    keep = pos < wcap
    w16 = torch.zeros(wcap, dtype=torch.int64, device=dev)
    w16.scatter_(0, pos[keep], word[keep])
    packed32 = w16[0::2] | (w16[1::2] << 16)
    n_words = _words_per_tile(nb.view(T, -1).sum(1, dtype=torch.int64), cum_w, n)
    head = torch.tensor([T, total_words, total_runs], dtype=torch.int64, device=dev)
    return _to_i32(torch.cat([head, n_words.to(torch.int64), tab, packed32]))
