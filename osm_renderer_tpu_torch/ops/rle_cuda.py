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

Both check their inputs, launch the kernels for CUDA tensors (raising if
a build or launch fails) and run the plain versions for CPU tensors.
They never fall back from a CUDA tensor.  The plain versions
(`*_reference`) work on any device; the tests hold them bit for bit to
the XLA encoders, and the chip smoke run holds the kernels to them.

Overflow: when a batch has more runs than `rtot` (v1) or more words than
`wcap` (v2), the header's total exceeds the cap and the content is cut at
the cap.  The caller then reads the raw planar batch.
"""

from __future__ import annotations

import threading

import torch

from osm_renderer_tpu_torch.ops.render_cuda import BatchLayoutError
from osm_renderer_tpu_torch.ops.rle_layout import BLOCK, PAL_CAP

# Launches made by the wrappers on CUDA tensors: one emit per wire (its
# run-count pass included), one expand per v2 wire (its word-count pass
# included).
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
    device.  CUDA: the emit kernel, not synchronised."""
    global EMIT_KERNEL_LAUNCHES
    _check_planar(planar)
    _check_cap("rtot", rtot)
    if not _route(planar):
        return encode_batch_wire_reference(planar, rtot)
    T = planar.shape[0]
    wire = torch.empty(2 + T + rtot, dtype=torch.int32, device=planar.device)
    packed = wire[2 + T:]
    packed.zero_()
    nb, cum = emit_cuda(planar, packed, rtot)
    wire[0:1].fill_(T)
    wire[1:2].copy_(cum[-1:])
    wire[2:2 + T] = nb.view(T, -1).sum(1, dtype=torch.int32)
    with _launch_lock:
        EMIT_KERNEL_LAUNCHES += 1
    return wire


def encode_wire_indexed(planar: torch.Tensor, wcap: int, table: torch.Tensor) -> torch.Tensor:
    """(T, 4, ts, ts) u8 + sorted (PAL_CAP,) i32 palette -> v2 wire,
    (3 + T + PAL_CAP + wcap / 2,) i32 on the planar's device.  CUDA: the
    emit and expand kernels, not synchronised."""
    global EMIT_KERNEL_LAUNCHES, EXPAND_KERNEL_LAUNCHES
    _check_planar(planar)
    _check_cap("wcap", wcap, even=True)
    _check_table(table, planar)
    if not _route(planar):
        return encode_wire_indexed_reference(planar, wcap, table)
    runs = torch.empty(wcap, dtype=torch.int32, device=planar.device)
    nb, cum = emit_cuda(planar, runs, wcap)
    with _launch_lock:
        EMIT_KERNEL_LAUNCHES += 1
    wire = expand_cuda(runs, nb, cum[-1:], planar.shape[0], wcap, table)
    with _launch_lock:
        EXPAND_KERNEL_LAUNCHES += 1
    return wire


def expand_cuda(runs: torch.Tensor, nb: torch.Tensor, total_runs: torch.Tensor, T: int,
                wcap: int, table: torch.Tensor) -> torch.Tensor:
    """The expand half of `encode_wire_indexed` on the card: the emitted
    runs (wcap i32 slots), the per-block run counts and the run total (a
    (1,) device tensor) -> the v2 wire.  Counts no launch."""
    from osm_renderer_tpu_torch.ops.build import rle_library

    lib = rle_library()
    dev = runs.device
    wc = torch.empty(wcap, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        _ok(lib.osmr_rle_word_counts(runs.data_ptr(), total_runs.data_ptr(), wcap,
                                     table.data_ptr(), wc.data_ptr(), stream), "word count")
        cum_w = torch.cumsum(wc, 0, dtype=torch.int32)
        woff = cum_w - wc
        head = 3 + T + PAL_CAP
        wire = torch.empty(head + wcap // 2, dtype=torch.int32, device=dev)
        words = wire[head:]
        words.zero_()
        _ok(lib.osmr_rle_expand_words(runs.data_ptr(), total_runs.data_ptr(), wcap,
                                      table.data_ptr(), woff.data_ptr(), words.data_ptr(),
                                      wcap, stream), "expand")
    wire[0:1].fill_(T)
    wire[1:2] = torch.maximum(cum_w[-1:], total_runs)
    wire[2:3].copy_(total_runs)
    wire[3:3 + T] = _words_per_tile(nb.view(T, -1).sum(1, dtype=torch.int32), cum_w, wcap)
    wire[3 + T:head].copy_(table)
    return wire


def _ok(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"RLE {what} kernel launch failed with cudaError_t {rc}")


def emit_cuda(planar: torch.Tensor, out: torch.Tensor, cap: int):
    """Run-count kernel, exclusive cumsum, emit kernel into `out` (cap
    i32 slots).  -> (nb per 256-px block, inclusive cumsum of nb)."""
    from osm_renderer_tpu_torch.ops.build import rle_library

    lib = rle_library()
    dev = planar.device
    T, ts = planar.shape[0], planar.shape[2]
    nb = torch.empty(T * ts * ts // BLOCK, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        _ok(lib.osmr_rle_count_runs(planar.data_ptr(), T, ts, nb.data_ptr(), stream), "run count")
        cum = torch.cumsum(nb, 0, dtype=torch.int32)
        off = cum - nb
        _ok(lib.osmr_rle_emit_runs(planar.data_ptr(), T, ts, off.data_ptr(), out.data_ptr(),
                                   cap, stream), "emit")
    return nb, cum


def _words_per_tile(n_runs_tile: torch.Tensor, cum_w: torch.Tensor, n_live: int) -> torch.Tensor:
    """Per-tile word counts from the inclusive word cumsum at each tile's
    last run (tile starts are forced run boundaries); on overflow the
    run index clamps to the last slot, as the XLA encoder does."""
    run_ends = (torch.cumsum(n_runs_tile, 0) - 1).clamp(0, n_live - 1)
    words_end = cum_w[run_ends.long()]
    zero = torch.zeros(1, dtype=words_end.dtype, device=words_end.device)
    return torch.diff(words_end, prepend=zero).to(torch.int32)


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
