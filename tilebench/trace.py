"""The device trace of a window, reduced: busy time, idle gaps, kernels.

Input: the device operations `torch.profiler` saw (kernels, copies,
sets; name, start and end in Unix nanoseconds) and the host intervals
of `probes.Probes`, on the same clock.  Everything is clipped to the
window [w0, w1): an operation that started before the window counts
only for its part inside it.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

Interval = Tuple[str, int, int]

# Host intervals, from the most specific to the least: an idle gap is
# named by the first kind that covers its middle.
HOST_ORDER = ("render_launch", "entities", "prepare", "wait", "fetch", "encode", "batch")
NO_CALL = "no_render_call_open"


def device_ops(prof) -> List[Interval]:
    """The device operations of a finished `torch.profiler.profile`, on
    the Unix clock in nanoseconds."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if str(e.device_type()).split(".")[-1] == "CUDA" and e.duration_ns() > 0:
            out.append((e.name(), e.start_ns(), e.start_ns() + e.duration_ns()))
    return out


def union(intervals: Sequence[Tuple[int, int]], w0: int, w1: int) -> List[Tuple[int, int]]:
    """The union of `intervals` clipped to [w0, w1), as disjoint sorted
    intervals."""
    merged: List[List[int]] = []
    for s, e in sorted((max(s, w0), min(e, w1)) for s, e in intervals):
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def gaps(busy: Sequence[Tuple[int, int]], w0: int, w1: int) -> List[Tuple[int, int]]:
    """The idle intervals of [w0, w1) between the busy ones."""
    out, t = [], w0
    for s, e in busy:
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if t < w1:
        out.append((t, w1))
    return out


def host_state(host: Sequence[Interval], t: int) -> str:
    """What the host was doing at `t`: the most specific probe interval
    open then, or that no render call was open."""
    open_kinds = {name for name, s, e in host if s <= t < e}
    for kind in HOST_ORDER:
        if kind in open_kinds:
            return kind
    return NO_CALL


def reduce(ops: Sequence[Interval], host: Sequence[Interval], w0: int, w1: int) -> Dict:
    """-> busy_s, window_s, the kernel seconds by name inside the window,
    the 10 device operations that took most time and the 10 longest idle
    gaps, each named by the host's state at its middle."""
    busy = union([(s, e) for _, s, e in ops], w0, w1)
    by_name: Dict[str, float] = {}
    for name, s, e in ops:
        s, e = max(s, w0), min(e, w1)
        if e > s:
            by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e9
    idle = sorted(gaps(busy, w0, w1), key=lambda g: g[0] - g[1])[:10]
    return {
        "busy_s": sum(e - s for s, e in busy) / 1e9,
        "window_s": (w1 - w0) / 1e9,
        "by_name": by_name,
        "device_ops": sorted(by_name.items(), key=lambda kv: -kv[1])[:10],
        "idle_gaps": [[host_state(host, (s + e) // 2), (e - s) / 1e9] for s, e in idle],
    }


def kernel_s(by_name: Dict[str, float], needle: str) -> float:
    """Seconds of the device operations whose name holds `needle`."""
    return sum(v for k, v in by_name.items() if needle in k)
