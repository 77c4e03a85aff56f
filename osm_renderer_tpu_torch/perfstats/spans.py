"""Hierarchical span-tree profiler (reference: `perf_stats/real_impl.rs`).

Thread-local per-tile tree of named wall-time measurements and event
counts; aggregated per zoom level into means a tile; HTML report with
percentage heat served at `/perf_stats`.  Usage:

    start_tile(zoom)
    with measure("Fill areas"):
        ...
    count("Tiles from raw batches")
    finish_tile(stats)

`PerfStats(intervals=N)` also keeps the last N host intervals
`(name, start_ns, end_ns, batch_id)` that its owner logs, stamped with
`time.time_ns()`: Unix nanoseconds, the clock `torch.profiler` stamps
device events with, so a device trace and the log line up.
`DeviceClock` times, by CUDA events, the kernel launches made while it
runs (`launch_events` at each launch site).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from contextlib import contextmanager
from contextvars import ContextVar
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Tuple

_tls = threading.local()

# A node's kind: a span of the tile's own work (seconds, in the heat), a
# wait before that work began (seconds, out of the heat, since it lies
# outside the tile's root), or a count of events.
SPAN, WAIT, COUNT = "span", "wait", "count"


@dataclass
class _Node:
    name: str
    total: float = 0.0  # seconds (SPAN) or events (COUNT)
    children: "Dict[str, _Node]" = field(default_factory=dict)
    kind: str = SPAN

    def merge_into(self, other: "_Node") -> None:
        other.total += self.total
        for k, v in self.children.items():
            v.merge_into(other.children.setdefault(k, _Node(k, kind=v.kind)))


@dataclass
class _TileRun:
    zoom: int
    root: _Node = field(default_factory=lambda: _Node("tile"))
    stack: List[_Node] = field(default_factory=list)
    t0: float = 0.0


def start_tile(zoom: int) -> None:
    run = _TileRun(zoom)
    run.stack = [run.root]
    run.t0 = time.perf_counter()
    _tls.run = run


@contextmanager
def measure(name: str):
    run: Optional[_TileRun] = getattr(_tls, "run", None)
    if run is None:
        yield
        return
    parent = run.stack[-1]
    node = parent.children.setdefault(name, _Node(name))
    run.stack.append(node)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        node.total += time.perf_counter() - t0
        run.stack.pop()


def add_span(name: str, seconds: float, kind: str = SPAN) -> None:
    """Record a named span with an externally measured duration under the
    current tile (used to attribute per-tile shares of batched device
    work, where one wall-clock interval covers many tiles).  `kind`
    WAIT: time before the tile's work began, shown out of the heat."""
    run: Optional[_TileRun] = getattr(_tls, "run", None)
    if run is None:
        return
    parent = run.stack[-1]
    node = parent.children.setdefault(name, _Node(name, kind=kind))
    node.total += seconds


def count(name: str, n: float = 1.0) -> None:
    """Count `n` events under the current tile, the counterpart of
    `add_span`: a fractional `n` carries a tile's share of an event that
    covers many tiles (a batch)."""
    run: Optional[_TileRun] = getattr(_tls, "run", None)
    if run is None:
        return
    parent = run.stack[-1]
    node = parent.children.setdefault(name, _Node(name, kind=COUNT))
    node.total += n


class DeviceClock:
    """The device time of the kernel launches made while it runs
    (`running`): each launch entry records, inside its C call, a CUDA
    timing event on its stream just before its launch and one just after
    (`launch_events`), so neither the host's time between launches, when
    the device may idle, nor a wait for the interpreter lock lies inside
    a pair.  Read `seconds` once the work has run."""

    def __init__(self):
        self._pairs: list = []

    @contextmanager
    def running(self):
        token = _clock.set(self)
        try:
            yield self
        finally:
            _clock.reset(token)

    def seconds(self) -> float:
        return sum(s.elapsed_time(e) for s, e in self._pairs) / 1e3


_clock: ContextVar[Optional[DeviceClock]] = ContextVar("osmr_device_clock", default=None)


def launch_events(stream) -> Tuple[Optional[int], Optional[int]]:
    """The handles of a pair of CUDA timing events for a launch entry on
    `stream` (a `torch.cuda.Stream`) to record just before and just after
    its launch, for the `DeviceClock` running in this context; (None,
    None), null to the entry, when none runs."""
    clock = _clock.get()
    if clock is None:
        return None, None
    import torch

    pair = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
    for event in pair:
        event.record(stream)  # creates the CUDA event; the entry records it again
    clock._pairs.append(pair)
    return pair[0].cuda_event, pair[1].cuda_event


class PerfStats:
    """Aggregated per-zoom stats; thread-safe via external locking.

    `intervals` > 0 keeps a log of the last `intervals` host intervals
    (`log`); 0 keeps none and `log` does nothing."""

    def __init__(self, intervals: int = 0):
        self.by_zoom: Dict[int, _Node] = {}
        self.tile_counts: Dict[int, int] = {}
        self.intervals: Optional[Deque[Tuple[str, int, int, Optional[int]]]] = (
            deque(maxlen=intervals) if intervals > 0 else None)

    def log(self, name: str, start_ns: int, end_ns: int, batch_id: Optional[int] = None) -> None:
        """Log the host interval [start_ns, end_ns] (`time.time_ns()`) of
        the micro-batch `batch_id` (None outside one), when the log is on."""
        if self.intervals is not None:
            self.intervals.append((name, start_ns, end_ns, batch_id))

    def to_html(self) -> str:
        rows = []
        for zoom in sorted(self.by_zoom):
            root = self.by_zoom[zoom]
            count = max(self.tile_counts.get(zoom, 1), 1)
            rows.append(
                f"<h2>zoom {zoom} &mdash; {count} tiles, "
                f"mean {1e3 * root.total / count:.2f} ms/tile</h2>"
            )
            rows.append("<ul>")
            rows.extend(self._render(root, root.total or 1e-12, count))
            rows.append("</ul>")
        body = "\n".join(rows) or "<p>no tiles rendered yet</p>"
        return (
            "<!DOCTYPE html><html><head><title>perf stats</title>"
            "<style>body{font-family:monospace} li b{display:inline-block;min-width:22em}"
            "</style></head><body><h1>osm_renderer_tpu perf stats</h1>"
            f"{body}</body></html>"
        )

    def _render(self, node: _Node, root_total: float, count: int) -> List[str]:
        out = []
        for child in node.children.values():
            if child.kind == COUNT:
                out.append(f"<li><b>{child.name}</b> {child.total / count:.3f} a tile</li>")
                continue
            if child.kind == WAIT:
                out.append(f"<li><b>{child.name}</b> {1e3 * child.total / count:.2f} ms/tile "
                           "(before the tile's work)</li>")
                continue
            pct = 100.0 * child.total / root_total
            out.append(
                f'<li style="background-color: rgba(255,0,0,{pct / 100.0:.2f})">'
                f"<b>{child.name}</b> {1e3 * child.total / count:.2f} ms/tile "
                f"({pct:.1f}%)</li>"
            )
            if child.children:
                out.append("<ul>")
                out.extend(self._render(child, root_total, count))
                out.append("</ul>")
        return out


def finish_tile(stats: PerfStats) -> None:
    run: Optional[_TileRun] = getattr(_tls, "run", None)
    if run is None:
        return
    run.root.total = time.perf_counter() - run.t0
    agg = stats.by_zoom.setdefault(run.zoom, _Node("tile"))
    run.root.merge_into(agg)
    stats.tile_counts[run.zoom] = stats.tile_counts.get(run.zoom, 0) + 1
    _tls.run = None
