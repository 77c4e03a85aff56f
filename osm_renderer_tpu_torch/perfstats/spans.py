"""Hierarchical span-tree profiler (reference: `perf_stats/real_impl.rs`).

Thread-local per-tile tree of named wall-time measurements; aggregated
per zoom level into mean durations; HTML report with percentage heat
served at `/perf_stats`.  Usage:

    start_tile(zoom)
    with measure("Fill areas"):
        ...
    finish_tile(stats)
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, List, Optional

_tls = threading.local()


@dataclass
class _Node:
    name: str
    total: float = 0.0
    children: "Dict[str, _Node]" = field(default_factory=dict)

    def merge_into(self, other: "_Node") -> None:
        other.total += self.total
        for k, v in self.children.items():
            v.merge_into(other.children.setdefault(k, _Node(k)))


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


def add_span(name: str, seconds: float) -> None:
    """Record a named span with an externally measured duration under the
    current tile (used to attribute per-tile shares of batched device
    work, where one wall-clock interval covers many tiles)."""
    run: Optional[_TileRun] = getattr(_tls, "run", None)
    if run is None:
        return
    parent = run.stack[-1]
    node = parent.children.setdefault(name, _Node(name))
    node.total += seconds


class PerfStats:
    """Aggregated per-zoom stats; thread-safe via external locking."""

    def __init__(self):
        self.by_zoom: Dict[int, _Node] = {}
        self.tile_counts: Dict[int, int] = {}

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
            pct = 100.0 * child.total / root_total
            heat = int(min(pct, 100.0) * 2.55)
            out.append(
                f'<li style="background-color: rgba(255,0,0,{pct / 100.0:.2f})">'
                f"<b>{child.name}</b> {1e3 * child.total / count:.2f} ms/tile "
                f"({pct:.1f}%)</li>"
            )
            if child.children:
                out.append("<ul>")
                out.extend(self._render(child, root_total, count))
                out.append("</ul>")
        _ = heat if node.children else None
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
