"""What a traced run records around the program, from the benchmark's side.

`Probes.install` wraps, on one service, the calls at each layer's
boundary and records host intervals on the profiler's clock (Unix
nanoseconds, which `torch.profiler` stamps its events with):

- `batch`: `TileService.render_tiles_device`, one call a micro-batch,
  with its request count;
- `entities`: the geodata reader's tile query;
- `prepare`: `_dispatch_group_device` (prepare, then launch);
- `wait`: `_collect_group_device` (wait for the kernels, then read the
  wire back);
- `encode`: `_encode_sub` (decode and PNG).

It also keeps what the byte rules of `bounds.py` need of every render
launch (the arena entry's packed buffer, its tile count and size) and of
every wire (format, tiles, live words), read where the program already
has them on the host.  Nothing here runs unless a run is traced.
"""

from __future__ import annotations

import functools
import threading
import time
from typing import List, Tuple

import numpy as np

from tilebench import bounds


class Probes:
    def __init__(self):
        self.intervals: List[Tuple[str, int, int]] = []
        self.batches: List[Tuple[int, int, int]] = []  # start, end, requests
        self.renders: List[tuple] = []  # t_ns, packed, n_tiles, ts, label rows, arena
        self.wires: List[tuple] = []  # t_ns, fmt, n_tiles, ts, live words
        self._undo = []
        self._lock = threading.Lock()

    def _wrap(self, owner, attr: str, name: str, after=None) -> None:
        orig = getattr(owner, attr)

        @functools.wraps(orig)
        def wrapper(*a, **kw):
            t0 = time.time_ns()
            try:
                out = orig(*a, **kw)
            finally:
                t1 = time.time_ns()
                self.intervals.append((name, t0, t1))
            if after is not None:
                after(t0, t1, a, kw, out)
            return out

        had = attr in vars(owner)
        setattr(owner, attr, wrapper)
        self._undo.append((owner, attr, orig, had))

    def install(self, service) -> None:
        from osm_renderer_tpu_torch.ops import render_cuda as RC

        def batch_done(t0, t1, a, kw, out):
            self.batches.append((t0, t1, len(a[0])))

        self._wrap(service, "render_tiles_device", "batch", batch_done)
        self._wrap(service.reader, "get_entities_in_tile_with_neighbors", "entities")
        self._wrap(service, "_dispatch_group_device", "prepare")
        self._wrap(service, "_collect_group_device", "wait")
        self._wrap(service, "_encode_sub", "encode")

        def render_done(t0, t1, a, kw, out, labeled=False):
            packed, arena, ts, n_tiles = a[0], a[2 if labeled else 1], a[7 if labeled else 6], \
                a[8 if labeled else 7]
            label_rows = int(np.asarray(a[1])[:, 2].sum()) if labeled else 0
            self.renders.append((t0, np.array(packed, copy=True), int(n_tiles), int(ts),
                                 label_rows, arena))

        self._wrap(RC, "render_arena_planar", "render_launch", render_done)
        self._wrap(RC, "render_arena_planar_labeled", "render_launch",
                   functools.partial(render_done, labeled=True))
        for r in service.batch_renderers:
            def wire_done(t0, t1, a, kw, out):
                res = a[0]
                host = res.host.numpy() if res.host is not None else res.wire.cpu().numpy()
                n_tiles, total = int(host[0]), int(host[1])
                if total <= res.rtot:
                    self.wires.append((t0, res.fmt, n_tiles, res.ts, total))

            self._wrap(r, "fetch_tile_view", "fetch", wire_done)

    def uninstall(self) -> None:
        for owner, attr, orig, had in reversed(self._undo):
            if had:
                setattr(owner, attr, orig)
            else:
                delattr(owner, attr)
        self._undo.clear()

    def render_bound_s(self, w0: int, w1: int) -> float:
        """Least seconds of the render launches made in [w0, w1) (ns)."""
        import torch

        total = 0.0
        for t, packed, n_tiles, ts, label_rows, arena in self.renders:
            if not w0 <= t < w1:
                continue
            rows, live = bounds.profiled_lanes(packed)
            used = 0
            if rows.size:
                sprof = arena.sprof.index_select(0, torch.from_numpy(rows).long().to(
                    arena.sprof.device)).cpu().numpy()
                used = int(np.unique(sprof[live]).size)
            total += bounds.render_bound_s(packed, used, ts, n_tiles, label_rows)
        return total

    def wire_bound_s(self, w0: int, w1: int) -> float:
        return sum(bounds.wire_bound_s(fmt, n, ts, words)
                   for t, fmt, n, ts, words in self.wires if w0 <= t < w1)
