"""Benchmark of the PyTorch/CUDA port: z15 256 px tiles/s per GPU on the
device render path, and end-to-end serving numbers.

Counterpart of the JAX package's `bench.py`, under the same JSON keys,
so that its line reads beside `BENCH_r0*.json` (those are a TPU's
numbers; this prints the card's).

    python -m osm_renderer_tpu_torch.bench [--device cuda] [--seed 0]

It runs on the card by default and raises without one; `--device cpu`
runs the kernels' plain versions, and its line then says
`"platform": "cpu"` and holds null under every key that names the
device (the tests run it so on tiny cities, through `run`'s keyword
arguments).  The corpus is the JAX bench's (`CORPUS`): the synthetic
minicity (`tools/make_fixture.py --blocks 24`) and bigcity (48 blocks),
imported by the port's importer into `assets/fixtures/` on first use,
and the minicity's z12-z17 pyramid; batches over `MAX_BATCH_CHUNKS`
split by halving, as the server splits them.  Prints ONE JSON line:

  {"metric": "z15_tiles_per_sec_per_chip", "value": N, "unit": "tiles/s",
   "vs_baseline": N / the C++ oracle's tiles/s, "correct": true|false,
   "device": {"platform", "name", "power_limit", "count"},
   "detail": {...}}

Each measured quantity is taken `RUNS` times: its key holds the
median, and `detail.spread` holds the run count, median, min and max
under the same key.  Device batches are timed with CUDA events around
back-to-back launches; host and end-to-end work with the host's clock
around work that ends in a synchronisation.  Every city has its own
renderer (the chunk cache is keyed by tile address, and both cities
cover the same addresses), and the production stylesheet
(`tests/fixtures/mapcss/osmosnimki-minimal.mapcss`, type mapsme) has
its own.  Before each timed loop, its untimed passes alternate until
the renderer's adaptive wire caps stop changing; the timed runs of the
end-to-end and production loops then go in an order shuffled by
`--seed`, the only random input.  `detail.png_writer` names the host
codec the end-to-end loops encoded through (`draw/png8.py`), and
`detail.e2e_png_containers` the PNG containers each kind served.

`correct` is true when every check holds: each PNG of the last timed
end-to-end and production passes decodes to its wire's pixels, and
`ORACLE_SAMPLE` of each pass's served tiles are within 1/255 of the C++
oracle (`CpuDrawer`), or with labels on within 2/255 of the oracle
under the host's label composite; bigcity z15 from the timed renderer
equals a fresh renderer's render; six minicity z15 tiles and two
production z16 tiles, labels off, are within 1/255 of the oracle.  A
failed check or an exception prints the line with `"correct": false`
and exits 1.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import random
import statistics
import subprocess
import sys
import time
import traceback
from collections import Counter
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from osm_renderer_tpu_torch.tools.corpus import (build_fixture, split_prepare, with_entities,
                                                 zoom_tiles)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE_DIR = os.path.join(REPO_ROOT, "assets", "fixtures")
STYLESHEET_DIR = os.path.join(REPO_ROOT, "assets", "stylesheets")
PROD_DIR = os.path.join(REPO_ROOT, "tests", "fixtures", "mapcss")
PROD_SHEET = "osmosnimki-minimal.mapcss"
# city -> (.osm, .bin, blocks a side): the JAX bench's cities.
CORPUS = {city: (os.path.join(FIXTURE_DIR, f"{city}.osm"), os.path.join(FIXTURE_DIR, f"{city}.bin"),
                 blocks) for city, blocks in (("minicity", 24), ("bigcity", 48))}
RUNS = 5         # timed runs of each measurement
REPS = 10        # back-to-back launches a timed device sample
COLD_SUB = 16    # tiles a cold sub-batch, as the JAX bench streams them
AT2X_TILES = 16  # minicity z15 tiles of the @2x batch
ORACLE_SAMPLE = 6  # served tiles of each timed pass held to the C++ oracle
E2E_KINDS = ("cold", "warm", "labels_cold", "labels_warm")
# The measured keys of `detail` (the JAX bench's, and the port's
# big_device_ms_render_wire); the two dicts hold one number a pass or zoom.
METRICS = ("z15_tiles_per_sec_per_chip", "big_ms_per_batch", "big_device_kernel_ms",
           "big_device_ms_render_wire", "minicity_30tile_tiles_per_sec", "device_ms_per_batch",
           "cpu_oracle_tiles_per_sec_1core", "assembly_cold_ms_per_batch",
           "assembly_warm_ms_per_batch", "png_encode_tiles_per_sec_1core",
           "at2x_device_tiles_per_sec", "prod_stylesheet_warm_labels_tiles_per_sec",
           "prod_stylesheet_warm_nolabels_tiles_per_sec", "e2e_tiles_per_sec",
           "pyramid_tiles_per_sec")
# Keys that name the device: null on the CPU.
DEVICE_KEYS = ("big_device_kernel_ms", "big_device_ms_render_wire", "device_ms_per_batch",
               "at2x_device_tiles_per_sec")


def pyramid_groups(reader) -> Dict[str, list]:
    """The z12-z17 pyramid, one group a zoom, then all of it folded ->
    {"z12": tiles_entities, ..., "mixed_z12_z17": ...}."""
    groups = {f"z{zoom}": with_entities(reader, zoom_tiles(reader, zoom))
              for zoom in range(12, 18)}
    groups["mixed_z12_z17"] = [x for g in groups.values() for x in g]
    return groups


def spread(samples: List[float]) -> Dict[str, float]:
    s = sorted(samples)
    return {"runs": len(s), "median": statistics.median(s), "min": s[0], "max": s[-1]}


def metric_values(line: Dict[str, object]) -> Dict[str, object]:
    """Every metric of a bench line by its key ("value", "vs_baseline",
    each of METRICS, dots into the two dicts); a missing one is None."""
    out = {"value": line.get("value"), "vs_baseline": line.get("vs_baseline")}
    detail = line.get("detail", {})
    for key in METRICS:
        v = detail.get(key)
        if isinstance(v, dict):
            out.update({f"{key}.{k}": x for k, x in v.items()})
        else:
            out[key] = v
    return out


def device_info(device: torch.device) -> Dict[str, object]:
    """The card as nvidia-smi names it, with its power limit, and the
    CUDA device count; on the CPU {"platform": "cpu"}."""
    if device.type != "cuda":
        return {"platform": "cpu", "name": "cpu", "power_limit": None, "count": 0}
    smi = subprocess.run(
        ["nvidia-smi", f"--id={device.index}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    name, limit = (s.strip() for s in smi.rsplit(",", 1))
    return {"platform": "gpu", "name": name, "power_limit": limit,
            "count": torch.cuda.device_count()}


def caps(renderer):
    """The renderer's adaptive wire caps by (ts, T) signature."""
    return dict(renderer._rtot_by_key), dict(renderer._wtot_by_key)


def settle(renderer, passes: List[Callable[[], object]], limit: int = 8) -> int:
    """Run the untimed `passes` in turn until the renderer's wire caps
    stop changing -> rounds taken; raises after `limit` rounds."""
    for rounds in range(1, limit + 1):
        before = caps(renderer)
        for p in passes:
            p()
        if caps(renderer) == before:
            return rounds
    raise RuntimeError(f"the wire caps did not settle in {limit} rounds: {caps(renderer)}")


def decode_png(png: bytes) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(png)).convert("RGB"))


class Bench:
    """One run of the benchmark: its device and clock, the measured
    values and their spreads, and the checks."""

    def __init__(self, device: torch.device, runs: int, reps: int, seed: int):
        self.device = device
        self.on_card = device.type == "cuda"
        self.runs = runs
        self.reps = reps
        self.rng = random.Random(seed)
        self.renderers: Dict[str, object] = {}
        self.detail: Dict[str, object] = {}
        self.spread: Dict[str, Dict[str, float]] = {}
        self.checks: List[Dict[str, object]] = []

    # ---------------------------------------------------------- clocks --

    def sync(self) -> None:
        if self.on_card:
            torch.cuda.synchronize(self.device)

    def ms_per_call(self, fn: Callable[[], object]) -> float:
        """ms a call of fn(), over `reps` back-to-back calls after a warm
        one: CUDA events on the card, the host's clock on the CPU."""
        reps = self.reps
        fn()
        self.sync()
        if self.on_card:
            ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            ev0.record()
            for _ in range(reps):
                fn()
            ev1.record()
            ev1.synchronize()
            return ev0.elapsed_time(ev1) / reps
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps

    def batch_ms(self, renderer, preps) -> List[float]:
        """`runs` samples of ms_per_call over rendering every prepared
        batch of `preps` (split_prepare's) to planar pixels."""
        return [self.ms_per_call(lambda: [renderer.render_prepared_planar(p) for p, _, _ in preps])
                for _ in range(self.runs)]

    def host_s(self, fn: Callable[[], object]) -> float:
        """Seconds of fn() on the host's clock, its device work included."""
        t0 = time.perf_counter()
        fn()
        self.sync()
        return time.perf_counter() - t0

    # --------------------------------------------------------- results --

    def record(self, key: str, samples: List[float]) -> float:
        """The median of `samples` under `key` (dots nest), their spread
        under the same key in `spread` -> the median."""
        s = spread(samples)
        self.spread[key] = s
        node = self.detail
        *parents, leaf = key.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = s["median"]
        return s["median"]

    def check(self, name: str, ok: bool, what: str) -> None:
        self.checks.append({"name": name, "ok": bool(ok), "detail": what})
        print(f"check {name}: {'ok' if ok else 'FAILED'}: {what}", file=sys.stderr, flush=True)

    def schedule(self, kinds, fns: Dict[str, Callable[[], float]]) -> Dict[str, List[float]]:
        """`runs` timed runs of each kind, in an order shuffled by the
        seed -> {kind: [samples]}."""
        order = [k for k in kinds for _ in range(self.runs)]
        self.rng.shuffle(order)
        got: Dict[str, List[float]] = {k: [] for k in kinds}
        for k in order:
            got[k].append(fns[k]())
        return got


def within_oracle(drawer, styler, tiles_entities, rgb, scale: int = 1) -> int:
    """Worst per-channel |diff| of the rendered (T, ts, ts, 3) tiles
    against the C++ oracle."""
    worst = 0
    for (ents, t), got in zip(tiles_entities, rgb):
        want = drawer.draw_to_pixels(ents, t, scale, styler)
        worst = max(worst, int(np.abs(got.astype(int) - want.astype(int)).max()))
    return worst


def fresh_render(styler, stylesheet_dir, tiles_entities, device) -> np.ndarray:
    """The tiles through a renderer that caches nothing -> (T, ts, ts, 3)."""
    from osm_renderer_tpu_torch.parallel.renderer import BatchRenderer

    r = BatchRenderer(styler, stylesheet_dir=stylesheet_dir, device=device)
    return np.concatenate([r.render_prepared(p).cpu().numpy()
                           for p, _, _ in split_prepare(r, tiles_entities, 1)])


class E2E:
    """The serving loop of the JAX bench (`bench.py:218-300`) on one
    renderer: each group's batch (split as the server splits) is
    prepared and launched, its wire copy queued, before the previous
    batch's wire is fetched and its tiles encoded.  A cold pass clears
    the caches and streams in `COLD_SUB`-tile groups; a warm pass is one
    group, whose tiles come from the chunk cache.  Counts the PNG
    containers each kind served, and keeps each kind's last sample (PNG,
    wire view, index in it, host-composited pixels, tile) for
    `check_served`."""

    def __init__(self, renderer, reader, tiles, styler, labeler):
        self.renderer, self.reader, self.tiles = renderer, reader, tiles
        self.styler, self.labeler = styler, labeler
        self.containers: Dict[str, Counter] = {k: Counter() for k in E2E_KINDS}
        self.kept: Dict[str, list] = {}

    def run(self, kind: str, n_passes: int = 1) -> float:
        """One sample of `kind` (one of E2E_KINDS) -> tiles/s."""
        from osm_renderer_tpu_torch.parallel.renderer import start_wire_copy

        labeler = self.labeler if kind.startswith("labels") else None
        cold = kind.endswith("cold")
        if cold:
            self.renderer.cache_clear()
            if labeler is not None:
                labeler.cache_clear()
        sub = COLD_SUB if cold else len(self.tiles)
        groups = [self.tiles[i:i + sub] for i in range(0, len(self.tiles), sub)]
        kept: list = []
        inflight = None
        t0 = time.perf_counter()
        for _ in range(n_passes):
            for g in groups:
                te = [(self.reader.get_entities_in_tile_with_neighbors(t)
                       if cold or (labeler is not None and not labeler.has_cached_layer(t, 256))
                       else None, t) for t in g]
                compacts = ([labeler.ensure_layer(e, t, 1.0, self.styler, 256) for e, t in te]
                            if labeler is not None else None)
                for p, pte, layers in split_prepare(self.renderer, te, 1, compacts):
                    res = start_wire_copy(self.renderer.render_prepared_rle(p))
                    if inflight is not None:
                        self._encode(kind, *inflight, kept)
                    inflight = (pte, res, layers, set(p.device_labeled))
        self._encode(kind, *inflight, kept)
        dt = time.perf_counter() - t0
        self.kept[kind] = kept
        return n_passes * len(self.tiles) / dt

    def _encode(self, kind, te, res, compacts, device_labeled, kept) -> None:
        """The server's encode (`server/http.py`): PNG-8 straight from a
        v2 wire, through the port's host codec, where the tile needs no
        host labels and its colours fit a PNG palette, else RGB,
        host-composited when its labels were not blended on the device."""
        from osm_renderer_tpu_torch.draw.png_writer import rgb_to_png

        view = self.renderer.fetch_tile_view(res)
        for i, (ents, t) in enumerate(te):
            host_labels = compacts is not None and compacts[i] is not None and \
                i not in device_labeled
            png = None if host_labels else view.png8(i, 1)
            img = None
            if png is None:
                img = view.rgb(i)
                if host_labels:
                    img = self.labeler.composite_labels(img, ents, t, 1.0, self.styler)
                png = rgb_to_png(img, 1)
                self.containers[kind]["rgb"] += 1
            else:
                self.containers[kind]["png8"] += 1
            kept.append((png, view, i, img, t))


def check_served(b: Bench, name: str, e2e: E2E, kinds, drawer, ref_labeler) -> None:
    """For each of `kinds`, from its last sample: every PNG decodes to
    its wire's pixels (or to the host composite the encoder was given);
    and `ORACLE_SAMPLE` of its tiles, spread over the sample, decode to
    within 1/255 of the C++ oracle, or, where `ref_labeler` (a labeler
    with no cache) gives a labels-on tile a layer, within 2/255 of the
    oracle under its host composite (1/255 for the render, 1/255 for the
    blit's quantization)."""
    for kind in kinds:
        kept = e2e.kept.get(kind, [])
        decoded = [decode_png(png) for png, *_ in kept]
        bad = [i for got, (_, view, i, img, _t) in zip(decoded, kept)
               if not np.array_equal(got, view.rgb(i) if img is None else img)]
        b.check(f"{name}_{kind}_pngs", bool(kept) and not bad,
                f"{len(kept)} PNGs of the last {kind} sample against their wires' pixels: "
                f"{len(bad)} differ")
        labels = kind.startswith("labels")
        worst, n = {1: 0, 2: 0}, {1: 0, 2: 0}
        picks = np.unique(np.linspace(0, len(kept) - 1, min(ORACLE_SAMPLE, len(kept)))
                          .round().astype(int)) if kept else []
        for k in picks:
            t = kept[k][4]
            ents = e2e.reader.get_entities_in_tile_with_neighbors(t)
            want = drawer.draw_to_pixels(ents, t, 1, e2e.styler)
            bar = 1
            if labels and ref_labeler.ensure_layer(ents, t, 1.0, e2e.styler, 256) is not None:
                want = ref_labeler.composite_labels(want, ents, t, 1.0, e2e.styler)
                bar = 2
            n[bar] += 1
            worst[bar] = max(worst[bar], int(np.abs(decoded[k].astype(int)
                                                    - want.astype(int)).max()))
        b.check(f"{name}_{kind}_oracle", len(picks) > 0 and worst[1] <= 1 and worst[2] <= 2,
                f"served tiles of the last {kind} sample against CpuDrawer: {n[1]} unlabeled "
                f"within {worst[1]}/255 (bar 1), {n[2]} labeled within {worst[2]}/255 of it "
                "under the host's label composite (bar 2)")


def measure(b: Bench, corpus) -> Dict[str, object]:
    """Every phase of the benchmark over `corpus` (as CORPUS), in `b` ->
    the JSON line's fields other than `correct` and `device`."""
    from osm_renderer_tpu_torch.draw.drawer import CpuDrawer
    from osm_renderer_tpu_torch.draw.labels.labeler import Labeler
    from osm_renderer_tpu_torch.draw.png8 import WRITER as PNG_WRITER
    from osm_renderer_tpu_torch.draw.png_writer import rgb_to_png
    from osm_renderer_tpu_torch.geodata.reader import GeodataReader
    from osm_renderer_tpu_torch.mapcss.parser import parse_file
    from osm_renderer_tpu_torch.mapcss.styler import Styler
    from osm_renderer_tpu_torch.ops import chunk_layout as CL
    from osm_renderer_tpu_torch.ops import render_cuda, rle_cuda
    from osm_renderer_tpu_torch.parallel.renderer import BatchRenderer, start_wire_copy
    from osm_renderer_tpu_torch.tools import kdevice

    device, detail = b.device, b.detail
    mini_bin, big_bin = (build_fixture(*corpus[city]) for city in ("minicity", "bigcity"))
    detail["fixture_bins"] = {"minicity": mini_bin, "bigcity": big_bin}
    render_cuda.RENDER_KERNEL_LAUNCHES = 0
    rle_cuda.EMIT_KERNEL_LAUNCHES = 0
    rle_cuda.EXPAND_KERNEL_LAUNCHES = 0

    styler = Styler(parse_file(STYLESHEET_DIR, "default.mapcss"), "josm")
    reader = GeodataReader.load(mini_bin)
    tiles = zoom_tiles(reader, 15)
    te = with_entities(reader, tiles)
    n_tiles = len(te)

    # --- the C++ oracle, one core (the reference's draw loop) ---
    cpu = CpuDrawer()
    cpu.draw_to_pixels(te[0][0], te[0][1], 1, styler)  # builds the library

    def oracle_pass():
        for ents, t in te:
            cpu.draw_to_pixels(ents, t, 1, styler)

    cpu_tps = b.record("cpu_oracle_tiles_per_sec_1core",
                       [n_tiles / b.host_s(oracle_pass) for _ in range(b.runs)])
    detail["cpu_cores"] = os.cpu_count()
    detail["n_mini_tiles"] = n_tiles

    # --- minicity on its own renderer (plain upload, as the JAX bench) ---
    mini = BatchRenderer(styler, stylesheet_dir=STYLESHEET_DIR, chunk_cache_tiles=1024,
                         device=device)
    mini.prepare(te, 1)  # the native assembler's first load
    cold, warm = [], []
    for _ in range(b.runs):
        mini.cache_clear()
        cold.append(1e3 * b.host_s(lambda: mini.prepare(te, 1)))
        warm.append(1e3 * b.host_s(lambda: mini.prepare(te, 1)))
    b.record("assembly_cold_ms_per_batch", cold)
    b.record("assembly_warm_ms_per_batch", warm)
    mini_preps = split_prepare(mini, te, 1)
    mini_samples = b.batch_ms(mini, mini_preps)
    b.record("device_ms_per_batch", mini_samples)
    b.record("minicity_30tile_tiles_per_sec", [n_tiles / s * 1e3 for s in mini_samples])
    mini_rgb = np.concatenate([CL.planar_to_rgb(mini.render_prepared_planar(p).cpu().numpy())
                               for p, _, _ in mini_preps])

    pngs = []
    b.record("png_encode_tiles_per_sec_1core", [
        n_tiles / b.host_s(lambda: pngs.extend(rgb_to_png(img, 1) for img in mini_rgb))
        for _ in range(b.runs)])
    idx = np.unique(np.linspace(0, n_tiles - 1, min(6, n_tiles)).round().astype(int))
    oracle = CpuDrawer(stylesheet_dir=STYLESHEET_DIR)
    worst = within_oracle(oracle, styler, [te[i] for i in idx], mini_rgb[idx])
    b.check("minicity_z15_oracle", worst <= 1,
            f"{len(idx)} minicity z15 tiles, labels off: max |diff| {worst}/255 against CpuDrawer")

    # --- bigcity (the headline) on a renderer of its own ---
    big_reader = GeodataReader.load(big_bin)
    big_te = with_entities(big_reader, zoom_tiles(big_reader, 15))
    big = BatchRenderer(styler, stylesheet_dir=STYLESHEET_DIR, chunk_cache_tiles=1024,
                        device=device)
    big_preps = split_prepare(big, big_te, 1)

    def render_big():
        return [big.render_prepared_planar(p) for p, _, _ in big_preps]

    big_samples = b.batch_ms(big, big_preps)
    b.record("big_ms_per_batch", big_samples)
    big_tps = b.record("z15_tiles_per_sec_per_chip", [len(big_te) / s * 1e3 for s in big_samples])
    detail["n_tiles"] = len(big_te)
    detail["big_batches"] = len(big_preps)
    detail["big_chunks"] = sum(int(p.batch.chunk_i.shape[0]) for p, _, _ in big_preps)
    got = np.concatenate([CL.planar_to_rgb(o.cpu().numpy()) for o in render_big()])
    want = fresh_render(styler, STYLESHEET_DIR, big_te, device)
    n_bad = int((got != want).any(-1).sum()) if got.shape == want.shape else -1
    b.check("bigcity_z15_fresh_renderer", n_bad == 0,
            f"bigcity z15 x{len(big_te)} against a renderer that caches nothing: "
            f"{n_bad} pixels differ")

    # The palette of the v2 wire is learned from a first v1 wire.
    big.fetch_tile_view(start_wire_copy(big.render_prepared_rle(big_preps[0][0])))

    def render_wire_big():
        return [big.render_prepared_rle(p) for p, _, _ in big_preps]

    if b.on_card:
        b.record("big_device_kernel_ms", [
            kdevice.device_ms_per_call(render_big, 8, ("render_kernel",), device)["ms"]
            for _ in range(b.runs)])
        b.record("big_device_ms_render_wire",
                 [kdevice.device_ms(render_wire_big) for _ in range(b.runs)])

    # --- @2x ---
    at2x = te[:AT2X_TILES]
    b.record("at2x_device_tiles_per_sec", [len(at2x) / s * 1e3 for s in
                                           b.batch_ms(mini, split_prepare(mini, at2x, 2))])

    # --- end to end, on the serving renderer (arena, tile bucket) ---
    srv = BatchRenderer(styler, stylesheet_dir=STYLESHEET_DIR, chunk_cache_tiles=256,
                        device=device, arena=True, tile_bucket=True)
    e2e = E2E(srv, reader, tiles, styler,
              Labeler(icon_base_path=STYLESHEET_DIR, label_cache_tiles=256))
    detail["e2e_settle_rounds"] = settle(srv, [lambda k=k: e2e.run(k) for k in E2E_KINDS])
    raw0 = srv.batch_counts["raw"]
    e2e.containers = {k: Counter() for k in E2E_KINDS}
    got = b.schedule(E2E_KINDS, {k: (lambda k=k: e2e.run(k, 1 if k.endswith("cold") else 2))
                                 for k in E2E_KINDS})
    for k in E2E_KINDS:
        b.record(f"e2e_tiles_per_sec.{k}", got[k])
    detail["e2e_png_containers"] = {k: dict(c) for k, c in e2e.containers.items()}
    detail["png_writer"] = PNG_WRITER
    detail["e2e_raw_batches_while_timed"] = srv.batch_counts["raw"] - raw0
    check_served(b, "e2e", e2e, E2E_KINDS, oracle,
                 Labeler(icon_base_path=STYLESHEET_DIR, label_cache_tiles=0))

    # --- the production stylesheet (osmosnimki-minimal, mapsme): warm
    # serial passes over the minicity z15 tiles, labels off and on, on a
    # renderer of its own (arena, no tile bucket, as the JAX bench) ---
    prod_styler = Styler(parse_file(PROD_DIR, PROD_SHEET), "mapsme")
    prod = BatchRenderer(prod_styler, stylesheet_dir=PROD_DIR, chunk_cache_tiles=256,
                         device=device, arena=True)
    prod_e2e = E2E(prod, reader, tiles, prod_styler,
                   Labeler(icon_base_path=PROD_DIR, label_cache_tiles=256))
    prod_e2e.run("labels_cold")  # fills the chunk and label caches
    prod_kinds = {"nolabels": lambda: prod_e2e.run("warm"),
                  "labels": lambda: prod_e2e.run("labels_warm")}
    detail["prod_settle_rounds"] = settle(prod, list(prod_kinds.values()))
    raw0 = prod.batch_counts["raw"]
    prod_e2e.containers = {k: Counter() for k in E2E_KINDS}
    got = b.schedule(tuple(prod_kinds), prod_kinds)
    b.record("prod_stylesheet_warm_nolabels_tiles_per_sec", got["nolabels"])
    b.record("prod_stylesheet_warm_labels_tiles_per_sec", got["labels"])
    detail["prod_png_containers"] = {k: dict(prod_e2e.containers[k])
                                     for k in ("warm", "labels_warm")}
    detail["prod_raw_batches_while_timed"] = prod.batch_counts["raw"] - raw0
    prod_oracle = CpuDrawer(stylesheet_dir=PROD_DIR)
    check_served(b, "prod", prod_e2e, ("warm", "labels_warm"), prod_oracle,
                 Labeler(icon_base_path=PROD_DIR, label_cache_tiles=0))
    z16 = zoom_tiles(reader, 16)
    mid = len(z16) // 2
    te16 = with_entities(reader, z16[mid:mid + 2])
    rgb16 = np.concatenate([CL.planar_to_rgb(prod.render_prepared_planar(p).cpu().numpy())
                            for p, _, _ in split_prepare(prod, te16, 1)])
    worst = within_oracle(prod_oracle, prod_styler, te16, rgb16)
    b.check("production_z16_oracle", worst <= 1,
            f"{len(te16)} production-stylesheet z16 tiles, labels off: max |diff| {worst}/255 "
            "against CpuDrawer")

    # --- the z12-z17 pyramid, one batch a zoom (split as the server
    # splits), then all of it folded ---
    batches = {}
    for key, group in pyramid_groups(reader).items():
        preps = split_prepare(mini, group, 1)
        batches[key] = len(preps)
        b.record(f"pyramid_tiles_per_sec.{key}",
                 [len(group) / s * 1e3 for s in b.batch_ms(mini, preps)])
    detail["pyramid_batches"] = batches

    detail["kernel_launches"] = {"render": render_cuda.RENDER_KERNEL_LAUNCHES,
                                 "emit": rle_cuda.EMIT_KERNEL_LAUNCHES,
                                 "expand": rle_cuda.EXPAND_KERNEL_LAUNCHES}
    b.renderers = {"minicity": mini, "bigcity": big, "serving": srv, "production": prod}
    detail["batch_counts"] = {name: dict(r.batch_counts) for name, r in b.renderers.items()}
    return {"metric": "z15_tiles_per_sec_per_chip", "value": big_tps, "unit": "tiles/s",
            "vs_baseline": big_tps / cpu_tps}


def parse_args(argv) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="Benchmark of the port: one JSON line.")
    ap.add_argument("--device", default="cuda", help="cuda, cuda:N, or cpu (the plain versions)")
    ap.add_argument("--seed", type=int, default=0, help="order of the timed e2e and "
                    "production runs")
    return ap.parse_args(argv)


def run(argv=None, *, corpus=CORPUS, runs: int = RUNS, reps: int = REPS):
    """The benchmark -> (its JSON line as a dict, the Bench).  The
    keyword arguments are the tests' tiny cities (`corpus`, as CORPUS)
    and counts.  Raises when the device cannot be had; any later failure
    gives a line with correct false and an `error`."""
    from osm_renderer_tpu_torch.utils.torch_setup import resolve_device

    args = parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    b = Bench(device, runs, reps, args.seed)
    line: Dict[str, object] = {"metric": "z15_tiles_per_sec_per_chip", "value": None,
                               "unit": "tiles/s", "vs_baseline": None}
    error: Optional[str] = None
    try:
        line["device"] = device_info(device)
        line.update(measure(b, corpus))
    except Exception as e:  # the line must still say the run is not correct
        traceback.print_exc()
        error = f"{type(e).__name__}: {e}"
    line.setdefault("device", {"platform": "gpu" if b.on_card else "cpu"})
    line["correct"] = error is None and bool(b.checks) and all(c["ok"] for c in b.checks)
    detail = dict(b.detail, backend=device.type, seed=args.seed, spread=b.spread,
                  checks=b.checks)
    if not b.on_card:
        for key in DEVICE_KEYS:
            detail[key] = None
            b.spread.pop(key, None)
    if error is not None:
        detail["error"] = error
    line["detail"] = detail
    return line, b


def main(argv=None, **kwargs) -> int:
    line, _ = run(argv, **kwargs)
    print(json.dumps(line), flush=True)
    return 0 if line["correct"] else 1


if __name__ == "__main__":
    sys.exit(main())
