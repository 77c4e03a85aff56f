"""Run one cell of the benchmark once.

    python3 -m tilebench.run --workload CELL --seed N --seconds S --trace 0|1

The cell, its configuration (`tilebench/configs/<config>.json`), its
traffic (`tilebench/traffic/<traffic>.json`) and its metrics (one file
each under `tilebench/metrics/`) are found by the names that
`BENCHMARK.json` gives.  The run builds (or finds) the city, starts the
program's tile service and HTTP server in this process on an ephemeral
port, warms the hot set, and then a child process sends the cell's
traffic for S seconds.  After the window it reads the metrics, frees the
program and compares what was served with the plain reference
(`tilebench/reference.py`).  Standard output's last line is the result;
standard error ends with each number compared beside its limit.  It
exits 2 without a result when no CUDA device (or too few) is visible,
and 3 when the JAX package or JAX was loaded.
"""

from __future__ import annotations

import time

T_PROCESS = time.monotonic()

import argparse  # noqa: E402
import asyncio  # noqa: E402
import configparser  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import shutil  # noqa: E402
import socket  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import threading  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "osm_renderer_tpu")
WARM_SEED = 97  # the warm batches: the same set-up for every run
WARM_BATCHES = 16
CHECK_SEED = 7919


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


# ---------------------------------------------------------------- discovery


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(bench: dict, workload: str, base: str = HERE) -> Cell:
    """The cell `workload` of `bench` (BENCHMARK.json), with its
    configuration and traffic files read and the metrics it reports."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json ({sorted(cells)})")
    w = cells[workload]
    return Cell(
        name=workload, chips=int(w["chips"]),
        config_name=w["config"],
        config=load_json(os.path.join(base, "configs", w["config"] + ".json")),
        traffic_name=w["traffic"],
        traffic=load_json(os.path.join(base, "traffic", w["traffic"] + ".json")),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, workload)],
    )


def metric_reader(name: str, base: str = HERE):
    """The `read(window)` function of `tilebench/metrics/<name>.py`."""
    path = os.path.join(base, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(f"tilebench_metric_{name}", path)
    if spec is None or not os.path.exists(path):
        raise SystemExit(f"no reader for metric {name!r} ({path})")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# ---------------------------------------------------------------- the window


@dataclass
class Window:
    """What the metric readers read: the window and what it recorded."""
    seconds: float
    t0: float
    records: list
    setup_s: float
    spans: Dict[str, float] = field(default_factory=dict)
    tiles_done: int = 0
    batches: List[int] = field(default_factory=list)
    trace: Optional[dict] = None


def perf_snapshot(service):
    """(seconds by span name, tiles finished), summed over zooms."""
    spans: Dict[str, float] = {}
    with service._perf_lock:
        for root in service.perf_stats.by_zoom.values():
            for name, node in root.children.items():
                spans[name] = spans.get(name, 0.0) + node.total
        tiles = sum(service.perf_stats.tile_counts.values())
    return spans, tiles


def thread_cpu() -> Dict[int, float]:
    """CPU seconds of each thread of this process (Linux's /proc), by
    thread id; empty where /proc is not there."""
    out: Dict[int, float] = {}
    tick = os.sysconf("SC_CLK_TCK") if hasattr(os, "sysconf") else 100
    try:
        for tid in os.listdir("/proc/self/task"):
            with open(f"/proc/self/task/{tid}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
            out[int(tid)] = (int(fields[11]) + int(fields[12])) / tick
    except OSError:
        pass
    return out


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Server:
    """The program's HTTP server (`server/http.py::run_server`) on its own
    thread and event loop, in this process."""

    def __init__(self, service, batch_window_ms: float, max_batch: int):
        from osm_renderer_tpu_torch.server.http import run_server

        self.port = free_port()
        self.error: Optional[BaseException] = None

        def serve():
            try:
                asyncio.run(run_server(f"127.0.0.1:{self.port}", service,
                                       batch_window_ms=batch_window_ms, max_batch=max_batch))
            except BaseException as e:  # reported by stop()
                self.error = e

        self.thread = threading.Thread(target=serve, name="tilebench-server", daemon=True)
        self.thread.start()
        deadline = time.monotonic() + 60
        while True:
            try:
                socket.create_connection(("127.0.0.1", self.port), timeout=1).close()
                return
            except OSError:
                if time.monotonic() > deadline or not self.thread.is_alive():
                    raise RuntimeError(f"the server did not start: {self.error!r}")
                time.sleep(0.05)

    def stop(self) -> None:
        with socket.create_connection(("127.0.0.1", self.port), timeout=10) as s:
            s.sendall(b"GET /shutdown HTTP/1.1\r\nHost: localhost\r\n\r\n")
            s.recv(1024)
        self.thread.join(timeout=120)
        if self.thread.is_alive():
            raise RuntimeError("the server did not stop")
        if self.error is not None:
            raise RuntimeError(f"the server failed: {self.error!r}")


# ---------------------------------------------------------------- set-up


def make_service(cfg: dict, program_bin: str, device: str):
    """The program's tile service, made from an INI as its CLI makes it
    (`cli/renderer_main.py::service_from_config`)."""
    from osm_renderer_tpu_torch.cli.renderer_main import service_from_config

    ini = configparser.ConfigParser()
    ini["geodata"] = {"file": program_bin}
    ini["style"] = {"file": os.path.join(HERE, "configs", cfg["style"]["file"]),
                    "type": cfg["style"]["type"]}
    ini["render"] = {k: str(v) for k, v in cfg["render"].items()}
    ini["render"]["device"] = device
    with contextlib.redirect_stdout(sys.stderr):
        service, backend = service_from_config(ini)
    if backend != "device":
        raise SystemExit(f"the configuration serves with backend {backend!r}, not 'device'")
    return service


def warm(service, ranking, traffic: dict, max_batch: int) -> None:
    """Render the hot set (padded to whole batches), then `WARM_BATCHES`
    batches of `max_batch` requests drawn from the traffic's law with a
    fixed seed: the full batches that the closed loop makes."""
    from osm_renderer_tpu_torch.core.tile import Tile
    from tilebench import traffic as traffic_mod

    reqs = [(Tile(z, x, y), s) for z, x, y, s in ranking]
    hot = reqs + reqs[:-len(reqs) % max_batch]
    seq = traffic_mod.request_sequence(len(reqs), traffic, WARM_SEED, WARM_BATCHES * max_batch)
    batches = [hot[i:i + max_batch] for i in range(0, len(hot), max_batch)]
    batches += [[reqs[i] for i in seq[j:j + max_batch]] for j in range(0, len(seq), max_batch)]
    for b in batches:
        service.render_tiles_device(b)


# ---------------------------------------------------------------- checks


def judge(ranking, records, bodies, check: dict, seed: int, reference, limit_override=None):
    """-> {name: (value, limit)} of the numbers compared: requests never
    answered (or answered with an error), keys answered with two
    different images, and the widest gap in u8 levels between a sampled
    served tile and the plain reference."""
    from tilebench import pngdec, readers

    unanswered = sum(1 for r in records if r[readers.STATUS] != 200)
    by_key: Dict[int, List[bytes]] = {}
    for name, body in bodies.items():
        by_key.setdefault(int(name.split(":")[0]), []).append(body)
    served: Dict[int, object] = {}
    inconsistent = 0
    for k, bs in sorted(by_key.items()):
        try:
            imgs = [pngdec.decode(b) for b in bs]
        except ValueError:
            inconsistent += 1
            continue
        if any(im.shape != imgs[0].shape or (im != imgs[0]).any() for im in imgs[1:]):
            inconsistent += 1
            continue
        served[k] = imgs[0]
    keys = sorted(by_key)
    rng = random.Random(int(seed) * CHECK_SEED + 1)
    sample = set(rng.sample(keys, min(int(check["sample_tiles"]), len(keys))))
    if keys:
        sample.add(max(keys, key=lambda k: max(len(b) for b in by_key[k])))
    gap = 0
    for k in sorted(sample):
        if k not in served:
            gap = 255
            continue
        ref = reference.render(tuple(ranking[k]), "exact")
        got = served[k]
        if got.shape != ref.shape:
            gap = 255
            continue
        gap = max(gap, int(abs(got.astype(int) - ref.astype(int)).max()))
    limit = check["ref_gap_limit"] if limit_override is None else limit_override
    return {"unanswered": (unanswered, 0), "inconsistent": (inconsistent, 0),
            "ref_gap": (gap, limit)}, sorted(sample)


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


# ---------------------------------------------------------------- one run


def read_loadgen(prefix: str):
    with open(prefix + ".json") as f:
        out = json.load(f)
    bodies = {}
    with open(prefix + ".bodies", "rb") as f:
        data = f.read()
    for name, (off, n) in out["bodies"].items():
        bodies[name] = data[off:off + n]
    return out["records"], bodies


def set_up(cell: Cell, device: str, city: Optional[dict] = None):
    """The city, the hot set in popularity order, and the program's
    service with the hot set warm -> (city files, ranking, service)."""
    from tilebench import traffic as traffic_mod
    from tilebench.city import ensure_city
    from tilebench.ref.geodata.reader import GeodataReader

    cfg, tr = cell.config, cell.traffic
    files = ensure_city(city or cfg["city"])
    reader = GeodataReader.load(files.reference_bin)
    xy = list(zip(reader.tiles["x"].tolist(), reader.tiles["y"].tolist()))
    ranking = traffic_mod.ranked(traffic_mod.hot_keys(xy, tr["zooms"], tr["scales"]),
                                 tr["ranking_seed"])
    service = make_service(cfg, files.program_bin, device)
    warm(service, ranking, tr, int(cfg["server"]["max_batch"]))
    log(f"warm: {len(ranking)} keys and {WARM_BATCHES} batches")
    return files, ranking, service


def warm_batch(service, ranking, max_batch: int) -> None:
    """One batch of the hot set, waited for."""
    from osm_renderer_tpu_torch.core.tile import Tile

    service.render_tiles_device([(Tile(z, x, y), s) for z, x, y, s in ranking[:max_batch]])


def send(port: int, ranking, tr: dict, seed: int, seconds: float, at_open=None,
         at_close=None, loadgen_cpus=None):
    """Hand the plan to a load generator child process and open the
    window one second later -> (t0, records, bodies).  `at_open(t0)` and
    `at_close()` run at the window's two ends, in this thread."""
    from tilebench import traffic as traffic_mod

    tmp = tempfile.mkdtemp(prefix="tilebench-")
    try:
        plan_path = os.path.join(tmp, "plan.json")
        with open(plan_path, "w") as f:
            json.dump(traffic_mod.plan(ranking, tr, seed, seconds), f)
        prefix = os.path.join(tmp, "loadgen")
        t0 = time.monotonic() + 1.0
        child = subprocess.Popen(
            [sys.executable, "-m", "tilebench.loadgen", plan_path, str(port), repr(t0), prefix,
             ",".join(map(str, loadgen_cpus or ()))],
            cwd=ROOT, stdin=subprocess.DEVNULL, stdout=subprocess.DEVNULL)
        try:
            time.sleep(max(0.0, t0 - time.monotonic()))
            if at_open is not None:
                at_open(t0)
            time.sleep(max(0.0, t0 + seconds - time.monotonic()))
            if at_close is not None:
                at_close()
            child.wait(timeout=seconds + 180)
        finally:
            if child.poll() is None:
                child.kill()
                child.wait()
        if child.returncode != 0:
            raise RuntimeError(f"the load generator exited with {child.returncode}")
        records, bodies = read_loadgen(prefix)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return t0, records, bodies


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device: str,
             t_process: float = T_PROCESS, city: Optional[dict] = None,
             sample_tiles: Optional[int] = None, fault=None, loadgen_cpus=None) -> dict:
    """One run of `cell` -> the result line's object.  `city` and
    `sample_tiles` replace the configuration's (the tests' small sizes);
    `fault(service)`, when given, breaks the program after the warm-up
    (the tests' planted faults) or puts the control in its place."""
    import torch

    from tilebench import readers
    from tilebench.probes import Probes
    from tilebench.reference import Reference

    cfg, tr = cell.config, cell.traffic
    files, ranking, service = set_up(cell, device, city)
    server_cfg = cfg["server"]
    if fault is not None:
        fault(service)
    probes = Probes()
    if trace:
        probes.install(service)
    server = Server(service, float(server_cfg["batch_window_ms"]), int(server_cfg["max_batch"]))
    prof = None
    snaps = []

    def at_open(t0):
        snaps.append(perf_snapshot(service) + (time.process_time(), thread_cpu()))

    def at_close():
        snaps.append(perf_snapshot(service) + (time.process_time(), thread_cpu()))
        if prof is not None:
            prof.__exit__(None, None, None)

    if trace:
        from torch.profiler import ProfilerActivity, profile

        # The device's activity only: host operators are not recorded.
        # A first trace can miss device operations, so one is thrown
        # away around a warm batch.
        acts = [ProfilerActivity.CUDA] if device != "cpu" else [ProfilerActivity.CPU]
        with profile(activities=acts):
            warm_batch(service, ranking, int(server_cfg["max_batch"]))
        prof = profile(activities=acts)
        prof.__enter__()
    t0, records, bodies = send(server.port, ranking, tr, seed, seconds, at_open, at_close,
                               loadgen_cpus)
    setup_s = t0 - t_process
    (span0, tiles0, cpu0, th0), (span1, tiles1, cpu1, th1) = snaps
    busiest = sorted((th1[t] - th0.get(t, 0.0) for t in th1), reverse=True)[:4]
    per_tile = {k: round(1e3 * (span1[k] - span0.get(k, 0.0)) / max(tiles1 - tiles0, 1), 4)
                for k in span1}
    log(f"window: {tiles1 - tiles0} tiles finished, {cpu1 - cpu0:.1f} s of this process's CPU "
        f"in {threading.active_count()} threads (busiest {busiest} s); spans ms a tile "
        f"{per_tile}; since start: containers {dict(service.containers)}, batches "
        f"{[dict(r.batch_counts) for r in service.batch_renderers]}")
    window = Window(seconds=seconds, t0=t0, records=records, setup_s=setup_s)
    dev_info = {"platform": "gpu" if device != "cpu" else "cpu",
                "kind": torch.cuda.get_device_name(0) if device != "cpu" else "cpu",
                "count": 1,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated(0))
                if device != "cpu" else 0}
    breakdown = None
    if trace:
        from tilebench import trace as trace_mod

        offset = time.time_ns() - time.monotonic_ns()
        w0 = int(t0 * 1e9) + offset
        w1 = w0 + int(seconds * 1e9)
        red = trace_mod.reduce(trace_mod.device_ops(prof), probes.intervals, w0, w1)
        red["render_bound_s"] = probes.render_bound_s(w0, w1)
        red["wire_bound_s"] = probes.wire_bound_s(w0, w1)
        window.trace = red
        window.spans = {k: span1.get(k, 0.0) - span0.get(k, 0.0) for k in span1}
        window.tiles_done = tiles1 - tiles0
        window.batches = [n for s, e, n in probes.batches if w0 <= s < w1]
        dev_info["busy_s"] = red["busy_s"]
        dev_info["window_s"] = red["window_s"]
        breakdown = {"device_ops": [[k, v] for k, v in red["device_ops"]],
                     "idle_gaps": red["idle_gaps"]}
        probes.uninstall()
    server.stop()

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = metric_reader(m["name"])(window)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        elif not trace:
            raise RuntimeError(f"end-to-end metric {m['name']} read nothing")

    # The program's state is freed before the reference runs on the card.
    del service, server, probes
    gc.collect()
    if device != "cpu":
        torch.cuda.empty_cache()
    reference = Reference(files.reference_bin, os.path.join(HERE, "configs", cfg["style"]["file"]),
                          cfg["style"]["type"], device)
    check = dict(cfg["check"])
    if sample_tiles is not None:
        check["sample_tiles"] = sample_tiles
    t_ref = time.monotonic()
    numbers, sample = judge(ranking, records, bodies, check, seed, reference)
    log(f"reference: {len(sample)} tiles in {time.monotonic() - t_ref:.1f} s")
    result = {
        "correct": all(v <= lim for v, lim in numbers.values()),
        "attempted": len(records),
        "failed": sum(1 for r in records if r[readers.STATUS] != 200),
        "metrics": metrics,
        "device": dev_info,
    }
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["check"] = {k: {"value": v, "limit": lim} for k, (v, lim) in numbers.items()}
    return result


def split_cpus() -> Optional[List[int]]:
    """Give the load generator, which stands in for clients on other
    hosts, the last two of this process's CPUs, and keep this process's
    threads (the server's) on the rest, so that neither takes the
    other's cores -> the load generator's CPUs; None, and nothing
    changed, with fewer than four."""
    cpus = sorted(os.sched_getaffinity(0))
    if len(cpus) < 4:
        return None
    for tid in os.listdir("/proc/self/task"):
        os.sched_setaffinity(int(tid), cpus[:-2])
    return cpus[-2:]


def use_checkout_caches() -> None:
    """The program's kernel builds, and PyTorch's and Triton's caches, in
    fixed directories of the checkout."""
    for var, sub in (("OSMR_TORCH_BUILD_DIR", "kernels"), ("TORCH_EXTENSIONS_DIR",
                     "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(ROOT, "build", sub)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = find_cell(load_json(os.path.join(ROOT, "BENCHMARK.json")), args.workload)
    use_checkout_caches()
    loadgen_cpus = split_cpus()

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"tilebench: {cell.name} needs {cell.chips} CUDA device(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible")
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                      loadgen_cpus=loadgen_cpus)
    bad = forbidden_modules()
    if bad:
        log(f"tilebench: loaded in the run's process: {', '.join(bad)}")
        return 3
    for name, c in result["check"].items():
        log(f"check {name} {c['value']} limit {c['limit']}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
