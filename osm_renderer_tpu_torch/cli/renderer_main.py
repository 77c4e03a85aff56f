"""Renderer CLI: `python -m osm_renderer_tpu_torch.cli.renderer_main CONFIG [OSM_IDS...]`.

Same INI surface as `osm_renderer_tpu.cli.renderer_main`:

    [http]
    address = 127.0.0.1:8080
    [geodata]
    file = city.bin
    [style]
    file = stylesheet/main.mapcss
    type = josm            ; or mapsme
    font-mul = 1.5         ; optional

    [render]
    backend = device       ; the default; or cpu (the C++ oracle, no GPU)
    device = cuda          ; first CUDA device for backend = device (cuda, cuda:N)
    gpus = 1               ; serve on this many GPUs from `device` on, one
                           ; renderer each (precision = exact: the first only)
    precision = fast       ; fast, or exact (the dense f64 renderer)
    png-level = 1
    labels = yes
    png-cache = 512
    warmup = yes           ; render a few tiles before accepting traffic

An INI without a `backend` line serves from the card (`device`
defaults to `cuda`); `backend = cpu` is the way to ask for the oracle.
`gpus` above the CUDA devices visible from `device` on, or below 1, is
refused: the server never serves on fewer devices than it was asked
for.  With backend = device, the server prints, when it shuts down, the
launches of each kernel made while serving (render, run emit, palette
expand; then the dense kernels of `precision = exact`, in all and by
kernel) and, summed over its renderers, the batches it served by path:
arena or plain upload or dense (`precision = exact`), and v1 wire, v2
wire or raw planar readback, beside the tiles whose labels were blended
on the device (`labeled_tiles`), then the tiles each renderer rendered
(`tiles by renderer while serving: 0@cuda:0=N ...`), then the host codec
and the PNG containers of the device tiles served
(`png writer: port (zlib); containers while serving: png8=N
rgb_overflow=N rgb_v1=N rgb_raw=N rgb_host_labels=N`).  Both backends run the
port's own server and labeler and need neither jax nor fontTools.
"""

from __future__ import annotations

import asyncio
import configparser
import os
import sys
from collections import Counter


def _require(config: configparser.ConfigParser, section: str, name: str) -> str:
    try:
        return config[section][name]
    except KeyError:
        print(f"Property {name} is missing in section [{section}]", file=sys.stderr)
        raise SystemExit(1)


def service_from_config(config: configparser.ConfigParser, osm_ids=None):
    """The tile service an INI asks for -> (service, backend).  Without a
    `backend` line it serves from the card.  Prints the fault and raises
    SystemExit(1) on a missing property or an unknown stylesheet type or
    backend."""
    geodata_file = _require(config, "geodata", "file")
    stylesheet_file = _require(config, "style", "file")
    stylesheet_type = _require(config, "style", "type")
    if stylesheet_type not in ("josm", "mapsme"):
        print(f"Unknown stylesheet type: {stylesheet_type}", file=sys.stderr)
        raise SystemExit(1)
    font_mul = None
    if config.has_option("style", "font-mul"):
        font_mul = float(config["style"]["font-mul"])

    backend = config.get("render", "backend", fallback="device")
    device = config.get("render", "device", fallback="cuda")
    gpus = int(config.get("render", "gpus", fallback="1"))
    precision = config.get("render", "precision", fallback="fast")
    png_level = int(config.get("render", "png-level", fallback="1"))
    labels = config.getboolean("render", "labels", fallback=True)
    png_cache = int(config.get("render", "png-cache", fallback="512"))
    if backend not in ("cpu", "device"):
        print(f"Unknown render backend: {backend}", file=sys.stderr)
        raise SystemExit(1)

    from osm_renderer_tpu_torch.mapcss.parser import parse_file
    from osm_renderer_tpu_torch.mapcss.styler import Styler
    from osm_renderer_tpu_torch.server.http import TileService

    base_path, file_name = os.path.split(stylesheet_file)
    styler = Styler(parse_file(base_path, file_name), stylesheet_type, font_mul)
    if backend == "device":
        service = TileService(
            geodata_file, styler, base_path, osm_ids=osm_ids, enable_labels=labels,
            precision=precision, png_level=png_level, png_cache_tiles=png_cache,
            device=device, gpus=gpus,
        )
        if precision == "exact" and gpus > 1:
            print(f"precision = exact serves on the first device only ({service.device}), "
                  f"not on gpus = {gpus}", flush=True)
    else:
        # The C++ oracle on the CPU, one tile a request (needs no GPU).
        service = TileService(
            geodata_file, styler, base_path, backend="cpu", osm_ids=osm_ids,
            enable_labels=labels, png_level=png_level, png_cache_tiles=png_cache,
        )
    return service, backend


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) < 1:
        print("Usage: renderer CONFIG [OSM_IDS]", file=sys.stderr)
        return 1

    config = configparser.ConfigParser()
    if not config.read(argv[0]):
        print(f"Failed to parse config from {argv[0]}", file=sys.stderr)
        return 1

    address = _require(config, "http", "address")
    osm_ids = {int(x) for x in argv[1:]} if len(argv) > 1 else None
    try:
        service, backend = service_from_config(config, osm_ids)
    except SystemExit as e:
        return int(e.code)
    except ValueError as e:  # a setting the service refuses, such as gpus
        print(f"ValueError: {e}", file=sys.stderr)
        return 1

    from osm_renderer_tpu_torch.ops import dense_cuda, render_cuda, rle_cuda
    from osm_renderer_tpu_torch.draw import png8
    from osm_renderer_tpu_torch.server.http import CONTAINERS, run_server

    if backend == "device":
        if config.getboolean("render", "warmup", fallback=True):
            print("Warming up the device path...")
            print(f"Warmed {service.warmup()} tiles", flush=True)
        render_cuda.RENDER_KERNEL_LAUNCHES = 0
        rle_cuda.EMIT_KERNEL_LAUNCHES = 0
        rle_cuda.EXPAND_KERNEL_LAUNCHES = 0
        dense_cuda.DENSE_KERNEL_LAUNCHES.update(dict.fromkeys(dense_cuda.KERNELS, 0))
        for r in service.batch_renderers:
            for counts in (r.batch_counts, r.readback_bytes):
                counts.update(dict.fromkeys(counts, 0))
        service.tiles_by_renderer.clear()
        service.containers.clear()
        devices = ", ".join(str(r.device) for r in service.batch_renderers)
        print(f"Serving tiles on http://{address} (backend={backend}, "
              f"{len(service.batch_renderers)} renderer(s) on {devices})", flush=True)
    else:
        print(f"Serving tiles on http://{address} (backend={backend})", flush=True)
    try:
        asyncio.run(run_server(address, service))
    finally:
        service.close()
    if backend == "device":
        print(f"render kernel launches while serving: {render_cuda.RENDER_KERNEL_LAUNCHES}")
        print(f"emit kernel launches while serving: {rle_cuda.EMIT_KERNEL_LAUNCHES}")
        print(f"expand kernel launches while serving: {rle_cuda.EXPAND_KERNEL_LAUNCHES}")
        dense = dense_cuda.DENSE_KERNEL_LAUNCHES
        print(f"dense kernel launches while serving: {sum(dense.values())}")
        print("dense kernel launches by kernel while serving: "
              + " ".join(f"{k}={v}" for k, v in dense.items()))
        for label, what in (("batches", "batch_counts"), ("readback bytes", "readback_bytes")):
            total = Counter()
            for r in service.batch_renderers:
                total.update(getattr(r, what))
            keys = getattr(service.batch_renderer, what)  # every key, in its order
            print(f"{label} while serving: " + " ".join(f"{k}={total[k]}" for k in keys))
        print("tiles by renderer while serving: " + " ".join(
            f"{i}@{r.device}={service.tiles_by_renderer[i]}"
            for i, r in enumerate(service.batch_renderers)))
        print(f"png writer: {png8.WRITER}; containers while serving: " + " ".join(
            f"{k}={service.containers[k]}" for k in CONTAINERS))
        sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
