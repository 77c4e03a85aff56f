"""Build and bind the port's CUDA kernels.

Each kernel source under `csrc/` exposes a plain C entry point; it is
compiled with nvcc for sm_90a into a shared library in the kernel build
directory (`utils.torch_setup.build_dir`) at first use, named by a hash
of the source and the flags (an edited source rebuilds), and loaded
with ctypes.  Pointers and the stream go in as `c_void_p`, and the
entry point returns `cudaGetLastError()` after its launch.  Nothing is
built when this module is imported, and a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, List

from osm_renderer_tpu_torch.utils.torch_setup import build_dir

CSRC_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")

# -fmad=false: see the floating-point note at the top of csrc/render.cu.
NVCC_FLAGS: List[str] = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
    "-fmad=false",
]

# Seconds spent in nvcc per source by this process (0.0 when the
# library was already built), and ptxas's resource report when asked.
BUILD_SECONDS: Dict[str, float] = {}
PTXAS_REPORT: Dict[str, str] = {}

_libs: Dict[str, ctypes.CDLL] = {}
_locks: Dict[str, threading.Lock] = {}
_locks_guard = threading.Lock()


def nvcc_path() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cands = []
    if CUDA_HOME:
        cands.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    for c in cands:
        if os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def load_library(source: str, ptxas_verbose: bool = False) -> ctypes.CDLL:
    """Compile `csrc/<source>` (once per content hash) and load it.
    Different sources build in parallel when called from several
    threads."""
    with _locks_guard:
        lock = _locks.setdefault(source, threading.Lock())
    with lock:
        lib = _libs.get(source)
        if lib is not None:
            return lib
        src_path = os.path.join(CSRC_DIR, source)
        with open(src_path, "rb") as f:
            digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        stem = os.path.splitext(source)[0]
        so_path = os.path.join(build_dir(), f"{stem}_{digest}.so")
        BUILD_SECONDS[source] = 0.0
        if not os.path.exists(so_path) or ptxas_verbose:
            flags = NVCC_FLAGS + (["-Xptxas", "-v"] if ptxas_verbose else [])
            tmp = f"{so_path}.{os.getpid()}.tmp"
            t0 = time.perf_counter()
            proc = subprocess.run(
                [nvcc_path(), *flags, "-o", tmp, src_path],
                capture_output=True, text=True,
            )
            BUILD_SECONDS[source] = time.perf_counter() - t0
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed to build {src_path}:\n{proc.stdout}\n{proc.stderr}"
                )
            if ptxas_verbose:
                PTXAS_REPORT[source] = proc.stderr
            os.replace(tmp, so_path)
        lib = ctypes.CDLL(so_path)
        _libs[source] = lib
        return lib


def render_library(ptxas_verbose: bool = False) -> ctypes.CDLL:
    return bind_render(load_library("render.cu", ptxas_verbose))


def bind_render(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare csrc/render.cu's entry points on a loaded build of it."""
    fn = lib.osmr_render_planar
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int]           # geom..items, items_stride
        + [ctypes.c_void_p] * 9                          # rows, isec..tile_range
        + [ctypes.c_void_p] * 2 + [ctypes.c_int]         # label_tri, label_plane, its rows
        + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]  # out, n_tiles, ts
        + [ctypes.c_void_p] * 3                          # stream, t_start, t_end
    )
    lib.osmr_render_occupancy.restype = ctypes.c_int
    lib.osmr_render_occupancy.argtypes = [ctypes.POINTER(ctypes.c_int)] * 3
    return lib


def rle_library(ptxas_verbose: bool = False) -> ctypes.CDLL:
    lib = load_library("rle.cu", ptxas_verbose)
    P, I = ctypes.c_void_p, ctypes.c_int
    # planar, T, ts, seg_px, [table,] wire and scratch, cap, stream, t_start, t_end
    lib.osmr_rle_wire_v1.argtypes = [P, I, I, I, P, I, P, P, P]
    lib.osmr_rle_wire_v2.argtypes = [P, I, I, I, P, P, I, P, P, P]
    for fn in (lib.osmr_rle_wire_v1, lib.osmr_rle_wire_v2):
        fn.restype = ctypes.c_int
    return lib


def dense_constants() -> tuple:
    """The constants csrc/dense.cu's osmr_dense_constants must report, in
    its order."""
    from osm_renderer_tpu_torch.ops import dense_cuda as DC
    from osm_renderer_tpu_torch.ops import render_dense as RD

    return (DC.N_PTRS, DC.N_DIMS, DC.FILL_PAIRS, DC.FILL_WARPS, DC.UNIT_SIDE, DC.TABLE_COLS,
            RD.WINDOW_COORD_BOUND["exact"], RD.WINDOW_COORD_BOUND["fast"], DC.FILL_MAX_ROWS)


def dense_library(ptxas_verbose: bool = False) -> ctypes.CDLL:
    lib = load_library("dense.cu", ptxas_verbose)
    P, I = ctypes.c_void_p, ctypes.c_int
    # ptrs, dims, exact, [chain,] stream, t_start, t_end
    lib.osmr_dense_stroke_alpha.argtypes = [P, P, I, I, P, P, P]
    lib.osmr_dense_fill_alpha.argtypes = [P, P, I, P, P, P]
    lib.osmr_dense_blend_finalize.argtypes = [P, P, I, P, P, P]
    lib.osmr_dense_kernel_attrs.argtypes = [I, P]
    for fn in (lib.osmr_dense_stroke_alpha, lib.osmr_dense_fill_alpha,
               lib.osmr_dense_blend_finalize, lib.osmr_dense_kernel_attrs,
               lib.osmr_dense_constants):
        fn.restype = ctypes.c_int
    lib.osmr_dense_constants.argtypes = [P]
    want = dense_constants()
    got = (ctypes.c_int64 * len(want))()
    lib.osmr_dense_constants(got)
    if tuple(got) != want:
        raise RuntimeError(f"csrc/dense.cu's constants {tuple(got)} differ from "
                           f"ops/dense_cuda.py's {want}")
    return lib


def build_all(ptxas_verbose: bool = False) -> None:
    """Build every kernel library at once: one nvcc per source, all
    started together.  Raises the first build failure."""
    from concurrent.futures import ThreadPoolExecutor

    loaders = (render_library, rle_library, dense_library)
    with ThreadPoolExecutor(len(loaders)) as ex:
        for fut in [ex.submit(load, ptxas_verbose) for load in loaders]:
            fut.result()
