"""PyTorch runtime configuration shared by serving, the chip smoke run
and the tests: device resolution, the kernel build directory and the
host-side native libraries.

The device is explicit.  Asking for CUDA on a host without it raises;
the CPU is used only when a caller names it (the tests do, to run the
kernels' plain versions).
"""

from __future__ import annotations

import os
import subprocess
import threading

import torch

_REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
_NATIVE_DIR = os.path.join(_REPO_ROOT, "native")
_CSRC_DIR = os.path.join(_REPO_ROOT, "osm_renderer_tpu_torch", "csrc")
_native_lock = threading.Lock()


def resolve_device(name: str = "cuda") -> torch.device:
    """`"cuda"`, `"cuda:N"` or `"cpu"` -> torch.device.  A CUDA name on
    a host without a usable card raises instead of falling back."""
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {name!r} requested but torch.cuda.is_available() is False"
            )
        index = dev.index if dev.index is not None else torch.cuda.current_device()
        if index >= torch.cuda.device_count():
            raise RuntimeError(
                f"device {name!r} requested but only "
                f"{torch.cuda.device_count()} CUDA device(s) are visible"
            )
        return torch.device("cuda", index)
    if dev.type != "cpu":
        raise ValueError(f"unsupported device {name!r} (use 'cuda' or 'cpu')")
    return dev


def build_dir() -> str:
    """Where compiled kernels go: `$OSMR_TORCH_BUILD_DIR`, else
    `build/kernels/` at the repository root (listed in .gitignore)."""
    path = os.environ.get("OSMR_TORCH_BUILD_DIR") or os.path.join(
        _REPO_ROOT, "build", "kernels"
    )
    os.makedirs(path, exist_ok=True)
    return path


# The host C++ libraries the port builds: name -> (source directory,
# source, link flags).  `native/`'s are the JAX package's sources; the
# port's own host code is in its `csrc/`.  The compile flags are
# `native/Makefile`'s.
_HOST_LIBS = {
    "oracle": (_NATIVE_DIR, "oracle.cpp", ()),
    "assembler": (_NATIVE_DIR, "assembler.cpp", ()),
    "pngenc": (_NATIVE_DIR, "pngenc.cpp", ("-ldeflate",)),
    "wirehost": (_CSRC_DIR, "wire_host.cpp", ()),
}
HOST_CXXFLAGS = ["-O2", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-ffp-contract=off", "-shared"]
_host_paths: dict = {}


def host_lib_path(name: str) -> str:
    """Path of the port's build of the host library `name` ("oracle",
    "assembler", "pngenc" or "wirehost"), compiled on first use.
    Raises when the build fails (pngenc needs libdeflate).

    The library goes to the kernel build directory under a name hashed
    from its source and flags, never to `native/`, whose libraries the
    JAX package's loaders build in place with `make`.  It is compiled to
    a temporary name and renamed into place under an `fcntl` lock on
    `host_libs.lock` in the build directory, so no process, in this one or another, loads a
    library the port has half written, and several processes build it
    once."""
    got = _host_paths.get(name)
    if got is not None:
        return got
    import fcntl
    import hashlib

    src_dir, source, libs = _HOST_LIBS[name]
    src_path = os.path.join(src_dir, source)
    flags = HOST_CXXFLAGS + list(libs)
    with open(src_path, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(flags).encode()).hexdigest()[:16]
    path = os.path.join(build_dir(), f"libosmr_{name}_{digest}.so")
    with _native_lock:
        if not os.path.exists(path):
            with open(os.path.join(build_dir(), "host_libs.lock"), "w") as lock:
                fcntl.flock(lock, fcntl.LOCK_EX)
                if not os.path.exists(path):
                    tmp = f"{path}.{os.getpid()}.tmp"
                    proc = subprocess.run(["g++", *HOST_CXXFLAGS, "-o", tmp, src_path, *libs],
                                          capture_output=True, text=True)
                    if proc.returncode != 0:
                        if os.path.exists(tmp):
                            os.remove(tmp)
                        raise RuntimeError(
                            f"building {src_path} failed:\n{proc.stdout}\n{proc.stderr}")
                    os.replace(tmp, path)
        _host_paths[name] = path
    return path


def build_native_host_libs() -> None:
    """Build the C++ oracle and chunk assembler of `native/` and the
    port's wire decoder (`csrc/wire_host.cpp`) for the port
    (`host_lib_path`).  The libdeflate PNG encoder is built apart, by the
    copied PNG writer, which falls back to zlib without it.  Raises when a
    build fails."""
    for name in ("oracle", "assembler", "wirehost"):
        host_lib_path(name)


def next_pow2(n: int, minimum: int = 1) -> int:
    v = max(n, minimum)
    return 1 << (v - 1).bit_length()
