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
_native_lock = threading.Lock()
_native_built = False


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


def build_native_host_libs() -> None:
    """Build the C++ oracle and chunk assembler of `native/` by name.

    `make -C native` with no target also builds the libdeflate PNG
    encoder and stops at the first failure, so on a host without
    libdeflate it would leave the assembler unbuilt.  Naming the two
    targets keeps them independent of it; the PNG writer falls back to
    zlib by itself when its encoder cannot be built.  Raises when the
    build fails."""
    global _native_built
    if _native_built:
        return
    with _native_lock:
        if _native_built:
            return
        proc = subprocess.run(
            ["make", "-C", _NATIVE_DIR, "libosmr_oracle.so", "libosmr_assembler.so"],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                "building native/libosmr_oracle.so and libosmr_assembler.so "
                f"failed:\n{proc.stdout}\n{proc.stderr}"
            )
        _native_built = True


def next_pow2(n: int, minimum: int = 1) -> int:
    v = max(n, minimum)
    return 1 << (v - 1).bit_length()
