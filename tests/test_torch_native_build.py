"""The port's build of the C++ host libraries (`utils/torch_setup.
host_lib_path`): several processes that load them at once from an empty
build directory all load whole libraries, each built once, outside
`native/` (whose libraries the JAX package's loaders write in place
with `make`)."""

import ctypes
import hashlib
import os
import subprocess
import sys

from tests.conftest import REPO_ROOT

_CHILD = """
import ctypes, sys
sys.path.insert(0, {root!r})
from osm_renderer_tpu_torch.utils.torch_setup import host_lib_path
for name in {names!r}:
    ctypes.CDLL(host_lib_path(name))
print("loaded")
"""


def _load_in_six_processes(tmp_path, names):
    """Six processes load `names` from an empty build directory -> its
    listing."""
    build = str(tmp_path / "kernels")
    env = dict(os.environ, OSMR_TORCH_BUILD_DIR=build)
    child = _CHILD.format(root=REPO_ROOT, names=tuple(names))
    procs = [subprocess.Popen([sys.executable, "-c", child], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(6)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0 and out.strip() == "loaded", err[-2000:]
    return build, sorted(os.listdir(build))


def test_concurrent_processes_load_whole_private_builds(tmp_path):
    build, built = _load_in_six_processes(tmp_path, ("assembler", "oracle"))
    assert [f.split("_")[1] for f in built if f.endswith(".so")] == ["assembler", "oracle"]
    assert not [f for f in built if f.endswith(".tmp")]
    native = os.path.realpath(os.path.join(REPO_ROOT, "native"))
    for f in built:
        if f.endswith(".so"):
            assert not os.path.realpath(os.path.join(build, f)).startswith(native)
            ctypes.CDLL(os.path.join(build, f))


def test_concurrent_processes_load_whole_private_wire_decoder_builds(tmp_path):
    """The port's own wire decoder (`csrc/wire_host.cpp`), built once from
    the port's package, with every entry point the codec binds."""
    from osm_renderer_tpu_torch.utils.torch_setup import HOST_CXXFLAGS

    build, built = _load_in_six_processes(tmp_path, ("wirehost",))
    libs = [f for f in built if f.endswith(".so")]
    assert [f.split("_")[1] for f in libs] == ["wirehost"]
    assert not [f for f in built if f.endswith(".tmp")]
    with open(os.path.join(REPO_ROOT, "osm_renderer_tpu_torch", "csrc", "wire_host.cpp"),
              "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(HOST_CXXFLAGS).encode()).hexdigest()[:16]
    assert libs == [f"libosmr_wirehost_{digest}.so"]
    lib = ctypes.CDLL(os.path.join(build, libs[0]))
    for entry in ("osmr_rle_decode_packed", "osmr_rle_decode_words",
                  "osmr_rle_decode_words_idx", "osmr_png8_filter_up"):
        assert getattr(lib, entry)
