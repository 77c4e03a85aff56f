"""The port's build of the C++ host libraries (`utils/torch_setup.
host_lib_path`): several processes that load them at once from an empty
build directory all load whole libraries, each built once, outside
`native/` (whose libraries the JAX package's loaders write in place
with `make`)."""

import ctypes
import os
import subprocess
import sys

from tests.conftest import REPO_ROOT

_CHILD = """
import ctypes, sys
sys.path.insert(0, {root!r})
from osm_renderer_tpu_torch.utils.torch_setup import host_lib_path
for name in ("assembler", "oracle"):
    ctypes.CDLL(host_lib_path(name))
print("loaded")
"""


def test_concurrent_processes_load_whole_private_builds(tmp_path):
    build = str(tmp_path / "kernels")
    env = dict(os.environ, OSMR_TORCH_BUILD_DIR=build)
    procs = [subprocess.Popen([sys.executable, "-c", _CHILD.format(root=REPO_ROOT)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(6)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0 and out.strip() == "loaded", err[-2000:]
    built = sorted(os.listdir(build))
    assert [f.split("_")[1] for f in built if f.endswith(".so")] == ["assembler", "oracle"]
    assert not [f for f in built if f.endswith(".tmp")]
    native = os.path.realpath(os.path.join(REPO_ROOT, "native"))
    for f in built:
        if f.endswith(".so"):
            assert not os.path.realpath(os.path.join(build, f)).startswith(native)
            ctypes.CDLL(os.path.join(build, f))
