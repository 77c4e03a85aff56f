"""No module the harness runs imports JAX or the JAX package (top-level
names compared whole: the port's name starts with the JAX package's),
the reference imports nothing of the program, and the load generator
imports only the standard library."""

import ast
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "osm_renderer_tpu"}
PROGRAM = "osm_renderer_tpu_torch"


def imported(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


def sources():
    for d, _, files in os.walk(HERE):
        if "cache" in d.split(os.sep):
            continue
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_file_of_the_harness_imports_jax_or_the_jax_package():
    bad = [(p, m) for p in sources() for m in imported(p) if m in FORBIDDEN]
    assert not bad


def test_the_reference_imports_nothing_of_the_program():
    ref = [os.path.join(HERE, f) for f in ("reference.py", "pngdec.py", "control.py")]
    ref += [p for p in sources() if os.sep + "ref" + os.sep in p]
    bad = [(p, m) for p in ref for m in imported(p) if m == PROGRAM]
    assert not bad


def test_the_reference_loads_no_program_module_when_it_runs():
    code = ("import sys, tilebench.reference, tilebench.pngdec, tilebench.ref.make_fixture;"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=os.path.dirname(HERE),
                         capture_output=True, text=True, check=True).stdout
    tops = set(eval(out))
    assert not tops & (FORBIDDEN | {PROGRAM})


def test_the_load_generator_is_standard_library_only():
    tops = set(imported(os.path.join(HERE, "loadgen.py")))
    assert tops <= set(sys.stdlib_module_names) | {"__future__"}


def test_nothing_reads_the_root_bench_files():
    for p in sources():
        text = open(p).read()
        for name in ("BENCH_r", "MULTICHIP_", "BASELINE.", "bench.py"):
            assert name not in text or p.endswith("test_tilebench_imports.py"), (p, name)
