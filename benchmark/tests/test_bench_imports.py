"""Nothing the harness runs may load JAX or the JAX package, and nothing
reads the JAX package's benchmark (bench.py, BENCH_*.json)."""
import ast
import os
import subprocess
import sys

from benchmark.core.guard import forbidden_loaded
from benchmark.core.spec import BENCH, ROOT


def _sources():
    for d, _, files in os.walk(BENCH):
        if "/.cache" in d or d.endswith("tests"):
            continue
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_guard_compares_whole_top_level_names():
    assert forbidden_loaded(["ac3acm_tpu_torch", "ac3acm_tpu_torch.ops",
                             "jaxtyping", "numpy"]) == []
    assert forbidden_loaded(["ac3acm_tpu.host", "jax._src", "jaxlib",
                             "flax.linen"]) == ["ac3acm_tpu", "flax", "jax",
                                                "jaxlib"]


def test_no_source_imports_a_forbidden_module():
    for path in _sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            assert forbidden_loaded(names) == [], (path, names)


def test_reference_imports_nothing_of_the_program():
    for path in _sources():
        if os.sep + "reference" + os.sep not in path:
            continue
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and node.level == 0:
                assert not (node.module or "").startswith("ac3acm_tpu")
            if isinstance(node, ast.Import):
                assert not any(a.name.startswith("ac3acm_tpu")
                               for a in node.names)


def test_no_source_reads_the_jax_benchmark():
    for path in _sources():
        with open(path) as f:
            text = f.read()
        assert "bench.py" not in text and "BENCH_" not in text, path


def test_loading_every_module_loads_no_jax():
    """Every harness, path, metric and reference module, with the program
    modules the paths import, in a fresh process."""
    mods = []
    for path in _sources():
        rel = os.path.relpath(path, ROOT)[:-3].replace(os.sep, ".")
        if not rel.endswith("run"):
            mods.append(rel.removesuffix(".__init__"))
    mods += ["ac3acm_tpu_torch.parallel.pipeline",
             "ac3acm_tpu_torch.parallel.transcode"]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "from benchmark.core.guard import forbidden_loaded\n"
            "print(forbidden_loaded())\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().splitlines()[-1] == "[]"
