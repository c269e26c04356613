"""What the benchmark loads: nothing of JAX or the JAX package anywhere
(top-level module names compared whole: the port's name begins with the
JAX package's), nothing of the port in the plain reference; and a run
that finds no card, or no port, prints no result."""
import ast
import glob
import json
import os
import shutil
import subprocess
import sys


BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
FORBIDDEN = {"jax", "jaxlib", "flax", "signnet_basisnet_tpu"}
PORT = "signnet_basisnet_tpu_torch"


def imported_tops(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def sources(sub=""):
    return [p for p in glob.glob(os.path.join(BENCH, sub, "**", "*.py"),
                                 recursive=True)
            if "/tests/" not in p]


def test_no_source_names_jax_or_the_jax_package():
    for path in sources():
        assert not FORBIDDEN & set(imported_tops(path)), path


def test_the_reference_names_nothing_of_the_port():
    for path in sources("reference"):
        tops = set(imported_tops(path))
        assert tops <= {"torch", "numpy", "dataclasses", "typing",
                        "__future__"}, (path, tops)


def _python(code, cwd=ROOT):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([ROOT, BENCH]))
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=600)


def test_a_run_loads_no_jax(tmp_path):
    """A whole run of a tiny cell on the CPU, every metric and count
    module loaded: then no module of JAX or the JAX package is held."""
    sys.path.insert(0, os.path.dirname(__file__))
    from conftest import tiny_checkout
    cell = tiny_checkout(str(tmp_path))
    code = f"""
import sys, time, json
sys.path[:0] = [{str(tmp_path / 'benchmark')!r}]
from harness.spec import load_cell
from harness.cell import run_cell
cell = load_cell({str(tmp_path)!r}, {cell!r})
run_cell(cell, 3, 0.2, True, "cpu", time.monotonic(), say=lambda m: None)
run_cell(cell, 3, 0.2, False, "cpu", time.monotonic(), say=lambda m: None)
print(json.dumps(sorted(sys.modules)))
"""
    out = _python(code)
    assert out.returncode == 0, out.stderr[-3000:]
    mods = json.loads(out.stdout.strip().splitlines()[-1])
    tops = {m.split(".")[0] for m in mods}
    assert not FORBIDDEN & tops
    assert PORT in tops   # the program was driven


def test_the_reference_loads_nothing_of_the_port():
    code = """
import sys, json
import reference.common, reference.batches, reference.gin_net
import reference.gatedgcn_net
print(json.dumps(sorted(sys.modules)))
"""
    out = _python(code)
    assert out.returncode == 0, out.stderr[-3000:]
    tops = {m.split(".")[0] for m in json.loads(out.stdout.splitlines()[-1])}
    assert PORT not in tops and not FORBIDDEN & tops


def _run_py(cwd):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "gin_signnet_zinc.zinc_subset_b128", "--seed", str(2 ** 31 + 3),
         "--seconds", "1", "--trace", "0"], cwd=cwd, capture_output=True,
        text=True, timeout=600, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))


def test_without_a_card_a_run_fails_and_prints_no_result():
    out = _run_py(ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA card" in out.stderr


def test_with_only_the_benchmark_a_run_fails(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    out = _run_py(str(tmp_path))
    assert out.returncode != 0
    assert out.stdout.strip() == ""
