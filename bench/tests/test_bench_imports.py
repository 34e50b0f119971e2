"""Nothing the benchmark runs loads JAX, Flax or the JAX package ``repro``
(top-level module names compared whole: ``repro_torch`` is not ``repro``),
and the plain references load nothing of the port.  Checked in a fresh
process, over a whole small run, and over the source text; and ``run.py``
prints no result where it cannot run."""

import json
import os
import pathlib
import re
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH_FILES = sorted((ROOT / "bench").rglob("*.py"))
FORBIDDEN = re.compile(r"^\s*(import (jax|jaxlib|flax|repro)\b|from (jax|jaxlib|flax|repro)(\.| ))", re.M)
PORT = re.compile(r"^\s*(import|from) repro_torch\b", re.M)

PROBE = """
import sys, time, torch
sys.path[:0] = [{root!r}, {src!r}]
from bench.lib import harness, loader
from bench.tests.conftest import SMALL
bench = loader.benchmark()
for cell in [w["name"] for w in bench["workloads"]]:
    cfg = loader.workload(bench, cell)["config"]
    r, _ = harness.run_cell(bench, cell, 7, 0.3, cell.endswith("steady"), torch.device("cpu"), time.perf_counter(),
                            SMALL[cfg])
    assert r["correct"], (cell, r["checks"])
for name in [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]:
    loader.metric_reader(name)
for path in {refs!r}:
    loader.load_module(__import__("pathlib").Path(path), "ref_" + path)
bad = harness.forbidden_modules()
print(bad)
sys.exit(1 if bad else 0)
"""


def test_a_whole_small_run_leaves_jax_and_the_reference_unloaded():
    refs = [str(p) for p in sorted((ROOT / "bench" / "reference").glob("*.py"))]
    probe = PROBE.format(root=str(ROOT), src=str(ROOT / "src"), refs=refs)
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-4000:]


def test_sources_import_no_jax_and_references_nothing_of_the_port():
    assert BENCH_FILES
    for path in BENCH_FILES:
        assert not FORBIDDEN.search(path.read_text()), path
    for path in (ROOT / "bench" / "reference").glob("*.py"):
        assert not PORT.search(path.read_text()), path
        assert "repro_torch" not in path.read_text().split('"""')[-1], path


def test_forbidden_names_compare_whole_top_level_names():
    from bench.lib import harness

    sys.modules.setdefault("repro_torch_lookalike", sys)
    try:
        assert "repro_torch_lookalike" not in harness.forbidden_modules()
        assert all(m.split(".")[0] in harness.FORBIDDEN for m in harness.forbidden_modules())
    finally:
        del sys.modules["repro_torch_lookalike"]


def test_run_prints_no_result_without_a_card_or_without_the_program(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    cmd = [sys.executable, "bench/run.py", "--workload", "hcl-matmul.steady", "--seed", "3", "--seconds", "1"]
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=300, cwd=ROOT, env=env)
    assert out.returncode != 0 and not out.stdout.strip()
    shutil.copytree(ROOT / "bench", tmp_path / "bench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=300, cwd=tmp_path, env=env)
    assert out.returncode != 0 and not out.stdout.strip()
    json.loads((tmp_path / "BENCHMARK.json").read_text())
