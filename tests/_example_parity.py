"""Helpers shared by the tests that hold ``examples_torch/`` against the
reference's ``examples/`` (``test_torch_examples_*.py``).

Each script runs in a subprocess of its own — the reference's with
``JAX_PLATFORMS=cpu``, the twin's with ``--device cpu`` — the two side by
side, each under a time limit, so a hang fails instead of stalling the
suite.  Their standard outputs must be equal line by line once the parts a
test names (each with its reason) are masked on both sides; every mask must
match at least one line on each side, so none is vacuous.
"""

import importlib.util
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
TWINS = sorted(p.stem for p in (ROOT / "examples_torch").glob("*.py"))
SCRIPT_TIMEOUT = 300


def _env():
    # one host thread a script: the suite runs files side by side in
    # workers, and two scripts a test at the card count of threads each
    # oversubscribe the host's cores many times over
    return dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
                XLA_FLAGS="--xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1")


def run_pair(name: str):
    """(reference stdout lines, twin stdout lines), run side by side."""
    procs = [
        subprocess.Popen([sys.executable, str(ROOT / d / f"{name}.py"), *args], cwd=ROOT,
                         env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for d, args in (("examples", ()), ("examples_torch", ("--device", "cpu")))
    ]
    outs = []
    try:
        for proc in procs:
            out, err = proc.communicate(timeout=SCRIPT_TIMEOUT)
            assert proc.returncode == 0, f"{proc.args} exited with {proc.returncode}:\n{err[-4000:]}"
            outs.append(out.splitlines())
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return outs[0], outs[1]


def mask(lines, masks):
    """Each match of a mask's groups replaced by ``<reason>``; returns the
    masked lines and the set of masks that matched."""
    out, hit = [], set()
    for line in lines:
        for pattern, reason in masks:
            m = re.search(pattern, line)
            if m:
                hit.add(pattern)
                for g in range(m.re.groups, 0, -1):
                    line = line[: m.start(g)] + f"<{reason}>" + line[m.end(g):]
        out.append(line)
    return out, hit


def assert_same_lines(ref, twin, masks=()):
    got_ref, hit_ref = mask(ref, masks)
    got_twin, hit_twin = mask(twin, masks)
    for pattern, _ in masks:
        assert pattern in hit_ref and pattern in hit_twin, f"mask {pattern!r} matched no line"
    assert len(got_twin) == len(got_ref), "\n".join(twin)
    for i, (a, b) in enumerate(zip(got_ref, got_twin)):
        assert a == b, f"line {i}:\n  reference: {ref[i]}\n  twin:      {twin[i]}"


def load_twin(name: str):
    """The twin's module, loaded by path (``examples_torch`` is no package)."""
    spec = importlib.util.spec_from_file_location(f"examples_torch_{name}", ROOT / "examples_torch" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
