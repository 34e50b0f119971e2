"""The port stands alone: ``repro_torch`` (every module, the model stack
and its serving path included) and ``chip_smoke.py`` import no JAX and
nothing of the reference package, and the smoke script refuses to run
without a CUDA device."""

import os
import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
_FORBIDDEN = re.compile(r"^\s*(import jax|from jax|import repro\b|from repro(\.| ))", re.M)


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else [])
    )
    return env


def test_import_leaves_jax_and_reference_unloaded():
    probe = (
        "import sys, repro_torch, repro_torch.core, repro_torch.kernels.ops, repro_torch._build\n"
        "import repro_torch.configs, repro_torch.nn, repro_torch.models, repro_torch.runtime\n"
        "import repro_torch.launch.serve, repro_torch.kernels.flash_attention, repro_torch.kernels.rglru\n"
        "import repro_torch.configs.recurrentgemma_2b, repro_torch.nn.convert\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", probe], env=_env(), capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_source_has_no_reference_import(path):
    assert not _FORBIDDEN.search(path.read_text()), path


def test_chip_smoke_fails_without_cuda():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal needs a machine without one")
    out = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py")], env=_env(), cwd=ROOT,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
