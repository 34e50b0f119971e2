"""The port stands alone: ``repro_torch`` (every module, the model stack
and its serving path, xLSTM, the encoder-decoder and the frontend stubs,
the fleet and the serving dispatch, the mesh code, the dry run and the
deprecated shims included), the example twins in ``examples_torch/`` and
``chip_smoke.py`` import no JAX and nothing of the reference package, and
the smoke script refuses to run without a CUDA device."""

import os
import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
EXAMPLE_TWINS = sorted((ROOT / "examples_torch").glob("*.py"))
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + EXAMPLE_TWINS + [ROOT / "chip_smoke.py"]
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
        "import repro_torch.configs.recurrentgemma_2b, repro_torch.nn.convert, repro_torch.models.moe\n"
        "import repro_torch.configs.gemma2_2b, repro_torch.configs.deepseek_v2_236b\n"
        "import repro_torch.core.partition2d, repro_torch.launch.paper_tables\n"
        "import repro_torch.launch.matmul_grid, repro_torch.core.energy, repro_torch.core.hierarchy\n"
        "import repro_torch.obs, repro_torch.obs.report, repro_torch.runtime.straggler\n"
        "import repro_torch.fleet, repro_torch.fleet.registry, repro_torch.fleet.scheduler\n"
        "from repro_torch.core import BatchedSimulatedExecutor2D, FleetExecutor, FleetRoundLog\n"
        "from repro_torch.core import speed_fn_2d_batch, time_fn_2d_batch\n"
        "import repro_torch.runtime.balance, repro_torch.runtime.elastic, repro_torch.runtime.serve_loop\n"
        "from repro_torch.runtime import ReplicaDispatcher, BalanceController, GroupTimer, elastic_rebalance\n"
        "from repro_torch.core.executor import TraceExecutor2D\n"
        "import repro_torch.launch.train, repro_torch.runtime.train_loop, repro_torch.checkpoint\n"
        "import repro_torch.data, repro_torch.optim, repro_torch.optim.compress, repro_torch.checkpoint.store\n"
        "import repro_torch.models.encdec, repro_torch.models.frontends, repro_torch.models.recurrent\n"
        "import repro_torch.configs.xlstm_350m, repro_torch.configs.seamless_m4t_medium, repro_torch.configs.pixtral_12b\n"
        "import repro_torch.sharding, repro_torch.sharding.rules, repro_torch.sharding.context\n"
        "import repro_torch.launch.mesh, repro_torch.launch.dryrun, repro_torch.core.dfpa\n"
        "from repro_torch.core import dfpa, DFPAResult, Grid2DResult, dfpa_partition_2d, bank_repartition_2d\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", probe], env=_env(), capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stdout + out.stderr


def test_example_twins_leave_jax_and_reference_unloaded():
    """Loading every twin (its module body, not its ``main``) in a fresh
    process imports no JAX and nothing of the reference."""
    assert len(EXAMPLE_TWINS) == 10
    probe = (
        "import importlib.util, sys\n"
        f"for path in {[str(p) for p in EXAMPLE_TWINS]!r}:\n"
        "    spec = importlib.util.spec_from_file_location('twin', path)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
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


def test_fleet_defaults_to_the_card():
    """``FleetScheduler()`` defaults to the torch backend on ``"cuda"``: on
    a machine without a card it raises instead of running on the host."""
    import torch

    from repro_torch.fleet import FleetScheduler

    if torch.cuda.is_available():
        fleet = FleetScheduler(4)
        assert fleet.backend == "torch" and fleet._device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="cuda"):
        FleetScheduler(4)
    assert FleetScheduler(4, device="cpu").backend == "torch"


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


def test_runtime_exports_the_serving_dispatch():
    """``repro_torch.runtime`` exports what the reference's does, the
    training names among them, and the serving dispatch; ``RoundLog``
    carries ``t_wall`` outside equality."""
    import dataclasses

    import repro_torch.runtime as runtime
    from repro_torch.core import executor

    assert set(runtime.__all__) == {
        "ServeEngine", "ReplicaDispatcher", "BalanceController", "GroupTimer",
        "StragglerDetector", "StragglerAction", "elastic_rebalance",
        "TrainState", "make_train_step", "init_train_state", "loss_for_config",
    }
    assert "TraceExecutor2D" in executor.__all__
    t_wall = {f.name: f for f in dataclasses.fields(executor.RoundLog)}["t_wall"]
    assert t_wall.default == 0.0 and t_wall.compare is False
