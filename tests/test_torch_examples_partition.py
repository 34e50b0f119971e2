"""The partitioning examples' twins held against the reference's scripts.

``examples_torch/{quickstart, matmul_2d_dfpa, hierarchy_walkthrough,
energy_pareto_walkthrough}.py`` run with ``--device cpu`` beside
``examples/`` under ``JAX_PLATFORMS=cpu``: their standard outputs must be
equal line by line.  The one difference allowed is the hierarchy's section
4, whose ``sharding="shard_map"`` has no one-card counterpart (ROADMAP item
10f): the twin holds its torch inner solve against numpy there instead,
and its bank-element count must equal the reference's unsharded count.
The energy twin's store runs on the torch backend where the reference's
runs on numpy: in float64 its partitions, front and budgeted solve must
equal the reference's numpy store's bit for bit.  Also: every twin
defaults to the card and refuses to run without one.
"""

import inspect
import re

import numpy as np
import pytest
import torch

from _example_parity import TWINS, assert_same_lines, load_twin, run_pair

HIER_SECTION_4 = [  # item 10f: the shard_map split has no one-card counterpart
    (r"^(shard_map.*)$", "section 4, item 10f"),
    (r"^per-device bank elements: (.*)$", "section 4, item 10f"),
]


@pytest.mark.parametrize("name", ["quickstart", "matmul_2d_dfpa", "energy_pareto_walkthrough"])
def test_twin_prints_the_reference_lines(name):
    ref, twin = run_pair(name)
    assert_same_lines(ref, twin)


def test_hierarchy_twin_prints_the_reference_lines_but_section_4():
    ref, twin = run_pair("hierarchy_walkthrough")
    assert_same_lines(ref, twin, HIER_SECTION_4)
    assert "single group == flat, bit-identical: True" in twin
    unsharded = int(re.search(r"vs (\d+) unsharded", "\n".join(ref)).group(1))
    assert any(re.fullmatch(r"shard_map: .*item 10f.* == numpy: True", line) for line in twin)
    assert f"per-device bank elements: {unsharded} (all 3 group blocks on one device)" in twin


def test_hierarchy_twin_returns_its_claims():
    got = load_twin("hierarchy_walkthrough").main(device="cpu")
    assert got["claims"] == {"single_group_is_flat": True, "torch_is_numpy": True}
    assert sum(got["hier"]) == sum(got["after_regroup"]) == 12_000


def test_energy_twin_equals_the_reference_numpy_store():
    from repro.core import PiecewiseLinearFPM as RefFPM
    from repro.core import SpeedStore as RefStore
    from repro.core.energy import energy_model as ref_energy_model

    twin = load_twin("energy_pareto_walkthrough")
    got = twin.main(device="cpu")
    xs = np.geomspace(1.0, 4096.0, 7)
    store = RefStore.from_models(
        [RefFPM.from_points([(1.0, twin.SPEED[c]), (4096.0, twin.SPEED[c])]) for c in twin.CLASSES],
        backend="numpy",
    )
    store.attach_energy([
        ref_energy_model([(x, twin.ENERGY[c][0] + twin.ENERGY[c][1] * x) for x in xs]) for c in twin.CLASSES
    ])
    d_time, _ = store.partition(twin.N)
    front = store.pareto_front(twin.N, num_points=9)
    cap = 0.65 * store.fleet_energy(d_time)
    assert got["d_time"] == list(d_time)
    assert got["d_energy"] == list(store.partition(twin.N, objective="energy")[0])
    assert got["front_times"] == [float(t) for t in front.times] and got["knee"] == front.knee()
    assert got["cap"] == cap and got["d_cap"] == list(store.partition(twin.N, energy_cap=cap)[0])
    assert all(got["claims"].values()) and got["fleet_budget"] < got["fleet_energy_free"]


def test_quickstart_twin_returns_its_claims():
    got = load_twin("quickstart").main(device="cpu")
    assert all(got["claims"].values()) and sum(got["allocations"]) == 5120


def test_matmul_twin_returns_its_claims():
    got = load_twin("matmul_2d_dfpa").main(device="cpu")
    assert all(got["claims"].values()) and sum(got["col_widths"]) == 512


@pytest.mark.parametrize("name", TWINS)
def test_twin_defaults_to_the_card_and_refuses_without_one(name):
    mod = load_twin(name)
    assert inspect.signature(mod.main).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            mod.main()


def test_ten_twins_one_for_each_reference_example():
    from _example_parity import ROOT

    assert TWINS == sorted(p.stem for p in (ROOT / "examples").glob("*.py"))
    assert len(TWINS) == 10
