"""The port's straggler detector and elastic membership, held against the
reference's.

``repro_torch.runtime.straggler`` is the reference's detector, copied, and
``Scheduler.straggler_actions`` / ``reprofile`` / ``resize`` / ``join`` /
``leave`` are the reference's methods.  Contract: on the same inputs the
port's detector returns the same actions and leaves the same ``strikes``
and ``history``; a port session (``backend="numpy"`` or ``"torch"`` on
``device="cpu"``, with and without ``groups=``) fed the same times as the
reference's numpy ``Scheduler`` ends with the same distribution ``d``, the
same points in every model, the same ``caps``, ``groups`` and remapped
strikes, bit for bit.  The reference's own elastic and reprofile cases
(``tests/test_runtime.py``) reach these methods through its deprecated
``BalanceController`` / ``elastic_rebalance`` shims; the cases here call
the methods directly, and ``tests/test_torch_dispatch.py`` runs them
through the port's shims.
"""

import numpy as np
import pytest
import torch

from repro.core.fpm import PiecewiseLinearFPM as RefFPM
from repro.core.modelbank import ModelBank as RefBank
from repro.core.scheduler import Scheduler as RefScheduler
from repro.runtime.straggler import StragglerAction as RefAction
from repro.runtime.straggler import StragglerDetector as RefDetector

from repro_torch.core import PiecewiseLinearFPM, Scheduler
from repro_torch.core.modelbank import ModelBank
from repro_torch.runtime import StragglerAction, StragglerDetector

BACKENDS = ["numpy", "torch"]


def _acts(actions):
    return [a.value for a in actions]


def _same_detector(port, ref):
    assert port.strikes == ref.strikes
    assert port.history == ref.history
    assert (port.factor, port.factor_hard, port.patience, port.patience_hard) == (
        ref.factor, ref.factor_hard, ref.patience, ref.patience_hard
    )


# ---------------------------------------------------------------------------
# the detector (tests/test_runtime.py's cases, each against the reference)
# ---------------------------------------------------------------------------


def test_straggler_detector_escalates():
    out = []
    for det_cls, fpm, action in ((StragglerDetector, PiecewiseLinearFPM, StragglerAction),
                                 (RefDetector, RefFPM, RefAction)):
        det = det_cls(factor=1.5, patience=2, patience_hard=4)
        m = fpm.from_points([(10, 10.0)])  # predicts t(10) = 1.0
        acts = [det.update(0, m, 10, 2.0) for _ in range(4)]
        assert action.REPROFILE in acts
        assert acts[-1] is action.QUARANTINE or action.QUARANTINE in acts
        out.append((_acts(acts), det))
    assert out[0][0] == out[1][0]
    _same_detector(out[0][1], out[1][1])


def test_straggler_healthy_group_resets_strikes():
    dets = []
    for det_cls, fpm in ((StragglerDetector, PiecewiseLinearFPM), (RefDetector, RefFPM)):
        det = det_cls(factor=1.5, patience=2)
        m = fpm.from_points([(10, 10.0)])
        det.update(0, m, 10, 2.0)
        det.update(0, m, 10, 1.0)  # healthy
        assert det.strikes[0] == 0
        dets.append(det)
    _same_detector(*dets)


def test_straggler_remap_drops_departed_strikes():
    dets = []
    for det_cls in (StragglerDetector, RefDetector):
        det = det_cls(factor=1.5, patience=3, patience_hard=6)
        det.strikes = {0: 5, 2: 2}
        det.history = [(0, 10, 1.0, 2.0, 2.0), (1, 12, 1.0, 1.0, 1.0)]
        new = det.remap([1, 2], joined=1)
        # old group 2 keeps its count under new index 1; departed 0's drop;
        # the joiner (new index 2) starts clean
        assert new.strikes == {1: 2}
        assert new.history == [(0, 12, 1.0, 1.0, 1.0)]
        assert (new.factor, new.patience, new.patience_hard) == (1.5, 3, 6)
        dets.append(new)
    _same_detector(*dets)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_update_batch_matches_reference(seed):
    """One batched prediction over a host bank: same actions, strikes and
    history as the reference's, over rounds of mixed slow and healthy
    groups, empty rows and zero allocations included."""
    rng = np.random.default_rng(seed)
    p = 7
    rows = [
        list(zip(np.sort(rng.uniform(1.0, 100.0, k)).tolist(), rng.uniform(1.0, 10.0, k).tolist()))
        for k in rng.integers(0, 4, p)
    ]
    port_bank = ModelBank.from_models([PiecewiseLinearFPM.from_points(r) for r in rows])
    ref_bank = RefBank.from_models([RefFPM.from_points(r) for r in rows])
    port, ref = StragglerDetector(), RefDetector()
    for _ in range(8):
        d = rng.integers(0, 60, p).tolist()
        healthy = ref_bank.time(np.asarray(d, dtype=np.float64))
        slow = rng.choice([0.5, 1.0, 1.7, 3.5], p)
        obs = np.where(np.isfinite(healthy), healthy * slow, 1.0).tolist()
        assert _acts(port.update_batch(port_bank, d, obs)) == _acts(ref.update_batch(ref_bank, d, obs))
    _same_detector(port, ref)


# ---------------------------------------------------------------------------
# Scheduler sessions fed the same times, port vs the reference's numpy one
# ---------------------------------------------------------------------------


def _simulate(sched, speeds, steps):
    """Feed the session synthetic per-group times t = d / speed."""
    for _ in range(steps):
        sched.observe([d / s if d > 0 else 0.0 for d, s in zip(sched.d, speeds)])


def _pair(backend, **kw):
    port_kw = dict(kw, backend=backend, device="cpu")
    return Scheduler(**port_kw), RefScheduler(**dict(kw, backend="numpy"))


def _same_session(port, ref):
    assert port.d == ref.d
    assert [m.as_points() for m in port.models] == [m.as_points() for m in ref.models]
    assert port.caps == ref.caps
    assert port.groups == ref.groups
    assert port.n_units == ref.n_units and port.num_groups == ref.num_groups
    assert port._ema == ref._ema
    if ref.detector is None:
        assert port.detector is None
    else:
        _same_detector(port.detector, ref.detector)


@pytest.mark.parametrize("backend", BACKENDS)
def test_leave_does_not_inherit_neighbour_strikes(backend):
    """A group one mild strike away from quarantine leaves; the survivor
    shifted into its index takes a first strike, not a sixth."""
    sessions = []
    for cls, det_cls, action in ((Scheduler, StragglerDetector, StragglerAction),
                                 (RefScheduler, RefDetector, RefAction)):
        kw = dict(backend=backend, device="cpu") if cls is Scheduler else dict(backend="numpy")
        sched = cls(
            n_units=60, num_groups=3, eps=0.05, min_units=1, smooth=1.0,
            detector=det_cls(factor=1.5, patience=3, patience_hard=6), **kw,
        )
        _simulate(sched, [1.0, 2.0, 3.0], 8)
        sched.detector.strikes = {0: 5}  # group 0: one mild strike from quarantine
        sched.leave(0)
        assert sched.detector.strikes == {}  # departed strikes dropped
        healthy = [m.time(float(d)) for m, d in zip(sched.models, sched.d)]
        acts = sched.straggler_actions([healthy[0] * 1.6, healthy[1]])
        assert acts[0] is action.NONE
        assert sched.detector.strikes[0] == 1
        sessions.append(sched)
    _same_session(*sessions)


@pytest.mark.parametrize("backend", BACKENDS)
def test_straggler_reprofile_clears_model(backend):
    """``reprofile`` keeps only the point at the current allocation, clears
    the group's EMA keys and drops the device carry."""
    port, ref = _pair(backend, n_units=40, num_groups=2, eps=0.05, smooth=1.0)
    for sched in (port, ref):
        sched.observe([2.0, 1.0])
        sched.observe([d / 2.0 for d in sched.d])
        sched.observe([d / 2.0 for d in sched.d])
    if backend == "torch":
        port.store.device_bank(snapshot=False)  # the carry exists before
        assert port.store._tbank is not None
    pts_before = port.models[0].num_points
    assert pts_before > 1
    port.reprofile(0)
    ref.reprofile(0)
    assert port.models[0].num_points <= pts_before
    assert all(x == float(port.d[0]) for x, _ in port.models[0].as_points())
    assert not any(k[0] == 0 for k in port._ema)
    assert port.store._tbank is None
    _same_session(port, ref)
    # the next rounds rebuild the carry and stay with the reference
    _simulate(port, [2.0, 1.0], 3)
    _simulate(ref, [2.0, 1.0], 3)
    _same_session(port, ref)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("groups", [None, [0, 0, 1]])
def test_straggler_actions_apply_reprofile_like_the_reference(backend, groups):
    port, ref = _pair(backend, n_units=90, num_groups=3, eps=0.05, min_units=1, smooth=0.5, groups=groups)
    _simulate(port, [1.0, 2.0, 3.0], 6)
    _simulate(ref, [1.0, 2.0, 3.0], 6)
    seen = set()
    for k in range(1, 7):  # group 1 slows down twice as much every round
        acts = []
        for sched in (port, ref):
            times = [d / s * (2.0 ** k if i == 1 else 1.0) if d > 0 else 0.0
                     for i, (d, s) in enumerate(zip(sched.d, [1.0, 2.0, 3.0]))]
            acts.append(_acts(sched.straggler_actions(times)))
            sched.observe(times)
        assert acts[0] == acts[1]
        seen.update(acts[0])
        _same_session(port, ref)
    assert "reprofile" in seen


@pytest.mark.parametrize("backend", BACKENDS)
def test_straggler_actions_report_only_without_auto_reprofile(backend):
    """``auto_reprofile=False`` reports REPROFILE and leaves the estimates,
    the EMA state and the distribution alone, as the reference does."""
    port, ref = _pair(backend, n_units=60, num_groups=3, eps=0.05, min_units=1, smooth=1.0)
    _simulate(port, [1.0, 2.0, 3.0], 6)
    _simulate(ref, [1.0, 2.0, 3.0], 6)
    before = [m.as_points() for m in port.models]
    for _ in range(3):
        acts = []
        for sched in (port, ref):
            times = [d / s * (2.0 if i == 2 else 1.0) for i, (d, s) in enumerate(zip(sched.d, [1.0, 2.0, 3.0]))]
            acts.append(_acts(sched.straggler_actions(times, auto_reprofile=False)))
        assert acts[0] == acts[1]
    assert acts[0][2] == "reprofile"
    assert [m.as_points() for m in port.models] == before
    _same_session(port, ref)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("groups", [None, [0, 1, 1]])
def test_elastic_leave_redistributes_all_units(backend, groups):
    port, ref = _pair(backend, n_units=60, num_groups=3, eps=0.05, smooth=1.0, groups=groups,
                      caps=[50, 45, 40])
    for sched in (port, ref):
        sched.detector = (StragglerDetector if sched is port else RefDetector)()
        _simulate(sched, [1.0, 2.0, 3.0], 20)
        sched.detector.strikes = {0: 1, 1: 2, 2: 4}
    new, want = port.resize([0, 1]), ref.resize([0, 1])
    assert new.num_groups == 2 and sum(new.d) == 60
    assert new.models[0].num_points == port.models[0].num_points  # warm start
    assert new.detector.strikes == {0: 1, 1: 2}
    _same_session(new, want)
    port.leave(2)
    ref.leave(2)
    _same_session(port, ref)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("groups", [None, [0, 1]])
def test_elastic_join_gets_optimistic_estimate(backend, groups):
    port, ref = _pair(backend, n_units=60, num_groups=2, eps=0.05, smooth=1.0, groups=groups,
                      caps=[60, 30])
    _simulate(port, [1.0, 3.0], 20)
    _simulate(ref, [1.0, 3.0], 20)
    new, want = port.resize([0, 1], joined=1), ref.resize([0, 1], joined=1)
    assert new.num_groups == 3 and sum(new.d) == 60
    assert new.models[2].num_points == 1  # the donor's point
    assert new.d[2] > 0  # the newcomer is not starved
    _same_session(new, want)
    port.join(2)
    ref.join(2)
    _same_session(port, ref)
    _simulate(port, [1.0, 3.0, 2.0, 2.5], 5)
    _simulate(ref, [1.0, 3.0, 2.0, 2.5], 5)
    _same_session(port, ref)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("groups", [None, [0, 0, 1]])
def test_elastic_then_converges_quickly(backend, groups):
    port, ref = _pair(backend, n_units=60, num_groups=3, eps=0.08, smooth=1.0, groups=groups)
    _simulate(port, [1.0, 2.0, 3.0], 20)
    _simulate(ref, [1.0, 2.0, 3.0], 20)
    port.leave([1])
    ref.leave([1])
    _same_session(port, ref)
    # group 2 (speed 3.0) survives as index 1
    _simulate(port, [1.0, 3.0], 6)
    _simulate(ref, [1.0, 3.0], 6)
    _same_session(port, ref)
    times = [d / s for d, s in zip(port.d, [1.0, 3.0])]
    assert (max(times) - min(times)) / min(times) <= 0.25


@pytest.mark.parametrize("dtype", [None, torch.float32])
def test_resize_keeps_backend_dtype_and_device(dtype):
    sched = Scheduler(n_units=48, num_groups=3, eps=0.05, smooth=1.0, backend="torch",
                      device="cpu", dtype=dtype)
    _simulate(sched, [1.0, 2.0, 3.0], 6)
    for new in (sched.resize([0, 2]), sched.resize([0, 1, 2], joined=1)):
        assert new.backend == "torch"
        assert new.store.device == torch.device("cpu") and new._device == torch.device("cpu")
        assert new.dtype == dtype
        carry = new.store.device_bank(snapshot=False)
        assert carry.xs.device == torch.device("cpu")
        assert carry.xs.dtype == (dtype or torch.float64)
    sched.leave(1)
    assert sched.backend == "torch" and sched.store.device == torch.device("cpu")
    host = Scheduler(n_units=48, num_groups=3, backend="numpy", device="cpu")
    assert host.resize([0, 1]).backend == "numpy"
