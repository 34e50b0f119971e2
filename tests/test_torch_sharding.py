"""The port's mesh code (``repro_torch.sharding``, ``launch.mesh``) against
the reference's: the logical-axis rules on fake meshes of any size (they
read only ``axis_names`` and ``devices.shape``), the shardings of whole
model specs, the activation constraint on the one-card mesh, and a
checkpoint restored onto the one-card mesh."""

import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hyp import given, settings, st

from repro.configs import get_config as ref_get_config
from repro.nn.params import ParamSpec as RefParamSpec
from repro.sharding import logical_to_pspec as ref_logical_to_pspec
from repro.sharding import maybe_constrain as ref_maybe_constrain
from repro.sharding import activation_sharding as ref_activation_sharding
from repro.sharding import shardings_for_spec as ref_shardings_for_spec
from repro.sharding.context import ACT_RULES as REF_ACT_RULES
from repro.sharding.rules import LOGICAL_RULES as REF_RULES

from repro_torch.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.launch.mesh import HW, Mesh, make_mesh, make_production_mesh
from repro_torch.models import transformer as tt
from repro_torch.nn import tree_leaves, tree_map
from repro_torch.optim import AdamWState
from repro_torch.runtime import TrainState, init_train_state
from repro_torch.sharding import (
    LOGICAL_RULES,
    NamedSharding,
    PartitionSpec,
    activation_sharding,
    batch_pspec,
    current_activation_mesh,
    logical_to_pspec,
    maybe_constrain,
    shardings_for_axes,
    shardings_for_spec,
)
from repro_torch.sharding.context import ACT_RULES

AXES = [None] + sorted(set(LOGICAL_RULES) | {"seq_act", "embed_act"})


class _FakeMesh:
    """The rules read only axis_names and the device shape: a 16x16 mesh
    (the reference's ``tests/test_substrate.py`` fake)."""

    axis_names = ("data", "model")

    class devices:
        shape = (16, 16)


def _fake(names, sizes):
    return type("M", (), {"axis_names": tuple(names), "devices": type("D", (), {"shape": tuple(sizes)})})


def _jmesh():
    return jax.make_mesh((1, 1), ("data", "model"), axis_types=(jax.sharding.AxisType.Auto,) * 2)


def test_rule_tables_are_the_references():
    assert LOGICAL_RULES == REF_RULES and ACT_RULES == REF_ACT_RULES


@pytest.mark.parametrize("case", [
    # test_rules_basic
    (("embed", "heads", "head_dim"), (64, 32, 16), ("data", "model")),
    (("batch",), (256,), ("data",)),
    # test_rules_conflict_resolution: experts take model; mlp can't reuse it
    (("experts", "embed", "mlp"), (32, 64, 128), ("model", "data")),
    # test_rules_divisibility_fallback: kv_heads=1 can't shard 16 ways; odd dim drops the axis
    (("embed", "kv_heads", "head_dim"), (64, 1, 16), ("data",)),
    (("embed",), (65,), ()),
])
def test_rules_match_the_reference(case):
    axes, shape, want = case
    got = logical_to_pspec(axes, _FakeMesh, shape)
    assert isinstance(got, PartitionSpec) and got == want
    assert tuple(ref_logical_to_pspec(axes, _FakeMesh(), shape)) == tuple(got)


@given(
    axes=st.lists(st.sampled_from(AXES), min_size=0, max_size=5),
    dims=st.lists(st.sampled_from([1, 2, 3, 4, 6, 8, 12, 16, 48, 64, 65, 256]), min_size=5, max_size=5),
    sizes=st.lists(st.sampled_from([1, 2, 3, 4, 8, 16]), min_size=3, max_size=3),
    pod=st.booleans(),
    with_shape=st.booleans(),
    act=st.booleans(),
)
@settings(max_examples=200, deadline=None)
def test_rules_match_the_reference_on_random_meshes(axes, dims, sizes, pod, with_shape, act):
    names = ("pod", "data", "model") if pod else ("data", "model")
    mesh = _fake(names, sizes[:len(names)])
    shape = tuple(dims[:len(axes)]) if with_shape else None
    rules = ACT_RULES if act else None
    got = logical_to_pspec(axes, mesh, shape, rules)
    want = ref_logical_to_pspec(axes, mesh, shape, dict(REF_ACT_RULES) if act else None)
    assert tuple(got) == tuple(want)
    assert tuple(batch_pspec(mesh, dims[0])) == tuple(ref_logical_to_pspec(("batch",), mesh, (dims[0],)))


def _ref_leaves(tree):
    leaves = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, RefParamSpec))[0]
    return [("/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path), leaf) for path, leaf in leaves]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_shardings_for_spec_over_a_whole_model(arch):
    """Every parameter of every config: the port's specs on a fake 16x16
    mesh are the reference's rules' on the reference's spec, and on the
    one-card mesh the reference's own ``shardings_for_spec`` agrees."""
    from repro.runtime.train_loop import model_spec_for as ref_model_spec_for
    from repro_torch.runtime.train_loop import model_spec_for

    jcfg, cfg = ref_get_config(arch), get_config(arch)
    jspec, spec = ref_model_spec_for(jcfg), model_spec_for(cfg)
    want = {p: tuple(ref_logical_to_pspec(l.axes, _FakeMesh(), l.shape)) for p, l in _ref_leaves(jspec)}
    got = {"/".join(map(str, p)): s for p, s in tree_leaves(shardings_for_spec(spec, _FakeMesh))}
    assert got.keys() == want.keys()
    assert all(isinstance(s, NamedSharding) and s.mesh is _FakeMesh for s in got.values())
    assert {p: tuple(s.spec) for p, s in got.items()} == want
    mesh = make_production_mesh(device="cpu")
    one = {"/".join(map(str, p)): tuple(s.spec) for p, s in tree_leaves(shardings_for_spec(spec, mesh))}
    jone = jax.tree_util.tree_flatten_with_path(ref_shardings_for_spec(jspec, _jmesh()))[0]
    assert one == {"/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path): tuple(s.spec)
                   for path, s in jone}
    assert all(not s.split_axes() for _, s in tree_leaves(shardings_for_spec(spec, mesh)))


def test_shardings_for_axes_walks_the_cache_tree():
    cfg = get_config("gemma2-2b")
    axes = tt.cache_axes(cfg)
    caches = tt.init_cache(cfg, 16, 8192, cfg.dtype, device="meta")
    shd = shardings_for_axes(axes, _FakeMesh, caches)
    assert isinstance(shd, list) and len(shd) == cfg.num_layers
    # global layers shard the sequence over "model"; kv_heads then replicates
    assert shd[1]["k"].spec == ("data", "model") and shd[0]["k"].spec == ("data",)
    assert shd[1]["pos"].spec == ()
    no_shapes = shardings_for_axes(axes, _FakeMesh)
    assert no_shapes[1]["k"].spec == ("data", "model") and no_shapes[0]["k"].spec == ("data", None, "model")


def test_maybe_constrain_is_the_identity_on_one_card():
    x = torch.zeros(2, 8, 4)
    assert current_activation_mesh() is None
    assert maybe_constrain(x, ("batch", "seq_act", "embed_act")) is x
    mesh = make_production_mesh(device="cpu")
    with activation_sharding(mesh):
        assert current_activation_mesh() is mesh
        assert maybe_constrain(x, ("batch", "seq_act", "embed_act")) is x
        assert maybe_constrain(x, ("batch",)) is x
    assert current_activation_mesh() is None


def test_maybe_constrain_rank_error_as_the_reference():
    """A spec longer than the tensor's rank raises, in both packages."""
    x = torch.zeros(2, 8)
    with activation_sharding(make_production_mesh(device="cpu")):
        with pytest.raises((ValueError, IndexError)):
            maybe_constrain(x, ("batch", None, "heads"))
    with ref_activation_sharding(_jmesh()):
        with pytest.raises((ValueError, IndexError)):
            ref_maybe_constrain(jnp.zeros((2, 8)), ("batch", None, "heads"))


def test_maybe_constrain_refuses_a_mesh_larger_than_one_card():
    wide = Mesh(("data", "model"), np.arange(2).reshape(1, 2), torch.device("cpu"))
    with activation_sharding(wide):
        with pytest.raises(NotImplementedError, match="one card"):
            maybe_constrain(torch.zeros(2, 8), ("batch", "seq_act"))


def test_meshes():
    mesh = make_production_mesh(device="cpu")
    assert mesh.axis_names == ("data", "model") and mesh.devices.shape == (1, 1)
    assert mesh.shape == {"data": 1, "model": 1}
    with pytest.raises(NotImplementedError, match="one card"):
        make_production_mesh(multi_pod=True)
    with pytest.raises(RuntimeError, match="needs 2"):
        make_mesh((1, 2), ("data", "model"), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            make_production_mesh()
    assert HW.peak_flops(torch.bfloat16) == 989e12 and HW.peak_flops(torch.float32) == 67e12
    assert HW.HBM_BW == 3.35e12 and 80e9 < HW.HBM_BYTES < 86e9


def test_restore_onto_the_one_card_mesh():
    """A smoke training state saved, then restored with ``shardings=``
    (``shardings_for_spec`` for the parameters and moments, replicated
    scalars): every leaf on the mesh's device, in ``like``'s dtype, equal;
    parameters keep ``requires_grad``."""
    from repro_torch.runtime.train_loop import model_spec_for

    cfg = get_smoke_config("gemma2-2b")
    state = init_train_state(cfg, 0, device="cpu")
    mesh = make_production_mesh(device="cpu")
    pshd = shardings_for_spec(model_spec_for(cfg), mesh)
    scalar = NamedSharding(mesh, PartitionSpec())
    shd = TrainState(params=pshd, opt=AdamWState(mu=pshd, nu=pshd, count=scalar), step=scalar)
    like = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta").requires_grad_(t.requires_grad),
                    state.params)
    like = TrainState(params=like, opt=AdamWState(mu=like, nu=like, count=state.opt.count), step=state.step)
    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(d, 3, state)
        back, manifest = load_checkpoint(d, like, shardings=shd)
    assert manifest["step"] == 3
    for (path, got), (_, want) in zip(tree_leaves(back.params), tree_leaves(state.params)):
        assert got.device.type == "cpu" and got.dtype == want.dtype and got.requires_grad, path
        assert torch.equal(got, want.detach()), path
    assert back.step.dtype == torch.int32
