"""The port's training path held against the reference's.

Weights come from the reference's ``init_tree`` and reach the port in the
reference's own layout (``nn.tree_from_reference``; the port's training
state keeps the stacked ``units`` tree); inputs are made from a seed with
numpy, batches by each package's ``SyntheticLMData``.  On the CPU the
port's attention and scan run their plain versions with autograd through
them; the reference differentiates its jnp path, as its own training does.

Tolerances (relative to the largest magnitude of the reference's value):

* ``lm_loss`` in float32: loss 1e-5, every gradient leaf 1e-4; in
  bfloat16 (the dense configs): loss 1e-3, every gradient leaf 5e-2 (the
  two frameworks round bfloat16 intermediates at different places);
* ``adamw_update`` on random trees: parameters and moments 1e-6;
* ``make_train_step``'s parity with the reference's step: see
  ``test_torch_train_step.py``;
* batches, checkpoints across the two packages and the in-place against
  the functional update: bit for bit.
"""

import functools
import os
import subprocess
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hyp import given, settings, st

from repro.checkpoint import load_checkpoint as ref_load_checkpoint
from repro.checkpoint import save_checkpoint as ref_save_checkpoint
from repro.configs import get_smoke_config as ref_smoke_config
from repro.data import SyntheticLMData as RefData
from repro.data import UnitBatcher as RefBatcher
from repro.models import transformer as jt
from repro.nn import params as jparams
from repro.optim import adamw_init as ref_adamw_init
from repro.optim import adamw_update as ref_adamw_update
from repro.optim import compress_int8_ef as ref_compress_int8_ef
from repro.optim import warmup_cosine as ref_warmup_cosine
from repro.runtime import train_loop as jtrain

from repro_torch.checkpoint import CheckpointManager, load_checkpoint, save_checkpoint
from repro_torch.configs import get_smoke_config
from repro_torch.data import SyntheticLMData, UnitBatcher
from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import FlashAttention, attention_backward
from repro_torch.kernels.rglru import RGLRUScan, reverse_scan
from repro_torch.launch import train as train_cli
from repro_torch.models import transformer as tt
from repro_torch.nn import (
    ParamSpec,
    axes_tree,
    init_tree,
    param_count,
    params_from_reference,
    spec_tree_shapes,
    stack_tree,
    tree_from_reference,
    unstack_tree,
    tree_leaves,
    tree_map,
)
from repro_torch.optim import (
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    compress_bf16,
    compress_int8_ef,
    decompress_int8,
    warmup_cosine,
)
from repro_torch.runtime import TrainState, init_train_state, loss_for_config, make_train_step

ARCHS = ["gemma2-2b", "gemma2-27b", "granite-20b", "stablelm-12b", "granite-moe-1b-a400m",
         "deepseek-v2-236b", "recurrentgemma-2b"]
DENSE = ["gemma2-2b", "gemma2-27b", "granite-20b", "stablelm-12b"]
KEY = jax.random.PRNGKey(0)
_JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
LOSS_TOL = {"float32": 1e-5, "bfloat16": 1e-3}
GRAD_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
ADAMW_TOL = 1e-6
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfgs(arch, dtype="float32", **kw):
    return (
        ref_smoke_config(arch).replace(dtype=_JNP[dtype], **kw),
        get_smoke_config(arch).replace(dtype=_TORCH[dtype], **kw),
    )


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rel(want, got) -> float:
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    return float(np.max(np.abs(want - got)) / (np.max(np.abs(want)) + 1e-30))


def _leaf_rels(want_tree, got_tree) -> dict:
    """Per-leaf rel of a port tree (tensors) against a reference tree."""
    want = dict(tree_leaves(_np(want_tree)))
    got = dict(tree_leaves(got_tree))
    assert set(want) == set(got)
    return {path: _rel(want[path], got[path]) for path in want}


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    """The reference's smoke weights (float32 specs, whatever the dtype)."""
    return _np(jparams.init_tree(KEY, jt.lm_spec(ref_smoke_config(arch))))


def _trainable(np_tree):
    return tree_map(lambda t: t.requires_grad_(True), tree_from_reference(np_tree))


def _torch_batch(b):
    return {k: torch.as_tensor(v).long() for k, v in b.items()}


# ---------------------------------------------------------------------------
# params: specs, axes, shapes; serving stays frozen
# ---------------------------------------------------------------------------


def test_param_spec_validation():
    with pytest.raises(ValueError):
        ParamSpec((4, 4), ("embed",))  # rank mismatch


def test_init_tree_deterministic():
    spec = {"a": ParamSpec((4, 8), ("embed", "mlp")), "b": {"c": ParamSpec((8,), ("mlp",), init="ones")}}
    t1 = init_tree(spec, torch.Generator().manual_seed(1), "cpu")
    t2 = init_tree(spec, torch.Generator().manual_seed(1), "cpu")
    for (_, x), (_, y) in zip(tree_leaves(t1), tree_leaves(t2)):
        assert torch.equal(x, y)
    assert param_count(spec) == 4 * 8 + 8


@pytest.mark.parametrize("arch", ARCHS)
def test_axes_and_shapes_trees_match_the_reference(arch):
    jcfg, tcfg = _cfgs(arch)
    want_axes = dict(tree_leaves(jax.tree_util.tree_map(
        lambda l: l.axes, jt.lm_spec(jcfg), is_leaf=lambda x: isinstance(x, jparams.ParamSpec))))
    assert dict(tree_leaves(axes_tree(tt.lm_spec(tcfg)))) == want_axes  # (path, axis index) -> name
    want = dict(tree_leaves(jparams.spec_tree_shapes(jt.lm_spec(jcfg))))
    got = dict(tree_leaves(spec_tree_shapes(tt.lm_spec(tcfg))))
    assert set(got) == set(want)
    for path, t in got.items():
        assert t.device.type == "meta" and tuple(t.shape) == tuple(want[path].shape) and t.dtype == torch.float32


def test_serving_forward_of_a_fresh_model_builds_no_graph():
    """Serving's forwards outside ``inference_mode`` (the checks that run
    the full forward, the dispatch replicas) record no autograd graph: the
    parameters are built frozen, and the kernels' Functions see no input
    that needs a gradient."""
    cfg = get_smoke_config("recurrentgemma-2b").replace(dtype=torch.float32, remat="full")
    model = tt.init_lm(cfg, torch.Generator().manual_seed(0), "cpu")
    assert not any(p.requires_grad for p in model.parameters())
    assert torch.is_grad_enabled()
    tokens = torch.randint(0, cfg.vocab_size, (2, 12), generator=torch.Generator().manual_seed(1))
    hidden, _, aux = tt.apply_lm(model, cfg, tokens, torch.arange(12))
    logits = tt.lm_logits(model, cfg, hidden)
    assert hidden.grad_fn is None and logits.grad_fn is None and not logits.requires_grad
    loss, _ = tt.lm_loss(stack_tree(model.state_dict(), cfg, numpy=False), cfg, {"tokens": tokens, "labels": tokens})
    assert loss.grad_fn is None


# ---------------------------------------------------------------------------
# stack_tree: the inverse of unstack_tree
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_stack_tree_inverts_unstack_tree(arch):
    jcfg, tcfg = _cfgs(arch)
    p = _ref_params(arch)
    back = stack_tree(params_from_reference(p, tcfg), tcfg)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(p)
    for a, b in zip(jax.tree_util.tree_leaves(p), jax.tree_util.tree_leaves(back)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    as_tensors = stack_tree(params_from_reference(p, tcfg), tcfg, numpy=False)
    for (_, a), b in zip(tree_leaves(as_tensors), jax.tree_util.tree_leaves(p)):
        assert isinstance(a, torch.Tensor) and np.array_equal(a.numpy(), b)
    with pytest.raises(KeyError):
        stack_tree({"embed.embedding": torch.zeros(1)}, tcfg)


def test_stack_tree_keeps_bfloat16_bits():
    _, tcfg = _cfgs("gemma2-2b")
    model = tt.init_lm(tcfg, torch.Generator().manual_seed(0), "cpu")
    flat = {k: v.to(torch.bfloat16) for k, v in model.state_dict().items()}
    tree = stack_tree(flat, tcfg)
    back = params_from_reference(tree, tcfg)
    for k, v in flat.items():
        assert back[k].dtype == torch.bfloat16 and torch.equal(back[k], v)


# ---------------------------------------------------------------------------
# Data pipeline (bit for bit the reference's)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["granite-20b", "gemma2-2b", "recurrentgemma-2b"])
@pytest.mark.parametrize("seed", [0, 3])
def test_batches_bit_identical_to_the_reference(arch, seed):
    jcfg, tcfg = _cfgs(arch)
    want, got = RefData(jcfg, batch=3, seq=24, seed=seed), SyntheticLMData(tcfg, batch=3, seq=24, seed=seed)
    for _ in range(3):
        w, g = want.next(), got.next()
        assert set(w) == set(g)
        for k in w:
            assert w[k].dtype == g[k].dtype and np.array_equal(w[k], g[k])
    assert want.state_dict() == got.state_dict()
    rb, tb = RefBatcher(RefData(jcfg, 2, 8, seed=seed), 2), UnitBatcher(SyntheticLMData(tcfg, 2, 8, seed=seed), 2)
    w, g = rb.global_step_units(6, step=2), tb.global_step_units(6, step=2)
    for k in w:
        assert np.array_equal(w[k], g[k])
    for pw, pg in zip(rb.split(w, [1, 3, 2]), tb.split(g, [1, 3, 2])):
        assert all(np.array_equal(pw[k], pg[k]) for k in pw)


def test_data_deterministic_and_resumable():
    cfg = get_smoke_config("granite-20b")
    d1 = SyntheticLMData(cfg, batch=2, seq=16, seed=3)
    b0, b1 = d1.next(), d1.next()
    state = d1.state_dict()
    b2 = d1.next()
    d2 = SyntheticLMData(cfg, batch=2, seq=16, seed=3)
    d2.load_state_dict(state)
    b2r = d2.next()
    np.testing.assert_array_equal(b2["tokens"], b2r["tokens"])
    assert not np.array_equal(b0["tokens"], b1["tokens"])


def test_labels_are_shifted_tokens():
    cfg = get_smoke_config("granite-20b")
    b = SyntheticLMData(cfg, batch=2, seq=16).next()
    np.testing.assert_array_equal(b["labels"][:, :-1], b["tokens"][:, 1:])
    assert (b["labels"][:, -1] == -1).all()


def test_unit_batcher_split_matches_distribution():
    cfg = get_smoke_config("granite-20b")
    batcher = UnitBatcher(SyntheticLMData(cfg, batch=2, seq=8), micro_batch=2)
    units = batcher.global_step_units(10, step=0)
    assert units["tokens"].shape == (10, 2, 8)
    parts = batcher.split(units, [3, 5, 2])
    assert [p["tokens"].shape[0] for p in parts] == [3, 5, 2]
    np.testing.assert_array_equal(np.concatenate([p["tokens"] for p in parts]), units["tokens"])


def test_unit_batcher_steps_disjoint():
    cfg = get_smoke_config("granite-20b")
    batcher = UnitBatcher(SyntheticLMData(cfg, batch=2, seq=8), micro_batch=2)
    u0 = batcher.global_step_units(4, step=0)
    u1 = batcher.global_step_units(4, step=1)
    assert not np.array_equal(u0["tokens"], u1["tokens"])
    np.testing.assert_array_equal(u0["tokens"], batcher.global_step_units(4, step=0)["tokens"])


# ---------------------------------------------------------------------------
# Optimizer, schedule, compression
# ---------------------------------------------------------------------------


def test_adamw_converges_on_quadratic():
    params = {"w": torch.tensor([5.0, -3.0])}
    state = adamw_init(params)
    for _ in range(300):
        params, state, _ = adamw_update({"w": 2 * params["w"]}, state, params, lr=0.1, weight_decay=0.0)
    assert float(params["w"].abs().max()) < 0.05


def test_adamw_bf16_moments_still_converges():
    params = {"w": torch.tensor([5.0, -3.0])}
    state = adamw_init(params, moment_dtype=torch.bfloat16)
    assert state.mu["w"].dtype == torch.bfloat16
    for _ in range(300):
        params, state, _ = adamw_update({"w": 2 * params["w"]}, state, params, lr=0.1, weight_decay=0.0)
    assert state.mu["w"].dtype == torch.bfloat16
    assert float(params["w"].abs().max()) < 0.1


def test_clip_by_global_norm():
    clipped, norm = clip_by_global_norm({"a": torch.ones(3) * 4.0}, 1.0)
    assert float(norm) == pytest.approx(np.sqrt(48.0))
    assert float(clipped["a"].square().sum().sqrt()) == pytest.approx(1.0, rel=1e-5)


def test_warmup_cosine_matches_the_reference():
    want, got = ref_warmup_cosine(1.0, 10, 100, floor=0.1), warmup_cosine(1.0, 10, 100, floor=0.1)
    assert float(got(0)) == pytest.approx(0.1)
    assert float(got(9)) == pytest.approx(1.0)
    assert float(got(100)) == pytest.approx(0.1, abs=1e-6)
    assert float(got(55)) < float(got(20))
    for step in [0, 3, 9, 10, 11, 40, 55, 99, 100, 150]:
        assert float(got(torch.tensor(step, dtype=torch.int32))) == pytest.approx(float(want(step)), rel=1e-6)


def test_compress_bf16_roundtrip():
    c = compress_bf16({"w": torch.tensor([1.0, 2.5, -3.25]), "t": (torch.ones(2),)})
    assert c["w"].dtype == torch.bfloat16 and c["t"][0].dtype == torch.bfloat16


@given(vals=st.lists(st.floats(-10, 10, allow_nan=False), min_size=4, max_size=32))
@settings(max_examples=50, deadline=None)
def test_int8_error_feedback_unbiased_over_time(vals):
    """Repeated compression of the same gradient with error feedback: the
    accumulated decompressed sum approaches the accumulated true sum."""
    g = {"w": torch.tensor(vals, dtype=torch.float32)}
    err = {"w": torch.zeros_like(g["w"])}
    acc = torch.zeros_like(g["w"])
    T = 20
    for _ in range(T):
        q, s, err = compress_int8_ef(g, err)
        acc = acc + decompress_int8(q, s)["w"]
    scale = float(g["w"].abs().max()) + 1e-6
    assert float((acc / T - g["w"]).abs().max()) / scale < 0.02


def test_int8_compression_matches_the_reference():
    rng = np.random.default_rng(5)
    g = {"a": rng.standard_normal((5, 7)).astype(np.float32), "b": (rng.standard_normal(9).astype(np.float32),)}
    e = jax.tree_util.tree_map(lambda a: (0.01 * rng.standard_normal(a.shape)).astype(np.float32), g)
    want = ref_compress_int8_ef(jax.tree_util.tree_map(jnp.asarray, g), jax.tree_util.tree_map(jnp.asarray, e))
    got = compress_int8_ef(tree_from_reference(g), tree_from_reference(e))
    for w, t in zip(want, got):
        for (pw, a), (pt, b) in zip(tree_leaves(_np(w)), tree_leaves(t)):
            assert pw == pt
            np.testing.assert_allclose(b.numpy(), a, rtol=1e-6, atol=1e-7)


def _random_tree(rng):
    return {"w": rng.standard_normal((6, 5)).astype(np.float32),
            "u": ({"x": rng.standard_normal((3, 4, 2)).astype(np.float32)}, rng.standard_normal(7).astype(np.float32))}


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("max_grad_norm", [1.0, 0.0])
def test_adamw_update_matches_the_reference(moment_dtype, max_grad_norm):
    rng = np.random.default_rng(7)
    p = _random_tree(rng)
    jp, tp = jax.tree_util.tree_map(jnp.asarray, p), tree_from_reference(p)
    js = ref_adamw_init(jp, moment_dtype=_JNP[moment_dtype])
    ts = adamw_init(tp, moment_dtype=_TORCH[moment_dtype])
    for i in range(4):
        g = jax.tree_util.tree_map(lambda a: (3.0 * rng.standard_normal(a.shape)).astype(np.float32), p)
        lr = 1e-2 * (i + 1)
        jp, js, jm = ref_adamw_update(jax.tree_util.tree_map(jnp.asarray, g), js, jp, lr=jnp.float32(lr),
                                      max_grad_norm=max_grad_norm)
        tp, ts, tm = adamw_update(tree_from_reference(g), ts, tp, lr=lr, max_grad_norm=max_grad_norm)
        for want, got in ((jp, tp), (js.mu, ts.mu), (js.nu, ts.nu)):
            assert max(_leaf_rels(want, got).values()) <= ADAMW_TOL
        assert int(ts.count) == int(js.count) == i + 1
        assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-6)
    assert all(t.dtype == _TORCH[moment_dtype] for _, t in tree_leaves(ts.mu))


def test_adamw_inplace_is_the_functional_update_bit_for_bit():
    rng = np.random.default_rng(11)
    p = _random_tree(rng)
    a, b = tree_from_reference(p), tree_from_reference(p)
    sa, sb = adamw_init(a, moment_dtype=torch.bfloat16), adamw_init(b, moment_dtype=torch.bfloat16)
    for _ in range(3):
        g = tree_from_reference(jax.tree_util.tree_map(lambda x: rng.standard_normal(x.shape).astype(np.float32), p))
        before = [t.clone() for _, t in tree_leaves(a)]
        a2, sa2, _ = adamw_update(g, sa, a, lr=0.05)
        assert all(torch.equal(x, t) for x, (_, t) in zip(before, tree_leaves(a)))  # input untouched
        ids = [id(t) for _, t in tree_leaves(b)]
        b, sb, _ = adamw_update(g, sb, b, lr=0.05, inplace=True)
        assert [id(t) for _, t in tree_leaves(b)] == ids  # written into the same tensors
        a, sa = a2, sa2
        for x, y in zip(tree_leaves((a, sa.mu, sa.nu)), tree_leaves((b, sb.mu, sb.nu))):
            assert torch.equal(x[1], y[1])


# ---------------------------------------------------------------------------
# lm_loss and its gradients against jax.value_and_grad of the reference's
# ---------------------------------------------------------------------------


_ref_loss_and_grad = jax.jit(
    jax.value_and_grad(lambda p, cfg, b: jt.lm_loss(p, cfg, b), has_aux=True), static_argnums=(1,)
)


def _loss_case(arch, dtype, **kw):
    jcfg, tcfg = _cfgs(arch, dtype, **kw)
    p = _ref_params(arch)
    b = RefData(jcfg, batch=2, seq=16, seed=1).next()
    (loss, metrics), grads = _ref_loss_and_grad(p, jcfg, {k: jnp.asarray(v) for k, v in b.items()})
    tp = _trainable(p)
    tl, tm = tt.lm_loss(tp, tcfg, _torch_batch(b))
    leaves = []
    tree_map(leaves.append, tp)
    it = iter(torch.autograd.grad(tl, leaves))
    return (loss, metrics, grads), (tl, tm, tree_map(lambda _: next(it), tp))


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_and_gradients_match_the_reference(arch):
    (loss, metrics, grads), (tl, tm, tg) = _loss_case(arch, "float32")
    assert _rel(loss, tl) <= LOSS_TOL["float32"]
    for k in ("nll", "tokens", "aux"):
        assert _rel(metrics[k], tm[k]) <= LOSS_TOL["float32"], k
    rels = _leaf_rels(grads, tg)
    assert max(rels.values()) <= GRAD_TOL["float32"], max(rels.items(), key=lambda kv: kv[1])


@pytest.mark.parametrize("arch", ["gemma2-2b", "granite-moe-1b-a400m", "recurrentgemma-2b", "deepseek-v2-236b"])
def test_lm_loss_with_remat_chunked_xent_and_zloss(arch):
    """The full configs' ``remat="full"`` and ``xent_chunk``, and a zloss
    term: the same loss and gradients (each layer and each chunk of 8
    positions recomputed in the backward)."""
    (loss, metrics, grads), (tl, tm, tg) = _loss_case(arch, "float32", remat="full", xent_chunk=8, zloss=1e-3)
    assert _rel(loss, tl) <= LOSS_TOL["float32"]
    assert _rel(metrics["nll"], tm["nll"]) <= LOSS_TOL["float32"]
    assert max(_leaf_rels(grads, tg).values()) <= GRAD_TOL["float32"]


@pytest.mark.parametrize("arch", DENSE)
def test_lm_loss_and_gradients_in_bfloat16(arch):
    (loss, _, grads), (tl, _, tg) = _loss_case(arch, "bfloat16")
    assert _rel(loss, tl) <= LOSS_TOL["bfloat16"]
    rels = _leaf_rels(grads, tg)
    assert max(rels.values()) <= GRAD_TOL["bfloat16"], max(rels.items(), key=lambda kv: kv[1])


def test_lm_loss_takes_a_language_model_or_the_stacked_tree():
    """A serving model's weights reach ``lm_loss`` as the stacked tree
    (``stack_tree`` at the caller) and give the reference-layout tree's
    loss; the model itself is refused.  ``prefix_embeds`` train: the loss
    over the text after a 3-position prefix is the reference's, and the
    gradient reaches the prefix and the weights."""
    jcfg, tcfg = _cfgs("recurrentgemma-2b")
    p = _ref_params("recurrentgemma-2b")
    raw = RefData(jcfg, batch=2, seq=16).next()
    b = _torch_batch(raw)
    model = tt.LanguageModel.from_state_dict(tcfg, params_from_reference(p, tcfg))
    with torch.no_grad():
        a, _ = tt.lm_loss(stack_tree(model.state_dict(), tcfg, numpy=False), tcfg, b)
        c, _ = tt.lm_loss(tree_from_reference(p), tcfg, b)
    assert torch.equal(a, c)
    with pytest.raises(TypeError, match="stack_tree"):
        tt.lm_loss(model, tcfg, b)
    pe = (0.02 * np.random.default_rng(3).standard_normal((2, 3, tcfg.d_model))).astype(np.float32)
    (want, wm), _ = _ref_loss_and_grad(p, jcfg, {**{k: jnp.asarray(v) for k, v in raw.items()},
                                                 "prefix_embeds": jnp.asarray(pe)})
    tp, tpe = _trainable(p), torch.from_numpy(pe).requires_grad_(True)
    got, gm = tt.lm_loss(tp, tcfg, {**b, "prefix_embeds": tpe})
    assert _rel(want, got) <= LOSS_TOL["float32"] and float(gm["tokens"]) == float(wm["tokens"]) == 30
    got.backward()
    assert float(tpe.grad.abs().sum()) > 0 and float(tp["embed"]["embedding"].grad.abs().sum()) > 0


# ---------------------------------------------------------------------------
# The train step (its parity with the reference's jitted step is in
# test_torch_train_step.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["gemma2-2b", "granite-moe-1b-a400m", "recurrentgemma-2b"])
def test_train_step_inplace_is_the_functional_step_bit_for_bit(arch):
    """The in-place form ``train_single`` takes gives the functional form's
    state bit for bit; the functional step leaves its input untouched."""
    _, tcfg = _cfgs(arch, remat="full", xent_chunk=8)
    data = SyntheticLMData(tcfg, batch=2, seq=16)
    f_state = init_train_state(tcfg, 0, device="cpu")
    i_state = init_train_state(tcfg, 0, device="cpu")
    sched = warmup_cosine(3e-3, 1, 3)
    functional, inplace = make_train_step(tcfg, sched), make_train_step(tcfg, sched, inplace=True)
    for _ in range(3):
        b = data.next()
        kept = [t.clone() for _, t in tree_leaves((f_state.params, f_state.opt.mu))]
        new_f, fm = functional(f_state, b)
        assert all(torch.equal(k, t) for k, (_, t) in zip(kept, tree_leaves((f_state.params, f_state.opt.mu))))
        i_state, im = inplace(i_state, b)
        f_state = new_f
        assert torch.equal(fm["loss"], im["loss"]) and torch.equal(fm["grad_norm"], im["grad_norm"])
        for (_, x), (_, y) in zip(tree_leaves(f_state), tree_leaves(i_state)):
            assert torch.equal(x, y)


def test_init_train_state_from_a_model_and_its_refusals():
    _, tcfg = _cfgs("gemma2-2b")
    model = tt.init_lm(tcfg, torch.Generator().manual_seed(0), "cpu")
    state = init_train_state(tcfg, params=stack_tree(model.state_dict(), tcfg, numpy=False), device="cpu")
    want = stack_tree(model.state_dict(), tcfg)
    for (pw, a), (pt, b) in zip(tree_leaves(want), tree_leaves(state.params)):
        assert pw == pt and b.requires_grad and np.array_equal(a, b.detach().numpy())
    assert not any(p.requires_grad for p in model.parameters())  # the model stays frozen
    assert isinstance(state, TrainState) and int(state.step) == 0 and int(state.opt.count) == 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            init_train_state(tcfg, 0)
    assert callable(loss_for_config(tcfg))


# ---------------------------------------------------------------------------
# The kernels' autograd Functions (float64 on their CPU path)
# ---------------------------------------------------------------------------


FLASH_GRAD_CASES = [  # (B, H, Kv, Sq, Sk, D, causal, window, softcap)
    (1, 4, 2, 6, 9, 4, True, 3, 2.0),
    (2, 2, 1, 5, 5, 3, False, 0, 0.0),
    (1, 3, 3, 7, 7, 4, True, 0, 0.0),
    (2, 4, 1, 8, 8, 4, True, 4, 50.0),
]


@pytest.mark.parametrize("rows_per_block", [None, 2])
@pytest.mark.parametrize("case", FLASH_GRAD_CASES)
def test_flash_attention_function_gradcheck(case, rows_per_block, monkeypatch):
    """``FlashAttention``'s backward formula (query rows recomputed a block
    at a time over the keys they see) against finite differences, and its
    gradients against autograd through the plain version."""
    B, H, Kv, Sq, Sk, D, causal, window, cap = case
    fa = sys.modules["repro_torch.kernels.flash_attention"]
    if rows_per_block:
        monkeypatch.setattr(fa, "BACKWARD_LOGITS", rows_per_block * B * H * Sk)
    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(B, n, s, D, dtype=torch.float64, generator=g, requires_grad=True)
               for n, s in ((H, Sq), (Kv, Sk), (Kv, Sk)))
    fn = lambda q, k, v: FlashAttention.apply(q, k, v, causal, window, cap, None, None, None, False)
    assert torch.autograd.gradcheck(fn, (q, k, v))
    dout = torch.randn(B, H, Sq, D, dtype=torch.float64, generator=g)
    want = torch.autograd.grad(ref.flash_attention_ref(q, k, v, causal=causal, window=window, softcap=cap), (q, k, v), dout)
    got = attention_backward(q.detach(), k.detach(), v.detach(), dout, causal=causal, window=window,
                             softcap=cap, scale=1.0 / np.sqrt(D))
    for w, t in zip(want, got):
        torch.testing.assert_close(t, w, rtol=1e-6, atol=1e-6)  # ref's logits are float32


@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_scan_function_gradcheck(with_h0):
    """``RGLRUScan``'s backward (the reversed recurrence plus elementwise
    terms) against finite differences and autograd through the plain
    version."""
    g = torch.Generator().manual_seed(4)
    la = (-torch.rand(2, 9, 3, dtype=torch.float64, generator=g)).requires_grad_(True)
    b = torch.randn(2, 9, 3, dtype=torch.float64, generator=g, requires_grad=True)
    h0 = torch.randn(2, 3, dtype=torch.float64, generator=g, requires_grad=True) if with_h0 else None
    fn = lambda la, b, h0: RGLRUScan.apply(la, b, h0, None, None, False)
    args = (la, b, h0)
    assert torch.autograd.gradcheck(fn, args)
    dh = torch.randn(2, 9, 3, dtype=torch.float64, generator=g)
    inputs = tuple(a for a in args if a is not None)
    want = torch.autograd.grad(ref.rglru_scan_ref(la, b, h0), inputs, dh)
    got = torch.autograd.grad(fn(*args), inputs, dh)
    for w, t in zip(want, got):
        torch.testing.assert_close(t, w, rtol=1e-12, atol=1e-12)
    g_rev = reverse_scan(la.detach(), dh, False)
    for t in range(9):
        nxt = torch.exp(la[:, t + 1]) * g_rev[:, t + 1] if t + 1 < 9 else 0.0
        torch.testing.assert_close(g_rev[:, t], dh[:, t] + nxt, rtol=1e-12, atol=1e-12)


def test_ops_keep_the_plain_versions_with_autograd_on_the_host():
    """On CPU tensors the wrappers run the plain versions, differentiable."""
    g = torch.Generator().manual_seed(5)
    q = torch.randn(1, 2, 8, 4, generator=g, requires_grad=True)
    out = ops.flash_attention(q, q[:, :1], q[:, :1], bq=None, bk=None)
    assert out.grad_fn is not None and type(out.grad_fn).__name__ != "FlashAttentionBackward"
    la = (-torch.rand(1, 5, 3, generator=g)).requires_grad_(True)
    h = ops.rglru_scan(la, la.exp(), bs=None, bd=None)
    assert h.grad_fn is not None and "RGLRUScan" not in type(h.grad_fn).__name__


# ---------------------------------------------------------------------------
# Checkpoints (the reference's format; each package restores the other's)
# ---------------------------------------------------------------------------


def _tree():
    return {"params": {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4)},
            "step": torch.tensor(7, dtype=torch.int32)}


def test_checkpoint_roundtrip():
    with tempfile.TemporaryDirectory() as d:
        t = _tree()
        save_checkpoint(d, 7, t)
        back, man = load_checkpoint(d, tree_map(lambda a: torch.empty(a.shape, dtype=a.dtype, device="meta"), t))
        assert man["step"] == 7
        assert torch.equal(back["params"]["w"], t["params"]["w"]) and back["step"].dtype == torch.int32


def test_checkpoint_latest_pointer_and_retention():
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d, keep=2)
        for s in [1, 2, 3]:
            mgr.save_async(s, _tree())
            mgr.wait()
        assert mgr.latest_step() == 3
        assert len([x for x in os.listdir(d) if x.startswith("step_")]) == 2  # retention


def test_checkpoint_async_save_snapshots_before_returning():
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d)
        t = _tree()
        mgr.save_async(1, t)
        t["params"]["w"].add_(100.0)  # an in-place update right after the call
        mgr.wait()
        back, _ = load_checkpoint(d, _tree())
        assert torch.equal(back["params"]["w"], _tree()["params"]["w"])


def test_checkpoint_missing_key_fails_loud():
    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(d, 1, {"a": torch.zeros(3)})
        with pytest.raises(KeyError):
            load_checkpoint(d, {"a": torch.zeros(3), "b": torch.zeros(2)})


def test_checkpoint_atomic_no_tmp_left():
    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(d, 5, _tree())
        assert not [x for x in os.listdir(d) if x.startswith("tmp.")]


def test_checkpoint_dtype_cast_on_restore():
    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(d, 1, {"w": torch.ones(4)})
        back, _ = load_checkpoint(d, {"w": torch.empty(4, dtype=torch.bfloat16, device="meta")})
        assert back["w"].dtype == torch.bfloat16 and back["w"].device.type == "cpu"


def test_checkpoint_refuses_shardings():
    """``shardings=`` restores onto the one-card mesh (every leaf whole on
    the mesh's device, in ``like``'s dtype, values equal to the
    reference's restore onto its own 1x1 mesh); a spec that splits a dim
    over a mesh axis larger than 1 is refused."""
    from jax.sharding import NamedSharding as JNamedSharding

    from repro.sharding import shardings_for_axes as ref_shardings_for_axes
    from repro_torch.launch.mesh import Mesh, make_production_mesh
    from repro_torch.sharding import shardings_for_axes

    axes = {"params": {"w": ("embed", "mlp")}, "step": ()}
    mesh = make_production_mesh(device="cpu")
    shd = shardings_for_axes(axes, mesh, _tree())
    assert shd["params"]["w"].spec == ("data", "model") and shd["step"].spec == ()
    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(d, 1, _tree())
        like = {"params": {"w": torch.empty(3, 4, dtype=torch.bfloat16, device="meta")},
                "step": torch.empty((), dtype=torch.int32, device="meta")}
        back, _ = load_checkpoint(d, like, shardings=shd)
        assert back["params"]["w"].device.type == "cpu" and back["params"]["w"].dtype == torch.bfloat16
        assert torch.equal(back["params"]["w"].float(), _tree()["params"]["w"]) and int(back["step"]) == 7
        jmesh = jax.make_mesh((1, 1), ("data", "model"), axis_types=(jax.sharding.AxisType.Auto,) * 2)
        jlike = {"params": {"w": jax.ShapeDtypeStruct((3, 4), jnp.bfloat16)}, "step": jax.ShapeDtypeStruct((), jnp.int32)}
        jshd = ref_shardings_for_axes(axes, jmesh, jlike)
        assert isinstance(jshd["params"]["w"], JNamedSharding)
        assert tuple(jshd["params"]["w"].spec) == tuple(shd["params"]["w"].spec)
        jback, _ = ref_load_checkpoint(d, jlike, shardings=jshd)
        assert np.array_equal(np.asarray(jback["params"]["w"], np.float32), back["params"]["w"].float().numpy())
        wide = Mesh(("data", "model"), np.arange(2).reshape(1, 2), torch.device("cpu"))
        with pytest.raises(NotImplementedError, match="one card"):
            load_checkpoint(d, _tree(), shardings=shardings_for_axes(axes, wide, _tree()))


def _ref_state(arch):
    jcfg, tcfg = _cfgs(arch)
    state = jtrain.init_train_state(jcfg, KEY)
    step = jax.jit(jtrain.make_train_step(jcfg, ref_warmup_cosine(3e-3, 1, 3)))
    b = RefData(jcfg, batch=2, seq=16).next()
    state, _ = step(state, {k: jnp.asarray(v) for k, v in b.items()})  # moments and count not zero
    return jcfg, tcfg, state


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "recurrentgemma-2b"])
def test_checkpoints_cross_the_two_packages_bit_for_bit(arch):
    jcfg, tcfg, ref_state = _ref_state(arch)
    with tempfile.TemporaryDirectory() as d:
        ref_save_checkpoint(d, 1, {"train": ref_state}, extra={"data": {"next_index": 1, "seed": 0}})
        like = {"train": init_train_state(tcfg, 0, device="cpu")}
        got, man = load_checkpoint(d, like)
        assert man["extra"]["data"]["next_index"] == 1
        state = got["train"]
        assert isinstance(state, TrainState) and int(state.step) == 1 and int(state.opt.count) == 1
        for want, have in ((ref_state.params, state.params), (ref_state.opt.mu, state.opt.mu), (ref_state.opt.nu, state.opt.nu)):
            w, h = dict(tree_leaves(_np(want))), dict(tree_leaves(have))
            assert set(w) == set(h) and all(np.array_equal(w[p], h[p].detach().numpy()) for p in w)
        assert all(t.requires_grad for _, t in tree_leaves(state.params))

        # ... and back: the port's save restored by the reference
        step = make_train_step(tcfg, warmup_cosine(3e-3, 1, 3), inplace=True)
        state, _ = step(state, SyntheticLMData(tcfg, batch=2, seq=16).batch_at(1))
        save_checkpoint(d, 2, {"train": state})
        ref_like = jax.tree_util.tree_map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), {"train": ref_state})
        back, man = ref_load_checkpoint(d, ref_like)
        assert man["step"] == 2
        w, h = dict(tree_leaves(_np(back["train"]))), dict(tree_leaves(state))
        assert set(w) == set(h) and all(np.array_equal(w[p], h[p].detach().numpy()) for p in w)


def test_checkpoint_of_a_serving_model_is_the_stacked_tree():
    """A serving model's weights, saved as the stacked tree, are the
    reference's tree on disk and come back as the same model."""
    jcfg, tcfg = _cfgs("deepseek-v2-236b")
    p = _ref_params("deepseek-v2-236b")
    model = tt.LanguageModel.from_state_dict(tcfg, params_from_reference(p, tcfg))
    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(d, 3, {"params": stack_tree(model.state_dict(), tcfg, numpy=False)})
        back, _ = ref_load_checkpoint(d, {"params": jax.tree_util.tree_map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), p)})
        for a, b in zip(jax.tree_util.tree_leaves(p), jax.tree_util.tree_leaves(_np(back))):
            assert np.array_equal(a, b)
        restored, _ = load_checkpoint(d, {"params": spec_tree_shapes(tt.lm_spec(tcfg))})
        got = tt.LanguageModel.from_state_dict(tcfg, unstack_tree(restored["params"], tcfg))
        assert not any(q.requires_grad for q in got.parameters())
        for k, v in model.state_dict().items():
            assert torch.equal(got.state_dict()[k], v)


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------


def _cli(*args):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.train", *args], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=300)


def test_cli_trains_a_smoke_model_on_the_host():
    out = _cli("--smoke", "--device", "cpu", "--steps", "4", "--batch", "2", "--seq", "16")
    assert out.returncode == 0, out.stderr
    lines = [l for l in out.stdout.splitlines() if l.startswith("step")]
    assert len(lines) == 4 and all(np.isfinite(float(l.split()[3])) for l in lines)


def test_cli_balances_four_groups_on_the_host():
    out = _cli("--arch", "granite-moe-1b-a400m", "--smoke", "--device", "cpu", "--groups", "4",
               "--hetero", "1.0,1.4,2.0,3.1", "--steps", "3", "--batch", "2", "--seq", "8", "--units", "8")
    assert out.returncode == 0, out.stderr
    assert "groups=4" in out.stdout and "rebalances:" in out.stdout
    assert len([l for l in out.stdout.splitlines() if l.startswith("step")]) == 3


def test_train_single_with_checkpoints_resumes(tmp_path):
    """``train_single`` on the host: losses finite, the final checkpoint
    holds the returned state bit for bit."""
    _, tcfg = _cfgs("gemma2-2b")
    state, losses = train_cli.train_single(tcfg, steps=3, batch=2, seq=16, lr=3e-3, ckpt_dir=str(tmp_path),
                                           device="cpu", log_every=10)
    assert len(losses) == 3 and np.isfinite(losses).all()
    back, man = load_checkpoint(str(tmp_path), state)
    assert man["step"] == 3
    for (_, a), (_, b) in zip(tree_leaves(back), tree_leaves(state)):
        assert torch.equal(a, b)
