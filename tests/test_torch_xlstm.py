"""The port's xLSTM (xlstm-350m: alternating mLSTM and sLSTM blocks) held
against the reference's.

Weights come from the reference's ``init_tree`` and reach the port through
``nn.convert.params_from_reference`` (the training tests: in the
reference's stacked layout, ``nn.tree_from_reference``); inputs are made
from a seed with numpy.  The xLSTM blocks launch no kernel on either side.

Tolerances, relative to the largest magnitude of the reference's value:

* the blocks in float32: 1e-5 for outputs and carried states (the mLSTM's
  ``C`` and ``n``, the sLSTM's ``c``, ``n``, ``h``; the stabilisers ``m``
  are compared the same way) — the exp-gate stabilisers need no more than
  the attention blocks do; in bfloat16 3e-2: the two frameworks round the
  bfloat16 projections and conv state at different places (the
  reference's XLA keeps excess precision), and after a 512-position
  prefill and three decode steps each package's bfloat16 mLSTM output
  lies 2.2e-2 (the reference's) and 2.3e-2 (the port's) from the same
  block in float32;
* whole-model logits 1e-4 in float32 and 2e-2 in bfloat16, as
  ``test_torch_decoders.py``; prefill + decode against the reference 1e-4
  (float32); prefill + decode against the port's own full forward rel
  0.05 (bfloat16, the reference's test of the same name);
* ``lm_loss`` in float32: loss 1e-5, every gradient leaf 1e-4, as
  ``test_torch_train.py``; the train step as ``_train_parity`` holds it.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _train_parity import check_train_steps, leaf_rels, np_tree

import repro.models.transformer as jt
from repro.configs import get_config as ref_get_config
from repro.configs import get_smoke_config as ref_smoke_config
from repro.data import SyntheticLMData as RefData
from repro.models import recurrent as jrec
from repro.nn import params as jparams
from repro.runtime.serve_loop import ServeEngine as RefServeEngine

import repro_torch.models.encdec as ted
import repro_torch.models.transformer as tt
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.models import recurrent as trec
from repro_torch.nn import param_count, params_from_reference, tree_from_reference, tree_leaves, tree_map
from repro_torch.runtime import ServeEngine

ARCH = "xlstm-350m"
KEY = jax.random.PRNGKey(0)
_JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
BLOCK_TOL = {"float32": 1e-5, "bfloat16": 3e-2}
LOGITS_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
LOSS_TOL, GRAD_TOL = 1e-5, 1e-4


def _cfgs(dtype="float32", **kw):
    return (ref_smoke_config(ARCH).replace(dtype=_JNP[dtype], **kw),
            get_smoke_config(ARCH).replace(dtype=_TORCH[dtype], **kw))


def _rel(want, got) -> float:
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    return float(np.max(np.abs(want - got)) / (np.max(np.abs(want)) + 1e-30))


def _x(shape, seed=0, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _tree(jtree):
    if isinstance(jtree, dict):
        return {k: _tree(v) for k, v in jtree.items()}
    return torch.from_numpy(np.array(jtree))


@functools.lru_cache(maxsize=None)
def _ref_params(jcfg):
    spec = jt.lm_spec(jcfg)
    return jax.jit(lambda key: jparams.init_tree(key, spec))(KEY)


def _model(jcfg, cfg):
    params = _ref_params(jcfg.replace(dtype=jnp.float32))  # float32 specs: one tree for both dtypes
    return params, tt.LanguageModel.from_state_dict(cfg, params_from_reference(np_tree(params), cfg))


def _fields(cfg, port: bool):
    out = {}
    for name in cfg.__dataclass_fields__:
        v = getattr(cfg, name)
        if name in ("dtype", "logit_dtype"):
            v = str(v).replace("torch.", "") if port else jnp.dtype(v).name
        out[name] = v
    return out


# ---------------------------------------------------------------------------
# config, spec, cache axes
# ---------------------------------------------------------------------------


def test_config_spec_and_cache_axes_match_the_reference():
    for smoke in (False, True):
        jcfg = ref_smoke_config(ARCH) if smoke else ref_get_config(ARCH)
        cfg = get_smoke_config(ARCH) if smoke else get_config(ARCH)
        assert _fields(jcfg, False) == _fields(cfg, True)
    jcfg, cfg = ref_get_config(ARCH), get_config(ARCH)
    jleaves = jax.tree_util.tree_flatten_with_path(jt.lm_spec(jcfg), is_leaf=lambda x: isinstance(x, jparams.ParamSpec))[0]
    tleaves = list(tree_leaves(tt.lm_spec(cfg)))
    assert len(jleaves) == len(tleaves)
    for (jpath, js), (tpath, ts) in zip(jleaves, tleaves):
        assert tuple(getattr(p, "key", getattr(p, "idx", None)) for p in jpath) == tpath
        assert (js.shape, js.axes, js.init, js.scale) == (ts.shape, ts.axes, ts.init, ts.scale)
    n = param_count(tt.lm_spec(cfg))
    assert n == jparams.param_count(jt.lm_spec(jcfg)) and 0.2e9 < n < 0.6e9
    assert sum(p.numel() for p in tt.LanguageModel(cfg).parameters()) == n  # the meta-device model
    # the cache axes, for all ten configs: the port's per-layer list (its
    # caches' structure) is the reference's stacked tree, units' leaves
    # behind a leading "layers" axis; the encoder-decoder's are the literal
    # of the reference's dry run (src/repro/launch/dryrun.py:84-93)
    for name in ("rglru_cache_axes", "mlstm_cache_axes", "slstm_cache_axes"):
        assert getattr(trec, name)(cfg) == getattr(jrec, name)(jcfg), name
    for arch in ARCH_IDS:
        jc, tc = ref_get_config(arch), get_config(arch)
        if tc.is_encdec:
            kv = ("layers", "batch", "seq", "kv_heads", "head_dim")
            want = {"units": tuple({"k": kv, "v": kv, "pos": ("layers", "seq")} for _ in jc.pattern),
                    "cross_kv": tuple((kv, kv) for _ in jc.pattern)}
            got = ted.encdec_cache_axes(tc)
            assert len(got["layers"]) == len(got["cross_kv"]) == tc.num_layers
            for i in range(tc.num_layers):
                s_ = i % len(tc.pattern)
                assert {k: ("layers",) + v for k, v in got["layers"][i].items()} == want["units"][s_], (arch, i)
                assert tuple(("layers",) + a for a in got["cross_kv"][i]) == want["cross_kv"][s_], (arch, i)
            continue
        want, got = jt.cache_axes(jc), tt.cache_axes(tc)
        n_pre = len(tc.prefix)
        assert len(got) == tc.num_layers, arch
        assert tuple(got[:n_pre]) == want["prefix"], arch
        for i in range(n_pre, tc.num_layers):
            s_ = (i - n_pre) % len(tc.pattern)
            assert {k: ("layers",) + v for k, v in got[i].items()} == want["units"][s_], (arch, i)


# ---------------------------------------------------------------------------
# the blocks
# ---------------------------------------------------------------------------


_j_mlstm = jax.jit(jrec.apply_mlstm_block, static_argnums=(1,), static_argnames=("decode", "chunk"))
_j_slstm = jax.jit(jrec.apply_slstm_block, static_argnums=(1,), static_argnames=("decode",))


def _check_block(kind, dtype, S, seed):
    """No cache over ``S`` positions; prefill of ``S`` into a fresh cache;
    three decode steps carrying it: outputs and states."""
    jcfg, cfg = _cfgs(dtype)
    spec, jfn, tfn, jinit, tinit = {
        "mlstm": (jrec.mlstm_spec, _j_mlstm, trec.apply_mlstm_block, jrec.init_mlstm_cache, trec.init_mlstm_cache),
        "slstm": (jrec.slstm_spec, _j_slstm, trec.apply_slstm_block, jrec.init_slstm_cache, trec.init_slstm_cache),
    }[kind]
    p = jparams.init_tree(KEY, spec(jcfg))
    tp = _tree(p)
    B = 2
    x = _x((B, S + 3, cfg.d_model), seed=seed)
    jx, tx = jnp.asarray(x).astype(_JNP[dtype]), torch.from_numpy(x).to(_TORCH[dtype])
    tol = BLOCK_TOL[dtype]
    want, _ = jfn(p, jcfg, jx[:, :S])
    got, _ = tfn(tp, cfg, tx[:, :S])
    assert got.dtype == _TORCH[dtype] and _rel(want, got) <= tol
    jc, tc = jinit(jcfg, B, _JNP[dtype]), tinit(cfg, B, _TORCH[dtype], "cpu")
    want, jc = jfn(p, jcfg, jx[:, :S], cache=jc)
    got, tc = tfn(tp, cfg, tx[:, :S], cache=tc)
    assert _rel(want, got) <= tol
    for step in range(3):
        want, jc = jfn(p, jcfg, jx[:, S + step:S + step + 1], cache=jc, decode=True)
        got, tc = tfn(tp, cfg, tx[:, S + step:S + step + 1], cache=tc, decode=True)
        assert _rel(want, got) <= tol, step
        assert set(jc) == set(tc)
        for name in jc:
            assert _rel(jc[name], tc[name]) <= tol, (step, name)


@pytest.mark.parametrize("S", [12, 512], ids=["below_a_chunk", "two_chunks"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlstm_block_matches_the_reference(dtype, S):
    _check_block("mlstm", dtype, S, seed=S)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_slstm_block_matches_the_reference(dtype):
    _check_block("slstm", dtype, 16, seed=2)


def test_mlstm_block_gradients_over_two_chunks():
    """The gradient through two 256-position chunks, each recomputed in
    the backward (``torch.utils.checkpoint``), against ``jax.grad`` of the
    reference's block: every parameter and the input, float32, 1e-4."""
    jcfg, cfg = _cfgs()
    p = jparams.init_tree(KEY, jrec.mlstm_spec(jcfg))
    x = _x((2, 512, cfg.d_model), seed=9)
    g = _x((2, 512, cfg.d_model), seed=10)
    want = jax.jit(jax.grad(lambda p, x: jnp.sum(jrec.apply_mlstm_block(p, jcfg, x)[0] * g), argnums=(0, 1)))(
        p, jnp.asarray(x))
    tp = tree_map(lambda t: t.requires_grad_(True), _tree(p))
    tx = torch.from_numpy(x).requires_grad_(True)
    (trec.apply_mlstm_block(tp, cfg, tx)[0] * torch.from_numpy(g)).sum().backward()
    rels = leaf_rels(want[0], tree_map(lambda t: t.grad, tp))
    assert max(rels.values()) <= GRAD_TOL, max(rels.items(), key=lambda kv: kv[1])
    assert _rel(want[1], tx.grad) <= GRAD_TOL


def test_mlstm_refuses_a_sequence_its_chunk_does_not_divide():
    jcfg, cfg = _cfgs()
    p = jparams.init_tree(KEY, jrec.mlstm_spec(jcfg))
    x = _x((1, 300, cfg.d_model))
    with pytest.raises(ValueError, match="not divisible by mlstm chunk 256"):
        jrec.apply_mlstm_block(p, jcfg, jnp.asarray(x))
    with pytest.raises(ValueError, match="not divisible by mlstm chunk 256"):
        trec.apply_mlstm_block(_tree(p), cfg, torch.from_numpy(x))


def test_slstm_gate_layout_is_the_references():
    """The recurrent term ``(B, H, 4 hd)`` flattened to ``(B, 4d)`` and
    split into z, i, f, o along the last axis (not per head): a recurrent
    weight that feeds only head 0's first ``hd`` columns moves z alone."""
    _, cfg = _cfgs()
    H, d = cfg.num_heads, cfg.d_model
    hd = d // H
    r = torch.zeros(H, hd, 4 * hd)
    r[0, :, :hd] = 1.0
    c, n, h, m = (torch.zeros(1, d),) * 3 + (torch.zeros(1, d),)
    h = torch.ones(1, d)
    base = trec._slstm_step(torch.zeros_like(r), torch.zeros(4 * d), (c, n, h, m), torch.zeros(1, 4 * d))
    moved = trec._slstm_step(r, torch.zeros(4 * d), (c, n, h, m), torch.zeros(1, 4 * d))
    # z = tanh(g[:, :d]): only its first hd features change; n (from i, f) does not
    assert not torch.equal(base[0][:, :hd], moved[0][:, :hd]) and torch.equal(base[0][:, hd:], moved[0][:, hd:])
    assert torch.equal(base[1], moved[1])


# ---------------------------------------------------------------------------
# the whole model and serving
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_whole_model_logits_match_the_reference(dtype):
    jcfg, cfg = _cfgs(dtype)
    params, model = _model(jcfg, cfg)
    B, S = 4, 64
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (B, S))
    pos = np.arange(S)
    jh, _, _ = jax.jit(lambda p, t, s: jt.apply_lm(p, jcfg, t, s))(params, jnp.asarray(toks), jnp.asarray(pos))
    with torch.inference_mode():
        th, _, taux = tt.apply_lm(model, cfg, torch.from_numpy(toks), torch.from_numpy(pos))
        got = tt.lm_logits(model, cfg, th)
    assert _rel(jt.lm_logits(params, jcfg, jh), got) < LOGITS_TOL[dtype]
    assert float(taux) == 0.0


_j_prefill = jax.jit(jt.prefill, static_argnames=("cfg",))
_j_decode = jax.jit(jt.decode_step, static_argnames=("cfg",))


def test_prefill_and_decode_match_the_reference():
    jcfg, cfg = _cfgs()
    params, model = _model(jcfg, cfg)
    B, S = 2, 20
    toks = np.random.default_rng(6).integers(0, cfg.vocab_size, (B, S))
    jc = jt.init_cache(jcfg, B, S + 4, jcfg.dtype)
    tc = tt.init_cache(cfg, B, S + 4, cfg.dtype, "cpu")
    assert [sorted(c) for c in tc] == [sorted(c) for c in jc["units"]] * cfg.num_units
    jl, jc = _j_prefill(params, cfg=jcfg, tokens=jnp.asarray(toks[:, :-1]), caches=jc)
    with torch.inference_mode():
        tl, tc = tt.prefill(model, cfg, torch.from_numpy(toks[:, :-1]), tc)
        assert _rel(jl, tl) < 1e-4
        for step in range(3):  # the last prompt token, then two more
            tok = toks[:, -1:] if step == 0 else np.array(jnp.argmax(jl, -1))[:, None]
            jl, jc = _j_decode(params, cfg=jcfg, token=jnp.asarray(tok), pos=jnp.array(S - 1 + step), caches=jc)
            tl, tc = tt.decode_step(model, cfg, torch.from_numpy(tok), S - 1 + step, tc)
            assert _rel(jl, tl) < 1e-4, step


def test_prefill_decode_matches_full_forward():
    """The port of the reference's test of the same name (bfloat16, rel 0.05)."""
    cfg = get_smoke_config(ARCH)
    model = tt.init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    B, S = 2, 16
    toks = torch.from_numpy(np.random.default_rng(7).integers(0, cfg.vocab_size, (B, S)))
    with torch.inference_mode():
        hid, _, _ = tt.apply_lm(model, cfg, toks, torch.arange(S))
        full = tt.lm_logits(model, cfg, hid[:, -1])
        caches = tt.init_cache(cfg, B, S, cfg.dtype, "cpu")
        _, caches = tt.prefill(model, cfg, toks[:, :-1], caches)
        got, _ = tt.decode_step(model, cfg, toks[:, -1:], S - 1, caches)
    assert _rel(full.float().numpy(), got) < 0.05


def test_generate_deterministic_greedy():
    """The port of ``tests/test_system.py``'s test of the same name
    (bfloat16, the smoke config's own dtype): two ``generate`` calls give
    the same (2, 8) tokens."""
    cfg = get_smoke_config(ARCH)
    model = tt.init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    eng = ServeEngine(cfg, model, batch=2, seq_budget=24, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 8)))
    out1, out2 = eng.generate(toks, 8), eng.generate(toks, 8)
    assert torch.equal(out1, out2) and tuple(out1.shape) == (2, 8)


def test_serve_engine_tokens_equal_the_reference():
    jcfg, cfg = _cfgs()
    params, model = _model(jcfg, cfg)
    toks = np.random.default_rng(8).integers(0, cfg.vocab_size, (2, 24))
    want = RefServeEngine(jcfg, params, batch=2, seq_budget=32).generate(jnp.asarray(toks), 8)
    got = ServeEngine(cfg, model, batch=2, seq_budget=32, device="cpu").generate(torch.from_numpy(toks), 8)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


def test_serve_cli_serves_xlstm_on_the_host(capsys):
    out = serve_cli.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
                          "--prompt-len", "12", "--new-tokens", "4"])
    assert tuple(out.shape) == (2, 4)
    assert "xlstm-smoke: generated (2, 4)" in capsys.readouterr().out
    assert serve_cli.kernels_for(get_config(ARCH)) == []


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


_ref_loss_and_grad = jax.jit(
    jax.value_and_grad(lambda p, cfg, b: jt.lm_loss(p, cfg, b), has_aux=True), static_argnums=(1,)
)


@pytest.mark.parametrize("kw", [{}, {"remat": "full", "xent_chunk": 8}], ids=["plain", "remat_chunked"])
def test_lm_loss_and_gradients_match_the_reference(kw):
    """With ``remat="full"`` each layer, and inside it each mLSTM chunk,
    runs under ``torch.utils.checkpoint``: the same loss and gradients."""
    jcfg, tcfg = _cfgs(**kw)
    p = np_tree(_ref_params(jcfg.replace(dtype=jnp.float32, **{k: getattr(ref_smoke_config(ARCH), k) for k in kw})))
    b = RefData(jcfg, batch=2, seq=32, seed=1).next()
    (loss, metrics), grads = _ref_loss_and_grad(p, jcfg, {k: jnp.asarray(v) for k, v in b.items()})
    tp = tree_map(lambda t: t.requires_grad_(True), tree_from_reference(p))
    tl, tm = tt.lm_loss(tp, tcfg, {k: torch.as_tensor(v).long() for k, v in b.items()})
    leaves = []
    tree_map(leaves.append, tp)
    it = iter(torch.autograd.grad(tl, leaves))
    tg = tree_map(lambda _: next(it), tp)
    assert _rel(loss, tl) <= LOSS_TOL and _rel(metrics["nll"], tm["nll"]) <= LOSS_TOL
    assert float(tm["tokens"].detach()) == float(metrics["tokens"])
    rels = leaf_rels(grads, tg)
    assert max(rels.values()) <= GRAD_TOL, max(rels.items(), key=lambda kv: kv[1])


def test_train_step_matches_the_reference():
    jcfg, tcfg = _cfgs()
    data = RefData(jcfg, batch=2, seq=16)
    check_train_steps(jcfg, tcfg, [data.next() for _ in range(3)])


def test_train_cli_balances_four_groups_on_the_host(capsys):
    """The train CLI's docstring example, ``--arch xlstm-350m --smoke
    --groups 4``, on the host."""
    train_cli.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--groups", "4", "--steps", "2",
                    "--batch", "2", "--seq", "16", "--units", "8"])
    out = capsys.readouterr().out
    assert "groups=4" in out and "rebalances:" in out
    losses = [float(l.split()[3]) for l in out.splitlines() if l.startswith("step")]
    assert len(losses) == 2 and all(math.isfinite(v) for v in losses)
