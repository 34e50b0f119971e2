"""The port's encoder-decoder (seamless-m4t-medium) and vision prefix
(pixtral-12b) held against the reference's.

Weights come from the reference's ``init_tree`` and reach the port through
``nn.convert.params_from_reference`` (the training tests: in the
reference's stacked layout, ``nn.tree_from_reference``); frames, prefix
embeddings and tokens are made from a seed with numpy and given to both
packages (the stub frontends' own values come from each framework's
generator and differ).  On the CPU the port's attention (the encoder's,
the decoder's and cross-attention) runs its plain version.

Tolerances, relative to the largest magnitude of the reference's value,
as ``test_torch_decoders.py`` and ``test_torch_train.py`` hold the
decoders: modules (cross-attention) 1e-5 in float32; ``encode``, the
cross K/V and ``apply_decoder``'s logits 1e-4 in float32 and 2e-2 in
bfloat16; prefill + decode against the reference 1e-4 (float32) and
against the port's own full decoder rel 0.05 (bfloat16, the reference's
test); losses 1e-5 and every gradient leaf 1e-4 (float32); the train step
as ``_train_parity`` holds it; greedy tokens, checkpoints and parameter
trees exactly.
"""

import functools
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _train_parity import check_train_steps, leaf_rels, np_tree

import repro.models.encdec as jed
import repro.models.transformer as jt
from repro.checkpoint import load_checkpoint as ref_load_checkpoint
from repro.checkpoint import save_checkpoint as ref_save_checkpoint
from repro.configs import get_config as ref_get_config
from repro.configs import get_smoke_config as ref_smoke_config
from repro.data import SyntheticLMData as RefData
from repro.models import attention as jattn
from repro.nn import params as jparams
from repro.optim import warmup_cosine as ref_warmup_cosine
from repro.runtime import train_loop as jtrain

import repro_torch.models.encdec as ted
import repro_torch.models.transformer as tt
from repro_torch.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data import SyntheticLMData
from repro_torch.models import attention as tattn
from repro_torch.models.frontends import stub_frame_embeddings, stub_patch_embeddings
from repro_torch.nn import (
    axes_tree,
    param_count,
    params_from_reference,
    spec_tree_shapes,
    stack_tree,
    tree_from_reference,
    tree_leaves,
    tree_map,
)
from repro_torch.optim import warmup_cosine
from repro_torch.runtime import TrainState, init_train_state, make_train_step
from repro_torch.runtime.train_loop import model_spec_for

SEAMLESS, PIXTRAL = "seamless-m4t-medium", "pixtral-12b"
KEY = jax.random.PRNGKey(0)
_JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
LOSS_TOL, GRAD_TOL = 1e-5, 1e-4
B, S_ENC, S_DEC = 2, 10, 12  # S_ENC != S_DEC: cross-attention is not square


def _cfgs(arch, dtype="float32", **kw):
    return (ref_smoke_config(arch).replace(dtype=_JNP[dtype], **kw),
            get_smoke_config(arch).replace(dtype=_TORCH[dtype], **kw))


def _rel(want, got) -> float:
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    return float(np.max(np.abs(want - got)) / (np.max(np.abs(want)) + 1e-30))


def _x(shape, seed=0, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _toks(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape)


@functools.lru_cache(maxsize=None)
def _ref_params(jcfg):
    spec = jt.lm_spec(jcfg) if not jcfg.is_encdec else jed.encdec_spec(jcfg)
    return jax.jit(lambda key: jparams.init_tree(key, spec))(KEY)


def _model(jcfg, cfg):
    params = _ref_params(jcfg.replace(dtype=jnp.float32))  # float32 specs: one tree for both dtypes
    state = params_from_reference(np_tree(params), cfg)
    cls = ted.EncoderDecoder if cfg.is_encdec else tt.LanguageModel
    return params, cls.from_state_dict(cfg, state)


def _fields(cfg, port: bool):
    out = {}
    for name in cfg.__dataclass_fields__:
        v = getattr(cfg, name)
        if name in ("dtype", "logit_dtype"):
            v = str(v).replace("torch.", "") if port else jnp.dtype(v).name
        out[name] = v
    return out


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _spec_leaves(spec):
    return jax.tree_util.tree_flatten_with_path(spec, is_leaf=lambda x: isinstance(x, jparams.ParamSpec))[0]


# ---------------------------------------------------------------------------
# configs, specs, parameter trees
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", [SEAMLESS, PIXTRAL])
def test_config_spec_and_axes_match_the_reference(arch):
    """Configs field for field; the full config's spec tree leaf for leaf
    (paths, shapes, axes, initialisers), its axes tree and shapes tree,
    and the parameter count."""
    for smoke in (False, True):
        jcfg = ref_smoke_config(arch) if smoke else ref_get_config(arch)
        cfg = get_smoke_config(arch) if smoke else get_config(arch)
        assert _fields(jcfg, False) == _fields(cfg, True)
    jcfg, cfg = ref_get_config(arch), get_config(arch)
    jspec = jed.encdec_spec(jcfg) if jcfg.is_encdec else jt.lm_spec(jcfg)
    spec = model_spec_for(cfg)
    jleaves, tleaves = _spec_leaves(jspec), list(tree_leaves(spec))
    assert len(jleaves) == len(tleaves)
    for (jpath, js), (tpath, ts) in zip(jleaves, tleaves):
        assert tuple(getattr(p, "key", getattr(p, "idx", None)) for p in jpath) == tpath
        assert (js.shape, js.axes, js.init, js.scale) == (ts.shape, ts.axes, ts.init, ts.scale)
    axes, jaxes, shapes = axes_tree(spec), jparams.axes_tree(jspec), spec_tree_shapes(spec)
    for path, leaf in tree_leaves(spec):
        assert _at(axes, path) == _at(jaxes, path) == leaf.axes
        assert _at(shapes, path).device.type == "meta" and tuple(_at(shapes, path).shape) == leaf.shape
    n = param_count(spec)
    assert n == jparams.param_count(jspec)
    model = (ted.EncoderDecoder if cfg.is_encdec else tt.LanguageModel)(cfg)  # on the meta device
    assert sum(p.numel() for p in model.parameters()) == n


def test_stub_frontends_keep_the_references_shapes():
    _, cfg = _cfgs(PIXTRAL)
    p = stub_patch_embeddings(cfg, 3, seed=1, device="cpu")
    assert tuple(p.shape) == (3, cfg.num_prefix_embeddings, cfg.d_model) and p.dtype == cfg.dtype
    assert torch.equal(p, stub_patch_embeddings(cfg, 3, seed=1, device="cpu"))
    assert abs(float(p.float().std()) - 0.02) < 0.004
    _, cfg = _cfgs(SEAMLESS, "bfloat16")
    f = stub_frame_embeddings(cfg, 2, 7, device="cpu")
    assert tuple(f.shape) == (2, 7, cfg.d_model) and f.dtype == torch.bfloat16


def test_params_from_reference_and_stack_tree_carry_the_encdec_tree():
    """``encoder.units`` / ``decoder.units`` unstack into per-layer modules
    and stack back, bit for bit."""
    jcfg, cfg = _cfgs(SEAMLESS)
    params, model = _model(jcfg, cfg)
    names = set(model.state_dict())
    assert "encoder.layers.1.attn.wq" in names and "decoder.layers.1.xattn.wk" in names
    assert "decoder.embed.embedding" in names and "encoder.final_norm.bias" in names
    np.testing.assert_array_equal(model.decoder.layers["1"].xattn.wk.numpy(),
                                  np.asarray(params["decoder"]["units"][0]["xattn"]["wk"][1]))
    back = stack_tree(model.state_dict(), cfg)
    for (pa, a), (pb, b) in zip(tree_leaves(np_tree(params)), tree_leaves(back)):
        assert pa == pb and np.array_equal(a, b)


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------


_j_attn = jax.jit(jattn.apply_attn, static_argnums=(1,), static_argnames=("kind", "causal", "decode"))


@pytest.mark.parametrize("Sq,Sk", [(5, 13), (13, 5), (1, 9)], ids=["fewer_queries", "more_queries", "decode"])
def test_cross_attention_matches_the_reference(Sq, Sk):
    """Non-causal, no rope on the query, any ``Sq`` against ``Sk``; one
    query (decode) is plain torch."""
    jcfg, cfg = _cfgs(SEAMLESS)
    p = jparams.init_tree(KEY, jattn.attn_spec(jcfg, cross=True))
    tp = tree_map(lambda a: torch.from_numpy(np.array(a)), np_tree(p))
    x = _x((B, Sq, cfg.d_model), seed=1)
    k, v = _x((B, Sk, cfg.num_kv_heads, cfg.head_dim), seed=2), _x((B, Sk, cfg.num_kv_heads, cfg.head_dim), seed=3)
    pos = np.arange(100, 100 + Sq)  # rope would move the query: there is none
    want, _ = _j_attn(p, jcfg, jnp.asarray(x), jnp.asarray(pos), kind="attn", causal=False,
                      cross_kv=(jnp.asarray(k), jnp.asarray(v)))
    got, _ = tattn.apply_attn(tp, cfg, torch.from_numpy(x), torch.from_numpy(pos), kind="attn", causal=False,
                              decode=Sq == 1, cross_kv=(torch.from_numpy(k), torch.from_numpy(v)))
    assert _rel(want, got) < 1e-5


_j_encode = jax.jit(jed.encode, static_argnums=(1,))
_j_xkv = jax.jit(jed._cross_kv_all, static_argnums=(1,))
_j_decoder = jax.jit(jed.apply_decoder, static_argnums=(1,), static_argnames=("decode",))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_cross_kv_and_decoder_match_the_reference(dtype):
    jcfg, cfg = _cfgs(SEAMLESS, dtype)
    params, model = _model(jcfg, cfg)
    frames = _x((B, S_ENC, cfg.d_model), seed=4, scale=0.02)
    toks = _toks(cfg, (B, S_DEC), 5)
    tol = TOL[dtype]
    jenc = _j_encode(params, jcfg, jnp.asarray(frames))
    with torch.inference_mode():
        tenc = ted.encode(model, cfg, torch.from_numpy(frames))
        assert tenc.dtype == _TORCH[dtype] and _rel(jenc, tenc) < tol
        jxkv = _j_xkv(params, jcfg, jenc)
        txkv = ted._cross_kv_all(model, cfg, tenc)
        n_slots = len(cfg.pattern)
        for i, (k, v) in enumerate(txkv):
            u, s = divmod(i, n_slots)
            assert _rel(jxkv[s][0][u], k) < tol and _rel(jxkv[s][1][u], v) < tol, i
        pos = np.arange(S_DEC)
        jh, _ = _j_decoder(params, jcfg, jnp.asarray(toks), jnp.asarray(pos), jxkv)
        th, _ = ted.apply_decoder(model, cfg, torch.from_numpy(toks), torch.from_numpy(pos), txkv)
        assert _rel(jed._dec_logits(params, jcfg, jh), ted._dec_logits(model, cfg, th)) < tol


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


_j_prefill = jax.jit(jed.encdec_prefill, static_argnums=(1,))
_j_decode = jax.jit(jed.encdec_decode_step, static_argnums=(1,))


def test_prefill_and_decode_match_the_reference():
    """Prefill (the caches' self-attention entries and cross K/V too) and
    three decode steps, then a greedy loop's tokens equal the
    reference's."""
    jcfg, cfg = _cfgs(SEAMLESS)
    params, model = _model(jcfg, cfg)
    frames = _x((B, S_ENC, cfg.d_model), seed=6, scale=0.02)
    toks = _toks(cfg, (B, S_DEC), 7)
    budget = S_DEC + 4
    jc = jed.init_encdec_cache(jcfg, B, budget, S_ENC, jcfg.dtype)
    tc = ted.init_encdec_cache(cfg, B, budget, S_ENC, cfg.dtype, "cpu")
    jl, jc = _j_prefill(params, jcfg, jnp.asarray(frames), jnp.asarray(toks[:, :-1]), jc)
    with torch.inference_mode():
        tl, tc = ted.encdec_prefill(model, cfg, torch.from_numpy(frames), torch.from_numpy(toks[:, :-1]), tc)
        assert _rel(jl, tl) < 1e-4
        for i, c in enumerate(tc["layers"]):
            for name in ("k", "v", "pos"):
                assert _rel(jc["units"][0][name][i], c[name]) < 1e-4, (i, name)
        got = []
        want = []
        jtok, ttok = toks[:, -1:], toks[:, -1:]
        for step in range(4):
            jl, jc = _j_decode(params, jcfg, jnp.asarray(jtok), jnp.array(S_DEC - 1 + step), jc)
            tl, tc = ted.encdec_decode_step(model, cfg, torch.from_numpy(ttok), S_DEC - 1 + step, tc)
            assert _rel(jl, tl) < 1e-4, step
            jtok, ttok = np.array(jnp.argmax(jl, -1))[:, None], torch.argmax(tl, -1)[:, None].numpy()
            want.append(jtok)
            got.append(ttok)
    np.testing.assert_array_equal(np.concatenate(want, 1), np.concatenate(got, 1))


def test_prefill_decode_matches_full_decoder():
    """The port of the reference's ``test_prefill_decode_matches_full_forward``
    for the encoder-decoder (bfloat16, rel 0.05)."""
    cfg = get_smoke_config(SEAMLESS)
    model = ted.init_encdec(cfg, torch.Generator().manual_seed(0), device="cpu")
    S = 16
    toks = torch.from_numpy(_toks(cfg, (B, S), 8))
    frames = stub_frame_embeddings(cfg, B, 8, device="cpu")
    with torch.inference_mode():
        xkv = ted._cross_kv_all(model, cfg, ted.encode(model, cfg, frames))
        hid, _ = ted.apply_decoder(model, cfg, toks, torch.arange(S), xkv)
        full = ted._dec_logits(model, cfg, hid[:, -1])
        caches = ted.init_encdec_cache(cfg, B, S, 8, cfg.dtype, "cpu")
        _, caches = ted.encdec_prefill(model, cfg, frames, toks[:, :-1], caches)
        got, _ = ted.encdec_decode_step(model, cfg, toks[:, -1:], S - 1, caches)
    assert _rel(full.float().numpy(), got) < 0.05


_jt_prefill = jax.jit(jt.prefill, static_argnames=("cfg",))
_jt_decode = jax.jit(jt.decode_step, static_argnames=("cfg",))


def test_prefix_embeds_prefill_and_decode_positions_match_the_reference():
    """pixtral: prefill of ``P`` prefix embeddings and the text into a
    budget of ``P + S_text + new``; decode positions continue after the
    prefix."""
    jcfg, cfg = _cfgs(PIXTRAL)
    params, model = _model(jcfg, cfg)
    P, S = cfg.num_prefix_embeddings, 12
    pe = _x((B, P, cfg.d_model), seed=9, scale=0.02)
    toks = _toks(cfg, (B, S), 10)
    jc = jt.init_cache(jcfg, B, P + S + 3, jcfg.dtype)
    tc = tt.init_cache(cfg, B, P + S + 3, cfg.dtype, "cpu")
    jl, jc = _jt_prefill(params, cfg=jcfg, tokens=jnp.asarray(toks), caches=jc, prefix_embeds=jnp.asarray(pe))
    with torch.inference_mode():
        tl, tc = tt.prefill(model, cfg, torch.from_numpy(toks), tc, prefix_embeds=torch.from_numpy(pe))
        assert _rel(jl, tl) < 1e-4
        assert tc[0]["pos"][:P + S].tolist() == list(range(P + S))
        for step in range(3):
            tok = np.array(jnp.argmax(jl, -1))[:, None]
            jl, jc = _jt_decode(params, cfg=jcfg, token=jnp.asarray(tok), pos=jnp.array(P + S + step), caches=jc)
            tl, tc = tt.decode_step(model, cfg, torch.from_numpy(tok), P + S + step, tc)
            assert _rel(jl, tl) < 1e-4, step
        # a prefix changes what follows it
        bare, _ = tt.prefill(model, cfg, torch.from_numpy(toks), tt.init_cache(cfg, B, S, cfg.dtype, "cpu"))
    assert _rel(jl, bare) > 1e-3


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


_ref_encdec_grad = jax.jit(jax.value_and_grad(lambda p, cfg, b: jed.encdec_loss(p, cfg, b), has_aux=True),
                           static_argnums=(1,))
_ref_lm_grad = jax.jit(jax.value_and_grad(lambda p, cfg, b: jt.lm_loss(p, cfg, b), has_aux=True),
                       static_argnums=(1,))


def _loss_case(arch, **kw):
    jcfg, tcfg = _cfgs(arch, **kw)
    p = np_tree(_ref_params(_cfgs(arch)[0]))
    b = RefData(jcfg, batch=2, seq=16, seed=1).next()
    fn = _ref_encdec_grad if jcfg.is_encdec else _ref_lm_grad
    (loss, metrics), grads = fn(p, jcfg, {k: jnp.asarray(v) for k, v in b.items()})
    tp = tree_map(lambda t: t.requires_grad_(True), tree_from_reference(p))
    tb = {k: torch.as_tensor(v) if np.issubdtype(v.dtype, np.floating) else torch.as_tensor(v).long()
          for k, v in b.items()}
    loss_fn = ted.encdec_loss if tcfg.is_encdec else tt.lm_loss
    tl, tm = loss_fn(tp, tcfg, tb)
    leaves = []
    tree_map(leaves.append, tp)
    it = iter(torch.autograd.grad(tl, leaves))
    return (loss, metrics, grads), (tl, tm, tree_map(lambda _: next(it), tp))


@pytest.mark.parametrize("kw", [{}, {"remat": "full", "xent_chunk": 8}], ids=["plain", "remat_chunked"])
@pytest.mark.parametrize("arch", [SEAMLESS, PIXTRAL])
def test_loss_and_gradients_match_the_reference(arch, kw):
    """``encdec_loss`` (frames of 16) and, for pixtral, ``lm_loss`` with
    ``prefix_embeds`` (the loss over the text only): loss, metrics and
    every gradient leaf."""
    (loss, metrics, grads), (tl, tm, tg) = _loss_case(arch, **kw)
    assert _rel(loss, tl) <= LOSS_TOL and _rel(metrics["nll"], tm["nll"]) <= LOSS_TOL
    assert float(tm["tokens"].detach()) == float(metrics["tokens"]) == 2 * 15
    rels = leaf_rels(grads, tg)
    assert max(rels.values()) <= GRAD_TOL, max(rels.items(), key=lambda kv: kv[1])


@pytest.mark.parametrize("arch", [SEAMLESS, PIXTRAL])
def test_train_step_matches_the_reference(arch):
    jcfg, tcfg = _cfgs(arch)
    data = RefData(jcfg, batch=2, seq=16)
    check_train_steps(jcfg, tcfg, [data.next() for _ in range(3)])


def test_checkpoints_cross_the_two_packages_bit_for_bit():
    """The encoder-decoder's training state: the reference's save restored
    by the port, a port step saved and restored by the reference."""
    jcfg, tcfg = _cfgs(SEAMLESS)
    state = jtrain.init_train_state(jcfg, KEY)
    step = jax.jit(jtrain.make_train_step(jcfg, ref_warmup_cosine(3e-3, 1, 3)))
    b = RefData(jcfg, batch=2, seq=16).next()
    ref_state, _ = step(state, {k: jnp.asarray(v) for k, v in b.items()})
    with tempfile.TemporaryDirectory() as d:
        ref_save_checkpoint(d, 1, {"train": ref_state})
        got, _ = load_checkpoint(d, {"train": init_train_state(tcfg, 0, device="cpu")})
        port = got["train"]
        assert isinstance(port, TrainState) and int(port.step) == 1
        for want, have in ((ref_state.params, port.params), (ref_state.opt.mu, port.opt.mu)):
            w, h = dict(tree_leaves(np_tree(want))), dict(tree_leaves(have))
            assert set(w) == set(h) and all(np.array_equal(w[p], h[p].detach().numpy()) for p in w)
        port, _ = make_train_step(tcfg, warmup_cosine(3e-3, 1, 3), inplace=True)(
            port, SyntheticLMData(tcfg, batch=2, seq=16).batch_at(1))
        save_checkpoint(d, 2, {"train": port})
        ref_like = jax.tree_util.tree_map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), {"train": ref_state})
        back, man = ref_load_checkpoint(d, ref_like)
        assert man["step"] == 2
        w, h = dict(tree_leaves(np_tree(back["train"]))), dict(tree_leaves(port))
        assert set(w) == set(h) and all(np.array_equal(w[p], h[p].detach().numpy()) for p in w)
