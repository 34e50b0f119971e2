"""The port's recurrentgemma model stack held against the reference's.

Weights come from the reference's ``init_tree`` and reach the port through
``nn.convert.params_from_reference``; inputs are made from a seed with
numpy.  On the CPU the port's attention and scan run their plain versions
(``kernels/ref.py``); the reference runs its jnp path, the one its own
model tests run.

Tolerances, relative to the largest magnitude of the reference's output:
modules 1e-5 in float32 (the smoke config); the whole model's logits 1e-4
in float32 and 2e-2 in bfloat16 (the two frameworks round bfloat16
intermediates at different places).
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import get_smoke_config as ref_smoke_config
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import recurrent as jrec
from repro.models import transformer as jt
from repro.nn import params as jparams

from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import recurrent as trec
from repro_torch.models import transformer as tt
from repro_torch.nn import ParamSpec, init_tree, param_count, params_from_reference, tree_leaves

ARCH = "recurrentgemma-2b"
KEY = jax.random.PRNGKey(0)
_JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _cfgs(dtype="float32"):
    return (
        ref_smoke_config(ARCH).replace(dtype=_JNP[dtype]),
        get_smoke_config(ARCH).replace(dtype=_TORCH[dtype]),
    )


def _tree(jtree):
    """A reference parameter (sub)tree as a dict of torch tensors."""
    if isinstance(jtree, dict):
        return {k: _tree(v) for k, v in jtree.items()}
    return torch.from_numpy(np.array(jtree))


def _rel(want, got) -> float:
    want = np.asarray(want, np.float32)
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    return float(np.max(np.abs(want - got)) / (np.max(np.abs(want)) + 1e-30))


def _x(shape, seed=0, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


# the reference's model functions, compiled once per config (eager jax
# dispatches op by op, which dominates these tests' time)
_j_apply_lm = jax.jit(jt.apply_lm, static_argnames=("cfg",))
_j_prefill = jax.jit(jt.prefill, static_argnames=("cfg",))
_j_decode = jax.jit(jt.decode_step, static_argnames=("cfg",))
_j_attn = jax.jit(jattn.apply_attn, static_argnums=(1,), static_argnames=("kind", "decode"))
_j_rglru = jax.jit(jrec.apply_rglru_block, static_argnums=(1,), static_argnames=("decode",))


@functools.lru_cache(maxsize=None)
def _ref_params(jcfg, seed=0):
    spec = jt.lm_spec(jcfg)
    return jax.jit(lambda key: jparams.init_tree(key, spec))(jax.random.PRNGKey(seed))


def _model(jcfg, cfg, seed=0):
    params = _ref_params(jcfg.replace(dtype=jnp.bfloat16), seed)  # float32 specs: one tree for both dtypes
    model = tt.LanguageModel.from_state_dict(
        cfg, params_from_reference(jax.tree_util.tree_map(np.asarray, params), cfg)
    )
    return params, model


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


def _ref_stddev(spec):
    init = spec.initializer()
    return init.__closure__[0].cell_contents if init.__closure__ else None


@pytest.mark.parametrize("full", [False, True], ids=["smoke", "full"])
def test_spec_matches_reference_leaf_for_leaf(full):
    jcfg = ref_get_config(ARCH) if full else ref_smoke_config(ARCH)
    cfg = get_config(ARCH) if full else get_smoke_config(ARCH)
    jleaves = jax.tree_util.tree_flatten_with_path(jt.lm_spec(jcfg), is_leaf=lambda x: isinstance(x, jparams.ParamSpec))[0]
    tleaves = list(tree_leaves(tt.lm_spec(cfg)))
    assert len(jleaves) == len(tleaves)
    for (jpath, js), (tpath, ts) in zip(jleaves, tleaves):
        assert tuple(getattr(p, "key", getattr(p, "idx", None)) for p in jpath) == tpath
        assert (js.shape, js.axes, js.init, js.scale) == (ts.shape, ts.axes, ts.init, ts.scale)
        want = _ref_stddev(js)
        got = ts.stddev()
        assert (want is None) == (got is None)
        if want is not None:
            assert math.isclose(float(want), got, rel_tol=1e-12), tpath
    assert param_count(tt.lm_spec(cfg)) == jparams.param_count(jt.lm_spec(jcfg))
    if full:
        assert param_count(tt.lm_spec(cfg)) == 2_894_574_080


def test_fan_in_rule_skips_stacked_axes():
    # the reference's rule: leading layers/stack/experts axes (keeping two
    # dims) are not fan-in; the fan-in is the product of the rest but last
    assert ParamSpec((4, 64, 32), ("layers", "embed", "mlp")).stddev() == 1 / 8
    assert ParamSpec((4, 64, 10, 16), ("layers", "embed", "heads", "head_dim")).stddev() == 1 / math.sqrt(640)
    assert ParamSpec((4, 64), ("layers", "rnn")).stddev() == 1 / 2
    assert ParamSpec((64,), ("rnn",), init="normal", scale=0.5).stddev() == 0.5
    assert ParamSpec((64,), ("rnn",), init="zeros").stddev() is None


def test_init_tree_materializes_every_leaf():
    cfg = get_smoke_config(ARCH)
    spec = tt.lm_spec(cfg)
    g = torch.Generator().manual_seed(0)
    tree = init_tree(spec, g, device="cpu")
    for (path, leaf), (_, t) in zip(tree_leaves(spec), tree_leaves(tree)):
        assert tuple(t.shape) == leaf.shape and t.dtype == torch.float32, path
        if leaf.init == "ones":
            assert bool((t == 1).all())
        elif leaf.init == "zeros":
            assert bool((t == 0).all())
        elif t.numel() >= 4096:
            assert abs(float(t.std()) / leaf.stddev() - 1) < 0.05, path
    again = init_tree(spec, torch.Generator().manual_seed(0), device="cpu")
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(tree_leaves(tree), tree_leaves(again)))
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="cuda"):
            init_tree(spec, g)


def test_module_names_mirror_reference_tree_keys():
    cfg = get_config(ARCH)  # full width, on the meta device: nothing is allocated
    model = tt.LanguageModel(cfg)
    names = dict(model.named_parameters())
    for name in ("embed.embedding", "prefix.0.rec.wa", "prefix.1.mlp.wo", "layers.4.attn.wq",
                 "layers.25.attn.wo", "layers.2.rec.lam", "final_norm.scale"):
        assert name in names, name
    kinds = cfg.layer_kinds()
    assert kinds.count("rec") == 18 and kinds.count("local") == 8
    assert all(f"layers.{i}.attn.wq" in names for i, k in enumerate(kinds) if k == "local")
    assert sum(p.numel() for p in names.values()) == 2_894_574_080
    assert all(p.device.type == "meta" for p in names.values())


def test_params_from_reference_unstacks_units():
    jcfg, cfg = _cfgs()
    params, model = _model(jcfg, cfg)
    n_pre, n_slots = len(cfg.prefix), len(cfg.pattern)
    for u in range(cfg.num_units):
        for s in range(n_slots):
            block = model.block(n_pre + u * n_slots + s)
            want = np.asarray(params["units"][s]["norm1"]["scale"][u])
            np.testing.assert_array_equal(block.norm1.scale.numpy(), want)
    np.testing.assert_array_equal(model.prefix[1].rec.wa.numpy(), np.asarray(params["prefix"][1]["rec"]["wa"]))


def test_registry_refuses_unported_archs():
    """Every architecture the reference assigns is ported: the registry
    serves all ten, full and smoke, each under its own name; an unknown
    name is still refused."""
    assert ARCH_IDS[7] == ARCH and len(ARCH_IDS) == 10
    for arch in ARCH_IDS:
        assert get_config(arch).name == ref_get_config(arch).name
        assert get_smoke_config(arch).name == ref_smoke_config(arch).name
    with pytest.raises(KeyError):
        get_config("no-such-arch")


@pytest.mark.parametrize(
    "field,value",
    [("frontend", "vision_stub"), ("encoder_layers", 2), ("num_prefix_embeddings", 4)],
)
def test_config_refuses_fields_the_port_does_not_read(field, value):
    """No field is refused any more: the frontend and encoder-decoder
    fields are read, and so is the dry run's ``unroll_scans``, which
    chooses nothing in the port (its loops are eager Python): the logits
    are the same bit for bit either way, and the reference's within 1e-4."""
    cfg = get_smoke_config(ARCH).replace(**{field: value})
    assert getattr(cfg, field) == value
    assert cfg.replace(unroll_scans=True).unroll_scans
    jcfg, cfg = _cfgs()
    params, model = _model(jcfg, cfg)
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 12))
    pos = torch.arange(12)
    logits = {}
    for unroll in (False, True):
        c = cfg.replace(unroll_scans=unroll)
        h, _, _ = tt.apply_lm(model, c, torch.from_numpy(toks), pos)
        logits[unroll] = tt.lm_logits(model, c, h)
    assert torch.equal(logits[False], logits[True])
    jc = jcfg.replace(unroll_scans=True)
    jh, _, _ = _j_apply_lm(params, cfg=jc, tokens=jnp.asarray(toks), positions=jnp.asarray(np.arange(12)))
    assert _rel(jt.lm_logits(params, jc, jh), logits[True]) < 1e-4


@pytest.mark.parametrize("field,value", [("zloss", 1e-4), ("xent_chunk", 0), ("remat", "none")])
def test_config_accepts_the_training_fields(field, value):
    """The training path reads ``zloss``, ``xent_chunk`` and ``remat``
    (``models.transformer.lm_loss``, ``apply_lm``): a config takes them."""
    cfg = get_smoke_config(ARCH).replace(**{field: value})
    assert getattr(cfg, field) == value


# ---------------------------------------------------------------------------
# modules (float32, smoke widths, 1e-5)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_apply_norm(kind):
    spec = jlayers.norm_spec(64, kind)
    p = jparams.init_tree(KEY, spec)
    p = {k: v + 0.1 * jax.random.normal(jax.random.PRNGKey(3), v.shape) for k, v in p.items()}
    x = _x((2, 5, 64))
    want = jax.jit(jlayers.apply_norm)(p, jnp.asarray(x))
    assert _rel(want, tlayers.apply_norm(_tree(p), torch.from_numpy(x))) < 1e-5


@pytest.mark.parametrize("kind", ["geglu", "swiglu", "gelu"])
def test_apply_mlp(kind):
    p = jparams.init_tree(KEY, jlayers.mlp_spec(64, 128, kind))
    x = _x((2, 5, 64))
    want = jax.jit(jlayers.apply_mlp, static_argnums=2)(p, jnp.asarray(x), kind)
    assert _rel(want, tlayers.apply_mlp(_tree(p), torch.from_numpy(x), kind)) < 1e-5


@pytest.mark.parametrize("fraction", [1.0, 0.5])
def test_rope(fraction):
    x = _x((2, 7, 4, 16))
    pos = np.arange(3, 10)
    want = jax.jit(jlayers.rope, static_argnames=("theta", "fraction"))(jnp.asarray(x), jnp.asarray(pos), theta=10000.0, fraction=fraction)
    got = tlayers.rope(torch.from_numpy(x), torch.from_numpy(pos), theta=10000.0, fraction=fraction)
    assert _rel(want, got) < 1e-5


def test_softcap_and_stacked():
    x = _x((3, 4), scale=50.0)
    assert _rel(jlayers.softcap(jnp.asarray(x), 30.0), tlayers.softcap(torch.from_numpy(x), 30.0)) < 1e-6
    st = tlayers.stacked({"w": ParamSpec((4, 8), ("embed", "mlp"))}, 3)["w"]
    assert st.shape == (3, 4, 8) and st.axes == ("layers", "embed", "mlp")


@pytest.mark.parametrize("Sq,Sk,window,offset", [(8, 8, 0, 0), (6, 16, 5, 10), (12, 12, 8, 0)])
def test_causal_mask(Sq, Sk, window, offset):
    want = np.asarray(jattn._causal_mask(Sq, Sk, window, q_offset=offset))
    np.testing.assert_array_equal(tattn._causal_mask(Sq, Sk, window, q_offset=offset).numpy(), want)


@pytest.mark.parametrize("S", [8, 12], ids=["fills", "wraps"])
@pytest.mark.parametrize("kind", ["local", "attn"])
def test_apply_attn_three_modes(kind, S):
    jcfg, cfg = _cfgs()
    p = jparams.init_tree(KEY, jattn.attn_spec(jcfg))
    tp = _tree(p)
    B, budget = 2, 16
    x = _x((B, S + 1, cfg.d_model), seed=1)
    pos = np.arange(S + 1)
    # train: no cache, full-sequence attention
    want, _ = _j_attn(p, jcfg, jnp.asarray(x), jnp.asarray(pos), kind=kind)
    got, _ = tattn.apply_attn(tp, cfg, torch.from_numpy(x), torch.from_numpy(pos), kind=kind)
    assert _rel(want, got) < 1e-5
    # prefill of S tokens into the cache
    jc = jattn.init_attn_cache(jcfg, kind, B, budget, jnp.float32)
    tc = tattn.init_attn_cache(cfg, kind, B, budget, torch.float32, "cpu")
    want, jc = _j_attn(p, jcfg, jnp.asarray(x[:, :S]), jnp.asarray(pos[:S]), kind=kind, cache=jc)
    got, tc = tattn.apply_attn(tp, cfg, torch.from_numpy(x[:, :S]), torch.from_numpy(pos[:S]), kind=kind, cache=tc)
    assert _rel(want, got) < 1e-5
    for name in ("k", "v", "pos"):
        assert _rel(jc[name], tc[name]) < 1e-5, name
    # decode of token S over the cache
    want, jc = _j_attn(p, jcfg, jnp.asarray(x[:, S:]), jnp.asarray(pos[S:]), kind=kind, cache=jc, decode=True)
    got, tc = tattn.apply_attn(tp, cfg, torch.from_numpy(x[:, S:]), torch.from_numpy(pos[S:]), kind=kind, cache=tc, decode=True)
    assert _rel(want, got) < 1e-5
    for name in ("k", "v", "pos"):
        assert _rel(jc[name], tc[name]) < 1e-5, name


@pytest.mark.parametrize("with_cache", [False, True])
def test_apply_rglru_block(with_cache):
    jcfg, cfg = _cfgs()
    p = jparams.init_tree(KEY, jrec.rglru_spec(jcfg))
    tp = _tree(p)
    x = _x((2, 9, cfg.d_model), seed=2)
    if not with_cache:
        want, _ = _j_rglru(p, jcfg, jnp.asarray(x))
        got, _ = trec.apply_rglru_block(tp, cfg, torch.from_numpy(x))
        assert _rel(want, got) < 1e-5
        return
    # a cache with a state and a conv history, as after an earlier prompt
    h = _x((2, cfg.d_rnn), seed=3)
    conv = _x((2, cfg.conv_width - 1, cfg.d_rnn), seed=4)
    jc = {"h": jnp.asarray(h), "conv": jnp.asarray(conv)}
    tc = {"h": torch.from_numpy(h), "conv": torch.from_numpy(conv)}
    want, jc = _j_rglru(p, jcfg, jnp.asarray(x[:, :8]), cache=jc)
    got, tc = trec.apply_rglru_block(tp, cfg, torch.from_numpy(x[:, :8]), cache=tc)
    assert _rel(want, got) < 1e-5
    assert _rel(jc["h"], tc["h"]) < 1e-5 and _rel(jc["conv"], tc["conv"]) < 1e-5
    want, jc = _j_rglru(p, jcfg, jnp.asarray(x[:, 8:]), cache=jc, decode=True)
    got, tc = trec.apply_rglru_block(tp, cfg, torch.from_numpy(x[:, 8:]), cache=tc, decode=True)
    assert _rel(want, got) < 1e-5
    assert _rel(jc["h"], tc["h"]) < 1e-5 and _rel(jc["conv"], tc["conv"]) < 1e-5


# ---------------------------------------------------------------------------
# the whole model (smoke config: 5 layers, window 8)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 2e-2)])
def test_whole_model_logits_match_reference(dtype, tol):
    jcfg, cfg = _cfgs(dtype)
    params, model = _model(jcfg, cfg)
    B, S = 2, 20  # beyond the window of 8
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (B, S))
    pos = np.arange(S)
    jh, _, _ = _j_apply_lm(params, cfg=jcfg, tokens=jnp.asarray(toks), positions=jnp.asarray(pos))
    th, _, _ = tt.apply_lm(model, cfg, torch.from_numpy(toks), torch.from_numpy(pos))
    assert _rel(jt.lm_logits(params, jcfg, jh), tt.lm_logits(model, cfg, th)) < tol
    jc = jt.init_cache(jcfg, B, S + 4, jcfg.dtype)
    tc = tt.init_cache(cfg, B, S + 4, cfg.dtype, "cpu")
    jl, jc = _j_prefill(params, cfg=jcfg, tokens=jnp.asarray(toks[:, :-1]), caches=jc)
    tl, tc = tt.prefill(model, cfg, torch.from_numpy(toks[:, :-1]), tc)
    assert _rel(jl, tl) < tol
    for step in range(3):  # the last prompt token, then two more
        tok = toks[:, -1:] if step == 0 else np.array(jnp.argmax(jl, -1))[:, None]
        jl, jc = _j_decode(params, cfg=jcfg, token=jnp.asarray(tok), pos=jnp.array(S - 1 + step), caches=jc)
        tl, tc = tt.decode_step(model, cfg, torch.from_numpy(tok), S - 1 + step, tc)
        assert _rel(jl, tl) < tol, step


def test_sliding_window_ring_buffer():
    """The port's twin of the reference's test: decode past the window with
    a window-sized cache reproduces the full forward (recurrentgemma's only
    attention is local, so a window-sized budget is lossless); and the
    decoded logits agree with the reference's."""
    jcfg, cfg = ref_smoke_config(ARCH), get_smoke_config(ARCH)  # bfloat16, as the reference's test
    params, model = _model(jcfg, cfg)
    W = cfg.window
    total = W + 6
    toks = np.asarray(jax.random.randint(KEY, (1, total), 0, cfg.vocab_size))
    pos = torch.arange(total)
    hid, _, _ = tt.apply_lm(model, cfg, torch.from_numpy(toks), pos)
    want = tt.lm_logits(model, cfg, hid[:, -1])
    caches = tt.init_cache(cfg, 1, W, cfg.dtype, "cpu")
    _, caches = tt.prefill(model, cfg, torch.from_numpy(toks[:, :W]), caches)
    jc = jt.init_cache(jcfg, 1, W)
    _, jc = _j_prefill(params, cfg=jcfg, tokens=jnp.asarray(toks[:, :W]), caches=jc)
    for i in range(W, total):
        got, caches = tt.decode_step(model, cfg, torch.from_numpy(toks[:, i : i + 1]), i, caches)
        jgot, jc = _j_decode(params, cfg=jcfg, token=jnp.asarray(toks[:, i : i + 1]), pos=jnp.array(i), caches=jc)
    assert _rel(want.float().numpy(), got) < 0.05
    assert _rel(jgot, got) < 2e-2
    assert all(c["k"].shape[1] == W for c, k in zip(caches, cfg.layer_kinds()) if k == "local")
