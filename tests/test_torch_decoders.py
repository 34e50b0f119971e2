"""The port's dense, MoE and MLA decoders held against the reference's.

Architectures: gemma2-2b, gemma2-27b, granite-20b, stablelm-12b (dense),
granite-moe-1b-a400m (MoE) and deepseek-v2-236b (MLA, a dense prefix
layer, MoE with shared experts), at the reference's smoke widths.  Weights
come from the reference's ``init_tree`` and reach the port through
``nn.convert.params_from_reference``; inputs are made from a seed with
numpy.  On the CPU the port's attention runs its plain version
(``kernels/ref.py``); the reference runs its jnp path.

Tolerances, relative to the largest magnitude of the reference's output:
modules 1e-5 in float32; whole-model logits 1e-4 in float32 and 2e-2 in
bfloat16.  In bfloat16 an MoE router may flip a near tie between two
experts (the frameworks round the router's bfloat16 product differently).
So the MoE cases first require that at least 99 % of the (token, choice)
pairs of every MoE layer pick the same expert as the reference, and then
compare logits on the tokens whose choices all agree.  A flip at token t
changes which later pairs of its sequence fill the two experts' capacity,
and reaches every later token of its sequence through attention, so the
logits are compared on the tokens before the first flip of their
sequence.

Past the budget: a global (``attn``) layer's cache of ``seq_budget`` slots
wraps silently in the reference (its oldest positions are overwritten);
the port mirrors that rather than refusing, so that it gives the
reference's tokens (``test_generate_past_the_budget_wraps_global_layers``).
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import repro.models.transformer as jt
from repro.configs import get_config as ref_get_config
from repro.configs import get_smoke_config as ref_smoke_config
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import moe as jmoe
from repro.nn import params as jparams
from repro.runtime.serve_loop import ServeEngine as RefServeEngine

import repro_torch.models.transformer as tt
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch import serve as serve_cli
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import moe as tmoe
from repro_torch.nn import param_count, params_from_reference, tree_leaves
from repro_torch.runtime import ServeEngine

DENSE = ["gemma2-2b", "gemma2-27b", "granite-20b", "stablelm-12b"]
MOE = ["granite-moe-1b-a400m", "deepseek-v2-236b"]
ARCHS = DENSE + MOE
KEY = jax.random.PRNGKey(0)
_JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# fields the port's configs leave out: none since the training path reads
# xent_chunk, remat and train_accum (the configs match field for field)
TRAINING_FIELDS = ()
ROUTING_AGREEMENT = 0.99


def _cfgs(arch, dtype="float32", **kw):
    return (
        ref_smoke_config(arch).replace(dtype=_JNP[dtype], **kw),
        get_smoke_config(arch).replace(dtype=_TORCH[dtype], **kw),
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


_j_apply_lm = jax.jit(jt.apply_lm, static_argnames=("cfg",))
_j_prefill = jax.jit(jt.prefill, static_argnames=("cfg",))
_j_decode = jax.jit(jt.decode_step, static_argnames=("cfg",))


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


def _ref_stddev(spec):
    init = spec.initializer()
    return init.__closure__[0].cell_contents if init.__closure__ else None


# ---------------------------------------------------------------------------
# configs and parameters
# ---------------------------------------------------------------------------


def _fields(cfg):
    out = {}
    for name in cfg.__dataclass_fields__:
        v = getattr(cfg, name)
        out[name] = jnp.dtype(v).name if name in ("dtype", "logit_dtype") else v
    return out


def _port_fields(cfg):
    out = {}
    for name in cfg.__dataclass_fields__:
        v = getattr(cfg, name)
        out[name] = str(v).replace("torch.", "") if name in ("dtype", "logit_dtype") else v
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_reference_field_for_field(arch):
    for smoke in (False, True):
        jcfg = ref_smoke_config(arch) if smoke else ref_get_config(arch)
        cfg = get_smoke_config(arch) if smoke else get_config(arch)
        want, got = _fields(jcfg), _port_fields(cfg)
        assert set(want) == set(got)
        left_out = {f for f in want if want[f] != got[f]}
        assert left_out <= set(TRAINING_FIELDS), (arch, smoke, {f: (want[f], got[f]) for f in left_out})
        for f in left_out:  # the port keeps the default, which it reads as "not set"
            assert got[f] == type(cfg).__dataclass_fields__[f].default


@pytest.mark.parametrize("arch", ["xlstm-350m", "pixtral-12b", "seamless-m4t-medium"])
def test_registry_still_refuses_the_other_families(arch):
    """The families this file does not serve (xLSTM, the vision prefix,
    the encoder-decoder; ``test_torch_xlstm.py`` and
    ``test_torch_encdec.py`` hold them) are no longer refused: each config
    equals the reference's field for field."""
    for smoke in (False, True):
        jcfg = ref_smoke_config(arch) if smoke else ref_get_config(arch)
        cfg = get_smoke_config(arch) if smoke else get_config(arch)
        assert _fields(jcfg) == _port_fields(cfg), (arch, smoke)


@pytest.mark.parametrize("arch", ARCHS)
def test_spec_matches_reference_leaf_for_leaf(arch):
    """The full config's spec tree, leaf for leaf: shapes, axes, the
    initialiser and its standard deviation (the fan-in rule skips both the
    ``layers`` and the ``experts`` axes of a stacked expert weight)."""
    jcfg, cfg = ref_get_config(arch), get_config(arch)  # specs only: nothing is allocated
    jleaves = jax.tree_util.tree_flatten_with_path(jt.lm_spec(jcfg), is_leaf=lambda x: isinstance(x, jparams.ParamSpec))[0]
    tleaves = list(tree_leaves(tt.lm_spec(cfg)))
    assert len(jleaves) == len(tleaves)
    for (jpath, js), (tpath, ts) in zip(jleaves, tleaves):
        assert tuple(getattr(p, "key", getattr(p, "idx", None)) for p in jpath) == tpath
        assert (js.shape, js.axes, js.init, js.scale) == (ts.shape, ts.axes, ts.init, ts.scale)
        want, got = _ref_stddev(js), ts.stddev()
        assert (want is None) == (got is None)
        if want is not None:
            assert math.isclose(float(want), got, rel_tol=1e-12), tpath
    model = tt.LanguageModel(cfg)  # on the meta device
    assert sum(p.numel() for p in model.parameters()) == param_count(tt.lm_spec(cfg))


@pytest.mark.parametrize("arch,lo,hi", [("deepseek-v2-236b", 200e9, 280e9), ("granite-20b", 18e9, 23e9)])
def test_param_count_matches_reference(arch, lo, hi):
    n = param_count(tt.lm_spec(get_config(arch)))
    assert n == jparams.param_count(jt.lm_spec(ref_get_config(arch)))
    assert lo < n < hi


def test_expert_fan_in_skips_the_experts_axis():
    cfg = get_config("granite-moe-1b-a400m")
    wi = tt.lm_spec(cfg)["units"][0]["mlp"]["wi_gate"]
    assert wi.shape == (24, 32, 1024, 512) and wi.axes == ("layers", "experts", "embed", "mlp")
    assert wi.stddev() == 1 / 32  # fan-in d_model, not E * d_model


@pytest.mark.parametrize("arch", MOE)
def test_params_from_reference_carries_moe_and_mla_leaves(arch):
    jcfg, cfg = _cfgs(arch)
    params, model = _model(jcfg, cfg)  # load_state_dict(strict=True) inside
    n_pre = len(cfg.prefix)
    for u in range(cfg.num_units):
        block = model.block(n_pre + u)
        for name in ("router", "wi_gate", "wi_up", "wo"):
            want = np.asarray(params["units"][0]["mlp"][name][u])
            np.testing.assert_array_equal(getattr(block.mlp, name).numpy(), want)
        assert tuple(block.mlp.wi_gate.shape) == (cfg.num_experts, cfg.d_model, cfg.d_ff_expert)
    if cfg.mla:
        pre = model.prefix[0]
        for name in ("wdq", "wuq", "wdkv", "wuk", "wuv", "wkr", "wo"):
            np.testing.assert_array_equal(getattr(pre.attn, name).numpy(), np.asarray(params["prefix"][0]["attn"][name]))
        np.testing.assert_array_equal(pre.mlp.wi_gate.numpy(), np.asarray(params["prefix"][0]["mlp"]["wi_gate"]))
        assert tuple(pre.mlp.wi_gate.shape) == (cfg.d_model, cfg.prefix_dense_ff)
        shared = model.block(n_pre).mlp.shared
        assert tuple(shared.wi_gate.shape) == (cfg.d_model, cfg.d_ff_expert * cfg.num_shared_experts)


# ---------------------------------------------------------------------------
# modules (float32, 1e-5)
# ---------------------------------------------------------------------------


def test_partial_rope_at_stablelm_head_dim():
    cfg = get_config("stablelm-12b")
    x = _x((1, 9, 4, cfg.head_dim))
    pos = np.arange(100, 109)
    want = jax.jit(jlayers.rope, static_argnames=("theta", "fraction"))(
        jnp.asarray(x), jnp.asarray(pos), theta=cfg.rope_theta, fraction=cfg.rope_fraction)
    got = tlayers.rope(torch.from_numpy(x), torch.from_numpy(pos), theta=cfg.rope_theta, fraction=cfg.rope_fraction)
    assert _rel(want, got) < 1e-5
    np.testing.assert_array_equal(got[..., 40:].numpy(), x[..., 40:])  # 25 % of 160 rotates


def test_gelu_at_granite_width():
    cfg = get_config("granite-20b")
    x = _x((3, cfg.d_ff), scale=3.0)
    want = jax.jit(functools.partial(jax.nn.gelu, approximate=True))(jnp.asarray(x))
    assert _rel(want, F.gelu(torch.from_numpy(x), approximate="tanh")) < 1e-5


_j_moe = jax.jit(jmoe.apply_moe, static_argnums=(1,))


@pytest.mark.parametrize("arch", MOE)
def test_apply_moe_with_drops(arch):
    """The port of the reference's ``test_moe_capacity_drops_tokens``:
    capacity factor 0.25 drops pairs to the residual path; ``y`` and the
    aux loss equal the reference's."""
    jcfg, cfg = _cfgs(arch, capacity_factor=0.25)
    p = jparams.init_tree(KEY, jmoe.moe_spec(jcfg))
    x = _x((2, 32, cfg.d_model), seed=4, scale=0.5)
    want_y, want_aux = _j_moe(p, jcfg, jnp.asarray(x))
    tx = torch.from_numpy(x)
    got_y, got_aux = tmoe.apply_moe(_tree(p), cfg, tx)
    assert got_y.shape == tx.shape
    assert _rel(want_y, got_y) < 1e-5
    assert _rel(want_aux, got_aux) < 1e-5
    C = tmoe.capacity(cfg, 32)
    _, gk, _ = tmoe.route(cfg, tmoe.router_probs(_tree(p), tx), C)
    assert int((gk == 0).sum()) > 0  # some pairs dropped


_j_mla = jax.jit(jattn.apply_mla, static_argnums=(1,), static_argnames=("decode",))


@pytest.mark.parametrize("S", [8, 12], ids=["fills", "wraps"])
def test_apply_mla_prefill_and_absorbed_decode(S):
    jcfg, cfg = _cfgs("deepseek-v2-236b")
    p = jparams.init_tree(KEY, jattn.mla_spec(jcfg))
    tp = _tree(p)
    B, budget = 2, 8
    x = _x((B, S + 1, cfg.d_model), seed=1)
    pos = np.arange(S + 1)
    # no cache: full-sequence attention
    want, _ = _j_mla(p, jcfg, jnp.asarray(x), jnp.asarray(pos))
    got, _ = tattn.apply_mla(tp, cfg, torch.from_numpy(x), torch.from_numpy(pos))
    assert _rel(want, got) < 1e-5
    # prefill of S tokens into a budget of 8 (S = 12 wraps)
    jc = jattn.init_mla_cache(jcfg, B, budget, jnp.float32)
    tc = tattn.init_mla_cache(cfg, B, budget, torch.float32, "cpu")
    want, jc = _j_mla(p, jcfg, jnp.asarray(x[:, :S]), jnp.asarray(pos[:S]), cache=jc)
    got, tc = tattn.apply_mla(tp, cfg, torch.from_numpy(x[:, :S]), torch.from_numpy(pos[:S]), cache=tc)
    assert _rel(want, got) < 1e-5
    for name in ("ckv", "kr", "pos"):
        assert _rel(jc[name], tc[name]) < 1e-5, name
    # absorbed decode of token S
    want, jc = _j_mla(p, jcfg, jnp.asarray(x[:, S:]), jnp.asarray(pos[S:]), cache=jc, decode=True)
    got, tc = tattn.apply_mla(tp, cfg, torch.from_numpy(x[:, S:]), torch.from_numpy(pos[S:]), cache=tc, decode=True)
    assert _rel(want, got) < 1e-5
    for name in ("ckv", "kr", "pos"):
        assert _rel(jc[name], tc[name]) < 1e-5, name


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------


class _Routes:
    """The experts each MoE layer picks, in call order, on both sides:
    the reference's through a ``jax.debug.callback`` (its layers run
    inside ``lax.scan`` under ``jit``), the port's directly."""

    def __init__(self, monkeypatch):
        self.ref, self.port = [], []
        j_apply, t_apply = jt.apply_moe, tt.apply_moe

        def j_wrapped(p, c, x):
            probs = jax.nn.softmax((x @ p["router"].astype(x.dtype)).astype(jnp.float32), -1)
            _, e = jax.lax.top_k(probs, c.top_k)
            jax.debug.callback(lambda e: self.ref.append(np.asarray(e)), e, ordered=True)
            return j_apply(p, c, x)

        def t_wrapped(p, c, x):
            self.port.append(tmoe.top_k(tmoe.router_probs(p, x), c.top_k)[1].numpy())
            return t_apply(p, c, x)

        monkeypatch.setattr(jt, "apply_moe", j_wrapped)
        monkeypatch.setattr(tt, "apply_moe", t_wrapped)

    def agreeing_tokens(self):
        """(share of agreeing (token, choice) pairs over every MoE layer,
        a (B, S) mask of the tokens before the first flip of their
        sequence in any layer)."""
        assert len(self.ref) == len(self.port) > 0
        # a pair agrees when its expert is among the port's choices for the token
        same = np.stack([(r[..., :, None] == p[..., None, :]).any(-1) for r, p in zip(self.ref, self.port)])  # (L, B, S, k)
        return float(same.mean()), np.logical_and.accumulate(same.all(axis=(0, 3)), axis=1)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("arch", ARCHS)
def test_whole_model_logits_and_aux_match_reference(arch, dtype, tol, monkeypatch):
    jcfg, cfg = _cfgs(arch, dtype)
    params, model = _model(jcfg, cfg)
    routes = _Routes(monkeypatch) if cfg.is_moe else None
    B, S = 8, 48  # beyond the gemma2 smoke window of 8; 384 tokens to route
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (B, S))
    pos = np.arange(S)
    # a jit of its own, traced with the recording router in place
    jh, _, jaux = jax.jit(lambda p, t, s: jt.apply_lm(p, jcfg, t, s))(params, jnp.asarray(toks), jnp.asarray(pos))
    th, _, taux = tt.apply_lm(model, cfg, torch.from_numpy(toks), torch.from_numpy(pos))
    want = np.asarray(jt.lm_logits(params, jcfg, jh), np.float32)
    got = tt.lm_logits(model, cfg, th).float().numpy()
    if routes is None:
        assert _rel(want, got) < tol
        assert float(jaux) == float(taux) == 0.0
        return
    share, ok = routes.agreeing_tokens()
    assert share >= ROUTING_AGREEMENT, share
    if dtype == "float32":
        assert ok.all()
    assert ok.sum() >= 0.5 * ok.size  # the comparison below covers most tokens
    assert _rel(want[ok], got[ok]) < tol
    assert _rel(jaux, taux) < tol


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch):
    jcfg, cfg = _cfgs(arch)
    params, model = _model(jcfg, cfg)
    B, S = 2, 20
    toks = np.random.default_rng(6).integers(0, cfg.vocab_size, (B, S))
    jc = jt.init_cache(jcfg, B, S + 4, jcfg.dtype)
    tc = tt.init_cache(cfg, B, S + 4, cfg.dtype, "cpu")
    jl, jc = _j_prefill(params, cfg=jcfg, tokens=jnp.asarray(toks[:, :-1]), caches=jc)
    tl, tc = tt.prefill(model, cfg, torch.from_numpy(toks[:, :-1]), tc)
    assert _rel(jl, tl) < 1e-4
    for step in range(3):  # the last prompt token, then two more
        tok = toks[:, -1:] if step == 0 else np.array(jnp.argmax(jl, -1))[:, None]
        jl, jc = _j_decode(params, cfg=jcfg, token=jnp.asarray(tok), pos=jnp.array(S - 1 + step), caches=jc)
        tl, tc = tt.decode_step(model, cfg, torch.from_numpy(tok), S - 1 + step, tc)
        assert _rel(jl, tl) < 1e-4, step


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_matches_full_forward(arch):
    """The port of the reference's test of the same name (bfloat16, rel
    0.05); MoE runs dropless (capacity factor 8), since capacity drops
    depend on the sequence length."""
    kw = {"capacity_factor": 8.0} if arch in MOE else {}
    cfg = get_smoke_config(arch).replace(**kw)
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


def test_chunked_attention_config_gives_the_reference_chunked_path():
    """granite smoke with ``attn_chunk_threshold=8, attn_q_chunk=4``: the
    reference runs its query-chunked path, the port the same flash
    attention as unchunked; the hidden states agree."""
    jcfg, cfg = _cfgs("granite-20b", attn_chunk_threshold=8, attn_q_chunk=4)
    params, model = _model(jcfg, cfg)
    B, S = 2, 16
    toks = np.random.default_rng(8).integers(0, cfg.vocab_size, (B, S))
    pos = np.arange(S)
    jh, _, _ = _j_apply_lm(params, cfg=jcfg, tokens=jnp.asarray(toks), positions=jnp.asarray(pos))
    th, _, _ = tt.apply_lm(model, cfg, torch.from_numpy(toks), torch.from_numpy(pos))
    assert _rel(jh, th) < 1e-4
    unchunked, _, _ = tt.apply_lm(model, get_smoke_config("granite-20b").replace(dtype=torch.float32),
                                  torch.from_numpy(toks), torch.from_numpy(pos))
    assert torch.equal(th, unchunked)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

SERVE_B, PROMPT, NEW = 2, 24, 8


def _engines(arch, seq_budget):
    jcfg, cfg = _cfgs(arch)
    params, model = _model(jcfg, cfg)
    ref = RefServeEngine(jcfg, params, batch=SERVE_B, seq_budget=seq_budget)
    port = ServeEngine(cfg, model, batch=SERVE_B, seq_budget=seq_budget, device="cpu")
    return ref, port, cfg


@pytest.mark.parametrize("arch", ["gemma2-2b", "granite-moe-1b-a400m", "deepseek-v2-236b"])
def test_generate_gives_the_reference_tokens(arch):
    ref, port, cfg = _engines(arch, PROMPT + NEW)
    prompt = np.random.default_rng(9).integers(0, cfg.vocab_size, (SERVE_B, PROMPT))
    want = np.asarray(ref.generate(jnp.asarray(prompt, jnp.int32), NEW))
    got = port.generate(torch.from_numpy(prompt), NEW)
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(port.generate(torch.from_numpy(prompt), NEW), got)


@pytest.mark.parametrize("arch", ["gemma2-2b", "granite-20b", "deepseek-v2-236b"])
def test_generate_past_the_budget_wraps_global_layers(arch):
    # The prompt plus the new tokens (24 + 8) run past a budget of 16: the
    # global layers' caches wrap as the reference's do (no refusal), and
    # the port gives the reference's tokens.
    budget = 16
    ref, port, cfg = _engines(arch, budget)
    prompt = np.random.default_rng(10).integers(0, cfg.vocab_size, (SERVE_B, PROMPT))
    want = np.asarray(ref.generate(jnp.asarray(prompt, jnp.int32), NEW))
    got = port.generate(torch.from_numpy(prompt), NEW)
    np.testing.assert_array_equal(got.numpy(), want)
    caches = port.new_cache()
    assert all(c["pos"].shape[0] == (min(budget, cfg.window) if k == "local" else budget)
               for c, k in zip(caches, cfg.layer_kinds()))


def test_serve_cli_defaults_to_gemma2_2b(capsys):
    out = serve_cli.main(["--smoke", "--device", "cpu", "--batch", "2", "--prompt-len", "12", "--new-tokens", "4"])
    assert tuple(out.shape) == (2, 4)
    assert "gemma2-2b-smoke: generated (2, 4)" in capsys.readouterr().out
    assert serve_cli.kernels_for(get_config("gemma2-2b")) == ["flash_attention"]
    assert serve_cli.kernels_for(get_config("recurrentgemma-2b")) == ["flash_attention", "rglru_scan"]
