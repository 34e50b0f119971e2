"""The port's serving path held against the reference's.

``ServeEngine.generate`` (prefill, then greedy decode) on the
recurrentgemma smoke config in float32, weights carried over from the
reference's ``init_tree``, prompts made from a seed with numpy: the port
must produce exactly the reference engine's tokens.  The prompt (24
tokens) runs past the window (8), so the ring buffer wraps during prefill
and decode.  A budget equal to the window, which the prompt and the new
tokens run past, gives the reference's tokens too.  Also the
``launch/serve.py`` CLI, on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.models.transformer import lm_spec as ref_lm_spec
from repro.nn.params import init_tree as ref_init_tree
from repro.runtime.serve_loop import ServeEngine as RefServeEngine

from repro_torch.configs import get_smoke_config
from repro_torch.launch import serve as serve_cli
from repro_torch.models.transformer import LanguageModel, init_lm
from repro_torch.nn import params_from_reference
from repro_torch.runtime import ServeEngine

ARCH = "recurrentgemma-2b"
B, PROMPT, NEW = 2, 24, 8


def _engines(seed, seq_budget=PROMPT + NEW):
    jcfg = ref_smoke_config(ARCH).replace(dtype=jnp.float32)
    cfg = get_smoke_config(ARCH).replace(dtype=torch.float32)
    params = jax.jit(lambda k: ref_init_tree(k, ref_lm_spec(jcfg)))(jax.random.PRNGKey(seed))
    model = LanguageModel.from_state_dict(cfg, params_from_reference(jax.tree_util.tree_map(np.asarray, params), cfg))
    ref = RefServeEngine(jcfg, params, batch=B, seq_budget=seq_budget)
    port = ServeEngine(cfg, model, batch=B, seq_budget=seq_budget, device="cpu")
    return ref, port, cfg


@pytest.mark.parametrize("seed", [0, 1])
def test_generate_gives_the_reference_tokens(seed):
    ref, port, cfg = _engines(seed)
    prompt = np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, PROMPT))
    want = np.asarray(ref.generate(jnp.asarray(prompt, jnp.int32), NEW))
    got = port.generate(torch.from_numpy(prompt), NEW)
    assert got.shape == (B, NEW) and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(port.generate(torch.from_numpy(prompt), NEW), got)  # deterministic


def test_generate_past_the_budget_gives_the_reference_tokens():
    # The prompt plus the new tokens (24 + 8) run past a budget equal to the
    # window (8): the reference serves it, and so must the port.
    cfg = get_smoke_config(ARCH)
    ref, port, cfg = _engines(0, seq_budget=cfg.window)
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, PROMPT))
    want = np.asarray(ref.generate(jnp.asarray(prompt, jnp.int32), NEW))
    got = port.generate(torch.from_numpy(prompt), NEW)
    np.testing.assert_array_equal(got.numpy(), want)


def test_engine_refuses_what_it_does_not_serve():
    cfg = get_smoke_config(ARCH)
    model = init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    eng = ServeEngine(cfg, model, batch=2, seq_budget=16, device="cpu")
    prompt = torch.zeros((2, 12), dtype=torch.int64)
    with pytest.raises(NotImplementedError, match="greedy"):
        eng.generate(prompt, 4, greedy=False)
    assert tuple(eng.generate(prompt, 5).shape) == (2, 5)  # 12 + 5 past the budget of 16, as the reference
    with pytest.raises(ValueError, match="batch"):
        eng.generate(prompt[:1], 4)
    with pytest.raises(ValueError, match="parameters lie on"):
        ServeEngine(cfg, model, batch=2, seq_budget=16, device="meta")
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="cuda"):
            ServeEngine(cfg, model, batch=2, seq_budget=16)


def test_serve_cli_runs_the_smoke_model_on_the_cpu(capsys):
    out = serve_cli.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
                          "--prompt-len", "12", "--new-tokens", "4", "--seed", "3"])
    assert tuple(out.shape) == (2, 4)
    text = capsys.readouterr().out
    assert "generated (2, 4)" in text and "tok/s, host clock" in text
    again = serve_cli.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
                            "--prompt-len", "12", "--new-tokens", "4", "--seed", "3"])
    assert torch.equal(out, again)


def test_serve_cli_refuses_what_is_not_ported(capsys):
    """``--replicas`` is ported (the dispatch demo runs; its line is held
    against the reference in ``tests/test_torch_dispatch.py``); xLSTM
    serves; an encoder-decoder gets the reference's ``SystemExit`` (its
    CLI serves decoder-only architectures)."""
    serve_cli.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--replicas", "4"])
    assert capsys.readouterr().out.strip().splitlines()[-1].startswith("DFPA dispatch over 4 replicas: d=")
    out = serve_cli.main(["--arch", "xlstm-350m", "--smoke", "--device", "cpu", "--batch", "2",
                          "--prompt-len", "8", "--new-tokens", "3"])
    assert tuple(out.shape) == (2, 3)
    with pytest.raises(SystemExit, match="serve CLI demonstrates decoder-only archs; see tests for enc-dec"):
        serve_cli.main(["--arch", "seamless-m4t-medium", "--smoke", "--device", "cpu"])
