"""The port's train step held against the reference's jitted step, for the
seven decoder architectures at smoke width, with and without gradient
accumulation.

Weights come from the reference's ``init_tree`` and reach the port in the
reference's own layout; batches come from the reference's
``SyntheticLMData`` through its ``UnitBatcher``.  Three
``make_train_step`` steps in float32: the port's own run, loss 1e-5 each
step; and each step taken by both packages from the reference's state
before it: the AdamW moments 1e-4 in each leaf, and each leaf's update
1e-4 in L2 relative to the reference's update over the elements whose
gradient the two packages resolve (``_train_parity`` says how).
"""

import jax.numpy as jnp
import pytest
import torch
from _train_parity import check_train_steps

from repro.configs import get_smoke_config as ref_smoke_config
from repro.data import SyntheticLMData as RefData
from repro.data import UnitBatcher as RefBatcher

from repro_torch.configs import get_smoke_config

ARCHS = ["gemma2-2b", "gemma2-27b", "granite-20b", "stablelm-12b", "granite-moe-1b-a400m",
         "deepseek-v2-236b", "recurrentgemma-2b"]
_JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _cfgs(arch, dtype="float32", **kw):
    return (
        ref_smoke_config(arch).replace(dtype=_JNP[dtype], **kw),
        get_smoke_config(arch).replace(dtype=_TORCH[dtype], **kw),
    )


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_the_reference(arch, accum):
    """Three steps: the port's own run keeps the reference's loss, and each
    step taken from the reference's state gives its moments and update."""
    jcfg, tcfg = _cfgs(arch)
    batcher = RefBatcher(RefData(jcfg, batch=2, seq=16), micro_batch=2)
    units = [batcher.global_step_units(accum, i) for i in range(3)]
    check_train_steps(jcfg, tcfg, [u if accum > 1 else {k: v[0] for k, v in u.items()} for u in units], accum=accum)
