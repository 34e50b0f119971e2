"""Training step factory: mixed precision, gradient accumulation.

The port's copy of the reference's ``runtime/train_loop.py``.  The DFPA
integration point: a group's step processes ``A`` microbatches (units) by
gradient accumulation — the accumulation length IS the paper's
per-processor allocation ``d_i``.

The state holds the fp32 master weights in the reference's layout (the
tree of ``lm_spec``, or of ``encdec_spec`` for an encoder-decoder, each
``units`` stacked along a leading unit axis), trainable, and the model
reads them through ``StackedParams``; so
gradients, AdamW moments and checkpoints have the reference's paths leaf
for leaf.  ``step`` and the optimizer's ``count`` are 0-d int32 tensors on
the host (the schedule and the bias corrections need no sync with the
card).

``train_step(state, batch) -> (new_state, metrics)`` leaves ``state``
untouched, as the reference's does (``launch.train.train_hetero`` steps
every group from the same state).  ``make_train_step(..., inplace=True)``
writes the update into ``state``'s parameters and moments instead and
returns them (the counterpart of JAX's buffer donation, for a caller that
never reuses the old state, as ``train_single``): the same values bit for
bit, without a second copy of the parameters and moments.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Tuple, Union

import numpy as np
import torch

from ..core.modelbank_torch import resolve_device
from ..models.config import ModelConfig
from ..models.encdec import encdec_loss, encdec_spec
from ..models.transformer import lm_loss, lm_spec
from ..nn.params import init_tree, tree_map
from ..optim import AdamWState, adamw_init, adamw_update

__all__ = ["TrainState", "init_train_state", "make_train_step", "loss_for_config", "model_spec_for"]


class TrainState(NamedTuple):
    params: Any  # fp32 master weights, the reference's tree layout
    opt: AdamWState
    step: torch.Tensor  # () int32, on the host


def model_spec_for(cfg: ModelConfig):
    return encdec_spec(cfg) if cfg.is_encdec else lm_spec(cfg)


def loss_for_config(cfg: ModelConfig) -> Callable:
    if cfg.is_encdec:
        return lambda p, b: encdec_loss(p, cfg, b)
    return lambda p, b: lm_loss(p, cfg, b)


def init_train_state(
    cfg: ModelConfig,
    key: Union[int, torch.Generator] = 0,
    *,
    params=None,
    moment_dtype=None,
    device="cuda",
) -> TrainState:
    """A fresh state on ``device``: the parameters drawn by ``init_tree``
    from ``key`` (a seed, or a ``torch.Generator`` on ``device``), or a copy
    of ``params`` (a tree in the reference's layout, for example
    ``nn.tree_from_reference`` of the reference's weights, or
    ``nn.convert.stack_tree(model.state_dict(), cfg, numpy=False)`` of a
    serving model), made trainable (``requires_grad_(True)``); zero
    moments of ``moment_dtype`` (the parameters' dtype when None)."""
    dev = resolve_device(device)
    if params is None:
        gen = key if isinstance(key, torch.Generator) else torch.Generator(device=dev).manual_seed(int(key))
        params = init_tree(model_spec_for(cfg), gen, dev)
    else:
        params = tree_map(lambda t: t.detach().to(dev, copy=True), params)
    params = tree_map(lambda t: t.requires_grad_(True), params)
    return TrainState(params=params, opt=adamw_init(params, moment_dtype=moment_dtype),
                      step=torch.zeros((), dtype=torch.int32))


def _leaves(tree) -> list:
    """The leaves in ``tree_map``'s order."""
    out = []
    tree_map(out.append, tree)
    return out


def _device_batch(batch: Dict, device) -> Dict[str, torch.Tensor]:
    """Host (numpy) or device batch leaves as tensors on ``device``;
    integer leaves (tokens, labels) as int64, the indices torch takes."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(np.asarray(v)) if not isinstance(v, torch.Tensor) else v
        out[k] = t.to(device, torch.int64 if not t.is_floating_point() else t.dtype)
    return out


def make_train_step(
    cfg: ModelConfig,
    lr_schedule: Callable[[torch.Tensor], torch.Tensor],
    *,
    accum_steps: int = 1,
    weight_decay: float = 0.1,
    max_grad_norm: float = 1.0,
    b1: float = 0.9,
    b2: float = 0.95,
    inplace: bool = False,
) -> Callable[[TrainState, Dict], Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    ``accum_steps == 1``: batch leaves are (B, ...) (or one stacked unit
    (1, mb, ...)).  ``accum_steps == A > 1``: batch leaves are (A, mb, ...)
    — one leading unit dim; gradients (float32) and losses averaged over
    the units, summed in unit order as the reference's scan sums them.
    """
    loss_fn = loss_for_config(cfg)

    def grads_of(params, batch):
        leaves = _leaves(params)
        with torch.enable_grad():
            loss, metrics = loss_fn(params, batch)
            grads = torch.autograd.grad(loss, leaves)
        it = iter(grads)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return loss.detach(), metrics, tree_map(lambda _: next(it), params)

    def train_step(state: TrainState, batch: Dict):
        params = state.params
        batch = _device_batch(batch, _leaves(params)[0].device)
        if accum_steps == 1:
            tok = batch.get("tokens")
            if tok is not None and tok.dim() == 3 and tok.shape[0] == 1:
                batch = {k: v[0] for k, v in batch.items()}
            loss, metrics, grads = grads_of(params, batch)
        else:
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)
            loss = torch.zeros((), dtype=torch.float32, device=_leaves(params)[0].device)
            for a in range(accum_steps):
                l_a, _, g_a = grads_of(params, {k: v[a] for k, v in batch.items()})
                tree_map(lambda acc, g: acc.add_(g.to(torch.float32)), grads, g_a)
                loss = loss + l_a
                del g_a
            grads = tree_map(lambda g: g / accum_steps, grads)
            loss = loss / accum_steps
            metrics = {}

        lr = lr_schedule(state.step)
        new_params, new_opt, opt_metrics = adamw_update(
            grads, state.opt, params, lr=lr, b1=b1, b2=b2,
            weight_decay=weight_decay, max_grad_norm=max_grad_norm, inplace=inplace,
        )
        metrics = dict(metrics)
        metrics.update(opt_metrics)
        metrics["loss"] = loss
        return TrainState(new_params, new_opt, state.step + 1), metrics

    return train_step
