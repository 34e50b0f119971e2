"""AdamW (decoupled weight decay) with global-norm clipping — the port's
copy of the reference's ``optim/adamw.py``.

Trees are nested dicts and tuples of tensors (the reference's pytrees; the
model's parameters in the reference's layout, ``runtime.train_loop``).
:func:`adamw_update` is functional: it returns new parameters and moments
and leaves its inputs as they were.  ``inplace=True`` writes the same
values into the given parameters and moments instead (the counterpart of
JAX's buffer donation, for a caller that never reuses the old state): the
update of one leaf is the same expressions either way, so the two forms
agree bit for bit, and the in-place one never holds a second copy of the
parameters and moments.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import torch

from ..nn.params import tree_leaves, tree_map, tree_map_n

__all__ = ["AdamWState", "adamw_init", "adamw_update", "clip_by_global_norm"]


class AdamWState(NamedTuple):
    mu: Any  # first moment (tree like params)
    nu: Any  # second moment
    count: torch.Tensor  # () int32, on the host


def adamw_init(params, *, moment_dtype=None) -> AdamWState:
    """``moment_dtype=torch.bfloat16`` halves optimizer-state memory; the
    update math still runs in fp32."""
    z = lambda p: torch.zeros(p.shape, dtype=moment_dtype or p.dtype, device=p.device)
    return AdamWState(mu=tree_map(z, params), nu=tree_map(z, params), count=torch.zeros((), dtype=torch.int32))


def global_norm(grads) -> torch.Tensor:
    """``sqrt`` of the sum over leaves of each leaf's summed squares, in
    float32 (on the leaves' device)."""
    return torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32))) for _, g in tree_leaves(grads)))


def _clip_scale(gn: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp_max(max_norm / torch.clamp_min(gn, 1e-12), 1.0)


def clip_by_global_norm(grads, max_norm: float):
    gn = global_norm(grads)
    scale = _clip_scale(gn, max_norm)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), gn


def _update_leaf(g, m, v, p, *, lr, c1, c2, b1, b2, eps, weight_decay, inplace):
    """One leaf's new ``(p, m, v)`` in their dtypes, the math in float32:
    the reference's expressions, evaluated op by op into as few buffers as
    they allow.  With ``inplace`` the float32 ``p``, ``m`` and ``v`` are
    those buffers; the values are the same either way (each op computes
    the same function in place as out of place)."""
    f32 = torch.float32
    g = g.to(f32)
    own = lambda t: t if inplace and t.dtype == f32 else t.to(f32, copy=True)
    m_new = own(m).mul_(b1).add_(g * (1.0 - b1))  # b1 m + (1 - b1) g
    v_new = own(v).mul_(b2).add_(torch.square(g).mul_(1.0 - b2))  # b2 v + (1 - b2) g^2
    den = (v_new / c2).sqrt_().add_(eps)  # sqrt(vhat) + eps
    step = (m_new / c1).div_(den)  # mhat / (sqrt(vhat) + eps)
    del den
    step.add_(p.to(f32) * weight_decay).mul_(lr)  # lr (... + wd p)
    p_new = own(p).sub_(step)
    return p_new.to(p.dtype), m_new.to(m.dtype), v_new.to(v.dtype)


@torch.no_grad()
def adamw_update(
    grads,
    state: AdamWState,
    params,
    *,
    lr,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    max_grad_norm: float = 1.0,
    inplace: bool = False,
) -> Tuple[Any, AdamWState, Dict[str, torch.Tensor]]:
    """Returns (new_params, new_state, metrics).  ``lr``: a float or a 0-d
    float32 tensor (on the host or the parameters' device).  New parameters
    keep their ``requires_grad``.  The clipped gradient of a leaf is made
    just before its update (the values :func:`clip_by_global_norm` gives),
    so one leaf's worth of temporaries is live at a time; ``grads`` is
    never written."""
    if max_grad_norm > 0:
        gnorm = global_norm(grads)
        scale = _clip_scale(gnorm, max_grad_norm)
    else:
        gnorm, scale = torch.zeros(()), None
    count = state.count + 1
    f32 = lambda x: torch.tensor(x, dtype=torch.float32)
    c1 = 1.0 - f32(b1) ** count.to(torch.float32)
    c2 = 1.0 - f32(b2) ** count.to(torch.float32)
    lr = torch.as_tensor(lr, dtype=torch.float32)
    kw = dict(lr=lr, c1=c1, c2=c2, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay, inplace=inplace)

    def one(g, m, v, p):
        if scale is not None:
            g = g * scale.to(g.dtype)
        new_p, new_m, new_v = _update_leaf(g, m, v, p, **kw)
        del g
        if inplace:
            for old, val in zip((p, m, v), (new_p, new_m, new_v)):
                if val is not old:
                    old.copy_(val)
            return p, m, v
        return new_p.requires_grad_(p.requires_grad), new_m, new_v

    new_p, new_m, new_v = tree_map_n(one, 3, grads, state.mu, state.nu, params)
    metrics = {"grad_norm": gnorm, "lr": lr}
    return new_p, AdamWState(new_m, new_v, count), metrics
