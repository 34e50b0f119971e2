"""Dry run: trace every (arch x shape) cell without the card's data.

The port's counterpart of the reference's ``launch/dryrun.py``, which
lowers and compiles every cell on 512 placeholder CPU devices to prove the
distribution config coherent and to read roofline terms from XLA.  The port
runs on one NVIDIA H100, so its question is sharper: does each cell fit in
the card's memory, and what are its compute and memory times at the card's
peaks?  It answers without the card and without allocating: the cell's step
(the port's own training step, prefill or decode, with its kernels, dtypes,
remat and chunked cross-entropy) runs on ``meta`` tensors, which carry
shapes, dtypes and strides and no data, and a ``TorchDispatchMode`` of its
own (:class:`CostCounter`) adds up, op by op (aten or the kernels' custom
operators):

  * FLOPs, by ``torch.utils.flop_counter``'s formulas (the kernels register
    theirs), split by the operand dtype, each divided by its own peak;
  * bytes: every op's tensor inputs plus outputs, the eager program's
    traffic; views and ``empty`` move nothing, ``fill_`` / ``zero_`` write
    their tensor, and the ops that write into part or all of a tensor in
    place (``copy_``, ``index_copy_``, ``index_put_``, ``scatter_``, ...)
    read their other inputs and write as many bytes;
  * live storage bytes: each new storage on the card is added when an op
    creates it and subtracted when it dies (a weakref finalizer); the peak
    is the step's temporaries.  An op's own internal temporaries (those
    its CUDA implementation allocates and frees inside one call) are not
    seen; the traced steps call no op that makes one of a tensor's size
    (the loss computes its logsumexp in place, ``models.transformer``).

Roofline terms (``launch.mesh.HW``)::

    compute_s    = sum over operand dtypes of FLOPs / that dtype's peak
    memory_s     = bytes / 3.35e12          (HBM bandwidth)
    collective_s = 0                        (one card)

Cost model, as the reference's ``run_cell``: the 1-unit and 2-unit depth
variants are traced at the cell's full batch and sequence, and FLOPs,
bytes and peak temporaries are extrapolated affinely in units (cost(U) =
a + b U).  The argument bytes (parameters or training state, caches,
inputs) are exact at full depth, from the specs; resident = arguments +
temporaries, and ``fits_hbm`` compares it with ``HW.HBM_BYTES``.

Dropped from the reference, each with its reason:

  * the 16x16 and 2x16x16 meshes and the SPMD partitioner: the port's mesh
    is the one card (``launch.mesh``); ``--mesh multi|both`` is refused;
  * ``collective_stats``: one card has no collectives, so ``collectives``
    is ``{}`` and ``collective_bytes`` 0;
  * ``slstm_flops_correction``: XLA's cost analysis counted the rolled
    sLSTM time loop once; the port's trace runs every step, so its count is
    exact;
  * the compile: a record has ``trace_s`` where the reference's had
    ``lower_s`` / ``compile_s``.

Why ``meta`` tensors and not ``FakeTensorMode``'s fake ``cuda`` ones: a
build of torch without CUDA (a host without the card) cannot index or
differentiate a fake ``cuda`` tensor (both take a CUDA device guard),
while ``meta`` tensors trace the same ops on every build.  The model's
code branches on the device in one place, ``kernels.ops``, which sends
``meta`` tensors down the kernel's path: each kernel's custom operator has
a meta implementation (and a FLOP formula), so the trace holds the kernels
the card would launch, and no kernel runs, builds or counts a launch.
The training state's step and count stay 0-d host tensors, as the port
keeps them.

Usage (several cells trace in parallel, one process a cell, as many as
the host has cores):
    python -m repro_torch.launch.dryrun --arch all --shape all --out experiments/dryrun_torch
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback
import weakref
from concurrent.futures import ProcessPoolExecutor
from dataclasses import dataclass
from typing import Any, Dict, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from ..configs import ARCH_IDS, SHAPES, ShapeSpec, get_config, shape_applicable
from ..models import encdec as ED
from ..models import transformer as T
from ..models.config import ModelConfig
from ..nn.params import param_count, tree_leaves, tree_map
from ..optim import AdamWState
from ..optim.schedule import warmup_cosine
from ..runtime.train_loop import TrainState, make_train_step, model_spec_for
from ..sharding import NamedSharding, PartitionSpec, logical_to_pspec
from ..sharding.context import ACT_RULES
from .mesh import HW, Mesh, make_production_mesh

__all__ = [
    "CostCounter", "TensorSpec", "active_param_count", "build_step", "cache_sds", "input_specs", "main",
    "param_sds", "reduced_units", "run_cell", "state_sds", "trace_variant",
]


# ---------------------------------------------------------------------------
# Tensor specs (no allocation anywhere)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class TensorSpec:
    """A tensor's shape, dtype, sharding and device type (``"cuda"``, or
    ``"cpu"`` for the training state's host scalars): the port's
    ``jax.ShapeDtypeStruct``."""

    shape: Tuple[int, ...]
    dtype: torch.dtype
    sharding: NamedSharding
    device: str = "cuda"

    @property
    def nbytes(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64)) * torch.empty((), dtype=self.dtype).element_size()


def _sds(shape, dtype, mesh: Mesh, axes, device: str = "cuda") -> TensorSpec:
    shape = tuple(int(s) for s in shape)
    return TensorSpec(shape, dtype, NamedSharding(mesh, logical_to_pspec(axes, mesh, shape, rules=ACT_RULES)), device)


def _scalar(mesh: Mesh, device: str) -> TensorSpec:
    return TensorSpec((), torch.int32, NamedSharding(mesh, PartitionSpec()), device)


def param_sds(cfg: ModelConfig, mesh: Mesh, dtype=None):
    """The parameter tree (the reference's stacked layout) as specs, in
    ``dtype`` (the specs' own, float32, when None)."""
    return tree_map(lambda l: _sds(l.shape, dtype or l.dtype, mesh, l.axes), model_spec_for(cfg))


def state_sds(cfg: ModelConfig, mesh: Mesh, *, moment_dtype=None) -> TrainState:
    """The training state: float32 parameters, AdamW moments in
    ``moment_dtype`` (the parameters' when None), and the step and count,
    0-d int32 host tensors as the port keeps them."""
    p = param_sds(cfg, mesh)
    m = param_sds(cfg, mesh, dtype=moment_dtype) if moment_dtype else p
    return TrainState(params=p, opt=AdamWState(mu=m, nu=m, count=_scalar(mesh, "cpu")), step=_scalar(mesh, "cpu"))


def cache_sds(cfg: ModelConfig, mesh: Mesh, batch: int, seq_budget: int):
    """The serving caches of ``init_cache`` (``init_encdec_cache``, its
    encoder length the budget) in ``cfg.dtype``, as specs: one entry per
    layer, in depth order, each leaf's sharding from ``cache_axes``."""
    if cfg.is_encdec:
        shapes = ED.init_encdec_cache(cfg, batch, seq_budget, seq_budget, cfg.dtype, device="meta")
        axes = ED.encdec_cache_axes(cfg)
    else:
        shapes = T.init_cache(cfg, batch, seq_budget, cfg.dtype, device="meta")
        axes = T.cache_axes(cfg)

    def walk(s, a):
        if isinstance(s, torch.Tensor):
            return _sds(s.shape, s.dtype, mesh, a)
        if isinstance(s, dict):
            return {k: walk(v, a[k]) for k, v in s.items()}
        return type(s)(walk(v, a[i]) for i, v in enumerate(s))

    return walk(shapes, axes)


def input_specs(cfg: ModelConfig, shape: ShapeSpec, mesh: Mesh) -> Dict[str, Any]:
    """Specs of every model input of this cell (the reference's)."""
    B, S = shape.global_batch, shape.seq_len
    tok = lambda b, s: _sds((b, s), torch.int32, mesh, ("batch", "seq"))
    out: Dict[str, Any] = {}
    if shape.kind == "train":
        A = max(cfg.train_accum, 1)
        mb = B // A
        # the accumulation unit dim leads when A > 1 (the DFPA unit axis)
        lead = (A,) if A > 1 else ()
        lax_ = (None,) if A > 1 else ()
        atok = lambda s: _sds(lead + (mb, s), torch.int32, mesh, lax_ + ("batch", "seq"))
        if cfg.is_encdec:
            out["batch"] = {
                "frames": _sds(lead + (mb, S, cfg.d_model), torch.float32, mesh, lax_ + ("batch", "seq", "embed_act")),
                "tokens": atok(S),
                "labels": atok(S),
            }
        else:
            s_text = S - cfg.num_prefix_embeddings
            out["batch"] = {"tokens": atok(s_text), "labels": atok(s_text)}
            if cfg.frontend == "vision_stub":
                out["batch"]["prefix_embeds"] = _sds(
                    lead + (mb, cfg.num_prefix_embeddings, cfg.d_model), torch.float32, mesh,
                    lax_ + ("batch", "seq", "embed_act"),
                )
    elif shape.kind == "prefill":
        out["caches"] = cache_sds(cfg, mesh, B, S)
        if cfg.is_encdec:
            out["frames"] = _sds((B, S, cfg.d_model), torch.float32, mesh, ("batch", "seq", "embed_act"))
            out["tokens"] = tok(B, S)
        else:
            s_text = S - cfg.num_prefix_embeddings
            out["tokens"] = tok(B, s_text)
            if cfg.frontend == "vision_stub":
                out["prefix_embeds"] = _sds(
                    (B, cfg.num_prefix_embeddings, cfg.d_model), torch.float32, mesh, ("batch", "seq", "embed_act"),
                )
    else:  # decode
        out["caches"] = cache_sds(cfg, mesh, B, S)
        out["token"] = tok(B, 1)
        out["pos"] = _scalar(mesh, "cuda")
    return out


# ---------------------------------------------------------------------------
# Steps to trace
# ---------------------------------------------------------------------------


def reduced_units(cfg: ModelConfig, units: int) -> ModelConfig:
    """Same family and widths, ``units`` pattern repetitions (prefix kept)."""
    kw = dict(num_layers=len(cfg.prefix) + units * len(cfg.pattern))
    if cfg.is_encdec:
        kw["encoder_layers"] = units * len(cfg.encoder_pattern)
    return cfg.replace(**kw)


def build_step(cfg: ModelConfig, shape: ShapeSpec, mesh: Mesh):
    """``(fn, args)``: the cell's step and its argument specs.  Training is
    ``make_train_step`` with ``inplace=True`` (the counterpart of the
    reference's donated state); serving takes bf16 weights in the
    reference's stacked layout."""
    if shape.kind == "train":
        step = make_train_step(
            cfg, warmup_cosine(3e-4, 100, 10_000), accum_steps=max(cfg.train_accum, 1), inplace=True,
        )
        ins = input_specs(cfg, shape, mesh)
        mdt = torch.bfloat16 if os.environ.get("REPRO_BF16_MOMENTS") else None
        return step, (state_sds(cfg, mesh, moment_dtype=mdt), ins["batch"])

    sparams = param_sds(cfg, mesh, dtype=cfg.dtype)  # bf16 serving weights
    ins = input_specs(cfg, shape, mesh)
    if shape.kind == "prefill":
        if cfg.is_encdec:
            def fn(params, frames, tokens, caches):
                return ED.encdec_prefill(params, cfg, frames, tokens, caches)

            return fn, (sparams, ins["frames"], ins["tokens"], ins["caches"])
        if cfg.frontend == "vision_stub":
            def fn(params, tokens, prefix_embeds, caches):
                return T.prefill(T.StackedParams(cfg, params), cfg, tokens, caches, prefix_embeds=prefix_embeds)

            return fn, (sparams, ins["tokens"], ins["prefix_embeds"], ins["caches"])

        def fn(params, tokens, caches):
            return T.prefill(T.StackedParams(cfg, params), cfg, tokens, caches)

        return fn, (sparams, ins["tokens"], ins["caches"])

    if cfg.is_encdec:
        def fn(params, token, pos, caches):
            return ED.encdec_decode_step(params, cfg, token, pos, caches)
    else:
        def fn(params, token, pos, caches):
            return T.decode_step(T.StackedParams(cfg, params), cfg, token, pos, caches)

    return fn, (sparams, ins["token"], ins["pos"], ins["caches"])


def _spec_leaves(tree):
    leaves, _ = tree_flatten(tree, is_leaf=lambda x: isinstance(x, TensorSpec))
    return [x for x in leaves if isinstance(x, TensorSpec)]


def argument_bytes(args) -> int:
    return sum(s.nbytes for s in _spec_leaves(args))


def materialize(args, device: str = "cuda"):
    """The specs as empty tensors on ``device`` (``meta`` for a trace;
    host scalars stay zeros on the host); NamedTuples, dicts, tuples and
    lists kept.  Training parameters require gradients."""

    def walk(x, grad=False):
        if isinstance(x, TensorSpec):
            t = torch.empty(x.shape, dtype=x.dtype, device=device if x.device == "cuda" else "cpu")
            if x.device == "cpu":
                t.zero_()
            return t.requires_grad_(True) if grad else t
        if isinstance(x, TrainState):
            return TrainState(walk(x.params, True), walk(x.opt), walk(x.step))
        if isinstance(x, dict):
            return {k: walk(v, grad) for k, v in x.items()}
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*(walk(v, grad) for v in x))
        if isinstance(x, (tuple, list)):
            return type(x)(walk(v, grad) for v in x)
        return x

    return walk(args)


def run_step(fn, args, shape: ShapeSpec):
    """``fn(*args)`` as the cell runs it: serving without autograd."""
    if shape.kind == "train":
        return fn(*args)
    with torch.no_grad():
        return fn(*args)


# ---------------------------------------------------------------------------
# Counting
# ---------------------------------------------------------------------------

_NO_TRAFFIC = {
    torch.ops.aten.empty, torch.ops.aten.empty_like, torch.ops.aten.empty_strided, torch.ops.aten.new_empty,
    torch.ops.aten.new_empty_strided, torch.ops.aten._unsafe_view, torch.ops.aten.lift_fresh,
}


TRACE_DEVICE = "meta"  # the card's stand-in: shapes, dtypes, strides, no data


_aten = torch.ops.aten
_WRITE_ONLY = {_aten.fill_, _aten.zero_}
_SCATTER = {
    _aten.copy_, _aten.index_copy_, _aten.index_put_, _aten._index_put_impl_, _aten.index_add_, _aten.scatter_,
    _aten.scatter_add_, _aten.scatter_reduce_, _aten.masked_scatter_,
}


def _traffic(packet, args, kwargs, outs) -> int:
    """Bytes an op moves (the module docstring's rule)."""
    if packet in _NO_TRAFFIC:
        return 0
    if packet in _WRITE_ONLY:
        return _nbytes(args[0])
    ins = _tensors((args, kwargs))
    if packet in _SCATTER:
        return 2 * sum(_nbytes(t) for t in ins[1:])
    return sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class CostCounter(TorchDispatchMode):
    """Adds up FLOPs (by operand dtype), bytes and live storage bytes of
    every op dispatched under it (see the module docstring), and the calls
    of each kernel's custom operator.  Storages of ``known`` tensors (the
    step's arguments) are not counted as new."""

    def __init__(self, known=()):
        super().__init__()
        self.flops: Dict[str, float] = {}
        self.bytes = 0
        self.ops = 0
        self.kernel_calls: Dict[str, int] = {}
        self.live = 0
        self.peak = 0
        self._keys = set()
        for t in known:
            self._keys.add(t.untyped_storage()._cdata)

    def _free(self, key: int, nb: int) -> None:
        self._keys.discard(key)
        self.live -= nb

    def _track(self, t: torch.Tensor) -> None:
        if t.device.type != TRACE_DEVICE:
            return
        st = t.untyped_storage()
        key = st._cdata
        if key in self._keys:
            return
        self._keys.add(key)
        nb = st.nbytes()
        self.live += nb
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key, nb)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.ops += 1
        if func.namespace == "repro_torch":
            name = func._overloadpacket.__name__
            self.kernel_calls[name] = self.kernel_calls.get(name, 0) + 1
        packet = func._overloadpacket
        formula = flop_registry.get(packet)
        if formula is not None:
            ins = _tensors((args, kwargs))
            dt = str(ins[0].dtype).replace("torch.", "") if ins else "float32"
            self.flops[dt] = self.flops.get(dt, 0.0) + float(formula(*args, **kwargs, out_val=out))
        outs = _tensors(out)
        if not func.is_view:
            self.bytes += _traffic(packet, args, kwargs, outs)
        for t in outs:
            self._track(t)
        return out


def compute_seconds(flops: Dict[str, float]) -> float:
    return sum(f / HW.peak_flops(getattr(torch, dt)) for dt, f in flops.items())


def trace_variant(cfg: ModelConfig, shape: ShapeSpec, mesh: Mesh) -> Dict[str, Any]:
    """Trace one step of ``cfg`` at ``shape`` on ``meta`` tensors:
    FLOPs by dtype, bytes, ops, argument bytes, peak temporaries, the
    outputs' bytes (new storages) and aliased bytes (outputs in argument
    storages), and the seconds the trace took."""
    fn, spec_args = build_step(cfg, shape, mesh)
    t0 = time.perf_counter()
    args = materialize(spec_args, TRACE_DEVICE)
    arg_tensors = [t for t in _tensors(args) if t.device.type == TRACE_DEVICE]
    arg_keys = {t.untyped_storage()._cdata for t in arg_tensors}
    with CostCounter(arg_tensors) as counter:
        out = run_step(fn, args, shape)
    outs = [t for t in _tensors(out) if t.device.type == TRACE_DEVICE]
    out_keys, alias_keys, output_bytes, alias_bytes = set(), set(), 0, 0
    for t in outs:
        st = t.untyped_storage()
        if st._cdata in arg_keys:
            alias_bytes += 0 if st._cdata in alias_keys else st.nbytes()
            alias_keys.add(st._cdata)
        elif st._cdata not in out_keys:
            out_keys.add(st._cdata)
            output_bytes += st.nbytes()
    del out, outs, args, arg_tensors
    return {
        "flops": counter.flops, "bytes": float(counter.bytes), "ops": counter.ops,
        "kernel_calls": counter.kernel_calls,
        "argument_bytes": argument_bytes(spec_args), "temp_bytes": int(counter.peak),
        "output_bytes": int(output_bytes), "alias_bytes": int(alias_bytes),
        "trace_s": time.perf_counter() - t0,
    }


# ---------------------------------------------------------------------------
# Cell runner
# ---------------------------------------------------------------------------


def active_param_count(cfg: ModelConfig) -> int:
    """Parameters touched per token (MoE: shared + top_k/E of routed)."""
    total = 0
    for _, leaf in tree_leaves(model_spec_for(cfg)):
        n = int(np.prod(leaf.shape))
        if "experts" in leaf.axes:
            n = int(n * cfg.top_k / max(cfg.num_experts, 1))
        total += n
    return total


def _affine(c1: float, c2: float, U: int) -> float:
    b = max(c2 - c1, 0.0)
    a = max(c1 - b, 0.0)
    return a + b * U


def model_flops(cfg: ModelConfig, shape: ShapeSpec) -> float:
    """MODEL_FLOPS: 6 N D for training, 2 N D forward only (N active)."""
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    return float((6 if shape.kind == "train" else 2) * active_param_count(cfg) * tokens)


def run_cell(arch: str, shape_name: str, multi_pod: bool = False, *, costs: bool = True) -> Dict[str, Any]:
    """One dry-run cell on the one-card mesh: the 1-unit and 2-unit
    variants traced (unless ``costs`` is False), their costs extrapolated
    to the config's depth, the argument bytes taken from the specs."""
    if multi_pod:
        raise NotImplementedError("the port's dry run has one mesh, the card's (1x1)")
    cfg = get_config(arch)
    shape = next(s for s in SHAPES if s.name == shape_name)
    rec: Dict[str, Any] = {"arch": arch, "shape": shape_name, "mesh": "1x1"}
    skip = shape_applicable(cfg, shape)
    if skip:
        rec["status"] = "skipped"
        rec["reason"] = skip
        return rec
    try:
        mesh = make_production_mesh(device=TRACE_DEVICE)
        _, full_args = build_step(cfg, shape, mesh)
        args_full = argument_bytes(full_args)
        rec["params_total"] = param_count(model_spec_for(cfg))
        n_active = active_param_count(cfg)
        rec["params_active"] = n_active
        mf = model_flops(cfg, shape)
        rec["model_flops_total"] = mf
        rec["model_flops_per_dev"] = mf
        if not costs:
            rec["status"] = "ok"
            rec["mem"] = {"argument_bytes": args_full}
            return rec
        U = cfg.num_units
        variants = {}
        for u in (1, 2):
            vcfg = reduced_units(cfg, u).replace(scan_layers=False, unroll_scans=True)
            variants[u] = trace_variant(vcfg, shape, mesh)
        v1, v2 = variants[1], variants[2]
        for v in (v1, v2):
            v["resident_bytes"] = v["argument_bytes"] + v["temp_bytes"]
        rec["trace_s"] = v1["trace_s"] + v2["trace_s"]
        rec["cost_model"] = {"u1": v1, "u2": v2}
        flops = {dt: _affine(v1["flops"].get(dt, 0.0), v2["flops"].get(dt, 0.0), U)
                 for dt in sorted(set(v1["flops"]) | set(v2["flops"]))}
        temp = int(_affine(v1["temp_bytes"], v2["temp_bytes"], U))
        rec["mem"] = {
            "argument_bytes": args_full,
            "output_bytes": int(_affine(v1["output_bytes"], v2["output_bytes"], U)),
            "temp_bytes": temp,
            "alias_bytes": int(_affine(v1["alias_bytes"], v2["alias_bytes"], U)),
            "peak_bytes": args_full + temp,
            "resident_bytes": args_full + temp,
        }
        rec["fits_hbm"] = bool(args_full + temp <= HW.HBM_BYTES)
        rec["status"] = "ok"
        flops_dev = sum(flops.values())
        bytes_dev = _affine(v1["bytes"], v2["bytes"], U)
        rec["flops_by_dtype"] = flops
        rec["flops_per_dev"] = flops_dev
        rec["bytes_per_dev"] = bytes_dev
        rec["ops"] = int(_affine(v1["ops"], v2["ops"], U))
        rec["kernel_calls"] = {k: int(_affine(v1["kernel_calls"].get(k, 0), v2["kernel_calls"].get(k, 0), U))
                               for k in sorted(set(v1["kernel_calls"]) | set(v2["kernel_calls"]))}
        rec["collectives"] = {}
        rec["collective_bytes"] = 0.0
        terms = {"compute_s": compute_seconds(flops), "memory_s": bytes_dev / HW.HBM_BW, "collective_s": 0.0}
        rec["terms"] = terms
        rec["dominant"] = max(terms, key=terms.get)
        rec["useful_flops_ratio"] = float(mf / flops_dev) if flops_dev else None
    except Exception as e:  # noqa: BLE001 — every failure is a bug report
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-3000:]
    return rec


def _line(tag: str, rec: Dict[str, Any]) -> str:
    status = rec["status"]
    extra = ""
    if status == "ok":
        extra = f" resident={rec['mem']['resident_bytes'] / 2**30:.2f}GiB fits={rec['fits_hbm']}"
        if "terms" in rec:
            t = rec["terms"]
            extra += (f" comp={t['compute_s'] * 1e3:.2f}ms mem={t['memory_s'] * 1e3:.2f}ms"
                      f" dom={rec['dominant']} trace={rec['trace_s']:.1f}s")
    elif status == "error":
        extra = " " + rec["error"][:120]
    elif status == "skipped":
        extra = " " + rec["reason"][:60]
    return f"[{status:>7}] {tag}{extra}"


def _run_and_write(a: str, s: str, path: str) -> Dict[str, Any]:
    rec = run_cell(a, s)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1, default=str)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--resume", action="store_true",
                    help="skip cells whose output JSON already exists and is ok")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if args.arch == "all" else [args.arch]
    shapes = [s.name for s in SHAPES] if args.shape == "all" else [args.shape]
    if args.list:
        for a in archs:
            for s in shapes:
                print(a, s)
        return 0
    if args.mesh != "single":
        print("--mesh multi|both: the reference's 2x16x16 mesh of two TPU pods has no counterpart on one card; "
              "the port's dry run has the one-card mesh only (--mesh single)", file=sys.stderr)
        return 2

    os.makedirs(args.out, exist_ok=True)
    todo = []
    for a in archs:
        for s in shapes:
            tag = f"{a}_{s}_single"
            path = os.path.join(args.out, tag + ".json")
            if args.resume and os.path.exists(path):
                try:
                    with open(path) as f:
                        prev = json.load(f)
                    if prev.get("status") == "skipped" or (prev.get("status") == "ok" and "terms" in prev):
                        print(f"[ resume] {tag}", flush=True)
                        continue
                except (OSError, ValueError):
                    pass
            todo.append((a, s, tag, path))
    failures = 0
    jobs = min(len(todo), os.cpu_count() or 1)
    if jobs > 1:  # one process a cell: a trace runs on one core
        with ProcessPoolExecutor(max_workers=jobs) as pool:
            futs = [(tag, pool.submit(_run_and_write, a, s, path)) for a, s, tag, path in todo]
            for tag, fut in futs:
                rec = fut.result()
                failures += rec["status"] == "error"
                print(_line(tag, rec), flush=True)
    else:
        for a, s, tag, path in todo:
            rec = _run_and_write(a, s, path)
            failures += rec["status"] == "error"
            print(_line(tag, rec), flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
