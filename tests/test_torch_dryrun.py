"""The port's dry run (``repro_torch.launch.dryrun``) against the
reference's (``repro.launch.dryrun``).

The reference's module sets ``XLA_FLAGS`` to 512 host devices when it is
imported, which would leak into every other test of a shared worker, so
its side runs in a subprocess (``_REF_SCRIPT``): for every (arch x shape)
cell it gives the skip reason, the arguments of the step it lowers (each
leaf's path, shape, dtype and partition spec on its 16x16 production
mesh), their bytes, the parameter counts and the model FLOPs.  The port's
specs must equal them leaf for leaf (its per-layer caches stacked into the
reference's units), its specs on a 16x16 mesh descriptor give the same
partition specs, and the counts are equal.

Then the port's own contracts: the cost model's affine extrapolation in
units equals a direct trace at three units, exactly for FLOPs and bytes;
a trace launches no kernel and builds nothing; ``--list`` is the
reference's; a few full-size cells end ``ok`` here, without a card, with
the reference's record keys.
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import _build
from repro_torch.configs import ARCH_IDS, SHAPES, ShapeSpec, get_config, get_smoke_config
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels.matmul_update import matmul_update_cuda
from repro_torch.kernels.rglru import rglru_scan_cuda
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import HW, Mesh

ROOT = pathlib.Path(__file__).resolve().parents[1]
CELLS = [(a, s.name) for a in ARCH_IDS for s in SHAPES]

_REF_SCRIPT = r"""
import contextlib, io, json, sys
import numpy as np
import jax
from repro.launch import dryrun as D
from repro.configs import ARCH_IDS, SHAPES, get_config, shape_applicable
from repro.nn.params import param_count
from repro.runtime.train_loop import model_spec_for

def key(p):
    for a in ("key", "idx", "name"):
        if hasattr(p, a):
            return str(getattr(p, a))
    return str(p)

def spec(x):
    return [list(e) if isinstance(e, tuple) else e for e in tuple(x.sharding.spec)]

mesh = D.make_production_mesh(multi_pod=False)
out = {"cells": {}}
for a in ARCH_IDS:
    cfg = get_config(a)
    for s in SHAPES:
        rec = {"skip": shape_applicable(cfg, s)}
        if rec["skip"] is None:
            fn, args, _ = D.build_step(cfg, s, mesh)
            leaves = jax.tree_util.tree_flatten_with_path(args)[0]
            rec["leaves"] = {"/".join(key(p) for p in path): [list(x.shape), np.dtype(x.dtype).name, spec(x)]
                             for path, x in leaves}
            rec["arg_bytes"] = int(sum(int(np.prod(x.shape)) * np.dtype(x.dtype).itemsize for _, x in leaves))
            n_active = D.active_param_count(cfg)
            tokens = s.global_batch * (s.seq_len if s.kind != "decode" else 1)
            rec["params_total"] = int(param_count(model_spec_for(cfg)))
            rec["params_active"] = int(n_active)
            rec["model_flops"] = float((6 if s.kind == "train" else 2) * n_active * tokens)
        out["cells"][a + "|" + s.name] = rec
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    D.main(["--list"])
out["list"] = buf.getvalue()
json.dump(out, sys.stdout)
"""


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", _REF_SCRIPT], env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout)


def _mesh16() -> Mesh:
    """A 16x16 ("data", "model") mesh descriptor (no devices behind it)."""
    return Mesh(("data", "model"), np.zeros((16, 16), dtype=np.int64), torch.device("cuda", 0))


def _walk(tree, path=()):
    """``(path, TensorSpec)`` of a tree of specs, NamedTuple fields by name."""
    if isinstance(tree, dryrun.TensorSpec):
        yield path, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, path + (str(k),))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for f, v in zip(tree._fields, tree):
            yield from _walk(v, path + (f,))
    else:
        for i, v in enumerate(tree):
            yield from _walk(v, path + (str(i),))


def _ref_cache_path(cfg, path):
    """The reference's path of a port cache leaf, and the unit it stacks
    into (None for an unstacked prefix layer)."""
    n_pre, P = len(cfg.prefix), len(cfg.pattern)
    if cfg.is_encdec:
        group, i, rest = path[0], int(path[1]), path[2:]
        name = "units" if group == "layers" else "cross_kv"
        return (name, str(i % P)) + rest, i // P
    i, rest = int(path[0]), path[1:]
    if i < n_pre:
        return ("prefix", str(i)) + rest, None
    return ("units", str((i - n_pre) % P)) + rest, (i - n_pre) // P


def _dtype(dt) -> str:
    return str(dt).replace("torch.", "")


def _norm_spec(spec):
    out = [tuple(e) if isinstance(e, list) else e for e in spec]
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


@pytest.mark.parametrize("arch,shape", CELLS)
def test_specs_bytes_and_counts_equal_the_reference(reference, arch, shape):
    want = reference["cells"][f"{arch}|{shape}"]
    rec = dryrun.run_cell(arch, shape, costs=False)
    if want["skip"] is not None:
        assert rec["status"] == "skipped" and rec["reason"] == want["skip"]
        return
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["params_total"] == want["params_total"]
    assert rec["params_active"] == want["params_active"]
    assert rec["model_flops_total"] == want["model_flops"]
    assert rec["mem"]["argument_bytes"] == want["arg_bytes"]

    cfg = get_config(arch)
    spec_shape = next(s for s in SHAPES if s.name == shape)
    _, args = dryrun.build_step(cfg, spec_shape, _mesh16())
    assert dryrun.argument_bytes(args) == want["arg_bytes"]
    got, stacked = {}, {}
    cache_arg = str(len(args) - 1) if spec_shape.kind != "train" else None
    for path, leaf in _walk(args):
        entry = [list(leaf.shape), _dtype(leaf.dtype), _norm_spec(leaf.sharding.spec)]
        if path[0] == cache_arg:
            rpath, unit = _ref_cache_path(cfg, path[1:])
            rpath = "/".join((cache_arg,) + rpath)
            if unit is not None:
                stacked.setdefault(rpath, []).append((unit, entry))
                continue
            got[rpath] = entry
        else:
            got["/".join(path)] = entry
    for rpath, units in stacked.items():
        units.sort(key=lambda x: x[0])
        assert [u for u, _ in units] == list(range(len(units))), rpath
        shapes = {tuple(e[0]) for _, e in units}
        dtypes = {e[1] for _, e in units}
        specs = {e[2] for _, e in units}
        assert len(shapes) == len(dtypes) == len(specs) == 1, rpath
        spec_ = specs.pop()
        got[rpath] = [[len(units)] + list(shapes.pop()), dtypes.pop(), (None,) + spec_ if spec_ else ()]
    ref = {p: [v[0], v[1], _norm_spec(v[2])] for p, v in want["leaves"].items()}
    assert got.keys() == ref.keys()
    for p in ref:
        assert got[p][:2] == ref[p][:2], p  # shape and dtype
        assert got[p][2] == ref[p][2], p  # partition spec on the 16x16 mesh


def test_list_matches_the_reference(reference, capsys):
    assert dryrun.main(["--list"]) == 0
    assert capsys.readouterr().out == reference["list"]


def _cost(cfg, shape):
    mesh = Mesh(("data", "model"), np.zeros((1, 1), dtype=np.int64), torch.device("cuda", 0))
    return {u: dryrun.trace_variant(dryrun.reduced_units(cfg, u).replace(scan_layers=False, unroll_scans=True),
                                    shape, mesh) for u in (1, 2, 3)}


SMALL = {"train": ShapeSpec("t", 64, 4, "train"), "prefill": ShapeSpec("p", 64, 2, "prefill"),
         "decode": ShapeSpec("d", 64, 2, "decode")}


@pytest.mark.parametrize("kind", sorted(SMALL))
@pytest.mark.parametrize("arch", ["gemma2-2b", "recurrentgemma-2b", "granite-moe-1b-a400m", "seamless-m4t-medium"])
def test_affine_extrapolation_equals_a_direct_trace(arch, kind):
    """cost(3) = a + 3 b from the 1- and 2-unit traces, exactly for FLOPs
    and bytes (a smoke config with the full config's remat)."""
    cfg = get_smoke_config(arch).replace(remat="full", train_accum=2, xent_chunk=16)
    c = _cost(cfg, SMALL[kind])
    for dt in set(c[1]["flops"]) | set(c[3]["flops"]):
        f1, f2, f3 = (c[u]["flops"].get(dt, 0.0) for u in (1, 2, 3))
        assert dryrun._affine(f1, f2, 3) == f3, dt
    assert dryrun._affine(c[1]["bytes"], c[2]["bytes"], 3) == c[3]["bytes"]
    assert c[1]["bytes"] < c[2]["bytes"] < c[3]["bytes"]
    assert c[1]["argument_bytes"] < c[2]["argument_bytes"] < c[3]["argument_bytes"]


def test_a_trace_launches_nothing_and_builds_nothing(monkeypatch):
    """The kernels' custom operators are traced (their calls counted) but
    never run: no launch counter moves, ``_build`` is never reached."""

    def refuse(*a, **k):
        raise AssertionError("a trace reached the kernel build")

    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(_build, "build", refuse)
    before = (flash_attention_cuda.launches, dict(flash_attention_cuda.launches_by_route),
              rglru_scan_cuda.launches, matmul_update_cuda.launches)
    cfg = get_smoke_config("recurrentgemma-2b").replace(remat="full")
    calls = {}
    for kind in ("train", "prefill"):
        c = _cost(cfg, SMALL[kind])[1]
        for k, v in c["kernel_calls"].items():
            calls[(kind, k)] = v
    after = (flash_attention_cuda.launches, dict(flash_attention_cuda.launches_by_route),
             rglru_scan_cuda.launches, matmul_update_cuda.launches)
    assert after == before
    # one local-attention layer and two recurrent layers at one unit: the
    # forward, again in the remat, and the scan's reversed recurrence
    assert calls[("prefill", "flash_attention")] == 1 and calls[("prefill", "rglru_scan")] == 4
    assert calls[("train", "flash_attention")] == 2 and calls[("train", "rglru_scan")] == 12


_REF_KEYS = {  # a successful single-pod record of src/repro/launch/dryrun.py:run_cell
    "arch", "shape", "mesh", "status", "mem", "fits_hbm", "cost_model", "flops_per_dev", "bytes_per_dev",
    "collectives", "collective_bytes", "terms", "dominant", "model_flops_total", "model_flops_per_dev",
    "useful_flops_ratio", "params_total", "params_active",
}
_REF_MEM = {"argument_bytes", "output_bytes", "temp_bytes", "alias_bytes", "peak_bytes", "resident_bytes"}


def test_full_size_cells_end_ok_without_a_card(tmp_path):
    """The CLI on gemma2-2b decode_32k writes an ``ok`` record with the
    reference's keys (``trace_s`` for ``lower_s`` / ``compile_s``); two
    more full-size cells end ``ok``; the sub-quadratic xLSTM fits the card
    at decode_32k, gemma2-2b's 32k caches for 128 sequences do not."""
    assert dryrun.main(["--arch", "gemma2-2b", "--shape", "decode_32k", "--out", str(tmp_path)]) == 0
    rec = json.loads((tmp_path / "gemma2-2b_decode_32k_single.json").read_text())
    assert rec["status"] == "ok" and rec["mesh"] == "1x1"
    assert _REF_KEYS | {"trace_s"} <= set(rec) and "lower_s" not in rec
    assert set(rec["mem"]) == _REF_MEM
    assert rec["collectives"] == {} and rec["collective_bytes"] == 0 and rec["terms"]["collective_s"] == 0
    assert rec["fits_hbm"] is False and rec["mem"]["resident_bytes"] > HW.HBM_BYTES
    assert rec["dominant"] == "memory_s"
    assert rec["cost_model"]["u1"]["kernel_calls"] == {}  # decode runs no kernel
    for arch, shape in (("xlstm-350m", "decode_32k"), ("recurrentgemma-2b", "long_500k")):
        r = dryrun.run_cell(arch, shape)
        assert r["status"] == "ok", r.get("traceback")
        assert r["mem"]["resident_bytes"] == r["mem"]["argument_bytes"] + r["mem"]["temp_bytes"]
        assert r["terms"]["compute_s"] > 0 and r["terms"]["memory_s"] > 0
    assert dryrun.run_cell("xlstm-350m", "decode_32k")["fits_hbm"] is True
    assert dryrun.main(["--mesh", "multi", "--out", str(tmp_path)]) == 2


def test_counter_rules_on_single_ops():
    """The counter's rules: a matmul's FLOPs under its dtype; views move
    nothing; an in-place copy reads and writes its source's bytes; a new
    storage counts until it dies."""
    x = torch.empty(64, 32, device="meta")
    w = torch.empty(32, 16, dtype=torch.bfloat16, device="meta")
    with dryrun.CostCounter([x]) as c:
        y = x.to(torch.bfloat16) @ w
        assert c.flops == {"bfloat16": 2 * 64 * 32 * 16}
        b = c.bytes
        x.view(32, 64).t()
        assert c.bytes == b
        x[:8].copy_(torch.empty(8, 32, device="meta"))
        assert c.bytes == b + 2 * 8 * 32 * 4
        live = c.live
        del y
        assert c.live == live - 64 * 16 * 2
    assert c.ops > 0
