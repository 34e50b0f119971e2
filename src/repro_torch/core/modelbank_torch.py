"""The device bank of the port: the padded FPM bank as torch tensors.

``TorchModelBank`` holds the same padded ``xs[..., p, k]`` / ``ss[..., p, k]``
/ ``counts[..., p]`` layout as the host :class:`~.modelbank.ModelBank`, on a
torch device, with any number of leading batch dims.  Every partitioning
step of the paper's loop runs on that device as torch tensor programs:

  * the ``t*`` search of the geometric partitioner — masked doubling (at
    most 200 steps) and a bisection whose early exit fires after the update,
    per batch lane, then the proportional excess rescale;
  * the integer partition — floor, ``min_units`` take-back in the stable
    descending per-unit-time order, the threshold-count bulk grant for
    monotone-time banks, and the exact greedy completion as a masked
    lexicographic argmin over ``(time(d+1), -frac_remainder, index)``;
  * ``fold_in`` — the vectorized sorted insert of one observation per row
    (``PiecewiseLinearFPM.add_point`` semantics, duplicates replace), so the
    DFPA loop keeps the bank as a device-resident carry across rounds.

Numerical contract.  In float64 the allocations and ``t*`` are bit-identical
to the host numpy bank, on the CPU and on CUDA.  Two things make that hold:

  * every float64 expression is written as the same sequence of single
    torch ops as the numpy code (eager torch launches one kernel per op, so
    nothing contracts ``1 - t*m`` or ``s0 - m*x0`` into an FMA);
  * every float sum that decides a comparison (``total_alloc`` in the
    bisections, the excess rescale) is taken in numpy's own order by
    :func:`np_order_sum` — numpy reduces a contiguous row block by block
    (8192 elements in numpy 2.0; the block size is observed once from the
    installed numpy), each block by pairwise summation over leaves of at
    most 128 elements with eight interleaved accumulators.  ``torch.sum`` takes
    another order on either device, and one ULP moves a boundary unit at
    fleet scale.

Integer sums (unit counts) are exact and use ``torch.sum``.

Two more uses serve the two-level partitioner (``core/hierarchy.py``):
``_agg_alloc`` evaluates every group's member allocations at the group's
sample times (the device half of the group aggregation), and the inner
solves run as one stacked ``[g, p_max, k]`` partition whose float sums
follow each group's own row length (:func:`ragged_order_sum`).

The loops that the reference runs as device ``while_loop``s are Python loops
over tensor ops here.  ``partition_units`` runs them in one of two forms:

  * the sync program (``defer=False``): the doubling and bisection loops
    read their exit condition back from the device once per step, and the
    greedy completion reads its leftover count once and then runs that many
    masked steps without further reads;
  * the deferred program (``defer=True``, :func:`_partition_units_fixed`):
    every loop runs a count fixed on the host — the doubling's 200, the
    bisections' ``max_steps``, the take-back's bit length from the host
    caps, and a host bound on the greedy's leftover — with finished lanes
    masked so that the extra steps are exact no-ops, and the ``"auto"``
    completion routing is a boolean mask computed on the device.  Nothing
    is read back until :func:`fetch_partition`, so the whole solve is
    queued on the device and left there (the fleet's pipelined rounds
    overlap it with the host's bookkeeping).  Its allocations and ``t*``
    are bit-identical to the sync program's.  To keep the launch count
    down, it evaluates several steps of a loop in one pass where the
    later steps' inputs are known in advance: eight doublings per pass,
    four bisection levels per pass (the 15 midpoints of the next four
    steps' binary tree), and the greedy's next-unit times in tables of 16
    units per row.  On the card the program is replayed as a CUDA graph
    from a shape's second call (:class:`_GraphedSolve`): eager, its many
    small kernels would keep the host busy for as long as the card.

The device is explicit: constructors take ``device=`` (default ``"cuda"``)
and raise when CUDA is requested but not available; the CPU is used only
when the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import functools
from collections import OrderedDict
from dataclasses import dataclass
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .modelbank import ModelBank

__all__ = [
    "DeferredPartition",
    "TorchModelBank",
    "fetch_partition",
    "np_order_sum",
    "numpy_sum_block",
    "ragged_order_sum",
    "resolve_device",
    "torch_dtype",
]

def resolve_device(device) -> torch.device:
    """``torch.device(device)``, refusing CUDA when no CUDA device exists —
    the port never carries on silently on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the host"
        )
    return dev


def torch_dtype(dtype) -> torch.dtype:
    """The bank's float dtype: a torch dtype, a numpy dtype or its name
    (``None`` means float64, the dtype of the bit-parity contract)."""
    if dtype is None:
        return torch.float64
    if isinstance(dtype, torch.dtype):
        return dtype
    name = np.dtype(dtype).name
    if name not in ("float64", "float32"):
        raise ValueError(f"unsupported bank dtype {name!r}")
    return getattr(torch, name)


# ---------------------------------------------------------------------------
# numpy's float summation order
# ---------------------------------------------------------------------------

_NP_PW_BLOCK = 128  # pairwise-summation leaf size (numpy's PW_BLOCKSIZE)
# Candidate sizes of the blocks numpy's iterator hands its reduction loop
# (``None``: the whole row in one call).  numpy 2.0 hands 8192-element
# blocks (its buffer size) even where nothing is buffered; later versions
# may hand the whole row.  :func:`numpy_sum_block` observes which one runs.
_NP_BLOCK_CANDIDATES = (8192, 16384, 32768, 65536, 131072, 262144, 524288, 1048576, None)


@functools.lru_cache(maxsize=64)
def _np_sum_plan(n: int, block: Optional[int]):
    """Host plan of numpy's summation tree for a row of ``n > 0`` elements
    reduced in ``block``-element blocks (``None``: one block).

    Returns ``(main, tail, levels, roots)``: gather indices of every leaf's
    eight-accumulator blocks ``[leaves, blocks, 8]`` and of its sequential
    tail ``[leaves, 7]`` (index ``n`` is a ``-0.0`` pad, the exact identity of
    IEEE addition; index ``n + 1`` a ``+0.0`` start for leaves under 8
    elements, which numpy sums from ``0.0``), the pairwise combine levels as
    ``(left_ids, right_ids)`` into the growing vector of node values, and the
    root node of every block in order.
    """
    leaves: List[Tuple[int, int]] = []
    inner: List[Tuple[tuple, tuple, int]] = []

    def build(start: int, length: int):
        if length <= _NP_PW_BLOCK:
            leaves.append((start, length))
            return ("leaf", len(leaves) - 1), 0
        n2 = length // 2
        n2 -= n2 % 8
        left, hl = build(start, n2)
        right, hr = build(start + n2, length - n2)
        h = max(hl, hr) + 1
        inner.append((left, right, h))
        return ("inner", len(inner) - 1), h

    step = block or n
    roots = [build(c, min(step, n - c))[0] for c in range(0, n, step)]

    nl = len(leaves)
    order = sorted(range(len(inner)), key=lambda j: (inner[j][2], j))
    final = {j: nl + r for r, j in enumerate(order)}

    def node_id(ref) -> int:
        kind, j = ref
        return j if kind == "leaf" else final[j]

    levels = []
    for h in sorted({h for _, _, h in inner}):
        js = [j for j in order if inner[j][2] == h]
        levels.append(
            (
                np.array([node_id(inner[j][0]) for j in js], dtype=np.int64),
                np.array([node_id(inner[j][1]) for j in js], dtype=np.int64),
            )
        )

    starts = np.array([st for st, _ in leaves], dtype=np.int64)
    lengths = np.array([ln for _, ln in leaves], dtype=np.int64)
    blocks = max(int(lengths.max()) // 8, 1)
    m = lengths - lengths % 8  # the eight-accumulator part of each leaf
    pos = np.arange(blocks * 8).reshape(blocks, 8)
    main = np.where(pos < m[:, None, None], starts[:, None, None] + pos, n)
    short = lengths < 8
    main[short, 0, :] = n + 1
    t = np.arange(7)
    tail = np.where(t < (lengths - m)[:, None], (starts + m)[:, None] + t, n)
    return main, tail, levels, [node_id(r) for r in roots]


def upload(v, device: torch.device, dtype=None) -> torch.Tensor:
    """Host data on ``device``.  A CUDA upload goes through pinned memory
    without blocking the host, so it is legal inside a queued solve (under
    ``torch.cuda.set_sync_debug_mode("error")`` and in stream order)."""
    t = torch.as_tensor(np.array(v), dtype=dtype)
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


@functools.lru_cache(maxsize=64)
def _np_sum_plan_on(n: int, block: Optional[int], device: torch.device):
    main, tail, levels, roots = _np_sum_plan(n, block)
    put = functools.partial(upload, device=device)
    used_tail = int((tail != n).sum(axis=0).nonzero()[0].max(initial=-1)) + 1
    return (
        put(main),
        put(tail[:, :used_tail]),
        [(put(lft), put(rgt)) for lft, rgt in levels],
        roots,
    )


@functools.lru_cache(maxsize=None)
def numpy_sum_block() -> Optional[int]:
    """The block size the installed numpy reduces a float64 row in,
    observed once: emulate every candidate on random rows longer than the
    largest candidate block and keep those that equal ``np.sum``, until one
    is left.  The rows mix small integers with a few huge ones (so a unit
    is absorbed or kept depending on when it meets them) and a heavy-tailed
    spread; two summation trees rarely agree on both kinds."""
    rng = np.random.default_rng(8192)
    n = (1 << 21) + 4321
    left = list(_NP_BLOCK_CANDIDATES)
    for trial in range(8):
        if trial % 2:
            row = rng.standard_normal(n) * np.exp(rng.uniform(0.0, 30.0, n))
        else:
            row = rng.integers(1, 4, n).astype(np.float64)
            big = rng.random(n) < 0.02
            row[big] = rng.choice([-1.0, 1.0], int(big.sum())) * 2.0 ** rng.integers(52, 56, int(big.sum()))
        want = float(np.sum(row))
        x = torch.from_numpy(row)
        left = [b for b in left if float(_plan_sum(x, b)) == want]
        if len(left) <= 1:
            break
    _np_sum_plan.cache_clear()  # the probe rows' plans are large and never reused
    _np_sum_plan_on.cache_clear()
    if len(left) != 1:
        raise RuntimeError(
            f"numpy {np.__version__} sums float64 rows in an order this module does "
            f"not single out (candidates left: {left}); the device bank cannot be "
            "bit-identical to it"
        )
    return left[0]


def np_order_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last dim in exactly numpy's order (see the module
    docstring), so a float64 reduction on any device equals
    ``np.sum(row)`` bit for bit."""
    return _plan_sum(x, numpy_sum_block())


def ragged_order_sum(lens: Sequence[int], device) -> Callable[[torch.Tensor], torch.Tensor]:
    """A row sum for ``[g, p_max]`` lanes whose row ``i`` holds only its
    first ``lens[i]`` elements (the rest are padding): lane ``i`` is summed
    over its first ``lens[i]`` elements in numpy's order for a row of that
    length, so it equals ``np.sum`` of the unpadded row bit for bit.
    Zero padding alone would not do: numpy's pairwise tree depends on the
    row length, and a longer row associates the same values differently.
    Lanes of one length share one :func:`np_order_sum` call."""
    lens = [int(v) for v in lens]
    width = max(lens, default=0)
    if all(v == width for v in lens):
        return np_order_sum
    by_len = {}
    for i, v in enumerate(lens):
        by_len.setdefault(v, []).append(i)
    parts = [(torch.as_tensor(idx, device=device), v) for v, idx in by_len.items()]

    def row_sum(x: torch.Tensor) -> torch.Tensor:
        out = x.new_zeros(x.shape[:-1])
        for idx, v in parts:
            out = out.index_copy(0, idx, np_order_sum(x[idx, :v]))
        return out

    return row_sum


def _plan_sum(x: torch.Tensor, block: Optional[int]) -> torch.Tensor:
    n = x.shape[-1]
    batch = x.shape[:-1]
    if n == 0:
        return x.new_zeros(batch)
    main, tail, levels, roots = _np_sum_plan_on(n, block, x.device)
    ext = torch.cat([x, x.new_full((*batch, 1), -0.0), x.new_zeros((*batch, 1))], dim=-1)
    blocks = ext[..., main]  # [..., leaves, blocks, 8]
    r = blocks[..., 0, :]
    for b in range(1, blocks.shape[-2]):
        r = r + blocks[..., b, :]
    pair = r[..., 0::2] + r[..., 1::2]  # (r0+r1), (r2+r3), (r4+r5), (r6+r7)
    quad = pair[..., 0::2] + pair[..., 1::2]
    res = quad[..., 0] + quad[..., 1]
    if tail.shape[-1]:
        rest = ext[..., tail]  # [..., leaves, tail]
        for t in range(rest.shape[-1]):
            res = res + rest[..., t]
    vals = res
    for lft, rgt in levels:
        vals = torch.cat([vals, vals[..., lft] + vals[..., rgt]], dim=-1)
    acc = x.new_zeros(batch)
    for root in roots:
        acc = acc + vals[..., root]
    return acc


# ---------------------------------------------------------------------------
# Batched model queries (leading batch dims allowed: [..., p, k])
# ---------------------------------------------------------------------------


def _take(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``a[..., idx]`` with one index per leading position (take_along_axis)."""
    return torch.gather(a, -1, idx.unsqueeze(-1)).squeeze(-1)


def _edges(xs, ss, counts):
    last = torch.clamp(counts - 1, min=0)
    return xs[..., 0], ss[..., 0], _take(xs, last), _take(ss, last)


def _speed(xs, ss, counts, x):
    """Mirror of ``ModelBank.speed`` (NaN on empty rows)."""
    first_x, first_s, last_x, last_s = _edges(xs, ss, counts)
    k = (xs <= x.unsqueeze(-1)).sum(dim=-1) - 1
    k = torch.minimum(torch.clamp(k, min=0), torch.clamp(counts - 2, min=0))
    kp1 = torch.clamp(k + 1, max=xs.shape[-1] - 1)
    x0, x1 = _take(xs, k), _take(xs, kp1)
    s0, s1 = _take(ss, k), _take(ss, kp1)
    denom = torch.where(x1 > x0, x1 - x0, 1.0)
    w = (x - x0) / denom
    interior = s0 + w * (s1 - s0)
    s = torch.where(x <= first_x, first_s, torch.where(x >= last_x, last_s, interior))
    return torch.where(counts > 0, s, float("nan"))


def _time(xs, ss, counts, x):
    return torch.where(x > 0.0, x / _speed(xs, ss, counts, x), 0.0)


def _alloc_at_time(xs, ss, counts, t, caps):
    """Mirror of ``ModelBank.alloc_at_time``; ``t`` has the batch shape
    (0-d for a single bank, ``[q]`` for a stacked one)."""
    tb = t.unsqueeze(-1)  # broadcast against [..., p]
    first_x, first_s, last_x, last_s = _edges(xs, ss, counts)

    # Region [0, x_1]: constant speed ss[..., 0].
    best = torch.minimum(tb * first_s, torch.minimum(first_x, caps))

    # Interior segments, all at once (static branch on the padded width).
    k_max = xs.shape[-1]
    if k_max >= 2:
        x0, x1 = xs[..., :-1], xs[..., 1:]
        s0, s1 = ss[..., :-1], ss[..., 1:]
        seg = torch.arange(k_max - 1, device=xs.device)
        valid = (
            (seg < (counts - 1).unsqueeze(-1))
            & (x0 < caps.unsqueeze(-1))
            & (x1 > x0)
        )
        x1c = torch.minimum(x1, caps.unsqueeze(-1))
        denom = torch.where(x1 > x0, x1 - x0, 1.0)
        m = (s1 - s0) / denom
        tseg = tb.unsqueeze(-1)  # against [..., p, k-1]
        a = 1.0 - tseg * m
        b = tseg * (s0 - m * x0)
        ub = b / torch.where(a != 0.0, a, 1.0)
        cand = torch.where(
            a > 0.0,
            torch.where(ub >= x0, torch.minimum(ub, x1c), 0.0),
            torch.where(
                a == 0.0,
                torch.where(b >= 0.0, x1c, 0.0),
                torch.where(x1c >= ub, x1c, 0.0),
            ),
        )
        cand = torch.where(valid, cand, 0.0)
        best = torch.maximum(best, cand.amax(dim=-1))

    # Region [x_m, cap]: constant speed at the last observed point.
    ub_r = tb * last_s
    right = (caps > last_x) & (ub_r >= last_x) & (counts > 0)
    best = torch.maximum(best, torch.where(right, torch.minimum(ub_r, caps), 0.0))

    best = torch.where((caps > 0.0) & (counts > 0), best, 0.0)
    return torch.where(tb > 0.0, best, 0.0)


def _total_alloc(xs, ss, counts, t, caps, row_sum=np_order_sum):
    return row_sum(_alloc_at_time(xs, ss, counts, t, caps))


# ---------------------------------------------------------------------------
# Group aggregation on the device (core/hierarchy.py)
# ---------------------------------------------------------------------------


def _agg_alloc(xs, ss, counts, caps, ts):
    """Member allocations at per-group sample times: ``[g, p, k]`` bank
    blocks at ``[g, T]`` times give ``[g, T, p]``.  One
    :func:`_alloc_at_time` over the blocks broadcast as ``[g, 1, p, k]``
    against ``[g, T, 1]`` times, so each element is bitwise the host
    ``_alloc_at_times`` pass: eager torch rounds ``t*m`` and ``m*x0`` as
    tensors of their own before anything subtracts them, so nothing
    contracts them into an FMA.  This function must never run under
    ``torch.compile``.  The per-group member sum runs back on the host,
    over the same axis as the host pass, so the aggregate bank equals the
    numpy backend's."""
    return _alloc_at_time(
        xs[:, None], ss[:, None], counts[:, None], ts, caps[:, None]
    )


def _monotone_lanes(xs, ss, counts):
    """Device mirror of ``modelbank._monotone_check``, one bool per leading
    batch element (0-d for a plain ``[p, k]`` bank)."""
    k = xs.shape[-1]
    j = torch.arange(k, device=xs.device)
    pts = j < counts.unsqueeze(-1)
    ok_pts = (xs > 0.0) & torch.isfinite(xs) & (ss > 0.0) & torch.isfinite(ss)
    ok = ~(pts & ~ok_pts).flatten(-2).any(dim=-1)
    if k >= 2:
        x0, x1 = xs[..., :-1], xs[..., 1:]
        s0, s1 = ss[..., :-1], ss[..., 1:]
        seg = j[:-1] < (counts - 1).unsqueeze(-1)
        ok_seg = (x1 >= x0) & (x0 * s1 <= x1 * s0)
        ok = ok & ~(seg & ~ok_seg).flatten(-2).any(dim=-1)
    return ok


# ---------------------------------------------------------------------------
# t* search: masked doubling + bisection with an after-update early exit
# ---------------------------------------------------------------------------


_DOUBLING_STEPS = 200  # the doubling loops' step limit
_DOUBLING_CHUNK = 8  # deferred program: doublings evaluated per pass (divides 200)
_BISECT_LEVELS = 4  # deferred program: bisection steps resolved per pass
_GREEDY_WINDOW = 16  # deferred program: greedy steps per table of next-unit times


def _double_fixed(hi, need_at):
    """The early-exit doubling ``while need(hi): hi *= 2`` (at most
    ``_DOUBLING_STEPS`` times, per lane) with no read: ``hi * 2**m``, ``m``
    the first ``j < _DOUBLING_STEPS`` with ``not need_at(hi * 2**j)``.  Each
    pass evaluates ``need_at`` on the next ``_DOUBLING_CHUNK`` candidates at
    once (a leading dim), each one the previous doubled, as the loop
    computes them; a lane whose need has ended keeps its ``hi`` through the
    later passes."""
    chunk = _DOUBLING_CHUNK
    for _ in range(_DOUBLING_STEPS // chunk):  # 200 doublings, 25 passes
        cands = [hi]
        for _ in range(chunk - 1):
            cands.append(cands[-1] * 2.0)
        c = torch.stack(cands)
        run = (~need_at(c)).to(torch.int64).cumsum(dim=0).eq(0).sum(dim=0)  # leading needs
        pick = torch.gather(c, 0, torch.clamp(run, max=chunk - 1).unsqueeze(0)).squeeze(0)
        hi = torch.where(run == chunk, cands[-1] * 2.0, pick)
    return hi


def _bisect_fixed(lo, hi, done, ge_at, rel_tol, steps: int):
    """``steps`` steps of the masked bisection with its after-update exit
    (``done`` lanes keep ``lo``/``hi``), with no read.  A pass resolves
    ``_BISECT_LEVELS`` steps: it builds the binary tree of the midpoints the
    next steps can visit (node ``j``'s children are ``(lo_j, mid_j)`` and
    ``(mid_j, hi_j)``, each midpoint computed as the step computes it),
    evaluates ``ge_at`` on all of them at once, and walks the tree."""
    for s in range(0, steps, _BISECT_LEVELS):
        levels = min(_BISECT_LEVELS, steps - s)
        los, his, mids = lo.unsqueeze(0), hi.unsqueeze(0), []
        for lvl in range(levels):
            mid = 0.5 * (los + his)
            mids.append(mid)
            if lvl + 1 < levels:
                los = torch.stack([los, mid], dim=1).flatten(0, 1)
                his = torch.stack([mid, his], dim=1).flatten(0, 1)
        ge_all = ge_at(torch.cat(mids))
        node = torch.zeros(lo.shape, dtype=torch.int64, device=lo.device)
        for lvl in range(levels):
            at = node.unsqueeze(0)
            mid = torch.gather(mids[lvl], 0, at).squeeze(0)
            ge = torch.gather(ge_all[(1 << lvl) - 1:(2 << lvl) - 1], 0, at).squeeze(0)
            hi2 = torch.where(~done & ge, mid, hi)
            lo2 = torch.where(~done & ~ge, mid, lo)
            done = done | (hi2 - lo2 <= rel_tol * hi2)
            lo, hi = lo2, hi2
            node = 2 * node + (~ge).to(torch.int64)
    return lo, hi, done


def _partition_continuous(
    xs, ss, counts, caps, n, rel_tol, max_steps, row_sum=np_order_sum, fixed=False,
):
    active = caps > 0.0

    # Exponential search for an upper bound on t* (per batch element).
    t_init = _time(xs, ss, counts, torch.clamp(caps, max=1.0))
    hi = torch.where(active, t_init, float("-inf")).amax(dim=-1)
    hi = torch.clamp(torch.clamp(hi, min=0.0), min=1e-9)
    if fixed:
        hi = _double_fixed(hi, lambda t: _total_alloc(xs, ss, counts, t, caps, row_sum) < n)
    else:
        for _ in range(_DOUBLING_STEPS):
            need = _total_alloc(xs, ss, counts, hi, caps, row_sum) < n
            if not bool(need.any()):
                break
            hi = torch.where(need, hi * 2.0, hi)

    # Bisection; `done` is set AFTER the update, like the host loop's break.
    # Lanes with n <= 0 start done (the excess rescale zeroes them anyway).
    lo = torch.zeros_like(hi)
    done = (n <= 0.0).expand(hi.shape)
    if fixed:
        lo, hi, done = _bisect_fixed(
            lo, hi, done,
            lambda t: _total_alloc(xs, ss, counts, t, caps, row_sum) >= n,
            rel_tol, max_steps,
        )
    else:
        for _ in range(max_steps):
            if bool(done.all()):
                break
            mid = 0.5 * (lo + hi)
            ge = _total_alloc(xs, ss, counts, mid, caps, row_sum) >= n
            hi2 = torch.where(~done & ge, mid, hi)
            lo2 = torch.where(~done & ~ge, mid, lo)
            done = done | (hi2 - lo2 <= rel_tol * hi2)
            lo, hi = lo2, hi2
    t_star = hi

    alloc = _alloc_at_time(xs, ss, counts, t_star, caps)
    total = row_sum(alloc)
    excess = total - n
    scaled = alloc - excess.unsqueeze(-1) * (alloc / total.unsqueeze(-1))
    alloc = torch.where(((total > 0.0) & (excess > 0.0)).unsqueeze(-1), scaled, alloc)
    return alloc, t_star


# ---------------------------------------------------------------------------
# Integer partition: floor + take-back + completion
# ---------------------------------------------------------------------------


def _take_back(xs, ss, counts, d, leftover, min_units, steps=None):
    """``min_units`` overshoot: take units back round-robin in the stable
    descending per-unit-time order, skipping rows at their floor, until the
    overshoot is gone — the reference's sequential loop in closed form.

    Pass ``j`` of the round robin takes one unit from every row whose room
    ``g = d - min_units`` exceeds ``j``, so after ``k`` full passes
    ``T(k) = sum(min(k, g))`` units are back.  ``k`` is the largest pass
    count with ``T(k) <= deficit`` (an integer bisection), and the remaining
    ``deficit - T(k)`` units come from the first rows in order with
    ``g > k``.

    ``steps`` (the deferred program) fixes the bisection's step count on the
    host, at least ``int(hi.max()).bit_length()``, and drops the early exit:
    ``T(lo) <= deficit`` holds throughout, so once ``hi - lo == 1`` a step
    keeps ``lo`` and ``hi``, and a lane without deficit takes nothing.
    """
    deficit = torch.clamp(-leftover, min=0)
    if steps is None and not bool((deficit > 0).any()):
        return d, leftover
    per_unit = _time(xs, ss, counts, d.to(xs.dtype)) / torch.clamp(d, min=1)
    order = torch.argsort(-per_unit, dim=-1, stable=True)
    g = d - min_units
    lo = torch.zeros_like(deficit)
    hi = g.amax(dim=-1) + 1
    for _ in range(int(hi.max()).bit_length() if steps is None else steps):
        mid = (lo + hi) // 2
        fits = torch.minimum(g, mid.unsqueeze(-1)).sum(dim=-1) <= deficit
        lo = torch.where(fits, mid, lo)
        hi = torch.where(fits, hi, mid)
    taken = torch.minimum(g, lo.unsqueeze(-1))
    rest = deficit - taken.sum(dim=-1)
    elig = torch.gather(g > lo.unsqueeze(-1), -1, order)
    pick = elig & (torch.cumsum(elig.to(d.dtype), dim=-1) <= rest.unsqueeze(-1))
    pick = torch.zeros_like(pick).scatter(-1, order, pick)
    return d - taken - pick.to(d.dtype), leftover + deficit


def _threshold_prefill(
    xs, ss, counts, caps_i, d0, leftover, t_star, rel_tol, max_steps, fast_mask,
    fixed=False,
):
    """Batched threshold-count bulk completion (monotone-time banks).

    Mirror of ``partition._threshold_prefill_bank``: bisect a time threshold
    on ``count(t) = sum(clip(floor(alloc(t)), d0, caps)) - sum(d0)`` with the
    strict bracket ``count(lo) < leftover <= count(hi)``, grant everything
    counted at ``lo``, and hand the boundary-tied remainder (at least 1) to
    the exact greedy.  Lanes with no leftover, or routed to the exact loop by
    ``fast_mask``, pass through untouched (``fixed``: the deferred program's
    loops, run whether or not a lane is active).
    """
    active = (leftover > 0) & fast_mask
    if not fixed and not bool(active.any()):
        return d0, leftover
    caps_f = caps_i.to(xs.dtype)
    base_total = d0.sum(dim=-1)

    def count(t):
        a = _alloc_at_time(xs, ss, counts, t, caps_f)
        g = torch.clamp(torch.floor(a).to(d0.dtype), d0, caps_i)
        return g.sum(dim=-1) - base_total, g

    hi = torch.clamp(t_star, min=1e-9)
    lo = torch.zeros_like(hi)
    done = ~active
    if fixed:
        hi = _double_fixed(hi, lambda t: active & (count(t)[0] < leftover))
        lo, hi, done = _bisect_fixed(
            lo, hi, done, lambda t: count(t)[0] >= leftover, rel_tol, max_steps
        )
    else:
        for _ in range(_DOUBLING_STEPS):
            c, _ = count(hi)
            need = active & (c < leftover)
            if not bool(need.any()):
                break
            hi = torch.where(need, hi * 2.0, hi)

        for _ in range(max_steps):
            if bool(done.all()):
                break
            mid = 0.5 * (lo + hi)
            c, _ = count(mid)
            ge = c >= leftover
            hi2 = torch.where(~done & ge, mid, hi)
            lo2 = torch.where(~done & ~ge, mid, lo)
            done = done | (hi2 - lo2 <= rel_tol * hi2)
            lo, hi = lo2, hi2
    c_lo, g_lo = count(lo)
    d = torch.where(active.unsqueeze(-1), g_lo, d0)
    return d, torch.where(active, leftover - c_lo, leftover)


def _complete_greedy(xs, ss, counts, caps_i, d, rem, leftover):
    """Greedy completion: repeated masked lexicographic argmin over
    ``(time(d+1), -rem, index)`` per lane — the tie-breaking of the host lazy
    heap.  The key vector is carried and only the winner's entry is rewritten
    (the heap's single-entry refresh).  Returns ``(d, ok)``; ``ok`` is False
    on lanes whose caps ran out before every unit was placed."""
    inf = float("inf")
    key = torch.where(d + 1 <= caps_i, _time(xs, ss, counts, (d + 1).to(xs.dtype)), inf)
    ok = torch.ones(leftover.shape, dtype=torch.bool, device=d.device)
    steps = int(leftover.max()) if leftover.numel() else 0
    left = leftover
    k = xs.shape[-1]
    for _ in range(max(steps, 0)):
        active = left > 0
        i0 = torch.argmin(key, dim=-1)  # first index of the minimum
        m1 = _take(key, i0)
        feasible = torch.isfinite(m1)
        # >1 processor at the exact minimal time: the heap orders them by
        # (-rem, index) — largest fractional remainder, then first index.
        tie = key == m1.unsqueeze(-1)
        r = torch.where(tie, rem, -inf)
        best_r = tie & (r == r.amax(dim=-1, keepdim=True))
        i_tie = torch.argmax(best_r.to(torch.uint8), dim=-1)
        i = torch.where(tie.sum(dim=-1) > 1, i_tie, i0)
        grant = feasible & active
        d = d.scatter_add(-1, i.unsqueeze(-1), grant.to(d.dtype).unsqueeze(-1))
        d_i = _take(d, i)
        row = i[..., None, None].expand(*i.shape, 1, k)
        t_new = _time(
            torch.gather(xs, -2, row).squeeze(-2),
            torch.gather(ss, -2, row).squeeze(-2),
            _take(counts, i),
            (d_i + 1).to(xs.dtype),
        )
        new_key = torch.where(d_i + 1 <= _take(caps_i, i), t_new, inf)
        new_key = torch.where(grant, new_key, _take(key, i))
        key = key.scatter(-1, i.unsqueeze(-1), new_key.unsqueeze(-1))
        left = torch.where(active, torch.where(feasible, left - 1, 0), left)
        ok = ok & (feasible | ~active)
    return d, ok


def _complete_greedy_fixed(xs, ss, counts, caps_i, d, rem, leftover, steps: int):
    """:func:`_complete_greedy` with ``steps`` (a host bound on the leftover)
    fixed on the host.  Returns ``(d, ok, left)``; ``left`` is what remains
    after the ``steps`` (0 on every lane when the bound held).

    The same grants as the sync loop, in fewer kernels a step:

    * the winner is the first index of the largest ``rem`` among the rows
      at the minimal key — the sync loop's pick when the minimum is tied,
      and the minimum's own index when it is not;
    * a step that grants nothing ends its lane for good (no units left, or
      no feasible row, which sets ``left`` to -1 and ``ok`` to False), so
      such a lane's key is never read again and the step rewrites it
      without a mask;
    * the winner's refreshed key ``time(d_i + 1)`` (``inf`` past its cap) is
      read from a table of every row's next ``_GREEDY_WINDOW + 1`` keys,
      rebuilt every ``_GREEDY_WINDOW`` steps: within a window a row is
      granted at most once a step, so ``d_i + 1`` stays inside its row of
      the table.  Each entry is the same elementwise computation as the
      sync loop's single-row evaluation."""
    inf = float("inf")
    key = torch.where(d + 1 <= caps_i, _time(xs, ss, counts, (d + 1).to(xs.dtype)), inf)
    left = leftover
    width = _GREEDY_WINDOW + 1
    units = torch.arange(1, width + 1, device=d.device)
    row_shape = (*xs.shape[:-1], width, xs.shape[-1])
    for s in range(0, steps, _GREEDY_WINDOW):
        nxt = d.unsqueeze(-1) + units  # [..., p, width]: d_i + 1 .. d_i + width
        table = torch.where(
            nxt <= caps_i.unsqueeze(-1),
            _time(
                xs.unsqueeze(-2).expand(row_shape),
                ss.unsqueeze(-2).expand(row_shape),
                counts.unsqueeze(-1),
                nxt.to(xs.dtype),
            ),
            inf,
        ).flatten(-2)
        taken = torch.zeros_like(d)  # units granted to each row in this window
        for _ in range(min(_GREEDY_WINDOW, steps - s)):
            m1 = key.amin(dim=-1)
            feasible = torch.isfinite(m1)
            active = left > 0
            i = torch.argmax(torch.where(key == m1.unsqueeze(-1), rem, -inf), dim=-1, keepdim=True)
            grant = (feasible & active).to(d.dtype).unsqueeze(-1)
            d = d.scatter_add(-1, i, grant)
            taken = taken.scatter_add(-1, i, grant)
            key = key.scatter(-1, i, torch.gather(table, -1, i * width + torch.gather(taken, -1, i)))
            left = torch.where(feasible | ~active, left - grant.squeeze(-1), -1)
    return d, left >= 0, torch.clamp(left, min=0)


def _partition_units_fixed(
    xs, ss, counts, caps_i, n, min_units, rel_tol, max_steps, fast_mask,
    completion_fast, take_back_steps: int, greedy_steps: int,
):
    """The deferred program: :func:`_partition_units` with every loop count
    fixed on the host and nothing read back (see the module docstring).
    ``fast_mask`` may be computed on the device; ``completion_fast`` (host)
    says whether any lane can take the threshold prefill at all.  Returns
    ``(d, ok, t_star, left)``, bit-identical to the sync program's
    ``(d, ok, t_star)`` when ``left`` is 0 everywhere.

    ``greedy_steps`` is the host bound on the leftover the greedy completes:
    the most rows with positive caps in any lane.  Proof: the continuous
    allocations ``a_i`` are 0 on rows with cap 0, and ``a_i <= min(cap_i,
    n)``, so ``floor(a_i) <= cap_i`` and the floored-and-clipped ``d_i >=
    floor(a_i)``.  Without a ``min_units`` overshoot the leftover is
    ``n - sum(d) <= n - sum(floor(a_i)) < (n - sum(a_i)) + A``, ``A`` the
    number of rows whose ``a_i`` is not an integer, at most the rows with
    positive caps; with an overshoot the take-back leaves it at 0.  The
    bisection keeps a ``t*`` whose allocations sum (in float) to at least
    ``n`` and the rescale brings the sum back to ``n``, so ``n - sum(a_i)``
    is a few rounding errors of ``n`` — below one unit while ``n * p`` stays
    under about 2**50 — and the leftover, an integer below ``1 + A``, is at
    most ``A``.  ``left`` is the tripwire: :func:`fetch_partition` raises if
    a lane still has units left (a doubling that never reached ``n``, or a
    rounding error of a unit or more)."""
    dt = xs.dtype
    n_f = n.to(dt)
    caps_f = torch.minimum(caps_i.to(dt), n_f.unsqueeze(-1))  # continuous clip
    alloc, t_star = _partition_continuous(
        xs, ss, counts, caps_f, n_f, rel_tol, max_steps, fixed=True
    )
    d = torch.maximum(min_units, torch.floor(alloc).to(caps_i.dtype))
    d = torch.minimum(d, caps_i)
    leftover = n - d.sum(dim=-1)
    d, leftover = _take_back(xs, ss, counts, d, leftover, min_units, steps=take_back_steps)
    rem = alloc - torch.floor(alloc)
    if completion_fast:
        d, leftover = _threshold_prefill(
            xs, ss, counts, caps_i, d, leftover, t_star, rel_tol, max_steps,
            fast_mask, fixed=True,
        )
    d, ok, left = _complete_greedy_fixed(xs, ss, counts, caps_i, d, rem, leftover, greedy_steps)
    return d, ok, t_star, left


def _partition_units(
    xs, ss, counts, caps_i, n, min_units, rel_tol, max_steps, fast_mask,
    completion_fast=False, row_sum=np_order_sum,
):
    # `n` and `fast_mask` carry the batch shape; `min_units` the row shape
    # [..., p] (per-lane floors broadcast by the public API, genuinely
    # per-row floors on the hierarchy's inner solve, where padded member
    # rows pin at 0), so per-lane unit counts, floors and completion
    # routing all ride the same tensor program.  `row_sum` takes the float
    # sums (numpy's order over the whole row unless the rows are ragged).
    dt = xs.dtype
    n_f = n.to(dt)
    caps_f = torch.minimum(caps_i.to(dt), n_f.unsqueeze(-1))  # continuous clip
    alloc, t_star = _partition_continuous(
        xs, ss, counts, caps_f, n_f, rel_tol, max_steps, row_sum
    )

    d = torch.maximum(min_units, torch.floor(alloc).to(caps_i.dtype))
    d = torch.minimum(d, caps_i)
    leftover = n - d.sum(dim=-1)
    d, leftover = _take_back(xs, ss, counts, d, leftover, min_units)

    rem = alloc - torch.floor(alloc)
    if completion_fast:
        d, leftover = _threshold_prefill(
            xs, ss, counts, caps_i, d, leftover, t_star, rel_tol, max_steps,
            fast_mask,
        )
    d, ok = _complete_greedy(xs, ss, counts, caps_i, d, rem, leftover)
    return d, ok, t_star


def _fold_in_impl(xs, ss, counts, x, s, valid):
    """Vectorized sorted insert of one ``(x_i, s_i)`` observation per row.

    Exactly ``PiecewiseLinearFPM.add_point`` semantics, for all rows at once:
    replace the speed on an exact duplicate ``x``, otherwise shift-insert at
    the bisect position and re-pad with the row's (possibly new) last point.
    Rows with ``valid[i] == False`` are untouched.
    """
    k = xs.shape[-1]
    j = torch.arange(k, device=xs.device)
    in_prefix = j < counts.unsqueeze(-1)
    dup = in_prefix & (xs == x.unsqueeze(-1))
    has_dup = dup.any(dim=-1)
    do_replace = valid & has_dup
    do_insert = valid & ~has_dup

    ss = torch.where(dup & do_replace.unsqueeze(-1), s.unsqueeze(-1), ss)

    pos = (in_prefix & (xs < x.unsqueeze(-1))).sum(dim=-1)
    jm1 = torch.clamp(j - 1, min=0)
    xs_prev, ss_prev = xs[..., jm1], ss[..., jm1]
    at = j == pos.unsqueeze(-1)
    before = j < pos.unsqueeze(-1)
    xs_ins = torch.where(before, xs, torch.where(at, x.unsqueeze(-1), xs_prev))
    ss_ins = torch.where(before, ss, torch.where(at, s.unsqueeze(-1), ss_prev))
    new_counts = counts + do_insert.to(counts.dtype)
    last = torch.clamp(new_counts - 1, min=0)
    last_x = torch.gather(xs_ins, -1, last.unsqueeze(-1))
    last_s = torch.gather(ss_ins, -1, last.unsqueeze(-1))
    pad = j >= new_counts.unsqueeze(-1)
    xs_ins = torch.where(pad, last_x, xs_ins)
    ss_ins = torch.where(pad, last_s, ss_ins)

    ins = do_insert.unsqueeze(-1)
    return torch.where(ins, xs_ins, xs), torch.where(ins, ss_ins, ss), new_counts


# ---------------------------------------------------------------------------
# The bank
# ---------------------------------------------------------------------------


@dataclass
class TorchModelBank:
    """Device-resident padded FPM bank; accepts leading batch dims
    (``[p, k]`` for one fleet, ``[q, p, k]`` for a stacked one).

    ``max_count`` (host upper bound on ``counts.max()``) and ``empty_rows``
    (host ``counts == 0`` mirror) keep fold-in growth checks and feasibility
    validation free of device reads; ``None`` means unknown (read once and
    cached).  ``generation`` counts folds since construction.
    """

    xs: torch.Tensor
    ss: torch.Tensor
    counts: torch.Tensor
    max_count: Optional[int] = None
    empty_rows: Optional[np.ndarray] = None
    # Host monotone-time flag (None = unknown; resolved by is_monotone()):
    # routes the threshold-count completion.
    monotone: Optional[bool] = None
    # Per-lane mirror for stacked banks: routes the completion per column.
    monotone_cols: Optional[np.ndarray] = None
    generation: int = 0
    # Optional energy sub-bank (same layout; ss holds energy RATES x/E(x),
    # so energy.time(x) == E(x)) — see core/energy.py.
    energy: Optional["TorchModelBank"] = None

    is_torch = True  # duck-type marker for SpeedStore.resolve

    # -- construction --------------------------------------------------------

    @classmethod
    def from_bank(cls, bank: ModelBank, *, device="cuda", dtype=None) -> "TorchModelBank":
        """Device copy of a host numpy bank (``dtype`` defaults to float64)."""
        dev = resolve_device(device)
        dt = torch_dtype(dtype)
        return cls(
            xs=torch.as_tensor(bank.xs, dtype=dt, device=dev),
            ss=torch.as_tensor(bank.ss, dtype=dt, device=dev),
            counts=torch.as_tensor(bank.counts, dtype=torch.int64, device=dev),
            max_count=int(bank.counts.max(initial=0)),
            empty_rows=np.asarray(bank.counts) == 0,
            # resolved on the host while the arrays are still numpy
            monotone=bank.is_monotone(),
            energy=(
                cls.from_bank(bank.energy, device=device, dtype=dtype)
                if bank.energy is not None
                else None
            ),
        )

    @classmethod
    def from_models(cls, models: Sequence[object], *, device="cuda", dtype=None) -> "TorchModelBank":
        """Adapt scalar models (``TypeError`` for non-piecewise ones)."""
        return cls.from_bank(ModelBank.from_models(models), device=device, dtype=dtype)

    @classmethod
    def empty(cls, p: int, k: int = 8, *, device="cuda", dtype=None) -> "TorchModelBank":
        """A bank of ``p`` empty rows (the cold-start DFPA carry)."""
        dev = resolve_device(device)
        dt = torch_dtype(dtype)
        return cls(
            xs=torch.zeros((p, k), dtype=dt, device=dev),
            ss=torch.zeros((p, k), dtype=dt, device=dev),
            counts=torch.zeros((p,), dtype=torch.int64, device=dev),
            max_count=0,
            empty_rows=np.ones((p,), dtype=bool),
            monotone=True,  # vacuous: no observed points yet
        )

    @classmethod
    def stack(
        cls, banks: Sequence["TorchModelBank"], min_k: Optional[int] = None
    ) -> "TorchModelBank":
        """Stack ``q`` same-``p`` banks into one ``[q, p, k]`` bank so every
        column's ``t*`` bisects simultaneously.  ``min_k`` reserves padded
        knot capacity up front."""
        k = max(int(b.xs.shape[-1]) for b in banks)
        if min_k is not None:
            k = max(k, int(min_k))
        padded = [b._padded_to(k) for b in banks]
        flags = [b.monotone for b in banks]
        energy = (
            cls.stack([b.energy for b in banks], min_k=min_k)
            if banks and all(b.energy is not None for b in banks)
            else None
        )
        return cls(
            energy=energy,
            xs=torch.stack([px for px, _ in padded]),
            ss=torch.stack([ps for _, ps in padded]),
            counts=torch.stack([b.counts for b in banks]),
            max_count=max(b._max_count_bound() for b in banks),
            empty_rows=np.stack([b._empty_rows_host() for b in banks]),
            monotone=(
                True if all(f is True for f in flags)
                else False if any(f is False for f in flags)
                else None
            ),
            monotone_cols=(
                np.asarray(flags, dtype=bool)
                if all(f is not None for f in flags)
                else None
            ),
        )

    def _padded_to(self, k: int):
        """``(xs, ss)`` right-padded to width ``k`` by repeating the last
        column (the row's last point, or the zeros of an empty row)."""
        extra = k - int(self.xs.shape[-1])
        if extra <= 0:
            return self.xs, self.ss
        return (
            torch.cat([self.xs, self.xs[..., -1:].expand(*self.xs.shape[:-1], extra)], dim=-1),
            torch.cat([self.ss, self.ss[..., -1:].expand(*self.ss.shape[:-1], extra)], dim=-1),
        )

    def to_bank(self) -> ModelBank:
        """Host snapshot as the numpy :class:`ModelBank` (single bank only)."""
        if self.xs.ndim != 2:
            raise ValueError("to_bank() requires an unbatched [p, k] bank")
        return ModelBank(
            xs=self.xs.detach().cpu().numpy().astype(np.float64),
            ss=self.ss.detach().cpu().numpy().astype(np.float64),
            counts=self.counts.detach().cpu().numpy().astype(np.int64),
            monotone=self.monotone,
            energy=self.energy.to_bank() if self.energy is not None else None,
        )

    # -- shape ---------------------------------------------------------------

    @property
    def p(self) -> int:
        return int(self.xs.shape[-2])

    def __len__(self) -> int:
        return self.p

    @property
    def dtype(self) -> torch.dtype:
        return self.xs.dtype

    @property
    def device(self) -> torch.device:
        return self.xs.device

    def _put(self, v, dtype=None) -> torch.Tensor:
        return torch.as_tensor(v, dtype=dtype or self.dtype, device=self.device)

    # -- batched evaluation --------------------------------------------------

    def speed(self, x) -> torch.Tensor:
        x = self._put(x).expand(self.counts.shape)
        return _speed(self.xs, self.ss, self.counts, x)

    def time(self, x) -> torch.Tensor:
        x = self._put(x).expand(self.counts.shape)
        return _time(self.xs, self.ss, self.counts, x)

    def alloc_at_time(self, t, caps) -> torch.Tensor:
        caps = self._put(caps).expand(self.counts.shape)
        t = self._put(t).expand(self.counts.shape[:-1])
        return _alloc_at_time(self.xs, self.ss, self.counts, t, caps)

    def total_alloc(self, t, caps) -> torch.Tensor:
        return np_order_sum(self.alloc_at_time(t, caps))

    def scaled(self, speed_scale) -> "TorchModelBank":
        """New bank with every row's speeds scaled; ``xs``/``counts`` are
        copied so folding either bank cannot change the other."""
        positive = bool(np.all(np.asarray(speed_scale, dtype=np.float64) > 0.0))
        scale = self._put(speed_scale).expand(self.counts.shape)
        return TorchModelBank(
            xs=self.xs.clone(), ss=self.ss * scale.unsqueeze(-1), counts=self.counts.clone(),
            max_count=self.max_count, empty_rows=self.empty_rows,
            # positive per-row scaling preserves time-monotonicity
            monotone=self.monotone if positive else None,
            monotone_cols=self.monotone_cols if positive else None,
            generation=self.generation,
            energy=self.energy,  # problem-size semantics unchanged
        )

    def copy(self) -> "TorchModelBank":
        """Deep copy of the device tensors (what a snapshot holder needs,
        since ``fold_in`` updates the carry in place)."""
        return TorchModelBank(
            xs=self.xs.clone(), ss=self.ss.clone(), counts=self.counts.clone(),
            max_count=self.max_count, empty_rows=self.empty_rows,
            monotone=self.monotone, monotone_cols=self.monotone_cols,
            generation=self.generation,
            energy=self.energy.copy() if self.energy is not None else None,
        )

    # -- the energy sub-bank (core/energy.py) --------------------------------

    def with_energy(self, energy: "TorchModelBank") -> "TorchModelBank":
        """Attach an energy sub-bank (same shape; ``ss`` holds energy rates
        ``x / E(x)``) — returns a new bank sharing this bank's tensors."""
        if energy.counts.shape != self.counts.shape:
            raise ValueError(
                f"energy bank shape {tuple(energy.counts.shape)} != speed bank "
                f"shape {tuple(self.counts.shape)}"
            )
        return TorchModelBank(
            xs=self.xs, ss=self.ss, counts=self.counts,
            max_count=self.max_count, empty_rows=self.empty_rows,
            monotone=self.monotone, monotone_cols=self.monotone_cols,
            generation=self.generation, energy=energy,
        )

    def energy_at(self, d) -> torch.Tensor:
        """Per-processor energies ``E_i(d_i)`` of a distribution (0 for
        ``d_i <= 0``, NaN on empty energy rows with units)."""
        if self.energy is None:
            raise ValueError("no energy sub-bank attached (use with_energy)")
        return self.energy.time(d)

    def fleet_energy(self, d) -> float:
        """Total fleet energy ``sum_i E_i(d_i)`` of a distribution, summed
        in numpy's order (the numpy bank's value bit for bit)."""
        return float(np_order_sum(self.energy_at(d)))

    def _max_count_bound(self) -> int:
        """Host upper bound on ``counts.max()`` (read once if unknown)."""
        if self.max_count is None:
            self.max_count = int(self.counts.max()) if self.counts.numel() else 0
        return self.max_count

    def _empty_rows_host(self) -> np.ndarray:
        """Host ``counts == 0`` mirror (read once if unknown, then kept by
        ``fold_in`` without further transfers)."""
        if self.empty_rows is None:
            self.empty_rows = (self.counts == 0).cpu().numpy()
        return self.empty_rows

    def is_monotone(self) -> bool:
        """Host bool of the monotone-time flag (the threshold-count
        completion's routing contract); after a ``fold_in`` it costs one
        device reduction and one read."""
        if self.monotone is None:
            if self.monotone_cols is not None:
                self.monotone = bool(np.all(self.monotone_cols))
            else:
                self.monotone = bool(_monotone_lanes(self.xs, self.ss, self.counts).all())
        return self.monotone

    def monotone_lanes(self) -> np.ndarray:
        """Per-lane host mirror of :meth:`is_monotone` (shape ``[q]`` for a
        stacked bank, ``()`` for a plain one)."""
        shape = self.counts.shape[:-1]
        if self.monotone_cols is None:
            if self.monotone is True:
                self.monotone_cols = np.ones(shape, dtype=bool)
            else:
                self.monotone_cols = (
                    _monotone_lanes(self.xs, self.ss, self.counts).cpu().numpy().reshape(shape)
                )
        return self.monotone_cols

    # -- the partitioners ----------------------------------------------------

    def _check_feasible(self, caps: np.ndarray) -> None:
        if np.any((caps > 0.0) & self._empty_rows_host()):
            raise ValueError("empty FPM")

    def partition_continuous(
        self, n, caps=None, *, rel_tol: float = 1e-12, max_steps: int = 200
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Continuous optimal partition on the device; ``n`` may be batched
        for a stacked bank.  Returns ``(allocations, t_star)`` tensors."""
        shape = self.counts.shape
        if caps is not None:
            caps_host = np.broadcast_to(np.asarray(caps, dtype=np.float64), shape)
        else:
            caps_host = np.broadcast_to(np.asarray(n, dtype=np.float64)[..., None], shape)
        self._check_feasible(caps_host)
        return _partition_continuous(
            self.xs, self.ss, self.counts,
            self._put(np.array(caps_host)),
            self._put(n).expand(shape[:-1]),
            rel_tol,
            max_steps,
        )

    def partition_units(
        self, n, caps=None, *, min_units=0, max_steps: int = 200,
        with_t: bool = False, completion: str = "auto",
        completion_lanes=None, auto_lanes=None, defer: bool = False,
    ):
        """Integer partition on the device; host-side feasibility checks
        raise the same ``ValueError`` s as the scalar and numpy-bank paths.

        ``n`` (and ``min_units``) may be ``[q]`` for a stacked bank.
        Returns the host allocation array; with ``with_t=True`` also the
        continuous solve's ``t*``.  ``completion``: ``"auto"`` takes the
        threshold-count bulk grant where the bank (per lane, on a stacked
        bank) is monotone-time, ``"greedy"`` forces the exact per-unit loop,
        ``"threshold"`` forces the bulk grant; ``completion_lanes`` (a
        ``[q]`` bool mask) overrides the routing per lane, except on the
        lanes ``auto_lanes`` (a ``[q]`` bool mask) marks, which follow the
        bank's monotonicity as ``"auto"`` does.

        ``defer=True`` queues the deferred program (see the module
        docstring) and returns a :class:`DeferredPartition` of device
        tensors without any device-to-host read: uploads are non-blocking,
        and ``"auto"`` routing the host does not already know is computed
        on the device.  :func:`fetch_partition` makes the one read and
        raises what this call would have raised.
        """
        if completion not in ("auto", "threshold", "greedy"):
            raise ValueError(f"unknown completion mode {completion!r}")
        shape = self.counts.shape
        p = shape[-1]
        lanes_host, auto_host = self._routing(completion, completion_lanes, auto_lanes)
        n_host = np.broadcast_to(np.asarray(n), shape[:-1])
        if np.any(n_host < 0):
            raise ValueError("n must be non-negative")
        mu_host = np.broadcast_to(np.asarray(min_units, dtype=np.int64), shape[:-1])
        if np.any(mu_host * p > n_host):
            i = int(np.argmax(np.reshape(mu_host * p > n_host, (-1,))))
            raise ValueError(
                f"min_units={int(np.reshape(mu_host, (-1,))[i])} infeasible for "
                f"n={int(np.reshape(n_host, (-1,))[i])}, p={p}"
            )
        if caps is None:
            caps_host = np.broadcast_to(np.asarray(n_host, dtype=np.int64)[..., None], shape)
        else:
            caps_host = np.broadcast_to(np.asarray(caps, dtype=np.int64), shape)
        under = (caps_host < mu_host[..., None]) & (mu_host[..., None] > 0)
        if np.any(under):
            i = int(np.argmax(np.reshape(under, (-1,))))
            raise ValueError(
                f"min_units={int(np.reshape(mu_host, (-1,))[i // p])} "
                f"infeasible: cap {int(caps_host.reshape(-1)[i])} < min_units"
            )
        clipped = np.minimum(caps_host.astype(np.float64), n_host[..., None].astype(np.float64))
        short = clipped.sum(axis=-1) < n_host
        if np.any(short):
            i = int(np.argmax(np.reshape(short, (-1,))))
            raise ValueError(
                f"infeasible: sum(caps)={float(clipped.reshape(-1, p)[i].sum())} "
                f"< n={float(np.reshape(n_host, (-1,))[i])}"
            )
        idtype = self.counts.dtype
        if defer:
            return self._partition_deferred(
                n_host, caps_host, mu_host, lanes_host, auto_host, max_steps, with_t
            )
        if auto_host is not None:
            mono = self.monotone_lanes() if self.counts.ndim >= 2 else self.is_monotone()
            lanes_host = np.where(auto_host, mono, lanes_host)
        self._check_feasible(caps_host.astype(np.float64))
        d, ok, t_star = _partition_units(
            self.xs, self.ss, self.counts,
            self._put(np.array(caps_host), idtype),
            self._put(np.array(n_host), idtype),
            self._put(np.array(np.broadcast_to(mu_host[..., None], shape)), idtype),
            1e-12,
            max_steps,
            self._put(lanes_host, torch.bool),
            completion_fast=bool(np.any(lanes_host)),
        )
        return fetch_partition(DeferredPartition(d, ok, t_star if with_t else None))

    def _routing(self, completion, completion_lanes, auto_lanes):
        """The completion routing per lane, as far as the host knows it
        without a device read: ``(lanes, auto)`` — host bool masks of the
        batch shape; ``auto`` (or ``None``) marks the lanes that follow the
        bank's monotonicity (:meth:`monotone_lanes`), which the host
        mirrors resolve where they are known."""
        batch = self.counts.shape[:-1]
        if completion_lanes is not None:
            lanes = np.array(np.broadcast_to(np.asarray(completion_lanes, dtype=bool), batch))
            auto = (
                None if auto_lanes is None
                else np.array(np.broadcast_to(np.asarray(auto_lanes, dtype=bool), batch))
            )
        elif completion == "threshold":
            lanes, auto = np.ones(batch, dtype=bool), None
        elif completion == "greedy":
            lanes, auto = np.zeros(batch, dtype=bool), None
        else:
            lanes, auto = np.zeros(batch, dtype=bool), np.ones(batch, dtype=bool)
        if auto is not None and not auto.any():
            auto = None
        known = self.monotone_cols
        if known is None and self.monotone is not None and (self.counts.ndim < 2 or self.monotone):
            known = np.full(batch, self.monotone, dtype=bool)
        if auto is not None and known is not None:
            lanes, auto = np.where(auto, known, lanes), None
        return lanes, auto

    def _partition_deferred(self, n_host, caps_host, mu_host, lanes_host, auto_host, max_steps, with_t):
        """Queue the deferred program (``partition_units(defer=True)``)."""
        shape = self.counts.shape
        idtype = self.counts.dtype
        dev = self.device
        caps = upload(caps_host, dev, idtype)
        empty = None
        if self.empty_rows is None:
            empty = ((caps > 0) & (self.counts == 0)).any()  # read by fetch_partition
        else:
            self._check_feasible(caps_host.astype(np.float64))
        lanes = upload(lanes_host, dev, torch.bool)
        if auto_host is not None:
            lanes = torch.where(
                upload(auto_host, dev, torch.bool),
                _monotone_lanes(self.xs, self.ss, self.counts), lanes,
            )
        # the take-back's room d - min_units stays below min(caps, n) - min_units + 1
        room = np.minimum(caps_host, n_host[..., None]) - mu_host[..., None]
        take_back_steps = (int(np.max(room, initial=0)) + 1).bit_length()
        greedy_steps = int(np.max(np.sum(caps_host > 0, axis=-1), initial=0))
        tensors = (
            self.xs, self.ss, self.counts, caps,
            upload(n_host, dev, idtype),
            upload(np.broadcast_to(mu_host[..., None], shape), dev, idtype),
        )
        fixed = (1e-12, max_steps)
        counts = (bool(np.any(lanes_host)) or auto_host is not None, take_back_steps, greedy_steps)
        if dev.type == "cuda" and GRAPH_DEFERRED:
            d, ok, t_star, left = _graphed_solve(tensors + (lanes,), fixed, counts)
        else:
            d, ok, t_star, left = _partition_units_fixed(*tensors, *fixed, lanes, *counts)
        return DeferredPartition(d, ok, t_star if with_t else None, left, empty)

    # -- device-resident observation fold-in ---------------------------------

    def fold_in(self, x, s, valid=None, *, donate: bool = True) -> "TorchModelBank":
        """Insert one observation ``(x_i, s_i)`` per row (vectorized sorted
        insert; a duplicate ``x`` replaces the speed) and return the updated
        bank, one :attr:`generation` newer.  Grows the padded width (by
        doubling) when a row is full.

        ``donate=True`` writes the result into this bank's tensors (no new
        device memory; this bank then reads as the new one), ``donate=False``
        leaves this bank's tensors untouched — the double-buffered form."""
        shape = self.counts.shape
        x = self._put(x).expand(shape)
        s = self._put(s).expand(shape)
        # valid is host data in every caller; mirror it on the host so
        # empty_rows stays host-tracked, then upload.
        if valid is None:
            valid_host = np.ones(shape, dtype=bool)
        else:
            valid_host = np.broadcast_to(np.asarray(valid, bool), shape)
        xs, ss = self.xs, self.ss
        k = int(xs.shape[-1])
        bound = self._max_count_bound()
        if bound >= k:
            # The host bound overcounts duplicate-x folds (they replace a
            # speed without growing counts): read the true maximum before
            # paying for a width doubling.
            bound = int(self.counts.max())
            self.max_count = bound
            if bound >= k:
                k = max(2 * k, 1)
                xs, ss = self._padded_to(k)
        nxs, nss, ncounts = _fold_in_impl(
            xs, ss, self.counts, x, s, self._put(np.array(valid_host), torch.bool)
        )
        if donate and xs is self.xs:
            self.xs.copy_(nxs)
            self.ss.copy_(nss)
            self.counts.copy_(ncounts)
            nxs, nss, ncounts = self.xs, self.ss, self.counts
        return TorchModelBank(
            xs=nxs, ss=nss, counts=ncounts, max_count=min(bound + 1, k),
            generation=self.generation + 1,
            empty_rows=self._empty_rows_host() & ~valid_host,
            # inserted points can create or remove a monotonicity violation;
            # re-resolved lazily on the next partition
            monotone=None,
            # speed observations leave the energy sub-bank as it is; energy
            # observations fold into it directly (it is a bank)
            energy=self.energy,
        )


# ---------------------------------------------------------------------------
# The deferred program replayed as a CUDA graph
# ---------------------------------------------------------------------------

GRAPH_DEFERRED = True  # replay the deferred program as a CUDA graph on the card
_GRAPHS_KEPT = 4  # captured shapes kept (least recently used dropped)
_graphs: "OrderedDict[tuple, _GraphedSolve]" = OrderedDict()


class _GraphedSolve:
    """The deferred program for one shape, captured as a CUDA graph.

    Eager, the program's tens of thousands of small kernels keep the host
    busy for as long as the card is, so queueing it frees nothing.  The
    first call of a shape runs it eagerly (the warm-up: it loads every
    kernel and uploads the summation plans); the second captures it on a
    side stream without synchronizing (``capture_begin`` directly, not the
    ``torch.cuda.graph`` context, which synchronizes the device), and every
    call from then on copies its inputs into the graph's static buffers and
    replays it on the current stream, in stream order with the fold that
    produced the carry.  The outputs are cloned, so a later replay does not
    overwrite a result not yet fetched."""

    def __init__(self, args, fixed, counts):
        self.inputs = [a.clone() for a in args]
        self.fixed, self.counts = fixed, counts
        # the summation plan the graph reads by address stays referenced
        self.plan = _np_sum_plan_on(int(args[0].shape[-2]), numpy_sum_block(), args[0].device)
        self.graph = None
        self.out = None

    def _capture(self) -> None:
        dev = self.inputs[0].device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        graph = torch.cuda.CUDAGraph()
        *tensors, lanes = self.inputs
        with torch.cuda.stream(side):
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                out = _partition_units_fixed(*tensors, *self.fixed, lanes, *self.counts)
            finally:
                graph.capture_end()
        torch.cuda.current_stream(dev).wait_stream(side)
        self.graph, self.out = graph, out

    def __call__(self, args):
        for dst, src in zip(self.inputs, args):
            dst.copy_(src)
        if self.graph is None:
            self._capture()
        self.graph.replay()
        return tuple(t.clone() for t in self.out)


def _graphed_solve(args, fixed, counts):
    """The deferred program on the card: eager on a shape's first call, a
    CUDA graph replay from its second (:class:`_GraphedSolve`)."""
    key = (
        tuple(args[0].shape), args[0].dtype, args[0].device, tuple(args[-1].shape),
        fixed, counts,
    )
    solve = _graphs.get(key)
    if solve is None:
        _graphs[key] = _GraphedSolve(args, fixed, counts)
        while len(_graphs) > _GRAPHS_KEPT:
            _graphs.popitem(last=False)
        *tensors, lanes = args
        return _partition_units_fixed(*tensors, *fixed, lanes, *counts)
    _graphs.move_to_end(key)
    return solve(args)


class DeferredPartition(NamedTuple):
    """A ``partition_units`` result still on the device: ``(d, ok)``, the
    continuous ``t_star`` when the call passed ``with_t=True``, and, from the
    deferred program, the units its fixed-count completion left unplaced
    (``unplaced``, 0 when the host bound held) and the empty-row flag it
    computed on the device where the bank's host mirror was unknown."""

    d: torch.Tensor
    ok: torch.Tensor
    t_star: Optional[torch.Tensor] = None
    unplaced: Optional[torch.Tensor] = None
    empty: Optional[torch.Tensor] = None


def fetch_partition(deferred: DeferredPartition):
    """Materialize a ``partition_units(..., defer=True)`` result: the one
    device-to-host read.  Raises what the sync call would have raised (an
    empty FPM, caps that ran out during the integer completion), and returns
    the host allocation array (plus ``t_star`` when the deferred call used
    ``with_t=True``)."""
    if deferred.empty is not None and bool(deferred.empty):
        raise ValueError("empty FPM")
    d_host = deferred.d.cpu().numpy()
    if not bool(deferred.ok.all()):
        raise ValueError("caps infeasible during integer completion")
    if deferred.unplaced is not None and bool((deferred.unplaced > 0).any()):
        raise RuntimeError(
            "the deferred partition's completion left units unplaced: its host "
            "bound on the leftover did not hold for this bank"
        )
    if deferred.t_star is not None:
        return d_host, deferred.t_star.cpu().numpy()
    return d_host
