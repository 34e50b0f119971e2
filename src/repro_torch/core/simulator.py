"""Heterogeneous-cluster simulator calibrated to the paper's experiments.

The paper's speed nonlinearity has three regimes (its Fig. 3 / Fig. 5):

  * cache region   — small working sets fit L2 -> speed boost;
  * memory plateau — the CPM regime, speed ~ constant;
  * paging cliff   — footprint exceeds RAM -> speed collapses.

For the paper's 1-D matmul kernel (update of an ``n_b x n`` panel,
``x = n_b * n`` computation units) the per-processor footprint is
``8*(2*x + n^2)`` bytes (its own A/C slices + the whole of B), so the paging
threshold *in units* depends on the matrix size ``n`` — exactly why nodes
hcl06/hcl08 (256 MB) paged at n=5120 in the paper while 1 GB nodes did not.

Speeds are calibrated from the paper's measured Mflop/s list for the HCL
cluster (§3.1: {658, 667, ..., 695} for n_b=20, n=2048; 1 unit = 1 add + 1 mul
= 2 flops) and RAM/L2 sizes from Table 1.  The simulator reproduces the
paper's *phenomena* (iteration counts, cost ratios, paging-borderline
convergence); absolute seconds are the same order as the paper's tables.

``speed_fn_2d_batch`` / ``time_fn_2d_batch`` evaluate the 2-D ground truth
of a whole grid in one array call (the fleet's batched measurements).  The
reference's device-group time functions (``make_tpu_group_time_fns``) are
not ported: nothing in the reference calls them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Sequence, Tuple

__all__ = [
    "NodeSpec",
    "speed_fn_1d",
    "time_fn_1d",
    "speed_fn_1d_batch",
    "time_fn_1d_batch",
    "speed_fn_2d",
    "speed_fn_2d_batch",
    "time_fn_2d_batch",
    "HCL_SPECS",
    "make_hcl_time_fns",
    "make_hcl_time_fn_batch",
    "make_grid5000_specs",
    "make_grid5000_time_fns",
    "matmul_app_time_1d",
    "full_model_build_cost",
]

MB = 1 << 20
GB = 1 << 30


@dataclass(frozen=True)
class NodeSpec:
    """One heterogeneous node.

    ``s_mem`` — plateau (main-memory) speed in units/s (1 unit = 1 add + 1 mul);
    ``cache_boost`` — multiplier when the working set fits L2 (the paper's
    quoted Mflop/s were measured at n_b=20, n=2048 — a cache-resident working
    set — so the plateau is calibrated as measured/boost);
    ``disk_factor`` — how much slower a paged-out access is than a resident one
    (disk vs RAM); drives the thrashing collapse via a miss-fraction model;
    ``anisotropy`` — 2-D kernels: mild dependence on the panel aspect ratio.
    """

    name: str
    s_mem: float
    l2_bytes: int
    ram_bytes: int
    os_bytes: int = 48 * MB
    cache_boost: float = 1.65
    disk_factor: float = 300.0
    anisotropy: float = 0.0


def speed_fn_1d(spec: NodeSpec, n: int) -> Callable[[float], float]:
    """Ground-truth speed s(x) [units/s] for the 1-D kernel at matrix size n.

    Smooth, strictly positive, monotonically non-increasing — satisfies the
    shape restrictions of [16], so the paper's convergence proposition applies.
    """
    # Cache region: A_b/C_b rows stream; boost while 16*x <= L2.
    x_cache = max(spec.l2_bytes / 16.0, 1.0)
    # Paging threshold in units: 8*(2*x + n^2) + OS <= RAM.
    avail = spec.ram_bytes - spec.os_bytes - 8.0 * n * n
    x_page = max(avail / 16.0, 1.0)  # <=1 -> node pages from the first unit
    x_ref = spec.ram_bytes / 16.0  # working set that would fill RAM

    def s(x: float) -> float:
        if x <= 0:
            return spec.s_mem * spec.cache_boost
        # cache boost, linearly fading to 1.0 over [x_cache, 3*x_cache]
        if x <= x_cache:
            boost = spec.cache_boost
        elif x <= 3.0 * x_cache:
            w = (x - x_cache) / (2.0 * x_cache)
            boost = spec.cache_boost + w * (1.0 - spec.cache_boost)
        else:
            boost = 1.0
        base = spec.s_mem * boost
        if x > x_page:
            # Thrashing: the overflow fraction of the working set misses to
            # disk; each missed access costs disk_factor resident accesses.
            z = (x - x_page) / x_ref
            miss = z / (1.0 + z)  # in [0, 1)
            base = base / (1.0 + (spec.disk_factor - 1.0) * miss)
        return base

    return s


def time_fn_1d(spec: NodeSpec, n: int) -> Callable[[float], float]:
    s = speed_fn_1d(spec, n)
    return lambda x: (x / s(x)) if x > 0 else 0.0


def speed_fn_1d_batch(specs: Sequence[NodeSpec], n: int) -> Callable[["object"], "object"]:
    """Batched ground truth: one vector call evaluates ``s_i(x_i)`` for the
    WHOLE fleet — the simulator-side analogue of ``ModelBank`` (needed so the
    scaling benchmark and the batched executor are not bottlenecked on ``p``
    Python calls per round).  Elementwise identical to ``speed_fn_1d``.
    """
    import numpy as np

    s_mem = np.array([s.s_mem for s in specs])
    boost0 = np.array([s.cache_boost for s in specs])
    disk = np.array([s.disk_factor for s in specs])
    x_cache = np.maximum(np.array([s.l2_bytes for s in specs]) / 16.0, 1.0)
    avail = np.array([s.ram_bytes - s.os_bytes for s in specs]) - 8.0 * n * n
    x_page = np.maximum(avail / 16.0, 1.0)
    x_ref = np.array([s.ram_bytes for s in specs]) / 16.0

    def s(x):
        x = np.asarray(x, dtype=np.float64)
        w = np.clip((x - x_cache) / (2.0 * x_cache), 0.0, 1.0)
        boost = boost0 + w * (1.0 - boost0)
        boost = np.where(x <= 0, boost0, boost)
        base = s_mem * boost
        z = np.maximum(x - x_page, 0.0) / x_ref
        miss = z / (1.0 + z)
        return base / (1.0 + (disk - 1.0) * miss)

    return s


def time_fn_1d_batch(specs: Sequence[NodeSpec], n: int) -> Callable[["object"], "object"]:
    """Batched ``t_i(x_i) = x_i / s_i(x_i)`` (0 where ``x_i <= 0``)."""
    import numpy as np

    s = speed_fn_1d_batch(specs, n)

    def t(x):
        x = np.asarray(x, dtype=np.float64)
        return np.where(x > 0, x / s(x), 0.0)

    return t


def speed_fn_2d(spec: NodeSpec, b: int = 32) -> Callable[[float, float], float]:
    """2-D kernel speed g(m_b, n_b) [units/s], unit = b x b block mult-add.

    Footprint ~ 8*b^2*(m_b*n_b + m_b + n_b); mild anisotropy makes the speed
    depend on the aspect ratio (the paper's Fig. 5(b) relative-speed surface).
    """
    flops_per_unit = 2.0 * b * b * b  # one b x b block multiply-accumulate
    s_units = spec.s_mem * 2.0 / flops_per_unit * (b * b)  # rescale: keep
    # plateau speed comparable in "block units"/s given s_mem in scalar units/s.
    avail = spec.ram_bytes - spec.os_bytes
    units_page = max(avail / (24.0 * b * b), 1.0)
    units_ref = spec.ram_bytes / (24.0 * b * b)
    x_cache = max(spec.l2_bytes / (24.0 * b * b), 1.0)

    def g(mb: float, nb: float) -> float:
        u = mb * nb
        if u <= 0:
            return s_units * spec.cache_boost
        if u <= x_cache:
            boost = spec.cache_boost
        elif u <= 3.0 * x_cache:
            w = (u - x_cache) / (2.0 * x_cache)
            boost = spec.cache_boost + w * (1.0 - spec.cache_boost)
        else:
            boost = 1.0
        base = s_units * boost
        if u > units_page:
            z = (u - units_page) / units_ref
            miss = z / (1.0 + z)
            base = base / (1.0 + (spec.disk_factor - 1.0) * miss)
        if spec.anisotropy:
            aspect = nb / (mb + nb)  # in (0, 1)
            base *= 1.0 + spec.anisotropy * (aspect - 0.5)
        return base

    return g


def speed_fn_2d_batch(
    specs: Sequence[NodeSpec], b: int = 32
) -> Callable[["object", "object"], "object"]:
    """Batched 2-D ground truth: ``g_i(mb_i, nb_i)`` for the WHOLE grid in one
    vector call — the simulator-side prerequisite of the ``[q, p, k]``
    stacked-bank partitioner (a ``p x q`` grid flattens to one spec list).
    Elementwise identical to :func:`speed_fn_2d`.
    """
    import numpy as np

    flops_per_unit = 2.0 * b * b * b
    s_units = np.array([s.s_mem for s in specs]) * 2.0 / flops_per_unit * (b * b)
    boost0 = np.array([s.cache_boost for s in specs])
    disk = np.array([s.disk_factor for s in specs])
    aniso = np.array([s.anisotropy for s in specs])
    avail = np.array([s.ram_bytes - s.os_bytes for s in specs])
    units_page = np.maximum(avail / (24.0 * b * b), 1.0)
    units_ref = np.array([s.ram_bytes for s in specs]) / (24.0 * b * b)
    x_cache = np.maximum(np.array([s.l2_bytes for s in specs]) / (24.0 * b * b), 1.0)

    def g(mb, nb):
        mb = np.asarray(mb, dtype=np.float64)
        nb = np.asarray(nb, dtype=np.float64)
        u = mb * nb
        w = np.clip((u - x_cache) / (2.0 * x_cache), 0.0, 1.0)
        boost = boost0 + w * (1.0 - boost0)
        base = s_units * boost
        z = np.maximum(u - units_page, 0.0) / units_ref
        miss = z / (1.0 + z)
        base = base / (1.0 + (disk - 1.0) * miss)
        denom = np.where(mb + nb > 0.0, mb + nb, 1.0)
        aspect = nb / denom
        base = np.where(aniso != 0.0, base * (1.0 + aniso * (aspect - 0.5)), base)
        return np.where(u <= 0.0, s_units * boost0, base)

    return g


def time_fn_2d_batch(
    specs: Sequence[NodeSpec], b: int = 32
) -> Callable[["object", "object"], "object"]:
    """Batched ``t_i(mb_i, nb_i) = mb_i * nb_i / g_i(mb_i, nb_i)`` (0 where
    the block is empty)."""
    import numpy as np

    g = speed_fn_2d_batch(specs, b)

    def t(mb, nb):
        mb = np.asarray(mb, dtype=np.float64)
        nb = np.asarray(nb, dtype=np.float64)
        u = mb * nb
        return np.where(u > 0.0, u / g(mb, nb), 0.0)

    return t


# --------------------------------------------------------------------------
# Calibrated clusters
# --------------------------------------------------------------------------

# Paper §3.1 measured speeds (Mflop/s, n_b=20, n=2048) for hcl01..hcl16.
_HCL_MFLOPS = [658, 667, 648, 644, 570, 503, 583, 581, 611, 628, 567, 601, 338, 651, 554, 695]
_HCL_RAM = [1 * GB] * 4 + [256 * MB, 256 * MB, 256 * MB, 256 * MB, 1 * GB, 1 * GB,
            512 * MB, 512 * MB, 1 * GB, 1 * GB, 1 * GB, 1 * GB]
_HCL_L2 = [1 * MB] * 4 + [2 * MB, 2 * MB, 1 * MB, 1 * MB, 1 * MB, 1 * MB,
           1 * MB, 1 * MB, 256 * 1024, 1 * MB, 1 * MB, 2 * MB]

HCL_SPECS: List[NodeSpec] = [
    NodeSpec(
        name=f"hcl{i + 1:02d}",
        # measured speeds were cache-resident -> plateau = measured / boost
        s_mem=_HCL_MFLOPS[i] * 1e6 / 2.0 / 1.65,  # units/s (unit = 2 flops)
        l2_bytes=_HCL_L2[i],
        ram_bytes=_HCL_RAM[i],
        anisotropy=0.08 * ((i % 5) - 2) / 2.0,
    )
    for i in range(16)
]


def make_hcl_time_fns(
    n: int, exclude: Sequence[str] = ("hcl07",)
) -> Tuple[List[NodeSpec], List[Callable[[float], float]]]:
    """The paper's experimental setup: 15 HCL nodes (hcl07 excluded)."""
    specs = [s for s in HCL_SPECS if s.name not in set(exclude)]
    return specs, [time_fn_1d(s, n) for s in specs]


def make_hcl_time_fn_batch(
    n: int, exclude: Sequence[str] = ("hcl07",)
) -> Tuple[List[NodeSpec], Callable[["object"], "object"]]:
    """Batched counterpart of :func:`make_hcl_time_fns`: one vector-valued
    time function for the whole cluster."""
    specs = [s for s in HCL_SPECS if s.name not in set(exclude)]
    return specs, time_fn_1d_batch(specs, n)


def make_grid5000_specs(seed: int = 5000) -> List[NodeSpec]:
    """28 nodes, 14 types x 2, heterogeneity ~2.5-2.8, large RAM (no paging
    for the paper's sizes) — the paper's Grid5000 experiment (Table 4)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    specs: List[NodeSpec] = []
    # 14 types with plateau speeds spanning ~2.7x.
    type_speeds = np.geomspace(2.2e8, 6.0e8, 14)
    type_ram = [4 * GB if i % 3 else 8 * GB for i in range(14)]
    for ty in range(14):
        for rep in range(2):
            jitter = 1.0 + 0.02 * float(rng.standard_normal())
            specs.append(
                NodeSpec(
                    name=f"g5k-{ty:02d}-{rep}",
                    s_mem=float(type_speeds[ty]) * jitter,
                    l2_bytes=2 * MB,
                    ram_bytes=type_ram[ty],
                    cache_boost=1.4,
                )
            )
    return specs


def make_grid5000_time_fns(n: int) -> Tuple[List[NodeSpec], List[Callable[[float], float]]]:
    specs = make_grid5000_specs()
    return specs, [time_fn_1d(s, n) for s in specs]


# --------------------------------------------------------------------------
# Application-level cost model (for the benchmark tables)
# --------------------------------------------------------------------------

def matmul_app_time_1d(
    time_fns: Sequence[Callable[[float], float]],
    d_rows: Sequence[int],
    n: int,
    *,
    step_overhead: float = 2.0e-3,
) -> float:
    """Full 1-D matmul app time for row distribution ``d_rows`` (rows of A/C).

    The app performs ``n`` rank-1 panel updates (k = 1..n); step k updates the
    processor's whole C slice, which is exactly the benchmark kernel — so the
    per-step cost is the slowest processor's kernel time (lockstep sweep) plus
    a per-step loop overhead.  ``time_fns`` expects *units* ``x = rows * n``.
    """
    per_step = max(tf(float(r * n)) for tf, r in zip(time_fns, d_rows))
    return n * (per_step + step_overhead)


def full_model_build_cost(
    time_fns_by_n: Callable[[int], Sequence[Callable[[float], float]]],
    n_values: Sequence[int],
    nb_fracs: Sequence[float],
) -> float:
    """Cost of building FULL functional models (the paper's 1850 s):

    every processor runs the kernel over the whole (n_b, n) grid in parallel;
    rounds are lockstep, so each grid point costs the max time across nodes.
    """
    total = 0.0
    for n in n_values:
        fns = time_fns_by_n(n)
        for frac in nb_fracs:
            nb = max(int(frac * n), 1)
            total += max(fn(float(nb * n)) for fn in fns)
    return total
