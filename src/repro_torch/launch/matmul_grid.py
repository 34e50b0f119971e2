"""The paper's 2-D application on one card: a ``p x q`` grid of processors
that share it, each updating its block of ``C += A B`` with the
``matmul_update`` kernel.

``MatmulGrid`` gives ``Scheduler(grid=...)`` one speed function per
processor, measured on the card.  Its defaults, the ``GRID_*`` constants,
are the configuration that ``chip_smoke.py``'s ``grid`` phase and
``tools/grid_probe.py`` balance: a 2 x 4 grid with repeats
``[[1, 2, 3, 4], [4, 3, 2, 1]]``, M = N = 128 units of 128 rows / columns
(16384), each block update 4096 deep, bf16, at eps 0.1, each evaluation of
a speed function one untimed run of the block and then the median of
``GRID_SAMPLES`` timings taken back to back::

    app = MatmulGrid()
    part = Scheduler(grid=app.grid(), policy=Policy.GRID2D).partition_grid(
        GRID_UNITS, GRID_UNITS, eps=GRID_EPS)
"""

from __future__ import annotations

import statistics
import time

import torch

from ..core.modelbank_torch import resolve_device
from ..kernels import matmul_update

__all__ = [
    "GRID_BLOCKS", "GRID_EPS", "GRID_K", "GRID_REPEATS", "GRID_SAMPLES", "GRID_UNIT", "GRID_UNITS", "GRID_WARMUP",
    "MatmulGrid",
]

GRID_REPEATS = [[1, 2, 3, 4], [4, 3, 2, 1]]
GRID_UNIT, GRID_UNITS, GRID_K = 128, 128, 4096
GRID_BLOCKS = dict(bm=128, bn=128, bk=512)  # divides every (r*128, w*128, 4096)
GRID_EPS = 0.1
# Timings per speed-function evaluation, of which the median counts.  With
# one timing of ~1.5 ms of blocks GRID2D stopped at its 40 outer iterations
# just above eps in 1 of 20 runs of tools/grid_probe.py on an H100: the outer
# loop re-times unchanged columns, so one noisy reading can hold it there.
GRID_SAMPLES = 3
# Untimed runs of the block before an evaluation's timings.  A timing that
# starts on an idle card also times the host's launch of its first kernel
# (8-11 % of a ~1.4 ms block on an H100, tools/grid_probe.py --study), and
# the card's clocks and L2 are in whatever state the host's pause and the
# block before left them.  One run of the same block first, with the
# timings enqueued behind it and behind each other, starts every timing on
# a busy card holding this block's operands: GRID2D then stopped short of
# eps in 1 of 180 runs of tools/grid_probe.py on an H100, against 5 of 130
# with each timing alone (the stall left is GRID2D's own fixed point).
GRID_WARMUP = 1


class MatmulGrid:
    """A ``p x q`` grid of processors sharing the card.  Processor
    ``(i, j)`` runs ``matmul_update`` on its ``(r*unit) x (w*unit) x K``
    block ``repeats[i][j]`` times; its speed function ``g(r, w)`` runs that
    ``warmup`` times untimed and then ``samples`` times, each timed with
    CUDA events (the way ``CallableExecutor`` times a panel), all enqueued
    before one synchronisation, and returns ``r*w / median``.  The kernel
    takes contiguous operands only, so a block's ``a``, ``b`` and ``c`` are
    the leading elements of flat buffers, viewed in the block's shape.
    ``evals`` counts the speed functions' evaluations, ``expected`` the
    launches they account for (``repeats[i][j] * (warmup + samples)``
    each), ``eval_s`` the host seconds spent inside them.  Raises without a
    CUDA device unless the caller passes ``device="cpu"`` (the plain
    version, timed by whatever stands in for ``torch.cuda.Event``: tests
    only)."""

    def __init__(self, repeats=GRID_REPEATS, unit=GRID_UNIT, units=GRID_UNITS, K=GRID_K,
                 blocks=GRID_BLOCKS, seed=0, samples=GRID_SAMPLES, device="cuda"):
        if samples < 1:
            raise ValueError(f"samples must be >= 1, got {samples}")
        dev = resolve_device(device)
        self.repeats, self.unit, self.K, self.blocks = repeats, unit, K, blocks
        self.samples, self.warmup = int(samples), GRID_WARMUP
        g = torch.Generator(device=dev).manual_seed(seed)
        rows = units * unit
        self.a = torch.randn(rows * K, generator=g, device=dev, dtype=torch.bfloat16)
        self.b = torch.randn(K * rows, generator=g, device=dev, dtype=torch.bfloat16)
        self.c = torch.zeros(rows * rows, device=dev, dtype=torch.bfloat16)
        self.reset_counts()

    def reset_counts(self) -> None:
        self.evals = self.expected = 0
        self.eval_s = 0.0

    def run(self, i, j, r, w) -> None:
        m, n = r * self.unit, w * self.unit
        a = self.a[: m * self.K].view(m, self.K)
        b = self.b[: self.K * n].view(self.K, n)
        c = self.c[: m * n].view(m, n)
        for _ in range(self.repeats[i][j]):
            matmul_update(c, a, b, **self.blocks)

    def timings(self, i, j, r, w, n: int) -> list:
        """``n`` timings of processor ``(i, j)``'s block, in seconds, after
        ``warmup`` untimed runs of it: every run enqueued behind the one
        before, then one synchronisation."""
        for _ in range(self.warmup):
            self.run(i, j, r, w)
        events = []
        for _ in range(n):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            self.run(i, j, r, w)
            end.record()
            events.append((start, end))
        events[-1][1].synchronize()
        return [start.elapsed_time(end) / 1e3 for start, end in events]

    def seconds(self, i, j, r, w) -> float:
        """One timing of processor ``(i, j)``'s block, in seconds (after
        ``warmup`` untimed runs)."""
        return self.timings(i, j, r, w, 1)[0]

    def speed(self, i, j):
        def g(mb: float, nb: float) -> float:
            t0 = time.perf_counter()
            r, w = int(mb), int(nb)
            sec = statistics.median(self.timings(i, j, r, w, self.samples))
            self.evals += 1
            self.expected += self.repeats[i][j] * (self.warmup + self.samples)
            self.eval_s += time.perf_counter() - t0
            return r * w / sec
        return g

    def grid(self):
        return [[self.speed(i, j) for j in range(len(self.repeats[0]))] for i in range(len(self.repeats))]

    def measure(self, part) -> list:
        """Every processor's time on ``part``'s blocks, one timing each
        after ``warmup`` untimed runs (seconds, column-major as
        ``Partition.times``)."""
        return [
            self.seconds(i, j, r, w)
            for j, w in enumerate(part.col_widths) for i, r in enumerate(part.row_heights[j])
        ]
