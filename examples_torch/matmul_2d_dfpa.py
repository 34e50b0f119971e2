"""2-D heterogeneous matmul partitioning (paper §3.2), end to end.

Compares the three applications of Fig. 10 on a 4x4 processor grid —
CPM (constant models), FFMPA (pre-built full models), and DFPA
(dynamically built partial models) — all through the ``Scheduler`` facade:
the same ``partition_grid(M, N)`` call, three policies.

The PyTorch twin of ``examples/matmul_2d_dfpa.py``: the three sessions keep
their banks on the card (``backend="torch"``), where each inner round's
stacked repartition and fold-in run; the speed functions stay on the host.

    PYTHONPATH=src python examples_torch/matmul_2d_dfpa.py [--device cpu]
"""

import argparse

from repro_torch.core import (
    HCL_SPECS,
    Policy,
    Scheduler,
    app_time_2d,
    speed_fn_2d,
)

P, Q, M, N = 4, 4, 512, 512


def main(device="cuda") -> dict:
    specs = HCL_SPECS[: P * Q]
    grid = [[speed_fn_2d(specs[i * Q + j]) for j in range(Q)] for i in range(P)]

    cpm = Scheduler(grid=grid, policy=Policy.CPM, device=device).partition_grid(M, N)
    ff = Scheduler(grid=grid, policy=Policy.FFMPA, device=device).partition_grid(
        M, N, eps=0.1, max_outer=50
    )
    df = Scheduler(grid=grid, policy=Policy.GRID2D, device=device).partition_grid(M, N, eps=0.1)

    t_cpm = app_time_2d(grid, cpm, K=N) + cpm.diagnostics["bench_cost"]
    t_ff = app_time_2d(grid, ff, K=N)
    t_df = app_time_2d(grid, df, K=N) + df.diagnostics["bench_cost"]

    print(f"grid {P}x{Q}, matrix {M}x{N} (block units)")
    print(f"CPM   : {t_cpm:8.2f}s   (1 benchmark round; misestimates paging nodes)")
    print(f"FFMPA : {t_ff:8.2f}s   (needs pre-built full models: expensive offline)")
    print(f"DFPA  : {t_df:8.2f}s   ({df.diagnostics['total_rounds']} online rounds, "
          f"{df.diagnostics['bench_cost']:.2f}s partitioning)")
    print(f"\nDFPA column widths: {df.col_widths}")
    for j in range(Q):
        print(f"  column {j}: rows {df.row_heights[j]}")
    print(f"\nCPM is {t_cpm / t_df:.2f}x slower than DFPA (paper Fig. 10: ~1.25x;")
    print("deep-paging nodes make the gap larger on this grid).")
    return {
        "claims": {"dfpa_faster_than_cpm": t_df < t_cpm},
        "t_cpm": t_cpm,
        "t_ffmpa": t_ff,
        "t_dfpa": t_df,
        "dfpa_rounds": df.diagnostics["total_rounds"],
        "col_widths": list(df.col_widths),
        "row_heights": [list(r) for r in df.row_heights],
    }


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="torch device (default: the card)")
    main(ap.parse_args().device)
