"""Compare cluster sizes of ``matmul_update``'s ``"wgmma"`` kernel on one H100.

    python3 tools/matmul_cluster_sweep.py [--sizes 1,2,4] [--dfpa-runs 6]

Run from the root of a checkout, on a machine with the card.  For each
size it builds ``src/repro_torch/csrc/matmul_update.cu`` with
``CLUSTER_N`` (the blocks along N that share each A slice) set to that
size, into ``build/cluster_sweep/``, and loads it in place of the
package's library.  Then, for every size, JSON lines on standard output:

* parity against the plain version (``atol 5e-2 sqrt(K) + rtol 2e-2``) and
  two launches bit-identical, on the reference's ragged shape, two larger
  ones and the 32- and 2048-row DFPA panels;
* the three DFPA panels (32, 992 and 2048 rows of a 16384^3 bf16 update)
  timed beside ``addmm_`` on the same operands, in five interleaved
  passes, each the median of 20 CUDA-event timings;
* the DFPA loop of ``chip_smoke.py``'s ``dfpa`` phase, ``--dfpa-runs``
  times: converged, rounds, wall seconds.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import re
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tools"))

import dfpa_probe as dp  # noqa: E402
from repro_torch import _build  # noqa: E402
from repro_torch.kernels import matmul_update  # noqa: E402
from repro_torch.kernels.ref import matmul_update_ref  # noqa: E402

N = dp.N
CASES = [(100, 96, 40), (1000, 4000, 200), (128, 1024, 256), (32, N, N), (2048, N, N)]


def build(sizes) -> dict:
    src = (_build.CSRC / "matmul_update.cu").read_text()
    out_dir = ROOT / "build" / "cluster_sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for size in sizes:
        text, n = re.subn(r"constexpr int CLUSTER_N = \d+;", f"constexpr int CLUSTER_N = {size};", src)
        if n != 1:
            raise SystemExit("matmul_cluster_sweep: no CLUSTER_N constant in the source")
        cu = out_dir / f"matmul_update_cluster{size}.cu"
        cu.write_text(text)
        so = out_dir / f"libmatmul_update_cluster{size}.so"
        procs[size] = (so, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    libs = {}
    for size, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"matmul_cluster_sweep: nvcc failed for CLUSTER_N={size}:\n{log[-4000:]}")
        print(json.dumps({"cluster_n": size, "ptxas": [ln.strip() for ln in log.splitlines() if "registers" in ln]}),
              flush=True)
        libs[size] = ctypes.CDLL(str(so))
    return libs


def use(lib) -> None:
    """Route the package's ``matmul_update`` launches to ``lib``."""
    _build._libs["matmul_update"] = lib


def check(size) -> None:
    for M, n, K in CASES:
        blocks = dict(bm=32, bn=256, bk=512) if n == N else dict(bm=M, bn=n, bk=K)
        g = torch.Generator(device="cuda").manual_seed(1)
        c, a, b = (torch.randn(s, generator=g, device="cuda").to(torch.bfloat16) for s in ((M, n), (M, K), (K, n)))
        want = matmul_update_ref(c, a, b).float()
        again = c.clone()
        matmul_update(c, a, b, **blocks)
        matmul_update(again, a, b, **blocks)
        torch.cuda.synchronize()
        err = (c.float() - want).abs()
        ok = bool((err <= 5e-2 * K**0.5 + 2e-2 * want.abs()).all())
        same = torch.equal(c, again)
        print(json.dumps({"cluster_n": size, "case": [M, n, K], "ok": ok, "max_abs_err": float(err.max()),
                          "repeat_bit_identical": same}), flush=True)
        if not (ok and same):
            raise SystemExit(f"matmul_cluster_sweep: CLUSTER_N={size} fails at {(M, n, K)}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sizes", default="1,2,4")
    ap.add_argument("--dfpa-runs", type=int, default=6)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("matmul_cluster_sweep: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(json.dumps({"nvidia_smi": smi}), flush=True)
    libs = build([int(v) for v in args.sizes.split(",")])
    for size, lib in libs.items():
        use(lib)
        check(size)
    for rows in (32, 992, 2048):
        c, a, b = dp._operands(rows, 0)
        times = {k: [] for k in (*libs, "addmm_")}
        for _ in range(5):
            for size, lib in libs.items():
                use(lib)
                times[size].append(dp._cuda_ms(lambda: matmul_update(c, a, b, **dp.BLOCKS), 20))
            times["addmm_"].append(dp._cuda_ms(lambda: c.addmm_(a, b), 20))
        print(json.dumps({"rows": rows, **{f"{k}_ms": dp._spread(v) for k, v in times.items()}}), flush=True)
        del c, a, b
    for size, lib in libs.items():
        use(lib)
        runs = []
        for _ in range(args.dfpa_runs):
            out, _executor, _ = dp._dfpa_once()
            runs.append({"converged": out["converged"], "rounds": out["iterations"], "wall_s": out["wall_s"]})
        print(json.dumps({"cluster_n": size, "dfpa": runs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
