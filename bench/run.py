"""Run one cell of the port's benchmark once, on the card this process sees.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout (it imports ``src/repro_torch`` and builds
the port's kernels into ``build/``).  The last line of standard output is
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` a ``breakdown``, and last ``checks``: each
number compared with the plain reference beside its limit.  The same
numbers are the last lines of standard error.  Exits non-zero with no
result when there is no CUDA device, and when JAX or the JAX package was
loaded.  See ``bench/README.md``.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import torch  # noqa: E402

from bench.lib import harness, loader  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = loader.benchmark()
    chips = int(loader.workload(bench, args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"bench: the cell needs {chips} CUDA device(s); this process sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    print(f"bench: {args.workload} seed {args.seed} on {harness.power_limit()}, torch {torch.__version__}",
          file=sys.stderr, flush=True)
    result, checks = harness.run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace), device,
                                      T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"bench: JAX or the JAX package was loaded: {bad}", file=sys.stderr)
        return 3
    for c in checks:
        for line in c.get("detail", []):
            print(f"bench: {c['name']}: {line}", file=sys.stderr)
    for c in checks:
        print(f"check {c['name']} = {c['value']!r} limit {c['limit']!r} {'ok' if c['ok'] else 'FAILED'}",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
