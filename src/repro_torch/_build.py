"""Build and load the package's CUDA kernels.

Every ``csrc/<name>.cu`` has a plain C interface.  At first use it is
compiled by ``nvcc`` for ``sm_90a`` into a shared library under
``build/repro_torch/`` at the repository root, keyed by a hash of the source
and the flags (a changed source builds anew, an unchanged one is reused),
and loaded with ``ctypes``.  :func:`build` starts one ``nvcc`` per source,
all at once, and waits for them together.

Nothing here runs at import: the CPU tests import every module of the
package on a machine with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Sequence

__all__ = ["Built", "build", "load", "nvcc_path", "BUILD_DIR", "CSRC"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


@dataclass
class Built:
    """One compiled source: the library path, the compiler's output (the
    ``ptxas -v`` register / spill / shared-memory report) and the seconds
    the compile took (0.0 when an earlier build was reused)."""

    name: str
    path: Path
    log: str
    seconds: float

    def ptxas_lines(self) -> List[str]:
        return [
            ln.strip() for ln in self.log.splitlines()
            if "registers" in ln or "spill" in ln or "smem" in ln
        ]


_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """``nvcc`` from ``$CUDA_HOME``, the ``PATH``, or the toolkit's default
    install prefix; raises when there is none."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(str(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc"))
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if Path(c).is_file():
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    key = hashlib.sha256(src + "\0".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{key}.so"


def build(names: Optional[Sequence[str]] = None) -> Dict[str, Built]:
    """Compile ``csrc/<name>.cu`` for every name (default: every source),
    all ``nvcc`` processes at once; raises if any fails."""
    if names is None:
        names = sorted(p.stem for p in CSRC.glob("*.cu"))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out: Dict[str, Built] = {}
    running = []
    for name in names:
        target = _target(name)
        if target.exists():
            out[name] = Built(name, target, "", 0.0)
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running.append((name, target, tmp, proc, time.perf_counter()))
    for name, target, tmp, proc, t0 in running:
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
        os.replace(tmp, target)
        out[name] = Built(name, target, log, seconds)
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    lib = _libs.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name].path))
        _libs[name] = lib
    return lib
