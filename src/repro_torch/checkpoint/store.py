"""Atomic, async checkpoints in the reference's on-disk format.

The port's copy of the reference's ``checkpoint/store.py``:

  * ATOMIC   — write to ``<dir>/tmp.<step>``, fsync, then ``os.replace`` to
    ``<dir>/step_<n>``; a crash mid-write can never corrupt the latest good
    checkpoint; ``latest`` symlink updated last.
  * ASYNC    — ``CheckpointManager.save_async`` copies the tree to host
    memory synchronously and writes in a background thread, so training
    resumes (and may update its tensors in place) immediately; ``wait()``
    joins before the next save.
  * MANIFEST — JSON with the step, the caller's extra state (data
    pipeline, balance) and the flattened tree paths.
  * FORMAT   — ``manifest.json`` plus ``arrays.npz`` keyed by the
    reference's tree paths (``train/params/units/0/attn/wq``: dict keys
    sorted, tuple indices, NamedTuple field names), so each package
    restores the other's checkpoint.  A model's parameters go in as the
    reference's stacked tree (the training state holds them so; a serving
    ``LanguageModel`` reaches it through ``nn.convert.stack_tree``).

  * RESHARD  — ``load_checkpoint(..., shardings=tree)`` places each leaf
    by its ``sharding.NamedSharding`` (a tree of ``like``'s structure, None
    leaves keeping the default placement), as the reference re-shards a
    restore onto the current mesh.  The port's mesh is one card
    (``launch.mesh``): a leaf goes whole onto its mesh's device, and a spec
    that splits a dim over a mesh axis larger than 1 is refused before
    anything is read.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..nn.convert import to_numpy, tree_from_reference

__all__ = ["save_checkpoint", "load_checkpoint", "CheckpointManager"]

_SEP = "/"


def _children(node):
    """``(key, child)`` pairs in the reference's flatten order, or None for
    a leaf."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return list(zip(node._fields, node))
    if isinstance(node, (tuple, list)):
        return [(str(i), v) for i, v in enumerate(node)]
    return None


def _flatten(tree, prefix: Tuple = ()) -> Dict[str, np.ndarray]:
    """Every leaf as a numpy array on the host (a copy) under its path."""
    if tree is None:
        return {}
    kids = _children(tree)
    if kids is None:
        return {_SEP.join(prefix): np.array(to_numpy(tree), copy=True)}
    flat: Dict[str, np.ndarray] = {}
    for k, v in kids:
        flat.update(_flatten(v, prefix + (k,)))
    return flat


def save_checkpoint(
    directory: str,
    step: int,
    tree: Any,
    *,
    extra: Optional[Dict[str, Any]] = None,
) -> str:
    """Synchronous atomic save. Returns the final checkpoint path."""
    return _write(directory, step, _flatten(tree), extra)


def _write(directory: str, step: int, flat: Dict[str, np.ndarray], extra) -> str:
    os.makedirs(directory, exist_ok=True)
    tmp = os.path.join(directory, f"tmp.{step}")
    final = os.path.join(directory, f"step_{step:010d}")
    os.makedirs(tmp, exist_ok=True)
    np.savez(os.path.join(tmp, "arrays.npz"), **flat)
    manifest = {
        "step": int(step),
        "keys": sorted(flat.keys()),
        "extra": extra or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    # update 'latest' pointer last (atomic symlink swap)
    link = os.path.join(directory, "latest")
    tmp_link = os.path.join(directory, ".latest.tmp")
    if os.path.lexists(tmp_link):
        os.remove(tmp_link)
    os.symlink(os.path.basename(final), tmp_link)
    os.replace(tmp_link, link)
    return final


def _restore(like, data, prefix: Tuple, device, shd=None):
    """``like``'s structure with each leaf read from ``data`` under its path,
    cast to the leaf's dtype, on the leaf's device (``device`` for ``meta``
    leaves and numpy leaves when given), or on its sharding's mesh device
    when ``shd`` (walked alongside) gives one."""
    if like is None:
        return None
    sub = lambda key: shd[key] if shd is not None else None
    if isinstance(like, dict):
        return {k: _restore(v, data, prefix + (str(k),), device, sub(k)) for k, v in like.items()}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_restore(v, data, prefix + (f,), device, sub(i))
                            for i, (f, v) in enumerate(zip(like._fields, like))))
    if isinstance(like, (tuple, list)):
        return type(like)(_restore(v, data, prefix + (str(i),), device, sub(i)) for i, v in enumerate(like))
    arr = data[_SEP.join(prefix)]
    if shd is not None:
        t = tree_from_reference(arr).to(device=shd.mesh.device, dtype=_torch_dtype(getattr(like, "dtype", None)))
        if isinstance(like, torch.Tensor) and t.is_floating_point():
            t.requires_grad_(like.requires_grad)
        return t
    if isinstance(like, torch.Tensor):
        dev = like.device
        if dev.type == "meta":
            dev = torch.device(device if device is not None else "cpu")
        t = tree_from_reference(arr).to(device=dev, dtype=like.dtype)
        return t.requires_grad_(like.requires_grad) if t.is_floating_point() else t
    want = getattr(like, "dtype", arr.dtype)
    return arr.astype(want)


def _torch_dtype(dtype):
    """A torch dtype for ``dtype`` (torch's or numpy's; None keeps the
    stored one)."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.zeros(0, dtype=np.dtype(dtype))).dtype


def _check_shardings(shardings) -> None:
    """Refuse a sharding that splits a dim over a mesh axis larger than 1."""
    if shardings is None:
        return
    kids = _children(shardings)
    if kids is not None:
        for _, v in kids:
            _check_shardings(v)
        return
    split = shardings.split_axes()
    if split:
        raise NotImplementedError(
            f"sharding {shardings.spec} splits a dim over mesh axes {split}: the port restores onto one "
            "card, whole tensors on its mesh's device"
        )


def _paths(like, prefix: Tuple = ()) -> list:
    if like is None:
        return []
    kids = _children(like)
    if kids is None:
        return [_SEP.join(prefix)]
    return [p for k, v in kids for p in _paths(v, prefix + (k,))]


def load_checkpoint(
    directory: str,
    like: Any,
    *,
    step: Optional[int] = None,
    shardings: Any = None,
    device=None,
) -> Tuple[Any, Dict[str, Any]]:
    """Restore into the structure of ``like`` (a tree of tensors, ``meta``
    tensors such as ``nn.spec_tree_shapes`` gives, or numpy arrays), each
    leaf in its dtype and on its device (``meta`` leaves on ``device``, the
    host by default); a tensor leaf keeps ``like``'s ``requires_grad``.
    ``shardings`` (``like``'s structure, ``NamedSharding`` or None leaves)
    places each leaf on its mesh's device.  Returns (tree, manifest)."""
    _check_shardings(shardings)
    if step is None:
        path = os.path.join(directory, "latest")
        if not os.path.exists(path):
            raise FileNotFoundError(f"no checkpoint in {directory}")
        path = os.path.realpath(path)
    else:
        path = os.path.join(directory, f"step_{step:010d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    data = np.load(os.path.join(path, "arrays.npz"))
    missing = [k for k in _paths(like) if k not in data]
    if missing:
        raise KeyError(f"checkpoint missing keys: {missing[:5]}... ({len(missing)})")
    return _restore(like, data, (), device, shardings), manifest


class CheckpointManager:
    """Async wrapper with retention: keeps the last ``keep`` checkpoints."""

    def __init__(self, directory: str, *, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save_async(self, step: int, tree: Any, *, extra=None) -> None:
        self.wait()
        flat = _flatten(tree)  # snapshot (host copies) before training continues

        def work():
            try:
                _write(self.directory, step, flat, extra)
                self._gc()
            except BaseException as e:  # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def _gc(self) -> None:
        if not os.path.isdir(self.directory):
            return
        steps = sorted(
            d for d in os.listdir(self.directory) if d.startswith("step_")
        )
        for d in steps[: -self.keep] if self.keep > 0 else []:
            shutil.rmtree(os.path.join(self.directory, d), ignore_errors=True)

    def latest_step(self) -> Optional[int]:
        link = os.path.join(self.directory, "latest")
        if not os.path.exists(link):
            return None
        return int(os.path.basename(os.path.realpath(link)).split("_")[1])
