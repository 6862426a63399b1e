"""Fault-tolerant checkpointing, the counterpart of
``repro/train/checkpoint.py``, in the reference's on-disk format: a
checkpoint written by either package restores in the other.

* Format: ``<dir>/step-<n>/arrays.npz`` with ``leaf_<i>`` in
  ``jax.tree.flatten``'s order (dict keys sorted at every level),
  ``meta.json`` ``{"step", "n_leaves"}`` and ``<dir>/LATEST``.
* Atomic: written to ``tmp-<step>``, fsynced, renamed to ``step-<n>``,
  then ``LATEST`` replaced — a crash mid-save never corrupts the last good
  checkpoint.
* Restore onto a device: arrays load on the host and move to the
  template leaf's device (or ``device=``), the one-device form of the
  reference's resharding restore.
* Async: :class:`AsyncSaver` copies the tree to host memory synchronously
  and writes it in a background thread, overlapping the I/O with the next
  train steps.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.train.optimizer import _leaves, _unflatten_like


def _host(x) -> np.ndarray:
    """A host copy (never a view: the trainer updates its tensors in
    place while a save is in flight)."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True).numpy()
    return np.array(x)


def _flatten(tree) -> dict:
    return {f"leaf_{i}": _host(x) for i, x in enumerate(_leaves(tree))}


def save(ckpt_dir: str, step: int, tree: Any, *, keep: int = 3) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    arrays = _flatten(tree)
    tmp = os.path.join(ckpt_dir, f"tmp-{step}")
    final = os.path.join(ckpt_dir, f"step-{step}")
    os.makedirs(tmp, exist_ok=True)
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump({"step": step, "n_leaves": len(arrays)}, f)
    for name in os.listdir(tmp):
        fd = os.open(os.path.join(tmp, name), os.O_RDONLY)
        os.fsync(fd)
        os.close(fd)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    with open(os.path.join(ckpt_dir, "LATEST.tmp"), "w") as f:
        f.write(str(step))
    os.replace(os.path.join(ckpt_dir, "LATEST.tmp"),
               os.path.join(ckpt_dir, "LATEST"))
    _gc(ckpt_dir, keep)
    return final


def _gc(ckpt_dir: str, keep: int) -> None:
    steps = sorted(int(d.split("-")[1]) for d in os.listdir(ckpt_dir)
                   if d.startswith("step-"))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step-{s}"),
                      ignore_errors=True)


def latest_step(ckpt_dir: str) -> Optional[int]:
    path = os.path.join(ckpt_dir, "LATEST")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return int(f.read().strip())


def restore(ckpt_dir: str, template: Any, *, step: Optional[int] = None,
            device=None) -> Tuple[int, Any]:
    """Restore onto ``template``'s structure: (step, tree of tensors).

    ``template``'s leaves are tensors or numpy arrays (their shapes are
    checked); each restored leaf goes to ``device`` if given, else to its
    template leaf's device (numpy templates: the CPU)."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step-{step}")
    data = np.load(os.path.join(path, "arrays.npz"))
    leaves = _leaves(template)
    if len(data.files) != len(leaves):
        raise ValueError(f"checkpoint has {len(data.files)} leaves, "
                         f"template has {len(leaves)}")
    arrays = [data[f"leaf_{i}"] for i in range(len(leaves))]
    for i, (a, t) in enumerate(zip(arrays, leaves)):
        if tuple(a.shape) != tuple(t.shape):
            raise ValueError(f"leaf {i}: shape {a.shape} != {t.shape}")
    out = []
    for a, t in zip(arrays, leaves):
        dev = device if device is not None else (
            t.device if isinstance(t, torch.Tensor) else "cpu")
        out.append(torch.from_numpy(np.array(a)).to(dev))
    return step, _unflatten_like(template, out)


class AsyncSaver:
    """Overlaps checkpoint I/O with training (one in-flight save)."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self.last_error: Optional[BaseException] = None
        # step -> (seconds to snapshot to host, seconds to write)
        self.times: Dict[int, Tuple[float, float]] = {}

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.last_error is not None:
            err, self.last_error = self.last_error, None
            raise err

    def save(self, step: int, tree: Any) -> None:
        self.wait()
        t0 = time.perf_counter()
        host_tree = _unflatten_like(tree, [_host(x) for x in _leaves(tree)])
        snap = time.perf_counter() - t0

        def _write():
            try:
                t1 = time.perf_counter()
                save(self.ckpt_dir, step, host_tree, keep=self.keep)
                self.times[step] = (snap, time.perf_counter() - t1)
            except BaseException as e:  # surfaced on next wait()
                self.last_error = e

        self._thread = threading.Thread(target=_write, daemon=True)
        self._thread.start()
