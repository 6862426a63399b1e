"""The training loop on one device, the counterpart of
``repro/train/trainer.py``.

``make_train_step`` builds the step (no shardings: one device): the
serving-dtype view of the float32 masters, the train-phase loss, its
gradients on the masters and one AdamW update. ``Trainer`` runs the loop
with the reference's semantics:

* atomic async checkpointing every ``ckpt_every`` steps and at the end
  (a step already saved is not written twice);
* restore-and-continue on an induced failure (``run(..., fail_at=)``):
  the last checkpoint is restored and the steps after it replayed on the
  same deterministic batches;
* a step-time watchdog that flags stragglers (> ``straggler_factor`` x
  the rolling median of the last 20 steps) and records them.

On CUDA tensors the exact-mode norms run their kernel forward and
backward (``kernels.ailayernorm.exact_norm``); every other hand kernel
refuses inputs that require grad, so a train config that would reach one
(a SOLE ``train_*_mode``) fails loudly. A failure other than the induced
one raises instead of restoring.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.convert import serving_view
from repro_torch.data.pipeline import make_batch
from repro_torch.models import api
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.optimizer import (OptConfig, _leaves, _unflatten_like,
                                         adamw_update, init_opt_state)


class InducedFailure(RuntimeError):
    """The test hook's node failure (``Trainer.run(fail_at=)``)."""


def batch_to_device(batch, device) -> Dict[str, torch.Tensor]:
    """A ``make_batch`` dict (numpy) as tensors on ``device``."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


def loss_and_grads(params, batch, cfg: ArchConfig):
    """(loss, {"xent", "aux"}, grads): the train-phase loss of the
    serving-dtype view of the float32 masters ``params`` and its
    gradients on them (float32, the masters' tree)."""
    leaves = [p.detach().requires_grad_(True) for p in _leaves(params)]
    masters = _unflatten_like(params, leaves)
    with torch.enable_grad():
        loss, metrics = api.loss_fn(serving_view(masters, cfg), batch, cfg)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            _unflatten_like(params, grads))


def make_train_step(cfg: ArchConfig, opt_cfg: OptConfig):
    """``step(params, opt_state, batch) -> (params, opt_state, metrics)``
    with metrics ``{"xent", "aux", "loss", "grad_norm", "lr"}`` as 0-dim
    tensors. The masters and moments are updated in place
    (``adamw_update``)."""

    def step_fn(params, opt_state, batch):
        loss, metrics, grads = loss_and_grads(params, batch, cfg)
        new_params, new_opt, opt_metrics = adamw_update(
            params, grads, opt_state, opt_cfg)
        return new_params, new_opt, dict(metrics, loss=loss, **opt_metrics)

    return step_fn


@dataclasses.dataclass
class Trainer:
    cfg: ArchConfig
    shape: ShapeConfig
    opt_cfg: OptConfig
    _: dataclasses.KW_ONLY
    device: Any = "cuda"
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    seed: int = 0
    straggler_factor: float = 2.5

    def __post_init__(self):
        self.device = torch.device(self.device)
        # float32 masters
        self.params = api.init_params(self.seed, self.cfg, self.device,
                                      masters=True)
        self.opt_state = init_opt_state(self.params)
        self.step_fn = make_train_step(self.cfg, self.opt_cfg)
        self.step = 0
        self.metrics_log = []
        self.step_times = []
        self.stragglers = []
        self.saver = (ckpt.AsyncSaver(self.ckpt_dir)
                      if self.ckpt_dir else None)
        self.saved_step: Optional[int] = None

    # -- fault tolerance ----------------------------------------------------
    def state_tree(self):
        return {"params": self.params, "opt": self.opt_state}

    def save(self):
        if self.saver and self.saved_step != self.step:
            self.saver.save(self.step, self.state_tree())
            self.saved_step = self.step

    def restore(self, step: Optional[int] = None):
        step, tree = ckpt.restore(self.ckpt_dir, self.state_tree(),
                                  step=step, device=self.device)
        self.params, self.opt_state = tree["params"], tree["opt"]
        self.step = step
        return step

    # -- loop -----------------------------------------------------------------
    def run(self, num_steps: int, *, fail_at: Optional[int] = None
            ) -> Dict[str, Any]:
        """Train to step ``num_steps``; ``fail_at`` induces a failure at
        that step (test hook)."""
        while self.step < num_steps:
            batch = batch_to_device(
                make_batch(self.cfg, self.shape, self.step, seed=self.seed),
                self.device)
            t0 = time.perf_counter()
            try:
                if fail_at is not None and self.step == fail_at:
                    fail_at = None
                    raise InducedFailure("induced node failure")
                self.params, self.opt_state, metrics = self.step_fn(
                    self.params, self.opt_state, batch)
                metrics = {k: float(v) for k, v in metrics.items()}
            except InducedFailure:
                # node failure: restore the last checkpoint and continue
                if self.saver:
                    self.saver.wait()
                failed = self.step
                restored = self.restore()
                print(f"[trainer] failure at step {failed}; "
                      f"restored step {restored}")
                continue
            dt = time.perf_counter() - t0
            self._watchdog(dt)
            self.metrics_log.append({"step": self.step, **metrics,
                                     "step_time": dt})
            self.step += 1
            if self.saver and self.step % self.ckpt_every == 0:
                self.save()
        if self.saver:
            self.save()
            self.saver.wait()
        return {"final_loss": self.metrics_log[-1]["loss"],
                "metrics": self.metrics_log,
                "stragglers": self.stragglers}

    def _watchdog(self, dt: float):
        self.step_times.append(dt)
        hist = self.step_times[-20:]
        med = float(np.median(hist))
        if len(hist) >= 5 and dt > self.straggler_factor * med:
            self.stragglers.append({"step": self.step, "time": dt,
                                    "median": med})
