"""Elastic restore and straggler mitigation, the counterpart of
``repro/train/elastic.py`` on one device.

1. **Re-placement** (:func:`reshard_checkpoint`): checkpoints are host
   npz trees; restoring moves every leaf to the target device. The mesh
   form (a different data/model mesh) waits for training over a mesh
   (ROADMAP queue 1 item 9.3) and raises. Because the data pipeline is a
   pure function of (seed, step, shard), a resumed run consumes exactly
   the remaining data.
2. **Straggler mitigation** (:func:`drop_slowest_microbatch`): zero the
   gradient contribution of flagged microbatches and renormalize over the
   rest.
3. **Failure recovery**: ``Trainer.run`` restores the last atomic
   checkpoint and replays.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.train import checkpoint as ckpt


def reshard_checkpoint(ckpt_dir: str, template: Any, target=None, *,
                       step: Optional[int] = None):
    """Restore a checkpoint onto ``target``, a device (or None: each
    template leaf's own). A mesh target raises: the port has no sharded
    layout yet."""
    if target is not None and not isinstance(target, (str, torch.device)):
        raise NotImplementedError(
            "restoring onto a mesh needs training over a mesh "
            "(ROADMAP queue 1 item 9.3); pass a device")
    return ckpt.restore(ckpt_dir, template, step=step, device=target)


def drop_slowest_microbatch(grads: Any, microbatch_ok: torch.Tensor):
    """Mask out flagged microbatches' gradient and renormalize.

    ``microbatch_ok``: bool (num_micro,) — False for straggler shards.
    Gradients are stacked over a leading microbatch axis; each leaf comes
    back float32 without it: ``sum_i w_i g_i / max(sum w, 1)``."""
    w = microbatch_ok.to(torch.float32)
    denom = torch.clamp_min(torch.sum(w), 1.0)

    def mask(g):
        if isinstance(g, dict):
            return {k: mask(v) for k, v in g.items()}
        return torch.tensordot(w.to(g.device), g.float(), dims=1) / denom

    return mask(grads)
