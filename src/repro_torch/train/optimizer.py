"""AdamW with global-norm clipping and a cosine schedule, the counterpart
of ``repro/train/optimizer.py``: elementwise torch ops in the reference's
arithmetic order on the same ``{"step", "mu", "nu"}`` tree.

Parameters are float32 masters (``api.init_params(..., masters=True)``,
``convert.params_from_jax(..., masters=True)``); each step's forward runs
on their serving-dtype view (``convert.serving_view``). Moments are
float32. Every scalar (step, lr, the clip scale, the bias corrections)
is a 0-dim tensor on the parameters' device, so an update reads nothing
back to the host.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1


def _leaves(tree):
    """Leaves in ``jax.tree.flatten``'s order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def _unflatten_like(tree, leaves):
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        return next(it)
    return build(tree)


def schedule(step: torch.Tensor, cfg: OptConfig) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``min_lr_ratio``; float32."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp_max(step / max(cfg.warmup_steps, 1), 1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def init_opt_state(params) -> Dict[str, Any]:
    def zeros(t):
        if isinstance(t, dict):
            return {k: zeros(v) for k, v in t.items()}
        return torch.zeros(t.shape, dtype=torch.float32, device=t.device)
    dev = _leaves(params)[0].device
    return {"step": torch.zeros((), dtype=torch.int32, device=dev),
            "mu": zeros(params), "nu": zeros(params)}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves (in flatten order, from 0) of each
    leaf's float32 sum of squares."""
    total = 0
    for x in _leaves(tree):
        total = total + torch.sum(torch.square(x.float()))
    return torch.sqrt(total)


def adamw_update(params, grads, state, cfg: OptConfig
                 ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step, in place: the new params and moments are written
    into the given tensors (the reference's functional update's
    arithmetic, without a second copy of the trees). Returns (params,
    state, {"grad_norm", "lr"}): the trees given, the state's step
    advanced. Decay applies to leaves of two or more dimensions only."""
    with torch.no_grad():
        step = state["step"] + 1
        gnorm = global_norm(grads)
        scale = torch.clamp_max(cfg.clip_norm / torch.clamp_min(gnorm, 1e-9),
                                1.0)
        lr = schedule(step, cfg)
        b1, b2 = cfg.beta1, cfg.beta2
        stepf = step.to(torch.float32)
        c1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                        device=stepf.device), stepf)
        c2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                        device=stepf.device), stepf)
        for p, g, mu, nu in zip(_leaves(params), _leaves(grads),
                                _leaves(state["mu"]), _leaves(state["nu"])):
            g = g.float() * scale
            mu.copy_(b1 * mu + (1 - b1) * g)
            nu.copy_(b2 * nu + (1 - b2) * torch.square(g))
            mhat = mu / c1
            nhat = nu / c2
            step_vec = mhat / (torch.sqrt(nhat) + cfg.eps)
            decay = cfg.weight_decay if p.ndim >= 2 else 0.0
            p.sub_(lr * (step_vec + decay * p))
        return (params, dict(state, step=step),
                {"grad_norm": gnorm, "lr": lr})
