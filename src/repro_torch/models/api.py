"""Model API: the only model surface ``serve/`` talks to. Dense family
only in this slice; other families raise.

State and reference vectors follow the reference's calling convention:
``state`` is the engine's composite device state (``{"k", "v"}`` page
pools) and ``refs`` the per-dispatch references (``"tables"`` (B, NB)).
"""
from __future__ import annotations

from typing import Union

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer


def get_model(cfg: ArchConfig):
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP.md queue 1 "
            "item 9)")
    return transformer


def init_params(seed: Union[int, torch.Generator], cfg: ArchConfig,
                device="cuda"):
    """Random parameters from a seed (or a ``torch.Generator`` on
    ``device``), laid out like the reference's value tree."""
    gen = seed
    if isinstance(seed, int):
        gen = torch.Generator(device=device).manual_seed(seed)
    return get_model(cfg).init(gen, cfg, device)


def sequence_state_spec(cfg: ArchConfig):
    return get_model(cfg).sequence_state_spec(cfg)


def prefill_paged(params, tokens, q_start, n_valid, refs, state,
                  cfg: ArchConfig):
    """One chunked-prefill step. Returns (logits (B,C,V), state)."""
    logits, pools = get_model(cfg).prefill_paged(
        params, tokens, q_start, n_valid, refs["tables"], state, cfg)
    return logits, dict(state, **pools)


def decode_step_paged(params, token, pos, refs, state, cfg: ArchConfig):
    """One decode step: token/pos (B,). Returns (logits (B,V), state)."""
    logits, pools = get_model(cfg).decode_step_paged(
        params, state, token, pos, refs["tables"], cfg)
    return logits, dict(state, **pools)


def decode_horizon_paged(params, token, pos, refs, state, eos_ids,
                         cfg: ArchConfig, *, num_steps: int,
                         use_eos: bool = True):
    """``num_steps`` fused greedy decode steps. Returns
    (tokens (B, num_steps), done (B, num_steps), state)."""
    toks, done, pools = get_model(cfg).decode_horizon_paged(
        params, state, token, pos, refs["tables"], eos_ids, cfg,
        num_steps=num_steps, use_eos=use_eos)
    return toks, done, dict(state, **pools)
