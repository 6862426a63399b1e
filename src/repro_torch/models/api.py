"""Model API: the only model surface ``serve/`` talks to. Dense family
only in this slice; other families raise.

The dense-slot engine calls :func:`prefill` / :func:`decode_step` on
stacked caches (:func:`init_cache`). The paged calls follow the
reference's calling convention: ``state`` is the engine's composite
device state (``{"k", "v"}`` page pools) and ``refs`` the per-dispatch
references (``"tables"`` (B, NB)).
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
            "item 7)")
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


def forward(params, batch, cfg: ArchConfig, phase: str = "serve"):
    """batch {"tokens": (B, S)} -> logits (B, S, padded_vocab) float32."""
    return get_model(cfg).forward(params, batch["tokens"], cfg, phase)


def init_cache(cfg: ArchConfig, batch: int, length: int, device="cuda"):
    """Empty dense-slot caches for ``batch`` lanes of ``length`` tokens."""
    return get_model(cfg).init_cache(cfg, batch, length, device)


def prefill(params, tokens, cfg: ArchConfig, cache_len: int, n_pad=None):
    """Whole-prompt prefill of tokens (B, S) into a fresh cache of
    ``cache_len`` columns. Returns (last-position logits (B, 1, V), cache)."""
    return get_model(cfg).prefill(params, tokens, cfg, cache_len,
                                  n_pad=n_pad)


def decode_step(params, cache, token, pos, cfg: ArchConfig, write_pos=None):
    """One decode step on the dense-slot cache (updated in place). Returns
    (logits (B, V), cache)."""
    return get_model(cfg).decode_step(params, cache, token, pos, cfg,
                                      write_pos=write_pos)


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


def decode_horizon_paged(params, token, pos, refs, state, temperature,
                         top_k, seed, counter, eos_ids, cfg: ArchConfig, *,
                         num_steps: int, use_top_k: bool = True,
                         stochastic: bool = True, use_eos: bool = True):
    """``num_steps`` fused decode+sample steps. Returns
    (tokens (B, num_steps), done (B, num_steps), state)."""
    toks, done, pools = get_model(cfg).decode_horizon_paged(
        params, state, token, pos, refs["tables"], temperature, top_k, seed,
        counter, eos_ids, cfg, num_steps=num_steps, use_top_k=use_top_k,
        stochastic=stochastic, use_eos=use_eos)
    return toks, done, dict(state, **pools)
