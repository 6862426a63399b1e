"""Model API: the only model surface ``serve/`` talks to, for every family
of the JAX package: dense, MoE, encdec (whisper), vlm (qwen2-vl), ssm
(rwkv6) and hybrid (RecurrentGemma).

The dense-slot engine calls :func:`prefill` / :func:`decode_step` on
stacked caches (:func:`init_cache`). The paged calls follow the
reference's single calling convention: ``state`` is the engine's
composite device state (``{"k", "v"}`` page pools and/or ``"slots"``, a
``StateSlotPool``'s tree) and ``refs`` the per-dispatch references
(``"tables"`` (B, NB) and/or ``"slots"`` (B,)), only the keys the
family's :func:`sequence_state_spec` calls for (encdec adds ``"cross"``
(B, NBc) cross-page tables and ``"cross_valid"`` (B,)). Dense and MoE keep
their ``(tables, pools)`` signatures behind adapters here. A family whose
spec is not ``servable`` (vlm) raises from every paged entry.

Encdec and vlm take a batch dict where the LM families take tokens:
``{"frames", "tokens"}`` and ``{"embeds", "positions"}`` for
:func:`forward` and :func:`prefill`.
"""
from __future__ import annotations

from typing import Union

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import (moe, rglru, rwkv6, transformer, vlm,
                                whisper)

_FAMILY_MODULES = {"dense": transformer, "moe": moe, "encdec": whisper,
                   "vlm": vlm, "ssm": rwkv6, "hybrid": rglru}
_PAGES_ONLY = ("dense", "moe")
_BATCH_DICT = ("encdec", "vlm")


def get_model(cfg: ArchConfig):
    mod = _FAMILY_MODULES.get(cfg.family)
    if mod is None:
        raise ValueError(f"unknown family {cfg.family!r} (known: "
                         f"{sorted(_FAMILY_MODULES)})")
    return mod


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


def _check_servable(cfg: ArchConfig) -> None:
    if not sequence_state_spec(cfg).servable:
        raise ValueError(
            f"family {cfg.family!r} is not paged-servable "
            "(see its sequence_state_spec)")


def forward(params, batch, cfg: ArchConfig, phase: str = "serve"):
    """batch {"tokens": (B, S)} (encdec: also "frames"; vlm: "embeds" and
    "positions") -> logits (B, S, padded_vocab) float32 (an MoE model's
    aux loss is dropped, as the reference's API does)."""
    m = get_model(cfg)
    if cfg.family in _BATCH_DICT:
        return m.forward(params, batch, cfg, phase)
    out = m.forward(params, batch["tokens"], cfg, phase)
    return out[0] if cfg.family == "moe" else out


def init_cache(cfg: ArchConfig, batch: int, length: int, device="cuda"):
    """Empty dense-slot caches for ``batch`` lanes of ``length`` tokens."""
    return get_model(cfg).init_cache(cfg, batch, length, device)


def prefill(params, tokens, cfg: ArchConfig, cache_len: int, n_pad=None):
    """Whole-prompt prefill of tokens (B, S) (encdec and vlm: their batch
    dict) into a fresh cache of ``cache_len`` columns. Returns
    (last-position logits (B, 1, V), cache)."""
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
    _check_servable(cfg)
    m = get_model(cfg)
    if cfg.family not in _PAGES_ONLY:
        return m.prefill_paged(params, tokens, q_start, n_valid, refs, state,
                               cfg)
    logits, pools = m.prefill_paged(params, tokens, q_start, n_valid,
                                    refs["tables"], state, cfg)
    return logits, dict(state, **pools)


def decode_step_paged(params, token, pos, refs, state, cfg: ArchConfig):
    """One decode step: token/pos (B,). Returns (logits (B,V), state)."""
    _check_servable(cfg)
    m = get_model(cfg)
    if cfg.family not in _PAGES_ONLY:
        return m.decode_step_paged(params, token, pos, refs, state, cfg)
    logits, pools = m.decode_step_paged(params, state, token, pos,
                                        refs["tables"], cfg)
    return logits, dict(state, **pools)


def decode_horizon_paged(params, token, pos, refs, state, temperature,
                         top_k, seed, counter, eos_ids, cfg: ArchConfig, *,
                         num_steps: int, use_top_k: bool = True,
                         stochastic: bool = True, use_eos: bool = True):
    """``num_steps`` fused decode+sample steps. Returns
    (tokens (B, num_steps), done (B, num_steps), state)."""
    _check_servable(cfg)
    if cfg.family not in _PAGES_ONLY:
        return get_model(cfg).decode_horizon_paged(
            params, token, pos, refs, state, temperature, top_k, seed,
            counter, eos_ids, cfg, num_steps=num_steps, use_top_k=use_top_k,
            stochastic=stochastic, use_eos=use_eos)
    toks, done, pools = get_model(cfg).decode_horizon_paged(
        params, state, token, pos, refs["tables"], temperature, top_k, seed,
        counter, eos_ids, cfg, num_steps=num_steps, use_top_k=use_top_k,
        stochastic=stochastic, use_eos=use_eos)
    return toks, done, dict(state, **pools)


def verify_paged(params, tokens, q_start, n_valid, refs, state, temperature,
                 top_k, seed, counter, eos_ids, cfg: ArchConfig, *,
                 use_top_k: bool = True, stochastic: bool = True,
                 use_eos: bool = True):
    """Speculative-verify dispatch (families whose state can rewind
    rejected drafts). Returns (pinned (B, C), done (B, C), state)."""
    if not sequence_state_spec(cfg).supports_spec_decode:
        raise ValueError(
            f"family {cfg.family!r} does not support speculative decoding "
            "(its sequence state cannot rewind rejected drafts)")
    pinned, done, pools = get_model(cfg).verify_paged(
        params, state, tokens, q_start, n_valid, refs["tables"], temperature,
        top_k, seed, counter, eos_ids, cfg, use_top_k=use_top_k,
        stochastic=stochastic, use_eos=use_eos)
    return pinned, done, dict(state, **pools)


def encode_paged(params, frames, cross_table, state, cfg: ArchConfig):
    """Admission-time encoder run (encdec only): park every decoder
    layer's cross K/V in the request's cross pages. Returns the state."""
    if cfg.family != "encdec":
        raise ValueError(f"encode_paged is encdec-only, got {cfg.family}")
    return get_model(cfg).encode_paged(params, frames, cross_table, state,
                                       cfg)
