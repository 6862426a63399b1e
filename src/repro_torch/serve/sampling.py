"""Greedy token sampling and finish events for the serve engine.

A draw is the argmax over the first ``vocab_size`` logits, first index
on ties — on the device inside a decode horizon (:func:`greedy_tokens`)
and on the host for the prefill-logits first token (:class:`Sampler`).
Stochastic sampling (temperature > 0) keys Gumbel noise on a threefry
stream bit-compatible with the reference's ``jax.random``; it is not
ported yet and :class:`Sampler` raises for it.

**Finish events.** ``eos_ids`` end generation the moment one is sampled;
``stop`` holds multi-token sequences matched over the generated tokens.
A decode horizon keeps sampling past a finish event, so the host cuts
each lane at its first event (:func:`apply_finish`) and the tokens after
it never enter the stream.
"""
from __future__ import annotations

from typing import List, Optional, Sequence as Seq, Tuple

import numpy as np
import torch


def greedy_tokens(logits: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """(B, padded_vocab) logits -> (B,) int32 argmax over the real vocab."""
    return torch.argmax(logits[:, :vocab_size].float(), -1).to(torch.int32)


def eos_hits(tokens, eos_ids):
    """Membership mask of ``tokens`` in a ``-1``-padded eos table
    (``(E,)`` or ``(B, E)``); torch tensors in the decode horizon, numpy
    on the host."""
    if isinstance(tokens, torch.Tensor):
        eos_ids = torch.as_tensor(eos_ids, device=tokens.device)
        return ((tokens[..., None] == eos_ids) & (eos_ids >= 0)).any(-1)
    eos_ids = np.asarray(eos_ids)
    toks = np.asarray(tokens)[..., None]
    return np.any((toks == eos_ids) & (eos_ids >= 0), axis=-1)


def apply_finish(sampler: "Sampler", out: List[int], new_tokens: Seq[int],
                 eos_row: Optional[Seq[bool]] = None,
                 ) -> Tuple[int, Optional[str]]:
    """Extend ``out`` with ``new_tokens``, cut at the earliest finish
    event; the finishing token is kept. ``eos_row`` is the device's eos
    mask when it computed one. Stop sequences may span the previous
    output. Returns ``(kept, reason)`` with ``reason`` in
    ``{"eos", "stop", None}``; eos wins a tie on the same token."""
    prev = len(out)
    kept = len(new_tokens)
    reason: Optional[str] = None
    if eos_row is None:
        eos_row = [sampler.is_eos(t) for t in new_tokens]
    for i in range(len(new_tokens)):
        if eos_row[i]:
            kept, reason = i + 1, "eos"
            break
    out.extend(int(t) for t in new_tokens[:kept])
    cut = sampler.find_stop(out, prev)
    if cut is not None and (cut < len(out) or reason is None):
        del out[cut:]
        kept, reason = cut - prev, "stop"
    return kept, reason


class Sampler:
    """Host-side per-sequence greedy sampler with the request's finish
    events."""

    def __init__(self, temperature: float = 0.0, top_k: int = 0,
                 seed: int = 0, vocab_size: int = 0,
                 eos_ids: Seq[int] = (), stop: Seq[Seq[int]] = ()):
        if temperature < 0:
            raise ValueError(f"temperature must be >= 0, got {temperature}")
        if temperature > 0:
            raise NotImplementedError(
                "stochastic sampling needs a torch threefry bit-compatible "
                "with jax.random (ROADMAP.md queue 1 item 5c); serve "
                "greedily (temperature=0)")
        if top_k < 0:
            raise ValueError(f"top_k must be >= 0 (0 = all), got {top_k}")
        # greedy: the argmax survives any top_k, and no seed is drawn from
        self.vocab_size = int(vocab_size)
        self.eos_ids = frozenset(int(t) for t in eos_ids)
        self.stop = tuple(tuple(int(t) for t in s) for s in stop if len(s))

    def is_eos(self, token: int) -> bool:
        return int(token) in self.eos_ids

    def find_stop(self, out: Seq[int], prev_len: int) -> Optional[int]:
        """Earliest end of a completed stop sequence in the newly
        generated region of ``out`` (index >= ``prev_len``), reaching
        back so a stop spanning a horizon boundary is found. Returns the
        kept output length, or None."""
        if not self.stop:
            return None
        best: Optional[int] = None
        for end in range(prev_len + 1, len(out) + 1):
            for s in self.stop:
                if end >= len(s) and tuple(out[end - len(s):end]) == s:
                    best = end if best is None else min(best, end)
            if best is not None:
                break
        return best

    def __call__(self, logits: np.ndarray) -> int:
        """One token id from a (padded_vocab,) logits row."""
        z = np.asarray(logits, np.float32)
        if self.vocab_size and self.vocab_size < len(z):
            z = z[:self.vocab_size]
        return int(np.argmax(z))


def eos_table(samplers: Seq[Sampler], width: int = 0) -> np.ndarray:
    """(len(samplers), E) int32 eos-id table, padded with ``-1``."""
    e = max([width, 1] + [len(s.eos_ids) for s in samplers])
    table = np.full((len(samplers), e), -1, np.int32)
    for i, s in enumerate(samplers):
        for j, tok in enumerate(sorted(s.eos_ids)):
            table[i, j] = tok
    return table


def sampler_for(request, vocab_size: int = 0) -> Sampler:
    """Sampler from a serve Request's (temperature, top_k, seed,
    eos_ids, stop)."""
    return Sampler(temperature=getattr(request, "temperature", 0.0),
                   top_k=getattr(request, "top_k", 0),
                   seed=getattr(request, "seed", 0),
                   vocab_size=vocab_size,
                   eos_ids=getattr(request, "eos_ids", ()),
                   stop=getattr(request, "stop", ()))
