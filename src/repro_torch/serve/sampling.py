"""Per-sequence token sampling for the serve engines: one algorithm, two
homes, as in the reference's ``serve/sampling.py``.

Every request carries ``(temperature, top_k, seed)``. Token ``n`` of a
sequence is drawn with the threefry key ``fold_in(PRNGKey(seed), n)``,
``n`` the number of tokens the sequence has sampled so far, so a draw
depends only on ``(seed, n)`` and its logits: cold, warm-cache and
preempted runs draw from the same stream (a preempted sequence's
recomputed K/V come from prefill chunks, which may round apart from the
decode steps that first wrote them), and a horizon of H fused decode
steps draws counters ``n .. n+H-1`` as H single steps would.

The draw, with the reference's op order:

1. slice the padded-vocab tail (``[:vocab_size]``);
2. ``top_k`` keeps exactly the k highest raw logits, ties at the k-th
   value kept at the lower indices (rank in a stable descending sort);
3. ``temperature == 0``: argmax (first index on ties);
4. otherwise divide by the temperature, add Gumbel noise from the
   counter key, argmax.

The random bits are ``jax.random``'s, bit for bit (threefry2x32 with
``jax_threefry_partitionable``, ``PRNGKey`` -> ``fold_in`` -> ``bits``
-> ``uniform`` -> ``gumbel`` in its default ``"low"`` mode,
``-log(-log(u))``). Each ``log`` is taken in float64 and rounded to
float32, so the host (numpy) and device (torch) draws agree; XLA's
float32 ``log`` is within one ulp of it.

* :func:`sample_tokens`: batched, on the device inside a decode horizon
  (only the sampled ids leave the device);
* :class:`Sampler`: the host-side per-row draw (numpy), for the
  prefill-logits first token and as the oracle of the device path.

**Finish events.** ``eos_ids`` end generation the moment one is sampled;
``stop`` holds multi-token sequences matched over the generated tokens.
A decode horizon keeps sampling past a finish event, so the host cuts
each lane at its first event (:func:`apply_finish`); the tokens after it
never enter the stream, and the counter advances by the kept count only.
"""
from __future__ import annotations

from typing import List, Optional, Sequence as Seq, Tuple

import numpy as np
import torch

# temperature == 0 lanes take the argmax branch; the divide still runs,
# so it gets a harmless tiny denominator
_MIN_TEMP = 1e-30
_U32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_FLOAT32_ONE_BITS = 0x3F800000
_TINY = float(np.finfo(np.float32).tiny)


def threefry2x32(k0, k1, x0, x1):
    """The threefry2x32 hash of counters ``(x0, x1)`` under key ``(k0,
    k1)`` (20 rounds, jax's ``_threefry2x32_lowering``), on uint32 numpy
    arrays or on int64 torch tensors holding uint32 values (torch has no
    uint32 arithmetic); the keys broadcast against the counters."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _U32
    x1 = (x1 + ks[1]) & _U32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _U32
            x1 = (((x1 << r) & _U32) | (x1 >> (32 - r))) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _U32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _U32
    return x0, x1


def fold_in_key(seed, counter):
    """``fold_in(PRNGKey(seed), counter)`` for uint32 seeds: the key
    ``(0, seed)`` hashes the counter pair ``(0, counter)``. numpy or
    int64 torch, elementwise."""
    zero = seed * 0
    return threefry2x32(zero, seed, zero, counter)


def _uniform_bits(bits):
    """float32 in [tiny, 1) from 32 random bits, as ``jax.random.uniform
    (minval=tiny)``: the top 23 bits as the mantissa of [1, 2), minus 1
    (``f * (1 - tiny) + tiny`` rounds back to ``f`` for every nonzero
    ``f``)."""
    if isinstance(bits, torch.Tensor):
        f = (((bits >> 9) | _FLOAT32_ONE_BITS).to(torch.int32)
             .view(torch.float32) - 1.0)
        return torch.clamp_min(f, _TINY)
    f = ((bits >> 9) | _FLOAT32_ONE_BITS).astype(np.uint32).view(
        np.float32) - np.float32(1.0)
    return np.maximum(f, np.float32(_TINY))


def _gumbel_of_uniform(u):
    """``-log(-log(u))``, each ``log`` in float64 rounded to float32."""
    if isinstance(u, torch.Tensor):
        a = torch.log(u.double()).float()
        return -torch.log(-a.double()).float()
    a = np.log(u.astype(np.float64)).astype(np.float32)
    return (-np.log(-a.astype(np.float64))).astype(np.float32)


def random_bits(seed: int, counter: int, n: int) -> np.ndarray:
    """``jax.random.bits(fold_in(PRNGKey(seed), counter), (n,))`` on the
    host: uint32 (n,)."""
    with np.errstate(over="ignore"):
        k0, k1 = fold_in_key(np.array([seed & _U32], np.uint32),
                             np.array([counter & _U32], np.uint32))
        b0, b1 = threefry2x32(k0, k1, np.zeros(n, np.uint32),
                              np.arange(n, dtype=np.uint32))
    return b0 ^ b1


def gumbel_row(seed: int, counter: int, n: int) -> np.ndarray:
    """Gumbel noise (n,) float32 for draw ``counter`` of stream ``seed``
    on the host."""
    return _gumbel_of_uniform(_uniform_bits(random_bits(seed, counter, n)))


def gumbel_rows(seed: torch.Tensor, counter: torch.Tensor,
                n: int) -> torch.Tensor:
    """Gumbel noise (B, n) float32 for per-lane ``seed``/``counter`` (B,)
    on their device: lane ``i`` equals ``gumbel_row(seed[i],
    counter[i], n)``."""
    k0, k1 = fold_in_key(seed.long() & _U32, counter.long() & _U32)
    idx = torch.arange(n, dtype=torch.int64, device=seed.device)
    b0, b1 = threefry2x32(k0[:, None], k1[:, None], torch.zeros_like(idx),
                          idx)
    return _gumbel_of_uniform(_uniform_bits(b0 ^ b1))


def top_k_mask(z: torch.Tensor, top_k: torch.Tensor) -> torch.Tensor:
    """Keep each row's ``top_k`` (B,) highest entries (all where <= 0),
    ties at the k-th value kept at the lower indices; the rest -inf."""
    order = torch.argsort(-z, dim=-1, stable=True)
    ranks = torch.empty_like(order)
    ranks.scatter_(-1, order, torch.arange(z.shape[-1], device=z.device)
                   .expand_as(order))
    keep = (top_k[:, None] <= 0) | (ranks < top_k[:, None])
    return torch.where(keep, z, -torch.inf)


def greedy_tokens(logits: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """(B, padded_vocab) logits -> (B,) int32 argmax over the real vocab."""
    return torch.argmax(logits[:, :vocab_size].float(), -1).to(torch.int32)


def sample_tokens(logits: torch.Tensor, temperature: torch.Tensor,
                  top_k: torch.Tensor, seed: torch.Tensor,
                  counter: torch.Tensor, vocab_size: int, *,
                  use_top_k: bool = True,
                  stochastic: bool = True) -> torch.Tensor:
    """Batched draw on the logits' device: (B, padded_vocab) -> (B,) int32.

    temperature (B,) float32, top_k (B,) (<= 0: the whole vocab), seed
    (B,) uint32 values, counter (B,) draws so far; lane ``i`` draws
    exactly what :class:`Sampler` draws at ``counter[i]`` for
    ``seed[i]``. ``use_top_k=False``/``stochastic=False`` skip the rank
    sort / the Gumbel rows, an identity for batches where no lane uses
    top-k / a temperature: an all-greedy batch runs :func:`greedy_tokens`
    alone."""
    if not (use_top_k or stochastic):
        return greedy_tokens(logits, vocab_size)
    z = logits.float()[:, :vocab_size]
    zm = top_k_mask(z, top_k) if use_top_k else z
    greedy = torch.argmax(zm, -1)
    if not stochastic:
        return greedy.to(torch.int32)
    y = zm / torch.clamp_min(temperature, _MIN_TEMP)[:, None]
    sampled = torch.argmax(y + gumbel_rows(seed, counter, vocab_size), -1)
    return torch.where(temperature <= 0, greedy, sampled).to(torch.int32)


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
    """Host-side per-sequence sampler: the device contract's oracle.

    Stateful counter: call ``n`` draws with the key of ``(seed, n)``, the
    same draw :func:`sample_tokens` makes at ``counter == n``; greedy
    calls consume no draw. Also carries the request's finish events
    (``eos_ids``, ``stop``)."""

    def __init__(self, temperature: float = 0.0, top_k: int = 0,
                 seed: int = 0, vocab_size: int = 0,
                 eos_ids: Seq[int] = (), stop: Seq[Seq[int]] = ()):
        if temperature < 0:
            raise ValueError(f"temperature must be >= 0, got {temperature}")
        if top_k < 0:
            raise ValueError(f"top_k must be >= 0 (0 = all), got {top_k}")
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        # the device takes seeds as uint32 values: wrap here too
        self.seed = int(seed) & _U32
        self.vocab_size = int(vocab_size)
        self.eos_ids = frozenset(int(t) for t in eos_ids)
        self.stop = tuple(tuple(int(t) for t in s) for s in stop if len(s))
        self._n = 0                     # tokens sampled so far

    @property
    def greedy(self) -> bool:
        return self.temperature == 0.0

    @property
    def draws(self) -> int:
        """Counter of the next draw."""
        return self._n

    def skip(self, n: int) -> None:
        """Advance past ``n`` draws taken on the device."""
        self._n += n

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

    def draw(self, logits: np.ndarray, counter: int) -> int:
        """The draw at an explicit ``counter`` from a (padded_vocab,)
        logits row, without touching the stream state."""
        z = np.asarray(logits, np.float32)
        if self.vocab_size and self.vocab_size < len(z):
            z = z[:self.vocab_size]
        if 0 < self.top_k < len(z):
            order = np.argsort(-z, kind="stable")
            ranks = np.argsort(order, kind="stable")
            z = np.where(ranks < self.top_k, z, -np.inf).astype(np.float32)
        if self.greedy:
            return int(np.argmax(z))
        y = z / np.float32(self.temperature)
        return int(np.argmax(y + gumbel_row(self.seed, counter, len(z))))

    def __call__(self, logits: np.ndarray) -> int:
        """One token id from a (padded_vocab,) logits row, consuming the
        next counter (greedy calls consume none)."""
        tok = self.draw(logits, self._n)
        if not self.greedy:
            self._n += 1
        return tok


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
