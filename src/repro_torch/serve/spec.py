"""Speculative decoding for :class:`PagedEngine`: pluggable drafters, one
batched verify dispatch, pinned-stream accept-prefix.

A drafter proposes up to K cheap tokens per running lane; the target
model scores all K + 1 positions in **one** chunked-prefill dispatch
(``models.transformer.verify_paged``) that also draws the pinned
counter-keyed sample at every slot on the device; the engine accepts the
longest draft prefix that equals those draws.

**Why prefix-match acceptance is exact.** The sampling contract
(serve/sampling.py) pins token ``n`` of a sequence to one draw: the
threefry key ``(seed, n)`` on that position's logits. The draw at verify
slot ``i`` is therefore the token plain decode would emit at counter
``n + i`` given the same prefix, provided the verify logits give the same
draw as the decode logits. A draft token is accepted iff it equals that
draw; the first mismatching slot emits the pinned draw itself as the
correction, and a fully accepted draft emits slot K's draw as a bonus.
Discarded slots never advance the sequence's counter.

The verify forward is the prefill path, at other row counts than decode:
in exact mode its logits can differ from decode's by an ulp (the
reference's own verify and decode logits do), and on the card its GEMMs
and the paged attention's C > 1 route round apart from decode's. So the
bar is tokens: speculation gives plain decode's tokens wherever no draw
sits on such a near-tie.

Drafters are duck-typed: anything with ``propose(lanes, ks) -> per-lane
token lists`` serves.

* :class:`NGramDrafter`: model-free prompt lookup on the host (numpy).
* :class:`DraftModelDrafter`: a small dense LM sharing the target's
  vocabulary, run on its parameters' device, proposing through each
  lane's own ``Sampler.draw`` at the counters verify will check.

The per-lane K controller lives in ``Scheduler.spec_ks`` /
``spec_feedback``; :class:`SpecConfig` carries its knobs and the drafter.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence as Seq

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, get_config
from repro_torch.convert import shard_params
from repro_torch.models import api
from repro_torch.models.state import tree_map
from repro_torch.serve.engine import _check_rules, _rank
from repro_torch.sharding import comm
from repro_torch.sharding.rules import use_rules


@dataclasses.dataclass
class SpecConfig:
    """The drafter and the knobs of the scheduler's per-lane K policy.

    ``max_k`` is rounded up to a power of two at verify time. A lane
    starts at ``max_k``; its EMA acceptance rate (weight ``ema_alpha`` per
    round) halves K below ``demote_below`` and doubles it above
    ``promote_above``. At K = 0 the lane decodes through the plain
    horizon, then re-probes K = 1 after ``retry_after`` rounds.
    """
    drafter: object
    max_k: int = 4
    ema_alpha: float = 0.4
    demote_below: float = 0.35
    promote_above: float = 0.8
    retry_after: int = 8

    def __post_init__(self):
        if self.max_k < 1:
            raise ValueError(f"max_k must be >= 1, got {self.max_k}")
        if not 0.0 <= self.demote_below <= self.promote_above <= 1.0:
            raise ValueError(
                "need 0 <= demote_below <= promote_above <= 1, got "
                f"{self.demote_below}/{self.promote_above}")


def _context(seq) -> np.ndarray:
    return np.concatenate([seq.prompt, np.asarray(seq.out, np.int32)])


class NGramDrafter:
    """Model-free prompt-lookup drafting.

    For each lane, find the longest suffix (up to ``max_ngram`` tokens) of
    ``prompt + out`` that occurred earlier in the context, most recent
    occurrence first, and propose the k tokens that followed it; nothing
    when no suffix re-occurs. O(context^2) per lane per round.
    """

    def __init__(self, max_ngram: int = 3, min_ngram: int = 1):
        if not 1 <= min_ngram <= max_ngram:
            raise ValueError(
                f"need 1 <= min_ngram <= max_ngram, got "
                f"{min_ngram}/{max_ngram}")
        self.max_ngram = max_ngram
        self.min_ngram = min_ngram

    def propose(self, lanes: Seq[object], ks: Seq[int]) -> List[List[int]]:
        return [self._match(_context(s), k) for s, k in zip(lanes, ks)]

    def _match(self, ctx: np.ndarray, k: int) -> List[int]:
        if k <= 0:
            return []
        for n in range(min(self.max_ngram, len(ctx) - 1),
                       self.min_ngram - 1, -1):
            pat = ctx[-n:]
            for s in range(len(ctx) - n - 1, -1, -1):
                if np.array_equal(ctx[s:s + n], pat):
                    cont = ctx[s + n:s + n + k]
                    if len(cont):
                        return [int(t) for t in cont]
        return []


class DraftModelDrafter:
    """Draft-model proposals through each lane's pinned sampling stream.

    Runs a small dense LM (the target's vocabulary; the engine checks)
    over each lane's context tail with the dense forward
    (``api.forward(..., "serve")``) on its parameters' device, and
    proposes the draw the lane's own ``Sampler`` pins at the counter
    verify will check (``Sampler.draw`` leaves the stream alone). Round
    ``i`` runs one forward over every lane still drafting, batch and width
    padded to powers of two with token 0 (in SOLE mode the padding rows
    take part in each norm's calibration, as in the reference). Contexts
    are clipped to the last ``window`` tokens, positions re-based to the
    window, and right-padded: the model is causal, so the padding never
    reaches the logits a proposal reads. Only those rows leave the device.

    With ``rules`` the draft model is sharded by its own rules
    (``param_axes`` its logical axes, ``models.api.param_axes(cfg)`` by
    default; cut where ``params`` lie, then moved to ``device`` when it is
    given, so a tree in host memory puts only the slices on the card) and
    each forward runs under them; without, every rank of a
    tensor-parallel target runs the whole draft model (its forward leaves
    the target's rules). On a (D, M) mesh each data rank runs its share of
    a round's lanes where D divides them (``transformer.forward``'s lane
    split). Under rules the rows read back are checked equal on every rank
    of the mesh, as the engine's are.
    """

    def __init__(self, cfg: ArchConfig, params, *, window: int = 64,
                 rules=None, param_axes=None, device=None):
        if cfg.family != "dense":
            raise ValueError(
                f"DraftModelDrafter drafts with dense LMs, got {cfg.family}")
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self.cfg = cfg
        self.rules = rules
        if rules is not None:
            _check_rules(cfg, rules, "DraftModelDrafter")
            params = shard_params(
                params, api.param_axes(cfg) if param_axes is None
                else param_axes, rules, _rank())
            if device is not None:
                params = tree_map(lambda t: t.to(device), params)
        self.params = params
        self.window = window
        self.vocab_size = cfg.vocab_size
        self.device = params["embed"]["table"].device
        self.forwards = 0                 # draft forwards run

    def propose(self, lanes: Seq[object], ks: Seq[int]) -> List[List[int]]:
        drafts: List[List[int]] = [[] for _ in lanes]
        if max(ks, default=0) <= 0:
            return drafts
        ctxs = [_context(s) for s in lanes]
        for i in range(max(ks)):
            live = [j for j, k in enumerate(ks) if k > i]
            if not live:
                break
            tails = [np.concatenate(
                         [ctxs[j], np.asarray(drafts[j], np.int32)]
                     )[-self.window:] for j in live]
            w = 1 << (max(len(t) for t in tails) - 1).bit_length()
            b = 1 << (len(live) - 1).bit_length()
            toks = np.zeros((b, w), np.int32)
            for r, t in enumerate(tails):
                toks[r, :len(t)] = t
            with use_rules(self.rules):
                logits = api.forward(
                    self.params,
                    {"tokens": torch.from_numpy(toks).to(self.device)},
                    self.cfg, "serve")
            self.forwards += 1
            last = torch.tensor([len(t) - 1 for t in tails],
                                device=self.device)
            rows = comm.agreed(
                logits[torch.arange(len(live), device=self.device),
                       last].float(), comm.whole_mesh(self.rules),
                "DraftModelDrafter readback")
            for r, j in enumerate(live):
                seq = lanes[j]
                drafts[j].append(seq.sampler.draw(rows[r], len(seq.out) + i))
        return drafts


def spec_config_from_flag(flag: Optional[str], cfg: ArchConfig, *,
                          max_k: int = 4, seed: int = 0, smoke: bool = False,
                          device="cuda", rules=None) -> Optional[SpecConfig]:
    """A :class:`SpecConfig` from the launcher's ``--spec-decode`` flag.

    ``""``/None: no speculation; ``"ngram"``: the model-free drafter;
    ``"draft:<arch>"``: a fresh draft model of that config with weights
    from ``api.init_params(seed + 1, ...)`` on ``device`` (``smoke``
    shrinks it like the target; its vocabulary must equal the target's);
    ``"draft"`` alone self-drafts with the target's architecture. Under
    ``rules`` (a tensor-parallel target) the draft model is drawn in host
    memory and sharded by them, its slices on ``device``.
    """
    if not flag:
        return None
    if flag == "ngram":
        return SpecConfig(NGramDrafter(), max_k=max_k)
    if flag == "draft" or flag.startswith("draft:"):
        name = (flag.split(":", 1)[1] if ":" in flag
                else cfg.name.removesuffix("-smoke"))
        dcfg = get_config(name)
        if smoke:
            dcfg = dcfg.smoke()
        if dcfg.vocab_size != cfg.vocab_size:
            raise ValueError(
                f"draft vocab {dcfg.vocab_size} != target vocab "
                f"{cfg.vocab_size}: speculation needs a shared tokenizer")
        if rules is None:
            return SpecConfig(DraftModelDrafter(
                dcfg, api.init_params(seed + 1, dcfg, device)), max_k=max_k)
        # drawn in host memory; each rank moves only its slices
        dparams = api.init_params(seed + 1, dcfg, "cpu")
        return SpecConfig(DraftModelDrafter(dcfg, dparams, rules=rules,
                                            device=device), max_k=max_k)
    raise ValueError(
        f"unknown --spec-decode mode {flag!r} "
        "(expected 'ngram', 'draft' or 'draft:<arch>')")
