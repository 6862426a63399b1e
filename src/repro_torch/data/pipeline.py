"""Deterministic synthetic data pipeline (shardable, resumable), the
counterpart of ``repro/data/pipeline.py``: pure numpy, so every batch is
bitwise the reference's for every family, step, shard and seed.

Every batch is a pure function of (seed, step, shard): a restart replays
identically with no stored iterator state, which is what makes
checkpoint-resume exactly reproducible.

The token stream is a learnable mixture (not iid noise): each sequence
draws a small affine generator (a, b) and emits
``t_{i+1} = (a * t_i + b + eps_i) mod V`` with sparse noise; a model must
learn the per-sequence transition to beat the unigram baseline, so a
falling train loss is a meaningful signal. The ``copy`` task repeats a
random prefix (an induction-head task).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.models.api import WHISPER_DEC_LEN


@dataclasses.dataclass
class SyntheticLM:
    cfg: ArchConfig
    seq_len: int
    batch: int
    seed: int = 0
    noise: float = 0.02
    task: str = "affine"   # affine | copy (copy = induction-head task)

    def _rng(self, step: int, shard: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, step, shard]))

    def batch_at(self, step: int, shard: int = 0, num_shards: int = 1):
        """Returns the shard's {tokens, targets} (int32 numpy) for
        ``step``."""
        assert self.batch % num_shards == 0
        b = self.batch // num_shards
        v = self.cfg.vocab_size
        rng = self._rng(step, shard)
        if self.task == "copy":
            # induction task: [prefix | prefix | prefix ...] — every
            # position past the first period is predictable by copying.
            n = self.seq_len + 1
            period = max(n // 4, 2)
            prefix = rng.integers(0, v, size=(b, period))
            reps = -(-n // period)
            seq = np.tile(prefix, (1, reps))[:, :n]
            return {"tokens": seq[:, :-1].astype(np.int32),
                    "targets": seq[:, 1:].astype(np.int32)}
        a = rng.integers(1, 64, size=(b, 1)) * 2 + 1      # odd multipliers
        off = rng.integers(0, v, size=(b, 1))
        t0 = rng.integers(0, v, size=(b, 1))
        n = self.seq_len + 1
        seq = np.zeros((b, n), np.int64)
        seq[:, 0:1] = t0
        for i in range(1, n):
            seq[:, i] = (a[:, 0] * seq[:, i - 1] + off[:, 0]) % v
        noise_mask = rng.random((b, n)) < self.noise
        seq = np.where(noise_mask, rng.integers(0, v, size=(b, n)), seq)
        return {"tokens": seq[:, :-1].astype(np.int32),
                "targets": seq[:, 1:].astype(np.int32)}


def make_batch(cfg: ArchConfig, shape: ShapeConfig, step: int, *,
               seed: int = 0, shard: int = 0, num_shards: int = 1):
    """Family-aware batch builder (numpy leaves; frames/embeds stubs for
    audio/vlm)."""
    pipe = SyntheticLM(cfg, shape.seq_len, shape.global_batch, seed)
    rng = pipe._rng(step, shard)
    b = shape.global_batch // num_shards
    if cfg.family == "encdec":
        t = min(WHISPER_DEC_LEN, shape.seq_len)
        tok = SyntheticLM(cfg, t, shape.global_batch, seed).batch_at(
            step, shard, num_shards)
        frames = rng.standard_normal(
            (b, shape.seq_len, cfg.d_model)).astype(np.float32) * 0.05
        return {"frames": frames, "tokens": tok["tokens"],
                "targets": tok["targets"]}
    if cfg.family == "vlm":
        tok = pipe.batch_at(step, shard, num_shards)
        embeds = rng.standard_normal(
            (b, shape.seq_len, cfg.d_model)).astype(np.float32) * 0.05
        pos = np.broadcast_to(np.arange(shape.seq_len, dtype=np.int32),
                              (3, b, shape.seq_len)).copy()
        return {"embeds": embeds, "positions": pos,
                "targets": tok["targets"]}
    return pipe.batch_at(step, shard, num_shards)
