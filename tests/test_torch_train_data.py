"""The port's synthetic data pipeline (``repro_torch.data.pipeline``)
against the JAX package's ``repro.data.pipeline`` on the CPU: pure numpy
on both sides, so every batch is held bitwise equal (values, dtypes and
shapes) for every config's smoke family, both tasks, shards 1/2/4 and a
few steps and seeds.
"""
import numpy as np
import pytest

from repro.configs.base import ShapeConfig as JaxShape
from repro.configs.base import get_config as jax_config
from repro.data import pipeline as JP
from repro_torch.configs.base import ARCH_NAMES, ShapeConfig, get_config
from repro_torch.data import pipeline as TP

SHARDS = (1, 2, 4)


def _equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_make_batch_bitwise(name):
    """``make_batch`` for the family (tokens/targets; whisper's frames and
    448-capped decoder tokens; qwen2-vl's embeds and 3-axis positions) at
    two shapes, steps 0 and 7, seeds 0 and 3, every shard of 1, 2 and 4."""
    jc, tc = jax_config(name).smoke(), get_config(name).smoke()
    for seq, batch in ((32, 8), (500, 4)):
        js = JaxShape("t", seq, batch, "train")
        ts = ShapeConfig("t", seq, batch, "train")
        for step in (0, 7):
            for seed in (0, 3):
                for n in SHARDS:
                    for shard in range(n):
                        _equal(JP.make_batch(jc, js, step, seed=seed,
                                             shard=shard, num_shards=n),
                               TP.make_batch(tc, ts, step, seed=seed,
                                             shard=shard, num_shards=n))


@pytest.mark.parametrize("task", ("affine", "copy"))
@pytest.mark.parametrize("name", ARCH_NAMES)
def test_synthetic_lm_batch_at_bitwise(name, task):
    jc, tc = jax_config(name).smoke(), get_config(name).smoke()
    jp = JP.SyntheticLM(jc, seq_len=48, batch=8, seed=5, task=task)
    tp = TP.SyntheticLM(tc, seq_len=48, batch=8, seed=5, task=task)
    for step in (0, 1, 1000):
        for n in SHARDS:
            for shard in range(n):
                _equal(jp.batch_at(step, shard, n), tp.batch_at(step, shard, n))


def test_pipeline_is_a_function_of_seed_step_shard():
    """Determinism and resume semantics, as the reference's own tests
    state them: the same (seed, step, shard) gives the same batch, other
    steps and shards differ, shards split the batch."""
    cfg = get_config("qwen2_0_5b").smoke()
    p = TP.SyntheticLM(cfg, seq_len=32, batch=8, seed=7)
    _equal(p.batch_at(3), p.batch_at(3))
    assert not np.array_equal(p.batch_at(1)["tokens"],
                              p.batch_at(2)["tokens"])
    s0 = p.batch_at(5, shard=0, num_shards=4)
    s1 = p.batch_at(5, shard=1, num_shards=4)
    assert s0["tokens"].shape == (2, 32)
    assert not np.array_equal(s0["tokens"], s1["tokens"])
    b = p.batch_at(0)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["targets"][:, :-1])
