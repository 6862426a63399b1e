"""The port's SOLE core (repro_torch.core.sole) against the JAX package's
(repro.core.sole) on the same numpy inputs.

Tolerances: integer results (PTF scale/alpha bits, codes, compressed
squares, int32 sums, log2 codes) must be **equal**. Float outputs are
held to 1e-6 relative: both sides compute in float32 with the same
operation order, and what remains is XLA's own ``exp2``/``rsqrt``/division
rounding (e.g. ``jnp.exp2(-13.0)`` is not exactly 2^-13 on the CPU).
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.core.sole import ailayernorm as T_ln
from repro_torch.core.sole import e2softmax as T_e2
from repro_torch.core.sole import quant as T_q

# repro.core.sole re-exports functions under its module names
J_ln = importlib.import_module("repro.core.sole.ailayernorm")
J_e2 = importlib.import_module("repro.core.sole.e2softmax")
J_q = importlib.import_module("repro.core.sole.quant")

FP_RTOL = 1e-6


def _act(rng, shape, outliers=True):
    """Activations with per-channel ranges spread over 2^0..2^3, so PTF
    picks every alpha."""
    x = rng.standard_normal(shape).astype(np.float32) * 2.0
    if outliers:
        x *= 2.0 ** rng.integers(0, 4, size=shape[-1])
    return x


def _pair(x, dtype):
    """The same values as a jax array and a torch tensor of ``dtype``."""
    j = jnp.asarray(x).astype(dtype)
    t = torch.from_numpy(np.asarray(j.astype(jnp.float32)).copy())
    return j, t.to(torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)


def _bits(a):
    """float32 bit pattern of a jax array / torch tensor (any float dtype)."""
    if isinstance(a, torch.Tensor):
        return a.float().numpy().view(np.uint32)
    return np.asarray(jnp.asarray(a, jnp.float32)).view(np.uint32)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(3, 5, 64), (16, 896), (7,)])
@pytest.mark.parametrize("unsigned", [True, False])
def test_calibrate_ptf_bits_and_codes_equal(dtype, shape, unsigned):
    """Scale and alpha are bit-equal — on bf16 input the scale is bf16 and
    log2/ceil run in bf16 on both sides — and so are the PTF codes.
    Calibration reduces over every leading axis (batch-global)."""
    rng = np.random.default_rng(sum(shape) + unsigned)
    jx, tx = _pair(_act(rng, shape), dtype)
    jp = J_q.calibrate_ptf(jx, unsigned=unsigned)
    tp = T_q.calibrate_ptf(tx, unsigned=unsigned)
    assert tp.scale.dtype == tx.dtype
    np.testing.assert_array_equal(_bits(tp.scale), _bits(jp.scale))
    np.testing.assert_array_equal(tp.alpha.numpy(), np.asarray(jp.alpha))
    assert tp.zero_point == int(jp.zero_point)
    np.testing.assert_array_equal(_bits(tp.denom()),
                                  _bits(jp.scale * jnp.exp2(
                                      jp.alpha.astype(jnp.float32))))
    np.testing.assert_array_equal(tp.quantize(tx).numpy(),
                                  np.asarray(jp.quantize(jx)))
    assert set(np.unique(tp.alpha.numpy())) <= {0, 1, 2, 3}


def test_compressed_square_equal_on_every_code():
    a = np.arange(256, dtype=np.int32)
    np.testing.assert_array_equal(
        T_ln.compressed_square(torch.from_numpy(a)).numpy(),
        np.asarray(J_ln.compressed_square(jnp.asarray(a))))


@pytest.mark.parametrize("rms", [True, False], ids=["rms", "ln"])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
def test_ailayernorm_matches_reference(rms, dtype):
    """Integer statistics equal, float output within FP_RTOL."""
    rng = np.random.default_rng(3 + rms)
    c = 64
    jx, tx = _pair(_act(rng, (6, c)), dtype)
    gamma = (1 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    beta = (0.1 * rng.standard_normal(c)).astype(np.float32)
    tg, tb = torch.from_numpy(gamma), torch.from_numpy(beta)
    if rms:
        jo = J_ln.airmsnorm(jx, jnp.asarray(gamma))
        to = T_ln.airmsnorm(tx, tg)
    else:
        jo = J_ln.ailayernorm(jx, jnp.asarray(gamma), jnp.asarray(beta))
        to = T_ln.ailayernorm(tx, tg, tb)
    # the integer pipeline: codes -> compressed squares -> int32 sums
    jp = J_q.calibrate_ptf(jx, unsigned=not rms)
    tp = T_q.calibrate_ptf(tx, unsigned=not rms)
    jxi = np.asarray(jp.quantize(jx)) - int(jp.zero_point)
    txi = tp.quantize(tx) - tp.zero_point
    np.testing.assert_array_equal(txi.numpy(), jxi)
    alpha = tp.alpha
    t_ex = T_ln.ptf_shift(txi, alpha).sum(-1, dtype=torch.int32)
    t_ex2 = (T_ln.compressed_square(txi.abs()) << (2 * alpha)).sum(
        -1, dtype=torch.int32)
    ja = np.asarray(jp.alpha)
    j_ex = (jxi << ja).sum(-1)
    j_ex2 = (np.asarray(J_ln.compressed_square(jnp.abs(jnp.asarray(jxi))))
             << (2 * ja)).sum(-1)
    np.testing.assert_array_equal(t_ex.numpy(), j_ex)
    np.testing.assert_array_equal(t_ex2.numpy(), j_ex2)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=FP_RTOL,
                               atol=FP_RTOL)


def test_log2exp_and_aldivision_match_reference():
    rng = np.random.default_rng(5)
    x = -np.abs(rng.standard_normal(512) * 6).astype(np.float32)
    x[:3] = [0.0, -0.3478260869565217, -1e30]       # 0, a .5 tie, NEG
    np.testing.assert_array_equal(
        T_e2.log2exp(torch.from_numpy(x)).numpy(),
        np.asarray(J_e2.log2exp(jnp.asarray(x))))
    k = rng.integers(0, 16, 512).astype(np.int32)
    s = (rng.random(512) * 40 + 2.0 ** -20).astype(np.float32)
    np.testing.assert_allclose(
        T_e2.aldivision(torch.from_numpy(k), torch.from_numpy(s)).numpy(),
        np.asarray(J_e2.aldivision(jnp.asarray(k), jnp.asarray(s))),
        rtol=FP_RTOL)


def test_masked_e2softmax_matches_reference():
    rng = np.random.default_rng(6)
    x = (rng.standard_normal((4, 3, 40)) * 4).astype(np.float32)
    mask = rng.random((4, 3, 40)) > 0.3
    mask[0, 0] = False                               # a fully masked row
    to = T_e2.e2softmax(torch.from_numpy(x), mask=torch.from_numpy(mask))
    jo = J_e2.e2softmax(jnp.asarray(x), mask=jnp.asarray(mask))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=FP_RTOL,
                               atol=0)
    assert (to.numpy()[~mask] == 0).all()
