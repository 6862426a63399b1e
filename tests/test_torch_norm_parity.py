"""The AILayerNorm row body's last bits against the compiled JAX Pallas
calls.

Inside ``jit`` XLA rewrites the reference's divisions by the channel count
into multiplies by ``float32(1/C)`` and ``float32(16/C)``, and LLVM
contracts both the LayerNorm variance ``ex2 * (16/C) - mu * mu`` and its
affine ``(gamma * rs) * (xs - mu) + beta`` into fused multiply-adds. The port's plain versions (which the kernels are held
to on the card) take the same forms, so the only rows that may still
differ are those where the port's correctly rounded ``1/sqrt`` and XLA's
approximate CPU ``rsqrt`` of the same variance differ: the tests compute
that set of rows and require every differing row to lie in it.

``fma32`` is torch's missing fused multiply-add, by way of float64; its
test places sums exactly on float32 midpoints, where a plain float64
route rounds twice.
"""
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.sole.quant import calibrate_ptf as j_calibrate
from repro.kernels import ailayernorm as JK  # repro: noqa RPR001
from repro_torch.core.sole.ailayernorm import inv_sqrt
from repro_torch.kernels import ailayernorm as KN


def _fma_exact(a, b, c) -> np.float32:
    """float32 of the exact ``a * b + c``, ties to even."""
    v = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    r = np.float32(float(v))
    cands = [r, np.nextafter(r, np.float32(np.inf)),
             np.nextafter(r, np.float32(-np.inf))]
    return min(cands, key=lambda f: (abs(Fraction(float(f)) - v),
                                     int(np.array(f).view(np.int32)) & 1))


def test_fma32_on_midpoints():
    """Products that are exactly float32 midpoints, nudged by a term far
    below float64's precision: the float64 sum lands on the midpoint, and
    only the TwoSum error term gives the right neighbour."""
    f = np.float32
    u = f(2.0 ** -23)
    cases = [(f(3), f(1) + u, f(-2.0 ** -60), f(3 + 2.0 ** -22)),
             (f(3), f(1) + u, f(2.0 ** -60), f(3 + 2.0 ** -21)),
             (f(3), f(1) + 3 * u, f(2.0 ** -60), f(3 + 5 * 2.0 ** -22)),
             (f(3), f(1) + 3 * u, f(-2.0 ** -60), f(3 + 2.0 ** -20)),
             (f(-3), f(1) + u, f(2.0 ** -60), f(-3 - 2.0 ** -22))]
    a, b, c, want = (torch.tensor([k[i] for k in cases]) for i in range(4))
    got = KN.fma32(a, b, c)
    assert torch.equal(got, want)
    naive = (a.double() * b.double() + c.double()).float()
    assert not torch.equal(naive, want)          # the double rounding
    for case in cases:
        assert _fma_exact(*case[:3]) == case[3]


def test_fma32_random_equals_exact():
    rng = np.random.default_rng(0)
    a, b, c = (rng.standard_normal(3000).astype(np.float32)
               * np.float32(2.0) ** rng.integers(-20, 20, 3000)
               for _ in range(3))
    got = KN.fma32(*(torch.from_numpy(v) for v in (a, b, c))).numpy()
    want = np.array([_fma_exact(*t) for t in zip(a, b, c)], np.float32)
    np.testing.assert_array_equal(got, want)


def _inputs(c, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((512, c)).astype(np.float32) * 2
    x *= 2.0 ** rng.integers(0, 4, size=c)            # every PTF alpha
    r = rng.standard_normal((512, c)).astype(np.float32)
    gamma = (1 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    beta = (0.1 * rng.standard_normal(c)).astype(np.float32)
    return x, r, gamma, beta


def _rsqrt_rows(xi, alpha, rms):
    """Rows where the port's ``1/sqrt`` of its variance differs from XLA's
    compiled ``rsqrt`` of the same value."""
    _, _, var = KN.row_stats(xi, alpha, rms=rms)
    mine = inv_sqrt(var).numpy()
    xla = np.asarray(jax.jit(jax.lax.rsqrt)(jnp.asarray(var.numpy())))
    return set(np.nonzero((mine != xla).any(-1))[0])


CASES = [("qnorm", True), ("qnorm", False), ("add_norm", True),
         ("add_norm", False), ("codes", False)]


@pytest.mark.parametrize("c", [896, 2048])
@pytest.mark.parametrize("entry,rms", CASES,
                         ids=[f"{e}-{'rms' if r else 'ln'}" for e, r in CASES])
def test_plain_differs_from_compiled_only_by_rsqrt(entry, rms, c):
    x, r, gamma, beta = _inputs(c, seed=c + len(entry) + rms)
    if rms:
        beta = np.zeros_like(beta)
    h = x + r if entry == "add_norm" else x
    params = j_calibrate(jnp.asarray(h), unsigned=not rms)
    denom = np.array(JK._ptf_denom(params), np.float32)
    alpha = np.array(params.alpha, np.int32)
    t = torch.from_numpy
    scale = t(np.array(params.scale, np.float32))
    xi = KN.ptf_codes(t(h), t(denom))
    if entry == "qnorm":
        want = JK._qnorm_call(jnp.asarray(x), denom, alpha, gamma, beta, rms,
                              256, True)
        got = KN.qnorm_plain(t(x), scale, t(alpha), t(gamma), t(beta),
                             rms=rms)
    elif entry == "add_norm":
        want_h, want = JK._fused_call(jnp.asarray(x), jnp.asarray(r), denom,
                                      alpha, gamma, beta, rms, 256, True)
        got_h, got = KN.add_norm_plain(t(x), t(r), scale, t(alpha),
                                       t(gamma), t(beta), rms=rms)
        np.testing.assert_array_equal(got_h.numpy(), np.asarray(want_h))
    else:
        want = JK._codes_call(jnp.asarray(xi.numpy()), alpha, gamma, beta,
                              256, True)
        got = KN.codes_norm_plain(xi, t(alpha), t(gamma), t(beta))
    got, want = got.numpy(), np.asarray(want)
    differ = set(np.nonzero((got != want).any(-1))[0])
    allowed = _rsqrt_rows(xi, t(alpha), rms)
    assert differ <= allowed, (len(differ), len(differ - allowed))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
