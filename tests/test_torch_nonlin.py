"""The port's ``core/nonlin.py`` back-compat shim against the JAX
package's: the same mode lists, ``backend="reference"`` pinned on any
device, and each mode's softmax / LayerNorm / RMSNorm on the same numpy
inputs.

Tolerances, and why:
* exact: float32 sums in another order (XLA's CPU ``exp`` and ``rsqrt``
  differ by an ulp): 1e-6 absolute on the softmax, 1e-5 on the norms
  (outputs of order 1-10);
* sole: E2Softmax codes equal, XLA's CPU ``exp2`` of integers off by up
  to 5.4e-7 relative: 2e-6 relative; AILayerNorm: integer statistics
  equal, XLA's CPU ``rsqrt`` approximate: 1e-5 absolute;
* softermax: 15 fractional bits: 2^-15 absolute;
* ibert: integer arithmetic: 1e-6 absolute of the dequantized output.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import ops as tops
from repro_torch.core import nonlin as T

J = importlib.import_module("repro.core.nonlin")

SOFTMAX_TOL = {"exact": dict(atol=1e-6), "sole": dict(rtol=2e-6, atol=0),
               "softermax": dict(atol=2.0 ** -15), "ibert": dict(atol=1e-6)}
NORM_TOL = {"exact": 1e-5, "sole": 1e-5, "ibert": 1e-6}


def test_modes_match_reference():
    assert T.SOFTMAX_MODES == J.SOFTMAX_MODES
    assert T.NORM_MODES == J.NORM_MODES


@pytest.mark.parametrize("mode", ["exact", "sole", "softermax", "ibert"])
def test_softmax_fn_matches_reference(mode):
    fn = T.softmax_fn(mode)
    assert fn is tops.resolve("softmax", mode, "reference")
    rng = np.random.default_rng(len(mode))
    x = (rng.standard_normal((6, 200)) * 4).astype(np.float32)
    mask = rng.random((6, 200)) > 0.2
    for m in (None, mask):
        want = np.asarray(J.softmax_fn(mode)(
            jnp.asarray(x), mask=None if m is None else jnp.asarray(m)))
        got = fn(torch.from_numpy(x),
                 mask=None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(got.float().numpy(), want,
                                   rtol=SOFTMAX_TOL[mode].get("rtol", 0),
                                   atol=SOFTMAX_TOL[mode]["atol"])


@pytest.mark.parametrize("mode", ["exact", "sole", "ibert"])
@pytest.mark.parametrize("kind", ["layernorm", "rmsnorm"])
def test_norm_fns_match_reference(kind, mode):
    fn = getattr(T, f"{kind}_fn")(mode)
    assert fn is tops.resolve(kind, mode, "reference")
    rng = np.random.default_rng(len(kind) + len(mode))
    x = (rng.standard_normal((5, 96)) * 3).astype(np.float32)
    x[:, ::7] *= 8                                   # outlier channels
    gamma = (1 + 0.1 * rng.standard_normal(96)).astype(np.float32)
    beta = (0.1 * rng.standard_normal(96)).astype(np.float32)
    args = (gamma, beta) if kind == "layernorm" else (gamma,)
    want = np.asarray(getattr(J, f"{kind}_fn")(mode)(
        jnp.asarray(x), *map(jnp.asarray, args)))
    got = fn(torch.from_numpy(x), *map(torch.from_numpy, args))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=NORM_TOL[mode])
