"""The port's E2Softmax (the kernel's plain version and the ``softmax``
``sole`` op) against the JAX package's ``softmax_fn("sole")``, both its
Pallas kernel in interpret mode and its reference. The same numpy inputs
go to both sides.

Tolerances, and why:
* The log2 codes are exact: every output is ``2^-(k + e) * f`` with ``f``
  one of the two ALDivision factors, so its float32 exponent and mantissa
  give ``k + e`` and ``f`` back; these are compared for equality. At
  ``exp_bits = 4`` and ``C <= 512`` the float32 sum ``S`` is exact in any
  order, so ``e`` and ``f`` cannot differ; at ``C = 1000`` or ``exp_bits =
  6`` the port and XLA sum in other orders, and a row whose ``S`` sat
  within a rounding of an ALDivision boundary could change bucket; these
  inputs have none, and the codes are held equal there too.
* The outputs agree to 2e-6 relative, 0 absolute: XLA's ``exp2`` of an
  integer is inexact on the CPU (2^-13 and 2^-15 are off by up to 5.4e-7
  relative, so a sum and an output can be off by ~1.1e-6), where the port
  builds every power of two from its exponent bits.

The kernel's own ``int8_scale`` branch (the snap of ``x - max``) has no
registry entry in the JAX package; it is held against the snap composed
from ``repro.ops.snap_logits`` (eager: a true division, as the kernel
does) followed by the Pallas op. The model path snaps before the op in
the form the jitted reference computes; ``test_snap_logits_is_the_jitted_form``
holds ``ops.snap_logits`` to it bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import ops as jops
from repro_torch import ops as tops
from repro_torch.kernels import e2softmax as KE
from repro_torch.models.layers import LOGIT_INT8_SCALE

SHAPES = [(4, 64), (3, 5, 130), (7, 257), (2, 1000)]
RTOL = 2e-6


def _inputs(shape, dtype, masked, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 3).astype(np.float32)
    mask = None
    if masked:
        mask = rng.random(shape) > 0.3
        mask.reshape(-1, shape[-1])[0] = False         # a fully masked row
    jx = jnp.asarray(x).astype(jnp.dtype(dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.from_numpy(mask)
    return jx, tx, jm, tm, mask


def _codes(out):
    """(k + e, factor bucket) of every output; masked zeros give (0, 0)."""
    mant, expo = np.frexp(np.asarray(out, np.float64))
    return expo, mant >= 0.7


def _check(got, want, mask):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == np.float32 and got.shape == want.shape
    for a, b in zip(_codes(got), _codes(want)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)
    if mask is not None:
        assert (got[~mask] == 0).all()
        assert (got.reshape(-1, got.shape[-1])[0] == 0).all()


@pytest.mark.parametrize("masked", [False, True], ids=["plain", "masked"])
@pytest.mark.parametrize("exp_bits", [4, 6])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES, ids=["x".join(map(str, s))
                                               for s in SHAPES])
def test_e2softmax_matches_jax(shape, dtype, exp_bits, masked):
    jx, tx, jm, tm, mask = _inputs(shape, dtype, masked, seed=sum(shape))
    pallas = jops.softmax_fn("sole", backend="pallas")(jx, mask=jm,
                                                        exp_bits=exp_bits)
    ref = jops.softmax_fn("sole", backend="reference")(jx, mask=jm,
                                                        exp_bits=exp_bits)
    plain = KE.e2softmax(tx, exp_bits=exp_bits, mask=tm)
    op = tops.softmax_fn("sole", "cpu")(tx, mask=tm, exp_bits=exp_bits)
    for got in (plain, op):
        for want in (pallas, ref):
            _check(got.numpy(), want, mask)


@pytest.mark.parametrize("masked", [False, True], ids=["plain", "masked"])
@pytest.mark.parametrize("shape", [(4, 64), (7, 257)], ids=["4x64", "7x257"])
def test_int8_scale_matches_snap_then_pallas(shape, masked):
    """``int8_scale`` on the kernel API: the snap of ``x - max`` (masked
    max with a mask) to the int8 grid, then E2Softmax."""
    jx, tx, jm, tm, mask = _inputs(shape, "float32", masked, seed=11)
    keep = jnp.ones(shape, bool) if jm is None else jm
    m = jnp.max(jnp.where(keep, jx, jnp.finfo(jnp.float32).min), -1,
                keepdims=True)
    snapped = jops.snap_logits(jx - m, LOGIT_INT8_SCALE)
    want = jops.softmax_fn("sole", backend="pallas")(snapped, mask=jm)
    got = KE.e2softmax(tx, int8_scale=LOGIT_INT8_SCALE, mask=tm)
    _check(got.numpy(), want, mask)
    assert len(np.unique(np.asarray(snapped))) <= 128    # the int8 grid


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_input_scale_matches_jax(dtype):
    """``input_scale`` on the op snaps the logits before the kernel."""
    jx, tx, jm, tm, mask = _inputs((6, 96), dtype, True, seed=5)
    scale = 0.0625 * 3
    got = tops.softmax_fn("sole", "cpu")(tx, mask=tm, input_scale=scale)
    for backend in ("pallas", "reference"):
        want = jops.softmax_fn("sole", backend=backend)(
            jx, mask=jm, input_scale=scale)
        _check(got.numpy(), want, mask)
    cuda_op = tops.resolve("softmax", "sole", "cuda")     # CPU tensors: plain
    _check(cuda_op(tx, mask=tm, input_scale=scale).numpy(),
           jops.softmax_fn("sole", backend="pallas")(jx, mask=jm,
                                                      input_scale=scale),
           mask)


def test_snap_logits_is_the_jitted_form():
    """The port snaps as the reference does inside ``jit`` (a multiply by
    the float32 reciprocal of the scale); at these three logits that
    differs from the eager true division."""
    rng = np.random.default_rng(0)
    d = -np.abs(rng.standard_normal(200_000).astype(np.float32) * 5)
    ties = np.array([3219111808, 3228491195, 3238778800],
                    np.uint32).view(np.float32)
    d = np.concatenate([ties, d])
    jitted = np.asarray(jax.jit(jops.snap_logits, static_argnums=1)(
        jnp.asarray(d), LOGIT_INT8_SCALE))
    eager = np.asarray(jops.snap_logits(jnp.asarray(d), LOGIT_INT8_SCALE))
    got = tops.snap_logits(torch.from_numpy(d), LOGIT_INT8_SCALE).numpy()
    np.testing.assert_array_equal(got, jitted)
    assert (jitted[:3] != eager[:3]).all()
    assert tops.snap_logits(torch.from_numpy(d), None) is not None


def test_exact_softmax_matches_reference():
    jx, tx, jm, tm, mask = _inputs((5, 40), "float32", True, seed=2)
    want = jops.softmax_fn("exact", backend="reference")(jx, mask=jm)
    got = tops.softmax_fn("exact", "cpu")(tx, mask=tm)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)


def test_wrapper_guards():
    """The mask broadcasts; exp_bits outside [0, 6] and a tensor on any
    device but the CPU or CUDA raise."""
    x = torch.randn(3, 4, 16)
    row = torch.tensor([True] * 10 + [False] * 6)
    np.testing.assert_array_equal(
        KE.e2softmax(x, mask=row).numpy(),
        KE.e2softmax(x, mask=row.expand(3, 4, 16).clone()).numpy())
    with pytest.raises(ValueError, match="exp_bits"):
        KE.e2softmax(x, exp_bits=7)
    with pytest.raises(ValueError, match="no e2softmax kernel"):
        KE.e2softmax(torch.zeros((2, 8), device="meta"))
    with pytest.raises(ValueError, match="last axis"):
        tops.resolve("softmax", "sole", "cuda")(x, axis=0)
    assert tops.backend_for("softmax", "sole", "cuda") == "cuda"
    assert tops.is_registered("softmax", "sole", "cuda")
