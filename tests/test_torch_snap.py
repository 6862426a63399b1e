"""The int8 snap of the paged Flash-E2Softmax and of the E2Softmax kernel
against the jitted JAX kernels, on logits placed on the snap's rounding
ties.

Inside ``jit`` XLA rewrites ``dm / int8_scale`` (a static scale) into a
multiply by ``float32(1 / s)``. The two forms round differently only where
``dm / s`` lies within an ulp of a half-integer, so random logits almost
never show the difference (3 of 2e6). These tests build such logits
exactly: float32 ``dm`` found by search where the correctly rounded
quotient and the product with the reciprocal round to different codes.
Each is fed as ``q = 8 dm`` against one-hot keys at head dim 64, where
``d^-1/2 = 1/8``, so every logit equals its ``dm`` exactly; a zero key
gives every row a logit 0 in the first page, so the running max is 0 from
the first page on and ``dm`` is the logit itself.

Tolerance: the codes must be equal, so the outputs agree up to the P.V
sum order and XLA's inexact CPU ``exp2`` of integers (~5e-7 relative);
one flipped code halves or doubles a weight, which the one-hot V rows
carry into its own output column.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import ops as jops
from repro.kernels import e2softmax as JE  # repro: noqa RPR001
from repro_torch import ops as tops
from repro_torch.kernels import e2softmax as KE
from repro_torch.kernels import flash_e2softmax as KA
from repro_torch.models.layers import LOGIT_INT8_SCALE

D = 64          # d^-1/2 = 1/8: q = 8 dm gives the logit dm exactly
BS = 16         # page size: keys 0..63 on four pages


def snap_ties(scale: float, exp_bits: int = 4):
    """Float32 ``dm`` in [-127 s, 0] where ``round(dm / s)`` (correctly
    rounded quotient) and ``round(dm * float32(1 / s))`` differ, and
    whether the 4-bit code that follows differs too."""
    f = np.float32
    s = f(scale)
    inv = f(1) / s
    kmax = 2 ** exp_bits - 1
    ties = []
    for n in range(-127, 0):
        bits = np.array([(n + 0.5) * float(s)], np.float32).view(np.int32)
        cand = (bits + np.arange(-256, 257, dtype=np.int32)).view(np.float32)
        for dm in cand:
            if not -127 * float(s) <= dm <= 0:
                continue
            a, b = np.round(f(dm) / s), np.round(f(dm) * inv)
            if a != b:
                ka, kb = (np.clip(np.round(-(f(c) * s) * f(1.4375)), 0, kmax)
                          for c in (a, b))
                ties.append((f(dm), ka != kb))
    return ties


def _tie_case(seed):
    """The op's layouts: q (1, 1, 2, 64), one query and two heads: head 0
    holds the ties in order, head 1 shuffled; a pool of one KV head whose
    64 keys are key 0 zero (logit 0) and key j the one-hot e_j, on four
    pages; V the same, so output column j is key j's weight times the
    row's ALDivision scale; q_start 0, kv_len 64."""
    ties = np.array([t for t, _ in snap_ties(LOGIT_INT8_SCALE)], np.float32)
    assert 8 <= len(ties) < D
    rng = np.random.default_rng(seed)
    q = np.zeros((1, 1, 2, D), np.float32)
    q[0, 0, 0, 1:1 + len(ties)] = 8 * ties
    q[0, 0, 1, 1:1 + len(ties)] = 8 * rng.permutation(ties)
    eye = np.eye(D, dtype=np.float32)
    eye[0, 0] = 0.0
    pool = np.zeros((D // BS + 1, BS, 1, D), np.float32)   # page 0: null
    pool[1:] = eye.reshape(D // BS, BS, 1, D)
    tables = np.arange(1, D // BS + 1, dtype=np.int32)[None]
    return (q, pool, pool, tables, np.zeros(1, np.int32),
            np.full(1, D, np.int32))


def _jax_paged(kw):
    """The JAX package's paged attention (Pallas, interpret mode on the
    CPU) under ``jit``, as its model steps call it."""
    fn = jops.resolve("paged_attention", "sole", "pallas")
    return jax.jit(lambda *a: fn(*a, **kw))


def test_ties_exist_and_move_codes():
    """The search finds ties at the path's scale, and some of them move
    the 4-bit code (so a wrong snap shows in the output)."""
    ties = snap_ties(LOGIT_INT8_SCALE)
    assert len(ties) >= 20
    assert sum(moved for _, moved in ties) >= 4


KW = dict(causal=False, exp_bits=4, int8_scale=LOGIT_INT8_SCALE)


def test_jitted_paged_snap_has_no_divide():
    """The compiled paged Pallas call multiplies by ``float32(1 / s)``:
    no ``divide`` in its HLO, and that constant in it."""
    hlo = _jax_paged(KW).lower(*map(jnp.asarray, _tie_case(0))) \
        .compile().as_text()
    assert not re.search(r"\bdivide\(", hlo)
    inv = np.float32(KA.snap_reciprocal(LOGIT_INT8_SCALE))
    assert f"constant({inv:.8g}" in hlo or f"constant({inv:.7g}" in hlo


@pytest.mark.parametrize("quant", [False, True], ids=["f32-pool", "int8-pool"])
def test_paged_plain_equals_jitted_pallas_on_snap_ties(quant):
    """The port's paged attention on CPU tensors (the kernel's plain
    version, which the kernel is held to on the card) against the jitted
    JAX paged kernel, on float32 pools and on int8 pools (kv_scale 1/16:
    the one-hot keys and values stay exact as codes 16)."""
    case = list(_tie_case(1))
    kw = dict(KW)
    if quant:
        case[1] = case[2] = (case[1] * 16).astype(np.int8)
        kw.update(kv_scale=1 / 16, quant_pv=False)
    want = np.asarray(_jax_paged(kw)(*map(jnp.asarray, case)))
    fn = tops.resolve("paged_attention", "sole", "cuda")
    before = KA.flash_e2softmax_paged.launches
    got = fn(*(torch.from_numpy(np.array(a)) for a in case), **kw).numpy()
    assert KA.flash_e2softmax_paged.launches == before
    assert got.shape == want.shape == (1, 1, 2, D)
    assert (want[..., 1:] > 0).sum() >= 8
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


# -- the E2Softmax kernel's own int8_scale ------------------------------------


def _e2_tie_rows():
    """Rows ``[0, dm, 0, ...]`` of width 8, one per tie: the row max is 0,
    so ``x - max`` at column 1 is the tie ``dm`` itself."""
    ties = np.array([t for t, _ in snap_ties(LOGIT_INT8_SCALE)], np.float32)
    x = np.zeros((len(ties), 8), np.float32)
    x[:, 1] = ties
    mask = np.ones_like(x, dtype=bool)
    mask[:, 5:] = False
    return x, mask


def test_jitted_e2softmax_snap_has_no_divide():
    """The compiled E2Softmax Pallas call with a static ``int8_scale``
    multiplies by ``float32(1 / s)`` in both variants: no ``divide``."""
    x, mask = _e2_tie_rows()
    inv = np.float32(KA.snap_reciprocal(LOGIT_INT8_SCALE))
    for has_mask, m in ((False, jnp.zeros((), jnp.int32)),
                        (True, jnp.asarray(mask))):
        hlo = JE._e2softmax_call.lower(
            jnp.asarray(x), m, 4, LOGIT_INT8_SCALE, has_mask, 256,
            True).compile().as_text()
        assert not re.search(r"\bdivide\(", hlo)
        assert f"constant({inv:.8g}" in hlo or f"constant({inv:.7g}" in hlo


@pytest.mark.parametrize("masked", [False, True], ids=["plain", "masked"])
def test_e2softmax_equals_jitted_pallas_on_snap_ties(masked):
    """``e2softmax(int8_scale=s)`` on CPU tensors (the kernel's plain
    version) against the jitted Pallas kernel on tie rows, where a true
    division moves codes. The codes must be equal: a flipped code halves or
    doubles an output, and the rest is XLA's inexact CPU ``exp2`` of
    integers (up to 5.4e-7 relative), so 2e-6 relative and 0 absolute, as
    ``tests/test_torch_e2softmax.py`` holds them."""
    x, mask = _e2_tie_rows()
    jm = jnp.asarray(mask) if masked else None
    want = np.asarray(JE.e2softmax_pallas(
        jnp.asarray(x), int8_scale=LOGIT_INT8_SCALE, mask=jm,
        interpret=None))
    got = KE.e2softmax(torch.from_numpy(x), int8_scale=LOGIT_INT8_SCALE,
                       mask=torch.from_numpy(mask) if masked else None)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-6, atol=0)
