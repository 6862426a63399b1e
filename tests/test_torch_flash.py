"""The port's dense Flash-E2Softmax (``flash_attention`` on both backends)
against the JAX package's, on the CPU.

The port's ``cuda`` adapter hands CPU tensors to the kernel wrapper, which
computes the kernel's plain version; the JAX side runs its Pallas kernel
in interpret mode through ``repro.ops.flash_attention_fn(mode,
backend="pallas")`` at the same ``block``. The ``reference`` twins are
both the two-pass oracle. The same numpy inputs go to both sides. The
plain version and the two-pass twin are not held to each other beyond a
single block: in SOLE mode the quantized correction applies once per
k-block, which the two-pass form does not have.

Tolerances, and why:
* exact-logit inputs (q, k on small grids and a head dim whose d^-1/2 is
  a power of two, so every q.k partial sum is exact in float32):
  identical 4-bit codes and block sums; only the w.v
  sum order and XLA's inexact CPU ``exp2`` of integers (up to ~5e-7
  relative per power of two) differ: 1e-5 of the output scale.
* real-valued inputs: the dot order may move a logit across a rounding
  boundary of the int8 snap or the 4-bit code and flip it: at least 99%
  of rows within 1e-4 of the output scale.
* exact mode: float32 sums in another order and XLA's ``exp2``: 1e-5.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import ops as jops
from repro.ops import oracles as jor
from repro_torch import ops as tops
from repro_torch.kernels import flash_e2softmax as KA
from repro_torch.models.layers import LOGIT_INT8_SCALE
from repro_torch.ops import oracles as tor
from repro_torch.roofline.cost import CostCounter


def _inputs(seed, b, s, t, h, kvh, hd, grid=True):
    rng = np.random.default_rng(seed)
    if grid:
        q = rng.integers(-8, 9, (b, s, h, hd)) / 4.0
        k = rng.integers(-8, 9, (b, t, kvh, hd)).astype(np.float64)
    else:
        q = rng.standard_normal((b, s, h, hd)) * 2
        k = rng.standard_normal((b, t, kvh, hd))
    v = rng.standard_normal((b, t, kvh, hd))
    return [a.astype(np.float32) for a in (q, k, v)]


def _both(mode, backend, arrays, **kw):
    jfn = jops.flash_attention_fn(mode, backend=backend)
    tfn = tops.resolve("flash_attention", mode,
                       "cuda" if backend == "pallas" else "reference")
    want = np.asarray(jfn(*(jnp.asarray(a) for a in arrays), **kw))
    got = tfn(*(torch.from_numpy(a) for a in arrays), **kw).numpy()
    return got, want


def _close(got, want, rel=1e-5):
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale)


@pytest.mark.parametrize("mode", ["sole", "exact"])
@pytest.mark.parametrize("block", [32, 64, 96, 128])
def test_plain_matches_pallas_across_blocks(block, mode):
    """Causal, 130 rows and keys (a ragged last block at every size),
    GQA 4 query heads on 2 KV heads."""
    arrays = _inputs(block, 1, 130, 130, 4, 2, 16)
    got, want = _both(mode, "pallas", arrays, causal=True, block=block)
    assert got.shape == want.shape == (1, 130, 4, 16)
    _close(got, want)


@pytest.mark.parametrize("causal,s,t,kvh", [(True, 100, 300, 4),
                                            (True, 300, 100, 2),
                                            (False, 77, 200, 1),
                                            (False, 64, 64, 4)])
def test_plain_matches_pallas_ragged(causal, s, t, kvh):
    """Ragged S and T, causal with S < T (the tile rule shrinks the key
    blocks to the rows') and S > T, non-causal, MHA and GQA 4:1."""
    arrays = _inputs(s + t, 2, s, t, 4, kvh, 16)
    got, want = _both("sole", "pallas", arrays, causal=causal, block=64)
    _close(got, want)


@pytest.mark.parametrize("kw", [dict(int8_scale=LOGIT_INT8_SCALE),
                                dict(exact_corr=True),
                                dict(exp_bits=6),
                                dict(int8_scale=LOGIT_INT8_SCALE,
                                     exact_corr=True)],
                         ids=["int8_scale", "exact_corr", "exp_bits6",
                              "both"])
def test_plain_matches_pallas_options(kw):
    arrays = _inputs(3, 1, 256, 256, 2, 2, 64)
    got, want = _both("sole", "pallas", arrays, causal=True, block=64, **kw)
    _close(got, want)


@pytest.mark.parametrize("mode", ["sole", "exact"])
def test_plain_matches_pallas_real_logits(mode):
    arrays = _inputs(4, 1, 200, 200, 2, 2, 64, grid=False)
    kw = dict(int8_scale=LOGIT_INT8_SCALE) if mode == "sole" else {}
    got, want = _both(mode, "pallas", arrays, causal=True, block=64, **kw)
    scale = max(float(np.abs(want).max()), 1.0)
    rows_ok = (np.abs(got - want).max(-1) <= 1e-4 * scale).mean()
    assert rows_ok >= 0.99


def test_bf16_inputs_give_bf16_output():
    """q, k, v in bf16 are read as float32 by the kernel; the op returns
    q's dtype, as the JAX adapter does."""
    arrays = _inputs(5, 1, 64, 64, 2, 2, 16)
    jfn = jops.flash_attention_fn("sole", backend="pallas")
    want = jfn(*(jnp.asarray(a, jnp.bfloat16) for a in arrays), block=32)
    got = tops.resolve("flash_attention", "sole", "cuda")(
        *(torch.from_numpy(a).bfloat16() for a in arrays), block=32)
    assert got.dtype == torch.bfloat16
    _close(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
           rel=8e-3)                          # one bf16 rounding of the output


@pytest.mark.parametrize("mode", ["sole", "exact"])
@pytest.mark.parametrize("causal", [True, False])
def test_reference_twin_matches_jax_reference(mode, causal):
    """The two-pass twins, GQA 4:2, ragged, with the int8 snap in SOLE
    mode (the eager reference divides by the scale)."""
    arrays = _inputs(6, 2, 70, 90 if not causal else 70, 4, 2, 16)
    kw = dict(int8_scale=LOGIT_INT8_SCALE) if mode == "sole" else {}
    got, want = _both(mode, "reference", arrays, causal=causal, **kw)
    _close(got, want)


def test_single_block_plain_equals_two_pass():
    """Within one k-block the online update is the two-pass softmax."""
    arrays = _inputs(7, 1, 64, 64, 2, 2, 16)
    t = [torch.from_numpy(a) for a in arrays]
    one = tops.resolve("flash_attention", "sole", "cuda")(*t, block=128)
    two = tops.resolve("flash_attention", "sole", "reference")(*t)
    torch.testing.assert_close(one, two, rtol=0, atol=1e-6)


def test_oracles_match_jax_oracles():
    rng = np.random.default_rng(8)
    x = (rng.standard_normal((5, 300)) * 4).astype(np.float32)
    for snap in (None, LOGIT_INT8_SCALE):
        want = np.asarray(jor.e2softmax_ref(jnp.asarray(x), int8_scale=snap))
        got = tor.e2softmax_ref(torch.from_numpy(x), int8_scale=snap).numpy()
        np.testing.assert_allclose(got, want, rtol=2e-6)
    q, k, v = _inputs(9, 3, 40, 40, 1, 1, 16)
    q, k, v = (a[:, :, 0] for a in (q, k, v))
    for sole in (True, False):
        want = np.asarray(jor.flash_e2softmax_ref(
            *(jnp.asarray(a) for a in (q, k, v)), causal=True, sole=sole))
        got = tor.flash_e2softmax_ref(
            *(torch.from_numpy(a) for a in (q, k, v)), causal=True,
            sole=sole).numpy()
        _close(got, want)


def test_pallas_flash_snap_multiplies_by_the_reciprocal():
    """Inside the jitted Pallas call XLA rewrites ``dm / int8_scale`` into
    a multiply by ``float32(1 / s)``: the compiled kernel has no divide
    and carries that constant, so the port's plain version and kernel
    multiply too (``snap_reciprocal``)."""
    q = jnp.zeros((1, 64, 2, 32), jnp.float32)
    fn = jops.flash_attention_fn("sole", backend="pallas")
    hlo = jax.jit(lambda q: fn(q, q, q, int8_scale=LOGIT_INT8_SCALE,
                               block=32)).lower(q).compile().as_text()
    assert not re.search(r"\bdivide\(", hlo)
    inv = np.float32(KA.snap_reciprocal(LOGIT_INT8_SCALE))
    assert inv == np.float32(1) / np.float32(LOGIT_INT8_SCALE)
    assert f"constant({inv:.8g}" in hlo or f"constant({inv:.7g}" in hlo


def _kernel_only(name, fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` on meta tensors under a cost counter: it
    reports one launch of kernel ``name``, and no aten op moves a byte or
    multiplies (the plain version did not run)."""
    with CostCounter() as counter:
        out = fn(*args, **kwargs)
    kernels = {k[0]: v[0] for k, v in counter.records.items()
               if k[0].startswith("kernel:")}
    assert kernels == {"kernel:" + name: 1}
    assert not [k for k, v in counter.records.items()
                if not k[0].startswith("kernel:") and (v[1] or v[2])]
    return out


def test_wrapper_guards():
    q = torch.zeros((2, 300, 16))
    with pytest.raises(ValueError, match="tiles"):
        KA.flash_e2softmax(q, q, q, block_q=256, block_k=256)
    with pytest.raises(ValueError, match="exp_bits"):
        KA.flash_e2softmax(q, q, q, exp_bits=7)
    with pytest.raises(ValueError, match="zero keys"):
        KA.flash_e2softmax(q, q[:, :0], q[:, :0], causal=False)
    before = KA.flash_e2softmax.launches
    m = torch.zeros((1, 8, 16), device="meta")     # the dry run's route
    out = _kernel_only("flash_e2softmax", KA.flash_e2softmax, m, m, m)
    assert out.is_meta and out.shape == (1, 8, 16)
    assert KA.flash_e2softmax.launches == before    # meta never launches
    KA.flash_e2softmax(q[:, :8], q[:, :8], q[:, :8])
    assert KA.flash_e2softmax.launches == before    # CPU tensors never launch
    assert KA.dense_blocks(100, 300, 128, 128, True) == (100, 100)
    assert KA.dense_blocks(100, 300, 128, 128, False) == (100, 128)


def test_pow2_neg_is_exact_into_the_subnormals():
    k = torch.arange(0, 256)
    want = torch.from_numpy(np.ldexp(np.float32(1), -k.numpy())
                            .astype(np.float32))
    assert torch.equal(KA.pow2_neg(k), want)


# -- what the tensor-core kernel relies on --------------------------------------


@pytest.mark.parametrize("exp_bits", [1, 2, 3, 4, 5, 6])
def test_sole_weights_are_exact_in_bf16(exp_bits):
    """Every SOLE weight 2^-k (k <= 2^b - 1) survives a round trip through
    bf16, so the kernel's P.V takes P on the tensor cores unrounded; so do
    the quantized corrections 2^-sub while they are normal floats (sub <=
    126: every one for b <= 4), though the kernel multiplies them into the
    float32 accumulator and never rounds them to bf16."""
    k = torch.arange(0, 2 ** exp_bits)
    w = KA.exp2_int(-k)
    assert torch.equal(w.to(torch.bfloat16).float(), w)
    sub = torch.arange(0, min(2 ** (exp_bits + 2), 127))
    corr = KA.pow2_neg(sub)
    assert torch.equal(corr.to(torch.bfloat16).float(), corr)


def _split_p_exact(q, k, v, *, causal, block, tail=True):
    """Exact mode as the tensor-core kernel computes it, in plain torch:
    bf16 q, k, v; float32 weights; P.V as bf16(P) . V + bf16(P - bf16(P))
    . V with float32 sums (without ``tail``, bf16(P) . V alone);
    everything else as ``flash_e2softmax_plain``."""
    bh, s, d = q.shape
    t = k.shape[1]
    _, bk = KA.dense_blocks(s, t, block, block, causal)
    qf = q.float() * (d ** -0.5)
    rows = torch.arange(s)[:, None]
    m = torch.full((bh, s), KA.NEG)
    ssum = torch.zeros((bh, s))
    acc = torch.zeros((bh, s, d))
    for c0 in range(0, t, bk):
        kb, vb = k[:, c0:c0 + bk].float(), v[:, c0:c0 + bk].float()
        cols = c0 + torch.arange(kb.shape[1])[None, :]
        mask = (cols < t) & ((rows >= cols) if causal else True)
        logits = torch.where(mask, torch.einsum("bsd,btd->bst", qf, kb),
                             KA.NEG)
        m_new = torch.maximum(m, logits.amax(-1))
        w = torch.where(mask, torch.exp2((logits - m_new[..., None])
                                         * KA.LOG2E), 0.0)
        corr = torch.exp2((m - m_new) * KA.LOG2E)
        hi = w.to(torch.bfloat16).float()
        lo = (w - hi).to(torch.bfloat16).float() if tail else 0 * hi
        ssum = ssum * corr + w.sum(-1)
        acc = (acc * corr[..., None] + torch.einsum("bst,btd->bsd", hi, vb)
               + torch.einsum("bst,btd->bsd", lo, vb))
        m = m_new
    return acc / ssum[..., None]


@pytest.mark.parametrize("bh,s,t,d,causal,block", [
    (4, 130, 130, 64, True, 64), (2, 70, 200, 16, False, 32)])
def test_exact_split_p_emulation_matches_plain(bh, s, t, d, causal, block):
    """Splitting exact mode's weights into a bf16 head and a bf16 tail
    keeps the output within 1e-5 of its scale of the plain version (one
    bf16 rounding of P alone would move it by ~2^-9 relative); bf16
    inputs on the exact-logit grid, random bf16 values."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(bh + s, 1, s, t, bh, bh,
                                                    d))
    q, k, v = (x[0].transpose(0, 1).to(torch.bfloat16).contiguous()
               for x in (q, k, v))
    kw = dict(causal=causal, sole=False, block_q=block, block_k=block)
    want = KA.flash_e2softmax_plain(q, k, v, **kw)
    got = _split_p_exact(q, k, v, causal=causal, block=block)
    scale = max(want.abs().max().item(), 1.0)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * scale)
    head_only = _split_p_exact(q, k, v, causal=causal, block=block,
                               tail=False)
    assert (head_only - want).abs().max().item() > 1e-5 * scale
