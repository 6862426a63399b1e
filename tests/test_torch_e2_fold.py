"""The dense path's SOLE attention probabilities as one ``softmax`` ``sole``
op call (``int8_scale`` and ``out_dtype`` on the raw logits) against the
chain it replaced (masked max, subtract, ``snap_logits``, E2Softmax, cast),
on both port backends, and against the jitted JAX chain
(``repro/models/layers.py`` ``attend_dense``/``decode_attend_stacked``: the
same ops around the Pallas E2Softmax in interpret mode, config
``ops_backend="pallas"``). The same numpy inputs go to every side.

Why the one call equals the chain: for a row with a kept entry the op's
masked max is the chain's max ``m``; the chain's snapped differences are
<= 0 with one exactly 0, so the second max inside its op is 0 and changes
nothing; a fully masked row gives zeros both ways.

Tolerances, and why:
* port one call against port chain, on either backend and across them:
  bit for bit (the same float32 operations in the same order).
* against JAX: bf16 outputs bit for bit; float32 outputs with equal codes
  (``k + e`` and the ALDivision bucket, from the float32 exponent and
  mantissa) and within 2e-6 relative, because XLA's CPU ``exp2`` of an
  integer is off by up to 5.4e-7 relative where the port builds every
  power of two from its exponent bits; every output is ``2^-n`` times
  1.636 or 1.136, about 0.4 of a bf16 ulp from the nearest bf16 midpoint,
  so that error never moves a bf16 rounding.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import ops as jops
from repro.configs.base import get_config as jax_config
from repro.models import layers as JL
from repro_torch import ops as tops
from repro_torch.configs.base import get_config
from repro_torch.kernels import e2softmax as KE
from repro_torch.models import layers as L
from repro_torch.models.layers import LOGIT_INT8_SCALE
from test_torch_snap import snap_ties

B, H, KVH, S, T = 2, 4, 2, 12, 16       # lanes, heads, KV heads, queries, cache
RTOL = 2e-6
BACKENDS = ("reference", "cuda")        # "cuda" on CPU tensors: the plain form


def _logits(rng, shape):
    """Random logits with, per row group, snap-tie rows (logit 0 first and
    the snap's rounding ties after it, so ``x - max`` is the tie itself)
    and rows whose max sits at several positions."""
    x = (rng.standard_normal(shape) * 4).astype(np.float32)
    rows = x.reshape(-1, shape[-1])
    ties = np.array([t for t, _ in snap_ties(LOGIT_INT8_SCALE)], np.float32)
    c = shape[-1]
    for i in range(0, rows.shape[0], 7):
        rows[i] = 0.0
        rows[i, 1:] = rng.choice(ties, c - 1)
    for i in range(3, rows.shape[0], 7):
        top = rows[i].max() + 1.5
        rows[i, rng.choice(c, 3, replace=False)] = top
    return x


def _masks(rng):
    """The dense path's mask forms, as numpy (shape, array): prefill's
    shared causal (S, S) mask, its per-lane (B, 1, S, S) left-padded mask
    with a fully masked row, and decode's concatenated (B, KV, g, T+1)
    mask (a lane sees its columns up to a per-lane length, never the
    write slot, and the current token)."""
    pos = np.arange(S)
    shared = pos[None, :] <= pos[:, None]
    n_pad = np.array([5, 0])
    local = pos[None] - n_pad[:, None]
    kpos = np.where(local < 0, 2 ** 30, local)
    qpos = np.clip(local, 0, None)
    lanes = (kpos[:, None, :] < 2 ** 29) & (qpos[:, :, None] >= kpos[:, None])
    lanes[0, 2, :] = False                          # a fully masked row
    lens = np.array([9, 16])
    valid = (np.arange(T)[None] < lens[:, None]) & (np.arange(T)[None] != 3)
    dec = np.concatenate(
        [np.broadcast_to(valid[:, None, None, :], (B, KVH, H // KVH, T)),
         np.ones((B, KVH, H // KVH, 1), bool)], -1)
    return {"prefill_shared": ((B, H, S, S), shared),
            "prefill_lanes": ((B, H, S, S), lanes[:, None]),
            "decode_cat": ((B, KVH, H // KVH, T + 1), dec)}


def _case(form, seed):
    rng = np.random.default_rng(seed)
    shape, mask = _masks(rng)[form]
    return _logits(rng, shape), np.ascontiguousarray(mask)


def _torch_chain(op, x, mask, cfg, out_dtype):
    """The chain the dense path ran before the fold, on backend ``op``."""
    m = torch.where(mask, x, -torch.inf).amax(-1, keepdim=True)
    d = tops.snap_logits(x - torch.clamp_min(m, -1e30),
                         LOGIT_INT8_SCALE if cfg.logit_int8 else None)
    return op(d, mask=mask, exp_bits=cfg.exp_bits).to(out_dtype)


def _cfg(exp_bits, logit_int8=True):
    return dataclasses.replace(get_config("qwen2_0_5b").smoke(),
                               exp_bits=exp_bits, logit_int8=logit_int8)


def _jax_chain(x, mask, exp_bits, logit_int8, out_dtype):
    """``attend_dense``'s SOLE lines, jitted, on the Pallas backend."""
    jcfg = dataclasses.replace(jax_config("qwen2_0_5b").smoke(),
                               ops_backend="pallas", exp_bits=exp_bits,
                               logit_int8=logit_int8)

    @jax.jit
    def chain(logits, mask):
        m = jnp.max(jnp.where(mask, logits, -jnp.inf), -1, keepdims=True)
        m = jnp.maximum(m, -1e30)
        logits = JL._snap_logits(logits - m, jcfg)
        probs = jops.softmax_fn("sole", jcfg)(logits, mask=mask,
                                               exp_bits=jcfg.exp_bits)
        return probs.astype(out_dtype)
    mask = np.broadcast_to(mask, x.shape)
    return np.asarray(chain(jnp.asarray(x), jnp.asarray(mask)).astype(
        jnp.float32))


def _codes(out):
    mant, expo = np.frexp(np.asarray(out, np.float64))
    return expo, mant >= 0.7


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("exp_bits", [4, 6])
@pytest.mark.parametrize("form", ["prefill_shared", "prefill_lanes",
                                  "decode_cat"])
def test_one_call_equals_chain_on_both_backends(form, exp_bits, out_dtype):
    x, mask = _case(form, seed=exp_bits)
    tx, tm = torch.from_numpy(x), torch.from_numpy(mask)
    tm = torch.broadcast_to(tm, tx.shape)             # as the path hands it
    cfg, dt = _cfg(exp_bits), getattr(torch, out_dtype)
    outs = []
    for backend in BACKENDS:
        op = tops.resolve("softmax", "sole", backend)
        one = op(tx, mask=tm, exp_bits=exp_bits, int8_scale=LOGIT_INT8_SCALE,
                 out_dtype=dt)
        chain = _torch_chain(op, tx, tm, cfg, dt)
        assert one.dtype == dt and torch.equal(one, chain)
        outs.append(one)
    assert torch.equal(outs[0], outs[1])
    assert (outs[0][~tm] == 0).all()


@pytest.mark.parametrize("logit_int8", [True, False], ids=["snap", "raw"])
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("form", ["prefill_lanes", "decode_cat"])
def test_sole_probs_equals_chain(form, out_dtype, logit_int8):
    """``layers._sole_probs`` (the one call) against the chain, on the
    CPU's backend, with and without the int8 snap."""
    x, mask = _case(form, seed=3)
    tx = torch.from_numpy(x)
    tm = torch.broadcast_to(torch.from_numpy(mask), tx.shape)
    cfg, dt = _cfg(4, logit_int8), getattr(torch, out_dtype)
    got = L._sole_probs(tx, tm, cfg, dt)
    want = _torch_chain(tops.softmax_fn("sole", "cpu"), tx, tm, cfg, dt)
    assert got.dtype == dt and torch.equal(got, want)


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("exp_bits", [4, 6])
@pytest.mark.parametrize("form", ["prefill_shared", "prefill_lanes",
                                  "decode_cat"])
def test_one_call_matches_jitted_jax_chain(form, exp_bits, out_dtype):
    x, mask = _case(form, seed=10 + exp_bits)
    tx = torch.from_numpy(x)
    tm = torch.broadcast_to(torch.from_numpy(mask), tx.shape)
    dt = getattr(torch, out_dtype)
    got = tops.softmax_fn("sole", "cpu")(
        tx, mask=tm, exp_bits=exp_bits, int8_scale=LOGIT_INT8_SCALE,
        out_dtype=dt).float().numpy()
    want = _jax_chain(x, mask, exp_bits, True, getattr(jnp, out_dtype))
    if out_dtype == "bfloat16":
        np.testing.assert_array_equal(got, want)
        return
    for a, b in zip(_codes(got), _codes(want)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)


def test_snap_tie_rows_reach_the_snap():
    """The tie rows hold logits on which the jitted snap (a multiply by
    float32(1/s)) and the true division disagree, so the cases above
    would catch a fold that snapped in the other form."""
    x, mask = _case("decode_cat", seed=4)
    row = torch.from_numpy(x.reshape(-1, x.shape[-1])[0])
    s = np.float32(LOGIT_INT8_SCALE)
    true = torch.round(row / torch.tensor(s))
    mult = torch.round(tops.snap_logits(row, LOGIT_INT8_SCALE) / s)
    assert (true != mult).any()


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_plain_version_on_stride0_masks(out_dtype):
    """The kernel's plain version on a mask broadcast over heads and
    lanes (stride 0 in two leading dims) equals it on the materialized
    mask, and the kernel's view of it keeps the zero strides."""
    x, mask = _case("prefill_shared", seed=8)
    tx = torch.from_numpy(x)
    view = torch.broadcast_to(torch.from_numpy(mask), tx.shape)
    assert view.stride()[:2] == (0, 0)
    dt = getattr(torch, out_dtype)
    kw = dict(exp_bits=4, int8_scale=LOGIT_INT8_SCALE, out_dtype=dt)
    got = KE.e2softmax_plain(tx, mask=view, **kw)
    assert torch.equal(got, KE.e2softmax_plain(tx, mask=view.contiguous(),
                                               **kw))
    assert torch.equal(got, KE.e2softmax(tx, mask=torch.from_numpy(mask),
                                         **kw))
    sizes, xs, ms = KE.row_view(tx, view)
    assert sizes == (1, 1, B * H, S) and ms == (0, 0, 0, S)


def test_row_view_forms_and_refusals():
    """The kernel's (rows, C) views: the decode mask is one dense run of
    rows, the per-lane prefill mask keeps its stride-0 head dim; a mask
    broadcast along the columns, or one needing five leading dims, has
    no view."""
    x = torch.zeros((B, H, S, S))
    lanes = torch.zeros((B, 1, S, S), dtype=torch.bool)
    assert KE.row_view(x, lanes.expand(x.shape)) == (
        (1, B, H, S), (0, H * S * S, S * S, S), (0, S * S, 0, S))
    dec = torch.zeros((B, KVH, H // KVH, T + 1), dtype=torch.bool)
    xd = torch.zeros(dec.shape)
    assert KE.row_view(xd, dec)[0] == (1, 1, 1, B * H)
    col = torch.zeros((B, H, S, 1), dtype=torch.bool).expand(x.shape)
    assert KE.row_view(x, col) is None
    x5 = torch.zeros((2, 3, 2, 3, 2, 4))
    m5 = torch.zeros((2, 1, 2, 1, 2, 4), dtype=torch.bool).expand(x5.shape)
    assert KE.row_view(x5, m5) is None
    assert KE.row_view(x5, None)[0] == (1, 1, 1, 72)
