"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU the port's ``cuda`` adapters hand CPU tensors to the kernel
wrappers, which compute the kernels' plain versions; the JAX side runs
its Pallas kernels in interpret mode through ``repro.ops.resolve(...,
"pallas")``. The same numpy inputs go to both.

Tolerances, and why:
* quantize+norm: integer codes and sums are exact on both sides, so the
  float output differs only by XLA's rsqrt/division rounding: 1e-6
  relative.
* paged attention, exact mode: fp32 sums in another order: 1e-5.
* paged attention, SOLE mode on exact-logit inputs (q, k small integers
  so every q.k partial sum is exact in fp32): identical 4-bit codes, so
  only the P.V sum order and XLA's inexact ``exp2`` of integers differ:
  1e-5. On real-valued inputs a logit can land on the other side of an
  int8-snap rounding boundary and flip one code, so there at least 99%
  of rows agree to 1e-4.

The card-only tests, each CUDA kernel against its plain version at the
full width of qwen2_0_5b, are in ``tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

from repro import ops as jops
from repro_torch import ops as tops
from repro_torch.kernels import ailayernorm as KN
from repro_torch.kernels import flash_e2softmax as KA
from repro_torch.models.layers import LOGIT_INT8_SCALE

import jax.numpy as jnp


# -- quantize + norm ------------------------------------------------------------


def _norm_inputs(rng, rows, c):
    x = rng.standard_normal((rows, c)).astype(np.float32) * 2
    x *= 2.0 ** rng.integers(0, 4, size=c)            # every PTF alpha
    r = rng.standard_normal((rows, c)).astype(np.float32)
    gamma = (1 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    beta = (0.1 * rng.standard_normal(c)).astype(np.float32)
    return x, r, gamma, beta


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(6, 64), (2, 3, 896)])
def test_norm_matches_pallas(kind, dtype, shape):
    """``(residual_)rmsnorm``/``layernorm`` in SOLE mode: the port's cuda
    adapter (plain version on CPU tensors) and its reference backend
    against the Pallas qnorm kernel in interpret mode."""
    rng = np.random.default_rng(len(shape) + len(kind))
    x, r, gamma, beta = _norm_inputs(rng, int(np.prod(shape[:-1])),
                                     shape[-1])
    x, r = x.reshape(shape), r.reshape(shape)
    jdt = jnp.dtype(dtype)
    jx, jr = jnp.asarray(x).astype(jdt), jnp.asarray(r).astype(jdt)
    tdt = getattr(torch, dtype)
    tx = torch.from_numpy(x).to(tdt)
    tr = torch.from_numpy(r).to(tdt)
    tg, tb = torch.from_numpy(gamma), torch.from_numpy(beta)
    args_j = (jnp.asarray(gamma),) + ((jnp.asarray(beta),)
                                      if kind == "layernorm" else ())
    args_t = (tg,) + ((tb,) if kind == "layernorm" else ())
    before = KN.qnorm.launches
    want = np.asarray(jops.resolve(kind, "sole", "pallas")(jx, *args_j))
    for backend in ("cuda", "reference"):
        got = tops.resolve(kind, "sole", backend)(tx, *args_t)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    js, jout = jops.resolve(f"residual_{kind}", "sole", "pallas")(
        jx, jr, *args_j)
    ts, tout = tops.resolve(f"residual_{kind}", "sole", "cuda")(tx, tr,
                                                                *args_t)
    np.testing.assert_array_equal(ts.float().numpy(),
                                  np.asarray(js, np.float32))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=1e-6,
                               atol=1e-6)
    assert KN.qnorm.launches == before         # CPU tensors never launch


# -- paged attention ------------------------------------------------------------


def _paged_case(rng, *, b, c, h, kvh, d, bs, nb, q_start, kv_len, grid,
                dtype=np.float32):
    """Model-layout inputs: q (B, C, H, d), pools (N, bs, KV, d) with
    garbage in the null page 0, tables (B, NB) covering each sequence's
    keys on shuffled pages (kv_len 1 with q_start 0 = a null lane)."""
    n = b * nb + 1
    if grid:
        q = rng.integers(-8, 9, (b, c, h, d)) / 4.0
        k = rng.integers(-8, 9, (n, bs, kvh, d)).astype(np.float64)
    else:
        q = rng.standard_normal((b, c, h, d)) * 2
        k = rng.standard_normal((n, bs, kvh, d))
    v = rng.standard_normal((n, bs, kvh, d))
    k[0] = rng.standard_normal((bs, kvh, d)) * 50       # null-page garbage
    v[0] = rng.standard_normal((bs, kvh, d)) * 50
    perm = rng.permutation(np.arange(1, n))
    tables = np.zeros((b, nb), np.int32)
    for i in range(b):
        if kv_len[i] > 1 or q_start[i] > 0:
            used = -(-kv_len[i] // bs)
            tables[i, :used] = perm[i * nb:i * nb + used]
    return (q.astype(dtype), k.astype(dtype), v.astype(dtype), tables,
            np.asarray(q_start, np.int32), np.asarray(kv_len, np.int32))


CASES = {
    # a causal prefill chunk at q_start > 0 across >= 3 pages, one lane
    # with a padded tail (kv_len < q_start + C)
    "chunk": dict(b=2, c=8, bs=4, nb=6, q_start=[5, 9], kv_len=[13, 15],
                  causal=True),
    # decode: kv_len not a multiple of bs, and a null lane
    "decode": dict(b=4, c=1, bs=4, nb=8, q_start=[6, 12, 0, 21],
                   kv_len=[7, 13, 1, 22], causal=False),
}


def _run_both(case, mode, causal, int8_scale):
    q, k, v, tables, q_start, kv_len = case
    kw = dict(causal=causal, exp_bits=4, int8_scale=int8_scale)
    want = jops.resolve("paged_attention", mode, "pallas")(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(tables),
        jnp.asarray(q_start), jnp.asarray(kv_len), **kw)
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in case]
    got = tops.resolve("paged_attention", mode, "cuda")(*t, **kw)
    ref = tops.resolve("paged_attention", mode, "reference")(*t, **kw)
    return (np.asarray(jnp.asarray(want, jnp.float32)), got.float().numpy(),
            ref.float().numpy())


@pytest.mark.parametrize("heads", [(4, 2), (14, 2)], ids=["gqa2", "gqa7"])
@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("mode,snap", [("exact", False), ("sole", True),
                                       ("sole", False)],
                         ids=["exact", "sole-int8", "sole"])
def test_paged_attention_matches_pallas(heads, name, mode, snap):
    """Exact-logit inputs: the port's plain paged kernel (through the cuda
    adapter and the reference backend) equals the Pallas kernel to 1e-5,
    garbage in the null page included."""
    h, kvh = heads
    spec = dict(CASES[name])
    causal = spec.pop("causal")
    rng = np.random.default_rng(h + len(name) + snap)
    case = _paged_case(rng, h=h, kvh=kvh, d=16, grid=True, **spec)
    before = KA.flash_e2softmax_paged.launches
    want, got, ref = _run_both(case, mode, causal,
                               LOGIT_INT8_SCALE if snap else None)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got, ref)
    assert KA.flash_e2softmax_paged.launches == before


@pytest.mark.parametrize("name", list(CASES))
def test_paged_attention_sole_real_valued(name):
    """Real-valued bf16 inputs in SOLE mode: at least 99% of rows agree to
    1e-4 (a code may flip at an int8-snap rounding boundary)."""
    spec = dict(CASES[name])
    causal = spec.pop("causal")
    spec.update(b=spec["b"] * 4, nb=spec["nb"])
    spec["q_start"] = spec["q_start"] * 4
    spec["kv_len"] = spec["kv_len"] * 4
    rng = np.random.default_rng(11)
    case = _paged_case(rng, h=14, kvh=2, d=64, grid=False, **spec)
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16).float().numpy()
               for a in case[:3])
    case = (q, k, v) + case[3:]
    want, got, _ = _run_both(case, "sole", causal, LOGIT_INT8_SCALE)
    row_err = np.abs(got - want).max(-1)
    assert (row_err <= 1e-4).mean() >= 0.99, row_err.max()


def test_paged_wrappers_layouts_and_guards():
    """The decode wrapper is the C=1, non-causal paged call, over float
    and over int8 pools; ``quant_pv`` without int8 pools (``kv_scale``)
    changes nothing, as in the reference."""
    rng = np.random.default_rng(2)
    q, k, v, tables, _, kv_len = (torch.from_numpy(np.ascontiguousarray(a))
                                  for a in _paged_case(
                                      rng, b=3, c=1, h=4, kvh=2, d=16, bs=4,
                                      nb=5, q_start=[0, 0, 0],
                                      kv_len=[3, 17, 9], grid=True))
    qk = q[:, 0].contiguous()                          # (B, H, d)
    dec = KA.flash_e2softmax_paged_decode(qk, k, v, tables, kv_len)
    meta = torch.stack([torch.zeros_like(kv_len), kv_len], 1)
    full = KA.flash_e2softmax_paged(qk[:, :, None], k, v, tables, meta,
                                    causal=False)
    assert torch.equal(dec, full[:, :, 0]) and dec.shape == (3, 4, 16)
    assert torch.equal(full, KA.flash_e2softmax_paged(
        qk[:, :, None], k, v, tables, meta, causal=False, quant_pv=True))
    codes = [torch.clamp(torch.round(t * 16), -127, 127).to(torch.int8)
             for t in (k, v)]
    dec8 = KA.flash_e2softmax_paged_decode(qk, *codes, tables, kv_len,
                                           kv_scale=1 / 16, quant_pv=True)
    assert dec8.shape == (3, 4, 16) and torch.isfinite(dec8).all()


# -- backend resolution -------------------------------------------------------


def test_backend_follows_device():
    assert tops.backend_for("paged_attention", "sole", "cpu") == "reference"
    assert tops.backend_for("paged_attention", "sole", "cuda") == "cuda"
    assert tops.backend_for("rmsnorm", "sole", "cuda") == "cuda"
    # the exact norms run the row-stable exact-norm kernel on the card
    # (torch's reductions there split rows by the batch's row count)
    for op in ("rmsnorm", "layernorm", "residual_rmsnorm",
               "residual_layernorm_q"):
        assert tops.backend_for(op, "exact", "cuda") == "cuda"
        assert tops.backend_for(op, "exact", "cpu") == "reference"
    # no kernel in the reference either: plain torch on the card
    assert tops.backend_for("softmax", "ibert", "cuda") == "reference"
    for mode in ("exact", "sole"):
        assert tops.backend_for("flash_attention", mode, "cpu") == "reference"
        assert tops.backend_for("flash_attention", mode, "cuda") == "cuda"
    with pytest.raises(ValueError):
        tops.backend_for("softmax", "nope", "cpu")
    with pytest.raises(NotImplementedError):
        tops.resolve("rmsnorm", "ibert", "cuda")
