"""The port's W8A8 pieces against the JAX package's, on the CPU: the quant
primitives, weight packing, the w8a8/w8a16 matmul twins (the int8 GEMM's
plain version), the quant-out residual norms and the paged attention
kernel's int8-pool branch. The same numpy inputs go to both sides; the JAX
side runs its Pallas kernels in interpret mode through ``repro.ops``.

Tolerances, and why:
* quantize_act / quantize_weight / quantize_params / w8a8 matmul: integer
  codes, exact int32 sums and the same float32 epilogue in the same order:
  bitwise equal.
* w8a16: float sums in another order: 1e-5.
* quant-out residual norms: the residual carry is the same add (1e-6 by
  the reference's own stated bound), the codes and scales are
  ``quantize_act`` of norm outputs that agree to 1e-6: codes equal, scale
  1e-6 relative.
* paged attention over int8 pools on exact-logit inputs (q and the K codes
  small integers, so every q.k partial sum is exact in float32): identical
  4-bit codes, only the P.V sum order differs: 1e-5, as for bf16 pools.
"""
import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import ops as jops
from repro.configs.base import get_config as jax_config
from repro.core.sole import quant as JQ
from repro.models import api as japi
from repro.sharding import rules as JR
from repro_torch import ops as tops
from repro_torch.configs.base import QuantConfig, get_config
from repro_torch.convert import params_from_jax
from repro_torch.core.sole import quant as TQ
from repro_torch.kernels import flash_e2softmax as KA
from repro_torch.kernels import int8_matmul as KM
from repro_torch.models import layers as TL
from repro_torch.models.layers import KV_INT8_SCALE, LOGIT_INT8_SCALE
from repro_torch.sharding import rules as TR


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))                 # a writable copy
    return t if dtype is None else t.to(dtype)


# -- quant primitives -----------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_contract", [1, 2])
def test_quantize_act_bitwise(dtype, n_contract):
    """Against ``quantize_act`` as the reference's model runs it, inside
    ``jit`` (see ``repro_torch/core/sole/quant.py`` on the scale)."""
    rng = np.random.default_rng(n_contract)
    x = rng.standard_normal((3, 5, 4, 16)).astype(np.float32) * 3
    x[0, 1] = 0.0                                  # an all-zero row: scale 1
    x[1, 2, :, :3] *= 40                           # outliers
    jq, js = jax.jit(JQ.quantize_act, static_argnums=1)(
        jnp.asarray(x).astype(dtype), n_contract)
    tq, ts = TQ.quantize_act(_t(x, getattr(torch, dtype)), n_contract)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,n_contract,offset", [
    ((32, 4, 8), 1, 0),            # wq (d, h, hd)
    ((4, 8, 32), 2, 0),            # wo (h, hd, d)
    ((3, 32, 24), 1, 1),           # stacked gate (layers, d, f)
    ((2, 4, 8, 32), 2, 1)])        # stacked wo
def test_quantize_weight_bitwise(dtype, shape, n_contract, offset):
    rng = np.random.default_rng(len(shape) + n_contract)
    w = rng.standard_normal(shape).astype(np.float32) * 0.02
    jw = JQ.quantize_weight(jnp.asarray(w).astype(dtype), n_contract,
                            offset=offset)
    tw = TQ.quantize_weight(_t(w, getattr(torch, dtype)), n_contract,
                            offset=offset)
    np.testing.assert_array_equal(tw["q"].numpy(), np.asarray(jw["q"]))
    np.testing.assert_array_equal(tw["s"].numpy(), np.asarray(jw["s"]))
    assert tw["s"].shape == jw["s"].shape
    np.testing.assert_array_equal(TQ.dequantize_weight(tw).numpy(),
                                  np.asarray(JQ.dequantize_weight(jw)))


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def test_quantize_params_matches_reference():
    """The qwen2 smoke tree packed by both: the same leaves, codes and
    scales bitwise; packing is idempotent and shrinks the tree below
    0.55x of its float32 bytes."""
    jparams = japi.init_params(0, jax_config("qwen2_0_5b").smoke())[0]
    cfg = get_config("qwen2_0_5b").smoke()
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    jq = _flat(jax.tree.map(np.asarray, JR.quantize_params(jparams)))
    tq = _flat(TR.quantize_params(tparams))
    assert set(jq) == set(tq)
    packed = [k for k in tq if k[-1] in ("q", "s")]
    assert len(packed) == 2 * len(TR.QUANT_WEIGHT_SPEC)
    for k, v in tq.items():
        assert v.dtype == getattr(torch, str(jq[k].dtype)), k
        np.testing.assert_array_equal(v.numpy(), jq[k])
    again = TR.quantize_params(TR.quantize_params(tparams))
    assert all(torch.equal(a, _flat(again)[k]) for k, a in tq.items())
    assert TR.param_bytes(TR.quantize_params(tparams)) \
        < 0.55 * TR.param_bytes(tparams)


# -- matmul twins ---------------------------------------------------------------


def _w8a8_inputs(rng, batch, wshape, n_contract):
    x = rng.standard_normal(batch + wshape[:n_contract]).astype(np.float32)
    w = rng.standard_normal(wshape).astype(np.float32) * 0.05
    jx = JQ.quantize_act(jnp.asarray(x), n_contract)
    jw = JQ.quantize_weight(jnp.asarray(w), n_contract)
    tx = (_t(np.asarray(jx[0])), _t(np.asarray(jx[1])))
    tw = {"q": _t(np.asarray(jw["q"])), "s": _t(np.asarray(jw["s"]))}
    return x, w, jx, jw, tx, tw


@pytest.mark.parametrize("batch,wshape,n_contract", [
    ((7,), (130, 33), 1),                 # ragged M, K and N
    ((64,), (256, 128), 1),
    ((2, 3), (4, 16, 64), 2)],            # wo: contracts (H, hd)
    ids=["7x130x33", "64x256x128", "wo"])
def test_w8a8_matmul_bitwise_matches_pallas(batch, wshape, n_contract):
    """The port's cuda adapter (the GEMM's plain version on CPU tensors)
    and its reference twin, bitwise against the Pallas int8 kernel."""
    rng = np.random.default_rng(sum(wshape))
    _, _, jx, jw, tx, tw = _w8a8_inputs(rng, batch, wshape, n_contract)
    want = np.asarray(jops.matmul_fn("w8a8", backend="pallas")(
        jx, jw, n_contract=n_contract))
    before = KM.int8_matmul.launches
    for backend in ("cuda", "reference"):
        got = tops.resolve("matmul", "w8a8", backend)(
            tx, tw, n_contract=n_contract)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)
    assert KM.int8_matmul.launches == before     # CPU tensors never launch
    # the int32 product itself
    k = int(np.prod(wshape[:n_contract]))
    acc = KM.int8_matmul(tx[0].reshape(-1, k), tw["q"].reshape(k, -1))
    ref = (tx[0].reshape(-1, k).long() @ tw["q"].reshape(k, -1).long())
    assert acc.dtype == torch.int32 and torch.equal(acc.long(), ref)


@pytest.mark.parametrize("n_contract", [1, 2])
def test_w8a16_matmul_matches_reference(n_contract):
    rng = np.random.default_rng(5)
    wshape = (64, 48) if n_contract == 1 else (4, 16, 48)
    x, _, _, jw, _, tw = _w8a8_inputs(rng, (3, 5), wshape, n_contract)
    want = np.asarray(jops.matmul_fn("w8a16")(jnp.asarray(x), jw,
                                               n_contract=n_contract))
    got = tops.matmul_fn("w8a16", "cpu")(_t(x), tw, n_contract=n_contract)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_qmatmul_routes_by_mode():
    """At w8a8 a plain activation is quantized on the fly in float32 and
    equals the pair path bitwise; at w8a16 it stays float."""
    rng = np.random.default_rng(9)
    x, _, _, _, _, tw = _w8a8_inputs(rng, (2, 3), (64, 40), 1)
    cfg = get_config("qwen2_0_5b").smoke()
    c8 = dataclasses.replace(cfg, quant=QuantConfig("w8a8"))
    c16 = dataclasses.replace(cfg, quant=QuantConfig("w8a16"))
    pair = TQ.quantize_act(_t(x))
    assert torch.equal(TL.qmatmul(_t(x), tw, c8), TL.qmatmul(pair, tw, c8))
    assert torch.equal(TL.qmatmul(_t(x), tw, c16),
                       tops.matmul_fn("w8a16", "cpu")(_t(x), tw))


# -- quant-out residual norms ---------------------------------------------------


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
@pytest.mark.parametrize("mode", ["exact", "sole"])
def test_residual_norm_q_matches_reference(kind, mode):
    """``residual_*_q``: the port's cuda adapter (kernel's plain version)
    and reference twin against JAX's (Pallas in SOLE mode; exact mode has
    no kernel, so its reference)."""
    rng = np.random.default_rng(len(kind) + len(mode))
    shape = (2, 3, 64)
    x = rng.standard_normal(shape).astype(np.float32) * 2
    x *= 2.0 ** rng.integers(0, 4, size=shape[-1])
    r = rng.standard_normal(shape).astype(np.float32)
    gamma = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    beta = (0.1 * rng.standard_normal(64)).astype(np.float32)
    jargs = (jnp.asarray(gamma),) + ((jnp.asarray(beta),)
                                     if kind == "layernorm" else ())
    targs = (_t(gamma),) + ((_t(beta),) if kind == "layernorm" else ())
    jbackend = "pallas" if mode == "sole" else "reference"
    jh, (jq, js) = jax.jit(jops.resolve(f"residual_{kind}_q", mode, jbackend))(
        jnp.asarray(x), jnp.asarray(r), *jargs)
    for backend in ("cuda", "reference"):
        if not tops.is_registered(f"residual_{kind}_q", mode, backend):
            continue
        th, (tq, ts) = tops.resolve(f"residual_{kind}_q", mode, backend)(
            _t(x), _t(r), *targs)
        np.testing.assert_allclose(th.float().numpy(), np.asarray(jh),
                                   rtol=1e-6, atol=1e-6)
        assert tq.dtype == torch.int8 and tq.shape == jq.shape
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6)
    fn = tops.residual_norm_q_fn(kind, mode, "cpu")
    assert fn is tops.resolve(f"residual_{kind}_q", mode, "reference")


# -- paged attention over int8 pools ------------------------------------------


def _int8_paged_case(rng, *, b, c, h, kvh, d, bs, nb, q_start, kv_len):
    """q (B, C, H, d) on an exact-logit grid; int8 K codes in [-8, 8] and
    V codes over the full range, with garbage codes in the null page 0;
    tables on shuffled pages (kv_len 1 with q_start 0 = a null lane)."""
    n = b * nb + 1
    q = rng.integers(-8, 9, (b, c, h, d)) / 4.0
    k = rng.integers(-8, 9, (n, bs, kvh, d))
    v = rng.integers(-127, 128, (n, bs, kvh, d))
    k[0] = rng.integers(-127, 128, (bs, kvh, d))
    perm = rng.permutation(np.arange(1, n))
    tables = np.zeros((b, nb), np.int32)
    for i in range(b):
        if kv_len[i] > 1 or q_start[i] > 0:
            used = -(-kv_len[i] // bs)
            tables[i, :used] = perm[i * nb:i * nb + used]
    return (q.astype(np.float32), k.astype(np.int8), v.astype(np.int8),
            tables, np.asarray(q_start, np.int32),
            np.asarray(kv_len, np.int32))


INT8_CASES = {
    # a causal chunk at q_start > 0 over >= 3 pages, one lane's tail padded
    "chunk": dict(b=2, c=8, bs=4, nb=6, q_start=[5, 9], kv_len=[13, 15],
                  causal=True),
    # ragged decode: kv_len not a multiple of bs, and a null lane
    "decode": dict(b=4, c=1, bs=4, nb=8, q_start=[6, 12, 0, 21],
                   kv_len=[7, 13, 1, 22], causal=False),
}


@pytest.mark.parametrize("quant_pv", [False, True], ids=["pv-f32", "pv-int8"])
@pytest.mark.parametrize("name", list(INT8_CASES))
@pytest.mark.parametrize("mode,snap", [("exact", False), ("sole", True),
                                       ("sole", False)],
                         ids=["exact", "sole-int8", "sole"])
def test_paged_attention_int8_pools_match_pallas(quant_pv, name, mode, snap):
    spec = dict(INT8_CASES[name])
    causal = spec.pop("causal")
    rng = np.random.default_rng(len(name) + 2 * quant_pv + snap)
    case = _int8_paged_case(rng, h=14, kvh=2, d=16, **spec)
    kw = dict(causal=causal, exp_bits=4, kv_scale=KV_INT8_SCALE,
              quant_pv=quant_pv,
              int8_scale=LOGIT_INT8_SCALE if snap else None)
    want = np.asarray(jops.resolve("paged_attention", mode, "pallas")(
        *map(jnp.asarray, case), **kw))
    t = [_t(a) for a in case]
    before = KA.flash_e2softmax_paged.launches
    got = tops.resolve("paged_attention", mode, "cuda")(*t, **kw).numpy()
    ref = tops.resolve("paged_attention", mode, "reference")(*t, **kw)
    assert KA.flash_e2softmax_paged.launches == before
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got, ref.numpy())
    # quant_pv folds kv_scale (a power of two) into the row scale: the
    # same numbers as dequantizing V first, to float32 rounding.
    if quant_pv:
        other = tops.resolve("paged_attention", mode, "reference")(
            *t, **dict(kw, quant_pv=False))
        np.testing.assert_allclose(got, other.numpy(), rtol=1e-6, atol=1e-6)


def test_kv_quant_round_trip():
    """int8 KV codes as the reference writes them, and back."""
    cfg = dataclasses.replace(get_config("qwen2_0_5b").smoke(),
                              kv_cache_dtype="int8")
    x = np.random.default_rng(4).standard_normal((2, 3, 2, 16)) * 4
    x = x.astype(np.float32)
    x[0, 0, 0, :4] = [0.03125, -0.03125, 0.09375, 100.0]   # ties, clip
    codes = TL.kv_quant(_t(x), cfg)
    assert codes.dtype == TL.kv_store_dtype(cfg) == torch.int8
    want = np.clip(np.round(x / KV_INT8_SCALE), -127, 127).astype(np.int8)
    np.testing.assert_array_equal(codes.numpy(), want)
    np.testing.assert_array_equal(TL.kv_dequant(codes, cfg).numpy(),
                                  want.astype(np.float32) * KV_INT8_SCALE)


# -- the int8 GEMM's split-K plan ----------------------------------------------


def _chip_smoke_gemm_kn():
    """(name, K, N) of the w8a8 path's GEMMs, as ``chip_smoke.py`` times
    and checks them."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_gemm", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.GEMM_KN


PATH_GEMMS = [(m, k, n) for m in (8, 128) for _, k, n in _chip_smoke_gemm_kn()]
# the uneven splits the card tests add: M = 1 at down's K (480-byte
# splits); K not a multiple of 64 x splits, with and without 16-byte loads
# (K % 16 == 0 or not); N % 4 != 0 (no vectorized loads)
UNEVEN_GEMMS = [(1, 4864, 896), (8, 1008, 896), (8, 1000, 896),
                (8, 896, 130)]


@pytest.mark.parametrize("m,k,n", PATH_GEMMS + UNEVEN_GEMMS,
                         ids=[f"{m}x{k}x{n}" for m, k, n in
                              PATH_GEMMS + UNEVEN_GEMMS])
def test_split_plan_covers_k_once_and_fills_the_card(m, k, n):
    """The splits' K ranges tile [0, K) in order with no gap, overlap or
    empty range, on 32-byte boundaries; every path shape launches at
    least one CTA per SM of an H100 (132)."""
    plan = KM.split_plan(m, n, k)
    ranges = [plan.k_range(s) for s in range(plan.splits)]
    assert ranges[0][0] == 0 and ranges[-1][1] == k
    for (lo, hi), (lo2, _) in zip(ranges, ranges[1:]):
        assert lo < hi == lo2 and lo % KM.SPLIT_UNIT == 0
    covered = np.zeros(k, np.int32)
    for lo, hi in ranges:
        covered[lo:hi] += 1
    assert (covered == 1).all()
    if (m, k, n) in PATH_GEMMS:
        assert plan.ctas >= KM.MIN_CTAS


@pytest.mark.parametrize("m,k,n", PATH_GEMMS + UNEVEN_GEMMS,
                         ids=[f"{m}x{k}x{n}" for m, k, n in
                              PATH_GEMMS + UNEVEN_GEMMS])
def test_split_partials_sum_bitwise(m, k, n):
    """int32 partial products over the plan's K ranges, added in a
    shuffled order (as the last CTA of a tile finds them), equal the
    exact product bitwise, with all-127 rows and columns at the K x 127^2
    headroom. Columns are independent of the split, so the wide shapes
    are checked on their first 160 columns."""
    plan = KM.split_plan(m, n, k)
    rng = np.random.default_rng(m + k + n)
    nc = min(n, 160)
    x = torch.from_numpy(rng.integers(-127, 128, (m, k)).astype(np.int8))
    w = torch.from_numpy(rng.integers(-127, 128, (k, nc)).astype(np.int8))
    x[0] = 127
    w[:, 0] = 127
    w[:, 1] = -127
    want = KM.int8_matmul_plain(x, w)
    assert want[0, 0].item() == k * 127 * 127
    parts = [(x[:, lo:hi].long() @ w[lo:hi].long()).to(torch.int32)
             for lo, hi in (plan.k_range(s) for s in range(plan.splits))]
    got = torch.zeros((m, nc), dtype=torch.int32)
    for s in rng.permutation(plan.splits):
        got += parts[s]
    assert got.dtype == torch.int32 and torch.equal(got, want)


def test_inv_127_scalar_equals_tensor_form():
    """``quantize_act`` multiplies by ``INV_127``, a Python float, where it
    used to copy a float32 tensor to the device on every call: the value is
    ``float32(1/127)``, the jitted reference's constant, and products with
    it equal those with the float32 tensor bit for bit."""
    assert TQ.INV_127 == float(np.float32(1) / np.float32(127))
    rng = np.random.default_rng(0)
    amax = (rng.random(100_000) * 10.0 ** rng.uniform(-6, 6, 100_000))
    t = torch.from_numpy(amax.astype(np.float32))
    assert torch.equal(t * TQ.INV_127,
                       t * torch.tensor(1.0 / 127.0, dtype=torch.float32))
