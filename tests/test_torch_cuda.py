"""Card-only tests of the port: each CUDA kernel against its plain version
at the full width of qwen2_0_5b, and the engine on the card against the
same engine on the CPU, in bf16 and at w8a8. Every test here carries the ``cuda`` marker and
skips without a CUDA device.

This file imports no JAX (the machine with the card need not have it).
Run it there without the repository's conftest, whose autouse fixtures
reach into the JAX package::

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Tolerances, and why:
* paged attention on exact-logit inputs (q, k small integers, so every q.k
  partial sum is exact in fp32): identical codes, only the P.V sum order
  differs: 1e-5.
* static-params quantize+norm: codes and int32 sums are exact and the
  epilogue rounds like the plain ops: bitwise equal to the plain version
  on the float32 view of the rows (float32 or bf16), a bf16 output to the
  plain output's ``.to(bfloat16)``.
* int8 GEMM: integer sums are exact in any order, split over K or not:
  bitwise equal, on two calls in a row (the split's self-resetting
  tickets leave nothing behind).
* paged attention on logits placed on the int8 snap's rounding ties:
  kernel and plain version both multiply by float32(1/s): equal codes,
  1e-6.
* paged attention over int8 pools on exact-logit inputs: as for bf16
  pools, 1e-5.
* w8a8 engine in exact mode, card vs CPU: every projection is an exact
  int32 sum, so the float ops that still round in other orders (RoPE,
  norms, softmax) only move an activation code at a rounding tie: greedy
  tokens equal.
* engine, card vs CPU: cuBLAS and the CPU sum in other orders, and in SOLE
  mode a logit that moves across a rounding boundary flips a code: at
  least 95% of greedy tokens equal. The same holds for the dense-slot
  engine; at w8a8 in exact mode its tokens are equal.
* E2Softmax: codes and the power-of-two sum are exact, so with C <= 512
  columns (exp_bits 4) the output equals the plain version bit for bit.
  Above that the kernel and torch sum in other orders and may round S
  differently; that can only move a row's ALDivision bucket, so a row
  either equals the plain row or differs from it by one constant ratio,
  and at most 0.1% of rows may differ.
* dense Flash-E2Softmax on exact-logit inputs (q, k on small grids and
  head dim 16 or 64, whose d^-1/2 is a power of two, so every q.k partial
  sum is exact in fp32): identical codes and sums, only the w.v sum order
  (and in exact mode exp2's last bit and the bf16 kernel's split of P
  into a bf16 head and tail, ~2^-17 relative) differ: 1e-5 of the output
  scale. bf16 inputs run the tensor-core kernel, float32 the CUDA-core
  one.
  Otherwise the dot order may move a logit across a rounding boundary
  and flip one code: at most 1% of rows off by more than 1e-3.
* fused add+norm: ``h`` is one float32 add, bitwise; the norm as the
  quantize+norm kernel, bitwise. Quantize-out: codes and scale bitwise
  equal to ``quantize_act`` of the add+norm kernel's output on the same
  inputs. A static-params op call is one device kernel under the
  profiler.
* codes entry: integer sums exact, epilogue as the quantize+norm: 1e-6.
* paged attention at the speculative verify shapes (B lanes x C = K + 1
  causal rows, ragged n_valid, null lanes): at head dim 64 as above
  (1e-5); at head dim 128 (the tensor cores with q scaled in float32 and
  split into three bf16 parts: 2^-3.5 is no exact bf16 factor, so the
  exact-logit grid is not exact there) exact mode to 1e-4 of the output
  scale, SOLE at most 1% of rows off by more than 1e-3. The C > 1 route
  against the C = 1 route on the same rows: the same codes, other sum
  orders: 1e-5.
* the paged kernel's tensor-core route at head dims 128 (32 or 48 heads
  on 8 KV heads) and 256 (16 heads on 1): at 256 as at 64 (1e-5 on
  exact-logit inputs), at 128 as at the verify shapes above; the decode
  kernel's rows bitwise equal whatever the batch (the split of a
  sequence's pages over a cluster's CTAs, chosen per launch, changes no
  bit).
* the row-stable products of decode and verify dispatches
  (``layers.stable_mm``, the MoE FFN with ``stable=True``) at mixtral's
  shapes: each row bitwise equal whatever the row count and its place.
* verify rows as the model attends them (``rows_as_decode``: the decode
  kernel, one single-row query per row) against the decode step at each
  row's position: bitwise, at head dim 64 and 128, bf16 and int8 pages,
  SOLE and exact.
* exact-mode norms: the kernel's rows bitwise equal whatever the row
  count, at every team size and on both sides of each step, from
  misaligned storage as from aligned; against the plain torch ops
  (another reduction order, torch's approximate rsqrt on the card) 1e-5
  of the output scale. The backward's dx bitwise whatever the row count
  and chunking, and its dgamma for one row with gamma 1 and dy 1 bitwise
  the forward's output (the two share mu and inv).
* the recurrent families: the calibrating norm with a (G, C) affine
  (rwkv6's per-head GroupNorm) bitwise against its plain version, the
  exact norm's heads bitwise alone; ``layers.fma`` bitwise ``fma32``; the
  paged kernel at 16 query heads on one KV head of dimension 256 (d^-1/2
  exact; bf16 pools on the tensor cores, float32 on the CUDA cores) on
  exact-logit inputs 1e-5; the smoke ssm and hybrid engines,
  card vs CPU: exact mode tokens equal, SOLE at least 95%.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import ops
from repro_torch.configs.base import get_config
from repro_torch.core.sole.quant import calibrate_ptf, quantize_act
from repro_torch.kernels import ailayernorm as KN
from repro_torch.configs.base import QuantConfig
from repro_torch.kernels import build
from repro_torch.kernels import e2softmax as KE
from repro_torch.kernels import flash_e2softmax as KA
from repro_torch.kernels import int8_matmul as KM
from repro_torch.models import api
from repro_torch.models.layers import KV_INT8_SCALE, LOGIT_INT8_SCALE
from repro_torch.serve.engine import Engine, PagedEngine, Request

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _paged_inputs(rng, *, b, c, h, kvh, d, bs, nb, q_start, kv_len):
    """Kernel-layout inputs on exact-logit grids: q (B, H, C, d), pools
    (N, bs, KV, d) with large garbage in the null page 0, tables on
    shuffled pages (kv_len 1 with q_start 0 = a null lane)."""
    n = b * nb + 1
    q = rng.integers(-8, 9, (b, h, c, d)) / 4.0
    k = rng.integers(-8, 9, (n, bs, kvh, d)).astype(np.float64)
    v = rng.standard_normal((n, bs, kvh, d))
    k[0] *= 50
    v[0] *= 50
    perm = rng.permutation(np.arange(1, n))
    tables = np.zeros((b, nb), np.int32)
    for i in range(b):
        if kv_len[i] > 1 or q_start[i] > 0:
            used = -(-kv_len[i] // bs)
            tables[i, :used] = perm[i * nb:i * nb + used]
    meta = np.stack([q_start, kv_len], 1).astype(np.int32)
    return q, k, v, tables, meta


@pytest.mark.parametrize("mode", ["exact", "sole"])
@pytest.mark.parametrize("name", ["prefill", "decode"])
def test_paged_kernel_matches_plain_full_width(cuda_device, mode, name):
    """14 q heads, 2 KV heads (groups of 7), head_dim 64, bf16 pools,
    16-token pages; a causal 128-row chunk at q_start 128, or a decode
    batch of 8 with two null lanes and kv_len not a multiple of 16."""
    cfg = get_config("qwen2_0_5b")
    spec = (dict(b=1, c=128, nb=32, q_start=[128], kv_len=[256])
            if name == "prefill" else
            dict(b=8, c=1, nb=32, q_start=[0] * 8,
                 kv_len=[49, 300, 117, 1, 256, 83, 160, 1]))
    rng = np.random.default_rng(7)
    arrays = _paged_inputs(rng, h=cfg.n_heads, kvh=cfg.n_kv_heads,
                           d=cfg.head_dim, bs=16, **spec)
    bf = torch.bfloat16
    q, k, v = (torch.from_numpy(a).to(cuda_device, bf) for a in arrays[:3])
    tables, meta = (torch.from_numpy(a).to(cuda_device) for a in arrays[3:])
    kw = dict(causal=name == "prefill", sole=mode == "sole", exp_bits=4,
              int8_scale=LOGIT_INT8_SCALE if mode == "sole" else None)
    before = KA.flash_e2softmax_paged.launches
    out = KA.flash_e2softmax_paged(q, k, v, tables, meta, **kw)
    assert KA.flash_e2softmax_paged.launches == before + 1
    kvmap = KA.default_kv_head_map(cfg.n_heads, cfg.n_kv_heads, cuda_device)
    ref = KA.flash_e2softmax_paged_plain(q, k, v, tables, meta, kvmap, **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)


def _snap_tie_logits(scale):
    """Float32 dm in [-127 s, 0] where round(dm / s) and round(dm *
    float32(1 / s)) differ (see tests/test_torch_snap.py)."""
    f = np.float32
    s, ties = f(scale), []
    for n in range(-127, 0):
        bits = np.array([(n + 0.5) * float(s)], np.float32).view(np.int32)
        for dm in (bits + np.arange(-256, 257, dtype=np.int32)).view(f):
            if (-127 * float(s) <= dm <= 0
                    and np.round(dm / s) != np.round(dm * (f(1) / s))):
                ties.append(dm)
    return np.array(ties, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_kernel_snap_ties_equal_plain(cuda_device, dtype):
    """Logits on the int8 snap's rounding ties (q = 8 dm against one-hot
    keys at head dim 64, a zero key for the row max 0): the kernel snaps
    like its plain version (a multiply by float32(1/s)), so both give the
    same codes. bf16 q holds each tie only where dm fits 8 bits; the rest
    still land exactly on bf16 values both sides read alike."""
    ties = _snap_tie_logits(LOGIT_INT8_SCALE)
    d, bs = 64, 16
    q = np.zeros((1, 2, 1, d), np.float32)
    q[0, 0, 0, 1:1 + len(ties)] = 8 * ties
    q[0, 1, 0, 1:1 + len(ties)] = 8 * ties[::-1]
    eye = np.eye(d, dtype=np.float32)
    eye[0, 0] = 0.0
    pool = np.zeros((d // bs + 1, bs, 1, d), np.float32)
    pool[1:] = eye.reshape(d // bs, bs, 1, d)
    tables = np.arange(1, d // bs + 1, dtype=np.int32)[None]
    meta = np.array([[0, d]], np.int32)
    dt = getattr(torch, dtype)
    qt, kt = (torch.from_numpy(a).to(cuda_device, dt) for a in (q, pool))
    tables, meta = (torch.from_numpy(a).to(cuda_device) for a in (tables, meta))
    kw = dict(causal=False, sole=True, exp_bits=4, int8_scale=LOGIT_INT8_SCALE)
    out = KA.flash_e2softmax_paged(qt, kt, kt, tables, meta, **kw)
    kvmap = KA.default_kv_head_map(2, 1, cuda_device)
    ref = KA.flash_e2softmax_paged_plain(qt, kt, kt, tables, meta, kvmap, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("c,rms", [(896, True), (2048, False)])
@pytest.mark.parametrize("rows", [8, 128])
def test_qnorm_kernel_matches_plain_full_width(cuda_device, c, rms, rows):
    rng = np.random.default_rng(c + rows)
    x = rng.standard_normal((rows, c)).astype(np.float32) * 2
    x *= 2.0 ** rng.integers(0, 4, size=c)             # every PTF alpha
    gamma = (1 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    beta = (0.1 * rng.standard_normal(c)).astype(np.float32)
    xt = torch.from_numpy(x).to(cuda_device, torch.bfloat16)
    p = calibrate_ptf(xt, unsigned=not rms)
    assert p.scale.dtype == torch.bfloat16
    args = (xt.float().contiguous(), p.scale, p.alpha,
            torch.from_numpy(gamma).to(cuda_device),
            None if rms else torch.from_numpy(beta).to(cuda_device))
    before = KN.qnorm.launches
    out = KN.qnorm(*args, rms=rms)
    assert KN.qnorm.launches == before + 1
    ref = KN.qnorm_plain(*args, rms=rms)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)


def test_calibration_on_card_equals_cpu(cuda_device):
    """``calibrate_ptf`` gives the same scale and alpha bits on the card
    as on the CPU, in f32 and in bf16."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((64, 896)).astype(np.float32)
    x *= 2.0 ** rng.integers(0, 4, size=896)
    for dt in (torch.float32, torch.bfloat16):
        xc = torch.from_numpy(x).to(dt)
        pc = calibrate_ptf(xc, unsigned=False)
        pg = calibrate_ptf(xc.to(cuda_device), unsigned=False)
        assert torch.equal(pg.scale.cpu(), pc.scale)
        assert torch.equal(pg.alpha.cpu(), pc.alpha)
        assert torch.equal(pg.quantize(xc.to(cuda_device)).cpu(),
                           pc.quantize(xc))


@pytest.mark.parametrize("mode", ["exact", "sole"])
def test_engine_on_card_matches_cpu(cuda_device, mode):
    """The smoke engine through the kernels (card) and through the plain
    versions (CPU): the paged attention and (SOLE) the calibrating norm
    kernels launch and the static-params quantize+norm does not, refcounts
    hold, and at least 95% of greedy tokens agree."""
    cfg = get_config("qwen2_0_5b").smoke()
    if mode == "exact":
        cfg = dataclasses.replace(cfg, softmax_mode="exact",
                                  norm_mode="exact", logit_int8=False)
    params = api.init_params(0, cfg, "cpu")
    rng = np.random.default_rng(1)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab_size, n)
                    .astype(np.int32), max_new_tokens=8)
            for n in (5, 20, 12, 30, 9)]
    outs = []
    for dev in ("cpu", cuda_device):
        eng = PagedEngine(cfg, params, num_blocks=32, block_size=8,
                          max_seq_len=64, decode_batch=4, prefill_chunk=8,
                          device=dev)
        attn0 = KA.flash_e2softmax_paged.launches
        norm0, qnorm0 = KN.calibrated_norm.launches, KN.qnorm.launches
        outs.append(eng.generate(reqs))
        eng.cache.check_refcounts()
        if dev == cuda_device:
            assert KA.flash_e2softmax_paged.launches > attn0
            assert (KN.calibrated_norm.launches > norm0) == (mode == "sole")
            assert KN.qnorm.launches == qnorm0
    pairs = [(a, b) for x, y in zip(*outs) for a, b in zip(x, y)]
    assert all(len(o) == 8 for o in outs[1])
    assert sum(a == b for a, b in pairs) / len(pairs) >= 0.95


# (M, K, N) of every int8 GEMM on the w8a8 path of qwen2_0_5b (M = 8 at a
# decode step, 128 at a prefill chunk), two ragged shapes, and shapes whose
# K splits are uneven: M = 1 at down's K, K not a multiple of 64 x splits
# (K % 16 == 0 and not), N % 4 != 0 (no vectorized loads).
GEMM_KN = ((896, 896), (896, 128), (896, 4864), (4864, 896), (896, 151936))
GEMM_SHAPES = [(m, k, n) for m in (8, 128) for k, n in GEMM_KN] + [
    (7, 130, 33), (64, 256, 128), (1, 4864, 896), (8, 1008, 896),
    (8, 1000, 896), (8, 896, 130)]


@pytest.mark.parametrize("m,k,n", GEMM_SHAPES,
                         ids=[f"{m}x{k}x{n}" for m, k, n in GEMM_SHAPES])
def test_int8_gemm_bitwise_equals_plain(cuda_device, m, k, n):
    gen = torch.Generator(device=cuda_device).manual_seed(m + k + n)
    x = torch.randint(-127, 128, (m, k), generator=gen, device=cuda_device,
                      dtype=torch.int8)
    w = torch.randint(-127, 128, (k, n), generator=gen, device=cuda_device,
                      dtype=torch.int8)
    x[0] = 127                                 # the largest sums
    w[:, 0] = 127
    before = KM.int8_matmul.launches
    out = KM.int8_matmul(x, w)
    again = KM.int8_matmul(x, w)
    assert KM.int8_matmul.launches == before + 2
    ref = KM.int8_matmul_plain(x, w)
    torch.cuda.synchronize()
    assert out.dtype == torch.int32 and torch.equal(out, ref)
    assert torch.equal(again, ref)
    if (m, k, n) in GEMM_SHAPES[:10]:
        assert KM.split_plan(m, n, k).ctas >= KM.MIN_CTAS


@pytest.mark.parametrize("quant_pv", [False, True], ids=["pv-f32", "pv-int8"])
@pytest.mark.parametrize("mode", ["exact", "sole"])
@pytest.mark.parametrize("name", ["prefill", "decode"])
def test_paged_kernel_int8_pools_match_plain(cuda_device, mode, name,
                                             quant_pv):
    """qwen2_0_5b widths over int8 pools: K codes on the exact-logit grid,
    V codes over the full int8 range, bf16 queries."""
    cfg = get_config("qwen2_0_5b")
    spec = (dict(b=1, c=128, nb=32, q_start=[128], kv_len=[256])
            if name == "prefill" else
            dict(b=8, c=1, nb=32, q_start=[0] * 8,
                 kv_len=[49, 300, 117, 1, 256, 83, 160, 1]))
    rng = np.random.default_rng(11)
    q, k, v, tables, meta = _paged_inputs(
        rng, h=cfg.n_heads, kvh=cfg.n_kv_heads, d=cfg.head_dim, bs=16,
        **spec)
    v = rng.integers(-127, 128, v.shape)
    qt = torch.from_numpy(q).to(cuda_device, torch.bfloat16)
    kt, vt = (torch.from_numpy(np.clip(a, -127, 127)).to(cuda_device,
                                                          torch.int8)
              for a in (k, v))
    tables, meta = (torch.from_numpy(a).to(cuda_device)
                    for a in (tables, meta))
    kw = dict(causal=name == "prefill", sole=mode == "sole", exp_bits=4,
              int8_scale=LOGIT_INT8_SCALE if mode == "sole" else None,
              kv_scale=KV_INT8_SCALE, quant_pv=quant_pv)
    before = KA.flash_e2softmax_paged.launches
    out = KA.flash_e2softmax_paged(qt, kt, vt, tables, meta, **kw)
    assert KA.flash_e2softmax_paged.launches == before + 1
    kvmap = KA.default_kv_head_map(cfg.n_heads, cfg.n_kv_heads, cuda_device)
    ref = KA.flash_e2softmax_paged_plain(qt, kt, vt, tables, meta, kvmap,
                                         **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kv", ["auto", "int8"])
def test_w8a8_engine_on_card_matches_cpu(cuda_device, kv):
    """The w8a8 smoke engine in exact mode through the kernels (card) and
    the plain versions (CPU): the GEMM and paged kernels launch, refcounts
    hold, and the greedy tokens are equal."""
    cfg = dataclasses.replace(
        get_config("qwen2_0_5b").smoke(), softmax_mode="exact",
        norm_mode="exact", logit_int8=False, quant=QuantConfig("w8a8"),
        kv_cache_dtype=kv)
    params = api.init_params(0, cfg, "cpu")
    rng = np.random.default_rng(1)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab_size, n)
                    .astype(np.int32), max_new_tokens=8)
            for n in (5, 20, 12, 30, 9)]
    outs = []
    for dev in ("cpu", cuda_device):
        eng = PagedEngine(cfg, params, num_blocks=32, block_size=8,
                          max_seq_len=64, decode_batch=4, prefill_chunk=8,
                          device=dev)
        mm0, attn0 = KM.int8_matmul.launches, KA.flash_e2softmax_paged.launches
        outs.append(eng.generate(reqs))
        eng.cache.check_refcounts()
        if dev == cuda_device:
            assert KM.int8_matmul.launches > mm0
            assert KA.flash_e2softmax_paged.launches > attn0
    assert all(len(o) == 8 for o in outs[1])
    assert outs[1] == outs[0]


# (rows, C, masked) of the E2Softmax calls of qwen2_0_5b's dense-slot path
# (decode: B*H rows of T+1 columns; prefill: B*H*S rows of S columns) and
# the JAX kernel benchmark's unmasked shapes.
E2_SHAPES = {"decode": (8 * 14, 385, True), "prefill": (8 * 14 * 300, 300, True),
             "bench_785": (8, 785, False), "bench_8192": (2, 8192, False)}


def _e2_inputs(gen, rows, c, masked, dtype, device):
    x = (torch.randn((rows, c), generator=gen, device=device) * 4).to(dtype)
    mask = None
    if masked:
        n = torch.randint(1, c + 1, (rows, 1), generator=gen, device=device)
        mask = torch.arange(c, device=device)[None] < n
        mask[:, -1] = True                     # the current token (decode)
        mask[:3] = False                       # fully masked rows
    return x, mask


def _assert_e2_matches(out, ref, c):
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
    if c <= 512:
        assert torch.equal(out, ref)
        return
    same = (out == ref).all(-1)
    assert same.float().mean().item() >= 0.999
    for i in torch.nonzero(~same).flatten().tolist():
        nz = ref[i] != 0
        ratio = out[i][nz] / ref[i][nz]
        assert torch.equal(ratio, ratio[:1].expand_as(ratio))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("snap", [False, True], ids=["raw", "int8_scale"])
@pytest.mark.parametrize("name", list(E2_SHAPES))
def test_e2softmax_kernel_matches_plain(cuda_device, name, snap, dtype):
    rows, c, masked = E2_SHAPES[name]
    gen = torch.Generator(device=cuda_device).manual_seed(rows + c)
    x, mask = _e2_inputs(gen, rows, c, masked, getattr(torch, dtype),
                         cuda_device)
    kw = dict(exp_bits=4, int8_scale=LOGIT_INT8_SCALE if snap else None,
              mask=mask)
    before = KE.e2softmax.launches
    out = KE.e2softmax(x, **kw)
    assert KE.e2softmax.launches == before + 1
    ref = KE.e2softmax_plain(x, **kw)
    torch.cuda.synchronize()
    _assert_e2_matches(out, ref, c)
    if masked:
        assert (out[~mask] == 0).all() and (out[:3] == 0).all()


def test_snap_logits_on_card_equals_cpu(cuda_device):
    """The path's int8 snap (a multiply by the float32 reciprocal) gives
    the same bits on the card as on the CPU, ties included."""
    from repro_torch import ops
    gen = torch.Generator().manual_seed(0)
    d = -(torch.randn(1_000_000, generator=gen) * 5).abs()
    ties = torch.tensor([3219111808, 3228491195, 3238778800],
                        dtype=torch.int64).to(torch.int32).view(torch.float32)
    d = torch.cat([ties, d])
    got = ops.snap_logits(d.to(cuda_device), LOGIT_INT8_SCALE).cpu()
    assert torch.equal(got, ops.snap_logits(d, LOGIT_INT8_SCALE))


def test_e2softmax_kernel_long_rows_and_exp_bits_6(cuda_device):
    """Rows too long for shared memory (the kernel re-reads them) and the
    6-bit codes."""
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    for c, exp_bits in ((50_000, 4), (300, 6), (1000, 6)):
        x, mask = _e2_inputs(gen, 4, c, True, torch.float32, cuda_device)
        out = KE.e2softmax(x, exp_bits=exp_bits, mask=mask)
        ref = KE.e2softmax_plain(x, exp_bits=exp_bits, mask=mask)
        torch.cuda.synchronize()
        _assert_e2_matches(out, ref, c if exp_bits == 4 else 513)


def _dense_path_masks(device, b=8, h=14, kvh=2, s=300, t=384):
    """The dense path's masks as it hands them to the op, at qwen2_0_5b's
    widths, each with logits of its shape: prefill's shared causal (s, s)
    mask and its per-lane left-padded (b, 1, s, s) mask, both broadcast
    over heads (stride 0, never copied), and decode's concatenated
    (b, kvh, g, t + 1) mask."""
    pos = torch.arange(s, device=device)
    shared = pos[None, :] <= pos[:, None]
    n_pad = torch.tensor([252, 0, 180, 100, 196, 136, 220, 50], device=device)
    local = pos[None] - n_pad[:, None]
    kpos = torch.where(local < 0, 2 ** 30, local)
    qpos = torch.clamp_min(local, 0)
    lanes = (kpos[:, None, :] < 2 ** 29) & (qpos[:, :, None] >= kpos[:, None])
    lens = torch.tensor([49, 300, 117, 1, 256, 83, 160, 1], device=device)
    cols = torch.arange(t, device=device)
    valid = (cols[None] < lens[:, None]) & (cols[None] != 7)
    g = h // kvh
    dec = torch.cat([torch.broadcast_to(valid[:, None, None, :], (b, kvh, g, t)),
                     torch.ones((b, kvh, g, 1), dtype=torch.bool, device=device)],
                    -1)
    return {"prefill_shared": torch.broadcast_to(shared, (b, h, s, s)),
            "prefill_lanes": torch.broadcast_to(lanes[:, None], (b, h, s, s)),
            "decode_cat": dec}


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("form", ["prefill_shared", "prefill_lanes",
                                  "decode_cat"])
def test_e2softmax_strided_masks_bitwise(cuda_device, form, out_dtype):
    """The warp-per-row body reads the dense path's masks in place (stride
    0 over heads, or the decode concatenation) and writes float32 or bf16:
    bitwise equal to the plain version on the materialized mask, with the
    path's int8 snap."""
    mask = _dense_path_masks(cuda_device)[form]
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    x = torch.randn(mask.shape, generator=gen, device=cuda_device) * 4
    dt = getattr(torch, out_dtype)
    kw = dict(exp_bits=4, int8_scale=LOGIT_INT8_SCALE, out_dtype=dt)
    if form.startswith("prefill"):
        assert mask.stride(1) == 0
    before = KE.e2softmax.launches
    out = KE.e2softmax(x, mask=mask, **kw)
    assert KE.e2softmax.launches == before + 1
    ref = KE.e2softmax_plain(x, mask=mask.contiguous(), **kw)
    torch.cuda.synchronize()
    assert out.dtype == dt and out.is_contiguous()
    assert torch.equal(out, ref)
    assert (out[~mask] == 0).all()


@pytest.mark.parametrize("name", ["decode_385", "prefill_300"])
def test_e2softmax_unaligned_and_bf16_out(cuda_device, name):
    """C = 385 (no 16-byte vectors) and C = 300 from a base pointer one
    element off 16 bytes (scalar loads), float32 and bf16 logits and
    outputs: bitwise."""
    rows, c = {"decode_385": (8 * 14, 385), "prefill_300": (8 * 14 * 300, 300)}[name]
    gen = torch.Generator(device=cuda_device).manual_seed(c)
    for dtype in (torch.float32, torch.bfloat16):
        buf = (torch.randn(rows * c + 1, generator=gen, device=cuda_device)
               * 4).to(dtype)
        x = buf[1:].view(rows, c)
        assert x.data_ptr() % 16 != 0
        n = torch.randint(1, c + 1, (rows, 1), generator=gen, device=cuda_device)
        mbuf = torch.zeros(rows * c + 1, dtype=torch.bool, device=cuda_device)
        mask = mbuf[1:].view(rows, c)
        mask.copy_(torch.arange(c, device=cuda_device)[None] < n)
        mask[:3] = False
        for out_dtype in (torch.float32, torch.bfloat16):
            kw = dict(exp_bits=4, int8_scale=LOGIT_INT8_SCALE, mask=mask,
                      out_dtype=out_dtype)
            out = KE.e2softmax(x, **kw)
            ref = KE.e2softmax_plain(x, **kw)
            torch.cuda.synchronize()
            assert torch.equal(out, ref) and (out[:3] == 0).all()


def test_e2softmax_long_row_block_body(cuda_device):
    """C = 4096 takes the block-per-row body (rows staged in shared
    memory), with a broadcast mask and bf16 out; C = 1024 is the warp
    body's widest row."""
    gen = torch.Generator(device=cuda_device).manual_seed(4096)
    for c in (4096, 1024):
        x = torch.randn((3, 5, c), generator=gen, device=cuda_device) * 4
        row = torch.arange(c, device=cuda_device) % 7 != 3
        mask = torch.broadcast_to(row, x.shape)
        for out_dtype in (torch.float32, torch.bfloat16):
            kw = dict(exp_bits=4, mask=mask, out_dtype=out_dtype)
            out = KE.e2softmax(x, **kw)
            ref = KE.e2softmax_plain(x, **kw)
            torch.cuda.synchronize()
            _assert_e2_matches(out.float().reshape(-1, c),
                               ref.float().reshape(-1, c), c)


def test_e2softmax_mask_without_unit_column_stride_raises(cuda_device):
    """A mask the kernel's view cannot express (here broadcast along the
    columns) raises; it is not copied."""
    x = torch.randn((4, 64), device=cuda_device)
    col = torch.ones((4, 1), dtype=torch.bool, device=cuda_device)
    before = KE.e2softmax.launches
    with pytest.raises(ValueError, match="unit column stride"):
        KE.e2softmax(x, mask=col)
    assert KE.e2softmax.launches == before


@pytest.mark.parametrize("phase", ["prefill", "decode"])
def test_sole_probs_one_launch_equals_chain(cuda_device, phase):
    """The dense path's SOLE probabilities are one ``e2softmax`` launch per
    call, bitwise equal to the chain it replaced (masked max, subtract,
    ``snap_logits``, E2Softmax, cast to bf16) on the card."""
    from repro_torch.models import layers as L
    cfg = get_config("qwen2_0_5b")
    mask = _dense_path_masks(cuda_device)[
        "prefill_lanes" if phase == "prefill" else "decode_cat"]
    gen = torch.Generator(device=cuda_device).manual_seed(11)
    logits = torch.randn(mask.shape, generator=gen, device=cuda_device) * 4
    before = KE.e2softmax.launches
    probs = L._sole_probs(logits, mask, cfg, torch.bfloat16)
    assert KE.e2softmax.launches == before + 1
    m = torch.where(mask, logits, -torch.inf).amax(-1, keepdim=True)
    d = ops.snap_logits(logits - torch.clamp_min(m, -1e30), LOGIT_INT8_SCALE)
    want = KE.e2softmax_plain(d, mask=mask).to(torch.bfloat16)
    torch.cuda.synchronize()
    assert probs.dtype == torch.bfloat16 and torch.equal(probs, want)


@pytest.mark.parametrize("rms", [True, False], ids=["rms", "ln"])
@pytest.mark.parametrize("c", [896, 898, 900, 2048])
@pytest.mark.parametrize("rows", [1, 8, 127, 2048, 3001])
def test_add_norm_quant_team_kernel_bitwise(cuda_device, rows, c, rms):
    """The quantize-out entry's team-per-row body: ``h`` bitwise equal to
    the plain ``x + r``, codes and scale bitwise equal to ``quantize_act``
    of the add+norm kernel's output (``norm_row``) on the same inputs, at
    decode to past-prefill rows (3001 rows walk the row loop), C = 898
    with scalar accesses, and RMS and LN."""
    rng = np.random.default_rng(rows * 7 + c)
    x, r, calib, gamma, beta = _norm_case(rng, rows, c, cuda_device)
    p = calibrate_ptf(calib, unsigned=not rms)
    args = (x, r, p.scale, p.alpha, gamma, None if rms else beta)
    q0 = KN.add_norm_quant.launches
    h8, codes, scale = KN.add_norm_quant(*args, rms=rms)
    assert KN.add_norm_quant.launches == q0 + 1
    h, out = KN.add_norm(*args, rms=rms)
    h_ref = KN.add_norm_plain(*args, rms=rms)[0]
    torch.cuda.synchronize()
    want_codes, want_scale = quantize_act(out)
    assert torch.equal(h8, h_ref) and torch.equal(h, h_ref)
    assert codes.dtype == torch.int8 and scale.shape == (rows, 1)
    assert torch.equal(codes, want_codes) and torch.equal(scale, want_scale)


@pytest.mark.parametrize("c", [1030, 5000])
def test_add_norm_quant_wide_rows_take_norm_row(cuda_device, c):
    """Rows wider than a team's registers (1030 scalar channels, 5000 in
    vectors) take the one-block-per-row body, with the same results."""
    rng = np.random.default_rng(c)
    x, r, calib, gamma, beta = _norm_case(rng, 64, c, cuda_device)
    p = calibrate_ptf(calib, unsigned=True)
    args = (x, r, p.scale, p.alpha, gamma, beta)
    h8, codes, scale = KN.add_norm_quant(*args, rms=False)
    h, out = KN.add_norm(*args, rms=False)
    torch.cuda.synchronize()
    want_codes, want_scale = quantize_act(out)
    assert torch.equal(h8, h)
    assert torch.equal(codes, want_codes) and torch.equal(scale, want_scale)


# -- the static-params norms on the team-per-row body -------------------------

STATIC_TYPES = [("float32", "float32"), ("float32", "bfloat16"),
                ("bfloat16", "float32"), ("bfloat16", "bfloat16")]


def _static_case(rng, rows, c, rms, x_dtype, device):
    """Rows in ``x_dtype`` and static params calibrated on a held-out
    batch of that dtype (a bf16 scale for bf16 rows): (x, r, channel
    arguments as the wrappers take them)."""
    x, r, calib, gamma, beta = _norm_case(rng, rows, c, device)
    dt = getattr(torch, x_dtype)
    p = calibrate_ptf(calib.to(dt), unsigned=not rms)
    return x.to(dt), r.to(dt), (p.scale, p.alpha, gamma,
                                None if rms else beta)


def _check_static_entries(x, r, chan, rms, od, count=True):
    """qnorm, add_norm and add_norm_quant on ``x``/``r`` bitwise equal to
    their plain versions on the float32 view of the same rows, the
    outputs then cast to ``od``; ``count``: one launch each (a caller
    alone in the process)."""
    counters = (KN.qnorm, KN.add_norm, KN.add_norm_quant)
    before = [f.launches for f in counters]
    out = KN.qnorm(x, *chan, rms=rms, out_dtype=od)
    h, out2 = KN.add_norm(x, r, *chan, rms=rms, out_dtype=od)
    h8, codes, scale = KN.add_norm_quant(x, r, *chan, rms=rms)
    if count:
        assert [f.launches - b for f, b in zip(counters, before)] == [1, 1, 1]
    want = KN.qnorm_plain(x.float(), *chan, rms=rms).to(od)
    h_ref, want2 = KN.add_norm_plain(x.float(), r.float(), *chan, rms=rms)
    _, want_codes, want_scale = KN.add_norm_quant_plain(
        x.float(), r.float(), *chan, rms=rms)
    torch.cuda.synchronize()
    assert out.dtype == od and torch.equal(out, want)
    assert h.dtype == torch.float32 and torch.equal(h, h_ref)
    assert torch.equal(h8, h_ref)
    assert out2.dtype == od and torch.equal(out2, want2.to(od))
    assert torch.equal(codes, want_codes) and torch.equal(scale, want_scale)


@pytest.mark.parametrize("x_dtype,out_dtype", STATIC_TYPES,
                         ids=[f"{a}-{b}" for a, b in STATIC_TYPES])
@pytest.mark.parametrize("rms", [True, False], ids=["rms", "ln"])
@pytest.mark.parametrize("c", [896, 898, 900, 2048])
@pytest.mark.parametrize("rows", [1, 8, 127, 2048, 3001])
def test_static_norm_team_kernels_bitwise(cuda_device, rows, c, rms, x_dtype,
                                          out_dtype):
    """``qnorm`` and ``add_norm`` (and ``add_norm_quant``) on the
    team-per-row body, float32 or bf16 rows read as they are, float32 or
    bf16 out written by the kernel: every output bitwise equal to the
    plain version on the float32 view of the same rows, at decode to
    past-prefill rows (3001 rows walk the persistent row loop), C = 898
    (scalar accesses) and 900, RMS and LN."""
    rng = np.random.default_rng(rows * 13 + c)
    x, r, chan = _static_case(rng, rows, c, rms, x_dtype, cuda_device)
    _check_static_entries(x, r, chan, rms, getattr(torch, out_dtype))


@pytest.mark.parametrize("x_dtype,out_dtype", STATIC_TYPES,
                         ids=[f"{a}-{b}" for a, b in STATIC_TYPES])
@pytest.mark.parametrize("c", [4099, 5000])
def test_static_norm_wide_rows_take_norm_row(cuda_device, c, x_dtype,
                                             out_dtype):
    """Rows wider than a team's registers (4099 scalar channels, 5000 in
    units of 4) take the one-block-per-row body, with the same results."""
    rng = np.random.default_rng(c + len(x_dtype + out_dtype))
    x, r, chan = _static_case(rng, 64, c, False, x_dtype, cuda_device)
    _check_static_entries(x, r, chan, False, getattr(torch, out_dtype))


def test_static_norm_on_every_card_in_one_process(cuda_device):
    """The static-params launcher's occupancy cache is per device, row
    width and entry, behind a lock: calls alternating between cuda:0 and,
    where present, cuda:1 at two widths, then two threads at once on each
    card, stay bitwise equal to the plain version."""
    import concurrent.futures
    cards = [torch.device("cuda", i)
             for i in range(min(2, torch.cuda.device_count()))]

    def run(dev, c, seed, count=True):
        with torch.cuda.device(dev):
            rng = np.random.default_rng(seed)
            x, r, chan = _static_case(rng, 127, c, c == 896, "bfloat16", dev)
            _check_static_entries(x, r, chan, c == 896, torch.bfloat16,
                                  count)
    for rnd in range(2):
        for i, dev in enumerate(cards):
            for c in (896, 2048):
                run(dev, c, 100 * rnd + 10 * i + c)
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        jobs = [pool.submit(run, dev, c, 7 * c + i, False)
                for i, dev in enumerate(cards) for c in (2048, 896)]
        for j in jobs:
            j.result()


@pytest.mark.parametrize("c", [896, 5000])
@pytest.mark.parametrize("scale", [2.0 ** 100, 2.0 ** -130],
                         ids=["2^100", "subnormal"])
def test_static_norm_extreme_scales(cuda_device, scale, c):
    """PTF scales no calibration gives, 2^100 and a subnormal one: the
    kernels' ``denom = scale * 2^alpha`` (one multiply by the exact power
    of two, in the team body and in ``norm_row``) keeps every output
    bitwise equal to the plain versions."""
    rng = np.random.default_rng(c)
    x, r, calib, gamma, beta = _norm_case(rng, 16, c, cuda_device)
    p = calibrate_ptf(calib, unsigned=True)
    s = torch.tensor(scale, dtype=torch.float32, device=cuda_device)
    f = s / p.scale.float()                # rows on the new scale's grid
    _check_static_entries(x * f, r * f, (s, p.alpha, gamma, beta), False,
                          torch.float32)


def _profiled_kernels(fn, counters, reps=5,
                      ours=("qnorm_kernel", "add_norm_kernel",
                            "add_norm_quant", "norm_row_kernel")):
    """Device kernels per call of ``fn`` under ``torch.profiler`` (between
    two ``torch.cuda._sleep`` markers, not counted), the kernels named in
    ``ours`` (by default the static-params norm kernels) by the launch
    counters ``counters`` of their wrappers (the profiler can drop a record
    of a kernel launched through ctypes). Returns (kernels per call, the
    names of every other kernel seen)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    before = sum(f.launches for f in counters)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1000)
        for _ in range(reps):
            fn()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
    launched = sum(f.launches for f in counters) - before
    other = [(e.key, e.count) for e in prof.key_averages()
             if max(getattr(e, k, 0) for k in ("device_time_total",
                                               "cuda_time_total")) > 0
             and "spin_kernel" not in e.key
             and not any(k in e.key for k in ours)]
    return (launched + sum(n for _, n in other)) / reps, [k for k, _ in other]


STATIC_OPS = ["layernorm", "rmsnorm", "residual_layernorm", "residual_rmsnorm",
              "residual_layernorm_q", "residual_rmsnorm_q"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("op", STATIC_OPS)
def test_static_params_op_call_is_one_kernel(cuda_device, op, dtype):
    """A static-params SOLE norm op call on contiguous float32 or bf16
    activations is one device kernel (no cast of the rows, no
    ``denom()``, no zero beta, the output written by the kernel in the
    activations' dtype), equal bit for bit to the plain version on the
    float32 view of the same rows."""
    rms = "rmsnorm" in op
    rng = np.random.default_rng(len(op) + len(dtype))
    x, r, calib, gamma, beta = _norm_case(rng, 8, 896, cuda_device)
    dt = getattr(torch, dtype)
    x, r = x.to(dt).reshape(2, 4, 896), r.to(dt).reshape(2, 4, 896)
    p = calibrate_ptf(calib.to(dt), unsigned=not rms)
    extra = () if rms else (beta,)
    fn = ops.resolve(op, "sole", "cuda")
    od = x.dtype
    if op.endswith("_q"):
        def call():
            return fn(x, r, gamma, *extra, params=p)
    elif op.startswith("residual_"):
        def call():
            return fn(x, r, gamma, *extra, params=p, out_dtype=od)
    else:
        def call():
            return fn(x, gamma, *extra, params=p, out_dtype=od)
    got = call()
    chan = (p.scale, p.alpha, gamma, None if rms else beta)
    x2, r2 = x.reshape(8, 896).float(), r.reshape(8, 896).float()
    if op.endswith("_q"):
        h_ref, codes, scale_ref = KN.add_norm_quant_plain(x2, r2, *chan,
                                                          rms=rms)
        want = (h_ref.reshape(x.shape), (codes.reshape(x.shape),
                                         scale_ref.reshape(2, 4, 1)))
        flat = [got[0], *got[1]], [want[0], *want[1]]
    elif op.startswith("residual_"):
        h_ref, out = KN.add_norm_plain(x2, r2, *chan, rms=rms)
        flat = list(got), [h_ref.reshape(x.shape), out.to(od).reshape(x.shape)]
    else:
        flat = [got], [KN.qnorm_plain(x2, *chan, rms=rms).to(od)
                       .reshape(x.shape)]
    torch.cuda.synchronize()
    assert all(a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(*flat))
    n, other = _profiled_kernels(call, (KN.qnorm, KN.add_norm,
                                        KN.add_norm_quant))
    assert n == 1 and not other, (n, other)


def test_ailayernorm_build_failure_raises(cuda_device, tmp_path, monkeypatch):
    """A norm source that does not compile raises from the wrapper; nothing
    falls back to the plain version and no launch is counted."""
    (tmp_path / "ailayernorm.cu").write_text("this is not CUDA\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.delitem(build._LIBS, "ailayernorm", raising=False)
    x = torch.zeros((2, 8), device=cuda_device)
    chan = (torch.ones((), device=cuda_device),
            torch.zeros(8, dtype=torch.int32, device=cuda_device),
            torch.ones(8, device=cuda_device), None)
    before = KN.qnorm.launches
    with pytest.raises(RuntimeError, match="nvcc failed on ailayernorm.cu"):
        KN.qnorm(x, *chan, rms=True)
    assert KN.qnorm.launches == before


def test_e2softmax_build_failure_raises(cuda_device, tmp_path, monkeypatch):
    """A source that does not compile raises from the wrapper; nothing
    falls back to the plain version and no launch is counted."""
    (tmp_path / "e2softmax.cu").write_text("this is not CUDA\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.delitem(build._LIBS, "e2softmax", raising=False)
    before = KE.e2softmax.launches
    with pytest.raises(RuntimeError, match="nvcc failed on e2softmax.cu"):
        KE.e2softmax(torch.zeros((2, 8), device=cuda_device))
    assert KE.e2softmax.launches == before


@pytest.mark.parametrize("mode", ["sole", "w8a8 exact int8 kv"])
def test_dense_engine_on_card_matches_cpu(cuda_device, mode):
    """The smoke dense-slot engine through the kernels (card) and the plain
    versions (CPU). SOLE mode: per prefill or decode call the E2Softmax
    kernel launches once per layer and the calibrating norm kernel
    2 * layers + 1 times, and at least 95% of greedy tokens agree. w8a8 in exact mode
    with an int8 cache: 7 * layers + 1 GEMM launches per call and equal
    tokens."""
    cfg = get_config("qwen2_0_5b").smoke()
    if mode != "sole":
        cfg = dataclasses.replace(cfg, softmax_mode="exact", norm_mode="exact",
                                  logit_int8=False, quant=QuantConfig("w8a8"),
                                  kv_cache_dtype="int8")
    params = api.init_params(0, cfg, "cpu")
    rng = np.random.default_rng(1)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab_size, n)
                    .astype(np.int32), max_new_tokens=8)
            for n in (5, 20, 12, 30, 9)]
    outs = []
    for dev in ("cpu", cuda_device):
        eng = Engine(cfg, params, batch_size=4, max_len=64, device=dev)
        sm0, norm0, mm0 = (KE.e2softmax.launches, KN.calibrated_norm.launches,
                           KM.int8_matmul.launches)
        outs.append(eng.generate(reqs))
        calls = eng.prefill_calls + eng.decode_calls
        if dev == cuda_device:
            if mode == "sole":
                assert KE.e2softmax.launches - sm0 == cfg.n_layers * calls
                assert KN.calibrated_norm.launches - norm0 == \
                    (2 * cfg.n_layers + 1) * calls
            else:
                assert KM.int8_matmul.launches - mm0 == (7 * cfg.n_layers + 1) \
                    * calls
                assert KE.e2softmax.launches == sm0
    assert all(len(o) == 8 for o in outs[1])
    if mode == "sole":
        pairs = [(a, b) for x, y in zip(*outs) for a, b in zip(x, y)]
        assert sum(a == b for a, b in pairs) / len(pairs) >= 0.95
    else:
        assert outs[1] == outs[0]


def _flash_inputs(rng, shape_q, shape_kv, grid, dtype, device):
    if grid:
        q = rng.integers(-8, 9, shape_q) / 4.0
        k = rng.integers(-8, 9, shape_kv).astype(np.float64)
    else:
        q = rng.standard_normal(shape_q) * 2
        k = rng.standard_normal(shape_kv)
    v = rng.standard_normal(shape_kv)
    return tuple(torch.from_numpy(a.astype(np.float32)).to(device, dtype)
                 for a in (q, k, v))


FLASH_CASES = {
    # (B, S, T, H, KV, hd, causal, block)
    "qwen2_causal": (1, 2048, 2048, 14, 2, 64, True, 128),
    "ragged_noncausal": (2, 300, 1000, 14, 2, 64, False, 128),
    "stablelm_mha": (1, 2048, 2048, 32, 32, 64, True, 128),
    "small_blocks_hd_16": (2, 200, 200, 4, 2, 16, True, 32),
    "block_96_hd_128": (1, 256, 256, 2, 1, 128, True, 96),
    # the last k-block (104 keys) not a multiple of 16
    "causal_1000": (1, 1000, 1000, 14, 2, 64, True, 128),
    # fewer than 16 rows and keys
    "short_8": (2, 8, 8, 4, 2, 64, True, 128),
    "hd_128": (1, 512, 512, 4, 4, 128, True, 128),
}


@pytest.mark.parametrize("mode", ["sole", "sole_int8", "sole_exact_corr",
                                  "exact"])
@pytest.mark.parametrize("name", list(FLASH_CASES) + ["qwen2_causal_f32",
                                                      "causal_1000_f32"])
def test_flash_kernel_matches_plain(cuda_device, name, mode):
    """The dense Flash-E2Softmax kernel through the op's cuda adapter
    against its plain version on the same (repeated, folded) inputs; bf16
    inputs (the tensor-core kernel), and float32 ones (the CUDA-core
    kernel) for the ``_f32`` cases."""
    dtype = torch.float32 if name.endswith("_f32") else torch.bfloat16
    b, s, t, h, kvh, hd, causal, block = FLASH_CASES[name.replace("_f32",
                                                                  "")]
    rng = np.random.default_rng(s + t + h)
    q, k, v = _flash_inputs(rng, (b, s, h, hd), (b, t, kvh, hd), True,
                            dtype, cuda_device)
    kw = dict(causal=causal, block=block, exp_bits=4,
              int8_scale=LOGIT_INT8_SCALE if mode == "sole_int8" else None,
              exact_corr=mode == "sole_exact_corr")
    op_mode = "exact" if mode == "exact" else "sole"
    assert ops.backend_for("flash_attention", op_mode, cuda_device) == "cuda"
    before = KA.flash_e2softmax.launches
    out = ops.flash_attention_fn(op_mode, cuda_device)(q, k, v, **kw)
    assert KA.flash_e2softmax.launches == before + 1
    assert out.dtype == dtype and out.shape == (b, s, h, hd)
    fold = [x.transpose(1, 2).reshape(b * h, -1, hd) for x in
            (q, k.repeat_interleave(h // kvh, 2),
             v.repeat_interleave(h // kvh, 2))]
    kern_kw = dict(causal=causal, sole=op_mode == "sole", exp_bits=4,
                   int8_scale=kw["int8_scale"], exact_corr=kw["exact_corr"],
                   block_q=block, block_k=block)
    got = KA.flash_e2softmax(*fold, **kern_kw)
    ref = KA.flash_e2softmax_plain(*fold, **kern_kw)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    scale = max(ref.abs().max().item(), 1.0)
    if hd in (16, 64):
        torch.testing.assert_close(got, ref, rtol=0, atol=1e-5 * scale)
    else:
        off = ((got - ref).abs().amax(-1) > 1e-3 * scale).float().mean()
        assert off.item() <= 0.01


@pytest.mark.parametrize("hd,exp_bits", [(20, 4), (64, 6)],
                         ids=["hd_20_unaligned", "exp_bits_6"])
@pytest.mark.parametrize("mode", ["sole_int8", "exact"])
def test_flash_tensor_core_kernel_edges(cuda_device, hd, exp_bits, mode):
    """The bf16 kernel's synchronous staging (a head dim that is not a
    multiple of 8: rows not 16-byte aligned, zero padding to 64) and
    6-bit codes (weights down to 2^-63, exact in bf16), causal over 300
    keys in blocks of 64, against the plain version: at hd 20 (d^-1/2 no
    power of two) at most 1% of rows off by 1e-3, at hd 64 1e-5."""
    b, s, h, kvh = 1, 300, 4, 2
    rng = np.random.default_rng(hd + exp_bits)
    q, k, v = _flash_inputs(rng, (b, s, h, hd), (b, s, kvh, hd), True,
                            torch.bfloat16, cuda_device)
    fold = [x.transpose(1, 2).reshape(b * h, -1, hd).contiguous() for x in
            (q, k.repeat_interleave(h // kvh, 2),
             v.repeat_interleave(h // kvh, 2))]
    kw = dict(causal=True, sole=mode != "exact", exp_bits=exp_bits,
              int8_scale=LOGIT_INT8_SCALE if mode != "exact" else None,
              block_q=64, block_k=64)
    got = KA.flash_e2softmax(*fold, **kw)
    ref = KA.flash_e2softmax_plain(*fold, **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    scale = max(ref.abs().max().item(), 1.0)
    if hd == 64:
        torch.testing.assert_close(got, ref, rtol=0, atol=1e-5 * scale)
    else:
        off = ((got - ref).abs().amax(-1) > 1e-3 * scale).float().mean()
        assert off.item() <= 0.01


def test_flash_kernel_random_logits_and_guards(cuda_device):
    """Real-valued logits (SOLE, int8 snap): at most 1% of rows differ by
    more than 1e-3; f32 inputs run too; tiles above 128 raise."""
    rng = np.random.default_rng(11)
    q, k, v = _flash_inputs(rng, (1, 512, 4, 64), (1, 512, 4, 64), False,
                            torch.float32, cuda_device)
    fold = [x.transpose(1, 2).reshape(4, 512, 64).contiguous()
            for x in (q, k, v)]
    kw = dict(causal=True, sole=True, int8_scale=LOGIT_INT8_SCALE,
              block_q=64, block_k=64)
    out = KA.flash_e2softmax(*fold, **kw)
    ref = KA.flash_e2softmax_plain(*fold, **kw)
    torch.cuda.synchronize()
    off = ((out - ref).abs().amax(-1) > 1e-3).float().mean().item()
    assert off <= 0.01
    with pytest.raises(ValueError, match="tiles"):
        KA.flash_e2softmax(*fold, causal=True, block_q=256, block_k=256)


def _norm_case(rng, rows, c, device):
    x = rng.standard_normal((rows, c)).astype(np.float32) * 2
    x *= 2.0 ** rng.integers(0, 4, size=c)             # every PTF alpha
    r = rng.standard_normal((rows, c)).astype(np.float32)
    calib = rng.standard_normal((rows, c)).astype(np.float32) * 2 \
        * 2.0 ** rng.integers(0, 4, size=c)
    gamma = (1 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    beta = (0.1 * rng.standard_normal(c)).astype(np.float32)
    return [torch.from_numpy(a).to(device) for a in (x, r, calib, gamma,
                                                     beta)]


@pytest.mark.parametrize("rows,c,rms", [(8, 896, True), (128, 896, True),
                                        (2048, 896, True),
                                        (128, 2048, False),
                                        (2048, 2048, False)])
def test_fused_norm_kernels_match_plain(cuda_device, rows, c, rms):
    """Static PTF params (calibrated on a held-out batch): the add+norm
    kernel's ``h`` bitwise and its norm to 1e-6; the quantize-out kernel's
    ``h`` bitwise and its codes and scale bitwise equal to
    ``quantize_act`` of the add+norm kernel's output."""
    rng = np.random.default_rng(rows + c)
    x, r, calib, gamma, beta = _norm_case(rng, rows, c, cuda_device)
    p = calibrate_ptf(calib, unsigned=not rms)
    args = (x, r, p.scale, p.alpha, gamma, None if rms else beta)
    n0, q0 = KN.add_norm.launches, KN.add_norm_quant.launches
    h, out = KN.add_norm(*args, rms=rms)
    h8, codes, scale = KN.add_norm_quant(*args, rms=rms)
    assert (KN.add_norm.launches, KN.add_norm_quant.launches) == (n0 + 1,
                                                                  q0 + 1)
    h_ref, out_ref = KN.add_norm_plain(*args, rms=rms)
    torch.cuda.synchronize()
    assert torch.equal(h, h_ref) and torch.equal(h8, h_ref)
    assert torch.equal(out, out_ref)
    want_codes, want_scale = quantize_act(out)
    assert codes.dtype == torch.int8 and scale.shape == (rows, 1)
    assert torch.equal(codes, want_codes) and torch.equal(scale, want_scale)


@pytest.mark.parametrize("kind", ["layernorm", "rmsnorm"])
def test_static_params_adapters_on_card(cuda_device, kind):
    """The registry sends static-params SOLE norms to the kernels: the
    plain norm to the quantize+norm kernel with the caller's params, the
    residual norm to the add+norm kernel and its ``_q`` twin to the
    quantize-out kernel; each matches the same adapter on the CPU."""
    rng = np.random.default_rng(5)
    x, r, calib, gamma, beta = _norm_case(rng, 64, 896, cuda_device)
    p = calibrate_ptf(calib, unsigned=kind == "layernorm")
    extra = (beta,) if kind == "layernorm" else ()
    cpu = [t.cpu() for t in (x, r, gamma) + extra]
    pc = calibrate_ptf(calib.cpu(), unsigned=kind == "layernorm")
    counters = (KN.qnorm, KN.add_norm, KN.add_norm_quant)
    before = [f.launches for f in counters]
    norm = ops.resolve(kind, "sole", "cuda")
    got = norm(x, gamma, *extra, params=p)
    want = norm(cpu[0], *cpu[2:], params=pc)
    h, out = ops.residual_norm_fn(kind, "sole", cuda_device)(
        x, r, gamma, *extra, params=p)
    hq, (codes, scale) = ops.residual_norm_q_fn(kind, "sole", cuda_device)(
        x, r, gamma, *extra, params=p)
    assert [f.launches - b for f, b in zip(counters, before)] == [1, 1, 1]
    torch.testing.assert_close(got.cpu(), want, rtol=1e-6, atol=1e-6)
    h_c, out_c = ops.residual_norm_fn(kind, "sole", "cpu")(*cpu, params=pc)
    assert torch.equal(h.cpu(), h_c) and torch.equal(hq.cpu(), h_c)
    torch.testing.assert_close(out.cpu(), out_c, rtol=1e-6, atol=1e-6)
    agree = (codes.cpu() == quantize_act(out_c)[0]).float().mean().item()
    assert agree >= 0.999


def test_codes_kernel_matches_plain(cuda_device):
    """LayerNorm on centred int32 codes in [-128, 127], alpha in 0..3."""
    rng = np.random.default_rng(9)
    xi = torch.from_numpy(rng.integers(-128, 128, (2048, 2048))
                          .astype(np.int32)).to(cuda_device)
    alpha = torch.from_numpy(rng.integers(0, 4, 2048).astype(np.int32)) \
        .to(cuda_device)
    gamma = torch.from_numpy((1 + 0.1 * rng.standard_normal(2048))
                             .astype(np.float32)).to(cuda_device)
    beta = torch.from_numpy((0.1 * rng.standard_normal(2048))
                            .astype(np.float32)).to(cuda_device)
    before = KN.codes_norm.launches
    out = KN.ailayernorm_codes(xi, alpha, gamma, beta)
    assert KN.codes_norm.launches == before + 1
    ref = KN.codes_norm_plain(xi, alpha, gamma, beta)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, rtol=1e-6, atol=1e-6)


def test_quickstart_runs_through_the_kernels(cuda_device, capsys):
    """The port's quickstart on the card launches the E2Softmax, the
    calibrating norm and the dense Flash-E2Softmax kernels."""
    from repro_torch.launch import quickstart
    counters = (KE.e2softmax, KN.calibrated_norm, KA.flash_e2softmax)
    before = [f.launches for f in counters]
    assert quickstart.main([]) == 0
    assert all(f.launches > b for f, b in zip(counters, before))
    assert "done." in capsys.readouterr().out


# -- the paged kernel's KV-group tiling ----------------------------------------

PAGED_GROUP_CASES = {
    # a permuted, non-contiguous map of 14 q heads onto 2 KV heads (the
    # groups 5 and 9 heads), a decode batch with null lanes
    "permuted_map": dict(b=4, c=1, nb=32, q_start=[0] * 4,
                         kv_len=[300, 1, 77, 16]),
    # 4096 keys: 256 pages, 32 chunks of the tensor-core kernel
    "kv4096": dict(b=2, c=1, nb=256, q_start=[0, 0], kv_len=[4096, 4001]),
    # a causal chunk of 100 rows (700 group rows: not a multiple of the
    # 64-row tile) at q_start 37
    "ragged_chunk": dict(b=1, c=100, nb=16, q_start=[37], kv_len=[137]),
}
PERMUTED_MAP = [1, 0, 0, 1, 1, 0, 1, 1, 0, 1, 0, 1, 1, 1]


@pytest.mark.parametrize("mode", ["exact", "sole"])
@pytest.mark.parametrize("pool", ["bf16", "int8", "int8-qpv"])
@pytest.mark.parametrize("case", list(PAGED_GROUP_CASES))
def test_paged_kernel_group_tiling_matches_plain(cuda_device, case, pool, mode):
    """The tensor-core kernel (bf16 q, one CTA per sequence, KV head and
    64-row tile) against its plain version on exact-logit inputs, at
    qwen2_0_5b's widths: an explicit permuted map, more pages than one
    chunk, and a prefill chunk whose rows do not fill the last tile; bf16
    pools and int8 pools with ``quant_pv`` off and on."""
    cfg = get_config("qwen2_0_5b")
    spec = PAGED_GROUP_CASES[case]
    rng = np.random.default_rng(len(case) + len(pool))
    q, k, v, tables, meta = _paged_inputs(
        rng, h=cfg.n_heads, kvh=cfg.n_kv_heads, d=cfg.head_dim, bs=16,
        **spec)
    qt = torch.from_numpy(q).to(cuda_device, torch.bfloat16)
    kw = dict(causal=spec["c"] > 1, sole=mode == "sole", exp_bits=4,
              int8_scale=LOGIT_INT8_SCALE if mode == "sole" else None)
    if pool == "bf16":
        kt, vt = (torch.from_numpy(a).to(cuda_device, torch.bfloat16)
                  for a in (k, v))
    else:
        v = rng.integers(-127, 128, v.shape)
        kt, vt = (torch.from_numpy(np.clip(a, -127, 127)).to(cuda_device,
                                                              torch.int8)
                  for a in (k, v))
        kw.update(kv_scale=KV_INT8_SCALE, quant_pv=pool == "int8-qpv")
    assert KA.paged_variant(qt.dtype, kt.dtype, cfg.head_dim, 16,
                            kw.get("kv_scale")).startswith("bf16 mma")
    tables, meta = (torch.from_numpy(a).to(cuda_device)
                    for a in (tables, meta))
    kvmap = (torch.tensor(PERMUTED_MAP, dtype=torch.int32, device=cuda_device)
             if case == "permuted_map" else
             KA.default_kv_head_map(cfg.n_heads, cfg.n_kv_heads, cuda_device))
    out = KA.flash_e2softmax_paged(qt, kt, vt, tables, meta,
                                   kv_head_map=kvmap, **kw)
    ref = KA.flash_e2softmax_paged_plain(qt, kt, vt, tables, meta, kvmap,
                                         **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", ["exact", "sole"])
@pytest.mark.parametrize("dtype,pool,bs", [
    ("float32", "float32", 16), ("bfloat16", "bfloat16", 8),
    ("bfloat16", "int8", 8)], ids=["f32", "bf16-8tok", "int8-8tok"])
def test_paged_kernel_cuda_cores_permuted_map(cuda_device, mode, dtype, pool,
                                              bs):
    """The CUDA-core kernel (float32 q, or pages of other than 16 tokens)
    with the same KV-group tiling: a permuted map and a ragged causal
    chunk, over float32, bf16 and int8 pools."""
    cfg = get_config("qwen2_0_5b")
    spec = dict(PAGED_GROUP_CASES["ragged_chunk"])
    spec["nb"] = 16 * 16 // bs
    rng = np.random.default_rng(4)
    arrays = _paged_inputs(rng, h=cfg.n_heads, kvh=cfg.n_kv_heads,
                           d=cfg.head_dim, bs=bs, **spec)
    q = torch.from_numpy(arrays[0]).to(cuda_device, getattr(torch, dtype))
    kw = dict(causal=True, sole=mode == "sole", exp_bits=4,
              int8_scale=LOGIT_INT8_SCALE if mode == "sole" else None)
    if pool == "int8":
        v = rng.integers(-127, 128, arrays[2].shape)
        k, v = (torch.from_numpy(np.clip(a, -127, 127)).to(cuda_device,
                                                            torch.int8)
                for a in (arrays[1], v))
        kw.update(kv_scale=KV_INT8_SCALE, quant_pv=False)
    else:
        k, v = (torch.from_numpy(a).to(cuda_device, getattr(torch, pool))
                for a in arrays[1:3])
    tables, meta = (torch.from_numpy(a).to(cuda_device) for a in arrays[3:])
    assert KA.paged_variant(q.dtype, k.dtype, cfg.head_dim, bs,
                            kw.get("kv_scale")) == "CUDA cores"
    kvmap = torch.tensor(PERMUTED_MAP, dtype=torch.int32, device=cuda_device)
    out = KA.flash_e2softmax_paged(q, k, v, tables, meta, kv_head_map=kvmap,
                                   **kw)
    ref = KA.flash_e2softmax_paged_plain(q, k, v, tables, meta, kvmap, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)


# -- the calibrating norm -------------------------------------------------------


def _calib_case(rng, rows, c, dtype, device):
    x = rng.standard_normal((rows, c)).astype(np.float32) * 2
    x *= 2.0 ** rng.integers(0, 4, size=c)             # every PTF alpha
    r = rng.standard_normal((rows, c)).astype(np.float32)
    gamma = (1 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    beta = (0.1 * rng.standard_normal(c)).astype(np.float32)
    xt, rt = (torch.from_numpy(a).to(device, dtype) for a in (x, r))
    return xt, rt, torch.from_numpy(gamma).to(device), \
        torch.from_numpy(beta).to(device)


def _check_calib(x, r, gamma, beta, rms):
    """The kernel against its plain version (the torch chain on the card),
    norm and quantize-out, twice each: ``h``, ``alpha``, ``scale``, the
    output in the model dtype, the codes and row scales bitwise."""
    b = None if rms else beta
    want = KN.calibrated_norm_plain(x, r, gamma, beta, rms=rms,
                                    out_dtype=x.dtype)
    want_q = KN.calibrated_norm_plain(x, r, gamma, beta, rms=rms,
                                      quant_out=True)
    before = KN.calibrated_norm.launches
    for _ in range(2):
        h, out, alpha, scale = KN.calibrated_norm(x, r, gamma, b, rms=rms,
                                                  out_dtype=x.dtype)
        hq, (codes, qs), alpha_q, scale_q = KN.calibrated_norm(
            x, r, gamma, b, rms=rms, quant_out=True)
        torch.cuda.synchronize()
        assert torch.equal(h, want[0]) and torch.equal(hq, want[0])
        for a in (alpha, alpha_q):
            assert torch.equal(a, want[2])
        for s in (scale, scale_q):
            assert torch.equal(s, want[3])
        assert out.dtype == x.dtype and torch.equal(out, want[1])
        assert torch.equal(codes, want_q[1][0]) and torch.equal(qs, want_q[1][1])
    assert KN.calibrated_norm.launches == before + 4


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("c,rms", [(896, True), (2048, False)])
@pytest.mark.parametrize("rows", [1, 8, 128, 2400])
def test_calibrated_norm_bitwise_equals_plain(cuda_device, rows, c, rms, dtype):
    """The decode (8), paged prefill (128) and dense prefill (8 x 300)
    row counts, and one row, at qwen2's (RMS) and stablelm's (LN) widths:
    the residual add, calibration over all rows and norm in one cluster
    launch equal the torch chain bit for bit, with and without ``r``."""
    rng = np.random.default_rng(rows + c)
    x, r, gamma, beta = _calib_case(rng, rows, c, getattr(torch, dtype),
                                    cuda_device)
    _check_calib(x, r, gamma, beta, rms)
    _check_calib(x, None, gamma, beta, rms)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_calibrated_norm_power_of_two_ratios(cuda_device, dtype):
    """Many random batches whose channels' ``ideal / scale`` ratios are
    exact powers of two (the case calibrate_ptf's ``- 1e-6`` exists for):
    alpha, scale and the outputs stay bitwise equal to the torch chain."""
    rng = np.random.default_rng(17)
    dt = getattr(torch, dtype)
    for trial in range(40):
        rows, c = int(rng.choice([1, 8, 128])), int(rng.choice([64, 896]))
        x = rng.standard_normal((rows, c)).astype(np.float32)
        top = float(2.0 ** rng.integers(-3, 6)) * 1.5
        peak = np.clip(np.abs(x).max(0), None, top / 16)
        x = np.sign(x) * np.minimum(np.abs(x), peak)
        k = rng.integers(0, 5, size=c)              # ratio 8 / 2^k exactly
        row = rng.integers(0, rows, size=c)
        x[row, np.arange(c)] = top / 2.0 ** k * rng.choice([-1, 1], size=c)
        xt = torch.from_numpy(x).to(cuda_device, dt)
        assert (xt.float().abs().amax(0) == torch.from_numpy(
            top / 2.0 ** k).float().to(cuda_device)).all()
        gamma = torch.ones(c, device=cuda_device)
        beta = torch.zeros(c, device=cuda_device)
        _check_calib(xt, torch.zeros_like(xt), gamma, beta, trial % 2 == 0)


def test_model_norms_launch_only_the_calibrating_kernel(cuda_device):
    """The op calls a model's SOLE norms make (``out_dtype`` the model
    dtype): one calibrating-norm launch each and nothing of the
    static-params kernels; outputs equal the torch chain."""
    rng = np.random.default_rng(2)
    x, r, gamma, _ = _calib_case(rng, 8, 896, torch.bfloat16, cuda_device)
    counters = (KN.calibrated_norm, KN.qnorm, KN.add_norm, KN.add_norm_quant)
    before = [f.launches for f in counters]
    h, out = ops.residual_norm_fn("rmsnorm", "sole", cuda_device)(
        x, r, gamma, out_dtype=torch.bfloat16)
    hq, (codes, scale) = ops.residual_norm_q_fn("rmsnorm", "sole",
                                                cuda_device)(x, r, gamma)
    n = ops.rmsnorm_fn("sole", cuda_device)(x, gamma, out_dtype=torch.bfloat16)
    assert [f.launches - b for f, b in zip(counters, before)] == [3, 0, 0, 0]
    want = KN.calibrated_norm_plain(x, r, gamma, None, rms=True,
                                    out_dtype=torch.bfloat16)
    assert torch.equal(h, want[0]) and torch.equal(out, want[1])
    assert out.dtype == torch.bfloat16 and torch.equal(hq, h)
    assert torch.equal(n, KN.calibrated_norm_plain(
        x, None, gamma, None, rms=True, out_dtype=torch.bfloat16)[1])


# (rows, C) on each side of calib_plan's boundaries (bf16 / float32 rows):
# the decode cluster's size (a row a CTA up to 16: 16 -> 17 rows of 2,048
# and 6,144; 32 -> 33 rows, two -> three a CTA), the route (127 / 128 / 129
# rows; 128 x 256 = 32,768 elements against 128 x 264), the grid's one CTA
# an SM (131 / 132 / 133 and 263 / 264 / 265 rows) and the h slab (2,400
# rows of 6,144 keep 16 of a CTA's 19 bf16 rows, 8 of float32 ones; the
# rest are read again)
CALIB_BOUNDARIES = [(1, 896), (16, 6144), (17, 6144), (32, 896), (33, 896),
                    (16, 2048), (17, 2048),
                    (127, 896), (128, 896), (129, 896), (127, 6144),
                    (128, 6144), (129, 6144), (128, 256), (128, 264),
                    (131, 896), (132, 896), (133, 896), (263, 896),
                    (264, 896), (265, 896), (2400, 6144)]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("rows,c", CALIB_BOUNDARIES)
def test_calibrated_norm_at_the_plan_boundaries(cuda_device, rows, c, dtype):
    """Row counts on each side of every boundary of the plan, with and
    without ``r``, RMS and LayerNorm: bitwise equal to the torch chain
    (norm and quantize-out, twice each)."""
    rng = np.random.default_rng(rows * 7 + c)
    x, r, gamma, beta = _calib_case(rng, rows, c, getattr(torch, dtype),
                                    cuda_device)
    _check_calib(x, r, gamma, beta, rows % 2 == 0)
    _check_calib(x, None, gamma, beta, rows % 2 == 1)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("rows,c", [(8, 896), (40, 4096), (127, 6144),
                                    (2400, 896), (2400, 6144)])
def test_calibrated_norm_max_in_the_last_row(cuda_device, rows, c, dtype):
    """One channel whose maximum sits only in the last row of the last CTA
    (it sets the base scale): the maxima cross every CTA before any row is
    normalized, so alpha, scale and the outputs equal the torch chain."""
    rng = np.random.default_rng(rows + c + 5)
    x = rng.uniform(-1, 1, (rows, c)).astype(np.float32)
    x[-1, c - 3] = -50.0
    dt = getattr(torch, dtype)
    xt = torch.from_numpy(x).to(cuda_device, dt)
    rt = torch.from_numpy(rng.uniform(-0.25, 0.25, (rows, c)).astype(
        np.float32)).to(cuda_device, dt)
    gamma = torch.ones(c, device=cuda_device)
    beta = torch.zeros(c, device=cuda_device)
    want = KN.calibrated_norm_plain(xt, rt, gamma, beta, rms=False)
    assert int(want[2][c - 3]) == 3 and want[2][:c - 3].max() < 3
    _check_calib(xt, rt, gamma, beta, False)
    _check_calib(xt, rt, gamma, beta, True)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("rows,c", [(8, 896), (40, 4096), (2400, 896)])
def test_calibrated_norm_all_zero_rows(cuda_device, rows, c, dtype):
    """All-zero RMS rows among others (every code 0: the zero dividends
    ``code_of`` keeps off the division's slow path) and an all-zero
    tensor (every channel at calibrate_ptf's 1e-8 floor): bitwise."""
    rng = np.random.default_rng(rows + c)
    x, r, gamma, beta = _calib_case(rng, rows, c, getattr(torch, dtype),
                                    cuda_device)
    x[::3] = 0
    r[::3] = 0
    _check_calib(x, r, gamma, beta, True)
    _check_calib(torch.zeros_like(x), None, gamma, beta, True)
    _check_calib(torch.zeros_like(x), torch.zeros_like(x), gamma, beta,
                 False)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("rows,c", [(8, 897), (40, 4098), (2400, 900),
                                    (8, 896), (2400, 896)])
def test_calibrated_norm_scalar_route(cuda_device, rows, c, dtype):
    """C not a multiple of the 16-byte vector, and x, r and gamma one
    element off 16-byte alignment (contiguous views into larger buffers):
    the scalar instantiation, bitwise equal to the torch chain."""
    rng = np.random.default_rng(rows + c + 11)
    x, r, gamma, beta = _calib_case(rng, rows, c, getattr(torch, dtype),
                                    cuda_device)
    if c % 16 == 0:
        def shift(t):
            buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
            view = buf[1:].view(t.shape)
            view.copy_(t)
            return view
        x, r, gamma, beta = (shift(t) for t in (x, r, gamma, beta))
        assert x.is_contiguous() and x.data_ptr() % 16 != 0
    _check_calib(x, r, gamma, beta, True)
    _check_calib(x, r, gamma, beta, False)


@pytest.mark.parametrize("rows,c", [(8, 896), (40, 4096), (2400, 6144)])
def test_calibrated_norm_float32_out_and_without_params(cuda_device, rows, c):
    """bf16 rows with a float32 output, quantize-out, and
    ``with_params=False`` (no copy of the calibration): the same bits as
    the torch chain."""
    rng = np.random.default_rng(rows + c + 3)
    x, r, gamma, beta = _calib_case(rng, rows, c, torch.bfloat16, cuda_device)
    for rms in (True, False):
        b = None if rms else beta
        want = KN.calibrated_norm_plain(x, r, gamma, beta, rms=rms)
        want_q = KN.calibrated_norm_plain(x, r, gamma, beta, rms=rms,
                                          quant_out=True)
        got = KN.calibrated_norm(x, r, gamma, b, rms=rms)
        h, out, alpha, scale = KN.calibrated_norm(
            x, r, gamma, b, rms=rms, with_params=False)
        hq, (codes, qs), aq, sq = KN.calibrated_norm(
            x, r, gamma, b, rms=rms, quant_out=True, with_params=False)
        torch.cuda.synchronize()
        assert all(torch.equal(p, q) for p, q in zip(got, want))
        assert got[1].dtype == torch.float32
        assert alpha is scale is aq is sq is None
        assert torch.equal(h, want[0]) and torch.equal(out, want[1])
        assert torch.equal(hq, want[0])
        assert torch.equal(codes, want_q[1][0]) and torch.equal(qs,
                                                                 want_q[1][1])


@pytest.mark.parametrize("rows,route,ctas", [(64, "cluster", 1),
                                             (153600, "grid", 132)])
def test_calibrated_norm_grouped_bf16_rows(cuda_device, rows, route, ctas):
    """rwkv6's (64, 64) affine on bf16 rows with a residual and
    quantize-out: one group (one CTA, a plain launch) and 153,600 rows (the
    grid route with whole groups a CTA), bitwise equal to the torch
    chain."""
    x, g, b = _groupnorm_case(np.random.default_rng(9), rows, cuda_device)
    r = torch.randn(x.shape, device=cuda_device) * 0.5
    x, r = x.to(torch.bfloat16), r.to(torch.bfloat16)
    plan = KN.calib_plan(rows, 64, 2, 64)
    assert (plan.route, plan.ctas) == (route, ctas)
    _check_calib(x, r, g, b, False)


def test_calibrated_norm_calls_in_a_row(cuda_device):
    """Ten calls in a row at alternating shapes and routes, enqueued
    without a synchronize: each equals the torch chain, so no scratch or
    barrier state is carried from one launch to the next."""
    rng = np.random.default_rng(10)
    bf, f32 = torch.bfloat16, torch.float32
    cases = []
    for rows, c, dt, rms in ((8, 896, bf, True), (2400, 6144, bf, False),
                             (128, 896, f32, True), (40, 4096, bf, False),
                             (2048, 3584, bf, True)):
        x, r, gamma, beta = _calib_case(rng, rows, c, dt, cuda_device)
        want = KN.calibrated_norm_plain(x, r, gamma, beta, rms=rms,
                                        out_dtype=dt)
        cases.append(((x, r, gamma, None if rms else beta), rms, dt, want))
    torch.cuda.synchronize()
    got = [KN.calibrated_norm(*args, rms=rms, out_dtype=dt)
           for i in range(10)
           for args, rms, dt, _ in [cases[(3 * i) % len(cases)]]]
    torch.cuda.synchronize()
    for i, g in enumerate(got):
        want = cases[(3 * i) % len(cases)][3]
        assert all(torch.equal(p, q) for p, q in zip(g, want)), i


@pytest.mark.parametrize("rows,c,rms", [(8, 896, True), (40, 4096, False),
                                        (2400, 6144, False),
                                        (2048, 3584, True)])
def test_calibrating_norm_op_call_is_one_kernel(cuda_device, rows, c, rms):
    """A model's SOLE norm op call (``residual_rmsnorm`` /
    ``residual_layernorm``, bf16 out) is one device kernel on either route:
    one ``calib_norm_kernel`` launch (by its counter: the profiler can drop
    a record of a kernel launched through ctypes) and no memset or other
    kernel under the profiler."""
    rng = np.random.default_rng(rows)
    x, r, gamma, beta = _calib_case(rng, rows, c, torch.bfloat16, cuda_device)
    fn = ops.resolve("residual_rmsnorm" if rms else "residual_layernorm",
                     "sole", "cuda")
    extra = () if rms else (beta,)

    def call():
        return fn(x, r, gamma, *extra, out_dtype=torch.bfloat16)
    before = KN.calibrated_norm.launches
    n, other = _profiled_kernels(call, (KN.calibrated_norm,),
                                 ours=("calib_norm_kernel",))
    assert KN.calibrated_norm.launches - before == 6
    assert n == 1 and not other, (n, other)


@pytest.mark.parametrize("pool", ["bf16", "int8"])
@pytest.mark.parametrize("c", [1, 40], ids=["decode", "prefill"])
def test_paged_kernel_head_dim_16(cuda_device, c, pool):
    """Head dim 16 (d^-1/2 = 1/4) runs the tensor-core kernels with the
    head dim zero-padded to 64 columns: decode and a causal chunk, over
    bf16 and int8 pools, against the plain version."""
    rng = np.random.default_rng(c)
    spec = (dict(b=3, c=1, nb=24, q_start=[0] * 3, kv_len=[300, 1, 33])
            if c == 1 else dict(b=1, c=40, nb=8, q_start=[60], kv_len=[100]))
    q, k, v, tables, meta = _paged_inputs(rng, h=4, kvh=2, d=16, bs=16,
                                          **spec)
    qt = torch.from_numpy(q).to(cuda_device, torch.bfloat16)
    kw = dict(causal=c > 1, sole=True, exp_bits=4, int8_scale=LOGIT_INT8_SCALE)
    if pool == "bf16":
        kt, vt = (torch.from_numpy(a).to(cuda_device, torch.bfloat16)
                  for a in (k, v))
    else:
        v = rng.integers(-127, 128, v.shape)
        kt, vt = (torch.from_numpy(np.clip(a, -127, 127)).to(cuda_device,
                                                              torch.int8)
                  for a in (k, v))
        kw.update(kv_scale=KV_INT8_SCALE, quant_pv=True)
    assert KA.paged_variant(qt.dtype, kt.dtype, 16, 16,
                            kw.get("kv_scale")).startswith("bf16 mma")
    tables, meta = (torch.from_numpy(a).to(cuda_device)
                    for a in (tables, meta))
    kvmap = KA.default_kv_head_map(4, 2, cuda_device)
    out = KA.flash_e2softmax_paged(qt, kt, vt, tables, meta, **kw)
    ref = KA.flash_e2softmax_paged_plain(qt, kt, vt, tables, meta, kvmap,
                                         **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)


# -- speculative verify: the paged kernel at B lanes x C = K + 1 rows ----------


def _verify_lanes(b, c, seed):
    """Per-lane (q_start, kv_len) of a verify batch: ragged n_valid in
    1..C at positions up to 300, every fourth lane a null lane (q_start 0,
    kv_len 1, page 0)."""
    rng = np.random.default_rng(seed)
    q_start, kv_len = [], []
    for i in range(b):
        if i % 4 == 3:
            q_start.append(0)
            kv_len.append(1)
            continue
        qs = int(rng.integers(1, 300 - c))
        q_start.append(qs)
        kv_len.append(qs + int(rng.integers(1, c + 1)))
    return q_start, kv_len


@pytest.mark.parametrize("mode", ["exact", "sole"])
@pytest.mark.parametrize("pool", ["bf16", "int8"])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("c", [2, 3, 5, 9])
@pytest.mark.parametrize("b", [1, 8])
def test_paged_kernel_verify_shapes(cuda_device, b, c, d, pool, mode):
    """The verify dispatch's attention: B lanes of C = K + 1 causal rows,
    a different q_start per lane, n_valid < C (rows past it attend every
    valid key), null lanes; 16-token pages; the tensor cores. At head dim
    64 (qwen2, 14/2 heads) exact-logit inputs give identical codes: 1e-5.
    At head dim 128 (minitron, 32/8 heads) the scale 2^-3.5 makes the
    scaled q inexact on the grid, so the kernel's summation order moves
    the logits: exact mode to 1e-4 of the output scale, SOLE at most 1% of
    rows off by more than 1e-3."""
    h, kvh = (14, 2) if d == 64 else (32, 8)
    q_start, kv_len = _verify_lanes(b, c, seed=b * 100 + c)
    rng = np.random.default_rng(d + c)
    q, k, v, tables, meta = _paged_inputs(
        rng, b=b, c=c, h=h, kvh=kvh, d=d, bs=16, nb=20, q_start=q_start,
        kv_len=kv_len)
    qt = torch.from_numpy(q).to(cuda_device, torch.bfloat16)
    kw = dict(causal=True, sole=mode == "sole", exp_bits=4,
              int8_scale=LOGIT_INT8_SCALE if mode == "sole" else None)
    if pool == "bf16":
        kt, vt = (torch.from_numpy(a).to(cuda_device, torch.bfloat16)
                  for a in (k, v))
    else:
        v = rng.integers(-127, 128, v.shape)
        kt, vt = (torch.from_numpy(np.clip(a, -127, 127)).to(cuda_device,
                                                              torch.int8)
                  for a in (k, v))
        kw.update(kv_scale=KV_INT8_SCALE, quant_pv=True)
    tables, meta = (torch.from_numpy(a).to(cuda_device)
                    for a in (tables, meta))
    kvmap = KA.default_kv_head_map(h, kvh, cuda_device)
    before = KA.flash_e2softmax_paged.launches
    out = KA.flash_e2softmax_paged(qt, kt, vt, tables, meta, **kw)
    assert KA.flash_e2softmax_paged.launches == before + 1
    ref = KA.flash_e2softmax_paged_plain(qt, kt, vt, tables, meta, kvmap,
                                         **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    if d == 64:
        torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
        return
    err = (out - ref).abs()
    scale = max(ref.abs().max().item(), 1.0)
    if mode == "exact":
        assert err.max().item() <= 1e-4 * scale
    else:
        assert (err.amax(-1) > 1e-3 * scale).float().mean().item() <= 0.01


@pytest.mark.parametrize("pool", ["bf16", "int8"])
@pytest.mark.parametrize("mode", ["exact", "sole"])
def test_verify_rows_match_decode_route(cuda_device, mode, pool):
    """The C > 1 route (one causal call over C rows) against the C = 1
    route (the decode kernel, one call per row at kv_len = position + 1)
    for the same query rows, pools and pages: exact-logit inputs give the
    same codes, so the two differ at most in the sum order, 1e-5."""
    c, q0 = 5, 117
    rng = np.random.default_rng(23)
    q, k, v, tables, meta = _paged_inputs(
        rng, b=1, c=c, h=14, kvh=2, d=64, bs=16, nb=20, q_start=[q0],
        kv_len=[q0 + c])
    qt = torch.from_numpy(q).to(cuda_device, torch.bfloat16)
    kw = dict(sole=mode == "sole", exp_bits=4,
              int8_scale=LOGIT_INT8_SCALE if mode == "sole" else None)
    if pool == "bf16":
        kt, vt = (torch.from_numpy(a).to(cuda_device, torch.bfloat16)
                  for a in (k, v))
    else:
        v = rng.integers(-127, 128, v.shape)
        kt, vt = (torch.from_numpy(np.clip(a, -127, 127)).to(cuda_device,
                                                              torch.int8)
                  for a in (k, v))
        kw.update(kv_scale=KV_INT8_SCALE, quant_pv=True)
    tables, meta = (torch.from_numpy(a).to(cuda_device)
                    for a in (tables, meta))
    wide = KA.flash_e2softmax_paged(qt, kt, vt, tables, meta, causal=True,
                                    **kw)
    rows = []
    for i in range(c):
        m = torch.tensor([[q0 + i, q0 + i + 1]], dtype=torch.int32,
                         device=cuda_device)
        rows.append(KA.flash_e2softmax_paged(
            qt[:, :, i:i + 1].contiguous(), kt, vt, tables, m, causal=False,
            **kw))
    narrow = torch.cat(rows, 2)
    torch.cuda.synchronize()
    torch.testing.assert_close(wide, narrow, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("k,n", GEMM_KN, ids=lambda v: str(v))
def test_int8_gemm_bitwise_at_verify_rows(cuda_device, k, n):
    """M = 40, the verify dispatch's rows (8 lanes x C = 5), at every w8a8
    projection of qwen2_0_5b and its head, bitwise on two calls."""
    gen = torch.Generator(device=cuda_device).manual_seed(k + n)
    x = torch.randint(-127, 128, (40, k), generator=gen, device=cuda_device,
                      dtype=torch.int8)
    w = torch.randint(-127, 128, (k, n), generator=gen, device=cuda_device,
                      dtype=torch.int8)
    ref = KM.int8_matmul_plain(x, w)
    for _ in range(2):
        out = KM.int8_matmul(x, w)
        torch.cuda.synchronize()
        assert torch.equal(out, ref)


@pytest.mark.parametrize("mode", ["sole", "w8a8 exact"])
def test_spec_engine_on_card(cuda_device, mode):
    """The smoke spec engine (n-gram drafter, 32-token vocabulary so every
    lane drafts) on the card: one paged-attention launch per layer per
    verify dispatch, 2L + 1 calibrating norms in SOLE mode, 7L + 1 int8
    GEMMs at w8a8, no static-params quantize+norm; in exact mode at w8a8
    its tokens equal the plain engine's on the card and the spec engine's
    on the CPU."""
    from repro_torch.serve import engine as E
    from repro_torch.serve.spec import NGramDrafter, SpecConfig
    cfg = dataclasses.replace(get_config("qwen2_0_5b").smoke(),
                              vocab_size=32)
    if mode != "sole":
        cfg = dataclasses.replace(cfg, softmax_mode="exact",
                                  norm_mode="exact", logit_int8=False,
                                  quant=QuantConfig("w8a8"))
    params = api.init_params(0, cfg, "cpu")
    rng = np.random.default_rng(44)
    reqs = [Request(prompt=rng.permutation(32).astype(np.int32),
                    max_new_tokens=8) for _ in range(3)]
    per_call = []
    real = E.api.verify_paged

    def counted(*a, **kw):
        before = (KA.flash_e2softmax_paged.launches,
                  KN.calibrated_norm.launches, KM.int8_matmul.launches,
                  KN.qnorm.launches)
        out = real(*a, **kw)
        per_call.append(tuple(x - y for x, y in zip(
            (KA.flash_e2softmax_paged.launches, KN.calibrated_norm.launches,
             KM.int8_matmul.launches, KN.qnorm.launches), before)))
        return out

    def engine(dev, spec):
        return PagedEngine(cfg, params, num_blocks=40, block_size=8,
                           max_seq_len=64, decode_batch=4, prefill_chunk=8,
                           device=dev, spec_config=spec)
    E.api.verify_paged = counted
    try:
        outs = {}
        for dev in ("cpu", cuda_device):
            per_call.clear()
            eng = engine(dev, SpecConfig(NGramDrafter(), max_k=4))
            outs[str(dev)] = eng.generate(reqs)
            eng.cache.check_refcounts()
        plain = engine(cuda_device, None).generate(reqs)
    finally:
        E.api.verify_paged = real
    assert eng.stats()["spec_dispatches"] == len(per_call) > 0
    layers = cfg.n_layers
    want = (layers, 2 * layers + 1 if mode == "sole" else 0,
            7 * layers + 1 if mode != "sole" else 0, 0)
    assert set(per_call) == {want}
    assert all(len(o) == 8 for o in outs["cuda"])
    if mode != "sole":
        assert outs["cuda"] == plain == outs["cpu"]


# -- row stability: verify rows against decode rows, the exact norms -----------


def _row_cfg(d, pool, mode):
    """qwen2 (head dim 64, the tensor cores) or minitron (128, the CUDA
    cores) in bf16, with bf16 pages, int8 pages, or int8 pages at w8a8
    (``quant_pv``: V's raw codes through P.V)."""
    cfg = get_config("qwen2_0_5b" if d == 64 else "minitron_8b")
    kw = dict(kv_cache_dtype="auto" if pool == "bf16" else "int8")
    if pool == "int8-qpv":
        kw["quant"] = QuantConfig("w8a8")
    if mode == "exact":
        kw.update(softmax_mode="exact", norm_mode="exact", logit_int8=False)
    return dataclasses.replace(cfg, **kw)


@pytest.mark.parametrize("mode", ["exact", "sole"])
@pytest.mark.parametrize("pool", ["bf16", "int8", "int8-qpv"])
@pytest.mark.parametrize("d", [64, 128])
def test_verify_rows_bitwise_equal_decode_rows(cuda_device, d, pool, mode):
    """``paged_attend`` as ``verify_paged`` calls it (8 lanes x C = 5
    causal rows, ragged n_valid, null lanes, random bf16 q) against the
    decode step at each valid row's position (kv_len = position + 1):
    the verify rows run through the decode kernel as single-row queries,
    so every valid row is bitwise equal to its decode row."""
    from repro_torch.models import layers as L
    cfg = _row_cfg(d, pool, mode)
    b, c, h, kvh = 8, 5, cfg.n_heads, cfg.n_kv_heads
    q_start, kv_len = _verify_lanes(b, c, seed=d + len(pool))
    rng = np.random.default_rng(d)
    _, k, v, tables, _ = _paged_inputs(
        rng, b=b, c=c, h=h, kvh=kvh, d=d, bs=16, nb=20, q_start=q_start,
        kv_len=kv_len)
    q = torch.from_numpy(rng.standard_normal((b, c, h, d))).to(
        cuda_device, torch.bfloat16)
    if pool == "bf16":
        kt, vt = (torch.from_numpy(a).to(cuda_device, torch.bfloat16)
                  for a in (k, v))
    else:
        v = rng.integers(-127, 128, v.shape)
        kt, vt = (torch.from_numpy(np.clip(a, -127, 127)).to(
            cuda_device, torch.int8) for a in (k, v))
    tables = torch.from_numpy(tables).to(cuda_device)
    qs = torch.tensor(q_start, dtype=torch.int32, device=cuda_device)
    kl = torch.tensor(kv_len, dtype=torch.int32, device=cuda_device)
    before = KA.flash_e2softmax_paged.launches
    wide = L.paged_attend(q, kt, vt, tables, qs, kl, cfg, causal=True,
                          rows_as_decode=True)
    assert KA.flash_e2softmax_paged.launches == before + 1
    n = 0
    for i in range(b):
        for j in range(kv_len[i] - q_start[i]):
            pos = torch.tensor([q_start[i] + j], dtype=torch.int32,
                               device=cuda_device)
            row = L.paged_attend(q[i:i + 1, j:j + 1].contiguous(), kt, vt,
                                 tables[i:i + 1], pos, pos + 1, cfg,
                                 causal=False)
            assert torch.equal(wide[i, j], row[0, 0]), (i, j)
            n += 1
    torch.cuda.synchronize()
    assert n >= b and torch.isfinite(wide).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c,rms", [(896, True), (4096, True), (4096, False),
                                   (6144, False)])
def test_exact_norm_rows_are_stable(cuda_device, c, rms, dtype):
    """The exact-mode norm kernel gives each row the same bits at 1, 8,
    40, 128 and 2,400 rows and alone; against the plain torch ops (another
    reduction order, torch's approximate rsqrt) to 1e-5 of the scale."""
    gen = torch.Generator(device=cuda_device).manual_seed(c + rms)
    dt = getattr(torch, dtype)
    x = (torch.randn((2400, c), generator=gen, device=cuda_device) * 3
         + torch.randn((2400, 1), generator=gen, device=cuda_device)).to(dt)
    g = torch.rand((c,), generator=gen, device=cuda_device) + 0.5
    bt = None if rms else torch.randn((c,), generator=gen,
                                      device=cuda_device)
    eps = 1e-6 if rms else 1e-5
    before = KN.exact_norm.launches
    full = KN.exact_norm(x, g, bt, rms=rms, eps=eps)
    assert KN.exact_norm.launches == before + 1
    for rows in (1, 8, 40, 128):
        assert torch.equal(KN.exact_norm(x[:rows], g, bt, rms=rms, eps=eps),
                           full[:rows])
    for i in (0, 7, 39, 1234, 2399):
        assert torch.equal(KN.exact_norm(x[i:i + 1], g, bt, rms=rms,
                                         eps=eps)[0], full[i])
    half = KN.exact_norm(x, g, bt, rms=rms, eps=eps, out_dtype=torch.bfloat16)
    assert torch.equal(half, full.to(torch.bfloat16))
    ref = KN.exact_norm_plain(x, g, bt, rms=rms, eps=eps)
    torch.cuda.synchronize()
    assert (full - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_exact_residual_norms_q_row_stable(cuda_device, kind):
    """The exact residual norm with int8 out (w8a8's ``residual_*_q``) at 40
    rows (a verify dispatch) and 8 (a decode step): the first 8 rows'
    sums, codes and scales are bitwise equal; one kernel per call."""
    fn = ops.resolve(f"residual_{kind}_q", "exact", "cuda")
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    x, r = (torch.randn((40, 896), generator=gen, device=cuda_device).to(
        torch.bfloat16) for _ in range(2))
    g = torch.ones(896, device=cuda_device)
    bt = torch.zeros(896, device=cuda_device)
    before = KN.exact_norm.launches
    s40, (q40, sc40) = fn(x, r, g, bt)
    s8, (q8, sc8) = fn(x[:8], r[:8], g, bt)
    assert KN.exact_norm.launches == before + 2
    assert torch.equal(s40[:8], s8)
    assert torch.equal(q40[:8], q8) and torch.equal(sc40[:8], sc8)


# -- the recurrent families: rwkv6's per-head GroupNorm, the hybrid's MQA -------


GROUPNORM_ROWS = (8 * 64, 128 * 64, 2400 * 64)   # decode, chunk, dense prefill


def _groupnorm_case(rng, rows, device):
    """rwkv6's GroupNorm at full width: float32 WKV rows of one head's 64
    channels, 64 heads, an (H, hd) = (64, 64) affine."""
    x = rng.standard_normal((rows, 64)).astype(np.float32) * 2
    x *= 2.0 ** rng.integers(0, 4, size=64)            # every PTF alpha
    g = (1 + 0.1 * rng.standard_normal((64, 64))).astype(np.float32)
    b = (0.1 * rng.standard_normal((64, 64))).astype(np.float32)
    return (torch.from_numpy(x).to(device), torch.from_numpy(g).to(device),
            torch.from_numpy(b).to(device))


@pytest.mark.parametrize("rows", GROUPNORM_ROWS)
def test_calibrated_norm_per_head_affine(cuda_device, rows):
    """The calibrating norm with a (G, C) affine (row r takes row r mod G):
    ``alpha``, ``scale`` and the output bitwise equal to its plain version
    (calibration over every row); a (G, C) affine whose rows are all one
    (C,) affine gives the (C,) call's bits."""
    x, g, b = _groupnorm_case(np.random.default_rng(rows), rows, cuda_device)
    want = KN.calibrated_norm_plain(x, None, g, b, rms=False)
    for _ in range(2):
        got = KN.calibrated_norm(x, None, g, b, rms=False)
        torch.cuda.synchronize()
        assert all(torch.equal(a, w) for a, w in zip(got[1:], want[1:]))
    one = KN.calibrated_norm(x, None, g[5], b[5], rms=False)[1]
    rep = KN.calibrated_norm(x, None, g[5].expand(64, 64).contiguous(),
                             b[5].expand(64, 64).contiguous(), rms=False)[1]
    assert torch.equal(one, rep)


@pytest.mark.parametrize("rows", GROUPNORM_ROWS)
def test_exact_norm_per_head_affine(cuda_device, rows):
    """The exact-mode norm with a (G, C) affine: each head's rows equal a
    (C,) call on those rows alone, bit for bit (the kernel's rows do not
    depend on their batch); against the plain torch ops 1e-5 of the
    scale."""
    x, g, b = _groupnorm_case(np.random.default_rng(rows + 1), rows,
                              cuda_device)
    full = KN.exact_norm(x, g, b, rms=False, eps=1e-5)
    for h in (0, 1, 37, 63):
        one = KN.exact_norm(x[h::64].contiguous(), g[h], b[h], rms=False,
                            eps=1e-5)
        assert torch.equal(full[h::64], one)
    ref = KN.exact_norm_plain(x, g, b, rms=False, eps=1e-5)
    torch.cuda.synchronize()
    assert (full - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()


@pytest.mark.parametrize("mode", ["exact", "sole"])
def test_groupnorm_op_is_one_launch(cuda_device, mode):
    """rwkv6's ``_group_norm``: the ``layernorm`` op on (B, S, H, hd)
    float32 with (H, hd) params is one launch of the mode's kernel and
    equals the kernels' plain version on the same rows."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import rwkv6 as TR
    cfg = get_config("rwkv6_7b")
    if mode == "exact":
        cfg = dataclasses.replace(cfg, norm_mode="exact")
    x, g, b = _groupnorm_case(np.random.default_rng(3), 8 * 64, cuda_device)
    o = x.reshape(2, 4, 64, 64)
    wrapper = KN.exact_norm if mode == "exact" else KN.calibrated_norm
    before = wrapper.launches
    out = TR._group_norm(o, g, b, cfg, "serve")
    assert wrapper.launches == before + 1 and out.shape == o.shape
    if mode == "exact":
        want = KN.exact_norm(x, g, b, rms=False, eps=1e-5)
    else:
        want = KN.calibrated_norm_plain(x, None, g, b, rms=False)[1]
    torch.cuda.synchronize()
    assert torch.equal(out.reshape(-1, 64), want)


def test_fma_on_the_card_is_one_rounding(cuda_device):
    """``layers.fma`` (``addcmul``) rounds once, as ``fma32`` does: the
    RG-LRU scan's combine and the causal conv's taps take the compiled
    reference's FMA contraction on the card too."""
    from repro_torch.models import layers as L
    gen = torch.Generator(device="cuda").manual_seed(0)
    a, b, c = (torch.randn(1 << 20, generator=gen, device="cuda")
               for _ in range(3))
    assert torch.equal(L.fma(a, b, c), KN.fma32(a, b, c))
    assert not torch.equal(a * b + c, KN.fma32(a, b, c))


@pytest.mark.parametrize("mode", ["exact", "sole"])
@pytest.mark.parametrize("pool", ["bfloat16", "float32"])
@pytest.mark.parametrize("name", ["prefill", "decode"])
def test_paged_kernel_mqa_head_dim_256(cuda_device, name, pool, mode):
    """recurrentgemma_9b's local attention: 16 query heads on one KV head
    of dimension 256 (d^-1/2 = 1/16 exact), a causal 128-row chunk or a
    decode batch of 8 with null lanes, on exact-logit inputs: 1e-5. bf16
    pools take the tensor-core route, float32 pools the CUDA cores."""
    spec = (dict(b=1, c=128, nb=32, q_start=[128], kv_len=[256])
            if name == "prefill" else
            dict(b=8, c=1, nb=32, q_start=[0] * 8,
                 kv_len=[49, 300, 117, 1, 256, 83, 160, 1]))
    arrays = _paged_inputs(np.random.default_rng(11), h=16, kvh=1, d=256,
                           bs=16, **spec)
    dt = getattr(torch, pool)
    q, k, v = (torch.from_numpy(a).to(cuda_device, dt) for a in arrays[:3])
    tables, meta = (torch.from_numpy(a).to(cuda_device) for a in arrays[3:])
    route = KA.paged_variant(q.dtype, k.dtype, 256, 16)
    assert route == ("CUDA cores" if pool == "float32"
                     else "bf16 mma.sync tensor cores")
    kw = dict(causal=name == "prefill", sole=mode == "sole", exp_bits=4,
              int8_scale=LOGIT_INT8_SCALE if mode == "sole" else None)
    kvmap = KA.default_kv_head_map(16, 1, cuda_device)
    out = KA.flash_e2softmax_paged(q, k, v, tables, meta, **kw)
    ref = KA.flash_e2softmax_paged_plain(q, k, v, tables, meta, kvmap, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)


# -- the tensor-core route at head dims 128 and 256 ----------------------------

WIDE_HEADS = {"minitron": (32, 8, 128), "dbrx": (48, 8, 128),
              "recurrentgemma": (16, 1, 256)}
WIDE_CASES = {
    "decode": dict(b=8, c=1, nb=32, q_start=[0] * 8,
                   kv_len=[49, 300, 117, 1, 256, 83, 160, 1]),
    "chunk": dict(b=1, c=128, nb=32, q_start=[128], kv_len=[256]),
    # causal chunks whose rows do not fill the last tile, a null lane
    "ragged_chunk": dict(b=3, c=37, nb=24, q_start=[20, 250, 0],
                         kv_len=[57, 270, 1]),
    # 256 pages: several rounds of a cluster's CTAs
    "kv4096": dict(b=2, c=1, nb=256, q_start=[0, 0], kv_len=[4096, 4001]),
}


def _wide_pools(rng, k, v, pool, device):
    if pool == "bf16":
        return tuple(torch.from_numpy(a).to(device, torch.bfloat16)
                     for a in (k, v))
    v = rng.integers(-127, 128, v.shape)
    return tuple(torch.from_numpy(np.clip(a, -127, 127)).to(device,
                                                             torch.int8)
                 for a in (k, v))


@pytest.mark.parametrize("mode", ["exact", "sole"])
@pytest.mark.parametrize("pool", ["bf16", "int8", "int8-qpv"])
@pytest.mark.parametrize("case", list(WIDE_CASES))
@pytest.mark.parametrize("heads", list(WIDE_HEADS))
def test_paged_kernel_wide_heads_match_plain(cuda_device, heads, case, pool,
                                             mode):
    """The tensor-core route at head dim 128 (minitron's and mixtral's
    32/8 heads, dbrx's 48/8; q in three bf16 parts) and 256
    (recurrentgemma's 16/1) against the plain version: decode with null
    lanes, a 128-row chunk, ragged causal chunks, 4,096 keys, over a
    permuted KV-head map, bf16 pools and int8 pools with ``quant_pv`` off
    and on, SOLE with the snap and exact mode. Exact-logit inputs: 1e-5 at
    256; at 128 exact mode 1e-4 of the output scale, SOLE at most 1% of
    rows off by more than 1e-3."""
    h, kvh, d = WIDE_HEADS[heads]
    spec = WIDE_CASES[case]
    rng = np.random.default_rng(d + len(case) + len(pool))
    q, k, v, tables, meta = _paged_inputs(rng, h=h, kvh=kvh, d=d, bs=16,
                                          **spec)
    qt = torch.from_numpy(q).to(cuda_device, torch.bfloat16)
    kt, vt = _wide_pools(rng, k, v, pool, cuda_device)
    kw = dict(causal=spec["c"] > 1, sole=mode == "sole", exp_bits=4,
              int8_scale=LOGIT_INT8_SCALE if mode == "sole" else None)
    if pool != "bf16":
        kw.update(kv_scale=KV_INT8_SCALE, quant_pv=pool == "int8-qpv")
    assert KA.paged_variant(qt.dtype, kt.dtype, d, 16,
                            kw.get("kv_scale")).startswith("bf16 mma")
    tables, meta = (torch.from_numpy(a).to(cuda_device)
                    for a in (tables, meta))
    kvmap = torch.from_numpy(rng.permutation(np.arange(h) % kvh).astype(
        np.int32)).to(cuda_device)
    before = KA.flash_e2softmax_paged.launches
    out = KA.flash_e2softmax_paged(qt, kt, vt, tables, meta,
                                   kv_head_map=kvmap, **kw)
    assert KA.flash_e2softmax_paged.launches == before + 1
    ref = KA.flash_e2softmax_paged_plain(qt, kt, vt, tables, meta, kvmap,
                                         **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    if d == 256:
        torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
        return
    err = (out - ref).abs()
    scale = max(ref.abs().max().item(), 1.0)
    if mode == "exact":
        assert err.max().item() <= 1e-4 * scale
    else:
        assert (err.amax(-1) > 1e-3 * scale).float().mean().item() <= 0.01


@pytest.mark.parametrize("mode", ["exact", "sole"])
@pytest.mark.parametrize("pool", ["bf16", "int8"])
@pytest.mark.parametrize("heads", list(WIDE_HEADS))
def test_paged_decode_rows_bitwise_across_batches(cuda_device, heads, pool,
                                                  mode):
    """The decode kernel splits each sequence's pages over the CTAs of a
    cluster, as many as fill the card for the launch's batch; every page's
    partial and the in-order fold over them are the same whatever the
    split, so one row alone, the same 8 rows and 40 rows (random q, 1-500
    keys) give the same bits."""
    h, kvh, d = WIDE_HEADS[heads]
    rng = np.random.default_rng(d + len(pool))
    lens = [int(x) for x in rng.integers(1, 501, 40)]
    _, k, v, tables, meta = _paged_inputs(rng, b=40, c=1, h=h, kvh=kvh, d=d,
                                          bs=16, nb=32, q_start=[0] * 40,
                                          kv_len=lens)
    q = torch.from_numpy(rng.standard_normal((40, h, 1, d))).to(
        cuda_device, torch.bfloat16)
    kt, vt = _wide_pools(rng, k, v, pool, cuda_device)
    tables, meta = (torch.from_numpy(a).to(cuda_device)
                    for a in (tables, meta))
    kw = dict(causal=False, sole=mode == "sole", exp_bits=4,
              int8_scale=LOGIT_INT8_SCALE if mode == "sole" else None)
    if pool == "int8":
        kw.update(kv_scale=KV_INT8_SCALE, quant_pv=True)

    def rows(sl):
        return KA.flash_e2softmax_paged(q[sl].contiguous(), kt, vt,
                                        tables[sl].contiguous(),
                                        meta[sl].contiguous(), **kw)
    full = rows(slice(0, 40))
    assert torch.equal(rows(slice(5, 13)), full[5:13])
    assert torch.equal(rows(slice(7, 8)), full[7:8])
    torch.cuda.synchronize()
    assert torch.isfinite(full).all()


# -- the row-stable products of decode and verify dispatches -------------------

# (K, N, dtype) of mixtral_8x7b's decode products: wq/wo, wk/wv, an
# expert's gate/up and down, the head, the router (float32 from bf16)
MIXTRAL_PRODUCTS = {"wq": (4096, 4096, "bfloat16"),
                    "wk": (4096, 1024, "bfloat16"),
                    "expert_up": (4096, 14336, "bfloat16"),
                    "expert_down": (14336, 4096, "bfloat16"),
                    "head": (4096, 32000, "bfloat16"),
                    "router": (4096, 8, "float32")}


@pytest.mark.parametrize("name", list(MIXTRAL_PRODUCTS))
def test_stable_mm_rows_bitwise_across_m(cuda_device, name):
    """``layers.stable_mm`` at mixtral's shapes: the rows of M = 1, 8, 40
    and 72 products (72: two tiles), in order and reversed, bitwise equal
    to the same rows of the 72-row product."""
    from repro_torch.models import layers as L
    k, n, dtype = MIXTRAL_PRODUCTS[name]
    gen = torch.Generator(device=cuda_device).manual_seed(k + n)
    a = torch.randn((72, k), generator=gen, device=cuda_device)
    w = torch.randn((k, n), generator=gen, device=cuda_device) * 0.02
    if dtype == "bfloat16":
        a, w = a.bfloat16(), w.bfloat16()
    else:                                   # bf16 operands, float32 product
        a, w = a.bfloat16().float(), w.bfloat16().float()
    full = L.stable_mm(a, w)
    for m in (1, 8, 40, 72):
        assert torch.equal(L.stable_mm(a[:m], w), full[:m]), m
        assert torch.equal(L.stable_mm(a[:m].flip(0), w), full[:m].flip(0))
    torch.cuda.synchronize()


def test_moe_ffn_rows_bitwise_across_t(cuda_device):
    """The drop-free MoE FFN of a decode or verify dispatch (``stable``)
    at mixtral's width, one layer of random bf16 experts: each token's row
    bitwise the same among 8, 40 and 72 tokens (other expert slots, one or
    two capacity tiles) and in reversed order."""
    from repro_torch.models import moe as M
    cfg = get_config("mixtral_8x7b")
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    gen = torch.Generator(device=cuda_device).manual_seed(3)

    def w(*shape):
        return (torch.randn(shape, generator=gen, device=cuda_device)
                * 0.02).bfloat16()
    p = {"router": w(d, e), "gate": w(e, d, f), "up": w(e, d, f),
         "down": w(e, f, d)}
    x = torch.randn((72, d), generator=gen, device=cuda_device).bfloat16()

    def ffn(rows):
        return M._paged_ffn(p, rows[None], cfg, "serve", stable=True)[0]
    few, many, most = ffn(x[:8]), ffn(x[32:72]), ffn(x)
    assert torch.equal(ffn(x[:8].flip(0)).flip(0), few)
    assert torch.equal(ffn(x[32:40]), many[:8])
    assert torch.equal(most[32:72], many) and torch.equal(most[:8], few)
    torch.cuda.synchronize()


@pytest.mark.parametrize("arch", ["qwen2_0_5b", "mixtral_8x7b"])
def test_decode_step_rows_do_not_depend_on_the_batch(cuda_device, arch):
    """A paged decode step on the card (smoke weights in bf16, exact mode)
    takes the row-stable products: lane 0's logits are bitwise the same in
    a batch of 8 lanes as alone."""
    cfg = dataclasses.replace(get_config(arch).smoke(), dtype="bfloat16",
                              softmax_mode="exact", norm_mode="exact",
                              logit_int8=False)
    params = api.init_params(0, cfg, cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    pools = {k: torch.randn((cfg.n_layers, 40, 16, cfg.n_kv_heads,
                             cfg.head_dim), generator=gen,
                            device=cuda_device).bfloat16()
             for k in ("k", "v")}
    tables = torch.arange(1, 33, dtype=torch.int32,
                          device=cuda_device).reshape(8, 4)
    pos = torch.tensor([37, 5, 60, 12, 0, 33, 18, 49], dtype=torch.int32,
                       device=cuda_device)
    token = torch.randint(0, cfg.vocab_size, (8,), generator=gen,
                          device=cuda_device).int()
    many, _ = api.decode_step_paged(params, token, pos, {"tables": tables},
                                    {k: v.clone() for k, v in pools.items()},
                                    cfg)
    one, _ = api.decode_step_paged(params, token[:1], pos[:1],
                                   {"tables": tables[:1]}, pools, cfg)
    torch.cuda.synchronize()
    assert torch.equal(many[0], one[0])


@pytest.mark.parametrize("name", ["decode", "prefill"])
def test_sole_probs_at_the_hybrids_shapes(cuda_device, name):
    """The hybrid's dense-slot attention softmax (``decode_attend``: 8
    lanes x 16 heads of one row over a 384-column ring, the valid columns
    broadcast at stride 0; the prefill's causal (300, 300) mask broadcast
    over 16 heads): one E2Softmax launch per call, bitwise equal to the
    max / snap / E2Softmax / cast chain on its plain pieces."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import layers as L
    cfg = get_config("recurrentgemma_9b")
    gen = torch.Generator(device="cuda").manual_seed(1)
    if name == "decode":
        cols = torch.arange(384, device="cuda")
        valid = (cols <= 300) & (cols != 17)
        mask = torch.broadcast_to(valid[None, None, None], (8, 16, 1, 384))
    else:
        pos = torch.arange(300, device="cuda")
        mask = torch.broadcast_to((pos[:, None] >= pos[None])[None, None],
                                  (8, 16, 300, 300))
    logits = torch.randn(mask.shape, generator=gen, device="cuda") * 4
    before = KE.e2softmax.launches
    probs = L._sole_probs(logits, mask, cfg, torch.bfloat16)
    assert KE.e2softmax.launches == before + 1
    m = torch.where(mask, logits, -torch.inf).amax(-1, keepdim=True)
    d = ops.snap_logits(logits - torch.clamp_min(m, -1e30), LOGIT_INT8_SCALE)
    want = KE.e2softmax_plain(d, mask=mask.contiguous(), exp_bits=4).to(
        torch.bfloat16)
    torch.cuda.synchronize()
    assert torch.equal(probs, want)


@pytest.mark.parametrize("engine", ["paged", "dense"])
@pytest.mark.parametrize("mode", ["exact", "sole"])
@pytest.mark.parametrize("arch", ["rwkv6_7b", "recurrentgemma_9b"])
def test_recurrent_smoke_engines_on_card(cuda_device, arch, mode, engine):
    """The ssm and hybrid smoke engines (the hybrid at 4 layers: one
    rec-rec-attention block, one tail layer) on the card against the same
    engines on the CPU: exact mode greedy tokens equal, SOLE at least 95%
    equal. Every SOLE norm of the card run is a calibrating-norm launch
    (rwkv6: 3 per layer and the final one per forward)."""
    cfg = get_config(arch).smoke()
    if arch == "recurrentgemma_9b":
        cfg = dataclasses.replace(cfg, n_layers=4, n_tail_layers=1)
    if mode == "exact":
        cfg = dataclasses.replace(cfg, softmax_mode="exact",
                                  norm_mode="exact", logit_int8=False)
    params = api.init_params(0, cfg, "cpu")
    rng = np.random.default_rng(1)
    n = 12 if engine == "dense" else None
    reqs = [Request(prompt=rng.integers(0, cfg.vocab_size, n or m)
                    .astype(np.int32), max_new_tokens=8)
            for m in (5, 20, 12, 30, 9)]
    outs = []
    for dev in ("cpu", "cuda"):
        if engine == "paged":
            eng = PagedEngine(cfg, params, num_blocks=32, block_size=8,
                              max_seq_len=64, decode_batch=4,
                              prefill_chunk=8, device=dev)
        else:
            eng = Engine(cfg, params, batch_size=4, max_len=64, device=dev)
        before = KN.calibrated_norm.launches
        outs.append(eng.generate(reqs))
        if dev == "cuda" and mode == "sole":
            assert KN.calibrated_norm.launches > before
    pairs = [(a, b) for x, y in zip(*outs) for a, b in zip(x, y)]
    assert all(len(o) == 8 for o in outs[1])
    agree = sum(a == b for a, b in pairs) / len(pairs)
    assert agree >= (1.0 if mode == "exact" else 0.95)


# -- the encdec and vlm families (whisper_small, qwen2_vl_7b) ----------------------

XATTN_VALID = (1500, 1200, 800, 1, 1500, 333, 1000, 1)   # cross rows a lane


def _family_mask(name, device):
    """The masks ``attend_dense`` hands ``_sole_probs`` on the two
    families' paths: whisper's encoder ((S, T) all true, or a 300-column
    padded tail, broadcast over batch and heads), its cross-attention at
    a decode step and a 64-row chunk (per-lane (B, 1, S, T) validity at
    stride 0 over 12 heads), qwen2-vl's causal prefill over 28 heads."""
    cols = torch.arange(1500, device=device)
    if name.startswith("encoder"):
        keep = cols[None] < (1200 if name == "encoder_tail" else 1500)
        return torch.broadcast_to(keep, (1, 12, 1500, 1500))
    if name.startswith("xattn"):
        lane = cols[None] < torch.tensor(XATTN_VALID, device=device)[:, None]
        rows = 1 if name == "xattn_decode" else 64
        return torch.broadcast_to(lane[:, None, None, :], (8, 12, rows, 1500))
    pos = torch.arange(1024, device=device)
    return torch.broadcast_to((pos[:, None] >= pos[None])[None, None],
                              (2, 28, 1024, 1024))


@pytest.mark.parametrize("name", ["encoder", "encoder_tail", "xattn_decode",
                                  "xattn_chunk", "vlm_prefill"])
def test_sole_probs_at_the_encdec_and_vlm_shapes(cuda_device, name):
    """``_sole_probs`` at 1,500 columns (the block-per-row body) and at
    qwen2-vl's 1,024-row causal prefill: one E2Softmax launch per call,
    equal to the max / snap / E2Softmax / cast chain on its plain pieces
    up to a row's ALDivision bucket (sums past 512 columns round in
    another order), every masked entry, the padded tail's included,
    exactly 0."""
    from repro_torch.models import layers as L
    cfg = get_config("qwen2_vl_7b" if name.startswith("vlm")
                     else "whisper_small")
    mask = _family_mask(name, cuda_device)
    gen = torch.Generator(device="cuda").manual_seed(2)
    logits = torch.randn(mask.shape, generator=gen, device="cuda") * 4
    before = KE.e2softmax.launches
    probs = L._sole_probs(logits, mask, cfg, torch.bfloat16)
    assert KE.e2softmax.launches == before + 1
    m = torch.where(mask, logits, -torch.inf).amax(-1, keepdim=True)
    d = ops.snap_logits(logits - torch.clamp_min(m, -1e30), LOGIT_INT8_SCALE)
    want = KE.e2softmax_plain(d, mask=mask.contiguous(), exp_bits=4).to(
        torch.bfloat16)
    torch.cuda.synchronize()
    c = mask.shape[-1]
    _assert_e2_matches(probs.float().reshape(-1, c),
                       want.float().reshape(-1, c), c)
    assert not probs[~mask].any()


FAMILY_NORMS = [(8, 768, False), (128, 768, False), (1500, 768, False),
                (8, 3584, True), (2048, 3584, True)]


def _family_norm_case(rows, c, device):
    gen = torch.Generator(device="cuda").manual_seed(rows + c)
    x = torch.randn((rows, c), generator=gen, device=device) * 3
    x[:, ::7] *= 8                                   # alpha > 0 channels
    r = torch.randn((rows, c), generator=gen, device=device)
    g = 1 + 0.1 * torch.randn((c,), generator=gen, device=device)
    b = 0.1 * torch.randn((c,), generator=gen, device=device)
    return x.to(torch.bfloat16), r.to(torch.bfloat16), g, b


@pytest.mark.parametrize("residual", [True, False])
@pytest.mark.parametrize("rows,c,rms", FAMILY_NORMS)
def test_calibrated_norm_at_the_encdec_and_vlm_widths(cuda_device, rows, c,
                                                      rms, residual):
    """whisper's LayerNorm at 768 channels (a decode step, a 128-row chunk,
    one request's 1,500 encoder rows) and qwen2-vl's RMSNorm at 3,584 (a
    decode step, a 2 x 1,024 prefill), with and without the residual add:
    bitwise equal to its plain version on two calls."""
    x, r, g, b = _family_norm_case(rows, c, cuda_device)
    rr = r if residual else None
    beta = None if rms else b
    want = KN.calibrated_norm_plain(x, rr, g, torch.zeros_like(g) if rms
                                    else b, rms=rms, out_dtype=x.dtype)
    for _ in range(2):
        got = KN.calibrated_norm(x, rr, g, beta, rms=rms, out_dtype=x.dtype)
        torch.cuda.synchronize()
        assert all(torch.equal(p, q) for p, q in zip(got, want))


@pytest.mark.parametrize("rows,c,rms", FAMILY_NORMS)
def test_exact_norm_at_the_encdec_and_vlm_widths(cuda_device, rows, c, rms):
    """The exact-mode norm at the same rows: each row alone bitwise equal
    to its row of the whole call; 1e-5 of the scale from the plain ops."""
    x, _, g, b = _family_norm_case(rows, c, cuda_device)
    beta, eps = (None, 1e-6) if rms else (b, 1e-5)
    full = KN.exact_norm(x, g, beta, rms=rms, eps=eps)
    for i in (0, rows // 2, rows - 1):
        assert torch.equal(KN.exact_norm(x[i:i + 1], g, beta, rms=rms,
                                         eps=eps)[0], full[i])
    ref = KN.exact_norm_plain(x, g, beta, rms=rms, eps=eps)
    torch.cuda.synchronize()
    assert (full - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()


@pytest.mark.parametrize("mode", ["exact", "sole"])
@pytest.mark.parametrize("name", ["prefill", "decode"])
def test_paged_kernel_at_whispers_heads(cuda_device, name, mode):
    """whisper's decoder self-attention: 12 query heads on 12 KV heads,
    head dim 64 (the tensor-core route), a causal 128-row chunk or a
    decode batch of 8 with null lanes, bf16 pools, exact-logit inputs:
    1e-5."""
    spec = (dict(b=1, c=128, nb=32, q_start=[0], kv_len=[128])
            if name == "prefill" else
            dict(b=8, c=1, nb=32, q_start=[0] * 8,
                 kv_len=[49, 96, 17, 1, 64, 83, 40, 1]))
    arrays = _paged_inputs(np.random.default_rng(13), h=12, kvh=12, d=64,
                           bs=16, **spec)
    q, k, v = (torch.from_numpy(a).to(cuda_device, torch.bfloat16)
               for a in arrays[:3])
    tables, meta = (torch.from_numpy(a).to(cuda_device) for a in arrays[3:])
    kw = dict(causal=name == "prefill", sole=mode == "sole", exp_bits=4,
              int8_scale=LOGIT_INT8_SCALE if mode == "sole" else None)
    kvmap = KA.default_kv_head_map(12, 12, cuda_device)
    out = KA.flash_e2softmax_paged(q, k, v, tables, meta, **kw)
    ref = KA.flash_e2softmax_paged_plain(q, k, v, tables, meta, kvmap, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", ["exact", "sole"])
def test_whisper_smoke_engine_on_card(cuda_device, mode):
    """The smoke whisper ``PagedEngine`` (ragged encoder inputs: 8-40
    frames against cross_len 32) on the card against the CPU: exact mode
    greedy tokens equal, SOLE at least 95%; on the card every cross page
    is freed with its sequence."""
    cfg = get_config("whisper_small").smoke()
    if mode == "exact":
        cfg = dataclasses.replace(cfg, softmax_mode="exact",
                                  norm_mode="exact", logit_int8=False)
    params = api.init_params(0, cfg, "cpu")
    rng = np.random.default_rng(1)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab_size, n)
                    .astype(np.int32), max_new_tokens=8,
                    frames=rng.standard_normal((m, cfg.d_model))
                    .astype(np.float32))
            for n, m in ((5, 32), (20, 17), (12, 40), (9, 8), (3, 32))]
    outs = []
    for dev in ("cpu", "cuda"):
        eng = PagedEngine(cfg, params, num_blocks=64, block_size=8,
                          max_seq_len=64, decode_batch=4, prefill_chunk=8,
                          device=dev)
        outs.append(eng.generate(reqs))
        eng.cache.check_refcounts()
        assert eng.stats()["blocks_in_use"] == 0
    pairs = [(a, b) for x, y in zip(*outs) for a, b in zip(x, y)]
    assert all(len(o) == 8 for o in outs[1])
    agree = sum(a == b for a, b in pairs) / len(pairs)
    assert agree >= (1.0 if mode == "exact" else 0.95)


def test_vlm_smoke_prefill_decode_on_card(cuda_device):
    """The smoke qwen2-vl ``prefill`` + ``decode_step`` (exact mode, a 4 x 4
    patch grid in the position ids) on the card against the CPU: logits
    within 1e-4 (cuBLAS and the CPU sum in other orders)."""
    from repro_torch.models.state import tree_map
    cfg = dataclasses.replace(get_config("qwen2_vl_7b").smoke(),
                              softmax_mode="exact", norm_mode="exact",
                              logit_int8=False)
    params = api.init_params(0, cfg, "cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 24),
                         generator=torch.Generator().manual_seed(3))
    pos = torch.arange(24, dtype=torch.int32).expand(3, 2, 24).clone()
    pos[0, :, :16] = 0
    pos[1, :, :16] = torch.arange(16) // 4
    pos[2, :, :16] = torch.arange(16) % 4
    rows = []
    for dev in ("cpu", "cuda"):
        p = tree_map(lambda t: t.to(dev), params)
        batch = {"embeds": p["embed"]["table"][toks.to(dev)],
                 "positions": pos.to(dev)}
        logits, cache = api.prefill(p, batch, cfg, 28)
        out = [logits[:, 0].cpu()]
        for i in range(4):
            logits, cache = api.decode_step(p, cache, toks[:, 20 + i].to(dev)
                                            .int(), 24 + i, cfg)
            out.append(logits.cpu())
        rows.append(torch.stack(out))
    torch.cuda.synchronize()
    torch.testing.assert_close(rows[1], rows[0], rtol=0, atol=1e-4)


# -- training: the exact norm's backward kernel and the train step --------------

def _bwd_case(device, rows, c, rms, groups, dtype, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    lead = (groups, c) if groups > 1 else (c,)
    x = (torch.randn((rows, c), generator=gen, device=device) * 3
         + torch.randn((rows, 1), generator=gen, device=device)).to(dtype)
    dy = torch.randn((rows, c), generator=gen, device=device).to(dtype)
    g = 1 + 0.1 * torch.randn(lead, generator=gen, device=device)
    b = None if rms else 0.1 * torch.randn(lead, generator=gen,
                                           device=device)
    return x, dy, g, b


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,c,rms,groups", [
    (8, 896, True, 1), (2048, 896, True, 1), (2048, 2048, False, 1),
    (1500, 768, False, 1), (8, 3584, True, 1), (2400, 6144, False, 1),
    (512, 64, False, 64), (8192, 64, False, 64)])
def test_exact_norm_backward_matches_plain(cuda_device, rows, c, rms, groups,
                                           dtype):
    """``exact_norm_bwd_kernel`` + ``exact_norm_wgrad_kernel`` against
    autograd of the plain version on the card: dx within 2e-6 of its
    row's scale (max |inv * g * dy|) in float32 and within one bf16 ulp (or
    that bar) in bf16; dgamma/dbeta within 1e-5 of their largest
    magnitude; bitwise equal on a second call; the first rows' dx
    bitwise equal to a call on those rows alone."""
    dt = getattr(torch, dtype)
    x, dy, g, b = _bwd_case(cuda_device, rows, c, rms, groups, dt, rows + c)
    eps = 1e-6 if rms else 1e-5
    before = KN.exact_norm_backward.launches
    dx, dg, db = KN.exact_norm_backward(x, g, b, dy, rms=rms, eps=eps)
    assert KN.exact_norm_backward.launches == before + 2   # dx, then wgrad
    assert dx.dtype == dt and dg.dtype == torch.float32 and dg.shape == g.shape
    again = KN.exact_norm_backward(x, g, b, dy, rms=rms, eps=eps)
    assert torch.equal(again[0], dx) and torch.equal(again[1], dg)
    head = max(8, groups)
    alone = KN.exact_norm_backward(x[:head].contiguous(), g, b,
                                   dy[:head].contiguous(), rms=rms, eps=eps)
    assert torch.equal(alone[0], dx[:head])
    px, pg, pb = KN.exact_norm_backward_plain(x, g, b, dy, rms=rms, eps=eps)
    xf = KN.grouped_rows(x.float(), g).reshape(rows, c)
    gg = g.reshape(-1, c).repeat(rows // groups, 1) if groups > 1 else g
    mu = 0 if rms else xf.mean(-1, keepdim=True)
    inv = torch.rsqrt(torch.square(xf - mu).mean(-1, keepdim=True) + eps)
    scale = (inv * gg * dy.float()).abs().amax(-1, keepdim=True)
    bar = 2e-6 * scale
    if dt == torch.bfloat16:
        ulp = torch.exp2(torch.floor(torch.log2(
            px.float().abs().clamp_min(2.0 ** -126))) - 7)
        bar = torch.maximum(bar, ulp)
    assert ((dx.float() - px.float()).abs() <= bar).all()
    assert (dg - pg).abs().max() <= 1e-5 * pg.abs().max()
    if not rms:
        assert torch.equal(again[2], db)
        assert (db - pb).abs().max() <= 1e-5 * pb.abs().max()


def test_exact_norm_autograd_runs_the_backward_kernel(cuda_device):
    """Autograd through ``exact_norm`` on CUDA tensors that require grad
    launches the forward kernel once and the backward's two kernels once
    per call, and gives what ``exact_norm_backward`` gives; without grad the forward
    alone runs (the serve path), with the same bits."""
    x, dy, g, b = _bwd_case(cuda_device, 40, 896, False, 1, torch.bfloat16, 5)
    xs, gs, bs = (t.clone().requires_grad_(True) for t in (x, g, b))
    f0, b0 = KN.exact_norm.launches, KN.exact_norm_backward.launches
    out = KN.exact_norm(xs, gs, bs, rms=False, eps=1e-5,
                        out_dtype=torch.bfloat16)
    grads = torch.autograd.grad(out, (xs, gs, bs), dy)
    assert KN.exact_norm.launches == f0 + 1
    assert KN.exact_norm_backward.launches == b0 + 2
    want = KN.exact_norm_backward(x, g, b, dy, rms=False, eps=1e-5)
    for a, w in zip(grads, want):
        assert torch.equal(a, w)
    with torch.no_grad():
        plain = KN.exact_norm(x, g, b, rms=False, eps=1e-5,
                              out_dtype=torch.bfloat16)
    assert torch.equal(plain, out.detach())


# widths on each side of every team-size step of the exact norm's kernels
# (4, 8, ..., 1,024 units of 8 channels; past 1,024 units the streamed
# instantiation), and one that is not a multiple of 8 (the scalar path)
EXACT_WIDTHS = (32, 40, 64, 72, 256, 264, 1024, 1032, 2048, 2056, 4096, 4104,
                8192, 8200, 1001)


@pytest.mark.parametrize("rms", [True, False])
@pytest.mark.parametrize("c", EXACT_WIDTHS)
def test_exact_norm_rows_stable_across_team_sizes(cuda_device, c, rms):
    """At every team size and on both sides of each step, the forward
    gives each row the same bits at 1, 8, 40 and 300 rows and alone
    (bf16 rows; float32 and bf16 out), and is within 1e-5 of the scale of
    the plain torch ops."""
    gen = torch.Generator(device=cuda_device).manual_seed(c + rms)
    x = (torch.randn((300, c), generator=gen, device=cuda_device) * 3
         + torch.randn((300, 1), generator=gen, device=cuda_device)).to(
             torch.bfloat16)
    g = 1 + 0.1 * torch.randn((c,), generator=gen, device=cuda_device)
    b = None if rms else 0.1 * torch.randn((c,), generator=gen,
                                           device=cuda_device)
    full = KN.exact_norm(x, g, b, rms=rms, eps=1e-5)
    for rows in (1, 8, 40):
        assert torch.equal(KN.exact_norm(x[:rows], g, b, rms=rms, eps=1e-5),
                           full[:rows])
    for i in (0, 7, 299):
        assert torch.equal(KN.exact_norm(x[i:i + 1], g, b, rms=rms,
                                         eps=1e-5)[0], full[i])
    half = KN.exact_norm(x, g, b, rms=rms, eps=1e-5, out_dtype=torch.bfloat16)
    assert torch.equal(half, full.to(torch.bfloat16))
    ref = KN.exact_norm_plain(x, g, b, rms=rms, eps=1e-5)
    torch.cuda.synchronize()
    assert (full - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c,rms", [(896, True), (6144, False), (8200, True)])
def test_exact_norm_misaligned_rows_equal_aligned(cuda_device, c, rms, dtype):
    """Rows read from a storage offset that is not 16-byte aligned (the
    kernels' scalar path) give the bits of the same rows in an aligned
    call (the vector path), forward and backward."""
    dt = getattr(torch, dtype)
    x, dy, g, b = _bwd_case(cuda_device, 40, c, rms, 1, dt, c)
    buf = torch.empty(40 * c + 1, dtype=dt, device=cuda_device)
    xm = buf[1:].view(40, c)
    xm.copy_(x)
    assert xm.data_ptr() % 16 != 0
    eps = 1e-6 if rms else 1e-5
    assert torch.equal(KN.exact_norm(xm, g, b, rms=rms, eps=eps),
                       KN.exact_norm(x, g, b, rms=rms, eps=eps))
    assert torch.equal(KN.exact_norm(xm[5:6], g, b, rms=rms, eps=eps),
                       KN.exact_norm(x, g, b, rms=rms, eps=eps)[5:6])
    mis = KN.exact_norm_backward(xm, g, b, dy, rms=rms, eps=eps)
    want = KN.exact_norm_backward(x, g, b, dy, rms=rms, eps=eps)
    for a, w in zip(mis, want):
        assert (a is None and w is None) or torch.equal(a, w)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c,rms", [(896, True), (2048, False), (6144, False)])
def test_exact_norm_backward_rows_stable_under_the_plan(cuda_device, c, rms,
                                                        dtype):
    """The backward's dx of the first 1, 8 and 40 rows of an 8,192-row
    call, each chunked by its own plan, bitwise equal to the same rows of
    the full call."""
    dt = getattr(torch, dtype)
    x, dy, g, b = _bwd_case(cuda_device, 8192, c, rms, 1, dt, 7 + c)
    eps = 1e-6 if rms else 1e-5
    full = KN.exact_norm_backward(x, g, b, dy, rms=rms, eps=eps)[0]
    for rows in (1, 8, 40):
        assert KN.bwd_plan(rows, c, 1) != KN.bwd_plan(8192, c, 1)
        dx = KN.exact_norm_backward(x[:rows].contiguous(), g, b,
                                    dy[:rows].contiguous(), rms=rms,
                                    eps=eps)[0]
        assert torch.equal(dx, full[:rows])


@pytest.mark.parametrize("rms", [True, False])
@pytest.mark.parametrize("c", [64, 896, 2048, 6144, 8200, 1001])
def test_exact_norm_forward_and_backward_share_the_statistics(cuda_device, c,
                                                              rms):
    """One row, gamma 1 (beta 0) and dy 1: dgamma is the sum of x-hat over
    that row alone, so it equals the forward's float32 output bit for bit
    only if the backward recomputes mu and 1/sqrt(var + eps) with the
    forward's bits."""
    gen = torch.Generator(device=cuda_device).manual_seed(c)
    for dt in (torch.float32, torch.bfloat16):
        x = (torch.randn((1, c), generator=gen, device=cuda_device) * 3
             + 0.5).to(dt)
        g = torch.ones(c, device=cuda_device)
        b = None if rms else torch.zeros(c, device=cuda_device)
        fwd = KN.exact_norm(x, g, b, rms=rms, eps=1e-5)
        dg = KN.exact_norm_backward(x, g, b, torch.ones_like(x), rms=rms,
                                    eps=1e-5)[1]
        assert torch.equal(dg, fwd[0])


def test_kernels_without_a_backward_refuse_inputs_that_require_grad(
        cuda_device):
    """Every other hand kernel raises when grad mode is on and an input
    requires grad, instead of cutting the graph; under ``no_grad`` it
    runs. (The int8 GEMM's inputs are int8, which cannot require grad;
    its wrapper holds the same check.)"""
    dev = cuda_device
    x = torch.randn(8, 896, device=dev, requires_grad=True)
    g = torch.ones(896, device=dev)
    calls = {
        "calibrated_norm": lambda: KN.calibrated_norm(x, None, g, rms=True),
        "ailayernorm qnorm": lambda: KN.qnorm(
            x, torch.ones(1, device=dev), torch.zeros(896, dtype=torch.int32,
                                                      device=dev), g,
            rms=True),
        "e2softmax": lambda: KE.e2softmax(x),
        "flash_e2softmax": lambda: KA.flash_e2softmax(
            x.reshape(1, 8, 896)[..., :64].contiguous(),
            x.detach().reshape(1, 8, 896)[..., :64].contiguous(),
            x.detach().reshape(1, 8, 896)[..., :64].contiguous()),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="no backward kernel"):
            call()
        with torch.no_grad():
            call()
    q = torch.randn(1, 14, 1, 64, device=dev, requires_grad=True)
    pool = torch.zeros(4, 16, 2, 64, device=dev)
    with pytest.raises(RuntimeError, match="no backward kernel"):
        KA.flash_e2softmax_paged(
            q, pool, pool, torch.ones(1, 1, dtype=torch.int32, device=dev),
            torch.tensor([[0, 1]], dtype=torch.int32, device=dev),
            causal=False)


def test_sole_train_config_fails_loudly_on_card(cuda_device):
    """A train step whose train-phase norm is SOLE reaches the
    calibrating norm with masters that require grad: it raises."""
    from repro_torch.train.trainer import batch_to_device, loss_and_grads
    from repro_torch.data.pipeline import make_batch
    from repro_torch.configs.base import ShapeConfig
    cfg = dataclasses.replace(get_config("qwen2_0_5b").smoke(),
                              train_norm_mode="sole")
    masters = api.init_params(0, cfg, cuda_device, masters=True)
    b = batch_to_device(make_batch(cfg, ShapeConfig("s", 16, 2, "train"), 0),
                        cuda_device)
    with pytest.raises(RuntimeError, match="no backward kernel"):
        loss_and_grads(masters, b, cfg)


@pytest.mark.parametrize("arch", ["qwen2_0_5b", "mixtral_8x7b", "rwkv6_7b",
                                  "recurrentgemma_9b", "whisper_small",
                                  "qwen2_vl_7b"])
def test_smoke_train_step_on_card_matches_cpu(cuda_device, arch):
    """One smoke train step (float32 masters, remat dots) through the
    kernels against the CPU: loss within 1e-4 and the grad norm within
    1e-3 relative (cuBLAS and the CPU sum in other orders); the exact
    norm's backward kernel ran."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import make_batch
    from repro_torch.models.state import tree_map
    from repro_torch.train.optimizer import global_norm
    from repro_torch.train.trainer import batch_to_device, loss_and_grads
    cfg = get_config(arch).smoke()
    masters = api.init_params(0, cfg, "cpu", masters=True)
    b = make_batch(cfg, ShapeConfig("s", 32, 4, "train"), 0)
    res = []
    before = KN.exact_norm_backward.launches
    for dev in ("cpu", "cuda"):
        loss, _, grads = loss_and_grads(
            tree_map(lambda t: t.to(dev), masters), batch_to_device(b, dev),
            cfg)
        res.append((loss.item(), global_norm(grads).item()))
    assert KN.exact_norm_backward.launches > before
    (lc, gc), (lg, gg) = res
    assert abs(lg - lc) <= 1e-4 * abs(lc)
    assert abs(gg - gc) <= 1e-3 * gc


def test_trainer_recovers_from_a_failure_on_card(cuda_device, tmp_path):
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.trainer import Trainer
    tr = Trainer(get_config("qwen2_0_5b").smoke(),
                 ShapeConfig("s", 64, 8, "train"),
                 OptConfig(lr=1e-2, warmup_steps=5, total_steps=60),
                 device=cuda_device, ckpt_dir=str(tmp_path), ckpt_every=5)
    out = tr.run(12, fail_at=8)
    steps = [m["step"] for m in out["metrics"]]
    assert steps == list(range(8)) + list(range(5, 12))
    first = {m["step"]: m["loss"] for m in out["metrics"][:8]}
    for m in out["metrics"][8:11]:
        assert m["loss"] == first[m["step"]]
