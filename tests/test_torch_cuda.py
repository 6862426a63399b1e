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
* quantize+norm: codes and int32 sums are exact and the epilogue rounds
  like the plain ops: 1e-6.
* int8 GEMM: integer sums are exact in any order: bitwise equal.
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
  (and in exact mode exp2's last bit) differ: 1e-5 of the output scale.
  Otherwise the dot order may move a logit across a rounding boundary
  and flip one code: at most 1% of rows off by more than 1e-3.
* fused add+norm: ``h`` is one float32 add, bitwise; the norm as the
  quantize+norm kernel, 1e-6. Quantize-out: codes and scale bitwise equal
  to ``quantize_act`` of the add+norm kernel's output on the same inputs.
* codes entry: integer sums exact, epilogue as the quantize+norm: 1e-6.
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
    args = (xt.float().contiguous(), p.denom(), p.alpha,
            torch.from_numpy(gamma).to(cuda_device),
            torch.from_numpy(0 * beta if rms else beta).to(cuda_device))
    before = KN.qnorm.launches
    out = KN.qnorm(*args, rms=rms)
    assert KN.qnorm.launches == before + 1
    ref = KN.qnorm_plain(*args, rms=rms)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, rtol=1e-6, atol=1e-6)


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
    versions (CPU): both kernels launch, refcounts hold, and at least 95%
    of greedy tokens agree."""
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
        attn0, norm0 = KA.flash_e2softmax_paged.launches, KN.qnorm.launches
        outs.append(eng.generate(reqs))
        eng.cache.check_refcounts()
        if dev == cuda_device:
            assert KA.flash_e2softmax_paged.launches > attn0
            assert (KN.qnorm.launches > norm0) == (mode == "sole")
    pairs = [(a, b) for x, y in zip(*outs) for a, b in zip(x, y)]
    assert all(len(o) == 8 for o in outs[1])
    assert sum(a == b for a, b in pairs) / len(pairs) >= 0.95


# (M, K, N) of every int8 GEMM on the w8a8 path of qwen2_0_5b (M = 8 at a
# decode step, 128 at a prefill chunk), and two ragged shapes.
GEMM_KN = ((896, 896), (896, 128), (896, 4864), (4864, 896), (896, 151936))
GEMM_SHAPES = [(m, k, n) for m in (8, 128) for k, n in GEMM_KN] + [
    (7, 130, 33), (64, 256, 128)]


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
    assert KM.int8_matmul.launches == before + 1
    ref = KM.int8_matmul_plain(x, w)
    torch.cuda.synchronize()
    assert out.dtype == torch.int32 and torch.equal(out, ref)


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
    kernel launches once per layer and the norm kernel 2 * layers + 1
    times, and at least 95% of greedy tokens agree. w8a8 in exact mode
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
        sm0, norm0, mm0 = (KE.e2softmax.launches, KN.qnorm.launches,
                           KM.int8_matmul.launches)
        outs.append(eng.generate(reqs))
        calls = eng.prefill_calls + eng.decode_calls
        if dev == cuda_device:
            if mode == "sole":
                assert KE.e2softmax.launches - sm0 == cfg.n_layers * calls
                assert KN.qnorm.launches - norm0 == (2 * cfg.n_layers + 1) \
                    * calls
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
}


@pytest.mark.parametrize("mode", ["sole", "sole_int8", "sole_exact_corr",
                                  "exact"])
@pytest.mark.parametrize("name", list(FLASH_CASES))
def test_flash_kernel_matches_plain(cuda_device, name, mode):
    """The dense Flash-E2Softmax kernel through the op's cuda adapter
    against its plain version on the same (repeated, folded) inputs."""
    b, s, t, h, kvh, hd, causal, block = FLASH_CASES[name]
    rng = np.random.default_rng(s + t + h)
    q, k, v = _flash_inputs(rng, (b, s, h, hd), (b, t, kvh, hd), True,
                            torch.bfloat16, cuda_device)
    kw = dict(causal=causal, block=block, exp_bits=4,
              int8_scale=LOGIT_INT8_SCALE if mode == "sole_int8" else None,
              exact_corr=mode == "sole_exact_corr")
    op_mode = "exact" if mode == "exact" else "sole"
    assert ops.backend_for("flash_attention", op_mode, cuda_device) == "cuda"
    before = KA.flash_e2softmax.launches
    out = ops.flash_attention_fn(op_mode, cuda_device)(q, k, v, **kw)
    assert KA.flash_e2softmax.launches == before + 1
    assert out.dtype == torch.bfloat16 and out.shape == (b, s, h, hd)
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
    args = (x, r, p.denom(), p.alpha, gamma,
            torch.zeros_like(beta) if rms else beta)
    n0, q0 = KN.add_norm.launches, KN.add_norm_quant.launches
    h, out = KN.add_norm(*args, rms=rms)
    h8, codes, scale = KN.add_norm_quant(*args, rms=rms)
    assert (KN.add_norm.launches, KN.add_norm_quant.launches) == (n0 + 1,
                                                                  q0 + 1)
    h_ref, out_ref = KN.add_norm_plain(*args, rms=rms)
    torch.cuda.synchronize()
    assert torch.equal(h, h_ref) and torch.equal(h8, h_ref)
    torch.testing.assert_close(out, out_ref, rtol=1e-6, atol=1e-6)
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
    quantize+norm and the dense Flash-E2Softmax kernels."""
    from repro_torch.launch import quickstart
    counters = (KE.e2softmax, KN.qnorm, KA.flash_e2softmax)
    before = [f.launches for f in counters]
    assert quickstart.main([]) == 0
    assert all(f.launches > b for f, b in zip(counters, before))
    assert "done." in capsys.readouterr().out
