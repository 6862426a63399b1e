"""The facts the paged kernel's tensor-core design rests on, held on the
CPU through the kernel's plain version (``flash_e2softmax_paged_plain``).

* Int8 pools: kv_scale is a power of two (1/16 on the serve path), so the
  kernel multiplies it into the float32 logits after Q.K^T on the raw
  codes, and into the final row scale instead of V, in both ``quant_pv``
  settings. Scaling by a power of two commutes with every float32
  rounding (barring underflow), so both placements give the plain
  version's output bit for bit.
* Any tiling of the rows gives the same function: a page a row cannot see
  is the identity for it, so running every row over the pages of the
  chunk's last row (what a row tile does) equals running each row over
  its own pages (up to the plain version's own summation order).
* ``paged_variant`` names the instantiation ``mma_variant`` picks.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_e2softmax as KA
from repro_torch.models.layers import KV_INT8_SCALE, LOGIT_INT8_SCALE


def _case(seed, *, b=3, h=6, kvh=2, c=1, d=64, bs=16, nb=6):
    rng = np.random.default_rng(seed)
    n = b * nb + 1
    q = torch.from_numpy(rng.standard_normal((b, h, c, d)).astype(np.float32))
    k = torch.from_numpy(rng.integers(-127, 128, (n, bs, kvh, d))
                         .astype(np.int8))
    v = torch.from_numpy(rng.integers(-127, 128, (n, bs, kvh, d))
                         .astype(np.int8))
    tables = torch.from_numpy(rng.permutation(np.arange(1, n))
                              .reshape(b, nb).astype(np.int32))
    kv = rng.integers(c, nb * bs + 1, b)
    meta = torch.from_numpy(np.stack([kv - c, kv], 1).astype(np.int32))
    kvmap = torch.from_numpy(rng.permutation(np.arange(h) % kvh)
                             .astype(np.int32))
    return q, k, v, tables, meta, kvmap


@pytest.mark.parametrize("sole", [False, True], ids=["exact", "sole"])
def test_kv_scale_after_the_products_is_exact(sole):
    """Raw V codes with kv_scale in the final row scale (``quant_pv``)
    equal V dequantized first, bit for bit; and the logits of the raw K
    codes times kv_scale equal the logits of the dequantized K."""
    q, k, v, tables, meta, kvmap = _case(1, c=5)
    kw = dict(causal=True, sole=sole, exp_bits=4,
              int8_scale=LOGIT_INT8_SCALE if sole else None,
              kv_scale=KV_INT8_SCALE)
    deq = KA.flash_e2softmax_paged_plain(q, k, v, tables, meta, kvmap,
                                         quant_pv=False, **kw)
    raw = KA.flash_e2softmax_paged_plain(q, k, v, tables, meta, kvmap,
                                         quant_pv=True, **kw)
    assert torch.equal(raw, deq)
    qf = q * 64 ** -0.5
    codes = torch.einsum("bhcd,ntd->bhcnt", qf, k[:, :, 0].float())
    scaled = torch.einsum("bhcd,ntd->bhcnt", qf,
                          k[:, :, 0].float() * KV_INT8_SCALE)
    assert torch.equal(codes * KV_INT8_SCALE, scaled)


@pytest.mark.parametrize("sole", [False, True], ids=["exact", "sole"])
def test_row_tiles_see_the_same_function(sole):
    """A causal chunk computed at once equals each of its rows computed
    alone (a decode-like call at that row's position): the pages a row
    cannot see change nothing for it. Tolerance 1e-5 of the output scale,
    as the card tests hold the kernel to the plain version: the plain
    version's einsum sums in an order that follows the call's shape, and
    exact mode's weights carry all their bits into those sums."""
    q, k, v, tables, meta, kvmap = _case(2, c=24, b=2, nb=4)
    kv = meta[:, 1]
    kw = dict(causal=True, sole=sole, exp_bits=4,
              int8_scale=LOGIT_INT8_SCALE if sole else None,
              kv_scale=KV_INT8_SCALE)
    whole = KA.flash_e2softmax_paged_plain(q, k, v, tables, meta, kvmap, **kw)
    for r in range(q.shape[2]):
        pos = meta[:, 0] + r
        one = KA.flash_e2softmax_paged_plain(
            q[:, :, r:r + 1].contiguous(), k, v, tables,
            torch.stack([pos, torch.minimum(pos + 1, kv)], 1).int(), kvmap,
            **kw)
        torch.testing.assert_close(one[:, :, 0], whole[:, :, r], rtol=0,
                                   atol=1e-5 * whole.abs().max().item())


def test_paged_variant():
    bf, f32, i8 = torch.bfloat16, torch.float32, torch.int8
    mma = "bf16 mma.sync tensor cores"
    assert KA.paged_variant(bf, bf, 64, 16) == mma
    assert KA.paged_variant(bf, bf, 16, 16) == mma             # padded to 64
    assert KA.paged_variant(bf, i8, 64, 16, KV_INT8_SCALE) == mma
    assert KA.paged_variant(bf, i8, 64, 16, 0.1) == "CUDA cores"
    assert KA.paged_variant(bf, bf, 32, 16) == "CUDA cores"    # 32^-1/2
    assert KA.paged_variant(bf, bf, 64, 8) == "CUDA cores"     # page size
    assert KA.paged_variant(bf, i8, 4, 16, KV_INT8_SCALE) == "CUDA cores"
    assert KA.paged_variant(f32, f32, 64, 16) == "CUDA cores"
    assert KA.paged_variant(bf, bf, 64, 16, aligned=False) == "CUDA cores"


@pytest.mark.parametrize("d", [128, 256])
def test_paged_variant_wide_heads(d):
    """Head dims 128 (minitron, nemotron, mixtral, dbrx: q in three bf16
    parts) and 256 (recurrentgemma: d^-1/2 = 1/16) take the tensor cores
    over bf16 pools and int8 pools with a power-of-two kv_scale, at
    16-token pages; float32, 8-token pages and other scales stay on the
    CUDA cores, as do head dims between 128 and 256."""
    bf, f32, i8 = torch.bfloat16, torch.float32, torch.int8
    mma = "bf16 mma.sync tensor cores"
    assert KA.paged_variant(bf, bf, d, 16) == mma
    assert KA.paged_variant(bf, i8, d, 16, KV_INT8_SCALE) == mma
    assert KA.paged_variant(bf, i8, d, 16, 0.1) == "CUDA cores"
    assert KA.paged_variant(bf, bf, d, 8) == "CUDA cores"
    assert KA.paged_variant(bf, i8, d, 8, KV_INT8_SCALE) == "CUDA cores"
    assert KA.paged_variant(f32, f32, d, 16) == "CUDA cores"
    assert KA.paged_variant(bf, bf, d, 16, aligned=False) == "CUDA cores"
    assert KA.paged_variant(bf, bf, d + 64, 16) == "CUDA cores"
