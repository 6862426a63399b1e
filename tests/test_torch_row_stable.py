"""Row stability of the speculative verify against plain decode, on the
CPU (the card's side is in ``tests/test_torch_cuda.py``):

* verify's attention runs its B x C rows as single-row decode queries
  (``layers.paged_attend(..., rows_as_decode=True)``): the op sees C = 1
  rows with no causal mask, each row keyed ``min(q_start + j + 1,
  kv_len)`` (a padded row sees the lane's keys, as under the causal
  mask), its lane's table repeated. On the CPU the plain version then
  computes each valid row as the decode step at its position does, and
  the whole (B, C) output as the causal chunk route (the same function;
  float32 sums in other batch shapes: 1e-6);
* ``verify_paged`` reaches the decode route and nothing else, with the
  drop-free MoE FFN too;
* the exact-mode norms' card adapters (the exact-norm kernel and the
  torch add and ``quantize_act`` around it) compute on CPU tensors what
  the reference backend computes, bit for bit.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import ops
from repro_torch.configs.base import get_config
from repro_torch.kernels import ailayernorm as KN
from repro_torch.kernels import flash_e2softmax as KA
from repro_torch.models import api
from repro_torch.models import layers as L
from repro_torch.ops import reference as R

EXACT = dict(softmax_mode="exact", norm_mode="exact", logit_int8=False)


def _verify_batch(cfg, seed=0):
    """4 lanes x C = 5: full, ragged (n_valid 3), one-token, null."""
    rng = np.random.default_rng(seed)
    n, bs = 40, 8
    shape = (n, bs, cfg.n_kv_heads, cfg.head_dim)
    pk, pv = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
              for _ in range(2))
    q_start = torch.tensor([13, 20, 6, 0], dtype=torch.int32)
    n_valid = torch.tensor([5, 3, 1, 1], dtype=torch.int32)
    tables = np.zeros((4, 8), np.int32)
    pages = rng.permutation(np.arange(1, n))
    for i in range(3):
        used = -(-int(q_start[i] + n_valid[i]) // bs)
        tables[i, :used] = pages[8 * i:8 * i + used]
    q = torch.from_numpy(rng.standard_normal(
        (4, 5, cfg.n_heads, cfg.head_dim)).astype(np.float32))
    return q, pk, pv, torch.from_numpy(tables), q_start, n_valid


@pytest.mark.parametrize("mode", ["exact", "sole"])
@pytest.mark.parametrize("arch", ["qwen2_0_5b", "minitron_8b"])
def test_verify_rows_take_the_decode_route(arch, mode, monkeypatch):
    cfg = get_config(arch).smoke()
    if mode == "exact":
        cfg = dataclasses.replace(cfg, **EXACT)
    q, pk, pv, tables, q_start, n_valid = _verify_batch(cfg)
    kv_len = q_start + n_valid
    seen = []
    plain = KA.flash_e2softmax_paged_plain

    def spy(q_, *a, **kw):
        seen.append((tuple(q_.shape), kw["causal"], a[3][:, 1].tolist()))
        return plain(q_, *a, **kw)

    monkeypatch.setattr(R, "flash_e2softmax_paged_plain", spy)
    rows = L.paged_attend(q, pk, pv, tables, q_start, kv_len, cfg,
                          causal=True, rows_as_decode=True)
    monkeypatch.undo()
    (shape, causal, lens), = seen
    assert shape == (20, cfg.n_heads, 1, cfg.head_dim) and not causal
    assert lens == [14, 15, 16, 17, 18, 21, 22, 23, 23, 23,
                    7, 7, 7, 7, 7, 1, 1, 1, 1, 1]
    chunk = L.paged_attend(q, pk, pv, tables, q_start, kv_len, cfg,
                           causal=True)
    torch.testing.assert_close(rows, chunk, rtol=1e-6, atol=1e-6)
    for i in range(4):
        for j in range(int(n_valid[i])):
            pos = q_start[i:i + 1] + j
            dec = L.paged_attend(q[i:i + 1, j:j + 1], pk, pv,
                                 tables[i:i + 1], pos, pos + 1, cfg,
                                 causal=False)
            torch.testing.assert_close(rows[i, j], dec[0, 0], rtol=1e-6,
                                       atol=1e-6)


@pytest.mark.parametrize("arch", ["qwen2_0_5b", "mixtral_8x7b"])
def test_verify_paged_attends_through_the_decode_route(arch, monkeypatch):
    """One paged-attention call per layer, every one C = 1 rows without a
    causal mask, for a dense and an MoE model."""
    cfg = dataclasses.replace(get_config(arch).smoke(), **EXACT)
    params = api.init_params(0, cfg, "cpu")
    q, _, _, tables, q_start, n_valid = _verify_batch(cfg)
    pools = {k: torch.zeros((cfg.n_layers, 40, 8, cfg.n_kv_heads,
                             cfg.head_dim)) for k in ("k", "v")}
    calls = []
    real = L.paged_attend

    def spy(q_, *a, causal, rows_as_decode=False):
        calls.append((q_.shape[1], causal, rows_as_decode))
        return real(q_, *a, causal=causal, rows_as_decode=rows_as_decode)

    monkeypatch.setattr(L, "paged_attend", spy)
    tokens = torch.randint(0, cfg.vocab_size, (4, 5), dtype=torch.int32)
    pinned, done, _ = api.verify_paged(
        params, tokens, q_start, n_valid, {"tables": tables}, pools, None,
        None, None, None, torch.full((4, 1), -1, dtype=torch.int32), cfg,
        use_top_k=False, stochastic=False)
    assert calls == [(5, True, True)] * cfg.n_layers
    assert pinned.shape == (4, 5) and not done.any()


@pytest.mark.parametrize("kind", ["layernorm", "rmsnorm"])
@pytest.mark.parametrize("quant_out", [False, True])
def test_exact_norm_card_adapters_equal_reference_on_cpu(kind, quant_out):
    op = f"residual_{kind}" + ("_q" if quant_out else "")
    ref, card = (ops.resolve(op, "exact", b) for b in ("reference", "cuda"))
    rng = np.random.default_rng(3)
    x, r = (torch.from_numpy(rng.standard_normal((2, 7, 96)).astype(
        np.float32)).bfloat16() for _ in range(2))
    g = torch.from_numpy(rng.uniform(0.5, 1.5, 96).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(96).astype(np.float32))
    launches = KN.exact_norm.launches
    s1, o1 = ref(x, r, g, b)
    s2, o2 = card(x, r, g, b)
    assert torch.equal(s1, s2)
    if quant_out:
        assert torch.equal(o1[0], o2[0]) and torch.equal(o1[1], o2[1])
    else:
        assert torch.equal(o1, o2)
        assert torch.equal(card(x, r, g, b, out_dtype=torch.bfloat16)[1],
                           o1.to(torch.bfloat16))
    plain = ops.resolve(kind, "exact", "cuda")
    args = (x, g) if kind == "rmsnorm" else (x, g, b)
    assert torch.equal(plain(*args), ops.resolve(kind, "exact",
                                                 "reference")(*args))
    assert KN.exact_norm.launches == launches      # CPU: the plain version
