"""The row-stable product route of decode and verify dispatches
(``layers.stable_mm`` and the ``stable=`` forms of the projections, the
MLP, the head and the MoE FFN), on the CPU.

On the card every bf16 or float32 product of a decode or verify dispatch
runs on ``ROW_TILE`` zero-padded rows (cuBLAS picks its kernel by M, so
rows of an 8-row and a 40-row product would round apart); the card tests
(``tests/test_torch_cuda.py``) hold the rows bitwise there. Here the
route is called directly, since the engines take it only on CUDA tensors
(on the CPU their products keep the reference's forms, which the parity
tests against JAX hold):

* each row of ``stable_mm`` and of the drop-free MoE FFN is bitwise the
  same whatever the row count (M 1, 8, 40, 72; T 8, 40) and wherever the
  row sits: one product shape per (N, K);
* the stable forms compute what the plain forms compute (float32, 1e-6
  of the output: other summation shapes);
* a paged forward on CPU tensors never takes the route.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_config
from repro_torch.models import api
from repro_torch.models import layers as L
from repro_torch.models import moe as M

ROWS = (1, 8, 40, 72)


def _rows(rng, m, k, dtype):
    return torch.from_numpy(rng.standard_normal((m, k)).astype(
        np.float32)).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("arch", ["qwen2_0_5b", "mixtral_8x7b"])
def test_stable_mm_rows_do_not_depend_on_m(arch, dtype):
    """The smoke widths' projections (d_model to d_ff, to the heads and
    to the vocabulary): rows of M = 1, 8, 40 and 72 products, in order and
    reversed, bitwise equal to the same rows of the 72-row product."""
    cfg = get_config(arch).smoke()
    rng = np.random.default_rng(0)
    for n in (cfg.d_ff, cfg.n_heads * cfg.head_dim, cfg.vocab_size):
        a = _rows(rng, max(ROWS), cfg.d_model, dtype)
        w = _rows(rng, cfg.d_model, n, dtype)
        full = L.stable_mm(a, w)
        assert full.shape == (max(ROWS), n) and full.dtype == dtype
        for m in ROWS:
            assert torch.equal(L.stable_mm(a[:m], w), full[:m])
            assert torch.equal(L.stable_mm(a[:m].flip(0), w),
                               full[:m].flip(0))
        torch.testing.assert_close(full.float(), (a @ w).float(),
                                   rtol=0, atol=1e-6 if dtype ==
                                   torch.float32 else 2e-2)


def test_stable_forms_compute_the_plain_forms():
    """``_project_qkv``, ``_wo_proj``, ``apply_mlp`` and ``lm_logits`` with
    ``stable=True`` against their plain forms on float32 smoke weights:
    the same shapes and values to 1e-6 of the output."""
    cfg = get_config("qwen2_0_5b").smoke()
    params = api.init_params(0, cfg, "cpu")
    lay = {k: {n: t[0] for n, t in v.items()} if isinstance(v, dict)
           else v for k, v in params["layers"].items()}
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((8, 5, cfg.d_model)).astype(
        np.float32))
    ctx = torch.from_numpy(rng.standard_normal(
        (8, 5, cfg.n_heads, cfg.head_dim)).astype(np.float32))

    def close(a, b):
        assert a.shape == b.shape
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=1e-6 * b.abs().max().item())
    for a, b in zip(L._project_qkv(lay["attn"], x, cfg, stable=True),
                    L._project_qkv(lay["attn"], x, cfg)):
        close(a, b)
    close(L._wo_proj(ctx, lay["attn"], cfg, stable=True),
          L._wo_proj(ctx, lay["attn"], cfg))
    close(L.apply_mlp(x, lay["mlp"], cfg, stable=True),
          L.apply_mlp(x, lay["mlp"], cfg))
    close(L.lm_logits(params["embed"], x, cfg, stable=True),
          L.lm_logits(params["embed"], x, cfg))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_ffn_rows_do_not_depend_on_t(dtype):
    """The drop-free MoE FFN (mixtral smoke: 4 experts, top 2) with the
    stable route: each of 8 tokens gives the same bits alone in a T = 8
    batch and among 40 tokens (other slots in every expert's buffer, the
    capacity rounded up to ROW_TILE either way), and 72 tokens (two tiles
    of capacity) give the 40's bits; the route computes the plain FFN's
    values (1e-6 of the output in float32)."""
    cfg = dataclasses.replace(get_config("mixtral_8x7b").smoke(), dtype=dtype)
    params = api.init_params(0, cfg, "cpu")
    p = {n: t[0] for n, t in params["layers"]["mlp"].items()}
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((72, cfg.d_model)).astype(
        np.float32)).to(L.torch_dtype(dtype))

    def ffn(rows):
        return M._paged_ffn(p, rows[None], cfg, "serve", stable=True)[0]
    few, many, most = ffn(x[:8]), ffn(x[32:72]), ffn(x)
    assert torch.equal(few, ffn(x[:8].flip(0)).flip(0))
    assert torch.equal(many[:8], ffn(x[32:40]))
    assert torch.equal(most[32:72], many)
    assert torch.equal(most[:8], few)
    if dtype == "float32":
        plain = M._paged_ffn(p, x[None], cfg, "serve")[0]
        torch.testing.assert_close(most, plain, rtol=0,
                                   atol=1e-6 * plain.abs().max().item())


@pytest.mark.parametrize("arch", ["qwen2_0_5b", "mixtral_8x7b"])
def test_cpu_paged_forward_keeps_the_plain_products(arch, monkeypatch):
    """A decode step and a verify dispatch on CPU tensors never reach
    ``stable_mm`` or ``pad_rows``: the engines' CPU products stay the
    ones the parity tests hold to JAX."""
    cfg = get_config(arch).smoke()
    params = api.init_params(0, cfg, "cpu")
    called = []
    for name in ("stable_mm", "pad_rows"):
        real = getattr(L, name)
        monkeypatch.setattr(L, name, lambda *a, _r=real, _n=name:
                            called.append(_n) or _r(*a))
    pools = {k: torch.zeros((cfg.n_layers, 16, 8, cfg.n_kv_heads,
                             cfg.head_dim)) for k in ("k", "v")}
    tables = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
    pos = torch.tensor([3, 9], dtype=torch.int32)
    token = torch.tensor([5, 7], dtype=torch.int32)
    logits, _ = api.decode_step_paged(params, token, pos, {"tables": tables},
                                      pools, cfg)
    assert logits.shape == (2, cfg.padded_vocab)
    api.verify_paged(params, token[:, None].repeat(1, 3), pos,
                     torch.tensor([3, 2], dtype=torch.int32),
                     {"tables": tables}, pools, None, None, None, None,
                     torch.full((2, 1), -1, dtype=torch.int32), cfg,
                     use_top_k=False, stochastic=False)
    assert called == []
