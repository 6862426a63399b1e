"""Reference backend: plain torch versions of the ops this slice serves.

Signatures match the JAX package's registry:

  layernorm(x, gamma, beta)            rmsnorm(x, gamma)
  residual_layernorm(x, r, gamma, beta) -> (x + r, norm(x + r))
  residual_rmsnorm(x, r, gamma)         -> (x + r, norm(x + r))
  paged_attention(q, pool_k, pool_v, tables, q_start, kv_len, *, causal, ...)

The paged attention here is the paged kernel's own plain version — one
online update per page — not the reference package's gather-and-two-pass
oracle: in SOLE mode the quantized correction is applied once per page,
so the two differ as soon as a sequence spans more than one page.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.sole.ailayernorm import ailayernorm, airmsnorm
from repro_torch.kernels.flash_e2softmax import (default_kv_head_map,
                                                 flash_e2softmax_paged_plain)
from repro_torch.ops import registry


@registry.register("layernorm", "exact", "reference")
def exact_layernorm(x, gamma, beta, *, eps=1e-5, **kw):
    x = x.float()
    mu = x.mean(-1, keepdim=True)
    var = torch.square(x - mu).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * gamma + beta


@registry.register("rmsnorm", "exact", "reference")
def exact_rmsnorm(x, gamma, *, eps=1e-6, **kw):
    x = x.float()
    ms = torch.square(x).mean(-1, keepdim=True)
    return x * torch.rsqrt(ms + eps) * gamma


@registry.register("layernorm", "sole", "reference")
def sole_layernorm(x, gamma, beta, **kw):
    return ailayernorm(x, gamma, beta, **kw)


@registry.register("rmsnorm", "sole", "reference")
def sole_rmsnorm(x, gamma, **kw):
    return airmsnorm(x, gamma, **kw)


def _residual_norm(norm_mode: str, kind: str):
    def fn(x, r, gamma, beta=None, **kw):
        s = x + r
        if kind == "layernorm":
            out = registry.resolve("layernorm", norm_mode, "reference")(
                s, gamma, beta, **kw)
        else:
            out = registry.resolve("rmsnorm", norm_mode, "reference")(
                s, gamma, **kw)
        return s, out
    return fn


for _mode in ("exact", "sole"):
    registry.register("residual_layernorm", _mode, "reference")(
        _residual_norm(_mode, "layernorm"))
    registry.register("residual_rmsnorm", _mode, "reference")(
        _residual_norm(_mode, "rmsnorm"))


def paged_meta(q_start, kv_len) -> torch.Tensor:
    """(B, 2) int32 rows (q_start, kv_len) — the paged kernel's metadata."""
    return torch.stack([q_start.to(torch.int32), kv_len.to(torch.int32)], 1)


def _paged_attention_ref(sole: bool):
    def fn(q, pool_k, pool_v, tables, q_start, kv_len, *, causal: bool,
           exp_bits: int = 4, int8_scale: Optional[float] = None,
           kv_head_map=None, **kw):
        """q (B, C, H, hd); pools (N, bs, KV, hd); tables (B, NB);
        q_start/kv_len (B,) -> (B, C, H, hd) in q.dtype."""
        if kv_head_map is None:
            kv_head_map = default_kv_head_map(q.shape[2], pool_k.shape[2],
                                              q.device)
        ctx = flash_e2softmax_paged_plain(
            q.transpose(1, 2), pool_k, pool_v, tables,
            paged_meta(q_start, kv_len), kv_head_map, causal=causal,
            sole=sole, exp_bits=exp_bits, int8_scale=int8_scale)
        return ctx.transpose(1, 2).to(q.dtype)
    return fn


registry.register("paged_attention", "exact", "reference")(
    _paged_attention_ref(sole=False))
registry.register("paged_attention", "sole", "reference")(
    _paged_attention_ref(sole=True))
