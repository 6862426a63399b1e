"""``repro_torch.ops`` — the op backend of the port, keyed by
``(op, mode, backend)`` like the JAX package's ``repro.ops``.

The ``*_fn`` helpers resolve the backend from the device the tensors
live on and the caller's ``backend`` choice (``auto`` by default;
:func:`registry.backend_for`)::

    p    = ops.softmax_fn(mode, x.device)(logits, mask=mask)
    h    = ops.rmsnorm_fn(mode, x.device)(x, gamma)
    o    = ops.flash_attention_fn(mode, q.device)(q, k, v, causal=True)
    x, h = ops.residual_norm_fn("rmsnorm", mode, x.device)(x, r, gamma)
    y    = ops.matmul_fn("w8a8", q.device)((q, scale), w, n_contract=1)
"""
from __future__ import annotations

from typing import Callable

from repro_torch.ops.registry import (ATTN_MODES, BACKENDS, CHOICES,
                                      MATMUL_MODES, MODES_BY_OP, NORM_MODES,
                                      OPS,
                                      SOFTMAX_MODES, backend_for,
                                      is_registered, register, resolve)
from repro_torch.ops import reference  # registers the reference backend
from repro_torch.ops import cuda       # registers the cuda backend
from repro_torch.ops.reference import snap_logits

__all__ = [
    "OPS", "BACKENDS", "CHOICES", "SOFTMAX_MODES", "NORM_MODES", "ATTN_MODES",
    "MATMUL_MODES", "MODES_BY_OP", "register", "resolve",
    "is_registered", "backend_for", "snap_logits", "softmax_fn",
    "layernorm_fn", "rmsnorm_fn",
    "residual_norm_fn", "residual_norm_q_fn", "matmul_fn",
    "flash_attention_fn", "paged_attention_fn", "reference", "cuda",
]


def _fn(op: str, mode: str, device, backend: str) -> Callable:
    return resolve(op, mode, backend_for(op, mode, device, backend))


def softmax_fn(mode: str, device, backend: str = "auto") -> Callable:
    """softmax(x, axis=-1, mask=None, ...) for the given mode."""
    return _fn("softmax", mode, device, backend)


def layernorm_fn(mode: str, device, backend: str = "auto") -> Callable:
    """layernorm(x, gamma, beta) for the given mode."""
    return _fn("layernorm", mode, device, backend)


def rmsnorm_fn(mode: str, device, backend: str = "auto") -> Callable:
    """rmsnorm(x, gamma) for the given mode."""
    return _fn("rmsnorm", mode, device, backend)


def residual_norm_fn(kind: str, mode: str, device,
                     backend: str = "auto") -> Callable:
    """(x, r, gamma[, beta]) -> (x + r, norm(x + r))."""
    if kind not in ("layernorm", "rmsnorm"):
        raise ValueError(f"unknown norm kind {kind!r}")
    return _fn(f"residual_{kind}", mode, device, backend)


def residual_norm_q_fn(kind: str, mode: str, device,
                       backend: str = "auto") -> Callable:
    """(x, r, gamma[, beta]) -> (x + r, (int8 codes, per-row scale)): the
    residual norm whose output leaves as per-row int8 for the next w8a8
    matmul."""
    if kind not in ("layernorm", "rmsnorm"):
        raise ValueError(f"unknown norm kind {kind!r}")
    return _fn(f"residual_{kind}_q", mode, device, backend)


def matmul_fn(mode: str, device, backend: str = "auto") -> Callable:
    """(x, w, *, n_contract) serve-path matmul: exact | w8a16 | w8a8."""
    return _fn("matmul", mode, device, backend)


def flash_attention_fn(mode: str, device, backend: str = "auto") -> Callable:
    """(q, k, v, *, causal, ...) fused-softmax attention in model layout:
    q (B, S, H, hd), k/v (B, T, KV, hd) -> (B, S, H, hd)."""
    return _fn("flash_attention", mode, device, backend)


def paged_attention_fn(mode: str, device, backend: str = "auto") -> Callable:
    """(q, pool_k, pool_v, tables, q_start, kv_len, *, causal, ...) paged
    attention for the continuous-batching engine."""
    return _fn("paged_attention", mode, device, backend)
