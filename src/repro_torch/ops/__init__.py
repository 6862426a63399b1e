"""``repro_torch.ops`` — the op backend of the port, keyed by
``(op, mode, backend)`` like the JAX package's ``repro.ops``.

The ``*_fn`` helpers resolve the backend from the device the tensors
live on (:func:`registry.backend_for`)::

    p    = ops.softmax_fn(mode, x.device)(logits, mask=mask)
    h    = ops.rmsnorm_fn(mode, x.device)(x, gamma)
    x, h = ops.residual_norm_fn("rmsnorm", mode, x.device)(x, r, gamma)
    y    = ops.matmul_fn("w8a8", q.device)((q, scale), w, n_contract=1)
"""
from __future__ import annotations

from typing import Callable

from repro_torch.ops.registry import (ATTN_MODES, BACKENDS, MATMUL_MODES,
                                      MODES_BY_OP, NORM_MODES, OPS,
                                      SOFTMAX_MODES, UNPORTED_KERNELS,
                                      backend_for, is_registered, register,
                                      resolve)
from repro_torch.ops import reference  # registers the reference backend
from repro_torch.ops import cuda       # registers the cuda backend
from repro_torch.ops.reference import snap_logits

__all__ = [
    "OPS", "BACKENDS", "SOFTMAX_MODES", "NORM_MODES", "ATTN_MODES",
    "MATMUL_MODES", "MODES_BY_OP", "UNPORTED_KERNELS", "register", "resolve",
    "is_registered", "backend_for", "snap_logits", "softmax_fn",
    "layernorm_fn", "rmsnorm_fn",
    "residual_norm_fn", "residual_norm_q_fn", "matmul_fn",
    "paged_attention_fn", "reference", "cuda",
]


def _fn(op: str, mode: str, device) -> Callable:
    return resolve(op, mode, backend_for(op, mode, device))


def softmax_fn(mode: str, device) -> Callable:
    """softmax(x, axis=-1, mask=None, ...) for the given mode."""
    return _fn("softmax", mode, device)


def layernorm_fn(mode: str, device) -> Callable:
    """layernorm(x, gamma, beta) for the given mode."""
    return _fn("layernorm", mode, device)


def rmsnorm_fn(mode: str, device) -> Callable:
    """rmsnorm(x, gamma) for the given mode."""
    return _fn("rmsnorm", mode, device)


def residual_norm_fn(kind: str, mode: str, device) -> Callable:
    """(x, r, gamma[, beta]) -> (x + r, norm(x + r))."""
    if kind not in ("layernorm", "rmsnorm"):
        raise ValueError(f"unknown norm kind {kind!r}")
    return _fn(f"residual_{kind}", mode, device)


def residual_norm_q_fn(kind: str, mode: str, device) -> Callable:
    """(x, r, gamma[, beta]) -> (x + r, (int8 codes, per-row scale)): the
    residual norm whose output leaves as per-row int8 for the next w8a8
    matmul."""
    if kind not in ("layernorm", "rmsnorm"):
        raise ValueError(f"unknown norm kind {kind!r}")
    return _fn(f"residual_{kind}_q", mode, device)


def matmul_fn(mode: str, device) -> Callable:
    """(x, w, *, n_contract) serve-path matmul: exact | w8a16 | w8a8."""
    return _fn("matmul", mode, device)


def paged_attention_fn(mode: str, device) -> Callable:
    """(q, pool_k, pool_v, tables, q_start, kv_len, *, causal, ...) paged
    attention for the continuous-batching engine."""
    return _fn("paged_attention", mode, device)
