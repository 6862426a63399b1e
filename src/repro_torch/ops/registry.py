"""The op registry: ``(op, mode, backend)`` -> callable, with the same
op and mode names as the JAX package's registry.

Backends are ``reference`` (plain torch — the CPU path and the oracle
every kernel is held against) and ``cuda`` (the hand-written Hopper
kernels). Under the default choice ``auto`` the backend follows the
tensors' device, never an autodetect of the machine (:func:`backend_for`):

* CPU tensors run ``reference``;
* CUDA tensors run ``cuda`` where a kernel is registered — every pair
  whose reference implementation is a Pallas kernel has one;
* every other pair (no kernel in the reference either, e.g. exact
  norms or the softermax / I-BERT baselines, which are XLA there) runs
  ``reference`` torch ops on the card;
* meta tensors (the dry run, ``launch/dryrun.py``) take the card's
  route: a pair with a kernel reaches the kernel's wrapper, which returns
  what the kernel writes and reports its work to the cost counter
  (``roofline/cost.py``) and runs nothing else; every other pair runs its
  torch ops on meta, as it would on the card.

A caller may choose (``ArchConfig.ops_backend``, the launcher's
``--ops-backend``): ``reference`` runs the plain versions on any device,
``cuda`` is ``auto`` that refuses CPU tensors.

:func:`resolve` is strict: an unregistered combination raises
``NotImplementedError``; unknown names raise ``ValueError``.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

OPS = ("softmax", "layernorm", "rmsnorm", "residual_layernorm",
       "residual_rmsnorm", "flash_attention", "paged_attention",
       "matmul", "residual_layernorm_q", "residual_rmsnorm_q")
BACKENDS = ("reference", "cuda")
CHOICES = ("auto",) + BACKENDS

SOFTMAX_MODES = ("exact", "sole", "softermax", "ibert")
NORM_MODES = ("exact", "sole", "ibert")
ATTN_MODES = ("exact", "sole")
MATMUL_MODES = ("exact", "w8a16", "w8a8")

MODES_BY_OP: Dict[str, Tuple[str, ...]] = {
    "softmax": SOFTMAX_MODES,
    "layernorm": NORM_MODES,
    "rmsnorm": NORM_MODES,
    "residual_layernorm": NORM_MODES,
    "residual_rmsnorm": NORM_MODES,
    "flash_attention": ATTN_MODES,
    "paged_attention": SOFTMAX_MODES,
    "matmul": MATMUL_MODES,
    "residual_layernorm_q": NORM_MODES,
    "residual_rmsnorm_q": NORM_MODES,
}

_REGISTRY: Dict[Tuple[str, str, str], Callable] = {}


def register(op: str, mode: str, backend: str):
    """Decorator: register ``fn`` as the (op, mode, backend) implementation."""
    _check_names(op, mode, backend)

    def deco(fn: Callable) -> Callable:
        _REGISTRY[(op, mode, backend)] = fn
        return fn

    return deco


def _check_names(op: str, mode: str, backend: str) -> None:
    if op not in OPS:
        raise ValueError(f"unknown op {op!r}; known: {OPS}")
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; known: {BACKENDS}")
    if mode not in MODES_BY_OP[op]:
        raise ValueError(
            f"unknown mode {mode!r} for op {op!r}; known: {MODES_BY_OP[op]}")


def is_registered(op: str, mode: str, backend: str) -> bool:
    return (op, mode, backend) in _REGISTRY


def resolve(op: str, mode: str, backend: str = "reference") -> Callable:
    """Strict lookup: the callable for (op, mode, backend), or raise."""
    _check_names(op, mode, backend)
    key = (op, mode, backend)
    if key not in _REGISTRY:
        raise NotImplementedError(
            f"op {op!r} mode {mode!r} has no {backend!r} backend "
            f"(registered backends: "
            f"{[b for b in BACKENDS if (op, mode, b) in _REGISTRY]})")
    return _REGISTRY[key]


def backend_for(op: str, mode: str, device, choice: str = "auto") -> str:
    """The backend for one (op, mode) call on tensors living on
    ``device`` under the caller's ``choice`` (see the module docstring)."""
    _check_names(op, mode, "reference")
    if choice not in CHOICES:
        raise ValueError(f"unknown ops backend {choice!r}; known: {CHOICES}")
    if choice == "reference":
        return "reference"
    if torch.device(device).type not in ("cuda", "meta"):
        if choice == "cuda":
            raise ValueError(
                f"ops backend 'cuda' needs CUDA tensors, got {device} "
                f"for op {op!r}")
        return "reference"
    return "cuda" if is_registered(op, mode, "cuda") else "reference"
