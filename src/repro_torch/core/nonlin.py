"""Back-compat shim over the ``repro_torch.ops`` registry, as the JAX
package's ``core/nonlin.py`` is over ``repro.ops``.

These helpers pin ``backend="reference"`` (the plain torch ops on any
device) for notebooks, benchmarks and examples; model and serve code
imports ``repro_torch.ops`` directly and resolves the backend from the
tensors' device.

Modes:
  exact      fp32 softmax / LayerNorm (ground truth)
  sole       E2Softmax / AILayerNorm (the paper)
  softermax  base-2 16-bit fixed-point softmax (softmax only)
  ibert      INT32 integer-only softmax / LayerNorm
"""
from __future__ import annotations

from typing import Callable

from repro_torch.ops import NORM_MODES, SOFTMAX_MODES  # noqa: F401 (re-export)
from repro_torch.ops import registry as _registry


def softmax_fn(mode: str) -> Callable:
    """Returns softmax(x, axis=-1, mask=None) for the given mode."""
    return _registry.resolve("softmax", mode, "reference")


def layernorm_fn(mode: str) -> Callable:
    """Returns layernorm(x, gamma, beta) for the given mode."""
    return _registry.resolve("layernorm", mode, "reference")


def rmsnorm_fn(mode: str) -> Callable:
    """Returns rmsnorm(x, gamma) for the given mode."""
    return _registry.resolve("rmsnorm", mode, "reference")
