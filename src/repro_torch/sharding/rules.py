"""Weight packing for quantized serving: the port's copy of the JAX
package's ``sharding.rules`` W8A8 helpers (``QUANT_WEIGHT_SPEC``,
``quantize_params``, ``param_bytes``). Mesh rules are not ported yet
(ROADMAP.md queue 1 item 9).
"""
from __future__ import annotations

import torch

from repro_torch.core.sole import quant as Q

# name -> (n_contract, base_ndim): every serve-path matmul weight
# contracts its *leading* base axes (wq/wk/wv (d,h,k) contract d; wo
# (h,k,d) contracts (h,k); gate/up/down/head (in,out) contract in). A
# leaf stacked with extra leading axes (per-layer "layers") quantizes
# with offset = ndim - base_ndim, so each layer gets its own scales.
QUANT_WEIGHT_SPEC = {
    "wq": (1, 3), "wk": (1, 3), "wv": (1, 3), "wo": (2, 3),
    "gate": (1, 2), "up": (1, 2), "down": (1, 2), "head": (1, 2),
}


def quantize_params(params):
    """Pack the named matmul weights as per-channel int8 codes + float32
    scales. Idempotent: packed ``{"q","s"}`` leaves pass through; other
    leaves (embeddings, norms, biases) are untouched."""
    def walk(node):
        if not isinstance(node, dict) or Q.is_qtensor(node):
            return node
        out = {}
        for k, v in node.items():
            spec = QUANT_WEIGHT_SPEC.get(k)
            if (spec is not None and isinstance(v, torch.Tensor)
                    and v.ndim >= spec[1]):
                n, base = spec
                out[k] = Q.quantize_weight(v, n, offset=v.ndim - base)
            else:
                out[k] = walk(v)
        return out

    return walk(params)


def param_bytes(params) -> int:
    """Total bytes resident across all parameter tensors (codes and
    scales included)."""
    if isinstance(params, dict):
        return sum(param_bytes(v) for v in params.values())
    return params.numel() * params.element_size()
