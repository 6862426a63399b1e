"""Weights from the JAX package into the port.

:func:`params_from_jax` takes the reference's parameter value tree with
its leaves already turned into numpy arrays (the stacked ``layers`` axis
kept) and returns the port's tree on ``device``. Each leaf is stored once
in its serving dtype — ``cfg.dtype`` for projections, biases and
embeddings, which is bit-identical to the reference's per-use ``cast``
(both round to nearest even), and float32 for norm gains and biases,
which the reference feeds to its norms uncast.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import torch_dtype

NORM_KEYS = ("ln1", "ln2", "final_norm")


def params_from_jax(tree: Mapping, cfg: ArchConfig, device="cuda"):
    """Reference value tree (numpy leaves) -> the port's tensors."""
    if cfg.quant.mode != "off":
        raise NotImplementedError("quantized weights come with the W8A8 "
                                  "slice (ROADMAP.md queue 1 item 6)")
    dt = torch_dtype(cfg.dtype)

    def conv(node, in_norm: bool):
        if isinstance(node, Mapping):
            if set(node) == {"q", "s"}:
                raise NotImplementedError("int8 weight leaves are not ported")
            return {k: conv(v, in_norm or k in NORM_KEYS)
                    for k, v in node.items()}
        a = torch.tensor(np.asarray(node))
        return a.to(device=device,
                    dtype=torch.float32 if in_norm else dt)

    return conv(tree, False)
