"""Weights from the JAX package into the port.

:func:`params_from_jax` takes the reference's parameter value tree with
its leaves already turned into numpy arrays (the stacked ``layers`` axis
kept) and returns the port's tree on ``device``. Each leaf is stored once
in its serving dtype — ``cfg.dtype`` for projections (the MoE experts'
``(L, E, d, f)`` gate/up/down and ``(L, d, E)`` router included), biases
and embeddings, which is bit-identical to the reference's per-use ``cast``
(both round to nearest even), and float32 for norm gains and biases,
which the reference feeds to its norms uncast, and for the recurrent
families' leaves it computes with uncast: rwkv6's decay ``w0``/``w1``/
``w2``, bonus ``u`` and GroupNorm ``gn_g``/``gn_b``, the RG-LRU's
``lam``. The trees are the reference's: ``layers.tm``/``layers.cm`` for
rwkv6, ``blocks.rec1``/``rec2``/``attn`` and ``tail`` for the hybrid,
``enc_layers``, ``enc_norm`` and ``dec_layers`` (with the cross-attention's
``ln_x`` and ``xattn``) for whisper, the dense tree for qwen2-vl.

:func:`serving_view` builds that tree from float32 masters (the
trainer's) by the same leaf rule, as differentiable casts.

Under ``cfg.quant.weights`` packed ``{"q", "s"}`` leaves become int8 codes
and float32 scales, and unpacked matmul weights (``QUANT_WEIGHT_SPEC``)
stay float32 so that the engine packs them from the same float32 masters
as the reference: codes packed from a bf16 copy would differ.

:func:`shard_params` cuts any of these trees to one rank's slices of a
mesh, by the logical axes of ``models.api.param_axes`` and the mesh rules
(``sharding.rules``).
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import torch_dtype
from repro_torch.sharding.rules import QUANT_WEIGHT_SPEC

NORM_KEYS = ("ln1", "ln2", "final_norm", "ln", "ln_mlp", "ln_x", "enc_norm")
# leaves the reference uses in float32 without a cast
FLOAT32_KEYS = ("w0", "w1", "w2", "u", "gn_g", "gn_b", "lam")


def _keeps_float32(key, in_norm: bool, cfg: ArchConfig) -> bool:
    """The leaf rule: norm gains and biases, ``FLOAT32_KEYS`` and (under
    int8 weights) the unpacked matmul weights stay float32."""
    return (in_norm or key in FLOAT32_KEYS
            or (cfg.quant.weights and key in QUANT_WEIGHT_SPEC))


def params_from_jax(tree: Mapping, cfg: ArchConfig, device="cuda",
                    masters: bool = False):
    """Reference value tree (numpy leaves) -> the port's tensors.
    ``masters`` keeps every leaf float32 (the trainer's masters; see
    :func:`serving_view`)."""
    dt = torch.float32 if masters else torch_dtype(cfg.dtype)
    quant = cfg.quant.weights

    def leaf(a, dtype):
        return torch.tensor(np.asarray(a)).to(device=device, dtype=dtype)

    def conv(node, key, in_norm: bool):
        if isinstance(node, Mapping):
            if set(node) == {"q", "s"}:
                if not quant:
                    raise ValueError(
                        f"packed int8 leaf {key!r} under quant mode "
                        f"{cfg.quant.mode!r}")
                return {"q": leaf(node["q"], torch.int8),
                        "s": leaf(node["s"], torch.float32)}
            return {k: conv(v, k, in_norm or k in NORM_KEYS)
                    for k, v in node.items()}
        if _keeps_float32(key, in_norm, cfg):
            return leaf(node, torch.float32)
        return leaf(node, dt)

    return conv(tree, None, False)


def serving_view(masters: Mapping, cfg: ArchConfig):
    """The tree the layers run on, built from float32 masters by the
    leaf rule of :func:`params_from_jax`: the float32 leaves as they are,
    every other leaf ``.to(cfg.dtype)`` — a differentiable cast (round to
    nearest even, the reference's per-use ``cast``), so one train step's
    gradients land on the masters in float32. Bitwise the serving tree the
    same weights would give."""
    dt = torch_dtype(cfg.dtype)

    def conv(node, key, in_norm: bool):
        if isinstance(node, Mapping):
            return {k: conv(v, k, in_norm or k in NORM_KEYS)
                    for k, v in node.items()}
        return node if _keeps_float32(key, in_norm, cfg) else node.to(dt)

    return conv(masters, None, False)


def shard_slices(spec, shape, rules, rank: int):
    """The index of ``rank``'s shard of a leaf of ``shape`` laid out by
    ``spec`` (``Rules.spec``): each sharded dim cut into as many equal
    pieces as its mesh axes' product, the piece at ``rank``'s index along
    them (row-major over a tuple of axes, as JAX lays a dim over several
    axes); replicated dims whole."""
    coords = rules.mesh.coords(rank)
    index = []
    for dim, ax in zip(shape, spec):
        if ax is None:
            index.append(slice(None))
            continue
        names = ax if isinstance(ax, tuple) else (ax,)
        n, i = 1, 0
        for a in names:
            n *= rules.axis_sizes[a]
            i = i * rules.axis_sizes[a] + coords[a]
        step = dim // n
        index.append(slice(i * step, (i + 1) * step))
    return tuple(index)


def shard_shape(spec, shape, rules) -> tuple:
    """The shape of every rank's shard of a leaf of ``shape`` laid out by
    ``spec`` (the pieces :func:`shard_slices` cuts are equal)."""
    out = []
    for dim, ax in zip(shape, spec):
        names = () if ax is None else ax if isinstance(ax, tuple) else (ax,)
        for a in names:
            dim //= rules.axis_sizes[a]
        out.append(dim)
    return tuple(out)


def shard_params(params, axes, rules, rank: int):
    """``rank``'s local tree: every leaf sliced to its shard per
    ``rules.spec(axes, shape)`` (``sharding.rules``; the divisibility
    fallback keeps a dim whole), a contiguous copy, so the whole tree can
    be freed. ``axes`` is ``models.api.param_axes(cfg)``'s tree (its
    quantized mirror for packed ``{"q", "s"}`` leaves). Bitwise a slice of
    the single-device tree."""
    if isinstance(params, Mapping):
        return {k: shard_params(v, axes[k], rules, rank)
                for k, v in params.items()}
    spec = rules.spec(axes, tuple(params.shape))
    if all(ax is None for ax in spec):
        return params
    return params[shard_slices(spec, params.shape, rules, rank)].clone(
        memory_format=torch.contiguous_format)
