"""Logical-axis sharding rules with the divisibility fallback, and the
weight packing of quantized serving: the port's copy of the JAX package's
``sharding.rules``.

Models name each parameter's dims with *logical* axes (``api.param_axes``);
a :class:`Rules` object maps them to mesh axes, dropping any mapping whose
dim is not divisible by the mesh-axis size (qwen2_0_5b's 14 heads on a
4-way model axis replicate attention while its FFN and vocabulary still
shard). A spec is a plain tuple with one entry per dim: ``None``
(replicated), a mesh-axis name, or a tuple of names (sharded over their
product), the analogue of ``PartitionSpec``.

The port keeps plain local tensors on each rank (``convert.shard_params``
slices them per :meth:`Rules.spec`); the layers read the active rules
(:func:`use_rules`, :func:`active_rules`) and call the collectives of
``sharding/comm.py`` where the reference's SPMD partitioner inserts them.
:func:`constrain` keeps the reference's name and is a no-op on local
tensors. :func:`fsdp_param_spec` and :func:`zero1_spec` are the training
layouts (ZeRO-3 parameters, ZeRO-1 optimizer state; not used by serving).
"""
from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.core.sole import quant as Q

# logical axis -> preferred mesh axes (joined). Tuples shard over the
# product of the listed mesh axes (those present in the mesh).
DEFAULT_RULES = {
    "batch": ("pod", "data"),
    "seq": (),                # sequence replicated by default (SP opt-in)
    "seq_shard": ("data",),   # opt-in sequence parallelism
    "embed": (),
    "heads": ("model",),
    "kv_heads": ("model",),
    "head_dim": (),
    "ff": ("model",),
    "vocab": ("model",),
    "experts": ("data",),
    "expert_ff": ("model",),
    "layers": (),
    "conv": (),
    "stats": (),
    # serve-time paged KV pool: pages replicate (any rank can host any
    # sequence's pages); the kv_heads dim of each page shards over model.
    "pages": (),
    # serve-time recurrent state slots: the slot dim replicates like pages
    "state_slots": (),
}

# FSDP: activations batch-shard over the whole mesh; no tensor parallelism.
FSDP_RULES = {
    "batch": ("pod", "data", "model"),
    "seq": (), "embed": (), "heads": (), "kv_heads": (), "head_dim": (),
    "ff": (), "vocab": (), "experts": ("data",), "expert_ff": (),
    "layers": (), "conv": (), "stats": (), "pages": (),
    "state_slots": (),
}

Spec = Tuple[object, ...]


def mesh_shape(mesh) -> Tuple[int, ...]:
    """The mesh's shape: ``mesh.devices.shape`` (a JAX mesh, the port's
    ``launch.mesh.Mesh``) or ``mesh.shape`` as a tuple."""
    devices = getattr(mesh, "devices", None)
    if devices is not None and hasattr(devices, "shape"):
        return tuple(devices.shape)
    shape = mesh.shape
    return tuple(shape.values()) if isinstance(shape, dict) else tuple(shape)


class Rules:
    """Logical axes -> mesh axes over ``mesh`` (anything with
    ``axis_names`` and a shape: no process group is needed to compute a
    spec)."""

    def __init__(self, mesh, table: Optional[dict] = None):
        self.mesh = mesh
        self.table = dict(DEFAULT_RULES)
        if table:
            self.table.update(table)
        self.axis_sizes = dict(zip(mesh.axis_names, mesh_shape(mesh)))

    def _mesh_axes(self, logical: Optional[str]) -> Tuple[str, ...]:
        if logical is None:
            return ()
        pref = self.table.get(logical, ())
        return tuple(a for a in pref if a in self.axis_sizes)

    def dim_spec(self, logical: Optional[str], size: Optional[int]):
        """Mesh axes for one dim, honoring divisibility of ``size``."""
        axes = self._mesh_axes(logical)
        if not axes:
            return None
        if size is not None:
            total = math.prod(self.axis_sizes[a] for a in axes)
            if size % total != 0:
                # try a prefix of the axes (batch 32 on pod*data = 32 ok,
                # batch 1 replicates)
                while axes:
                    axes = axes[:-1]
                    total = math.prod(self.axis_sizes[a] for a in axes)
                    if axes and size % total == 0:
                        break
                if not axes:
                    return None
        return axes if len(axes) > 1 else axes[0]

    def spec(self, logical_axes: Sequence[Optional[str]],
             shape: Optional[Sequence[int]] = None) -> Spec:
        return tuple(self.dim_spec(ax, None if shape is None else shape[i])
                     for i, ax in enumerate(logical_axes))

    def split(self, logical: Optional[str], size: int) -> int:
        """How many ways a dim of ``size`` along ``logical`` is split (1
        where it replicates)."""
        ax = self.dim_spec(logical, size)
        if ax is None:
            return 1
        names = ax if isinstance(ax, tuple) else (ax,)
        return math.prod(self.axis_sizes[a] for a in names)


def fsdp_param_spec(shape, rules: Rules) -> Spec:
    """Shard the largest divisible dim over the full (data, model) mesh
    product (falling back to 'data' alone, then 'model') — the ZeRO-3
    parameter layout."""
    for axes in (("data", "model"), ("data",), ("model",)):
        if not all(a in rules.axis_sizes for a in axes):
            continue
        n = math.prod(rules.axis_sizes[a] for a in axes)
        best, best_size = None, 0
        for i, dim in enumerate(shape):
            if dim % n == 0 and dim > best_size:
                best, best_size = i, dim
        if best is not None:
            dims = [None] * len(shape)
            dims[best] = axes if len(axes) > 1 else axes[0]
            return tuple(dims)
    return (None,) * len(shape)


def make_rules_for(cfg, mesh) -> Rules:
    """Strategy-aware rules factory (``cfg.sharding_strategy``)."""
    table = (FSDP_RULES if getattr(cfg, "sharding_strategy", "tp") == "fsdp"
             else None)
    return Rules(mesh, table)


_ACTIVE: contextvars.ContextVar[Optional[Rules]] = contextvars.ContextVar(
    "active_rules", default=None)


@contextlib.contextmanager
def use_rules(rules: Optional[Rules]):
    tok = _ACTIVE.set(rules)
    try:
        yield rules
    finally:
        _ACTIVE.reset(tok)


def active_rules() -> Optional[Rules]:
    return _ACTIVE.get()


def constrain(x: torch.Tensor, *logical_axes: Optional[str]) -> torch.Tensor:
    """The reference's sharding constraint: each rank already holds its
    local tensor, so nothing moves."""
    return x


def _is_axes_leaf(v) -> bool:
    return isinstance(v, tuple) and all(
        a is None or isinstance(a, str) for a in v)


def param_specs(axes_tree, shapes_tree, rules: Rules):
    """A tree of logical-axes tuples and one of shapes -> a tree of
    specs."""
    if _is_axes_leaf(axes_tree):
        return rules.spec(axes_tree, tuple(shapes_tree))
    return {k: param_specs(v, shapes_tree[k], rules)
            for k, v in axes_tree.items()}


def zero1_spec(spec: Spec, shape, rules: Rules, axis: str = "data") -> Spec:
    """ZeRO-1: additionally shard the largest unsharded dim over ``axis``
    (optimizer moments and the float32 master copy)."""
    if axis not in rules.axis_sizes:
        return tuple(spec)
    n = rules.axis_sizes[axis]
    dims = list(spec) + [None] * (len(shape) - len(spec))
    used = set()
    for d in dims:
        for a in (d if isinstance(d, tuple) else (d,)):
            if a:
                used.add(a)
    if axis in used:
        return tuple(spec)
    best, best_size = None, 0
    for i, d in enumerate(dims):
        if d is None and shape[i] % n == 0 and shape[i] > best_size:
            best, best_size = i, shape[i]
    if best is None:
        return tuple(spec)
    dims[best] = axis
    return tuple(dims)


# -- serving-time weight quantization (SOLE W8A8) -----------------------------

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


def quantize_param_axes(axes_tree):
    """Mirror a logical-axes tree onto the packed-weight structure: each
    quantized leaf's axes become ``{"q": axes, "s": axes}`` (the scale's
    size-1 contraction dims fall back to replicated by divisibility)."""
    if not isinstance(axes_tree, dict):
        return axes_tree
    return {k: ({"q": v, "s": v} if k in QUANT_WEIGHT_SPEC
                and _is_axes_leaf(v) else quantize_param_axes(v))
            for k, v in axes_tree.items()}


def param_bytes(params) -> int:
    """Total bytes resident across all parameter tensors (codes and
    scales included)."""
    if isinstance(params, dict):
        return sum(param_bytes(v) for v in params.values())
    return params.numel() * params.element_size()
