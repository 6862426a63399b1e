"""The collectives of serving over a (data, model) mesh of ranks: over the
``model`` axis the tensor-parallel ones (Megatron-style: the layers call
them where the reference's SPMD partitioner inserts one), over the
``data`` axis those of the lane split (each data rank runs its share of a
dispatch's lanes), and :func:`agreed` over the whole mesh.

* :func:`all_reduce_sum` — the row-parallel products' partial outputs
  (``wo`` and the MLP's ``down``: float32 partials, and the W8A8 GEMM's
  int32 partials, which sum exactly; both private to the caller, so they
  are summed in place) and the vocab-parallel embedding's model-dtype rows
  (summed in a float32 copy: one rank holds each row, the others add
  zeros, so the sum is exact);
* :func:`all_reduce_max` — the W8A8 activation scale of a row-parallel
  product: the row's max over every rank's slice of the contracted dim;
* :func:`all_gather` — the vocab-parallel head's float32 logits, along
  the vocabulary, before any sampling;
* :func:`agreed` — a readback the host schedulers act on, checked equal
  on every rank of the mesh (a gather of its bytes): every rank runs the
  same scheduler on replicated values, so their tokens agree by
  construction, and the check makes a rank that parted fail at once (a
  broadcast of rank 0's tokens would hide it).

Over the data axis (the lane split of ``models/layers.py``):
:func:`all_gather` joins the ranks' lanes (each layer's new K/V rows,
which every data rank's replicated pool stores; the sampled tokens at a
horizon's end; the logits of a dense-slot call) and :func:`all_reduce_max`
takes SOLE's per-channel calibration maxima to the whole batch's (exact
in any order). The MoE family's experts are the one weight split over
data (``models/moe.py``): :func:`all_to_all` sends each expert's
dispatched rows to the rank that holds it and brings its rows back, and
where the batch is whole on every data rank :func:`all_reduce_sum` joins
the ranks' partial outputs. No pool is split over data.

Under the ``nccl`` backend every collective runs on the card. Under
``gloo`` (CPU ranks, or ranks that share one card and asked for it) a
CUDA tensor is staged through host memory here, once per collective, and
the CPU collective runs on the copy, so gloo runs the same host code on
both devices and takes no dtype it might refuse (bfloat16 sums and maxima
run in float32, as they do on the card; other types are gathered as their
bytes).

``COUNTS`` counts the calls of each collective in this process and
``SECONDS`` the host's wall inside them (the chip smoke reads both per
trace), kept per axis: a model-axis collective under its own name
(``all_reduce_sum``), a data-axis one as ``data.<name>`` and ``agreed``
(the whole mesh) as itself; under gloo the whole collective, staging
included; under nccl only the enqueue, the device's time in it not.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import math
import time
from typing import Optional

import torch
import torch.distributed as dist

COUNTS: collections.Counter = collections.Counter()
SECONDS: collections.Counter = collections.Counter()


@contextlib.contextmanager
def _counted(name: str, ax=None):
    key = name if ax is None or ax.name == "model" else f"{ax.name}.{name}"
    COUNTS[key] += 1
    t0 = time.perf_counter()
    try:
        yield
    finally:
        SECONDS[key] += time.perf_counter() - t0


@dataclasses.dataclass(frozen=True)
class MeshAxis:
    """This rank's place on one axis of the mesh (``name``: ``model``,
    ``data``, or ``mesh`` for all its ranks): the axis's ``size``, this
    rank's ``index`` along it and the process group of the ranks that
    share every other coordinate (None: the default group, the whole
    mesh)."""
    name: str
    size: int
    index: int
    group: object



def mesh_axis(rules, name: str) -> Optional[MeshAxis]:
    """Axis ``name`` of ``rules``'s mesh, or None where it is absent or of
    size 1 (nothing is split). Cached on the rules."""
    if rules is None:
        return None
    cache = rules.__dict__.setdefault("_comm_axes", {})
    if name not in cache:
        size = rules.axis_sizes.get(name, 1)
        ax = None
        if size > 1:
            mesh = rules.mesh
            ax = MeshAxis(name, size, mesh.coordinate(name),
                          mesh.group(name))
        cache[name] = ax
    return cache[name]


def model_axis(rules) -> Optional[MeshAxis]:
    """The model axis of ``rules``'s mesh (:func:`mesh_axis`)."""
    return mesh_axis(rules, "model")


def data_axis(rules) -> Optional[MeshAxis]:
    """The data axis of ``rules``'s mesh (:func:`mesh_axis`)."""
    return mesh_axis(rules, "data")


def whole_mesh(rules) -> Optional[MeshAxis]:
    """Every rank of ``rules``'s mesh as one axis (the default group), or
    None on a mesh of one rank: what readbacks are checked over."""
    if rules is None:
        return None
    n = math.prod(rules.axis_sizes.values())
    return None if n == 1 else MeshAxis("mesh", n, dist.get_rank(), None)


def _staged(t: torch.Tensor, group) -> bool:
    return t.device.type != "cpu" and dist.get_backend(group) == "gloo"


def _run(t: torch.Tensor, group, op) -> torch.Tensor:
    """``op(x)`` in place on ``t`` or, under gloo, on a host copy; returns
    the result on ``t``'s device."""
    if _staged(t, group):
        h = t.cpu()
        op(h)
        return h.to(t.device)
    op(t)
    return t


def all_reduce_sum(t: torch.Tensor, ax: MeshAxis) -> torch.Tensor:
    """The elementwise sum over ``ax``, in ``t``'s dtype. A float32 or
    integer ``t`` is summed in place (the callers' partials are their
    own); other floats are summed in a float32 copy and cast back."""
    with _counted("all_reduce_sum", ax):
        wide = (t.float() if t.is_floating_point()
                and t.dtype != torch.float32 else t)
        out = _run(wide, ax.group,
                   lambda x: dist.all_reduce(x, dist.ReduceOp.SUM,
                                             group=ax.group))
        return out.to(t.dtype)


def all_reduce_max(t: torch.Tensor, ax: MeshAxis) -> torch.Tensor:
    """The elementwise max over ``ax`` in ``t``'s dtype (another float
    than float32 in a float32 copy: exact, as a max rounds nothing)."""
    with _counted("all_reduce_max", ax):
        wide = (t.float() if t.is_floating_point()
                and t.dtype != torch.float32 else t.clone())
        out = _run(wide, ax.group,
                   lambda x: dist.all_reduce(x, dist.ReduceOp.MAX,
                                             group=ax.group))
        return out.to(t.dtype)


# types every backend gathers as they are; others travel as their bytes
_GATHER_TYPES = (torch.float32, torch.float64, torch.int32, torch.int64,
                 torch.uint8)


def stack(t: torch.Tensor, ax: MeshAxis) -> torch.Tensor:
    """Every rank's ``t`` stacked along a new leading dim, in rank order
    along ``ax`` (uncounted: :func:`all_gather` and :func:`agreed` count
    their own calls). Another type than ``_GATHER_TYPES`` (bf16 K/V rows,
    int8 codes, booleans) is gathered as its bytes, bit for bit."""
    t = t.contiguous()
    if t.dtype not in _GATHER_TYPES:
        raw = stack(t.reshape(-1).view(torch.uint8), ax)
        return raw.view(t.dtype).reshape((ax.size,) + tuple(t.shape))
    if _staged(t, ax.group) or t.device.type == "cpu":
        h = t.cpu()
        parts = [torch.empty_like(h) for _ in range(ax.size)]
        dist.all_gather(parts, h, group=ax.group)
        return torch.stack(parts).to(t.device)
    out = torch.empty((ax.size,) + tuple(t.shape), dtype=t.dtype,
                      device=t.device)
    dist.all_gather_into_tensor(out, t, group=ax.group)
    return out


def all_to_all(t: torch.Tensor, ax: MeshAxis) -> torch.Tensor:
    """``t`` (ax.size, ...) exchanged over ``ax``: chunk i of the leading
    dim goes to rank i along ``ax``, and the result's chunk j is the one
    rank j sent here (``jax.lax.all_to_all(t, axis, 0, 0,
    tiled=False)``). Another type than ``_GATHER_TYPES`` (bf16 expert
    rows) travels as its bytes under gloo, bit for bit."""
    with _counted("all_to_all", ax):
        t = t.contiguous()
        if _staged(t, ax.group) or t.device.type == "cpu":
            h = t.cpu()
            raw = (h if h.dtype in _GATHER_TYPES
                   else h.reshape(ax.size, -1).view(torch.uint8))
            out = torch.empty_like(raw)
            dist.all_to_all_single(out, raw, group=ax.group)
            return out.view(t.dtype).reshape(t.shape).to(t.device)
        out = torch.empty_like(t)
        dist.all_to_all_single(out, t, group=ax.group)
        return out


def all_gather(t: torch.Tensor, dim: int, ax: MeshAxis) -> torch.Tensor:
    """Every rank's ``t`` concatenated along ``dim`` in rank order along
    ``ax``."""
    with _counted("all_gather", ax):
        return torch.cat(stack(t, ax).unbind(0), dim)


def agreed(t: torch.Tensor, ax: Optional[MeshAxis], what: str):
    """``t`` read back to host memory as a numpy array, after checking
    that every rank of ``ax`` (the whole mesh: :func:`whole_mesh`) holds
    the same bytes: the replicated values every rank's host scheduler acts
    on (sampled tokens, a logits row). One gather and one readback; raises
    ``RuntimeError`` naming the ranks that differ."""
    if ax is None:
        return t.cpu().numpy()
    with _counted("agreed"):
        rows = stack(t, ax).cpu().numpy()
    ref = rows[0].tobytes()
    differ = [i for i in range(1, ax.size) if rows[i].tobytes() != ref]
    if differ:
        raise RuntimeError(
            f"{what}: ranks {differ} of the {ax.name} axis disagree with "
            "rank 0: the replicated values every rank's scheduler acts on "
            "must be bitwise equal")
    return rows[ax.index]
