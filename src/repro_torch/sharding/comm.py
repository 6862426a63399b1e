"""The collectives of tensor-parallel serving, each over the mesh's
``model`` axis (Megatron-style: the layers call them where the reference's
SPMD partitioner inserts one).

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
  on every rank (a gather of its bytes): every rank runs the same
  scheduler on replicated logits, so their tokens agree by construction,
  and the check makes a rank that parted fail at once (a broadcast of
  rank 0's tokens would hide it).

Under the ``nccl`` backend every collective runs on the card. Under
``gloo`` (CPU ranks, or ranks that share one card and asked for it) a
CUDA tensor is staged through host memory here, once per collective, and
the CPU collective runs on the copy, so gloo runs the same host code on
both devices and takes no dtype it might refuse (bfloat16 sums run in
float32, as they do on the card).

``COUNTS`` counts the calls of each collective in this process and
``SECONDS`` the host's wall inside them (the chip smoke reads both per
trace): under gloo the whole collective, staging included; under nccl
only the enqueue, the device's time in it not.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import time
from typing import Optional

import torch
import torch.distributed as dist

COUNTS: collections.Counter = collections.Counter()
SECONDS: collections.Counter = collections.Counter()


@contextlib.contextmanager
def _counted(name: str):
    COUNTS[name] += 1
    t0 = time.perf_counter()
    try:
        yield
    finally:
        SECONDS[name] += time.perf_counter() - t0


@dataclasses.dataclass(frozen=True)
class ModelAxis:
    """This rank's place on the mesh's ``model`` axis: its ``size``, this
    rank's ``index`` along it and the process group of the ranks that
    share every other coordinate."""
    size: int
    index: int
    group: object


def model_axis(rules) -> Optional[ModelAxis]:
    """The model axis of ``rules``'s mesh, or None where it is absent or
    of size 1 (nothing is split). Cached on the rules."""
    if rules is None:
        return None
    ax = getattr(rules, "_model_axis", False)
    if ax is False:
        size = rules.axis_sizes.get("model", 1)
        ax = None
        if size > 1:
            mesh = rules.mesh
            ax = ModelAxis(size, mesh.coordinate("model"),
                           mesh.group("model"))
        rules._model_axis = ax
    return ax


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


def all_reduce_sum(t: torch.Tensor, ax: ModelAxis) -> torch.Tensor:
    """The elementwise sum over the model axis, in ``t``'s dtype. A
    float32 or integer ``t`` is summed in place (the callers' partials are
    their own); other floats are summed in a float32 copy and cast back."""
    with _counted("all_reduce_sum"):
        wide = (t.float() if t.is_floating_point()
                and t.dtype != torch.float32 else t)
        out = _run(wide, ax.group,
                   lambda x: dist.all_reduce(x, dist.ReduceOp.SUM,
                                             group=ax.group))
        return out.to(t.dtype)


def all_reduce_max(t: torch.Tensor, ax: ModelAxis) -> torch.Tensor:
    """The elementwise max over the model axis."""
    with _counted("all_reduce_max"):
        return _run(t.clone(), ax.group,
                    lambda x: dist.all_reduce(x, dist.ReduceOp.MAX,
                                              group=ax.group))


def stack(t: torch.Tensor, ax: ModelAxis) -> torch.Tensor:
    """Every rank's ``t`` stacked along a new leading dim, in rank order
    along the model axis (uncounted: :func:`all_gather` and
    :func:`agreed` count their own calls)."""
    t = t.contiguous()
    if _staged(t, ax.group) or t.device.type == "cpu":
        h = t.cpu()
        parts = [torch.empty_like(h) for _ in range(ax.size)]
        dist.all_gather(parts, h, group=ax.group)
        return torch.stack(parts).to(t.device)
    out = torch.empty((ax.size,) + tuple(t.shape), dtype=t.dtype,
                      device=t.device)
    dist.all_gather_into_tensor(out, t, group=ax.group)
    return out


def all_gather(t: torch.Tensor, dim: int, ax: ModelAxis) -> torch.Tensor:
    """Every rank's ``t`` concatenated along ``dim`` in rank order along
    the model axis."""
    with _counted("all_gather"):
        return torch.cat(stack(t, ax).unbind(0), dim)


def agreed(t: torch.Tensor, ax: Optional[ModelAxis], what: str):
    """``t`` read back to host memory as a numpy array, after checking
    that every rank of the model axis holds the same bytes: the replicated
    values every rank's host scheduler acts on (sampled tokens, a logits
    row). One gather and one readback; raises ``RuntimeError`` naming the
    ranks that differ."""
    if ax is None:
        return t.cpu().numpy()
    with _counted("agreed"):
        rows = stack(t, ax).cpu().numpy()
    ref = rows[0].tobytes()
    differ = [i for i in range(1, ax.size) if rows[i].tobytes() != ref]
    if differ:
        raise RuntimeError(
            f"{what}: model-axis ranks {differ} disagree with rank 0: the "
            "replicated values every rank's scheduler acts on must be "
            "bitwise equal")
    return rows[ax.index]
