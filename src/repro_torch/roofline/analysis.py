"""Roofline terms of a step on one NVIDIA H100 (the counterpart of
``repro/roofline/analysis.py``, whose targets are a TPU's).

  compute_s    = sum over operand types of FLOPs / that type's peak
  memory_s     = bytes / HBM rate
  collective_s = collective link bytes / NVLink rate (0 on one card)

The FLOPs and bytes come from :mod:`repro_torch.roofline.cost` (one meta
run of the step). ``bound_s`` is the larger of ``compute_s`` and
``memory_s`` (and ``collective_s``): the least time the card could take,
each resource at its peak and perfectly overlapped.

MODEL_FLOPS uses the 6ND (train) / 2ND (inference) convention with N the
active parameters; ``useful_ratio`` = MODEL_FLOPS / counted FLOPs (remat
recompute, the attention's quadratic terms and the kernels' elementwise
operations lower it).

The peaks are the H100 SXM data sheet's dense rates at its 700 W limit:
every bound in ``PERF.md`` and ``chip_smoke.py`` takes them from here.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

from repro_torch.configs.base import ArchConfig, ShapeConfig

HBM_BW = 3.35e12               # bytes/s, device memory
PEAK_FLOPS = {                 # operations/s by operand type
    "bfloat16": 989e12,        # dense tensor cores (fp16 alike)
    "float32": 67e12,          # outside the tensor cores
    "int8": 1979e12,           # dense int8 tensor cores
}
NVLINK_BW = 450e9              # bytes/s a direction (no collective yet)
CARD_BYTES = 85_017_493_504    # total_memory of an NVIDIA H100 80GB HBM3,
                               # as torch.cuda.get_device_properties reads it


def bound_s(nbytes: float, ops_by_type: Dict[str, float]
            ) -> Tuple[float, str]:
    """(least seconds, "bytes" or "operations"): the larger of the bytes
    over the HBM rate and each type's operations over its peak, summed."""
    t_bytes = nbytes / HBM_BW
    t_ops = sum(f / PEAK_FLOPS[k] for k, f in ops_by_type.items())
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_by_type: Dict[str, float]   # per device
    hlo_bytes: float                  # per device
    coll_bytes: float                 # per device link bytes
    coll_op_bytes: float
    model_flops: float                # whole-step useful flops (6ND / 2ND)
    coll_by_kind: Dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def hlo_flops(self) -> float:
        return sum(self.flops_by_type.values())

    @property
    def compute_s(self) -> float:
        return sum(f / PEAK_FLOPS[k] for k, f in self.flops_by_type.items())

    @property
    def memory_s(self) -> float:
        return self.hlo_bytes / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.coll_bytes / NVLINK_BW

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_ratio(self) -> float:
        total = self.hlo_flops * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the compute roofline achieved if the step ran at
        the dominant-term bound: (useful flops / chips / bf16 peak) /
        bound."""
        if self.bound_s == 0:
            return 0.0
        return (self.model_flops / self.chips / PEAK_FLOPS["bfloat16"]
                ) / self.bound_s

    def row(self) -> Dict[str, object]:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "dominant": self.dominant,
            "bound_s": self.bound_s,
            "hlo_flops_per_dev": self.hlo_flops,
            "flops_by_type": dict(self.flops_by_type),
            "hlo_bytes_per_dev": self.hlo_bytes,
            "coll_bytes_per_dev": self.coll_bytes,
            "coll_op_bytes_per_dev": self.coll_op_bytes,
            "model_flops": self.model_flops,
            "useful_ratio": self.useful_ratio,
            "roofline_fraction": self.roofline_fraction,
            "coll_by_kind": self.coll_by_kind,
        }


def model_flops(cfg: ArchConfig, shape: ShapeConfig) -> float:
    """6ND for training, 2ND per generated/processed token for inference."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n_active * shape.seq_len * shape.global_batch
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.seq_len * shape.global_batch
    # decode: one token per sequence in the batch
    return 2.0 * n_active * shape.global_batch


def make_roofline(cfg: ArchConfig, shape: ShapeConfig, mesh_name: str,
                  chips: int, cost) -> Roofline:
    """``cost``: a :class:`repro_torch.roofline.cost.Cost`."""
    return Roofline(
        arch=cfg.name, shape=shape.name, mesh=mesh_name, chips=chips,
        flops_by_type=dict(cost.flops_by_type), hlo_bytes=cost.bytes,
        coll_bytes=cost.coll_bytes, coll_op_bytes=cost.coll_op_bytes,
        model_flops=model_flops(cfg, shape),
        coll_by_kind=dict(cost.coll_by_kind),
    )
