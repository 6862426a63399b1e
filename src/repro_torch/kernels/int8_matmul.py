"""int8 x int8 -> int32 matrix product: the Hopper kernel
(``csrc/int8_matmul.cu``), its wrapper and its plain torch version.

Counterpart of ``repro/kernels/int8_matmul.py``'s ``_mm_kernel`` (entry
point ``int8_matmul_pallas``): (M, K) int8 x (K, N) int8 -> (M, N) int32,
exact for any M, K and N. Every fp scale stays with the caller
(``ops/cuda.py``), as on the TPU.

:func:`int8_matmul` given CPU tensors computes the plain version; given
CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build


def int8_matmul_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The exact product in plain torch on any device. PyTorch has no
    integer matrix product on CUDA, so it runs in float64, which is exact
    here: every partial sum is an integer of magnitude at most
    K * 127^2 < 2^53."""
    return (x.double() @ w.double()).to(torch.int32)


def _launch(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    for name, t in (("x", x), ("w", w)):
        if t.dtype != torch.int8 or t.ndim != 2 or not t.is_contiguous():
            raise ValueError(f"{name}: need a contiguous 2-D int8 tensor, got "
                             f"{t.dtype} {tuple(t.shape)}")
    if w.device != x.device:
        raise ValueError(f"w is on {w.device}, x on {x.device}")
    m, k = x.shape
    if w.shape[0] != k:
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}")
    n = w.shape[1]
    if m == 0 or n == 0 or k == 0:
        return torch.zeros((m, n), dtype=torch.int32, device=x.device)
    out = torch.empty((m, n), dtype=torch.int32, device=x.device)
    vec = int(k % 16 == 0 and n % 4 == 0 and x.data_ptr() % 16 == 0
              and w.data_ptr() % 16 == 0)
    lib = build.load("int8_matmul")
    fn = build.declare(lib, "int8_matmul", 3, 4)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), m, n, k, vec,
                stream)
    build.check(lib, rc, "int8_matmul launch")
    int8_matmul.launches += 1
    return out


def int8_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 x (K, N) int8 -> (M, N) int32, exact."""
    if x.device.type == "cpu":
        return int8_matmul_plain(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"no int8_matmul kernel for device {x.device}")
    return _launch(x, w)


int8_matmul.launches = 0
