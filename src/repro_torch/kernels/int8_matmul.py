"""int8 x int8 -> int32 matrix product: the Hopper kernel
(``csrc/int8_matmul.cu``), its wrapper and its plain torch version.

Counterpart of ``repro/kernels/int8_matmul.py``'s ``_mm_kernel`` (entry
point ``int8_matmul_pallas``): (M, K) int8 x (K, N) int8 -> (M, N) int32,
exact for any M, K and N. Every fp scale stays with the caller
(``ops/cuda.py``), as on the TPU.

The kernel splits K across CTAs where the output alone has too few tiles
to fill the card (:func:`split_plan`), and sums the int32 partials inside
the same launch; integer sums make the result independent of the split.

:func:`int8_matmul` given CPU tensors computes the plain version; given
CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import dataclasses
import functools
import threading
from typing import Dict, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.roofline.cost import io_bytes, kernel_work

# (BM, BN) output tile of each kernel instantiation, by the C interface's
# tile code: 16 x 64 for M <= 16, 64 x 64 above, 16 x 16 for narrow N.
TILES = ((16, 64), (64, 64), (16, 16))
SPLIT_UNIT = 32         # split boundaries fall on multiples of 32 bytes of K
MIN_CTAS = 132          # one per SM of an H100 SXM


@dataclasses.dataclass(frozen=True)
class SplitPlan:
    """The kernel's grid for one (M, N, K): output tile ``TILES[tile]``
    and ``splits`` contiguous ranges of K, split ``s`` covering the
    32-byte chunks ``[s * chunks // splits, (s + 1) * chunks // splits)``
    (the kernel computes the same bounds)."""
    m: int
    n: int
    k: int
    tile: int
    splits: int

    @property
    def tiles(self) -> int:
        bm, bn = TILES[self.tile]
        return -(-self.m // bm) * -(-self.n // bn)

    @property
    def ctas(self) -> int:
        return self.tiles * self.splits

    def k_range(self, s: int) -> Tuple[int, int]:
        chunks = -(-self.k // SPLIT_UNIT)
        return (SPLIT_UNIT * (s * chunks // self.splits),
                min(self.k, SPLIT_UNIT * ((s + 1) * chunks // self.splits)))

    @property
    def workspace_ints(self) -> int:
        """int32 partials the split tiles need (0 without a split)."""
        bm, bn = TILES[self.tile]
        return 0 if self.splits == 1 else self.tiles * self.splits * bm * bn


@functools.lru_cache(maxsize=4096)
def split_plan(m: int, n: int, k: int) -> SplitPlan:
    """The tile and the number of K splits for (M, K) x (K, N): the row
    tile for M (16 or 64 rows), K split just enough that the grid reaches
    ``MIN_CTAS``; where even one split per 32-byte chunk of K cannot, the
    16 x 16 tile. Without any plan reaching ``MIN_CTAS``, the one with
    the most CTAs."""
    chunks = -(-k // SPLIT_UNIT)
    plans = []
    for tile in (0 if m <= 16 else 1, 2):
        tiles = SplitPlan(m, n, k, tile, 1).tiles
        splits = max(1, min(chunks, -(-MIN_CTAS // tiles)))
        plan = SplitPlan(m, n, k, tile, splits)
        if plan.ctas >= MIN_CTAS:
            return plan
        plans.append(plan)
    return max(plans, key=lambda p: p.ctas)


def int8_matmul_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The exact product in plain torch on any device. PyTorch has no
    integer matrix product on CUDA, so it runs in float64, which is exact
    here: every partial sum is an integer of magnitude at most
    K * 127^2 < 2^53."""
    return (x.double() @ w.double()).to(torch.int32)


# Per device: the split partials' workspace and the per-tile tickets
# (all 0 between calls: the last CTA of each tile resets its own). Grown,
# never shrunk; calls on one device share them, ordered on its stream.
_WORKSPACE: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}
_WS_LOCK = threading.Lock()


def _workspace(device: torch.device, plan: SplitPlan):
    with _WS_LOCK:
        ws, tickets = _WORKSPACE.get(device, (None, None))
        if ws is None or ws.numel() < plan.workspace_ints:
            ws = torch.empty(max(plan.workspace_ints, 1 << 20),
                             dtype=torch.int32, device=device)
        if tickets is None or tickets.numel() < plan.tiles:
            tickets = torch.zeros(max(plan.tiles, 4096), dtype=torch.int32,
                                  device=device)
        _WORKSPACE[device] = (ws, tickets)
        return ws, tickets


def _launch(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    build.refuse_grad("int8_matmul", x, w)
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
    if x.device.type == "meta":
        kernel_work("int8_matmul", io_bytes(x, w, out),
                    {"int8": 2 * m * n * k}, out.shape)
        return out
    vec = int(k % 16 == 0 and n % 4 == 0 and x.data_ptr() % 16 == 0
              and w.data_ptr() % 16 == 0)
    plan = split_plan(m, n, k)
    ws, tickets = _workspace(x.device, plan)
    lib = build.load("int8_matmul")
    fn = build.declare(lib, "int8_matmul", 5, 6)
    rc = build.launch(x.device, fn, x.data_ptr(), w.data_ptr(), out.data_ptr(),
                      ws.data_ptr(), tickets.data_ptr(), m, n, k, vec,
                      plan.tile, plan.splits)
    build.check(lib, rc, "int8_matmul launch")
    int8_matmul.launches += 1
    return out


def int8_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 x (K, N) int8 -> (M, N) int32, exact."""
    if x.device.type == "cpu":
        return int8_matmul_plain(x, w)
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"no int8_matmul kernel for device {x.device}")
    return _launch(x, w)


int8_matmul.launches = 0
