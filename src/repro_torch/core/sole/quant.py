"""Power-of-Two Factor (PTF) quantization — FQ-ViT, SOLE paper Eq. (6).

    X_Q = Clip(round(X / (2^alpha * s)) + zp, 0, 2^b - 1)

with a shared (s, zp) per tensor and a per-channel 2-bit alpha in {0..3}.

Bit-compatibility with the reference: ``calibrate_ptf`` runs in the
activation's own dtype, as the reference does (on bf16 activations the
scale is bf16 and ``log2``/``ceil`` run in bf16). Every division is a
true division by a tensor of the divisor's value: PyTorch's CUDA kernel
turns a division by a Python scalar into a multiply by its reciprocal,
which rounds differently.
"""
from __future__ import annotations

import dataclasses

import torch


def true_div(x: torch.Tensor, value: float) -> torch.Tensor:
    """``x / value`` as a correctly rounded elementwise division in
    ``x``'s dtype (never a multiply by the reciprocal)."""
    return x / torch.full_like(x, value)


def log2_quantize(x: torch.Tensor, bits: int = 4) -> torch.Tensor:
    """Paper Eq. (2): ``Log2Q(X) = clip(round(-log2 X), 0, 2^b - 1)`` for X
    in (0, 1): the int32 code k with X ~= 2^-k."""
    k = torch.round(-torch.log2(torch.clamp_min(x, 1e-38)))
    return torch.clamp(k, 0, 2 ** bits - 1).to(torch.int32)


def log2_dequantize(k: torch.Tensor) -> torch.Tensor:
    """``2^-k`` in float32, exact: built from the exponent bits (k in
    [0, 126])."""
    return ((127 - k.to(torch.int32)) << 23).view(torch.float32)


@dataclasses.dataclass(frozen=True)
class AffineQuantParams:
    """Per-tensor affine int8 quantization parameters."""

    scale: torch.Tensor       # 0-dim, the calibrated tensor's dtype
    zero_point: torch.Tensor  # 0-dim int32

    def quantize(self, x: torch.Tensor, *,
                 unsigned: bool = False) -> torch.Tensor:
        lo, hi = (0, 255) if unsigned else (-128, 127)
        q = torch.round(x / self.scale) + self.zero_point
        return torch.clamp(q, lo, hi).to(torch.int32)

    def dequantize(self, q: torch.Tensor) -> torch.Tensor:
        return (q.float() - self.zero_point) * self.scale


def calibrate_affine(x: torch.Tensor, *, unsigned: bool = False,
                     symmetric: bool = True) -> AffineQuantParams:
    """Min/max calibration of a per-tensor int8 quantizer, in ``x``'s
    dtype, with true divisions (the reference runs it eagerly)."""
    if symmetric and not unsigned:
        amax = torch.clamp_min(x.abs().amax(), 1e-8)
        return AffineQuantParams(
            scale=true_div(amax, 127.0),
            zero_point=torch.zeros((), dtype=torch.int32, device=x.device))
    xmin = torch.clamp_max(x.amin(), 0.0)
    xmax = torch.maximum(x.amax(), xmin + 1e-8)
    scale = true_div(xmax - xmin, 255.0)
    zp = torch.round(-xmin / scale).to(torch.int32)
    return AffineQuantParams(scale=scale, zero_point=zp)


def fake_quant_int8(x: torch.Tensor, *, symmetric: bool = True
                    ) -> torch.Tensor:
    """Quantize-dequantize round trip (simulated int8 matmul inputs)."""
    p = calibrate_affine(x, symmetric=symmetric)
    return p.dequantize(p.quantize(x))


@dataclasses.dataclass(frozen=True)
class PTFQuantParams:
    scale: torch.Tensor       # 0-dim, the calibrated activation's dtype
    zero_point: int           # 128 (unsigned codes) or 0 (symmetric)
    alpha: torch.Tensor       # int32 [C], per-channel power-of-two factor
    unsigned: bool = True

    def denom(self) -> torch.Tensor:
        """Per-channel divisor ``s * 2^alpha`` in float32 (exact: a
        power-of-two multiple of the promoted scale)."""
        return self.scale.float() * torch.exp2(self.alpha.float())

    def quantize(self, x: torch.Tensor) -> torch.Tensor:
        lo, hi = (0, 255) if self.unsigned else (-128, 127)
        q = torch.round(x.float() / self.denom()) + self.zero_point
        return torch.clamp(q, lo, hi).to(torch.int32)


def calibrate_ptf(x: torch.Tensor, *, max_alpha: int = 3,
                  unsigned: bool = True) -> PTFQuantParams:
    """FQ-ViT-style PTF calibration over the last axis (channels),
    reducing over **all** leading axes — in SOLE mode a row's codes
    depend on the whole batch it was normalized with.

    Channel ranges are symmetric around zero: the shared base scale is
    the widest channel's ``amax / 127`` divided by ``2^max_alpha``, and
    each channel takes the smallest alpha whose ``2^alpha * s`` covers
    its range.
    """
    amax = x.abs()
    if x.ndim > 1:
        amax = amax.flatten(0, -2).amax(0)
    ideal = true_div(torch.maximum(amax, torch.full_like(amax, 1e-8)), 127.0)
    scale = true_div(ideal.amax(), float(2 ** max_alpha))
    ratio = ideal / scale.expand_as(ideal)
    expo = torch.log2(ratio)
    expo = torch.ceil(expo - torch.full_like(expo, 1e-6))
    alpha = torch.clamp(expo, 0, max_alpha).to(torch.int32)
    return PTFQuantParams(scale=scale, zero_point=128 if unsigned else 0,
                          alpha=alpha, unsigned=unsigned)


# -- W8A8 serving primitives --------------------------------------------------
#
# Weights: per-output-channel symmetric int8, the scale reducing over the
# matmul's contraction axes (the leading axes of every serve-path weight),
# so it applies once after the int8 dot. Activations: dynamic per-row
# symmetric int8 over the contracted trailing axes. Codes are
# ``round(x / scale)`` (half to even) in float32, clipped to +-127.
#
# The two scales follow the reference as it runs. The engine packs weights
# eagerly: ``where(amax > 0, amax, 1) / 127`` in the weight's dtype, then
# float32. Activations are quantized inside the jitted model steps, where
# XLA rewrites the division by the constant 127 into a float32 multiply by
# its rounded reciprocal (and computes a bf16 amax in float32): the scale
# is ``float32(amax) * float32(1 / 127)``, which differs from the division
# in the last bit for ~5% of rows. Per-row codes of a SOLE norm's output
# sit exactly on rounding ties often enough that the last bit decides
# codes, so the port takes the jitted form.

_INV_127 = torch.tensor(1.0 / 127.0, dtype=torch.float32)


def is_qtensor(x) -> bool:
    """A packed int8 weight: ``{"q": codes, "s": scale}`` and nothing else."""
    return isinstance(x, dict) and set(x.keys()) == {"q", "s"}


def _nonzero(amax: torch.Tensor) -> torch.Tensor:
    return torch.where(amax > 0, amax, torch.ones_like(amax))


def _codes(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    q = torch.round(x.float() / scale)
    return torch.clamp(q, -127, 127).to(torch.int8)


def quantize_weight(w: torch.Tensor, n_contract: int = 1, *,
                    offset: int = 0) -> dict:
    """Per-output-channel symmetric int8 over the ``n_contract``
    contraction axes starting at ``offset`` (``offset`` > 0 skips leading
    stacking axes such as ``layers``). Returns ``{"q": int8 codes, "s":
    float32 scale}``, the scale keeping the contraction axes as size 1."""
    axes = tuple(range(offset, offset + n_contract))
    amax = w.abs().amax(dim=axes, keepdim=True)
    scale = true_div(_nonzero(amax), 127.0).float()
    return {"q": _codes(w, scale), "s": scale}


def dequantize_weight(qw: dict) -> torch.Tensor:
    return qw["q"].float() * qw["s"]


def quantize_act(x: torch.Tensor, n_contract: int = 1):
    """Dynamic per-row symmetric int8 over the trailing ``n_contract``
    axes: ``(int8 codes, float32 scale)``, the scale keeping the reduced
    axes as size 1."""
    axes = tuple(range(x.ndim - n_contract, x.ndim))
    amax = _nonzero(x.abs().amax(dim=axes, keepdim=True)).float()
    scale = amax * _INV_127.to(amax.device)
    return _codes(x, scale), scale
