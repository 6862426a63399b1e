"""Quickstart: SOLE's E2Softmax + AILayerNorm as drop-in ops, on the card
unless ``--device cpu`` is given.

The port's counterpart of ``examples/quickstart.py``: the same steps, at
the same shapes, on the same numpy inputs. On the card the op calls go
through the hand-written kernels (E2Softmax, the AILayerNorm
quantize+norm, the dense Flash-E2Softmax); on the CPU through their plain
versions::

  PYTHONPATH=src python -m repro_torch.launch.quickstart
  PYTHONPATH=src python -m repro_torch.launch.quickstart --device cpu
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import ops
from repro_torch.core.sole.ailayernorm import dynamic_compress
from repro_torch.core.sole.e2softmax import e2softmax
from repro_torch.core.sole.quant import calibrate_ptf


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    dev = torch.device(ap.parse_args(argv).device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run the "
                           "kernels' plain versions")
    kernel = "cuda kernel" if dev.type == "cuda" else "plain kernel version"

    def tensor(a):
        return torch.from_numpy(a.astype(np.float32)).to(dev)

    rng = np.random.default_rng(0)

    # --- E2Softmax: 4-bit log2-quantized softmax, no retraining needed -----
    logits = tensor(rng.normal(0, 3, (4, 785)))
    exact = torch.softmax(logits, -1)
    sole = e2softmax(logits)                   # paper Alg. 1 (two-pass form)
    print("E2Softmax vs exact:")
    print(f"  mean |err| = {(sole - exact).abs().mean().item():.2e}")
    print(f"  row sums   = {sole.sum(-1).cpu().numpy()[:4].round(3)}")

    # --- the same op as a hand-written kernel ------------------------------
    k_out = ops.softmax_fn("sole", dev)(logits)
    print(f"  {kernel} max |diff| vs torch path = "
          f"{(k_out - sole).abs().max().item():.2e}")

    # --- AILayerNorm: integer statistics on PTF-quantized activations ------
    x = tensor(rng.normal(0.5, 2.0, (8, 768)))
    g = torch.ones(768, device=dev)
    b = torch.zeros(768, device=dev)
    ln_exact = ops.layernorm_fn("exact", dev)(x, g, b)
    ln_sole = ops.layernorm_fn("sole", dev)(x, g, b)
    rel = (torch.sqrt(((ln_sole - ln_exact) ** 2).mean())
           / torch.sqrt((ln_exact ** 2).mean())).item()
    print(f"\nAILayerNorm rel RMSE vs exact LayerNorm: {rel:.4f}")
    params = calibrate_ptf(x, unsigned=True)
    print(f"  PTF alphas used: {sorted(set(params.alpha.tolist()))}")
    y4, s1 = dynamic_compress(torch.arange(256, device=dev))
    print(f"  dynamic compression: 8-bit -> 4-bit codes, max code "
          f"{int(y4.max())}, shift flag in {set(s1.tolist())}")

    # --- fused Flash-E2Softmax attention (beyond-paper) --------------------
    B, S, H, hd = 1, 128, 4, 32
    q, k, v = (tensor(rng.normal(0, 1, (B, S, H, hd))) for _ in range(3))
    out = ops.flash_attention_fn("sole", dev)(q, k, v, causal=True, block=64)
    print(f"\nFlash-E2Softmax attention output: {tuple(out.shape)}, "
          f"finite={bool(torch.isfinite(out).all())}")
    print("done.")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
