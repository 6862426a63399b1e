"""Training launcher, the port's counterpart of ``repro/launch/train.py``:
the single-device ``Trainer`` on the card unless ``--device cpu`` is
given. Prints the reference's JSON keys.

Examples::

  # smoke-scale run on the CPU:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2_0_5b \\
      --smoke --device cpu --steps 50

  # on the card, through the kernels (the exact norm's forward and
  # backward), or the plain versions with --ops-backend reference:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2_0_5b \\
      --smoke --steps 50

``--mesh`` (a data/model mesh) waits for training over a mesh
(ROADMAP.md queue 1 item 9.3) and raises.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Optional, Sequence

from repro_torch.configs.base import (ARCH_NAMES, SHAPES, ShapeConfig,
                                      get_config)
from repro_torch.ops import CHOICES
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.trainer import Trainer


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True,
                    help="a ported config: " + ", ".join(ARCH_NAMES))
    ap.add_argument("--shape", default="train_4k", choices=list(SHAPES))
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config + small shape (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--mesh", default="", help="e.g. 4,2 => (data, model)")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (cuda unless asked)")
    ap.add_argument("--ops-backend", choices=CHOICES, default="auto",
                    help="op backend: auto = the kernels on a CUDA device "
                         "(plain torch on the CPU), reference = the plain "
                         "versions everywhere, cuda = auto, refusing the "
                         "CPU")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = parse_args(argv)
    if args.mesh:
        raise NotImplementedError(
            "--mesh needs training over a mesh (ROADMAP.md queue 1 item "
            "9.3); the port trains on one device")
    cfg = dataclasses.replace(get_config(args.arch),
                              ops_backend=args.ops_backend)
    if args.smoke:
        cfg = cfg.smoke()
        shape = ShapeConfig("smoke", seq_len=64, global_batch=8, kind="train")
    else:
        shape = SHAPES[args.shape]
    opt = OptConfig(lr=args.lr, warmup_steps=min(100, args.steps // 10 + 1),
                    total_steps=args.steps)
    trainer = Trainer(cfg, shape, opt, device=args.device,
                      ckpt_dir=args.ckpt_dir, seed=args.seed)
    out = trainer.run(args.steps)
    res = {"arch": cfg.name, "steps": args.steps,
           "first_loss": out["metrics"][0]["loss"],
           "final_loss": out["final_loss"],
           "stragglers": len(out["stragglers"])}
    print(json.dumps(res, indent=2))
    return res


if __name__ == "__main__":
    main()
