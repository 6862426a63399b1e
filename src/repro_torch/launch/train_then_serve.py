"""The paper's headline claim, end to end, the port's counterpart of
``examples/train_then_serve_sole.py``: train in float32 with the exact
softmax and norms, swap SOLE in at inference with NO retraining, and keep
accuracy.

Trains the reference example's small LM (qwen2_0_5b's smoke family cut to
2 layers, d 128, 4 heads of 32, d_ff 256, vocab 256) on the induction
(copy) task, 150 steps of batch 16 x 64 at lr 5e-3, then evaluates greedy
next-token accuracy over the second half of a held-out batch with exact
softmax/LayerNorm against SOLE. On the card the training step runs the
exact norm's kernels forward and backward and the SOLE evaluation runs
E2Softmax and the calibrating norm; ``--device cpu`` runs the plain
versions. Prints the reference's lines::

  PYTHONPATH=src python -m repro_torch.launch.train_then_serve
  PYTHONPATH=src python -m repro_torch.launch.train_then_serve --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Optional, Sequence

import torch

from repro_torch.configs.base import ShapeConfig, get_config
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.models import api
from repro_torch.models.state import tree_map
from repro_torch.ops import CHOICES
from repro_torch.train.optimizer import OptConfig, init_opt_state
from repro_torch.train.trainer import batch_to_device, make_train_step

STEPS = 150


def demo_configs(ops_backend: str = "auto"):
    """(SOLE serving config, exact training config) of the example."""
    cfg = dataclasses.replace(
        get_config("qwen2_0_5b").smoke(), n_layers=2, d_model=128,
        n_heads=4, head_dim=32, d_ff=256, vocab_size=256,
        ops_backend=ops_backend)
    train_cfg = dataclasses.replace(cfg, softmax_mode="exact",
                                    norm_mode="exact", logit_int8=False)
    return cfg, train_cfg


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=STEPS,
                    help="train steps (the schedule stays the example's)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ops-backend", choices=CHOICES, default="auto")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = parse_args(argv)
    device = torch.device(args.device)
    cfg, train_cfg = demo_configs(args.ops_backend)
    shape = ShapeConfig("demo", seq_len=64, global_batch=16, kind="train")
    pipe = SyntheticLM(cfg, shape.seq_len, shape.global_batch, 0, task="copy")

    # drawn on the host and moved: the same weights on every device
    params = tree_map(lambda t: t.to(device),
                      api.init_params(0, cfg, "cpu", masters=True))
    opt = init_opt_state(params)
    step = make_train_step(
        train_cfg, OptConfig(lr=5e-3, warmup_steps=10, total_steps=STEPS))
    losses = []
    for i in range(args.steps):
        batch = batch_to_device(pipe.batch_at(i), device)
        params, opt, m = step(params, opt, batch)
        losses.append(m["loss"])
        if i % 50 == 0:
            print(f"step {i:4d} loss {float(m['loss']):.3f}")

    test = batch_to_device(pipe.batch_at(10_000), device)
    half = shape.seq_len // 2

    def acc(eval_cfg):
        with torch.no_grad():
            logits = api.forward(params, test, eval_cfg, "serve")
        pred = torch.argmax(logits, -1)
        return float(torch.mean((pred == test["targets"].long())[:, half:]
                                .float()))

    a_exact = acc(train_cfg)
    a_sole = acc(cfg)  # E2Softmax + AILayerNorm, no retraining
    print(f"\ncopy-task accuracy  exact: {a_exact:.4f}   SOLE: {a_sole:.4f}")
    print(f"accuracy drop with SOLE, zero retraining: "
          f"{a_exact - a_sole:+.4f}  (paper claims < 0.009)")
    return {"exact": a_exact, "sole": a_sole, "drop": a_exact - a_sole,
            "losses": [float(v) for v in losses]}


if __name__ == "__main__":
    main()
