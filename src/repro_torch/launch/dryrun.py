"""Single-card dry run: every (arch x shape) cell counted on the meta
device, the counterpart of ``repro/launch/dryrun.py``.

For each cell this builds the port's real train/prefill/decode step on
``meta`` tensors (shapes and dtypes, no storage), runs it once under the
cost counter (``roofline/cost.py``) and records:

  * the parameter, optimizer, state and batch bytes, the peak of bytes
    alive during the step (``peak_bytes``: what
    ``torch.cuda.max_memory_allocated`` should read on the card) and
    whether it fits one 80 GB H100;
  * the counter's FLOPs by type and bytes, and the H100 roofline terms
    (``roofline/analysis.py``).

Train cells run the loss, its backward and the AdamW update through
``train.trainer.make_train_step`` on float32 masters, as the ``Trainer``
holds them; prefill cells ``models.api.prefill``; decode cells one
``decode_step`` on the family's dense cache, or with ``--paged`` one
``decode_step_paged`` on its page pools and state slots. Serving
parameters are cast as the reference's dry run casts them (every float32
leaf to ``cfg.dtype``). Nothing is allocated, so it runs on a machine
with no GPU.

Results are written one JSON file per cell (atomic) under
``roofline_results_torch/`` and rendered by
``python -m repro_torch.roofline.report``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2_0_5b \\
      --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--paged]

``--mesh multi`` (the reference's 2 x 16 x 16 pods) waits for the dry
run's mesh cells (ROADMAP.md queue 1 item 9.4) and raises.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from typing import Dict, Optional, Sequence

import torch

from repro_torch.configs.base import (ARCH_NAMES, SHAPES, ArchConfig,
                                      ShapeConfig, get_config)
from repro_torch.models import api
from repro_torch.models.state import leaves
from repro_torch.roofline.analysis import CARD_BYTES, make_roofline
from repro_torch.roofline.cost import CostCounter, nbytes
from repro_torch.train.optimizer import OptConfig, init_opt_state
from repro_torch.train.trainer import make_train_step

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "roofline_results_torch")


def tree_bytes(tree) -> int:
    """Bytes of the tensors of a nested dict (python scalars: none)."""
    return sum(nbytes(t) for t in leaves(tree) if isinstance(t, torch.Tensor))


def serve_params(cfg: ArchConfig):
    """Serving parameters on meta, every float32 leaf in ``cfg.dtype``
    (the reference's ``_serve_params``)."""
    dt = getattr(torch, cfg.dtype)

    def cast(node):
        if isinstance(node, dict):
            return {k: cast(v) for k, v in node.items()}
        return node.to(dt) if node.dtype == torch.float32 else node
    return cast(api.init_params(0, cfg, "meta"))


def train_cell(cfg: ArchConfig, shape: ShapeConfig):
    """(step thunk, {bytes of what stays resident}) of one train step."""
    params = api.init_params(0, cfg, "meta", masters=True)
    opt = init_opt_state(params)
    batch, _ = api.train_inputs(cfg, shape)
    step = make_train_step(cfg, OptConfig())
    parts = {"param_bytes": params, "opt_bytes": opt, "batch_bytes": batch}
    return (lambda: step(params, opt, batch)), parts


def prefill_cell(cfg: ArchConfig, shape: ShapeConfig):
    params = serve_params(cfg)
    batch, _ = api.prefill_inputs(cfg, shape)
    tokens = batch if cfg.family in ("encdec", "vlm") else batch["tokens"]
    parts = {"param_bytes": params, "batch_bytes": batch}
    return (lambda: api.prefill(params, tokens, cfg, shape.seq_len)), parts


def decode_cell(cfg: ArchConfig, shape: ShapeConfig):
    params = serve_params(cfg)
    cache, _, token, _ = api.decode_inputs(cfg, shape)
    parts = {"param_bytes": params, "state_bytes": cache,
             "batch_bytes": token}
    # the dense-slot decode takes its write column on the host: the last
    return (lambda: api.decode_step(params, cache, token, shape.seq_len - 1,
                                    cfg)), parts


def paged_decode_cell(cfg: ArchConfig, shape: ShapeConfig):
    params = serve_params(cfg)
    state, _, token, pos, refs = api.paged_decode_inputs(cfg, shape)
    parts = {"param_bytes": params, "state_bytes": state,
             "batch_bytes": {"token": token, "pos": pos, "refs": refs}}
    return (lambda: api.decode_step_paged(params, token, pos, refs, state,
                                          cfg)), parts


def count_cell(cfg: ArchConfig, shape: ShapeConfig, paged: bool = False):
    """(counter, {part: bytes}) of one meta run of the cell's step."""
    if shape.kind == "train":
        thunk, parts = train_cell(cfg, shape)
    elif shape.kind == "prefill":
        thunk, parts = prefill_cell(cfg, shape)
    elif paged:
        thunk, parts = paged_decode_cell(cfg, shape)
    else:
        thunk, parts = decode_cell(cfg, shape)
    counter = CostCounter()
    with counter:
        for tree in parts.values():
            counter.resident(tree)
        if shape.kind == "train":
            thunk()
        else:
            with torch.no_grad():
                thunk()
    return counter, {k: tree_bytes(v) for k, v in parts.items()}


def configure(arch: str, overrides: Optional[Dict[str, str]] = None
              ) -> ArchConfig:
    """The arch's config with ``--set`` overrides, typed as the field."""
    cfg = get_config(arch)
    typed = {}
    for k, val in (overrides or {}).items():
        cur = getattr(cfg, k)
        typed[k] = type(cur)(val) if cur is not None else val
    return dataclasses.replace(cfg, **typed)


def run_cell(arch: str, shape_name: str, mesh_kind: str = "single",
             out_dir: str = RESULTS_DIR, overrides: dict = None,
             tag: str = "", paged: bool = False) -> dict:
    if mesh_kind != "single":
        raise NotImplementedError(
            f"--mesh {mesh_kind} needs the dry run's mesh cells "
            "(ROADMAP.md queue 1 item 9.4); the dry run counts one card")
    cfg = configure(arch, overrides)
    shape = SHAPES[shape_name]
    t0 = time.time()
    result = {"arch": arch + ("+paged" if paged else "")
              + (f"+{tag}" if tag else ""), "shape": shape_name,
              "mesh": mesh_kind, "status": "ok", "overrides": overrides or {}}
    if shape_name in cfg.skip_shapes:
        result["status"] = "skipped"
        result["reason"] = ("full-attention arch: 500k-token decode is not "
                            "sub-quadratic (DESIGN.md §4)"
                            if shape_name == "long_500k" else "per config")
        _write(out_dir, result)
        return result
    if (paged and shape.kind == "decode"
            and not api.sequence_state_spec(cfg).servable):
        result["status"] = "skipped"
        result["reason"] = (f"family {cfg.family!r} is not paged-servable "
                            "(see its sequence_state_spec)")
        _write(out_dir, result)
        return result
    try:
        counter, parts = count_cell(cfg, shape, paged=paged)
        cost = counter.cost
        row = make_roofline(cfg, shape, mesh_kind, 1, cost).row()
        row["arch"] = result["arch"]      # keep the +tag suffix
        result.update(row)
        peak = int(cost.peak_bytes)
        result["memory"] = dict(parts, peak_bytes=peak,
                                per_device_bytes=peak, card_bytes=CARD_BYTES,
                                fits_one_card=bool(peak < CARD_BYTES))
        result["cost"] = cost.row()
        result["compile_s"] = time.time() - t0
    except Exception as e:  # a failing cell is a bug: record it loudly
        result["status"] = "error"
        result["error"] = f"{type(e).__name__}: {e}"
        result["traceback"] = traceback.format_exc()[-4000:]
        result["compile_s"] = time.time() - t0
    _write(out_dir, result)
    return result


def _write(out_dir: str, result: dict) -> None:
    os.makedirs(out_dir, exist_ok=True)
    name = f"{result['arch']}__{result['shape']}__{result['mesh']}.json"
    tmp = os.path.join(out_dir, name + ".tmp")
    with open(tmp, "w") as f:
        json.dump(result, f, indent=1, default=str)
    os.replace(tmp, os.path.join(out_dir, name))


def main(argv: Optional[Sequence[str]] = None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default=RESULTS_DIR)
    ap.add_argument("--set", action="append", default=[],
                    help="config override key=value (e.g. kv_cache_dtype=int8)")
    ap.add_argument("--tag", default="", help="suffix for the result name")
    ap.add_argument("--paged", action="store_true",
                    help="decode cells use the paged sequence-state step "
                         "(page pools + state slots) instead of the dense "
                         "cache")
    args = ap.parse_args(argv)
    overrides = dict(kv.split("=", 1) for kv in getattr(args, "set"))
    if args.mesh != "single":
        raise NotImplementedError(
            f"--mesh {args.mesh} needs the dry run's mesh cells "
            "(ROADMAP.md queue 1 item 9.4); the dry run counts one card")
    archs = ARCH_NAMES if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) else [args.shape]
    results = []
    for arch in archs:
        for shape in shapes:
            r = run_cell(arch, shape, args.mesh, args.out,
                         overrides=overrides, tag=args.tag, paged=args.paged)
            results.append(r)
            mem = r.get("memory", {})
            fits = mem.get("fits_one_card", "-")
            print(f"[{r['status']:>7}] {arch:20s} {shape:12s} "
                  f"{args.mesh:6s} dominant={r.get('dominant', '-')} "
                  f"peak={mem.get('peak_bytes', 0) / 1e9:.2f}GB fits={fits} "
                  f"t={r.get('compile_s', 0):.1f}s {r.get('error', '')}",
                  flush=True)
    return results


if __name__ == "__main__":
    main()
