"""Render the dry run's results into markdown tables (the counterpart of
``repro/roofline/report.py``).

Usage: PYTHONPATH=src python -m repro_torch.roofline.report [results_dir]

Three tables: every cell with its peak bytes and whether it fits one
80 GB H100 (``roofline.analysis.CARD_BYTES``, the card's
``total_memory``), the H100 roofline of the cells that ran, and the
skipped cells with their reasons.
"""
from __future__ import annotations

import glob
import json
import os
import sys
from typing import List, Optional, Sequence

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "roofline_results_torch")


def load(results_dir: str) -> List[dict]:
    rows = []
    for f in sorted(glob.glob(os.path.join(results_dir, "*.json"))):
        with open(f) as fh:
            rows.append(json.load(fh))
    return rows


def fmt_bytes(b) -> str:
    return f"{b / 1e9:.2f}"


def _next_action(r) -> str:
    """One sentence: what would move the dominant term down."""
    dom = r.get("dominant")
    shape = r["shape"]
    if dom == "memory":
        if shape == "train_4k":
            return ("fuse the softmax/mask chain and keep S^2 logits out "
                    "of memory (a flash kernel with a backward)")
        if shape.startswith("prefill"):
            return ("larger attention blocks, the online chain fused into "
                    "one kernel")
        return "8-bit KV pages (halve decode reads); dequant inside the kernel"
    if dom == "collective":
        return "overlap the tensor-parallel all-reduce with the products"
    return "raise arithmetic intensity (larger tiles per launch)"


def dryrun_table(rows) -> str:
    out = ["| arch | shape | status | params GB | state GB | peak GB | "
           "fits one 80 GB H100 | bound s | dominant | count s |",
           "|---|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        mem = r.get("memory", {})
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['status']} | "
            f"{fmt_bytes(mem['param_bytes']) if mem else '-'} | "
            f"{fmt_bytes(mem.get('state_bytes', 0) + mem.get('opt_bytes', 0)) if mem else '-'} | "
            f"{fmt_bytes(mem['peak_bytes']) if mem else '-'} | "
            f"{mem.get('fits_one_card', '-') if mem else '-'} | "
            f"{r['bound_s']:.4g} | {r['dominant']} | "
            f"{r.get('compile_s', 0):.1f} |" if mem else
            f"| {r['arch']} | {r['shape']} | {r['status']} | - | - | - | - "
            f"| - | - | {r.get('compile_s', 0):.1f} |")
    return "\n".join(out)


def roofline_table(rows, mesh: str = "single") -> str:
    out = ["| arch | shape | compute_s | memory_s | collective_s | dominant "
           "| MODEL_FLOPS | useful ratio | roofline frac | next action |",
           "|---|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        if r["mesh"] != mesh or r["status"] != "ok":
            continue
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['compute_s']:.4f} | "
            f"{r['memory_s']:.3f} | {r['collective_s']:.4f} | "
            f"{r['dominant']} | {r['model_flops']:.3e} | "
            f"{r['useful_ratio']:.3f} | {r['roofline_fraction']:.5f} | "
            f"{_next_action(r)} |")
    return "\n".join(out)


def skipped_table(rows) -> str:
    out = ["| arch | shape | reason |", "|---|---|---|"]
    for r in rows:
        if r["status"] == "skipped" and r["mesh"] == "single":
            out.append(f"| {r['arch']} | {r['shape']} | {r.get('reason')} |")
    return "\n".join(out)


def errors_table(rows) -> str:
    out = ["| arch | shape | error |", "|---|---|---|"]
    for r in rows:
        if r["status"] == "error":
            out.append(f"| {r['arch']} | {r['shape']} | {r.get('error')} |")
    return "\n".join(out)


def main(argv: Optional[Sequence[str]] = None) -> str:
    argv = sys.argv[1:] if argv is None else list(argv)
    rows = load(argv[0] if argv else RESULTS_DIR)
    text = "\n".join([
        "## Dry run (every cell, one H100)\n", dryrun_table(rows),
        "\n## Roofline (one H100 SXM, per step)\n",
        roofline_table(rows, "single"),
        "\n## Skipped cells\n", skipped_table(rows),
        "\n## Cells in error\n", errors_table(rows)])
    print(text)
    return text


if __name__ == "__main__":
    main()
