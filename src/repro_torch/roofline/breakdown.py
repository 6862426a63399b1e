"""Per-op breakdown of a cell: the ops of one step with the most bytes or
FLOPs, from the cost counter's records (the counterpart of
``repro/roofline/breakdown.py``, which reads a compiled HLO).

Usage:
  PYTHONPATH=src python -m repro_torch.roofline.breakdown \\
      --arch mixtral_8x7b --shape prefill_32k [--metric bytes|flops|coll]
      [--top 20] [--paged]

A row is one (op, output shape): an aten op, or ``kernel:<name>`` for a
hand-written kernel's launch, with its calls (a trip-counted loop's
multiplied), bytes or FLOPs and share of the step's total. ``coll`` has
nothing on one card (the dry run's mesh cells: ``ROADMAP.md`` queue 1
item 9.4).
"""
from __future__ import annotations

import argparse
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.configs.base import SHAPES
from repro_torch.launch.dryrun import configure, count_cell


def breakdown(records: Dict[Tuple[str, str], List[float]],
              metric: str = "bytes", top: int = 20) -> str:
    """The ``top`` rows of ``records`` ((op, shape) -> [calls, bytes,
    flops]) by ``metric``, as text."""
    col = {"bytes": 1, "flops": 2, "coll": None}[metric]
    rows = [] if col is None else sorted(
        ((v[col], v[0], op, shape) for (op, shape), v in records.items()
         if v[col]), reverse=True)
    total = sum(r[0] for r in rows) or 1.0
    lines = [f"total {metric}: {sum(r[0] for r in rows):.4e}"]
    for v, calls, op, shape in rows[:top]:
        lines.append(f"{v:12.4e} {v / total * 100:5.1f}% {calls:9.0f}x  "
                     f"{op:32s} {shape[:44]}")
    return "\n".join(lines)


def main(argv: Optional[Sequence[str]] = None) -> str:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True, choices=list(SHAPES))
    ap.add_argument("--metric", default="bytes",
                    choices=["bytes", "flops", "coll"])
    ap.add_argument("--top", type=int, default=20)
    ap.add_argument("--paged", action="store_true")
    args = ap.parse_args(argv)
    counter, _ = count_cell(configure(args.arch), SHAPES[args.shape],
                            paged=args.paged)
    text = breakdown(counter.records, args.metric, args.top)
    print(text)
    return text


if __name__ == "__main__":
    main()
