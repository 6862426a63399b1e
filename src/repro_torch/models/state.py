"""Paged *sequence state*: what one sequence's serve-time state is for a
model family (the port's copy of ``repro.models.state``, pages only —
recurrent state slots and cross-attention pages come with the other
families).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class SequenceStateSpec:
    """``kv_layers`` layers of paged self-attention KV, whether the
    family's pages may be shared through the prefix cache, and whether its
    state can rewind rejected speculative drafts (pages can: ``truncate``
    hands the tail back)."""
    family: str
    kv_layers: int = 0
    supports_prefix_cache: bool = False
    supports_spec_decode: bool = False
