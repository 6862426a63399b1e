"""Mixture-of-Experts FFN (mixtral / dbrx): the router, sort-based
capacity dispatch, the expert products over the reference's (E, capacity,
d) buffer and a combine in the reference's order; and the MoE model, which
is the dense backbone (``models/transformer.py``) with this FFN in place
of the MLP.

Counterpart of ``repro/models/moe.py``. On one device the local branch;
under mesh rules (``sharding.rules.use_rules``) each rank holds the
experts ``convert.shard_params`` gave it (``experts`` over ``data``,
``expert_ff`` over ``model``) and the FFN takes one of three routes
(:func:`apply_moe_ffn`):

* (a) expert parallelism, the dispatch's lanes split over data
  (``layers.data_split``): each data rank routes and dispatches its own
  tokens, one ``all_to_all`` over data sends each expert's rows to its
  owner, the rank runs its experts on every source's rows, a second
  ``all_to_all`` brings the rows back and the combine runs in source
  order, as the reference's ``_moe_inner`` does;
* (b) the batch replicated over data while the experts lie over it (a B
  = 1 prefill chunk; a dense-slot batch D does not divide): each rank
  dispatches the whole batch as one card does, runs its experts' rows of
  the buffer only, combines their contributions (the other experts' rows
  zero, in the combine's order) and one sum over data joins the ranks'
  (T, d) partials. The reference cannot take this case (its weight specs
  keep the experts over data while its EP fallback gives each shard the
  whole buffer, and the einsum's expert counts disagree); with top-2
  routing a token has at most two non-zero terms, so the float32 sum of
  the partials rounds as one card's combine does, bit for bit;
* (c) tensor parallelism over model: ``gate``/``up`` column-parallel on
  the rank's ``d_ff / M`` columns, ``down`` row-parallel with float32
  partials, the combine in float32, one sum over model of the (T, d)
  output and one cast to the model dtype (the dense TP forms' rounding,
  ``layers.apply_mlp``). It composes with (a) or (b).

The aux loss is the rank's own (its tokens' routing); its mean over the
data axis is training's, ROADMAP.md queue 1 item 9.3.

Where the bits would part from the reference unless taken care of:

* top-k: ``jax.lax.top_k`` puts the lower expert index first among equal
  gates; ``torch.topk`` promises no order among ties, so a stable
  descending sort is taken and its first k kept;
* dispatch: ``argsort(stable=True)`` by expert, per-expert counts
  (``scatter_add_``) and ``cumsum`` slot positions, tokens past an
  expert's capacity dropped in routing order;
* combine: the reference scatter-adds each token's contributions into a
  zero buffer of the activation dtype in sorted order, i.e. ascending
  expert id, one rounding per add; ``index_add_`` on the card uses
  atomics in no fixed order, so the (T, k) block of contributions is
  gathered in that order and added left to right;
* the gates are cast to the activation dtype before the combine; the
  router's logits are the model-dtype product with a float32 result (the
  reference casts the product to float32, and inside ``jit`` XLA folds
  that cast into the dot, so bf16 logits are never rounded to bf16),
  softmaxed in float32 (the exact softmax: SOLE targets the attention
  softmax).

The paged serve path pins capacity to the dispatch's token count (every
data rank's lanes: drop-free), which makes a row's output independent of
its batch; the dense-slot path uses the capacity-factor formula on the
tokens the rank dispatches (its lanes under route (a), as the reference's
formula inside ``shard_map``), so tokens can drop there, and on a data
axis they can drop otherwise than on one card: the reference's mesh
semantics.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.state import SequenceStateSpec
from repro_torch.sharding import comm
from repro_torch.sharding.rules import active_rules


def init_moe_ffn(gen: torch.Generator, cfg: ArchConfig, device) -> Dict:
    """The stacked expert weights, normal x 0.02 in the serving dtype:
    router (L, d, E), gate/up (L, E, d, f), down (L, E, f, d). Each layer
    is drawn on its own: one float32 draw of mixtral's whole gate stack
    would take 30 GB."""
    w, mw = T._weights(gen, cfg, device)
    n, d, f, e = cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.n_experts
    dt = L.torch_dtype(cfg.dtype)
    master = torch.float32 if cfg.quant.weights else dt
    return {"router": T.stacked(w, n, (d, e), dt, device),
            "gate": T.stacked(mw, n, (e, d, f), master, device),
            "up": T.stacked(mw, n, (e, d, f), master, device),
            "down": T.stacked(mw, n, (e, f, d), master, device)}


def route(x2: torch.Tensor, wr: torch.Tensor, k: int, stable: bool = False):
    """Router over tokens x2 (T, D): ``(gates (T, E) float32, top-k gates
    renormalised (T, k) float32, top-k expert ids (T, k))``. The logits
    are the float32 product of the model-dtype operands (exact products,
    float32 sums; ``stable``: through ``layers.stable_mm``), softmaxed in
    float32; ties keep the lower expert id first, as ``jax.lax.top_k``
    does."""
    if stable:
        logits = L.stable_mm(x2.float(), wr.float())
    else:
        logits = x2.float() @ wr.float()
    ex = torch.exp(logits - logits.amax(-1, keepdim=True))
    gates = ex / ex.sum(-1, keepdim=True)
    vals, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    top_val, top_idx = vals[:, :k], idx[:, :k]
    return gates, top_val / top_val.sum(-1, keepdim=True), top_idx


def dispatch(x2: torch.Tensor, top_idx: torch.Tensor, top_val: torch.Tensor,
             n_experts: int, capacity: int):
    """Sort-based capacity dispatch (``_dispatch_local``): the (E *
    capacity, D) expert buffer and what the combine needs, ``(order,
    dest, keep, gate)`` per routed (token, slot) entry in sorted order.
    Entries past their expert's capacity are dropped in routing order
    (token order within an expert)."""
    t, k = top_idx.shape
    dev = x2.device
    flat_e = top_idx.reshape(-1)
    flat_t = torch.arange(t, device=dev).repeat_interleave(k)
    order = torch.argsort(flat_e, stable=True)
    se, st, sg = flat_e[order], flat_t[order], top_val.reshape(-1)[order]
    # a static-length count: bincount reads its length back from the data
    counts = torch.zeros(n_experts, dtype=flat_e.dtype,
                         device=dev).scatter_add_(0, flat_e,
                                                  torch.ones_like(flat_e))
    starts = torch.cumsum(counts, 0) - counts
    pos_in_e = torch.arange(t * k, device=dev) - starts[se]
    keep = pos_in_e < capacity
    dest = torch.where(keep, se * capacity + pos_in_e, n_experts * capacity)
    buf = torch.zeros((n_experts * capacity + 1, x2.shape[1]),
                      dtype=x2.dtype, device=dev)
    # dropped entries all land on the extra last row, which is cut off
    buf[dest] = x2[st] * keep[:, None].to(x2.dtype)
    return buf[:-1], (order, dest, keep, sg)


def combine(ye: torch.Tensor, info, top_idx: torch.Tensor,
            dtype: torch.dtype) -> torch.Tensor:
    """``_combine_local`` in the reference's order: each entry's expert
    row times its gate (zero if dropped) in ``ye``'s dtype, then per token
    a zero of ``dtype`` plus its k contributions in ascending expert id,
    each add rounded to ``dtype`` (the sorted scatter-add's order)."""
    order, dest, keep, sg = info
    t, k = top_idx.shape
    pad = torch.zeros((1, ye.shape[1]), dtype=ye.dtype, device=ye.device)
    ye_pad = torch.cat([ye, pad], 0)
    contrib = ye_pad[torch.where(keep, dest, ye.shape[0])]
    contrib = (contrib * (sg * keep).to(ye.dtype)[:, None]).to(dtype)
    # sorted position of each (token, slot) entry, slots by ascending id
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.numel(), device=order.device)
    slots = torch.argsort(top_idx, dim=1)
    rows = torch.arange(t, device=top_idx.device)[:, None] * k
    block = contrib[inv[rows + slots]]                      # (T, k, D)
    out = torch.zeros((t, ye.shape[1]), dtype=dtype, device=ye.device)
    for j in range(k):
        out = out + block[:, j]
    return out


def expert_ffn(xe: torch.Tensor, wg, wu, wd, cfg: ArchConfig,
               stable: bool = False, out32: bool = False) -> torch.Tensor:
    """(E, C, D) dispatched rows through each expert's gated FFN: SwiGLU,
    else tanh-GELU gating, in the activation dtype -> (E, C, D).
    ``stable`` (C a multiple of ``layers.ROW_TILE``): one set of products
    of (E, ROW_TILE, D) rows per tile of the capacity, so each row's
    result is the same whatever C and its slot. ``out32``: ``down``'s
    product in float32, rounded once (a row-parallel partial)."""
    if stable and xe.shape[1] > L.ROW_TILE:
        return torch.cat([_expert_products(t.contiguous(), wg, wu, wd, cfg,
                                           out32)
                          for t in xe.split(L.ROW_TILE, 1)], 1)
    return _expert_products(xe, wg, wu, wd, cfg, out32)


def _bmm(a: torch.Tensor, w: torch.Tensor, out32: bool) -> torch.Tensor:
    """``torch.bmm``; ``out32`` as ``layers.mm``'s."""
    if not out32 or a.dtype == torch.float32:
        return torch.bmm(a, w)
    if a.device.type == "cuda":
        return torch.bmm(a, w, out_dtype=torch.float32)
    return torch.bmm(a.float(), w.float())


def _expert_products(xe, wg, wu, wd, cfg: ArchConfig,
                     out32: bool = False) -> torch.Tensor:
    h = torch.bmm(xe, wg)
    if cfg.mlp_kind == "swiglu":
        h = F.silu(h) * torch.bmm(xe, wu)
    else:
        h = F.gelu(h, approximate="tanh") * torch.bmm(xe, wu)
    return _bmm(h, wd, out32)


def mesh_routes(cfg: ArchConfig):
    """The FFN's mesh axes under the active rules: ``(ep, replicated,
    tp)``. ``ep``: the data axis the experts lie over, the lanes split
    over it too (route (a)); ``replicated``: that axis where the batch is
    whole on every data rank (route (b)); ``tp``: the model axis
    ``d_ff`` is split over (route (c)). Nones without rules or where a
    dim replicates."""
    rules = active_rules()
    if rules is None:
        return None, None, None
    tp = L.model_split("expert_ff", cfg.d_ff)
    if rules.split("experts", cfg.n_experts) == 1:
        return None, None, tp
    ax = comm.data_axis(rules)
    if L.split_lanes() is not None:
        return ax, None, tp
    return None, ax, tp


def apply_moe_ffn(p, x: torch.Tensor, cfg: ArchConfig, phase: str,
                  capacity: Optional[int] = None, stable: bool = False
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """MoE FFN of x (B, S, D): ``(out (B, S, D), Switch load-balance aux
    loss)``. ``capacity`` overrides the per-expert depth
    ``ceil(T * top_k * capacity_factor / E)``; ``capacity >= T`` is
    drop-free (an expert sees each token at most once), so each row's
    output is then independent of the rows beside it. ``stable`` (a
    decode or verify dispatch on the card) rounds the capacity up to a
    multiple of ``layers.ROW_TILE`` and runs the router and the experts'
    products on fixed row counts, so a row's bits do not depend on T or
    on its slot in the expert buffer either.

    Under mesh rules the rank's experts (``p`` holds their slices) run on
    the route :func:`mesh_routes` names, as the module docstring sets
    out; ``capacity`` must then be the same on every data rank of route
    (a)."""
    if any(isinstance(p[n], dict) for n in ("gate", "up", "down")):
        raise NotImplementedError(
            "MoE experts with packed int8 weights: the reference has no "
            "quantized MoE path either (repro/models/moe.py:155-156 casts "
            "the packed leaves and fails)")
    b, s, d = x.shape
    t = b * s
    e, k = cfg.n_experts, cfg.top_k
    x2 = x.reshape(t, d)
    gates, top_val, top_idx = route(x2, p["router"], k, stable)
    cap = capacity
    if cap is None:
        cap = max(int(math.ceil(t * k * cfg.capacity_factor / e)), 1)
    if stable:
        cap = -(-cap // L.ROW_TILE) * L.ROW_TILE
    ep, rep, tp = mesh_routes(cfg)
    xe, info = dispatch(x2, top_idx, top_val.to(x2.dtype), e, cap)
    xe = xe.reshape(e, cap, d)
    wg, wu, wd = p["gate"], p["up"], p["down"]
    e_loc = wg.shape[0]
    over = ep or rep
    if e_loc != (e if over is None else e // over.size):
        raise ValueError(
            f"MoE FFN: {e_loc} experts on this rank, the rules lay "
            f"{e} over {1 if over is None else over.size} ranks (the "
            "weights must be the rank's slice: convert.shard_params)")
    out32 = tp is not None
    if ep is not None:                   # (a): every source's rows, mine
        xr = comm.all_to_all(xe.reshape(ep.size, e_loc * cap, d), ep)
        xr = xr.reshape(ep.size, e_loc, cap, d).transpose(0, 1)
        ye = expert_ffn(xr.reshape(e_loc, ep.size * cap, d), wg, wu, wd,
                        cfg, stable, out32)
        ye = ye.reshape(e_loc, ep.size, cap, d).transpose(0, 1)
        ye = comm.all_to_all(ye.reshape(ep.size, e_loc * cap, d), ep)
    elif rep is not None:                # (b): my experts' rows, others 0
        lo = rep.index * e_loc
        mine = expert_ffn(xe[lo:lo + e_loc], wg, wu, wd, cfg, stable, out32)
        ye = mine.new_zeros((e, cap, d))
        ye[lo:lo + e_loc] = mine
    else:
        ye = expert_ffn(xe, wg, wu, wd, cfg, stable, out32)
    out = combine(ye.reshape(e * cap, d), info, top_idx,
                  torch.float32 if out32 else x.dtype)
    if tp is not None:
        out = comm.all_reduce_sum(out, tp)
    if rep is not None:
        out = comm.all_reduce_sum(out, rep)
    frac = F.one_hot(top_idx, e).float().mean((0, 1))
    aux = e * torch.sum(frac * gates.mean(0))
    return out.to(x.dtype).reshape(b, s, d), aux


# -- full model (the dense backbone with the MoE FFN) --------------------------


def init(gen: torch.Generator, cfg: ArchConfig, device) -> Dict:
    return T.init(gen, cfg, device, ffn_init=init_moe_ffn)


def _serve_ffn(p, x, cfg: ArchConfig, phase: str) -> torch.Tensor:
    """The dense-slot serve FFN: the capacity-factor formula on the tokens
    this rank dispatches (tokens can drop, as in the reference; under
    route (a) on the rank's lanes, as the reference's formula inside
    ``shard_map``, so a data axis can drop other tokens than one card)."""
    return apply_moe_ffn(p, x, cfg, phase)[0]


def _paged_ffn(p, x, cfg: ArchConfig, phase: str,
               stable: bool = False) -> torch.Tensor:
    """The paged serve FFN: capacity pinned to the dispatch's token count
    (every data rank's lanes where they split, as the reference takes it
    from the global batch), so no token drops and a lane's rows never
    depend on what else rides in the batch (padded chunks, null lanes);
    the paged engine then gives its dense oracle's tokens. ``stable``: the
    row-stable products of a decode or verify dispatch on the card."""
    ax = L.split_lanes()
    t = x.shape[0] * x.shape[1] * (1 if ax is None else ax.size)
    return apply_moe_ffn(p, x, cfg, phase, capacity=t, stable=stable)[0]


def forward(params, tokens, cfg: ArchConfig, phase: str):
    """Returns (logits (B, S, V) float32, aux loss): the mean over layers
    of the Switch load-balance loss, summed layer by layer in float32."""
    logits, aux = T.forward(params, tokens, cfg, phase,
                            ffn_apply=apply_moe_ffn, with_aux=True)
    return logits, aux / cfg.n_layers


def init_cache(cfg: ArchConfig, batch: int, length: int, device):
    return T.init_cache(cfg, batch, length, device)


def sequence_state_spec(cfg: ArchConfig) -> SequenceStateSpec:
    """MoE shares the dense backbone's state (attention KV only); the FFN
    is stateless, and the paged path's drop-free routing keeps prefix
    sharing and speculative verify exact."""
    return SequenceStateSpec(family="moe", kv_layers=cfg.n_layers,
                             supports_prefix_cache=True,
                             supports_spec_decode=True,
                             supports_cow_fork=True, window=cfg.window)


def prefill(params, tokens, cfg: ArchConfig, cache_len: int, n_pad=None):
    return T.prefill(params, tokens, cfg, cache_len, n_pad=n_pad,
                     ffn_apply=_serve_ffn)


def decode_step(params, cache, token, pos, cfg: ArchConfig, write_pos=None):
    return T.decode_step(params, cache, token, pos, cfg, write_pos=write_pos,
                         ffn_apply=_serve_ffn)


def prefill_paged(params, tokens, q_start, n_valid, tables, pools,
                  cfg: ArchConfig):
    return T.prefill_paged(params, tokens, q_start, n_valid, tables, pools,
                           cfg, ffn_apply=_paged_ffn)


def decode_step_paged(params, pools, token, pos, tables, cfg: ArchConfig):
    return T.decode_step_paged(params, pools, token, pos, tables, cfg,
                               ffn_apply=_paged_ffn)


def decode_horizon_paged(params, pools, token, pos, tables, temperature,
                         top_k, seed, counter, eos_ids, cfg: ArchConfig, *,
                         num_steps: int, use_top_k: bool = True,
                         stochastic: bool = True, use_eos: bool = True):
    return T.decode_horizon_paged(
        params, pools, token, pos, tables, temperature, top_k, seed,
        counter, eos_ids, cfg, num_steps=num_steps, use_top_k=use_top_k,
        stochastic=stochastic, use_eos=use_eos, ffn_apply=_paged_ffn)


def verify_paged(params, pools, tokens, q_start, n_valid, tables,
                 temperature, top_k, seed, counter, eos_ids,
                 cfg: ArchConfig, *, use_top_k: bool = True,
                 stochastic: bool = True, use_eos: bool = True):
    return T.verify_paged(
        params, pools, tokens, q_start, n_valid, tables, temperature, top_k,
        seed, counter, eos_ids, cfg, use_top_k=use_top_k,
        stochastic=stochastic, use_eos=use_eos, ffn_apply=_paged_ffn)
