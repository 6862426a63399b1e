"""Model API: the only model surface ``serve/`` talks to, for every family
of the JAX package: dense, MoE, encdec (whisper), vlm (qwen2-vl), ssm
(rwkv6) and hybrid (RecurrentGemma).

The dense-slot engine calls :func:`prefill` / :func:`decode_step` on
stacked caches (:func:`init_cache`). The paged calls follow the
reference's single calling convention: ``state`` is the engine's
composite device state (``{"k", "v"}`` page pools and/or ``"slots"``, a
``StateSlotPool``'s tree) and ``refs`` the per-dispatch references
(``"tables"`` (B, NB) and/or ``"slots"`` (B,)), only the keys the
family's :func:`sequence_state_spec` calls for (encdec adds ``"cross"``
(B, NBc) cross-page tables and ``"cross_valid"`` (B,)). Dense and MoE keep
their ``(tables, pools)`` signatures behind adapters here. A family whose
spec is not ``servable`` (vlm) raises from every paged entry.

Encdec and vlm take a batch dict where the LM families take tokens:
``{"frames", "tokens"}`` and ``{"embeds", "positions"}`` for
:func:`forward` and :func:`prefill`.

Training (``repro/models/api.py:62-112``): :func:`loss_fn` is the mean
next-token cross-entropy, plus ``AUX_LOSS_WEIGHT`` times the MoE
load-balance loss, of a ``"train"``-phase forward (exact softmax and
norms). It takes the serving-dtype view of float32 masters
(``convert.serving_view``), so its gradients reach the masters through
the view's casts, as the reference's reach its masters through its
per-use ``cast``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple, Union

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.models import (moe, rglru, rwkv6, transformer, vlm,
                                whisper)
from repro_torch.models.state import tree_map

_FAMILY_MODULES = {"dense": transformer, "moe": moe, "encdec": whisper,
                   "vlm": vlm, "ssm": rwkv6, "hybrid": rglru}
_PAGES_ONLY = ("dense", "moe")
_BATCH_DICT = ("encdec", "vlm")
_TOKENS = ("dense", "ssm", "hybrid")

AUX_LOSS_WEIGHT = 0.01
WHISPER_DEC_LEN = 448


def get_model(cfg: ArchConfig):
    mod = _FAMILY_MODULES.get(cfg.family)
    if mod is None:
        raise ValueError(f"unknown family {cfg.family!r} (known: "
                         f"{sorted(_FAMILY_MODULES)})")
    return mod


def init_params(seed: Union[int, torch.Generator], cfg: ArchConfig,
                device="cuda", masters: bool = False):
    """Random parameters from a seed (or a ``torch.Generator`` on
    ``device``), laid out like the reference's value tree. ``masters``
    keeps every leaf float32 (the trainer's master copy): the same float32
    draws, uncast, so ``convert.serving_view`` of them is bitwise the
    default tree."""
    gen = seed
    if isinstance(seed, int):
        # the meta device draws nothing: a CPU generator stands in
        gen_dev = "cpu" if torch.device(device).type == "meta" else device
        gen = torch.Generator(device=gen_dev).manual_seed(seed)
    if masters:
        cfg = dataclasses.replace(cfg, dtype="float32")
    return get_model(cfg).init(gen, cfg, device)


class _Stacked:
    """A schema whose leaves carry the leading stacked ``layers`` axis."""

    def __init__(self, schema):
        self.schema = schema


_NORM_AXES = {"g": ("embed",), "b": ("embed",)}
_EMBED_AXES = {"table": ("vocab", "embed"), "head": ("embed", "vocab")}
_ATTN_AXES = {"wq": ("embed", "heads", "head_dim"),
              "wk": ("embed", "kv_heads", "head_dim"),
              "wv": ("embed", "kv_heads", "head_dim"),
              "wo": ("heads", "head_dim", "embed"),
              "bq": ("heads", "head_dim"), "bk": ("kv_heads", "head_dim"),
              "bv": ("kv_heads", "head_dim")}
_MLP_AXES = {"gate": ("embed", "ff"), "up": ("embed", "ff"),
             "down": ("ff", "embed")}
_MOE_AXES = {"router": ("embed", None),
             "gate": ("experts", "embed", "expert_ff"),
             "up": ("experts", "embed", "expert_ff"),
             "down": ("experts", "expert_ff", "embed")}
_DECODER_LAYER = {"ln1": _NORM_AXES, "attn": _ATTN_AXES, "ln2": _NORM_AXES,
                  "mlp": _MLP_AXES}
_TIME_MIX_AXES = {"mu_x": ("embed",), "mu": (None, "embed"),
                  "lora_a": ("embed", None), "lora_b": (None, None, "embed"),
                  "w0": ("embed",), "w1": ("embed", None),
                  "w2": (None, "embed"),
                  **{k: ("embed", "heads", "head_dim")
                     for k in ("wr", "wk", "wv", "wg")},
                  "u": ("heads", "head_dim"),
                  "wo": ("heads", "head_dim", "embed"),
                  "gn_g": ("heads", "head_dim"), "gn_b": ("heads", "head_dim")}
_CHANNEL_MIX_AXES = {"mu_k": ("embed",), "mu_r": ("embed",),
                     "wk": ("embed", "ff"), "wv": ("ff", "embed"),
                     "wr": ("embed", "embed2")}
_RECURRENT_AXES = {"ln": _NORM_AXES, "in_x": ("embed", "ff"),
                   "in_gate": ("embed", "ff"), "conv_w": ("conv", "ff"),
                   "conv_b": ("ff",), "wa": ("ff", None), "ba": ("ff",),
                   "wx": ("ff", None), "bx": ("ff",), "lam": ("ff",),
                   "out": ("ff", "embed"), "ln_mlp": _NORM_AXES,
                   "mlp": _MLP_AXES}


def _family_schema(cfg: ArchConfig):
    top = {"embed": _EMBED_AXES, "final_norm": _NORM_AXES}
    if cfg.family in ("dense", "vlm"):
        return {**top, "layers": _Stacked(_DECODER_LAYER)}
    if cfg.family == "moe":
        return {**top, "layers": _Stacked({**_DECODER_LAYER,
                                           "mlp": _MOE_AXES})}
    if cfg.family == "ssm":
        return {**top, "layers": _Stacked({
            "ln1": _NORM_AXES, "tm": _TIME_MIX_AXES, "ln2": _NORM_AXES,
            "cm": _CHANNEL_MIX_AXES})}
    if cfg.family == "hybrid":
        return {**top, "blocks": _Stacked({
            "rec1": _RECURRENT_AXES, "rec2": _RECURRENT_AXES,
            "attn": {"ln": _NORM_AXES, "attn": _ATTN_AXES,
                     "ln_mlp": _NORM_AXES, "mlp": _MLP_AXES}}),
            "tail": _Stacked(_RECURRENT_AXES)}
    if cfg.family == "encdec":
        return {**top, "enc_layers": _Stacked(_DECODER_LAYER),
                "enc_norm": _NORM_AXES,
                "dec_layers": _Stacked({**_DECODER_LAYER,
                                        "ln_x": _NORM_AXES,
                                        "xattn": _ATTN_AXES})}
    raise ValueError(f"unknown family {cfg.family!r}")


def param_axes(cfg: ArchConfig):
    """The logical-axes tree of :func:`init_params`'s values (the tree
    ``repro.models.api.init_params`` returns beside them): one tuple of
    logical axis names per leaf, ``"layers"`` first on stacked leaves.
    Under ``cfg.quant.weights`` each matmul weight's axes are mirrored onto
    its packed ``{"q", "s"}`` leaf (``sharding.rules.quantize_param_axes``),
    the tree a quantizing engine lays out."""
    from repro_torch.sharding.rules import quantize_param_axes

    def walk(tree, schema, stacked: bool):
        out = {}
        for k, v in tree.items():
            s, st = schema[k], stacked
            if isinstance(s, _Stacked):
                s, st = s.schema, True
            out[k] = (walk(v, s, st) if isinstance(v, dict)
                      else (("layers",) if st else ()) + s)
        return out

    axes = walk(init_params(0, cfg, "meta"), _family_schema(cfg), False)
    return quantize_param_axes(axes) if cfg.quant.weights else axes


def sequence_state_spec(cfg: ArchConfig):
    return get_model(cfg).sequence_state_spec(cfg)


def _check_servable(cfg: ArchConfig) -> None:
    if not sequence_state_spec(cfg).servable:
        raise ValueError(
            f"family {cfg.family!r} is not paged-servable "
            "(see its sequence_state_spec)")


def forward(params, batch, cfg: ArchConfig, phase: str = "serve"):
    """batch {"tokens": (B, S)} (encdec: also "frames"; vlm: "embeds" and
    "positions") -> logits (B, S, padded_vocab) float32 (an MoE model's
    aux loss is dropped, as the reference's API does)."""
    m = get_model(cfg)
    if cfg.family in _BATCH_DICT:
        return m.forward(params, batch, cfg, phase)
    out = m.forward(params, batch["tokens"], cfg, phase)
    return out[0] if cfg.family == "moe" else out


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor
                  ) -> torch.Tensor:
    """Mean next-token NLL. logits (B, S, V) float32, targets (B, S)."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.take_along_dim(logits, targets.long()[..., None],
                                dim=-1)[..., 0]
    return torch.mean(logz - gold)


def loss_fn(params, batch, cfg: ArchConfig
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss, {"xent", "aux"}) of a train-phase forward: dense, ssm and
    hybrid take ``batch["tokens"]``, MoE adds ``AUX_LOSS_WEIGHT * aux``,
    encdec and vlm take the batch dict."""
    m = get_model(cfg)
    dev = batch["targets"].device
    aux = torch.zeros((), dtype=torch.float32, device=dev)
    if cfg.family in _TOKENS:
        logits = m.forward(params, batch["tokens"], cfg, "train")
    elif cfg.family == "moe":
        logits, aux = m.forward(params, batch["tokens"], cfg, "train")
    else:
        logits = m.forward(params, batch, cfg, "train")
    xent = cross_entropy(logits, batch["targets"])
    loss = xent + AUX_LOSS_WEIGHT * aux
    return loss, {"xent": xent, "aux": aux}


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def train_inputs(cfg: ArchConfig, shape: ShapeConfig):
    """(batch tree of meta-device tensors, logical-axes tree) for a train
    step: the shapes and dtypes :func:`loss_fn` takes, allocating
    nothing."""
    b, s = shape.global_batch, shape.seq_len
    i32 = torch.int32
    dt = getattr(torch, cfg.dtype)
    meta = _meta
    if cfg.family == "encdec":
        t = min(WHISPER_DEC_LEN, s)
        batch = {"frames": meta((b, s, cfg.d_model), dt),
                 "tokens": meta((b, t), i32), "targets": meta((b, t), i32)}
        axes = {"frames": ("batch", None, None), "tokens": ("batch", None),
                "targets": ("batch", None)}
    elif cfg.family == "vlm":
        batch = {"embeds": meta((b, s, cfg.d_model), dt),
                 "positions": meta((3, b, s), i32),
                 "targets": meta((b, s), i32)}
        axes = {"embeds": ("batch", None, None),
                "positions": (None, "batch", None),
                "targets": ("batch", None)}
    else:
        batch = {"tokens": meta((b, s), i32), "targets": meta((b, s), i32)}
        axes = {"tokens": ("batch", None), "targets": ("batch", None)}
    return batch, axes


def prefill_inputs(cfg: ArchConfig, shape: ShapeConfig):
    """(batch tree of meta tensors, logical-axes tree) for :func:`prefill`:
    tokens (encdec: frames and the decoder's first ``WHISPER_DEC_LEN``
    tokens; vlm: embeds and M-RoPE positions)."""
    b, s = shape.global_batch, shape.seq_len
    dt = getattr(torch, cfg.dtype)
    if cfg.family == "encdec":
        t = min(WHISPER_DEC_LEN, s)
        return ({"frames": _meta((b, s, cfg.d_model), dt),
                 "tokens": _meta((b, t), torch.int32)},
                {"frames": ("batch", None, None), "tokens": ("batch", None)})
    if cfg.family == "vlm":
        return ({"embeds": _meta((b, s, cfg.d_model), dt),
                 "positions": _meta((3, b, s), torch.int32)},
                {"embeds": ("batch", None, None),
                 "positions": (None, "batch", None)})
    return ({"tokens": _meta((b, s), torch.int32)},
            {"tokens": ("batch", None)})


_DENSE_CACHE_AXES = {"k": ("layers", "batch", "kv_heads", "head_dim", None),
                     "v": ("layers", "batch", "kv_heads", None, "head_dim"),
                     "pos": (None,)}
_REC_AXES = {"h": ("layers", "batch", "ff"),
             "conv": ("layers", "batch", None, "ff")}


def cache_axes(cfg: ArchConfig):
    """The logical axes of :func:`init_cache`'s tree (the reference's
    per-family ``cache_axes``)."""
    if cfg.family in ("dense", "moe", "vlm"):
        return dict(_DENSE_CACHE_AXES)
    if cfg.family == "encdec":
        xa = ("layers", "batch", "seq", "kv_heads", "head_dim")
        return {"self": dict(_DENSE_CACHE_AXES), "cross_k": xa,
                "cross_v": xa, "cross_pos": (None,)}
    if cfg.family == "ssm":
        return {"tm_x": ("layers", "batch", "embed"),
                "cm_x": ("layers", "batch", "embed"),
                "s": ("layers", "batch", "heads", "head_dim", None)}
    kv = {"k": ("layers", "batch", "seq", "kv_heads", "head_dim"),
          "v": ("layers", "batch", "seq", "kv_heads", "head_dim"),
          "pos": ("layers", None)}
    return {"blocks": {"rec1": dict(_REC_AXES), "rec2": dict(_REC_AXES),
                       "attn": kv},
            "tail": dict(_REC_AXES), "pos": ()}


def decode_inputs(cfg: ArchConfig, shape: ShapeConfig):
    """(cache tree, cache axes, token, pos) for :func:`decode_step` on
    the meta device: the family's :func:`init_cache` of ``global_batch``
    lanes of ``seq_len`` columns, token (B,) int32, pos a 0-d int32. The
    port's dense-slot decode takes its write column on the host: the dry
    run passes ``seq_len - 1``, the last column."""
    b, s = shape.global_batch, shape.seq_len
    cache = init_cache(cfg, b, s, device="meta")
    return (cache, cache_axes(cfg), _meta((b,), torch.int32),
            _meta((), torch.int32))


def paged_decode_inputs(cfg: ArchConfig, shape: ShapeConfig,
                        block_size: int = 16):
    """(state tree, state axes, token, pos, refs) for
    :func:`decode_step_paged` on the meta device (the reference's
    ``paged_decode_inputs``): ``{"k", "v"}`` page pools of the
    dense-cache-equivalent capacity plus the null page (encdec: plus each
    lane's cross pages) in the KV store dtype, a ``"slots"`` pool of one
    slot per lane plus the null slot, and the refs the engine passes a
    dispatch (page tables, slot ids, cross tables). A family that is not
    paged-servable raises."""
    from repro_torch.models.layers import kv_store_dtype
    from repro_torch.serve.kv_cache import cdiv
    spec = sequence_state_spec(cfg)
    _check_servable(cfg)
    b, s = shape.global_batch, shape.seq_len
    i32 = torch.int32
    state, axes, refs = {}, {}, {}
    if spec.has_pages:
        cross_blocks = cdiv(spec.cross_tokens, block_size)
        num_blocks = b * (cdiv(s, block_size) + cross_blocks) + 1
        pool = (spec.kv_layers, num_blocks, block_size, cfg.n_kv_heads,
                cfg.head_dim)
        dt = kv_store_dtype(cfg)
        state["k"], state["v"] = _meta(pool, dt), _meta(pool, dt)
        axes["k"] = ("layers", "pages", None, "kv_heads", "head_dim")
        axes["v"] = ("layers", "pages", None, "kv_heads", "head_dim")
        refs["tables"] = _meta((b, cdiv(s, block_size)), i32)
        if spec.cross_tokens:
            refs["cross"] = _meta((b, cross_blocks), i32)
            refs["cross_valid"] = _meta((b,), i32)
    if spec.has_slots:
        state["slots"] = tree_map(
            lambda leaf: _meta((b + 1,) + tuple(leaf.shape), leaf.dtype),
            spec.slot_shapes)
        axes["slots"] = tree_map(lambda ax: ("state_slots",) + tuple(ax),
                                 spec.slot_axes)
        refs["slots"] = _meta((b,), i32)
    return state, axes, _meta((b,), i32), _meta((b,), i32), refs


def init_cache(cfg: ArchConfig, batch: int, length: int, device="cuda"):
    """Empty dense-slot caches for ``batch`` lanes of ``length`` tokens."""
    return get_model(cfg).init_cache(cfg, batch, length, device)


def prefill(params, tokens, cfg: ArchConfig, cache_len: int, n_pad=None):
    """Whole-prompt prefill of tokens (B, S) (encdec and vlm: their batch
    dict) into a fresh cache of ``cache_len`` columns. Returns
    (last-position logits (B, 1, V), cache)."""
    return get_model(cfg).prefill(params, tokens, cfg, cache_len,
                                  n_pad=n_pad)


def decode_step(params, cache, token, pos, cfg: ArchConfig, write_pos=None):
    """One decode step on the dense-slot cache (updated in place). Returns
    (logits (B, V), cache)."""
    return get_model(cfg).decode_step(params, cache, token, pos, cfg,
                                      write_pos=write_pos)


def prefill_paged(params, tokens, q_start, n_valid, refs, state,
                  cfg: ArchConfig):
    """One chunked-prefill step. Returns (logits (B,C,V), state)."""
    _check_servable(cfg)
    m = get_model(cfg)
    if cfg.family not in _PAGES_ONLY:
        return m.prefill_paged(params, tokens, q_start, n_valid, refs, state,
                               cfg)
    logits, pools = m.prefill_paged(params, tokens, q_start, n_valid,
                                    refs["tables"], state, cfg)
    return logits, dict(state, **pools)


def decode_step_paged(params, token, pos, refs, state, cfg: ArchConfig):
    """One decode step: token/pos (B,). Returns (logits (B,V), state)."""
    _check_servable(cfg)
    m = get_model(cfg)
    if cfg.family not in _PAGES_ONLY:
        return m.decode_step_paged(params, token, pos, refs, state, cfg)
    logits, pools = m.decode_step_paged(params, state, token, pos,
                                        refs["tables"], cfg)
    return logits, dict(state, **pools)


def decode_horizon_paged(params, token, pos, refs, state, temperature,
                         top_k, seed, counter, eos_ids, cfg: ArchConfig, *,
                         num_steps: int, use_top_k: bool = True,
                         stochastic: bool = True, use_eos: bool = True):
    """``num_steps`` fused decode+sample steps. Returns
    (tokens (B, num_steps), done (B, num_steps), state)."""
    _check_servable(cfg)
    if cfg.family not in _PAGES_ONLY:
        return get_model(cfg).decode_horizon_paged(
            params, token, pos, refs, state, temperature, top_k, seed,
            counter, eos_ids, cfg, num_steps=num_steps, use_top_k=use_top_k,
            stochastic=stochastic, use_eos=use_eos)
    toks, done, pools = get_model(cfg).decode_horizon_paged(
        params, state, token, pos, refs["tables"], temperature, top_k, seed,
        counter, eos_ids, cfg, num_steps=num_steps, use_top_k=use_top_k,
        stochastic=stochastic, use_eos=use_eos)
    return toks, done, dict(state, **pools)


def verify_paged(params, tokens, q_start, n_valid, refs, state, temperature,
                 top_k, seed, counter, eos_ids, cfg: ArchConfig, *,
                 use_top_k: bool = True, stochastic: bool = True,
                 use_eos: bool = True):
    """Speculative-verify dispatch (families whose state can rewind
    rejected drafts). Returns (pinned (B, C), done (B, C), state)."""
    if not sequence_state_spec(cfg).supports_spec_decode:
        raise ValueError(
            f"family {cfg.family!r} does not support speculative decoding "
            "(its sequence state cannot rewind rejected drafts)")
    pinned, done, pools = get_model(cfg).verify_paged(
        params, state, tokens, q_start, n_valid, refs["tables"], temperature,
        top_k, seed, counter, eos_ids, cfg, use_top_k=use_top_k,
        stochastic=stochastic, use_eos=use_eos)
    return pinned, done, dict(state, **pools)


def encode_paged(params, frames, cross_table, state, cfg: ArchConfig):
    """Admission-time encoder run (encdec only): park every decoder
    layer's cross K/V in the request's cross pages. Returns the state."""
    if cfg.family != "encdec":
        raise ValueError(f"encode_paged is encdec-only, got {cfg.family}")
    return get_model(cfg).encode_paged(params, frames, cross_table, state,
                                       cfg)
