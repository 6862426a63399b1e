"""Shared model components of the serve paths: embeddings, RoPE and
M-RoPE, norms, the MLPs (SwiGLU, GeGLU, GELU, squared ReLU), QKV/output
projections, paged attention, the dense (materialized-logits) attention
of the dense-slot engine, the blocked (online-normalized) attention of
long sequences and cross-attention over encoder states, with the SOLE
technique as the softmax/norm implementation.

Plain functions on tensors, in the JAX package's layouts. Parameters are
stored once in their serving dtype (``cfg.dtype`` for projections,
biases and embeddings — bit-identical to the reference's per-use cast;
float32 for norm gains, which the reference never casts). Under
``cfg.quant.weights`` the projections are packed ``{"q", "s"}`` int8
leaves (``sharding.rules.quantize_params``) and go through
:func:`qmatmul`.

Under active mesh rules (``sharding.rules.use_rules``) each rank holds
its local slice of every weight (``convert.shard_params``) and the layers
take their tensor-parallel forms, each calling ``sharding/comm.py``'s
collective over the model axis where the reference's SPMD partitioner
inserts one: QKV, ``gate`` and ``up`` column-parallel (no collective),
``wo`` and ``down`` row-parallel (one sum all-reduce of the partial
outputs; at w8a8 a max all-reduce of the row scale first and the int32
partials summed, exact), the embedding vocab-parallel (a masked lookup,
summed: one rank holds each row) and the head vocab-parallel (its float32
logits gathered along the vocabulary). A dim the divisibility fallback
replicates is whole on every rank and runs no collective; paged attention
reads its KV heads through :func:`_paged_tp_plan`'s map.

Over the mesh's ``data`` axis a dispatch's lanes split (:func:`data_split`:
where D divides them, as the reference lays ``"batch"`` over data; else
every data rank runs every lane): the model functions take this rank's
share (:func:`lanes`) and run the products, attention and sampling on it
alone inside :func:`lane_split`, which gives every SOLE norm the whole
batch's calibration (one max all-reduce of its C per-channel maxima over
data, ``calibrate_ptf``'s ``amax_reduce``; exact, so the rows are bitwise
those of the whole batch). Weights and pools replicate over data.
"""
from __future__ import annotations

import contextlib
import contextvars
import functools
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import ops
from repro_torch.configs.base import ArchConfig
from repro_torch.core.sole.e2softmax import ALDIV_BIAS, log2exp, split_sum
from repro_torch.core.sole.quant import is_qtensor, quantize_act, true_div
from repro_torch.kernels.ailayernorm import fma32
from repro_torch.kernels.flash_e2softmax import exp2_int
from repro_torch.ops.reference import repeat_kv
from repro_torch.roofline.cost import Trips
from repro_torch.sharding import comm
from repro_torch.sharding.rules import active_rules

# int8 logit grid for E2Softmax inputs: exp(-12) is below the 4-bit log2
# resolution, so [-12, 0] covers the useful post-max range.
LOGIT_INT8_SCALE = 12.0 / 127.0

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def cast(x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    return x.to(torch_dtype(cfg.dtype))


class _Fma32(torch.autograd.Function):
    """``fma32`` with the gradient of ``a * b + c`` (its float64 rounding
    steps have none)."""

    @staticmethod
    def forward(ctx, a, b, c):
        ctx.save_for_backward(a, b)
        ctx.shapes = (a.shape, b.shape, c.shape)
        return fma32(a, b, c).to(a.dtype)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        sa, sb, sc = ctx.shapes
        need = ctx.needs_input_grad
        return ((g * b).sum_to_size(sa) if need[0] else None,
                (g * a).sum_to_size(sb) if need[1] else None,
                g.sum_to_size(sc) if need[2] else None)


def fma(a, b, c) -> torch.Tensor:
    """``a * b + c`` rounded once, as XLA contracts it inside ``jit``: the
    correctly rounded ``fma32`` on the CPU, ``addcmul`` on the card (one
    launch, which nvcc contracts into an FMA; the card tests hold it to
    ``fma32``). In ``a``'s dtype; differentiable as ``a * b + c``."""
    if a.device.type == "cpu":
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (a, b, c)):
            return _Fma32.apply(a, b, c)
        return fma32(a, b, c).to(a.dtype)
    return torch.addcmul(c, a, b)


def model_split(logical: str, size: int) -> Optional[comm.MeshAxis]:
    """The model axis when the active rules split a dim of ``size`` along
    ``logical`` over it (the weights' layout, ``convert.shard_params``),
    else None."""
    rules = active_rules()
    if rules is None or rules.split(logical, size) == 1:
        return None
    return comm.model_axis(rules)


# -- the lane split over the data axis -------------------------------------------

_LANES: contextvars.ContextVar = contextvars.ContextVar("lane_split",
                                                       default=None)


def data_split(lanes_: int) -> Optional[comm.MeshAxis]:
    """The data axis when the active rules split a dispatch of ``lanes_``
    lanes over it (``rules.dim_spec("batch", lanes_)`` names ``data``: D
    divides the lanes), else None: every data rank runs every lane (a B =
    1 prefill chunk; 4 lanes on 8 data ranks)."""
    rules = active_rules()
    if rules is None:
        return None
    ax = rules.dim_spec("batch", lanes_)
    if "data" not in (ax if isinstance(ax, tuple) else (ax,)):
        return None
    return comm.data_axis(rules)


def lanes(t: Optional[torch.Tensor], ax: Optional[comm.MeshAxis],
          dim: int = 0) -> Optional[torch.Tensor]:
    """This data rank's contiguous share of ``t``'s lanes along ``dim``
    (``t`` itself where nothing splits)."""
    if ax is None or t is None:
        return t
    n = t.shape[dim] // ax.size
    return t.narrow(dim, ax.index * n, n)


def gather_lanes(t: torch.Tensor, ax: Optional[comm.MeshAxis],
                 dim: int = 0) -> torch.Tensor:
    """Every data rank's lanes of ``t`` joined along ``dim`` in lane order
    (one all-gather over data; ``t`` itself where nothing splits)."""
    return t if ax is None else comm.all_gather(t, dim, ax)


@contextlib.contextmanager
def lane_split(ax: Optional[comm.MeshAxis]):
    """The layers inside run on this data rank's lanes of a batch split
    over ``ax`` (None: the whole batch): each SOLE norm calibrates over
    the whole batch (:func:`apply_norm`)."""
    tok = _LANES.set(ax)
    try:
        yield ax
    finally:
        _LANES.reset(tok)


def split_lanes() -> Optional[comm.MeshAxis]:
    """The data axis the lanes of the enclosing :func:`lane_split` are
    split over (None: the whole batch runs here)."""
    return _LANES.get()


def _calibration(mode: str) -> dict:
    """A SOLE norm's ``amax_reduce`` inside a lane split: the max
    all-reduce over data that makes its per-channel maxima the whole
    batch's. The exact norm is per row and needs none."""
    ax = _LANES.get()
    if ax is None or mode != "sole":
        return {}
    return {"amax_reduce": lambda t: comm.all_reduce_max(t, ax)}


def qmatmul(x, w, cfg: ArchConfig, n_contract: int = 1,
            ax: Optional[comm.MeshAxis] = None) -> torch.Tensor:
    """Matmul against a packed int8 weight ``{"q", "s"}``.

    ``x`` is a plain activation (consumed as it is at w8a16, quantized
    per row on the fly in float32 at w8a8) or an ``(int8 codes, per-row
    scale)`` pair from a ``residual_*_q`` norm, which feeds the w8a8
    matmul directly. Returns float32; call sites cast to the model dtype.

    ``ax``: a row-parallel product (the contracted dim split over the
    model axis). At w8a8 the row scale takes the row's max over every
    rank (one max all-reduce of the local maxima), each rank quantizes its
    slice with it and the int32 partials are summed (exact), then scaled
    as on one device: bitwise the single-device product. At w8a16 the
    float partials are summed.
    """
    b = cfg.ops_backend
    if isinstance(x, tuple):
        return ops.matmul_fn("w8a8", x[0].device, b)(x, w,
                                                     n_contract=n_contract)
    if cfg.quant.acts:
        red = None if ax is None else (
            lambda t: comm.all_reduce_max(t, ax))
        qx = quantize_act(x.float(), n_contract, amax_reduce=red)
        acc = None if ax is None else (
            lambda t: comm.all_reduce_sum(t, ax))
        return ops.matmul_fn("w8a8", x.device, b)(
            qx, w, n_contract=n_contract, acc_reduce=acc)
    out = ops.matmul_fn("w8a16", x.device, b)(x, w, n_contract=n_contract)
    return out if ax is None else comm.all_reduce_sum(out, ax)


# -- decode and verify products ----------------------------------------------

# rows of every product of a decode or verify dispatch on the card
ROW_TILE = 64


@functools.lru_cache(maxsize=None)
def _zero_rows(k: int, dtype: torch.dtype, device) -> torch.Tensor:
    """ROW_TILE rows of k zeros (made once per device; never written)."""
    return torch.zeros((ROW_TILE, k), dtype=dtype, device=device)


def pad_rows(a2: torch.Tensor) -> torch.Tensor:
    """(M, K) rows zero-padded to a multiple of ``ROW_TILE`` rows (one
    concatenation; a multiple already is returned as it is)."""
    m, k = a2.shape
    pad = -m % ROW_TILE
    if pad == 0:
        return a2.contiguous()
    return torch.cat([a2, _zero_rows(k, a2.dtype, a2.device)[:pad]])


def mm(a2: torch.Tensor, w: torch.Tensor, out32: bool = False):
    """``a2 @ w`` for 2-D operands; ``out32``: the product in float32,
    rounded once (a row-parallel partial that is summed over the ranks
    before its one rounding to the model dtype, as the single-device
    product rounds once): bf16 operands accumulate into a float32 output
    on the card (``torch.mm``'s ``out_dtype``), into float32 operands'
    product on the CPU."""
    if not out32 or a2.dtype == torch.float32:
        return a2 @ w
    if a2.device.type == "cuda":
        return torch.mm(a2, w, out_dtype=torch.float32)
    return a2.float() @ w.float()


def tile_mm(ap: torch.Tensor, w: torch.Tensor,
            out32: bool = False) -> torch.Tensor:
    """``ap @ w`` for ``ap`` of a multiple of ``ROW_TILE`` rows, as one
    (ROW_TILE, K) x (K, N) product per tile of rows (``out32``: as
    :func:`mm`)."""
    if ap.shape[0] == ROW_TILE:
        return mm(ap, w, out32)
    return torch.cat([mm(t, w, out32) for t in ap.split(ROW_TILE)])


def stable_mm(a: torch.Tensor, w: torch.Tensor,
              out32: bool = False) -> torch.Tensor:
    """``a @ w`` for ``a`` (..., K) and ``w`` (K, N), whose rows do not
    depend on how many rows ride with them: the rows run zero-padded in
    tiles of ``ROW_TILE``, each one product of the same shape.

    The route of every bf16 or float32 product of a decode or verify
    dispatch on the card (the decode horizon, ``decode_step_paged``,
    ``verify_paged``). cuBLAS picks its kernel, and with it the order of
    each row's sums, from (M, N, K), so an 8-row decode product and a
    40-row verify product round the same row apart (at d 4,096); one
    shape per (N, K) gives every row one kernel, whatever M and wherever
    the row sits in its tile (the card tests hold this bitwise). At M <=
    ROW_TILE a bf16 product at d 4,096 is still bound by the weight
    bytes, so the padding costs little device time. It runs only on the
    card: on the CPU the products keep the reference's forms (one product
    per projection), which the engines' parity tests against JAX hold,
    and prefill chunks keep them on both devices. ``out32``: as
    :func:`mm`."""
    lead = a.shape[:-1]
    a2 = a.reshape(-1, a.shape[-1])
    out = tile_mm(pad_rows(a2), w, out32)[:a2.shape[0]]
    return out.reshape(lead + (w.shape[1],))


# -- norms ------------------------------------------------------------------


def _norm_mode(cfg: ArchConfig, phase: str) -> str:
    return cfg.train_norm_mode if phase == "train" else cfg.norm_mode


def apply_norm(x, p, cfg: ArchConfig, phase: str) -> torch.Tensor:
    """The norm in the model dtype; ``out_dtype`` lets a kernel write it
    directly (the other backends' float32 output is cast here)."""
    mode = _norm_mode(cfg, phase)
    kw = dict(out_dtype=torch_dtype(cfg.dtype), **_calibration(mode))
    if cfg.norm_kind == "layernorm":
        out = ops.layernorm_fn(mode, x.device, cfg.ops_backend)(
            x, p["g"], p["b"], **kw)
    else:
        out = ops.rmsnorm_fn(mode, x.device, cfg.ops_backend)(
            x, p["g"], **kw)
    return cast(out, cfg)


def apply_residual_norm(x, r, p, cfg: ArchConfig, phase: str,
                        quant_out: bool = False):
    """``x + r`` followed by the norm: returns (new residual stream,
    normalized output), both in the model dtype. In SOLE mode on CUDA
    the add, the calibration and the quantize + statistics + affine are
    one kernel launch, which writes the output in the model dtype.

    With ``quant_out`` (and w8a8 active) the ``residual_*_q`` op runs
    instead: the normalized output leaves as an ``(int8 codes, per-row
    scale)`` pair that the next :func:`qmatmul` consumes directly. Inside
    a :func:`lane_split` a SOLE norm calibrates over the whole batch."""
    mode = _norm_mode(cfg, phase)
    calib = _calibration(mode)
    if quant_out and cfg.quant.acts:
        fn = ops.residual_norm_q_fn(cfg.norm_kind, mode, x.device,
                                    cfg.ops_backend)
        if cfg.norm_kind == "layernorm":
            s, out = fn(x, r, p["g"], p["b"], **calib)
        else:
            s, out = fn(x, r, p["g"], **calib)
        return cast(s, cfg), out
    fn = ops.residual_norm_fn(cfg.norm_kind, mode, x.device,
                              cfg.ops_backend)
    kw = dict(out_dtype=torch_dtype(cfg.dtype), **calib)
    if cfg.norm_kind == "layernorm":
        s, out = fn(x, r, p["g"], p["b"], **kw)
    else:
        s, out = fn(x, r, p["g"], **kw)
    return cast(s, cfg), cast(out, cfg)


# -- embeddings / head -------------------------------------------------------


def embed_tokens(p, tokens: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """The table's rows of ``tokens``; vocab-parallel under a split
    vocabulary: each rank looks up the tokens in its range, zeros
    elsewhere, and one sum all-reduce assembles the rows (one rank holds
    each, so the sum is exact)."""
    ax = model_split("vocab", cfg.padded_vocab)
    if ax is None:
        return F.embedding(tokens.long(), p["table"])
    rows = p["table"].shape[0]
    local = tokens.long() - ax.index * rows
    hit = (local >= 0) & (local < rows)
    x = F.embedding(torch.where(hit, local, 0), p["table"])
    return comm.all_reduce_sum(torch.where(hit[..., None], x, 0), ax)


def lm_logits(p, x, cfg: ArchConfig, stable: bool = False) -> torch.Tensor:
    """The head's logits in float32; ``stable``: through :func:`stable_mm`
    (a decode or verify dispatch on the card). Under a split vocabulary
    each rank computes its columns and they are gathered along the
    vocabulary, so every rank holds the whole float32 rows."""
    if is_qtensor(p["head"]):
        logits = qmatmul(x, p["head"], cfg)
    elif stable:
        logits = stable_mm(x, p["head"]).float()
    else:
        logits = (x @ p["head"]).float()
    ax = model_split("vocab", cfg.padded_vocab)
    return logits if ax is None else comm.all_gather(logits, -1, ax)


# -- RoPE ---------------------------------------------------------------------


def rope_freqs(cfg: ArchConfig, device) -> torch.Tensor:
    half = cfg.head_dim // 2
    expo = -torch.arange(half, dtype=torch.float32, device=device) / half
    # a fill on the device, not an upload: no sync in the decode loop
    return torch.pow(torch.full((), cfg.rope_theta, dtype=torch.float32,
                                device=device), expo)


def _rotate(x: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    """x (..., S, H, head_dim) turned by the angles (..., S, head_dim / 2),
    in float32, back in x's dtype."""
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               cfg: ArchConfig) -> torch.Tensor:
    """x: (..., S, H, head_dim); positions broadcastable to (..., S)."""
    freqs = rope_freqs(cfg, x.device)
    return _rotate(x, positions[..., None].float() * freqs)


def mrope_sections(cfg: ArchConfig) -> Tuple[int, int, int]:
    """M-RoPE's (temporal, height, width) shares of the head_dim / 2
    rotary frequencies."""
    half = cfg.head_dim // 2
    t = half // 4
    h = (half - t) // 2
    return (t, h, half - t - h)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor,
                cfg: ArchConfig) -> torch.Tensor:
    """M-RoPE (qwen2-vl): x (..., S, H, head_dim), positions (3, ..., S);
    frequency section i turns with position axis i."""
    freqs = rope_freqs(cfg, x.device)
    ang3 = positions[..., None].float() * freqs         # (3, ..., S, half)
    parts, start = [], 0
    for i, n in enumerate(mrope_sections(cfg)):
        parts.append(ang3[i][..., start:start + n])
        start += n
    return _rotate(x, torch.cat(parts, -1))             # (..., S, half)


# -- MLP ----------------------------------------------------------------------

# feed-forward kinds of the dense family; the gated ones carry a "gate"
# projection beside "up" and "down"
MLP_KINDS = ("swiglu", "geglu", "gelu", "relu2")
GATED_MLP_KINDS = ("swiglu", "geglu")


def apply_mlp(x, p, cfg: ArchConfig, stable: bool = False) -> torch.Tensor:
    """The feed-forward block of ``cfg.mlp_kind``: ``swiglu`` and
    ``geglu`` (gate, up, down), ``gelu`` and ``relu2`` (up, down). GELU
    is the tanh form (``jax.nn.gelu``'s default); ``relu2`` squares in
    the model dtype. ``x`` may be an ``(int8 codes, scale)`` pair at
    w8a8; the ``down`` input is then quantized per row on the fly.
    ``stable`` (a decode or verify dispatch on the card): the float
    products run as :func:`stable_mm` does, the rows padded once and the
    hidden rows kept padded for ``down``. Under a split ``ff`` dim
    ``gate``/``up`` are column-parallel and ``down`` row-parallel: its
    float32 partial rows summed over the model axis, then rounded to the
    model dtype once."""
    kind = cfg.mlp_kind
    if kind not in MLP_KINDS:
        raise ValueError(f"unknown mlp_kind {kind!r}")
    ax = model_split("ff", cfg.d_ff)
    lead = None
    if is_qtensor(p["up"]):
        def proj(a, w, ax=None):
            return cast(qmatmul(a, w, cfg, ax=ax), cfg)
    else:
        if stable:
            lead = x.shape[:-1]
            x = pad_rows(x.reshape(-1, x.shape[-1]))

        def proj(a, w, ax=None):
            if ax is None:
                return tile_mm(a, w) if stable else a @ w
            if stable:
                out = tile_mm(a, w, out32=True)[:lead.numel()]
            else:
                out = mm(a.reshape(-1, a.shape[-1]), w, out32=True
                         ).reshape(a.shape[:-1] + (w.shape[1],))
            return cast(comm.all_reduce_sum(out, ax), cfg)
    if kind == "swiglu":
        h = F.silu(proj(x, p["gate"])) * proj(x, p["up"])
    elif kind == "geglu":
        h = F.gelu(proj(x, p["gate"]), approximate="tanh") * proj(x, p["up"])
    elif kind == "gelu":
        h = F.gelu(proj(x, p["up"]), approximate="tanh")
    else:
        h = torch.square(F.relu(proj(x, p["up"])))
    out = proj(h, p["down"], ax)
    if lead is not None:
        out = out[:lead.numel()].reshape(lead + (out.shape[-1],))
    return out


# -- attention ----------------------------------------------------------------


def _project_qkv(p, x, cfg: ArchConfig, stable: bool = False):
    """q, k, v (B, S, heads, hd) of x (B, S, D); ``stable``: the float
    products as :func:`stable_mm`, x padded once for the three."""
    if is_qtensor(p["wq"]):
        q = cast(qmatmul(x, p["wq"], cfg), cfg)
        k = cast(qmatmul(x, p["wk"], cfg), cfg)
        v = cast(qmatmul(x, p["wv"], cfg), cfg)
    elif stable:
        b, s, d = x.shape
        xp = pad_rows(x.reshape(b * s, d))

        def proj(w):
            out = tile_mm(xp, w.reshape(d, -1))[:b * s]
            return out.reshape(b, s, w.shape[1], w.shape[2])
        q, k, v = proj(p["wq"]), proj(p["wk"]), proj(p["wv"])
    else:
        q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
        k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
        v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    return q, k, v


def _wo_proj(ctx: torch.Tensor, p, cfg: ArchConfig,
             stable: bool = False) -> torch.Tensor:
    """Output projection ctx (B,S,H,hd) @ wo (H,hd,D) -> (B,S,D);
    ``stable``: as :func:`stable_mm`. Row-parallel under split heads:
    each rank's float32 (B, S, D) partial over its heads, summed over the
    model axis, then rounded to the model dtype once."""
    ax = model_split("heads", cfg.n_heads)
    if is_qtensor(p["wo"]):
        return cast(qmatmul(ctx, p["wo"], cfg, n_contract=2, ax=ax), cfg)
    b, s, h, hd = ctx.shape
    if stable:
        out = stable_mm(ctx.reshape(b, s, h * hd),
                        p["wo"].reshape(h * hd, -1), out32=ax is not None)
    elif ax is None:
        return torch.einsum("bshk,hkd->bsd", ctx, p["wo"])
    else:
        out = mm(ctx.reshape(b * s, h * hd), p["wo"].reshape(h * hd, -1),
                 out32=True).reshape(b, s, -1)
    return out if ax is None else cast(comm.all_reduce_sum(out, ax), cfg)


def _softmax_mode(cfg: ArchConfig, phase: str) -> str:
    return cfg.train_softmax_mode if phase == "train" else cfg.softmax_mode


KV_INT8_SCALE = 1.0 / 16.0  # calibration-provided symmetric scale


def kv_store_dtype(cfg: ArchConfig) -> torch.dtype:
    if cfg.kv_cache_dtype == "int8":
        return torch.int8
    return torch_dtype(cfg.dtype)


def kv_quant(x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """K/V rows as stored in the pages: int8 codes ``clip(round(x /
    KV_INT8_SCALE), -127, 127)`` for int8 pools, else the model dtype."""
    if cfg.kv_cache_dtype == "int8":
        codes = torch.round(true_div(x.float(), KV_INT8_SCALE))
        return torch.clamp(codes, -127, 127).to(torch.int8)
    return x.to(torch_dtype(cfg.dtype))


def kv_dequant(x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    if cfg.kv_cache_dtype == "int8":
        dt = torch_dtype(cfg.dtype)
        return x.to(dt) * torch.tensor(KV_INT8_SCALE, dtype=dt)
    return x


def _paged_kv_scale(cfg: ArchConfig):
    return KV_INT8_SCALE if cfg.kv_cache_dtype == "int8" else None


def decode_rows(q, tables, q_start, kv_len):
    """A causal chunk's B * C query rows as single-query decode rows: q
    (B, C, H, hd) -> (B * C, 1, H, hd), each row with its lane's table
    and its own key count ``min(q_start + j + 1, kv_len)`` (a padded row
    past ``n_valid`` sees the lane's ``kv_len`` keys, as under the causal
    mask). Returns (q, tables, positions, key counts) of the rows."""
    b, c = q.shape[:2]
    j = torch.arange(c, device=q_start.device)
    lens = torch.minimum(q_start[:, None] + j + 1, kv_len[:, None])
    lens = lens.reshape(-1).to(kv_len.dtype)
    return (q.reshape((b * c, 1) + q.shape[2:]),
            torch.repeat_interleave(tables, c, dim=0), lens - 1, lens)


def paged_attend(q, pool_k, pool_v, tables, q_start, kv_len,
                 cfg: ArchConfig, *, causal: bool,
                 rows_as_decode: bool = False) -> torch.Tensor:
    """Attention for C chunk queries per sequence against paged KV.

    q: (B, C, H, hd); pool_k/pool_v: (N, bs, KV, hd) one layer's pool
    (the chunk's own K/V already written); tables: (B, NB) page tables;
    q_start/kv_len: (B,) absolute position of q row 0 / valid key count.

    ``rows_as_decode`` (speculative verify; ``causal`` chunks only) runs
    the B * C rows as single-query decode rows (:func:`decode_rows`)
    through the decode route of the same op: the same function, and on
    the card the decode kernel's own reduction order, so each verify row
    has the bits of the decode step at its position. Prefill chunks keep
    the chunk route (tensor cores on the card).
    """
    mode = _softmax_mode(cfg, phase="serve")
    sole = mode == "sole"
    fn = ops.paged_attention_fn(mode, q.device, cfg.ops_backend)
    kv_scale = _paged_kv_scale(cfg)
    kw = dict(exp_bits=cfg.exp_bits,
              int8_scale=(LOGIT_INT8_SCALE if sole and cfg.logit_int8
                          else None),
              kv_scale=kv_scale,
              # w8a8: V stays raw int8 codes through P.V and kv_scale
              # folds into the final row scale (exact: a power of two).
              quant_pv=bool(cfg.quant.acts and kv_scale is not None))
    plan = _paged_tp_plan(active_rules(), cfg.n_heads, cfg.n_kv_heads)
    if plan is not None:
        kw["kv_head_map"] = _local_kv_map(plan, cfg, q.shape[2], q.device)
    if rows_as_decode and causal:
        rq, rt, rpos, rlen = decode_rows(q, tables, q_start, kv_len)
        out = fn(rq, pool_k, pool_v, rt, rpos, rlen, causal=False, **kw)
        return out.reshape(q.shape)
    return fn(q, pool_k, pool_v, tables, q_start, kv_len, causal=causal, **kw)


def _paged_tp_plan(rules, h: int, kvh: int):
    """Tensor-parallel plan for paged attention under the active rules
    (``repro/models/layers.py``'s ``_paged_tp_plan``).

    Returns ``(axes, kv_sharded)`` — the mesh axis (or axis tuple)
    sharding the q-heads dim, and whether the pool's kv_heads dim shards
    the same way — or None when heads fall back to replicated (the
    divisibility fallback, e.g. qwen2's 14 heads on a 4-way axis), the
    axis product is 1 (nothing to split) or no rules are active.
    """
    if rules is None:
        return None
    ax = rules.dim_spec("heads", h)
    if ax is None:
        return None
    names = ax if isinstance(ax, tuple) else (ax,)
    if math.prod(rules.axis_sizes[a] for a in names) == 1:
        return None
    return ax, rules.dim_spec("kv_heads", kvh) == ax


@functools.lru_cache(maxsize=None)
def _kv_map(hloc: int, first: int, g: int, device) -> torch.Tensor:
    """(hloc,) int32 ``(first + i) // g`` on ``device`` (made once; never
    written)."""
    i = torch.arange(hloc, dtype=torch.int32, device=device)
    return (i + first) // g


def _local_kv_map(plan, cfg: ArchConfig, hloc: int, device) -> torch.Tensor:
    """The KV head each of this rank's ``hloc`` query heads reads, the
    reference's two pool regimes:

    * matched — kv_heads shards with the heads; each rank holds its own
      contiguous KV block and local head ``i`` reads ``i // g``;
    * replicated KV — kv_heads does not divide the axis (GQA with few KV
      heads): the pool is whole on every rank and local head ``i`` on
      rank ``s`` reads global KV head ``(s * hloc + i) // g`` (a group
      may straddle two KV heads, and a KV head may be read by no local
      head).
    """
    _, kv_sharded = plan
    g = max(cfg.n_heads // max(cfg.n_kv_heads, 1), 1)
    first = 0 if kv_sharded else comm.model_axis(active_rules()).index * hloc
    return _kv_map(hloc, first, g, device)


def _replicated_kv_index(cfg: ArchConfig, device) -> Optional[torch.Tensor]:
    """Under the replicated-KV regime (heads split over the model axis, KV
    heads whole), the global KV head each local query head reads
    (:func:`_local_kv_map`, int64); None in the other regimes (matched:
    local head ``i`` reads local KV head ``i // g``; heads replicated)."""
    plan = _paged_tp_plan(active_rules(), cfg.n_heads, cfg.n_kv_heads)
    if plan is None or plan[1]:
        return None
    hloc = cfg.n_heads // comm.model_axis(active_rules()).size
    return _local_kv_map(plan, cfg, hloc, device).long()


def _kv_for_local_heads(k, v, cfg: ArchConfig):
    """Under the replicated-KV regime, the dense paths' K/V (B, T, KV, hd)
    gathered to one KV head per local query head, so ``repeat_kv`` sees g
    = 1; otherwise as they are."""
    idx = _replicated_kv_index(cfg, k.device)
    if idx is None:
        return k, v
    return k[:, :, idx], v[:, :, idx]


# -- dense and blocked attention (whole sequences) ------------------------------

_BLOCK_NEG = -1e30                 # the blocked path's masked logit
_LN2E = 1.4426950408889634


def _mask(q_pos, k_pos, cfg: ArchConfig, causal: bool) -> torch.Tensor:
    """(..., S_q, S_k) boolean mask from positions; padded keys carry
    position 2**30."""
    m = k_pos[..., None, :] < 2 ** 29
    m = torch.broadcast_to(m, tuple(q_pos.shape) + (k_pos.shape[-1],))
    if causal:
        m = m & (q_pos[..., :, None] >= k_pos[..., None, :])
    if cfg.window:
        m = m & ((q_pos[..., :, None] - k_pos[..., None, :]) < cfg.window)
    return m


def _sole_probs(logits, mask, cfg: ArchConfig, out_dtype) -> torch.Tensor:
    """SOLE attention probabilities in ``out_dtype``, one op call (one
    kernel launch on CUDA): the masked row max (floored for fully masked
    rows), the int8 snap of ``logits - max`` (``int8_scale``) and
    E2Softmax, the reference's max, subtract, snap, op and cast."""
    return ops.softmax_fn("sole", logits.device, cfg.ops_backend)(
        logits, mask=mask, exp_bits=cfg.exp_bits,
        int8_scale=LOGIT_INT8_SCALE if cfg.logit_int8 else None,
        out_dtype=out_dtype)


def attend_dense(q, k, v, q_pos, k_pos, cfg: ArchConfig, phase: str,
                 causal: bool = True) -> torch.Tensor:
    """Materialized-logits attention. q (B,S,H,hd), k/v (B,T,KV,hd);
    positions (S,)/(T,) shared or (B,S)/(B,T) per lane. The logits are the
    model-dtype product, then float32, as in the reference."""
    b, s, h, hd = q.shape
    k = repeat_kv(k, h)
    v = repeat_kv(v, h)
    qs = q * (hd ** -0.5)
    logits = torch.einsum("bshd,bthd->bhst", qs, k).float()
    mask = _mask(q_pos, k_pos, cfg, causal)          # (s, t) or (b, s, t)
    if mask.ndim == 3:                               # per-lane positions
        mask = mask[:, None]
    mask = torch.broadcast_to(mask, logits.shape)
    mode = _softmax_mode(cfg, phase)
    if mode == "sole":
        probs = _sole_probs(logits, mask, cfg, q.dtype)
    else:
        probs = ops.softmax_fn(mode, q.device, cfg.ops_backend)(
            logits, mask=mask).to(q.dtype)
    return torch.einsum("bhst,bthd->bshd", probs, v)


def _online_chunk(qc, qp, kb, vb, pb, cfg: ArchConfig, sole: bool,
                  causal: bool, out_dtype) -> torch.Tensor:
    """One q chunk's pass over the k-blocks: qc (b, qblk, h, hd) at
    positions qp (qblk,); kb/vb (nkb, b, blk, h, hd) at pb (nkb, blk).
    Returns (b, h, qblk, hd) in ``out_dtype``."""
    b, qblk, h, hd = qc.shape
    qs = (qc * (hd ** -0.5)).float()
    dev = qc.device
    m_run = torch.full((b, h, qblk), _BLOCK_NEG, device=dev)
    s_run = torch.zeros((b, h, qblk), device=dev)
    acc = torch.zeros((b, h, qblk, hd), device=dev)
    loop = Trips(kb.shape[0], dev)     # two trips on meta, counted nkb
    for j in loop:
        kc, vc, pc = kb[j], vb[j], pb[j]
        logits = torch.einsum("bshd,bthd->bhst", qs, kc.float())
        mask = torch.broadcast_to(_mask(qp, pc, cfg, causal), logits.shape)
        logits = torch.where(mask, logits, _BLOCK_NEG)
        m_new = torch.maximum(m_run, logits.amax(-1))
        if sole:
            d = ops.snap_logits(logits - m_new[..., None],
                                LOGIT_INT8_SCALE if cfg.logit_int8 else None)
            kcode = log2exp(d, exp_bits=cfg.exp_bits)
            w = torch.where(mask, exp2_int(-kcode), 0.0)
            sub = log2exp(m_run - m_new, exp_bits=cfg.exp_bits + 2)
            corr = exp2_int(-sub)
        else:
            w = torch.where(mask, torch.exp2((logits - m_new[..., None])
                                             * _LN2E), 0.0)
            corr = torch.exp2((m_run - m_new) * _LN2E)
        s_run = s_run * corr + w.sum(-1)
        acc = acc * corr[..., None] + torch.einsum("bhst,bthd->bhsd", w,
                                                   vc.float())
        m_run = m_new
        loop.carry(m_run, s_run, acc)
    s_run = torch.clamp_min(s_run, 2.0 ** -30)
    if sole:
        # ALDivision with k_y = 0: per row 2^-(k_s + 1) (1.636 - q)
        k_s, q = split_sum(s_run)
        scale = exp2_int(-(k_s + 1)) * torch.where(q, ALDIV_BIAS - 0.5,
                                                   ALDIV_BIAS)
    else:
        scale = 1.0 / s_run
    return (acc * scale[..., None]).to(out_dtype)


def attend_blocked(q, k, v, q_pos, k_pos, cfg: ArchConfig, phase: str,
                   causal: bool = True) -> torch.Tensor:
    """Online-normalized blocked attention (one flash-style pass), tiled
    over Q and KV in blocks of ``cfg.attn_block``: q (B,S,H,hd), k/v
    (B,T,KV,hd), shared positions (S,)/(T,). Returns (B,S,H,hd).

    In SOLE mode each k-block's post-max logits are snapped to the int8
    grid and weighted by their 4-bit codes ``2^-k``; the running sum is
    rescaled by the quantized correction ``2^-Log2Exp(m_old - m_new)``
    (``exp_bits + 2`` bits) and ALDivision scales each row once at the
    end. Powers of two are built from exponent bits. With a sliding
    window (causal) each q chunk scans only its key band."""
    b, s, h, hd = q.shape
    k = repeat_kv(k, h)
    v = repeat_kv(v, h)
    t = k.shape[1]
    blk = min(cfg.attn_block, t)
    padk = (-t) % blk
    if padk:
        k = F.pad(k, (0, 0, 0, 0, 0, padk))
        v = F.pad(v, (0, 0, 0, 0, 0, padk))
        k_pos = F.pad(k_pos, (0, padk), value=2 ** 30)
    tk = t + padk
    qblk = min(cfg.attn_block, s)
    padq = (-s) % qblk
    if padq:
        q = F.pad(q, (0, 0, 0, 0, 0, padq))
        q_pos = F.pad(q_pos, (0, padq))
    nqb = (s + padq) // qblk
    sole = _softmax_mode(cfg, phase) == "sole"

    def blocks(kk, vv, pp):
        n = kk.shape[1] // blk
        return (kk.reshape(b, n, blk, h, hd).transpose(0, 1),
                vv.reshape(b, n, blk, h, hd).transpose(0, 1),
                pp.reshape(n, blk))

    band = cfg.window and causal and tk > cfg.window + blk
    if band:
        # a q chunk starting at q0 sees keys in [q0 - window + 1, q0 +
        # qblk) only: scan that fixed-size band of K/V
        span = min(-(-(cfg.window + qblk) // blk) * blk, tk)
    else:
        kb, vb, pb = blocks(k, v, k_pos)
    ctx = []
    loop = Trips(nqb, q.device)        # two trips on meta, counted nqb
    for i in loop:
        if band:
            start = min(max(i * qblk + qblk - span, 0), tk - span)
            kb, vb, pb = blocks(k[:, start:start + span],
                                v[:, start:start + span],
                                k_pos[start:start + span])
        ctx.append(_online_chunk(q[:, i * qblk:(i + 1) * qblk],
                                 q_pos[i * qblk:(i + 1) * qblk], kb, vb, pb,
                                 cfg, sole, causal, q.dtype))
    ctx = torch.cat(loop.kept(ctx), 2).transpose(1, 2)  # (b, S + padq, h, hd)
    return ctx[:, :s]


def apply_attention(p, x, positions, cfg: ArchConfig, phase: str,
                    causal: Optional[bool] = None) -> torch.Tensor:
    """Self-attention over x (B,S,D) at ``positions`` (S,): dense, or
    blocked under ``attn_impl="blocked"`` (``auto`` picks it from 8192
    tokens on)."""
    causal = cfg.causal if causal is None else causal
    q, k, v = _project_qkv(p, x, cfg)
    k, v = _kv_for_local_heads(k, v, cfg)
    if cfg.pos_kind == "rope":
        q = apply_rope(q, positions, cfg)
        k = apply_rope(k, positions, cfg)
    attend = (attend_blocked if attn_impl(cfg, x.shape[1]) == "blocked"
              else attend_dense)
    ctx = attend(q, k, v, positions, positions, cfg, phase, causal=causal)
    return _wo_proj(ctx, p, cfg)


def apply_attention_mrope(p, x, positions3, cfg: ArchConfig,
                          phase: str) -> torch.Tensor:
    """qwen2-vl self-attention with M-RoPE positions (3, B, S), causal in
    the flattened order (the temporal positions never decrease)."""
    q, k, v = _project_qkv(p, x, cfg)
    q = apply_mrope(q, positions3, cfg)
    k = apply_mrope(k, positions3, cfg)
    s = x.shape[1]
    flat_pos = torch.arange(s, device=x.device)
    attend = (attend_blocked if attn_impl(cfg, s) == "blocked"
              else attend_dense)
    ctx = attend(q, k, v, flat_pos, flat_pos, cfg, phase, causal=True)
    return _wo_proj(ctx, p, cfg)


def apply_cross_attention(p, x, enc_kv, cfg: ArchConfig, phase: str,
                          k_pos: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Cross-attention: queries from x (B,S,D), keys and values the
    encoder's (B,T,KV,hd) pair. ``k_pos`` (T,) shared or (B,T) per lane
    marks padded encoder rows with 2**30 (masked out): a per-lane mask is
    (B, 1, S, T), read at stride 0 over heads."""
    if is_qtensor(p["wq"]):
        q = cast(qmatmul(x, p["wq"], cfg), cfg)
    else:
        q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    if cfg.qkv_bias:
        q = q + p["bq"]
    k, v = enc_kv
    s, t = x.shape[1], k.shape[1]
    if k_pos is None:
        k_pos = torch.arange(t, device=x.device)
    q_pos = torch.arange(s, device=x.device)
    if k_pos.ndim == 2:           # per-lane encoder validity (paged serving)
        q_pos = torch.broadcast_to(q_pos, (x.shape[0], s))
    ctx = attend_dense(q, k, v, q_pos, k_pos, cfg, phase, causal=False)
    return _wo_proj(ctx, p, cfg)


def cross_kv(p, enc_out, cfg: ArchConfig):
    """The encoder states' (B,T,KV,hd) keys and values for one decoder
    layer's cross-attention."""
    if is_qtensor(p["wk"]):
        k = cast(qmatmul(enc_out, p["wk"], cfg), cfg)
        v = cast(qmatmul(enc_out, p["wv"], cfg), cfg)
    else:
        k = torch.einsum("btd,dhk->bthk", enc_out, p["wk"])
        v = torch.einsum("btd,dhk->bthk", enc_out, p["wv"])
    if cfg.qkv_bias:
        k = k + p["bk"]
        v = v + p["bv"]
    return k, v


def attn_impl(cfg: ArchConfig, s: int) -> str:
    """``cfg.attn_impl`` for a sequence of ``s`` tokens: ``auto`` is
    blocked from 8192 tokens on, dense below."""
    if cfg.attn_impl == "auto":
        return "blocked" if s >= 8192 else "dense"
    return cfg.attn_impl


def decode_attend_stacked(p, x1, ck, cv, cpos, layer_idx: int, pos,
                          cfg: ArchConfig, slot: int,
                          positions3: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token attention against the stacked dot-layout caches
    ck (L,B,KV,hd,T) and cv (L,B,KV,T,hd), which are only read here: the
    current token's (k, v) is attended as column T+1 and returned, and the
    caller writes every layer's column after the layer loop. Under mesh
    rules the caches hold the rank's KV heads and this rank's query heads
    read them as the paged kernel does (:func:`_replicated_kv_index`). ``cpos`` is
    the position ring (T,) or per lane (B,T); ``pos`` scalar or per lane
    (B,); ``slot`` the ring column this step writes (its stale content is
    masked out). M-RoPE models pass the token's 3-axis ``positions3``
    (3, B, 1). The logits are float32 products of
    the model-dtype operands. Returns (attn_out, k_col (B,KV,hd,1), v_row
    (B,KV,1,hd)).
    """
    q, k, v = _project_qkv(p, x1, cfg)
    if cfg.pos_kind == "rope":
        rp = pos[:, None] if pos.ndim else pos[None]
        q = apply_rope(q, rp, cfg)
        k = apply_rope(k, rp, cfg)
    elif cfg.pos_kind == "mrope" and positions3 is not None:
        q = apply_mrope(q, positions3, cfg)
        k = apply_mrope(k, positions3, cfg)
    t = ck.shape[-1]
    kl = kv_dequant(ck[layer_idx], cfg)                  # (B,KV,hd,T)
    vl = kv_dequant(cv[layer_idx], cfg)                  # (B,KV,T,hd)
    kq, vq = k, v
    idx = _replicated_kv_index(cfg, q.device)
    if idx is not None:          # local query heads on the whole KV
        kl, vl, k, v = kl[:, idx], vl[:, idx], k[:, :, idx], v[:, :, idx]
    b, _, h, hd = q.shape
    kvh = kl.shape[1]
    g = h // kvh
    cpos2 = cpos if cpos.ndim == 2 else cpos[None]       # (1|B, T)
    pos2 = (pos if pos.ndim else pos[None])[:, None]     # (1|B, 1)
    valid = cpos2 <= pos2
    if cfg.window:
        valid = valid & ((pos2 - cpos2) < cfg.window)
    valid = valid & (torch.arange(t, device=q.device)[None] != slot)
    mode = _softmax_mode(cfg, phase="serve")
    qg = (q * (hd ** -0.5)).reshape(b, kvh, g, hd)
    kc = k.reshape(b, kvh, 1, hd)                        # current token
    vc = v.reshape(b, kvh, 1, hd)
    logits_c = torch.einsum("bkgd,bkdt->bkgt", qg.float(), kl.float())
    logit_s = torch.einsum("bkgd,bkxd->bkgx", qg.float(),
                           kc.to(qg.dtype).float())
    logits = torch.cat([logits_c, logit_s], -1)          # (B,KV,g,T+1)
    mask = torch.cat(
        [torch.broadcast_to(valid[:, None, None, :], (b, kvh, g, t)),
         torch.ones((b, kvh, g, 1), dtype=torch.bool, device=q.device)], -1)
    if mode == "sole":
        probs = _sole_probs(logits, mask, cfg, q.dtype)
    else:
        probs = ops.softmax_fn(mode, q.device, cfg.ops_backend)(
            logits, mask=mask).to(q.dtype)
    ctx = torch.einsum("bkgt,bktd->bkgd", probs[..., :t], vl)
    ctx = ctx + probs[..., t:] * vc
    out = _wo_proj(ctx.reshape(b, 1, h, hd), p, cfg)
    k_col = kv_quant(kq, cfg).permute(0, 2, 3, 1)        # (B,KV,hd,1)
    v_row = kv_quant(vq, cfg).permute(0, 2, 1, 3)        # (B,KV,1,hd)
    return out, k_col, v_row


def decode_attend(p, x1, cache, pos: int, cfg: ArchConfig) -> torch.Tensor:
    """One-token self-attention against one layer's (B, T, KV, hd) cache
    and its position ring ``cache["pos"]`` (T,), the reference's
    ``decode_attend`` (the hybrid's dense-slot path): ``pos`` is the shared
    absolute position, for windowed models the cache a rolling buffer of
    min(T, window) columns. The current token's K/V and position are
    written into the cache **in place** at its slot before the attention
    reads it. Returns the attention output (B, 1, D)."""
    q, k, v = _project_qkv(p, x1, cfg)
    pos_t = torch.tensor([pos], dtype=torch.int32, device=x1.device)
    if cfg.pos_kind == "rope":
        q = apply_rope(q, pos_t, cfg)
        k = apply_rope(k, pos_t, cfg)
    ck, cv, cpos = cache["k"], cache["v"], cache["pos"]
    t = ck.shape[1]
    slot = pos % t if cfg.window else min(pos, t - 1)
    ck[:, slot] = k[:, 0].to(ck.dtype)
    cv[:, slot] = v[:, 0].to(cv.dtype)
    cpos[slot] = pos
    b, _, h, hd = q.shape
    kf = repeat_kv(cast(ck, cfg), h)
    vf = repeat_kv(cast(cv, cfg), h)
    qs = q * (hd ** -0.5)
    logits = torch.einsum("bshd,bthd->bhst", qs, kf).float()
    valid = cpos <= pos
    if cfg.window:
        valid = valid & ((pos - cpos) < cfg.window)
    mask = torch.broadcast_to(valid[None, None, None, :], logits.shape)
    mode = _softmax_mode(cfg, phase="serve")
    if mode == "sole":
        probs = _sole_probs(logits, mask, cfg, q.dtype)
    else:
        probs = ops.softmax_fn(mode, q.device, cfg.ops_backend)(
            logits, mask=mask).to(q.dtype)
    ctx = torch.einsum("bhst,bthd->bshd", probs, vf)
    return _wo_proj(ctx, p, cfg)


def write_kv_columns(ck, cv, k_cols, v_rows, slot: int) -> None:
    """Write all layers' decode columns, k_cols (L,B,KV,hd,1) and v_rows
    (L,B,KV,1,hd), into the stacked caches at ring column ``slot``, in
    place."""
    ck[..., slot] = k_cols[..., 0].to(ck.dtype)
    cv[..., slot, :] = v_rows[..., 0, :].to(cv.dtype)


def pack_prefill_cache(k, v, positions, t: int, cfg: ArchConfig):
    """One layer's prefill K/V (B,S,KV,hd) -> the dot-layout rings
    (B,KV,hd,T) and (B,KV,T,hd) and their positions, (T,) shared or (B,T)
    per lane (pad slots hold 2**30)."""
    s = k.shape[1]
    if s >= t:
        kk, vv, pp = k[:, -t:], v[:, -t:], positions[..., -t:]
    else:
        kk = F.pad(k, (0, 0, 0, 0, 0, t - s))
        vv = F.pad(v, (0, 0, 0, 0, 0, t - s))
        pp = F.pad(positions, (0, t - s), value=2 ** 30)
    if cfg.window:
        shift = s % t if s >= t else 0
        kk = torch.roll(kk, shift, 1)
        vv = torch.roll(vv, shift, 1)
        pp = torch.roll(pp, shift, -1)
    kq = kv_quant(kk, cfg).permute(0, 2, 3, 1).contiguous()
    vq = kv_quant(vv, cfg).permute(0, 2, 1, 3).contiguous()
    return kq, vq, pp.to(torch.int32)
