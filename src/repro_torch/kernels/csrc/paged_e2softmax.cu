// Paged Flash-E2Softmax attention over a block-paged KV pool, for sm_90a.
//
// Replaces src/repro/kernels/flash_e2softmax.py::_paged_kernel (with
// _online_update and _final_scale; entry points flash_e2softmax_paged and
// flash_e2softmax_paged_decode): every prefill chunk (causal) and every
// decode step (C = 1) of the serve path.
//
// The function. For each (sequence b, query head h, query row) the pages of
// the sequence's table j = 0..NB-1 apply one online update each, *in order*,
// as the TPU kernel's sequential grid axis does:
//   logits = (q * d^-1/2) . k^T, masked to col < kv_len (and, causal,
//            q_start + row >= col); masked logits are NEG = -1e30
//   m_j = max(m_{j-1}, max of the page's logits)
//   SOLE : dm = logit - m_j, optional int8 snap clip(rint(dm * (1/s)),
//          -127, 0) * s (the jitted reference multiplies by float32(1/s)),
//          w = 2^-clip(rint(-1.4375 dm), 0, 2^b - 1), masked w = 0;
//          corr_j = 2^-clip(rint(1.4375 (m_j - m_{j-1})), 0, 2^(b+2) - 1)
//   exact: w = exp2(dm log2 e), corr_j = exp2((m_{j-1} - m_j) log2 e)
//   s = s * corr_j + sum(w);  acc = acc * corr_j + w . v
// and at the end out = acc * 2^-e * {1.636, 1.136} (ALDivision, e and the
// mantissa bit from frexp(max(s, 2^-30))) or acc / s (exact mode). SOLE's
// quantized correction makes the page order part of the function, but only
// the combine needs it: every page's logits and maximum are independent, the
// running maximum m_j is a prefix maximum (exact), and from it each page's
// correction and weights follow; only s and acc are carried page to page.
// A page a row cannot see is the identity for that row (corr = 1, w = 0), so
// pages past the last one any row of a tile sees are skipped, and any tiling
// of the rows computes the same function. Int8 page pools (the W8A8 path)
// carry codes with one scale kv_scale (a power of two, 1/16 on the serve
// path): K is dequantized to k * kv_scale, and so is V unless quant_pv, where
// P.V accumulates the raw V codes and kv_scale multiplies the final row scale.
//
// What bounds it on an H100: bytes at decode (each live K/V page read once
// per sequence and KV head, ~2 flops per byte); prefill chunks reach ~64
// flops per byte, still below the card's ~295 bf16 operations per byte. The
// bound is the bytes of q, the live pages and the output at 3.35 TB/s.
//
// Design. One CTA per (sequence, KV head, tile of query rows) serves every
// query head that kv_head_map sends to that KV head, so each page is read
// from device memory once per GQA group and row tile (at decode, once per
// sequence and KV head). The map is explicit and need not be contiguous (the
// replicated-KV tensor-parallel map is not): the CTA scans it for its heads
// and orders its rows r = c * G + i (query c, i-th head of the group; 4
// rows a group at minitron's and mixtral's decode, 6 at dbrx's, 16 at
// recurrentgemma's, all in one 16-row mma tile). Kernels chosen by type,
// head dim and C:
//
// bf16 q over bf16 or int8 pools of 16-token pages, d a multiple of 16 up
// to 64 with d^-1/2 a power of two (16, 64), up to 128, or 256: the
// tensor cores (mma.sync m16n8k16 bf16 -> float32, K fragments by
// ldmatrix, V by ldmatrix.trans), instantiated at padded head dims 64, 128
// and 256. Both kernels read their page table and head list into shared
// memory and fill a ring of K/V tiles by cp.async two loads ahead (one at
// 256 in the decode kernel, for room). What each head dim settles:
//  * The scale. d^-1/2 = 2^-3 (64), 1/4 (16) and 1/16 (256) are powers of
//    two, folded into the bf16 q exactly. At 128 it is 2^-3.5: q is scaled
//    in float32 with __fmul_rn, as the plain version does, and split into
//    three bf16 parts hi + mid + lo (8 of float32's 24 significant bits
//    each, exact barring underflow); every part's product with a bf16 (or
//    int8) key is exact in float32, so the logits differ from the plain
//    version's only in the summation order, as at 64. The two extra
//    products of Q.K^T cost little: decode is bound by the K/V bytes.
//  * Shared memory and registers. Prefill chunks (C > 1): chunks of 512 /
//    DP pages (8, 4, 2), so a ring stage holds ~35 KB of bf16 K/V at any
//    head dim; a CTA of 4 warps owns 64 rows, 16 per warp (32 at 256,
//    where two warps share a 16-row group and each owns half the head dim,
//    so a warp's float32 accumulator stays at 64 registers a thread); q is
//    read from shared memory by ldmatrix at each k-step instead of being
//    held. Each warp computes all the chunk's pages' logits at once and
//    their maxima, then walks the pages in order: prefix max, weights,
//    correction, s, and acc * corr plus the page's P.V.
//  * Filling the card at decode (C = 1), where B * KV CTAs can be as few
//    as 8 (recurrentgemma: 16 heads on 1 KV head). The S CTAs of a thread-
//    block cluster (S a power of two up to DP / 32, chosen per launch to
//    fill the card's SMs once) share one tile of one sequence; a round of S
//    x 4 warps x (2 at 64, else 1) pages gives each warp its own page(s):
//    logits and maxima to shared memory, a cluster barrier, the round's
//    maxima gathered through distributed shared memory (the prefix maximum
//    is exact, formed from the page maxima), each page's weights, row sums
//    and P.V partial from its prefix maximum, a cluster barrier, then the
//    in-order combine s = s * corr_j + sum_j, acc = acc * corr_j + pv_j
//    (the plain version's own order), each CTA over its DP / S columns,
//    reading every page's partial from the CTA that made it. A cluster,
//    not two passes: the maxima and partials stay on chip and K/V is read
//    once. Every page's partial and the fold over them are the same
//    whatever S, so the split never changes a bit: a verify row through
//    this kernel keeps the decode step's bits whatever the batch.
// The products are exact: bf16 x bf16 is exact in float32; SOLE weights
// 2^-k are exact in bf16 and exact mode splits P into hi + lo bf16 halves
// (~2^-17 relative); int8 codes are exact in bf16, and kv_scale, a power of
// two, multiplies the float32 logits after Q.K^T and the final row scale
// instead of V (both quant_pv settings), which is exact barring underflow
// (below 2^-126, far from the path's values). Only the float32 summation
// order differs from the plain version. Arguments the chosen instantiation
// cannot take (a page table too wide for shared memory) fail the launch;
// nothing drops to the CUDA cores.
// float32 q, 8-token pages, an int8 pool's kv_scale that is no power of
// two, and other head dims: the CUDA cores, one page at a time through
// shared memory as float32, a lane per key for the logits and per head-dim
// column for the accumulator, the same CTA-per-KV-group tiling. It is the
// float32 path's kernel, not a fallback.
// All: powers of two from exponent bits or ldexpf, rounding half to even
// like jnp.round, __fmul_rn/__fsub_rn keep the codes' inputs out of FMA
// contraction; no atomics, and nothing depends on the launch's timing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <cooperative_groups.h>
#include <type_traits>

#include "flash_common.cuh"

namespace {

constexpr int kMaxHeads = 512;              // H <= 512

// The CTA's query heads: every h with kv_head_map[h] == kvh, in order.
// The map is read by all threads at once (one round trip), then compacted
// in shared memory by one thread. Returns their count; heads[] in shared
// memory.
__device__ __forceinline__ int group_heads(const int* __restrict__ kv_head_map, int H, int kvh,
                                           int* heads, int* count) {
  for (int h = threadIdx.x; h < H; h += blockDim.x) heads[h] = kv_head_map[h] == kvh;
  __syncthreads();
  if (threadIdx.x == 0) {
    int g = 0;
    for (int h = 0; h < H; ++h)
      if (heads[h]) heads[g++] = h;        // g <= h: reads stay ahead of writes
    *count = g;
  }
  __syncthreads();
  return *count;
}

// -- CUDA cores: float32 q, and shapes the tensor-core kernel does not take ----

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxRowsPerWarp = 4;          // BQ = kWarps * kMaxRowsPerWarp rows a CTA
constexpr int kRowTile = kWarps * kMaxRowsPerWarp;
constexpr int kMaxDimChunks = 8;            // head_dim <= 256

template <typename TQ, typename TP>
__global__ void __launch_bounds__(kThreads)
paged_e2softmax_kernel(const TQ* __restrict__ q, const TP* __restrict__ k_pool,
                       const TP* __restrict__ v_pool, const int* __restrict__ tables,
                       const int* __restrict__ meta, const int* __restrict__ kv_head_map,
                       float* __restrict__ out, int H, int C, int d, int bs, int KV,
                       int NB, int causal, int sole, int exp_bits,
                       int has_snap, float int8_scale, float snap_inv,
                       float qk_scale, int quant_pv, float kv_scale) {
  // Int8 pools always carry kv_scale; float pools compile without it.
  constexpr bool kInt8Pool = std::is_same<TP, int8_t>::value;
  extern __shared__ float smem[];
  __shared__ int heads[kMaxHeads];
  __shared__ int n_heads;
  const int kstride = d + 1;
  float* Ks = smem;                         // bs x (d + 1)
  float* Vs = Ks + bs * kstride;            // bs x d
  float* Qs = Vs + bs * d;                  // kRowTile x d, pre-scaled
  float* Ws = Qs + kRowTile * d;            // kWarps x bs: logits, then weights

  const int b = blockIdx.x / KV, kvh = blockIdx.x % KV;
  const int G = group_heads(kv_head_map, H, kvh, heads, &n_heads);
  const int t0 = blockIdx.y * kRowTile;
  if (t0 >= G * C) return;                  // block-uniform: no rows here
  const int rows = min(kRowTile, G * C - t0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q_start = meta[2 * b], kv_len = meta[2 * b + 1];
  const float kmax = (float)((1 << exp_bits) - 1);
  const float submax = (float)((1 << (exp_bits + 2)) - 1);

  for (int idx = threadIdx.x; idx < rows * d; idx += kThreads) {
    const int r = t0 + idx / d, i = idx % d;
    const int c = r / G, h = heads[r % G];
    Qs[idx] = __fmul_rn(to_f32(q[(((size_t)b * H + h) * C + c) * d + i]), qk_scale);
  }

  float m_run[kMaxRowsPerWarp], s_run[kMaxRowsPerWarp];
  float acc[kMaxRowsPerWarp][kMaxDimChunks];
#pragma unroll
  for (int rr = 0; rr < kMaxRowsPerWarp; ++rr) {
    m_run[rr] = kNeg;
    s_run[rr] = 0.0f;
#pragma unroll
    for (int ch = 0; ch < kMaxDimChunks; ++ch) acc[rr][ch] = 0.0f;
  }
  float* Wrow = Ws + warp * bs;
  const int last_pos = q_start + (t0 + rows - 1) / G;

  for (int j = 0; j < NB; ++j) {
    const int col0 = j * bs;
    if (col0 >= kv_len || (causal && col0 > last_pos)) break;   // block-uniform
    const size_t page = (size_t)tables[(size_t)b * NB + j];
    __syncthreads();                        // previous page fully consumed
    for (int idx = threadIdx.x; idx < bs * d; idx += kThreads) {
      const int t = idx / d, i = idx - t * d;
      const size_t src = ((page * bs + t) * KV + kvh) * (size_t)d + i;
      if constexpr (kInt8Pool) {
        const float vf = to_f32(v_pool[src]);
        Ks[t * kstride + i] = __fmul_rn(to_f32(k_pool[src]), kv_scale);
        Vs[idx] = quant_pv ? vf : __fmul_rn(vf, kv_scale);
      } else {
        Ks[t * kstride + i] = to_f32(k_pool[src]);
        Vs[idx] = to_f32(v_pool[src]);
      }
    }
    __syncthreads();

#pragma unroll
    for (int rr = 0; rr < kMaxRowsPerWarp; ++rr) {
      const int r = warp + rr * kWarps;
      if (r >= rows) continue;              // warp-uniform
      const int row_pos = q_start + (t0 + r) / G;
      const float* qr = Qs + r * d;
      float lmax = kNeg;
      for (int t = lane; t < bs; t += 32) {
        const float* kr = Ks + t * kstride;
        float dot = 0.0f;
        for (int i = 0; i < d; ++i) dot = fmaf(qr[i], kr[i], dot);
        const int col = col0 + t;
        const bool keep = col < kv_len && (!causal || row_pos >= col);
        const float lg = keep ? dot : kNeg;
        Wrow[t] = lg;
        lmax = fmaxf(lmax, lg);
      }
      const float m_prev = m_run[rr];
      const float m_new = fmaxf(m_prev, warp_max(lmax));
      float corr;
      if (sole) {
        const float sub = fminf(fmaxf(rintf(__fmul_rn(__fsub_rn(m_new, m_prev), kInvLn2Shift)),
                                      0.0f), submax);
        corr = ldexpf(1.0f, -(int)sub);
      } else {
        corr = exp2f(__fmul_rn(__fsub_rn(m_prev, m_new), kLog2e));
      }
      float lsum = 0.0f;
      for (int t = lane; t < bs; t += 32) {
        const int col = col0 + t;
        const bool keep = col < kv_len && (!causal || row_pos >= col);
        float dm = __fsub_rn(Wrow[t], m_new);
        float w;
        if (sole) {
          if (has_snap)
            dm = __fmul_rn(fminf(fmaxf(rintf(__fmul_rn(dm, snap_inv)), -127.0f), 0.0f),
                           int8_scale);
          const float kc = fminf(fmaxf(rintf(__fmul_rn(-dm, kInvLn2Shift)), 0.0f), kmax);
          w = keep ? ldexpf(1.0f, -(int)kc) : 0.0f;
        } else {
          w = keep ? exp2f(__fmul_rn(dm, kLog2e)) : 0.0f;
        }
        Wrow[t] = w;
        lsum += w;
      }
      const float page_sum = warp_sum(lsum);
      __syncwarp();
      s_run[rr] = __fadd_rn(__fmul_rn(s_run[rr], corr), page_sum);
      m_run[rr] = m_new;
#pragma unroll
      for (int ch = 0; ch < kMaxDimChunks; ++ch) {
        const int i = ch * 32 + lane;
        if (i < d) {
          float pv = 0.0f;
          for (int t = 0; t < bs; ++t) pv = fmaf(Wrow[t], Vs[t * d + i], pv);
          acc[rr][ch] = __fadd_rn(__fmul_rn(acc[rr][ch], corr), pv);
        }
      }
      __syncwarp();                         // Wrow is reused by the next row
    }
  }

#pragma unroll
  for (int rr = 0; rr < kMaxRowsPerWarp; ++rr) {
    const int r = warp + rr * kWarps;
    if (r >= rows) continue;
    float scale = final_scale(s_run[rr], sole);
    if (kInt8Pool && quant_pv) scale = __fmul_rn(scale, kv_scale);
    const int c = (t0 + r) / G, h = heads[(t0 + r) % G];
    float* orow = out + (((size_t)b * H + h) * C + c) * d;
#pragma unroll
    for (int ch = 0; ch < kMaxDimChunks; ++ch) {
      const int i = ch * 32 + lane;
      if (i < d) orow[i] = __fmul_rn(acc[rr][ch], scale);
    }
  }
}

template <typename TQ, typename TP>
int launch(const void* q, const void* k_pool, const void* v_pool, const void* tables,
           const void* meta, const void* kv_head_map, void* out, int B, int H, int C,
           int d, int bs, int KV, int NB, int causal, int sole, int exp_bits,
           int has_snap, float int8_scale, float snap_inv, float qk_scale,
           int quant_pv, float kv_scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) *
      ((size_t)bs * (d + 1) + (size_t)bs * d + (size_t)kRowTile * d + (size_t)kWarps * bs);
  auto kernel = paged_e2softmax_kernel<TQ, TP>;
  static size_t allowed = 48 * 1024;        // per instantiation: opt in once
  if (smem > allowed) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
    allowed = smem;
  }
  // rows of a KV group: at most H * C (the CTA finds its own count)
  dim3 grid(B * KV, (H * C + kRowTile - 1) / kRowTile);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TP*>(k_pool),
      static_cast<const TP*>(v_pool), static_cast<const int*>(tables),
      static_cast<const int*>(meta), static_cast<const int*>(kv_head_map),
      static_cast<float*>(out), H, C, d, bs, KV, NB, causal, sole, exp_bits, has_snap,
      int8_scale, snap_inv, qk_scale, quant_pv, kv_scale);
  return (int)cudaGetLastError();
}

// -- bf16 q: tensor cores ---------------------------------------------------------

constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = kMmaWarps * 32;
constexpr int kPage = 16;                   // tokens per page: one 16-key mma tile
// dynamic shared memory a CTA may ask for, beside the static head list
constexpr size_t kMaxSmem = 220 * 1024;
constexpr int kStages = 3;                  // ring depth of the chunk kernel: two loads ahead

// The tensor-core instantiation of padded head dim DP (64, 128 or 256) over
// pools of TP: tile rows of DP + 8 bf16 in shared memory; q in kQParts bf16
// tiles (three at DP 128, where d^-1/2 is no power of two). Chunk kernel
// (C > 1): chunks of kChunkPages pages (512 / DP: a stage holds ~35 KB of
// bf16 K/V whatever DP), warps of kColSplit sharing a 16-row group, each
// with kCols accumulator columns (64 registers a thread at most).
template <int DP, typename TP>
struct Mma {
  static constexpr int kStride = DP + 8;                      // bf16 per tile row
  static constexpr bool kInt8 = std::is_same<TP, int8_t>::value;
  static constexpr int kRawRow = kInt8 ? DP : kStride * 2;    // bytes per raw row
  static constexpr int kQParts = DP == 128 ? 3 : 1;
  static constexpr int kChunkPages = 512 / DP;
  static constexpr int kChunkKeys = kChunkPages * kPage;
  static constexpr int kColSplit = DP == 256 ? 2 : 1;
  static constexpr int kRows = kMmaWarps / kColSplit * 16;   // query rows of a CTA
  static constexpr int kCols = DP / kColSplit;
  static constexpr size_t kQ = (size_t)kQParts * kRows * kStride * 2;
  static constexpr size_t kRawTile = (size_t)kChunkKeys * kRawRow;   // K or V
  static constexpr size_t kWide = kInt8 ? 2 * (size_t)kChunkKeys * kStride * 2 : 0;
  static constexpr size_t kTotal = kQ + kStages * 2 * kRawTile + kWide;
};

// Stage PAGES pages from `first` on into raw K/V tiles, token t of page p
// at row 16 p + t, columns 16 bytes at a time by cp.async; zeros for pages
// at or past n_live and for the head-dim padding past d.
template <int DP, typename TP, int PAGES>
__device__ __forceinline__ void stage_pages(unsigned char* raw_k, unsigned char* raw_v,
                                            const TP* __restrict__ k_pool,
                                            const TP* __restrict__ v_pool, const int* table,
                                            int first, int n_live, int kvh, int KV, int d) {
  using L = Mma<DP, TP>;
  constexpr int kEl = (int)sizeof(TP);
  constexpr int kSegs = DP * kEl / 16;      // 16-byte segments of a padded row
  for (int idx = threadIdx.x; idx < PAGES * kPage * kSegs; idx += kMmaThreads) {
    const int row = idx / kSegs, seg = idx - row * kSegs;
    const int j = first + row / kPage, t = row % kPage;
    const int col = seg * 16 / kEl;
    const bool ok = j < n_live && col < d;
    size_t src = 0;
    if (ok) src = (((size_t)table[j] * kPage + t) * KV + kvh) * (size_t)d + col;
    const size_t dst = (size_t)row * L::kRawRow + seg * 16;
    cp_async16(raw_k + dst, ok ? (const void*)(k_pool + src) : (const void*)k_pool, ok ? 16 : 0);
    cp_async16(raw_v + dst, ok ? (const void*)(v_pool + src) : (const void*)v_pool, ok ? 16 : 0);
  }
}

// Widen KEYS rows of int8 K/V codes (raw rows of DP bytes) to bf16 tiles
// (rows of DP + 8); exact, as every code is an integer of at most 8 bits.
template <int DP, int KEYS>
__device__ __forceinline__ void widen_keys(const unsigned char* rk, const unsigned char* rv,
                                           bf16* wk, bf16* wv) {
  constexpr int kStride = DP + 8;
  for (int idx = threadIdx.x; idx < KEYS * DP / 4; idx += kMmaThreads) {
    const int row = idx / (DP / 4), c4 = (idx - row * (DP / 4)) * 4;
    const char4 kc = *reinterpret_cast<const char4*>(rk + (size_t)row * DP + c4);
    const char4 vc = *reinterpret_cast<const char4*>(rv + (size_t)row * DP + c4);
    uint2 kw, vw;
    kw.x = pack_bf16((float)kc.x, (float)kc.y);
    kw.y = pack_bf16((float)kc.z, (float)kc.w);
    vw.x = pack_bf16((float)vc.x, (float)vc.y);
    vw.y = pack_bf16((float)vc.z, (float)vc.w);
    *reinterpret_cast<uint2*>(wk + row * kStride + c4) = kw;
    *reinterpret_cast<uint2*>(wv + row * kStride + c4) = vw;
  }
}

// The CTA's TILE q rows (row r: query r / G of head heads[r % G], from t0
// on), zeros past its rows and past d, in two steps so that the ring's
// first loads go out while q is in flight: q_fetch issues the 16-byte
// loads into registers, q_store scales them in float32 by qk_scale
// (__fmul_rn, as the plain version scales q) and stores PARTS bf16 tiles
// of TILE rows: one (the scale a power of two: exact) or hi, mid and lo,
// whose sum is the float32 value exactly (each part takes the next 8 of
// its 24 significant bits; barring underflow), so every part's product
// with a bf16 key is exact in float32.
template <int DP, int TILE>
struct QRows {
  static constexpr int kSegs = TILE * (DP / 8);      // 16-byte segments
  static constexpr int kPer = (kSegs + kMmaThreads - 1) / kMmaThreads;
  uint4 raw[kPer];
};

template <int DP, int TILE>
__device__ __forceinline__ void q_fetch(QRows<DP, TILE>& qr, const bf16* __restrict__ q,
                                        const int* heads, int b, int H, int C, int G, int t0,
                                        int rows, int d) {
  using R = QRows<DP, TILE>;
#pragma unroll
  for (int i = 0; i < R::kPer; ++i) {
    const int idx = threadIdx.x + i * kMmaThreads;
    const int r = idx / (DP / 8), col = (idx - r * (DP / 8)) * 8;
    qr.raw[i] = make_uint4(0, 0, 0, 0);
    if (idx < R::kSegs && r < rows && col < d) {
      const int rg = t0 + r;
      qr.raw[i] = *reinterpret_cast<const uint4*>(
          q + (((size_t)b * H + heads[rg % G]) * C + rg / G) * d + col);
    }
  }
}

template <int DP, int TILE, int PARTS>
__device__ __forceinline__ void q_store(bf16* Qs, const QRows<DP, TILE>& qr, float qk_scale) {
  using R = QRows<DP, TILE>;
  constexpr int kStride = DP + 8;
#pragma unroll
  for (int i = 0; i < R::kPer; ++i) {
    const int idx = threadIdx.x + i * kMmaThreads;
    if (idx >= R::kSegs) break;
    const int r = idx / (DP / 8), col = (idx - r * (DP / 8)) * 8;
    const uint32_t* in = reinterpret_cast<const uint32_t*>(&qr.raw[i]);
    uint4 part[PARTS];
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&in[w]));
      float x0 = __fmul_rn(f.x, qk_scale), x1 = __fmul_rn(f.y, qk_scale);
#pragma unroll
      for (int p = 0; p < PARTS; ++p) {
        const uint32_t h = pack_bf16(x0, x1);
        reinterpret_cast<uint32_t*>(&part[p])[w] = h;
        const float2 hf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&h));
        x0 = __fsub_rn(x0, hf.x);           // exact: the bits below the part
        x1 = __fsub_rn(x1, hf.y);
      }
    }
#pragma unroll
    for (int p = 0; p < PARTS; ++p)
      *reinterpret_cast<uint4*>(Qs + ((size_t)p * TILE + r) * kStride + col) = part[p];
  }
}

// The logits of 16 q rows (PARTS tiles of `tile` rows from Qs) against
// KT 16-key tiles of ks: sc[2 kt + n] += q . k over the head dim, k-step
// by k-step, the parts in order within each step.
template <int DP, int PARTS, int KT>
__device__ __forceinline__ void qk_logits(float (&sc)[2 * KT][4], const bf16* qs, int tile,
                                          const bf16* ks, int lane) {
  constexpr int kStride = DP + 8;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    uint32_t qa[PARTS][4];
#pragma unroll
    for (int p = 0; p < PARTS; ++p)
      ldsm_x4(qa[p], qs + ((size_t)p * tile + (lane & 15)) * kStride + kk * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
      uint32_t bq[4];
      ldsm_x4(bq, ks + (kt * 16 + (lane & 7) + ((lane >> 4) << 3)) * kStride + kk * 16 +
                      (((lane >> 3) & 1) << 3));
#pragma unroll
      for (int p = 0; p < PARTS; ++p) {
        mma_bf16(sc[2 * kt], qa[p], bq[0], bq[1]);
        mma_bf16(sc[2 * kt + 1], qa[p], bq[2], bq[3]);
      }
    }
  }
}

// The SOLE or exact weights of one page's two 8-key tiles in place, given
// the rows' running maxima, and their row sums.
__device__ __forceinline__ void page_weights(float (&sp)[2][4], float mn_a, float mn_b, int sole,
                                             int has_snap, float snap_inv, float int8_scale,
                                             float kmax, float& ls_a, float& ls_b) {
  if (sole && has_snap) {
    sole_weights<2, true>(sp, mn_a, mn_b, snap_inv, int8_scale, kmax, ls_a, ls_b);
  } else if (sole) {
    sole_weights<2, false>(sp, mn_a, mn_b, snap_inv, int8_scale, kmax, ls_a, ls_b);
  } else {
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) {         // masked: exp2(-inf) = 0
        const float w = exp2f(__fmul_rn(__fsub_rn(sp[nt][r], r < 2 ? mn_a : mn_b), kLog2e));
        sp[nt][r] = w;
        if (r < 2) ls_a = __fadd_rn(ls_a, w);
        else ls_b = __fadd_rn(ls_b, w);
      }
  }
}

// One page's weights as bf16 A fragments of P . V; exact mode (split) also
// the tail, P = bf16(P) + bf16(P - bf16(P)) (~2^-17 relative).
__device__ __forceinline__ void p_frags(const float (&sp)[2][4], uint32_t (&a)[4],
                                        uint32_t (&lo)[4], bool split) {
  a[0] = pack_bf16(sp[0][0], sp[0][1]);
  a[1] = pack_bf16(sp[0][2], sp[0][3]);
  a[2] = pack_bf16(sp[1][0], sp[1][1]);
  a[3] = pack_bf16(sp[1][2], sp[1][3]);
  if (!split) return;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float* p = sp[r >> 1];
    const int c = (r & 1) * 2;
    const float2 h = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&a[r]));
    lo[r] = pack_bf16(__fsub_rn(p[c], h.x), __fsub_rn(p[c + 1], h.y));
  }
}

// acc += P . V on columns c0 .. c0 + 8 CN of one page's 16 V rows (vp), V
// fragments by ldmatrix.trans; the head then, in exact mode, the tail.
template <int DP, int CN, bool SPLIT>
__device__ __forceinline__ void pv_cols(float (&acc)[CN][4], const uint32_t (&a)[4],
                                        const uint32_t (&lo)[4], const bf16* vp, int lane,
                                        int c0) {
  constexpr int kStride = DP + 8;
#pragma unroll
  for (int dp = 0; dp < CN / 2; ++dp) {
    uint32_t b[4];
    ldsm_x4_trans(b, vp + ((lane & 7) + (((lane >> 3) & 1) << 3)) * kStride + c0 + dp * 16 +
                         ((lane >> 4) << 3));
    mma_bf16(acc[2 * dp], a, b[0], b[1]);
    mma_bf16(acc[2 * dp + 1], a, b[2], b[3]);
    if (SPLIT) {
      mma_bf16(acc[2 * dp], lo, b[0], b[1]);
      mma_bf16(acc[2 * dp + 1], lo, b[2], b[3]);
    }
  }
}

template <int DP, typename TP>
__global__ void __launch_bounds__(kMmaThreads, 1)
paged_e2softmax_mma_kernel(const bf16* __restrict__ q, const TP* __restrict__ k_pool,
                 const TP* __restrict__ v_pool, const int* __restrict__ tables,
                 const int* __restrict__ meta, const int* __restrict__ kv_head_map,
                 float* __restrict__ out, int H, int C, int d, int KV, int NB, int causal,
                 int sole, int exp_bits, int has_snap, float int8_scale, float snap_inv,
                 float qk_scale, float kv_scale) {
  using L = Mma<DP, TP>;
  constexpr int kStride = L::kStride;
  constexpr int kCP = L::kChunkPages;
  constexpr int NT = 2 * kCP;               // 8-key tiles of a chunk
  constexpr int CN = L::kCols / 8;          // 8-column tiles of a warp's output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int heads[kMaxHeads];
  __shared__ int n_heads;
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  unsigned char* ring = smem_raw + L::kQ;
  bf16* wide = reinterpret_cast<bf16*>(ring + kStages * 2 * L::kRawTile);

  const int b = blockIdx.x / KV, kvh = blockIdx.x % KV;
  const int G = group_heads(kv_head_map, H, kvh, heads, &n_heads);
  const int t0 = (gridDim.y - 1 - blockIdx.y) * L::kRows;   // heaviest causal tiles first
  if (t0 >= G * C) return;                  // block-uniform: no rows here
  const int rows = min(L::kRows, G * C - t0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int grp = warp / L::kColSplit;      // the warp's 16-row group
  const int c_base = (warp % L::kColSplit) * L::kCols;        // and its output columns
  const int q_start = meta[2 * b], kv_len = meta[2 * b + 1];
  const float kmax = (float)((1 << exp_bits) - 1);
  const float submax = (float)((1 << (exp_bits + 2)) - 1);
  const int last_pos = q_start + (t0 + rows - 1) / G;
  int n_live = min(NB, (kv_len + kPage - 1) / kPage);
  if (causal) n_live = min(n_live, last_pos / kPage + 1);
  const int n_chunks = (n_live + kCP - 1) / kCP;
  int* table = reinterpret_cast<int*>(smem_raw + L::kTotal);     // the live pages
  for (int j = threadIdx.x; j < n_live; j += kMmaThreads) table[j] = tables[(size_t)b * NB + j];
  __syncthreads();

  // the CTA's q rows, gathered per head, in flight while the ring's first
  // chunks are requested; scaled and stored after (made visible by the
  // loop's first barrier)
  QRows<DP, L::kRows> qr;
  q_fetch<DP, L::kRows>(qr, q, heads, b, H, C, G, t0, rows, d);
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_chunks)
      stage_pages<DP, TP, kCP>(ring + (size_t)s * 2 * L::kRawTile,
                               ring + ((size_t)s * 2 + 1) * L::kRawTile, k_pool, v_pool, table,
                               s * kCP, n_live, kvh, KV, d);
    cp_async_commit();
  }
  q_store<DP, L::kRows, L::kQParts>(Qs, qr, qk_scale);

  // the warp's rows a = 16 grp + g and b = a + 8 (tile-local), their positions
  const int ra = grp * 16 + g, rb = ra + 8;
  const int pos_a = q_start + min(t0 + ra, G * C - 1) / G;
  const int pos_b = q_start + min(t0 + rb, G * C - 1) / G;
  float acc[CN][4];
#pragma unroll
  for (int dn = 0; dn < CN; ++dn)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[dn][r] = 0.0f;
  float m_a = kNeg, m_b = kNeg, s_a = 0.0f, s_b = 0.0f;

  for (int ch = 0; ch < n_chunks; ++ch) {
    const int pre = ch + kStages - 1;       // the chunk loaded now, stages - 1 ahead
    if (pre < n_chunks) {
      const int slot = pre % kStages;
      stage_pages<DP, TP, kCP>(ring + (size_t)slot * 2 * L::kRawTile,
                               ring + ((size_t)slot * 2 + 1) * L::kRawTile, k_pool, v_pool,
                               table, pre * kCP, n_live, kvh, KV, d);
    }
    cp_async_commit();
    cp_async_wait<kStages - 1>();           // chunk ch landed
    __syncthreads();
    const unsigned char* rk = ring + (size_t)(ch % kStages) * 2 * L::kRawTile;
    const unsigned char* rv = rk + L::kRawTile;
    const bf16* ks;
    const bf16* vs;
    if constexpr (L::kInt8) {
      widen_keys<DP, L::kChunkKeys>(rk, rv, wide, wide + L::kChunkKeys * kStride);
      __syncthreads();
      ks = wide;
      vs = wide + L::kChunkKeys * kStride;
    } else {
      ks = reinterpret_cast<const bf16*>(rk);
      vs = reinterpret_cast<const bf16*>(rv);
    }

    // all the chunk's pages' logits of the warp's 16 rows
    float sc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) sc[nt][r] = 0.0f;
    qk_logits<DP, L::kQParts, kCP>(sc, Qs + grp * 16 * kStride, L::kRows, ks, lane);
    // mask (keys past kv_len, the causal diagonal, dead pages) to -inf; int8
    // pools: the logits of the codes times kv_scale (a power of two: exact)
    const int c0 = ch * L::kChunkKeys;
    if constexpr (L::kInt8) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int r = 0; r < 4; ++r) sc[nt][r] = __fmul_rn(sc[nt][r], kv_scale);
    }
    // only a chunk that reaches past kv_len or the warp's first row masks
    if (c0 + L::kChunkKeys > kv_len || (causal && c0 + L::kChunkKeys - 1 > min(pos_a, pos_b))) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int col = c0 + nt * 8 + 2 * t4 + (r & 1);
          const int pos = r < 2 ? pos_a : pos_b;
          if (col >= kv_len || (causal && pos < col)) sc[nt][r] = -CUDART_INF_F;
        }
    }
    // the pages' maxima are independent; the running max is their prefix max
    float pm_a[kCP], pm_b[kCP];
#pragma unroll
    for (int p = 0; p < kCP; ++p) {
      pm_a[p] = quad_max(fmaxf(fmaxf(sc[2 * p][0], sc[2 * p][1]),
                               fmaxf(sc[2 * p + 1][0], sc[2 * p + 1][1])));
      pm_b[p] = quad_max(fmaxf(fmaxf(sc[2 * p][2], sc[2 * p][3]),
                               fmaxf(sc[2 * p + 1][2], sc[2 * p + 1][3])));
    }
    // the combine, page by page in order (dead pages are the identity)
#pragma unroll
    for (int p = 0; p < kCP; ++p) {
      const float mn_a = fmaxf(m_a, pm_a[p]), mn_b = fmaxf(m_b, pm_b[p]);
      float sp[2][4];                       // the page's two 8-key tiles
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        sp[0][r] = sc[2 * p][r];
        sp[1][r] = sc[2 * p + 1][r];
      }
      float ls_a = 0.0f, ls_b = 0.0f;
      page_weights(sp, mn_a, mn_b, sole, has_snap, snap_inv, int8_scale, kmax, ls_a, ls_b);
      const float corr_a = block_corr(m_a, mn_a, sole, submax);
      const float corr_b = block_corr(m_b, mn_b, sole, submax);
      s_a = __fadd_rn(__fmul_rn(s_a, corr_a), quad_sum(ls_a));
      s_b = __fadd_rn(__fmul_rn(s_b, corr_b), quad_sum(ls_b));
      m_a = mn_a;
      m_b = mn_b;
#pragma unroll
      for (int dn = 0; dn < CN; ++dn) {
        acc[dn][0] = __fmul_rn(acc[dn][0], corr_a);
        acc[dn][1] = __fmul_rn(acc[dn][1], corr_a);
        acc[dn][2] = __fmul_rn(acc[dn][2], corr_b);
        acc[dn][3] = __fmul_rn(acc[dn][3], corr_b);
      }
      uint32_t a[4], lo[4];
      p_frags(sp, a, lo, !sole);
      const bf16* vp = vs + p * kPage * kStride;
      if (sole) pv_cols<DP, CN, false>(acc, a, lo, vp, lane, c_base);
      else pv_cols<DP, CN, true>(acc, a, lo, vp, lane, c_base);
    }
    __syncthreads();                        // this slot is refilled later
  }
  cp_async_wait<0>();                       // nothing left in flight at exit

  float sc_a = final_scale(s_a, sole), sc_b = final_scale(s_b, sole);
  if constexpr (L::kInt8) {                 // P.V ran on the raw V codes
    sc_a = __fmul_rn(sc_a, kv_scale);
    sc_b = __fmul_rn(sc_b, kv_scale);
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = half ? rb : ra;
    if (r >= rows) continue;
    const int rg = t0 + r;
    float* orow = out + (((size_t)b * H + heads[rg % G]) * C + rg / G) * d;
    const float s = half ? sc_b : sc_a;
#pragma unroll
    for (int dn = 0; dn < CN; ++dn) {
      const int col = c_base + dn * 8 + 2 * t4;
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (col + e < d) orow[col + e] = __fmul_rn(acc[dn][2 * half + e], s);
    }
  }
}

template <int DP, typename TP>
int launch_mma(const void* q, const void* k_pool, const void* v_pool, const void* tables,
               const void* meta, const void* kv_head_map, void* out, int B, int H, int C,
               int d, int KV, int NB, int causal, int sole, int exp_bits, int has_snap,
               float int8_scale, float snap_inv, float qk_scale, float kv_scale,
               cudaStream_t stream) {
  using L = Mma<DP, TP>;
  // the ring, Q and the CTA's page table (NB ints)
  const size_t smem = L::kTotal + ((size_t)NB * 4 + 15) / 16 * 16;
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  auto kernel = paged_e2softmax_mma_kernel<DP, TP>;
  static bool ready = false;                // per instantiation
  if (!ready) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kMaxSmem);
    if (e != cudaSuccess) return (int)e;
    ready = true;
  }
  dim3 grid(B * KV, (H * C + L::kRows - 1) / L::kRows);
  kernel<<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const TP*>(k_pool),
      static_cast<const TP*>(v_pool), static_cast<const int*>(tables),
      static_cast<const int*>(meta), static_cast<const int*>(kv_head_map),
      static_cast<float*>(out), H, C, d, KV, NB, causal, sole, exp_bits, has_snap, int8_scale,
      snap_inv, qk_scale, kv_scale);
  return (int)cudaGetLastError();
}

// -- decode: one 16-row tile, a sequence's pages split over warps and CTAs -----
//
// At decode a CTA's rows (its group's heads, one query each) fit one 16-row
// mma tile, so one warp would walk every page alone, and B * KV CTAs may
// leave most of the card idle (8 at recurrentgemma's decode). Here the S
// CTAs of a thread-block cluster share one (sequence, KV head, tile), and
// a round covers S * kCtaPages pages: CTA c takes pages c * kCtaPages ..,
// warp w of it kWarpPages of those, for all 16 rows. Per round: each warp's
// pages' logits and maxima (to its CTA's shared memory); a cluster barrier;
// every CTA gathers the round's maxima through distributed shared memory
// (a lone CTA, S = 1, reads its own, behind a CTA barrier);
// each warp's weights from the exact prefix maxima, row sums and P.V
// partials on the tensor cores (to shared memory); a cluster barrier; then
// the combine, page by page in order, s = s * corr_j + sum_j and acc = acc
// * corr_j + pv_j (the plain version's own order), CTA c on its DP / S
// columns, reading each page's partial from the CTA that made it. Every
// page's partial and the fold over them are the same whatever S and the
// round, so the bits do not depend on the split: S is chosen per launch to
// fill the card (verify rows keep the decode step's bits).

template <int DP, typename TP>
struct Dec {
  using M = Mma<DP, TP>;
  static constexpr int kWarpPages = DP == 64 ? 2 : 1;
  static constexpr int kCtaPages = kMmaWarps * kWarpPages;
  static constexpr int kMaxCluster = DP / 32;       // a combine lane owns >= 4 columns
  static constexpr int kMaxRound = kCtaPages * kMaxCluster;
  static constexpr int kStagesD = DP == 256 ? 2 : 3;
  static constexpr int kPvStride = DP + 4;   // floats per pv row: 16-byte rows, banks spread
  static constexpr size_t kQ = (size_t)M::kQParts * 16 * M::kStride * 2;
  static constexpr size_t kRawTile = (size_t)kCtaPages * kPage * M::kRawRow;
  static constexpr size_t kRing = (size_t)kStagesD * 2 * kRawTile;
  static constexpr size_t kWide = M::kInt8 ? 2 * (size_t)kCtaPages * kPage * M::kStride * 2 : 0;
  static constexpr size_t kPv = (size_t)kCtaPages * 16 * kPvStride * 4;
  static constexpr size_t kOwn = (size_t)2 * kCtaPages * 16 * 4;    // own maxima, sums
  static constexpr size_t kRound = (size_t)2 * kMaxRound * 16 * 4;  // the round's, gathered
  static constexpr size_t kTotal = kQ + kRing + kWide + kPv + kOwn + kRound;
};

template <int DP, typename TP>
__global__ void __launch_bounds__(kMmaThreads, 1)
paged_e2softmax_decode_kernel(const bf16* __restrict__ q, const TP* __restrict__ k_pool,
                              const TP* __restrict__ v_pool, const int* __restrict__ tables,
                              const int* __restrict__ meta, const int* __restrict__ kv_head_map,
                              float* __restrict__ out, int H, int C, int d, int KV, int NB,
                              int causal, int sole, int exp_bits, int has_snap, float int8_scale,
                              float snap_inv, float qk_scale, float kv_scale) {
  using M = Mma<DP, TP>;
  using L = Dec<DP, TP>;
  constexpr int kStride = M::kStride;
  constexpr int kPvStride = L::kPvStride;
  constexpr int kCB = DP < 64 ? DP : 64;    // P.V columns a pass (32 registers)
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int S = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int heads[kMaxHeads];
  __shared__ int n_heads;
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  unsigned char* ring = smem_raw + L::kQ;
  bf16* wide = reinterpret_cast<bf16*>(ring + L::kRing);
  float* pvbuf = reinterpret_cast<float*>(ring + L::kRing + L::kWide);   // [page][row][col]
  float* own_max = pvbuf + (size_t)L::kCtaPages * 16 * kPvStride;       // [page][row]
  float* own_sum = own_max + L::kCtaPages * 16;
  float* rmax = own_sum + L::kCtaPages * 16;                             // [round page][row]
  float* rsum = rmax + L::kMaxRound * 16;
  // the round's maxima and sums as this CTA reads them: gathered from the
  // cluster, or a lone CTA's own
  const float* rm = S > 1 ? rmax : own_max;
  const float* rs = S > 1 ? rsum : own_sum;
  auto sync = [&]() {                       // cluster-uniform choice
    if (S > 1) cluster.sync();
    else __syncthreads();
  };

  const int seq = blockIdx.x / S;           // the cluster's (sequence, KV head)
  const int b = seq / KV, kvh = seq % KV;
  const int G = group_heads(kv_head_map, H, kvh, heads, &n_heads);
  const int t0 = blockIdx.y * 16;
  if (t0 >= G * C) return;                  // cluster-uniform: no rows here
  const int rows = min(16, G * C - t0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int q_start = meta[2 * b], kv_len = meta[2 * b + 1];
  const float kmax = (float)((1 << exp_bits) - 1);
  const float submax = (float)((1 << (exp_bits + 2)) - 1);
  const int last_pos = q_start + (t0 + rows - 1) / G;
  int n_live = min(NB, (kv_len + kPage - 1) / kPage);
  if (causal) n_live = min(n_live, last_pos / kPage + 1);
  const int RP = S * L::kCtaPages;          // pages of a round
  const int n_rounds = (n_live + RP - 1) / RP;
  int* table = reinterpret_cast<int*>(smem_raw + L::kTotal);
  for (int j = threadIdx.x; j < n_live; j += kMmaThreads) table[j] = tables[(size_t)b * NB + j];
  __syncthreads();

  QRows<DP, 16> qr;
  q_fetch<DP, 16>(qr, q, heads, b, H, C, G, t0, rows, d);
  for (int st = 0; st < L::kStagesD - 1; ++st) {
    if (st < n_rounds)
      stage_pages<DP, TP, L::kCtaPages>(ring + (size_t)st * 2 * L::kRawTile,
                                        ring + ((size_t)st * 2 + 1) * L::kRawTile, k_pool,
                                        v_pool, table, st * RP + rank * L::kCtaPages, n_live,
                                        kvh, KV, d);
    cp_async_commit();
  }
  q_store<DP, 16, M::kQParts>(Qs, qr, qk_scale);

  // mma rows g and g + 8 (every warp holds all 16); the combine's row and
  // columns: 8 threads a row, each n4 groups of 4 of the CTA's DP / S
  // columns, 32 apart (a row's 8 threads read 128 contiguous bytes)
  const int pos_a = q_start + min(t0 + g, G * C - 1) / G;
  const int pos_b = q_start + min(t0 + g + 8, G * C - 1) / G;
  const int rc = threadIdx.x >> 3;
  const int n4 = DP / S / 32;
  const int col0 = rank * (DP / S) + (threadIdx.x & 7) * 4;
  const int wp0 = warp * L::kWarpPages;     // the warp's first page in its CTA's share
  float m_a = kNeg, m_b = kNeg;             // running maxima of the mma rows (past rounds)
  float m_c = kNeg, s_c = 0.0f;             // and of the combine row
  float acc[DP / 8];
#pragma unroll
  for (int e = 0; e < DP / 8; ++e) acc[e] = 0.0f;

  for (int rd = 0; rd < n_rounds; ++rd) {
    const int pre = rd + L::kStagesD - 1;
    if (pre < n_rounds) {
      const int slot = pre % L::kStagesD;
      stage_pages<DP, TP, L::kCtaPages>(ring + (size_t)slot * 2 * L::kRawTile,
                                        ring + ((size_t)slot * 2 + 1) * L::kRawTile, k_pool,
                                        v_pool, table, pre * RP + rank * L::kCtaPages, n_live,
                                        kvh, KV, d);
    }
    cp_async_commit();
    cp_async_wait<L::kStagesD - 1>();       // round rd's pages (and q) landed
    __syncthreads();
    const unsigned char* rk = ring + (size_t)(rd % L::kStagesD) * 2 * L::kRawTile;
    const unsigned char* rv = rk + L::kRawTile;
    const bf16* ks;
    const bf16* vs;
    if constexpr (M::kInt8) {
      widen_keys<DP, L::kCtaPages * kPage>(rk, rv, wide, wide + L::kCtaPages * kPage * kStride);
      __syncthreads();
      ks = wide;
      vs = wide + L::kCtaPages * kPage * kStride;
    } else {
      ks = reinterpret_cast<const bf16*>(rk);
      vs = reinterpret_cast<const bf16*>(rv);
    }
    const int base = rd * RP;               // the round's first page
    const int n_round = min(RP, n_live - base);
    const int mine = base + rank * L::kCtaPages + wp0;   // the warp's first page

    // the warp's pages: logits of the 16 rows, masked, and their maxima
    float sc[L::kWarpPages][2][4];
#pragma unroll
    for (int pp = 0; pp < L::kWarpPages; ++pp) {
      const int j = mine + pp;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int r = 0; r < 4; ++r) sc[pp][nt][r] = 0.0f;
      if (j >= n_live) continue;            // warp-uniform: a dead page
      qk_logits<DP, M::kQParts, 1>(sc[pp], Qs, 16, ks + (wp0 + pp) * kPage * kStride, lane);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int col = j * kPage + nt * 8 + 2 * t4 + (r & 1);
          const int pos = r < 2 ? pos_a : pos_b;
          float x = sc[pp][nt][r];
          if constexpr (M::kInt8) x = __fmul_rn(x, kv_scale);   // a power of two: exact
          sc[pp][nt][r] = (col >= kv_len || (causal && pos < col)) ? -CUDART_INF_F : x;
        }
      const float pm_a = quad_max(fmaxf(fmaxf(sc[pp][0][0], sc[pp][0][1]),
                                        fmaxf(sc[pp][1][0], sc[pp][1][1])));
      const float pm_b = quad_max(fmaxf(fmaxf(sc[pp][0][2], sc[pp][0][3]),
                                        fmaxf(sc[pp][1][2], sc[pp][1][3])));
      if (t4 == 0) {
        own_max[(wp0 + pp) * 16 + g] = pm_a;
        own_max[(wp0 + pp) * 16 + g + 8] = pm_b;
      }
    }
    sync();                                 // every CTA's maxima of the round in place
    if (S > 1) {                            // a lone CTA's maxima are the round's
      for (int i = threadIdx.x; i < n_round * 16; i += kMmaThreads) {
        const int p = i >> 4;
        const float* src = cluster.map_shared_rank(own_max, p / L::kCtaPages);
        rmax[i] = src[(p % L::kCtaPages) * 16 + (i & 15)];
      }
      __syncthreads();
    }

    // weights from the prefix maxima, row sums and P.V partials of its pages
    float mp_a = m_a, mp_b = m_b;
#pragma unroll 4
    for (int p = 0; p < min(mine - base, n_round); ++p) {
      mp_a = fmaxf(mp_a, rm[p * 16 + g]);
      mp_b = fmaxf(mp_b, rm[p * 16 + g + 8]);
    }
#pragma unroll
    for (int pp = 0; pp < L::kWarpPages; ++pp) {
      const int p = mine + pp - base;
      if (p >= n_round) break;              // warp-uniform
      mp_a = fmaxf(mp_a, rm[p * 16 + g]);
      mp_b = fmaxf(mp_b, rm[p * 16 + g + 8]);
      float ls_a = 0.0f, ls_b = 0.0f;
      page_weights(sc[pp], mp_a, mp_b, sole, has_snap, snap_inv, int8_scale, kmax, ls_a, ls_b);
      ls_a = quad_sum(ls_a);
      ls_b = quad_sum(ls_b);
      if (t4 == 0) {
        own_sum[(wp0 + pp) * 16 + g] = ls_a;
        own_sum[(wp0 + pp) * 16 + g + 8] = ls_b;
      }
      uint32_t a[4], lo[4];
      p_frags(sc[pp], a, lo, !sole);
      const bf16* vp = vs + (wp0 + pp) * kPage * kStride;
      float* pvp = pvbuf + (size_t)(wp0 + pp) * 16 * kPvStride;
#pragma unroll
      for (int cb = 0; cb < DP; cb += kCB) {
        float pv[kCB / 8][4];
#pragma unroll
        for (int dn = 0; dn < kCB / 8; ++dn)
#pragma unroll
          for (int r = 0; r < 4; ++r) pv[dn][r] = 0.0f;
        if (sole) pv_cols<DP, kCB / 8, false>(pv, a, lo, vp, lane, cb);
        else pv_cols<DP, kCB / 8, true>(pv, a, lo, vp, lane, cb);
#pragma unroll
        for (int dn = 0; dn < kCB / 8; ++dn) {
          const int col = cb + dn * 8 + 2 * t4;
          *reinterpret_cast<float2*>(pvp + g * kPvStride + col) = make_float2(pv[dn][0], pv[dn][1]);
          *reinterpret_cast<float2*>(pvp + (g + 8) * kPvStride + col) =
              make_float2(pv[dn][2], pv[dn][3]);
        }
      }
    }
    sync();                                 // every CTA's sums and partials in place
    if (S > 1) {
      for (int i = threadIdx.x; i < n_round * 16; i += kMmaThreads) {
        const int p = i >> 4;
        const float* src = cluster.map_shared_rank(own_sum, p / L::kCtaPages);
        rsum[i] = src[(p % L::kCtaPages) * 16 + (i & 15)];
      }
      __syncthreads();
    }

    // the combine, page by page in order, on this thread's row and columns
    // (unrolled so that several pages' loads are in flight at once); a
    // lone CTA reads its own partials as plain shared memory
    auto fold = [&](auto page_pv) {
#pragma unroll 4
      for (int p = 0; p < n_round; ++p) {
        const float mn = fmaxf(m_c, rm[p * 16 + rc]);
        const float corr = block_corr(m_c, mn, sole, submax);
        m_c = mn;
        s_c = __fadd_rn(__fmul_rn(s_c, corr), rs[p * 16 + rc]);
        const float4* pvr = reinterpret_cast<const float4*>(page_pv(p) + rc * kPvStride + col0);
#pragma unroll
        for (int e4 = 0; e4 < DP / 32; ++e4) {
          if (e4 >= n4) break;
          const float4 v = pvr[8 * e4];
          acc[4 * e4] = __fadd_rn(__fmul_rn(acc[4 * e4], corr), v.x);
          acc[4 * e4 + 1] = __fadd_rn(__fmul_rn(acc[4 * e4 + 1], corr), v.y);
          acc[4 * e4 + 2] = __fadd_rn(__fmul_rn(acc[4 * e4 + 2], corr), v.z);
          acc[4 * e4 + 3] = __fadd_rn(__fmul_rn(acc[4 * e4 + 3], corr), v.w);
        }
      }
    };
    if (S > 1)
      fold([&](int p) {
        return cluster.map_shared_rank(pvbuf, p / L::kCtaPages) +
               (size_t)(p % L::kCtaPages) * 16 * kPvStride;
      });
    else
      fold([&](int p) { return pvbuf + (size_t)p * 16 * kPvStride; });
#pragma unroll 4
    for (int p = 0; p < n_round; ++p) {
      m_a = fmaxf(m_a, rm[p * 16 + g]);
      m_b = fmaxf(m_b, rm[p * 16 + g + 8]);
    }
    // the next round writes its maxima only after every CTA passed this
    // round's second barrier, and its partials only after the next first
    // barrier, which every CTA reaches after this combine
  }
  cp_async_wait<0>();                       // nothing left in flight at exit
  if (S > 1) cluster.sync();                // no CTA leaves while its partials are read

  if (rc < rows) {
    float scale = final_scale(s_c, sole);
    if constexpr (M::kInt8) scale = __fmul_rn(scale, kv_scale);   // P.V ran on the raw codes
    const int rg = t0 + rc;
    float* orow = out + (((size_t)b * H + heads[rg % G]) * C + rg / G) * d;
#pragma unroll
    for (int e = 0; e < DP / 8; ++e) {
      const int col = col0 + 32 * (e / 4) + e % 4;
      if (e / 4 < n4 && col < d) orow[col] = __fmul_rn(acc[e], scale);
    }
  }
}

// The CTAs sharing one decode tile (a power of two up to Dec::kMaxCluster):
// the most that keep the launch within one wave of the card's SMs, and no
// more than the table's pages can keep busy.
template <int DP, typename TP>
int decode_cluster(int tiles, int NB) {
  static int sms = 0;
  if (!sms) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  int s = 1;
  while (2 * s <= Dec<DP, TP>::kMaxCluster && tiles * 2 * s <= sms &&
         (s * 2 - 1) * Dec<DP, TP>::kCtaPages < NB)
    s *= 2;
  return s;
}

template <int DP, typename TP>
int launch_decode(const void* q, const void* k_pool, const void* v_pool, const void* tables,
                  const void* meta, const void* kv_head_map, void* out, int B, int H, int C,
                  int d, int KV, int NB, int causal, int sole, int exp_bits, int has_snap,
                  float int8_scale, float snap_inv, float qk_scale, float kv_scale,
                  cudaStream_t stream) {
  const size_t smem = Dec<DP, TP>::kTotal + ((size_t)NB * 4 + 15) / 16 * 16;
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  auto kernel = paged_e2softmax_decode_kernel<DP, TP>;
  static bool ready = false;                // per instantiation
  if (!ready) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kMaxSmem);
    if (e != cudaSuccess) return (int)e;
    ready = true;
  }
  const int row_tiles = (H * C + 15) / 16;
  const int S = decode_cluster<DP, TP>(B * KV * row_tiles, NB);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * KV * S, row_tiles);
  cfg.blockDim = dim3(kMmaThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const bf16*>(q), static_cast<const TP*>(k_pool),
      static_cast<const TP*>(v_pool), static_cast<const int*>(tables),
      static_cast<const int*>(meta), static_cast<const int*>(kv_head_map),
      static_cast<float*>(out), H, C, d, KV, NB, causal, sole, exp_bits, has_snap, int8_scale,
      snap_inv, qk_scale, kv_scale);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The tensor-core instantiation for these arguments, by its padded head
// dim, or 0 for the CUDA cores: bf16 q, bf16 or int8 pools of 16-token
// pages (an int8 pool's kv_scale a power of two, applied after the
// products), d a multiple of 16, 16-byte aligned q and pools (vec); 64 for
// d <= 64 with d^-1/2 a power of two (folded into the bf16 q), 128 for 64
// < d <= 128 (q * d^-1/2 in three bf16 parts), 256 for d = 256 (d^-1/2 =
// 1/16). Everything else runs on the CUDA cores.
int mma_variant(int q_type, int pool_type, int d, int bs, float qk_scale, float kv_scale,
                int vec) {
  int e;
  const bool pow2 = frexpf(qk_scale, &e) == 0.5f;
  if (q_type != 1 || pool_type == 0 || bs != kPage || d % 16 != 0 || !vec) return 0;
  if (pool_type == 2 && frexpf(kv_scale, &e) != 0.5f) return 0;
  if (d <= 64) return pow2 ? 64 : 0;
  if (d <= 128) return 128;
  return d == 256 && pow2 ? 256 : 0;
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Element types: 0 = float32, 1 = bfloat16, 2 = int8 (pools only).
// q: (B, H, C, d) of q_type; k_pool, v_pool: (N, bs, KV, d) of pool_type,
// which is q_type or int8; all contiguous (vec = 1 when q and the pools are
// 16-byte aligned). tables: (B, NB)
// int32; meta: (B, 2) int32 rows (q_start, kv_len); kv_head_map: (H,) int32,
// any map of query heads to KV heads; out: (B, H, C, d) float32. Int8 pools
// are dequantized by kv_scale, a power of two: K, and V unless quant_pv,
// where kv_scale multiplies the final row scale instead; float pools ignore
// kv_scale and quant_pv. snap_inv = float32(1 / int8_scale). Requires
// d <= 256 and H <= 512. Launches on `stream` and returns the launch's
// cudaError_t (0 on success; cudaErrorInvalidValue for arguments it does not
// take). bf16 q with bf16 or int8 pools of 16-token pages runs on the
// tensor cores where mma_variant allows (head dims 64, 128 and 256),
// everything else on the CUDA cores.
int paged_e2softmax(const void* q, const void* k_pool, const void* v_pool,
                    const void* tables, const void* meta, const void* kv_head_map,
                    void* out, int B, int H, int C, int d, int bs, int KV, int NB,
                    int causal, int sole, int exp_bits, int has_snap, int q_type,
                    int pool_type, int quant_pv, int vec, float int8_scale,
                    float snap_inv, float qk_scale, float kv_scale, void* stream) {
  if (H > kMaxHeads || d > 32 * kMaxDimChunks) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int dp = mma_variant(q_type, pool_type, d, bs, qk_scale, kv_scale, vec);
  if (dp) {
#define REPRO_MMA_LAUNCH(DP, TP)                                                           \
  return C == 1                                                                             \
             ? launch_decode<DP, TP>(q, k_pool, v_pool, tables, meta, kv_head_map, out, B, H, \
                                     C, d, KV, NB, causal, sole, exp_bits, has_snap,          \
                                     int8_scale, snap_inv, qk_scale, kv_scale, s)            \
             : launch_mma<DP, TP>(q, k_pool, v_pool, tables, meta, kv_head_map, out, B, H, C, \
                                  d, KV, NB, causal, sole, exp_bits, has_snap, int8_scale,    \
                                  snap_inv, qk_scale, kv_scale, s)
    if (pool_type == 1) {
      if (dp == 64) REPRO_MMA_LAUNCH(64, __nv_bfloat16);
      if (dp == 128) REPRO_MMA_LAUNCH(128, __nv_bfloat16);
      REPRO_MMA_LAUNCH(256, __nv_bfloat16);
    }
    if (dp == 64) REPRO_MMA_LAUNCH(64, int8_t);
    if (dp == 128) REPRO_MMA_LAUNCH(128, int8_t);
    REPRO_MMA_LAUNCH(256, int8_t);
#undef REPRO_MMA_LAUNCH
  }
#define REPRO_PAGED_LAUNCH(TQ, TP)                                                     \
  return launch<TQ, TP>(q, k_pool, v_pool, tables, meta, kv_head_map, out, B, H, C, d, \
                        bs, KV, NB, causal, sole, exp_bits, has_snap, int8_scale,       \
                        snap_inv, qk_scale, quant_pv, kv_scale, s)
  if (q_type == 0 && pool_type == 0) REPRO_PAGED_LAUNCH(float, float);
  if (q_type == 1 && pool_type == 1) REPRO_PAGED_LAUNCH(__nv_bfloat16, __nv_bfloat16);
  if (q_type == 0 && pool_type == 2) REPRO_PAGED_LAUNCH(float, int8_t);
  if (q_type == 1 && pool_type == 2) REPRO_PAGED_LAUNCH(__nv_bfloat16, int8_t);
#undef REPRO_PAGED_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
