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
// and orders its rows r = c * G + i (query c, i-th head of the group). Three
// kernels, chosen by type and by C:
//
// bf16 q (bf16 or int8 pools of 16-token pages; d^-1/2 and kv_scale powers
// of two, so d is 16 or 64): tensor cores, in two kernels. Both walk chunks
// of 8 pages (128 keys) through a 3-stage ring of K/V tiles filled by
// cp.async two chunks ahead, after reading their page table and head list
// into shared memory. Prefill chunks (C > 1): a CTA of 4 warps owns 64
// rows, 16 per warp; each warp computes all 8 pages' logits at once
// (mma.sync m16n8k16 bf16 -> float32, K fragments by ldmatrix) and their
// maxima, then walks the pages in order: prefix max, weights, correction,
// s, and acc * corr plus the page's P.V on the tensor cores (V by
// ldmatrix.trans). Decode (C = 1): the group's rows fit one 16-row tile,
// so the 4 warps split each chunk's pages instead, two apiece: logits and
// maxima, then (after one barrier) weights, row sums and P.V partials from
// the prefix maxima, and the in-order combine s = s * corr + sum, acc =
// acc * corr + pv over column slices (see the decode kernel). The products
// are exact: bf16 x bf16 is exact in float32; d^-1/2 = 2^-k is folded into
// the bf16 q; SOLE weights 2^-k are exact in bf16 and exact mode splits P
// into hi + lo bf16 halves (~2^-17 relative); int8 codes are exact in
// bf16, and kv_scale, a power of two, multiplies the float32 logits after
// Q.K^T and the final row scale instead of V (both quant_pv settings),
// which is exact barring underflow (below 2^-126, far from the path's
// values). Only the float32 summation order differs from the plain version.
// float32 q (and shapes the tensor-core kernel does not take): the CUDA
// cores, one page at a time through shared memory as float32, a lane per
// key for the logits and per head-dim column for the accumulator, the same
// CTA-per-KV-group tiling. It is the float32 path's kernel, not a fallback.
// Both: powers of two from exponent bits or ldexpf, rounding half to even
// like jnp.round, __fmul_rn/__fsub_rn keep the codes' inputs out of FMA
// contraction.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

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
constexpr int kMmaRows = kMmaWarps * 16;    // query rows of a CTA
constexpr int kPage = 16;                   // tokens per page: one 16-key mma tile
constexpr int kChunkPages = 8;              // pages per chunk: 128 keys
constexpr int kChunkKeys = kChunkPages * kPage;
// dynamic shared memory a CTA may ask for, beside the static head list
constexpr size_t kMaxSmem = 220 * 1024;

constexpr int kStages = 3;                  // chunks in the ring: two loads ahead

// Shared memory of the tensor-core kernel, in bytes: Q (kMmaRows rows), then
// kStages raw K/V chunk tiles as the pool stores them (bf16 rows of DP + 8,
// or int8 rows of DP bytes), then for int8 pools one bf16 K/V tile the raw
// codes are widened into; the CTA's page table follows (sized at launch).
template <int DP, typename TP>
struct MmaSmem {
  static constexpr int kStride = DP + 8;                      // bf16 per tile row
  static constexpr bool kInt8 = std::is_same<TP, int8_t>::value;
  static constexpr int kRawRow = kInt8 ? DP : kStride * 2;    // bytes per raw row
  static constexpr size_t kQ = (size_t)kMmaRows * kStride * 2;
  static constexpr size_t kRawTile = (size_t)kChunkKeys * kRawRow;   // K or V
  static constexpr size_t kWide = kInt8 ? 2 * (size_t)kChunkKeys * kStride * 2 : 0;
  static constexpr size_t kTotal = kQ + kStages * 2 * kRawTile + kWide;
};

// Stage one chunk of pages into the ring slot `slot`: page p of the chunk,
// token t, columns 16 bytes at a time by cp.async; zeros for dead pages and
// for the head-dim padding past d.
template <int DP, typename TP>
__device__ __forceinline__ void stage_chunk(unsigned char* raw_k, unsigned char* raw_v,
                                            const TP* __restrict__ k_pool,
                                            const TP* __restrict__ v_pool,
                                            const int* table, int chunk,
                                            int n_live, int kvh, int KV, int d) {
  using L = MmaSmem<DP, TP>;
  constexpr int kEl = (int)sizeof(TP);
  constexpr int kSegs = DP * kEl / 16;      // 16-byte segments of a padded row
  for (int idx = threadIdx.x; idx < kChunkKeys * kSegs; idx += kMmaThreads) {
    const int row = idx / kSegs, seg = idx - row * kSegs;
    const int j = chunk * kChunkPages + row / kPage, t = row % kPage;
    const int col = seg * 16 / kEl;
    const bool ok = j < n_live && col < d;
    size_t src = 0;
    if (ok) src = (((size_t)table[j] * kPage + t) * KV + kvh) * (size_t)d + col;
    const size_t dst = (size_t)row * L::kRawRow + seg * 16;
    cp_async16(raw_k + dst, ok ? (const void*)(k_pool + src) : (const void*)k_pool, ok ? 16 : 0);
    cp_async16(raw_v + dst, ok ? (const void*)(v_pool + src) : (const void*)v_pool, ok ? 16 : 0);
  }
}

// Widen a chunk's int8 K/V codes (raw rows of DP bytes) to bf16 tiles (rows
// of DP + 8); exact, as every code is an integer of at most 8 bits.
template <int DP>
__device__ __forceinline__ void widen_chunk(const unsigned char* rk, const unsigned char* rv,
                                            bf16* wk, bf16* wv) {
  constexpr int kStride = DP + 8;
  for (int idx = threadIdx.x; idx < kChunkKeys * DP / 4; idx += kMmaThreads) {
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

// The A fragments of 16 q rows of Qs (rows of DP + 8 bf16) times d^-1/2, a
// power of two: exact in bf16.
template <int DP>
__device__ __forceinline__ void load_q_frags(uint32_t (&qf)[DP / 16][4], const bf16* Qs,
                                             int lane, float qk_scale) {
  constexpr int kStride = DP + 8;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    ldsm_x4(qf[kk], Qs + (lane & 15) * kStride + kk * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&qf[kk][r]));
      qf[kk][r] = pack_bf16(__fmul_rn(f.x, qk_scale), __fmul_rn(f.y, qk_scale));
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

template <int DP, typename TP>
__global__ void __launch_bounds__(kMmaThreads, 1)
paged_e2softmax_mma_kernel(const bf16* __restrict__ q, const TP* __restrict__ k_pool,
                 const TP* __restrict__ v_pool, const int* __restrict__ tables,
                 const int* __restrict__ meta, const int* __restrict__ kv_head_map,
                 float* __restrict__ out, int H, int C, int d, int KV, int NB, int causal,
                 int sole, int exp_bits, int has_snap, float int8_scale, float snap_inv,
                 float qk_scale, float kv_scale) {
  using L = MmaSmem<DP, TP>;
  constexpr int kStride = L::kStride;
  constexpr int DK = DP / 16;               // k-steps of Q.K^T
  constexpr int DN = DP / 8;                // 8-column tiles of the output
  constexpr int NT = 2 * kChunkPages;       // 8-key tiles of a chunk
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int heads[kMaxHeads];
  __shared__ int n_heads;
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  unsigned char* ring = smem_raw + L::kQ;
  bf16* wide = reinterpret_cast<bf16*>(ring + kStages * 2 * L::kRawTile);

  const int b = blockIdx.x / KV, kvh = blockIdx.x % KV;
  const int G = group_heads(kv_head_map, H, kvh, heads, &n_heads);
  const int t0 = (gridDim.y - 1 - blockIdx.y) * kMmaRows;   // heaviest causal tiles first
  if (t0 >= G * C) return;                  // block-uniform: no rows here
  const int rows = min(kMmaRows, G * C - t0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int q_start = meta[2 * b], kv_len = meta[2 * b + 1];
  const float kmax = (float)((1 << exp_bits) - 1);
  const float submax = (float)((1 << (exp_bits + 2)) - 1);
  const int last_pos = q_start + (t0 + rows - 1) / G;
  int n_live = min(NB, (kv_len + kPage - 1) / kPage);
  if (causal) n_live = min(n_live, last_pos / kPage + 1);
  const int n_chunks = (n_live + kChunkPages - 1) / kChunkPages;
  int* table = reinterpret_cast<int*>(smem_raw + L::kTotal);     // the live pages
  for (int j = threadIdx.x; j < n_live; j += kMmaThreads) table[j] = tables[(size_t)b * NB + j];
  __syncthreads();

  // the CTA's q rows, gathered per head, zeros past its rows and past d
  for (int idx = threadIdx.x; idx < kMmaRows * (DP / 8); idx += kMmaThreads) {
    const int r = idx / (DP / 8), col = (idx - r * (DP / 8)) * 8;
    const bool ok = r < rows && col < d;
    const int rg = t0 + (ok ? r : 0);
    const bf16* src = q + (((size_t)b * H + heads[rg % G]) * C + rg / G) * d + col;
    cp_async16(Qs + r * kStride + col, ok ? (const void*)src : (const void*)q, ok ? 16 : 0);
  }
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_chunks)
      stage_chunk<DP, TP>(ring + (size_t)s * 2 * L::kRawTile,
                          ring + ((size_t)s * 2 + 1) * L::kRawTile, k_pool, v_pool, table, s,
                          n_live, kvh, KV, d);
    cp_async_commit();
  }

  // the warp's rows a = 16 warp + g and b = a + 8 (tile-local), their positions
  const int ra = warp * 16 + g, rb = ra + 8;
  const int pos_a = q_start + min(t0 + ra, G * C - 1) / G;
  const int pos_b = q_start + min(t0 + rb, G * C - 1) / G;
  uint32_t qf[DK][4];
  float acc[DN][4];
#pragma unroll
  for (int dn = 0; dn < DN; ++dn)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[dn][r] = 0.0f;
  float m_a = kNeg, m_b = kNeg, s_a = 0.0f, s_b = 0.0f;

  for (int ch = 0; ch < n_chunks; ++ch) {
    const int pre = ch + kStages - 1;       // the chunk loaded now, stages - 1 ahead
    if (pre < n_chunks) {
      const int slot = pre % kStages;
      stage_chunk<DP, TP>(ring + (size_t)slot * 2 * L::kRawTile,
                          ring + ((size_t)slot * 2 + 1) * L::kRawTile, k_pool, v_pool, table,
                          pre, n_live, kvh, KV, d);
    }
    cp_async_commit();
    cp_async_wait<kStages - 1>();           // chunk ch (and the q tile) landed
    __syncthreads();
    const unsigned char* rk = ring + (size_t)(ch % kStages) * 2 * L::kRawTile;
    const unsigned char* rv = rk + L::kRawTile;
    const bf16* ks;
    const bf16* vs;
    if constexpr (L::kInt8) {
      widen_chunk<DP>(rk, rv, wide, wide + kChunkKeys * kStride);
      __syncthreads();
      ks = wide;
      vs = wide + kChunkKeys * kStride;
    } else {
      ks = reinterpret_cast<const bf16*>(rk);
      vs = reinterpret_cast<const bf16*>(rv);
    }
    if (ch == 0) load_q_frags<DP>(qf, Qs + warp * 16 * kStride, lane, qk_scale);

    // all 8 pages' logits of the warp's 16 rows
    float sc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) sc[nt][r] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < DK; ++kk)
#pragma unroll
      for (int kt = 0; kt < kChunkPages; ++kt) {
        uint32_t bq[4];
        ldsm_x4(bq, ks + (kt * 16 + (lane & 7) + ((lane >> 4) << 3)) * kStride + kk * 16 +
                        (((lane >> 3) & 1) << 3));
        mma_bf16(sc[2 * kt], qf[kk], bq[0], bq[1]);
        mma_bf16(sc[2 * kt + 1], qf[kk], bq[2], bq[3]);
      }
    // mask (keys past kv_len, the causal diagonal, dead pages) to -inf; int8
    // pools: the logits of the codes times kv_scale (a power of two: exact)
    const int c0 = ch * kChunkKeys;
    if constexpr (L::kInt8) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int r = 0; r < 4; ++r) sc[nt][r] = __fmul_rn(sc[nt][r], kv_scale);
    }
    // only a chunk that reaches past kv_len or the warp's first row masks
    if (c0 + kChunkKeys > kv_len || (causal && c0 + kChunkKeys - 1 > min(pos_a, pos_b))) {
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
    float pm_a[kChunkPages], pm_b[kChunkPages];
#pragma unroll
    for (int p = 0; p < kChunkPages; ++p) {
      pm_a[p] = quad_max(fmaxf(fmaxf(sc[2 * p][0], sc[2 * p][1]),
                               fmaxf(sc[2 * p + 1][0], sc[2 * p + 1][1])));
      pm_b[p] = quad_max(fmaxf(fmaxf(sc[2 * p][2], sc[2 * p][3]),
                               fmaxf(sc[2 * p + 1][2], sc[2 * p + 1][3])));
    }
    // the combine, page by page in order (dead pages are the identity)
#pragma unroll
    for (int p = 0; p < kChunkPages; ++p) {
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
      for (int dn = 0; dn < DN; ++dn) {
        acc[dn][0] = __fmul_rn(acc[dn][0], corr_a);
        acc[dn][1] = __fmul_rn(acc[dn][1], corr_a);
        acc[dn][2] = __fmul_rn(acc[dn][2], corr_b);
        acc[dn][3] = __fmul_rn(acc[dn][3], corr_b);
      }
      const bf16* vp = vs + p * kPage * kStride;
      if (sole) pv_product<DP, 1, false>(acc, sp, vp, lane);
      else pv_product<DP, 1, true>(acc, sp, vp, lane);
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
    for (int dn = 0; dn < DN; ++dn) {
      const int col = dn * 8 + 2 * t4;
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
  // the ring, Q and the CTA's page table (NB ints)
  const size_t smem = MmaSmem<DP, TP>::kTotal + ((size_t)NB * 4 + 15) / 16 * 16;
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  auto kernel = paged_e2softmax_mma_kernel<DP, TP>;
  static bool ready = false;                // per instantiation
  if (!ready) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kMaxSmem);
    if (e != cudaSuccess) return (int)e;
    ready = true;
  }
  dim3 grid(B * KV, (H * C + kMmaRows - 1) / kMmaRows);
  kernel<<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const TP*>(k_pool),
      static_cast<const TP*>(v_pool), static_cast<const int*>(tables),
      static_cast<const int*>(meta), static_cast<const int*>(kv_head_map),
      static_cast<float*>(out), H, C, d, KV, NB, causal, sole, exp_bits, has_snap, int8_scale,
      snap_inv, qk_scale, kv_scale);
  return (int)cudaGetLastError();
}

// -- decode: one 16-row tile, the chunk's pages split over the warps -----------
//
// At decode a CTA's rows (its group's heads, one query each) fit one 16-row
// mma tile, so one warp would walk every page alone. Here warp w takes pages
// 2w and 2w + 1 of each chunk for all 16 rows: their logits, their maxima
// (to shared memory), then, from the prefix maxima of all 8 pages, their
// weights, row sums and P.V partials on the tensor cores (to shared memory).
// The combine runs in page order, s = s * corr_j + sum_j and acc = acc *
// corr_j + pv_j (the plain version's own order), each warp over its quarter
// of the head-dim columns.

template <int DP, typename TP>
struct DecSmem {
  using M = MmaSmem<DP, TP>;
  static constexpr int kPvStride = DP + 4;   // floats per pv row: 16-byte rows, banks spread
  static constexpr size_t kQ = (size_t)16 * M::kStride * 2;
  static constexpr size_t kRing = (size_t)kStages * 2 * M::kRawTile;
  static constexpr size_t kPv = (size_t)kChunkPages * 16 * kPvStride * 4;
  static constexpr size_t kStat = (size_t)2 * kChunkPages * 16 * 4;   // maxima, sums
  static constexpr size_t kTotal = kQ + kRing + M::kWide + kPv + kStat;
};

template <int DP, typename TP>
__global__ void __launch_bounds__(kMmaThreads, 1)
paged_e2softmax_decode_kernel(const bf16* __restrict__ q, const TP* __restrict__ k_pool,
                              const TP* __restrict__ v_pool, const int* __restrict__ tables,
                              const int* __restrict__ meta, const int* __restrict__ kv_head_map,
                              float* __restrict__ out, int H, int C, int d, int KV, int NB,
                              int causal, int sole, int exp_bits, int has_snap, float int8_scale,
                              float snap_inv, float qk_scale, float kv_scale) {
  using M = MmaSmem<DP, TP>;
  using L = DecSmem<DP, TP>;
  constexpr int kStride = M::kStride;
  constexpr int DK = DP / 16;
  constexpr int DN = DP / 8;
  constexpr int kPvStride = L::kPvStride;
  constexpr int kE = DP / kMmaWarps / 2;    // combine columns a lane owns
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int heads[kMaxHeads];
  __shared__ int n_heads;
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  unsigned char* ring = smem_raw + L::kQ;
  bf16* wide = reinterpret_cast<bf16*>(ring + L::kRing);
  float* pvbuf = reinterpret_cast<float*>(ring + L::kRing + M::kWide);
  float* pmax = pvbuf + (size_t)kChunkPages * 16 * kPvStride;      // [page][row]
  float* psum = pmax + kChunkPages * 16;

  const int b = blockIdx.x / KV, kvh = blockIdx.x % KV;
  const int G = group_heads(kv_head_map, H, kvh, heads, &n_heads);
  const int t0 = blockIdx.y * 16;
  if (t0 >= G * C) return;                  // block-uniform: no rows here
  const int rows = min(16, G * C - t0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int q_start = meta[2 * b], kv_len = meta[2 * b + 1];
  const float kmax = (float)((1 << exp_bits) - 1);
  const float submax = (float)((1 << (exp_bits + 2)) - 1);
  const int last_pos = q_start + (t0 + rows - 1) / G;
  int n_live = min(NB, (kv_len + kPage - 1) / kPage);
  if (causal) n_live = min(n_live, last_pos / kPage + 1);
  const int n_chunks = (n_live + kChunkPages - 1) / kChunkPages;
  int* table = reinterpret_cast<int*>(smem_raw + L::kTotal);
  for (int j = threadIdx.x; j < n_live; j += kMmaThreads) table[j] = tables[(size_t)b * NB + j];
  __syncthreads();

  for (int idx = threadIdx.x; idx < 16 * (DP / 8); idx += kMmaThreads) {
    const int r = idx / (DP / 8), col = (idx - r * (DP / 8)) * 8;
    const bool ok = r < rows && col < d;
    const int rg = t0 + (ok ? r : 0);
    const bf16* src = q + (((size_t)b * H + heads[rg % G]) * C + rg / G) * d + col;
    cp_async16(Qs + r * kStride + col, ok ? (const void*)src : (const void*)q, ok ? 16 : 0);
  }
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_chunks)
      stage_chunk<DP, TP>(ring + (size_t)st * 2 * M::kRawTile,
                          ring + ((size_t)st * 2 + 1) * M::kRawTile, k_pool, v_pool, table, st,
                          n_live, kvh, KV, d);
    cp_async_commit();
  }

  // mma rows g and g + 8 (every warp holds all 16); the combine row and columns
  const int pos_a = q_start + min(t0 + g, G * C - 1) / G;
  const int pos_b = q_start + min(t0 + g + 8, G * C - 1) / G;
  const int rc = lane >> 1;
  const int col0 = warp * (DP / kMmaWarps) + (lane & 1) * kE;
  const int p0 = 2 * warp;                  // this warp's pages of a chunk
  uint32_t qf[DK][4];
  float m_a = kNeg, m_b = kNeg;             // running maxima of the mma rows
  float m_c = kNeg, s_c = 0.0f;             // and of the combine row
  float acc[kE];
#pragma unroll
  for (int e = 0; e < kE; ++e) acc[e] = 0.0f;

  for (int ch = 0; ch < n_chunks; ++ch) {
    const int pre = ch + kStages - 1;
    if (pre < n_chunks) {
      const int slot = pre % kStages;
      stage_chunk<DP, TP>(ring + (size_t)slot * 2 * M::kRawTile,
                          ring + ((size_t)slot * 2 + 1) * M::kRawTile, k_pool, v_pool, table,
                          pre, n_live, kvh, KV, d);
    }
    cp_async_commit();
    cp_async_wait<kStages - 1>();           // chunk ch (and the q tile) landed
    __syncthreads();
    const unsigned char* rk = ring + (size_t)(ch % kStages) * 2 * M::kRawTile;
    const unsigned char* rv = rk + M::kRawTile;
    const bf16* ks;
    const bf16* vs;
    if constexpr (M::kInt8) {
      widen_chunk<DP>(rk, rv, wide, wide + kChunkKeys * kStride);
      __syncthreads();
      ks = wide;
      vs = wide + kChunkKeys * kStride;
    } else {
      ks = reinterpret_cast<const bf16*>(rk);
      vs = reinterpret_cast<const bf16*>(rv);
    }
    if (ch == 0) load_q_frags<DP>(qf, Qs, lane, qk_scale);

    // this warp's two pages: logits of the 16 rows, masked, and their maxima
    float sc[4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) sc[nt][r] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < DK; ++kk)
#pragma unroll
      for (int kt = 0; kt < 2; ++kt) {
        uint32_t bq[4];
        ldsm_x4(bq, ks + ((p0 + kt) * 16 + (lane & 7) + ((lane >> 4) << 3)) * kStride +
                        kk * 16 + (((lane >> 3) & 1) << 3));
        mma_bf16(sc[2 * kt], qf[kk], bq[0], bq[1]);
        mma_bf16(sc[2 * kt + 1], qf[kk], bq[2], bq[3]);
      }
    const int c0 = ch * kChunkKeys + p0 * kPage;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int col = c0 + nt * 8 + 2 * t4 + (r & 1);
        const int pos = r < 2 ? pos_a : pos_b;
        float x = sc[nt][r];
        if constexpr (M::kInt8) x = __fmul_rn(x, kv_scale);   // a power of two: exact
        sc[nt][r] = (col >= kv_len || (causal && pos < col)) ? -CUDART_INF_F : x;
      }
#pragma unroll
    for (int pp = 0; pp < 2; ++pp) {
      const float pm_a = quad_max(fmaxf(fmaxf(sc[2 * pp][0], sc[2 * pp][1]),
                                        fmaxf(sc[2 * pp + 1][0], sc[2 * pp + 1][1])));
      const float pm_b = quad_max(fmaxf(fmaxf(sc[2 * pp][2], sc[2 * pp][3]),
                                        fmaxf(sc[2 * pp + 1][2], sc[2 * pp + 1][3])));
      if (t4 == 0) {
        pmax[(p0 + pp) * 16 + g] = pm_a;
        pmax[(p0 + pp) * 16 + g + 8] = pm_b;
      }
    }
    __syncthreads();

    // weights from the prefix maxima, row sums and P.V partials of its pages
    float mp_a = m_a, mp_b = m_b;
    for (int j = 0; j < p0; ++j) {
      mp_a = fmaxf(mp_a, pmax[j * 16 + g]);
      mp_b = fmaxf(mp_b, pmax[j * 16 + g + 8]);
    }
#pragma unroll
    for (int pp = 0; pp < 2; ++pp) {
      const int p = p0 + pp;
      mp_a = fmaxf(mp_a, pmax[p * 16 + g]);
      mp_b = fmaxf(mp_b, pmax[p * 16 + g + 8]);
      float sp[2][4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        sp[0][r] = sc[2 * pp][r];
        sp[1][r] = sc[2 * pp + 1][r];
      }
      float ls_a = 0.0f, ls_b = 0.0f;
      page_weights(sp, mp_a, mp_b, sole, has_snap, snap_inv, int8_scale, kmax, ls_a, ls_b);
      ls_a = quad_sum(ls_a);
      ls_b = quad_sum(ls_b);
      if (t4 == 0) {
        psum[p * 16 + g] = ls_a;
        psum[p * 16 + g + 8] = ls_b;
      }
      float pv[DN][4];
#pragma unroll
      for (int dn = 0; dn < DN; ++dn)
#pragma unroll
        for (int r = 0; r < 4; ++r) pv[dn][r] = 0.0f;
      const bf16* vp = vs + p * kPage * kStride;
      if (sole) pv_product<DP, 1, false>(pv, sp, vp, lane);
      else pv_product<DP, 1, true>(pv, sp, vp, lane);
      float* pvp = pvbuf + (size_t)p * 16 * kPvStride;
#pragma unroll
      for (int dn = 0; dn < DN; ++dn) {
        const int col = dn * 8 + 2 * t4;
        *reinterpret_cast<float2*>(pvp + g * kPvStride + col) = make_float2(pv[dn][0], pv[dn][1]);
        *reinterpret_cast<float2*>(pvp + (g + 8) * kPvStride + col) =
            make_float2(pv[dn][2], pv[dn][3]);
      }
    }
#pragma unroll
    for (int j = 0; j < kChunkPages; ++j) {
      m_a = fmaxf(m_a, pmax[j * 16 + g]);
      m_b = fmaxf(m_b, pmax[j * 16 + g + 8]);
    }
    __syncthreads();

    // the combine, page by page in order, on this lane's row and columns
#pragma unroll
    for (int j = 0; j < kChunkPages; ++j) {
      const float mn = fmaxf(m_c, pmax[j * 16 + rc]);
      const float corr = block_corr(m_c, mn, sole, submax);
      m_c = mn;
      s_c = __fadd_rn(__fmul_rn(s_c, corr), psum[j * 16 + rc]);
      const float4* pvr =
          reinterpret_cast<const float4*>(pvbuf + ((size_t)j * 16 + rc) * kPvStride + col0);
#pragma unroll
      for (int e4 = 0; e4 < kE / 4; ++e4) {
        const float4 v = pvr[e4];
        acc[4 * e4] = __fadd_rn(__fmul_rn(acc[4 * e4], corr), v.x);
        acc[4 * e4 + 1] = __fadd_rn(__fmul_rn(acc[4 * e4 + 1], corr), v.y);
        acc[4 * e4 + 2] = __fadd_rn(__fmul_rn(acc[4 * e4 + 2], corr), v.z);
        acc[4 * e4 + 3] = __fadd_rn(__fmul_rn(acc[4 * e4 + 3], corr), v.w);
      }
    }
    __syncthreads();                        // the ring slot and the buffers are reused
  }
  cp_async_wait<0>();                       // nothing left in flight at exit

  if (rc < rows) {
    float scale = final_scale(s_c, sole);
    if constexpr (M::kInt8) scale = __fmul_rn(scale, kv_scale);   // P.V ran on the raw codes
    const int rg = t0 + rc;
    float* orow = out + (((size_t)b * H + heads[rg % G]) * C + rg / G) * d;
#pragma unroll
    for (int e = 0; e < kE; ++e)
      if (col0 + e < d) orow[col0 + e] = __fmul_rn(acc[e], scale);
  }
}

template <int DP, typename TP>
int launch_decode(const void* q, const void* k_pool, const void* v_pool, const void* tables,
                  const void* meta, const void* kv_head_map, void* out, int B, int H, int C,
                  int d, int KV, int NB, int causal, int sole, int exp_bits, int has_snap,
                  float int8_scale, float snap_inv, float qk_scale, float kv_scale,
                  cudaStream_t stream) {
  const size_t smem = DecSmem<DP, TP>::kTotal + ((size_t)NB * 4 + 15) / 16 * 16;
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  auto kernel = paged_e2softmax_decode_kernel<DP, TP>;
  static bool ready = false;                // per instantiation
  if (!ready) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kMaxSmem);
    if (e != cudaSuccess) return (int)e;
    ready = true;
  }
  dim3 grid(B * KV, (H * C + 15) / 16);
  kernel<<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const TP*>(k_pool),
      static_cast<const TP*>(v_pool), static_cast<const int*>(tables),
      static_cast<const int*>(meta), static_cast<const int*>(kv_head_map),
      static_cast<float*>(out), H, C, d, KV, NB, causal, sole, exp_bits, has_snap, int8_scale,
      snap_inv, qk_scale, kv_scale);
  return (int)cudaGetLastError();
}

// Whether the tensor-core kernels take these arguments: bf16 q, bf16 or int8
// pools of 16-token pages, d^-1/2 (folded into the bf16 q) and an int8 pool's
// kv_scale (applied after the products) powers of two, d a multiple of 16 up
// to 64 (so 16 or 64, padded to 64 columns), 16-byte aligned q and pools
// (vec).
bool mma_variant(int q_type, int pool_type, int d, int bs, float qk_scale, float kv_scale,
                 int vec) {
  int e;
  const bool pow2 = frexpf(qk_scale, &e) == 0.5f &&
                    (pool_type != 2 || frexpf(kv_scale, &e) == 0.5f);
  return q_type == 1 && pool_type != 0 && bs == kPage && d % 16 == 0 && d <= 64 && pow2 && vec;
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
// tensor cores where mma_variant allows, everything else on the CUDA cores.
int paged_e2softmax(const void* q, const void* k_pool, const void* v_pool,
                    const void* tables, const void* meta, const void* kv_head_map,
                    void* out, int B, int H, int C, int d, int bs, int KV, int NB,
                    int causal, int sole, int exp_bits, int has_snap, int q_type,
                    int pool_type, int quant_pv, int vec, float int8_scale,
                    float snap_inv, float qk_scale, float kv_scale, void* stream) {
  if (H > kMaxHeads || d > 32 * kMaxDimChunks) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mma_variant(q_type, pool_type, d, bs, qk_scale, kv_scale, vec)) {
#define REPRO_MMA_LAUNCH(DP, TP)                                                           \
  return C == 1                                                                             \
             ? launch_decode<DP, TP>(q, k_pool, v_pool, tables, meta, kv_head_map, out, B, H, \
                                     C, d, KV, NB, causal, sole, exp_bits, has_snap,          \
                                     int8_scale, snap_inv, qk_scale, kv_scale, s)            \
             : launch_mma<DP, TP>(q, k_pool, v_pool, tables, meta, kv_head_map, out, B, H, C, \
                                  d, KV, NB, causal, sole, exp_bits, has_snap, int8_scale,    \
                                  snap_inv, qk_scale, kv_scale, s)
    if (pool_type == 1) REPRO_MMA_LAUNCH(64, __nv_bfloat16);
    REPRO_MMA_LAUNCH(64, int8_t);
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
