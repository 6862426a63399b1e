// Paged Flash-E2Softmax attention over a block-paged KV pool, for sm_90a.
//
// Replaces src/repro/kernels/flash_e2softmax.py::_paged_kernel (with
// _online_update and _final_scale; entry points flash_e2softmax_paged and
// flash_e2softmax_paged_decode): every prefill chunk (causal) and every
// decode step (C = 1) of the serve path.
//
// For each (sequence b, query head h, tile of BQ query rows) one block walks
// the sequence's page table j = 0..NB-1 *in order* and applies one online
// update per live page, exactly as the TPU kernel's sequential grid axis
// does. The order is part of the function: in SOLE mode the running sum and
// accumulator are rescaled by the *quantized* correction 2^-clip(rint(
// 1.4375 dm), 0, 2^(b+2)-1) once per page, so a split-KV reduction would
// compute something else. Per page:
//   logits = (q * d^-1/2) . k^T, masked to col < kv_len (and, causal,
//            q_start + row >= col); masked logits are NEG = -1e30
//   SOLE : dm = logit - m_new, optional int8 snap clip(rint(dm * (1/s)),
//          -127, 0) * s (the jitted reference multiplies by float32(1/s)),
//          w = 2^-clip(rint(-1.4375 dm), 0, 2^b - 1), masked w = 0
//   exact: w = exp2(dm * log2 e), corr = exp2((m_prev - m_new) * log2 e)
//   s = s * corr + sum(w);  acc = acc * corr + w . v
// and at the end out = acc * 2^-e * {1.636, 1.136} (ALDivision, e and the
// mantissa bit from frexp(max(s, 2^-30))) or acc / s (exact mode).
// Int8 page pools (the W8A8 path) carry codes with one scale kv_scale: K is
// dequantized as it is staged (k * kv_scale in fp32, like the TPU kernel),
// and so is V unless quant_pv, where P.V accumulates the raw V codes and
// kv_scale multiplies the final row scale instead.
// A page is skipped when its first column is >= kv_len or, causal, past the
// tile's last query row: for rows that see none of its keys the update is
// the identity (corr = 1, w = 0), so this matches the TPU kernel's skip.
//
// What bounds it on an H100: bytes. A decode step reads every live K and V
// page once per query head that maps to it and does 4 flops per key and
// head dimension, about 1 flop per byte; prefill chunks reach ~BQ flops
// per byte, still far below the card's ~295 operations per byte. The bound
// is the bytes of q, the live K/V pages and the output at 3.35 TB/s.
// Int8 pools halve the page bytes of bf16 ones.
// Design, simple and right first: each page's K and V tile goes through
// shared memory as fp32 (K rows padded by one word against bank conflicts),
// one warp per query row computes the page's logits (a lane per key), the
// warp-reduced max and sum, then the accumulator (a lane per head-dim
// column); all arithmetic is fp32, powers of two are built exactly with
// ldexpf, and rint() is round-half-to-even like jnp.round. GQA query heads
// of one KV head re-read its pages from L2; wgmma, TMA and reading each page
// once per KV-head group are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxRowsPerWarp = 4;          // BQ <= kWarps * kMaxRowsPerWarp
constexpr int kMaxDimChunks = 8;            // head_dim <= 256
constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kInvLn2Shift = 1.4375f;
constexpr float kAldivBias = 1.636f;
constexpr float kAldivBiasHalf = 1.136f;    // ALDIV_BIAS - 0.5 in float32

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(int8_t v) { return (float)v; }

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename TQ, typename TP>
__global__ void __launch_bounds__(kThreads)
paged_e2softmax_kernel(const TQ* __restrict__ q, const TP* __restrict__ k_pool,
                       const TP* __restrict__ v_pool, const int* __restrict__ tables,
                       const int* __restrict__ meta, const int* __restrict__ kv_head_map,
                       float* __restrict__ out, int H, int C, int d, int bs, int KV,
                       int NB, int BQ, int causal, int sole, int exp_bits,
                       int has_snap, float int8_scale, float snap_inv,
                       float qk_scale, int quant_pv, float kv_scale) {
  // Int8 pools always carry kv_scale; float pools compile without it.
  constexpr bool kInt8Pool = std::is_same<TP, int8_t>::value;
  extern __shared__ float smem[];
  const int kstride = d + 1;
  float* Ks = smem;                         // bs x (d + 1)
  float* Vs = Ks + bs * kstride;            // bs x d
  float* Qs = Vs + bs * d;                  // BQ x d, pre-scaled
  float* Ws = Qs + BQ * d;                  // kWarps x bs: logits, then weights

  const int b = blockIdx.x, h = blockIdx.y, q0 = blockIdx.z * BQ;
  const int rows = min(BQ, C - q0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q_start = meta[2 * b], kv_len = meta[2 * b + 1];
  const int kvh = kv_head_map[h];
  const float kmax = (float)((1 << exp_bits) - 1);
  const float submax = (float)((1 << (exp_bits + 2)) - 1);

  const TQ* qb = q + (((size_t)b * H + h) * C + q0) * d;
  for (int idx = threadIdx.x; idx < rows * d; idx += kThreads)
    Qs[idx] = __fmul_rn(to_f32(qb[idx]), qk_scale);

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
  const int last_row = q_start + q0 + rows - 1;

  for (int j = 0; j < NB; ++j) {
    const int col0 = j * bs;
    if (col0 >= kv_len || (causal && col0 > last_row)) continue;  // block-uniform
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
      const int row_pos = q_start + q0 + r;
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
    const float s = fmaxf(s_run[rr], 9.313225746154785e-10f);   // 2^-30
    float scale;
    if (sole) {
      int e;
      const float mant = frexpf(s, &e);
      scale = ldexpf(mant >= 0.75f ? kAldivBiasHalf : kAldivBias, -e);
    } else {
      scale = __fdiv_rn(1.0f, s);
    }
    if (kInt8Pool && quant_pv) scale = __fmul_rn(scale, kv_scale);
    float* orow = out + (((size_t)b * H + h) * C + q0 + r) * d;
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
  const int BQ = C < kWarps * kMaxRowsPerWarp ? C : kWarps * kMaxRowsPerWarp;
  const size_t smem = sizeof(float) *
      ((size_t)bs * (d + 1) + (size_t)bs * d + (size_t)BQ * d + (size_t)kWarps * bs);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(paged_e2softmax_kernel<TQ, TP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(B, H, (C + BQ - 1) / BQ);
  paged_e2softmax_kernel<TQ, TP><<<grid, kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TP*>(k_pool),
      static_cast<const TP*>(v_pool), static_cast<const int*>(tables),
      static_cast<const int*>(meta), static_cast<const int*>(kv_head_map),
      static_cast<float*>(out), H, C, d, bs, KV, NB, BQ, causal, sole, exp_bits, has_snap,
      int8_scale, snap_inv, qk_scale, quant_pv, kv_scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Element types: 0 = float32, 1 = bfloat16, 2 = int8 (pools only).
// q: (B, H, C, d) of q_type; k_pool, v_pool: (N, bs, KV, d) of pool_type,
// which is q_type or int8; all contiguous. tables: (B, NB) int32; meta:
// (B, 2) int32 rows (q_start, kv_len); kv_head_map: (H,) int32; out:
// (B, H, C, d) float32. Int8 pools are dequantized by kv_scale: K, and V
// unless quant_pv, where kv_scale multiplies the final row scale instead;
// float pools ignore kv_scale and quant_pv. snap_inv = float32(1 /
// int8_scale). Requires d <= 256. Launches on `stream` and returns the launch's
// cudaError_t (0 on success; cudaErrorInvalidValue for a type pair it
// does not take).
int paged_e2softmax(const void* q, const void* k_pool, const void* v_pool,
                    const void* tables, const void* meta, const void* kv_head_map,
                    void* out, int B, int H, int C, int d, int bs, int KV, int NB,
                    int causal, int sole, int exp_bits, int has_snap, int q_type,
                    int pool_type, int quant_pv, float int8_scale,
                    float snap_inv, float qk_scale, float kv_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
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
