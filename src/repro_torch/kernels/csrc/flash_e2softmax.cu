// Dense Flash-E2Softmax attention, single-head layout, for sm_90a.
//
// Replaces src/repro/kernels/flash_e2softmax.py::_kernel (with
// _online_update and _final_scale; entry point flash_e2softmax_pallas,
// reached through the op layer's flash_attention exact/sole).
//
// q (BH, S, d), k and v (BH, T, d), float32 or bf16 -> out (BH, S, d)
// float32. One block per (bh, tile of BQ query rows) walks the k-blocks of
// width BK *in order* and applies one online update per k-block, as the TPU
// kernel's sequential grid axis does. The order and the block width are part
// of the function: in SOLE mode the running sum and accumulator are rescaled
// by the quantized correction 2^-clip(rint(1.4375 dm), 0, 2^(b+2)-1) once per
// k-block, so a split-K reduction would compute something else. Per k-block:
//   logits = (q * d^-1/2) . k^T, masked to col < T and, causal, row >= col;
//            masked logits are NEG = -1e30
//   SOLE : dm = logit - m_new, optional int8 snap clip(rint(dm * (1/s)),
//          -127, 0) * s (the jitted reference multiplies by float32(1/s)),
//          w = 2^-clip(rint(-1.4375 dm), 0, 2^b - 1), masked w = 0;
//          corr = 2^-clip(rint(1.4375 (m_new - m_prev)), 0, 2^(b+2) - 1), or
//          with exact_corr exp2((m_prev - m_new) log2 e)
//   exact: w = exp2(dm log2 e), corr = exp2((m_prev - m_new) log2 e)
//   s = s * corr + sum(w);  acc = acc * corr + w . v
// and at the end out = acc * 2^-e * {1.636, 1.136} (ALDivision, e and the
// mantissa bit from frexp(max(s, 2^-30))) or acc / s (exact mode). A causal
// k-block that no row of the tile reaches is skipped: for those rows the
// update is the identity (corr = 1, w = 0), as in the TPU kernel.
//
// What bounds it on an H100: at the op layer's shapes (S = T = 2048,
// d = 64) operations. A causal (BH, 2048, 64) call moves ~1.3 MB per head
// (q, k, v read once in bf16, the float32 output written once) for ~0.54
// GFLOP per head of q.k and w.v, ~400 flops per byte, above the card's
// ~295 bf16 operations per byte, so the bound is the products at the
// tensor cores' 989 TFLOP/s. In SOLE mode each logit also takes ~15
// CUDA-core instructions (subtract, snap, round, clamp, the power of two),
// which no tensor core does.
//
// Two instantiations, chosen by the inputs' type:
//
// bf16 q/k/v (the op layer's type): tensor cores. A CTA of BQ/16 warps
// owns one q tile, 16 rows per warp, and walks the k-blocks in order:
// * K and V tiles stay bf16 in shared memory, copied with cp.async into
//   a two-stage ring: block j + 1 loads while block j computes. The head
//   dim is zero-padded to 64 or 128 and the key rows to the widest block's
//   64 or 128 (zero rows are masked), so every block runs the same
//   unguarded code; rows are padded by 16 bytes so ldmatrix hits 32 banks.
//   Causal CTAs are scheduled heaviest q tile first.
// * Q.K^T: mma.sync.m16n8k16 bf16 -> float32, Q fragments held in
//   registers, K fragments by ldmatrix. bf16 x bf16 products are exact in
//   float32; only the summation order differs from the plain version.
//   Where d^-1/2 is a power of two (d = 16, 64, 256) it is folded into the
//   bf16 q exactly; otherwise it multiplies the float32 logits (codes may
//   then flip at rounding ties against the plain version's scaled q).
// * The whole BQ x BK logits tile of a k-block is in registers (at BK =
//   128, 64 float32 a thread); the row max over the whole block comes from
//   the quad's shuffles, and only then the weights: one online update per
//   k-block, as the Pallas kernel's sequential grid axis, never a split.
// * P.V: the weights go to the tensor cores as the A operand straight from
//   the logits' accumulator layout; V fragments by ldmatrix.trans. SOLE
//   weights 2^-k (k <= 63) are exact in bf16, so P.V rounds only in the
//   float32 sums; their codes round with two full-rate adds, not rintf.
//   Exact-mode exp2 weights would lose 2^-9 relative in bf16, so P is
//   split into hi = bf16(P) and lo = bf16(P - hi) and both are multiplied
//   (~2^-17 relative). The correction multiplies the float32 accumulator
//   in registers.
// float32 q/k/v (the quickstart's type): the CUDA cores, as the first
// version of this kernel was built, and right as it is: float32 tiles in
// shared memory, a lane per key for the logits and per head-dim column
// for the accumulator, weights read by shuffle. It is the float32 path's
// kernel, not a fallback of the bf16 one.
// Both: masked logits NEG (-inf in registers), weights 0; powers of two
// from exponent bits or ldexpf; rounding is half to even like jnp.round;
// __fmul_rn/__fsub_rn keep the codes' inputs out of FMA contraction.
// On an NVIDIA H100 80GB HBM3 at a 700 W power limit the bf16 kernel
// takes 0.103 ms (exact) and 0.135 ms (SOLE) at qwen2_0_5b's 2048-token
// causal shape, the first (CUDA-core) version 1.05 and 1.20; at 194
// registers one 8-warp CTA fits an SM and the SOLE arithmetic is
// latency-bound. wgmma with TMA tiles, and reading each KV head once per
// GQA group (the op repeats K/V to every query head), are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxBlock = 128;              // BQ, BK <= 128

// DCH: head-dim columns per lane / 32 (d <= 32 * DCH). ROWS: query-row slots
// per warp, KEYS: key slots per lane (tiles of up to 8 * ROWS rows and
// 32 * KEYS keys). Every warp computes all its slots: the q rows past the
// tile and the key rows past the k-block are zeros in shared memory, so the
// inner loops carry no guards and their loads and shuffles pipeline.
template <typename T, int DCH, int ROWS, int KEYS>
__global__ void __launch_bounds__(kThreads)
flash_e2softmax_dense_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v, float* __restrict__ out,
                             int S, int Tk, int d, int BQ, int BK, int causal,
                             int sole, int exp_bits, int has_snap, int exact_corr,
                             float int8_scale, float snap_inv, float qk_scale) {
  extern __shared__ float smem[];
  const int kst = d + 1;
  float* Qs = smem;                         // (8 ROWS) x d, pre-scaled
  float* Ks = Qs + kWarps * ROWS * d;       // (32 KEYS) x (d + 1)
  float* Vs = Ks + 32 * KEYS * kst;         // BK x d

  const int bh = blockIdx.y, q0 = blockIdx.x * BQ;
  const int rows = min(BQ, S - q0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float kmax = (float)((1 << exp_bits) - 1);
  const float submax = (float)((1 << (exp_bits + 2)) - 1);

  const T* qb = q + ((size_t)bh * S + q0) * d;
  for (int idx = threadIdx.x; idx < kWarps * ROWS * d; idx += kThreads)
    Qs[idx] = idx < rows * d ? __fmul_rn(to_f32(qb[idx]), qk_scale) : 0.0f;
  for (int idx = BK * kst + threadIdx.x; idx < 32 * KEYS * kst; idx += kThreads)
    Ks[idx] = 0.0f;                         // key slots past the k-block

  float m_run[ROWS], s_run[ROWS], acc[ROWS][DCH];
#pragma unroll
  for (int rr = 0; rr < ROWS; ++rr) {
    m_run[rr] = kNeg;
    s_run[rr] = 0.0f;
#pragma unroll
    for (int ch = 0; ch < DCH; ++ch) acc[rr][ch] = 0.0f;
  }
  const int last_row = q0 + rows - 1;
  const int nk = (Tk + BK - 1) / BK;
  const T* kb = k + (size_t)bh * Tk * d;
  const T* vb = v + (size_t)bh * Tk * d;

  for (int j = 0; j < nk; ++j) {
    const int c0 = j * BK;
    if (causal && c0 > last_row) break;     // block-uniform
    __syncthreads();                        // previous k-block fully consumed
    for (int idx = threadIdx.x; idx < BK * d; idx += kThreads) {
      const int t = idx / d, i = idx - t * d;
      float kv = 0.0f, vv = 0.0f;
      if (c0 + t < Tk) {
        const size_t src = (size_t)(c0 + t) * d + i;
        kv = to_f32(kb[src]);
        vv = to_f32(vb[src]);
      }
      Ks[t * kst + i] = kv;
      Vs[idx] = vv;
    }
    __syncthreads();

    // logits of this warp's rows (warp + 8 rr): lane holds keys lane + 32 jj
    float lg[ROWS][KEYS];
#pragma unroll
    for (int rr = 0; rr < ROWS; ++rr)
#pragma unroll
      for (int jj = 0; jj < KEYS; ++jj) lg[rr][jj] = 0.0f;
    for (int i = 0; i < d; ++i) {
      float kk[KEYS];
#pragma unroll
      for (int jj = 0; jj < KEYS; ++jj) kk[jj] = Ks[(jj * 32 + lane) * kst + i];
#pragma unroll
      for (int rr = 0; rr < ROWS; ++rr) {
        const float qv = Qs[(warp + rr * kWarps) * d + i];
#pragma unroll
        for (int jj = 0; jj < KEYS; ++jj) lg[rr][jj] = fmaf(qv, kk[jj], lg[rr][jj]);
      }
    }

    // online update per row; lg becomes the weights w
#pragma unroll
    for (int rr = 0; rr < ROWS; ++rr) {
      const int row = q0 + warp + rr * kWarps;
      bool keep[KEYS];
      float lmax = kNeg;
#pragma unroll
      for (int jj = 0; jj < KEYS; ++jj) {
        const int t = jj * 32 + lane, col = c0 + t;
        keep[jj] = t < BK && col < Tk && (!causal || row >= col);
        lg[rr][jj] = keep[jj] ? lg[rr][jj] : kNeg;
        lmax = fmaxf(lmax, lg[rr][jj]);
      }
      const float m_prev = m_run[rr];
      const float m_new = fmaxf(m_prev, warp_max(lmax));
      float corr;
      if (sole && !exact_corr) {
        const float sub = fminf(fmaxf(rintf(__fmul_rn(__fsub_rn(m_new, m_prev), kInvLn2Shift)),
                                      0.0f), submax);
        corr = ldexpf(1.0f, -(int)sub);
      } else {
        corr = exp2f(__fmul_rn(__fsub_rn(m_prev, m_new), kLog2e));
      }
      float lsum = 0.0f;
#pragma unroll
      for (int jj = 0; jj < KEYS; ++jj) {
        float dm = __fsub_rn(lg[rr][jj], m_new);
        float w;
        if (sole) {
          if (has_snap)
            dm = __fmul_rn(fminf(fmaxf(rintf(__fmul_rn(dm, snap_inv)), -127.0f), 0.0f),
                           int8_scale);
          const float kc = fminf(fmaxf(rintf(__fmul_rn(-dm, kInvLn2Shift)), 0.0f), kmax);
          w = keep[jj] ? ldexpf(1.0f, -(int)kc) : 0.0f;
        } else {
          w = keep[jj] ? exp2f(__fmul_rn(dm, kLog2e)) : 0.0f;
        }
        lg[rr][jj] = w;
        lsum = __fadd_rn(lsum, w);
      }
      s_run[rr] = __fadd_rn(__fmul_rn(s_run[rr], corr), warp_sum(lsum));
      m_run[rr] = m_new;
#pragma unroll
      for (int ch = 0; ch < DCH; ++ch) acc[rr][ch] = __fmul_rn(acc[rr][ch], corr);
    }

    // acc += w . v: key t's weight lives in lane t % 32, slot t / 32
#pragma unroll
    for (int jj = 0; jj < KEYS; ++jj) {
      if (jj * 32 >= BK) break;             // block-uniform
      const int nsrc = min(32, BK - jj * 32);
      for (int src = 0; src < nsrc; ++src) {
        const float* vrow = Vs + (jj * 32 + src) * d;
        float vv[DCH];
#pragma unroll
        for (int ch = 0; ch < DCH; ++ch) {
          const int i = ch * 32 + lane;
          vv[ch] = i < d ? vrow[i] : 0.0f;
        }
#pragma unroll
        for (int rr = 0; rr < ROWS; ++rr) {
          const float wv = __shfl_sync(0xffffffffu, lg[rr][jj], src);
#pragma unroll
          for (int ch = 0; ch < DCH; ++ch) acc[rr][ch] = fmaf(wv, vv[ch], acc[rr][ch]);
        }
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < ROWS; ++rr) {
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
    float* orow = out + ((size_t)bh * S + q0 + r) * d;
#pragma unroll
    for (int ch = 0; ch < DCH; ++ch) {
      const int i = ch * 32 + lane;
      if (i < d) orow[i] = __fmul_rn(acc[rr][ch], scale);
    }
  }
}

template <typename T, int DCH, int ROWS, int KEYS>
int launch(const void* q, const void* k, const void* v, void* out, int BH, int S,
           int Tk, int d, int BQ, int BK, int causal, int sole, int exp_bits,
           int has_snap, int exact_corr, float int8_scale, float snap_inv,
           float qk_scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) *
      ((size_t)kWarps * ROWS * d + (size_t)32 * KEYS * (d + 1) + (size_t)BK * d);
  auto kernel = flash_e2softmax_dense_kernel<T, DCH, ROWS, KEYS>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((S + BQ - 1) / BQ, BH);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<float*>(out), S, Tk, d, BQ, BK, causal, sole, exp_bits, has_snap,
      exact_corr, int8_scale, snap_inv, qk_scale);
  return (int)cudaGetLastError();
}

// float32 instantiations: d <= 64 or <= 128; tiles of up to 64 or 128 rows
// and keys.
template <typename T>
int launch_shape(const void* q, const void* k, const void* v, void* out, int BH, int S,
                 int Tk, int d, int BQ, int BK, int causal, int sole, int exp_bits,
                 int has_snap, int exact_corr, float int8_scale, float snap_inv,
                 float qk_scale, cudaStream_t stream) {
#define REPRO_DENSE_LAUNCH(DCH, ROWS, KEYS)                                              \
  return launch<T, DCH, ROWS, KEYS>(q, k, v, out, BH, S, Tk, d, BQ, BK, causal, sole,    \
                                    exp_bits, has_snap, exact_corr, int8_scale,          \
                                    snap_inv, qk_scale, stream)
  const bool small = BQ <= 64 && BK <= 64;
  if (d <= 64) {
    if (small) REPRO_DENSE_LAUNCH(2, 8, 2);
    REPRO_DENSE_LAUNCH(2, 16, 4);
  }
  if (small) REPRO_DENSE_LAUNCH(4, 8, 2);
  REPRO_DENSE_LAUNCH(4, 16, 4);
#undef REPRO_DENSE_LAUNCH
}

// -- bf16 q/k/v: tensor cores ---------------------------------------------------

constexpr int kMmaMaxWarps = kMaxBlock / 16;   // 16 query rows per warp

// Rows [0, nrows) of DP bf16 into shared rows of DP + 8: source rows
// [0, valid) of a row-major (., d) tensor, zeros past `valid` and past
// column d. vec (d % 8 == 0, 16-byte aligned base): cp.async per 16 bytes,
// each wholly inside or outside; otherwise synchronous element copies.
template <int DP>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src, int nrows, int valid,
                                           int d, int vec) {
  constexpr int kStride = DP + 8, kChunks = DP / 8;
  for (int idx = threadIdx.x; idx < nrows * kChunks; idx += blockDim.x) {
    const int r = idx / kChunks, c = (idx - r * kChunks) * 8;
    bf16* o = dst + r * kStride + c;
    if (vec) {
      const bool ok = r < valid && c < d;
      cp_async16(o, ok ? src + (size_t)r * d + c : src, ok ? 16 : 0);
    } else {
      const uint16_t* s = reinterpret_cast<const uint16_t*>(src) + (size_t)r * d;
      uint32_t w[4] = {0u, 0u, 0u, 0u};
      for (int e = 0; e < 8; ++e)
        if (r < valid && c + e < d) w[e / 2] |= (uint32_t)s[c + e] << (16 * (e % 2));
      *reinterpret_cast<uint4*>(o) = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}


// DP: head dim padded to 64 or 128; KT: 16-key tiles of the widest k-block
// (4: BK <= 64, 8: BK <= 128); every block stages and computes all KT
// tiles (zero rows past its keys, masked), so the inner loops carry no
// runtime guards and schedule as one basic block. blockDim.x = 32 *
// ceil(BQ / 16). Thread (g = lane / 4, t = lane % 4) of warp w holds rows
// q0 + 16 w + g and + 8, and of each 8-key (or 8-column) tile the columns
// 2 t and 2 t + 1: the mma.sync accumulator layout, which is also the
// A-operand layout of the following P.V product.
template <int DP, int KT>
__global__ void __launch_bounds__(kMmaMaxWarps * 32, 1)
flash_e2softmax_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, float* __restrict__ out, int S,
                           int Tk, int d, int BQ, int BK, int causal, int sole, int exp_bits,
                           int has_snap, int exact_corr, int vec, int scale_q,
                           float int8_scale, float snap_inv, float qk_scale) {
  constexpr int kStride = DP + 8;           // bf16 per shared row: 16-byte pad
  constexpr int DK = DP / 16;               // k-steps of Q.K^T
  constexpr int DN = DP / 8;                // 8-column tiles of the output
  constexpr int NT = 2 * KT;                // 8-key tiles of a k-block
  constexpr int kRows = KT * 16;            // key rows staged per k-block
  constexpr int kvTile = kRows * kStride;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nwarps = blockDim.x / 32;
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);     // nwarps * 16 rows
  bf16* Ks = Qs + nwarps * 16 * kStride;            // two stages of kRows rows
  bf16* Vs = Ks + 2 * kvTile;

  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // heaviest causal tiles first
  const int rows = min(BQ, S - q0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const float kmax = (float)((1 << exp_bits) - 1);
  const float submax = (float)((1 << (exp_bits + 2)) - 1);
  const int last_row = q0 + rows - 1;
  const int nk = (Tk + BK - 1) / BK;
  const int nblocks = causal ? min(nk, last_row / BK + 1) : nk;
  const bf16* kb = k + (size_t)bh * Tk * d;
  const bf16* vb = v + (size_t)bh * Tk * d;

  stage_rows<DP>(Qs, q + ((size_t)bh * S + q0) * d, nwarps * 16, rows, d, vec);
  auto stage_kv = [&](int j) {
    const int c0 = j * BK, valid = min(BK, Tk - c0);
    stage_rows<DP>(Ks + (j & 1) * kvTile, kb + (size_t)c0 * d, kRows, valid, d, vec);
    stage_rows<DP>(Vs + (j & 1) * kvTile, vb + (size_t)c0 * d, kRows, valid, d, vec);
  };
  stage_kv(0);
  cp_async_commit();

  const int row_a = q0 + warp * 16 + g, row_b = row_a + 8;
  uint32_t qf[DK][4];
  float acc[DN][4];
#pragma unroll
  for (int dn = 0; dn < DN; ++dn)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[dn][r] = 0.0f;
  float m_a = kNeg, m_b = kNeg, s_a = 0.0f, s_b = 0.0f;

  for (int j = 0; j < nblocks; ++j) {
    if (j + 1 < nblocks) stage_kv(j + 1);
    cp_async_commit();
    cp_async_wait<1>();                     // block j (and, at j = 0, the q tile) landed
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < DK; ++kk) {
        ldsm_x4(qf[kk], Qs + (warp * 16 + (lane & 15)) * kStride + kk * 16 + (lane >> 4) * 8);
        if (scale_q) {                      // a power of two: exact in bf16
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&qf[kk][r]));
            qf[kk][r] = pack_bf16(__fmul_rn(f.x, qk_scale), __fmul_rn(f.y, qk_scale));
          }
        }
      }
    }
    const bf16* ks = Ks + (j & 1) * kvTile;
    const bf16* vs = Vs + (j & 1) * kvTile;
    const int c0 = j * BK;
    const int valid = min(BK, Tk - c0);     // keys of this k-block

    // logits of the warp's 16 rows x the block's key tiles
    float sc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) sc[nt][r] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < DK; ++kk)
#pragma unroll
      for (int kt = 0; kt < KT; ++kt) {
        uint32_t b[4];
        ldsm_x4(b, ks + (kt * 16 + (lane & 7) + ((lane >> 4) << 3)) * kStride + kk * 16 +
                       (((lane >> 3) & 1) << 3));
        mma_bf16(sc[2 * kt], qf[kk], b[0], b[1]);
        mma_bf16(sc[2 * kt + 1], qf[kk], b[2], b[3]);
      }
    if (!scale_q) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int r = 0; r < 4; ++r) sc[nt][r] = __fmul_rn(sc[nt][r], qk_scale);
    }
    // mask (keys past the block, the causal diagonal) to -inf
    if (valid < kRows || (causal && c0 + valid - 1 > q0 + warp * 16)) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int tcol = nt * 8 + 2 * t4 + (r & 1), col = c0 + tcol;
          const int row = r < 2 ? row_a : row_b;
          if (tcol >= valid || (causal && row < col)) sc[nt][r] = -CUDART_INF_F;
        }
    }
    // row max over the whole block, then the weights
    float mx_a = kNeg, mx_b = kNeg;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      mx_a = fmaxf(mx_a, fmaxf(sc[nt][0], sc[nt][1]));
      mx_b = fmaxf(mx_b, fmaxf(sc[nt][2], sc[nt][3]));
    }
    const float mn_a = fmaxf(m_a, quad_max(mx_a)), mn_b = fmaxf(m_b, quad_max(mx_b));
    float ls_a = 0.0f, ls_b = 0.0f;
    if (sole && has_snap) {
      sole_weights<NT, true>(sc, mn_a, mn_b, snap_inv, int8_scale, kmax, ls_a, ls_b);
    } else if (sole) {
      sole_weights<NT, false>(sc, mn_a, mn_b, snap_inv, int8_scale, kmax, ls_a, ls_b);
    } else {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int r = 0; r < 4; ++r) {       // masked: exp2(-inf) = 0
          const float w = exp2f(__fmul_rn(__fsub_rn(sc[nt][r], r < 2 ? mn_a : mn_b), kLog2e));
          sc[nt][r] = w;
          if (r < 2) ls_a = __fadd_rn(ls_a, w);
          else ls_b = __fadd_rn(ls_b, w);
        }
    }
    const int quantized = sole && !exact_corr;
    const float corr_a = block_corr(m_a, mn_a, quantized, submax);
    const float corr_b = block_corr(m_b, mn_b, quantized, submax);
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
    if (sole) pv_product<DP, KT, false>(acc, sc, vs, lane);
    else pv_product<DP, KT, true>(acc, sc, vs, lane);
    __syncthreads();                        // this stage is refilled at block j + 2
  }

  const float sc_a = final_scale(s_a, sole), sc_b = final_scale(s_b, sole);
  float* ob = out + (size_t)bh * S * d;
#pragma unroll
  for (int dn = 0; dn < DN; ++dn) {
    const int col = dn * 8 + 2 * t4;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (col + e >= d) continue;
      if (row_a - q0 < rows) ob[(size_t)row_a * d + col + e] = __fmul_rn(acc[dn][e], sc_a);
      if (row_b - q0 < rows) ob[(size_t)row_b * d + col + e] = __fmul_rn(acc[dn][2 + e], sc_b);
    }
  }
}

template <int DP, int KT>
int launch_mma(const void* q, const void* k, const void* v, void* out, int BH, int S, int Tk,
               int d, int BQ, int BK, int causal, int sole, int exp_bits, int has_snap,
               int exact_corr, int vec, int scale_q, float int8_scale, float snap_inv,
               float qk_scale, cudaStream_t stream) {
  const int nwarps = (BQ + 15) / 16;
  const size_t smem = sizeof(bf16) * (DP + 8) * ((size_t)nwarps * 16 + 4 * (size_t)KT * 16);
  auto kernel = flash_e2softmax_mma_kernel<DP, KT>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((S + BQ - 1) / BQ, BH);
  kernel<<<grid, nwarps * 32, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<float*>(out), S, Tk, d, BQ, BK, causal, sole, exp_bits, has_snap, exact_corr,
      vec, scale_q, int8_scale, snap_inv, qk_scale);
  return (int)cudaGetLastError();
}

int launch_mma_shape(const void* q, const void* k, const void* v, void* out, int BH, int S,
                     int Tk, int d, int BQ, int BK, int causal, int sole, int exp_bits,
                     int has_snap, int exact_corr, float int8_scale, float snap_inv,
                     float qk_scale, cudaStream_t stream) {
  const uintptr_t align = (uintptr_t)q | (uintptr_t)k | (uintptr_t)v;
  const int vec = d % 8 == 0 && align % 16 == 0;
  int e2;
  const int scale_q = frexpf(qk_scale, &e2) == 0.5f;   // d^-1/2 a power of two
#define REPRO_MMA_LAUNCH(DP, KT)                                                          \
  return launch_mma<DP, KT>(q, k, v, out, BH, S, Tk, d, BQ, BK, causal, sole, exp_bits,   \
                            has_snap, exact_corr, vec, scale_q, int8_scale, snap_inv,     \
                            qk_scale, stream)
  if (d <= 64) {
    if (BK <= 64) REPRO_MMA_LAUNCH(64, 4);
    REPRO_MMA_LAUNCH(64, 8);
  }
  if (BK <= 64) REPRO_MMA_LAUNCH(128, 4);
  REPRO_MMA_LAUNCH(128, 8);
#undef REPRO_MMA_LAUNCH
}


}  // namespace

extern "C" {

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dtype: 0 = float32, 1 = bfloat16 (q, k and v alike). q: (BH, S, d); k, v:
// (BH, T, d); out: (BH, S, d) float32; all contiguous. Tiles of BQ query rows
// and BK keys, 1 <= BQ, BK <= 128; 1 <= d <= 128; T >= 1; BH < 65536;
// exp_bits <= 6. snap_inv = float32(1 / int8_scale). Launches on `stream`
// and returns the launch's cudaError_t (0 on success; cudaErrorInvalidValue
// for arguments it does not take).
int flash_e2softmax(const void* q, const void* k, const void* v, void* out, int BH,
                    int S, int T, int d, int BQ, int BK, int causal, int sole,
                    int exp_bits, int has_snap, int exact_corr, int dtype,
                    float int8_scale, float snap_inv, float qk_scale, void* stream) {
  if (BQ < 1 || BQ > kMaxBlock || BK < 1 || BK > kMaxBlock || d < 1 || d > 128 ||
      T < 1 || BH < 1 || BH > 65535 || S < 1 || exp_bits < 0 || exp_bits > 6)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_shape<float>(q, k, v, out, BH, S, T, d, BQ, BK, causal, sole, exp_bits,
                               has_snap, exact_corr, int8_scale, snap_inv, qk_scale, s);
  if (dtype == 1)
    return launch_mma_shape(q, k, v, out, BH, S, T, d, BQ, BK, causal, sole, exp_bits,
                            has_snap, exact_corr, int8_scale, snap_inv, qk_scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
