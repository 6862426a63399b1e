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
// tensor cores' 989 TFLOP/s. This kernel computes them with float32 FMAs
// on the CUDA cores (67 TFLOP/s at most), so it cannot come near that
// bound; it is built to be exact first.
// Design, simple and right first: the tile's q rows (pre-scaled), and each
// k-block's K (rows padded by one word against bank conflicts) and V go
// through shared memory as float32. Eight warps each own 8 or 16 query-row
// slots (interleaved); a lane holds the logits of its rows for 2 or 4 keys
// (lane + 32 j) in registers, the warp-reduced max and sum run per row, and
// w . v reads each weight from its owner lane by shuffle while each lane
// accumulates 2 or 4 head-dim columns (lane + 32 c) of every row in
// registers. Slots past the tile or the k-block hold zeros, so the inner
// loops carry no guards and their shared loads and shuffles pipeline (a
// first version that guarded every row took 3.6x as long on an H100 at
// qwen2_0_5b's 2048-token causal shape). All arithmetic is
// float32 on the CUDA cores; powers of two come exactly from ldexpf, rintf
// rounds half to even like jnp.round, and __fmul_rn/__fsub_rn keep the
// codes' inputs out of FMA contraction. Tensor-core (mma/wgmma) products,
// TMA tiles, and reading each KV head once per GQA group (the op repeats
// K/V to every query head) are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxBlock = 128;              // BQ, BK <= 128
constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kInvLn2Shift = 1.4375f;
constexpr float kAldivBias = 1.636f;
constexpr float kAldivBiasHalf = 1.136f;    // ALDIV_BIAS - 0.5 in float32

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

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

// Instantiations: d <= 64 or <= 128; tiles of up to 64 or 128 rows and keys.
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
    return launch_shape<__nv_bfloat16>(q, k, v, out, BH, S, T, d, BQ, BK, causal, sole,
                                       exp_bits, has_snap, exact_corr, int8_scale,
                                       snap_inv, qk_scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
