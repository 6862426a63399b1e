// E2Softmax over the last axis of a (rows, C) tensor, for sm_90a.
//
// Replaces src/repro/kernels/e2softmax.py::_kernel and ::_masked_kernel
// (launched by _e2softmax_call, entry point e2softmax_pallas): every
// attention softmax of the dense-slot engine (layers.attend_dense in prefill
// and layers.decode_attend_stacked in decode, both masked).
//
// Per row of C logits (float32 or bf16 in, float32 out):
//   masked : xm = keep ? x : FLT_LOWEST,  m = max(max(xm), FLT_LOWEST / 2)
//   plain  : xm = x,                      m = max(x)
//   d  = xm - m; optional int8 snap d = clip(rint(d * (1/s)), -127, 0) * s
//        (the jitted reference multiplies by float32(1/s), XLA's rewrite of
//        its division by the static scale)
//   k  = clip(rint(-d * 1.4375), 0, 2^b - 1)        (the 4-bit log2 codes)
//   S  = sum over kept entries of 2^-k; masked: S = max(S, 2^-30)
//   out = 2^-(k + e) * (mant >= 0.75 ? 1.136 : 1.636), (mant, e) = frexp(S);
//   masked entries give exactly 0.
// Arithmetic matches the plain version bit for bit: rintf is jnp.round (half
// to even), __fdiv_rn / __fmul_rn / __fsub_rn are never contracted into an
// FMA, and powers of two are built from their exponent bits (exact). A masked
// logit's -d * 1.4375 overflows to +inf and fminf clips it to 2^b - 1.
//
// The sum: each thread adds its strided elements in index order, then a
// shuffle tree over the 32 lanes, then the warps' partial sums in warp order.
// With b = 4 every partial sum is a multiple of 2^-15 no larger than C, so
// for C <= 512 the float32 sum is exact in any order and the output equals
// the plain version's bit for bit; above that (or at b = 6) the order can
// move S by a rounding, which changes the output only when S sits at an
// ALDivision boundary (a power of two or 1.5 times one).
//
// What bounds it on an H100: bytes. Per element it reads 4 B (or 2 B) of
// logits and 1 B of mask and writes 4 B, and does ~15 operations, far below
// the card's ~295 operations per byte: the bound is the bytes at 3.35 TB/s.
// Design, simple and right first: one block per row. Where C * 5 bytes fit in
// shared memory the row is read once from device memory with 16-byte vector
// loads (when C and the pointers allow) into shared memory as float32 with
// the masked entries already replaced, and the codes are kept beside it as
// one uint8 each (the paper's 4-bit buffer; bit 7 marks a masked entry), so
// the final pass reads only the codes. Longer rows re-read the logits from
// device memory in every pass and recompute the codes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kLowest = -FLT_MAX;         // finfo(float32).min
constexpr float kInvLn2Shift = 1.4375f;     // 1 + 1/2 - 1/16
constexpr float kAldivBias = 1.636f;
constexpr float kAldivBiasHalf = 1.136f;    // ALDIV_BIAS - 0.5 in float32
constexpr uint8_t kMaskedCode = 0x80;
// Largest dynamic shared memory a block asks for (the H100 allows 227 KB).
constexpr int kMaxSmemBytes = 200 * 1024;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// Exact float32 2^e for integer e in [-126, 127].
__device__ __forceinline__ float exp2_int(int e) { return __int_as_float((e + 127) << 23); }

// 16-byte vectors of logits and the matching bytes of mask.
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int N = 4;
  using M = uint32_t;
  __device__ static void load(const float* p, float* o) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  using M = uint2;
  __device__ static void load(const __nv_bfloat16* p, float* o) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
    for (int j = 0; j < N; ++j) o[j] = __bfloat162float(h[j]);
  }
};

__device__ __forceinline__ float block_max(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float m = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) m = fmaxf(m, red[w]);
  __syncthreads();
  return m;
}

__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) s += red[w];
  return s;
}

// The code of one logit (see the header), given the row max m.
__device__ __forceinline__ int log2_code(float xm, float m, int has_snap, float snap_scale,
                                         float snap_inv, float kmax) {
  float d = __fsub_rn(xm, m);
  if (has_snap)
    d = __fmul_rn(fminf(fmaxf(rintf(__fmul_rn(d, snap_inv)), -127.0f), 0.0f), snap_scale);
  return (int)fminf(fmaxf(rintf(__fmul_rn(-d, kInvLn2Shift)), 0.0f), kmax);
}

template <typename T, bool kMasked>
__device__ __forceinline__ float load_masked(const T* xr, const uint8_t* mr, int i, bool* keep) {
  *keep = !kMasked || mr[i] != 0;
  return *keep ? to_f32(xr[i]) : kLowest;
}

template <typename T, bool kMasked, bool kSmem>
__global__ void __launch_bounds__(kThreads)
e2softmax_kernel(const T* __restrict__ x, const uint8_t* __restrict__ mask,
                 float* __restrict__ out, int c, int exp_bits, int has_snap,
                 float snap_scale, float snap_inv, int vec) {
  extern __shared__ float xs[];             // c float32 logits, then c codes
  uint8_t* codes = reinterpret_cast<uint8_t*>(xs + (kSmem ? c : 0));
  __shared__ float red[kWarps];
  const size_t row = blockIdx.x;
  const T* xr = x + row * (size_t)c;
  const uint8_t* mr = kMasked ? mask + row * (size_t)c : nullptr;
  float* orow = out + row * (size_t)c;
  const float kmax = (float)((1 << exp_bits) - 1);

  // pass 1: the (masked) row max; with shared memory, stage the row.
  float mx = kLowest;
  if (kSmem && vec) {
    constexpr int N = Vec<T>::N;
    for (int v = threadIdx.x; v < c / N; v += kThreads) {
      float f[N];
      Vec<T>::load(xr + v * N, f);
      uint8_t mb[N];
      if (kMasked) {
        const typename Vec<T>::M mm = *reinterpret_cast<const typename Vec<T>::M*>(mr + v * N);
        const uint8_t* b = reinterpret_cast<const uint8_t*>(&mm);
#pragma unroll
        for (int j = 0; j < N; ++j) mb[j] = b[j];
      }
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const bool keep = !kMasked || mb[j] != 0;
        const float xm = keep ? f[j] : kLowest;
        xs[v * N + j] = xm;
        codes[v * N + j] = keep ? 0 : kMaskedCode;
        mx = fmaxf(mx, xm);
      }
    }
  } else {
    for (int i = threadIdx.x; i < c; i += kThreads) {
      bool keep;
      const float xm = load_masked<T, kMasked>(xr, mr, i, &keep);
      if (kSmem) {
        xs[i] = xm;
        codes[i] = keep ? 0 : kMaskedCode;
      }
      mx = fmaxf(mx, xm);
    }
  }
  float m = block_max(mx, red);
  if (kMasked) m = fmaxf(m, kLowest * 0.5f);    // fully masked rows

  // pass 2: codes and the sum of 2^-k over kept entries.
  float sum = 0.0f;
  for (int i = threadIdx.x; i < c; i += kThreads) {
    bool keep;
    float xm;
    if (kSmem) {
      xm = xs[i];
      keep = codes[i] == 0;
    } else {
      xm = load_masked<T, kMasked>(xr, mr, i, &keep);
    }
    const int k = log2_code(xm, m, has_snap, snap_scale, snap_inv, kmax);
    if (kSmem) codes[i] = (uint8_t)(k | (keep ? 0 : kMaskedCode));
    if (keep) sum += exp2_int(-k);
  }
  float s = block_sum(sum, red);
  s = kMasked ? fmaxf(s, 0x1p-30f) : fmaxf(s, 1e-38f);
  int expo;
  const float mant = frexpf(s, &expo);
  const float factor = mant >= 0.75f ? kAldivBiasHalf : kAldivBias;

  // pass 3: ALDivision, one write per element.
  for (int i = threadIdx.x; i < c; i += kThreads) {
    int k;
    bool keep;
    if (kSmem) {
      const uint8_t code = codes[i];
      keep = !(code & kMaskedCode);
      k = code & 0x7f;
    } else {
      const float xm = load_masked<T, kMasked>(xr, mr, i, &keep);
      k = log2_code(xm, m, has_snap, snap_scale, snap_inv, kmax);
    }
    orow[i] = keep ? __fmul_rn(exp2_int(-(k + expo)), factor) : 0.0f;
  }
}

template <typename T, bool kMasked, bool kSmem>
int launch(const void* x, const void* mask, void* out, int rows, int c, int exp_bits,
           int has_snap, float snap_scale, float snap_inv, int vec, cudaStream_t stream) {
  const size_t smem = kSmem ? (size_t)c * (sizeof(float) + 1) : 0;
  auto kern = e2softmax_kernel<T, kMasked, kSmem>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<rows, kThreads, smem, stream>>>(static_cast<const T*>(x),
                                         static_cast<const uint8_t*>(mask),
                                         static_cast<float*>(out), c, exp_bits, has_snap,
                                         snap_scale, snap_inv, vec);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, const void* mask, void* out, int rows, int c, int exp_bits,
             int has_snap, float snap_scale, float snap_inv, int vec, cudaStream_t stream) {
  const bool smem = (size_t)c * (sizeof(float) + 1) <= (size_t)kMaxSmemBytes;
  if (mask != nullptr) {
    return smem ? launch<T, true, true>(x, mask, out, rows, c, exp_bits, has_snap, snap_scale,
                                        snap_inv, vec, stream)
                : launch<T, true, false>(x, mask, out, rows, c, exp_bits, has_snap,
                                         snap_scale, snap_inv, vec, stream);
  }
  return smem ? launch<T, false, true>(x, mask, out, rows, c, exp_bits, has_snap, snap_scale,
                                       snap_inv, vec, stream)
              : launch<T, false, false>(x, mask, out, rows, c, exp_bits, has_snap, snap_scale,
                                        snap_inv, vec, stream);
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x: (rows, c) float32 (x_type 0) or bf16 (x_type 1), contiguous; mask:
// (rows, c) uint8/bool contiguous, or null for the unmasked variant; out:
// (rows, c) float32. vec = 1 when c is a multiple of the 16-byte vector
// (4 float32, 8 bf16) and x (16 B) and mask (vector width) are aligned.
// snap_inv = float32(1 / snap_scale). Launches on `stream`; returns the
// cudaError_t of the launch (0 on success).
int e2softmax(const void* x, const void* mask, void* out, int rows, int c, int exp_bits,
              int has_snap, int x_type, int vec, float snap_scale, float snap_inv,
              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_type == 1)
    return dispatch<__nv_bfloat16>(x, mask, out, rows, c, exp_bits, has_snap, snap_scale,
                                   snap_inv, vec, s);
  return dispatch<float>(x, mask, out, rows, c, exp_bits, has_snap, snap_scale, snap_inv, vec,
                         s);
}

}  // extern "C"
