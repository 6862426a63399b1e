// Device helpers shared by the dense and the paged Flash-E2Softmax kernels
// (flash_e2softmax.cu, paged_e2softmax.cu): the SOLE constants, warp
// reductions, and the bf16 tensor-core pieces (cp.async, ldmatrix,
// mma.sync.m16n8k16 bf16 -> float32, the SOLE weights of a logits tile in
// the accumulator layout, the per-block correction, ALDivision and P.V).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kInvLn2Shift = 1.4375f;
constexpr float kAldivBias = 1.636f;
constexpr float kAldivBiasHalf = 1.136f;    // ALDIV_BIAS - 0.5 in float32

__device__ __forceinline__ float to_f32(float v) { return v; }

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

__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(int8_t v) { return (float)v; }

// -- bf16 tensor cores ---------------------------------------------------------

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte cp.async; src_bytes 0 writes zeros and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}

// c += a . b: a 16 x 16 bf16 (row), b 16 x 8 bf16 (col), c 16 x 8 float32.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats as a bf16 pair, round to nearest; `lo` in the low half (the
// smaller column of an mma fragment).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// rint(x) (half to even) with two full-rate adds: exact for |x| < 2^22;
// beyond, a value as far out, which the callers' clamps treat alike.
__device__ __forceinline__ float round_even(float x) {
  return __fsub_rn(__fadd_rn(x, 12582912.0f), 12582912.0f);   // 1.5 * 2^23
}

// The SOLE weights of a block's logits in place (masked, -inf: 0) and
// their row sums. w = 2^-kc, built from the exponent bits: kc + 2^23
// holds the integer kc in its low mantissa bits.
template <int NT, bool SNAP>
__device__ __forceinline__ void sole_weights(float (&sc)[NT][4], float mn_a, float mn_b,
                                             float snap_inv, float int8_scale, float kmax,
                                             float& ls_a, float& ls_b) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float x = sc[nt][r];
      float dm = __fsub_rn(x, r < 2 ? mn_a : mn_b);
      if (SNAP)
        dm = __fmul_rn(fminf(fmaxf(round_even(__fmul_rn(dm, snap_inv)), -127.0f), 0.0f),
                       int8_scale);
      const float kc = fminf(fmaxf(round_even(__fmul_rn(-dm, kInvLn2Shift)), 0.0f), kmax);
      const int bits = __float_as_int(__fadd_rn(kc, 8388608.0f));   // 0x4B000000 + kc
      const float w = x == -CUDART_INF_F ? 0.0f : __int_as_float((0x4B00007F - bits) << 23);
      sc[nt][r] = w;
      if (r < 2) ls_a = __fadd_rn(ls_a, w);
      else ls_b = __fadd_rn(ls_b, w);
    }
}

__device__ __forceinline__ float block_corr(float m_prev, float m_new, int quantized,
                                            float submax) {
  if (quantized) {
    const float sub = fminf(fmaxf(rintf(__fmul_rn(__fsub_rn(m_new, m_prev), kInvLn2Shift)),
                                  0.0f), submax);
    return ldexpf(1.0f, -(int)sub);
  }
  return exp2f(__fmul_rn(__fsub_rn(m_prev, m_new), kLog2e));
}

__device__ __forceinline__ float final_scale(float s, int sole) {
  s = fmaxf(s, 9.313225746154785e-10f);     // 2^-30
  if (!sole) return __fdiv_rn(1.0f, s);
  int e;
  const float mant = frexpf(s, &e);
  return ldexpf(mant >= 0.75f ? kAldivBiasHalf : kAldivBias, -e);
}

// acc += P . V over the block's KT 16-key tiles: P from the logits'
// accumulator layout as bf16 A fragments; V fragments by ldmatrix.trans.
// SPLIT (exact mode): P = bf16(P) + bf16(P - bf16(P)), two products.
template <int DP, int KT, bool SPLIT>
__device__ __forceinline__ void pv_product(float (&acc)[DP / 8][4], const float (&sc)[2 * KT][4],
                                           const bf16* vs, int lane) {
  constexpr int kStride = DP + 8;
#pragma unroll
  for (int kt = 0; kt < KT; ++kt) {
    const float* p0 = sc[2 * kt];
    const float* p1 = sc[2 * kt + 1];
    const uint32_t a[4] = {pack_bf16(p0[0], p0[1]), pack_bf16(p0[2], p0[3]),
                           pack_bf16(p1[0], p1[1]), pack_bf16(p1[2], p1[3])};
    uint32_t lo[4];
    if (SPLIT) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float* p = r < 2 ? p0 : p1;
        const int c = (r & 1) * 2;
        const float2 h = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&a[r]));
        lo[r] = pack_bf16(__fsub_rn(p[c], h.x), __fsub_rn(p[c + 1], h.y));
      }
    }
#pragma unroll
    for (int dp = 0; dp < DP / 16; ++dp) {
      uint32_t b[4];
      ldsm_x4_trans(b, vs + (kt * 16 + (lane & 7) + (((lane >> 3) & 1) << 3)) * kStride +
                           dp * 16 + ((lane >> 4) << 3));
      mma_bf16(acc[2 * dp], a, b[0], b[1]);
      mma_bf16(acc[2 * dp + 1], a, b[2], b[3]);
      if (SPLIT) {
        mma_bf16(acc[2 * dp], lo, b[0], b[1]);
        mma_bf16(acc[2 * dp + 1], lo, b[2], b[3]);
      }
    }
  }
}
}  // namespace
