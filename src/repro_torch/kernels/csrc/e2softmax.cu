// E2Softmax over the last axis of a (rows, C) view, for sm_90a.
//
// Replaces src/repro/kernels/e2softmax.py::_kernel and ::_masked_kernel
// (launched by _e2softmax_call, entry point e2softmax_pallas): every
// attention softmax of the dense-slot engine (layers.attend_dense in prefill
// and layers.decode_attend_stacked in decode, both masked). With int8_scale
// and a bf16 output it is also the XLA ops around that Pallas call on the
// dense path (repro/models/layers.py:353-356 and 628-631: the masked max, the
// subtraction, the int8 snap of the difference, the cast of the result), so
// the path's SOLE probabilities are one launch.
//
// Per row of C logits (float32 or bf16 in, float32 or bf16 out):
//   masked : xm = keep ? x : FLT_LOWEST,  m = max(max(xm), FLT_LOWEST / 2)
//   plain  : xm = x,                      m = max(x)
//   d  = xm - m; optional int8 snap d = clip(rint(d * (1/s)), -127, 0) * s
//        (the jitted reference multiplies by float32(1/s), XLA's rewrite of
//        its division by the static scale)
//   k  = clip(rint(-d * 1.4375), 0, 2^b - 1)        (the 4-bit log2 codes)
//   S  = sum over kept entries of 2^-k; masked: S = max(S, 2^-30)
//   out = 2^-(k + e) * (mant >= 0.75 ? 1.136 : 1.636), (mant, e) = frexp(S);
//   masked entries give exactly 0; a bf16 output is that float32 value
//   rounded once by __float2bfloat16_rn (torch's .to(torch.bfloat16)).
// Arithmetic matches the plain version bit for bit: rintf is jnp.round (half
// to even), __fdiv_rn / __fmul_rn / __fsub_rn are never contracted into an
// FMA, and powers of two are built from their exponent bits (exact). A masked
// logit's -d * 1.4375 overflows to +inf and fminf clips it to 2^b - 1.
//
// Why the fold changes no result: for a row with a kept entry the masked max
// here is the path's max m; the path's snapped differences are <= 0 with one
// exactly 0 (the max entry), so its second max, inside the op, is 0 and
// subtracting it changes nothing; a fully masked row gives zeros both ways.
//
// The sum: each lane adds its elements in index order, then a shuffle tree
// over the 32 lanes (and, in the block body, the warps' partial sums in warp
// order). With b = 4 every partial sum is a multiple of 2^-15 no larger than
// C, so for C <= 512 the float32 sum is exact in any order and the output
// equals the plain version's bit for bit; above that (C > 512, or b = 6) the
// order can move S by a rounding, which changes the output only when S sits
// at an ALDivision boundary (a power of two or 1.5 times one): a row then
// differs from the plain one by one constant ratio.
//
// Layout: the logits and the mask are (rows, C) views given by four leading
// sizes (n0 implied by rows) and four element strides each, any of which may
// be 0 (a mask broadcast over heads or lanes is read in place, never copied),
// and a unit column stride; the output is contiguous (rows, C).
//
// What bounds it on an H100: bytes. Per element it reads 4 B (or 2 B) of
// logits and at most 1 B of mask (a broadcast mask is read once per distinct
// row) and writes 4 B or 2 B, and does ~16 operations, far below the card's
// ~295 operations per byte. The dense path's decode call (112 rows x 385)
// moves ~301 KB (float32 in, mask once, bf16 out): 0.09 us at 3.35 TB/s, so
// it is latency-bound and the aim is one short pass per warp; its prefill
// call (33,600 x 300) moves 40.3 MB of logits, 0.72 MB of broadcast mask and
// 20.2 MB of bf16 output: 0.018 ms.
// Design. Rows of C <= 1024 (every model shape): one warp per row, four rows
// per CTA, a persistent grid (as many CTAs as the card holds at once) whose
// warps walk the rows with the next row's loads in flight during the
// current row's arithmetic. A lane holds ceil(C/32) logits in registers (lane i reads elements
// i + 32 j, or 16-byte vectors where C, the strides and the pointers allow),
// all its loads in flight at once (no guard between them), the max and the
// sum are warp shuffles with no __syncthreads, and the codes stay in
// registers between the sum and the write: one read of the row and one
// write. At the prefill shape the warp body is bound by issue slots before
// bytes (~30 instructions per logit slot), so it spends few: two warps per
// CTA, a lane width that fits C (12 logits at C = 300), codes through a
// 128-entry table of the snapped integer, __float2int_rn for round and
// convert, and multiply-high division for the row's leading indices. Longer rows: one 256-thread block per row; where C * 5 bytes fit
// in shared memory the row is staged there once as float32 (masked entries
// already replaced) with one uint8 code per element (bit 7 marks a masked
// entry), so the final pass reads only the codes; longer rows re-read the
// logits from device memory in every pass and recompute the codes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;               // block body: one row per block
constexpr int kWarps = kThreads / 32;
constexpr int kRowWarps = 2;                // warp body: rows (warps) per CTA
constexpr int kMaxWarpCols = 1024;          // warp body: up to 32 logits a lane
constexpr float kLowest = -FLT_MAX;         // finfo(float32).min
constexpr float kInvLn2Shift = 1.4375f;     // 1 + 1/2 - 1/16
constexpr float kAldivBias = 1.636f;
constexpr float kAldivBiasHalf = 1.136f;    // ALDIV_BIAS - 0.5 in float32
constexpr uint8_t kMaskedCode = 0x80;
// Largest dynamic shared memory a block asks for (the H100 allows 227 KB).
constexpr int kMaxSmemBytes = 200 * 1024;

// Division of a non-negative int by a fixed d >= 1 as a multiply-high and a
// shift (the round-up magic number of d, exact for dividends below 2^31).
struct FastDiv {
  int d;
  unsigned mul;
  int shift;
};

FastDiv fast_div(int d) {
  FastDiv f{d, 0u, 0};
  if (d > 1) {
    const int l = 32 - __builtin_clz((unsigned)(d - 1));     // ceil(log2 d)
    f.mul = (unsigned)(((1ull << (31 + l)) + (unsigned)d - 1) / (unsigned)d);
    f.shift = l - 1;
  }
  return f;
}

__device__ __forceinline__ int div_by(int n, const FastDiv& f) {
  return f.d == 1 ? n : (int)(__umulhi((unsigned)n, f.mul) >> f.shift);
}

// The (rows, C) views of the logits and the mask: row r has leading indices
// (i0, i1, i2, i3) with r = ((i0 * n1 + i1) * n2 + i2) * n3 + i3.
struct Rows {
  FastDiv n1, n2, n3;
  long long xs[4], ms[4];                   // element strides, x and mask
};

__device__ __forceinline__ void row_offsets(const Rows& v, int r, long long* xo,
                                            long long* mo) {
  int q = div_by(r, v.n3);
  const int i3 = r - q * v.n3.d;
  r = q;
  q = div_by(r, v.n2);
  const int i2 = r - q * v.n2.d;
  r = q;
  const int i0 = div_by(r, v.n1);
  const int i1 = r - i0 * v.n1.d;
  *xo = i0 * v.xs[0] + i1 * v.xs[1] + i2 * v.xs[2] + i3 * v.xs[3];
  *mo = i0 * v.ms[0] + i1 * v.ms[1] + i2 * v.ms[2] + i3 * v.ms[3];
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// Exact float32 2^e for integer e in [-126, 127].
__device__ __forceinline__ float exp2_int(int e) { return __int_as_float((e + 127) << 23); }

// V consecutive elements of T as float32: one 16-byte load when V > 1.
template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* p, float* f) {
  if constexpr (V == 1) {
    f[0] = to_f32(*p);
  } else {
    static_assert(V * sizeof(T) == 16, "16-byte vectors");
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int j = 0; j < V; ++j) f[j] = to_f32(e[j]);
  }
}

// V consecutive mask bytes (V-byte aligned when V > 1).
template <int V>
__device__ __forceinline__ void load_bytes(const uint8_t* p, uint8_t* b) {
  if constexpr (V == 1) {
    b[0] = *p;
  } else if constexpr (V == 4) {
    const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = (w >> (8 * j)) & 0xff;
  } else {
    static_assert(V == 8, "4 or 8 mask bytes");
    const uint2 w = *reinterpret_cast<const uint2*>(p);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      b[j] = (w.x >> (8 * j)) & 0xff;
      b[4 + j] = (w.y >> (8 * j)) & 0xff;
    }
  }
}

__device__ __forceinline__ uint32_t pack_bf16x2(float a, float b) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(a)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(b)) << 16);
}

// V consecutive outputs: float4 or packed bf16 stores when V > 1.
template <int V>
__device__ __forceinline__ void store_vec(float* p, const float* f) {
  if constexpr (V == 1) {
    *p = f[0];
  } else {
#pragma unroll
    for (int w = 0; w < V / 4; ++w)
      reinterpret_cast<float4*>(p)[w] =
          make_float4(f[4 * w], f[4 * w + 1], f[4 * w + 2], f[4 * w + 3]);
  }
}

template <int V>
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float* f) {
  if constexpr (V == 1) {
    *p = __float2bfloat16_rn(f[0]);
  } else if constexpr (V == 4) {
    *reinterpret_cast<uint2*>(p) = make_uint2(pack_bf16x2(f[0], f[1]), pack_bf16x2(f[2], f[3]));
  } else {
    static_assert(V == 8, "4 or 8 bf16 outputs");
    *reinterpret_cast<uint4*>(p) = make_uint4(pack_bf16x2(f[0], f[1]), pack_bf16x2(f[2], f[3]),
                                              pack_bf16x2(f[4], f[5]), pack_bf16x2(f[6], f[7]));
  }
}

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

__device__ __forceinline__ float block_max(float v, float* red) {
  v = warp_max(v);
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
  v = warp_sum(v);
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

// The row's ALDivision: the clamped sum's exponent and factor.
template <bool kMasked>
__device__ __forceinline__ float aldiv_factor(float s, int* expo) {
  s = kMasked ? fmaxf(s, 0x1p-30f) : fmaxf(s, 1e-38f);
  const float mant = frexpf(s, expo);
  return mant >= 0.75f ? kAldivBiasHalf : kAldivBias;
}

// Warp body: one warp per row of c <= 32 * kPer logits, kPer a lane; a
// persistent grid, each warp walking rows with the next row's loads in
// flight during the current row's arithmetic.
template <typename T, typename O, bool kMasked, int kPer, bool kVec>
__global__ void __launch_bounds__(kRowWarps * 32)
e2softmax_warp_kernel(const T* __restrict__ x, const uint8_t* __restrict__ mask,
                      O* __restrict__ out, Rows lay, int rows, int c, int exp_bits,
                      int has_snap, float snap_scale, float snap_inv) {
  constexpr int V = kVec ? 16 / (int)sizeof(T) : 1;   // elements per load
  constexpr int J = kPer / V;                          // loads per lane
  static_assert(kPer % V == 0 && kPer <= 32, "a lane's logits");
  const int lane = threadIdx.x % 32;
  const int step = gridDim.x * kRowWarps;
  int row = blockIdx.x * kRowWarps + threadIdx.x / 32;
  const int kmax = (1 << exp_bits) - 1;
  // with the snap, a code depends only on the snapped integer n in
  // [-127, 0]: the CTA tabulates it once at -n with log2_code's operations
  // (rint(-(n * s) * 1.4375) clipped, where -(n * s) = (-n) * s exactly:
  // log2_code(0, m) rounds m * 1.4375), so each element needs a multiply, a
  // round-to-int and a byte from shared memory (128 bytes, one word per
  // bank: conflict-free)
  __shared__ uint8_t snap_code[128];
  for (int i = threadIdx.x; i < 128; i += kRowWarps * 32)
    snap_code[i] = (uint8_t)log2_code(0.0f, __fmul_rn((float)i, snap_scale), 0, 0.0f, 0.0f,
                                      (float)kmax);
  __syncthreads();
  if (row >= rows) return;                             // the whole warp

  // one read of a row, every load issued before any is used: a lane past
  // the row's end reads the row's first element (an in-row address), so
  // the loads need no branch that would wait for the one before
  float nv[kPer];
  uint8_t nm[kPer];
  auto load_row = [&](int rw) {
    long long xo, mo;
    row_offsets(lay, rw, &xo, &mo);
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int e0 = (lane + 32 * j) * V;
      const int src = e0 < c ? e0 : 0;
      load_vec<T, V>(x + xo + src, nv + j * V);
      if (kMasked) load_bytes<V>(mask + mo + src, nm + j * V);
    }
  };
  load_row(row);

  for (; row < rows; row += step) {
    // the (masked) logits, and a bit per element that is in the row and kept
    float v[kPer];
    uint32_t keep = 0;
    float mx = kLowest;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const bool in = (lane + 32 * j) * V < c;   // with vectors c % V == 0
#pragma unroll
      for (int u = 0; u < V; ++u) {
        const int e = j * V + u;
        const bool k = in && (!kMasked || nm[e] != 0);
        v[e] = k ? nv[e] : kLowest;
        keep |= (k ? 1u : 0u) << e;
        mx = fmaxf(mx, v[e]);
      }
    }
    if (row + step < rows) load_row(row + step);
    float m = warp_max(mx);
    if (kMasked) m = fmaxf(m, kLowest * 0.5f);         // fully masked rows

    // the codes: __float2int_rn is rintf and the int conversion in one
    // (saturating where rintf's value is out of int range, which the
    // clamps then treat alike)
    int code[kPer];
    float sum = 0.0f;
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const float d = __fsub_rn(v[e], m);
      if (has_snap) {
        const int n = min(max(__float2int_rn(__fmul_rn(d, snap_inv)), -127), 0);
        code[e] = snap_code[-n];
      } else {
        code[e] = min(max(__float2int_rn(__fmul_rn(-d, kInvLn2Shift)), 0), kmax);
      }
      if ((keep >> e) & 1u) sum += exp2_int(-code[e]);
    }
    int expo;
    const float factor = aldiv_factor<kMasked>(warp_sum(sum), &expo);

    O* orow = out + (size_t)row * c;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int e0 = (lane + 32 * j) * V;
      if (e0 < c) {
        float o[V];
#pragma unroll
        for (int u = 0; u < V; ++u) {
          const int e = j * V + u;
          o[u] = ((keep >> e) & 1u) ? __fmul_rn(exp2_int(-(code[e] + expo)), factor) : 0.0f;
        }
        store_vec<V>(orow + e0, o);
      }
    }
  }
}

template <typename T, bool kMasked>
__device__ __forceinline__ float load_masked(const T* xr, const uint8_t* mr, int i, bool* keep) {
  *keep = !kMasked || mr[i] != 0;
  return *keep ? to_f32(xr[i]) : kLowest;
}

// Block body: one 256-thread block per row of any length.
template <typename T, typename O, bool kMasked, bool kSmem>
__global__ void __launch_bounds__(kThreads)
e2softmax_kernel(const T* __restrict__ x, const uint8_t* __restrict__ mask,
                 O* __restrict__ out, Rows lay, int c, int exp_bits, int has_snap,
                 float snap_scale, float snap_inv, int vec) {
  extern __shared__ float xs[];             // c float32 logits, then c codes
  uint8_t* codes = reinterpret_cast<uint8_t*>(xs + (kSmem ? c : 0));
  __shared__ float red[kWarps];
  const int row = blockIdx.x;
  long long xo, mo;
  row_offsets(lay, row, &xo, &mo);
  const T* xr = x + xo;
  const uint8_t* mr = kMasked ? mask + mo : nullptr;
  O* orow = out + (size_t)row * c;
  const float kmax = (float)((1 << exp_bits) - 1);

  // pass 1: the (masked) row max; with shared memory, stage the row.
  float mx = kLowest;
  if (kSmem && vec) {
    constexpr int N = 16 / (int)sizeof(T);   // a 16-byte vector of logits
    for (int v = threadIdx.x; v < c / N; v += kThreads) {
      float f[N];
      load_vec<T, N>(xr + v * N, f);
      uint8_t mb[N];
      if (kMasked) load_bytes<N>(mr + v * N, mb);
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
  int expo;
  const float factor = aldiv_factor<kMasked>(block_sum(sum, red), &expo);

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
    store1(orow + i, keep ? __fmul_rn(exp2_int(-(k + expo)), factor) : 0.0f);
  }
}

struct Args {
  const void* x;
  const void* mask;
  void* out;
  Rows lay;
  int rows, c, exp_bits, has_snap, vec;
  float snap_scale, snap_inv;
  cudaStream_t stream;
};

// SMs of the current device (cached per device).
int sm_count(int* sms) {
  static int cache[64] = {0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  int& n = cache[dev & 63];
  if (n == 0) {
    e = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
  }
  *sms = n;
  return 0;
}

template <typename T, typename O, bool kMasked, int kPer, bool kVec>
int launch_warp(const Args& a) {
  auto kern = e2softmax_warp_kernel<T, O, kMasked, kPer, kVec>;
  // a persistent grid: as many CTAs as the card holds at once (found once
  // per instantiation), fewer where the rows are fewer
  static int occ = 0;
  if (occ == 0) {
    cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kern, kRowWarps * 32, 0);
    if (e != cudaSuccess) return (int)e;
  }
  int sms;
  const int e = sm_count(&sms);
  if (e) return e;
  const int want = (a.rows + kRowWarps - 1) / kRowWarps;
  const int cap = sms * (occ > 0 ? occ : 1);
  const int grid = want < cap ? want : cap;
  kern<<<grid, kRowWarps * 32, 0, a.stream>>>(
      static_cast<const T*>(a.x), static_cast<const uint8_t*>(a.mask), static_cast<O*>(a.out),
      a.lay, a.rows, a.c, a.exp_bits, a.has_snap, a.snap_scale, a.snap_inv);
  return (int)cudaGetLastError();
}

template <typename T, typename O, bool kMasked, int kPer>
int launch_warp_vec(const Args& a) {
  if constexpr (kPer % (16 / sizeof(T)) == 0) {
    if (a.vec) return launch_warp<T, O, kMasked, kPer, true>(a);
  }
  return launch_warp<T, O, kMasked, kPer, false>(a);
}

// The lane's width: the fewest of 4, 8, 12, 16, 24, 32 logits that cover
// the row (in whole vectors with vec), so no lane computes codes for slots
// a narrower width would not have.
template <typename T, typename O, bool kMasked>
int launch_row(const Args& a) {
  const int v = a.vec ? 16 / (int)sizeof(T) : 1;
  const int need = (a.c + 32 * v - 1) / (32 * v) * v;
  if (need <= 4) return launch_warp_vec<T, O, kMasked, 4>(a);
  if (need <= 8) return launch_warp_vec<T, O, kMasked, 8>(a);
  if (need <= 12) return launch_warp_vec<T, O, kMasked, 12>(a);
  if (need <= 16) return launch_warp_vec<T, O, kMasked, 16>(a);
  if (need <= 24) return launch_warp_vec<T, O, kMasked, 24>(a);
  return launch_warp_vec<T, O, kMasked, 32>(a);
}

template <typename T, typename O, bool kMasked, bool kSmem>
int launch_block(const Args& a) {
  const size_t smem = kSmem ? (size_t)a.c * (sizeof(float) + 1) : 0;
  auto kern = e2softmax_kernel<T, O, kMasked, kSmem>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<a.rows, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.x), static_cast<const uint8_t*>(a.mask), static_cast<O*>(a.out),
      a.lay, a.c, a.exp_bits, a.has_snap, a.snap_scale, a.snap_inv, a.vec);
  return (int)cudaGetLastError();
}

template <typename T, typename O, bool kMasked>
int dispatch_mask(const Args& a) {
  if (a.c <= kMaxWarpCols) return launch_row<T, O, kMasked>(a);
  if ((size_t)a.c * (sizeof(float) + 1) <= (size_t)kMaxSmemBytes)
    return launch_block<T, O, kMasked, true>(a);
  return launch_block<T, O, kMasked, false>(a);
}

template <typename T, typename O>
int dispatch(const Args& a) {
  return a.mask != nullptr ? dispatch_mask<T, O, true>(a) : dispatch_mask<T, O, false>(a);
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x: a (rows, c) view of float32 (x_type 0) or bf16 (x_type 1) logits with
// unit column stride and leading sizes (rows / (n1 n2 n3), n1, n2, n3) of
// element strides xs0..xs3; mask: uint8/bool with the same sizes and strides
// ms0..ms3 (any may be 0), or null for the unmasked variant; out: contiguous
// (rows, c) float32 (out_type 0) or bf16 (out_type 1). vec = 1 when c and
// every non-zero stride are multiples of the 16-byte vector (4 float32, 8
// bf16) and x (16 B), the mask (vector width) and out (16 B) are aligned.
// snap_inv = float32(1 / snap_scale). Launches on `stream`; returns the
// cudaError_t of the launch (0 on success).
int e2softmax(const void* x, const void* mask, void* out, int rows, int c, int exp_bits,
              int has_snap, int x_type, int out_type, int vec, int n1, int n2, int n3,
              int xs0, int xs1, int xs2, int xs3, int ms0, int ms1, int ms2, int ms3,
              float snap_scale, float snap_inv, void* stream) {
  Args a;
  a.x = x;
  a.mask = mask;
  a.out = out;
  a.lay.n1 = fast_div(n1);
  a.lay.n2 = fast_div(n2);
  a.lay.n3 = fast_div(n3);
  const int xs[4] = {xs0, xs1, xs2, xs3}, ms[4] = {ms0, ms1, ms2, ms3};
  for (int i = 0; i < 4; ++i) {
    a.lay.xs[i] = xs[i];
    a.lay.ms[i] = ms[i];
  }
  a.rows = rows;
  a.c = c;
  a.exp_bits = exp_bits;
  a.has_snap = has_snap;
  a.vec = vec;
  a.snap_scale = snap_scale;
  a.snap_inv = snap_inv;
  a.stream = static_cast<cudaStream_t>(stream);
  if (x_type == 0 && out_type == 0) return dispatch<float, float>(a);
  if (x_type == 0 && out_type == 1) return dispatch<float, __nv_bfloat16>(a);
  if (x_type == 1 && out_type == 0) return dispatch<__nv_bfloat16, float>(a);
  if (x_type == 1 && out_type == 1) return dispatch<__nv_bfloat16, __nv_bfloat16>(a);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
