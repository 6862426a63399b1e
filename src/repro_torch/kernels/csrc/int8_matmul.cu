// int8 x int8 -> int32 matrix product for sm_90a.
//
// Replaces src/repro/kernels/int8_matmul.py::_mm_kernel (entry point
// int8_matmul_pallas): the W8A8 serve path's every projection and the LM
// head. (M, K) int8 row-major times (K, N) int8 row-major gives (M, N)
// int32, exact: |sum| <= K * 127^2 stays far inside int32 for the path's
// K <= 4864, and integer sums do not depend on their order, so the result
// is bit-identical to any other exact evaluation, split or not. The scales
// stay outside the kernel, as on the TPU.
//
// What bounds it on an H100: bytes. On the path M is 8 (a decode step)
// or 128 (a prefill chunk), so the weight matrix, read once, dominates:
// at M = 8 each weight byte feeds 16 int8 operations, at M = 128 it feeds
// 256, both below the card's ~590 int8 operations per byte of device
// memory. The LM head at decode moves about 136 MB, ~0.041 ms at
// 3.35 TB/s; the decode projections move 0.1-4.4 MB, 0.03-1.3 us, so
// there the floor is latency: on an NVIDIA H100 80GB HBM3 at a 700 W power
// limit a first version (one CTA per 16 x 64 tile walking K serially in
// 64-byte steps, each a global load, a barrier, a transpose and a barrier)
// took ~2 us per step, 151 us for `down`'s K = 4864 on 14 CTAs; this
// design takes 15 us there, 9-13 us for the other decode projections.
//
// Design: fill the card and keep loads in flight.
// * Split-K. The wrapper's split_plan(m, n, k) picks a tile (16 x 64 for
//   M <= 16, 64 x 64 above, 16 x 16 where N is too narrow to fill the card
//   otherwise) and a number of K splits so that the grid (N tiles, M tiles,
//   splits) has at least ~132 CTAs. Split s covers the 32-byte chunks
//   [s * chunks / splits, (s + 1) * chunks / splits) of K (chunks =
//   ceil(K / 32)), so every K index belongs to exactly one split.
// * One launch. Each split writes its int32 partial tile to a workspace
//   (fragment order, coalesced), fences, and takes a ticket from the
//   tile's counter; the CTA that draws the last ticket adds the other
//   splits' partials to its own registers, writes C and resets the
//   counter to 0 for the next call. Integer sums: whichever CTA is last,
//   the result is the same bits. One split writes C directly.
// * A 4-stage cp.async ring (16-byte cp.async.cg; 4-byte cp.async.ca where
//   N % 16 != 0) stages the raw A tile (rows padded to 80 bytes so the
//   fragment loads hit 32 banks) and the raw B tile (K x N as stored).
//   sm_90's ldmatrix cannot transpose 8-bit data and mma.sync's row.col
//   fragments want K contiguous, so each step transposes the raw B stage
//   in shared memory into [n][k] (4 x 4 byte blocks with __byte_perm)
//   while the next stages' copies are in flight, then runs
//   mma.sync.m16n8k32.row.col.s32.s8.s8.s32.
// Ragged edges (M, N, and K inside a split) load zeros, exact under
// integer sums; stores are masked. wgmma s8 (which needs B K-major in
// shared memory: an in-shared-memory transpose or a K-contiguous copy of
// the weights made once at engine build) and TMA are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBK = 64;              // K bytes per pipeline stage
constexpr int kLds = kBK + 16;       // padded [row][k] stride in bytes (80)
constexpr int kStages = 4;
constexpr int kSplitUnit = 32;       // split boundaries: multiples of 32 bytes of K

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async of 16 (or 4) bytes; src_bytes 0 writes zeros and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld_s32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <int BM, int BN, int WARPS_M, int WARPS_N>
__global__ void __launch_bounds__(WARPS_M * WARPS_N * 32)
int8_matmul_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ B,
                   int32_t* __restrict__ C, int32_t* __restrict__ ws,
                   int* __restrict__ tickets, int M, int N, int K, int vec, int splits) {
  constexpr int kThreads = WARPS_M * WARPS_N * 32;
  constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;
  constexpr int MT = WM / 16, NT = WN / 8;
  constexpr int kRegs = MT * NT * 4;        // accumulators a thread holds
  static_assert(MT >= 1 && NT >= 1 && WM % 16 == 0 && WN % 8 == 0, "tile");
  static_assert(BN % 16 == 0, "B rows are staged in 16-byte chunks");
  __shared__ __align__(16) int8_t As[kStages][BM * kLds];   // [m][k]
  __shared__ __align__(16) int8_t Bs[kStages][kBK * BN];    // [k][n], as stored
  __shared__ __align__(16) int8_t Bt[BN * kLds];            // [n][k]
  __shared__ int s_last;

  const int n_tile = blockIdx.x, m_tile = blockIdx.y, split = blockIdx.z;
  const int n0 = n_tile * BN, m0 = m_tile * BM;
  const int chunks = (K + kSplitUnit - 1) / kSplitUnit;
  const int k_lo = kSplitUnit * (int)((long long)split * chunks / splits);
  const int k_hi = min(K, kSplitUnit * (int)((long long)(split + 1) * chunks / splits));
  const int nsteps = (k_hi - k_lo + kBK - 1) / kBK;
  const bool b16 = vec && N % 16 == 0;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int g = lane >> 2, tig = lane & 3;

  // Stage `step` of this split into ring slot `st`. Bytes outside
  // [k_lo, k_hi), M or N are zeros. With vec (K % 16 == 0, N % 4 == 0,
  // 16-byte aligned bases) every 16-byte A chunk and 4-byte B word lies
  // wholly inside or outside, since k_lo and k_hi are multiples of 16.
  auto load_stage = [&](int step, int st) {
    const int k0 = k_lo + step * kBK;
    for (int c = tid; c < BM * (kBK / 16); c += kThreads) {
      const int r = c / (kBK / 16), kk = (c % (kBK / 16)) * 16;
      const int gm = m0 + r, gk = k0 + kk;
      int8_t* dst = &As[st][r * kLds + kk];
      if (vec) {
        const bool ok = gm < M && gk < k_hi;
        cp_async16(dst, ok ? A + (size_t)gm * K + gk : A, ok ? 16 : 0);
      } else {
        uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int i = 0; i < 16; ++i)
          if (gm < M && gk + i < k_hi)
            w[i / 4] |= (uint32_t)(uint8_t)A[(size_t)gm * K + gk + i] << (8 * (i % 4));
        *reinterpret_cast<int4*>(dst) = make_int4((int)w[0], (int)w[1], (int)w[2], (int)w[3]);
      }
    }
    for (int c = tid; c < kBK * (BN / 16); c += kThreads) {
      const int kk = c / (BN / 16), nn = (c % (BN / 16)) * 16;
      const int gk = k0 + kk, gn = n0 + nn;
      int8_t* dst = &Bs[st][kk * BN + nn];
      const bool row_ok = gk < k_hi;
      const int8_t* src = B + (size_t)gk * N + gn;
      if (b16) {
        const bool ok = row_ok && gn < N;
        cp_async16(dst, ok ? src : B, ok ? 16 : 0);
      } else if (vec) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const bool ok = row_ok && gn + 4 * j < N;
          cp_async4(dst + 4 * j, ok ? src + 4 * j : B, ok ? 4 : 0);
        }
      } else {
        uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int i = 0; i < 16; ++i)
          if (row_ok && gn + i < N) w[i / 4] |= (uint32_t)(uint8_t)src[i] << (8 * (i % 4));
        *reinterpret_cast<int4*>(dst) = make_int4((int)w[0], (int)w[1], (int)w[2], (int)w[3]);
      }
    }
  };

  int acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nsteps) load_stage(s, s);
    cp_async_commit();
  }
  for (int step = 0; step < nsteps; ++step) {
    cp_async_wait<kStages - 2>();           // this step's copies have landed
    __syncthreads();                        // ... for every thread; step - 1 fully consumed
    const int nxt = step + kStages - 1;
    if (nxt < nsteps) load_stage(nxt, nxt % kStages);
    cp_async_commit();

    // B stage -> Bt: a work item is a 4 (k) x 4 (n) byte block.
    const int8_t* braw = Bs[step % kStages];
    for (int c = tid; c < (kBK / 4) * (BN / 4); c += kThreads) {
      const int kk = (c / (BN / 4)) * 4, nn = (c % (BN / 4)) * 4;
      const int8_t* src = braw + kk * BN + nn;
      const uint32_t r0 = ld_s32(src), r1 = ld_s32(src + BN);
      const uint32_t r2 = ld_s32(src + 2 * BN), r3 = ld_s32(src + 3 * BN);
      const uint32_t lo01 = __byte_perm(r0, r1, 0x5140);  // r0b0 r1b0 r0b1 r1b1
      const uint32_t hi01 = __byte_perm(r0, r1, 0x7362);  // r0b2 r1b2 r0b3 r1b3
      const uint32_t lo23 = __byte_perm(r2, r3, 0x5140);
      const uint32_t hi23 = __byte_perm(r2, r3, 0x7362);
      int8_t* dst = Bt + nn * kLds + kk;
      *reinterpret_cast<uint32_t*>(dst + 0 * kLds) = __byte_perm(lo01, lo23, 0x5410);
      *reinterpret_cast<uint32_t*>(dst + 1 * kLds) = __byte_perm(lo01, lo23, 0x7632);
      *reinterpret_cast<uint32_t*>(dst + 2 * kLds) = __byte_perm(hi01, hi23, 0x5410);
      *reinterpret_cast<uint32_t*>(dst + 3 * kLds) = __byte_perm(hi01, hi23, 0x7632);
    }
    __syncthreads();

    const int8_t* as = As[step % kStages];
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 32) {
      uint32_t af[MT][4], bf[NT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int8_t* a = as + (wm * WM + i * 16 + g) * kLds + ks + tig * 4;
        af[i][0] = ld_s32(a);                 // row g,     k 0..15
        af[i][1] = ld_s32(a + 8 * kLds);      // row g + 8, k 0..15
        af[i][2] = ld_s32(a + 16);            // row g,     k 16..31
        af[i][3] = ld_s32(a + 8 * kLds + 16); // row g + 8, k 16..31
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int8_t* b = Bt + (wn * WN + j * 8 + g) * kLds + ks + tig * 4;
        bf[j][0] = ld_s32(b);                 // col g, k 0..15
        bf[j][1] = ld_s32(b + 16);            // col g, k 16..31
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_s8(acc[i][j], af[i], bf[j]);
    }
  }
  cp_async_wait<0>();

  if (splits > 1) {
    // Partial tile in fragment order: accumulator r of thread t at r *
    // kThreads + t, so each store and load below is coalesced.
    const int tile = m_tile * gridDim.x + n_tile;
    const size_t tile_ints = (size_t)kRegs * kThreads;
    int32_t* base = ws + (size_t)tile * splits * tile_ints;
    int32_t* mine = base + (size_t)split * tile_ints;
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) mine[((i * NT + j) * 4 + r) * kThreads + tid] = acc[i][j][r];
    __threadfence();                        // partial visible before the ticket
    __syncthreads();
    if (tid == 0) s_last = atomicAdd(&tickets[tile], 1) == splits - 1;
    __syncthreads();
    if (!s_last) return;
    __threadfence();                        // the other splits' partials, after their tickets
    for (int o = 0; o < splits; ++o) {
      if (o == split) continue;
      const int32_t* part = base + (size_t)o * tile_ints;
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            acc[i][j][r] += __ldcg(part + ((i * NT + j) * 4 + r) * kThreads + tid);
    }
    if (tid == 0) tickets[tile] = 0;        // ready for the next call on the stream
  }

#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int col = n0 + wn * WN + j * 8 + tig * 2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm * WM + i * 16 + g + 8 * h;
        if (row >= M) continue;
        int32_t* dst = C + (size_t)row * N + col;
        if (col < N) dst[0] = acc[i][j][2 * h];
        if (col + 1 < N) dst[1] = acc[i][j][2 * h + 1];
      }
    }
  }
}

template <int BM, int BN, int WARPS_M, int WARPS_N>
int launch(const int8_t* A, const int8_t* B, int32_t* C, int32_t* ws, int* tickets, int M,
           int N, int K, int vec, int splits, cudaStream_t stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  if (grid.y > 65535 || grid.z > 65535) return (int)cudaErrorInvalidValue;
  int8_matmul_kernel<BM, BN, WARPS_M, WARPS_N>
      <<<grid, WARPS_M * WARPS_N * 32, 0, stream>>>(A, B, C, ws, tickets, M, N, K, vec,
                                                    splits);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// a: (M, K) int8, b: (K, N) int8, c: (M, N) int32, all row-major and
// contiguous. `vec` = 1 allows 16-byte loads of a and 4-byte (16-byte
// where N % 16 == 0) loads of b: the caller sets it only when K % 16 == 0,
// N % 4 == 0 and both pointers are 16-byte aligned. `tile`: 0 = 16 x 64,
// 1 = 64 x 64, 2 = 16 x 16 output tiles. `splits` in [1, ceil(K / 32)];
// above 1, ws holds at least tiles * splits * BM * BN int32 and tickets
// one int per tile, all 0 before the first call (each call leaves them
// 0). Calls that share ws and tickets must be ordered on one stream.
// M, N, K >= 1. Launches on `stream` and returns the launch's cudaError_t
// (0 on success; cudaErrorInvalidValue for arguments it does not take).
int int8_matmul(const void* a, const void* b, void* c, void* ws, void* tickets, int M,
                int N, int K, int vec, int tile, int splits, void* stream) {
  const int chunks = (K + kSplitUnit - 1) / kSplitUnit;
  if (M < 1 || N < 1 || K < 1 || splits < 1 || splits > chunks ||
      (splits > 1 && (ws == nullptr || tickets == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* A = static_cast<const int8_t*>(a);
  const int8_t* B = static_cast<const int8_t*>(b);
  int32_t* C = static_cast<int32_t*>(c);
  int32_t* W = static_cast<int32_t*>(ws);
  int* T = static_cast<int*>(tickets);
  if (tile == 0) return launch<16, 64, 1, 4>(A, B, C, W, T, M, N, K, vec, splits, s);
  if (tile == 1) return launch<64, 64, 2, 2>(A, B, C, W, T, M, N, K, vec, splits, s);
  if (tile == 2) return launch<16, 16, 1, 2>(A, B, C, W, T, M, N, K, vec, splits, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
