// int8 x int8 -> int32 matrix product for sm_90a.
//
// Replaces src/repro/kernels/int8_matmul.py::_mm_kernel (entry point
// int8_matmul_pallas): the W8A8 serve path's every projection and the LM
// head. (M, K) int8 row-major times (K, N) int8 row-major gives (M, N)
// int32, exact: |sum| <= K * 127^2 stays far inside int32 for the path's
// K <= 4864, and integer sums do not depend on their order, so the result
// is bit-identical to any other exact evaluation. The scales stay outside
// the kernel, as on the TPU.
//
// What bounds it on an H100: bytes. On the path M is 8 (a decode step)
// or 128 (a prefill chunk), so the weight matrix, read once, dominates:
// at M = 8 each weight byte feeds 16 int8 operations, at M = 128 it feeds
// 256, both below the card's ~590 int8 operations per byte of device
// memory. The LM head at decode moves about 136 MB, ~0.041 ms at
// 3.35 TB/s.
//
// Design, simple and right first: one block of 4 warps per BM x BN output
// tile, N tiles on gridDim.x (the head's 151,936 columns would overflow
// gridDim.y at narrow tiles). Per 64-deep K step the block stages the A
// tile and the B tile in shared memory, B transposed as it is stored (a
// thread loads a 4x4 byte block with four 32-bit loads and permutes it
// with __byte_perm), so both tiles hold K contiguously, as the tensor
// core's row.col fragments want. Each warp then runs
// mma.sync.m16n8k32.row.col.s32.s8.s8.s32 on its sub-tile. Rows are
// padded to 80 bytes so fragment loads hit 32 distinct banks. Ragged
// edges load zeros (exact under integer sums) and stores are masked. There
// is no software pipelining: latency is hidden by many small blocks per SM
// (6.4 KB or 10 KB of shared memory each). wgmma, TMA and a multi-stage
// ring are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBK = 64;              // K bytes per stage
constexpr int kLds = kBK + 16;       // shared row stride in bytes (80)

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

// Four bytes of row `gk` of B starting at column `gn`, zero past the edges.
__device__ __forceinline__ uint32_t load_b_word(const int8_t* __restrict__ B, int K,
                                                int N, int gk, int gn, int vec) {
  if (gk >= K) return 0u;
  const int8_t* src = B + (size_t)gk * N + gn;
  if (vec && gn + 4 <= N) return *reinterpret_cast<const uint32_t*>(src);
  uint32_t w = 0u;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (gn + j < N) w |= (uint32_t)(uint8_t)src[j] << (8 * j);
  return w;
}

template <int BM, int BN, int WARPS_M, int WARPS_N>
__global__ void __launch_bounds__(WARPS_M * WARPS_N * 32)
int8_matmul_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ B,
                   int32_t* __restrict__ C, int M, int N, int K, int vec) {
  constexpr int kThreads = WARPS_M * WARPS_N * 32;
  constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;
  constexpr int MT = WM / 16, NT = WN / 8;
  static_assert(MT >= 1 && NT >= 1 && WM % 16 == 0 && WN % 8 == 0, "tile");
  __shared__ __align__(16) int8_t As[BM * kLds];   // [m][k]
  __shared__ __align__(16) int8_t Bs[BN * kLds];   // [n][k]

  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int g = lane >> 2, tig = lane & 3;

  int acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    // A tile: BM rows of kBK bytes, 16 bytes per work item.
    for (int c = threadIdx.x; c < BM * (kBK / 16); c += kThreads) {
      const int r = c / (kBK / 16), kk = (c % (kBK / 16)) * 16;
      const int gm = m0 + r, gk = k0 + kk;
      int4 v = make_int4(0, 0, 0, 0);
      if (gm < M) {
        const int8_t* src = A + (size_t)gm * K + gk;
        if (vec && gk + 16 <= K) {
          v = *reinterpret_cast<const int4*>(src);
        } else {
          uint32_t w[4] = {0u, 0u, 0u, 0u};
          for (int i = 0; i < 16 && gk + i < K; ++i)
            w[i / 4] |= (uint32_t)(uint8_t)src[i] << (8 * (i % 4));
          v = make_int4((int)w[0], (int)w[1], (int)w[2], (int)w[3]);
        }
      }
      *reinterpret_cast<int4*>(As + r * kLds + kk) = v;
    }
    // B tile: kBK rows (k) x BN columns (n), stored transposed as [n][k].
    // A work item is a 4 (k) x 4 (n) byte block; neighbouring threads take
    // neighbouring column quads, so each row's loads are coalesced.
    for (int c = threadIdx.x; c < (kBK / 4) * (BN / 4); c += kThreads) {
      const int kk = (c / (BN / 4)) * 4, nn = (c % (BN / 4)) * 4;
      const int gn = n0 + nn;
      const uint32_t r0 = load_b_word(B, K, N, k0 + kk + 0, gn, vec);
      const uint32_t r1 = load_b_word(B, K, N, k0 + kk + 1, gn, vec);
      const uint32_t r2 = load_b_word(B, K, N, k0 + kk + 2, gn, vec);
      const uint32_t r3 = load_b_word(B, K, N, k0 + kk + 3, gn, vec);
      const uint32_t lo01 = __byte_perm(r0, r1, 0x5140);  // r0b0 r1b0 r0b1 r1b1
      const uint32_t hi01 = __byte_perm(r0, r1, 0x7362);  // r0b2 r1b2 r0b3 r1b3
      const uint32_t lo23 = __byte_perm(r2, r3, 0x5140);
      const uint32_t hi23 = __byte_perm(r2, r3, 0x7362);
      int8_t* dst = Bs + nn * kLds + kk;
      *reinterpret_cast<uint32_t*>(dst + 0 * kLds) = __byte_perm(lo01, lo23, 0x5410);
      *reinterpret_cast<uint32_t*>(dst + 1 * kLds) = __byte_perm(lo01, lo23, 0x7632);
      *reinterpret_cast<uint32_t*>(dst + 2 * kLds) = __byte_perm(hi01, hi23, 0x5410);
      *reinterpret_cast<uint32_t*>(dst + 3 * kLds) = __byte_perm(hi01, hi23, 0x7632);
    }
    __syncthreads();

#pragma unroll
    for (int ks = 0; ks < kBK; ks += 32) {
      uint32_t af[MT][4], bf[NT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int8_t* a = As + (wm * WM + i * 16 + g) * kLds + ks + tig * 4;
        af[i][0] = ld_s32(a);                 // row g,     k 0..15
        af[i][1] = ld_s32(a + 8 * kLds);      // row g + 8, k 0..15
        af[i][2] = ld_s32(a + 16);            // row g,     k 16..31
        af[i][3] = ld_s32(a + 8 * kLds + 16); // row g + 8, k 16..31
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int8_t* b = Bs + (wn * WN + j * 8 + g) * kLds + ks + tig * 4;
        bf[j][0] = ld_s32(b);                 // col g, k 0..15
        bf[j][1] = ld_s32(b + 16);            // col g, k 16..31
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_s8(acc[i][j], af[i], bf[j]);
    }
    __syncthreads();
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
int launch(const int8_t* A, const int8_t* B, int32_t* C, int M, int N, int K, int vec,
           cudaStream_t stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  int8_matmul_kernel<BM, BN, WARPS_M, WARPS_N>
      <<<grid, WARPS_M * WARPS_N * 32, 0, stream>>>(A, B, C, M, N, K, vec);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// a: (M, K) int8, b: (K, N) int8, c: (M, N) int32, all row-major and
// contiguous. `vec` = 1 allows 16-byte loads of a and 4-byte loads of b:
// the caller sets it only when K % 16 == 0, N % 4 == 0 and both pointers
// are 16-byte aligned. M, N, K >= 1. Launches on `stream` and returns the
// launch's cudaError_t (0 on success).
int int8_matmul(const void* a, const void* b, void* c, int M, int N, int K, int vec,
                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* A = static_cast<const int8_t*>(a);
  const int8_t* B = static_cast<const int8_t*>(b);
  int32_t* C = static_cast<int32_t*>(c);
  if (M <= 16) return launch<16, 64, 1, 4>(A, B, C, M, N, K, vec, s);
  return launch<64, 64, 2, 2>(A, B, C, M, N, K, vec, s);
}

}  // extern "C"
