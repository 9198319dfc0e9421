// Preemptible-matmul tile window for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/preemptible_matmul/kernel.py
// (`_window_kernel`, launched by `matmul_window_call`). For A (M,K) and
// B (K,N) it adds A@B into the 128x128 output tiles [start, start+window)
// of the flattened (m, n) tile grid of C (tile f -> (f / n_n, f % n_n)),
// in place; every other tile of C is left as it is. That is the paper's
// progress-table preemption: to resume a layer, launch again from the
// next tile.
//
// The TPU grid (window, k_steps) ran in order on one core, carrying each
// tile's sum in VMEM across the k axis. Here the window's tiles run in
// parallel: one CUDA block per 64x64 quarter of each tile (window * 4
// blocks), each block looping over K itself in 32-deep steps staged
// through shared memory, 256 threads each holding a 4x4 register patch
// of fp32 sums, and one `C[tile] += acc` at the end. Each block reads its
// own tile index from `start`; no scalar prefetch is needed.
//
// What bounds it on this card: the serving path runs M = 128 (one tile
// row), so a window is a 128 x (window*128) x K product: 2*128*128*K
// flops per tile against 4*(128*K + K*128 + 2*128*128) bytes. At K of a
// few hundred and more that is bound by fp32 FMA throughput on the CUDA
// cores (67 TFLOP/s), and a small window by the launch itself. Nothing uses TF32 or the tensor
// cores, because the serving path is exact fp32. wgmma, TMA and CUDA
// graphs are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kTile = 128;    // output tile edge at the public API
constexpr int kSub = 64;      // one CUDA block computes a 64x64 quarter
constexpr int kDepth = 32;    // K depth staged in shared memory per step
constexpr int kThreads = 256; // 16 x 16 threads, 4x4 outputs each

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    window_kernel(const T* __restrict__ a, const T* __restrict__ b,
                  float* __restrict__ c, int K, int N, int start,
                  int n_tiles_n) {
  // +1 column: the 16 rows a warp reads in one step fall in distinct banks
  __shared__ float a_s[kSub][kDepth + 1];
  __shared__ float b_s[kDepth][kSub];

  const int tile = start + static_cast<int>(blockIdx.x) / 4;
  const int quarter = static_cast<int>(blockIdx.x) % 4;
  const int row0 = (tile / n_tiles_n) * kTile + (quarter / 2) * kSub;
  const int col0 = (tile % n_tiles_n) * kTile + (quarter % 2) * kSub;
  const int tx = threadIdx.x % 16;  // output columns tx + 16*j
  const int ty = threadIdx.x / 16;  // output rows 4*ty + i

  const T* a_blk = a + static_cast<size_t>(row0) * K;
  const T* b_blk = b + col0;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += kDepth) {
    // coalesced loads: neighbouring threads read neighbouring elements
#pragma unroll
    for (int r = 0; r < kSub * kDepth / kThreads; ++r) {
      const int idx = static_cast<int>(threadIdx.x) + r * kThreads;
      const int am = idx / kDepth, ak = idx % kDepth;
      a_s[am][ak] = to_f32(a_blk[static_cast<size_t>(am) * K + k0 + ak]);
      const int bk = idx / kSub, bn = idx % kSub;
      b_s[bk][bn] = to_f32(b_blk[static_cast<size_t>(k0 + bk) * N + bn]);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kDepth; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = a_s[4 * ty + i][kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = b_s[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float* c_row = c + static_cast<size_t>(row0 + 4 * ty + i) * N + col0;
#pragma unroll
    for (int j = 0; j < 4; ++j) c_row[tx + 16 * j] += acc[i][j];
  }
}

template <typename T>
int launch(const void* a, const void* b, void* c, int K, int N, int start,
           int window, int n_tiles_n, void* stream) {
  window_kernel<T><<<window * 4, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<float*>(c), K, N, start, n_tiles_n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface for ctypes. Operands are row-major and contiguous,
// M, N multiples of 128 and K a multiple of 32; the Python wrapper
// checks all of it. Returns cudaGetLastError() after the launch.
extern "C" int pmm_window_f32(const void* a, const void* b, void* c, int K,
                              int N, int start, int window, int n_tiles_n,
                              void* stream) {
  return launch<float>(a, b, c, K, N, start, window, n_tiles_n, stream);
}

extern "C" int pmm_window_bf16(const void* a, const void* b, void* c, int K,
                               int N, int start, int window, int n_tiles_n,
                               void* stream) {
  return launch<__nv_bfloat16>(a, b, c, K, N, start, window, n_tiles_n,
                               stream);
}
