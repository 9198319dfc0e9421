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
// tile's sum in VMEM across the k axis. Here each 128x128 tile of the
// window is cut into sub-tiles, one 128-thread block each, and each block
// runs the whole K loop itself. A window of up to 8 tiles (on 132 SMs)
// gets 32 sub-tiles of 32x16 per tile, the 4 warps sharing the one patch,
// each taking every 4th k-step, so its products spread over the card. A
// larger window gets 8 sub-tiles of 64x32 per tile, the 4 warps each
// owning a 32x16 patch: fewer, larger blocks read A and B fewer times. Every
// output element is summed by one block in one fixed order (the warps'
// shares are added in the order of their k-steps, through shared memory),
// with no split-K across blocks and no atomics, so `c_acc` comes out
// bit-identical from launch to launch. Each block reads its own tile
// index from `start`; no scalar prefetch is needed.
//
// A block streams K slices of its A rows and B columns through a 4-stage
// cp.async ring (16-byte copies, one __syncthreads per slice; slices 32
// deep for the wide fp32 blocks, 64 otherwise) and multiplies on the
// tensor cores with mma.sync:
// - fp32 inputs: 3xTF32 on m16n8k8. Each operand is split once, as its
//   fragment leaves shared memory: hi = tf32(x), lo = tf32(x - hi), both
//   rounded to nearest (cvt.rna). The product is a_lo b_hi + a_hi b_lo +
//   a_hi b_hi: hi and lo carry 22 of fp32's 24 bits, and the dropped
//   a_lo b_lo term is 2^-22 of the product, so the sum is fp32-exact to
//   the card check's 1e-5 (one TF32 product alone misses it by 30x).
// - bf16 inputs: one m16n8k16 bf16 product, exact in fp32.
// The tensor cores need not round their own running sums to nearest
// (measurements of earlier NVIDIA tensor cores found truncation), so the
// large term of each slice is summed into fresh registers and added to
// the running fp32 sums with one rounded add per slice; the two cross
// terms, 2^-11 of it, stay in the tensor cores over the whole K loop and
// are added last.
//
// What bounds it on this card: the serving path runs M = 128 (one tile
// row), so a window is a 128 x (window*128) x K product: 2*128*128*K
// flops per tile against 4*(128*K + K*128 + 2*128*128) bytes. At K of a
// few hundred and more that is bound by arithmetic: 3xTF32 does three
// TF32 products per fp32 one, at best at the 495 TFLOP/s TF32 peak, 2.5x
// the 67 TFLOP/s of fp32 FMA on the CUDA cores; a small window is bound
// by the launch itself. In practice the card runs mma.sync's TF32 form far
// below that peak (PERF.md), and that rate bounds the fp32 path.
// Not wgmma: its tf32 form takes only K-major operands, and B is
// row-major (K, N).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kTile = 128;     // output tile edge at the API
constexpr int kStages = 4;     // ring slots
constexpr int kThreads = 128;  // 4 warps

// A block's part of the window: a BM x BN sub-tile of one output tile,
// covered by warps of 32 x 16; SPLIT warps share each patch, each taking
// every SPLIT-th k-step of a ring slot BK deep.
template <typename T, int BM, int BN, int SPLIT, int BK>
struct Cfg {
  using Elem = T;
  static constexpr int kBM = BM, kBN = BN, kSplit = SPLIT, kBK = BK;
  static constexpr int kWarpsN = BN / 16;
  static constexpr int kWarpsMN = (BM / 32) * kWarpsN;
  static constexpr int kSubsN = kTile / BN;
  static constexpr int kSubs = (kTile / BM) * kSubsN;  // blocks per tile
  static constexpr int kStep = sizeof(T) == 4 ? 8 : 16;  // k of one mma
  static constexpr int vec = 16 / static_cast<int>(sizeof(T));  // per copy
  // padded row strides, in elements: the fragment loads of a warp hit 32
  // distinct banks, and every row starts on 16 bytes
  static constexpr int a_ld = kBK + (sizeof(T) == 4 ? 4 : 8);
  static constexpr int b_ld = BN + 8;
  static constexpr int a_elems = BM * a_ld;
  static constexpr int slot_elems = a_elems + kBK * b_ld;
  static constexpr size_t smem = sizeof(T) * slot_elems * kStages;
  static constexpr int a_copies = BM * kBK / vec / kThreads;  // per thread
  static constexpr int b_copies = kBK * BN / vec / kThreads;
  static_assert(32 * kWarpsMN * SPLIT == kThreads, "4 warps");
  static_assert(a_copies * kThreads * vec == BM * kBK &&
                    b_copies * kThreads * vec == kBK * BN,
                "every thread makes the same number of copies");
  static_assert(kBK % (kStep * SPLIT) == 0, "k-steps split evenly");
  static_assert((SPLIT - 1) * kWarpsMN * 16 * 32 * 4 <= smem,
                "the ring holds the warps' shares at the end");
};
// windows of 9 tiles or more: 64x32 blocks, a 32x16 patch a warp
template <typename T>
using Wide = Cfg<T, 64, 32, 1, sizeof(T) == 4 ? 32 : 64>;
// smaller windows (at most 2 blocks per SM): 32x16 blocks, the 4 warps
// splitting the k-steps
template <typename T>
using Narrow = Cfg<T, 32, 16, 4, 64>;

// 16 bytes from src, or 16 zero bytes where `in` is false (then src is
// not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// One K slice of the block's A rows and B columns into a ring slot;
// columns of A and rows of B past K (a 64-deep last slice that K fills
// only half) are zeros.
template <class C>
__device__ __forceinline__ void load_slice(typename C::Elem* slot,
                                           const typename C::Elem* a_blk,
                                           const typename C::Elem* b_blk,
                                           int K, int N, int k0) {
  constexpr int a_row = C::kBK / C::vec, b_row = C::kBN / C::vec;  // copies
  typename C::Elem* sa = slot;
  typename C::Elem* sb = slot + C::a_elems;
#pragma unroll
  for (int r = 0; r < C::a_copies; ++r) {
    const int i = static_cast<int>(threadIdx.x) + r * kThreads;
    const int row = i / a_row, v = (i % a_row) * C::vec;
    const bool in = C::kBK == 32 || k0 + v < K;  // K is a multiple of 32
    cp_async16(sa + row * C::a_ld + v,
               in ? a_blk + static_cast<size_t>(row) * K + k0 + v : a_blk, in);
  }
#pragma unroll
  for (int r = 0; r < C::b_copies; ++r) {
    const int i = static_cast<int>(threadIdx.x) + r * kThreads;
    const int row = i / b_row, v = (i % b_row) * C::vec;
    const bool in = C::kBK == 32 || k0 + row < K;
    cp_async16(sb + row * C::b_ld + v,
               in ? b_blk + static_cast<size_t>(k0 + row) * N + v : b_blk, in);
  }
}

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Fragment layouts of mma.sync (g = lane / 4, t = lane % 4):
// m16n8k8 tf32  A: (g, t) (g+8, t) (g, t+4) (g+8, t+4); B: (k t, n g) (t+4, g)
// m16n8k16 bf16 A: pairs at (g, 2t) (g+8, 2t) (g, 2t+8) (g+8, 2t+8);
//               B: pairs (k 2t, 2t+1 | n g) and (2t+8, 2t+9 | g)
// accumulator: (g, 2t) (g, 2t+1) (g+8, 2t) (g+8, 2t+1)

// This warp's k-steps of one ring slot for its 32x16 patch at (wm, wn):
// the slot's large terms into `big` (zero on entry), the fp32 cross terms
// into `small`.
template <class C>
__device__ __forceinline__ void slice_products(const float* slot, int wm,
                                               int wn, int wk, int g, int t,
                                               float (&big)[2][2][4],
                                               float (&small)[2][2][4]) {
  const float* sa = slot + (wm * 32 + g) * C::a_ld + t;
  const float* sb = slot + C::a_elems + t * C::b_ld + wn * 16 + g;
#pragma unroll
  for (int step = 0; step < C::kBK / (8 * C::kSplit); ++step) {
    const int ks = (step * C::kSplit + wk) * 8;
    uint32_t ah[2][4], al[2][4], bh[2][2], bl[2][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const float* p = sa + mi * 16 * C::a_ld + ks;
      split(p[0], ah[mi][0], al[mi][0]);
      split(p[8 * C::a_ld], ah[mi][1], al[mi][1]);
      split(p[4], ah[mi][2], al[mi][2]);
      split(p[8 * C::a_ld + 4], ah[mi][3], al[mi][3]);
    }
#pragma unroll
    for (int ni = 0; ni < 2; ++ni) {
      const float* p = sb + ks * C::b_ld + ni * 8;
      split(p[0], bh[ni][0], bl[ni][0]);
      split(p[4 * C::b_ld], bh[ni][1], bl[ni][1]);
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 2; ++ni) {
        mma_tf32(small[mi][ni], al[mi], bh[ni]);
        mma_tf32(small[mi][ni], ah[mi], bl[ni]);
        mma_tf32(big[mi][ni], ah[mi], bh[ni]);
      }
  }
}

template <class C>
__device__ __forceinline__ void slice_products(const __nv_bfloat16* slot,
                                               int wm, int wn, int wk, int g,
                                               int t, float (&big)[2][2][4],
                                               float (&)[2][2][4]) {
  const uint16_t* raw = reinterpret_cast<const uint16_t*>(slot);
  const uint16_t* sa = raw + (wm * 32 + g) * C::a_ld + 2 * t;
  const uint16_t* sb = raw + C::a_elems + 2 * t * C::b_ld + wn * 16 + g;
  auto word = [](const uint16_t* p) {
    return *reinterpret_cast<const uint32_t*>(p);
  };
  auto pair = [](const uint16_t* p) {  // rows k and k+1 of one B column
    return static_cast<uint32_t>(p[0]) |
           static_cast<uint32_t>(p[C::b_ld]) << 16;
  };
#pragma unroll
  for (int step = 0; step < C::kBK / (16 * C::kSplit); ++step) {
    const int ks = (step * C::kSplit + wk) * 16;
    uint32_t a[2][4], b[2][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const uint16_t* p = sa + mi * 16 * C::a_ld + ks;
      a[mi][0] = word(p);
      a[mi][1] = word(p + 8 * C::a_ld);
      a[mi][2] = word(p + 8);
      a[mi][3] = word(p + 8 * C::a_ld + 8);
    }
#pragma unroll
    for (int ni = 0; ni < 2; ++ni) {
      const uint16_t* p = sb + ks * C::b_ld + ni * 8;
      b[ni][0] = pair(p);
      b[ni][1] = pair(p + 8 * C::b_ld);
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 2; ++ni) mma_bf16(big[mi][ni], a[mi], b[ni]);
  }
}

template <class C>
__global__ void __launch_bounds__(kThreads)
    window_kernel(const typename C::Elem* __restrict__ a,
                  const typename C::Elem* __restrict__ b,
                  float* __restrict__ c, int K, int N, int start,
                  int n_tiles_n) {
  using T = typename C::Elem;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);

  const int tile = start + static_cast<int>(blockIdx.x) / C::kSubs;
  const int sub = static_cast<int>(blockIdx.x) % C::kSubs;
  const int row0 = (tile / n_tiles_n) * kTile + (sub / C::kSubsN) * C::kBM;
  const int col0 = (tile % n_tiles_n) * kTile + (sub % C::kSubsN) * C::kBN;
  const int warp = static_cast<int>(threadIdx.x) / 32;
  const int lane = static_cast<int>(threadIdx.x) % 32;
  const int g = lane / 4, t = lane % 4;
  const int wk = warp / C::kWarpsMN, wmn = warp % C::kWarpsMN;
  const int wm = wmn / C::kWarpsN, wn = wmn % C::kWarpsN;  // rows 32wm, cols 16wn

  const T* a_blk = a + static_cast<size_t>(row0) * K;
  const T* b_blk = b + col0;
  const int n_slices = (K + C::kBK - 1) / C::kBK;

  float acc[2][2][4], small[2][2][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 2; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = small[mi][ni][e] = 0.0f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_slices)
      load_slice<C>(ring + s * C::slot_elems, a_blk, b_blk, K, N, s * C::kBK);
    cp_async_commit();
  }
  for (int ks = 0; ks < n_slices; ++ks) {
    cp_async_wait<kStages - 2>();  // slice ks has landed
    __syncthreads();               // ... for every thread; slot ks-1 is free
    const int next = ks + kStages - 1;
    if (next < n_slices)
      load_slice<C>(ring + (next % kStages) * C::slot_elems, a_blk, b_blk, K,
                    N, next * C::kBK);
    cp_async_commit();

    float big[2][2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 2; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) big[mi][ni][e] = 0.0f;
    slice_products<C>(ring + (ks % kStages) * C::slot_elems, wm, wn, wk, g, t,
                      big, small);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 2; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] += big[mi][ni][e];
  }

  // This warp's share of its patch; with split k-steps, the warps'
  // shares summed in the order of wk, through the spent ring.
  float sum[2][2][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 2; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) sum[mi][ni][e] = acc[mi][ni][e] + small[mi][ni][e];
  if constexpr (C::kSplit > 1) {
    float* share = reinterpret_cast<float*>(smem_raw);  // [wk-1][wmn][16][32]
    cp_async_wait<0>();
    __syncthreads();  // every warp is done with the ring
    if (wk > 0) {
      float* mine = share + ((wk - 1) * C::kWarpsMN + wmn) * 16 * 32 + lane;
#pragma unroll
      for (int e = 0; e < 16; ++e) mine[32 * e] = sum[e / 8][(e / 4) % 2][e % 4];
    }
    __syncthreads();
    if (wk > 0) return;
#pragma unroll
    for (int w = 1; w < C::kSplit; ++w) {
      const float* theirs = share + ((w - 1) * C::kWarpsMN + wmn) * 16 * 32 + lane;
#pragma unroll
      for (int e = 0; e < 16; ++e) sum[e / 8][(e / 4) % 2][e % 4] += theirs[32 * e];
    }
  }
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 2; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // rows g and g + 8
        const int row = row0 + wm * 32 + mi * 16 + g + 8 * h;
        const int col = col0 + wn * 16 + ni * 8 + 2 * t;
        float2* p = reinterpret_cast<float2*>(c + static_cast<size_t>(row) * N + col);
        float2 v = *p;
        v.x += sum[mi][ni][2 * h];
        v.y += sum[mi][ni][2 * h + 1];
        *p = v;
      }
}

template <class C>
int launch_cfg(const void* a, const void* b, void* c, int K, int N, int start,
               int window, int n_tiles_n, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        window_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(C::smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  using T = typename C::Elem;
  window_kernel<C><<<window * C::kSubs, kThreads, C::smem, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<float*>(c), K, N, start, n_tiles_n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* a, const void* b, void* c, int K, int N, int start,
           int window, int n_tiles_n, void* stream) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const auto st = static_cast<cudaStream_t>(stream);
  if (window * Narrow<T>::kSubs <= 2 * sms)
    return launch_cfg<Narrow<T>>(a, b, c, K, N, start, window, n_tiles_n, st);
  return launch_cfg<Wide<T>>(a, b, c, K, N, start, window, n_tiles_n, st);
}

}  // namespace

// Plain C interface for ctypes. Operands are row-major, contiguous and
// 16-byte aligned, M, N multiples of 128 and K a multiple of 32; the
// Python wrapper checks all of it. Returns cudaGetLastError() after the
// launch.
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
