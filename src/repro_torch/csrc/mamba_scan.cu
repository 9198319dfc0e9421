// Selective scan (Mamba) for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/mamba_scan/kernel.py:27
// (`_scan_kernel`, launched by `mamba_scan_call`). Per batch row b and
// channel (d, n) of d_inner x d_state, from h0:
//
//     h_t = exp(dt_t[d] * A[d, n]) * h_{t-1} + (dt_t[d] * x_t[d]) * B_t[n]
//     y_t[d] = sum_n h_t[d, n] * C_t[n]
//
// and returns y (every step) and h_S. All fp32. dt, x, y are (Bb, S, di);
// B, C are (Bb, S, ns); A is (di, ns); h0 and h_out are (Bb, di, ns).
//
// The TPU kernel runs the chunks of a sequence in order on one core with
// the (di, ns) state in VMEM. Here channels are independent, so the grid
// runs over (d_inner block of kChan channels, batch row), and the
// recurrence runs step by step in fp32 for any A.
// - States split across lanes: each channel's 16 states belong to kLanes
//   neighbouring lanes, lane g of them holding states g, g + 4, g + 8,
//   g + 12, and a lane holds kCPL neighbouring channels, so one load of
//   B_t and C_t serves kCPL channels. The states and their entries of A
//   (pre-scaled by log2(e)) stay in registers, and a decay is one
//   MUFU.EX2 (`ex2.approx.ftz`: dt * A <= 0, and it flushes only results
//   below 2^-126 to 0).
// - Steps run in groups of kSub: a lane first reads the group's dt, x, B
//   and C from shared memory, then runs its steps, then writes each
//   step's partial y_g = sum of h C over its states, in the order g,
//   g + 4, g + 8, g + 12, to a per-warp buffer. The warp then sums each
//   channel's partials as (y_0 + y_1) + (y_2 + y_3) into a [kT] x
//   [channels of the warp] tile of y, which one lane stores with TMA
//   once per stage; the store drops steps past S and channels past di.
//   The order is fixed, so every launch gives the same bits, and it is
//   that of four interleaved sums of one thread that holds all 16
//   states: y is bit for bit what such a thread computes.
// - A producer warp keeps a ring of kStages stages filled by TMA, behind
//   "full" and "empty" mbarriers (the pattern of rwkv6_scan.cu): a stage
//   is kT steps of dt and x for the block's channels, and of B and C for
//   its batch row, boxes of 3-D tensor maps over (di or ns, S, Bb). Its
//   lanes then regroup each step's B and C so that a lane's four states
//   sit side by side, and mark the stage "ready" a stage ahead.
//   Steps past S and channels past di read as zeros, and a box never
//   reaches another batch row. No block-wide barrier runs after setup.
//   The last stage, if ragged, leaves h untouched past S.
//
// What bounds it on this card: per step and channel 16 exponentials on
// the SFU (16 per clock per SM) against 12 bytes of dt, x and y. At Bb 2,
// S 2048, di 8192: 537 M exponentials, 0.128 ms at 132 SMs and 1.98 GHz,
// against 403 MB, 0.120 ms at 3.35 TB/s. The kernel reaches neither. Per
// lane and step it issues about 47 instructions for its 8 state elements
// (40 of them the recurrence's FMUL, MUFU and FFMA), at about 2 compute
// warps per SM sub-partition: 92 clocks of issue and 124 of SFU work per
// sub-partition and step, where an H100 80GB HBM3 at 700 W takes about
// 200. Neither unit binds alone: with stale tiles in place of the loads
// the time is the same, and moving a quarter of the exponentials to an
// FMA-pipe polynomial makes it slower; the steps' dependent chains at
// two warps per sub-partition leave both about half used. One channel
// per lane (4 warps of 35 instructions per 4 elements) and a shuffle
// butterfly in place of the shared-memory partials each took about 220;
// the regrouping of B and C costs about 3%.
#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched
                   // through the runtime, so nothing links libcuda
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kNS = 16;                      // d_state
constexpr int kLanes = 4;                    // lanes per channel
constexpr int kPer = kNS / kLanes;           // states per lane
constexpr int kCPL = 2;                      // channels per lane
constexpr int kChan = 32;                    // channels per block
constexpr int kT = 32;                       // steps per stage
constexpr int kStages = 3;                   // stages in the ring
constexpr int kSub = 16;                     // steps per unrolled group
constexpr int kGroups = 32 / kLanes;         // lane groups per warp
constexpr int kChanPerWarp = kGroups * kCPL;
constexpr int kWarps = kChan / kChanPerWarp;  // compute warps
constexpr int kThreads = (kWarps + 1) * 32;
constexpr int kItems = kSub * kGroups / 32;  // (step, lane group) sums per lane
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kLanes == 4 && kPer == 4 && kCPL == 2 && kT == 32 &&
                  kT % kSub == 0 &&
                  kChan % kChanPerWarp == 0 && kSub * kGroups % 32 == 0,
              "layout");

// Shared memory, from a 128-byte aligned base: kStages x {dt, x, B, C}
// boxes ([kT][kChan] and [kT][kNS] floats); per compute warp its partial
// sums [kSub][32 lanes][kCPL] and its y tile [kT][kChanPerWarp]; then the
// mbarriers full, ready and empty [kStages] each.
constexpr uint32_t kBoxX = kT * kChan * 4;
constexpr uint32_t kBoxB = kT * kNS * 4;
constexpr uint32_t kStageBytes = 2 * kBoxX + 2 * kBoxB;
constexpr uint32_t kPartBytes = kSub * 32 * kCPL * 4;
constexpr uint32_t kYBytes = kT * kChanPerWarp * 4;
constexpr uint32_t kPartOff = kStages * kStageBytes;
constexpr uint32_t kYOff = kPartOff + kWarps * kPartBytes;
constexpr uint32_t kBarOff = kYOff + kWarps * kYBytes;
constexpr size_t kSmem = kBarOff + 3 * kStages * 8 + 128;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// Wait until the barrier's phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One TMA box of a 3-D map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// One TMA box from shared memory into a 3-D map, as a bulk group.
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src,
                                          int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];\n"
      "cp.async.bulk.commit_group;" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// 2^x in one MUFU.EX2; results below 2^-126 flush to 0.
__device__ __forceinline__ float ex2(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// n consecutive floats from 4n-byte aligned memory (n = 2 or 4).
template <int n>
__device__ __forceinline__ void ldv(float (&dst)[n], const float* src) {
  if constexpr (n == 2) {
    const float2 v = *reinterpret_cast<const float2*>(src);
    dst[0] = v.x;
    dst[1] = v.y;
  } else {
    static_assert(n == 4, "2 or 4 floats");
    const float4 v = *reinterpret_cast<const float4*>(src);
    dst[0] = v.x;
    dst[1] = v.y;
    dst[2] = v.z;
    dst[3] = v.w;
  }
}

__device__ __forceinline__ void st2(float* dst, const float (&v)[2]) {
  *reinterpret_cast<float2*>(dst) = make_float2(v[0], v[1]);
}

__global__ void __launch_bounds__(kThreads, 4)
    scan_kernel(const __grid_constant__ CUtensorMap tm_dt,
                const __grid_constant__ CUtensorMap tm_x,
                const __grid_constant__ CUtensorMap tm_b,
                const __grid_constant__ CUtensorMap tm_c,
                const __grid_constant__ CUtensorMap tm_y,
                const float* __restrict__ A, const float* __restrict__ h0,
                float* __restrict__ h_out, int S, int di) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((128 - (smem_u32(smem_raw) & 127)) & 127);
  const uint32_t bars = smem_u32(smem + kBarOff);
  auto full = [&](int s) { return bars + 8 * s; };
  auto ready = [&](int s) { return bars + 8 * (kStages + s); };
  auto empty = [&](int s) { return bars + 8 * (2 * kStages + s); };

  const int b = blockIdx.y;
  const int d0 = blockIdx.x * kChan;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_stages = (S + kT - 1) / kT;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(ready(s), 32);
      mbar_init(empty(s), kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == kWarps) {
    // Producer: lane 0 stages n into slot n % kStages once every compute
    // warp has released that slot's previous stage; all 32 lanes regroup
    // each landed stage's B and C so that states g, g + 4, g + 8, g + 12
    // sit side by side, and mark it ready, one stage ahead of the compute
    // warps.
    auto load = [&](int n) {
      const int s = n % kStages;
      const uint32_t dst = smem_u32(smem + s * kStageBytes);
      mbar_expect_tx(full(s), kStageBytes);
      tma_load(dst, &tm_dt, full(s), d0, n * kT, b);
      tma_load(dst + kBoxX, &tm_x, full(s), d0, n * kT, b);
      tma_load(dst + 2 * kBoxX, &tm_b, full(s), 0, n * kT, b);
      tma_load(dst + 2 * kBoxX + kBoxB, &tm_c, full(s), 0, n * kT, b);
    };
    // Row element n of B and C moves to (n % 4) * 4 + n / 4. The B and C
    // boxes are 2 kT rows of kNS floats, one after the other; lane l reads
    // elements l, l + 32, ... (all of them before any write), and element
    // l + 32 i goes to 32 i + `to`: conflict-free both ways.
    constexpr int kRegroup = 2 * kT * kNS / 32;
    const int to = (lane & ~15) + (lane % 4) * 4 + (lane % 16) / 4;
    auto regroup = [&](int n) {
      const int s = n % kStages;
      mbar_wait(full(s), (n / kStages) & 1);
      float* bc = reinterpret_cast<float*>(smem + s * kStageBytes + 2 * kBoxX);
      float v[kRegroup];
#pragma unroll
      for (int i = 0; i < kRegroup; ++i) v[i] = bc[lane + 32 * i];
      __syncwarp();
#pragma unroll
      for (int i = 0; i < kRegroup; ++i) bc[32 * i + to] = v[i];
      // the next TMA load into this slot comes after these stores
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      mbar_arrive(ready(s));
    };
    if (lane == 0)
      for (int n = 0; n < min(kStages, n_stages); ++n) load(n);
    regroup(0);
    for (int n = 0; n < n_stages; ++n) {
      if (n + 1 < n_stages) regroup(n + 1);
      if (n + kStages < n_stages) {  // the whole warp waits, converged
        mbar_wait(empty(n % kStages), (n / kStages) & 1);
        if (lane == 0) load(n + kStages);
      }
    }
    return;
  }

  const int g = lane % kLanes;      // state group
  const int q = lane / kLanes;      // lane group: channels c, c + 1, ...
  const int c = warp * kChanPerWarp + q * kCPL;  // first channel in the block
  const int d = d0 + c;
  // di is a multiple of 4, so a lane's channels are all live or none is
  const bool live = d < di;
  const size_t state = (static_cast<size_t>(b) * di + d) * kNS + g;
  float* part = reinterpret_cast<float*>(smem + kPartOff + warp * kPartBytes);
  float* ys = reinterpret_cast<float*>(smem + kYOff + warp * kYBytes);
  const int d_warp = d0 + warp * kChanPerWarp;  // the y tile's first channel

  float h[kCPL][kPer], a2[kCPL][kPer];
#pragma unroll
  for (int k = 0; k < kCPL; ++k) {
    if (live) {
#pragma unroll
      for (int j = 0; j < kPer; ++j) {  // state g + kLanes j
        a2[k][j] = A[static_cast<size_t>(d + k) * kNS + g + kLanes * j] * kLog2e;
        h[k][j] = h0[state + k * kNS + kLanes * j];
      }
    } else {
#pragma unroll
      for (int j = 0; j < kPer; ++j) h[k][j] = a2[k][j] = 0.0f;
    }
  }

  // Steps t0 .. t0 + n - 1 of the stage at `st` (n <= kSub, all in one
  // group of kSub): h, and the partial y of each channel into rows t %
  // kSub of the partial sums. The steps' operands are all read before the
  // first step and the partials written after the last, so no step waits
  // on a shared-memory load issued behind another step's store.
  auto steps_from = [&](const unsigned char* st, int t0, int n) {
    const float* dts = reinterpret_cast<const float*>(st);
    const float* xs = reinterpret_cast<const float*>(st + kBoxX);
    const float* bs = reinterpret_cast<const float*>(st + 2 * kBoxX);
    const float* cs = reinterpret_cast<const float*>(st + 2 * kBoxX + kBoxB);
    float dtv[kSub][kCPL], dx[kSub][kCPL], bb[kSub][kPer], cc[kSub][kPer],
        p[kSub][kCPL];
#pragma unroll
    for (int u = 0; u < kSub; ++u) {
      if (u < n) {
        const int t = t0 + u;
        ldv(dtv[u], dts + t * kChan + c);
        ldv(dx[u], xs + t * kChan + c);
        ldv(bb[u], bs + t * kNS + g * kPer);
        ldv(cc[u], cs + t * kNS + g * kPer);
      }
    }
#pragma unroll
    for (int u = 0; u < kSub; ++u) {
      if (u < n) {
#pragma unroll
        for (int k = 0; k < kCPL; ++k) {
          const float dxk = dx[u][k] * dtv[u][k];
#pragma unroll
          for (int j = 0; j < kPer; ++j)
            h[k][j] = fmaf(ex2(dtv[u][k] * a2[k][j]), h[k][j], dxk * bb[u][j]);
          p[u][k] = h[k][0] * cc[u][0];
#pragma unroll
          for (int j = 1; j < kPer; ++j) p[u][k] = fmaf(h[k][j], cc[u][j], p[u][k]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kSub; ++u)
      if (u < n) st2(part + (((t0 + u) % kSub) * 32 + lane) * kCPL, p[u]);
  };

  // The partials of steps [t0, t0 + kSub) summed into rows t0.. of the y
  // tile: item i of this lane is step t0 + lane / kGroups + i * (32 /
  // kGroups), lane group lane % kGroups, all its kCPL channels.
  auto sum_partials = [&](int t0) {
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int tr = lane / kGroups + i * (32 / kGroups);
      const int qq = lane % kGroups;
      const float* pp = part + (tr * 32 + qq * kLanes) * kCPL;
      float v[kLanes * kCPL], out[kCPL];
#pragma unroll
      for (int w = 0; w < kCPL; ++w) {
        float v4[4];
        ldv(v4, pp + 4 * w);
#pragma unroll
        for (int e = 0; e < 4; ++e) v[4 * w + e] = v4[e];
      }
      // v[g * kCPL + k]: lane g's partial of channel k
#pragma unroll
      for (int k = 0; k < kCPL; ++k)
        out[k] = (v[k] + v[kCPL + k]) + (v[2 * kCPL + k] + v[3 * kCPL + k]);
      st2(ys + (t0 + tr) * kChanPerWarp + qq * kCPL, out);
    }
  };

  for (int n = 0; n < n_stages; ++n) {
    const int s = n % kStages;
    mbar_wait(ready(s), (n / kStages) & 1);
    const unsigned char* st = smem + s * kStageBytes;
    const int steps = min(kT, S - n * kT);
#pragma unroll 1
    for (int t0 = 0; t0 < kT; t0 += kSub) {
      if (t0 + kSub <= steps) {
        steps_from(st, t0, kSub);
      } else {
#pragma unroll 1
        for (int t = t0; t < steps; ++t) steps_from(st, t, 1);
      }
      if (t0 + kSub >= kT) {
        __syncwarp();
        if (lane == 0) mbar_arrive(empty(s));  // done reading the stage
      }
      if (t0 == 0 && n > 0 && lane == 0)  // the last stage's y tile is read
        asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
      __syncwarp();
      sum_partials(t0);
      __syncwarp();
    }
    // every lane's y rows in place: hand the tile to the TMA store
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncwarp();
    if (lane == 0 && d_warp < di) tma_store(&tm_y, smem_u32(ys), d_warp, n * kT, b);
  }
  if (lane == 0) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");

  if (live) {
#pragma unroll
    for (int k = 0; k < kCPL; ++k)
#pragma unroll
      for (int j = 0; j < kPer; ++j) h_out[state + k * kNS + kLanes * j] = h[k][j];
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the CUDA runtime's
// entry-point query (nothing links libcuda)
EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A (Bb, S, width) fp32 tensor as a 3-D map over (width, S, Bb); one box
// is kT steps of `box` columns of one batch row. Loads past S or width
// read zeros; stores there are dropped.
bool make_map(CUtensorMap* map, const void* ptr, int width, int box, int S,
              int Bb) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(width),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(Bb)};
  const cuuint64_t row = static_cast<cuuint64_t>(width) * 4;
  const cuuint64_t strides[2] = {row, row * S};
  const cuuint32_t boxes[3] = {static_cast<cuuint32_t>(box), kT, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encoder()(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
                   const_cast<void*>(ptr), dims, strides, boxes, unit,
                   CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// Plain C interface for ctypes. dt, x, y: (Bb, S, di); B, C: (Bb, S, 16);
// A: (di, 16); h0, h_out: (Bb, di, 16); all float32 and contiguous; dt,
// B, C, x, y, A, h0 16-byte aligned and di a multiple of 4 (TMA strides);
// Bb within the grid's y limit. The Python wrapper checks all of it.
// Returns cudaGetLastError() after the launch, or the error that kept
// the kernel from launching.
extern "C" int mamba_scan_f32(const void* dt, const void* Bm, const void* Cm,
                              const void* x, const void* A, const void* h0,
                              void* y, void* h_out, int Bb, int S, int di,
                              void* stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kSmem));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  if (encoder() == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap tm_dt, tm_x, tm_b, tm_c, tm_y;
  if (!make_map(&tm_dt, dt, di, kChan, S, Bb) ||
      !make_map(&tm_x, x, di, kChan, S, Bb) ||
      !make_map(&tm_b, Bm, kNS, kNS, S, Bb) ||
      !make_map(&tm_c, Cm, kNS, kNS, S, Bb) ||
      !make_map(&tm_y, y, di, kChanPerWarp, S, Bb))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((di + kChan - 1) / kChan, Bb);
  scan_kernel<<<grid, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      tm_dt, tm_x, tm_b, tm_c, tm_y, static_cast<const float*>(A),
      static_cast<const float*>(h0), static_cast<float*>(h_out), S, di);
  return static_cast<int>(cudaGetLastError());
}
