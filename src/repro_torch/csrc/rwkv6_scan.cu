// RWKV-6 WKV recurrence for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/rwkv6_scan/kernel.py:29
// (`_wkv_kernel`, launched by `rwkv6_scan_call`). Per (batch, head), from
// a zero state S_0 (hd x hd):
//
//     y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
//     S_t = diag(w_t) S_{t-1} + k_t v_t^T
//
// and returns y (every step) and S_S. All fp32. r, k, v, w and y are the
// model's (B, S, H, hd) tensors, read and written through their strides
// (a step is H * hd floats); u is (H, hd); S_final is (B, H, hd, hd).
//
// The TPU kernel runs chunks of the sequence in order with the state in
// VMEM and turns each chunk into MXU products (the GLA form, with an
// exp(-cumw) rescale that needs chunk <= 64). Here the recurrence runs
// step by step in fp32, which is exact and needs no rescale. The bonus
// is taken out of the state: y_t = r_t^T S_{t-1} + b_t v_t with
// b_t = sum_i r_i u_i k_i, one number per (b, h, t).
//
// One block per (b, h): a producer warp and 4 compute warps.
// - The producer keeps a ring of 3 stages filled by TMA. A stage holds 32
//   steps of r, k, w and v for the block's (b, h): four 8 KB boxes of a
//   4-D tensor map over (hd, H, S, B), so steps past S read as zeros and
//   a box never reaches another batch row or head. Each stage has a
//   "full" mbarrier (the copies landed) and an "empty" one (every compute
//   lane is done with it). Loads for the next two stages are in flight
//   while one is computed; no block-wide barrier runs after the setup.
// - Compute warp g owns state columns [16g, 16g+16) over all 64 rows.
//   Lane (rg, cg) = (lane / 4, lane % 4) holds rows 4rg..4rg+3 and
//   32+4rg..32+4rg+3 of columns 16g+4cg..16g+4cg+3: 32 state elements in
//   registers. Per step it reads r, k, w for its rows as two 16-byte
//   broadcasts each and v for its columns as one, and does 3 fp32
//   operations per element (k v, the y FMA on S_{t-1}, the decay FMA).
//   Its partial y (its 8 rows, 4 columns) goes to a per-warp shared
//   buffer; once per stage the warp sums the 8 row groups' partials in
//   order, adds b_t v, and writes y.
// - b_t: each compute warp computes 8 of the 32 steps of the next stage
//   (8 lanes per step, 8 rows each, summed across the 8 lanes) into the
//   stage's bonus slot and arrives on the stage's "bonus" mbarrier.
//
// What bounds it on this card: per step and head the function costs
// 5 hd^2 + 5 hd fp32 flops (5.45 GFLOP at B = 2, S = 2048, H = 64: 0.081
// ms at the fp32 FMA peak) against 5 * B*S*H*hd * 4 bytes of r, k, v, w
// in and y out (336 MB there: 0.101 ms at 3.35 TB/s), so memory. The
// kernel cannot reach either: the step loop is serial in S, and at that
// shape one (b, h) fills one SM. Per warp and step it issues 105
// instructions (96 of them the recurrence's fp32 operations, 7 16-byte
// shared loads, one 16-byte store of the partials), plus about 8 for the
// bonus and the y sums, on one warp per SM sub-partition; on an H100
// 80GB HBM3 at 700 W that runs about 200 SM clocks per step (chip_smoke.py's `[lmkern] wkv6`
// line has the time). Neither the shared loads nor the y sums alone bind
// it: without the step's loads it is about a tenth faster, without the
// partial sums' round trip about a sixth. Splitting the columns over 8
// warps (2 per sub-partition, twice the loads per FMA) was slower, and
// reading each step's operands a step ahead gained nothing.
#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched
                   // through the runtime, so nothing links libcuda
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kHD = 64;                   // head width
constexpr int kT = 32;                    // steps per stage
constexpr int kStages = 3;                // stages in the ring
constexpr int kWarps = 4;                 // compute warps
constexpr int kWarpCols = kHD / kWarps;   // state columns per warp: 16
constexpr int kCols = kWarpCols / 4;      // per thread: 4
constexpr int kRows = 8;                  // per thread
constexpr int kThreads = (kWarps + 1) * 32;
constexpr int kUnroll = 8;                // steps per unrolled group
constexpr uint32_t kBox = kT * kHD * 4;   // bytes of one TMA box
// Per-warp partial-y rows: 8 row groups x 16 columns per step, padded to
// 9 x 16 floats so the stage-end reads of 8 steps at once hit distinct
// banks.
constexpr int kPartRow = 9 * kWarpCols;
constexpr int kQuads = kWarpCols / 4;                 // float4s per step
constexpr int kItems = kT * kQuads / 32;              // epilogue items per lane
constexpr int kBonusSteps = kT / kWarps;              // bonus steps per warp
static_assert(kCols == 4 && kBonusSteps % 4 == 0 && kT % kUnroll == 0, "layout");

// Shared memory, from a 1024-byte aligned base: kStages x {r, k, w, v}
// boxes of [kT][kHD] floats, the partial-y buffers, the bonus slots
// [kStages][kT], then the mbarriers full, bonus, empty [kStages] each.
constexpr uint32_t kStageBytes = 4 * kBox;
constexpr uint32_t kPartOff = kStages * kStageBytes;
constexpr uint32_t kPartBytes = kT * kPartRow * 4;    // one warp
constexpr uint32_t kBonusOff = kPartOff + kWarps * kPartBytes;
constexpr uint32_t kBarOff = kBonusOff + kStages * kT * 4;
constexpr size_t kSmem = kBarOff + 3 * kStages * 8 + 1024;

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

// One TMA box of a 4-D map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, const float (&s)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(s[0], s[1], s[2], s[3]);
}

__global__ void __launch_bounds__(kThreads, 1)
    wkv6_kernel(const __grid_constant__ CUtensorMap tm_r,
                const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_w,
                const __grid_constant__ CUtensorMap tm_v,
                const float* __restrict__ u, float* __restrict__ y,
                float* __restrict__ s_out, int S, int H) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  auto stage = [&](int s, int which) {  // which: 0 r, 1 k, 2 w, 3 v
    return reinterpret_cast<float*>(smem + s * kStageBytes + which * kBox);
  };
  float* bonus_s = reinterpret_cast<float*>(smem + kBonusOff);
  const uint32_t bars = smem_u32(smem + kBarOff);
  auto full = [&](int s) { return bars + 8 * s; };
  auto bonus_bar = [&](int s) { return bars + 8 * (kStages + s); };
  auto empty = [&](int s) { return bars + 8 * (2 * kStages + s); };

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_stages = (S + kT - 1) / kT;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(bonus_bar(s), 32 * kWarps);
      mbar_init(empty(s), 32 * kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == kWarps) {
    // Producer: stage n into slot n % kStages once every compute lane has
    // released that slot's previous stage.
    if (lane == 0) {
      for (int n = 0; n < n_stages; ++n) {
        const int s = n % kStages;
        if (n >= kStages) mbar_wait(empty(s), ((n / kStages) + 1) & 1);
        mbar_expect_tx(full(s), kStageBytes);
        tma_load(smem_u32(stage(s, 0)), &tm_r, full(s), 0, h, n * kT, b);
        tma_load(smem_u32(stage(s, 1)), &tm_k, full(s), 0, h, n * kT, b);
        tma_load(smem_u32(stage(s, 2)), &tm_w, full(s), 0, h, n * kT, b);
        tma_load(smem_u32(stage(s, 3)), &tm_v, full(s), 0, h, n * kT, b);
      }
    }
    return;
  }

  const int g = warp;
  const int rg = lane / 4, cg = lane % 4;  // state rows / columns
  const int col0 = g * kWarpCols + cg * kCols;
  float* part = reinterpret_cast<float*>(smem + kPartOff + g * kPartBytes);

  // Bonus lanes: step bq of each group of 4, rows of row group bc.
  const int bq = lane / 8, bc = lane % 8;
  float ub[kRows];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    ub[q] = u[h * kHD + 4 * bc + q];
    ub[4 + q] = u[h * kHD + 32 + 4 * bc + q];
  }
  // This warp's steps of b_t for the stage in slot s, into its bonus slot.
  auto bonus = [&](int s) {
    const float* rs = stage(s, 0);
    const float* ks = stage(s, 1);
#pragma unroll
    for (int p = 0; p < kBonusSteps / 4; ++p) {
      const int t = g * kBonusSteps + 4 * p + bq;
      const float4 r0 = ld4(rs + t * kHD + 4 * bc);
      const float4 r1 = ld4(rs + t * kHD + 32 + 4 * bc);
      const float4 k0 = ld4(ks + t * kHD + 4 * bc);
      const float4 k1 = ld4(ks + t * kHD + 32 + 4 * bc);
      float acc = (r0.x * ub[0]) * k0.x;
      acc = fmaf(r0.y * ub[1], k0.y, acc);
      acc = fmaf(r0.z * ub[2], k0.z, acc);
      acc = fmaf(r0.w * ub[3], k0.w, acc);
      acc = fmaf(r1.x * ub[4], k1.x, acc);
      acc = fmaf(r1.y * ub[5], k1.y, acc);
      acc = fmaf(r1.z * ub[6], k1.z, acc);
      acc = fmaf(r1.w * ub[7], k1.w, acc);
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      acc += __shfl_xor_sync(0xffffffffu, acc, 4);
      if (bc == 0) bonus_s[s * kT + t] = acc;
    }
  };

  float st[kRows][kCols];
#pragma unroll
  for (int j = 0; j < kRows; ++j)
#pragma unroll
    for (int c = 0; c < kCols; ++c) st[j][c] = 0.0f;

  // One step: y partial over this lane's rows from S_{t-1}, then the
  // state update.
  auto step = [&](const float* rs, const float* ks, const float* ws,
                  const float* vs, int t) {
    const float4 ra = ld4(rs + t * kHD + 4 * rg), rb = ld4(rs + t * kHD + 32 + 4 * rg);
    const float4 ka = ld4(ks + t * kHD + 4 * rg), kb = ld4(ks + t * kHD + 32 + 4 * rg);
    const float4 wa = ld4(ws + t * kHD + 4 * rg), wb = ld4(ws + t * kHD + 32 + 4 * rg);
    const float4 vq = ld4(vs + t * kHD + col0);
    const float vv[kCols] = {vq.x, vq.y, vq.z, vq.w};
    const float rr[kRows] = {ra.x, ra.y, ra.z, ra.w, rb.x, rb.y, rb.z, rb.w};
    const float kk[kRows] = {ka.x, ka.y, ka.z, ka.w, kb.x, kb.y, kb.z, kb.w};
    const float ww[kRows] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
    float acc[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[c] = rr[0] * st[0][c];
#pragma unroll
    for (int j = 1; j < kRows; ++j)
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[c] = fmaf(rr[j], st[j][c], acc[c]);
#pragma unroll
    for (int j = 0; j < kRows; ++j)
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        st[j][c] = fmaf(ww[j], st[j][c], kk[j] * vv[c]);
    st4(part + t * kPartRow + rg * kWarpCols + cg * kCols, acc);
  };

  const size_t step_stride = static_cast<size_t>(H) * kHD;
  float* y_bh = y + static_cast<size_t>(b) * S * step_stride +
                static_cast<size_t>(h) * kHD + g * kWarpCols;

  mbar_wait(full(0), 0);
  bonus(0);
  mbar_arrive(bonus_bar(0));
  for (int n = 0; n < n_stages; ++n) {
    const int s = n % kStages;
    if (n + 1 < n_stages) {
      const int s1 = (n + 1) % kStages;
      mbar_wait(full(s1), ((n + 1) / kStages) & 1);
      bonus(s1);
      mbar_arrive(bonus_bar(s1));
    }
    mbar_wait(bonus_bar(s), (n / kStages) & 1);
    const float* rs = stage(s, 0);
    const float* ks = stage(s, 1);
    const float* ws = stage(s, 2);
    const float* vs = stage(s, 3);
    const int steps = min(kT, S - n * kT);
    if (steps == kT) {
#pragma unroll 1
      for (int t0 = 0; t0 < kT; t0 += kUnroll) {
#pragma unroll
        for (int t = 0; t < kUnroll; ++t) step(rs, ks, ws, vs, t0 + t);
      }
    } else {
#pragma unroll 1
      for (int t = 0; t < steps; ++t) step(rs, ks, ws, vs, t);
    }
    __syncwarp();
    // y for this warp's columns: the 8 row groups' partials in order,
    // then the bonus.
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int item = lane + 32 * i;
      const int t = item / kQuads, quad = item % kQuads;
      if (t < steps) {
        const float* p = part + t * kPartRow + quad * 4;
        float4 sum = ld4(p);
#pragma unroll
        for (int r = 1; r < 8; ++r) {
          const float4 q = ld4(p + r * kWarpCols);
          sum.x += q.x;
          sum.y += q.y;
          sum.z += q.z;
          sum.w += q.w;
        }
        const float bt = bonus_s[s * kT + t];
        const float4 vq = ld4(vs + t * kHD + g * kWarpCols + quad * 4);
        sum.x = fmaf(bt, vq.x, sum.x);
        sum.y = fmaf(bt, vq.y, sum.y);
        sum.z = fmaf(bt, vq.z, sum.z);
        sum.w = fmaf(bt, vq.w, sum.w);
        *reinterpret_cast<float4*>(
            y_bh + static_cast<size_t>(n * kT + t) * step_stride + quad * 4) = sum;
      }
    }
    __syncwarp();  // partials read before the next stage rewrites them
    mbar_arrive(empty(s));
  }

  float* s_bh = s_out + static_cast<size_t>(bh) * kHD * kHD + col0;
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    const int row = (j < 4 ? 4 * rg + j : 32 + 4 * rg + (j - 4));
    st4(s_bh + row * kHD, st[j]);
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

// A (B, S, H, 64) fp32 tensor as a 4-D map over (64, H, S, B); one box
// is kT steps of one head of one batch row. Steps past S read as zeros.
bool make_map(CUtensorMap* map, const void* ptr, int B, int S, int H) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(kHD),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t row = kHD * 4;
  const cuuint64_t strides[3] = {row, row * H, row * H * S};
  const cuuint32_t box[4] = {kHD, 1, kT, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encoder()(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                   const_cast<void*>(ptr), dims, strides, box, unit,
                   CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// Plain C interface for ctypes. r, k, v, w, y: (B, S, H, 64) float32;
// u: (H, 64); s_out: (B, H, 64, 64); all contiguous; r, k, v, w 16-byte
// aligned (TMA); B*H within the grid's x limit. The Python wrapper
// checks all of it. Returns cudaGetLastError() after the launch, or the
// error that kept the kernel from launching.
extern "C" int wkv6_forward_f32(const void* r, const void* k, const void* v,
                                const void* w, const void* u, void* y,
                                void* s_out, int B, int S, int H,
                                void* stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        wkv6_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kSmem));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  if (encoder() == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap tm_r, tm_k, tm_w, tm_v;
  if (!make_map(&tm_r, r, B, S, H) || !make_map(&tm_k, k, B, S, H) ||
      !make_map(&tm_w, w, B, S, H) || !make_map(&tm_v, v, B, S, H))
    return static_cast<int>(cudaErrorInvalidValue);
  wkv6_kernel<<<B * H, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      tm_r, tm_k, tm_w, tm_v, static_cast<const float*>(u),
      static_cast<float*>(y), static_cast<float*>(s_out), S, H);
  return static_cast<int>(cudaGetLastError());
}
