// Gradient of the selective scan (Mamba) for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package trains Jamba's mixer through
// XLA's gradient of its jnp chunked scan (src/repro/models/ssm.py:99-121).
// It is the backward of mamba_scan.cu's forward. Per batch row b and
// state (d, n), with a_t = exp(dt_t[d] A[d, n]),
// h_t = a_t h_{t-1} + dt_t x_t B_t[n] and y_t[d] = sum_n h_t C_t[n], and
// g_t the adjoint of h_t (g_{S-1} = dh_final + dy_{S-1} C_{S-1},
// g_t = a_{t+1} g_{t+1} + dy_t C_t):
//
//     dx_t  = dt_t sum_n g_t B_t
//     ddt_t = sum_n g_t h_{t-1} a_t A + x_t sum_n g_t B_t
//     dB_t  = sum_d g_t dt_t x_t,   dC_t = sum_d h_t dy_t
//     dA    = sum over b, t of g_t h_{t-1} a_t dt_t
//     dh0   = a_0 g_0
//
// All fp32, d_state 16. dt, x, dy, ddt, dx are (Bb, S, di); B, C, dB, dC
// (Bb, S, 16); A, dA (di, 16); h0, dh_final, dh0 (Bb, di, 16).
//
// The step cannot be run backwards (a_t falls to exp(-16 dt) and below),
// so the states are recomputed. Four kernels, launched in order by one
// call:
// - `scan_bwd_stash_kernel` runs the recurrence from h0 and writes h
//   before every chunk of kT steps: (Bb, chunks, di, 16).
// - `scan_bwd_reverse_kernel` walks the chunks from the last. For each
//   it runs the chunk's kT steps forward again from the stash, keeping
//   p_t = a_t h_{t-1} in shared memory, then carries g back through
//   them: ddt, dx per channel; dA in registers; dB and dC summed over
//   the block's channels in a fixed order into per-block partials.
// - `scan_bwd_dbc_kernel` sums the partials over the blocks of d_inner
//   in order, `scan_bwd_dA_kernel` dA's over the batch.
// No atomics: every sum has a fixed order, so every launch gives the
// same bits.
//
// Layout: a block of 8 warps per (64 channels, batch row); thread
// (c, j) = (tid / 4, tid % 4) holds states 4j..4j+3 of channel c. Sums
// over n are a thread's 4 states in order, then the xor-1, 2 butterfly;
// sums over d are the xor-4, 8, 16 butterfly over a warp's 8 channels,
// then the 8 warps' partials in order through shared memory, then the
// blocks in order in `scan_bwd_dbc_kernel`. Inputs come kT steps at a
// time into shared memory by cp.async, the next chunk's while this one
// is computed; ddt and dx replace dt and x in the tile they were read
// from.
//
// What bounds it on this card: the function needs per state element
// and step one exponential on the SFUs and about 17 fp32 flops, against
// dt, x, dy read and ddt, dx written once (5 x Bb S di floats). The
// kernels take three exponentials (the stash pass's, the recompute's,
// the adjoint's) and move the stash and the partials besides.
// chip_smoke.py prints the bounds and the time.
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "hopper.cuh"

namespace {

using hopper::cp_async16;
using hopper::cp_async_commit;
using hopper::cp_async_wait_all;
using hopper::ld4;

constexpr int kNS = 16;                 // d_state
constexpr int kPer = 4;                 // states per thread
constexpr int kChan = 64;               // channels per block
constexpr int kThreads = kChan * kNS / kPer;  // 256
constexpr int kWarps = kThreads / 32;
constexpr int kT = 16;                  // steps per chunk (stash interval)
constexpr int kCT = kT * kChan;         // floats in a [kT][64] channel tile
constexpr int kST = kT * kNS;           // floats in a [kT][16] state tile
static_assert(kCT / 4 == kThreads && 2 * kST / 4 <= kThreads, "tile split");

// scan_bwd_reverse_kernel's shared memory: 2 buffers of {dt, x, dy, B,
// C} tiles, p [kT][kThreads][4], the dB/dC partials [kT][kWarps][32]
constexpr int kBuf = 3 * kCT + 2 * kST;
constexpr size_t kRevSmem = (2 * kBuf + kT * kThreads * kPer + kT * kWarps * 2 * kNS) * 4;
// scan_bwd_stash_kernel's: 2 buffers of {dt, x, B}
constexpr int kStashBuf = 2 * kCT + kST;
constexpr size_t kStashSmem = 2 * kStashBuf * 4;

// Chunk n's [kT][64] tile of a (Bb, S, di) tensor for the block's
// channels, one float4 a thread; steps past S and channels past di read
// as zeros.
__device__ __forceinline__ void load_chan(float* dst, const float* src, int b, int n,
                                          int S, int di, int d0) {
  const int t = threadIdx.x / (kChan / 4), c = (threadIdx.x % (kChan / 4)) * 4;
  const int ts = n * kT + t;
  const bool ok = ts < S && d0 + c < di;
  const size_t off = ok ? (static_cast<size_t>(b) * S + ts) * di + d0 + c : 0;
  cp_async16(dst + t * kChan + c, src + off, ok);
}

// Chunk n's [kT][16] tile of a (Bb, S, 16) tensor; `lane` in [0, kST / 4).
__device__ __forceinline__ void load_state(float* dst, const float* src, int b, int n,
                                           int S, int lane) {
  const int t = lane / (kNS / 4), c = (lane % (kNS / 4)) * 4;
  const int ts = n * kT + t;
  const bool ok = ts < S;
  const size_t off = ok ? (static_cast<size_t>(b) * S + ts) * kNS + c : 0;
  cp_async16(dst + t * kNS + c, src + off, ok);
}

__global__ void __launch_bounds__(kThreads, 4)
    scan_bwd_stash_kernel(const float* __restrict__ dt, const float* __restrict__ Bm,
                          const float* __restrict__ x, const float* __restrict__ A,
                          const float* __restrict__ h0, float* __restrict__ stash, int S,
                          int di) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int b = blockIdx.y, d0 = blockIdx.x * kChan;
  const int c = threadIdx.x / kPer, j0 = (threadIdx.x % kPer) * kPer;
  const int d = d0 + c;
  const bool valid = d < di;
  const int n_chunks = (S + kT - 1) / kT;
  auto load = [&](int n, int buf) {
    float* dst = smem + buf * kStashBuf;
    load_chan(dst, dt, b, n, S, di, d0);
    load_chan(dst + kCT, x, b, n, S, di, d0);
    if (threadIdx.x < kST / 4) load_state(dst + 2 * kCT, Bm, b, n, S, threadIdx.x);
    cp_async_commit();
  };
  float h[kPer], a[kPer];
  {
    const size_t off = (static_cast<size_t>(b) * di + d) * kNS + j0;
    const float4 hv = valid ? ld4(h0 + off) : make_float4(0.f, 0.f, 0.f, 0.f);
    const float4 av = valid ? ld4(A + static_cast<size_t>(d) * kNS + j0)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
    h[0] = hv.x; h[1] = hv.y; h[2] = hv.z; h[3] = hv.w;
    a[0] = av.x; a[1] = av.y; a[2] = av.z; a[3] = av.w;
  }
  load(0, 0);
  for (int n = 0; n < n_chunks; ++n) {
    const int buf = n & 1;
    cp_async_wait_all();
    __syncthreads();
    if (n + 1 < n_chunks) load(n + 1, buf ^ 1);
    if (valid)
      *reinterpret_cast<float4*>(
          stash + ((static_cast<size_t>(b) * n_chunks + n) * di + d) * kNS + j0) =
          make_float4(h[0], h[1], h[2], h[3]);
    const float* dts = smem + buf * kStashBuf;
    const float* xs = dts + kCT;
    const float* bs = xs + kCT;
    const int steps = min(kT, S - n * kT);
#pragma unroll 4
    for (int t = 0; t < steps; ++t) {
      const float dtv = dts[t * kChan + c];
      const float dtx = dtv * xs[t * kChan + c];
      const float4 bv = ld4(bs + t * kNS + j0);
      const float bb[kPer] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int j = 0; j < kPer; ++j) h[j] = fmaf(dtx, bb[j], __expf(dtv * a[j]) * h[j]);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 2)
    scan_bwd_reverse_kernel(const float* __restrict__ dt, const float* __restrict__ Bm,
                            const float* __restrict__ Cm, const float* __restrict__ x,
                            const float* __restrict__ A, const float* __restrict__ dy,
                            const float* __restrict__ dh_final, const float* __restrict__ stash,
                            float* __restrict__ ddt, float* __restrict__ dx,
                            float* __restrict__ bc_part, float* __restrict__ da_part,
                            float* __restrict__ dh0, int S, int di) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* ptile = smem + 2 * kBuf;               // [kT][kThreads][4]
  float* part = ptile + kT * kThreads * kPer;   // [kT][kWarps][32]
  const int b = blockIdx.y, d0 = blockIdx.x * kChan, n_blocks = gridDim.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c = threadIdx.x / kPer, j0 = (threadIdx.x % kPer) * kPer;
  const int d = d0 + c;
  const bool valid = d < di;
  const int n_chunks = (S + kT - 1) / kT;
  auto load = [&](int n, int buf) {
    float* dst = smem + buf * kBuf;
    load_chan(dst, dt, b, n, S, di, d0);
    load_chan(dst + kCT, x, b, n, S, di, d0);
    load_chan(dst + 2 * kCT, dy, b, n, S, di, d0);
    if (threadIdx.x < kST / 4)
      load_state(dst + 3 * kCT, Bm, b, n, S, threadIdx.x);
    else if (threadIdx.x < 2 * kST / 4)
      load_state(dst + 3 * kCT + kST, Cm, b, n, S, threadIdx.x - kST / 4);
    cp_async_commit();
  };
  auto stashed = [&](int n) {
    return valid ? ld4(stash + ((static_cast<size_t>(b) * n_chunks + n) * di + d) * kNS + j0)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
  };
  float a[kPer], q[kPer], da[kPer] = {0.f, 0.f, 0.f, 0.f};
  {
    const float4 av = valid ? ld4(A + static_cast<size_t>(d) * kNS + j0)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
    a[0] = av.x; a[1] = av.y; a[2] = av.z; a[3] = av.w;
    float4 qv = make_float4(0.f, 0.f, 0.f, 0.f);
    if (valid && dh_final != nullptr)
      qv = ld4(dh_final + (static_cast<size_t>(b) * di + d) * kNS + j0);
    q[0] = qv.x; q[1] = qv.y; q[2] = qv.z; q[3] = qv.w;  // g_S a_S, a_S := 1
  }
  float4 next = stashed(n_chunks - 1);
  load(n_chunks - 1, 0);
  for (int it = 0; it < n_chunks; ++it) {
    const int n = n_chunks - 1 - it, buf = it & 1;
    cp_async_wait_all();
    __syncthreads();
    if (n > 0) load(n - 1, buf ^ 1);
    float h[kPer] = {next.x, next.y, next.z, next.w};
    if (n > 0) next = stashed(n - 1);
    float* dts = smem + buf * kBuf;
    float* xs = dts + kCT;
    const float* dys = xs + kCT;
    const float* bs = dys + kCT;
    const float* cs = bs + kST;
    const int steps = min(kT, S - n * kT);
    // the chunk forward again: p_t = a_t h_{t-1}
#pragma unroll 4
    for (int t = 0; t < steps; ++t) {
      const float dtv = dts[t * kChan + c];
      const float dtx = dtv * xs[t * kChan + c];
      const float4 bv = ld4(bs + t * kNS + j0);
      const float bb[kPer] = {bv.x, bv.y, bv.z, bv.w};
      float p[kPer];
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        p[j] = __expf(dtv * a[j]) * h[j];
        h[j] = fmaf(dtx, bb[j], p[j]);
      }
      *reinterpret_cast<float4*>(ptile + (t * kThreads + threadIdx.x) * kPer) =
          make_float4(p[0], p[1], p[2], p[3]);
    }
    // and back
#pragma unroll 1
    for (int t = steps - 1; t >= 0; --t) {
      const float dtv = dts[t * kChan + c];
      const float xv = xs[t * kChan + c];
      const float dyv = dys[t * kChan + c];
      const float dtx = dtv * xv;
      const float4 bv = ld4(bs + t * kNS + j0), cv = ld4(cs + t * kNS + j0);
      const float4 pv = ld4(ptile + (t * kThreads + threadIdx.x) * kPer);
      const float bb[kPer] = {bv.x, bv.y, bv.z, bv.w};
      const float cc[kPer] = {cv.x, cv.y, cv.z, cv.w};
      const float pp[kPer] = {pv.x, pv.y, pv.z, pv.w};
      float g[kPer], db[kPer], dc[kPer];
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        g[j] = fmaf(dyv, cc[j], q[j]);
        dc[j] = fmaf(dtx, bb[j], pp[j]) * dyv;  // h_t dy_t
        db[j] = g[j] * dtx;
      }
      float gb = g[0] * bb[0], gpa = (g[0] * pp[0]) * a[0];
#pragma unroll
      for (int j = 1; j < kPer; ++j) {
        gb = fmaf(g[j], bb[j], gb);
        gpa = fmaf(g[j] * pp[j], a[j], gpa);
      }
      gb += __shfl_xor_sync(0xffffffffu, gb, 1);
      gb += __shfl_xor_sync(0xffffffffu, gb, 2);
      gpa += __shfl_xor_sync(0xffffffffu, gpa, 1);
      gpa += __shfl_xor_sync(0xffffffffu, gpa, 2);
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        da[j] = fmaf(g[j] * pp[j], dtv, da[j]);
        q[j] = __expf(dtv * a[j]) * g[j];
      }
#pragma unroll
      for (int m = 4; m < 32; m *= 2)
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          db[j] += __shfl_xor_sync(0xffffffffu, db[j], m);
          dc[j] += __shfl_xor_sync(0xffffffffu, dc[j], m);
        }
      if (lane < kPer) {
        float* pt = part + (t * kWarps + warp) * 2 * kNS;
        *reinterpret_cast<float4*>(pt + j0) = make_float4(db[0], db[1], db[2], db[3]);
        *reinterpret_cast<float4*>(pt + kNS + j0) =
            make_float4(dc[0], dc[1], dc[2], dc[3]);
      }
      __syncwarp();  // every lane has read dt_t and x_t of its channel
      if (j0 == 0) {
        dts[t * kChan + c] = fmaf(xv, gb, gpa);  // ddt_t
        xs[t * kChan + c] = dtv * gb;            // dx_t
      }
    }
    __syncthreads();  // ddt, dx and the partials are complete
    {
      const int t = threadIdx.x / (kChan / 4), cq = (threadIdx.x % (kChan / 4)) * 4;
      if (t < steps && d0 + cq < di) {
        const size_t off = (static_cast<size_t>(b) * S + n * kT + t) * di + d0 + cq;
        *reinterpret_cast<float4*>(ddt + off) = ld4(dts + t * kChan + cq);
        *reinterpret_cast<float4*>(dx + off) = ld4(xs + t * kChan + cq);
      }
    }
    if (threadIdx.x < kT * 2 * kNS / 4) {
      const int t = threadIdx.x / (2 * kNS / 4), k = (threadIdx.x % (2 * kNS / 4)) * 4;
      if (t < steps) {
        const float* pt = part + t * kWarps * 2 * kNS + k;
        float4 s = ld4(pt);
#pragma unroll
        for (int w = 1; w < kWarps; ++w) {
          const float4 v = ld4(pt + w * 2 * kNS);
          s.x += v.x;
          s.y += v.y;
          s.z += v.z;
          s.w += v.w;
        }
        *reinterpret_cast<float4*>(
            bc_part + ((static_cast<size_t>(b) * S + n * kT + t) * n_blocks + blockIdx.x) *
                          2 * kNS + k) = s;
      }
    }
  }
  if (valid) {
    const size_t off = (static_cast<size_t>(b) * di + d) * kNS + j0;
    *reinterpret_cast<float4*>(dh0 + off) = make_float4(q[0], q[1], q[2], q[3]);
    *reinterpret_cast<float4*>(da_part + off) = make_float4(da[0], da[1], da[2], da[3]);
  }
}

// dB, dC at (b, t, n): the blocks' partials in order.
__global__ void scan_bwd_dbc_kernel(const float* __restrict__ bc_part, float* __restrict__ dB,
                                    float* __restrict__ dC, int rows, int n_blocks) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<size_t>(rows) * 2 * kNS) return;
  const size_t row = i / (2 * kNS);
  const int k = static_cast<int>(i % (2 * kNS));
  const float* p = bc_part + row * n_blocks * 2 * kNS + k;
  float s = p[0];
  for (int blk = 1; blk < n_blocks; ++blk) s += p[static_cast<size_t>(blk) * 2 * kNS];
  if (k < kNS)
    dB[row * kNS + k] = s;
  else
    dC[row * kNS + k - kNS] = s;
}

// dA[d, n]: the batch rows' partials in order.
__global__ void scan_bwd_dA_kernel(const float* __restrict__ da_part, float* __restrict__ dA,
                                   int Bb, int di) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const size_t n = static_cast<size_t>(di) * kNS;
  if (i >= n) return;
  float s = da_part[i];
  for (int b = 1; b < Bb; ++b) s += da_part[static_cast<size_t>(b) * n + i];
  dA[i] = s;
}

}  // namespace

// Plain C interface for ctypes. dt, x, dy, ddt, dx: (Bb, S, di); Bm, Cm,
// dB, dC: (Bb, S, 16); A, dA: (di, 16); h0, dh0, da_part: (Bb, di, 16);
// dh_final: (Bb, di, 16) or null (zero); stash: (Bb, ceil(S / 16), di,
// 16) scratch; bc_part: (Bb, S, ceil(di / 64), 32) scratch. All float32,
// contiguous and 16-byte aligned, di a multiple of 4. The Python wrapper
// checks all of it. Returns cudaGetLastError() after the launches, or
// the error that kept a kernel from launching.
extern "C" int mamba_scan_backward_f32(const void* dt, const void* Bm, const void* Cm,
                                       const void* x, const void* A, const void* h0,
                                       const void* dy, const void* dh_final, void* ddt,
                                       void* dB, void* dC, void* dx, void* dA, void* dh0,
                                       void* stash, void* bc_part, void* da_part, int Bb,
                                       int S, int di, void* stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        scan_bwd_reverse_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kRevSmem));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const auto s = static_cast<cudaStream_t>(stream);
  const int n_blocks = (di + kChan - 1) / kChan;
  const dim3 grid(n_blocks, Bb);
  scan_bwd_stash_kernel<<<grid, kThreads, kStashSmem, s>>>(
      static_cast<const float*>(dt), static_cast<const float*>(Bm),
      static_cast<const float*>(x), static_cast<const float*>(A),
      static_cast<const float*>(h0), static_cast<float*>(stash), S, di);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  scan_bwd_reverse_kernel<<<grid, kThreads, kRevSmem, s>>>(
      static_cast<const float*>(dt), static_cast<const float*>(Bm),
      static_cast<const float*>(Cm), static_cast<const float*>(x),
      static_cast<const float*>(A), static_cast<const float*>(dy),
      static_cast<const float*>(dh_final), static_cast<const float*>(stash),
      static_cast<float*>(ddt), static_cast<float*>(dx), static_cast<float*>(bc_part),
      static_cast<float*>(da_part), static_cast<float*>(dh0), S, di);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t rows = static_cast<size_t>(Bb) * S;
  scan_bwd_dbc_kernel<<<static_cast<unsigned>((rows * 2 * kNS + 255) / 256), 256, 0, s>>>(
      static_cast<const float*>(bc_part), static_cast<float*>(dB), static_cast<float*>(dC),
      static_cast<int>(rows), n_blocks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  scan_bwd_dA_kernel<<<(di * kNS + 255) / 256, 256, 0, s>>>(static_cast<const float*>(da_part),
                                                  static_cast<float*>(dA), Bb, di);
  return static_cast<int>(cudaGetLastError());
}
