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
// runs over (d_inner block, batch) and each thread owns one channel d:
// its ns = 16 states and its A row (pre-scaled by log2(e), so that the
// decay is one exp2f of dt * A2) stay in registers while the thread loops
// over S. Blocks step through time in tiles of 64 steps: dt and x for the
// block's 64 channels, and B and C (shared by every channel of a batch
// row), are staged in shared memory with coalesced loads, then the tile's
// steps run out of shared memory. The result does not depend on any
// chunking of S. exp2f is the accurate CUDA function (MUFU.EX2 plus
// range handling), about 2 ulp.
//
// Occupancy: at Jamba's shape Bb * di = 2 * 8192 = 16384 channels. 128
// threads per block would give 128 blocks, fewer than the H100's 132
// SMs; 64-thread blocks give 256 blocks, which puts about one warp on
// each of the 528 SM sub-partitions.
//
// What bounds it on this card: per step and channel 16 exponentials on
// the SFU (16 per clock per SM) and 3 * 16 FMAs, against 12 bytes of dt,
// x, y. At Bb 2, S 2048, di 8192: 537 M exponentials, ~0.13 ms at 132 SMs
// and ~1.9 GHz, against 403 MB of dt, x, y, ~0.12 ms at 3.35 TB/s, so
// the SFU and the memory bind about equally. The step loop is serial in
// S and there is about one warp per sub-partition, so the staged tile
// loads are not hidden behind other warps' work; a later version would
// double-buffer them.
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kNS = 16;       // d_state
constexpr int kThreads = 64;  // channels per block
constexpr int kSteps = 64;    // time steps staged per tile
constexpr float kLog2e = 1.4426950408889634f;

__global__ void __launch_bounds__(kThreads)
    scan_kernel(const float* __restrict__ dt, const float* __restrict__ Bm,
                const float* __restrict__ Cm, const float* __restrict__ x,
                const float* __restrict__ A, const float* __restrict__ h0,
                float* __restrict__ y, float* __restrict__ h_out, int S,
                int di) {
  __shared__ float dt_s[kSteps][kThreads];
  __shared__ float x_s[kSteps][kThreads];
  __shared__ float b_s[kSteps][kNS];
  __shared__ float c_s[kSteps][kNS];

  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int d = blockIdx.x * kThreads + tid;
  const bool live = d < di;
  const size_t row = static_cast<size_t>(b) * S;  // step 0 of this batch row
  const size_t state = (static_cast<size_t>(b) * di + d) * kNS;

  float h[kNS], a2[kNS];
  if (live) {
    const float4* a4 = reinterpret_cast<const float4*>(A + static_cast<size_t>(d) * kNS);
    const float4* g4 = reinterpret_cast<const float4*>(h0 + state);
#pragma unroll
    for (int q = 0; q < kNS / 4; ++q) {
      const float4 av = a4[q], hv = g4[q];
      a2[4 * q + 0] = av.x * kLog2e;
      a2[4 * q + 1] = av.y * kLog2e;
      a2[4 * q + 2] = av.z * kLog2e;
      a2[4 * q + 3] = av.w * kLog2e;
      h[4 * q + 0] = hv.x;
      h[4 * q + 1] = hv.y;
      h[4 * q + 2] = hv.z;
      h[4 * q + 3] = hv.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kNS; ++k) h[k] = a2[k] = 0.0f;
  }

  for (int t0 = 0; t0 < S; t0 += kSteps) {
    const int n = min(kSteps, S - t0);
    __syncthreads();  // every thread is done with the last tile
    if (live) {
      for (int t = 0; t < n; ++t) {
        const size_t off = (row + t0 + t) * di + d;
        dt_s[t][tid] = dt[off];
        x_s[t][tid] = x[off];
      }
    }
    for (int idx = tid; idx < n * kNS; idx += kThreads) {
      const size_t off = (row + t0) * kNS + idx;
      b_s[idx / kNS][idx % kNS] = Bm[off];
      c_s[idx / kNS][idx % kNS] = Cm[off];
    }
    __syncthreads();
    if (!live) continue;
    for (int t = 0; t < n; ++t) {
      const float dtv = dt_s[t][tid];
      const float dx = dtv * x_s[t][tid];
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // 4 short sum chains
#pragma unroll
      for (int k = 0; k < kNS; ++k) {
        h[k] = fmaf(exp2f(dtv * a2[k]), h[k], dx * b_s[t][k]);
        acc[k % 4] = fmaf(h[k], c_s[t][k], acc[k % 4]);
      }
      y[(row + t0 + t) * di + d] = (acc[0] + acc[1]) + (acc[2] + acc[3]);
    }
  }

  if (live) {
    float4* o4 = reinterpret_cast<float4*>(h_out + state);
#pragma unroll
    for (int q = 0; q < kNS / 4; ++q)
      o4[q] = make_float4(h[4 * q], h[4 * q + 1], h[4 * q + 2], h[4 * q + 3]);
  }
}

}  // namespace

// Plain C interface for ctypes. dt, x, y: (Bb, S, di); B, C: (Bb, S, 16);
// A: (di, 16); h0, h_out: (Bb, di, 16); all float32 and contiguous (so
// every 16-float state row is 16-byte aligned); Bb within the grid's y
// limit. The Python wrapper checks all of it. Returns cudaGetLastError()
// after the launch.
extern "C" int mamba_scan_f32(const void* dt, const void* Bm, const void* Cm,
                              const void* x, const void* A, const void* h0,
                              void* y, void* h_out, int Bb, int S, int di,
                              void* stream) {
  const dim3 grid((di + kThreads - 1) / kThreads, Bb);
  scan_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dt), static_cast<const float*>(Bm),
      static_cast<const float*>(Cm), static_cast<const float*>(x),
      static_cast<const float*>(A), static_cast<const float*>(h0),
      static_cast<float*>(y), static_cast<float*>(h_out), S, di);
  return static_cast<int>(cudaGetLastError());
}
