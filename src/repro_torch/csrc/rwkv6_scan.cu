// RWKV-6 WKV recurrence for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/rwkv6_scan/kernel.py
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
// step by step, which is exact and needs no rescale: column e of the
// state needs only v[:, e], so one CUDA block owns 32 state columns of
// one (b, h) and a grid of (B*H, hd/32) blocks runs them all at once.
// Each of the block's 4 warps holds 16 rows x 32 columns of the state in
// registers (16 per thread); r, k, w for 32 steps and v for the block's
// columns are staged in shared memory, each warp reads its rows as
// broadcasts, and the 4 warps' partial y sums meet in shared memory once
// per 32 steps.
//
// What bounds it on this card: 7 fp32 flops per state element per step
// (B*S*H*hd*hd*7, 7.5 GFLOP at B = 2, S = 2048, H = 64, hd = 64) against
// 5 * B*S*H*hd * 4 bytes (r, k, v, w in, y out; 336 MB there): about 0.11
// ms of fp32 FMA and 0.10 ms of memory, so both are near. The step loop
// is serial in S, so the kernel's time is set by latency: 2048 dependent
// steps per block, with 8 warps per SM at that shape.
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kHD = 64;                   // head width
constexpr int kCols = 32;                 // state columns per block
constexpr int kWarps = 4;                 // warp g owns rows [16g, 16g+16)
constexpr int kRows = kHD / kWarps;       // state rows per thread
constexpr int kSteps = 32;                // time steps staged per pass
constexpr int kThreads = kCols * kWarps;  // 128

__global__ void __launch_bounds__(kThreads)
    wkv6_kernel(const float* __restrict__ r, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ w,
                const float* __restrict__ u, float* __restrict__ y,
                float* __restrict__ s_out, int S, int H) {
  __shared__ float r_s[kSteps][kHD];
  __shared__ float k_s[kSteps][kHD];
  __shared__ float w_s[kSteps][kHD];
  __shared__ float v_s[kSteps][kCols];
  __shared__ float y_s[kSteps][kWarps][kCols];

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int e0 = blockIdx.y * kCols;
  const int lane = threadIdx.x % 32;  // state column e0 + lane
  const int g = threadIdx.x / 32;     // state rows g*16 .. g*16+15
  const size_t step = static_cast<size_t>(H) * kHD;
  const size_t base = static_cast<size_t>(b) * S * step + static_cast<size_t>(h) * kHD;

  float st[kRows], uu[kRows];
#pragma unroll
  for (int ii = 0; ii < kRows; ++ii) {
    st[ii] = 0.0f;
    uu[ii] = u[h * kHD + g * kRows + ii];
  }

  for (int t0 = 0; t0 < S; t0 += kSteps) {
    const int n = min(kSteps, S - t0);
    __syncthreads();  // the last pass's y_s has been written out
    for (int idx = threadIdx.x; idx < n * kHD; idx += kThreads) {
      const int t = idx / kHD, i = idx % kHD;
      const size_t off = base + (t0 + t) * step + i;
      r_s[t][i] = r[off];
      k_s[t][i] = k[off];
      w_s[t][i] = w[off];
    }
    for (int idx = threadIdx.x; idx < n * kCols; idx += kThreads) {
      const int t = idx / kCols, e = idx % kCols;
      v_s[t][e] = v[base + (t0 + t) * step + e0 + e];
    }
    __syncthreads();

    for (int t = 0; t < n; ++t) {
      const float ve = v_s[t][lane];
      float acc = 0.0f;
#pragma unroll
      for (int ii = 0; ii < kRows; ++ii) {
        const int i = g * kRows + ii;
        const float kv = k_s[t][i] * ve;
        acc = fmaf(r_s[t][i], fmaf(uu[ii], kv, st[ii]), acc);
        st[ii] = fmaf(w_s[t][i], st[ii], kv);
      }
      y_s[t][g][lane] = acc;
    }
    __syncthreads();

    for (int idx = threadIdx.x; idx < n * kCols; idx += kThreads) {
      const int t = idx / kCols, e = idx % kCols;
      float sum = 0.0f;
#pragma unroll
      for (int gg = 0; gg < kWarps; ++gg) sum += y_s[t][gg][e];
      y[base + (t0 + t) * step + e0 + e] = sum;
    }
  }

  float* s_bh = s_out + static_cast<size_t>(bh) * kHD * kHD;
#pragma unroll
  for (int ii = 0; ii < kRows; ++ii)
    s_bh[(g * kRows + ii) * kHD + e0 + lane] = st[ii];
}

}  // namespace

// Plain C interface for ctypes. r, k, v, w, y: (B, S, H, 64) float32;
// u: (H, 64); s_out: (B, H, 64, 64); all contiguous; B*H within the
// grid's x limit. The Python wrapper checks all of it. Returns
// cudaGetLastError() after the launch.
extern "C" int wkv6_forward_f32(const void* r, const void* k, const void* v,
                                const void* w, const void* u, void* y,
                                void* s_out, int B, int S, int H,
                                void* stream) {
  const dim3 grid(B * H, kHD / kCols);
  wkv6_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(r), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<float*>(y),
      static_cast<float*>(s_out), S, H);
  return static_cast<int>(cudaGetLastError());
}
