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
//   before every chunk of kT steps: (Bb, chunks, di, 16). It is bound by
//   those bytes, so it loads kStashTile steps a tile, two tiles in flight.
// - `scan_bwd_reverse_kernel` walks the chunks from the last. For each
//   it runs the chunk's kT steps forward again from the stash, keeping
//   a_t and p_t = a_t h_{t-1} in registers, then carries g back through
//   them with the same a_t (one exponential per state element and step
//   here, one in the stash pass): ddt, dx per channel; dA in registers;
//   dB and dC summed over the block's channels into per-block partials.
// - `scan_bwd_dbc_kernel` sums the partials over the blocks of d_inner
//   in order, `scan_bwd_dA_kernel` dA's over the batch.
// No atomics: every sum has a fixed order, so every launch gives the
// same bits.
//
// The reverse's layout: a block of 8 warps per (128 channels, batch
// row); thread (cp, jq) = (tid / 4, tid % 4) holds states 4jq..4jq+3 of
// channels 2cp and 2cp + 1 (a_t and p_t of its 8 states for the chunk's
// 8 steps: 128 registers). The sums over n (g B, g p A) are a thread's
// 4 states in order, then a reduce-scatter over the channel pair's 4
// threads (xor 1, 2), which sums as the pairwise butterfly does. A
// step's dB and dC are the thread's two channels in order, then the
// warp's 8 channel pairs by a reduce-scatter that halves the payload
// (xor 16: 4 values, xor 8: 2, xor 4: 1; pairs cp and cp ^ 4, then ^ 2,
// then ^ 1), which leaves each lane one of the step's 32 sums; then the
// 8 warps in order through shared memory, then the blocks in order in
// `scan_bwd_dbc_kernel`. Inputs come kT steps at a time into shared
// memory by cp.async, the next chunk's while this one is computed; the
// outputs go through double-buffered tiles, so one barrier a chunk
// serves both. The exponential is 2^(dt (A log2 e)) on the SFU, A
// pre-scaled as the forward kernel takes it.
//
// What bounds it on this card: the function needs per state element
// and step one exponential on the SFUs and about 17 fp32 flops, against
// dt, x, dy read and ddt, dx written once (5 x Bb S di floats). The
// kernels take two exponentials (the stash pass's, the recompute's) and
// move the stash (1.07 GB at the training shape, written and read) and
// the partials besides; the reverse runs ~250 instructions a thread
// and step, of which the shuffles of its sums are the costliest.
// chip_smoke.py prints the bounds and the time.
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "hopper.cuh"

namespace {

using hopper::cp_async16;
using hopper::cp_async_commit;
using hopper::cp_async_wait_all;
using hopper::ex2;
using hopper::ld4;

constexpr int kNS = 16;                 // d_state
constexpr int kPer = 4;                 // states of a channel per thread
constexpr int kChan = 128;              // channels per block
constexpr int kT = 8;                   // steps per chunk (stash interval)
constexpr int kStashTile = 32;          // steps a tile of the stash pass loads
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kCT = kT * kChan;         // floats in a [kT][128] channel tile
constexpr int kST = kT * kNS;           // floats in a [kT][16] state tile
constexpr unsigned kFull = 0xffffffffu;
// scan_bwd_stash_kernel: a channel a thread
constexpr int kStashThreads = kChan * kNS / kPer;  // 512
// scan_bwd_reverse_kernel: two channels a thread
constexpr int kCPL = 2;
constexpr int kThreads = kChan / kCPL * (kNS / kPer);  // 256
constexpr int kWarps = kThreads / 32;
static_assert(kCT / 4 == kThreads && 2 * kST / 4 <= kThreads, "tile split");
static_assert(kT * 2 * kNS / 4 <= kThreads, "one float4 of the partials a thread");

// scan_bwd_reverse_kernel's shared memory: 2 buffers of {dt, x, dy, B,
// C} tiles, and 2 of the outputs: the warps' dB and dC partials
// [kT][kWarps][32], the ddt and dx tiles [kT][kChan]
constexpr int kBuf = 3 * kCT + 2 * kST;
constexpr int kPart = kT * kWarps * 2 * kNS;
constexpr int kOut = kPart + 2 * kCT;
constexpr size_t kRevSmem = (2 * kBuf + 2 * kOut) * 4;
// scan_bwd_stash_kernel's: a ring of 3 buffers of {dt, x, B} tiles of
// kStashTile steps (two tiles in flight)
constexpr int kStashStages = 3;
constexpr int kStashBuf = (2 * kChan + kNS) * kStashTile;
constexpr size_t kStashSmem = kStashStages * kStashBuf * 4;

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;" ::: "memory");
}

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// Tile n (TS steps) of a (Bb, S, di) tensor for the block's channels,
// [TS][128], by a block of NT threads; steps past S and channels past di
// read as zeros.
template <int TS, int NT>
__device__ __forceinline__ void load_chan(float* dst, const float* src, int b, int n,
                                          int S, int di, int d0) {
  static_assert(TS * kChan / 4 % NT == 0, "whole float4s a thread");
#pragma unroll
  for (int i = 0; i < TS * kChan / 4 / NT; ++i) {
    const int q = threadIdx.x + NT * i;
    const int t = q / (kChan / 4), c = (q % (kChan / 4)) * 4;
    const int ts = n * TS + t;
    const bool ok = ts < S && d0 + c < di;
    const size_t off = ok ? (static_cast<size_t>(b) * S + ts) * di + d0 + c : 0;
    cp_async16(dst + t * kChan + c, src + off, ok);
  }
}

// Tile n (TS steps) of a (Bb, S, 16) tensor, [TS][16]; `lane` in
// [0, TS * 4).
template <int TS>
__device__ __forceinline__ void load_state(float* dst, const float* src, int b, int n,
                                           int S, int lane) {
  const int t = lane / (kNS / 4), c = (lane % (kNS / 4)) * 4;
  const int ts = n * TS + t;
  const bool ok = ts < S;
  const size_t off = ok ? (static_cast<size_t>(b) * S + ts) * kNS + c : 0;
  cp_async16(dst + t * kNS + c, src + off, ok);
}

// A step's dB and dC (db[4], dc[4]: this thread's 4 states, its two
// channels summed) over the warp's 8 channel pairs cp (lane / 4), by a
// reduce-scatter that halves the payload: cp and cp ^ 4 (xor 16, 4
// values), then ^ 2 (xor 8, 2), then ^ 1 (xor 4, 1). The lane keeps
// entry kNS (lane >> 4 & 1) + j0 + 2 (lane >> 3 & 1) + (lane >> 2 & 1) of
// the step's 32 (dB's 16 states, then dC's).
__device__ __forceinline__ float chan_sum(const float (&db)[kPer], const float (&dc)[kPer],
                                          int lane) {
  const bool hi = lane & 16, mid = lane & 8, lo = lane & 4;
  float k4[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j)
    k4[j] = (hi ? dc[j] : db[j]) + __shfl_xor_sync(kFull, hi ? db[j] : dc[j], 16);
  float k2[2];
#pragma unroll
  for (int j = 0; j < 2; ++j)
    k2[j] = (mid ? k4[j + 2] : k4[j]) + __shfl_xor_sync(kFull, mid ? k4[j] : k4[j + 2], 8);
  return (lo ? k2[1] : k2[0]) + __shfl_xor_sync(kFull, lo ? k2[0] : k2[1], 4);
}

// sum_n g B and sum_n g p A of the thread's two channels over the 4
// threads of a channel pair (jq = lane % 4), by a reduce-scatter: jq and
// jq ^ 1 (xor 1, 2 values), then ^ 2 (xor 2, 1), which sums each as the
// pairwise butterfly would, ((jq0 + jq1) + (jq2 + jq3)). Thread jq keeps
// channel jq >> 1's gb (jq even) or gpa (jq odd) and trades it with
// jq ^ 1: both return that channel's (gb, gpa).
__device__ __forceinline__ float2 state_sums(const float (&gb)[kCPL], const float (&gpa)[kCPL],
                                             int lane) {
  const bool odd = lane & 1, up = lane & 2;
  const float k0 = (odd ? gpa[0] : gb[0]) + __shfl_xor_sync(kFull, odd ? gb[0] : gpa[0], 1);
  const float k1 = (odd ? gpa[1] : gb[1]) + __shfl_xor_sync(kFull, odd ? gb[1] : gpa[1], 1);
  const float kept = (up ? k1 : k0) + __shfl_xor_sync(kFull, up ? k0 : k1, 2);
  const float other = __shfl_xor_sync(kFull, kept, 1);
  return odd ? make_float2(other, kept) : make_float2(kept, other);
}

__global__ void __launch_bounds__(kStashThreads, 2)
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
  const int n_chunks = (S + kT - 1) / kT, n_tiles = (S + kStashTile - 1) / kStashTile;
  constexpr int kTC = kStashTile * kChan;
  auto load = [&](int m, int buf) {
    float* dst = smem + buf * kStashBuf;
    load_chan<kStashTile, kStashThreads>(dst, dt, b, m, S, di, d0);
    load_chan<kStashTile, kStashThreads>(dst + kTC, x, b, m, S, di, d0);
    if (threadIdx.x < kStashTile * kNS / 4)
      load_state<kStashTile>(dst + 2 * kTC, Bm, b, m, S, threadIdx.x);
    cp_async_commit();
  };
  float h[kPer], a2[kPer];  // A pre-scaled by log2(e), as the forward takes it
  {
    const size_t off = (static_cast<size_t>(b) * di + d) * kNS + j0;
    const float4 hv = valid ? ld4(h0 + off) : make_float4(0.f, 0.f, 0.f, 0.f);
    const float4 av = valid ? ld4(A + static_cast<size_t>(d) * kNS + j0)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
    h[0] = hv.x; h[1] = hv.y; h[2] = hv.z; h[3] = hv.w;
    a2[0] = av.x * kLog2e; a2[1] = av.y * kLog2e; a2[2] = av.z * kLog2e;
    a2[3] = av.w * kLog2e;
  }
  load(0, 0);
  if (n_tiles > 1) load(1, 1);
  for (int m = 0; m < n_tiles; ++m) {
    const int buf = m % kStashStages;
    if (m + 1 < n_tiles)
      cp_async_wait_one();  // tile m + 1's loads may still be in flight
    else
      cp_async_wait_all();
    __syncthreads();
    if (m + 2 < n_tiles) load(m + 2, (m + 2) % kStashStages);
    const float* dts = smem + buf * kStashBuf;
    const float* xs = dts + kTC;
    const float* bs = xs + kTC;
#pragma unroll
    for (int sub = 0; sub < kStashTile / kT; ++sub) {
      const int n = m * (kStashTile / kT) + sub;
      if (n >= n_chunks) break;
      if (valid)
        *reinterpret_cast<float4*>(
            stash + ((static_cast<size_t>(b) * n_chunks + n) * di + d) * kNS + j0) =
            make_float4(h[0], h[1], h[2], h[3]);
      if (n + 1 == n_chunks) break;  // the last chunk's steps feed no stash
#pragma unroll
      for (int t = sub * kT; t < sub * kT + kT; ++t) {
        const float dtv = dts[t * kChan + c];
        const float dtx = dtv * xs[t * kChan + c];
        const float4 bv = ld4(bs + t * kNS + j0);
        const float bb[kPer] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int j = 0; j < kPer; ++j) h[j] = fmaf(dtx, bb[j], ex2(dtv * a2[j]) * h[j]);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    scan_bwd_reverse_kernel(const float* __restrict__ dt, const float* __restrict__ Bm,
                            const float* __restrict__ Cm, const float* __restrict__ x,
                            const float* __restrict__ A, const float* __restrict__ dy,
                            const float* __restrict__ dh_final, const float* __restrict__ stash,
                            float* __restrict__ ddt, float* __restrict__ dx,
                            float* __restrict__ bc_part, float* __restrict__ da_part,
                            float* __restrict__ dh0, int S, int di) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  // output buffer o: the partials [kT][kWarps][32] (dB, then dC), ddt
  // and dx [kT][kChan]
  auto out = [&](int o) { return smem + 2 * kBuf + o * kOut; };
  const int b = blockIdx.y, d0 = blockIdx.x * kChan, n_blocks = gridDim.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int cl = (threadIdx.x / kPer) * kCPL, j0 = (threadIdx.x % kPer) * kPer;
  const int d = d0 + cl;  // channels d, d + 1 (both below di or neither: di % 4 == 0)
  const bool valid = d < di;
  const int n_chunks = (S + kT - 1) / kT;
  // where this lane's step outputs go: its entry of the warp's dB/dC
  // partials (chan_sum), and the channel whose ddt, dx it writes (even
  // lanes, state_sums)
  auto load = [&](int n, int buf) {
    float* dst = smem + buf * kBuf;
    load_chan<kT, kThreads>(dst, dt, b, n, S, di, d0);
    load_chan<kT, kThreads>(dst + kCT, x, b, n, S, di, d0);
    load_chan<kT, kThreads>(dst + 2 * kCT, dy, b, n, S, di, d0);
    if (threadIdx.x < kST / 4)
      load_state<kT>(dst + 3 * kCT, Bm, b, n, S, threadIdx.x);
    else if (threadIdx.x < 2 * kST / 4)
      load_state<kT>(dst + 3 * kCT + kST, Cm, b, n, S, threadIdx.x - kST / 4);
    cp_async_commit();
  };
  // this thread's 4 states of channels d, d + 1 in (Bb, *, di, 16) m
  auto states = [&](const float* m, size_t row, float (&s)[kCPL][kPer]) {
#pragma unroll
    for (int k = 0; k < kCPL; ++k) {
      const float4 v = valid && m != nullptr ? ld4(m + (row + d + k) * kNS + j0)
                                             : make_float4(0.f, 0.f, 0.f, 0.f);
      s[k][0] = v.x; s[k][1] = v.y; s[k][2] = v.z; s[k][3] = v.w;
    }
  };
  auto stash_row = [&](int n) { return (static_cast<size_t>(b) * n_chunks + n) * di; };
  float a[kCPL][kPer], a2[kCPL][kPer], q[kCPL][kPer], da[kCPL][kPer], next[kCPL][kPer];
  states(A, 0, a);
  states(dh_final, static_cast<size_t>(b) * di, q);  // g_S a_S, a_S := 1
#pragma unroll
  for (int k = 0; k < kCPL; ++k)
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      a2[k][j] = a[k][j] * kLog2e;
      da[k][j] = 0.0f;
    }
  // chunk m's ddt and dx out, and its dB, dC partials summed over the
  // warps in order
  auto flush = [&](int m, int o) {
    const float* part = out(o);
    const float* ddts = part + kPart;
    const float* dxs = ddts + kCT;
    const int steps = min(kT, S - m * kT);
    {
      const int t = threadIdx.x / (kChan / 4), cq = (threadIdx.x % (kChan / 4)) * 4;
      if (t < steps && d0 + cq < di) {
        const size_t off = (static_cast<size_t>(b) * S + m * kT + t) * di + d0 + cq;
        *reinterpret_cast<float4*>(ddt + off) = ld4(ddts + t * kChan + cq);
        *reinterpret_cast<float4*>(dx + off) = ld4(dxs + t * kChan + cq);
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
            bc_part + ((static_cast<size_t>(b) * S + m * kT + t) * n_blocks + blockIdx.x) *
                          2 * kNS + k) = s;
      }
    }
  };
  states(stash, stash_row(n_chunks - 1), next);
  load(n_chunks - 1, 0);
  for (int it = 0; it < n_chunks; ++it) {
    const int n = n_chunks - 1 - it, buf = it & 1;
    cp_async_wait_all();
    __syncthreads();  // chunk n landed; chunk n + 1's outputs are complete
    if (n > 0) load(n - 1, buf ^ 1);
    if (it > 0) flush(n + 1, buf ^ 1);
    float* part = out(buf);
    float* ddts = part + kPart;
    float* dxs = ddts + kCT;
    float h[kCPL][kPer];
#pragma unroll
    for (int k = 0; k < kCPL; ++k)
#pragma unroll
      for (int j = 0; j < kPer; ++j) h[k][j] = next[k][j];
    if (n > 0) states(stash, stash_row(n - 1), next);
    const float* dts = smem + buf * kBuf;
    const float* xs = dts + kCT;
    const float* dys = xs + kCT;
    const float* bs = dys + kCT;
    const float* cs = bs + kST;
    const int steps = min(kT, S - n * kT);
    // The chunk forward again: a_t and p_t = a_t h_{t-1}, in registers.
    // All kT steps run: past S every input reads 0, so a_t = 1, h holds,
    // and the backward below carries g through those steps unchanged.
    float e[kT][kCPL][kPer], pr[kT][kCPL][kPer];
#pragma unroll
    for (int t = 0; t < kT; ++t) {
      const float2 dt2 = ld2(dts + t * kChan + cl), x2 = ld2(xs + t * kChan + cl);
      const float dtv[kCPL] = {dt2.x, dt2.y}, dtx[kCPL] = {dt2.x * x2.x, dt2.y * x2.y};
      const float4 bv = ld4(bs + t * kNS + j0);
      const float bb[kPer] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int k = 0; k < kCPL; ++k)
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          e[t][k][j] = ex2(dtv[k] * a2[k][j]);
          pr[t][k][j] = e[t][k][j] * h[k][j];
          h[k][j] = fmaf(dtx[k], bb[j], pr[t][k][j]);
        }
    }
    // and back
#pragma unroll
    for (int t = kT - 1; t >= 0; --t) {
      const float2 dt2 = ld2(dts + t * kChan + cl), x2 = ld2(xs + t * kChan + cl),
                   dy2 = ld2(dys + t * kChan + cl);
      const float dtv[kCPL] = {dt2.x, dt2.y}, xv[kCPL] = {x2.x, x2.y},
                  dyv[kCPL] = {dy2.x, dy2.y};
      const float4 bv = ld4(bs + t * kNS + j0), cv = ld4(cs + t * kNS + j0);
      const float bb[kPer] = {bv.x, bv.y, bv.z, bv.w};
      const float cc[kPer] = {cv.x, cv.y, cv.z, cv.w};
      const float (&pp)[kCPL][kPer] = pr[t];
      float gb[kCPL], gpa[kCPL], db[kPer], dc[kPer];
#pragma unroll
      for (int k = 0; k < kCPL; ++k) {
        const float dtx = dtv[k] * xv[k];
        float g[kPer];
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          g[j] = fmaf(dyv[k], cc[j], q[k][j]);
          const float bj = g[j] * dtx, cj = fmaf(dtx, bb[j], pp[k][j]) * dyv[k];  // h_t dy_t
          db[j] = k ? db[j] + bj : bj;  // the thread's two channels in order
          dc[j] = k ? dc[j] + cj : cj;
        }
        gb[k] = g[0] * bb[0];
        gpa[k] = (g[0] * pp[k][0]) * a[k][0];
#pragma unroll
        for (int j = 1; j < kPer; ++j) {
          gb[k] = fmaf(g[j], bb[j], gb[k]);
          gpa[k] = fmaf(g[j] * pp[k][j], a[k][j], gpa[k]);
        }
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          da[k][j] = fmaf(g[j] * pp[k][j], dtv[k], da[k][j]);
          q[k][j] = e[t][k][j] * g[j];
        }
      }
      const float2 gs = state_sums(gb, gpa, lane);
      // dB, dC over the warp's 16 channels
      part[(t * kWarps + warp) * 2 * kNS + (lane & 16 ? kNS : 0) + j0 +
           2 * ((lane >> 3) & 1) + ((lane >> 2) & 1)] = chan_sum(db, dc, lane);
      {  // lane and lane ^ 1 store the same values
        const int k = (lane >> 1) & 1;
        ddts[t * kChan + cl + k] = fmaf(k ? xv[1] : xv[0], gs.x, gs.y);
        dxs[t * kChan + cl + k] = (k ? dtv[1] : dtv[0]) * gs.x;
      }
    }
  }
  __syncthreads();  // chunk 0's outputs are complete
  flush(0, (n_chunks - 1) & 1);
  if (valid) {
#pragma unroll
    for (int k = 0; k < kCPL; ++k) {
      const size_t off = (static_cast<size_t>(b) * di + d + k) * kNS + j0;
      *reinterpret_cast<float4*>(dh0 + off) = make_float4(q[k][0], q[k][1], q[k][2], q[k][3]);
      *reinterpret_cast<float4*>(da_part + off) =
          make_float4(da[k][0], da[k][1], da[k][2], da[k][3]);
    }
  }
}

// dB, dC at (b, t, n): the blocks' partials in order, 4 states a thread.
__global__ void scan_bwd_dbc_kernel(const float* __restrict__ bc_part, float* __restrict__ dB,
                                    float* __restrict__ dC, int rows, int n_blocks) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<size_t>(rows) * 2 * kNS / 4) return;
  const size_t row = i / (2 * kNS / 4);
  const int k = static_cast<int>(i % (2 * kNS / 4)) * 4;
  const float* p = bc_part + row * n_blocks * 2 * kNS + k;
  float4 s = ld4(p);
  for (int blk = 1; blk < n_blocks; ++blk) {
    const float4 v = ld4(p + static_cast<size_t>(blk) * 2 * kNS);
    s.x += v.x;
    s.y += v.y;
    s.z += v.z;
    s.w += v.w;
  }
  *reinterpret_cast<float4*>(k < kNS ? dB + row * kNS + k : dC + row * kNS + k - kNS) = s;
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
// dh_final: (Bb, di, 16) or null (zero); stash: (Bb, ceil(S / 8), di,
// 16) scratch; bc_part: (Bb, S, ceil(di / 128), 32) scratch. All float32,
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
    err = cudaFuncSetAttribute(scan_bwd_stash_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kStashSmem));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const auto s = static_cast<cudaStream_t>(stream);
  const int n_blocks = (di + kChan - 1) / kChan;
  const dim3 grid(n_blocks, Bb);
  scan_bwd_stash_kernel<<<grid, kStashThreads, kStashSmem, s>>>(
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
  scan_bwd_dbc_kernel<<<static_cast<unsigned>((rows * 2 * kNS / 4 + 255) / 256), 256, 0, s>>>(
      static_cast<const float*>(bc_part), static_cast<float*>(dB), static_cast<float*>(dC),
      static_cast<int>(rows), n_blocks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  scan_bwd_dA_kernel<<<(di * kNS + 255) / 256, 256, 0, s>>>(static_cast<const float*>(da_part),
                                                  static_cast<float*>(dA), Bb, di);
  return static_cast<int>(cudaGetLastError());
}
