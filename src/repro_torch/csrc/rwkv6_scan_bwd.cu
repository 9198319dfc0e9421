// Gradient of the RWKV-6 WKV recurrence for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package trains RWKV-6 through XLA's
// gradient of its jnp chunked form (src/repro/models/rwkv.py:109
// `_tmix_impl`, whose `chunk_body` sits under `jax.checkpoint`). It is
// the backward of rwkv6_scan.cu's forward. Per (batch, head), from a zero
// state, with S_t = diag(w_t) S_{t-1} + k_t v_t^T and
// y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T), and G_t the adjoint of S_t
// (G_{S-1} = dS_final, G_{t-1} = diag(w_t) G_t + r_t dy_t^T):
//
//     dr_t = S_{t-1} dy_t + u k_t (v_t . dy_t)
//     dk_t = G_t v_t + u r_t (v_t . dy_t)
//     dv_t = sum_i k_t[i] (G_t[i, :] + r_t[i] u[i] dy_t)
//     dw_t = rowsum(G_t * S_{t-1})
//     du   = sum over b, t of r_t k_t (v_t . dy_t)
//
// All fp32, hd 64. r, k, v, w, dy and the gradients are the model's
// (B, S, H, hd) tensors, read and written through their strides. The
// decays must lie in (0, 1): dw is taken as (Q - k (G v)) / w (below),
// so its rounding grows as 1/w, about 2e-7 / w of its max (w 0.01:
// 1.5e-5), and w = 0 divides by zero. The model's decay clamp keeps w
// at or above exp(-exp(-1)) = 0.69.
//
// Three kernels, launched in order by one call:
// - `wkv6_bwd_sweep_kernel` runs the recurrence again, step by step,
//   and writes dr_t and a_t = r_t * (S_{t-1} dy_t) (into dw, as
//   scratch), and the state after every chunk of kT steps into a stash
//   (B, H, chunks, 64, 64).
// - `wkv6_bwd_reverse_kernel` carries G from the last step to the first
//   and writes dk, dv and dw, and each (b, h)'s du. The decay's gradient
//   needs S_{t-1} and G_t at the same step. It uses
//       Q_t := rowsum(G_t * S_t),  w_t dw_t = Q_t - k_t * (G_t v_t),
//       Q_{t-1} = Q_t - k_t * (G_t v_t) + a_t,
//   with Q taken exactly (from the stash) at the last step of every
//   chunk and walked down through the chunk's kT steps. The identity
//   alone, from the last step, subtracts sums over the whole sequence;
//   anchored every kT steps its rounding is that of at most kT steps.
// - `wkv6_bwd_du_kernel` sums du over the batch in order.
// No atomics: every sum has a fixed order, so every launch gives the
// same bits.
//
// Layout: a block of 4 warps per (b, h). Warp g owns state rows
// 16g..16g+15; lane (ri, ci) = (lane / 8, lane % 8) holds rows
// 16g+4ri..+3 of columns 4ci..4ci+3 and 32+4ci..+3: 32 elements of the
// state (forward) or of G (reverse) in registers. Row sums (S dy, G v,
// Q) are a lane's 8 columns in order, then the xor-1, 2, 4 butterfly
// over the row's 8 lanes; dv's column sums are a lane's 4 rows in order,
// the xor-8, 16 butterfly over the warp's 4 row groups, then the 4
// warps' partials in order through shared memory at the chunk's end.
// Inputs come kT steps at a time into shared memory by cp.async, the
// next chunk's while this one is computed.
//
// What bounds it on this card: per step and head 12 hd^2 fp32 flops
// (the states again, S dy, G's update, G v, G^T k) at the FMA peak,
// against 9 (B, S, H, hd) fp32 tensors read or written once (the
// kernels also move a's scratch and the stash). dw needs no work per
// state element and step: the Q walk is O(hd) a step, plus one exact
// rowsum(G * S) a chunk.
// chip_smoke.py prints both bounds and the time. Neither is reached: each (b, h) is a serial loop over S on
// one SM, four warps each issuing its 32 elements' operations and the
// butterflies for every step.
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "hopper.cuh"

namespace {

using hopper::cp_async16;
using hopper::cp_async_commit;
using hopper::cp_async_wait_all;
using hopper::ld4;

constexpr int kHD = 64;                 // head width
constexpr int kT = 32;                  // steps per chunk (stash interval)
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = kT * kHD;         // floats in one [kT][64] tile
constexpr int kState = kHD * kHD;       // floats in one state
constexpr int kQuads = kTile / 4 / kThreads;  // float4s per thread per tile
static_assert(kQuads * 4 * kThreads == kTile, "tile split");

// wkv6_bwd_sweep_kernel's shared memory: 2 buffers of {r, k, w, v, dy}
// tiles, then the dr and a out tiles
constexpr int kFwdIn = 5;
constexpr size_t kFwdSmem = (2 * kFwdIn + 2) * kTile * 4;
// wkv6_bwd_reverse_kernel's: 2 buffers of {r, k, w, v, dy, a} tiles and
// the stashed state, the dk and dw out tiles, dv's partials [kT][4][64]
constexpr int kRevIn = 6;
constexpr int kRevBuf = kRevIn * kTile + kState;
constexpr size_t kRevSmem = (2 * kRevBuf + 2 * kTile + kT * kWarps * kHD) * 4;

__device__ __forceinline__ void st4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

__device__ __forceinline__ float xor_sum(float x, int mask) {
  return x + __shfl_xor_sync(0xffffffffu, x, mask);
}

// The [kT][64] tile of chunk n of one (B, S, H, 64) tensor for (b, h)
// into shared memory; steps past S read as zeros.
__device__ __forceinline__ void load_tile(float* dst, const float* src, size_t base,
                                          size_t step, int n, int S) {
#pragma unroll
  for (int j = 0; j < kQuads; ++j) {
    const int q = threadIdx.x + kThreads * j;
    const int t = q / (kHD / 4), c = (q % (kHD / 4)) * 4;
    const int ts = n * kT + t;
    const bool ok = ts < S;
    cp_async16(dst + t * kHD + c, src + base + static_cast<size_t>(ok ? ts : 0) * step + c,
               ok);
  }
}

// The chunk's rows of a [kT][64] shared tile out to a (B, S, H, 64)
// tensor.
__device__ __forceinline__ void store_tile(float* dst, const float* src, size_t base,
                                           size_t step, int n, int steps) {
#pragma unroll
  for (int j = 0; j < kQuads; ++j) {
    const int q = threadIdx.x + kThreads * j;
    const int t = q / (kHD / 4), c = (q % (kHD / 4)) * 4;
    if (t < steps)
      *reinterpret_cast<float4*>(dst + base + static_cast<size_t>(n * kT + t) * step + c) =
          ld4(src + t * kHD + c);
  }
}

// A lane's 8 columns of a step's row vector in shared memory.
__device__ __forceinline__ void cols8(const float* row, int ci, float (&out)[8]) {
  const float4 a = ld4(row + 4 * ci), b = ld4(row + 32 + 4 * ci);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

__device__ __forceinline__ void rows4(const float* row, int row0, float (&out)[4]) {
  const float4 a = ld4(row + row0);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
}

// Column of a lane's j-th column slot: 4ci + c, or 32 + 4ci + (c - 4).
__device__ __forceinline__ int col_of(int ci, int c) {
  return c < 4 ? 4 * ci + c : 32 + 4 * ci + (c - 4);
}

__global__ void __launch_bounds__(kThreads, 2)
    wkv6_bwd_sweep_kernel(const float* __restrict__ r, const float* __restrict__ k,
                          const float* __restrict__ v, const float* __restrict__ w,
                          const float* __restrict__ u, const float* __restrict__ dy,
                          float* __restrict__ dr, float* __restrict__ a_out,
                          float* __restrict__ stash, int S, int H) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ri = lane / 8, ci = lane % 8;
  const int row0 = 16 * warp + 4 * ri;
  const int n_chunks = (S + kT - 1) / kT;
  const size_t step = static_cast<size_t>(H) * kHD;
  const size_t base = (static_cast<size_t>(b) * S * H + h) * kHD;
  const float* src[kFwdIn] = {r, k, w, v, dy};
  float* dr_tile = smem + 2 * kFwdIn * kTile;
  float* a_tile = dr_tile + kTile;
  auto load = [&](int n, int buf) {
#pragma unroll
    for (int x = 0; x < kFwdIn; ++x)
      load_tile(smem + (buf * kFwdIn + x) * kTile, src[x], base, step, n, S);
    cp_async_commit();
  };

  float uu[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) uu[j] = u[h * kHD + row0 + j];
  float st[4][8];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int c = 0; c < 8; ++c) st[j][c] = 0.0f;

  load(0, 0);
  for (int n = 0; n < n_chunks; ++n) {
    const int buf = n & 1;
    cp_async_wait_all();
    __syncthreads();  // chunk n landed; the other buffer and the out tiles are free
    if (n + 1 < n_chunks) load(n + 1, buf ^ 1);
    const float* rs = smem + (buf * kFwdIn + 0) * kTile;
    const float* ks = smem + (buf * kFwdIn + 1) * kTile;
    const float* ws = smem + (buf * kFwdIn + 2) * kTile;
    const float* vs = smem + (buf * kFwdIn + 3) * kTile;
    const float* ds = smem + (buf * kFwdIn + 4) * kTile;
    const int steps = min(kT, S - n * kT);
#pragma unroll 1
    for (int t = 0; t < steps; ++t) {
      float rr[4], kk[4], ww[4], vv[8], dd[8];
      rows4(rs + t * kHD, row0, rr);
      rows4(ks + t * kHD, row0, kk);
      rows4(ws + t * kHD, row0, ww);
      cols8(vs + t * kHD, ci, vv);
      cols8(ds + t * kHD, ci, dd);
      float vdy = vv[0] * dd[0];
#pragma unroll
      for (int c = 1; c < 8; ++c) vdy = fmaf(vv[c], dd[c], vdy);
      vdy = xor_sum(xor_sum(xor_sum(vdy, 1), 2), 4);
      float p[4];  // (S_{t-1} dy_t) over this lane's rows
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p[j] = st[j][0] * dd[0];
#pragma unroll
        for (int c = 1; c < 8; ++c) p[j] = fmaf(st[j][c], dd[c], p[j]);
        p[j] = xor_sum(xor_sum(xor_sum(p[j], 1), 2), 4);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int c = 0; c < 8; ++c) st[j][c] = fmaf(ww[j], st[j][c], kk[j] * vv[c]);
      if (ci == 0) {
        float o[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) o[j] = fmaf(uu[j] * kk[j], vdy, p[j]);
        st4(dr_tile + t * kHD + row0, o[0], o[1], o[2], o[3]);
        st4(a_tile + t * kHD + row0, rr[0] * p[0], rr[1] * p[1], rr[2] * p[2],
            rr[3] * p[3]);
      }
    }
    // the state after the chunk
    float* sp = stash + (static_cast<size_t>(bh) * n_chunks + n) * kState;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      st4(sp + (row0 + j) * kHD + 4 * ci, st[j][0], st[j][1], st[j][2], st[j][3]);
      st4(sp + (row0 + j) * kHD + 32 + 4 * ci, st[j][4], st[j][5], st[j][6], st[j][7]);
    }
    __syncthreads();  // the out tiles are complete
    store_tile(dr, dr_tile, base, step, n, steps);
    store_tile(a_out, a_tile, base, step, n, steps);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    wkv6_bwd_reverse_kernel(const float* __restrict__ r, const float* __restrict__ k,
                            const float* __restrict__ v, const float* __restrict__ w,
                            const float* __restrict__ u, const float* __restrict__ dy,
                            const float* __restrict__ ds_final, const float* __restrict__ stash,
                            float* __restrict__ dk, float* __restrict__ dv,
                            float* a_dw,  // in: a_t; out: dw_t
                            float* __restrict__ du_part, int S, int H) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ri = lane / 8, ci = lane % 8;
  const int row0 = 16 * warp + 4 * ri;
  const int n_chunks = (S + kT - 1) / kT;
  const size_t step = static_cast<size_t>(H) * kHD;
  const size_t base = (static_cast<size_t>(b) * S * H + h) * kHD;
  const float* src[kRevIn] = {r, k, w, v, dy, a_dw};
  float* dk_tile = smem + 2 * kRevBuf;
  float* dw_tile = dk_tile + kTile;
  float* part = dw_tile + kTile;  // [kT][kWarps][64]
  auto load = [&](int n, int buf) {
    float* dst = smem + buf * kRevBuf;
#pragma unroll
    for (int x = 0; x < kRevIn; ++x) load_tile(dst + x * kTile, src[x], base, step, n, S);
    const float* sp = stash + (static_cast<size_t>(bh) * n_chunks + n) * kState;
#pragma unroll
    for (int j = 0; j < kState / 4 / kThreads; ++j) {
      const int q = (threadIdx.x + kThreads * j) * 4;
      cp_async16(dst + kRevIn * kTile + q, sp + q, true);
    }
    cp_async_commit();
  };

  float uu[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) uu[j] = u[h * kHD + row0 + j];
  float G[4][8];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int c = 0; c < 8; ++c)
      G[j][c] = ds_final == nullptr
                    ? 0.0f
                    : ds_final[static_cast<size_t>(bh) * kState + (row0 + j) * kHD +
                               col_of(ci, c)];
  float du[4] = {0.0f, 0.0f, 0.0f, 0.0f};

  load(n_chunks - 1, 0);
  for (int it = 0; it < n_chunks; ++it) {
    const int n = n_chunks - 1 - it, buf = it & 1;
    cp_async_wait_all();
    __syncthreads();
    if (n > 0) load(n - 1, buf ^ 1);
    const float* in = smem + buf * kRevBuf;
    const float* rs = in;
    const float* ks = in + kTile;
    const float* ws = in + 2 * kTile;
    const float* vs = in + 3 * kTile;
    const float* ds = in + 4 * kTile;
    const float* as = in + 5 * kTile;
    const float* sm = in + 6 * kTile;  // the state after the chunk's last step
    const int steps = min(kT, S - n * kT);
    // Q at the chunk's last step, exactly
    float Q[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float s8[8];
      cols8(sm + (row0 + j) * kHD, ci, s8);
      Q[j] = G[j][0] * s8[0];
#pragma unroll
      for (int c = 1; c < 8; ++c) Q[j] = fmaf(G[j][c], s8[c], Q[j]);
      Q[j] = xor_sum(xor_sum(xor_sum(Q[j], 1), 2), 4);
    }
#pragma unroll 1
    for (int t = steps - 1; t >= 0; --t) {
      float rr[4], kk[4], ww[4], aa[4], vv[8], dd[8];
      rows4(rs + t * kHD, row0, rr);
      rows4(ks + t * kHD, row0, kk);
      rows4(ws + t * kHD, row0, ww);
      rows4(as + t * kHD, row0, aa);
      cols8(vs + t * kHD, ci, vv);
      cols8(ds + t * kHD, ci, dd);
      float vdy = vv[0] * dd[0];
#pragma unroll
      for (int c = 1; c < 8; ++c) vdy = fmaf(vv[c], dd[c], vdy);
      vdy = xor_sum(xor_sum(xor_sum(vdy, 1), 2), 4);
      float gv[4], okk[4], odw[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        gv[j] = G[j][0] * vv[0];
#pragma unroll
        for (int c = 1; c < 8; ++c) gv[j] = fmaf(G[j][c], vv[c], gv[j]);
        gv[j] = xor_sum(xor_sum(xor_sum(gv[j], 1), 2), 4);
        const float ck = kk[j] * gv[j];
        okk[j] = fmaf(uu[j] * rr[j], vdy, gv[j]);
        const float qm = Q[j] - ck;  // w_t dw_t
        odw[j] = qm / ww[j];
        Q[j] = qm + aa[j];
        du[j] = fmaf(rr[j] * kk[j], vdy, du[j]);
      }
      // dv: this lane's 4 rows, then the warp's 4 row groups
      float pv[8];
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        pv[c] = kk[0] * fmaf(rr[0] * uu[0], dd[c], G[0][c]);
#pragma unroll
        for (int j = 1; j < 4; ++j)
          pv[c] = fmaf(kk[j], fmaf(rr[j] * uu[j], dd[c], G[j][c]), pv[c]);
        pv[c] = xor_sum(xor_sum(pv[c], 8), 16);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int c = 0; c < 8; ++c) G[j][c] = fmaf(ww[j], G[j][c], rr[j] * dd[c]);
      if (ri == 0) {
        float* pp = part + (t * kWarps + warp) * kHD;
        st4(pp + 4 * ci, pv[0], pv[1], pv[2], pv[3]);
        st4(pp + 32 + 4 * ci, pv[4], pv[5], pv[6], pv[7]);
      }
      if (ci == 0) {
        st4(dk_tile + t * kHD + row0, okk[0], okk[1], okk[2], okk[3]);
        st4(dw_tile + t * kHD + row0, odw[0], odw[1], odw[2], odw[3]);
      }
    }
    __syncthreads();  // the out tiles and dv's partials are complete
    store_tile(dk, dk_tile, base, step, n, steps);
    store_tile(a_dw, dw_tile, base, step, n, steps);
#pragma unroll
    for (int j = 0; j < kQuads; ++j) {
      const int q = threadIdx.x + kThreads * j;
      const int t = q / (kHD / 4), c = (q % (kHD / 4)) * 4;
      if (t < steps) {
        const float* pp = part + t * kWarps * kHD + c;
        float4 s = ld4(pp);
#pragma unroll
        for (int g = 1; g < kWarps; ++g) {
          const float4 x = ld4(pp + g * kHD);
          s.x += x.x;
          s.y += x.y;
          s.z += x.z;
          s.w += x.w;
        }
        *reinterpret_cast<float4*>(dv + base + static_cast<size_t>(n * kT + t) * step +
                                   c) = s;
      }
    }
  }
  if (ci == 0)
    st4(du_part + static_cast<size_t>(bh) * kHD + row0, du[0], du[1], du[2], du[3]);
}

// du[h, i] = sum over b of du_part[b, h, i], b in order.
__global__ void wkv6_bwd_du_kernel(const float* __restrict__ du_part, float* __restrict__ du,
                                   int B, int H) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= H * kHD) return;
  float s = du_part[i];
  for (int b = 1; b < B; ++b) s += du_part[static_cast<size_t>(b) * H * kHD + i];
  du[i] = s;
}

}  // namespace

// Plain C interface for ctypes. r, k, v, w, dy, dr, dk, dv, dw: (B, S, H,
// 64) float32; u, du: (H, 64); ds_final: (B, H, 64, 64) or null (zero);
// du_part: (B, H, 64) scratch; stash: (B, H, ceil(S / 32), 64, 64)
// scratch. All contiguous and 16-byte aligned; B*H within the grid's x
// limit. The Python wrapper checks all of it. Returns cudaGetLastError()
// after the launches, or the error that kept a kernel from launching.
extern "C" int wkv6_backward_f32(const void* r, const void* k, const void* v,
                                 const void* w, const void* u, const void* dy,
                                 const void* ds_final, void* dr, void* dk, void* dv,
                                 void* dw, void* du, void* du_part, void* stash, int B,
                                 int S, int H, void* stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        wkv6_bwd_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kFwdSmem));
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncSetAttribute(wkv6_bwd_reverse_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kRevSmem));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* fr = static_cast<const float*>(r);
  const auto* fk = static_cast<const float*>(k);
  const auto* fv = static_cast<const float*>(v);
  const auto* fw = static_cast<const float*>(w);
  const auto* fu = static_cast<const float*>(u);
  const auto* fdy = static_cast<const float*>(dy);
  wkv6_bwd_sweep_kernel<<<B * H, kThreads, kFwdSmem, s>>>(
      fr, fk, fv, fw, fu, fdy, static_cast<float*>(dr), static_cast<float*>(dw),
      static_cast<float*>(stash), S, H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  wkv6_bwd_reverse_kernel<<<B * H, kThreads, kRevSmem, s>>>(
      fr, fk, fv, fw, fu, fdy, static_cast<const float*>(ds_final),
      static_cast<const float*>(stash), static_cast<float*>(dk), static_cast<float*>(dv),
      static_cast<float*>(dw), static_cast<float*>(du_part), S, H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  wkv6_bwd_du_kernel<<<(H * kHD + 255) / 256, 256, 0, s>>>(static_cast<const float*>(du_part),
                                                  static_cast<float*>(du), B, H);
  return static_cast<int>(cudaGetLastError());
}
