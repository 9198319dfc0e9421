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
//     dv_t = G_t^T k_t + (sum_i r_t u k_t) dy_t
//     dw_t = rowsum(G_t * S_{t-1})
//     du   = sum over b, t of r_t k_t (v_t . dy_t)
//
// All fp32, hd 64. r, k, v, w, dy and the gradients are the model's
// (B, S, H, hd) tensors, read and written through their strides. The
// decays must lie in (0, 1): dw is taken as (Q - k (G v)) / w (below),
// so its rounding grows as 1/w, about 2e-7 / w of its max (w 0.01:
// 1.6e-5), and w = 0 divides by zero. The model's decay clamp keeps w
// at or above exp(-exp(-1)) = 0.69.
//
// A column j of S, and of G, evolves alone: S_t[:, j] = w_t S_{t-1}[:, j]
// + k_t v_t[j]. Every sum over columns (S dy, G v, rowsum(G * S)) is an
// output and feeds nothing back, so the state is split into kGroups
// groups of 16 columns, a warp each, that run side by side with no sum
// crossing them in the step loops; the groups' partial rows meet once a
// tile of kT steps, in group order. Three kernels, launched in order by
// one call:
// - `wkv6_bwd_sweep_kernel` runs the recurrence again: S_{t-1} dy_t (dr
//   less its bonus term) into dr, and the state after every kStash steps
//   and after the last into a stash (B, H, ceil(S / kStash), 64, 64).
// - `wkv6_bwd_reverse_kernel` walks the tiles from the last, carrying G:
//   per group (G_t v_t)^J and G_t^T k_t over its columns (whole within the
//   group), G's update; once a tile, dr (adding the bonus), dk, dv, and
//   the decay's gradient from
//       Q_t := rowsum(G_t * S_t),  w_t dw_t = Q_t - k_t (G_t v_t),
//       Q_{t-1} = Q_t - k_t (G_t v_t) + r_t (S_{t-1} dy_t),
//   with Q taken exactly at each stashed state (the groups' row sums
//   summed) and walked down to the next, a row a thread. (The identity
//   alone, from the last step, subtracts sums over the whole sequence;
//   anchored every kStash steps its rounding is that of at most kStash
//   steps.) v . dy and sum_i r u k are taken once a step, du per (b, h)
//   in step order. S dy comes from the sweep, so no state is recomputed.
// - `wkv6_bwd_du_kernel` sums du over the batch in order.
// No atomics: every sum has a fixed order, so every launch gives the
// same bits.
//
// Layout: a block of 4 warps per (b, h), warp J the column group J
// (columns 16J..16J+15, all 64 rows); lane (rq, ch) = (lane / 2, lane % 2)
// holds rows 4rq..4rq+3 of columns 16J + 8ch..+7: 32 elements of the
// state (sweep) or of G (reverse) in registers. A row sum over J is a
// lane's 8 columns in order, then the row's 2 lanes (xor 1, each lane
// keeping 2 of its 4 rows); dv's column sums are a lane's 4 rows in
// order, then the warp's 16 row quads by a reduce-scatter (xor 16, 8, 4
// halving the payload, then 2). The vectors a step reads (r, k, w over
// rows, v, dy over columns) come out of shared memory once per lane, so
// a lane's 32 elements share them. Inputs come kT steps at a time into
// shared memory by cp.async, the next tile's while this one is computed.
// Shared memory: the sweep 48 KB a block, the reverse 69 KB (three
// blocks an SM).
//
// What bounds it on this card: per step and head 12 hd^2 fp32 flops
// (the states again, S dy, G's update, G v, G^T k) at the FMA peak,
// against 9 (B, S, H, hd) fp32 tensors read or written once (the kernels
// also move the stash and S dy). dw needs no work per state element and
// step: the Q walk is O(hd) a step, plus one exact rowsum(G * S) a
// stash. chip_smoke.py prints both bounds and the time. Neither is
// reached: each (b, h) is a serial loop over S on one SM, and the
// shuffles and shared-memory reads run beside the FMAs.
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "hopper.cuh"

namespace {

using hopper::cp_async16;
using hopper::cp_async_commit;
using hopper::cp_async_wait_all;
using hopper::ld4;

constexpr int kHD = 64;                    // head width
constexpr int kT = 16;                     // steps a tile holds
constexpr int kStash = 32;                 // steps between stashed states
constexpr int kSub = kStash / kT;          // tiles between stashed states
constexpr int kGroups = 4;                 // column groups of the state, a warp each
constexpr int kGCols = kHD / kGroups;      // columns a group
constexpr int kThreads = kGroups * 32;     // 128
constexpr int kTile = kT * kHD;            // floats in one [kT][64] tile
constexpr int kState = kHD * kHD;          // floats in one state
constexpr int kQuads = kTile / 4 / kThreads;  // float4s of a tile per thread
constexpr unsigned kFull = 0xffffffffu;
static_assert(kQuads * 4 * kThreads == kTile, "tile split");
static_assert(kSub * kT == kStash, "whole tiles between stashed states");
static_assert(kGCols == 16, "a lane holds 4 rows x 8 columns of its group");

// wkv6_bwd_sweep_kernel's shared memory: 2 buffers of {k, w, v, dy}
// tiles, the groups' partial rows of S dy [kGroups][kT][64]
constexpr int kSweepIn = 4;
constexpr size_t kSweepSmem = (2 * kSweepIn * kTile + kGroups * kTile) * 4;
// wkv6_bwd_reverse_kernel's: 2 buffers of {r, k, w, v, dy, S dy} tiles;
// the groups' partial rows of G v [kGroups][kT][64]; G^T k [kT][64]; the
// groups' rowsum(G * S) at a stashed state [kGroups][64]; v . dy and
// sum_i r u k of each step [kT]
constexpr int kRevIn = 6;
constexpr size_t kRevSmem =
    (2 * kRevIn * kTile + kGroups * kTile + kTile + kGroups * kHD + 2 * kT) * 4;
static_assert(3 * kRevSmem <= 232448, "three blocks an SM");

__device__ __forceinline__ void st4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

__device__ __forceinline__ void add4(float4& s, const float4 x) {
  s.x += x.x;
  s.y += x.y;
  s.z += x.z;
  s.w += x.w;
}

// This lane's place in the state: group J = its warp; rows row0..row0 + 3
// (rq = lane / 2), columns col0..col0 + 7 (ch = lane % 2) of the group's
// 16. Its row sums keep rows row0 + 2 ch, + 1.
struct Place {
  int grp, ch, row0, col0;
};

__device__ __forceinline__ Place place() {
  const int lane = threadIdx.x % 32;
  Place p;
  p.grp = threadIdx.x / 32;
  p.ch = lane % 2;
  p.row0 = 4 * (lane / 2);
  p.col0 = kGCols * p.grp + 8 * p.ch;
  return p;
}

__device__ __forceinline__ void row4(const float* p, float (&x)[4]) {
  const float4 a = ld4(p);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
}

__device__ __forceinline__ void cols8(const float* p, float (&x)[8]) {
  const float4 a = ld4(p), b = ld4(p + 4);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

// sum_c m[c] x[c] over a lane's 8 columns, in order.
__device__ __forceinline__ float dot8(const float (&m)[8], const float (&x)[8]) {
  float s = m[0] * x[0];
#pragma unroll
  for (int c = 1; c < 8; ++c) s = fmaf(m[c], x[c], s);
  return s;
}

// The 4 rows' sums over the group's 16 columns from each lane's partials:
// the row's 2 lanes added (xor 1, halving the payload); the lane keeps
// rows 2 ch, 2 ch + 1 of its 4.
__device__ __forceinline__ float2 row_sum(const float (&x)[4], int ch) {
  float k0 = ch ? x[2] : x[0], k1 = ch ? x[3] : x[1];
  k0 += __shfl_xor_sync(kFull, ch ? x[0] : x[2], 1);
  k1 += __shfl_xor_sync(kFull, ch ? x[1] : x[3], 1);
  return make_float2(k0, k1);
}

// Column sums of a lane's 8 columns over the warp's 16 row quads rq,
// halving: rq and rq ^ 8, then ^ 4, ^ 2, ^ 1 (lane bits 4, 3, 2, 1). The
// lane keeps column 4 (lane >> 4 & 1) + 2 (lane >> 3 & 1) + (lane >> 2 & 1).
__device__ __forceinline__ float col_sum(const float (&x)[8], int lane) {
  const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4;
  float k4[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    k4[i] = (b4 ? x[i + 4] : x[i]) + __shfl_xor_sync(kFull, b4 ? x[i] : x[i + 4], 16);
  float k2[2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    k2[i] = (b3 ? k4[i + 2] : k4[i]) + __shfl_xor_sync(kFull, b3 ? k4[i] : k4[i + 2], 8);
  const float k1 = (b2 ? k2[1] : k2[0]) + __shfl_xor_sync(kFull, b2 ? k2[0] : k2[1], 4);
  return k1 + __shfl_xor_sync(kFull, k1, 2);
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

// The recurrence again, kT steps a tile: S dy (dr less its bonus term)
// into dr, and the state after every kStash steps and after the last.
__global__ void __launch_bounds__(kThreads, 4)
    wkv6_bwd_sweep_kernel(const float* __restrict__ k, const float* __restrict__ v,
                          const float* __restrict__ w, const float* __restrict__ dy,
                          float* __restrict__ dr, float* __restrict__ stash, int S, int H) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* Pt = smem + 2 * kSweepIn * kTile;  // [kGroups][kT][64]: (S_{t-1} dy_t)^J
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const Place P = place();
  const int n_tiles = (S + kT - 1) / kT, n_stash = (S + kStash - 1) / kStash;
  const size_t step = static_cast<size_t>(H) * kHD;
  const size_t base = (static_cast<size_t>(b) * S * H + h) * kHD;
  const float* src[kSweepIn] = {k, w, v, dy};
  auto load = [&](int n, int buf) {
#pragma unroll
    for (int x = 0; x < kSweepIn; ++x)
      load_tile(smem + (buf * kSweepIn + x) * kTile, src[x], base, step, n, S);
    cp_async_commit();
  };
  const int e4 = (threadIdx.x % (kHD / 4)) * 4;

  float st[4][8];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int c = 0; c < 8; ++c) st[j][c] = 0.0f;

  load(0, 0);
  for (int n = 0; n < n_tiles; ++n) {
    const int buf = n & 1;
    cp_async_wait_all();
    __syncthreads();  // tile n landed; the other buffer and the partial rows are free
    if (n + 1 < n_tiles) load(n + 1, buf ^ 1);
    const float* ks = smem + (buf * kSweepIn + 0) * kTile;
    const float* ws = smem + (buf * kSweepIn + 1) * kTile;
    const float* vs = smem + (buf * kSweepIn + 2) * kTile;
    const float* ds = smem + (buf * kSweepIn + 3) * kTile;
    const int steps = min(kT, S - n * kT);
    float* Pg = Pt + P.grp * kTile + P.row0 + 2 * P.ch;
#pragma unroll 1
    for (int t = 0; t < steps; ++t) {
      float kk[4], ww[4], vv[8], dd[8], p[4];
      row4(ks + t * kHD + P.row0, kk);
      row4(ws + t * kHD + P.row0, ww);
      cols8(vs + t * kHD + P.col0, vv);
      cols8(ds + t * kHD + P.col0, dd);
#pragma unroll
      for (int j = 0; j < 4; ++j) p[j] = dot8(st[j], dd);
      *reinterpret_cast<float2*>(Pg + t * kHD) = row_sum(p, P.ch);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int c = 0; c < 8; ++c) st[j][c] = fmaf(ww[j], st[j][c], kk[j] * vv[c]);
    }
    if (n % kSub == kSub - 1 || n + 1 == n_tiles) {
      float* sp = stash + (static_cast<size_t>(bh) * n_stash + n / kSub) * kState;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        st4(sp + (P.row0 + j) * kHD + P.col0, st[j][0], st[j][1], st[j][2], st[j][3]);
        st4(sp + (P.row0 + j) * kHD + P.col0 + 4, st[j][4], st[j][5], st[j][6], st[j][7]);
      }
    }
    __syncthreads();  // the partial rows are complete
    // S dy: the groups' partial rows in group order
#pragma unroll
    for (int j = 0; j < kQuads; ++j) {
      const int et = (threadIdx.x + kThreads * j) / (kHD / 4);
      if (et >= steps) continue;
      const int o = et * kHD + e4;
      float4 p = ld4(Pt + o);
#pragma unroll
      for (int g = 1; g < kGroups; ++g) add4(p, ld4(Pt + g * kTile + o));
      *reinterpret_cast<float4*>(dr + base + static_cast<size_t>(n * kT + et) * step + e4) = p;
    }
  }
}

__global__ void __launch_bounds__(kThreads, 3)
    wkv6_bwd_reverse_kernel(const float* __restrict__ r, const float* __restrict__ k,
                            const float* __restrict__ v, const float* __restrict__ w,
                            const float* __restrict__ u, const float* __restrict__ dy,
                            const float* __restrict__ ds_final, const float* __restrict__ stash,
                            float* dr,  // in: S dy; out: dr
                            float* __restrict__ dk, float* __restrict__ dv,
                            float* __restrict__ dw, float* __restrict__ du_part, int S,
                            int H) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* GVt = smem + 2 * kRevIn * kTile;  // [kGroups][kT][64]: (G_t v_t)^J
  float* DVt = GVt + kGroups * kTile;      // [kT][64]: G_t^T k_t
  float* QJ = DVt + kTile;                 // [kGroups][64]: rowsum_J(G * S)
  float* VDY = QJ + kGroups * kHD;         // [kT]: v_t . dy_t
  float* RUK = VDY + kT;                   // [kT]: sum_i r_t u k_t
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int lane = threadIdx.x % 32;
  const Place P = place();
  const int n_tiles = (S + kT - 1) / kT, n_stash = (S + kStash - 1) / kStash;
  const size_t step = static_cast<size_t>(H) * kHD;
  const size_t base = (static_cast<size_t>(b) * S * H + h) * kHD;
  const float* src[kRevIn] = {r, k, w, v, dy, dr};
  auto load = [&](int n, int buf) {
#pragma unroll
    for (int x = 0; x < kRevIn; ++x)
      load_tile(smem + (buf * kRevIn + x) * kTile, src[x], base, step, n, S);
    cp_async_commit();
  };
  // A state's 32 elements of this lane (zero for null).
  auto lane_state = [&](const float* m, float (&s)[4][8]) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float4 a = m == nullptr ? make_float4(0.f, 0.f, 0.f, 0.f)
                                    : ld4(m + (P.row0 + j) * kHD + P.col0);
      const float4 c = m == nullptr ? make_float4(0.f, 0.f, 0.f, 0.f)
                                    : ld4(m + (P.row0 + j) * kHD + P.col0 + 4);
      s[j][0] = a.x; s[j][1] = a.y; s[j][2] = a.z; s[j][3] = a.w;
      s[j][4] = c.x; s[j][5] = c.y; s[j][6] = c.z; s[j][7] = c.w;
    }
  };
  const float* sb = stash + static_cast<size_t>(bh) * n_stash * kState;
  // The thread's 4 rows (or columns) in the per-tile passes.
  const int e4 = (threadIdx.x % (kHD / 4)) * 4;
  const float4 u4 = ld4(u + h * kHD + e4);

  float G[4][8], next[4][8];
  lane_state(ds_final == nullptr ? nullptr : ds_final + static_cast<size_t>(bh) * kState, G);
  lane_state(sb + static_cast<size_t>(n_stash - 1) * kState, next);
  float Q = 0.0f, du = 0.0f;  // row threadIdx.x's, threads below kHD

  load(n_tiles - 1, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int n = n_tiles - 1 - it, buf = it & 1;
    cp_async_wait_all();
    __syncthreads();  // tile n landed; the other buffer and the partial rows are free
    if (n > 0) load(n - 1, buf ^ 1);
    const float* in = smem + buf * kRevIn * kTile;
    const float* rs = in;
    const float* ks = in + kTile;
    const float* ws = in + 2 * kTile;
    const float* vs = in + 3 * kTile;
    const float* ds = in + 4 * kTile;
    const float* ps = in + 5 * kTile;
    const int steps = min(kT, S - n * kT);
    // At a stashed state (the tile ends a kStash chunk, or the sequence):
    // the groups' rowsum(G * S) there, exactly, to anchor the walk below.
    const bool anchor = n % kSub == kSub - 1 || n + 1 == n_tiles;
    if (anchor) {
      float q[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) q[j] = dot8(G[j], next[j]);
      *reinterpret_cast<float2*>(QJ + P.grp * kHD + P.row0 + 2 * P.ch) = row_sum(q, P.ch);
      const int m = n / kSub;  // the state after chunk m; the next anchor's is m - 1
      if (m > 0) lane_state(sb + static_cast<size_t>(m - 1) * kState, next);
    }

    // v . dy and sum_i r u k of each step: 4 columns (rows) a thread in
    // order, then the step's 16 threads pairwise
#pragma unroll
    for (int j = 0; j < kQuads; ++j) {
      const int et = (threadIdx.x + kThreads * j) / (kHD / 4), o = et * kHD + e4;
      const float4 vv = ld4(vs + o), dd = ld4(ds + o), rr = ld4(rs + o), kk = ld4(ks + o);
      float vd = vv.x * dd.x;
      vd = fmaf(vv.y, dd.y, vd);
      vd = fmaf(vv.z, dd.z, vd);
      vd = fmaf(vv.w, dd.w, vd);
      float ruk = (rr.x * u4.x) * kk.x;
      ruk = fmaf(rr.y * u4.y, kk.y, ruk);
      ruk = fmaf(rr.z * u4.z, kk.z, ruk);
      ruk = fmaf(rr.w * u4.w, kk.w, ruk);
#pragma unroll
      for (int m = 1; m < kHD / 4; m *= 2) {
        vd += __shfl_xor_sync(kFull, vd, m);
        ruk += __shfl_xor_sync(kFull, ruk, m);
      }
      if (e4 == 0) {
        VDY[et] = vd;
        RUK[et] = ruk;
      }
    }

    // G back through the tile's steps: the group's (G v)^J and its columns
    // of G^T k
    float* GVg = GVt + P.grp * kTile + P.row0 + 2 * P.ch;
    float* DVl = DVt + P.col0 + 4 * ((lane >> 4) & 1) + 2 * ((lane >> 3) & 1) +
                 ((lane >> 2) & 1);
#pragma unroll 1
    for (int t = steps - 1; t >= 0; --t) {
      float rr[4], kk[4], ww[4], vv[8], dd[8], g[4], pv[8];
      row4(rs + t * kHD + P.row0, rr);
      row4(ks + t * kHD + P.row0, kk);
      row4(ws + t * kHD + P.row0, ww);
      cols8(vs + t * kHD + P.col0, vv);
      cols8(ds + t * kHD + P.col0, dd);
#pragma unroll
      for (int j = 0; j < 4; ++j) g[j] = dot8(G[j], vv);
      *reinterpret_cast<float2*>(GVg + t * kHD) = row_sum(g, P.ch);
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        pv[c] = kk[0] * G[0][c];
#pragma unroll
        for (int j = 1; j < 4; ++j) pv[c] = fmaf(kk[j], G[j][c], pv[c]);
      }
      const float dvs = col_sum(pv, lane);
      if (!(lane & 2)) DVl[t * kHD] = dvs;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int c = 0; c < 8; ++c) G[j][c] = fmaf(ww[j], G[j][c], rr[j] * dd[c]);
    }
    __syncthreads();  // the partial rows are complete

    // dr, dk, dv: each row of the tile out once, G v's partial rows in
    // group order
#pragma unroll
    for (int j = 0; j < kQuads; ++j) {
      const int et = (threadIdx.x + kThreads * j) / (kHD / 4);
      if (et >= steps) continue;
      const int o = et * kHD + e4;
      float4 gv = ld4(GVt + o);
#pragma unroll
      for (int g = 1; g < kGroups; ++g) add4(gv, ld4(GVt + g * kTile + o));
      const float4 pv = ld4(DVt + o), pp = ld4(ps + o);
      const float4 rr = ld4(rs + o), kk = ld4(ks + o), dd = ld4(ds + o);
      const float vd = VDY[et], ruk = RUK[et];
      const size_t off = base + static_cast<size_t>(n * kT + et) * step + e4;
      st4(dr + off, fmaf(u4.x * kk.x, vd, pp.x), fmaf(u4.y * kk.y, vd, pp.y),
          fmaf(u4.z * kk.z, vd, pp.z), fmaf(u4.w * kk.w, vd, pp.w));
      st4(dk + off, fmaf(u4.x * rr.x, vd, gv.x), fmaf(u4.y * rr.y, vd, gv.y),
          fmaf(u4.z * rr.z, vd, gv.z), fmaf(u4.w * rr.w, vd, gv.w));
      st4(dv + off, fmaf(ruk, dd.x, pv.x), fmaf(ruk, dd.y, pv.y), fmaf(ruk, dd.z, pv.z),
          fmaf(ruk, dd.w, pv.w));
    }
    // dw and du, a row a thread: Q = rowsum(G_t * S_t) walked down the
    // tile, w_t dw_t = Q - k_t (G_t v_t), Q <- Q - k_t (G_t v_t) + r_t (S_{t-1} dy_t)
    if (threadIdx.x < kHD) {
      const int i = threadIdx.x;
      if (anchor) Q = ((QJ[i] + QJ[kHD + i]) + QJ[2 * kHD + i]) + QJ[3 * kHD + i];
#pragma unroll 4
      for (int t = steps - 1; t >= 0; --t) {
        const int o = t * kHD + i;
        const float gv = ((GVt[o] + GVt[kTile + o]) + GVt[2 * kTile + o]) + GVt[3 * kTile + o];
        const float qm = fmaf(-ks[o], gv, Q);
        dw[base + static_cast<size_t>(n * kT + t) * step + i] = qm / ws[o];
        Q = fmaf(rs[o], ps[o], qm);
        du = fmaf(rs[o] * ks[o], VDY[t], du);
      }
    }
  }
  if (threadIdx.x < kHD) du_part[static_cast<size_t>(bh) * kHD + threadIdx.x] = du;
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
        static_cast<int>(kSweepSmem));
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
  const auto* fdy = static_cast<const float*>(dy);
  wkv6_bwd_sweep_kernel<<<B * H, kThreads, kSweepSmem, s>>>(
      fk, fv, fw, fdy, static_cast<float*>(dr), static_cast<float*>(stash), S, H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  wkv6_bwd_reverse_kernel<<<B * H, kThreads, kRevSmem, s>>>(
      fr, fk, fv, fw, static_cast<const float*>(u), fdy,
      static_cast<const float*>(ds_final), static_cast<const float*>(stash),
      static_cast<float*>(dr), static_cast<float*>(dk), static_cast<float*>(dv),
      static_cast<float*>(dw), static_cast<float*>(du_part), S, H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  wkv6_bwd_du_kernel<<<(H * kHD + 255) / 256, 256, 0, s>>>(static_cast<const float*>(du_part),
                                                  static_cast<float*>(du), B, H);
  return static_cast<int>(cudaGetLastError());
}
