// Causal GQA flash attention, backward, for Hopper (sm_90a).
//
// The gradient of csrc/flash_attention.cu's forward. The JAX package has
// no Pallas backward: it trains through its jnp attention
// (src/repro/models/layers.py:140 `attention`) and lets XLA derive the
// gradient. Here attention on the card runs through the hand-written
// forward kernel, so its gradient is hand-written too.
//
// For q, o, dO (B, S, H, hd) and k, v (B, S, Hkv, hd), with query head h
// reading KV head h / (H / Hkv), P the (causal) softmax of
// s = q k^T / sqrt(hd) and D = rowsum(dO * O):
//   dV = P^T dO,  dS = P * (dO V^T - D),  dQ = dS K / sqrt(hd),
//   dK = dS^T Q / sqrt(hd),
// dK and dV of a KV head summed over its group's query heads. P is
// rebuilt as 2^(s log2(e) / sqrt(hd) - lse) from the log-sum-exp that the
// forward wrote (base 2, fp32, (B, H, S)), with the exponential the
// forward uses, so nothing recomputes the softmax statistics. Three
// passes, each a grid of independent blocks:
// 1. `delta_kernel`: D into an fp32 (B, H, S) workspace, one 16-byte load
//    of O and of dO per thread, a row summed over a few lanes. Memory-bound.
// 2. dK and dV, one block per (b, KV head, key tile): K and V stay in
//    shared memory while the block walks, in a fixed order, the group's
//    query heads and, for each, the q tiles at or below the diagonal.
// 3. dQ, one block per (b, head, q tile): Q and dO stay in shared memory
//    while the block walks the k tiles up to the diagonal.
// Every sum is taken in a fixed order and every gradient element is
// written once: no atomics, so dq, dk and dv are bit-identical from launch
// to launch. Each gradient is rounded once to the inputs' type. Rows past
// S load as zeros, are masked, and are never stored, so any S is taken.
//
// bf16 (`fa_backward_bf16`, every LM train step on the card) runs all
// five products on the tensor cores with wgmma (m64nNk16, fp32
// accumulators, N 64 at hd 16 and 32: hopper.cuh `tile_width`), built as
// the forward's bf16 kernel: two consumer
// warpgroups of 64 resident rows each and one producer warp that keeps a
// ring of tiles filled by TMA from the forward's 4-D tensor maps
// (128-byte swizzled, rows past S read as zeros), each stage guarded by a
// "full" and an "empty" mbarrier.
// - dK/dV (`dkdv_kernel`): 128 resident keys, Q and dO tiles of 64
//   queries through the ring (with each tile's lse and D, which the
//   producer copies beside them). Two accumulators a thread leave the
//   consumers short of registers, so the producer here is a warpgroup
//   that hands its registers to them (setmaxnreg). S^T = K Q^T and dP^T = V dO^T are
//   K-major products from shared memory; P^T and dS^T = P^T (dP^T - D)
//   stay in registers, where the accumulator layout is already the A
//   operand's, and dV += P^T dO, dK += dS^T Q take dO and Q as MN-major B
//   operands (wgmma's transposed-B form, the forward's P V).
// - dQ (`dq_kernel`): 128 resident queries, 64-key K and V tiles through
//   the ring. S = Q K^T and dP = dO V^T from shared memory, dS in
//   registers, dQ += dS K with K as the MN-major B operand.
// P and dS are fp32 in registers. The bound this kernel is held to (one
// bf16 ulp of each gradient, flash_attention/ref.py BACKWARD_TOL) refuses
// either one rounded to bf16 once (dv 7-18x, dq and dk 8-31x the bound at
// S 1024-2048), so each enters its products as two bf16 terms, hi =
// bf16(x) and lo = bf16(x - hi), both summed into the same fp32
// accumulator, as the forward feeds P. s and dP are exact products of
// bf16 inputs.
//
// fp32 (`fa_backward_f32`, the card tests' fp32 cases; no LM path on the
// card trains in fp32) keeps SIMT passes 2 and 3: 256 threads as 16 x 16,
// a thread owning a 4 x 4 patch of each 64 x 64 score tile and 4 rows x
// hd/16 columns of its accumulators, operands widened to fp32 in shared
// memory, every product on fp32 FMA.
//
// What bounds it on this card: the backward does five products of 2 * hd
// flops per (query, key <= query) pair (s, dP, dV, dQ, dK), 344 GFLOP per
// StableLM-1.6B layer at B 8, S 2048, 32 heads of 64, against ~0.54 GB of
// q, k, v, o, dO in and dq, dk, dv out: bound by arithmetic, 0.35 ms at
// the bf16 tensor-core peak. The hi + lo split runs dV, dK and dQ twice
// and s appears in both passes: 10 products per pair, a floor of 0.70 ms.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// Pass 1, both types: D = rowsum(dO * O)
// ---------------------------------------------------------------------------
__device__ __forceinline__ void widen(const uint4& raw, float (&x)[4]) {
  const float* f = reinterpret_cast<const float*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) x[i] = f[i];
}
__device__ __forceinline__ void widen(const uint4& raw, float (&x)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __low2float(h[i]);
    x[2 * i + 1] = __high2float(h[i]);
  }
}

constexpr int kDeltaThreads = 256;

// Row r of the (B, S, H) rows of O and dO (memory order) is summed by
// HD / kVec neighbouring lanes, each over one 16-byte piece, then reduced
// across them by shuffles; D goes to delta[b, h, s].
template <typename T, int HD>
__global__ void __launch_bounds__(kDeltaThreads)
    delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                 float* __restrict__ delta, int S, int H, long long rows) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kLanes = HD / kVec;
  static_assert(kLanes <= 32 && 32 % kLanes == 0, "lanes per row");
  const long long t = static_cast<long long>(blockIdx.x) * kDeltaThreads + threadIdx.x;
  const long long row = t / kLanes;
  const int part = static_cast<int>(t % kLanes);
  float sum = 0.0f;
  if (row < rows) {
    const size_t at = static_cast<size_t>(row) * HD + part * kVec;
    float a[kVec], g[kVec];
    widen(*reinterpret_cast<const uint4*>(o + at), a);
    widen(*reinterpret_cast<const uint4*>(dout + at), g);
#pragma unroll
    for (int i = 0; i < kVec; ++i) sum = fmaf(g[i], a[i], sum);
  }
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (part == 0 && row < rows) {
    const long long h = row % H, bs = row / H;
    const long long s = bs % S, b = bs / S;
    delta[(b * H + h) * S + s] = sum;
  }
}

template <typename T, int HD>
cudaError_t launch_delta(const void* o, const void* dout, void* delta, int B,
                         int S, int H, cudaStream_t stream) {
  constexpr int kLanes = HD / (16 / sizeof(T));
  const long long rows = static_cast<long long>(B) * S * H;
  const long long blocks = (rows * kLanes + kDeltaThreads - 1) / kDeltaThreads;
  delta_kernel<T, HD><<<static_cast<unsigned>(blocks), kDeltaThreads, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout),
      static_cast<float*>(delta), S, H, rows);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// fp32: passes 2 and 3 on the CUDA cores
// ---------------------------------------------------------------------------
namespace simt {

constexpr int kBlock = 64;       // rows of a q or k tile
constexpr int kThreads = 256;    // 16 x 16
constexpr int kPs = kBlock + 1;  // row stride of a 64 x 64 tile of P or dS

// rows r0 .. r0+63 of one head of a (B, S, heads, HD) tensor (base points
// at row 0 of that batch and head; rows are row_step elements apart) into
// shared memory with row stride ld; rows past S as zeros
template <int HD>
__device__ __forceinline__ void load_tile(float* dst, int ld,
                                          const float* __restrict__ base,
                                          size_t row_step, int r0, int S) {
  for (int idx = threadIdx.x; idx < kBlock * HD; idx += kThreads) {
    const int r = idx / HD, d = idx % HD;
    const int s = r0 + r;
    dst[r * ld + d] = s < S ? base[static_cast<size_t>(s) * row_step + d] : 0.0f;
  }
}

// sc[i][j] += sum_d a[4ty+i][d] * b[tx+16j][d]: a read by row (stride
// HD+4), b by column (stride HD+1)
template <int HD>
__device__ __forceinline__ void tile_dot(float (&sc)[4][4],
                                         const float* __restrict__ a,
                                         const float* __restrict__ b, int tx,
                                         int ty) {
  constexpr int kRs = HD + 4, kCs = HD + 1;
#pragma unroll 8
  for (int d = 0; d < HD; ++d) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a[(4 * ty + i) * kRs + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = b[(tx + 16 * j) * kCs + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(av[i], bv[j], sc[i][j]);
  }
}

// acc[i][c] += sum_r p[4ty+i][r] * m[r][tx+16c] over the tile's 64 rows:
// p a 64 x 64 tile (stride kPs), m a column-read operand (stride HD+1)
template <int HD>
__device__ __forceinline__ void tile_acc(float (&acc)[4][HD / 16],
                                         const float* __restrict__ p,
                                         const float* __restrict__ m, int tx,
                                         int ty) {
  constexpr int kCs = HD + 1, kCols = HD / 16;
#pragma unroll 4
  for (int r = 0; r < kBlock; ++r) {
    float pv[4], mv[kCols];
#pragma unroll
    for (int i = 0; i < 4; ++i) pv[i] = p[(4 * ty + i) * kPs + r];
#pragma unroll
    for (int c = 0; c < kCols; ++c) mv[c] = m[r * kCs + tx + 16 * c];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] = fmaf(pv[i], mv[c], acc[i][c]);
  }
}

template <int HD>
constexpr size_t dkdv_smem() {
  // k, v [64][HD+4]; q, dO [64][HD+1]; P^T, dS^T [64][65]; lse, D [64]
  return sizeof(float) *
         (2 * kBlock * (HD + 4) + 2 * kBlock * (HD + 1) + 2 * kBlock * kPs +
          2 * kBlock);
}
template <int HD>
constexpr size_t dq_smem() {
  // q, dO [64][HD+4]; k, v [64][HD+1]; dS [64][65]
  return sizeof(float) *
         (2 * kBlock * (HD + 4) + 2 * kBlock * (HD + 1) + kBlock * kPs);
}

// Pass 2. dk, dv of one (b, kv head, k tile).
template <int HD>
__global__ void __launch_bounds__(kThreads)
    dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                float* __restrict__ dk, float* __restrict__ dv, int S, int H,
                int Hkv, float scale_log2, float scale, int causal) {
  constexpr int kRs = HD + 4, kCs = HD + 1, kCols = HD / 16;
  extern __shared__ float smem[];
  float* k_s = smem;                   // read by row
  float* v_s = k_s + kBlock * kRs;     // read by row
  float* q_s = v_s + kBlock * kRs;     // read by column
  float* do_s = q_s + kBlock * kCs;    // read by column
  float* pt_s = do_s + kBlock * kCs;   // P^T [key][query]
  float* dst_s = pt_s + kBlock * kPs;  // dS^T [key][query]
  float* lse_s = dst_s + kBlock * kPs;
  float* d_s = lse_s + kBlock;

  const int bkv = blockIdx.x;
  const int b = bkv / Hkv, kvh = bkv % Hkv;
  const int group = H / Hkv;
  const int kb = blockIdx.y;  // early k tiles have the most q tiles: first
  const int k0 = kb * kBlock;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const size_t q_step = static_cast<size_t>(H) * HD;
  const size_t kv_step = static_cast<size_t>(Hkv) * HD;
  const size_t kv_off = static_cast<size_t>(b) * S * kv_step + static_cast<size_t>(kvh) * HD;

  load_tile<HD>(k_s, kRs, k + kv_off, kv_step, k0, S);
  load_tile<HD>(v_s, kRs, v + kv_off, kv_step, k0, S);

  float acc_k[4][kCols], acc_v[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc_k[i][c] = acc_v[i][c] = 0.0f;

  const int n_qb = (S + kBlock - 1) / kBlock;
  for (int g = 0; g < group; ++g) {
    const int h = kvh * group + g;
    const size_t q_off = static_cast<size_t>(b) * S * q_step + static_cast<size_t>(h) * HD;
    const float* lse_row = lse + (static_cast<size_t>(b) * H + h) * S;
    const float* delta_row = delta + (static_cast<size_t>(b) * H + h) * S;
    for (int qb = causal ? kb : 0; qb < n_qb; ++qb) {
      const int q0 = qb * kBlock;
      __syncthreads();  // last tile's reads of q_s, do_s, pt_s, dst_s done
      load_tile<HD>(q_s, kCs, q + q_off, q_step, q0, S);
      load_tile<HD>(do_s, kCs, dout + q_off, q_step, q0, S);
      if (threadIdx.x < kBlock) {
        const int s = q0 + threadIdx.x;
        lse_s[threadIdx.x] = s < S ? lse_row[s] : 0.0f;
        d_s[threadIdx.x] = s < S ? delta_row[s] : 0.0f;
      }
      __syncthreads();
      float st[4][4] = {}, dpt[4][4] = {};
      tile_dot<HD>(st, k_s, q_s, tx, ty);    // s^T: keys x queries
      tile_dot<HD>(dpt, v_s, do_s, tx, ty);  // dP^T = V dO^T
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = k0 + 4 * ty + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int qc = tx + 16 * j;
          const int query = q0 + qc;
          const bool valid = key < S && query < S && (!causal || key <= query);
          const float p =
              valid ? exp2f(fmaf(st[i][j], scale_log2, -lse_s[qc])) : 0.0f;
          pt_s[(4 * ty + i) * kPs + qc] = p;
          dst_s[(4 * ty + i) * kPs + qc] = valid ? p * (dpt[i][j] - d_s[qc]) : 0.0f;
        }
      }
      __syncthreads();
      tile_acc<HD>(acc_v, pt_s, do_s, tx, ty);   // dV += P^T dO
      tile_acc<HD>(acc_k, dst_s, q_s, tx, ty);   // dK += dS^T Q
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + 4 * ty + i;
    if (row >= S) continue;
    const size_t at = kv_off + static_cast<size_t>(row) * kv_step;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      dk[at + tx + 16 * c] = acc_k[i][c] * scale;
      dv[at + tx + 16 * c] = acc_v[i][c];
    }
  }
}

// Pass 3. dq of one (b, h, q tile).
template <int HD>
__global__ void __launch_bounds__(kThreads)
    dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              float* __restrict__ dq, int S, int H, int Hkv, float scale_log2,
              float scale, int causal) {
  constexpr int kRs = HD + 4, kCs = HD + 1, kCols = HD / 16;
  extern __shared__ float smem[];
  float* q_s = smem;                 // read by row
  float* do_s = q_s + kBlock * kRs;  // read by row
  float* k_s = do_s + kBlock * kRs;  // read by column
  float* v_s = k_s + kBlock * kCs;   // read by column
  float* ds_s = v_s + kBlock * kCs;  // dS [query][key]

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / Hkv);
  const int qb = static_cast<int>(gridDim.y) - 1 - static_cast<int>(blockIdx.y);
  const int q0 = qb * kBlock;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const size_t q_step = static_cast<size_t>(H) * HD;
  const size_t kv_step = static_cast<size_t>(Hkv) * HD;
  const size_t q_off = static_cast<size_t>(b) * S * q_step + static_cast<size_t>(h) * HD;
  const size_t kv_off = static_cast<size_t>(b) * S * kv_step + static_cast<size_t>(kvh) * HD;

  load_tile<HD>(q_s, kRs, q + q_off, q_step, q0, S);
  load_tile<HD>(do_s, kRs, dout + q_off, q_step, q0, S);
  float row_lse[4], row_d[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    const size_t at = static_cast<size_t>(bh) * S + row;
    row_lse[i] = row < S ? lse[at] : 0.0f;
    row_d[i] = row < S ? delta[at] : 0.0f;
  }
  float acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.0f;

  const int n_kb_all = (S + kBlock - 1) / kBlock;
  const int n_kb = causal ? min(n_kb_all, qb + 1) : n_kb_all;
  for (int kb = 0; kb < n_kb; ++kb) {
    const int k0 = kb * kBlock;
    __syncthreads();  // last tile's reads of k_s, v_s, ds_s done
    load_tile<HD>(k_s, kCs, k + kv_off, kv_step, k0, S);
    load_tile<HD>(v_s, kCs, v + kv_off, kv_step, k0, S);
    __syncthreads();
    float sc[4][4] = {}, dp[4][4] = {};
    tile_dot<HD>(sc, q_s, k_s, tx, ty);
    tile_dot<HD>(dp, do_s, v_s, tx, ty);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + 4 * ty + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        const bool valid = row < S && col < S && (!causal || col <= row);
        const float p = valid ? exp2f(fmaf(sc[i][j], scale_log2, -row_lse[i])) : 0.0f;
        ds_s[(4 * ty + i) * kPs + tx + 16 * j] =
            valid ? p * (dp[i][j] - row_d[i]) : 0.0f;
      }
    }
    __syncthreads();
    tile_acc<HD>(acc, ds_s, k_s, tx, ty);  // dQ += dS K
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= S) continue;
    const size_t at = q_off + static_cast<size_t>(row) * q_step;
#pragma unroll
    for (int c = 0; c < kCols; ++c) dq[at + tx + 16 * c] = acc[i][c] * scale;
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const void* lse, void* dq, void* dk, void* dv,
           void* delta, int B, int S, int H, int Hkv, int causal,
           cudaStream_t stream) {
  static bool cfg_dkdv = false, cfg_dq = false;
  cudaError_t err = hopper::allow_smem(dkdv_kernel<HD>, dkdv_smem<HD>(), cfg_dkdv);
  if (err == cudaSuccess) err = hopper::allow_smem(dq_kernel<HD>, dq_smem<HD>(), cfg_dq);
  if (err == cudaSuccess) err = launch_delta<float, HD>(o, dout, delta, B, S, H, stream);
  if (err != cudaSuccess) return static_cast<int>(err);

  const int n_tiles = (S + kBlock - 1) / kBlock;
  const float scale = 1.0f / sqrtf(static_cast<float>(HD));
  const float scale_log2 = kLog2e / sqrtf(static_cast<float>(HD));
  const float* q_ = static_cast<const float*>(q);
  const float* k_ = static_cast<const float*>(k);
  const float* v_ = static_cast<const float*>(v);
  const float* do_ = static_cast<const float*>(dout);
  const float* lse_ = static_cast<const float*>(lse);
  const float* delta_ = static_cast<const float*>(delta);

  dkdv_kernel<HD><<<dim3(B * Hkv, n_tiles), kThreads, dkdv_smem<HD>(), stream>>>(
      q_, k_, v_, do_, lse_, delta_, static_cast<float*>(dk),
      static_cast<float*>(dv), S, H, Hkv, scale_log2, scale, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dq_kernel<HD><<<dim3(B * H, n_tiles), kThreads, dq_smem<HD>(), stream>>>(
      q_, k_, v_, do_, lse_, delta_, static_cast<float*>(dq), S, H, Hkv,
      scale_log2, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace simt

// ---------------------------------------------------------------------------
// bf16: passes 2 and 3 on wgmma, tiles through TMA rings
// ---------------------------------------------------------------------------
namespace tc {

using namespace hopper;

constexpr int kRowsWg = 64;                       // resident rows per consumer warpgroup
constexpr int kConsumers = 2;                     // consumer warpgroups per block
constexpr int kBlockRows = kRowsWg * kConsumers;  // resident rows per block
constexpr int kProducerWarp = 4 * kConsumers;     // the warp after the consumers
constexpr int kThreads = 32 * (kProducerWarp + 1);
// The dK/dV pass holds two accumulators a thread (64 registers at hd 64,
// 128 at hd 128), S^T and dP^T (64) and their bf16 fragments: more than
// the 168 a block of 288 threads leaves it (it spilled at both widths).
// So its producer is a whole warpgroup that hands registers to the
// consumers (setmaxnreg): 128 x 40 + 256 x 232 of the SM's 65536.
constexpr int kKvThreads = 128 * (kConsumers + 1);
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;

// Split fp32 pairs (x[n], x[n + 1]) of a wgmma accumulator into the bf16
// A fragments hi = bf16(x) and lo = bf16(x - hi): register r of k-step kk
// is the pair n = 8 kk + 2 r.
template <int N>
__device__ __forceinline__ void split(const float (&x)[N / 2],
                                      uint32_t (&hi)[N / 16][4],
                                      uint32_t (&lo)[N / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int n = 8 * kk + 2 * r;
      const __nv_bfloat162 h = __floats2bfloat162_rn(x[n], x[n + 1]);
      hi[kk][r] = *reinterpret_cast<const uint32_t*>(&h);
      lo[kk][r] = bf16x2(x[n] - __low2float(h), x[n + 1] - __high2float(h));
    }
}

// dK/dV pass shared memory, from a 1024-byte aligned base. Tiles are
// stored as [tile_width / 64 chunks][rows][64] bf16, 128-byte swizzled by
// TMA (hd 16 and 32 zero-filled to 64 columns, hopper.cuh): K,
// V (128 rows each), then per stage a Q and a dO tile (64 queries each);
// then per stage the tile's lse and D (64 fp32 each); then the mbarriers:
// kv, full[kStages], empty[kStages].
template <int HD>
struct KvLayout {
  static constexpr int kNq = 64;
  static constexpr int kStages = 4;
  static constexpr int kWidth = tile_width(HD);
  static constexpr int kChunks = kWidth / 64;
  static constexpr uint32_t kv_chunk = kBlockRows * kRow;
  static constexpr uint32_t kv_bytes = kChunks * kv_chunk;  // K or V
  static constexpr uint32_t q_chunk = kNq * kRow;
  static constexpr uint32_t q_bytes = kChunks * q_chunk;    // one Q or dO tile
  static constexpr uint32_t k_off = 0;
  static constexpr uint32_t v_off = kv_bytes;
  static constexpr uint32_t q_off = 2 * kv_bytes;           // stage st: + st * 2 q_bytes
  static constexpr uint32_t stat_off = q_off + kStages * 2 * q_bytes;
  static constexpr uint32_t bar_off = stat_off + kStages * 2 * kNq * 4;
  static constexpr size_t smem = bar_off + (1 + 2 * kStages) * 8 + kAtom;
};

// Pass 2 on the tensor cores: dk, dv of 128 keys of one (b, KV head).
// Consumer warpgroup wg owns keys kw0 .. kw0 + 63; a thread holds keys
// r_lo and r_lo + 8 and, of each S^T tile, the queries 8j + t2 + {0, 1}.
template <int HD>
__global__ void __launch_bounds__(kKvThreads, 1)
    dkdv_kernel(const __grid_constant__ CUtensorMap tm_q,
                const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v,
                const __grid_constant__ CUtensorMap tm_do,
                const float* __restrict__ lse, const float* __restrict__ delta,
                __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                int S, int H, int Hkv, float scale_log2, float scale,
                int causal) {
  using Ly = KvLayout<HD>;
  constexpr int NQ = Ly::kNq;
  constexpr int kStages = Ly::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + kAtom - 1) & ~(kAtom - 1);
  float* const stats = reinterpret_cast<float*>(smem_raw + (base - raw) + Ly::stat_off);
  const uint32_t k_s = base + Ly::k_off;
  const uint32_t v_s = base + Ly::v_off;
  const uint32_t bar_kv = base + Ly::bar_off;
  auto full = [&](int st) { return bar_kv + 8u * (1 + st); };
  auto empty = [&](int st) { return bar_kv + 8u * (1 + kStages + st); };
  auto q_tile = [&](int st) { return base + Ly::q_off + st * 2 * Ly::q_bytes; };

  const int b = blockIdx.x / Hkv, kvh = blockIdx.x % Hkv;
  const int group = H / Hkv;
  const int k0 = blockIdx.y * kBlockRows;  // early key tiles have the most work: first
  const int n_qt = (S + NQ - 1) / NQ;
  const int qt0 = causal ? k0 / NQ : 0;    // the first q tile at or below the diagonal
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full(st), 32);               // every lane of the producer warp
      mbar_init(empty(st), 4 * kConsumers);  // lane 0 of every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= kProducerWarp) {
    // Producer warpgroup: its first warp loads K and V once, then per
    // (head, q tile) the Q and dO tiles by TMA and the tile's lse and D,
    // which its lanes read one tile ahead (the loads in flight while the
    // stage drains) and copy into the stage. Every consumer warp releases
    // every stage.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (warp != kProducerWarp) return;
    if (lane == 0) {
      mbar_expect_tx(bar_kv, 2 * Ly::kv_bytes);
      for (int c = 0; c < Ly::kChunks; ++c) {
        tma_load(k_s + c * Ly::kv_chunk, &tm_k, bar_kv, 64 * c, kvh, k0, b);
        tma_load(v_s + c * Ly::kv_chunk, &tm_v, bar_kv, 64 * c, kvh, k0, b);
      }
    }
    const int per_head = n_qt - qt0;
    const int total = group * per_head;
    float next_lse[NQ / 32], next_d[NQ / 32];
    auto fetch = [&](int i) {
      const int h = kvh * group + i / per_head, qt = qt0 + i % per_head;
      const size_t row = (static_cast<size_t>(b) * H + h) * S;
#pragma unroll
      for (int r = 0; r < NQ / 32; ++r) {
        const int s = qt * NQ + lane + 32 * r;
        next_lse[r] = s < S ? lse[row + s] : 0.0f;
        next_d[r] = s < S ? delta[row + s] : 0.0f;
      }
    };
    fetch(0);
    for (int it = 0; it < total; ++it) {
      const int h = kvh * group + it / per_head, qt = qt0 + it % per_head;
      const int st = it % kStages;
      if (it >= kStages) mbar_wait(empty(st), ((it / kStages) + 1) & 1);
      float* st_lse = stats + st * 2 * NQ;
#pragma unroll
      for (int r = 0; r < NQ / 32; ++r) {
        st_lse[lane + 32 * r] = next_lse[r];
        st_lse[NQ + lane + 32 * r] = next_d[r];
      }
      if (lane == 0) {
        mbar_expect_tx(full(st), 2 * Ly::q_bytes);
        const uint32_t q_t = q_tile(st);
        for (int c = 0; c < Ly::kChunks; ++c) {
          tma_load(q_t + c * Ly::q_chunk, &tm_q, full(st), 64 * c, h, qt * NQ, b);
          tma_load(q_t + Ly::q_bytes + c * Ly::q_chunk, &tm_do, full(st), 64 * c,
                   h, qt * NQ, b);
        }
      } else {
        mbar_arrive(full(st));
      }
      if (it + 1 < total) fetch(it + 1);
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));

  const int wg = warp / 4;
  const int kw0 = k0 + wg * kRowsWg;
  const int r_lo = kw0 + 16 * (warp % 4) + lane / 4;
  const int t2 = 2 * (lane % 4);
  const uint32_t k_wg = k_s + wg * kRowsWg * kRow;
  const uint32_t v_wg = v_s + wg * kRowsWg * kRow;

  // m64n{width} accumulators: columns past hd stay 0 and are not stored
  float acc_dk[Ly::kWidth / 2], acc_dv[Ly::kWidth / 2];
#pragma unroll
  for (int i = 0; i < Ly::kWidth / 2; ++i) acc_dk[i] = acc_dv[i] = 0.0f;

  mbar_wait(bar_kv, 0);
  int it = 0;
  for (int g = 0; g < group; ++g) {
    for (int qt = qt0; qt < n_qt; ++qt, ++it) {
      const int st = it % kStages;
      const int q0 = qt * NQ;
      mbar_wait(full(st), (it / kStages) & 1);
      // a tile whose queries all precede this warpgroup's keys (causal),
      // or a warpgroup whose keys all lie past S, has nothing to add
      if (kw0 < S && !(causal && q0 + NQ - 1 < kw0)) {
        const uint32_t q_t = q_tile(st);
        const uint32_t do_t = q_t + Ly::q_bytes;
        // S^T = K Q^T and dP^T = V dO^T: hd / 16 k-steps each, K-major
        float s[NQ / 2], dp[NQ / 2];
#pragma unroll
        for (int i = 0; i < NQ / 2; ++i) s[i] = dp[i] = 0.0f;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          const uint32_t off = (kk % 4) * 32;
          wgmma_ss(s, desc(k_wg + (kk / 4) * Ly::kv_chunk + off, 16),
                   desc(q_t + (kk / 4) * Ly::q_chunk + off, 16), kk > 0);
        }
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          const uint32_t off = (kk % 4) * 32;
          wgmma_ss(dp, desc(v_wg + (kk / 4) * Ly::kv_chunk + off, 16),
                   desc(do_t + (kk / 4) * Ly::q_chunk + off, 16), kk > 0);
        }
        wgmma_commit();
        wgmma_wait();
        pin(s);
        pin(dp);

        // P^T = 2^(s scale log2 e - lse) and dS^T = P^T (dP^T - D) in
        // place, 0 where a key follows its query (causal) or either lies
        // past S
        const float* st_lse = stats + st * 2 * NQ;
        const bool edge = q0 + NQ > S || kw0 + kRowsWg > S ||
                          (causal && q0 < kw0 + kRowsWg - 1);
#pragma unroll
        for (int j = 0; j < NQ / 8; ++j) {
          const float2 l2 = *reinterpret_cast<const float2*>(st_lse + 8 * j + t2);
          const float2 d2 = *reinterpret_cast<const float2*>(st_lse + NQ + 8 * j + t2);
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int n = 4 * j + 2 * i + e;
              float p = ex2(fmaf(s[n], scale_log2, -(e ? l2.y : l2.x)));
              float ds = p * (dp[n] - (e ? d2.y : d2.x));
              if (edge) {
                const int key = r_lo + 8 * i, query = q0 + 8 * j + t2 + e;
                if (key >= S || query >= S || (causal && key > query)) p = ds = 0.0f;
              }
              s[n] = p;
              dp[n] = ds;
            }
        }
        uint32_t p_hi[NQ / 16][4], p_lo[NQ / 16][4];
        uint32_t d_hi[NQ / 16][4], d_lo[NQ / 16][4];
        split<NQ>(s, p_hi, p_lo);
        split<NQ>(dp, d_hi, d_lo);

        // dV += (P_hi + P_lo)^T-rows dO and dK += (dS_hi + dS_lo) Q: k-steps
        // of 16 queries, 16 rows (2048 bytes) apart in the MN-major tiles,
        // whose 64-column chunks lie q_chunk bytes apart
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < NQ / 16; ++kk) {
          const uint64_t b_do = desc(do_t + kk * 16 * kRow, Ly::q_chunk);
          const uint64_t b_q = desc(q_t + kk * 16 * kRow, Ly::q_chunk);
          wgmma_rs(acc_dv, p_hi[kk], b_do);
          wgmma_rs(acc_dv, p_lo[kk], b_do);
          wgmma_rs(acc_dk, d_hi[kk], b_q);
          wgmma_rs(acc_dk, d_lo[kk], b_q);
        }
        wgmma_commit();
        wgmma_wait();
        pin(acc_dv);
        pin(acc_dk);
#pragma unroll
        for (int kk = 0; kk < NQ / 16; ++kk) {
          pin(p_hi[kk]);
          pin(p_lo[kk]);
          pin(d_hi[kk]);
          pin(d_lo[kk]);
        }
      }
      if (lane == 0) mbar_arrive(empty(st));  // this warp is done with the stage
    }
  }

  const size_t kv_step = static_cast<size_t>(Hkv) * HD;
  const size_t kv_off = static_cast<size_t>(b) * S * kv_step + static_cast<size_t>(kvh) * HD;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = r_lo + 8 * i;
    if (key >= S) continue;
    const size_t at = kv_off + static_cast<size_t>(key) * kv_step + t2;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const int n = 4 * j + 2 * i;
      *reinterpret_cast<__nv_bfloat162*>(dk + at + 8 * j) =
          __floats2bfloat162_rn(acc_dk[n] * scale, acc_dk[n + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + at + 8 * j) =
          __floats2bfloat162_rn(acc_dv[n], acc_dv[n + 1]);
    }
  }
}

// dQ pass shared memory, from a 1024-byte aligned base: Q and dO (128
// rows each), then per stage a K and a V tile (64 rows each), then the
// mbarriers: qdo, full[kStages], empty[kStages].
template <int HD>
struct QLayout {
  static constexpr int kBlockK = 64;
  static constexpr int kStages = 3;
  static constexpr int kWidth = tile_width(HD);
  static constexpr int kChunks = kWidth / 64;
  static constexpr uint32_t q_chunk = kBlockRows * kRow;
  static constexpr uint32_t q_bytes = kChunks * q_chunk;    // Q or dO
  static constexpr uint32_t kv_chunk = kBlockK * kRow;
  static constexpr uint32_t kv_bytes = kChunks * kv_chunk;  // one K or V tile
  static constexpr uint32_t q_off = 0;
  static constexpr uint32_t do_off = q_bytes;
  static constexpr uint32_t k_off = 2 * q_bytes;
  static constexpr uint32_t v_off = k_off + kStages * kv_bytes;
  static constexpr uint32_t bar_off = v_off + kStages * kv_bytes;
  static constexpr size_t smem = bar_off + (1 + 2 * kStages) * 8 + kAtom;
};

// Pass 3 on the tensor cores: dq of 128 queries of one (b, head).
// Consumer warpgroup wg owns queries wg_q0 .. wg_q0 + 63; a thread holds
// rows r_lo and r_lo + 8 and, of each S tile, the keys 8j + t2 + {0, 1}.
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
    dq_kernel(const __grid_constant__ CUtensorMap tm_q,
              const __grid_constant__ CUtensorMap tm_k,
              const __grid_constant__ CUtensorMap tm_v,
              const __grid_constant__ CUtensorMap tm_do,
              const float* __restrict__ lse, const float* __restrict__ delta,
              __nv_bfloat16* __restrict__ dq, int S, int H, int Hkv,
              float scale_log2, float scale, int causal) {
  using Ly = QLayout<HD>;
  constexpr int kBlockK = Ly::kBlockK;
  constexpr int kStages = Ly::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + kAtom - 1) & ~(kAtom - 1);
  const uint32_t q_s = base + Ly::q_off;
  const uint32_t do_s = base + Ly::do_off;
  const uint32_t k_s = base + Ly::k_off;
  const uint32_t v_s = base + Ly::v_off;
  const uint32_t bar_q = base + Ly::bar_off;
  auto full = [&](int st) { return bar_q + 8u * (1 + st); };
  auto empty = [&](int st) { return bar_q + 8u * (1 + kStages + st); };

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / Hkv);
  // later q tiles have more keys to visit: launch them first
  const int q0 =
      (static_cast<int>(gridDim.y) - 1 - static_cast<int>(blockIdx.y)) * kBlockRows;
  const int n_kb_all = (S + kBlockK - 1) / kBlockK;
  const int n_kb = causal ? min(n_kb_all, (q0 + kBlockRows - 1) / kBlockK + 1)
                          : n_kb_all;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), 4 * kConsumers);  // lane 0 of every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == kProducerWarp) {
    // Producer: Q and dO once, then K and V tiles into the ring. A
    // consumer warpgroup whose rows end before the last tile skips it
    // without releasing its stage; the producer never waits on that stage
    // again.
    if (lane == 0) {
      mbar_expect_tx(bar_q, 2 * Ly::q_bytes);
      for (int c = 0; c < Ly::kChunks; ++c) {
        tma_load(q_s + c * Ly::q_chunk, &tm_q, bar_q, 64 * c, h, q0, b);
        tma_load(do_s + c * Ly::q_chunk, &tm_do, bar_q, 64 * c, h, q0, b);
      }
      for (int kb = 0; kb < n_kb; ++kb) {
        const int st = kb % kStages;
        if (kb >= kStages) mbar_wait(empty(st), ((kb / kStages) + 1) & 1);
        mbar_expect_tx(full(st), 2 * Ly::kv_bytes);
        const uint32_t k_t = k_s + st * Ly::kv_bytes;
        const uint32_t v_t = v_s + st * Ly::kv_bytes;
        for (int c = 0; c < Ly::kChunks; ++c) {
          tma_load(k_t + c * Ly::kv_chunk, &tm_k, full(st), 64 * c, kvh,
                   kb * kBlockK, b);
          tma_load(v_t + c * Ly::kv_chunk, &tm_v, full(st), 64 * c, kvh,
                   kb * kBlockK, b);
        }
      }
    }
    return;
  }

  const int wg = warp / 4;
  const int wg_q0 = q0 + wg * kRowsWg;
  const int r_lo = wg_q0 + 16 * (warp % 4) + lane / 4;
  const int t2 = 2 * (lane % 4);
  const int n_kb_wg =
      causal ? min(n_kb_all, (wg_q0 + kRowsWg - 1) / kBlockK + 1) : n_kb_all;
  const uint32_t q_wg = q_s + wg * kRowsWg * kRow;
  const uint32_t do_wg = do_s + wg * kRowsWg * kRow;

  float row_lse[2], row_d[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r_lo + 8 * i;
    row_lse[i] = row < S ? lse[static_cast<size_t>(bh) * S + row] : 0.0f;
    row_d[i] = row < S ? delta[static_cast<size_t>(bh) * S + row] : 0.0f;
  }
  float acc[Ly::kWidth / 2];  // columns past hd stay 0 and are not stored
#pragma unroll
  for (int i = 0; i < Ly::kWidth / 2; ++i) acc[i] = 0.0f;

  mbar_wait(bar_q, 0);
  for (int kb = 0; kb < n_kb_wg; ++kb) {
    const int st = kb % kStages;
    const uint32_t k_t = k_s + st * Ly::kv_bytes;
    const uint32_t v_t = v_s + st * Ly::kv_bytes;
    mbar_wait(full(st), (kb / kStages) & 1);

    // S = Q K^T and dP = dO V^T: hd / 16 k-steps each, K-major
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.0f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;
      wgmma_ss(s, desc(q_wg + (kk / 4) * Ly::q_chunk + off, 16),
               desc(k_t + (kk / 4) * Ly::kv_chunk + off, 16), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;
      wgmma_ss(dp, desc(do_wg + (kk / 4) * Ly::q_chunk + off, 16),
               desc(v_t + (kk / 4) * Ly::kv_chunk + off, 16), kk > 0);
    }
    wgmma_commit();
    wgmma_wait();
    pin(s);
    pin(dp);

    // dS = P (dP - D), P = 2^(s scale log2 e - lse), 0 where the key
    // follows the query (causal) or lies past S
    const int k0 = kb * kBlockK;
    const bool edge = k0 + kBlockK > S || (causal && k0 + kBlockK - 1 > wg_q0);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = 4 * j + 2 * i + e;
          const float p = ex2(fmaf(s[n], scale_log2, -row_lse[i]));
          float ds = p * (dp[n] - row_d[i]);
          if (edge) {
            const int col = k0 + 8 * j + t2 + e;
            if (col >= S || (causal && col > r_lo + 8 * i)) ds = 0.0f;
          }
          dp[n] = ds;
        }
    uint32_t d_hi[4][4], d_lo[4][4];
    split<64>(dp, d_hi, d_lo);

    // dQ += (dS_hi + dS_lo) K: 4 k-steps of 16 keys, 16 rows (2048 bytes)
    // apart in the MN-major K tile, whose 64-column chunks lie kv_chunk
    // bytes apart
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t b_k = desc(k_t + kk * 16 * kRow, Ly::kv_chunk);
      wgmma_rs(acc, d_hi[kk], b_k);
      wgmma_rs(acc, d_lo[kk], b_k);
    }
    wgmma_commit();
    wgmma_wait();
    pin(acc);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      pin(d_hi[kk]);
      pin(d_lo[kk]);
    }
    if (lane == 0) mbar_arrive(empty(st));  // this warp is done with the stage
  }

  const size_t q_step = static_cast<size_t>(H) * HD;
  __nv_bfloat16* dq_base =
      dq + static_cast<size_t>(b) * S * q_step + static_cast<size_t>(h) * HD;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r_lo + 8 * i;
    if (row >= S) continue;
    __nv_bfloat16* dq_row = dq_base + row * q_step + t2;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dq_row + 8 * j) = __floats2bfloat162_rn(
          acc[4 * j + 2 * i] * scale, acc[4 * j + 2 * i + 1] * scale);
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const void* lse, void* dq, void* dk, void* dv,
           void* delta, int B, int S, int H, int Hkv, int causal,
           cudaStream_t stream) {
  using KL = KvLayout<HD>;
  using QL = QLayout<HD>;
  static bool cfg_dkdv = false, cfg_dq = false;
  cudaError_t err = allow_smem(dkdv_kernel<HD>, KL::smem, cfg_dkdv);
  if (err == cudaSuccess) err = allow_smem(dq_kernel<HD>, QL::smem, cfg_dq);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (encoder() == nullptr) return static_cast<int>(cudaErrorNotSupported);
  // the dK/dV pass: K, V in 128-row boxes, Q, dO in 64-row boxes; the dQ
  // pass: Q, dO in 128-row boxes, K, V in 64-row boxes
  CUtensorMap kv_q, kv_do, kv_k, kv_v, q_q, q_do, q_k, q_v;
  if (!make_map(&kv_q, q, B, S, H, HD, KL::kNq) ||
      !make_map(&kv_do, dout, B, S, H, HD, KL::kNq) ||
      !make_map(&kv_k, k, B, S, Hkv, HD, kBlockRows) ||
      !make_map(&kv_v, v, B, S, Hkv, HD, kBlockRows) ||
      !make_map(&q_q, q, B, S, H, HD, kBlockRows) ||
      !make_map(&q_do, dout, B, S, H, HD, kBlockRows) ||
      !make_map(&q_k, k, B, S, Hkv, HD, QL::kBlockK) ||
      !make_map(&q_v, v, B, S, Hkv, HD, QL::kBlockK))
    return static_cast<int>(cudaErrorInvalidValue);
  err = launch_delta<__nv_bfloat16, HD>(o, dout, delta, B, S, H, stream);
  if (err != cudaSuccess) return static_cast<int>(err);

  const int n_tiles = (S + kBlockRows - 1) / kBlockRows;
  const float scale = 1.0f / sqrtf(static_cast<float>(HD));
  // as the forward computes it, so P here is the forward's P
  const float scale_log2 = 1.4426950408889634f / sqrtf(static_cast<float>(HD));
  const float* lse_ = static_cast<const float*>(lse);
  const float* delta_ = static_cast<const float*>(delta);
  dkdv_kernel<HD><<<dim3(B * Hkv, n_tiles), kKvThreads, KL::smem, stream>>>(
      kv_q, kv_k, kv_v, kv_do, lse_, delta_, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), S, H, Hkv, scale_log2, scale, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dq_kernel<HD><<<dim3(B * H, n_tiles), kThreads, QL::smem, stream>>>(
      q_q, q_k, q_v, q_do, lse_, delta_, static_cast<__nv_bfloat16*>(dq), S, H,
      Hkv, scale_log2, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

using Launch = int (*)(const void*, const void*, const void*, const void*,
                       const void*, const void*, void*, void*, void*, void*, int,
                       int, int, int, int, cudaStream_t);

// one launcher per head width: 16, 32, 64, 128
int dispatch(const Launch (&at)[4], const void* q, const void* k,
             const void* v, const void* o, const void* dout, const void* lse,
             void* dq, void* dk, void* dv, void* delta, int B, int S, int H,
             int Hkv, int hd, int causal, void* stream) {
  int i;
  switch (hd) {
    case 16: i = 0; break;
    case 32: i = 1; break;
    case 64: i = 2; break;
    case 128: i = 3; break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return at[i](q, k, v, o, dout, lse, dq, dk, dv, delta, B, S, H, Hkv, causal,
               static_cast<cudaStream_t>(stream));
}

}  // namespace

// Plain C interface for ctypes. q, o, dout, dq: (B, S, H, hd); k, v, dk,
// dv: (B, S, Hkv, hd); all contiguous, one type, 16-byte aligned; lse: the
// forward's fp32 (B, H, S) log-sum-exp in base 2; delta: an fp32 (B, H, S)
// workspace; hd 16, 32, 64 or 128; H a multiple of Hkv; B*H and ceil(S/64) within
// the grid's limits. The Python wrapper checks all of it. Launches the
// three passes on ``stream`` and returns cudaGetLastError() after them, or
// the first error that kept a pass from launching.
extern "C" int fa_backward_f32(const void* q, const void* k, const void* v,
                               const void* o, const void* dout, const void* lse,
                               void* dq, void* dk, void* dv, void* delta, int B,
                               int S, int H, int Hkv, int hd, int causal,
                               void* stream) {
  static const Launch at[4] = {simt::launch<16>, simt::launch<32>,
                               simt::launch<64>, simt::launch<128>};
  return dispatch(at, q, k, v, o, dout, lse, dq, dk, dv, delta, B, S, H, Hkv,
                  hd, causal, stream);
}

extern "C" int fa_backward_bf16(const void* q, const void* k, const void* v,
                                const void* o, const void* dout, const void* lse,
                                void* dq, void* dk, void* dv, void* delta, int B,
                                int S, int H, int Hkv, int hd, int causal,
                                void* stream) {
  static const Launch at[4] = {tc::launch<16>, tc::launch<32>, tc::launch<64>,
                               tc::launch<128>};
  return dispatch(at, q, k, v, o, dout, lse, dq, dk, dv, delta, B, S, H, Hkv,
                  hd, causal, stream);
}
