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
// dK and dV of a KV head summed over its group's query heads. Three
// passes, each a grid of independent blocks:
// 1. `stats_kernel`, one block per (b*h, 64-row q tile): each row's
//    log-sum-exp, recomputed with the forward's online max and sum, and
//    D, both fp32, into a (B, H, S) workspace.
// 2. `dkdv_kernel`, one block per (b*kv head, 64-row k tile): K and V stay
//    in shared memory while the block walks, in a fixed order, the
//    group's query heads and, for each, the q tiles at or below the
//    diagonal. It rebuilds P^T = exp(s - lse) and dS^T, accumulates dV
//    and dK in registers and writes each once.
// 3. `dq_kernel`, one block per (b*h, 64-row q tile): Q and dO stay in
//    shared memory while the block walks the k tiles up to the diagonal,
//    accumulating dQ in registers.
// Every sum is taken by one thread in a fixed order and every gradient
// element is written once: no atomics, so dq, dk and dv are bit-identical
// from launch to launch. Inputs of either type are widened to fp32 in
// shared memory; every product, statistic and accumulator is fp32, and
// each gradient is rounded once to the inputs' type. Rows past S load as
// zeros and are neither counted nor stored, so any S is taken.
//
// Each block has 256 threads as 16 x 16: a thread owns a 4 x 4 patch of
// each 64 x 64 score tile (rows 4*ty + i, columns tx + 16*j) and 4 rows x
// hd/16 columns of its accumulators; the 16 threads of a score row sit in
// one half-warp, so a row's max and sum are shuffle reductions. Operands
// read by row (ty) have a row stride of hd + 4, those read by column (tx)
// hd + 1, so neither read pattern meets a bank conflict.
//
// What bounds it on this card: the backward does five products of 2 * hd
// flops per (query, key <= query) pair (s, dP, dV, dQ, dK), 344 GFLOP
// per StableLM-1.6B layer at B 8, S 2048, 32 heads of 64, against ~0.54 GB
// of q, k, v, o, dO in and dq, dk, dv out: bound by arithmetic, 0.35 ms
// at the bf16 tensor-core peak. This first kernel runs on the CUDA
// cores' fp32 FMA (67 TFLOP/s peak) and recomputes s twice more (the
// statistics pass and the dQ pass) and dP once more: 8 products per pair.
// Moving the products to wgmma is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kBlock = 64;     // rows of a q or k tile
constexpr int kThreads = 256;  // 16 x 16
constexpr int kPs = kBlock + 1;  // row stride of a 64 x 64 tile of P or dS

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's cast
}

// rows r0 .. r0+63 of one head of a (B, S, heads, HD) tensor (base points
// at row 0 of that batch and head; rows are row_step elements apart) into
// shared memory as fp32 with row stride ld; rows past S as zeros
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, int ld,
                                          const T* __restrict__ base,
                                          size_t row_step, int r0, int S) {
  for (int idx = threadIdx.x; idx < kBlock * HD; idx += kThreads) {
    const int r = idx / HD, d = idx % HD;
    const int s = r0 + r;
    dst[r * ld + d] = s < S ? to_f(base[static_cast<size_t>(s) * row_step + d])
                            : 0.0f;
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
constexpr size_t stats_smem() {  // q [64][HD+4], k [64][HD+1]
  return sizeof(float) * kBlock * ((HD + 4) + (HD + 1));
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

// Pass 1. lse[b, h, row] and delta[b, h, row] for rows < S.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    stats_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ o, const T* __restrict__ dout,
                 float* __restrict__ lse, float* __restrict__ delta, int S,
                 int H, int Hkv, float scale, int causal) {
  constexpr int kQs = HD + 4, kKs = HD + 1;
  extern __shared__ float smem[];
  float* q_s = smem;
  float* k_s = q_s + kBlock * kQs;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / Hkv);
  // later q tiles have more keys to visit: launch them first
  const int qb = static_cast<int>(gridDim.y) - 1 - static_cast<int>(blockIdx.y);
  const int q0 = qb * kBlock;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t q_step = static_cast<size_t>(H) * HD;
  const size_t kv_step = static_cast<size_t>(Hkv) * HD;
  const size_t q_off = static_cast<size_t>(b) * S * q_step + static_cast<size_t>(h) * HD;
  const T* k_base = k + static_cast<size_t>(b) * S * kv_step + static_cast<size_t>(kvh) * HD;
  float* lse_row = lse + static_cast<size_t>(bh) * S;
  float* delta_row = delta + static_cast<size_t>(bh) * S;

  // D: each warp takes rows warp, warp + 8, ...; lanes split hd
  for (int r = warp; r < kBlock; r += kThreads / 32) {
    const int s = q0 + r;
    if (s >= S) break;
    const size_t at = q_off + static_cast<size_t>(s) * q_step;
    float sum = 0.0f;
#pragma unroll
    for (int d = lane; d < HD; d += 32) sum = fmaf(to_f(dout[at + d]), to_f(o[at + d]), sum);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) delta_row[s] = sum;
  }

  load_tile<T, HD>(q_s, kQs, q + q_off, q_step, q0, S);
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
  }
  const int n_kb_all = (S + kBlock - 1) / kBlock;
  const int n_kb = causal ? min(n_kb_all, qb + 1) : n_kb_all;
  for (int kb = 0; kb < n_kb; ++kb) {
    const int k0 = kb * kBlock;
    __syncthreads();  // q tile loaded / last tile's reads done
    load_tile<T, HD>(k_s, kKs, k_base, kv_step, k0, S);
    __syncthreads();
    float sc[4][4] = {};
    tile_dot<HD>(sc, q_s, k_s, tx, ty);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + 4 * ty + i;
      bool valid[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        valid[j] = col < S && (!causal || col <= row);
        sc[i][j] = valid[j] ? sc[i][j] * scale : kNegInf;
        mx = fmaxf(mx, sc[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) sum += valid[j] ? expf(sc[i][j] - m_new) : 0.0f;
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * expf(m[i] - m_new) + sum;
      m[i] = m_new;
    }
  }
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + 4 * ty + i;
      if (row < S) lse_row[row] = m[i] + logf(l[i] > 0.0f ? l[i] : 1.0f);
    }
  }
}

// Pass 2. dk, dv of one (b, kv head, k tile).
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                T* __restrict__ dk, T* __restrict__ dv, int S, int H, int Hkv,
                float scale, int causal) {
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

  load_tile<T, HD>(k_s, kRs, k + kv_off, kv_step, k0, S);
  load_tile<T, HD>(v_s, kRs, v + kv_off, kv_step, k0, S);

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
      load_tile<T, HD>(q_s, kCs, q + q_off, q_step, q0, S);
      load_tile<T, HD>(do_s, kCs, dout + q_off, q_step, q0, S);
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
          const float p = valid ? expf(st[i][j] * scale - lse_s[qc]) : 0.0f;
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
      dk[at + tx + 16 * c] = from_f<T>(acc_k[i][c] * scale);
      dv[at + tx + 16 * c] = from_f<T>(acc_v[i][c]);
    }
  }
}

// Pass 3. dq of one (b, h, q tile).
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              T* __restrict__ dq, int S, int H, int Hkv, float scale,
              int causal) {
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

  load_tile<T, HD>(q_s, kRs, q + q_off, q_step, q0, S);
  load_tile<T, HD>(do_s, kRs, dout + q_off, q_step, q0, S);
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
    load_tile<T, HD>(k_s, kCs, k + kv_off, kv_step, k0, S);
    load_tile<T, HD>(v_s, kCs, v + kv_off, kv_step, k0, S);
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
        const float p = valid ? expf(sc[i][j] * scale - row_lse[i]) : 0.0f;
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
    for (int c = 0; c < kCols; ++c) dq[at + tx + 16 * c] = from_f<T>(acc[i][c] * scale);
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, bool& configured) {
  if (configured) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err == cudaSuccess) configured = true;
  return err;
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, void* dq, void* dk, void* dv, void* lse,
           void* delta, int B, int S, int H, int Hkv, int causal,
           cudaStream_t stream) {
  static bool cfg_stats = false, cfg_dkdv = false, cfg_dq = false;
  cudaError_t err = allow_smem(stats_kernel<T, HD>, stats_smem<HD>(), cfg_stats);
  if (err == cudaSuccess) err = allow_smem(dkdv_kernel<T, HD>, dkdv_smem<HD>(), cfg_dkdv);
  if (err == cudaSuccess) err = allow_smem(dq_kernel<T, HD>, dq_smem<HD>(), cfg_dq);
  if (err != cudaSuccess) return static_cast<int>(err);

  const int n_tiles = (S + kBlock - 1) / kBlock;
  const float scale = 1.0f / sqrtf(static_cast<float>(HD));
  const T* q_ = static_cast<const T*>(q);
  const T* k_ = static_cast<const T*>(k);
  const T* v_ = static_cast<const T*>(v);
  const T* o_ = static_cast<const T*>(o);
  const T* do_ = static_cast<const T*>(dout);
  float* lse_ = static_cast<float*>(lse);
  float* delta_ = static_cast<float*>(delta);

  stats_kernel<T, HD><<<dim3(B * H, n_tiles), kThreads, stats_smem<HD>(), stream>>>(
      q_, k_, o_, do_, lse_, delta_, S, H, Hkv, scale, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dkdv_kernel<T, HD><<<dim3(B * Hkv, n_tiles), kThreads, dkdv_smem<HD>(), stream>>>(
      q_, k_, v_, do_, lse_, delta_, static_cast<T*>(dk), static_cast<T*>(dv), S,
      H, Hkv, scale, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dq_kernel<T, HD><<<dim3(B * H, n_tiles), kThreads, dq_smem<HD>(), stream>>>(
      q_, k_, v_, do_, lse_, delta_, static_cast<T*>(dq), S, H, Hkv, scale,
      causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* o,
             const void* dout, void* dq, void* dk, void* dv, void* lse,
             void* delta, int B, int S, int H, int Hkv, int hd, int causal,
             void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64:
      return launch<T, 64>(q, k, v, o, dout, dq, dk, dv, lse, delta, B, S, H,
                           Hkv, causal, st);
    case 128:
      return launch<T, 128>(q, k, v, o, dout, dq, dk, dv, lse, delta, B, S, H,
                            Hkv, causal, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C interface for ctypes. q, o, dout, dq: (B, S, H, hd); k, v, dk,
// dv: (B, S, Hkv, hd); all contiguous, one type; lse, delta: fp32 (B, H,
// S) workspaces; hd 64 or 128; H a multiple of Hkv; B*H and ceil(S/64)
// within the grid's limits. The Python wrapper checks all of it. Launches
// the three passes on ``stream`` and returns cudaGetLastError() after
// them, or the first error that kept a pass from launching.
extern "C" int fa_backward_f32(const void* q, const void* k, const void* v,
                               const void* o, const void* dout, void* dq,
                               void* dk, void* dv, void* lse, void* delta,
                               int B, int S, int H, int Hkv, int hd, int causal,
                               void* stream) {
  return dispatch<float>(q, k, v, o, dout, dq, dk, dv, lse, delta, B, S, H,
                         Hkv, hd, causal, stream);
}

extern "C" int fa_backward_bf16(const void* q, const void* k, const void* v,
                                const void* o, const void* dout, void* dq,
                                void* dk, void* dv, void* lse, void* delta,
                                int B, int S, int H, int Hkv, int hd,
                                int causal, void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, o, dout, dq, dk, dv, lse, delta, B,
                                 S, H, Hkv, hd, causal, stream);
}
