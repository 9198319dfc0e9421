// Causal GQA flash attention (forward) for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py
// (`_fa_kernel`, launched by `flash_attention_call`). For q (B, S, H, hd)
// and k, v (B, S, Hkv, hd) it computes softmax(q k^T * hd^-1/2) v per
// (batch, head), causal or not, with query head h reading KV head
// h / (H / Hkv): K and V are never copied per query head. Softmax
// statistics (running max m, normaliser l) and the output accumulator are
// fp32, masked scores are -1e30, a row with l = 0 is divided by 1, and the
// output is written in q's type.
//
// Layout: the kernel reads and writes the model's (B, S, heads, hd)
// tensors in place through their strides (a sequence step is heads * hd
// elements), so the wrapper transposes nothing.
//
// The TPU grid (B*H, q blocks, k blocks) ran the k axis in order on one
// core, with m / l / acc in VMEM scratch across it. Here one CUDA block
// owns one (b*h, 64-row q block) and sweeps the K/V blocks itself, from
// the first to the one holding the diagonal, and no further: blocks
// above the diagonal are never visited. Its q tile lives in shared
// memory as fp32; K and V tiles of 64 rows stream through shared memory;
// each of the 256 threads holds a 4 x 4 patch of scores and a 4 x hd/16
// patch of the accumulator in registers. The 16 threads that share a
// score row sit in one half-warp, so the row max and row sum are two
// shuffle reductions. Probabilities go back to shared memory (over the
// spent K tile) for the P V product. A ragged last block (S not a
// multiple of 64) is masked: rows past S are computed but not stored,
// columns past S get -1e30 and zero V. Heavier (later) q blocks launch
// first.
//
// What bounds it on this card: causal attention does 4 * hd flops per
// (query, key <= query) pair, ~68.7 GFLOP per Mistral-NeMo layer at
// B = 2, S = 2048, against ~84 MB of q/k/v/o, so it is bound by
// arithmetic: 0.07 ms at the bf16 tensor-core peak. This kernel does its
// products on fp32 FMA (67 TFLOP/s peak, and two shared loads per FMA
// pair here), so it stays far above that bound; mma/wgmma tiles and
// TMA-fed K/V rings are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

namespace {

constexpr int kBlockQ = 64;    // query rows per CUDA block
constexpr int kBlockK = 64;    // key rows per shared-memory tile
constexpr int kThreads = 256;  // 16 x 16: 4 rows x (hd/16 or 4) cols each
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <int HD>
constexpr size_t smem_bytes() {
  // q [64][HD+4] + k [64][HD+1] (later p [64][65]) + v [64][HD]
  return sizeof(float) *
         (kBlockQ * (HD + 4) + kBlockK * (HD + 1) + kBlockK * HD);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    fa_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ o, int S, int H,
              int Hkv, float scale, int causal) {
  static_assert(HD % 16 == 0 && kBlockK + 1 <= HD + 1, "head width");
  constexpr int kQs = HD + 4;  // q row stride: the two rows a warp reads
                               // in one step fall in different banks
  constexpr int kKs = HD + 1;  // k row stride: 16 rows, 16 banks
  constexpr int kPs = kBlockK + 1;
  constexpr int kCols = HD / 16;  // accumulator columns per thread
  extern __shared__ float smem[];
  float* q_s = smem;
  float* k_s = q_s + kBlockQ * kQs;
  float* v_s = k_s + kBlockK * kKs;
  float* p_s = k_s;  // probabilities overwrite the spent K tile

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / Hkv);
  const int qb = static_cast<int>(gridDim.y) - 1 - static_cast<int>(blockIdx.y);
  const int q0 = qb * kBlockQ;
  const int tx = threadIdx.x % 16;  // score columns tx + 16*j
  const int ty = threadIdx.x / 16;  // rows 4*ty + i
  const size_t q_step = static_cast<size_t>(H) * HD;
  const size_t kv_step = static_cast<size_t>(Hkv) * HD;
  const T* q_base = q + static_cast<size_t>(b) * S * q_step + static_cast<size_t>(h) * HD;
  const T* k_base = k + static_cast<size_t>(b) * S * kv_step + static_cast<size_t>(kvh) * HD;
  const T* v_base = v + static_cast<size_t>(b) * S * kv_step + static_cast<size_t>(kvh) * HD;
  T* o_base = o + static_cast<size_t>(b) * S * q_step + static_cast<size_t>(h) * HD;

  for (int idx = threadIdx.x; idx < kBlockQ * HD; idx += kThreads) {
    const int r = idx / HD, d = idx % HD;
    const int s = q0 + r;
    q_s[r * kQs + d] = s < S ? to_f32(q_base[s * q_step + d]) : 0.0f;
  }

  float acc[4][kCols];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.0f;
  }

  const int n_kb_all = (S + kBlockK - 1) / kBlockK;
  const int n_kb = causal ? min(n_kb_all, (q0 + kBlockQ - 1) / kBlockK + 1)
                          : n_kb_all;
  for (int kb = 0; kb < n_kb; ++kb) {
    const int k0 = kb * kBlockK;
    __syncthreads();  // q tile loaded / last P V product done
    for (int idx = threadIdx.x; idx < kBlockK * HD; idx += kThreads) {
      const int r = idx / HD, d = idx % HD;
      const int s = k0 + r;
      const bool in = s < S;
      k_s[r * kKs + d] = in ? to_f32(k_base[s * kv_step + d]) : 0.0f;
      v_s[r * HD + d] = in ? to_f32(v_base[s * kv_step + d]) : 0.0f;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = q_s[(4 * ty + i) * kQs + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = k_s[(tx + 16 * j) * kKs + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }
    __syncthreads();  // every read of the K tile is done: P may overwrite it

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
      const float alpha = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = valid[j] ? expf(sc[i][j] - m_new) : 0.0f;
        p_s[(4 * ty + i) * kPs + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = alpha * l[i] + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBlockK; ++kk) {
      float pv[4], vv[kCols];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = p_s[(4 * ty + i) * kPs + kk];
#pragma unroll
      for (int c = 0; c < kCols; ++c) vv[c] = v_s[kk * HD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= S) continue;
    const float inv = 1.0f / (l[i] > 0.0f ? l[i] : 1.0f);
    T* o_row = o_base + row * q_step;
#pragma unroll
    for (int c = 0; c < kCols; ++c) store(o_row + tx + 16 * c, acc[i][c] * inv);
  }
}

template <typename T, int HD>
int launch_hd(const void* q, const void* k, const void* v, void* o, int B,
              int S, int H, int Hkv, int causal, void* stream) {
  constexpr size_t smem = smem_bytes<HD>();
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        fa_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid(B * H, (S + kBlockQ - 1) / kBlockQ);
  const float scale = 1.0f / sqrtf(static_cast<float>(HD));
  fa_kernel<T, HD><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, H, Hkv, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S,
           int H, int Hkv, int hd, int causal, void* stream) {
  switch (hd) {
    case 64:
      return launch_hd<T, 64>(q, k, v, o, B, S, H, Hkv, causal, stream);
    case 128:
      return launch_hd<T, 128>(q, k, v, o, B, S, H, Hkv, causal, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C interface for ctypes. q, o: (B, S, H, hd); k, v: (B, S, Hkv, hd);
// all contiguous, one type; hd 64 or 128; H a multiple of Hkv; B*H and
// ceil(S/64) within the grid's limits. The Python wrapper checks all of
// it. Returns cudaGetLastError() after the launch.
extern "C" int fa_forward_f32(const void* q, const void* k, const void* v,
                              void* o, int B, int S, int H, int Hkv, int hd,
                              int causal, void* stream) {
  return launch<float>(q, k, v, o, B, S, H, Hkv, hd, causal, stream);
}

extern "C" int fa_forward_bf16(const void* q, const void* k, const void* v,
                               void* o, int B, int S, int H, int Hkv, int hd,
                               int causal, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, B, S, H, Hkv, hd, causal, stream);
}
