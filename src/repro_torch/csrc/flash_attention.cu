// Causal GQA flash attention (forward) for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py
// (`_fa_kernel`, launched by `flash_attention_call`). For q (B, S, H, hd)
// and k, v (B, S, Hkv, hd) it computes softmax(q k^T * hd^-1/2) v per
// (batch, head), causal or not, with query head h reading KV head
// h / (H / Hkv): K and V are never copied per query head. Softmax
// statistics (running max m, normaliser l) and the output accumulator are
// fp32, masked scores are -1e30, a row with l = 0 is divided by 1, and the
// output is written in q's type through the model's (B, S, heads, hd)
// strides, so the wrapper transposes nothing. Where the caller passes a
// buffer, each row's log-sum-exp goes there too, in base 2 (fp32, (B, H,
// S)): the backward rebuilds P from it, and o is the same bits with or
// without it. Blocks above the diagonal
// are never visited, masks are applied only on the blocks that need them,
// rows past S are not stored, and heavier (later) q blocks launch first.
//
// The TPU grid (B*H, q blocks, k blocks) ran the k axis in order on one
// core, with m / l / acc in VMEM scratch across it. Here one CUDA block
// owns one (b*h, q block) and sweeps the K/V blocks itself.
//
// Each input type has one kernel, chosen by type (a dispatch, not a
// fallback: nothing else ever runs for that type):
//
// bf16 (`fa_forward_bf16`, every LM prefill on the card) runs both
// products on the tensor cores with wgmma. A block owns 128 query rows:
// two consumer warpgroups of 64 rows each, and one producer warp that
// keeps a 3-stage ring of 64-key K and V tiles filled by TMA, each stage
// guarded by a "full" and an "empty" mbarrier. TMA reads 4-D tensor maps
// over (hd, heads, S, B), so rows past S come back as zeros and a ragged
// tile never reads the next batch's rows. Tiles land 128-byte swizzled,
// split into 64-column chunks, which is the layout wgmma reads; a head
// of 16 or 32 lands in one chunk, zero past hd (hopper.cuh `tile_width`):
// - S = Q K^T: Q and K from shared memory, both K-major; the bf16 inputs
//   are exact and the sums fp32 (m64n64k16, hd / 16 steps).
// - O += P V: P from registers as the A operand, V from shared memory as
//   an MN-major B operand (wgmma's transposed-B form), so V's natural
//   (keys, hd) layout serves without a transpose (m64n{hd}k16, n64 at
//   hd 16 and 32 over the zero columns).
// Scores and probabilities never leave registers; the max, the
// exponentials, l and the rescale stay fp32 there.
//
// fp32 (`fa_forward_f32`, the card tests' fp32 cases) keeps the SIMT
// kernel of the first port: 64-row q blocks, K/V tiles widened to fp32 in
// shared memory, 4 x 4 register patches of scores per thread and the
// products on fp32 FMA. No LM path on the card runs it.
//
// What bounds it on this card: causal attention does 4 * hd flops per
// (query, key <= query) pair, 68.7 GFLOP per Mistral-NeMo layer at B = 2,
// S = 2048, against ~84 MB of q/k/v/o, so it is bound by arithmetic:
// 0.0695 ms at the bf16 tensor-core peak (989 TFLOP/s). The TPU kernel
// keeps P in fp32 for the P V product, and the port's bound holds it to
// that: one bf16 ulp of each output (flash_attention/ref.py KERNEL_TOL).
// Rounding P to bf16 once reads 12-22x that bound at S 1024-2048, so P
// goes in as two bf16 terms, P_hi = bf16(P) and P_lo = bf16(P - P_hi),
// both into the same fp32 accumulator: P_hi + P_lo carries 16 bits of P,
// which the bound accepts. That is 1.5x the products of a plain bf16
// kernel, a floor of 0.104 ms at the same peak.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// fp32: the SIMT kernel
// ---------------------------------------------------------------------------
namespace simt {

constexpr int kBlockQ = 64;    // query rows per CUDA block
constexpr int kBlockK = 64;    // key rows per shared-memory tile
constexpr int kThreads = 256;  // 16 x 16: 4 rows x (hd/16 or 4) cols each

// row stride of the K tile, which the probabilities [64][65] overwrite:
// wide enough for either
template <int HD>
__host__ __device__ constexpr int k_stride() {
  return HD + 1 > kBlockK + 1 ? HD + 1 : kBlockK + 1;
}

template <int HD>
constexpr size_t smem_bytes() {
  // q [64][HD+4] + k [64][k_stride] (later p [64][65]) + v [64][HD]
  return sizeof(float) *
         (kBlockQ * (HD + 4) + kBlockK * k_stride<HD>() + kBlockK * HD);
}

// One block per (b*h, 64-row q block): its q tile lives in shared memory;
// K and V tiles of 64 rows stream through shared memory; each of the 256
// threads holds a 4 x 4 patch of scores and a 4 x hd/16 patch of the
// accumulator in registers. The 16 threads that share a score row sit in
// one half-warp, so the row max and row sum are two shuffle reductions.
// Probabilities go back to shared memory (over the spent K tile) for the
// P V product. Columns past S get -1e30 and zero V.
template <int HD>
__global__ void __launch_bounds__(kThreads)
    fa_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o,
              float* __restrict__ lse, int S, int H, int Hkv, float scale,
              int causal) {
  static_assert(HD % 16 == 0, "head width");
  constexpr int kQs = HD + 4;  // q row stride: the two rows a warp reads
                               // in one step fall in different banks
  constexpr int kKs = k_stride<HD>();  // odd: 16 rows, 16 banks
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
  const float* q_base = q + static_cast<size_t>(b) * S * q_step + static_cast<size_t>(h) * HD;
  const float* k_base = k + static_cast<size_t>(b) * S * kv_step + static_cast<size_t>(kvh) * HD;
  const float* v_base = v + static_cast<size_t>(b) * S * kv_step + static_cast<size_t>(kvh) * HD;
  float* o_base = o + static_cast<size_t>(b) * S * q_step + static_cast<size_t>(h) * HD;

  for (int idx = threadIdx.x; idx < kBlockQ * HD; idx += kThreads) {
    const int r = idx / HD, d = idx % HD;
    const int s = q0 + r;
    q_s[r * kQs + d] = s < S ? q_base[s * q_step + d] : 0.0f;
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
      k_s[r * kKs + d] = in ? k_base[s * kv_step + d] : 0.0f;
      v_s[r * HD + d] = in ? v_base[s * kv_step + d] : 0.0f;
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
    float* o_row = o_base + row * q_step;
#pragma unroll
    for (int c = 0; c < kCols; ++c) o_row[tx + 16 * c] = acc[i][c] * inv;
    // the row's log-sum-exp in base 2, as the bf16 kernel keeps it
    if (lse != nullptr && tx == 0)
      lse[static_cast<size_t>(bh) * S + row] =
          fmaf(m[i], kLog2e, log2f(l[i] > 0.0f ? l[i] : 1.0f));
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int B, int S, int H, int Hkv, int causal, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        fa_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid(B * H, (S + kBlockQ - 1) / kBlockQ);
  const float scale = 1.0f / sqrtf(static_cast<float>(HD));
  fa_kernel<HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), S, H, Hkv, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace simt

// ---------------------------------------------------------------------------
// bf16: wgmma on the tensor cores, K/V through a TMA ring
// ---------------------------------------------------------------------------
namespace tc {

using namespace hopper;

constexpr int kRowsWg = 64;                    // query rows per consumer warpgroup
constexpr int kConsumers = 2;                  // consumer warpgroups per block
constexpr int kBlockQ = kRowsWg * kConsumers;  // query rows per block
constexpr int kBlockK = 64;                    // keys per K/V tile
constexpr int kStages = 3;                     // depth of the K/V ring
constexpr int kProducerWarp = 4 * kConsumers;  // the warp after the consumers
constexpr int kThreads = 32 * (kProducerWarp + 1);

// Shared memory, from a 1024-byte aligned base. Every tile is stored as
// [tile_width / 64 chunks][rows][64] bf16, each row 128 bytes, 128-byte
// swizzled by TMA (hd 16 and 32 zero-filled to 64 columns); then the
// mbarriers: q, full[kStages], empty[kStages].
template <int HD>
struct Layout {
  static constexpr int kWidth = tile_width(HD);
  static constexpr int kChunks = kWidth / 64;
  static constexpr uint32_t q_chunk = kBlockQ * kRow;
  static constexpr uint32_t kv_chunk = kBlockK * kRow;
  static constexpr uint32_t q_bytes = kChunks * q_chunk;
  static constexpr uint32_t kv_bytes = kChunks * kv_chunk;  // one K or V tile
  static constexpr uint32_t k_off = q_bytes;
  static constexpr uint32_t v_off = k_off + kStages * kv_bytes;
  static constexpr uint32_t bar_off = v_off + kStages * kv_bytes;
  static constexpr size_t smem = bar_off + (1 + 2 * kStages) * 8 + kAtom;
};

// Accumulator layout of a wgmma m64nN tile, per thread of the warpgroup
// (warp w, lane l): element 4j + 2i + e sits at row 16w + l/4 + 8i and
// column 8j + 2(l%4) + e. Read in pairs, that is also the A-fragment
// layout of m64nNk16: pairs 4kk .. 4kk+3 are the A registers of k-step
// kk, so P goes from the score registers to the A operand in place.
//
// Each warpgroup runs its tiles in order: Q K^T, wait, softmax, P V,
// wait. The two warpgroups of a block interleave on the SM's tensor
// cores, one in its softmax while the other multiplies. (A software
// pipeline inside the warpgroup, Q K^T of the next tile and P V of this
// one in flight during the exponentials, measured slower on the card;
// PERF.md.)
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
    fa_kernel(const __grid_constant__ CUtensorMap tm_q,
              const __grid_constant__ CUtensorMap tm_k,
              const __grid_constant__ CUtensorMap tm_v,
              __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int S,
              int H, int Hkv, float scale_log2, int causal) {
  using Ly = Layout<HD>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + kAtom - 1) & ~(kAtom - 1);
  const uint32_t q_s = base;
  const uint32_t k_s = base + Ly::k_off;
  const uint32_t v_s = base + Ly::v_off;
  const uint32_t bar_q = base + Ly::bar_off;
  auto full = [&](int st) { return bar_q + 8u * (1 + st); };
  auto empty = [&](int st) { return bar_q + 8u * (1 + kStages + st); };

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / Hkv);
  const int q0 =
      (static_cast<int>(gridDim.y) - 1 - static_cast<int>(blockIdx.y)) * kBlockQ;
  const int n_kb_all = (S + kBlockK - 1) / kBlockK;
  const int n_kb = causal ? min(n_kb_all, (q0 + kBlockQ - 1) / kBlockK + 1)
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
    // Producer: Q once, then K and V tiles into the ring. A consumer
    // warpgroup whose rows end before the last tile skips it without
    // releasing its stage; the producer never waits on that stage again.
    if (lane == 0) {
      mbar_expect_tx(bar_q, Ly::q_bytes);
      for (int c = 0; c < Ly::kChunks; ++c)
        tma_load(q_s + c * Ly::q_chunk, &tm_q, bar_q, 64 * c, h, q0, b);
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

  // Consumer warpgroup `wg`: query rows wg_q0 .. wg_q0 + 63; this thread
  // holds rows r_lo and r_lo + 8, columns 8j + t2 + {0, 1}.
  const int wg = warp / 4;
  const int wg_q0 = q0 + wg * kRowsWg;
  const int r_lo = wg_q0 + 16 * (warp % 4) + lane / 4;
  const int t2 = 2 * (lane % 4);
  const int n_kb_wg =
      causal ? min(n_kb_all, (wg_q0 + kRowsWg - 1) / kBlockK + 1) : n_kb_all;
  const uint32_t q_wg = q_s + wg * kRowsWg * kRow;

  // m64n{width} accumulator: columns past hd stay 0 and are not stored
  float acc[Ly::kWidth / 2];
#pragma unroll
  for (int i = 0; i < Ly::kWidth / 2; ++i) acc[i] = 0.0f;
  float m[2] = {kNegInf, kNegInf};  // running row max, in log2 units
  float l[2] = {0.0f, 0.0f};        // this thread's share of the row sums

  mbar_wait(bar_q, 0);
  for (int kb = 0; kb < n_kb_wg; ++kb) {
    const int st = kb % kStages;
    const uint32_t k_t = k_s + st * Ly::kv_bytes;
    const uint32_t v_t = v_s + st * Ly::kv_bytes;
    mbar_wait(full(st), (kb / kStages) & 1);

    // S = Q K^T: hd / 16 k-steps, 32 bytes apart inside a 64-column chunk
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.0f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;
      wgmma_ss(s, desc(q_wg + (kk / 4) * Ly::q_chunk + off, 16),
               desc(k_t + (kk / 4) * Ly::kv_chunk + off, 16), kk > 0);
    }
    wgmma_commit();
    wgmma_wait();
    pin(s);

    const int k0 = kb * kBlockK;
    if (k0 + kBlockK > S || (causal && k0 + kBlockK - 1 > wg_q0)) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = k0 + 8 * j + t2 + e;
            if (col >= S || (causal && col > r_lo + 8 * i))
              s[4 * j + 2 * i + e] = kNegInf;
          }
    }

    // online softmax in fp32; the 4 lanes of a row are lanes 4r .. 4r+3
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        mx = fmaxf(mx, fmaxf(s[4 * j + 2 * i], s[4 * j + 2 * i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[i], mx * scale_log2);
      alpha[i] = ex2(m[i] - m_new);
      m[i] = m_new;
    }
    // P = exp2(s * scale log2 e - m), fed to the tensor cores as
    // P_hi + P_lo, two bf16 A fragments per k-step
    uint32_t p_hi[4][4], p_lo[4][4];
    float sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int n = 8 * kk + 2 * r, i = r & 1;
        const float p0 = ex2(fmaf(s[n], scale_log2, -m[i]));
        const float p1 = ex2(fmaf(s[n + 1], scale_log2, -m[i]));
        sum[i] += p0 + p1;
        const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
        p_hi[kk][r] = *reinterpret_cast<const uint32_t*>(&hi);
        p_lo[kk][r] = bf16x2(p0 - __low2float(hi), p1 - __high2float(hi));
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = alpha[i] * l[i] + sum[i];
#pragma unroll
    for (int j = 0; j < Ly::kWidth / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        acc[4 * j + 2 * i] *= alpha[i];
        acc[4 * j + 2 * i + 1] *= alpha[i];
      }

    // O += (P_hi + P_lo) V: 4 k-steps of 16 keys, 16 rows (2048 bytes)
    // apart in the MN-major V tile, whose 64-column chunks lie
    // kv_chunk bytes apart
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t dv = desc(v_t + kk * 16 * kRow, Ly::kv_chunk);
      wgmma_rs(acc, p_hi[kk], dv);
      wgmma_rs(acc, p_lo[kk], dv);
    }
    wgmma_commit();
    wgmma_wait();
    pin(acc);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      pin(p_hi[kk]);
      pin(p_lo[kk]);
    }
    if (lane == 0) mbar_arrive(empty(st));  // this warp is done with the stage
  }

  const size_t q_step = static_cast<size_t>(H) * HD;
  __nv_bfloat16* o_base =
      o + static_cast<size_t>(b) * S * q_step + static_cast<size_t>(h) * HD;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int row = r_lo + 8 * i;
    if (row >= S) continue;
    const float inv = 1.0f / (l[i] > 0.0f ? l[i] : 1.0f);
    // the row's log-sum-exp in base 2 (m is in log2 units), for the backward
    if (lse != nullptr && t2 == 0)
      lse[static_cast<size_t>(bh) * S + row] =
          m[i] + log2f(l[i] > 0.0f ? l[i] : 1.0f);
    __nv_bfloat16* o_row = o_base + row * q_step + t2;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(o_row + 8 * j) = __floats2bfloat162_rn(
          acc[4 * j + 2 * i] * inv, acc[4 * j + 2 * i + 1] * inv);
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int B, int S, int H, int Hkv, int causal, cudaStream_t stream) {
  constexpr size_t smem = Layout<HD>::smem;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        fa_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  if (encoder() == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap tm_q, tm_k, tm_v;
  if (!make_map(&tm_q, q, B, S, H, HD, kBlockQ) ||
      !make_map(&tm_k, k, B, S, Hkv, HD, kBlockK) ||
      !make_map(&tm_v, v, B, S, Hkv, HD, kBlockK))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(B * H, (S + kBlockQ - 1) / kBlockQ);
  const float scale_log2 = 1.4426950408889634f / sqrtf(static_cast<float>(HD));
  fa_kernel<HD><<<grid, kThreads, smem, stream>>>(
      tm_q, tm_k, tm_v, static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse),
      S, H, Hkv, scale_log2, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

}  // namespace

// Plain C interface for ctypes. q, o: (B, S, H, hd); k, v: (B, S, Hkv, hd);
// all contiguous, one type; hd 16, 32, 64 or 128; H a multiple of Hkv; B*H and
// ceil(S/64) within the grid's limits; bf16 operands 16-byte aligned. lse
// is null, or a contiguous fp32 (B, H, S) buffer that receives each row's
// log-sum-exp of the scaled scores in base 2, log2 sum_j 2^(s_j log2(e) /
// sqrt(hd)), which the backward takes. The Python wrapper checks all of
// it. Returns cudaGetLastError() after the launch, or the error that kept
// the kernel from launching.
extern "C" int fa_forward_f32(const void* q, const void* k, const void* v,
                              void* o, void* lse, int B, int S, int H, int Hkv,
                              int hd, int causal, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16:
      return simt::launch<16>(q, k, v, o, lse, B, S, H, Hkv, causal, st);
    case 32:
      return simt::launch<32>(q, k, v, o, lse, B, S, H, Hkv, causal, st);
    case 64:
      return simt::launch<64>(q, k, v, o, lse, B, S, H, Hkv, causal, st);
    case 128:
      return simt::launch<128>(q, k, v, o, lse, B, S, H, Hkv, causal, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int fa_forward_bf16(const void* q, const void* k, const void* v,
                               void* o, void* lse, int B, int S, int H, int Hkv,
                               int hd, int causal, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16:
      return tc::launch<16>(q, k, v, o, lse, B, S, H, Hkv, causal, st);
    case 32:
      return tc::launch<32>(q, k, v, o, lse, B, S, H, Hkv, causal, st);
    case 64:
      return tc::launch<64>(q, k, v, o, lse, B, S, H, Hkv, causal, st);
    case 128:
      return tc::launch<128>(q, k, v, o, lse, B, S, H, Hkv, causal, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
