// Multi-tensor AdamW with global-norm clipping for Hopper (sm_90a).
//
// Replaces no Pallas kernel. The JAX package's optimizer
// (src/repro/optim/adamw.py `adamw_update`) is jnp code that XLA fuses
// into one loop a leaf. The port's per-leaf PyTorch version
// (src/repro_torch/optim/adamw.py) launches each operation of it as a
// kernel of its own: about 25 a leaf, each reading and writing whole fp32
// copies. Over a tree of ~290 leaves that is ~214 bytes of device traffic
// a parameter. This file does the same arithmetic over the whole tree in
// two launches.
//
// What it computes, for every leaf of the tree (parameters p in bf16 or
// fp32, gradients g in bf16 or fp32, fp32 moments m and v):
//
//     norm  = sqrt(sum over the tree of g^2)
//     scale = min(max_norm * (1 / max(norm, 1e-12)), 1)
//     gc    = round_to_g's_dtype(g * scale)
//     m'    = b1 m + (1 - b1) gc
//     v'    = b2 v + (1 - b2) gc^2
//     d     = (m' / bc1) / (sqrt(v' / bc2) + eps)   [+ wd p for a decayed leaf]
//     p'    = round_to_p's_dtype(p - lr d)
//
// Each line is the per-leaf code's operation in its order, one rounding
// each (`__fmul_rn`, `__fadd_rn`, `__fdiv_rn`, `__fsqrt_rn`), so nvcc
// contracts nothing into an FMA that PyTorch's separate kernels do not:
// with the same scale the results are the per-leaf code's bits. Only the
// norm's summation order differs. lr, bc1 and bc2 are read from device
// memory (the schedule stays PyTorch scalar code, no host read); the
// constants come in as the fp32 values PyTorch's kernels use.
//
// Layout. The host passes one int64 table: kLeafWords words a leaf (the
// `Leaf` struct below: seven pointers, the element count, flags), then
// the chunk table, one word a chunk: leaf | (index << 32), the chunk
// covering elements [index * kChunk, min((index + 1) * kChunk, n)) of its
// leaf. Outputs are new tensors; the inputs are only read.
//
// - adamw_norm_kernel: kNormBlocks persistent blocks walk the chunks (block b
//   takes b, b + kNormBlocks, ...); each thread sums squares of kVec
//   gradient elements a step (16-byte loads), pairwise, into a sum a chunk
//   and that into its total; the block's threads are summed by a fixed
//   shuffle tree and the warps in order, one partial a block. No atomics.
// - adamw_update_kernel: every block first sums the kNormBlocks partials in
//   the same fixed order (the same bits in every block), forms norm and
//   scale as `clip_by_global_norm` does, and block 0 writes the norm.
//   Then the blocks (as many as fit on the card at once) walk the chunks,
//   kVec elements a thread a step.
// A leaf whose seven pointers are all 16-byte aligned is read and written
// with vector accesses, the last len % kVec elements of a chunk one by
// one; any other leaf (a view at an odd offset) is walked element by
// element. The results are the same bits either way.
//
// What bounds it on this card: memory. Per element the norm reads g once
// (2 bytes in bf16) and the update reads p, g, m, v and writes p', m',
// v' (22 bytes for bf16 parameters and gradients): 24 bytes a parameter,
// 44.1 GB for Qwen1.5-1.8B's 1.836 B parameters, 13.2 ms at 3.35 TB/s.
// The arithmetic (~15 fp32 operations an element, three of them
// divisions and one a square root) is far below the memory's time.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;         // threads a block, both kernels
constexpr int kVec = 8;               // elements a thread takes a step
constexpr int kChunk = 65536;         // elements a chunk (a multiple of kVec)
constexpr int kNormBlocks = 528;      // 4 x 132 blocks: one partial each
constexpr int kLeafWords = 9;         // int64 words a leaf descriptor
constexpr long long kDecay = 1;       // flag: weight decay on this leaf
constexpr long long kParamBf16 = 2;   // flag: p (and p') bf16, else fp32
constexpr long long kGradBf16 = 4;    // flag: g bf16, else fp32
constexpr long long kAligned = 8;     // flag: all seven pointers 16-byte aligned
constexpr float kNormFloor = 1e-12f;  // clamp(norm, min=1e-12)

struct Leaf {
  const void* p;
  const void* g;
  const float* m;
  const float* v;
  void* p_out;
  float* m_out;
  float* v_out;
  long long n;
  long long flags;
};
static_assert(sizeof(Leaf) == kLeafWords * 8, "Leaf is kLeafWords int64 words");

struct Consts {
  float b1, omb1, b2, omb2, eps, wd;
};

struct Step {
  float scale, lr, bc1, bc2;
};

template <bool kBf16>
__device__ __forceinline__ void load8(const void* base, long long i, float (&x)[kVec]) {
  if constexpr (kBf16) {
    const uint4 raw = __ldcs(reinterpret_cast<const uint4*>(
        static_cast<const __nv_bfloat16*>(base) + i));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(h[k]);
      x[2 * k] = f.x;
      x[2 * k + 1] = f.y;
    }
  } else {
    const float4* q = reinterpret_cast<const float4*>(static_cast<const float*>(base) + i);
    const float4 a = __ldcs(q), b = __ldcs(q + 1);
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
    x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
  }
}

template <bool kBf16>
__device__ __forceinline__ void store8(void* base, long long i, const float (&x)[kVec]) {
  if constexpr (kBf16) {
    uint4 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int k = 0; k < 4; ++k) h[k] = __floats2bfloat162_rn(x[2 * k], x[2 * k + 1]);
    __stcs(reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(base) + i), raw);
  } else {
    float4* q = reinterpret_cast<float4*>(static_cast<float*>(base) + i);
    __stcs(q, make_float4(x[0], x[1], x[2], x[3]));
    __stcs(q + 1, make_float4(x[4], x[5], x[6], x[7]));
  }
}

template <bool kBf16>
__device__ __forceinline__ float load1(const void* base, long long i) {
  if constexpr (kBf16) return __bfloat162float(static_cast<const __nv_bfloat16*>(base)[i]);
  else return static_cast<const float*>(base)[i];
}

template <bool kBf16>
__device__ __forceinline__ void store1(void* base, long long i, float x) {
  if constexpr (kBf16) static_cast<__nv_bfloat16*>(base)[i] = __float2bfloat16_rn(x);
  else static_cast<float*>(base)[i] = x;
}

// `.to(g.dtype)` of the clipped fp32 gradient, widened again
template <bool kBf16>
__device__ __forceinline__ float round_to(float x) {
  if constexpr (kBf16) return __bfloat162float(__float2bfloat16_rn(x));
  else return x;
}

// The per-leaf code's `upd` for one element, operation by operation.
template <bool kGradBf16>
__device__ __forceinline__ void adamw_elem(float& p, float g, float& m, float& v,
                                           bool decay, const Consts& c, const Step& s) {
  const float gc = round_to<kGradBf16>(__fmul_rn(g, s.scale));
  m = __fadd_rn(__fmul_rn(c.b1, m), __fmul_rn(c.omb1, gc));
  v = __fadd_rn(__fmul_rn(c.b2, v), __fmul_rn(c.omb2, __fmul_rn(gc, gc)));
  const float mhat = __fdiv_rn(m, s.bc1);
  const float vhat = __fdiv_rn(v, s.bc2);
  float delta = __fdiv_rn(mhat, __fadd_rn(__fsqrt_rn(vhat), c.eps));
  if (decay) delta = __fadd_rn(delta, __fmul_rn(c.wd, p));
  p = __fsub_rn(p, __fmul_rn(s.lr, delta));
}

// The sum over the block, returned in thread 0 only: a fixed shuffle tree in
// each warp, then the warps in order. Called once a kernel.
__device__ __forceinline__ float block_sum(float x) {
  __shared__ float warp_sums[kThreads / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = x;
  __syncthreads();
  float total = 0.f;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) total += warp_sums[w];
  }
  return total;
}

__device__ __forceinline__ void decode(long long entry, const Leaf* leaves, Leaf& leaf,
                                       long long& start, int& len) {
  leaf = leaves[static_cast<int>(entry & 0xffffffffLL)];
  start = (entry >> 32) * kChunk;
  const long long left = leaf.n - start;
  len = static_cast<int>(left < kChunk ? left : kChunk);
}

// This thread's share of sum(g^2) over one chunk.
template <bool kBf16>
__device__ __forceinline__ float chunk_sumsq(const void* g, long long start, int len,
                                             bool aligned) {
  float acc = 0.f;
  int done = 0;
  if (aligned) {
    const int nvec = len / kVec;
#pragma unroll 4
    for (int j = threadIdx.x; j < nvec; j += kThreads) {
      float x[kVec];
      load8<kBf16>(g, start + static_cast<long long>(j) * kVec, x);
      const float s = ((x[0] * x[0] + x[1] * x[1]) + (x[2] * x[2] + x[3] * x[3])) +
                      ((x[4] * x[4] + x[5] * x[5]) + (x[6] * x[6] + x[7] * x[7]));
      acc += s;
    }
    done = nvec * kVec;
  }
  for (int j = done + threadIdx.x; j < len; j += kThreads) {
    const float x = load1<kBf16>(g, start + j);
    acc = fmaf(x, x, acc);
  }
  return acc;
}

__global__ void __launch_bounds__(kThreads)
adamw_norm_kernel(const Leaf* __restrict__ leaves,
                  const long long* __restrict__ chunks, int n_chunks,
                  float* __restrict__ partials) {
  float total = 0.f;
  for (int c = blockIdx.x; c < n_chunks; c += kNormBlocks) {
    Leaf leaf;
    long long start;
    int len;
    decode(chunks[c], leaves, leaf, start, len);
    const bool aligned = leaf.flags & kAligned;
    total += (leaf.flags & kGradBf16) ? chunk_sumsq<true>(leaf.g, start, len, aligned)
                                      : chunk_sumsq<false>(leaf.g, start, len, aligned);
  }
  const float sum = block_sum(total);
  if (threadIdx.x == 0) partials[blockIdx.x] = sum;
}

template <bool kP, bool kG>
__device__ __forceinline__ void chunk_update(const Leaf& leaf, long long start, int len,
                                             const Consts& c, const Step& s) {
  const bool decay = leaf.flags & kDecay;
  int done = 0;
  if (leaf.flags & kAligned) {
    const int nvec = len / kVec;
    for (int j = threadIdx.x; j < nvec; j += kThreads) {
      const long long i = start + static_cast<long long>(j) * kVec;
      float p[kVec], g[kVec], m[kVec], v[kVec];
      load8<kP>(leaf.p, i, p);
      load8<kG>(leaf.g, i, g);
      load8<false>(leaf.m, i, m);
      load8<false>(leaf.v, i, v);
#pragma unroll
      for (int k = 0; k < kVec; ++k) adamw_elem<kG>(p[k], g[k], m[k], v[k], decay, c, s);
      store8<kP>(leaf.p_out, i, p);
      store8<false>(leaf.m_out, i, m);
      store8<false>(leaf.v_out, i, v);
    }
    done = nvec * kVec;
  }
  for (int j = done + threadIdx.x; j < len; j += kThreads) {
    const long long i = start + j;
    float p = load1<kP>(leaf.p, i), m = leaf.m[i], v = leaf.v[i];
    adamw_elem<kG>(p, load1<kG>(leaf.g, i), m, v, decay, c, s);
    store1<kP>(leaf.p_out, i, p);
    leaf.m_out[i] = m;
    leaf.v_out[i] = v;
  }
}

__global__ void __launch_bounds__(kThreads)
adamw_update_kernel(const Leaf* __restrict__ leaves,
                    const long long* __restrict__ chunks, int n_chunks,
                    const float* __restrict__ partials, float max_norm,
                    const float* __restrict__ lr, const float* __restrict__ bc1,
                    const float* __restrict__ bc2, Consts c,
                    float* __restrict__ norm_out) {
  __shared__ float shared_scale;
  float part = 0.f;
  for (int i = threadIdx.x; i < kNormBlocks; i += kThreads) part += partials[i];
  const float sumsq = block_sum(part);
  if (threadIdx.x == 0) {
    const float norm = __fsqrt_rn(sumsq);
    const float floored = norm < kNormFloor ? kNormFloor : norm;  // NaN stays
    float scale = __fmul_rn(__fdiv_rn(1.0f, floored), max_norm);
    if (scale > 1.0f) scale = 1.0f;  // clamp(max=1), NaN stays
    shared_scale = scale;
    if (blockIdx.x == 0) *norm_out = norm;
  }
  __syncthreads();
  const Step s{shared_scale, *lr, *bc1, *bc2};
  for (int ci = blockIdx.x; ci < n_chunks; ci += gridDim.x) {
    Leaf leaf;
    long long start;
    int len;
    decode(chunks[ci], leaves, leaf, start, len);
    const bool pb = leaf.flags & kParamBf16, gb = leaf.flags & kGradBf16;
    if (pb && gb) chunk_update<true, true>(leaf, start, len, c, s);
    else if (pb) chunk_update<true, false>(leaf, start, len, c, s);
    else if (gb) chunk_update<false, true>(leaf, start, len, c, s);
    else chunk_update<false, false>(leaf, start, len, c, s);
  }
}

// Blocks of adamw_update_kernel resident on the card at once (all of them
// walk the chunks; more would only queue behind), found once a process.
cudaError_t update_grid(int* grid) {
  static int resident = 0;
  if (resident == 0) {
    int device = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, adamw_update_kernel, kThreads, 0);
    if (err != cudaSuccess) return err;
    resident = sms * (per_sm > 0 ? per_sm : 1);
  }
  *grid = resident;
  return cudaSuccess;
}

}  // namespace

// Launch adamw_norm_kernel: kNormBlocks partial sums of g^2 into `partials`.
// `table` is the leaf descriptors then the chunk table, on the card.
extern "C" int adamw_norm_partials(const void* table, int n_leaves, int n_chunks,
                                   void* partials, void* stream) {
  const Leaf* leaves = static_cast<const Leaf*>(table);
  const long long* chunks = static_cast<const long long*>(table) +
                            static_cast<long long>(n_leaves) * kLeafWords;
  adamw_norm_kernel<<<kNormBlocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      leaves, chunks, n_chunks, static_cast<float*>(partials));
  return static_cast<int>(cudaGetLastError());
}

// Launch adamw_update_kernel: the norm from `partials` into `norm_out`, then
// p', m', v' of every leaf.
extern "C" int adamw_update(const void* table, int n_leaves, int n_chunks,
                            const void* partials, float max_norm, const void* lr,
                            const void* bc1, const void* bc2, float b1, float omb1,
                            float b2, float omb2, float eps, float weight_decay,
                            void* norm_out, void* stream) {
  int resident = 0;
  const cudaError_t err = update_grid(&resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = n_chunks < resident ? (n_chunks > 0 ? n_chunks : 1) : resident;
  const Leaf* leaves = static_cast<const Leaf*>(table);
  const long long* chunks = static_cast<const long long*>(table) +
                            static_cast<long long>(n_leaves) * kLeafWords;
  adamw_update_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      leaves, chunks, n_chunks, static_cast<const float*>(partials), max_norm,
      static_cast<const float*>(lr), static_cast<const float*>(bc1),
      static_cast<const float*>(bc2), Consts{b1, omb1, b2, omb2, eps, weight_decay},
      static_cast<float*>(norm_out));
  return static_cast<int>(cudaGetLastError());
}
