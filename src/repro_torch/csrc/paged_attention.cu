// Paged decode attention for Hopper (sm_90a): one new query token per
// sequence attends to its KV cache, read through the block table.
//
// Replaces repro/kernels/paged_attention.py:paged_decode_attention
// (_paged_attn_kernel). Same function: GQA with KV-major head grouping
// (q[b].reshape(KV, g, hd)), q scaled by hd^-0.5 in f32, an online
// softmax (m, l, acc) in f32, positions at or past kv_len[b] left out,
// output acc / max(l, 1e-30) cast to q's dtype -- so kv_len == 0 gives
// zeros, as the Pallas kernel does.
//
// Plain extern "C" entry point, loaded with ctypes by
// repro_torch/kernels/_build.py; the wrapper (kernels/ops.py) checks
// shapes, dtypes, devices and contiguity and never synchronises.
//
// Layout: q (B, H, hd); pool (n_blocks, bt, 2, KV, hd); block_table
// (B, mbs) int32; kv_len (B,) int32; out (B, H, hd) in q's dtype.
//
// Design (flash-decoding). The work of one (sequence, KV head) -- the g =
// H/KV query heads that share that head's K and V -- is cut along the
// sequence into splits of kChunk positions, and each split is one thread
// block, so a batch of 8 sequences of 512 tokens keeps 512 blocks busy
// rather than 64; every K/V byte is still read from HBM once. A block
// walks its split in tiles of kTile tokens (a tile may span several
// context blocks: each token's pool row is found through the block
// table, so bt = 8 and bt = 64 take the same path). Per tile:
//   0. one thread per token looks its pool row up in the block table;
//   1. the tile's V rows are staged in shared memory as f32, and each
//      warp scores its kTile/8 tokens against the g query heads: a lane
//      holds hd/32 elements of each K row (lane-strided, so each load
//      instruction of the warp is contiguous; all of a warp's K loads are
//      in flight together), and a butterfly shuffle sums each product;
//   2. one warp per head folds the tile's scores into the running max and
//      denominator and turns them into probabilities;
//   3. each thread rescales its (head, element) accumulators and adds the
//      tile's probability-weighted V rows.
// The split's (m, l, acc) go to an f32 workspace; a second kernel, one
// block per (sequence, KV head), merges the splits that hold positions:
// out = sum(acc_s e^(m_s - M)) / max(sum(l_s e^(m_s - M)), 1e-30) with
// M = max m_s -- zeros when kv_len is 0. Splits past kv_len return at
// once. Tokens past kv_len are never read (the Pallas kernel reads whole
// blocks and masks scores to -1e30, whose probability is 0): same
// result, and no NEG_INF score ever reaches exp.
//
// Bound on the card: reading K and V once. At the main-path shape (B 8,
// KV 8, hd 128, kv_len 512, bf16) that is 16.8 MB, ~5.0 us at 3.35 TB/s;
// the arithmetic (4 flops per K/V element and query head) is far below
// even the f32 rate. Each split still walks its two tiles in order with
// four barriers per tile, so the kernel is latency- rather than
// bandwidth-bound; overlapping one tile's loads with the previous
// tile's arithmetic (a cp.async or TMA ring) is the next step.
//
// A block-table entry the kernel reads (context blocks below
// ceil(kv_len/bt)) outside [0, n_blocks) traps: the launch fails loudly
// instead of reading wild memory.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;            // tokens per shared-memory tile
static_assert(kTile == 32, "the softmax step gives each lane of a warp one token");
constexpr int kTokensPerWarp = kTile / kWarps;   // score step
constexpr int kChunk = 2 * kTile;    // positions per split (one block)
constexpr float kNegInf = -1e30f;
constexpr int kMaxSharedBytes = 232448;  // 227 KB: the opt-in maximum

// dtype codes shared with the wrapper
enum : int { kF32 = 0, kF16 = 1, kBF16 = 2 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// Pool row of the token at position pos of sequence b: block-table lookup
// with the bounds check, then the slot inside the block.
__device__ __forceinline__ int64_t token_row(const int32_t* __restrict__ table,
                                             int b, int mbs, int bt, int pos,
                                             int64_t n_blocks) {
  const int32_t blk = table[static_cast<int64_t>(b) * mbs + pos / bt];
  if (blk < 0 || blk >= n_blocks) __trap();
  return static_cast<int64_t>(blk) * bt + pos % bt;
}

// Shared memory: the tile's pool rows (kTile int64), then in floats q
// (g x HD, pre-scaled), acc (g x HD), V tile (kTile x HD), scores /
// probabilities (g x kTile), m, l, alpha (g).
__host__ __device__ inline int64_t shared_bytes(int g, int hd) {
  return 8LL * kTile + 4 * (2LL * g * hd + static_cast<int64_t>(kTile) * hd +
                            static_cast<int64_t>(g) * kTile + 3LL * g);
}

// Workspace of the splits, f32: m and l (B*H*n_split each), then acc
// (B*H*n_split x HD); query head hq = b*H + kh*g + h, split s at
// hq*n_split + s.
template <typename TQ, typename TP, int HD>
__global__ void __launch_bounds__(kThreads)
paged_attn_split_kernel(const TQ* __restrict__ q, const TP* __restrict__ pool,
                        const int32_t* __restrict__ table,
                        const int32_t* __restrict__ kv_len,
                        float* __restrict__ ws, int H, int KV, int bt, int mbs,
                        int64_t n_blocks, int n_split, float scale) {
  constexpr int EPL = HD / 32;        // K elements per lane
  extern __shared__ int64_t smem_raw[];
  const int g = H / KV;
  const int b = blockIdx.x / KV;
  const int kh = blockIdx.x % KV;
  const int split = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gd = g * HD;
  const int len = kv_len[b];
  const int n_pos = len <= 0 ? 0 : min(len, mbs * bt);
  const int p0 = split * kChunk;
  if (p0 >= n_pos) return;             // the whole block: no position here
  const int p1 = min(p0 + kChunk, n_pos);

  int64_t* row_s = smem_raw;           // [kTile]
  float* q_s = reinterpret_cast<float*>(row_s + kTile);   // [g][HD]
  float* acc_s = q_s + gd;             // [g][HD]
  float* v_s = acc_s + gd;             // [kTile][HD]
  float* p_s = v_s + kTile * HD;       // [g][kTile]
  float* m_s = p_s + g * kTile;        // [g]
  float* l_s = m_s + g;                // [g]
  float* a_s = l_s + g;                // [g]

  // the g query heads of this KV head are contiguous: rows kh*g .. kh*g+g-1
  const int64_t qo = (static_cast<int64_t>(b) * H + static_cast<int64_t>(kh) * g) * HD;
  for (int i = tid; i < gd; i += kThreads) {
    q_s[i] = to_f32(q[qo + i]) * scale;
    acc_s[i] = 0.f;
  }
  for (int h = tid; h < g; h += kThreads) {
    m_s[h] = kNegInf;
    l_s[h] = 0.f;
  }
  // element (row, kv01, kh, d) of the pool
  const int64_t row_stride = 2LL * KV * HD;
  const int64_t k_off = static_cast<int64_t>(kh) * HD;
  const int64_t v_off = static_cast<int64_t>(KV + kh) * HD;
  __syncthreads();

  for (int t0 = p0; t0 < p1; t0 += kTile) {
    const int nt = min(kTile, p1 - t0);
    // 0. the tile's pool rows, one block-table lookup per token
    if (tid < nt) row_s[tid] = token_row(table, b, mbs, bt, t0 + tid, n_blocks);
    __syncthreads();
    // 1a. stage the tile's V rows (threads along d: coalesced)
#pragma unroll 4
    for (int i = tid; i < nt * HD; i += kThreads) {
      const int t = i / HD, d = i % HD;
      v_s[i] = to_f32(pool[row_s[t] * row_stride + v_off + d]);
    }
    // 1b. scores: each warp takes kTile / kWarps tokens, lanes along d;
    // all of its K loads are issued before the first dot product
    float k[kTokensPerWarp][EPL];
#pragma unroll
    for (int j = 0; j < kTokensPerWarp; ++j) {
      const int t = warp + j * kWarps;
      const TP* krow = pool + row_s[t < nt ? t : 0] * row_stride + k_off;
#pragma unroll
      for (int e = 0; e < EPL; ++e) k[j][e] = t < nt ? to_f32(krow[lane + 32 * e]) : 0.f;
    }
    for (int h = 0; h < g; ++h) {
      const float* qh = q_s + h * HD;
      float qv[EPL];
#pragma unroll
      for (int e = 0; e < EPL; ++e) qv[e] = qh[lane + 32 * e];
#pragma unroll
      for (int j = 0; j < kTokensPerWarp; ++j) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) dot = fmaf(qv[e], k[j][e], dot);
        dot = warp_sum(dot);
        const int t = warp + j * kWarps;
        if (lane == 0 && t < nt) p_s[h * kTile + t] = dot;
      }
    }
    __syncthreads();
    // 2. online softmax: one warp per head, lanes along the tile
    for (int h = warp; h < g; h += kWarps) {
      const float s = lane < nt ? p_s[h * kTile + lane] : kNegInf;
      const float m_old = m_s[h];
      const float m_new = fmaxf(m_old, warp_max(s));
      const float p = lane < nt ? expf(s - m_new) : 0.f;
      if (lane < nt) p_s[h * kTile + lane] = p;
      const float sum = warp_sum(p);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        l_s[h] = l_s[h] * alpha + sum;
        m_s[h] = m_new;
        a_s[h] = alpha;
      }
    }
    __syncthreads();
    // 3. acc = acc * alpha + p . V (threads along d: conflict-free reads)
    for (int i = tid; i < gd; i += kThreads) {
      const int h = i / HD, d = i % HD;
      const float* ph = p_s + h * kTile;
      float a = acc_s[i] * a_s[h];
      for (int t = 0; t < nt; ++t) a = fmaf(ph[t], v_s[t * HD + d], a);
      acc_s[i] = a;
    }
    __syncthreads();
  }

  // the split's partials, unnormalised
  const int64_t hq0 = static_cast<int64_t>(b) * H + static_cast<int64_t>(kh) * g;
  const int64_t n_heads = static_cast<int64_t>(gridDim.x / KV) * H;
  float* ws_m = ws;
  float* ws_l = ws + n_heads * n_split;
  float* ws_acc = ws + 2 * n_heads * n_split;
  for (int h = tid; h < g; h += kThreads) {
    ws_m[(hq0 + h) * n_split + split] = m_s[h];
    ws_l[(hq0 + h) * n_split + split] = l_s[h];
  }
  for (int i = tid; i < gd; i += kThreads) {
    const int h = i / HD, d = i % HD;
    ws_acc[((hq0 + h) * n_split + split) * HD + d] = acc_s[i];
  }
}

// Merge the splits of one (sequence, KV head) that hold positions.
template <typename TQ, int HD>
__global__ void __launch_bounds__(kThreads)
paged_attn_merge_kernel(const float* __restrict__ ws,
                        const int32_t* __restrict__ kv_len,
                        TQ* __restrict__ out, int H, int KV, int bt, int mbs,
                        int n_split) {
  const int g = H / KV;
  const int b = blockIdx.x / KV;
  const int kh = blockIdx.x % KV;
  const int len = kv_len[b];
  const int n_pos = len <= 0 ? 0 : min(len, mbs * bt);
  const int n_used = (n_pos + kChunk - 1) / kChunk;
  const int64_t hq0 = static_cast<int64_t>(b) * H + static_cast<int64_t>(kh) * g;
  const int64_t n_heads = static_cast<int64_t>(gridDim.x / KV) * H;
  const float* ws_m = ws;
  const float* ws_l = ws + n_heads * n_split;
  const float* ws_acc = ws + 2 * n_heads * n_split;
  for (int i = threadIdx.x; i < g * HD; i += kThreads) {
    const int h = i / HD, d = i % HD;
    const int64_t base = (hq0 + h) * n_split;
    float m = kNegInf;
    for (int s = 0; s < n_used; ++s) m = fmaxf(m, ws_m[base + s]);
    float l = 0.f, a = 0.f;
    for (int s = 0; s < n_used; ++s) {
      const float w = expf(ws_m[base + s] - m);
      l = fmaf(ws_l[base + s], w, l);
      a = fmaf(ws_acc[(base + s) * HD + d], w, a);
    }
    out[(hq0 + h) * HD + d] = from_f32<TQ>(a / fmaxf(l, 1e-30f));
  }
}

template <typename TQ, typename TP, int HD>
int launch(const void* q, const void* pool, const void* table,
           const void* kv_len, void* out, void* ws, int64_t B, int64_t H,
           int64_t KV, int64_t bt, int64_t mbs, int64_t n_blocks,
           int64_t n_split, float scale, cudaStream_t stream) {
  const int64_t smem = shared_bytes(static_cast<int>(H / KV), HD);
  if (smem > kMaxSharedBytes || n_split * kChunk < mbs * bt || n_split > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  auto split = paged_attn_split_kernel<TQ, TP, HD>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        split, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(static_cast<unsigned>(B * KV), static_cast<unsigned>(n_split));
  split<<<grid, kThreads, static_cast<size_t>(smem), stream>>>(
      static_cast<const TQ*>(q), static_cast<const TP*>(pool),
      static_cast<const int32_t*>(table), static_cast<const int32_t*>(kv_len),
      static_cast<float*>(ws), static_cast<int>(H), static_cast<int>(KV),
      static_cast<int>(bt), static_cast<int>(mbs), n_blocks,
      static_cast<int>(n_split), scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  paged_attn_merge_kernel<TQ, HD><<<static_cast<unsigned>(B * KV), kThreads, 0,
                                    stream>>>(
      static_cast<const float*>(ws), static_cast<const int32_t*>(kv_len),
      static_cast<TQ*>(out), static_cast<int>(H), static_cast<int>(KV),
      static_cast<int>(bt), static_cast<int>(mbs), static_cast<int>(n_split));
  return static_cast<int>(cudaGetLastError());
}

#define PA_ARGS q, pool, table, kv_len, out, ws, B, H, KV, bt, mbs, n_blocks, n_split, scale, stream

template <typename TQ, typename TP>
int launch_hd(int64_t hd, const void* q, const void* pool, const void* table,
              const void* kv_len, void* out, void* ws, int64_t B, int64_t H,
              int64_t KV, int64_t bt, int64_t mbs, int64_t n_blocks,
              int64_t n_split, float scale, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch<TQ, TP, 32>(PA_ARGS);
    case 64: return launch<TQ, TP, 64>(PA_ARGS);
    case 128: return launch<TQ, TP, 128>(PA_ARGS);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// ws: f32 workspace of B*H*n_split*(hd + 2) elements, n_split >=
// ceil(mbs*bt / kChunk). Returns a cudaError_t code:
// cudaErrorInvalidValue for a dtype pair or head size the kernel does not
// take, a g x hd that needs more shared memory than a block has, or a
// split count that does not cover the table or exceeds 65535.
int paged_attn_decode(const void* q, const void* pool, const void* table,
                      const void* kv_len, void* out, void* ws, int64_t B,
                      int64_t H, int64_t KV, int64_t hd, int64_t bt,
                      int64_t mbs, int64_t n_blocks, int64_t n_split,
                      int q_dtype, int pool_dtype, float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0) return 0;
  if (q_dtype == kBF16 && pool_dtype == kBF16)
    return launch_hd<__nv_bfloat16, __nv_bfloat16>(hd, q, pool, table, kv_len, out, ws, B, H, KV, bt, mbs, n_blocks, n_split, scale, s);
  if (q_dtype == kF32 && pool_dtype == kBF16)
    return launch_hd<float, __nv_bfloat16>(hd, q, pool, table, kv_len, out, ws, B, H, KV, bt, mbs, n_blocks, n_split, scale, s);
  if (q_dtype == kF32 && pool_dtype == kF32)
    return launch_hd<float, float>(hd, q, pool, table, kv_len, out, ws, B, H, KV, bt, mbs, n_blocks, n_split, scale, s);
  if (q_dtype == kF16 && pool_dtype == kF16)
    return launch_hd<__half, __half>(hd, q, pool, table, kv_len, out, ws, B, H, KV, bt, mbs, n_blocks, n_split, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
