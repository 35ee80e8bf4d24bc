// Paged latent-attention (MLA) decode for Hopper (sm_90a): one new query
// token per sequence, 16 heads, attends to the sequence's latent cache,
// read through the block table. DeepSeek-V2's absorbed decode form.
//
// Replaces no Pallas kernel: the reference has no latent attention. Its
// plain version is repro_torch/kernels/ref.py:paged_mla_decode. Same
// function: per head the score of a position is (q . row) * scale over
// the whole 576-wide row [c | k_pe]; softmax over the positions below
// kv_len[b], in f32; the output is sum p c over the row's first 512
// values (the latent is also the value), acc / max(l, 1e-30) in q's
// dtype -- so kv_len == 0 gives zeros.
//
// Plain extern "C" entry point, loaded with ctypes by
// repro_torch/kernels/_build.py; the wrapper (kernels/ops.py) checks
// shapes, dtypes, devices and contiguity and never synchronises.
//
// Layout: q (B, 16, 576), each head [q_lat | q_pe]; pool (n_blocks, bt,
// 576); block_table (B, mbs) int32; kv_len (B,) int32; out (B, 16, 512)
// in q's dtype. bf16 q with a bf16 pool, or f32 with f32.
//
// What bounds it on the H100: reading each latent row once. At the
// serving shape (batch 64, contexts 256-1024, bf16) a layer reads
// 64 x kv_len x 1152 B, ~47 MB at kv_len 640: 14 us at 3.35 TB/s. All 16
// heads share every row, so the arithmetic is 2 x 16 x (576 + 512) flops
// per row, 30 per byte: on CUDA cores in f32 (67 TFLOP/s) that is 21 us,
// above the byte bound; on the tensor cores (989 TFLOP/s in bf16) 1.4 us.
// So the bf16 kernel does both products with mma.sync, the 16 heads being
// exactly one m16n8k16 M tile, and stays byte-bound.
//
// Design (flash-decoding, split-KV, two launches):
//   * Blocks are (split of kSpan = 256 positions, sequence); a block past
//     its sequence's kv_len returns at once (the wrapper knows no kv_len:
//     it lives on the device and is never synchronised). 128 threads, two
//     blocks an SM (86 KB of shared memory each).
//   * The split's pool rows come from the block table first (one lookup
//     per token, a bad entry traps). Then stages of kTile = 32 tokens go
//     through a two-stage cp.async ring (16 B a lane, L2 only), rows
//     padded to 584 values so ldmatrix hits every bank once; positions
//     past kv_len are zero-filled (a zero row times p = 0 stays finite).
//   * Scores S = Q K^T: warp w holds its nine 16-wide k-steps of Q as A
//     fragments in registers for the whole split (read once from global)
//     and multiplies them into all 32 tokens of a stage (K^T fragments by
//     ldmatrix); the four warps' partial scores meet in shared memory.
//     The online softmax (exp2, scale pre-multiplied by log2 e) runs 8
//     threads to a head. O += P V: warp w owns 128 of the 512 value
//     columns, P (rounded to bf16, as flash attention does) by ldmatrix,
//     V by ldmatrix.trans of the same stage; accumulators in f32.
//   * A sequence that fits one split writes its output directly; else
//     each split leaves (m, l, acc) in an f32 workspace and a second,
//     small kernel (one block per head and sequence) merges them:
//     out = sum(acc_s 2^(m_s - M)) / max(sum(l_s 2^(m_s - M)), 1e-30),
//     and writes the zeros of kv_len 0.
//   * f32 pools take a plain CUDA-core kernel of the same splits (8
//     threads to a head, a token at a time, FMAs in f32): a bf16
//     tensor-core operand would round them. It is the card tests' path,
//     not the serving one.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kHeads = 16;           // one MMA M tile
constexpr int kWidth = 576;          // a latent row: c, then k_pe
constexpr int kRank = 512;           // c, which is also the value
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;            // tokens per stage
constexpr int kSpan = 256;           // positions per split
constexpr int kMaxSplits = 256;      // the merge's weights in shared memory
constexpr int kStride = kWidth + 8;  // a staged row, bf16: 1168 B
constexpr int kKSteps = kWidth / 16;
constexpr int kKStepsPerWarp = kKSteps / kWarps;
constexpr int kColsPerWarp = kRank / kWarps;
constexpr int kNTiles = kColsPerWarp / 8;
constexpr int kSStride = kTile + 4;  // partial scores, f32
constexpr int kPStride = kTile + 8;  // probabilities, bf16: 80 B
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kKSteps % kWarps == 0 && kNTiles % 2 == 0, "warp shares");
static_assert(kTile == 32 && kThreads == 8 * kHeads, "the softmax: 8 threads a head, 4 tokens each");
static_assert(kSpan % kTile == 0, "whole stages in a split");

// shared memory of the bf16 kernel, bytes
constexpr int kKvBytes = 2 * kTile * kStride * 2;
constexpr int kSPartBytes = kWarps * kHeads * kSStride * 4;
constexpr int kPBytes = kHeads * kPStride * 2;
constexpr int kRowBytes = kSpan * 8;
constexpr int kSmemBytes = kKvBytes + kSPartBytes + kPBytes + kRowBytes + 3 * kHeads * 4;
static_assert(kKvBytes % 16 == 0 && kSPartBytes % 16 == 0 && kPBytes % 16 == 0,
              "16-byte aligned arrays");

// dtype codes shared with the wrapper
enum : int { kF32 = 0, kF16 = 1, kBF16 = 2 };

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;      // 0: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
}

// d += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float group8_max(float x) {
  for (int off = 1; off < 8; off <<= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float group8_sum(float x) {
  for (int off = 1; off < 8; off <<= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Positions of sequence b the launch covers (kv_len clamped to the table).
__device__ __forceinline__ int seq_len(const int32_t* __restrict__ kv_len, int b, int cap) {
  return max(0, min(kv_len[b], cap));
}

// The split's pool rows: one block-table lookup per position, the bounds
// checked (a bad entry traps rather than read wild memory).
__device__ __forceinline__ void split_rows(const int32_t* __restrict__ table, int b, int mbs,
                                           int bt, int start, int nt, int64_t n_blocks,
                                           int64_t* row_s) {
  for (int i = threadIdx.x; i < nt; i += kThreads) {
    const int pos = start + i;
    const int32_t blk = table[static_cast<int64_t>(b) * mbs + pos / bt];
    if (blk < 0 || blk >= n_blocks) __trap();
    row_s[i] = static_cast<int64_t>(blk) * bt + pos % bt;
  }
}

// Workspace, f32: acc (B, n_split, 16, 512), then m and l (B, n_split, 16)
// each; m in log2 units.
struct Workspace {
  float* acc;
  float* m;
  float* l;
  __device__ Workspace(float* ws, int B, int n_split) {
    const int64_t n = static_cast<int64_t>(B) * n_split * kHeads;
    acc = ws;
    m = ws + n * kRank;
    l = m + n;
  }
};

// ------------------------------------------------------------ bf16, MMA
__global__ void __launch_bounds__(kThreads, 2)
paged_mla_split_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ pool,
                       const int32_t* __restrict__ table,
                       const int32_t* __restrict__ kv_len,
                       __nv_bfloat16* __restrict__ out, float* __restrict__ ws,
                       int B, int bt, int mbs, int64_t n_blocks, int n_split,
                       float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* kv_s = reinterpret_cast<__nv_bfloat16*>(smem);          // [2][kTile][kStride]
  float* s_part = reinterpret_cast<float*>(smem + kKvBytes);              // [kWarps][16][kSStride]
  __nv_bfloat16* p_s =
      reinterpret_cast<__nv_bfloat16*>(smem + kKvBytes + kSPartBytes);  // [16][kPStride]
  int64_t* row_s = reinterpret_cast<int64_t*>(smem + kKvBytes + kSPartBytes + kPBytes);
  float* alpha_s = reinterpret_cast<float*>(row_s + kSpan);               // [16]
  float* l_s = alpha_s + kHeads;
  float* m_s = l_s + kHeads;

  const int b = blockIdx.y, split = blockIdx.x;
  const int len = seq_len(kv_len, b, mbs * bt);
  const int start = split * kSpan;
  if (start >= len) return;
  const int nt = min(kSpan, len - start);
  const int n_act = (len + kSpan - 1) / kSpan;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;        // the MMA fragments' group and thread

  split_rows(table, b, mbs, bt, start, nt, n_blocks, row_s);

  // this warp's k-steps of Q as A fragments, straight from global
  const uint32_t* q32 = reinterpret_cast<const uint32_t*>(q + static_cast<int64_t>(b) * kHeads * kWidth);
  uint32_t qa[kKStepsPerWarp][4];
#pragma unroll
  for (int ks = 0; ks < kKStepsPerWarp; ++ks) {
    const int k0 = (warp * kKStepsPerWarp + ks) * 16 + 2 * tq;
    qa[ks][0] = q32[(g * kWidth + k0) / 2];
    qa[ks][1] = q32[((g + 8) * kWidth + k0) / 2];
    qa[ks][2] = q32[(g * kWidth + k0 + 8) / 2];
    qa[ks][3] = q32[((g + 8) * kWidth + k0 + 8) / 2];
  }
  __syncthreads();                               // row_s

  const int n_tiles = (nt + kTile - 1) / kTile;
  auto issue = [&](int j) {
    __nv_bfloat16* dst = kv_s + (j & 1) * kTile * kStride;
    constexpr int kVecs = kWidth / 8;            // 16-byte pieces of a row
    for (int c = tid; c < kTile * kVecs; c += kThreads) {
      const int t = c / kVecs, e = (c % kVecs) * 8, tok = j * kTile + t;
      const bool ok = tok < nt;
      cp_async16(dst + t * kStride + e, pool + (ok ? row_s[tok] * kWidth + e : 0), ok);
    }
  };
  issue(0);
  cp_async_commit();
  if (n_tiles > 1) issue(1);
  cp_async_commit();

  float acc[kNTiles][4];
#pragma unroll
  for (int n = 0; n < kNTiles; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  const int sh = tid >> 3, sj = tid & 7;        // softmax: head, token quad
  float m_run = kNegInf, l_run = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait1();
    __syncthreads();
    const __nv_bfloat16* tile = kv_s + (j & 1) * kTile * kStride;
    const int nt_j = min(kTile, nt - j * kTile);

    // a. partial scores over this warp's k-steps, all tokens of the stage
    float sc[kTile / 8][4];
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kKStepsPerWarp; ++ks) {
      const int k0 = (warp * kKStepsPerWarp + ks) * 16;
#pragma unroll
      for (int np = 0; np < kTile / 16; ++np) {
        uint32_t kb[4];
        ldsm_x4(kb, tile + (np * 16 + ((lane >> 4) << 3) + (lane & 7)) * kStride + k0 +
                        (((lane >> 3) & 1) << 3));
        mma_bf16(sc[2 * np], qa[ks], kb[0], kb[1]);
        mma_bf16(sc[2 * np + 1], qa[ks], kb[2], kb[3]);
      }
    }
    float* sp = s_part + warp * kHeads * kSStride;
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n) {
      const int t = n * 8 + 2 * tq;
      *reinterpret_cast<float2*>(sp + g * kSStride + t) = make_float2(sc[n][0], sc[n][1]);
      *reinterpret_cast<float2*>(sp + (g + 8) * kSStride + t) = make_float2(sc[n][2], sc[n][3]);
    }
    __syncthreads();

    // b. online softmax: 8 threads to head sh, tokens 4 sj .. 4 sj + 3
    {
      float s4[4];
      float4 part = *reinterpret_cast<const float4*>(s_part + sh * kSStride + 4 * sj);
      s4[0] = part.x; s4[1] = part.y; s4[2] = part.z; s4[3] = part.w;
#pragma unroll
      for (int w = 1; w < kWarps; ++w) {
        part = *reinterpret_cast<const float4*>(s_part + (w * kHeads + sh) * kSStride + 4 * sj);
        s4[0] += part.x; s4[1] += part.y; s4[2] += part.z; s4[3] += part.w;
      }
      float mx = kNegInf;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s4[i] = 4 * sj + i < nt_j ? s4[i] * scale_log2 : kNegInf;
        mx = fmaxf(mx, s4[i]);
      }
      const float m_new = fmaxf(m_run, group8_max(mx));
      const float alpha = exp2f(m_run - m_new);
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = 4 * sj + i < nt_j ? exp2f(s4[i] - m_new) : 0.f;
        p_s[sh * kPStride + 4 * sj + i] = __float2bfloat16_rn(p);
        sum += p;
      }
      l_run = l_run * alpha + group8_sum(sum);
      m_run = m_new;
      if (sj == 0) alpha_s[sh] = alpha;
    }
    __syncthreads();

    // c. O += P V over this warp's value columns
    const float al0 = alpha_s[g], al1 = alpha_s[g + 8];
#pragma unroll
    for (int n = 0; n < kNTiles; ++n) {
      acc[n][0] *= al0; acc[n][1] *= al0;
      acc[n][2] *= al1; acc[n][3] *= al1;
    }
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      uint32_t pa[4];
      ldsm_x4(pa, p_s + ((lane & 7) + (((lane >> 3) & 1) << 3)) * kPStride + kk * 16 +
                      ((lane >> 4) << 3));
#pragma unroll
      for (int np = 0; np < kNTiles / 2; ++np) {
        uint32_t vb[4];
        ldsm_x4_trans(vb, tile + (kk * 16 + (((lane >> 3) & 1) << 3) + (lane & 7)) * kStride +
                              warp * kColsPerWarp + np * 16 + ((lane >> 4) << 3));
        mma_bf16(acc[2 * np], pa, vb[0], vb[1]);
        mma_bf16(acc[2 * np + 1], pa, vb[2], vb[3]);
      }
    }
    __syncthreads();                             // the stage's buffer is free again
    if (j + 2 < n_tiles) issue(j + 2);
    cp_async_commit();
  }

  if (sj == 0) {
    l_s[sh] = l_run;
    m_s[sh] = m_run;
  }
  __syncthreads();
  if (n_act == 1) {
    const float i0 = 1.f / fmaxf(l_s[g], 1e-30f), i1 = 1.f / fmaxf(l_s[g + 8], 1e-30f);
    __nv_bfloat16* o = out + static_cast<int64_t>(b) * kHeads * kRank;
#pragma unroll
    for (int n = 0; n < kNTiles; ++n) {
      const int d = warp * kColsPerWarp + n * 8 + 2 * tq;
      *reinterpret_cast<__nv_bfloat162*>(o + g * kRank + d) =
          __floats2bfloat162_rn(acc[n][0] * i0, acc[n][1] * i0);
      *reinterpret_cast<__nv_bfloat162*>(o + (g + 8) * kRank + d) =
          __floats2bfloat162_rn(acc[n][2] * i1, acc[n][3] * i1);
    }
    return;
  }
  const Workspace w(ws, B, n_split);
  const int64_t hs = (static_cast<int64_t>(b) * n_split + split) * kHeads;
#pragma unroll
  for (int n = 0; n < kNTiles; ++n) {
    const int d = warp * kColsPerWarp + n * 8 + 2 * tq;
    *reinterpret_cast<float2*>(w.acc + (hs + g) * kRank + d) = make_float2(acc[n][0], acc[n][1]);
    *reinterpret_cast<float2*>(w.acc + (hs + g + 8) * kRank + d) =
        make_float2(acc[n][2], acc[n][3]);
  }
  if (tid < kHeads) {
    w.m[hs + tid] = m_s[tid];
    w.l[hs + tid] = l_s[tid];
  }
}

// ----------------------------------------------------------- f32, FMAs
constexpr int kQPer = kWidth / 8;    // q values a thread holds (72)
constexpr int kVPer = kRank / 8;     // value columns a thread owns (64)

__global__ void __launch_bounds__(kThreads)
paged_mla_split_f32_kernel(const float* __restrict__ q, const float* __restrict__ pool,
                           const int32_t* __restrict__ table,
                           const int32_t* __restrict__ kv_len, float* __restrict__ out,
                           float* __restrict__ ws, int B, int bt, int mbs, int64_t n_blocks,
                           int n_split, float scale_log2) {
  __shared__ int64_t row_s[kSpan];
  const int b = blockIdx.y, split = blockIdx.x;
  const int len = seq_len(kv_len, b, mbs * bt);
  const int start = split * kSpan;
  if (start >= len) return;
  const int nt = min(kSpan, len - start);
  const int n_act = (len + kSpan - 1) / kSpan;
  const int h = threadIdx.x >> 3, j = threadIdx.x & 7;
  split_rows(table, b, mbs, bt, start, nt, n_blocks, row_s);
  float qr[kQPer];
  const float* qh = q + (static_cast<int64_t>(b) * kHeads + h) * kWidth + j * kQPer;
#pragma unroll
  for (int i = 0; i < kQPer; ++i) qr[i] = qh[i] * scale_log2;
  float acc[kVPer];
#pragma unroll
  for (int i = 0; i < kVPer; ++i) acc[i] = 0.f;
  float m = kNegInf, l = 0.f;
  __syncthreads();
  for (int t = 0; t < nt; ++t) {
    const float* row = pool + row_s[t] * kWidth;
    float dot = 0.f;
#pragma unroll
    for (int i = 0; i < kQPer; i += 4) {
      const float4 r = *reinterpret_cast<const float4*>(row + j * kQPer + i);
      dot = fmaf(qr[i], r.x, dot);
      dot = fmaf(qr[i + 1], r.y, dot);
      dot = fmaf(qr[i + 2], r.z, dot);
      dot = fmaf(qr[i + 3], r.w, dot);
    }
    dot = group8_sum(dot);
    const float m_new = fmaxf(m, dot);
    const float alpha = exp2f(m - m_new), p = exp2f(dot - m_new);
    l = l * alpha + p;
    m = m_new;
#pragma unroll
    for (int i = 0; i < kVPer; i += 4) {
      const float4 v = *reinterpret_cast<const float4*>(row + j * kVPer + i);
      acc[i] = fmaf(p, v.x, acc[i] * alpha);
      acc[i + 1] = fmaf(p, v.y, acc[i + 1] * alpha);
      acc[i + 2] = fmaf(p, v.z, acc[i + 2] * alpha);
      acc[i + 3] = fmaf(p, v.w, acc[i + 3] * alpha);
    }
  }
  if (n_act == 1) {
    float* o = out + (static_cast<int64_t>(b) * kHeads + h) * kRank + j * kVPer;
    const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < kVPer; ++i) o[i] = acc[i] * inv;
    return;
  }
  const Workspace w(ws, B, n_split);
  const int64_t hs = (static_cast<int64_t>(b) * n_split + split) * kHeads + h;
#pragma unroll
  for (int i = 0; i < kVPer; ++i) w.acc[hs * kRank + j * kVPer + i] = acc[i];
  if (j == 0) {
    w.m[hs] = m;
    w.l[hs] = l;
  }
}

// ------------------------------------------------------------ the merge
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// One block per (head, sequence): zeros for kv_len 0, nothing for a
// sequence of one split (it wrote its output), else the splits' partials
// of the head merged, four value columns a thread.
template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_mla_merge_kernel(const int32_t* __restrict__ kv_len, T* __restrict__ out,
                       float* __restrict__ ws, int B, int cap, int n_split) {
  static_assert(kRank == 4 * kThreads, "four columns a thread");
  __shared__ float w_s[kMaxSplits];
  __shared__ float l_s;
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int n_act = (seq_len(kv_len, b, cap) + kSpan - 1) / kSpan;
  T* o = out + (static_cast<int64_t>(b) * kHeads + h) * kRank + 4 * tid;
  if (n_act == 1) return;
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
  if (n_act > 1) {
    const Workspace w(ws, B, n_split);
    const int64_t base = static_cast<int64_t>(b) * n_split * kHeads + h;  // + s * kHeads
    if (tid < 32) {
      float mx = kNegInf;
      for (int s = tid; s < n_act; s += 32) mx = fmaxf(mx, w.m[base + s * kHeads]);
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      float sum = 0.f;
      for (int s = tid; s < n_act; s += 32) {
        const float e = exp2f(w.m[base + s * kHeads] - mx);
        w_s[s] = e;
        sum += w.l[base + s * kHeads] * e;
      }
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (tid == 0) l_s = fmaxf(sum, 1e-30f);
    }
    __syncthreads();
    for (int s = 0; s < n_act; ++s) {
      const float4 v = *reinterpret_cast<const float4*>(w.acc + (base + s * kHeads) * kRank + 4 * tid);
      const float e = w_s[s];
      a.x = fmaf(v.x, e, a.x); a.y = fmaf(v.y, e, a.y);
      a.z = fmaf(v.z, e, a.z); a.w = fmaf(v.w, e, a.w);
    }
    a.x /= l_s; a.y /= l_s; a.z /= l_s; a.w /= l_s;
  }
  o[0] = from_f32<T>(a.x);
  o[1] = from_f32<T>(a.y);
  o[2] = from_f32<T>(a.z);
  o[3] = from_f32<T>(a.w);
}

}  // namespace

extern "C" {

// ws: f32 workspace of B * n_split * 16 * (512 + 2) elements, n_split =
// ceil(mbs * bt / 256). Returns a cudaError_t code: cudaErrorInvalidValue
// for a shape other than 16 heads x 576 / 512, a dtype other than bf16 or
// f32, a split count that does not cover the table or passes 256, a batch
// past 65535, or q, pool or out not 16-byte aligned.
int paged_mla_decode(const void* q, const void* pool, const void* table, const void* kv_len,
                     void* out, void* ws, int64_t B, int64_t H, int64_t W, int64_t R,
                     int64_t bt, int64_t mbs, int64_t n_blocks, int64_t n_split, int dtype,
                     float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0) return 0;
  const uintptr_t align = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(pool) |
                          reinterpret_cast<uintptr_t>(out);
  if (H != kHeads || W != kWidth || R != kRank || n_split * kSpan < mbs * bt ||
      n_split > kMaxSplits || B > 65535 || (align & 15) || mbs * bt > (int64_t{1} << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(n_split), static_cast<unsigned>(B));
  const float scale_log2 = scale * kLog2e;
  const int cap = static_cast<int>(mbs * bt);
  if (dtype == kBF16) {
    static bool sized = false;         // the shared-memory opt-in, once
    if (!sized) {
      const cudaError_t e = cudaFuncSetAttribute(
          paged_mla_split_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
      if (e != cudaSuccess) return static_cast<int>(e);
      sized = true;
    }
    paged_mla_split_kernel<<<grid, kThreads, kSmemBytes, s>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(pool),
        static_cast<const int32_t*>(table), static_cast<const int32_t*>(kv_len),
        static_cast<__nv_bfloat16*>(out), static_cast<float*>(ws), static_cast<int>(B),
        static_cast<int>(bt), static_cast<int>(mbs), n_blocks, static_cast<int>(n_split),
        scale_log2);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    paged_mla_merge_kernel<__nv_bfloat16><<<dim3(kHeads, static_cast<unsigned>(B)), kThreads, 0, s>>>(
        static_cast<const int32_t*>(kv_len), static_cast<__nv_bfloat16*>(out),
        static_cast<float*>(ws), static_cast<int>(B), cap, static_cast<int>(n_split));
    return static_cast<int>(cudaGetLastError());
  }
  if (dtype == kF32) {
    paged_mla_split_f32_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(pool),
        static_cast<const int32_t*>(table), static_cast<const int32_t*>(kv_len),
        static_cast<float*>(out), static_cast<float*>(ws), static_cast<int>(B),
        static_cast<int>(bt), static_cast<int>(mbs), n_blocks, static_cast<int>(n_split),
        scale_log2);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    paged_mla_merge_kernel<float><<<dim3(kHeads, static_cast<unsigned>(B)), kThreads, 0, s>>>(
        static_cast<const int32_t*>(kv_len), static_cast<float*>(out), static_cast<float*>(ws),
        static_cast<int>(B), cap, static_cast<int>(n_split));
    return static_cast<int>(cudaGetLastError());
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
