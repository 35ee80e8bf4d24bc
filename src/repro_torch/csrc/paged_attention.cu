// Paged decode attention for Hopper (sm_90a): one new query token per
// sequence attends to its KV cache, read through the block table.
//
// Replaces repro/kernels/paged_attention.py:paged_decode_attention
// (_paged_attn_kernel). Same function: GQA with KV-major head grouping
// (q[b].reshape(KV, g, hd)), q scaled by hd^-0.5 in f32, softmax in f32,
// positions at or past kv_len[b] left out, output
// acc / max(l, 1e-30) cast to q's dtype -- so kv_len == 0 gives zeros,
// as the Pallas kernel does.
//
// Plain extern "C" entry point, loaded with ctypes by
// repro_torch/kernels/_build.py; the wrapper (kernels/ops.py) checks
// shapes, dtypes, devices and contiguity and never synchronises.
//
// Layout: q (B, H, hd); pool (n_blocks, bt, 2, KV, hd); block_table
// (B, mbs) int32; kv_len (B,) int32; out (B, H, hd) in q's dtype.
//
// What bounds it on the H100: reading K and V once. At the main-path
// shape (B 8, KV 8, hd 128, kv_len 512, bf16) that is 16.8 MB, 5.0 us at
// 3.35 TB/s. The arithmetic, 4 flops per K/V element and query head, is
// ~1/40 of a byte's worth of the card's ~295 operations per byte, so the
// kernel is a streaming read, and what it has to get right is having
// enough bytes in flight and few dependent steps around them.
//
// Design (flash-decoding, one launch):
//   * Work items are (sequence, KV head, split of kChunk = 64 positions);
//     the g = H/KV query heads of a KV head share every K/V byte an item
//     loads. The wrapper knows no kv_len (it lives on the device and is
//     never synchronised), so the grid is persistent: as many blocks as
//     fit the card at once (132 SMs x the occupancy, capped by the most
//     items the table allows), and block i takes items i, i + grid, ...
//     Warp 0 finds an item from kv_len on the device (a prefix sum over
//     the sequences, 32 at a time), so no block is spent on splits past
//     kv_len.
//   * An item's pool rows come from the block table first (one lookup per
//     token); then every 16-byte piece of its K and V is issued at once
//     with cp.async.cg (16 B per lane, the pool's own dtype, L2 only) into
//     shared memory, one commit group per stage of 16 tokens (the ring's
//     stages). Up to 32 KB per block is in flight, and five blocks fit an
//     SM (kBlocksPerSM), so up to 660 items -- the serve's 512 to 576 --
//     are all loading at once.
//   * Stage by stage, as cp.async.wait_group says each has landed: scores,
//     sixteen lanes to a K row, each holding a 16-byte vector of it as f32
//     beside the same slice of q * scale, kept in registers, and five
//     shuffles (a transposed exchange) finishing the row's four dot
//     products; an online softmax of the stage, one warp per head; and
//     p.V, each thread rescaling and adding to 8-wide accumulators of 4
//     heads for its share of the stage's tokens. So the arithmetic of a
//     stage overlaps the loads of the later ones. FMAs in f32, not
//     mma.sync: q * scale and the probabilities stay in f32 (a bf16
//     tensor-core operand would round them), and at 4 flops per element
//     the FMAs cost fewer instructions per byte than padding g = 4 heads
//     to the 16 rows of an m16n8k16 tile. With g > 4 the stages are walked
//     again for each further 4 heads, from shared memory.
//   * Merge folded into the kernel: each split writes (m, l, acc) to the
//     f32 workspace, and one thread bumps its (sequence, KV head) counter
//     with an acq_rel atomic after a barrier (the pattern of a split-K
//     semaphore; a __threadfence per thread, MEMBAR.SC, and ld.cg's strong
//     loads in the merge were each far slower). The block that bumps it
//     last merges every split's partials with plain loads, its first
//     loads issued before the weights are made:
//     out = sum(acc_s e^(m_s - M)) / max(sum(l_s e^(m_s - M)), 1e-30),
//     and sets the counter back to 0, so back-to-back launches and CUDA
//     graph replays find it at 0. A sequence that fits one split writes
//     its output directly; blocks write the zeros of kv_len 0 at the end.
//   The counters are a static array of this library (kMaxPairs entries
//   per device, zero when the module loads): two launches must not run
//   at once on two streams, which no caller of the port does (decode is
//   one stream).
//
// What still holds it back at kv_len 512 (a few times the byte bound): the
// dependent steps outside the streaming, none of which the load overlaps
// -- the kernel's launch and drain, finding the item and its pool rows
// (two global round trips before the first K/V load), and after the last
// stage the token groups' reduction, the release/acquire of the counter
// and the merging block's reads of the other splits' partials. The next
// step is merging through distributed shared memory in a thread block
// cluster (the splits of a pair in one cluster), which takes the
// workspace round trip and the counter off that tail.
//
// Tokens past kv_len are never read (the Pallas kernel reads whole blocks
// and masks scores to -1e30, whose probability is 0): same result, and
// no masked score ever reaches exp. A block-table entry the kernel reads
// (context blocks below ceil(kv_len/bt)) outside [0, n_blocks) traps:
// the launch fails loudly instead of reading wild memory.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 64;           // positions per split (one block)
static_assert(kChunk == 64, "the softmax gives each lane two positions");
constexpr int kTile = 16;            // tokens per K stage
constexpr int kStages = kChunk / kTile;
constexpr int kParts = 16;           // lanes that share a K row
static_assert(kParts == 16, "the score sum's transposed exchange");
constexpr int kRowsPerRound = kThreads / kParts;  // K rows scored at once
static_assert(kTile % kRowsPerRound == 0 && kTile <= 32,
              "a stage in whole rounds, a lane per token");
constexpr int kHeadsPerPass = 4;     // query heads per pass of the score / p.V loops
static_assert(kHeadsPerPass == 4 && kWarps == kHeadsPerPass,
              "the score sum's transposed exchange; a warp per head in the softmax");
// Blocks an SM holds: the register cap (96 a thread) that lets five fit.
// With four (128 registers) an item runs faster, but 528 blocks hold the
// card, and the serve's decode past kv_len 528 (576 items at batch 8)
// takes two rounds; five hold 660 items.
constexpr int kBlocksPerSM = 5;
constexpr int kMaxPairs = 1 << 16;   // (sequence, KV head) counters
constexpr float kNegInf = -1e30f;
constexpr int kMaxSharedBytes = 232448;  // 227 KB: the opt-in maximum

// dtype codes shared with the wrapper
enum : int { kF32 = 0, kF16 = 1, kBF16 = 2 };

// arrivals per (sequence, KV head); the merging block resets its entry
__device__ unsigned int g_split_counters[kMaxPairs];

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

// One 16-byte vector of the pool's dtype, widened to f32.
__device__ __forceinline__ void widen(const float* p, float* f) {
  const float4 w = *reinterpret_cast<const float4*>(p);
  f[0] = w.x; f[1] = w.y; f[2] = w.z; f[3] = w.w;
}
__device__ __forceinline__ void widen(const __nv_bfloat16* p, float* f) {
  const uint4 w = *reinterpret_cast<const uint4*>(p);
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(u[i] << 16);
    f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void widen(const __half* p, float* f) {
  const uint4 w = *reinterpret_cast<const uint4*>(p);
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 h = __half22float2(*reinterpret_cast<const __half2*>(&u[i]));
    f[2 * i] = h.x;
    f[2 * i + 1] = h.y;
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most `pending` of this thread's commit groups are in flight.
__device__ __forceinline__ void cp_async_wait(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
  }
}
static_assert(kStages == 4, "cp_async_wait covers kStages groups");

// Release this block's earlier writes (ordered before by a barrier) and
// acquire the ones released before by the other splits, at GPU scope: the
// pattern of a split-K semaphore, without a sequentially consistent
// __threadfence per thread (a MEMBAR.SC.GPU, which measured ~13 us in the
// merging block at the serve shape).
__device__ __forceinline__ unsigned atomic_add_acq_rel(unsigned* p, unsigned v) {
  unsigned old;
  asm volatile("atom.add.acq_rel.gpu.global.u32 %0, [%1], %2;\n"
               : "=r"(old) : "l"(p), "r"(v) : "memory");
  return old;
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

// 16-byte vectors per K/V row, and the token groups of the p.V step
template <typename TP, int HD> struct Geometry {
  static constexpr int kEpv = 16 / static_cast<int>(sizeof(TP));  // elements per vector
  static constexpr int kVpr = HD / kEpv;                          // vectors per row
  static constexpr int kGroups = kThreads / kVpr;                 // p.V token groups
  static constexpr int kVecsPerPart = (kVpr + kParts - 1) / kParts;
  static_assert(kVpr >= 4 && kVpr <= kThreads, "head size");
  // the p.V partials, f32, and whether they fit where K was (they are
  // written once K is no longer read: after the last stage of the only
  // pass, when g <= kHeadsPerPass)
  static constexpr int64_t kRedBytes = 4LL * kGroups * kHeadsPerPass * HD;
  static constexpr bool kRedInK = kRedBytes <= 1LL * kChunk * HD * sizeof(TP);
};

// Shared memory: the split's pool rows (kChunk int64), K and V of the
// split (kChunk x HD each, the pool's dtype), then in floats q * scale
// (g x HD), the p.V partials of the token groups (kGroups x
// kHeadsPerPass x HD; in K's place when red_in_k), scores /
// probabilities (a stage's in a pass, the merge's weights: g x kChunk),
// m and l (max(g, kHeadsPerPass) each) and a stage's rescale
// (kHeadsPerPass). Every array that takes 16-byte accesses starts
// 16-byte aligned. At the serve shape that is ~36 KB: six blocks fit an
// SM's shared memory, five its registers (kBlocksPerSM).
template <typename TP, int HD>
__host__ __device__ constexpr bool red_in_k(int g) {
  return Geometry<TP, HD>::kRedInK && g <= kHeadsPerPass;
}
template <typename TP, int HD>
__host__ __device__ constexpr int64_t shared_bytes(int g) {
  return 8LL * kChunk + 2LL * kChunk * HD * sizeof(TP) +
         (red_in_k<TP, HD>(g) ? 0 : Geometry<TP, HD>::kRedBytes) +
         4LL * (static_cast<int64_t>(g) * HD + static_cast<int64_t>(g) * kChunk +
                2LL * (g > kHeadsPerPass ? g : kHeadsPerPass) + kHeadsPerPass);
}

// Item `item` of the launch -- items run over the sequences in order,
// each sequence's over its splits, each split's over the KV heads -- as
// ctl[0..3] = (b, kh, split, n_pos of b), or ctl[0] = -1 past the last.
// Warp 0 scans kv_len 32 sequences at a time; every sequence with n_pos
// positions has KV * ceil(n_pos / kChunk) items.
__device__ __forceinline__ void find_item(int item, const int32_t* __restrict__ kv_len,
                                          int B, int KV, int cap, int lane, int* ctl) {
  int before = 0;                      // items of the sequences already scanned
  for (int c0 = 0; c0 < B; c0 += 32) {
    const int bb = c0 + lane;
    int cnt = 0, n_pos = 0;
    if (bb < B) {
      n_pos = max(0, min(kv_len[bb], cap));
      cnt = KV * ((n_pos + kChunk - 1) / kChunk);
    }
    int incl = cnt;                    // inclusive prefix sum over the lanes
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += y;
    }
    const int rel = item - before;
    const unsigned hit = __ballot_sync(0xffffffffu, rel >= incl - cnt && rel < incl);
    if (hit) {
      if (lane == __ffs(hit) - 1) {
        const int local = rel - (incl - cnt);
        ctl[0] = bb;
        ctl[1] = local % KV;
        ctl[2] = local / KV;
        ctl[3] = n_pos;
      }
      return;
    }
    before += __shfl_sync(0xffffffffu, incl, 31);
  }
  if (lane == 0) ctl[0] = -1;
}

// Workspace of the splits, f32: m and l (B*H*n_split each), then acc
// (B*H*n_split x HD); query head hq = b*H + kh*g + h, split s at
// hq*n_split + s.
//
// Item `item` of the launch: one split of one (sequence b, KV head kh).
// Returns false, having done nothing, past the last item. ctl: the item
// (find_item) and, in ctl[4], the block's flag for "this split merges".
template <typename TQ, typename TP, int HD>
__device__ __forceinline__ bool attend_split(
    const TQ* __restrict__ q, const TP* __restrict__ pool,
    const int32_t* __restrict__ table, const int32_t* __restrict__ kv_len,
    TQ* __restrict__ out, float* ws, int B, int H, int KV, int bt, int mbs,
    int64_t n_blocks, int n_split, float scale, int item, int64_t* smem_raw,
    int* ctl) {
  using G = Geometry<TP, HD>;
  constexpr int EPV = G::kEpv, VPR = G::kVpr, NG = G::kGroups;
  const int g = H / KV;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  int64_t* row_s = smem_raw;                                  // [kChunk]
  TP* k_s = reinterpret_cast<TP*>(row_s + kChunk);            // [kChunk][HD]
  TP* v_s = k_s + kChunk * HD;                                // [kChunk][HD]
  float* q_s = reinterpret_cast<float*>(v_s + kChunk * HD);   // [g][HD]
  const bool red_k = red_in_k<TP, HD>(g);
  // [NG][kHeadsPerPass][HD]
  float* red_s = red_k ? reinterpret_cast<float*>(k_s) : q_s + g * HD;
  float* p_s = q_s + g * HD + (red_k ? 0 : NG * kHeadsPerPass * HD);  // [g][kChunk]
  const int gm = max(g, kHeadsPerPass);
  float* m_s = p_s + g * kChunk;       // [gm]: m of a pass's heads, then M
  float* l_s = m_s + gm;               // [gm]: l of a pass's heads, then L
  float* a_s = l_s + gm;               // [kHeadsPerPass]: a stage's rescale

  // 0. warp 0 finds the item; the split's pool rows (one block-table
  // lookup per token) and q * scale
  if (warp == 0) find_item(item, kv_len, B, KV, mbs * bt, lane, ctl);
  __syncthreads();
  const int b = ctl[0];
  if (b < 0) return false;
  const int kh = ctl[1], split = ctl[2], n_pos = ctl[3];
  const int pair = b * KV + kh;
  const int n_used = (n_pos + kChunk - 1) / kChunk;
  // the g query heads of this KV head are contiguous: rows kh*g .. kh*g+g-1
  const int64_t hq0 = static_cast<int64_t>(b) * H + static_cast<int64_t>(kh) * g;
  const int nt = min(kChunk, n_pos - split * kChunk);
  if (tid < nt) row_s[tid] = token_row(table, b, mbs, bt, split * kChunk + tid, n_blocks);
  for (int i = tid; i < g * HD; i += kThreads) q_s[i] = to_f32(q[hq0 * HD + i]) * scale;
  __syncthreads();

  // 1. every 16-byte piece of the split's K and V, in flight together: a
  // commit group per stage of kTile tokens
  const int64_t row_stride = 2LL * KV * HD;
  const TP* k_src = pool + static_cast<int64_t>(kh) * HD;
  const TP* v_src = pool + static_cast<int64_t>(KV + kh) * HD;
  for (int j = 0; j < kStages; ++j) {
    for (int c = tid; c < kTile * VPR; c += kThreads) {
      const int t = j * kTile + c / VPR, e = (c % VPR) * EPV;
      if (t < nt) {
        const int64_t r = row_s[t] * row_stride + e;
        cp_async16(k_s + t * HD + e, k_src + r);
        cp_async16(v_s + t * HD + e, v_src + r);
      }
    }
    cp_async_commit();
  }

  // 2. per pass of kHeadsPerPass query heads (one pass unless g > 4), stage
  // by stage as each lands (a later pass finds them all in shared memory):
  //   a. scores: kParts lanes per token, lane `part` holding vectors part,
  //      part + kParts, ... of its K row as f32 beside the same slice of
  //      q * scale, kept in registers for the pass;
  //   b. the online softmax of the stage's tokens, one warp per head;
  //   c. p.V: thread (token group tg, vector dv) rescales its 16-byte
  //      column of the heads' accumulators and adds tokens tg, tg + NG, ...
  //      of the stage.
  // Then the token groups meet in red_s, and the pass's heads go to the
  // output (a sequence of one split) or, unnormalised, to the workspace.
  const int64_t n_heads = static_cast<int64_t>(B) * H;
  float* ws_m = ws;
  float* ws_l = ws + n_heads * n_split;
  float* ws_acc = ws + 2 * n_heads * n_split;
  const int part = tid % kParts, dv = tid % VPR, tg = tid / VPR;
  for (int hc = 0; hc < g; hc += kHeadsPerPass) {
    float qr[kHeadsPerPass][G::kVecsPerPart][EPV];
#pragma unroll
    for (int hh = 0; hh < kHeadsPerPass; ++hh)
#pragma unroll
      for (int i = 0; i < G::kVecsPerPart; ++i) {
        const int vv = part + kParts * i;
        if (hc + hh < g && vv < VPR) {
#pragma unroll
          for (int e = 0; e < EPV; e += 4)
            widen(q_s + (hc + hh) * HD + vv * EPV + e, &qr[hh][i][e]);
        } else {
#pragma unroll
          for (int e = 0; e < EPV; ++e) qr[hh][i][e] = 0.f;
        }
      }
    if (tid < kHeadsPerPass) {
      m_s[tid] = kNegInf;
      l_s[tid] = 0.f;
    }
    float acc[kHeadsPerPass][EPV];
#pragma unroll
    for (int hh = 0; hh < kHeadsPerPass; ++hh)
#pragma unroll
      for (int e = 0; e < EPV; ++e) acc[hh][e] = 0.f;
    for (int j = 0; j < kStages && j * kTile < nt; ++j) {
      const int nt_j = min(kTile, nt - j * kTile);
      if (hc == 0) cp_async_wait(kStages - 1 - j);
      __syncthreads();
      // a. scores into p_s[hh][token of the stage]
#pragma unroll
      for (int r = 0; r < kTile / kRowsPerRound; ++r) {
        const int tt = r * kRowsPerRound + tid / kParts, t = j * kTile + tt;
        float kf[G::kVecsPerPart][EPV];
#pragma unroll
        for (int i = 0; i < G::kVecsPerPart; ++i) {
          const int vv = part + kParts * i;
          if (vv < VPR) {
            widen(k_s + t * HD + vv * EPV, kf[i]);
          } else {
#pragma unroll
            for (int e = 0; e < EPV; ++e) kf[i][e] = 0.f;
          }
        }
        float dot[kHeadsPerPass];
#pragma unroll
        for (int hh = 0; hh < kHeadsPerPass; ++hh) {
          dot[hh] = 0.f;
#pragma unroll
          for (int i = 0; i < G::kVecsPerPart; ++i)
#pragma unroll
            for (int e = 0; e < EPV; ++e) dot[hh] = fmaf(qr[hh][i][e], kf[i][e], dot[hh]);
        }
        // sum over the token's sixteen lanes, transposed: each exchange
        // sends half of what a lane holds, five shuffles in all, and lane
        // part ends with head 2 * (part >> 3) + ((part >> 2) & 1)
        const bool up8 = part & 8, up4 = part & 4;
        float e2[2];
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const float send = up8 ? dot[k] : dot[k + 2];
          e2[k] = (up8 ? dot[k + 2] : dot[k]) + __shfl_xor_sync(0xffffffffu, send, 8);
        }
        float sum = (up4 ? e2[1] : e2[0]) +
                    __shfl_xor_sync(0xffffffffu, up4 ? e2[0] : e2[1], 4);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        const int hh = 2 * up8 + up4;
        if (!(part & 3) && tt < nt_j && hc + hh < g) p_s[hh * kTile + tt] = sum;
      }
      __syncthreads();
      // b. online softmax: warp hh for head hc + hh, a lane per token
      if (hc + warp < g) {
        float* ph = p_s + warp * kTile;
        const float sc = lane < nt_j ? ph[lane] : kNegInf;
        const float m_old = m_s[warp];
        const float m_new = fmaxf(m_old, warp_max(sc));
        const float pr = lane < nt_j ? expf(sc - m_new) : 0.f;
        if (lane < nt_j) ph[lane] = pr;
        const float sum = warp_sum(pr);
        if (lane == 0) {
          const float alpha = expf(m_old - m_new);
          l_s[warp] = l_s[warp] * alpha + sum;
          m_s[warp] = m_new;
          a_s[warp] = alpha;
        }
      }
      __syncthreads();
      // c. p.V
#pragma unroll
      for (int hh = 0; hh < kHeadsPerPass; ++hh) {
        const float alpha = hc + hh < g ? a_s[hh] : 1.f;
#pragma unroll
        for (int e = 0; e < EPV; ++e) acc[hh][e] *= alpha;
      }
#pragma unroll
      for (int k = 0; k < (kTile + NG - 1) / NG; ++k) {
        const int tt = tg + k * NG;
        if (tt < nt_j) {
          float vf[EPV];
          widen(v_s + (j * kTile + tt) * HD + dv * EPV, vf);
#pragma unroll
          for (int hh = 0; hh < kHeadsPerPass; ++hh) {
            const float pr = p_s[hh * kTile + tt];
#pragma unroll
            for (int e = 0; e < EPV; ++e) acc[hh][e] = fmaf(pr, vf[e], acc[hh][e]);
          }
        }
      }
    }
#pragma unroll
    for (int hh = 0; hh < kHeadsPerPass; ++hh) {
      float* dst = red_s + (tg * kHeadsPerPass + hh) * HD + dv * EPV;
#pragma unroll
      for (int e = 0; e < EPV; e += 4)
        *reinterpret_cast<float4*>(dst + e) =
            make_float4(acc[hh][e], acc[hh][e + 1], acc[hh][e + 2], acc[hh][e + 3]);
    }
    __syncthreads();
    for (int i = tid; i < kHeadsPerPass * HD; i += kThreads) {
      const int hh = i / HD, d = i % HD, h = hc + hh;
      if (h >= g) continue;
      float a = 0.f;
#pragma unroll 8
      for (int k = 0; k < NG; ++k) a += red_s[(k * kHeadsPerPass + hh) * HD + d];
      if (n_used == 1)
        out[(hq0 + h) * HD + d] = from_f32<TQ>(a / fmaxf(l_s[hh], 1e-30f));
      else
        ws_acc[((hq0 + h) * n_split + split) * HD + d] = a;
    }
    if (n_used > 1 && tid < kHeadsPerPass && hc + tid < g) {
      ws_m[(hq0 + hc + tid) * n_split + split] = m_s[tid];
      ws_l[(hq0 + hc + tid) * n_split + split] = l_s[tid];
    }
    __syncthreads();
  }
  if (n_used == 1) return true;

  // 3. the last split of the pair to arrive merges
  __syncthreads();
  if (tid == 0)
    ctl[4] = atomic_add_acq_rel(&g_split_counters[pair], 1u) ==
             static_cast<unsigned>(n_used - 1);
  __syncthreads();
  if (!ctl[4]) return true;
  // The merge, with plain loads: the acquire above and the barrier after
  // it order them after the other splits' writes (ld.cg's strong loads
  // took ~12 us here). kOut outputs per thread at a time; per chunk of up
  // to kChunk splits, the weights e^(m_s - M) go to p_s, and each
  // thread's loads of kBatch splits' acc are issued together, the first
  // batch before the weights are made. The first chunk's weights come
  // with M = max m_s and L = sum l_s e^(m_s - M) per head (one warp per
  // head, lanes over the splits; m_s and l_s take them).
  constexpr int kOut = 4, kBatch = 8;
  for (int i0 = 0; i0 < g * HD; i0 += kOut * kThreads) {
    const float* accp[kOut];           // split 0 of each output in ws_acc
    int hh[kOut];                      // its head within the group
    float a[kOut];
#pragma unroll
    for (int o = 0; o < kOut; ++o) {
      const int i = min(i0 + o * kThreads + tid, g * HD - 1);
      hh[o] = i / HD;
      accp[o] = ws_acc + (hq0 + hh[o]) * n_split * HD + i % HD;
      a[o] = 0.f;
    }
    for (int c0 = 0; c0 < n_used; c0 += kChunk) {
      const int nc = min(kChunk, n_used - c0);
      float v[kBatch][kOut];
      auto load_batch = [&](int s0) {
#pragma unroll
        for (int u = 0; u < kBatch; ++u)
#pragma unroll
          for (int o = 0; o < kOut; ++o)
            v[u][o] = s0 + u < nc ? accp[o][static_cast<int64_t>(c0 + s0 + u) * HD] : 0.f;
      };
      load_batch(0);                   // in flight while the weights are made
      if (i0 == 0 && c0 == 0) {
        for (int h = warp; h < g; h += kWarps) {
          const int64_t row = (hq0 + h) * n_split;
          float mx = kNegInf, sum = 0.f;
          for (int s = lane; s < n_used; s += 32) {
            const float ms = ws_m[row + s], nm = fmaxf(mx, ms);
            sum = sum * expf(mx - nm) + ws_l[row + s] * expf(ms - nm);
            mx = nm;
          }
          const float big = warp_max(mx);
          sum = warp_sum(sum * expf(mx - big));
          for (int s = lane; s < nc; s += 32) p_s[h * kChunk + s] = expf(ws_m[row + s] - big);
          if (lane == 0) {
            m_s[h] = big;
            l_s[h] = sum;
          }
        }
      } else {
        for (int i = tid; i < g * nc; i += kThreads) {
          const int h = i / nc, sc = i % nc;
          p_s[h * kChunk + sc] = expf(ws_m[(hq0 + h) * n_split + c0 + sc] - m_s[h]);
        }
      }
      __syncthreads();
      for (int s0 = 0; s0 < nc; s0 += kBatch) {
        if (s0) load_batch(s0);
#pragma unroll
        for (int u = 0; u < kBatch; ++u)
#pragma unroll
          for (int o = 0; o < kOut; ++o)
            if (s0 + u < nc) a[o] = fmaf(v[u][o], p_s[hh[o] * kChunk + s0 + u], a[o]);
      }
      __syncthreads();                 // p_s is rewritten by the next chunk
    }
#pragma unroll
    for (int o = 0; o < kOut; ++o) {
      const int i = i0 + o * kThreads + tid;
      if (i < g * HD) out[hq0 * HD + i] = from_f32<TQ>(a[o] / fmaxf(l_s[hh[o]], 1e-30f));
    }
  }
  if (tid == 0) g_split_counters[pair] = 0;
  return true;
}

// Persistent grid: block i takes items i, i + gridDim.x, ... until they
// run out, then writes zeros for its share of the sequences with no
// position.
template <typename TQ, typename TP, int HD>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
paged_attn_kernel(const TQ* __restrict__ q, const TP* __restrict__ pool,
                  const int32_t* __restrict__ table,
                  const int32_t* __restrict__ kv_len, TQ* __restrict__ out,
                  float* ws, int B, int H, int KV, int bt, int mbs,
                  int64_t n_blocks, int n_split, float scale) {
  extern __shared__ __align__(16) int64_t smem_raw[];
  __shared__ int ctl_s[5];             // the item's b, kh, split, n_pos; "merges"
  for (int item = blockIdx.x;
       attend_split<TQ, TP, HD>(q, pool, table, kv_len, out, ws, B, H, KV, bt, mbs,
                                n_blocks, n_split, scale, item, smem_raw, ctl_s);
       item += gridDim.x)
    __syncthreads();                   // shared memory and ctl_s are reused
  for (int b = blockIdx.x; b < B; b += gridDim.x)
    if (kv_len[b] <= 0)
      for (int i = threadIdx.x; i < H * HD; i += kThreads)
        out[static_cast<int64_t>(b) * H * HD + i] = from_f32<TQ>(0.f);
}

template <typename TQ, typename TP, int HD>
int launch(const void* q, const void* pool, const void* table,
           const void* kv_len, void* out, void* ws, int64_t B, int64_t H,
           int64_t KV, int64_t bt, int64_t mbs, int64_t n_blocks,
           int64_t n_split, float scale, cudaStream_t stream) {
  const int64_t smem = shared_bytes<TP, HD>(static_cast<int>(H / KV));
  const int64_t items = B * KV * n_split;          // the most kv_len can ask for
  if (smem > kMaxSharedBytes || n_split * kChunk < mbs * bt || B * KV > kMaxPairs ||
      items > (int64_t{1} << 30) || (reinterpret_cast<uintptr_t>(pool) & 15))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = paged_attn_kernel<TQ, TP, HD>;
  // blocks per SM at this shared-memory size, asked once per size
  static int64_t occ_smem = -1;
  static int occ = 0;
  if (smem != occ_smem) {
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &occ, kernel, kThreads, static_cast<size_t>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    occ_smem = smem;
  }
  int dev = 0, n_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int64_t resident = static_cast<int64_t>(n_sm) * (occ > 0 ? occ : 1);
  const unsigned grid = static_cast<unsigned>(items < resident ? items : resident);
  kernel<<<grid, kThreads, static_cast<size_t>(smem), stream>>>(
      static_cast<const TQ*>(q), static_cast<const TP*>(pool),
      static_cast<const int32_t*>(table), static_cast<const int32_t*>(kv_len),
      static_cast<TQ*>(out), static_cast<float*>(ws), static_cast<int>(B),
      static_cast<int>(H), static_cast<int>(KV), static_cast<int>(bt),
      static_cast<int>(mbs), n_blocks, static_cast<int>(n_split), scale);
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
// take, a g x hd that needs more shared memory than a block has, a split
// count that does not cover the table or exceeds 65535, more than
// kMaxPairs (sequence, KV head) pairs, or a pool not 16-byte aligned.
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
