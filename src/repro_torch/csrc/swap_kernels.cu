// Swap data-path kernels for Hopper (sm_90a): the swap-out's indexed
// pass (gather, zero scan, and both at once with compaction), the
// swap-in's verified scatter (the staged rows' Fletcher tags checked and
// the frame written in one launch) and the per-row Fletcher integrity
// tags.
//
// Plain extern "C" entry points, loaded with ctypes by
// repro_torch/kernels/_build.py; each launches on the stream it is given
// and returns the launch's error (cudaLaunchKernelEx, then
// cudaGetLastError()), so a refused launch surfaces in the Python wrapper
// (repro_torch/kernels/ops.py), which also checks device, dtype, shape,
// contiguity and index bounds before it gets here.
//
// Layout: every operand is a row-major (rows, elems) uint8 matrix.
//
// Bound on the card: at the main-path shapes (64 rows of one 4 KiB MP out
// of a (512, 4096) MS frame) every kernel here is bounded by bytes moved,
// and at these sizes the launch itself (~1.5 us replayed from a CUDA
// graph) dominates: a 64-row chunk is 256 KiB, ~0.08 us at 3.35 TB/s.
// So the swap-out reads each chunk from the frame once, in one launch
// that flags the zero rows and hands back only the non-zero ones, and
// the swap-in writes each chunk in one launch that checks its tags.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__host__ __device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// ------------------------------------------------- the indexed pass
// Replaces repro/kernels/swap_copy.py:gather_blocks (_gather_kernel) and
// repro/kernels/zero_detect.py:zero_detect (_zero_detect_kernel), and on
// the swap-out does the work of gather + zero scan + second gather of
// the non-zero rows in one launch. One body, three modes:
//   kFull     out[i] = pool[idx[i]]                  (gather_blocks)
//   kFlags    zero[i] = pool[idx[i]] is all zero     (zero_detect; idx
//             is the identity)
//   kCompact  both flags and the non-zero rows, compacted in ascending
//             row order, plus their count
//
// Indices come by value, in the launch's parameters (up to kMaxIdx int32,
// 2 KiB): no upload from pageable host memory before the launch and no
// dependent index load in the kernel; a CUDA graph keeps the values it
// captured. The host entry point splits longer vectors into launches.
//
// A launch's rows are read as one flat range of words (16-byte uint4
// when every row is 16-byte aligned, else bytes) split evenly over the
// blocks. kFull copies each word as it comes. The scanning modes run as
// one thread block cluster of up to kMaxCluster blocks:
//   phase 1  each block ORs its words into per-row marks in its shared
//            memory (a row may span blocks), then stores them as bit
//            words into every peer's shared memory with st.async, which
//            counts the bytes on the peer's mbarrier: a block waits for
//            its peers' words, not at a cluster barrier, and no block
//            waits on a remote load;
//            each block ORs the words into a bit mask of the launch's
//            rows, and a warp prefix-sums the mask's words: a row's output
//            slot is the count of non-zero rows before it -- no atomics,
//            no second launch, and the same order every time;
//   phase 2  each block writes its non-zero rows' words to their slots
//            and its rows' flags; block 0 writes the count.
// A block's share of up to kRegVecs words a thread (16 KiB: four 4 KiB
// rows over 256 threads, sixteen blocks at the 64-row chunk) stays in
// registers between the phases, four 16-byte loads in flight a thread; a
// larger share (a whole MS, 1.125 MiB KV rows) is read in tiles of that
// size, and again in phase 2, from L2, for the non-zero rows only.
// At the 64-row chunk on the H100 a cluster barrier in place of the
// st.async exchange, and eight blocks of eight words a thread in place of
// sixteen of four, were both slower.
constexpr int kMaxIdx = 512;      // a whole 512-MP MS
constexpr int kMaxCluster = 16;   // the largest (non-portable) cluster
constexpr int kRegVecs = 4;       // words a thread keeps between phases
constexpr int kFullVecs = 1;      // words a thread copies in kFull

enum PassMode : int { kFull = 0, kFlags = 1, kCompact = 2 };

struct PassArgs {
  const uint8_t* pool;
  uint8_t* out;          // rows (kFull, kCompact)
  uint8_t* zero;         // flags, 1 where the row is zero (kFlags, kCompact)
  int32_t* count;        // non-zero rows written so far (kCompact)
  int64_t elems;         // bytes per row, < 2^31
  int64_t per;           // words per block
  int64_t total;         // words of this launch: n * words per row
  int32_t n;             // rows of this launch, <= kMaxIdx
  int32_t accumulate;    // kCompact: append after *count (a later launch)
  int32_t idx[kMaxIdx];  // pool row of each row
};

__device__ __forceinline__ bool nonzero(const uint4& v) {
  return (v.x | v.y | v.z | v.w) != 0;
}
__device__ __forceinline__ bool nonzero(uint8_t v) { return v != 0; }

// a / b for a >= 0, b > 0: a 32-bit division where both fit (a 64-bit
// one is a long software routine)
__host__ __device__ __forceinline__ int64_t div_nonneg(int64_t a, int64_t b) {
  return (a | b) < (int64_t{1} << 32)
             ? static_cast<int64_t>(static_cast<uint32_t>(a) / static_cast<uint32_t>(b))
             : a / b;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// st.async of one word into peer ``rank``'s shared memory at the address
// ``local`` has here, completing bytes on the peer's mbarrier ``bar``
__device__ __forceinline__ void store_to_peer(const uint32_t* local, uint32_t value,
                                              const uint64_t* bar, uint32_t rank) {
  uint32_t dst, dst_bar;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(dst) : "r"(smem_addr(local)), "r"(rank));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(dst_bar) : "r"(smem_addr(bar)), "r"(rank));
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.u32 [%0], %1, [%2];"
               :: "r"(dst), "r"(value), "r"(dst_bar) : "memory");
}

template <int kMode, typename W>
__global__ void __launch_bounds__(kThreads, 1)
gather_pass_kernel(const __grid_constant__ PassArgs a) {
  constexpr bool kScan = kMode != kFull;
  constexpr int kVecs = kMode == kFull ? kFullVecs : kRegVecs;
  constexpr int kWords = kMaxIdx / 32;
  __shared__ uint8_t seen[kMaxIdx];                  // this block's marks
  __shared__ uint32_t marks[kMaxCluster][kWords];    // [b]: block b's, as bits
  __shared__ uint32_t mask[kWords];                  // bit r: row r non-zero
  __shared__ uint32_t before[kWords + 1];            // non-zero rows in earlier words
  __shared__ int32_t base;                           // rows of earlier launches
  __shared__ alignas(8) uint64_t got;                // mbarrier: the peers' words

  const int t = threadIdx.x;
  const int64_t nw = a.elems / static_cast<int64_t>(sizeof(W));
  const int64_t lo = min(static_cast<int64_t>(blockIdx.x) * a.per, a.total);
  const int64_t hi = min(lo + a.per, a.total);
  const bool resident = a.per <= kVecs * kThreads;  // one tile a block
  auto src = [&](int64_t r) {
    return reinterpret_cast<const W*>(a.pool + static_cast<int64_t>(a.idx[r]) * a.elems);
  };
  // the rows [row_lo, row_hi) this block's words touch (rows of no bytes:
  // all of them, block 0)
  const int32_t row_lo = hi > lo ? static_cast<int32_t>(div_nonneg(lo, nw)) : 0;
  const int32_t row_hi = hi > lo                            ? static_cast<int32_t>(div_nonneg(hi - 1, nw)) + 1
                         : a.total == 0 && blockIdx.x == 0 ? a.n
                                                           : 0;

  const int n_words = (a.n + 31) >> 5;                // <= 16
  if constexpr (kScan) {
    // the mbarrier that counts the bytes of the peers' mark words, set up
    // and published to the cluster before any peer may store to it; the
    // block's first barrier is after its loads are in flight
    if (t == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(smem_addr(&got)));
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                   :: "r"(smem_addr(&got)), "r"(gridDim.x * n_words * 4u) : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      base = (kMode == kCompact && a.accumulate) ? *a.count : 0;
    }
    asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
    for (int r = row_lo + t; r < row_hi; r += kThreads) seen[r] = 0;
  }

  // the block's range in tiles of kVecs words a thread: this thread's
  // words of a tile are f0 + j * kThreads, n_in of them, whose (row, word)
  // is stepped from one division, not divided per word
  constexpr int64_t kTile = kVecs * kThreads;
  const int32_t nw32 = static_cast<int32_t>(nw);
  const int32_t q = nw32 ? kThreads / nw32 : 0, rm = kThreads - q * nw32;
  auto step = [&](int32_t& r, int32_t& w) {
    r += q;
    w += rm;
    if (w >= nw32) {
      w -= nw32;
      ++r;
    }
  };
  W v[kVecs];
  int32_t r0 = 0, w0 = 0, n_in = 0;
  auto load_tile = [&](int64_t tile, auto&& wanted) {
    const int64_t f0 = tile + t;
    n_in = 0;
    if (f0 < hi) {
      r0 = static_cast<int32_t>(div_nonneg(f0, nw));
      w0 = static_cast<int32_t>(f0 - r0 * nw);
      n_in = static_cast<int32_t>(min(static_cast<int64_t>(kVecs), (hi - f0 + kThreads - 1) / kThreads));
    }
    int32_t r = r0, w = w0;
#pragma unroll
    for (int j = 0; j < kVecs; ++j) {
      if (j < n_in && wanted(r)) v[j] = src(r)[w];
      step(r, w);
    }
  };

  // phase 1: read the range; a share of one tile stays in v for phase 2
  for (int64_t tile = lo; tile < hi; tile += kTile) {
    load_tile(tile, [](int32_t) { return true; });
    if constexpr (kScan) {
      if (tile == lo) __syncthreads();       // the marks are zeroed
      int32_t r = r0, w = w0;
#pragma unroll
      for (int j = 0; j < kVecs; ++j) {
        if (j < n_in && nonzero(v[j])) seen[r] = 1;
        step(r, w);
      }
    }
  }

  if constexpr (kScan) {
    // each block stores its marks as bit words into every peer's shared
    // memory (zero outside its rows) with st.async, which counts their
    // bytes on the peer's mbarrier: a block waits for its peers' words,
    // not at a barrier, and a row's mask word is the OR of the words
    const int n_blocks = static_cast<int>(gridDim.x), me = static_cast<int>(blockIdx.x);
    const int lane = t & 31, warp = t >> 5;
    __syncthreads();
    asm volatile("barrier.cluster.wait.aligned;" ::: "memory");   // peers' mbarriers are set up
    for (int w = warp; w < n_words; w += kThreads / 32) {
      const int r = w * 32 + lane;
      const uint32_t bits = __ballot_sync(0xffffffffu, r >= row_lo && r < row_hi && seen[r]);
      if (lane < n_blocks) store_to_peer(&marks[me][w], bits, &got, lane);
    }
    uint32_t done = 0;
    for (uint32_t spin = 0; !done; ++spin) {
      asm volatile("{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
                   " selp.u32 %0, 1, 0, p;\n}" : "=r"(done) : "r"(smem_addr(&got)) : "memory");
      if (spin > (1u << 24)) __trap();       // a lost word: fail, do not hang
    }
    if (warp == 0) {
      uint32_t m = 0;
#pragma unroll
      for (int b = 0; b < kMaxCluster; ++b)
        if (lane < n_words && b < n_blocks) m |= marks[b][lane];
      const uint32_t p = __popc(m);
      uint32_t incl = p;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const uint32_t up = __shfl_up_sync(0xffffffffu, incl, d);
        if (lane >= d) incl += up;
      }
      if (lane < n_words) mask[lane] = m;
      if (lane <= n_words) before[lane] = incl - p;     // [n_words]: the total
      if (kMode == kCompact && me == 0 && lane == n_words) *a.count = base + incl;
    }
    __syncthreads();
    // each block the flags of its rows (a row two blocks span, twice)
    for (int r = row_lo + t; r < row_hi; r += kThreads)
      a.zero[r] = ((mask[r >> 5] >> (r & 31)) & 1) ? 0 : 1;
  }

  // phase 2: the output row of row r, or -1 where r is not written
  auto dst = [&](int64_t r) -> int64_t {
    if constexpr (kMode == kFull) {
      return r;
    } else {
      const uint32_t m = mask[r >> 5], bit = 1u << (r & 31);
      if (!(m & bit)) return -1;
      return static_cast<int64_t>(base) + before[r >> 5] + __popc(m & (bit - 1));
    }
  };
  if constexpr (kMode != kFlags) {
    W* out = reinterpret_cast<W*>(a.out);
    auto kept = [&](int32_t r) { return dst(r) >= 0; };
    auto store_tile = [&] {
      int32_t r = r0, w = w0;
#pragma unroll
      for (int j = 0; j < kVecs; ++j) {
        if (j < n_in) {
          const int64_t d = dst(r);
          if (d >= 0) out[d * nw + w] = v[j];
        }
        step(r, w);
      }
    };
    if (resident) {
      store_tile();
    } else {             // read the range again from L2, the kept rows only
      for (int64_t tile = lo; tile < hi; tile += kTile) {
        load_tile(tile, kept);
        store_tile();
      }
    }
  }
}

// One launch of up to kMaxIdx rows: blocks of kVecs words a thread where
// that fits, as one cluster for the scanning modes (at most kMaxCluster
// blocks; beyond, each block reads its share in tiles, twice). A cluster
// past the portable 8 blocks needs the kernel's permission, which is set
// on the current device before each such launch.
template <int kMode, typename W>
cudaError_t launch_pass(PassArgs& a, cudaStream_t stream) {
  constexpr int64_t kVecs = kMode == kFull ? kFullVecs : kRegVecs;
  a.total = a.n * (a.elems / static_cast<int64_t>(sizeof(W)));
  int64_t blocks = (a.total + kVecs * kThreads - 1) / (kVecs * kThreads);
  if (blocks < 1) blocks = 1;
  if (kMode != kFull && blocks > kMaxCluster) blocks = kMaxCluster;
  a.per = (a.total + blocks - 1) / blocks;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(blocks);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  if (kMode != kFull) {
    const cudaError_t err = cudaFuncSetAttribute(
        gather_pass_kernel<kMode, W>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  const cudaError_t err = cudaLaunchKernelEx(&cfg, gather_pass_kernel<kMode, W>, a);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <int kMode>
cudaError_t launch_pass_words(PassArgs& a, bool vec, cudaStream_t stream) {
  return vec ? launch_pass<kMode, uint4>(a, stream) : launch_pass<kMode, uint8_t>(a, stream);
}

// Replaces repro/kernels/crc32c.py:fletcher_checksum (_fletcher_kernel).
// Per row: (sum x mod p) | (sum ((i+1) mod p) * x mod p) << 16.
//
// What bounds it on the H100: at the main-path shape (64 rows of 4 KiB)
// the 256 KiB read takes 0.08 us at 3.35 TB/s, so the launch (~1.5 us
// replayed from a CUDA graph) and one row's chain of dependent steps are
// the whole time: so 16-byte loads, 32-bit integer sums and no 64-bit
// division (a software routine on the card).
//
// Design. A row is a head of bytes up to its first 16-byte boundary, a
// body of 16-byte vectors (uint4 loads) and a byte tail. As (i+1) mod p
// is i+1 mod p, a vector at byte offset o of the row adds
//   s1v = sum_j x_j,   s2v = o * s1v + Lv,   Lv = sum_j (j+1) x_j,
// and both sums are __dp4a over its four words, with 0x01010101 and with
// the packed local weights 1..16. All of it is uint32: o is stepped mod p
// (never divided), o * s1v + Lv < 65521 * 4080 + 34680 < 2^28, and each
// lane folds its two sums mod p once per four vectors (p is a constant,
// so a fold is a multiply-high), so no partial overflows whatever the
// row length. A warp takes 2 KiB per pass, each lane's four 16-byte
// loads in flight together, and a row gets a warp per 2 KiB, up to eight:
// a 4 KiB row is one block of two warps, so 64 rows keep 64 SMs busy with
// short chains; two warp reductions (redux.sync) and one barrier end it.
// Integer sums are exact in any order, so the tag equals the reference's
// bit for bit for every row length and alignment, rows past 65521 bytes
// (the weight wraps) included. Rows of 2^31 bytes or more are refused
// (32-bit offsets).
constexpr uint32_t kFletcherP = 65521;  // largest prime < 2^16
constexpr int kFletcherUnroll = 4;      // 16-byte loads in flight per lane
constexpr int64_t kFletcherWarpBytes = 32 * 16 * kFletcherUnroll;

// Head or tail bytes [lo, hi) of a row, one per thread, into s1 and s2
// (both kept below p).
__device__ __forceinline__ void fletcher_bytes(const uint8_t* __restrict__ row,
                                               uint32_t lo, uint32_t hi,
                                               uint32_t& s1, uint32_t& s2) {
  for (uint32_t i = lo + threadIdx.x; i < hi; i += blockDim.x) {
    const uint32_t v = row[i];
    s1 = (s1 + v) % kFletcherP;
    s2 = (s2 + ((i + 1) % kFletcherP) * v) % kFletcherP;  // < 2^25
  }
}

__global__ void fletcher_rows_kernel(const uint8_t* __restrict__ x,
                                     uint32_t elems,
                                     uint32_t* __restrict__ out) {
  const uint8_t* row = x + static_cast<int64_t>(blockIdx.x) * elems;
  const uint32_t nthr = blockDim.x;
  const uint32_t head = min(
      elems, static_cast<uint32_t>((16 - (reinterpret_cast<uintptr_t>(row) & 15)) & 15));
  const uint32_t nvec = (elems - head) >> 4;
  uint32_t s1 = 0, s2 = 0;
  fletcher_bytes(row, 0, head, s1, s2);
  fletcher_bytes(row, head + (nvec << 4), elems, s1, s2);
  const uint4* body = reinterpret_cast<const uint4*>(row + head);
  // o mod p of this lane's next vector, stepped by 16 * nthr (< p)
  const uint32_t step = 16 * nthr;
  uint32_t base = (head + 16 * threadIdx.x) % kFletcherP;
  for (uint32_t v0 = threadIdx.x; v0 < nvec; v0 += kFletcherUnroll * nthr) {
    uint4 w[kFletcherUnroll];
#pragma unroll
    for (int u = 0; u < kFletcherUnroll; ++u) {
      const uint32_t v = v0 + u * nthr;
      w[u] = v < nvec ? body[v] : make_uint4(0, 0, 0, 0);
    }
    // the kFletcherUnroll vectors' terms, then one fold: t1 <= 8 * 4080
    // and t2 < 8 * 2^28, so s + t stays below 2^32
    static_assert(kFletcherUnroll <= 8, "the fold's bound");
    uint32_t t1 = 0, t2 = 0;
#pragma unroll
    for (int u = 0; u < kFletcherUnroll; ++u) {
      const uint32_t s1v =
          __dp4a(w[u].x, 0x01010101u, __dp4a(w[u].y, 0x01010101u,
          __dp4a(w[u].z, 0x01010101u, __dp4a(w[u].w, 0x01010101u, 0u))));
      const uint32_t lv =
          __dp4a(w[u].x, 0x04030201u, __dp4a(w[u].y, 0x08070605u,
          __dp4a(w[u].z, 0x0C0B0A09u, __dp4a(w[u].w, 0x100F0E0Du, 0u))));
      t1 += s1v;
      t2 += base * s1v + lv;
      base += step;
      if (base >= kFletcherP) base -= kFletcherP;
    }
    s1 = (s1 + t1) % kFletcherP;
    s2 = (s2 + t2) % kFletcherP;
  }
  // 32 partials below p sum below 2^21: one redux.sync each
  s1 = __reduce_add_sync(0xffffffffu, s1);
  s2 = __reduce_add_sync(0xffffffffu, s2);
  if (nthr > 32) {                     // the same branch for the whole block
    __shared__ uint32_t part1[kThreads / 32], part2[kThreads / 32];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (lane == 0) {
      part1[warp] = s1 % kFletcherP;
      part2[warp] = s2 % kFletcherP;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      s1 = s2 = 0;
      for (uint32_t k = 0; k < nthr / 32; ++k) {
        s1 += part1[k];
        s2 += part2[k];
      }
    }
  }
  if (threadIdx.x == 0)
    out[blockIdx.x] = (s1 % kFletcherP) | ((s2 % kFletcherP) << 16);
}

// Threads per row: one warp per 2 KiB pass, from one warp to kThreads.
int fletcher_threads(int64_t elems) {
  const int64_t warps = (elems + kFletcherWarpBytes - 1) / kFletcherWarpBytes;
  return 32 * static_cast<int>(warps < 1 ? 1 : warps > kThreads / 32 ? kThreads / 32 : warps);
}

// ------------------------------------------------ the verified scatter
// Replaces repro/kernels/swap_copy.py:scatter_blocks (_scatter_kernel)
// and, on the swap-in, repro/kernels/crc32c.py:fletcher_checksum
// (_fletcher_kernel) as the check of the staged extent rows. A call takes
// a chunk's rows staged on the card -- each with a frame row to write or
// none (verify only), and an expected Fletcher tag or none -- and a list
// of frame rows to zero. It writes the frame only if every expected tag
// matches, then zeroes the listed rows, and sets a 4-byte verdict:
// kVerdictOk, or the first staged row whose tag differs. Without tags and
// zero rows it is the plain scatter pool[dst[i]] = stage[i]: rows not
// named are never touched (the TPU kernel's input/output aliasing), and
// duplicate destinations give an undefined result, as in the reference.
//
// Bound on the card: bytes. At (512, 4096) u8 with 64 staged rows 256 KiB
// are read and 256 KiB written, 0.157 us at 3.35 TB/s, well under a
// launch's fixed cost (~1.5 us replayed from a CUDA graph); so the design
// is about the fixed costs:
//   * destinations, tags and zero rows come by value in the launch's
//     parameters (ScatterArgs, 1.6 KiB): no index upload before the
//     launch and no dependent index load before the first store;
//   * check and write are one launch: one thread block cluster of up to
//     kMaxCluster blocks. Each block reads its share of the staged words
//     once, keeps one tile of kRegVecs 16-byte words a thread in
//     registers, and sums each row's Fletcher terms (the __dp4a
//     arithmetic of fletcher_rows_kernel, exact in integers whatever the
//     row length); it stores its per-row sums into every peer's shared
//     memory with st.async, counted on the peer's mbarrier (as the
//     indexed pass trades its marks), so every block has every row's tag
//     once its own bytes have come, and writes its share only if none
//     differs. The rows are read from HBM once. A share larger than one
//     tile (a whole MS, 1.125 MiB KV rows) is read again, from L2, for
//     the write rather than staged in shared memory: the register tile
//     is the layout the indexed pass above measured fastest, and a
//     second read of a share that just went through L2 costs less than
//     a second launch;
//   * the zero rows are filled by the same launch, after the verdict.
// On the H100 at that chunk, adding the partials into the peers' sums
// (red.shared::cluster) between two cluster barriers, and all warps of a
// block adding into one shared sum per row (64-bit atomics that contend),
// were each slower than the per-warp sums and the st.async exchange here.
// A call with more rows than one launch takes runs verify-only launches
// over the tagged rows, which lower the verdict with atomicMin, then
// write launches that read the verdict first and write nothing unless it
// is ok: all or nothing still, and no host wait in between.
constexpr int kMaxRows = 128;       // staged rows a launch takes
constexpr int kMaxZero = 128;       // zero rows a launch takes
constexpr uint32_t kVerdictOk = 0xffffffffu;

struct ScatterArgs {
  const uint8_t* stage;       // (n, elems) staged rows
  uint8_t* pool;              // frame rows, written in place
  uint32_t* verdict;          // kVerdictOk or the first bad row; NULL: none
  int64_t elems;              // bytes per row, < 2^31
  int64_t per;                // staged words per block (check launch)
  int64_t total;              // staged words of this launch
  int64_t ztotal;             // words of this launch's zero rows
  int32_t n;                  // staged rows of this launch, <= kMaxRows
  int32_t n_zero;             // zero rows of this launch, <= kMaxZero
  int32_t row0;               // staged row 0's index in the whole call
  int32_t gate;               // copy launch: write only if *verdict is ok
  int32_t combine;            // check launch: atomicMin into *verdict
  uint32_t expect;            // check launch: bytes of sums each block receives
  uint32_t has_tag[kMaxRows / 32];  // bit r: row r has an expected tag
  int32_t dst[kMaxRows];      // frame row of each staged row, -1: none
  uint32_t tag[kMaxRows];     // its expected tag, where it has one
  int32_t zero[kMaxZero];     // frame rows to zero
};

__device__ __forceinline__ bool tagged(const ScatterArgs& a, int32_t r) {
  return (a.has_tag[r >> 5] >> (r & 31)) & 1;
}

// The Fletcher terms of one word at word w of its row, both below p: a
// 16-byte word at byte offset o = 16 w adds s1v = sum_j x_j and
// o * s1v + sum_j (j+1) x_j (as fletcher_rows_kernel); a byte adds x and
// (w+1) x.
__device__ __forceinline__ void fletcher_terms(const uint4& x, int32_t w,
                                               uint32_t& c1, uint32_t& c2) {
  const uint32_t s1v =
      __dp4a(x.x, 0x01010101u, __dp4a(x.y, 0x01010101u,
      __dp4a(x.z, 0x01010101u, __dp4a(x.w, 0x01010101u, 0u))));
  const uint32_t lv =
      __dp4a(x.x, 0x04030201u, __dp4a(x.y, 0x08070605u,
      __dp4a(x.z, 0x0C0B0A09u, __dp4a(x.w, 0x100F0E0Du, 0u))));
  const uint32_t o = (static_cast<uint32_t>(w) << 4) % kFletcherP;  // w < 2^27
  c1 = s1v;                                       // <= 4080
  c2 = (o * s1v + lv) % kFletcherP;               // o * s1v + lv < 2^28
}
__device__ __forceinline__ void fletcher_terms(uint8_t x, int32_t w,
                                               uint32_t& c1, uint32_t& c2) {
  c1 = x;
  c2 = ((static_cast<uint32_t>(w) + 1) % kFletcherP) * x % kFletcherP;
}

// st.async of two words into peer ``rank``'s shared memory at the
// address ``local`` has here, completing 8 bytes on the peer's mbarrier
// ``bar``
__device__ __forceinline__ void store2_to_peer(const uint2* local, uint32_t x, uint32_t y,
                                               const uint64_t* bar, uint32_t rank) {
  uint32_t dst, dst_bar;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(dst) : "r"(smem_addr(local)), "r"(rank));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(dst_bar) : "r"(smem_addr(bar)), "r"(rank));
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.u32 [%0], {%1, %2}, [%3];"
               :: "r"(dst), "r"(x), "r"(y), "r"(dst_bar) : "memory");
}

// The staged rows [row_lo, row_hi) whose words block b of a check launch
// reads (rows of no bytes: all of them, block 0); on the host too, which
// counts the bytes each block's mbarrier waits for
__host__ __device__ __forceinline__ void block_rows(const ScatterArgs& a, int64_t nw, int b,
                                                    int32_t& row_lo, int32_t& row_hi) {
  const int64_t lo0 = static_cast<int64_t>(b) * a.per;
  const int64_t lo = lo0 < a.total ? lo0 : a.total;
  const int64_t hi = lo + a.per < a.total ? lo + a.per : a.total;
  row_lo = hi > lo ? static_cast<int32_t>(div_nonneg(lo, nw)) : 0;
  row_hi = hi > lo                    ? static_cast<int32_t>(div_nonneg(hi - 1, nw)) + 1
           : a.total == 0 && b == 0 ? a.n
                                      : 0;
}

// tagged rows in [lo, hi) (host)
uint32_t tagged_in(const ScatterArgs& a, int32_t lo, int32_t hi) {
  uint32_t c = 0;
  for (int32_t r = lo; r < hi; ++r) c += (a.has_tag[r >> 5] >> (r & 31)) & 1;
  return c;
}

// A launch without tags: the plain scatter, and the gated write launches
// of a long call. Each thread copies one word of the staged rows, or
// zeroes one word of the zero rows, per grid stride.
template <typename W>
__global__ void __launch_bounds__(kThreads)
scatter_copy_kernel(const __grid_constant__ ScatterArgs a) {
  if (a.gate && *a.verdict != kVerdictOk) return;
  const int64_t nw = a.elems / static_cast<int64_t>(sizeof(W));
  const W* src = reinterpret_cast<const W*>(a.stage);
  W* out = reinterpret_cast<W*>(a.pool);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t f = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       f < a.total + a.ztotal; f += stride) {
    if (f < a.total) {
      const int64_t r = div_nonneg(f, nw);
      const int64_t d = a.dst[r];
      if (d >= 0) out[d * nw + (f - r * nw)] = src[f];
    } else {
      const int64_t g = f - a.total, z = div_nonneg(g, nw);
      out[static_cast<int64_t>(a.zero[z]) * nw + (g - z * nw)] = W{};
    }
  }
  if (a.verdict && !a.gate && blockIdx.x == 0 && threadIdx.x == 0) *a.verdict = kVerdictOk;
}

// The check and the write in one cluster launch (see above).
template <typename W>
__global__ void __launch_bounds__(kThreads, 1)
scatter_check_kernel(const __grid_constant__ ScatterArgs a) {
  constexpr int kWarps = kThreads / 32;
  // [w][r]: warp w's sums of row r (each warp adds into its own, so the
  // warps of a step that all lie in one row do not contend)
  __shared__ unsigned long long part1[kWarps][kMaxRows], part2[kWarps][kMaxRows];
  __shared__ uint2 slot[kMaxCluster][kMaxRows];   // [b][r]: block b's sums of row r, mod p
  __shared__ uint32_t first_bad;
  __shared__ alignas(8) uint64_t got;             // mbarrier: the peers' sums

  const int t = threadIdx.x, lane = t & 31;
  const int n_blocks = static_cast<int>(gridDim.x), me = static_cast<int>(blockIdx.x);
  const int64_t nw = a.elems / static_cast<int64_t>(sizeof(W));
  const int64_t lo = min(static_cast<int64_t>(me) * a.per, a.total);
  const int64_t hi = min(lo + a.per, a.total);
  const bool resident = a.per <= kRegVecs * kThreads;  // one tile a block
  int32_t row_lo, row_hi;
  block_rows(a, nw, me, row_lo, row_hi);
  if (t == 0) {
    // the mbarrier that counts the bytes of every block's sums of its
    // tagged rows, set up and published to the cluster before any peer
    // may store to it
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(smem_addr(&got)));
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(smem_addr(&got)), "r"(a.expect) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    first_bad = kVerdictOk;
  }
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
  const int warp = t >> 5;
  for (int r = row_lo + lane; r < row_hi; r += 32) part1[warp][r] = part2[warp][r] = 0;
  __syncwarp();

  // the block's range in tiles of kRegVecs words a thread, stepped as in
  // gather_pass_kernel
  constexpr int64_t kTile = kRegVecs * kThreads;
  const int32_t nw32 = static_cast<int32_t>(nw);
  const int32_t q = nw32 ? kThreads / nw32 : 0, rm = kThreads - q * nw32;
  auto step = [&](int32_t& r, int32_t& w) {
    r += q;
    w += rm;
    if (w >= nw32) {
      w -= nw32;
      ++r;
    }
  };
  const W* src = reinterpret_cast<const W*>(a.stage);
  W v[kRegVecs];
  int32_t r0 = 0, w0 = 0, n_in = 0;
  auto load_tile = [&](int64_t tile, auto&& wanted) {
    const int64_t f0 = tile + t;
    n_in = 0;
    if (f0 < hi) {
      r0 = static_cast<int32_t>(div_nonneg(f0, nw));
      w0 = static_cast<int32_t>(f0 - r0 * nw);
      n_in = static_cast<int32_t>(min(static_cast<int64_t>(kRegVecs), (hi - f0 + kThreads - 1) / kThreads));
    }
    int32_t r = r0, w = w0;
#pragma unroll
    for (int j = 0; j < kRegVecs; ++j) {
      if (j < n_in && wanted(r)) v[j] = src[static_cast<int64_t>(r) * nw + w];
      step(r, w);
    }
  };

  // phase 1: read the range once, summing the tagged rows' terms per row:
  // a warp whose words of a step lie in one row adds one warp sum; at a
  // row's edge (and in rows under 32 words) each lane adds its own
  for (int64_t tile = lo; tile < hi; tile += kTile) {
    load_tile(tile, [&](int32_t r) { return tagged(a, r) || a.dst[r] >= 0; });
    int32_t r = r0, w = w0;
#pragma unroll
    for (int j = 0; j < kRegVecs; ++j) {
      uint32_t c1 = 0, c2 = 0;
      const int32_t rr = j < n_in ? r : -1;   // lane 0 holds the warp's first word
      if (rr >= 0 && tagged(a, rr)) fletcher_terms(v[j], w, c1, c2);
      const int32_t r_first = __shfl_sync(0xffffffffu, rr, 0);
      if (__all_sync(0xffffffffu, rr == r_first || rr < 0)) {
        c1 = __reduce_add_sync(0xffffffffu, c1);   // 32 terms below p: < 2^21
        c2 = __reduce_add_sync(0xffffffffu, c2);
        if (lane == 0 && (c1 | c2)) {
          atomicAdd(&part1[warp][r_first], static_cast<unsigned long long>(c1));
          atomicAdd(&part2[warp][r_first], static_cast<unsigned long long>(c2));
        }
      } else if (c1 | c2) {                   // lanes of one warp may share a row
        atomicAdd(&part1[warp][rr], static_cast<unsigned long long>(c1));
        atomicAdd(&part2[warp][rr], static_cast<unsigned long long>(c2));
      }
      step(r, w);
    }
  }

  // store this block's sums of its tagged rows (mod p) into every peer's
  // slots with st.async, which counts their bytes on the peer's
  // mbarrier: a block waits for its peers' sums, not at a barrier
  __syncthreads();
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");   // peers' mbarriers are set up
  for (int k = t; k < (row_hi - row_lo) * n_blocks; k += kThreads) {
    const int32_t r = row_lo + k / n_blocks;
    if (!tagged(a, r)) continue;
    unsigned long long s1 = 0, s2 = 0;
#pragma unroll
    for (int u = 0; u < kWarps; ++u) {
      s1 += part1[u][r];
      s2 += part2[u][r];
    }
    store2_to_peer(&slot[me][r], static_cast<uint32_t>(s1 % kFletcherP),
                   static_cast<uint32_t>(s2 % kFletcherP), &got,
                   static_cast<uint32_t>(k % n_blocks));
  }
  uint32_t done = 0;
  for (uint32_t spin = 0; !done; ++spin) {
    asm volatile("{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
                 " selp.u32 %0, 1, 0, p;\n}" : "=r"(done) : "r"(smem_addr(&got)) : "memory");
    if (spin > (1u << 24)) __trap();       // a lost store: fail, do not hang
  }

  // the verdict: every block sums each tagged row over the blocks that
  // read it and finds the launch's first bad row, a row a thread (a warp
  // taking one row at a time, to keep its parameter reads uniform, was
  // slower on the H100: the rows' chains then run one after another)
  uint32_t bad = kVerdictOk;
  for (int r = t; r < a.n; r += kThreads) {
    if (!tagged(a, r)) continue;
    int b0 = 0, b1 = 0;
    if (a.total > 0) {
      b0 = static_cast<int>(div_nonneg(static_cast<int64_t>(r) * nw, a.per));
      b1 = static_cast<int>(div_nonneg(static_cast<int64_t>(r + 1) * nw - 1, a.per));
    }
    uint32_t s1 = 0, s2 = 0;                  // at most kMaxCluster terms below p
    for (int b = b0; b <= b1; ++b) {
      s1 += slot[b][r].x;
      s2 += slot[b][r].y;
    }
    if (((s1 % kFletcherP) | ((s2 % kFletcherP) << 16)) != a.tag[r])
      bad = min(bad, static_cast<uint32_t>(r));
  }
  bad = __reduce_min_sync(0xffffffffu, bad);
  if (lane == 0 && bad != kVerdictOk) atomicMin(&first_bad, bad);
  __syncthreads();
  bad = first_bad;
  if (me == 0 && t == 0 && a.verdict) {
    const uint32_t v0 = bad == kVerdictOk ? kVerdictOk : static_cast<uint32_t>(a.row0) + bad;
    if (!a.combine)
      *a.verdict = v0;
    else if (bad != kVerdictOk)
      atomicMin(a.verdict, v0);
  }
  if (bad != kVerdictOk) return;                    // nothing written

  // phase 2: the block's staged words to their frame rows, then its share
  // of the zero rows
  W* out = reinterpret_cast<W*>(a.pool);
  auto store_tile = [&] {
    int32_t r = r0, w = w0;
#pragma unroll
    for (int j = 0; j < kRegVecs; ++j) {
      if (j < n_in) {
        const int64_t d = a.dst[r];
        if (d >= 0) out[d * nw + w] = v[j];
      }
      step(r, w);
    }
  };
  if (resident) {
    store_tile();
  } else {                          // read the range again from L2
    for (int64_t tile = lo; tile < hi; tile += kTile) {
      load_tile(tile, [&](int32_t r) { return a.dst[r] >= 0; });
      store_tile();
    }
  }
  const int64_t zper = (a.ztotal + n_blocks - 1) / n_blocks;
  const int64_t zlo = min(static_cast<int64_t>(me) * zper, a.ztotal);
  const int64_t zhi = min(zlo + zper, a.ztotal);
  for (int64_t g = zlo + t; g < zhi; g += kThreads) {
    const int64_t z = div_nonneg(g, nw);
    out[static_cast<int64_t>(a.zero[z]) * nw + (g - z * nw)] = W{};
  }
}

// One launch: where it checks tags, one cluster of up to kMaxCluster
// blocks of kRegVecs words a thread (a longer share is read in tiles),
// else a grid of one word a thread. The non-portable cluster size needs
// the kernel's permission, set on the current device before each check
// launch.
template <typename W>
cudaError_t launch_scatter(ScatterArgs& a, bool check, cudaStream_t stream) {
  const int64_t nw = a.elems / static_cast<int64_t>(sizeof(W));
  a.total = a.n * nw;
  a.ztotal = a.n_zero * nw;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(kThreads);
  cfg.stream = stream;
  cudaError_t err;
  if (!check) {
    int64_t blocks = (a.total + a.ztotal + kThreads - 1) / kThreads;
    blocks = blocks < 1 ? 1 : blocks > 65535 ? 65535 : blocks;
    cfg.gridDim = dim3(static_cast<unsigned>(blocks));
    err = cudaLaunchKernelEx(&cfg, scatter_copy_kernel<W>, a);
  } else {
    const int64_t most = a.total > a.ztotal ? a.total : a.ztotal;
    int64_t blocks = (most + kRegVecs * kThreads - 1) / (kRegVecs * kThreads);
    blocks = blocks < 1 ? 1 : blocks > kMaxCluster ? kMaxCluster : blocks;
    a.per = (a.total + blocks - 1) / blocks;
    a.expect = 0;              // 8 bytes per tagged row of each block
    for (int b = 0; b < blocks; ++b) {
      int32_t lo, hi;
      block_rows(a, nw, b, lo, hi);
      a.expect += 8 * tagged_in(a, lo, hi);
    }
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = static_cast<unsigned>(blocks);
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(static_cast<unsigned>(blocks));
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaFuncSetAttribute(scatter_check_kernel<W>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    err = cudaLaunchKernelEx(&cfg, scatter_check_kernel<W>, a);
  }
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

extern "C" {

// The indexed pass (mode: 0 gather, 1 zero flags, 2 both, compacted) over
// n rows: pool row idx[i] for row i, idx a host int32 vector (NULL: the
// identity), split into launches of kMaxIdx rows. out: (n, elems) rows;
// zero: n flags; count: one int32.
int swap_gather_pass(int mode, const void* pool, const void* idx, int64_t n,
                     int64_t elems, void* out, void* zero, void* count,
                     void* stream) {
  if (elems < 0 || elems >= (int64_t{1} << 31) || n < 0 || n >= (int64_t{1} << 31) ||
      mode < kFull || mode > kCompact)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = elems % 16 == 0 && aligned16(pool) && (mode == kFlags || aligned16(out));
  const int32_t* host_idx = static_cast<const int32_t*>(idx);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  PassArgs a = {};
  a.pool = static_cast<const uint8_t*>(pool);
  a.count = static_cast<int32_t*>(count);
  a.elems = elems;
  for (int64_t lo = 0; lo < n; lo += kMaxIdx) {
    a.n = static_cast<int32_t>(n - lo < kMaxIdx ? n - lo : kMaxIdx);
    for (int32_t i = 0; i < a.n; ++i)
      a.idx[i] = host_idx ? host_idx[lo + i] : static_cast<int32_t>(lo + i);
    a.accumulate = lo > 0;
    a.out = static_cast<uint8_t*>(out) + (mode == kFull ? lo * elems : 0);
    a.zero = zero ? static_cast<uint8_t*>(zero) + lo : nullptr;
    const cudaError_t err = mode == kFull    ? launch_pass_words<kFull>(a, vec, s)
                            : mode == kFlags ? launch_pass_words<kFlags>(a, vec, s)
                                             : launch_pass_words<kCompact>(a, vec, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}

// The verified scatter (see above) of n staged rows of elems bytes at
// stage into pool (n_pool rows). dst: a host int64 vector, the frame row
// of each staged row (-1: verify only); tags: a host int64 vector, each
// row's expected tag (-1: none; NULL: no check); zero: a host int64
// vector of n_zero frame rows to zero. Every index is checked here first
// (kBadIndex). upload: a host buffer (pinned, for an asynchronous copy)
// whose n * elems bytes are copied to stage first, on the same stream.
// verdict: one device uint32, needed with tags or host_verdict; with
// host_verdict (pinned) the verdict is copied back and the stream waited
// for -- the one host wait. launches: a host int32, set to the number of
// kernels launched.
constexpr int kBadIndex = -1;

int swap_scatter_verified(void* pool, int64_t n_pool, void* stage, int64_t n,
                          int64_t elems, const void* dst, const void* tags,
                          const void* zero, int64_t n_zero, void* verdict,
                          const void* upload, void* host_verdict, void* stream,
                          void* launches) {
  int32_t* launched = static_cast<int32_t*>(launches);
  *launched = 0;
  const int64_t* host_dst = static_cast<const int64_t*>(dst);
  const int64_t* host_tag = static_cast<const int64_t*>(tags);
  const int64_t* host_zero = static_cast<const int64_t*>(zero);
  if (elems < 0 || elems >= (int64_t{1} << 31) || n < 0 || n >= (int64_t{1} << 31) ||
      n_zero < 0 || n_zero >= (int64_t{1} << 31) || n_pool >= (int64_t{1} << 31) ||
      (n && !host_dst) || (n_zero && !host_zero))
    return static_cast<int>(cudaErrorInvalidValue);
  bool any_tag = false;
  for (int64_t i = 0; i < n; ++i) {
    if (host_dst[i] < -1 || host_dst[i] >= n_pool) return kBadIndex;
    if (host_tag && (host_tag[i] < -1 || host_tag[i] > 0xffffffffll)) return kBadIndex;
    any_tag |= host_tag && host_tag[i] >= 0;
  }
  for (int64_t i = 0; i < n_zero; ++i)
    if (host_zero[i] < 0 || host_zero[i] >= n_pool) return kBadIndex;
  if ((any_tag || host_verdict) && !verdict) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = elems % 16 == 0 && aligned16(pool) && aligned16(stage);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
  if (upload && n * elems)
    err = cudaMemcpyAsync(stage, upload, static_cast<size_t>(n * elems),
                          cudaMemcpyHostToDevice, s);
  ScatterArgs a = {};
  a.pool = static_cast<uint8_t*>(pool);
  a.verdict = static_cast<uint32_t*>(verdict);
  a.elems = elems;
  // staged rows [lo, lo + rows) and zero rows [zlo, zlo + zeros), each
  // with (check) or without their tags and with (write) or without
  // their destinations
  auto launch = [&](int64_t lo, int64_t rows, int64_t zlo, int64_t zeros,
                    bool check, bool write) {
    a.stage = static_cast<const uint8_t*>(stage) + lo * elems;
    a.n = static_cast<int32_t>(rows);
    a.n_zero = static_cast<int32_t>(zeros);
    a.row0 = static_cast<int32_t>(lo);
    for (int w = 0; w < kMaxRows / 32; ++w) a.has_tag[w] = 0;
    for (int32_t i = 0; i < a.n; ++i) {
      const bool has = check && host_tag && host_tag[lo + i] >= 0;
      a.dst[i] = write ? static_cast<int32_t>(host_dst[lo + i]) : -1;
      a.tag[i] = has ? static_cast<uint32_t>(host_tag[lo + i]) : 0;
      if (has) a.has_tag[i >> 5] |= 1u << (i & 31);
    }
    for (int32_t i = 0; i < a.n_zero; ++i) a.zero[i] = static_cast<int32_t>(host_zero[zlo + i]);
    ++*launched;
    return vec ? launch_scatter<uint4>(a, check, s) : launch_scatter<uint8_t>(a, check, s);
  };
  if (err == cudaSuccess && n <= kMaxRows && n_zero <= kMaxZero) {
    err = launch(0, n, 0, n_zero, any_tag, true);            // one launch does it all
  } else if (err == cudaSuccess) {
    if (verdict) err = cudaMemsetAsync(verdict, 0xff, sizeof(uint32_t), s);   // ok
    a.combine = 1;
    for (int64_t lo = 0; err == cudaSuccess && any_tag && lo < n; lo += kMaxRows) {
      const int64_t rows = n - lo < kMaxRows ? n - lo : kMaxRows;
      bool seg_tag = false;
      for (int64_t i = lo; i < lo + rows; ++i) seg_tag |= host_tag[i] >= 0;
      if (seg_tag) err = launch(lo, rows, 0, 0, true, false);
    }
    a.combine = 0;
    a.gate = any_tag;
    for (int64_t lo = 0, zlo = 0; err == cudaSuccess && (lo < n || zlo < n_zero);
         lo += kMaxRows, zlo += kMaxZero) {
      const int64_t rows = n - lo < kMaxRows ? (n - lo > 0 ? n - lo : 0) : kMaxRows;
      const int64_t zeros = n_zero - zlo < kMaxZero ? (n_zero - zlo > 0 ? n_zero - zlo : 0) : kMaxZero;
      err = launch(lo < n ? lo : n, rows, zlo < n_zero ? zlo : n_zero, zeros, false, true);
    }
  }
  if (err == cudaSuccess && host_verdict) {
    err = cudaMemcpyAsync(host_verdict, verdict, sizeof(uint32_t), cudaMemcpyDeviceToHost, s);
    if (err == cudaSuccess) err = cudaStreamSynchronize(s);
  }
  return static_cast<int>(err);
}

int swap_fletcher_rows(const void* x, void* out, int64_t n_rows,
                       int64_t elems, void* stream) {
  if (elems >= (int64_t{1} << 31)) return static_cast<int>(cudaErrorInvalidValue);
  fletcher_rows_kernel<<<static_cast<unsigned>(n_rows), fletcher_threads(elems),
                         0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(x), static_cast<uint32_t>(elems),
      static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

const char* swap_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
