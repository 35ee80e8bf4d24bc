// Swap data-path kernels for Hopper (sm_90a): the swap-out's indexed
// pass (gather, zero scan, and both at once with compaction), the
// swap-in's scatter and the per-row Fletcher integrity tags.
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
// that flags the zero rows and hands back only the non-zero ones.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__host__ __device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Copy one row of n bytes: 16-byte (uint4) loads and stores when both
// ends are 16-byte aligned, then a byte tail; a byte loop otherwise.
__device__ __forceinline__ void copy_row(const uint8_t* __restrict__ src,
                                         uint8_t* __restrict__ dst,
                                         int64_t n) {
  int64_t done = 0;
  if (aligned16(src) && aligned16(dst)) {
    const int64_t nv = n >> 4;
    const uint4* s = reinterpret_cast<const uint4*>(src);
    uint4* d = reinterpret_cast<uint4*>(dst);
    for (int64_t k = threadIdx.x; k < nv; k += blockDim.x) d[k] = s[k];
    done = nv << 4;
  }
  for (int64_t k = done + threadIdx.x; k < n; k += blockDim.x) dst[k] = src[k];
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
__device__ __forceinline__ int64_t div_nonneg(int64_t a, int64_t b) {
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

// Replaces repro/kernels/swap_copy.py:scatter_blocks (_scatter_kernel).
// Written in place into the pool: rows not named in idx are never
// touched, which the TPU kernel gets from input/output aliasing.
// Duplicate indices give an undefined result, as in the reference.
__global__ void scatter_rows_kernel(uint8_t* __restrict__ pool,
                                    const int64_t* __restrict__ idx,
                                    const uint8_t* __restrict__ blocks,
                                    int64_t elems) {
  const int64_t row = blockIdx.x;
  copy_row(blocks + row * elems, pool + idx[row] * elems, elems);
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

int swap_scatter_rows(void* pool, const void* idx, const void* blocks,
                      int64_t n_rows, int64_t elems, void* stream) {
  scatter_rows_kernel<<<static_cast<unsigned>(n_rows), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint8_t*>(pool), static_cast<const int64_t*>(idx),
      static_cast<const uint8_t*>(blocks), elems);
  return static_cast<int>(cudaGetLastError());
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
