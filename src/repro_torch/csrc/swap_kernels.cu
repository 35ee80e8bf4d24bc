// Swap data-path kernels for Hopper (sm_90a): the four kernels that carry
// Taiji's swap-out and swap-in copies, the store-side zero scan and the
// per-row Fletcher integrity tags.
//
// Plain extern "C" entry points, loaded with ctypes by
// repro_torch/kernels/_build.py; each launches on the stream it is given
// and returns cudaGetLastError(), so a refused launch surfaces in the
// Python wrapper (repro_torch/kernels/ops.py), which also checks device,
// dtype, shape, contiguity and index bounds before it gets here.
//
// Layout: every operand is a row-major (rows, elems) uint8 matrix; one
// thread block owns one row.
//
// Bound on the card: at the main-path shapes (64 rows of one 4 KiB MP out
// of a (512, 4096) MS frame) every kernel here is bounded by bytes moved,
// and at these sizes the launch itself (a few microseconds) dominates:
//   gather / scatter move 2 x 256 KiB per 64-row chunk: ~0.16 us at
//   3.35 TB/s; zero scan and Fletcher read 256 KiB: ~0.08 us.
// The design therefore keeps each kernel a single launch over the whole
// chunk with 16-byte accesses where the rows allow them; making the swap
// path launch fewer kernels is where later speed-ups come from.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ bool aligned16(const void* p) {
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

// Replaces repro/kernels/swap_copy.py:gather_blocks (_gather_kernel).
// The TPU kernel scalar-prefetches the indices so its DMA knows each
// source row ahead of the grid step; here each block loads its own index.
__global__ void gather_rows_kernel(const uint8_t* __restrict__ pool,
                                   const int64_t* __restrict__ idx,
                                   uint8_t* __restrict__ out, int64_t elems) {
  const int64_t row = blockIdx.x;
  copy_row(pool + idx[row] * elems, out + row * elems, elems);
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

// Replaces repro/kernels/zero_detect.py:zero_detect (_zero_detect_kernel).
// The TPU kernel walks the row tile by tile through a sequential grid
// dimension; here the whole block ORs the row (uint4 words when the row
// is 16-byte aligned) and __syncthreads_or combines the threads, so any
// row length works with no tile restriction. Bytes only: the wrapper
// rejects float rows, where -0.0 is non-zero as bytes but zero as value.
__global__ void zero_rows_kernel(const uint8_t* __restrict__ x, int64_t elems,
                                 uint8_t* __restrict__ out) {
  const uint8_t* row = x + static_cast<int64_t>(blockIdx.x) * elems;
  uint32_t acc = 0;
  int64_t done = 0;
  if (aligned16(row)) {
    const int64_t nv = elems >> 4;
    const uint4* v = reinterpret_cast<const uint4*>(row);
    for (int64_t k = threadIdx.x; k < nv; k += blockDim.x) {
      const uint4 w = v[k];
      acc |= w.x | w.y | w.z | w.w;
    }
    done = nv << 4;
  }
  for (int64_t k = done + threadIdx.x; k < elems; k += blockDim.x) acc |= row[k];
  const int any = __syncthreads_or(acc != 0);
  if (threadIdx.x == 0) out[blockIdx.x] = any ? 0 : 1;
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

int swap_gather_rows(const void* pool, const void* idx, void* out,
                     int64_t n_out, int64_t elems, void* stream) {
  gather_rows_kernel<<<static_cast<unsigned>(n_out), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(pool), static_cast<const int64_t*>(idx),
      static_cast<uint8_t*>(out), elems);
  return static_cast<int>(cudaGetLastError());
}

int swap_scatter_rows(void* pool, const void* idx, const void* blocks,
                      int64_t n_rows, int64_t elems, void* stream) {
  scatter_rows_kernel<<<static_cast<unsigned>(n_rows), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint8_t*>(pool), static_cast<const int64_t*>(idx),
      static_cast<const uint8_t*>(blocks), elems);
  return static_cast<int>(cudaGetLastError());
}

int swap_zero_rows(const void* x, void* out, int64_t n_rows, int64_t elems,
                   void* stream) {
  zero_rows_kernel<<<static_cast<unsigned>(n_rows), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(x), elems, static_cast<uint8_t*>(out));
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
