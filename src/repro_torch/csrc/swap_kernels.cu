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
constexpr unsigned long long kFletcherP = 65521;  // largest prime < 2^16

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
// Per row: (sum x mod p) | (sum ((i+1) mod p) * x mod p) << 16. The TPU
// kernel folds tile partials modularly across its sequential grid; here
// each thread sums its strided bytes exactly in uint64 (a term is below
// 2^24, so no row that fits in memory can overflow), the block reduces
// the partials, and one thread takes the modulus. Integer sums are exact
// in any order, so the tag equals the reference's bit for bit for any
// row length, including rows past 65521 bytes where the weight wraps.
__global__ void fletcher_rows_kernel(const uint8_t* __restrict__ x,
                                     int64_t elems,
                                     uint32_t* __restrict__ out) {
  const uint8_t* row = x + static_cast<int64_t>(blockIdx.x) * elems;
  unsigned long long s1 = 0, s2 = 0;
  // weight (i+1) mod p, stepped by blockDim (< p) without a division
  unsigned long long w = (threadIdx.x + 1) % kFletcherP;
  for (int64_t i = threadIdx.x; i < elems; i += blockDim.x) {
    const unsigned long long v = row[i];
    s1 += v;
    s2 += w * v;
    w += blockDim.x;
    if (w >= kFletcherP) w -= kFletcherP;
  }
  for (int off = 16; off > 0; off >>= 1) {
    s1 += __shfl_down_sync(0xffffffffu, s1, off);
    s2 += __shfl_down_sync(0xffffffffu, s2, off);
  }
  __shared__ unsigned long long part1[kThreads / 32], part2[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    part1[warp] = s1;
    part2[warp] = s2;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long t1 = 0, t2 = 0;
    for (int k = 0; k < static_cast<int>(blockDim.x >> 5); ++k) {
      t1 += part1[k];
      t2 += part2[k];
    }
    out[blockIdx.x] = static_cast<uint32_t>((t1 % kFletcherP) |
                                            ((t2 % kFletcherP) << 16));
  }
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
  fletcher_rows_kernel<<<static_cast<unsigned>(n_rows), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(x), elems, static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

const char* swap_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
