// Int8 block quantize / dequantize for Hopper (sm_90a): the per-MP
// symmetric quantizer of the lossy KV tier and its inverse.
//
// Replaces repro/kernels/compress.py:block_quantize (_quant_kernel) and
// repro/kernels/compress.py:block_dequantize (_dequant_kernel). No path
// of either package calls them; they are held against their plain
// versions (repro_torch/kernels/ref.py) bit for bit.
//
// Plain extern "C" entry points, loaded with ctypes by
// repro_torch/kernels/_build.py; each launches on the stream it is given
// and returns cudaGetLastError(). The Python wrappers
// (repro_torch/kernels/ops.py) check device, dtype, shape and contiguity.
//
// Layout: a contiguous (n, elems) matrix cut into n * mps MPs of
// mp = elems / mps elements; MP k starts at element k * mp, and its scale
// is scales[k], so the (n, mps) scale matrix is read flat.
//
// Bit-exactness: absmax is a max, which is the same in any order; the
// scale is one f32 division absmax / 127 (1 for an all-zero MP); each
// element is one IEEE division x / scale (__fdiv_rn, whatever the
// flags), rounded half to even (rintf, as jnp.round) and clipped before
// the int8 cast. Dequantize is one f32 multiply (__fmul_rn: nothing to
// contract) and a round-to-nearest cast to the output type.
//
// Bound on the card: both kernels are bounded by bytes. At the KV
// geometry (24 blocks of 4,718,592 bf16 in 8 MPs) quantize reads 226.5 MB
// and writes 113.2 MB: ~101 us at 3.35 TB/s; dequantize the reverse.
// Quantize needs each MP's absmax before its first result, so an MP is
// one thread block cluster that holds it in shared memory and reads it
// from HBM once (quantize_cluster_kernel). Dequantize needs no reduction
// and spreads each MP over many blocks.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kQuantThreads = 256;
constexpr int kDequantThreads = 256;
constexpr int kDequantVec = 16;          // int8 per 16-byte load
constexpr int64_t kMaxGridY = 65535;

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__half>(__half v) {
  return __half2float(v);
}
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ bool aligned(const void* p, int n) {
  return (reinterpret_cast<uintptr_t>(p) % n) == 0;
}

__device__ __forceinline__ int8_t quantize1(float v, float scale) {
  const float r = fminf(fmaxf(rintf(__fdiv_rn(v, scale)), -127.0f), 127.0f);
  return static_cast<int8_t>(static_cast<int>(r));
}

// max over the block; every thread gets the result
__device__ __forceinline__ float block_max(float m) {
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  __shared__ float part[kQuantThreads / 32];
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = m;
  __syncthreads();
  m = part[0];
  for (int w = 1; w < static_cast<int>(blockDim.x >> 5); ++w)
    m = fmaxf(m, part[w]);
  return m;
}

// One thread block cluster per MP: the Pallas kernel quantizes one
// (1, mp) tile per grid step with the tile in VMEM; here an MP (1.125
// MiB at the card's shape) does not fit one SM, but it fits the shared
// memory of a cluster. The MP is cut into C slices of at most
// kSliceTarget bytes (C <= kQuantCluster; 16 x 72 KiB at the card's
// shape, three blocks an SM). Each block
//   1. bulk-copies its slice into shared memory (cp.async.bulk from one
//      warp in kBulkChunk pieces, completing on an mbarrier; an
//      unaligned head or tail by plain loads),
//   2. takes the slice's absmax there and stores it into every peer's
//      shared memory (st.shared::cluster); after one cluster barrier each
//      block has the MP's absmax, and so its scale,
//   3. quantizes from shared memory, 16 results a thread to one 16-byte
//      store where the output is aligned.
// HBM traffic is then the bound's bytes: each input byte read once, each
// int8 written once. A slice above kSliceMax bytes (MPs over 1.75 MiB:
// two blocks an SM, so that a cluster of 16 spans 8 SMs of a GPC) is not
// held: such a block streams its slice twice from HBM instead (absmax,
// then quantize), the exchange unchanged; so does a held cluster the
// card reports it cannot place.
constexpr int kQuantCluster = 16;            // blocks an MP, at most (non-portable)
constexpr int64_t kSliceTarget = 72 << 10;   // bytes of a slice, at most, where C allows
constexpr int64_t kSliceMax = 112 << 10;     // bytes of a slice kept in shared memory
constexpr uint32_t kBulkChunk = 16 << 10;    // bytes of one cp.async.bulk
constexpr int kGroup = 16;                   // results a thread stores at once

__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t cluster_size() {
  uint32_t n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(n));
  return n;
}

// the absmax of p[0, n): 16-byte loads where p is 16-byte aligned
template <typename T>
__device__ __forceinline__ float absmax_range(const T* p, int64_t n) {
  constexpr int kVec = 16 / sizeof(T);
  float m = 0.0f;
  const int64_t nv = aligned(p, 16) ? n / kVec : 0;
  for (int64_t i = threadIdx.x; i < nv; i += blockDim.x) {
    alignas(16) T e[kVec];
    *reinterpret_cast<uint4*>(e) = reinterpret_cast<const uint4*>(p)[i];
#pragma unroll
    for (int j = 0; j < kVec; ++j) m = fmaxf(m, fabsf(to_f32(e[j])));
  }
  for (int64_t i = nv * kVec + threadIdx.x; i < n; i += blockDim.x)
    m = fmaxf(m, fabsf(to_f32(p[i])));
  return m;
}

// quantize n elements of src into dst: kGroup results a thread to one
// 16-byte store where dst is 16-byte aligned and src 16-byte aligned,
// one by one otherwise and for the tail
template <typename T>
__device__ __forceinline__ void quantize_range(const T* src, int8_t* dst, int64_t n,
                                               float scale) {
  int64_t done = 0;
  if (aligned(src, 16) && aligned(dst, 16)) {
    constexpr int kIn = kGroup * sizeof(T) / 16;   // 16-byte loads a group
    const int64_t ng = n / kGroup;
    for (int64_t g = threadIdx.x; g < ng; g += blockDim.x) {
      alignas(16) T e[kGroup];
      alignas(16) int8_t o[kGroup];
#pragma unroll
      for (int w = 0; w < kIn; ++w)
        reinterpret_cast<uint4*>(e)[w] = reinterpret_cast<const uint4*>(src + g * kGroup)[w];
#pragma unroll
      for (int j = 0; j < kGroup; ++j) o[j] = quantize1(to_f32(e[j]), scale);
      reinterpret_cast<uint4*>(dst)[g] = *reinterpret_cast<const uint4*>(o);
    }
    done = ng * kGroup;
  }
  for (int64_t i = done + threadIdx.x; i < n; i += blockDim.x)
    dst[i] = quantize1(to_f32(src[i]), scale);
}

template <typename T, bool kResident>
__global__ void __launch_bounds__(kQuantThreads, 3)
quantize_cluster_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                        float* __restrict__ scales, int64_t mp, int64_t slice) {
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ alignas(8) uint64_t full;                 // mbarrier: the slice has landed
  __shared__ float peer_max[kQuantCluster];            // [b]: block b's absmax
  const uint32_t C = cluster_size(), rank = cluster_rank();
  const int64_t k = blockIdx.x / C;                    // the MP
  const int64_t s0 = min(static_cast<int64_t>(rank) * slice, mp);
  const int64_t len = min(s0 + slice, mp) - s0;
  const T* src = x + k * mp + s0;
  int8_t* dst = q + k * mp + s0;
  const int t = threadIdx.x;

  float m;
  if constexpr (kResident) {
    // the 16-byte aligned middle of the slice by bulk copies, an
    // unaligned head and tail by plain loads
    const int64_t bytes = len * static_cast<int64_t>(sizeof(T));
    const uintptr_t a0 = reinterpret_cast<uintptr_t>(src);
    const int64_t head = min(bytes, static_cast<int64_t>((16 - (a0 & 15)) & 15));
    const int64_t body = (bytes - head) & ~int64_t{15};
    // src byte i goes to bytes_buf[i]: bytes_buf + head is 16-byte
    // aligned, as src + head is
    uint8_t* bytes_buf = smem + (a0 & 15);
    if (t == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(shared_addr(&full)));
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
    if (t < 32) {
      const uint32_t n_chunks = static_cast<uint32_t>((body + kBulkChunk - 1) / kBulkChunk);
      if (t == 0)
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                     :: "r"(shared_addr(&full)), "r"(static_cast<uint32_t>(body)) : "memory");
      __syncwarp();
      for (uint32_t c = t; c < n_chunks; c += 32) {
        const int64_t off = head + static_cast<int64_t>(c) * kBulkChunk;
        const uint32_t size = static_cast<uint32_t>(min(static_cast<int64_t>(kBulkChunk), head + body - off));
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
            :: "r"(shared_addr(bytes_buf + off)), "l"(reinterpret_cast<const uint8_t*>(src) + off),
               "r"(size), "r"(shared_addr(&full)) : "memory");
      }
    }
    const uint8_t* sb = reinterpret_cast<const uint8_t*>(src);
    for (int64_t i = t; i < head; i += blockDim.x) bytes_buf[i] = sb[i];
    for (int64_t i = head + body + t; i < bytes; i += blockDim.x) bytes_buf[i] = sb[i];
    // peers start and publish nothing yet: arrive now, wait before the
    // exchange
    asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
    uint32_t done = 0;
    for (uint32_t spin = 0; !done; ++spin) {
      asm volatile("{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
                   " selp.u32 %0, 1, 0, p;\n}" : "=r"(done) : "r"(shared_addr(&full)) : "memory");
      if (spin > (1u << 26)) __trap();     // a lost copy: fail, do not hang
    }
    __syncthreads();                       // the head and tail bytes
    src = reinterpret_cast<const T*>(bytes_buf);   // element-aligned, as src was
    m = absmax_range(src, len);
  } else {
    asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
    m = absmax_range(src, len);
  }
  m = block_max(m);

  // the exchange: this block's absmax into every peer's peer_max[rank]
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");       // every peer has started
  if (t < static_cast<int>(C)) {
    uint32_t addr;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
                 : "=r"(addr) : "r"(shared_addr(&peer_max[rank])), "r"(static_cast<uint32_t>(t)));
    asm volatile("st.shared::cluster.f32 [%0], %1;" :: "r"(addr), "f"(m) : "memory");
  }
  asm volatile("barrier.cluster.arrive.aligned;\n\tbarrier.cluster.wait.aligned;" ::: "memory");
  m = peer_max[0];
  for (uint32_t b = 1; b < C; ++b) m = fmaxf(m, peer_max[b]);
  const float scale = m > 0.0f ? __fdiv_rn(m, 127.0f) : 1.0f;
  if (rank == 0 && t == 0) scales[k] = scale;
  quantize_range(src, dst, len, scale);
}

// The cluster size and slice length (elements, a multiple of kGroup) for
// MPs of mp elements of sz bytes.
void quantize_geometry(int64_t mp, int64_t sz, int* clusters, int64_t* slice) {
  int64_t c = (mp * sz + kSliceTarget - 1) / kSliceTarget;
  c = c < 1 ? 1 : c > kQuantCluster ? kQuantCluster : c;
  int64_t s = (mp + c - 1) / c;
  s = (s + kGroup - 1) / kGroup * kGroup;
  *clusters = static_cast<int>((mp + s - 1) / s);
  *slice = s;
}

template <typename T>
cudaError_t launch_quantize(const void* x, void* q, void* scales, int64_t n_mps,
                            int64_t mp, cudaStream_t stream) {
  int c;
  int64_t slice;
  quantize_geometry(mp, sizeof(T), &c, &slice);
  if (n_mps * c > 0x7fffffff) return cudaErrorInvalidValue;
  // room for the slice and for shifting an unaligned head (16 bytes)
  const int64_t smem = slice * static_cast<int64_t>(sizeof(T)) + 16;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(n_mps * c));
  cfg.blockDim = dim3(kQuantThreads);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(c);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  auto prepare = [&](auto kernel, int64_t dyn) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(dyn));
    cfg.dynamicSmemBytes = static_cast<size_t>(dyn);
    return e;
  };
  const auto held = quantize_cluster_kernel<T, true>;
  const auto streamed = quantize_cluster_kernel<T, false>;
  bool resident = smem <= kSliceMax;
  cudaError_t err = resident ? prepare(held, smem) : prepare(streamed, 0);
  if (err == cudaSuccess && resident) {
    int fit = 0;
    err = cudaOccupancyMaxActiveClusters(&fit, held, &cfg);
    if (err == cudaSuccess && fit < 1) {
      resident = false;
      err = prepare(streamed, 0);
    }
  }
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(&cfg, resident ? held : streamed, static_cast<const T*>(x),
                           static_cast<int8_t*>(q), static_cast<float*>(scales), mp, slice);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// grid (MP, slice of the MP): elementwise, so each MP spreads over up
// to 65535 blocks that stride through it together.
template <typename T>
__global__ void __launch_bounds__(kDequantThreads)
block_dequantize_kernel(const int8_t* __restrict__ q,
                        const float* __restrict__ scales,
                        T* __restrict__ out, int64_t mp) {
  constexpr int kOutWords = kDequantVec * sizeof(T) / 16;
  const int64_t k = blockIdx.x;
  const float scale = scales[k];
  const int8_t* src = q + k * mp;
  T* dst = out + k * mp;
  const int64_t nv = (aligned(src, 16) && aligned(dst, 16)) ? mp / kDequantVec : 0;
  const int64_t first = static_cast<int64_t>(blockIdx.y) * blockDim.x + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.y) * blockDim.x;

  for (int64_t i = first; i < nv; i += stride) {
    alignas(16) int8_t e[kDequantVec];
    alignas(16) T o[kDequantVec];
    *reinterpret_cast<uint4*>(e) = reinterpret_cast<const uint4*>(src)[i];
#pragma unroll
    for (int j = 0; j < kDequantVec; ++j)
      o[j] = from_f32<T>(__fmul_rn(static_cast<float>(e[j]), scale));
#pragma unroll
    for (int w = 0; w < kOutWords; ++w)
      reinterpret_cast<uint4*>(dst + i * kDequantVec)[w] =
          reinterpret_cast<const uint4*>(o)[w];
  }
  for (int64_t i = nv * kDequantVec + first; i < mp; i += stride)
    dst[i] = from_f32<T>(__fmul_rn(static_cast<float>(src[i]), scale));
}

bool bad_grid(int64_t n_mps, int64_t mp) {
  return n_mps <= 0 || n_mps > 0x7fffffff || mp <= 0;
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 float16, 2 bfloat16 (of x)
int quant_block_quantize(const void* x, void* q, void* scales, int64_t n_mps,
                         int64_t mp, int dtype, void* stream) {
  if (bad_grid(n_mps, mp)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return static_cast<int>(launch_quantize<float>(x, q, scales, n_mps, mp, s));
    case 1:
      return static_cast<int>(launch_quantize<__half>(x, q, scales, n_mps, mp, s));
    case 2:
      return static_cast<int>(launch_quantize<__nv_bfloat16>(x, q, scales, n_mps, mp, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// dtype: 0 float32, 1 float16, 2 bfloat16 (of out)
int quant_block_dequantize(const void* q, const void* scales, void* out,
                           int64_t n_mps, int64_t mp, int dtype, void* stream) {
  if (bad_grid(n_mps, mp)) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t per_block = static_cast<int64_t>(kDequantThreads) * kDequantVec;
  int64_t slices = (mp + per_block - 1) / per_block;
  if (slices > kMaxGridY) slices = kMaxGridY;
  const dim3 grid(static_cast<unsigned>(n_mps), static_cast<unsigned>(slices));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* qi = static_cast<const int8_t*>(q);
  const float* si = static_cast<const float*>(scales);
  switch (dtype) {
    case 0:
      block_dequantize_kernel<float><<<grid, kDequantThreads, 0, s>>>(
          qi, si, static_cast<float*>(out), mp);
      break;
    case 1:
      block_dequantize_kernel<__half><<<grid, kDequantThreads, 0, s>>>(
          qi, si, static_cast<__half*>(out), mp);
      break;
    case 2:
      block_dequantize_kernel<__nv_bfloat16><<<grid, kDequantThreads, 0, s>>>(
          qi, si, static_cast<__nv_bfloat16*>(out), mp);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
