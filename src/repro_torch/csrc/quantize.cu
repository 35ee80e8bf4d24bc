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
// and writes 113.2 MB: ~101 us at 3.35 TB/s; dequantize the reverse. The
// design here is the simple one: quantize gives one thread block to each
// MP and reads it twice (absmax, then quantize), 16 bytes a load; the
// second read of a 1.1 MiB MP mostly misses L2 at that shape, so ~1.7x
// the bound's bytes move. Dequantize needs no reduction and spreads each
// MP over many blocks.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kQuantThreads = 512;
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

// a word of N bytes, for storing N int8 results at once
template <int N> struct Word;
template <> struct Word<4> { using type = uint32_t; };
template <> struct Word<8> { using type = uint2; };

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

// One block per MP. The Pallas kernel quantizes one (1, mp) tile per
// grid step with the tile in VMEM; here the MP (1.1 MiB at the card's
// shape) does not fit an SM, so the block streams it twice from HBM.
template <typename T>
__global__ void __launch_bounds__(kQuantThreads)
block_quantize_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                      float* __restrict__ scales, int64_t mp) {
  constexpr int kVec = 16 / sizeof(T);   // elements per 16-byte load
  using Out = typename Word<kVec>::type;
  const int64_t k = blockIdx.x;
  const T* src = x + k * mp;
  int8_t* dst = q + k * mp;
  const int64_t nv = (aligned(src, 16) && aligned(dst, kVec)) ? mp / kVec : 0;

  float m = 0.0f;
  for (int64_t i = threadIdx.x; i < nv; i += blockDim.x) {
    alignas(16) T e[kVec];
    *reinterpret_cast<uint4*>(e) = reinterpret_cast<const uint4*>(src)[i];
#pragma unroll
    for (int j = 0; j < kVec; ++j) m = fmaxf(m, fabsf(to_f32(e[j])));
  }
  for (int64_t i = nv * kVec + threadIdx.x; i < mp; i += blockDim.x)
    m = fmaxf(m, fabsf(to_f32(src[i])));
  m = block_max(m);
  const float scale = m > 0.0f ? __fdiv_rn(m, 127.0f) : 1.0f;
  if (threadIdx.x == 0) scales[k] = scale;

  for (int64_t i = threadIdx.x; i < nv; i += blockDim.x) {
    alignas(16) T e[kVec];
    alignas(8) int8_t o[kVec];
    *reinterpret_cast<uint4*>(e) = reinterpret_cast<const uint4*>(src)[i];
#pragma unroll
    for (int j = 0; j < kVec; ++j) o[j] = quantize1(to_f32(e[j]), scale);
    reinterpret_cast<Out*>(dst)[i] = *reinterpret_cast<const Out*>(o);
  }
  for (int64_t i = nv * kVec + threadIdx.x; i < mp; i += blockDim.x)
    dst[i] = quantize1(to_f32(src[i]), scale);
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
  const dim3 grid(static_cast<unsigned>(n_mps));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int8_t* qo = static_cast<int8_t*>(q);
  float* so = static_cast<float*>(scales);
  switch (dtype) {
    case 0:
      block_quantize_kernel<float><<<grid, kQuantThreads, 0, s>>>(
          static_cast<const float*>(x), qo, so, mp);
      break;
    case 1:
      block_quantize_kernel<__half><<<grid, kQuantThreads, 0, s>>>(
          static_cast<const __half*>(x), qo, so, mp);
      break;
    case 2:
      block_quantize_kernel<__nv_bfloat16><<<grid, kQuantThreads, 0, s>>>(
          static_cast<const __nv_bfloat16*>(x), qo, so, mp);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
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
