// Shared helpers for the port's hand-written Hopper kernels.
//
// Every kernel library entry point has a plain C signature (pointers as
// void*, the CUDA stream as void*), launches on the caller's stream and
// returns cudaGetLastError() so the Python wrapper can raise on a refused
// launch. Nothing here includes a PyTorch header.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define MVDF_API extern "C" __attribute__((visibility("default")))

namespace mvdf {

typedef __nv_bfloat16 bf16;

// dtype codes shared with ops/_lib.py
enum { DT_F32 = 0, DT_BF16 = 1 };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16(x); }

// element i of a buffer whose type is chosen at run time (uniform branch)
__device__ __forceinline__ float load_any(const void* p, int64_t i, int is_bf16) {
  return is_bf16 ? __bfloat162float(reinterpret_cast<const bf16*>(p)[i])
                 : reinterpret_cast<const float*>(p)[i];
}
__device__ __forceinline__ void store_any(void* p, int64_t i, float v, int is_bf16) {
  if (is_bf16)
    reinterpret_cast<bf16*>(p)[i] = __float2bfloat16(v);
  else
    reinterpret_cast<float*>(p)[i] = v;
}

// exact (erf) GELU, as jax.nn.gelu(approximate=False)
__device__ __forceinline__ float gelu_erf(float x) {
  return 0.5f * x * (1.0f + erff(x * 0.70710678118654752440f));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// sum over the whole block (blockDim.x a multiple of 32, <= 1024); every
// thread gets the result. `scratch` holds >= 32 floats.
__device__ __forceinline__ float block_sum(float v, float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  v = warp_sum(v);
  __syncthreads();
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float t = (lane < nwarps) ? scratch[lane] : 0.0f;
  return warp_sum(t);
}

}  // namespace mvdf
