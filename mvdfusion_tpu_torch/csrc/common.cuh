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

// ---- Hopper's warp-level tensor-core path (sm_90a, PTX ISA 7.x): 16-byte
// asynchronous copies into shared memory, ldmatrix and mma.sync m16n8k16 with
// bf16 operands and fp32 sums. Fragment layouts are the ISA's: for a 16x16 A
// tile, a thread holds rows lane/4 and lane/4 + 8 at columns 2*(lane%4) + {0,
// 1} and + 8; for a 16x8 B tile, rows (k) 2*(lane%4) + {0, 1} and + 8 at column
// lane/4; for the 16x8 fp32 sum, c0 c1 at row lane/4 and c2 c3 at row
// lane/4 + 8, columns 2*(lane%4) + {0, 1}.

// 16 bytes from global to shared memory; `full` false writes 16 zero bytes
// and reads nothing
__device__ __forceinline__ void cp_async16(void* smem_dst, const void* gmem_src, bool full) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem_dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem_src), "r"(full ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8x8 bf16 matrices; lanes 8i..8i+7 give the row addresses of matrix i
// (16 bytes each), register i receives this thread's pair of matrix i
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* smem_row) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem_row);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s)
               : "memory");
}
// the same, each matrix transposed on the way (a B fragment from k-major rows)
__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const void* smem_row) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem_row);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s)
               : "memory");
}

// d += a (16x16, row) * b (16x8, col), bf16 operands, fp32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two bf16 in one register, `lo` at the lower address
__device__ __forceinline__ unsigned pack_bf16(bf16 lo, bf16 hi) {
  return (unsigned)__bfloat16_as_ushort(lo) | ((unsigned)__bfloat16_as_ushort(hi) << 16);
}
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  return pack_bf16(__float2bfloat16(lo), __float2bfloat16(hi));
}

// one 16-byte vector of T (8 bf16 or 4 fp32) to fp32 and back (round to nearest)
__device__ __forceinline__ void unpack16(const uint4& u, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x, f[2 * i + 1] = t.y;
  }
}
__device__ __forceinline__ void unpack16(const uint4& u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x), f[1] = __uint_as_float(u.y), f[2] = __uint_as_float(u.z), f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ uint4 pack16(const float (&f)[8]) {
  return make_uint4(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]), pack_bf16(f[4], f[5]), pack_bf16(f[6], f[7]));
}
__device__ __forceinline__ uint4 pack16(const float (&f)[4]) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]), __float_as_uint(f[3]));
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
