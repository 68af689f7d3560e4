// K3 building blocks: LayerNorm and a GEMM with a fused epilogue.
//
// Together with K1 (site GroupNorm) and K2 (self-attention) these replace
// the split form of mvdfusion_tpu/ops/block.py::_fwd_impl — _attn_kernel
// (site GN, proj_in, LN1, attention, out-proj, residual, + attn2) and
// _ff_kernel (LN3, GEGLU, FF out, residual, proj_out, + x_in) — and the
// token-wise products of K4's DiT (ops/crossview.py).
//
// Bound on the H100: the site's products are operations-bound (C=320 at
// N=1024, B=16: ~60 GFLOP against ~40 MB); LayerNorm is bytes-bound. The
// GEMM runs on the bf16 tensor cores through warp-level mma (nvcuda::wmma,
// 16x16x16 fragments, fp32 accumulation) with 64x64 block tiles staged in
// shared memory; it is far from the card's wgmma peak (no TMA, no pipelining)
// and that is where a later PR gains. The epilogue applies bias, exact-erf
// GELU or GEGLU, a per-column gate, and up to two residual adds in fp32, so
// no intermediate of the site makes an extra round trip; it rounds once, or
// (`steps`) where the TPU kernel's bf16 operations round. The tile, the
// epilogue and the LayerNorm row are gemm.cuh's, shared with the one-kernel
// site (blockforms.cu).
// GEGLU needs its value and gate columns in one tile: the wrapper packs the
// weight rows so each 64-row tile holds 32 value rows then their 32 gate rows.
#include "gemm.cuh"

namespace mvdf {

// one warp per row of C <= 32 PL
template <int PL>
__global__ void __launch_bounds__(256) layernorm_kernel(const void* x, int x_bf16, const float* gamma,
                                                        const float* beta, void* y, int y_bf16, int M, int C,
                                                        float eps) {
  const int64_t row = (int64_t)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row < M) layernorm_row<PL>(x, x_bf16, gamma, beta, y, y_bf16, row, C, eps);
}

// one 64x64 output tile per block, 128 threads
template <typename T>
__global__ void __launch_bounds__(128) gemm_kernel(const T* A, const T* W, int N, int K, Epilogue e) {
  __shared__ __align__(128) unsigned char smem[GEMM_SMEM_BYTES];
  gemm_tile(A, W, N, K, e, blockIdx.y * BM, blockIdx.x * BN, smem);
}

}  // namespace mvdf

using namespace mvdf;

MVDF_API int mvdf_layernorm(const void* x, int x_bf16, const void* gamma, const void* beta, void* y, int y_bf16,
                            int M, int C, float eps, void* stream) {
  const int rows_per_block = 8;
  const dim3 grid((M + rows_per_block - 1) / rows_per_block), block(32 * rows_per_block);
  cudaStream_t s = (cudaStream_t)stream;
  if (C <= 1024)
    layernorm_kernel<32><<<grid, block, 0, s>>>(x, x_bf16, (const float*)gamma, (const float*)beta, y, y_bf16, M, C,
                                                eps);
  else if (C <= 2048)  // the C=1280 sites of the big-C form
    layernorm_kernel<64><<<grid, block, 0, s>>>(x, x_bf16, (const float*)gamma, (const float*)beta, y, y_bf16, M, C,
                                                eps);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// act: 0 none, 1 gelu, 2 geglu (Nout = N / 2, N % 64 == 0, rows packed);
// steps: 0 round once, 1 round at the TPU kernel's points (gemm.cuh).
MVDF_API int mvdf_gemm(const void* A, const void* W, const void* bias, void* out, int out_bf16, const void* res1,
                       int res1_bf16, const void* res2, int res2_bf16, int res2_div, const void* gate, int act,
                       int steps, int M, int N, int K, int dtype, void* stream) {
  Epilogue e;
  e.bias = (const float*)bias;
  e.out = out;
  e.out_bf16 = out_bf16;
  e.res1 = res1;
  e.res1_bf16 = res1_bf16;
  e.res2 = res2;
  e.res2_bf16 = res2_bf16;
  e.res2_div = res2_div > 0 ? res2_div : 1;
  e.gate = (const float*)gate;
  e.act = act;
  e.steps = steps;
  e.M = M;
  e.Nout = act == ACT_GEGLU ? N / 2 : N;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == DT_BF16) {
    if (K % 8) return (int)cudaErrorInvalidValue;
    gemm_kernel<bf16><<<grid, 128, 0, s>>>((const bf16*)A, (const bf16*)W, N, K, e);
  } else {
    gemm_kernel<float><<<grid, 128, 0, s>>>((const float*)A, (const float*)W, N, K, e);
  }
  return (int)cudaGetLastError();
}
