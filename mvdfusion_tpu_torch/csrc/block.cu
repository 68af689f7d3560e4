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
// main path's bf16 products run on gemm_sm90.cu's wgmma kernel; this GEMM
// (warp-level mma, nvcuda::wmma 16x16x16 fragments, fp32 accumulation, 64x64
// block tiles, no TMA, no pipelining) takes fp32 operands and the bf16
// shapes that kernel does not (ops/block.py::gemm_route). The epilogue
// applies bias, exact-erf
// GELU or GEGLU, a per-column gate, and up to two residual adds in fp32, so
// no intermediate of the site makes an extra round trip; it rounds once, or
// (`steps`) where the TPU kernel's bf16 operations round. The tile, the
// epilogue and the LayerNorm row are gemm.cuh's, shared with the one-kernel
// site (blockforms.cu).
// GEGLU needs its value and gate columns in one tile: the wrapper packs the
// weight rows so each 64-row tile holds 32 value rows then their 32 gate rows.
#include "gemm.cuh"

namespace mvdf {

// LayerNorm over rows of C: L lanes a row (ln_row), 256 / L rows a block
template <typename T, int L, int VPL>
__global__ void __launch_bounds__(256) layernorm_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                                                        const float* __restrict__ beta, T* __restrict__ y, int M,
                                                        int C, float eps) {
  const int64_t row = (int64_t)blockIdx.x * (256 / L) + threadIdx.x / L;
  ln_row<T, L, VPL>(x, gamma, beta, y, row, row < M, C, eps);
}

// L lanes of VPL vectors a row: five vectors a lane where C / VEC <= 160
// (C = 320, 640, 1280 in bf16: 8, 16 and 32 lanes, every lane full), ten
// up to 320
template <typename T>
static int layernorm_launch(const void* x, const float* gamma, const float* beta, void* y, int M, int C, float eps,
                            cudaStream_t s) {
  constexpr int VEC = 16 / sizeof(T);
  if (C % VEC || C > 320 * VEC) return (int)cudaErrorInvalidValue;
  const int nv = C / VEC;
  const int L = nv <= 20 ? 4 : nv <= 40 ? 8 : nv <= 80 ? 16 : 32;
  const dim3 grid((M + 256 / L - 1) / (256 / L));
  const T* xt = (const T*)x;
  T* yt = (T*)y;
  if (nv > 160)
    layernorm_kernel<T, 32, 10><<<grid, 256, 0, s>>>(xt, gamma, beta, yt, M, C, eps);
  else if (L == 32)
    layernorm_kernel<T, 32, 5><<<grid, 256, 0, s>>>(xt, gamma, beta, yt, M, C, eps);
  else if (L == 16)
    layernorm_kernel<T, 16, 5><<<grid, 256, 0, s>>>(xt, gamma, beta, yt, M, C, eps);
  else if (L == 8)
    layernorm_kernel<T, 8, 5><<<grid, 256, 0, s>>>(xt, gamma, beta, yt, M, C, eps);
  else
    layernorm_kernel<T, 4, 5><<<grid, 256, 0, s>>>(xt, gamma, beta, yt, M, C, eps);
  return (int)cudaGetLastError();
}

// one 64x64 output tile per block, 128 threads
template <typename T>
__global__ void __launch_bounds__(128) gemm_kernel(const T* A, const T* W, int N, int K, Epilogue e) {
  __shared__ __align__(128) unsigned char smem[GEMM_SMEM_BYTES];
  gemm_tile(A, W, N, K, e, blockIdx.y * BM, blockIdx.x * BN, smem);
}

}  // namespace mvdf

using namespace mvdf;

// x and y (M, C) of one type, 16-byte aligned, C % (16 / sizeof(T)) == 0
MVDF_API int mvdf_layernorm(const void* x, const void* gamma, const void* beta, void* y, int M, int C, float eps,
                            int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return dtype == DT_BF16 ? layernorm_launch<bf16>(x, (const float*)gamma, (const float*)beta, y, M, C, eps, s)
                          : layernorm_launch<float>(x, (const float*)gamma, (const float*)beta, y, M, C, eps, s);
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
