// K1: GroupNorm(32) (+SiLU) over channels-last (B, N, C) activations.
//
// Replaces mvdfusion_tpu/ops/groupnorm.py::_gn_kernel (called from
// _gn_fwd_impl). Bound on the H100: bytes — about 10 flops per element
// against 2 bytes read and 2 written (bf16), far below the ~295 flop/byte
// ridge. Design: one block per (group, batch) walks its (N, C/G) slice twice
// (fp32 sum and sum of squares, then normalise + affine + SiLU); the second
// read of a slice of at most 2^20/32 elements is served from L2, so device
// memory sees one read and one write per element. The TPU kernel's (C, G)
// segment-matrix products exist only for Mosaic's lane layout and are gone.
#include "common.cuh"

namespace mvdf {

template <typename T>
__global__ void __launch_bounds__(256) gn_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                                                 const float* __restrict__ beta, T* __restrict__ y, int N,
                                                 int C, int G, float eps, int silu) {
  __shared__ float scratch[32];
  const int g = blockIdx.x, b = blockIdx.y;
  const int cg = C / G;
  const int64_t base = (int64_t)b * N * C + (int64_t)g * cg;
  const int64_t count = (int64_t)N * cg;
  float s1 = 0.0f, s2 = 0.0f;
  for (int64_t e = threadIdx.x; e < count; e += blockDim.x) {
    const int64_t r = e / cg;
    const int c = (int)(e - r * cg);
    const float v = to_f(x[base + r * C + c]);
    s1 += v;
    s2 += v * v;
  }
  s1 = block_sum(s1, scratch);
  s2 = block_sum(s2, scratch);
  const float mean = s1 / (float)count;
  // E[x^2] - E[x]^2 clamped at 0, as the reference
  const float var = fmaxf(s2 / (float)count - mean * mean, 0.0f);
  const float rstd = rsqrtf(var + eps);
  for (int64_t e = threadIdx.x; e < count; e += blockDim.x) {
    const int64_t r = e / cg;
    const int c = (int)(e - r * cg);
    const int ch = g * cg + c;
    float v = (to_f(x[base + r * C + c]) - mean) * (rstd * gamma[ch]) + beta[ch];
    if (silu) v = v / (1.0f + expf(-v));
    y[base + r * C + c] = from_f<T>(v);
  }
}

}  // namespace mvdf

using namespace mvdf;

MVDF_API int mvdf_groupnorm(const void* x, const void* gamma, const void* beta, void* y, int B, int N, int C,
                            int G, float eps, int silu, int dtype, void* stream) {
  dim3 grid(G, B);
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == DT_BF16)
    gn_kernel<bf16><<<grid, 256, 0, s>>>((const bf16*)x, (const float*)gamma, (const float*)beta, (bf16*)y, N,
                                         C, G, eps, silu);
  else
    gn_kernel<float><<<grid, 256, 0, s>>>((const float*)x, (const float*)gamma, (const float*)beta, (float*)y,
                                          N, C, G, eps, silu);
  return (int)cudaGetLastError();
}

MVDF_API const char* mvdf_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }
