// K1 and K7: GroupNorm(32) (+SiLU) over channels-last (B, N, C) activations.
//
// K1 replaces mvdfusion_tpu/ops/groupnorm.py::_gn_kernel (called from
// _gn_fwd_impl). Bound on the H100: bytes — about 10 flops per element
// against 2 bytes read and 2 written (bf16), far below the ~295 flop/byte
// ridge. Design: one block per (group, batch) walks its (N, C/G) slice twice
// (fp32 sum and sum of squares, then normalise + affine + SiLU); the second
// read of a slice of at most 2^20/32 elements is served from L2, so device
// memory sees one read and one write per element. The TPU kernel's (C, G)
// segment-matrix products exist only for Mosaic's lane layout and are gone.
//
// K7 replaces the reference's tiled form for larger maps, _gn_tiled_impl:
// _gn_stats_kernel and _gn_apply_kernel. Bound by bytes as K1 (two reads and
// one write of x, a few flops per element). The TPU kernel carries its
// per-channel sums across sequential grid steps; here the row tiles run in
// parallel blocks, each writes its partial sums, and a second small kernel
// adds the partials of a (batch, channel) in tile order, so the sums are the
// same on every run (no float atomics). That kernel also does the (B, G)
// fold, which the reference computes in XLA between its two kernels, so the
// stats pass is two launches and no host work. The apply pass reads 16 bytes
// a thread where C allows. The stats pass also serves conv3x3's
// gn_fold_affine, with the variance unclamped as there.
#include <algorithm>

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

// K7 pass 1: per-channel fp32 sums over the row tile blockIdx.x of batch
// element blockIdx.y: 64 channels x 4 row lanes a step, the row lanes added in
// a fixed order. part[b][tile] = [sum; sum of squares] (2, C).
template <typename T>
__global__ void __launch_bounds__(256) gn_stats_partial_kernel(const T* __restrict__ x, float* __restrict__ part,
                                                               int N, int C, int rows) {
  __shared__ float s1s[4][64], s2s[4][64];
  const int tile = blockIdx.x, b = blockIdx.y;
  const int lc = threadIdx.x & 63, lr = threadIdx.x >> 6;
  const int r0 = tile * rows, r1 = min(N, r0 + rows);
  const T* xb = x + (int64_t)b * N * C;
  float* pb = part + ((int64_t)b * gridDim.x + tile) * 2 * C;
  for (int c0 = 0; c0 < C; c0 += 64) {
    const int c = c0 + lc;
    float s1 = 0.0f, s2 = 0.0f;
    if (c < C) {
#pragma unroll 4
      for (int r = r0 + lr; r < r1; r += 4) {
        const float v = to_f(xb[(int64_t)r * C + c]);
        s1 += v;
        s2 += v * v;
      }
    }
    s1s[lr][lc] = s1;
    s2s[lr][lc] = s2;
    __syncthreads();
    if (lr == 0 && c < C) {
      pb[c] = ((s1s[0][lc] + s1s[1][lc]) + s1s[2][lc]) + s1s[3][lc];
      pb[C + c] = ((s2s[0][lc] + s2s[1][lc]) + s2s[2][lc]) + s2s[3][lc];
    }
    __syncthreads();
  }
}

// K7 pass 1b: the fold. One block per batch element sums part[b][tile] over
// the tiles in order, then each channel's group (its C/G channels in order),
// and writes the folded affine, two contiguous (B, C) arrays: a = rstd * gamma,
// sh = beta - mu * a, rstd = rsqrt(E[x^2] - mu^2 + eps), the variance clamped
// at 0 where `clamp` (the tiled GroupNorm) and not for conv3x3's fold.
__global__ void __launch_bounds__(256) gn_fold_kernel(const float* __restrict__ part,
                                                      const float* __restrict__ gamma,
                                                      const float* __restrict__ beta, float* __restrict__ a_out,
                                                      float* __restrict__ sh_out, int tiles, int N, int C, int G, float eps, int clamp) {
  extern __shared__ float sums[];  // [sum; sum of squares] (2, C)
  const int b = blockIdx.x;
  const float* pb = part + (int64_t)b * tiles * 2 * C;
  for (int i = threadIdx.x; i < 2 * C; i += blockDim.x) {
    float s = 0.0f;
#pragma unroll 8
    for (int t = 0; t < tiles; ++t) s += pb[(int64_t)t * 2 * C + i];
    sums[i] = s;
  }
  __syncthreads();
  const int cg = C / G;
  const float cnt = (float)N * (float)cg;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const int c0 = (c / cg) * cg;
    float s1 = 0.0f, s2 = 0.0f;
    for (int k = 0; k < cg; ++k) {
      s1 += sums[c0 + k];
      s2 += sums[C + c0 + k];
    }
    const float mu = s1 / cnt;
    float var = s2 / cnt - mu * mu;
    if (clamp) var = fmaxf(var, 0.0f);
    const float a = rsqrtf(var + eps) * gamma[c];
    a_out[(int64_t)b * C + c] = a;
    sh_out[(int64_t)b * C + c] = beta[c] - mu * a;
  }
}

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

// K7 pass 2: y = x*a + b (+SiLU), a and b (B, C) fp32; VEC elements a thread
// (C % VEC == 0, so a pack never leaves its row).
template <typename T, int VEC>
__global__ void __launch_bounds__(256) gn_apply_kernel(const T* __restrict__ x, const float* __restrict__ a,
                                                       const float* __restrict__ bsh, T* __restrict__ y,
                                                       int64_t NC, int C, int64_t packs, int silu) {
  for (int64_t p = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; p < packs;
       p += (int64_t)gridDim.x * blockDim.x) {
    const int64_t e = p * VEC;
    const int64_t bc = (e / NC) * C + (int)(e % C);
    const Pack<T, VEC> in = reinterpret_cast<const Pack<T, VEC>*>(x)[p];
    Pack<T, VEC> out;
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      float v = to_f(in.v[k]) * a[bc + k] + bsh[bc + k];
      if (silu) v = v / (1.0f + expf(-v));
      out.v[k] = from_f<T>(v);
    }
    reinterpret_cast<Pack<T, VEC>*>(y)[p] = out;
  }
}

template <typename T>
int gn_stats(const void* x, void* part, const void* gamma, const void* beta, void* a, void* sh, int B, int N, int C,
             int G, int rows, float eps, int clamp, cudaStream_t s) {
  const int tiles = (N + rows - 1) / rows;
  gn_stats_partial_kernel<T><<<dim3(tiles, B), 256, 0, s>>>((const T*)x, (float*)part, N, C, rows);
  gn_fold_kernel<<<B, 256, 2 * C * sizeof(float), s>>>((const float*)part, (const float*)gamma, (const float*)beta,
                                                       (float*)a, (float*)sh, tiles, N, C, G, eps, clamp);
  return (int)cudaGetLastError();
}

template <typename T, int VEC>
int gn_apply(const void* x, const void* a, const void* b, void* y, int B, int N, int C, int silu, cudaStream_t s) {
  const int64_t packs = (int64_t)B * N * C / VEC;
  const int64_t blocks = std::min<int64_t>((packs + 255) / 256, 132 * 32);
  gn_apply_kernel<T, VEC><<<(int)blocks, 256, 0, s>>>((const T*)x, (const float*)a, (const float*)b, (T*)y,
                                                      (int64_t)N * C, C, packs, silu);
  return (int)cudaGetLastError();
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

MVDF_API int mvdf_gn_stats(const void* x, void* part, const void* gamma, const void* beta, void* a, void* sh, int B,
                           int N, int C, int G, int rows, float eps, int clamp, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return dtype == DT_BF16 ? gn_stats<bf16>(x, part, gamma, beta, a, sh, B, N, C, G, rows, eps, clamp, s)
                          : gn_stats<float>(x, part, gamma, beta, a, sh, B, N, C, G, rows, eps, clamp, s);
}

MVDF_API int mvdf_gn_apply(const void* x, const void* a, const void* b, void* y, int B, int N, int C, int silu,
                           int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const bool aligned = (((uintptr_t)x | (uintptr_t)y) & 15) == 0;
  if (dtype == DT_BF16)
    return aligned && C % 8 == 0 ? gn_apply<bf16, 8>(x, a, b, y, B, N, C, silu, s)
                                 : gn_apply<bf16, 1>(x, a, b, y, B, N, C, silu, s);
  return aligned && C % 4 == 0 ? gn_apply<float, 4>(x, a, b, y, B, N, C, silu, s)
                               : gn_apply<float, 1>(x, a, b, y, B, N, C, silu, s);
}

MVDF_API const char* mvdf_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }
