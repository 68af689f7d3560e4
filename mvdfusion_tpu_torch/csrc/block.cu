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
// GELU or GEGLU, a per-column gate, and up to two residual adds in fp32 and
// rounds once, so no intermediate of the site makes an extra round trip.
// GEGLU needs its value and gate columns in one tile: the wrapper packs the
// weight rows so each 64-row tile holds 32 value rows then their 32 gate rows.
#include <mma.h>

#include "common.cuh"

namespace mvdf {

// ---------------------------------------------------------------- LayerNorm
// y = (x - mean) / sqrt(var + eps) * gamma + beta per row of C <= 1024,
// two-pass fp32 statistics; one warp per row. gamma/beta fp32 (nullable).
__global__ void __launch_bounds__(256) layernorm_kernel(const void* __restrict__ x, int x_bf16,
                                                        const float* __restrict__ gamma,
                                                        const float* __restrict__ beta, void* __restrict__ y,
                                                        int y_bf16, int M, int C, float eps) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * (blockDim.x >> 5) + warp;
  if (row >= M) return;
  float vals[32];
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int c = lane + 32 * i;
    vals[i] = (c < C) ? load_any(x, row * C + c, x_bf16) : 0.0f;
    s += vals[i];
  }
  const float mean = warp_sum(s) / (float)C;
  float s2 = 0.0f;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int c = lane + 32 * i;
    const float d = (c < C) ? vals[i] - mean : 0.0f;
    s2 += d * d;
  }
  const float rstd = rsqrtf(warp_sum(s2) / (float)C + eps);
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int c = lane + 32 * i;
    if (c < C) {
      float v = (vals[i] - mean) * rstd;
      if (gamma) v *= gamma[c];
      if (beta) v += beta[c];
      store_any(y, row * C + c, v, y_bf16);
    }
  }
}

// --------------------------------------------------------------------- GEMM
// out[M, Nout] = epilogue(A[M, K] @ W[N, K]^T), W in nn.Linear (out, in) layout.
enum { ACT_NONE = 0, ACT_GELU = 1, ACT_GEGLU = 2 };

struct Epilogue {
  const float* bias;  // (N,) or null
  void* out;
  int out_bf16;
  const void* res1;  // (M, Nout) or null
  int res1_bf16;
  const void* res2;  // (M / res2_div, Nout) or null: row r reads res2[r / res2_div]
  int res2_bf16;
  int res2_div;
  const float* gate;  // (Nout,) or null: v = gate * v before the residuals
  int act;
  int M, Nout;
};

constexpr int BM = 64, BN = 64;

__device__ __forceinline__ void finish(const Epilogue& e, int row, int col, float v) {
  if (e.gate) v *= e.gate[col];
  const int64_t i = (int64_t)row * e.Nout + col;
  if (e.res1) v += load_any(e.res1, i, e.res1_bf16);
  if (e.res2) v += load_any(e.res2, (int64_t)(row / e.res2_div) * e.Nout + col, e.res2_bf16);
  store_any(e.out, i, v, e.out_bf16);
}

// Cs: the block's (BM, BN) fp32 accumulator tile in shared memory.
__device__ __forceinline__ void tile_epilogue(const float* Cs, int ldc, int m0, int n0, const Epilogue& e) {
  if (e.act == ACT_GEGLU) {
    const int half = BN / 2;
    for (int idx = threadIdx.x; idx < BM * half; idx += blockDim.x) {
      const int r = idx / half, j = idx - r * half;
      const int row = m0 + r, col = n0 / 2 + j;
      if (row < e.M && col < e.Nout) {
        float a = Cs[r * ldc + j], g = Cs[r * ldc + j + half];
        if (e.bias) {
          a += e.bias[n0 + j];
          g += e.bias[n0 + j + half];
        }
        finish(e, row, col, a * gelu_erf(g));
      }
    }
  } else {
    for (int idx = threadIdx.x; idx < BM * BN; idx += blockDim.x) {
      const int r = idx / BN, j = idx - r * BN;
      const int row = m0 + r, col = n0 + j;
      if (row < e.M && col < e.Nout) {
        float v = Cs[r * ldc + j];
        if (e.bias) v += e.bias[col];
        if (e.act == ACT_GELU) v = gelu_erf(v);
        finish(e, row, col, v);
      }
    }
  }
}

// bf16 operands on the tensor cores: 4 warps, each a 32x32 quarter of the
// 64x64 tile as 2x2 wmma fragments; K in steps of 32 (K % 8 == 0).
constexpr int BK_TC = 32, LDS_TC = BK_TC + 8, LDC = BN + 4;

__global__ void __launch_bounds__(128) gemm_bf16_kernel(const bf16* __restrict__ A, const bf16* __restrict__ W,
                                                        int N, int K, Epilogue e) {
  using namespace nvcuda;
  __shared__ __align__(32) bf16 As[BM * LDS_TC];
  __shared__ __align__(32) bf16 Bs[BN * LDS_TC];
  __shared__ __align__(32) float Cs[BM * LDC];
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int warp = threadIdx.x >> 5;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int k0 = 0; k0 < K; k0 += BK_TC) {
    // 64 rows x 32 cols of A and of W: 256 16-byte vectors each, 2 per thread
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int vec = threadIdx.x + t * 128;
      const int r = vec >> 2, c = (vec & 3) * 8;
      uint4 va = make_uint4(0, 0, 0, 0), vb = make_uint4(0, 0, 0, 0);
      if (m0 + r < e.M && k0 + c < K)
        va = *reinterpret_cast<const uint4*>(A + (int64_t)(m0 + r) * K + k0 + c);
      if (n0 + r < N && k0 + c < K)
        vb = *reinterpret_cast<const uint4*>(W + (int64_t)(n0 + r) * K + k0 + c);
      *reinterpret_cast<uint4*>(As + r * LDS_TC + c) = va;
      *reinterpret_cast<uint4*>(Bs + r * LDS_TC + c) = vb;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK_TC; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(fa[i], As + (wm + i * 16) * LDS_TC + kk, LDS_TC);
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(fb[j], Bs + (wn + j * 16) * LDS_TC + kk, LDS_TC);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm + i * 16) * LDC + wn + j * 16, acc[i][j], LDC, wmma::mem_row_major);
  __syncthreads();
  tile_epilogue(Cs, LDC, m0, n0, e);
}

// fp32 operands on the CUDA cores: 256 threads, 4x4 outputs each, K steps of 16.
constexpr int BK_F = 16;

__global__ void __launch_bounds__(256) gemm_f32_kernel(const float* __restrict__ A, const float* __restrict__ W,
                                                       int N, int K, Epilogue e) {
  __shared__ float As[BK_F][BM + 4];
  __shared__ float Bs[BK_F][BN + 4];
  __shared__ float Cs[BM * LDC];
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += BK_F) {
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int idx = threadIdx.x + t * 256;
      const int r = idx >> 4, c = idx & 15;
      As[c][r] = (m0 + r < e.M && k0 + c < K) ? A[(int64_t)(m0 + r) * K + k0 + c] : 0.0f;
      Bs[c][r] = (n0 + r < N && k0 + c < K) ? W[(int64_t)(n0 + r) * K + k0 + c] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK_F; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = As[kk][ty * 4 + i];
        b[i] = Bs[kk][tx * 4 + i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * b[j];
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) Cs[(ty * 4 + i) * LDC + tx * 4 + j] = acc[i][j];
  __syncthreads();
  tile_epilogue(Cs, LDC, m0, n0, e);
}

}  // namespace mvdf

using namespace mvdf;

MVDF_API int mvdf_layernorm(const void* x, int x_bf16, const void* gamma, const void* beta, void* y, int y_bf16,
                            int M, int C, float eps, void* stream) {
  if (C > 1024) return (int)cudaErrorInvalidValue;
  const int rows_per_block = 8;
  layernorm_kernel<<<(M + rows_per_block - 1) / rows_per_block, 32 * rows_per_block, 0, (cudaStream_t)stream>>>(
      x, x_bf16, (const float*)gamma, (const float*)beta, y, y_bf16, M, C, eps);
  return (int)cudaGetLastError();
}

// act: 0 none, 1 gelu, 2 geglu (Nout = N / 2, N % 64 == 0, rows packed).
MVDF_API int mvdf_gemm(const void* A, const void* W, const void* bias, void* out, int out_bf16, const void* res1,
                       int res1_bf16, const void* res2, int res2_bf16, int res2_div, const void* gate, int act,
                       int M, int N, int K, int dtype, void* stream) {
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
  e.M = M;
  e.Nout = act == ACT_GEGLU ? N / 2 : N;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == DT_BF16) {
    if (K % 8) return (int)cudaErrorInvalidValue;
    gemm_bf16_kernel<<<grid, 128, 0, s>>>((const bf16*)A, (const bf16*)W, N, K, e);
  } else {
    gemm_f32_kernel<<<grid, 256, 0, s>>>((const float*)A, (const float*)W, N, K, e);
  }
  return (int)cudaGetLastError();
}
