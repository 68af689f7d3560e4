// Device building blocks of the transformer-site kernels: the GEMM epilogue,
// one 64x64 output tile of a GEMM (bf16 on the tensor cores, fp32 on the
// CUDA cores) and a LayerNorm row. The standalone kernels of block.cu launch
// them one tile or row per block; the one-kernel site (blockforms.cu) walks
// its tiles in grid-stride loops. Every tile function runs on 128 threads.
//
// No pointer here is __restrict__: the one-kernel site reads buffers that
// earlier phases of the same launch wrote, which the read-only data path
// would not see.
#pragma once

#include <mma.h>

#include "common.cuh"

namespace mvdf {

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
  // 0: the epilogue's terms are summed in fp32 and rounded once. 1: rounded
  // to the output type where the TPU kernels' bf16 operations round: after
  // the bias, after each residual add, and in GEGLU at each factor.
  int steps;
  int M, Nout;
};

constexpr int BM = 64, BN = 64;
constexpr int BK_TC = 32, LDS_TC = BK_TC + 8, LDC = BN + 4;
constexpr int BK_F = 16;
// bf16 tile: A and W stages (64 x 40 bf16 each) + the fp32 (64 x 68) tile;
// the fp32 tile's (16 x 68) stages fit the same bytes
constexpr int GEMM_SMEM_BYTES = 2 * BM * LDS_TC * 2 + BM * LDC * 4;

__device__ __forceinline__ float round_to(float v, int bf16) {
  return bf16 ? __bfloat162float(__float2bfloat16(v)) : v;
}

__device__ __forceinline__ void finish(const Epilogue& e, int row, int col, float v) {
  const int r = e.steps & e.out_bf16;
  if (e.gate) v *= e.gate[col];
  const int64_t i = (int64_t)row * e.Nout + col;
  if (e.res1) v = round_to(v, r) + load_any(e.res1, i, e.res1_bf16);
  if (e.res2) v = round_to(v, r) + load_any(e.res2, (int64_t)(row / e.res2_div) * e.Nout + col, e.res2_bf16);
  store_any(e.out, i, v, e.out_bf16);
}

// ops/crossview.py::_gelu in the output type: (x * 0.5) * (1 + erf(x / sqrt 2)),
// the second factor rounded, the product rounded
__device__ __forceinline__ float gelu_steps(float g, int r) {
  return round_to(round_to(g * 0.5f, r) * round_to(1.0f + erff(g * 0.70710678118654752440f), r), r);
}

// Cs: the block's (BM, BN) fp32 accumulator tile in shared memory.
__device__ __forceinline__ void tile_epilogue(const float* Cs, int ldc, int m0, int n0, const Epilogue& e) {
  const int r = e.steps & e.out_bf16;
  if (e.act == ACT_GEGLU) {
    const int half = BN / 2;
    for (int idx = threadIdx.x; idx < BM * half; idx += blockDim.x) {
      const int rr = idx / half, j = idx - rr * half;
      const int row = m0 + rr, col = n0 / 2 + j;
      if (row < e.M && col < e.Nout) {
        float a = Cs[rr * ldc + j], g = Cs[rr * ldc + j + half];
        if (e.bias) {
          a += e.bias[n0 + j];
          g += e.bias[n0 + j + half];
        }
        finish(e, row, col, e.steps ? round_to(a, r) * gelu_steps(round_to(g, r), r) : a * gelu_erf(g));
      }
    }
  } else {
    for (int idx = threadIdx.x; idx < BM * BN; idx += blockDim.x) {
      const int rr = idx / BN, j = idx - rr * BN;
      const int row = m0 + rr, col = n0 + j;
      if (row < e.M && col < e.Nout) {
        float v = Cs[rr * ldc + j];
        if (e.bias) v += e.bias[col];
        if (e.act == ACT_GELU) v = gelu_erf(v);
        finish(e, row, col, v);
      }
    }
  }
}

// out tile (m0, n0) of epilogue(A[M, K] @ W[N, K]^T), bf16 operands on the
// tensor cores: 4 warps, each a 32x32 quarter of the 64x64 tile as 2x2 wmma
// fragments; K in steps of 32 (K % 8 == 0, 16-byte aligned rows).
__device__ __forceinline__ void gemm_tile(const bf16* A, const bf16* W, int N, int K, const Epilogue& e, int m0,
                                          int n0, unsigned char* smem) {
  using namespace nvcuda;
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = As + BM * LDS_TC;
  float* Cs = reinterpret_cast<float*>(smem + 2 * BM * LDS_TC * 2);
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
      if (m0 + r < e.M && k0 + c < K) va = *reinterpret_cast<const uint4*>(A + (int64_t)(m0 + r) * K + k0 + c);
      if (n0 + r < N && k0 + c < K) vb = *reinterpret_cast<const uint4*>(W + (int64_t)(n0 + r) * K + k0 + c);
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
  __syncthreads();  // Cs is read before the caller's next tile writes the stages
}

// the same tile with fp32 operands on the CUDA cores: 4x8 outputs a thread,
// K in steps of 16
__device__ __forceinline__ void gemm_tile(const float* A, const float* W, int N, int K, const Epilogue& e, int m0,
                                          int n0, unsigned char* smem) {
  float(*As)[BM + 4] = reinterpret_cast<float(*)[BM + 4]>(smem);
  float(*Bs)[BN + 4] = reinterpret_cast<float(*)[BN + 4]>(smem + BK_F * (BM + 4) * 4);
  float* Cs = reinterpret_cast<float*>(smem + 2 * BM * LDS_TC * 2);
  const int tx = threadIdx.x & 7, ty = threadIdx.x >> 3;
  float acc[4][8] = {};
  for (int k0 = 0; k0 < K; k0 += BK_F) {
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const int idx = threadIdx.x + t * 128;
      const int r = idx >> 4, c = idx & 15;
      As[c][r] = (m0 + r < e.M && k0 + c < K) ? A[(int64_t)(m0 + r) * K + k0 + c] : 0.0f;
      Bs[c][r] = (n0 + r < N && k0 + c < K) ? W[(int64_t)(n0 + r) * K + k0 + c] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK_F; ++kk) {
      float a[4], b[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = Bs[kk][tx * 8 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] += a[i] * b[j];
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) Cs[(ty * 4 + i) * LDC + tx * 8 + j] = acc[i][j];
  __syncthreads();
  tile_epilogue(Cs, LDC, m0, n0, e);
  __syncthreads();
}

// y = (x - mean) / sqrt(var + eps) * gamma + beta over one row of
// C <= 32 PL by one warp, two-pass fp32 statistics; gamma/beta fp32
// (nullable).
template <int PL>
__device__ __forceinline__ void layernorm_row(const void* x, int x_bf16, const float* gamma, const float* beta,
                                              void* y, int y_bf16, int64_t row, int C, float eps) {
  const int lane = threadIdx.x & 31;
  float vals[PL];
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < PL; ++i) {
    const int c = lane + 32 * i;
    vals[i] = (c < C) ? load_any(x, row * C + c, x_bf16) : 0.0f;
    s += vals[i];
  }
  const float mean = warp_sum(s) / (float)C;
  float s2 = 0.0f;
#pragma unroll
  for (int i = 0; i < PL; ++i) {
    const int c = lane + 32 * i;
    const float d = (c < C) ? vals[i] - mean : 0.0f;
    s2 += d * d;
  }
  const float rstd = rsqrtf(warp_sum(s2) / (float)C + eps);
#pragma unroll
  for (int i = 0; i < PL; ++i) {
    const int c = lane + 32 * i;
    if (c < C) {
      float v = (vals[i] - mean) * rstd;
      if (gamma) v *= gamma[c];
      if (beta) v += beta[c];
      store_any(y, row * C + c, v, y_bf16);
    }
  }
}

}  // namespace mvdf
