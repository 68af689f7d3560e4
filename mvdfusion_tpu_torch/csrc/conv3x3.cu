// K8: the VAE ResBlock's fused GroupNorm affine + SiLU + 3x3 SAME conv, with
// its epilogue (+ bias + a per-batch row, optional + residual), over
// channels-last (B, H, W, C) maps.
//
// Replaces mvdfusion_tpu/ops/conv3x3.py::_conv_kernel (called from _fwd_impl;
// its statistics pass, gn_fold_affine, is groupnorm.cu's K7 stats pass).
// Bound on the H100: operations. An implicit GEMM with M = B*H*W output
// pixels, N = Cout, K = 9*Cin: 2*M*N*K flops against one read of x and one
// write of y, e.g. (8, 256, 256, 256 -> 128) is 309 GFLOP and 403 MB, far
// above the ~295 flop/byte ridge.
//
// Design. A block computes 128 output pixels (TR image rows x TX columns, TX
// the largest of 128, 64, 32, 16 that W reaches) by 64 output channels. For
// each 32-channel slice of Cin it stages the rows y0-1 .. y0+TR and columns
// x0-1 .. x0+TX of the map in shared memory with the prologue applied once per
// staged element, s = silu(x*a + b) rounded to the compute type, and zeroes
// the positions outside the image after the SiLU (the SAME padding pads the
// conv's input silu(x*a + b), and silu(b) != 0, so padding x would be wrong);
// columns are addressed by (row, column), so no wrapped x-edge tap exists to
// mask. It also stages the nine taps' (32, 64) weight slices. The nine taps
// then read shifted views of the staged tile: bf16 operands on the tensor
// cores (wmma 16x16x16, 8 warps each a 32x32 quarter of the 128x64 tile) with
// fp32 sums; fp32 operands in full fp32 on the CUDA cores (no TF32). The
// epilogue adds bias + row[b] (+ res) in fp32 and rounds once. The TPU
// kernel's flat token tiles with a (W + 8)-token halo and iota masks exist for
// Mosaic's layout and its DMA alignment and are gone. No pipelining, no
// wgmma/TMA yet: a simple kernel first.
#include <mma.h>

#include <type_traits>

#include "common.cuh"

namespace mvdf {
namespace conv {

constexpr int THREADS = 256;
constexpr int BMP = 128;  // output pixels a block
constexpr int BNC = 64;   // output channels a block
constexpr int BK = 32;    // input channels a stage
// the staged tile's pixels at most: (TR + 2) x (TX + 2) over TX in {16, 32, 64, 128}
constexpr int MAX_STAGE_PIX = 3 * (128 + 2);
constexpr int LDC = BNC + 4;

template <typename T>
struct Cfg {
  static constexpr bool TC = std::is_same<T, bf16>::value;
  // bf16: 48 elements (96 bytes) a staged pixel and 72 (144 bytes) a weight
  // row, so every wmma fragment starts 32-byte aligned; fp32: padded rows
  static constexpr int LDA = TC ? BK + 16 : BK + 1;
  static constexpr int LDB = TC ? BNC + 8 : BNC;
  static constexpr int STAGE_BYTES = (MAX_STAGE_PIX * LDA * (int)sizeof(T) + 127) / 128 * 128;
  static constexpr int SMEM_BYTES = STAGE_BYTES + 9 * BK * LDB * (int)sizeof(T);
};

}  // namespace conv

template <typename T>
__global__ void __launch_bounds__(conv::THREADS)
    conv3x3_kernel(const T* __restrict__ x, const float* __restrict__ a, const float* __restrict__ bsh,
                   const T* __restrict__ w9, const float* __restrict__ bias, const float* __restrict__ row,
                   const T* __restrict__ res, T* __restrict__ y, int H, int W, int Cin, int Cout, int TX,
                   int silu) {
  using namespace conv;
  using C = Cfg<T>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* As = reinterpret_cast<T*>(smem);
  T* Ws = reinterpret_cast<T*>(smem + C::STAGE_BYTES);
  constexpr int LDA = C::LDA, LDB = C::LDB;

  const int TR = BMP / TX, SW = TX + 2, SP = (TR + 2) * SW;
  const int nN = (Cout + BNC - 1) / BNC;
  const int n0 = (blockIdx.x % nN) * BNC;
  const int x0 = (blockIdx.x / nN) * TX;
  const int y0 = blockIdx.y * TR;
  const int b = blockIdx.z;
  const float* ab = a + (int64_t)b * Cin;
  const float* bb = bsh + (int64_t)b * Cin;
  const T* xb = x + (int64_t)b * H * W * Cin;
  const int warp = threadIdx.x >> 5;

  // staged offset of each output pixel's tap (0, 0): tile pixel m sits at
  // staged row m / TX + 1, column m % TX + 1
  using namespace nvcuda;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc_tc[2][2];
  float acc_f[4][8];
  int abase[4];
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;  // tensor-core warp tile
  const int tx = threadIdx.x & 7, ty = threadIdx.x >> 3;  // fp32: 4 pixels x 8 channels a thread
  if constexpr (C::TC) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int m = wm + i * 16;  // 16 | TX: a fragment's 16 pixels share one staged row
      abase[i] = ((m / TX + 1) * SW + m % TX + 1) * LDA;
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc_tc[i][j], 0.0f);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = ty * 4 + i;
      abase[i] = ((m / TX + 1) * SW + m % TX + 1) * LDA;
#pragma unroll
      for (int j = 0; j < 8; ++j) acc_f[i][j] = 0.0f;
    }
  }

  for (int c0 = 0; c0 < Cin; c0 += BK) {
    // prologue, once per staged element
    for (int i = threadIdx.x; i < SP * BK; i += THREADS) {
      const int p = i / BK, k = i - p * BK;
      const int sr = p / SW, sc = p - sr * SW;
      const int gy = y0 - 1 + sr, gx = x0 - 1 + sc, c = c0 + k;
      float v = 0.0f;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W && c < Cin) {
        v = to_f(xb[((int64_t)gy * W + gx) * Cin + c]) * ab[c] + bb[c];
        if (silu) v = v / (1.0f + expf(-v));
      }
      As[p * LDA + k] = from_f<T>(v);
    }
    // the nine taps' weight slices: Ws[tap * BK + k][n] = w9[tap * Cin + c0 + k][n0 + n]
    if constexpr (C::TC) {
      for (int i = threadIdx.x; i < 9 * BK * (BNC / 8); i += THREADS) {
        const int r = i / (BNC / 8), cv = (i - r * (BNC / 8)) * 8;
        const int tap = r / BK, k = r - tap * BK;
        uint4 v = make_uint4(0, 0, 0, 0);
        if (c0 + k < Cin && n0 + cv < Cout)
          v = *reinterpret_cast<const uint4*>(w9 + ((int64_t)tap * Cin + c0 + k) * Cout + n0 + cv);
        *reinterpret_cast<uint4*>(Ws + r * LDB + cv) = v;
      }
    } else {
      for (int i = threadIdx.x; i < 9 * BK * BNC; i += THREADS) {
        const int r = i / BNC, n = i - r * BNC;
        const int tap = r / BK, k = r - tap * BK;
        Ws[r * LDB + n] =
            (c0 + k < Cin && n0 + n < Cout) ? w9[((int64_t)tap * Cin + c0 + k) * Cout + n0 + n] : from_f<T>(0.0f);
      }
    }
    __syncthreads();
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int off = ((tap / 3 - 1) * SW + (tap % 3 - 1)) * LDA;
      const T* wt = Ws + tap * BK * LDB;
      if constexpr (C::TC) {
#pragma unroll
        for (int kk = 0; kk < BK; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[2];
#pragma unroll
          for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(fa[i], As + abase[i] + off + kk, LDA);
#pragma unroll
          for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(fb[j], wt + kk * LDB + wn + j * 16, LDB);
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 2; ++j) wmma::mma_sync(acc_tc[i][j], fa[i], fb[j], acc_tc[i][j]);
        }
      } else {
#pragma unroll 4
        for (int k = 0; k < BK; ++k) {
          float av[4], bv[8];
#pragma unroll
          for (int i = 0; i < 4; ++i) av[i] = to_f(As[abase[i] + off + k]);
#pragma unroll
          for (int j = 0; j < 8; ++j) bv[j] = to_f(wt[k * LDB + tx * 8 + j]);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) acc_f[i][j] = fmaf(av[i], bv[j], acc_f[i][j]);
        }
      }
    }
    __syncthreads();
  }

  // epilogue: + bias + row[b] (+ res) in fp32, rounded once
  auto finish = [&](int m, int n, float v) {
    const int gy = y0 + m / TX, gx = x0 + m % TX, col = n0 + n;
    if (gy < H && gx < W && col < Cout) {
      const int64_t o = (((int64_t)b * H + gy) * W + gx) * Cout + col;
      v += bias[col] + row[(int64_t)b * Cout + col];
      if (res) v += to_f(res[o]);
      y[o] = from_f<T>(v);
    }
  };
  if constexpr (C::TC) {
    float* Cs = reinterpret_cast<float*>(smem);  // the stages are free after the loop's last barrier
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(Cs + (wm + i * 16) * LDC + wn + j * 16, acc_tc[i][j], LDC, wmma::mem_row_major);
    __syncthreads();
    for (int i = threadIdx.x; i < BMP * BNC; i += THREADS) {
      const int m = i / BNC, n = i - m * BNC;
      finish(m, n, Cs[m * LDC + n]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) finish(ty * 4 + i, tx * 8 + j, acc_f[i][j]);
  }
}

template <typename T>
int conv3x3(const void* x, const void* a, const void* b, const void* w9, const void* bias, const void* row,
            const void* res, void* y, int B, int H, int W, int Cin, int Cout, int silu, cudaStream_t s) {
  constexpr int smem = conv::Cfg<T>::SMEM_BYTES;
  const int TX = W >= 128 ? 128 : W >= 64 ? 64 : W >= 32 ? 32 : 16;
  const int TR = conv::BMP / TX;
  const int nN = (Cout + conv::BNC - 1) / conv::BNC;
  const dim3 grid(((W + TX - 1) / TX) * nN, (H + TR - 1) / TR, B);
  cudaError_t e = cudaFuncSetAttribute(conv3x3_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  conv3x3_kernel<T><<<grid, conv::THREADS, smem, s>>>((const T*)x, (const float*)a, (const float*)b,
                                                      (const T*)w9, (const float*)bias, (const float*)row,
                                                      (const T*)res, (T*)y, H, W, Cin, Cout, TX, silu);
  return (int)cudaGetLastError();
}

}  // namespace mvdf

using namespace mvdf;

MVDF_API int mvdf_conv3x3(const void* x, const void* a, const void* b, const void* w9, const void* bias,
                          const void* row, const void* res, void* y, int B, int H, int W, int Cin, int Cout,
                          int silu, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return dtype == DT_BF16 ? conv3x3<bf16>(x, a, b, w9, bias, row, res, y, B, H, W, Cin, Cout, silu, s)
                          : conv3x3<float>(x, a, b, w9, bias, row, res, y, B, H, W, Cin, Cout, silu, s);
}
