// K8: the VAE ResBlock's fused GroupNorm affine + SiLU + 3x3 SAME conv, with
// its epilogue (+ bias + a per-batch row, optional + residual), over
// channels-last (B, H, W, C) maps.
//
// Replaces mvdfusion_tpu/ops/conv3x3.py::_conv_kernel (:230, called from
// _fwd_impl, :95; its statistics pass, gn_fold_affine, is groupnorm.cu's K7
// stats pass).
// Bound on the H100: operations. An implicit GEMM with M = B*H*W output
// pixels, N = Cout, K = 9*Cin: 2*M*N*K flops against one read of x and one
// write of y, e.g. (8, 256, 256, 256 -> 128) is 309 GFLOP and 403 MB (0.31
// ms at 989 TFLOP/s), far above the ~295 flop/byte ridge.
//
// Design, bf16 (conv_mma_kernel). A block of 16 warps computes 256 output
// pixels (TR image rows x TX columns: 4 x 64 where W >= 64, else 8 x 32 or
// 16 x 16) by 128 output channels, each warp a 32 x 64 sum tile in fp32
// registers. So the decoder's Cout = 128 convs take one column tile and
// prologue each staged element once a block, and the halo costs (TR + 2)(TX
// + 2) / 256 = 1.55 staged pixels an output pixel, where one 128-column row
// cost 3.05. Cin goes in 16-channel slices through two-stage rings in
// shared memory (142 KB, one block an SM) of the nine taps' (16, 128) weight
// rows, the raw x of the slice's (TR + 2) x (TX + 2) window and its operand
// window, filled by 16-byte cp.async copies. While the nine taps of slice sl
// run as mma.sync m16n8k16 (bf16 operands, fp32 sums) on the tensor cores,
// the same warps turn slice sl + 1's raw window into its operand window, a
// 16-byte unit after every third tap, so the prologue's CUDA-core work
// overlaps the products inside each warp; and the copies of slice sl + 1's
// weights and slice sl + 2's raw window are in flight. The prologue is s =
// silu(x*a + b) in fp32 with the reference's expf arithmetic, rounded to
// bf16, zero outside the image (the SAME padding pads the conv's input
// silu(x*a + b), and silu(b) != 0). ldmatrix takes one address a row, so a
// tap's shifted view (dy, dx) of the operand window is an A fragment read at
// shifted row addresses, and the weights, stored k-major, are read
// transposed into B fragments; rows of 48 and 272 bytes keep ldmatrix's
// eight rows in eight bank groups. The epilogue adds bias + row[b] (+ res)
// in fp32 and rounds once. mma.sync rather than wgmma: see attention.cu.
// The TPU kernel's flat token tiles with a (W + 8)-token halo and iota masks
// existed for Mosaic's layout and DMA alignment and are gone.
//
// fp32 operands (conv_f32_kernel): 128 pixels x 64 channels a block on the
// CUDA cores in full fp32 (no TF32), one 32-channel slice at a time,
// un-pipelined.
#include "common.cuh"

namespace mvdf {
namespace conv {

// the staged window's pixels at most, (TR + 2) x (TX + 2) over TX in {16, 32,
// 64} for a tile of `pix` output pixels (TX = 64 is the largest)
__host__ __device__ constexpr int stage_pix(int pix) { return (pix / 64 + 2) * 66; }

// bf16 tensor-core tiles: 8 warps along the pixels (32 each) x 2 along the
// output channels (64 each)
constexpr int M_THREADS = 512;
constexpr int M_PIX = 256;       // output pixels a block
constexpr int M_STAGE = stage_pix(M_PIX);
constexpr int BN = 128;          // output channels a block
constexpr int BK = 16;           // input channels a slice
constexpr int LDA = BK + 8;      // staged operand pixel: 24 elements, 48 bytes
constexpr int LDB = BN + 8;      // staged weight row: 136 elements, 272 bytes
constexpr int W_BYTES = 9 * BK * LDB * 2;
constexpr int RAW_BYTES = M_STAGE * BK * 2;
// two stages each of weights, raw windows and operand windows: 141,696 bytes
constexpr int M_SMEM_BYTES = 2 * (W_BYTES + RAW_BYTES + M_STAGE * LDA * 2);

// fp32 CUDA-core tiles: 128 pixels x 64 channels, 256 threads
constexpr int F_THREADS = 256;
constexpr int F_PIX = 128;
constexpr int F_STAGE = stage_pix(F_PIX);
constexpr int F_BNC = 64;
constexpr int F_BK = 32;
constexpr int F_LDA = F_BK + 1;
constexpr int F_SMEM_BYTES = (F_STAGE * F_LDA + 9 * F_BK * F_BNC) * 4;

__host__ __device__ constexpr int tile_cols(int W) { return W >= 64 ? 64 : W >= 32 ? 32 : 16; }

}  // namespace conv

__global__ void __launch_bounds__(conv::M_THREADS, 1)
    conv_mma_kernel(const bf16* __restrict__ x, const float* __restrict__ a, const float* __restrict__ bsh,
                    const bf16* __restrict__ w9, const float* __restrict__ bias, const float* __restrict__ row,
                    const bf16* __restrict__ res, bf16* __restrict__ y, int H, int W, int Cin, int Cout, int TX,
                    int silu) {
  using namespace conv;
  constexpr int THREADS = M_THREADS, BMP = M_PIX;
  extern __shared__ __align__(128) unsigned char smem[];

  const int TR = BMP / TX, SW = TX + 2, SP = (TR + 2) * SW;
  const int nN = (Cout + BN - 1) / BN;
  const int n0 = (blockIdx.x % nN) * BN;
  const int x0 = (blockIdx.x / nN) * TX;
  const int y0 = blockIdx.y * TR;
  const int b = blockIdx.z;
  const float* ab = a + (int64_t)b * Cin;
  const float* bb = bsh + (int64_t)b * Cin;
  const bf16* xb = x + (int64_t)b * H * W * Cin;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, r = lane >> 2, c = lane & 3;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 64;  // the warp's 32 x 64 sum tile

  // this thread's 16-byte units of the staged window: unit i = tid + j *
  // THREADS is pixel i / 2, channels 8 * (i % 2) .. + 7 of the slice (the
  // same half for every unit of a thread, THREADS being even); gofs is the
  // unit's offset in x's image at slice 0, or -1 outside the image
  constexpr int NU = (M_STAGE * 2 + THREADS - 1) / THREADS;
  const int half = (tid & 1) * 8;
  int upix[NU], gofs[NU];
#pragma unroll
  for (int j = 0; j < NU; ++j) {
    const int p = (tid + j * THREADS) >> 1;
    const int sr = p / SW, sc = p - sr * SW, gy = y0 - 1 + sr, gx = x0 - 1 + sc;
    upix[j] = p < SP ? p : -1;
    gofs[j] = gy >= 0 && gy < H && gx >= 0 && gx < W ? (gy * W + gx) * Cin + half : -1;
  }
  bf16* wsm = reinterpret_cast<bf16*>(smem);                     // [2][9 * BK][LDB]
  bf16* raws = reinterpret_cast<bf16*>(smem + 2 * W_BYTES);      // [2][M_STAGE][BK]
  bf16* acts = reinterpret_cast<bf16*>(smem + 2 * W_BYTES + 2 * RAW_BYTES);  // [2][M_STAGE][LDA]

  // the nine taps' (16, 128) weight rows of slice sl -> wsm[buf]
  auto stage_w = [&](int sl, int buf) {
    const int c0 = sl * BK, cv = (tid & 15) * 8;
    for (int rr = tid >> 4; rr < 9 * BK; rr += THREADS / 16) {
      const int tap = rr / BK, k = rr % BK;
      const bool ok = c0 + k < Cin && n0 + cv < Cout;
      cp_async16(wsm + (buf * 9 * BK + rr) * LDB + cv, ok ? w9 + ((int64_t)tap * Cin + c0 + k) * Cout + n0 + cv : w9,
                 ok);
    }
  };
  // the raw x of slice sl's window -> raws[buf]
  auto stage_x = [&](int sl, int buf) {
    const int c0 = sl * BK;
#pragma unroll
    for (int j = 0; j < NU; ++j)
      if (upix[j] >= 0) {
        const bool ok = gofs[j] >= 0 && c0 + half < Cin;
        cp_async16(raws + (buf * M_STAGE + upix[j]) * BK + half, ok ? xb + gofs[j] + c0 : xb, ok);
      }
  };
  // unit j of slice sl: raws[buf] -> acts[buf], s = silu(x*a + b) rounded,
  // 0 outside the image
  auto prologue = [&](int sl, int buf, int j) {
    if (upix[j] < 0) return;
    const int ch = sl * BK + half;
    uint4 out = make_uint4(0, 0, 0, 0);
    if (gofs[j] >= 0 && ch < Cin) {
      const uint4 in = *reinterpret_cast<const uint4*>(raws + (buf * M_STAGE + upix[j]) * BK + half);
      const bf16* xv = reinterpret_cast<const bf16*>(&in);
      unsigned* o = reinterpret_cast<unsigned*>(&out);
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const float4 av = *reinterpret_cast<const float4*>(ab + ch + 4 * q);
        const float4 bv = *reinterpret_cast<const float4*>(bb + ch + 4 * q);
        float v[4] = {__bfloat162float(xv[4 * q]) * av.x + bv.x, __bfloat162float(xv[4 * q + 1]) * av.y + bv.y,
                      __bfloat162float(xv[4 * q + 2]) * av.z + bv.z, __bfloat162float(xv[4 * q + 3]) * av.w + bv.w};
        if (silu)
#pragma unroll
          for (int e = 0; e < 4; ++e) v[e] = v[e] / (1.0f + expf(-v[e]));
        o[2 * q] = pack_bf16(v[0], v[1]);
        o[2 * q + 1] = pack_bf16(v[2], v[3]);
      }
    }
    *reinterpret_cast<uint4*>(acts + (buf * M_STAGE + upix[j]) * LDA + half) = out;
  };

  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.0f;

  // staged pixel of each of the warp's two 16-pixel A rows at tap (0, 0),
  // for this lane's ldmatrix row (16 | TX: the 16 pixels share an image row)
  int arow[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int m = wm + i * 16 + (lane & 15);
    arow[i] = (m / TX + 1) * SW + m % TX + 1;
  }
  const int acol = (lane >> 4) * 8;

  // The pipeline: while the taps of slice sl run on the tensor cores, the
  // same warps turn slice sl + 1's raw window into its operand stage (CUDA
  // cores), and the copies of slice sl + 1's weights and slice sl + 2's raw
  // window are in flight.
  const int slices = (Cin + BK - 1) / BK;
  stage_w(0, 0);
  stage_x(0, 0);
  if (slices > 1) stage_x(1, 1);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
#pragma unroll
  for (int j = 0; j < NU; ++j) prologue(0, 0, j);
  for (int sl = 0; sl < slices; ++sl) {
    const int buf = sl & 1;
    // slice sl's operands and weights are complete; every warp is done with
    // slice sl - 1's stages, which the copies below refill
    __syncthreads();
    if (sl + 1 < slices) stage_w(sl + 1, buf ^ 1);
    if (sl + 2 < slices) stage_x(sl + 2, buf);
    cp_async_commit();

    const bf16* act = acts + buf * M_STAGE * LDA;
    const bf16* ws = wsm + buf * 9 * BK * LDB;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int shift = (tap / 3 - 1) * SW + (tap % 3 - 1);
      unsigned fa[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) ldsm_x4(fa[i], act + (arow[i] + shift) * LDA + acol);
      const bf16* wt = ws + tap * BK * LDB;
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        unsigned fb[4];
        ldsm_x4_t(fb, wt + ((lane & 7) + ((lane >> 3) & 1) * 8) * LDB + wn + np * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma_bf16(acc[i][2 * np], fa[i], fb[0], fb[1]);
          mma_bf16(acc[i][2 * np + 1], fa[i], fb[2], fb[3]);
        }
      }
      // the next slice's prologue, one unit after every third tap
      if (tap % 3 == 1 && tap / 3 < NU && sl + 1 < slices) prologue(sl + 1, buf ^ 1, tap / 3);
    }
    cp_async_wait<0>();
  }

  // epilogue: + bias + row[b] (+ res) in fp32, rounded once; two channels a store
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int m = wm + i * 16 + r + hh * 8;
      const int gy = y0 + m / TX, gx = x0 + m % TX;
      if (gy >= H || gx >= W) continue;
      const int64_t pix = ((int64_t)b * H + gy) * W + gx;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = n0 + wn + j * 8 + 2 * c;
        if (col >= Cout) continue;
        float v0 = acc[i][j][2 * hh] + bias[col] + row[(int64_t)b * Cout + col];
        float v1 = acc[i][j][2 * hh + 1] + bias[col + 1] + row[(int64_t)b * Cout + col + 1];
        if (res) {
          const __nv_bfloat162 rv = *reinterpret_cast<const __nv_bfloat162*>(res + pix * Cout + col);
          v0 += __low2float(rv);
          v1 += __high2float(rv);
        }
        *reinterpret_cast<unsigned*>(y + pix * Cout + col) = pack_bf16(v0, v1);
      }
    }
}

__global__ void __launch_bounds__(conv::F_THREADS)
    conv_f32_kernel(const float* __restrict__ x, const float* __restrict__ a, const float* __restrict__ bsh,
                    const float* __restrict__ w9, const float* __restrict__ bias, const float* __restrict__ row,
                    const float* __restrict__ res, float* __restrict__ y, int H, int W, int Cin, int Cout, int TX,
                    int silu) {
  using namespace conv;
  extern __shared__ __align__(128) unsigned char smem[];
  float* As = reinterpret_cast<float*>(smem);
  float* Ws = As + F_STAGE * F_LDA;

  const int TR = F_PIX / TX, SW = TX + 2, SP = (TR + 2) * SW;
  const int nN = (Cout + F_BNC - 1) / F_BNC;
  const int n0 = (blockIdx.x % nN) * F_BNC;
  const int x0 = (blockIdx.x / nN) * TX;
  const int y0 = blockIdx.y * TR;
  const int b = blockIdx.z;
  const float* ab = a + (int64_t)b * Cin;
  const float* bb = bsh + (int64_t)b * Cin;
  const float* xb = x + (int64_t)b * H * W * Cin;
  const int tx = threadIdx.x & 7, ty = threadIdx.x >> 3;  // 4 pixels x 8 channels a thread

  // staged offset of each output pixel's tap (0, 0): tile pixel m sits at
  // staged row m / TX + 1, column m % TX + 1
  float acc[4][8];
  int abase[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = ty * 4 + i;
    abase[i] = ((m / TX + 1) * SW + m % TX + 1) * F_LDA;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  }

  for (int c0 = 0; c0 < Cin; c0 += F_BK) {
    // prologue, once per staged element
    for (int i = threadIdx.x; i < SP * F_BK; i += F_THREADS) {
      const int p = i / F_BK, k = i - p * F_BK;
      const int sr = p / SW, sc = p - sr * SW;
      const int gy = y0 - 1 + sr, gx = x0 - 1 + sc, ch = c0 + k;
      float v = 0.0f;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W && ch < Cin) {
        v = xb[((int64_t)gy * W + gx) * Cin + ch] * ab[ch] + bb[ch];
        if (silu) v = v / (1.0f + expf(-v));
      }
      As[p * F_LDA + k] = v;
    }
    // the nine taps' weight slices: Ws[tap * F_BK + k][n] = w9[tap * Cin + c0 + k][n0 + n]
    for (int i = threadIdx.x; i < 9 * F_BK * F_BNC; i += F_THREADS) {
      const int rr = i / F_BNC, n = i - rr * F_BNC;
      const int tap = rr / F_BK, k = rr - tap * F_BK;
      Ws[rr * F_BNC + n] = (c0 + k < Cin && n0 + n < Cout) ? w9[((int64_t)tap * Cin + c0 + k) * Cout + n0 + n] : 0.0f;
    }
    __syncthreads();
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int off = ((tap / 3 - 1) * SW + (tap % 3 - 1)) * F_LDA;
      const float* wt = Ws + tap * F_BK * F_BNC;
#pragma unroll 4
      for (int k = 0; k < F_BK; ++k) {
        float av[4], bv[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] = As[abase[i] + off + k];
#pragma unroll
        for (int j = 0; j < 8; ++j) bv[j] = wt[k * F_BNC + tx * 8 + j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

  // epilogue: + bias + row[b] (+ res), in fp32
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int m = ty * 4 + i, n = tx * 8 + j;
      const int gy = y0 + m / TX, gx = x0 + m % TX, col = n0 + n;
      if (gy < H && gx < W && col < Cout) {
        const int64_t o = (((int64_t)b * H + gy) * W + gx) * Cout + col;
        float v = acc[i][j] + bias[col] + row[(int64_t)b * Cout + col];
        if (res) v += res[o];
        y[o] = v;
      }
    }
}

static int conv3x3_bf16(const void* x, const void* a, const void* b, const void* w9, const void* bias,
                        const void* row, const void* res, void* y, int B, int H, int W, int Cin, int Cout, int silu,
                        cudaStream_t s) {
  if (Cin % 8 || Cout % 8) return (int)cudaErrorInvalidValue;  // 16-byte rows of x and of the weight
  if ((int64_t)H * W * Cin >= (1ll << 31)) return (int)cudaErrorInvalidValue;  // 32-bit offsets in one image
  const int TX = conv::tile_cols(W), TR = conv::M_PIX / TX;
  const int nN = (Cout + conv::BN - 1) / conv::BN;
  const dim3 grid(((W + TX - 1) / TX) * nN, (H + TR - 1) / TR, B);
  cudaError_t e =
      cudaFuncSetAttribute(conv_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, conv::M_SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  conv_mma_kernel<<<grid, conv::M_THREADS, conv::M_SMEM_BYTES, s>>>(
      (const bf16*)x, (const float*)a, (const float*)b, (const bf16*)w9, (const float*)bias, (const float*)row,
      (const bf16*)res, (bf16*)y, H, W, Cin, Cout, TX, silu);
  return (int)cudaGetLastError();
}

static int conv3x3_f32(const void* x, const void* a, const void* b, const void* w9, const void* bias,
                       const void* row, const void* res, void* y, int B, int H, int W, int Cin, int Cout, int silu,
                       cudaStream_t s) {
  const int TX = conv::tile_cols(W), TR = conv::F_PIX / TX;
  const int nN = (Cout + conv::F_BNC - 1) / conv::F_BNC;
  const dim3 grid(((W + TX - 1) / TX) * nN, (H + TR - 1) / TR, B);
  cudaError_t e =
      cudaFuncSetAttribute(conv_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, conv::F_SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  conv_f32_kernel<<<grid, conv::F_THREADS, conv::F_SMEM_BYTES, s>>>(
      (const float*)x, (const float*)a, (const float*)b, (const float*)w9, (const float*)bias, (const float*)row,
      (const float*)res, (float*)y, H, W, Cin, Cout, TX, silu);
  return (int)cudaGetLastError();
}

}  // namespace mvdf

using namespace mvdf;

MVDF_API int mvdf_conv3x3(const void* x, const void* a, const void* b, const void* w9, const void* bias,
                          const void* row, const void* res, void* y, int B, int H, int W, int Cin, int Cout,
                          int silu, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return dtype == DT_BF16 ? conv3x3_bf16(x, a, b, w9, bias, row, res, y, B, H, W, Cin, Cout, silu, s)
                          : conv3x3_f32(x, a, b, w9, bias, row, res, y, B, H, W, Cin, Cout, silu, s);
}
