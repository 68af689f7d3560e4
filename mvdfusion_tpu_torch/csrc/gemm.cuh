// Device building blocks of the transformer-site kernels: the GEMM epilogue,
// one 64x64 output tile of a GEMM (bf16 on the tensor cores, fp32 on the
// CUDA cores) and a LayerNorm row. The standalone kernels of block.cu launch
// them one tile or row per block; the one-kernel site (blockforms.cu) walks
// its tiles in grid-stride loops. Every tile function runs on 128 threads.
// Namespace sm90 holds Hopper's TMA + wgmma helpers and the wgmma GEMM's
// epilogue (pass2_kind), shared by gemm_sm90.cu and blockforms.cu.
//
// No pointer here is __restrict__: the one-kernel site reads buffers that
// earlier phases of the same launch wrote, which the read-only data path
// would not see.
#pragma once

#include <cuda.h>
#include <mma.h>
#include <string.h>

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

// LayerNorm of one row of C <= L * VPL * VEC elements (VEC = 16 / sizeof(T))
// by a group of L lanes (a power of two up to 32, L consecutive threads):
// 16-byte loads and stores, fp32 statistics in the reference's form
// (mvdfusion_tpu/ops/block.py::_ln_t): mean, E[x^2] - mean^2 clamped at 0,
// then (x - mean) * rstd * gamma + beta, gamma and beta fp32 (nullable).
// Every lane of the warp calls it (the shuffles take the whole warp); with
// `valid` false it reads and stores nothing.
template <typename T, int L, int VPL>
__device__ __forceinline__ void ln_row(const T* __restrict__ x, const float* __restrict__ gamma,
                                       const float* __restrict__ beta, T* __restrict__ y, int64_t row, bool valid,
                                       int C, float eps) {
  constexpr int VEC = 16 / sizeof(T);
  const int lane = threadIdx.x & (L - 1);
  const uint4* xr = reinterpret_cast<const uint4*>(x + row * C);
  uint4* yr = reinterpret_cast<uint4*>(y + row * C);
  float v[VPL][VEC];
  float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
  for (int i = 0; i < VPL; ++i)
    if (valid && (lane + L * i) * VEC < C) {
      unpack16(xr[lane + L * i], v[i]);
#pragma unroll
      for (int j = 0; j < VEC; ++j) s1 += v[i][j], s2 += v[i][j] * v[i][j];
    }
#pragma unroll
  for (int o = L / 2; o > 0; o >>= 1) {
    s1 += __shfl_xor_sync(0xffffffffu, s1, o);
    s2 += __shfl_xor_sync(0xffffffffu, s2, o);
  }
  const float mean = s1 / (float)C;
  const float rstd = rsqrtf(fmaxf(s2 / (float)C - mean * mean, 0.0f) + eps);
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int c = (lane + L * i) * VEC;
    if (valid && c < C) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        float o = (v[i][j] - mean) * rstd;
        if (gamma) o *= gamma[c + j];
        if (beta) o += beta[c + j];
        v[i][j] = o;
      }
      yr[lane + L * i] = pack16(v[i]);
    }
  }
}

// ---- Hopper's asynchronous path (sm_90a), shared by the site GEMM
// (gemm_sm90.cu) and the site forms' kernels (blockforms.cu): TMA copies
// completing on mbarriers, wgmma on 128-byte-swizzled shared-memory tiles,
// and the GEMM epilogue's pass 2 over a warpgroup's fp32 staging tile.
namespace sm90 {

constexpr int TMA_BK = 64;            // a TMA box's columns: 64 bf16, one 128-byte swizzled row
constexpr int EPI_LDS = 128 + 8;      // the staging tile's row stride (floats) for 128 packed columns

__device__ __forceinline__ uint32_t smem_u32(const void* p) { return (uint32_t)__cvta_generic_to_shared(p); }

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// spin until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// box (TMA_BK columns x box rows) at (col, row) of the tensor map into `dst`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int col, int row, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], "
      "[%4];\n" ::"r"(smem_u32(dst)),
      "l"((uint64_t)map), "r"(col), "r"(row), "r"(smem_u32(bar))
      : "memory");
}

// shared-memory matrix descriptor of a K-major tile in the 128-byte swizzle:
// rows of 128 bytes, 8-row groups 1024 bytes apart (tile base 1024-aligned;
// a k16 step within the 64-deep slice adds 32 bytes to the start address)
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d (+)= A (64x16, K-major, smem) * B (128x16, K-major, smem); 64 fp32 sums a thread
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// the accumulators as the compiler sees them are written here, after the
// wgmma that writes them has been waited for: no read moves above the wait
template <int N>
__device__ __forceinline__ void wgmma_fence_operand(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// four consecutive elements of a buffer whose type is chosen at run time
__device__ __forceinline__ float4 load4(const void* p, int64_t i, int is_bf16) {
  if (is_bf16) {
    const uint2 u = *reinterpret_cast<const uint2*>(reinterpret_cast<const bf16*>(p) + i);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    return make_float4(a.x, a.y, b.x, b.y);
  }
  return *reinterpret_cast<const float4*>(reinterpret_cast<const float*>(p) + i);
}
__device__ __forceinline__ void store4(void* p, int64_t i, const float (&v)[4], int is_bf16) {
  if (is_bf16) {
    const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]), b = __floats2bfloat162_rn(v[2], v[3]);
    uint2 u;
    u.x = *reinterpret_cast<const unsigned*>(&a);
    u.y = *reinterpret_cast<const unsigned*>(&b);
    *reinterpret_cast<uint2*>(reinterpret_cast<bf16*>(p) + i) = u;
  } else {
    *reinterpret_cast<float4*>(reinterpret_cast<float*>(p) + i) = make_float4(v[0], v[1], v[2], v[3]);
  }
}

// The epilogue's kinds: each main-path combination of Epilogue's fields gets
// a pass 2 whose per-element code has no branch on them; EK_GENERIC takes
// any combination (gemm.cuh's tile_epilogue in full).
enum {
  EK_GENERIC = 0,
  EK_BIAS,      // + bias (or none): projections, qkv
  EK_GELU,      // GELU(+ bias): the DiT's fc1
  EK_GEGLU,     // GEGLU with `steps` into bf16: the site's FF in
  EK_RES1,      // + bias, + res1: FF out, proj_out (bf16, `steps` or not)
  EK_RES2,      // + bias, + res1, + res2[row / div]: the site's out-projection
  EK_GATE_RES,  // gate * (+ bias) + res1, fp32 out: the DiT's residual stream
};

// the kind of an epilogue (once per call or phase)
__host__ __device__ inline int epilogue_kind(const Epilogue& e) {
  const int r = e.steps & e.out_bf16;
  if (e.act == ACT_GEGLU) return !e.gate && !e.res1 && !e.res2 && r ? EK_GEGLU : EK_GENERIC;
  if (e.gate) return e.act == ACT_NONE && e.res1 && !e.res2 && !r ? EK_GATE_RES : EK_GENERIC;
  if (e.act == ACT_GELU) return !e.res1 && !e.res2 ? EK_GELU : EK_GENERIC;
  if (e.res2) return e.res1 ? EK_RES2 : EK_GENERIC;
  return e.res1 ? EK_RES1 : EK_BIAS;
}

__device__ __forceinline__ float bf16_round(float v) { return __bfloat162float(__float2bfloat16(v)); }

// pass 2 of the epilogue over one warpgroup's staging tile (64 rows from m0,
// 128 packed columns from n0): lane l owns output columns 4l..4l+3 (GEGLU:
// lanes 16h + c own output columns 4c..4c+3 of every other row, from their
// value columns and the gate columns 32 to the right, ops/block.py::
// pack_geglu), so bias and gate are read once a tile; warp w walks rows
// 16w..16w+15, coalesced, in batches whose residual loads are all issued
// before the batch's stores (`out` may alias `res1`, so no load may pass an
// earlier store).
template <bool GEGLU, int KIND>
__device__ __forceinline__ void pass2(const float* stage, const Epilogue& e, int m0, int n0, int tid) {
  constexpr bool GATE = KIND == EK_GENERIC || KIND == EK_GATE_RES;
  constexpr bool RES1 = KIND == EK_GENERIC || KIND == EK_RES1 || KIND == EK_RES2 || KIND == EK_GATE_RES;
  constexpr bool RES2 = KIND == EK_GENERIC || KIND == EK_RES2;
  constexpr int ROWS = GEGLU ? 8 : 16, NB = RES2 ? 4 : 8;  // rows a lane handles; rows a batch
  const int warp = tid >> 5, lane = tid & 31, half = GEGLU ? lane >> 4 : 0;
  const int cc = GEGLU ? 4 * (lane & 15) : 4 * lane;        // output column in the tile
  const int sc = GEGLU ? 64 * (cc / 32) + cc % 32 : cc;     // its (value) column in the staging tile
  const int col = (GEGLU ? n0 / 2 : n0) + cc, pc = n0 + sc;  // output and packed (bias) column
  if (col >= e.Nout) return;
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f), one = make_float4(1.0f, 1.0f, 1.0f, 1.0f);
  const float4 bv = e.bias ? *reinterpret_cast<const float4*>(e.bias + pc) : zero;
  const float4 bg = GEGLU && e.bias ? *reinterpret_cast<const float4*>(e.bias + pc + 32) : zero;
  const float4 gt = GATE && e.gate ? *reinterpret_cast<const float4*>(e.gate + col) : one;
  const float b4[4] = {bv.x, bv.y, bv.z, bv.w}, c4[4] = {bg.x, bg.y, bg.z, bg.w}, t4[4] = {gt.x, gt.y, gt.z, gt.w};
  const int r = e.steps & e.out_bf16;
#pragma unroll
  for (int i0 = 0; i0 < ROWS; i0 += NB) {
    float4 q1[NB], q2[NB];
#pragma unroll
    for (int u = 0; u < NB; ++u) {
      const int row = m0 + 16 * warp + (GEGLU ? 2 * (i0 + u) + half : i0 + u);
      const bool ok = row < e.M;
      q1[u] = RES1 && ok && e.res1 ? load4(e.res1, (int64_t)row * e.Nout + col, e.res1_bf16) : zero;
      q2[u] = RES2 && ok && e.res2 ? load4(e.res2, (int64_t)(row / e.res2_div) * e.Nout + col, e.res2_bf16) : zero;
    }
#pragma unroll
    for (int u = 0; u < NB; ++u) {
      const int rr = 16 * warp + (GEGLU ? 2 * (i0 + u) + half : i0 + u), row = m0 + rr;
      if (row >= e.M) break;
      const float* src = stage + rr * EPI_LDS + sc;
      const float4 acc = *reinterpret_cast<const float4*>(src);
      const float4 acg = GEGLU ? *reinterpret_cast<const float4*>(src + 32) : zero;
      const float a4[4] = {acc.x, acc.y, acc.z, acc.w}, g4[4] = {acg.x, acg.y, acg.z, acg.w};
      const float p4[4] = {q1[u].x, q1[u].y, q1[u].z, q1[u].w}, s4[4] = {q2[u].x, q2[u].y, q2[u].z, q2[u].w};
      float v[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        if constexpr (KIND == EK_GENERIC) {
          if (GEGLU) {
            float a = a4[t], g = g4[t];
            if (e.bias) {
              a += b4[t];
              g += c4[t];
            }
            v[t] = e.steps ? round_to(a, r) * gelu_steps(round_to(g, r), r) : a * gelu_erf(g);
          } else {
            v[t] = a4[t];
            if (e.bias) v[t] += b4[t];
            if (e.act == ACT_GELU) v[t] = gelu_erf(v[t]);
          }
          if (e.gate) v[t] *= t4[t];
          if (e.res1) v[t] = round_to(v[t], r) + p4[t];
          if (e.res2) v[t] = round_to(v[t], r) + s4[t];
        } else if constexpr (KIND == EK_GEGLU) {
          v[t] = bf16_round(a4[t] + b4[t]) * gelu_steps(bf16_round(g4[t] + c4[t]), 1);
        } else if constexpr (KIND == EK_GELU) {
          v[t] = gelu_erf(a4[t] + b4[t]);
        } else if constexpr (KIND == EK_GATE_RES) {
          v[t] = (a4[t] + b4[t]) * t4[t] + p4[t];
        } else {
          v[t] = a4[t] + b4[t];
          if constexpr (RES1) {
            const float w = bf16_round(v[t]);
            v[t] = (r ? w : v[t]) + p4[t];
          }
          if constexpr (KIND == EK_RES2) {
            const float w = bf16_round(v[t]);
            v[t] = (r ? w : v[t]) + s4[t];
          }
        }
      }
      store4(e.out, (int64_t)row * e.Nout + col, v, e.out_bf16);
    }
  }
}

// pass 2 of `kind` on the warpgroup's staging tile
__device__ __forceinline__ void pass2_kind(const float* stage, const Epilogue& e, int kind, int m0, int n0, int tid) {
  switch (kind) {
    case EK_BIAS: pass2<false, EK_BIAS>(stage, e, m0, n0, tid); break;
    case EK_GELU: pass2<false, EK_GELU>(stage, e, m0, n0, tid); break;
    case EK_GEGLU: pass2<true, EK_GEGLU>(stage, e, m0, n0, tid); break;
    case EK_RES1: pass2<false, EK_RES1>(stage, e, m0, n0, tid); break;
    case EK_RES2: pass2<false, EK_RES2>(stage, e, m0, n0, tid); break;
    case EK_GATE_RES: pass2<false, EK_GATE_RES>(stage, e, m0, n0, tid); break;
    default:
      if (e.act == ACT_GEGLU)
        pass2<true, EK_GENERIC>(stage, e, m0, n0, tid);
      else
        pass2<false, EK_GENERIC>(stage, e, m0, n0, tid);
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

static EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t rc = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t rc = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (rc == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = (EncodeTiled)p;
  }
  return fn;
}

// a (rows, cols) row-major bf16 matrix read in boxes of TMA_BK columns x box_rows
// rows, 128-byte swizzle, zeros past its edges
static int encode(CUtensorMap* map, const void* base, int rows, int cols, int box_rows) {
  EncodeTiled fn = encode_fn();
  if (!fn) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {(cuuint32_t)TMA_BK, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// every generic-proxy write of this thread to device memory is ordered
// before later async-proxy (TMA) reads of it, by this block or, after a
// grid-wide barrier, by any other
__device__ __forceinline__ void fence_proxy_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}
// the same for shared memory: generic accesses before a TMA copy overwrites it
__device__ __forceinline__ void fence_proxy_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

}  // namespace sm90

}  // namespace mvdf
