// K5 and K6: the transformer site's one-kernel form, and the attention
// kernel of its big-C form.
//
// K5 replaces mvdfusion_tpu/ops/block.py::_block_kernel (:298, called from
// _fwd_impl at :698 when the site's weights fit _SINGLE_KERNEL_WEIGHT_BYTES,
// i.e. under MVDF_BLOCK_SINGLE=1: the C=320 32^2 sites). One launch runs the
// whole site — GN statistics and apply, proj_in, LN1, qkv, self-attention,
// out-proj + residual + attn2, LN3, GEGLU, FF + residual, proj_out + x_in —
// where K3 takes nine. It is a persistent cooperative kernel: as many
// 128-thread blocks as fit the SMs at once, each phase a grid-stride loop
// over its tiles, the phases separated by grid-wide barriers. Every tile is
// K3's own code (gemm.cuh's GEMM tile and epilogue, its LayerNorm row,
// attention.cuh's K2 tiles: in bf16 the tensor-core tile, rounding the
// normalised probabilities; in fp32 the CUDA-core loop), so K5 rounds where
// K3 does; the intermediates live in a workspace the wrapper allocates once
// per shape. One dynamic shared-memory buffer serves every phase, sized for
// the larger of the GEMM tile and the attention tile's two-stage ring.
// Bound on the H100: operations (at B=16, N=1024, C=320: ~60 GFLOP against
// ~40 MB); its GEMM phases run un-pipelined WMMA tiles. What it removes is
// K3's eight launch gaps a site.
//
// K6's kernel replaces _bigattn_stream_kernel (:370, called at :651), the
// attention of the big-C form (MVDF_BLOCK_BIGC=1: the C=1280 sites with
// 64 <= N <= 256). One block per (head, batch) projects that head's K and V
// for all N tokens from LN1 into shared memory, then Q 64 rows at a time,
// and runs the softmax attention one query per warp with the logits in
// registers, so the (B, N, 3C) qkv never goes to device memory. It rounds
// where the TPU kernel does: q, k and v to the input type; fp32 logits;
// exp((l - max) * scale) divided by its sum and rounded; PV rounded. The
// TPU kernel's lane packing of several batch elements and its block-
// diagonal mask existed for Mosaic's 128-lane tiles: a block per batch
// element computes the same per-batch attention directly. Bound on the
// H100: operations (the projections, 2 N C 3C a batch element, on WMMA
// tiles); at N=256, dh=160 the bf16 K, V and Q tiles take 187 KB of shared
// memory, one block an SM.
#include <cooperative_groups.h>

#include <type_traits>

#include "attention.cuh"
#include "gemm.cuh"

namespace cg = cooperative_groups;

namespace mvdf {

constexpr int GN_GROUPS = 32;

// block 0 stamps the device clock (ns) as it starts and as it leaves each
// phase's barrier: the phase breakdown a profiler cannot see inside one launch
__device__ __forceinline__ void stamp(unsigned long long* stamps, int i) {
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    stamps[i] = t;
  }
}

struct SiteParams {
  const void* x;
  const void* a2;  // attn2 term: (B, C) row (a2_div = N) or (B, N, C) map (a2_div = 1)
  int a2_div;
  const float *gn_w, *gn_b;
  const void* pi_w;
  const float* pi_b;
  const float *ln1_w, *ln1_b;
  const void *qkv_w, *out_w;
  const float* out_b;
  const float *ln3_w, *ln3_b;
  const void* g_w;  // GEGLU rows packed as block.py::pack_geglu packs them
  const float* g_b;
  const void* f_w;
  const float* f_b;
  const void* po_w;
  const float* po_b;
  void* out;
  // workspace: GN mean and rstd per (batch, group); two (M, C) buffers and
  // one (M, max(3C, inner)) buffer; 12 globaltimer stamps and the grid's size
  float* stats;
  void *A, *H, *big;
  unsigned long long* stamps;
  int B, N, C, heads, inner, bk;
  float gn_eps, ln_eps, scale, scale_log2;
};

template <typename T>
__device__ __forceinline__ Epilogue site_epilogue(const float* bias, void* out, const void* res1, const void* res2,
                                                  int res2_div, int act, int M, int Nout) {
  const int bf = sizeof(T) == 2;
  Epilogue e;
  e.bias = bias;
  e.out = out;
  e.out_bf16 = bf;
  e.res1 = res1;
  e.res1_bf16 = bf;
  e.res2 = res2;
  e.res2_bf16 = bf;
  e.res2_div = res2_div;
  e.gate = nullptr;
  e.act = act;
  e.steps = 1;
  e.M = M;
  e.Nout = Nout;
  return e;
}

template <typename T>
__device__ __forceinline__ void gemm_phase(const T* A, const T* W, int N, int K, const Epilogue& e,
                                           unsigned char* smem) {
  const int tn = (N + BN - 1) / BN, tiles = ((e.M + BM - 1) / BM) * tn;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) gemm_tile(A, W, N, K, e, (t / tn) * BM, (t % tn) * BN, smem);
}

// K3's LayerNorm row (ln_row), a warp a row, C <= 1024
template <typename T>
__device__ __forceinline__ void layernorm_phase(const T* x, const float* g, const float* b, T* y, int64_t M, int C,
                                                float eps) {
  constexpr int VPL = 1024 / 32 / (16 / sizeof(T));
  const int warps = blockDim.x >> 5;
  for (int64_t row = (int64_t)blockIdx.x * warps + (threadIdx.x >> 5); row < M; row += (int64_t)gridDim.x * warps)
    ln_row<T, 32, VPL>(x, g, b, y, row, true, C, eps);
}

// DP > 0 (bf16): attention.cuh's tensor-core tile with dh padded to DP;
// DP == 0: its CUDA-core loop with TPQ threads a query, DPT dims a thread
template <typename T, int TPQ, int DPT, int DP>
__global__ void __launch_bounds__(128) site_kernel(SiteParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  const int B = p.B, N = p.N, C = p.C, cpg = C / GN_GROUPS, M = B * N;
  const T* x = reinterpret_cast<const T*>(p.x);
  T* A = reinterpret_cast<T*>(p.A);
  T* H = reinterpret_cast<T*>(p.H);
  T* big = reinterpret_cast<T*>(p.big);
  int phase = 0;
  stamp(p.stamps, phase++);

  // 1. site GroupNorm statistics: one (batch, group) a tile, fp32 sums,
  //    E[x^2] - E[x]^2 clamped at 0 (as K1)
  float* scratch = reinterpret_cast<float*>(smem);
  for (int t = blockIdx.x; t < B * GN_GROUPS; t += gridDim.x) {
    const int b = t / GN_GROUPS, g = t % GN_GROUPS;
    const int64_t base = (int64_t)b * N * C + (int64_t)g * cpg, count = (int64_t)N * cpg;
    float s1 = 0.0f, s2 = 0.0f;
    for (int64_t e = threadIdx.x; e < count; e += blockDim.x) {
      const int64_t r = e / cpg;
      const float v = to_f(x[base + r * C + (e - r * cpg)]);
      s1 += v;
      s2 += v * v;
    }
    s1 = block_sum(s1, scratch);
    s2 = block_sum(s2, scratch);
    if (threadIdx.x == 0) {
      const float mean = s1 / (float)count;
      p.stats[2 * t] = mean;
      p.stats[2 * t + 1] = rsqrtf(fmaxf(s2 / (float)count - mean * mean, 0.0f) + p.gn_eps);
    }
  }
  grid.sync();
  stamp(p.stamps, phase++);
  // 2. GroupNorm apply -> A
  const int64_t MC = (int64_t)M * C;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < MC; i += (int64_t)gridDim.x * blockDim.x) {
    const int ch = (int)(i % C), b = (int)(i / ((int64_t)N * C));
    const float* st = p.stats + 2 * (b * GN_GROUPS + ch / cpg);
    A[i] = from_f<T>((to_f(x[i]) - st[0]) * (st[1] * p.gn_w[ch]) + p.gn_b[ch]);
  }
  grid.sync();
  stamp(p.stamps, phase++);
  // 3. proj_in -> H (h0)
  gemm_phase(A, (const T*)p.pi_w, C, C, site_epilogue<T>(p.pi_b, H, nullptr, nullptr, 1, ACT_NONE, M, C), smem);
  grid.sync();
  stamp(p.stamps, phase++);
  // 4. LN1 -> A
  layernorm_phase(H, p.ln1_w, p.ln1_b, A, M, C, p.ln_eps);
  grid.sync();
  stamp(p.stamps, phase++);
  // 5. qkv -> big (M, 3C)
  gemm_phase(A, (const T*)p.qkv_w, 3 * C, C,
             site_epilogue<T>(nullptr, big, nullptr, nullptr, 1, ACT_NONE, M, 3 * C), smem);
  grid.sync();
  stamp(p.stamps, phase++);
  // 6. self-attention -> A, one (query block, batch x head) a tile; the
  //    normalised probabilities rounded, as the site kernels round them
  const int dh = C / p.heads;
  const int64_t sb = (int64_t)N * 3 * C;
  if constexpr (DP > 0) {
    const int qblocks = (N + attn::QB - 1) / attn::QB;
    for (int t = blockIdx.x; t < qblocks * B * p.heads; t += gridDim.x)
      attn_tile_mma<DP>(big, big + C, big + 2 * C, A, p.heads, N, N, dh, sb, 3 * C, sb, 3 * C, sb, 3 * C,
                        (int64_t)N * C, C, p.scale, ATTN_PROBS, t % qblocks, t / qblocks, smem);
  } else {
    const int qblocks = (N + blockDim.x / TPQ - 1) / (blockDim.x / TPQ);
    for (int t = blockIdx.x; t < qblocks * B * p.heads; t += gridDim.x)
      attn_tile<T, TPQ, DPT>(big, big + C, big + 2 * C, A, p.heads, N, N, dh, sb, 3 * C, sb, 3 * C, sb, 3 * C,
                             (int64_t)N * C, C, p.scale_log2, p.bk, t % qblocks, t / qblocks, smem);
  }
  grid.sync();
  stamp(p.stamps, phase++);
  // 7. out-proj + h0 + attn2 -> H (h2, in place)
  gemm_phase(A, (const T*)p.out_w, C, C, site_epilogue<T>(p.out_b, H, H, p.a2, p.a2_div, ACT_NONE, M, C), smem);
  grid.sync();
  stamp(p.stamps, phase++);
  // 8. LN3 -> A
  layernorm_phase(H, p.ln3_w, p.ln3_b, A, M, C, p.ln_eps);
  grid.sync();
  stamp(p.stamps, phase++);
  // 9. GEGLU -> big (M, inner)
  gemm_phase(A, (const T*)p.g_w, 2 * p.inner, C,
             site_epilogue<T>(p.g_b, big, nullptr, nullptr, 1, ACT_GEGLU, M, p.inner), smem);
  grid.sync();
  stamp(p.stamps, phase++);
  // 10. FF + h2 -> H (h3, in place)
  gemm_phase(big, (const T*)p.f_w, C, p.inner, site_epilogue<T>(p.f_b, H, H, nullptr, 1, ACT_NONE, M, C), smem);
  grid.sync();
  stamp(p.stamps, phase++);
  // 11. proj_out + x_in -> out
  gemm_phase(H, (const T*)p.po_w, C, C, site_epilogue<T>(p.po_b, p.out, p.x, nullptr, 1, ACT_NONE, M, C), smem);
  grid.sync();
  stamp(p.stamps, phase);
  if (blockIdx.x == 0 && threadIdx.x == 0) p.stamps[phase + 1] = gridDim.x;  // the launch's grid, for the log
}

template <typename T, int TPQ, int DPT, int DP>
static int launch_site(SiteParams p, cudaStream_t s) {
  void (*kern)(SiteParams) = site_kernel<T, TPQ, DPT, DP>;
  // one dynamic buffer for every phase: the GEMM tile's, or the attention
  // tile's two-stage ring where that is larger
  int smem = GEMM_SMEM_BYTES;
  if constexpr (DP > 0) smem = attn::Tile<DP>::SMEM > smem ? attn::Tile<DP>::SMEM : smem;
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, 128, smem);
  if (err != cudaSuccess) return (int)err;
  if (!coop) return (int)cudaErrorNotSupported;
  if (per_sm < 1) return (int)cudaErrorLaunchOutOfResources;
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel((const void*)kern, dim3(sms * per_sm), dim3(128), args, smem, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T>
static int dispatch_site(const SiteParams& p, cudaStream_t s) {
  const int dh = p.C / p.heads;
  if constexpr (std::is_same<T, bf16>::value) {
    if (dh % 8 || dh > 128) return (int)cudaErrorInvalidValue;
    switch ((dh + 15) / 16) {
      case 1: return launch_site<T, 0, 0, 16>(p, s);
      case 2: return launch_site<T, 0, 0, 32>(p, s);
      case 3: return launch_site<T, 0, 0, 48>(p, s);
      case 4: return launch_site<T, 0, 0, 64>(p, s);
      case 5: return launch_site<T, 0, 0, 80>(p, s);
      case 6: return launch_site<T, 0, 0, 96>(p, s);
      case 7: return launch_site<T, 0, 0, 112>(p, s);
      default: return launch_site<T, 0, 0, 128>(p, s);
    }
  } else {
    if (dh <= 32) return launch_site<T, 4, 8, 0>(p, s);
    if (dh <= 64) return launch_site<T, 4, 16, 0>(p, s);
    if (dh <= 128) return launch_site<T, 4, 32, 0>(p, s);
    return (int)cudaErrorInvalidValue;
  }
}

// ------------------------------------------------------------------- K6
constexpr int BIG_WARPS = 8, BIG_ROWS = 64, BIG_COLS = 32, BIG_MAX_KEYS = 256, BIG_MAX_DH = 256;
constexpr int BIG_BK = 64, BIG_LDW = BIG_BK + 8;                // bf16 stage depth and row stride
constexpr int BIG_LDC = BIG_COLS + 4;                           // fp32 result row stride
constexpr int BIG_STAGE_BYTES = (BIG_ROWS + BIG_COLS) * BIG_LDW * 2 + BIG_ROWS * BIG_LDC * 4;

// dst[r * ldd + c] = X[r0 + r, :] . W[w0 + c, :] rounded to T, for r < 64,
// c < 32; 256 threads. bf16 on the tensor cores: each warp one 16x16
// fragment, K in steps of 64 (K % 8 == 0).
__device__ __forceinline__ void proj_tile(const bf16* X, const bf16* W, int K, int r0, int w0, bf16* dst, int ldd,
                                          unsigned char* stage) {
  using namespace nvcuda;
  bf16* As = reinterpret_cast<bf16*>(stage);
  bf16* Ws = As + BIG_ROWS * BIG_LDW;
  float* Cs = reinterpret_cast<float*>(stage + (BIG_ROWS + BIG_COLS) * BIG_LDW * 2);
  const int warp = threadIdx.x >> 5, fr = (warp >> 1) * 16, fc = (warp & 1) * 16;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
  wmma::fill_fragment(acc, 0.0f);
  constexpr int VPR = BIG_BK / 8;  // 16-byte vectors a stage row
  for (int k0 = 0; k0 < K; k0 += BIG_BK) {
    for (int v = threadIdx.x; v < (BIG_ROWS + BIG_COLS) * VPR; v += blockDim.x) {
      const int r = v / VPR, c = (v % VPR) * 8;
      const bool a = r < BIG_ROWS;
      const bf16* src = a ? X + (int64_t)(r0 + r) * K : W + (int64_t)(w0 + r - BIG_ROWS) * K;
      *reinterpret_cast<uint4*>(As + r * BIG_LDW + c) =
          k0 + c < K ? *reinterpret_cast<const uint4*>(src + k0 + c) : make_uint4(0, 0, 0, 0);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BIG_BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
      wmma::load_matrix_sync(fa, As + fr * BIG_LDW + kk, BIG_LDW);
      wmma::load_matrix_sync(fb, Ws + fc * BIG_LDW + kk, BIG_LDW);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    __syncthreads();
  }
  wmma::store_matrix_sync(Cs + fr * BIG_LDC + fc, acc, BIG_LDC, wmma::mem_row_major);
  __syncthreads();
  for (int i = threadIdx.x; i < BIG_ROWS * BIG_COLS; i += blockDim.x)
    dst[(i / BIG_COLS) * ldd + i % BIG_COLS] = __float2bfloat16(Cs[(i / BIG_COLS) * BIG_LDC + i % BIG_COLS]);
  __syncthreads();
}

// the same with fp32 operands on the CUDA cores: 8 outputs a thread, K in
// steps of 16
__device__ __forceinline__ void proj_tile(const float* X, const float* W, int K, int r0, int w0, float* dst, int ldd,
                                          unsigned char* stage) {
  float(*As)[BIG_ROWS + 4] = reinterpret_cast<float(*)[BIG_ROWS + 4]>(stage);
  float(*Ws)[BIG_COLS + 4] = reinterpret_cast<float(*)[BIG_COLS + 4]>(stage + BK_F * (BIG_ROWS + 4) * 4);
  const int r = threadIdx.x >> 2, c8 = (threadIdx.x & 3) * 8;
  float acc[8] = {};
  for (int k0 = 0; k0 < K; k0 += BK_F) {
    for (int i = threadIdx.x; i < BK_F * BIG_ROWS; i += blockDim.x) {
      const int rr = i >> 4, cc = i & 15;
      As[cc][rr] = k0 + cc < K ? X[(int64_t)(r0 + rr) * K + k0 + cc] : 0.0f;
      if (rr < BIG_COLS) Ws[cc][rr] = k0 + cc < K ? W[(int64_t)(w0 + rr) * K + k0 + cc] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK_F; ++kk) {
      const float a = As[kk][r];
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j] += a * Ws[kk][c8 + j];
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) dst[r * ldd + c8 + j] = acc[j];
  __syncthreads();
}

template <typename T>
__host__ __device__ constexpr int big_ldk(int dh) {
  return dh + (sizeof(T) == 2 ? 2 : 1);  // an odd number of 32-bit words a row: conflict-free key reads
}

template <typename T>
__host__ __device__ constexpr size_t big_smem_bytes(int N, int dh) {
  return BIG_STAGE_BYTES + (size_t)BIG_WARPS * N * 4 + (size_t)(2 * N + BIG_ROWS) * big_ldk<T>(dh) * sizeof(T);
}

// grid (heads, B), 256 threads; ln1 (B, N, C), qkv_w (3C, C) rows [Wq; Wk; Wv],
// out (B, N, C); N % 64 == 0, N <= 256, dh % 32 == 0, dh <= 256
template <typename T>
__global__ void __launch_bounds__(256) bigattn_kernel(const T* __restrict__ ln1, const T* __restrict__ qkv_w,
                                                      T* __restrict__ out, int N, int C, int heads, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int h = blockIdx.x, b = blockIdx.y, dh = C / heads, ldk = big_ldk<T>(dh);
  unsigned char* stage = smem;
  float* P = reinterpret_cast<float*>(smem + BIG_STAGE_BYTES);  // one row of probabilities a warp
  T* Ks = reinterpret_cast<T*>(P + BIG_WARPS * N);
  T* Vs = Ks + N * ldk;
  T* Qs = Vs + N * ldk;
  const T* X = ln1 + (int64_t)b * N * C;
  for (int r0 = 0; r0 < N; r0 += BIG_ROWS)
    for (int c0 = 0; c0 < dh; c0 += BIG_COLS) {
      proj_tile(X, qkv_w, C, r0, C + h * dh + c0, Ks + r0 * ldk + c0, ldk, stage);
      proj_tile(X, qkv_w, C, r0, 2 * C + h * dh + c0, Vs + r0 * ldk + c0, ldk, stage);
    }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nkt = N / 32, ndu = dh / 32;
  float* pw = P + warp * N;
  for (int q0 = 0; q0 < N; q0 += BIG_ROWS) {
    for (int c0 = 0; c0 < dh; c0 += BIG_COLS) proj_tile(X, qkv_w, C, q0, h * dh + c0, Qs + c0, ldk, stage);
    for (int i = warp; i < BIG_ROWS; i += BIG_WARPS) {
      const T* qr = Qs + i * ldk;
      float s[BIG_MAX_KEYS / 32];
      float m = -INFINITY;
#pragma unroll
      for (int t = 0; t < BIG_MAX_KEYS / 32; ++t) {
        s[t] = 0.0f;
        if (t < nkt) {
          const T* kr = Ks + (lane + 32 * t) * ldk;
          float a = 0.0f;
          for (int d = 0; d < dh; ++d) a += to_f(qr[d]) * to_f(kr[d]);
          s[t] = a;
          m = fmaxf(m, a);
        }
      }
      m = warp_max(m);
      float l = 0.0f;
#pragma unroll
      for (int t = 0; t < BIG_MAX_KEYS / 32; ++t)
        if (t < nkt) {
          s[t] = expf((s[t] - m) * scale);
          l += s[t];
        }
      l = warp_sum(l);
#pragma unroll
      for (int t = 0; t < BIG_MAX_KEYS / 32; ++t)
        if (t < nkt) pw[lane + 32 * t] = to_f(from_f<T>(s[t] / l));
      __syncwarp();
      float acc[BIG_MAX_DH / 32] = {};
      for (int j = 0; j < N; ++j) {
        const float pj = pw[j];
        const T* vr = Vs + j * ldk + lane;
#pragma unroll
        for (int u = 0; u < BIG_MAX_DH / 32; ++u)
          if (u < ndu) acc[u] += pj * to_f(vr[32 * u]);
      }
      T* o = out + ((int64_t)b * N + q0 + i) * C + h * dh + lane;
#pragma unroll
      for (int u = 0; u < BIG_MAX_DH / 32; ++u)
        if (u < ndu) o[32 * u] = from_f<T>(acc[u]);
      __syncwarp();
    }
    __syncthreads();  // Qs is rewritten for the next 64 queries
  }
}

template <typename T>
static int launch_bigattn(const void* ln1, const void* qkv_w, void* out, int B, int N, int C, int heads, float scale,
                          cudaStream_t s) {
  const int dh = C / heads;
  if (C % heads || N % BIG_ROWS || N > BIG_MAX_KEYS || dh % BIG_COLS || dh > BIG_MAX_DH)
    return (int)cudaErrorInvalidValue;
  const size_t smem = big_smem_bytes<T>(N, dh);
  int dev = 0, cap = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&cap, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  if (smem > (size_t)cap) return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(bigattn_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  bigattn_kernel<T><<<dim3(heads, B), 256, smem, s>>>((const T*)ln1, (const T*)qkv_w, (T*)out, N, C, heads, scale);
  return (int)cudaGetLastError();
}

}  // namespace mvdf

using namespace mvdf;

// K5: the whole site in one cooperative launch. a2_div: N for a (B, C) attn2
// row, 1 for a (B, N, C) map. Workspace: stats (B * 32 * 2 fp32), A and H
// (B N C), big (B N max(3C, inner)), stamps (13 uint64: the start and
// the end of each of the 11 phases, then the number of blocks launched).
MVDF_API int mvdf_block_single(const void* x, const void* a2, int a2_div, const void* gn_w, const void* gn_b,
                               const void* pi_w, const void* pi_b, const void* ln1_w, const void* ln1_b,
                               const void* qkv_w, const void* out_w, const void* out_b, const void* ln3_w,
                               const void* ln3_b, const void* g_w, const void* g_b, const void* f_w, const void* f_b,
                               const void* po_w, const void* po_b, void* out, void* stats, void* A, void* H, void* big,
                               void* stamps, int B, int N, int C, int heads, int inner, float gn_eps, float ln_eps, int dtype,
                               void* stream) {
  if (C % GN_GROUPS || C % heads || C > 1024 || C % 8 || inner % 32) return (int)cudaErrorInvalidValue;
  SiteParams p;
  p.x = x;
  p.a2 = a2;
  p.a2_div = a2_div > 0 ? a2_div : 1;
  p.gn_w = (const float*)gn_w;
  p.gn_b = (const float*)gn_b;
  p.pi_w = pi_w;
  p.pi_b = (const float*)pi_b;
  p.ln1_w = (const float*)ln1_w;
  p.ln1_b = (const float*)ln1_b;
  p.qkv_w = qkv_w;
  p.out_w = out_w;
  p.out_b = (const float*)out_b;
  p.ln3_w = (const float*)ln3_w;
  p.ln3_b = (const float*)ln3_b;
  p.g_w = g_w;
  p.g_b = (const float*)g_b;
  p.f_w = f_w;
  p.f_b = (const float*)f_b;
  p.po_w = po_w;
  p.po_b = (const float*)po_b;
  p.out = out;
  p.stats = (float*)stats;
  p.A = A;
  p.H = H;
  p.big = big;
  p.stamps = (unsigned long long*)stamps;
  p.B = B;
  p.N = N;
  p.C = C;
  p.heads = heads;
  p.inner = inner;
  p.gn_eps = gn_eps;
  p.ln_eps = ln_eps;
  const int dh = C / heads;
  p.scale = (float)(1.0 / sqrt((double)dh));  // as the wrappers' float(dh ** -0.5)
  p.scale_log2 = p.scale * 1.4426950408889634f;
  const int esz = dtype == DT_BF16 ? 2 : 4;
  p.bk = 64;  // the fp32 loop's key tile, its two stages inside the GEMM tile's shared memory
  while (p.bk > 8 && 2 * p.bk * dh * esz > GEMM_SMEM_BYTES) p.bk >>= 1;
  cudaStream_t s = (cudaStream_t)stream;
  return dtype == DT_BF16 ? dispatch_site<bf16>(p, s) : dispatch_site<float>(p, s);
}

// K6's attention: ln1 (B, N, C), qkv_w (3C, C), out (B, N, C).
MVDF_API int mvdf_big_attention(const void* ln1, const void* qkv_w, void* out, int B, int N, int C, int heads,
                                float scale, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return dtype == DT_BF16 ? launch_bigattn<bf16>(ln1, qkv_w, out, B, N, C, heads, scale, s)
                          : launch_bigattn<float>(ln1, qkv_w, out, B, N, C, heads, scale, s);
}
