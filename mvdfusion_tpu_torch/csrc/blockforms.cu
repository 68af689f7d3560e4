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
// over its tiles, the phases separated by grid-wide barriers; the
// intermediates live in a workspace the wrapper allocates once per shape.
// Bound on the H100: operations (at B=16, N=1024, C=320: ~60 GFLOP against
// ~40 MB). In bf16:
// - the six products run on wgmma fed by TMA: one 64 x 128 output tile a
//   block at a time (m64n128k16, the block's one warpgroup), K in 64-deep
//   slices through a ring of two shared-memory stages that one
//   thread keeps full (cp.async.bulk.tensor, 128-byte swizzle, zeros past
//   the edges; the stage's mbarrier completes on the bytes), the ring's
//   barriers and slice counter carried across all six phases; each tile's
//   sums go through
//   gemm_sm90.cu's epilogue (gemm.cuh: sm90::pass2, of the kind K3's call
//   takes), so K5 rounds where K3 rounds. The tensor maps of the
//   workspace and of the prepared weights come in one __grid_constant__
//   parameter. An epilogue writes through the generic proxy and the next
//   phase reads through TMA: every thread fences the async proxy before
//   each grid barrier;
// - the ring, the epilogue's fp32 staging tile (which aliases the ring: no
//   copy is in flight between a tile's products and its epilogue) and the
//   attention tile's two-stage ring share one dynamic buffer, small enough
//   that four blocks fit an SM: the attention phase (K2's
//   tensor-core tile, attention.cuh, rounding the normalised probabilities)
//   runs faster with more blocks in flight;
// - the GroupNorm takes 16-byte rows: per-(batch, 32-row chunk) partial
//   sums in a fixed order, then each apply tile folds its batch's partials
//   into the group statistics; the LayerNorm rows are K3's (gemm.cuh ln_row)
//   with the lanes a row that block.cu's kernel takes.
// The fp32 instantiations (the small correctness cases) keep gemm.cuh's
// CUDA-core GEMM tile, the strided GroupNorm and the warp-a-row LayerNorm.
//
// K6's kernel replaces _bigattn_stream_kernel (:370, called at :651), the
// attention of the big-C form (MVDF_BLOCK_BIGC=1: the C=1280 sites with
// 64 <= N <= 256): each head's q, k and v projected from LN1 and attended
// without writing the (B, N, 3C) qkv to device memory, rounding where the
// TPU kernel does: q, k and v to the input type; fp32 logits; exp((l -
// max) * scale) divided by its sum and rounded; PV rounded once. The TPU
// kernel's lane packing of several batch elements and its block-diagonal
// mask existed for Mosaic's 128-lane tiles; here a warpgroup's rows lie in
// one batch element. Bound on the H100: operations (2 N C 3C a batch
// element for the projections; at B=16, N=64, C=1280: 10 GFLOP), and the
// head's weights (1.2 MB) read through L2 by every block of the head. Two
// routes, by shape:
// - bigattn_sm90_kernel (bf16, dh = 160, N = 64 or 128: the 8^2 sites): a
//   block holds one head and 64 x CONS token rows (whole batch elements,
//   one consumer warpgroup a 64-row slice); a producer warp streams 64-deep
//   slices of those rows and of the head's K, V and Q weight rows (TMA boxes
//   of 160 rows) through a ring; the warpgroups take m64n160k16 wgmma
//   products, round K and V into shared memory and Q into registers as
//   mma.sync A fragments (the accumulator's layout is the fragment's), then
//   each warp attends its 16 queries against the batch element's keys on
//   the tensor cores (mma.sync + ldmatrix, as K2's tile) with the logits in
//   registers: one pass, since all keys are at hand;
// - bigattn_kernel (fp32, and bf16 at the other shapes: N = 192, 256 from
//   the 512^2 stretch): one block per (head, batch) projects that head's K
//   and V for all N tokens into shared memory on WMMA tiles, then Q 64 rows
//   at a time, and attends one query per warp on the CUDA cores.
#include <cooperative_groups.h>

#include <type_traits>

#include "attention.cuh"
#include "gemm.cuh"

namespace cg = cooperative_groups;

namespace mvdf {

constexpr int GN_GROUPS = 32;
constexpr int SITE_GN_ROWS = 32;  // rows of a bf16 GroupNorm tile (ops/block.py::SITE_GN_ROWS)

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
  // workspace: GN statistics (fp32: mean and rstd per (batch, group); bf16:
  // the partial sums per (batch, chunk, group)); two (M, C) buffers and one
  // (M, max(3C, inner)) buffer; 12 globaltimer stamps and the grid's size
  float* stats;
  void *A, *H, *big;
  unsigned long long* stamps;
  int B, N, C, heads, inner, bk;
  int dp, buf;  // bf16: dh padded to 16 (the attention tile's DP); the shared buffer's bytes before the barriers
  float gn_eps, ln_eps, scale, scale_log2;
};

// bf16: the tensor maps of the products' operands, in the order of
// ops/block.py::SITE_MAPS: A (M, C), H (M, C), big (M, inner) in 64-row
// boxes; the prepared weights in 128-row boxes
struct SiteMaps {
  CUtensorMap a, h, big, pi, qkv, out, g, f, po;
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

// fp32: gemm.cuh's CUDA-core tile
template <typename T>
__device__ __forceinline__ void gemm_phase(const T* A, const T* W, int N, int K, const Epilogue& e,
                                           unsigned char* smem) {
  const int tn = (N + BN - 1) / BN, tiles = ((e.M + BM - 1) / BM) * tn;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) gemm_tile(A, W, N, K, e, (t / tn) * BM, (t % tn) * BN, smem);
}

// ------------------------------------------------------- K5's bf16 products
namespace k5 {
// a ring of two stages and four blocks an SM: three stages or three blocks
// an SM measured slower (PERF.md)
constexpr int BM = 64, BN = 128, STAGES = 2, MIN_BLOCKS = 4;
constexpr int A_STAGE = BM * sm90::TMA_BK * 2, W_STAGE = BN * sm90::TMA_BK * 2;
constexpr int STAGE = A_STAGE + W_STAGE;  // a multiple of 1024: every stage keeps the swizzle's alignment
constexpr int RING = STAGES * STAGE;
constexpr int STAGING = BM * sm90::EPI_LDS * 4;  // pass 1's fp32 tile, over the ring

// the one dynamic buffer of every phase (1024-aligned): the ring, or the
// attention tile's (`attn` bytes) where that is larger; the ring's barriers
// after it
inline int buffer_bytes(int attn) {
  const int b = RING > STAGING ? RING : STAGING;
  return b > attn ? b : attn;
}
inline int smem_bytes(int attn) { return buffer_bytes(attn) + 2 * STAGES * 8 + 1024; }  // + alignment slack
}  // namespace k5

// The ring of one block: STAGES stages of (A box, W box), `full` completing
// on a stage's bytes, `empty` on its four warps' release; `it` counts the
// slices this block has consumed since the launch.
struct Ring {
  unsigned char* buf;
  uint64_t *full, *empty;
  uint32_t it;
};

// epilogue(A @ W^T) over (M = e.M, N) in 64 x 128 tiles, a tile a block at a
// time; tmA in 64-row boxes, tmW in 128-row boxes, K % 8 == 0. KIND is
// epilogue_kind(e), the kind K3's call takes (ops/block.py::site_gemm_phases):
// each phase compiles its own pass 2 only. Inlined: out of line it measured
// ~20% slower, its pointers to the ring and staging tile generic.
template <int KIND>
__device__ __forceinline__ void tma_gemm_phase(const CUtensorMap* tmA, const CUtensorMap* tmW, int N, int K,
                                               const Epilogue& e, Ring& ring) {
  using namespace sm90;
  const int tn = (N + k5::BN - 1) / k5::BN, tiles = ((e.M + k5::BM - 1) / k5::BM) * tn;
  const int nk = (K + TMA_BK - 1) / TMA_BK, tid = threadIdx.x, lane = tid & 31;
  float* stage = reinterpret_cast<float*>(ring.buf);
  // slice g of the launch (slice kb of the tile at (m0, n0)) into its stage,
  // once the slice STAGES before it has been released
  auto load = [&](uint32_t g, int kb, int m0, int n0) {
    const int s = g % k5::STAGES;
    mbar_wait(&ring.empty[s], ((g / k5::STAGES) & 1) ^ 1);  // a fresh barrier passes parity 1
    mbar_expect_tx(&ring.full[s], k5::STAGE);
    unsigned char* dst = ring.buf + s * k5::STAGE;
    tma_load(dst, tmA, kb * TMA_BK, m0, &ring.full[s]);
    tma_load(dst + k5::A_STAGE, tmW, kb * TMA_BK, n0, &ring.full[s]);
  };
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int m0 = (t / tn) * k5::BM, n0 = (t % tn) * k5::BN;
    if (tid == 0)
      for (int j = 0; j < k5::STAGES && j < nk; ++j) load(ring.it + j, j, m0, n0);
    // zeroed here, not once before the loop: the first product ignores them,
    // but as its operands they would otherwise stay live through the
    // previous tile's epilogue (64 registers more there, and spills)
    float d[k5::BN / 2];
#pragma unroll
    for (int i = 0; i < k5::BN / 2; ++i) d[i] = 0.0f;
    int prev = -1;
    for (int kb = 0; kb < nk; ++kb) {
      const uint32_t g = ring.it + kb;
      const int s = g % k5::STAGES;
      mbar_wait(&ring.full[s], (g / k5::STAGES) & 1);
      const unsigned char* a = ring.buf + s * k5::STAGE;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TMA_BK / 16; ++kk)
        wgmma_n128(d, sw128_desc(a + kk * 32), sw128_desc(a + k5::A_STAGE + kk * 32), (kb | kk) != 0);
      wgmma_commit();
      wgmma_wait<1>();  // the previous slice's products are done: release its stage, refill it
      if (prev >= 0) {
        if (lane == 0) mbar_arrive(&ring.empty[prev]);
        if (tid == 0 && kb - 1 + k5::STAGES < nk) load(g - 1 + k5::STAGES, kb - 1 + k5::STAGES, m0, n0);
      }
      prev = s;
    }
    wgmma_wait<0>();
    wgmma_fence_operand(d);
    if (lane == 0) mbar_arrive(&ring.empty[prev]);
    ring.it += nk;
    __syncthreads();  // every warp's products have read the ring: the staging tile overwrites it
    const int sr = (tid >> 5) * 16 + (lane >> 2), sc = 2 * (lane & 3);
#pragma unroll
    for (int i = 0; i < k5::BN / 8; ++i) {
      *reinterpret_cast<float2*>(stage + sr * EPI_LDS + 8 * i + sc) = make_float2(d[4 * i], d[4 * i + 1]);
      *reinterpret_cast<float2*>(stage + (sr + 8) * EPI_LDS + 8 * i + sc) = make_float2(d[4 * i + 2], d[4 * i + 3]);
    }
    __syncthreads();
    pass2<KIND == EK_GEGLU, KIND>(stage, e, m0, n0, tid);
    fence_proxy_async_shared();  // the staging tile's generic accesses before the next copies overwrite it
    __syncthreads();
  }
}

// K3's LayerNorm row (ln_row), a group of lanes a row. bf16: the lanes a row
// that block.cu's kernel takes (five 16-byte vectors a lane, C <= 1280;
// measured faster than four lanes of ten vectors at C = 320); fp32: a warp
// a row, C <= 1024.
template <typename T, int L, int VPL>
__device__ __forceinline__ void layernorm_rows(const T* x, const float* g, const float* b, T* y, int64_t M, int C,
                                               float eps) {
  constexpr int RPB = 128 / L;  // rows a block at a time; every lane of a warp runs every round
  for (int64_t r0 = (int64_t)blockIdx.x * RPB; r0 < M; r0 += (int64_t)gridDim.x * RPB) {
    const int64_t row = r0 + threadIdx.x / L;
    ln_row<T, L, VPL>(x, g, b, y, row, row < M, C, eps);
  }
}

template <typename T>
__device__ __forceinline__ void layernorm_phase(const T* x, const float* g, const float* b, T* y, int64_t M, int C,
                                                float eps) {
  if constexpr (std::is_same<T, bf16>::value) {
    const int nv = C / 8;
    if (nv <= 20)
      layernorm_rows<T, 4, 5>(x, g, b, y, M, C, eps);
    else if (nv <= 40)
      layernorm_rows<T, 8, 5>(x, g, b, y, M, C, eps);
    else if (nv <= 80)
      layernorm_rows<T, 16, 5>(x, g, b, y, M, C, eps);
    else
      layernorm_rows<T, 32, 5>(x, g, b, y, M, C, eps);
  } else {
    layernorm_rows<T, 32, 1024 / 32 / (16 / sizeof(T))>(x, g, b, y, M, C, eps);
  }
}

// bf16 GroupNorm statistics: tile (batch b, chunk ch) sums rows ch*R .. +R
// of x[b] per channel, each thread one 16-byte column of channels over every
// `lanes`-th row, then per group in a fixed order -> part[b][ch][g] = (sum,
// sum of squares). C <= 1024.
__device__ __forceinline__ void gn_partials_phase(const bf16* x, float* part, int B, int N, int C,
                                                  unsigned char* smem) {
  const int nv = C / 8, lanes = blockDim.x / nv, cpg = C / GN_GROUPS, nch = (N + SITE_GN_ROWS - 1) / SITE_GN_ROWS;
  const int v = threadIdx.x % nv, l = threadIdx.x / nv;
  float* red = reinterpret_cast<float*>(smem);  // (lanes, C) sums, then (lanes, C) sums of squares
  for (int t = blockIdx.x; t < B * nch; t += gridDim.x) {
    const int b = t / nch, ch = t % nch, r1 = min(N, (ch + 1) * SITE_GN_ROWS);
    float s1[8] = {}, s2[8] = {};
    if (l < lanes) {
      const bf16* xb = x + (int64_t)b * N * C + v * 8;
#pragma unroll 4
      for (int r = ch * SITE_GN_ROWS + l; r < r1; r += lanes) {
        float f[8];
        unpack16(*reinterpret_cast<const uint4*>(xb + (int64_t)r * C), f);
#pragma unroll
        for (int j = 0; j < 8; ++j) s1[j] += f[j], s2[j] += f[j] * f[j];
      }
    }
    __syncthreads();  // the previous tile's sums are read
    if (l < lanes)
#pragma unroll
      for (int j = 0; j < 8; ++j) red[l * C + v * 8 + j] = s1[j], red[(lanes + l) * C + v * 8 + j] = s2[j];
    __syncthreads();
    if (threadIdx.x < GN_GROUPS) {
      const int g = threadIdx.x;
      float a = 0.0f, q = 0.0f;
      for (int c = g * cpg; c < (g + 1) * cpg; ++c)
        for (int k = 0; k < lanes; ++k) a += red[k * C + c], q += red[(lanes + k) * C + c];
      float* o = part + ((int64_t)(b * nch + ch) * GN_GROUPS + g) * 2;
      o[0] = a;
      o[1] = q;
    }
  }
}

// bf16 GroupNorm apply over the same tiles: the batch's group statistics
// from its chunks' partial sums (in chunk order; E[x^2] - E[x]^2 clamped at
// 0, as K1), per channel in shared memory, then (x - mean) * (rstd * w) + b
// on 16-byte vectors
__device__ __forceinline__ void gn_apply_phase(const bf16* x, const float* part, const float* w, const float* bias,
                                               bf16* y, int B, int N, int C, float eps, unsigned char* smem) {
  const int nv = C / 8, lanes = blockDim.x / nv, cpg = C / GN_GROUPS, nch = (N + SITE_GN_ROWS - 1) / SITE_GN_ROWS;
  const int v = threadIdx.x % nv, l = threadIdx.x / nv;
  float* mu = reinterpret_cast<float*>(smem);
  float* sc = mu + C;
  for (int t = blockIdx.x; t < B * nch; t += gridDim.x) {
    const int b = t / nch, ch = t % nch, r1 = min(N, (ch + 1) * SITE_GN_ROWS);
    __syncthreads();  // the previous tile's channel statistics are read
    if (threadIdx.x < GN_GROUPS) {
      const int g = threadIdx.x;
      float a = 0.0f, q = 0.0f;
      for (int k = 0; k < nch; ++k) {
        const float* o = part + ((int64_t)(b * nch + k) * GN_GROUPS + g) * 2;
        a += o[0];
        q += o[1];
      }
      const float count = (float)((int64_t)N * cpg), mean = a / count;
      const float rstd = rsqrtf(fmaxf(q / count - mean * mean, 0.0f) + eps);
      for (int c = g * cpg; c < (g + 1) * cpg; ++c) mu[c] = mean, sc[c] = rstd * w[c];
    }
    __syncthreads();
    if (l < lanes) {
      const int c0 = v * 8;
      float m8[8], s8[8], b8[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) m8[j] = mu[c0 + j], s8[j] = sc[c0 + j], b8[j] = bias[c0 + j];
      const int64_t base = (int64_t)b * N * C + c0;
#pragma unroll 4
      for (int r = ch * SITE_GN_ROWS + l; r < r1; r += lanes) {
        float f[8];
        unpack16(*reinterpret_cast<const uint4*>(x + base + (int64_t)r * C), f);
#pragma unroll
        for (int j = 0; j < 8; ++j) f[j] = (f[j] - m8[j]) * s8[j] + b8[j];
        *reinterpret_cast<uint4*>(y + base + (int64_t)r * C) = pack16(f);
      }
    }
  }
}

// K5's bf16 attention phase: K2's tensor-core tile (attention.cuh) over every
// (query block, batch x head), reading q, k and v from the packed qkv rows.
// Not inlined: apart from the kernel's other phases, the tile keeps to its
// own registers (inlined, it spilled at the kernel's 128-register budget).
template <int DP>
__device__ __noinline__ void attention_phase(const bf16* qkv, bf16* out, int B, int N, int C, int heads, float scale,
                                             unsigned char* smem) {
  const int dh = C / heads, qblocks = (N + attn::QB - 1) / attn::QB;
  const int64_t sb = (int64_t)N * 3 * C;
  for (int t = blockIdx.x; t < qblocks * B * heads; t += gridDim.x)
    attn_tile_mma<DP>(qkv, qkv + C, qkv + 2 * C, out, heads, N, N, dh, sb, 3 * C, sb, 3 * C, sb, 3 * C,
                      (int64_t)N * C, C, scale, ATTN_PROBS, t % qblocks, t / qblocks, smem);
}

// the end of a phase: this thread's generic writes (device and shared
// memory) ordered before later TMA accesses, then the grid-wide barrier
__device__ __forceinline__ void phase_barrier(cg::grid_group& grid) {
  sm90::fence_proxy_async_global();
  sm90::fence_proxy_async_shared();
  grid.sync();
}

// bf16: attention.cuh's tensor-core tile with dh padded to p.dp, one build
// for every head width (the tile's own code apart, in attention_phase);
// fp32: its CUDA-core loop with TPQ threads a query, DPT dims a thread
template <typename T, int TPQ, int DPT>
__global__ void __launch_bounds__(128, std::is_same<T, bf16>::value ? k5::MIN_BLOCKS : 1)
    site_kernel(SiteParams p, const __grid_constant__ SiteMaps maps) {
  constexpr bool TC = std::is_same<T, bf16>::value;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = TC ? smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023) : smem_raw;
  cg::grid_group grid = cg::this_grid();
  const int B = p.B, N = p.N, C = p.C, cpg = C / GN_GROUPS, M = B * N;
  const T* x = reinterpret_cast<const T*>(p.x);
  T* A = reinterpret_cast<T*>(p.A);
  T* H = reinterpret_cast<T*>(p.H);
  T* big = reinterpret_cast<T*>(p.big);
  Ring ring{};
  if constexpr (TC) {
    ring.buf = smem;
    ring.full = reinterpret_cast<uint64_t*>(smem + p.buf);
    ring.empty = ring.full + k5::STAGES;
    ring.it = 0;
    if (threadIdx.x == 0) {
      for (int s = 0; s < k5::STAGES; ++s) {
        sm90::mbar_init(&ring.full[s], 1);   // the issuing thread's arrive + the copies' bytes
        sm90::mbar_init(&ring.empty[s], 4);  // lane 0 of each warp
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }
  int phase = 0;
  stamp(p.stamps, phase++);

  // 1. site GroupNorm statistics (fp32: one (batch, group) a tile, fp32
  //    sums, E[x^2] - E[x]^2 clamped at 0, as K1)
  if constexpr (TC) {
    gn_partials_phase(x, p.stats, B, N, C, smem);
  } else {
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
  }
  phase_barrier(grid);
  stamp(p.stamps, phase++);
  // 2. GroupNorm apply -> A
  if constexpr (TC) {
    gn_apply_phase(x, p.stats, p.gn_w, p.gn_b, A, B, N, C, p.gn_eps, smem);
  } else {
    const int64_t MC = (int64_t)M * C;
    for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < MC; i += (int64_t)gridDim.x * blockDim.x) {
      const int ch = (int)(i % C), b = (int)(i / ((int64_t)N * C));
      const float* st = p.stats + 2 * (b * GN_GROUPS + ch / cpg);
      A[i] = from_f<T>((to_f(x[i]) - st[0]) * (st[1] * p.gn_w[ch]) + p.gn_b[ch]);
    }
  }
  phase_barrier(grid);
  stamp(p.stamps, phase++);
  // 3. proj_in -> H (h0)
  const Epilogue e_pi = site_epilogue<T>(p.pi_b, H, nullptr, nullptr, 1, ACT_NONE, M, C);
  if constexpr (TC)
    tma_gemm_phase<sm90::EK_BIAS>(&maps.a, &maps.pi, C, C, e_pi, ring);
  else
    gemm_phase(A, (const T*)p.pi_w, C, C, e_pi, smem);
  phase_barrier(grid);
  stamp(p.stamps, phase++);
  // 4. LN1 -> A
  layernorm_phase(H, p.ln1_w, p.ln1_b, A, M, C, p.ln_eps);
  phase_barrier(grid);
  stamp(p.stamps, phase++);
  // 5. qkv -> big (M, 3C)
  const Epilogue e_qkv = site_epilogue<T>(nullptr, big, nullptr, nullptr, 1, ACT_NONE, M, 3 * C);
  if constexpr (TC)
    tma_gemm_phase<sm90::EK_BIAS>(&maps.a, &maps.qkv, 3 * C, C, e_qkv, ring);
  else
    gemm_phase(A, (const T*)p.qkv_w, 3 * C, C, e_qkv, smem);
  phase_barrier(grid);
  stamp(p.stamps, phase++);
  // 6. self-attention -> A, one (query block, batch x head) a tile; the
  //    normalised probabilities rounded, as the site kernels round them
  const int dh = C / p.heads;
  const int64_t sb = (int64_t)N * 3 * C;
  if constexpr (TC) {
    switch (p.dp) {
      case 16: attention_phase<16>(big, A, B, N, C, p.heads, p.scale, smem); break;
      case 32: attention_phase<32>(big, A, B, N, C, p.heads, p.scale, smem); break;
      case 48: attention_phase<48>(big, A, B, N, C, p.heads, p.scale, smem); break;
      case 64: attention_phase<64>(big, A, B, N, C, p.heads, p.scale, smem); break;
      case 80: attention_phase<80>(big, A, B, N, C, p.heads, p.scale, smem); break;
      case 96: attention_phase<96>(big, A, B, N, C, p.heads, p.scale, smem); break;
      case 112: attention_phase<112>(big, A, B, N, C, p.heads, p.scale, smem); break;
      default: attention_phase<128>(big, A, B, N, C, p.heads, p.scale, smem);
    }
  } else {
    const int qblocks = (N + blockDim.x / TPQ - 1) / (blockDim.x / TPQ);
    for (int t = blockIdx.x; t < qblocks * B * p.heads; t += gridDim.x)
      attn_tile<T, TPQ, DPT>(big, big + C, big + 2 * C, A, p.heads, N, N, dh, sb, 3 * C, sb, 3 * C, sb, 3 * C,
                             (int64_t)N * C, C, p.scale_log2, p.bk, t % qblocks, t / qblocks, smem);
  }
  phase_barrier(grid);
  stamp(p.stamps, phase++);
  // 7. out-proj + h0 + attn2 -> H (h2, in place)
  const Epilogue e_out = site_epilogue<T>(p.out_b, H, H, p.a2, p.a2_div, ACT_NONE, M, C);
  if constexpr (TC)
    tma_gemm_phase<sm90::EK_RES2>(&maps.a, &maps.out, C, C, e_out, ring);
  else
    gemm_phase(A, (const T*)p.out_w, C, C, e_out, smem);
  phase_barrier(grid);
  stamp(p.stamps, phase++);
  // 8. LN3 -> A
  layernorm_phase(H, p.ln3_w, p.ln3_b, A, M, C, p.ln_eps);
  phase_barrier(grid);
  stamp(p.stamps, phase++);
  // 9. GEGLU -> big (M, inner)
  const Epilogue e_g = site_epilogue<T>(p.g_b, big, nullptr, nullptr, 1, ACT_GEGLU, M, p.inner);
  if constexpr (TC)
    tma_gemm_phase<sm90::EK_GEGLU>(&maps.a, &maps.g, 2 * p.inner, C, e_g, ring);
  else
    gemm_phase(A, (const T*)p.g_w, 2 * p.inner, C, e_g, smem);
  phase_barrier(grid);
  stamp(p.stamps, phase++);
  // 10. FF + h2 -> H (h3, in place)
  const Epilogue e_f = site_epilogue<T>(p.f_b, H, H, nullptr, 1, ACT_NONE, M, C);
  if constexpr (TC)
    tma_gemm_phase<sm90::EK_RES1>(&maps.big, &maps.f, C, p.inner, e_f, ring);
  else
    gemm_phase(big, (const T*)p.f_w, C, p.inner, e_f, smem);
  phase_barrier(grid);
  stamp(p.stamps, phase++);
  // 11. proj_out + x_in -> out
  const Epilogue e_po = site_epilogue<T>(p.po_b, p.out, p.x, nullptr, 1, ACT_NONE, M, C);
  if constexpr (TC)
    tma_gemm_phase<sm90::EK_RES1>(&maps.h, &maps.po, C, C, e_po, ring);
  else
    gemm_phase(H, (const T*)p.po_w, C, C, e_po, smem);
  grid.sync();
  stamp(p.stamps, phase);
  if (blockIdx.x == 0 && threadIdx.x == 0) p.stamps[phase + 1] = gridDim.x;  // the launch's grid, for the log
}

// smem: the dynamic shared memory of every phase (bf16: k5::smem_bytes;
// fp32: the GEMM tile's)
template <typename T, int TPQ, int DPT>
static int launch_site(SiteParams p, const SiteMaps& maps, int smem, cudaStream_t s) {
  void (*kern)(SiteParams, const SiteMaps) = site_kernel<T, TPQ, DPT>;
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, 128, smem);
  if (err != cudaSuccess) return (int)err;
  if (!coop) return (int)cudaErrorNotSupported;
  if (per_sm < 1) return (int)cudaErrorLaunchOutOfResources;
  SiteMaps m = maps;
  void* args[] = {&p, &m};
  err = cudaLaunchCooperativeKernel((const void*)kern, dim3(sms * per_sm), dim3(128), args, smem, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T>
static int dispatch_site(const SiteParams& p, const SiteMaps& m, cudaStream_t s) {
  const int dh = p.C / p.heads;
  if constexpr (std::is_same<T, bf16>::value) {
    if (dh % 8 || dh > 128) return (int)cudaErrorInvalidValue;
    SiteParams q = p;
    q.dp = (dh + 15) / 16 * 16;
    int attn = attn::Tile<128>::SMEM;
    switch (q.dp) {
      case 16: attn = attn::Tile<16>::SMEM; break;
      case 32: attn = attn::Tile<32>::SMEM; break;
      case 48: attn = attn::Tile<48>::SMEM; break;
      case 64: attn = attn::Tile<64>::SMEM; break;
      case 80: attn = attn::Tile<80>::SMEM; break;
      case 96: attn = attn::Tile<96>::SMEM; break;
      case 112: attn = attn::Tile<112>::SMEM; break;
    }
    q.buf = k5::buffer_bytes(attn);
    return launch_site<T, 0, 0>(q, m, k5::smem_bytes(attn), s);
  } else {
    if (dh <= 32) return launch_site<T, 4, 8>(p, m, GEMM_SMEM_BYTES, s);
    if (dh <= 64) return launch_site<T, 4, 16>(p, m, GEMM_SMEM_BYTES, s);
    if (dh <= 128) return launch_site<T, 4, 32>(p, m, GEMM_SMEM_BYTES, s);
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


// ------------------------------------------------ K6 on the tensor cores
// d (+)= A (64x16, K-major, smem) * B (160x16, K-major, smem); 80 fp32 sums a thread
__device__ __forceinline__ void wgmma_n160(float (&d)[80], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %82, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79"
      "}, %80, %81, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
      : "l"(da), "l"(db), "r"(accumulate));
}

namespace k6 {
constexpr int DH = 160;                           // the head width the tile takes (C = 1280, 8 heads)
constexpr int LD = DH + 8;                        // a K or V row in shared memory: 21 16-byte units (odd: ldmatrix
                                                  // reads without bank conflicts, as K2's tile)
constexpr int W_STAGE = DH * sm90::TMA_BK * 2;    // one 64-deep slice of a head's 160 weight rows
template <int CONS>
struct Cfg {
  static constexpr int ROWS = 64 * CONS;          // token rows a block
  static constexpr int THREADS = 128 * CONS + 32; // consumer warpgroups, one producer warp
  static constexpr int A_STAGE = ROWS * sm90::TMA_BK * 2;
  static constexpr int STAGE = A_STAGE + W_STAGE; // a multiple of 1024
  static constexpr int STAGES = CONS == 2 ? 3 : 4;
  static constexpr int RING = STAGES * STAGE;
  static constexpr int KV = 2 * ROWS * LD * 2;    // the block's K and V rows, bf16
  static constexpr int SMEM = RING + KV + 2 * STAGES * 8 + 1024;  // + the ring's barriers, alignment slack
};
}  // namespace k6

// grid (heads, ceil(B N / ROWS)); ln1 (B N, C) through tmX in ROWS-row boxes,
// qkv_w (3C, C) rows [Wq; Wk; Wv] through tmW in 160-row boxes; out (B N, C).
// NK = N keys (64 or 128; ROWS % NK == 0), C % 64 == 0. Block y holds rows
// y ROWS .. +ROWS; warpgroup w the 64 rows from y ROWS + 64 w, which lie in
// one batch element (ops/block.py::big_attention_plan); rows past B N are
// zero-filled by TMA and never stored.
template <int CONS, int NK>
__global__ void __launch_bounds__(k6::Cfg<CONS>::THREADS, 1)
    bigattn_sm90_kernel(const __grid_constant__ CUtensorMap tmX, const __grid_constant__ CUtensorMap tmW,
                        bf16* __restrict__ out, int M, int C, float scale) {
  using namespace sm90;
  using Cfg = k6::Cfg<CONS>;
  constexpr int LD = k6::LD, STAGES = Cfg::STAGES;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* ring = smem;
  bf16* Ks = reinterpret_cast<bf16*>(smem + Cfg::RING);
  bf16* Vs = Ks + Cfg::ROWS * LD;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + Cfg::RING + Cfg::KV);
  uint64_t* empty = full + STAGES;
  const int h = blockIdx.x, row0 = blockIdx.y * Cfg::ROWS, nk = C / TMA_BK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * CONS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * CONS) {  // the producer: the head's K, V, then Q weight rows, each against all of the rows' C
    if (lane == 0) {
      int it = 0;
      for (int p = 0; p < 3; ++p) {
        const int wrow = ((p + 1) % 3) * C + h * k6::DH;
        for (int kb = 0; kb < nk; ++kb, ++it) {
          const int s = it % STAGES;
          mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
          mbar_expect_tx(&full[s], Cfg::STAGE);
          tma_load(ring + s * Cfg::STAGE, &tmX, kb * TMA_BK, row0, &full[s]);
          tma_load(ring + s * Cfg::STAGE + Cfg::A_STAGE, &tmW, kb * TMA_BK, wrow, &full[s]);
        }
      }
    }
    return;  // the consumers synchronise among themselves (named barrier 1)
  }

  const int wg = threadIdx.x >> 7, wq = warp & 3, r = lane >> 2, c = lane & 3;
  unsigned qa[k6::DH / 16][4];  // Q's mma.sync A fragments, bf16
  int it = 0;
  for (int p = 0; p < 3; ++p) {
    float d[80];  // zeroed a product, so that no product's sums stay live through the previous one's stores
#pragma unroll
    for (int i = 0; i < 80; ++i) d[i] = 0.0f;
    int prev = -1;
    for (int kb = 0; kb < nk; ++kb, ++it) {
      const int s = it % STAGES;
      mbar_wait(&full[s], (it / STAGES) & 1);
      const unsigned char* a = ring + s * Cfg::STAGE + wg * (64 * TMA_BK * 2);
      const unsigned char* w = ring + s * Cfg::STAGE + Cfg::A_STAGE;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TMA_BK / 16; ++kk)
        wgmma_n160(d, sw128_desc(a + kk * 32), sw128_desc(w + kk * 32), (kb | kk) != 0);
      wgmma_commit();
      wgmma_wait<1>();
      if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
      prev = s;
    }
    wgmma_wait<0>();
    wgmma_fence_operand(d);
    if (lane == 0) mbar_arrive(&empty[prev]);
    if (p < 2) {  // K or V: rows 64 wg + 16 wq + r (and + 8), rounded, into shared memory
      bf16* dst = (p == 0 ? Ks : Vs) + (64 * wg + 16 * wq + r) * LD + 2 * c;
#pragma unroll
      for (int i = 0; i < k6::DH / 8; ++i) {
        *reinterpret_cast<unsigned*>(dst + 8 * i) = pack_bf16(d[4 * i], d[4 * i + 1]);
        *reinterpret_cast<unsigned*>(dst + 8 * LD + 8 * i) = pack_bf16(d[4 * i + 2], d[4 * i + 3]);
      }
    } else {  // Q, rounded: the m64 accumulator's rows and columns are the A fragments' of the warp's 16 rows
#pragma unroll
      for (int ks = 0; ks < k6::DH / 16; ++ks) {
        qa[ks][0] = pack_bf16(d[8 * ks], d[8 * ks + 1]);
        qa[ks][1] = pack_bf16(d[8 * ks + 2], d[8 * ks + 3]);
        qa[ks][2] = pack_bf16(d[8 * ks + 4], d[8 * ks + 5]);
        qa[ks][3] = pack_bf16(d[8 * ks + 6], d[8 * ks + 7]);
      }
    }
  }
  named_barrier(1, 128 * CONS);  // every warpgroup's K and V rows are in shared memory

  // S (16 x NK a warp) = Q K^T in fp32, against the keys of this warpgroup's batch element
  const int kb0 = (64 * wg / NK) * NK;
  const bf16* Kb = Ks + kb0 * LD;
  const bf16* Vb = Vs + kb0 * LD;
  float s[NK / 8][4];
#pragma unroll
  for (int n = 0; n < NK / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
#pragma unroll
  for (int ks = 0; ks < k6::DH / 16; ++ks)
#pragma unroll
    for (int np = 0; np < NK / 16; ++np) {
      unsigned bk[4];
      ldsm_x4(bk, Kb + (np * 16 + (lane & 7) + (lane >> 4) * 8) * LD + ks * 16 + ((lane >> 3) & 1) * 8);
      mma_bf16(s[2 * np], qa[ks], bk[0], bk[1]);
      mma_bf16(s[2 * np + 1], qa[ks], bk[2], bk[3]);
    }
  // the reference's softmax: the max over the raw logits, exp((l - max) *
  // scale) over its fp32 sum, rounded (rows r and r + 8; a row's 4 lanes)
  float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
  for (int n = 0; n < NK / 8; ++n) {
    m0 = fmaxf(m0, fmaxf(s[n][0], s[n][1]));
    m1 = fmaxf(m1, fmaxf(s[n][2], s[n][3]));
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, off));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, off));
  }
  float l0 = 0.0f, l1 = 0.0f;
#pragma unroll
  for (int n = 0; n < NK / 8; ++n)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      s[n][e] = expf((s[n][e] - m0) * scale);
      s[n][2 + e] = expf((s[n][2 + e] - m1) * scale);
      l0 += s[n][e];
      l1 += s[n][2 + e];
    }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  // P as PV's A fragments (two 8-key sum tiles make one 16-key A tile)
  unsigned pa[NK / 16][4];
#pragma unroll
  for (int n = 0; n < NK / 8; ++n) {
    pa[n >> 1][(n & 1) * 2] = pack_bf16(s[n][0] / l0, s[n][1] / l0);
    pa[n >> 1][(n & 1) * 2 + 1] = pack_bf16(s[n][2] / l1, s[n][3] / l1);
  }
  // O = P V in fp32, rounded once
  float o[k6::DH / 8][4];
#pragma unroll
  for (int n = 0; n < k6::DH / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < NK / 16; ++kk)
#pragma unroll
    for (int dp = 0; dp < k6::DH / 16; ++dp) {
      unsigned bv[4];
      ldsm_x4_t(bv, Vb + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + dp * 16 + (lane >> 4) * 8);
      mma_bf16(o[2 * dp], pa[kk], bv[0], bv[1]);
      mma_bf16(o[2 * dp + 1], pa[kk], bv[2], bv[3]);
    }
  const int g0 = row0 + 64 * wg + 16 * wq + r, g1 = g0 + 8;
  bf16* o0 = out + (int64_t)g0 * C + h * k6::DH + 2 * c;
  bf16* o1 = out + (int64_t)g1 * C + h * k6::DH + 2 * c;
#pragma unroll
  for (int n = 0; n < k6::DH / 8; ++n) {
    if (g0 < M) *reinterpret_cast<unsigned*>(o0 + 8 * n) = pack_bf16(o[n][0], o[n][1]);
    if (g1 < M) *reinterpret_cast<unsigned*>(o1 + 8 * n) = pack_bf16(o[n][2], o[n][3]);
  }
}

template <int CONS, int NK>
static int launch_bigattn_sm90(const void* ln1, const void* w_desc, void* out, int B, int N, int C, int heads,
                               float scale, cudaStream_t s) {
  using Cfg = k6::Cfg<CONS>;
  static bool ready = false;
  if (!ready) {
    const cudaError_t rc = cudaFuncSetAttribute(bigattn_sm90_kernel<CONS, NK>,
                                                cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::SMEM);
    if (rc != cudaSuccess) return (int)rc;
    ready = true;
  }
  CUtensorMap tmX, tmW;
  const int rc = sm90::encode(&tmX, ln1, B * N, C, Cfg::ROWS);
  if (rc) return rc;
  memcpy(&tmW, w_desc, sizeof(tmW));
  const dim3 grid(heads, (B * N + Cfg::ROWS - 1) / Cfg::ROWS);
  bigattn_sm90_kernel<CONS, NK><<<grid, Cfg::THREADS, Cfg::SMEM, s>>>(tmX, tmW, (bf16*)out, B * N, C, scale);
  return (int)cudaGetLastError();
}

}  // namespace mvdf

using namespace mvdf;

// K5: the whole site in one cooperative launch. a2_div: N for a (B, C) attn2
// row, 1 for a (B, N, C) map. Workspace: stats (B * 32 * 2 fp32, or in bf16
// B * ceil(N / 32) * 32 * 2), A and H (B N C), big (B N max(3C, inner)),
// stamps (13 uint64: the start and the end of each of the 11 phases, then
// the number of blocks launched). maps (bf16; host memory): the nine 128-byte
// tensor maps of SiteMaps, in its order.
MVDF_API int mvdf_block_single(const void* x, const void* a2, int a2_div, const void* gn_w, const void* gn_b,
                               const void* pi_w, const void* pi_b, const void* ln1_w, const void* ln1_b,
                               const void* qkv_w, const void* out_w, const void* out_b, const void* ln3_w,
                               const void* ln3_b, const void* g_w, const void* g_b, const void* f_w, const void* f_b,
                               const void* po_w, const void* po_b, void* out, void* stats, void* A, void* H, void* big,
                               void* stamps, const void* maps, int B, int N, int C, int heads, int inner,
                               float gn_eps, float ln_eps, int dtype, void* stream) {
  if (C % GN_GROUPS || C % heads || C > 1024 || C % 8 || inner % 32) return (int)cudaErrorInvalidValue;
  if (dtype == DT_BF16 && (!maps || C % 64 || inner % 64)) return (int)cudaErrorInvalidValue;
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
  p.dp = p.buf = 0;  // bf16: set where the launch is chosen (dispatch_site)
  p.gn_eps = gn_eps;
  p.ln_eps = ln_eps;
  const int dh = C / heads;
  p.scale = (float)(1.0 / sqrt((double)dh));  // as the wrappers' float(dh ** -0.5)
  p.scale_log2 = p.scale * 1.4426950408889634f;
  const int esz = dtype == DT_BF16 ? 2 : 4;
  p.bk = 64;  // the fp32 loop's key tile, its two stages inside the GEMM tile's shared memory
  while (p.bk > 8 && 2 * p.bk * dh * esz > GEMM_SMEM_BYTES) p.bk >>= 1;
  SiteMaps m;
  memset(&m, 0, sizeof(m));
  if (maps) memcpy(&m, maps, sizeof(m));
  cudaStream_t s = (cudaStream_t)stream;
  return dtype == DT_BF16 ? dispatch_site<bf16>(p, m, s) : dispatch_site<float>(p, m, s);
}

// K6's attention: ln1 (B, N, C), qkv_w (3C, C), out (B, N, C). w_desc:
// qkv_w's tensor map in 160-row boxes (mvdf_tma_desc), or null for the
// CUDA-core kernel; with it, bf16, C / heads == 160, N == 64 or 128 and
// C % 64 == 0, the tensor-core kernel with `consumers` warpgroups a block
// (N == 64: 1 or 2; N == 128: 2).
MVDF_API int mvdf_big_attention(const void* ln1, const void* qkv_w, const void* w_desc, void* out, int B, int N,
                                int C, int heads, float scale, int dtype, int consumers, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (w_desc) {
    if (dtype != DT_BF16 || C % heads || C / heads != k6::DH || C % sm90::TMA_BK || (uintptr_t)ln1 % 16 ||
        (uintptr_t)out % 16)
      return (int)cudaErrorInvalidValue;
    if (N == 64 && consumers == 1) return launch_bigattn_sm90<1, 64>(ln1, w_desc, out, B, N, C, heads, scale, s);
    if (N == 64 && consumers == 2) return launch_bigattn_sm90<2, 64>(ln1, w_desc, out, B, N, C, heads, scale, s);
    if (N == 128 && consumers == 2) return launch_bigattn_sm90<2, 128>(ln1, w_desc, out, B, N, C, heads, scale, s);
    return (int)cudaErrorInvalidValue;
  }
  return dtype == DT_BF16 ? launch_bigattn<bf16>(ln1, qkv_w, out, B, N, C, heads, scale, s)
                          : launch_bigattn<float>(ln1, qkv_w, out, B, N, C, heads, scale, s);
}
