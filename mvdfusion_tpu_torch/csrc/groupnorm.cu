// K1 and K7: GroupNorm(32) (+SiLU) over channels-last (B, N, C) activations.
//
// K1 replaces mvdfusion_tpu/ops/groupnorm.py::_gn_kernel (called from
// _gn_fwd_impl). Bound on the H100: bytes -- about 10 flops per element
// against 2 bytes read and 2 written (bf16), far below the ~295 flop/byte
// ridge. Design: one pass per sample over a thread block cluster of k CTAs
// (k in 1..16, chosen per shape by ops/groupnorm.py::plan_group_norm). Each
// CTA reads its share of the sample's rows once, as 16-byte vectors (a thread
// owns 16 bytes of channels: 8 in bf16, 4 in fp32, at a fixed column, over
// every P-th row), sums each channel in fp32 on the way and keeps the rows in
// shared memory. The per-thread channel sums are added in a fixed order into
// per-channel sums, those into per-group sums (a vector may straddle two
// groups: cg = C/32 is 10, 20 or 30 in the UNet), and after cluster.sync()
// every CTA adds the k CTAs' group sums, read through distributed shared
// memory in rank order: every CTA gets the same statistics on every run, with
// no atomics. Each CTA then normalises its rows from shared memory and writes
// them once: device memory sees one read and one write per element, in one
// launch. A second cluster barrier keeps each CTA's sums alive until every
// CTA of its cluster has read them. Where a CTA's rows do not fit its shared
// memory (fp32 at the largest maps, off the main path) it reads them again in
// the second pass. The TPU kernel's (C, G) segment-matrix products exist only
// for Mosaic's lane layout and are gone.
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
#include <cooperative_groups.h>

#include <algorithm>

#include "common.cuh"

namespace mvdf {

namespace cg = cooperative_groups;

// K1's limits, shared with ops/groupnorm.py (GN_MAX_THREADS, GN_MAX_CLUSTER,
// GN_SMEM_MAX, GN_MAX_LANES)
constexpr int GN_MAX_THREADS = 640, GN_MAX_CLUSTER = 16, GN_SMEM_MAX = 232448, GN_MAX_LANES = 16;
constexpr int GN_UNROLL = 4;  // 16-byte vectors a thread handles per step
constexpr int GN_CHUNKS = 4;  // cp.async groups of a CTA's rows (the chunk size shifts by 2)
constexpr int GN_SUB = 4;     // threads that share one group's channel sums

// relaxed: what it orders is this CTA's reads of the others' sums, which are
// complete once their values are used
__device__ __forceinline__ void cluster_arrive() { asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void cluster_wait() { asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory"); }

// Where `stamps` is given, CTA (0, 0) stamps the device clock (ns) at the
// start and at the end of each of its GN_PHASES steps into stamps[0..7], and
// every CTA its start and end into stamps[8 + 2 * cta], [9 + 2 * cta]
// (ops/groupnorm.py::K1_PHASES; chip_smoke.py --k1-sweep reads them).
__device__ __forceinline__ unsigned long long gn_clock() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
__device__ __forceinline__ void gn_stamp(unsigned long long* stamps, int i) {
  if (stamps && threadIdx.x == 0) {
    const unsigned long long t = gn_clock();
    const int cta = blockIdx.y * gridDim.x + blockIdx.x;
    if (cta == 0 && i < 8) stamps[i] = t;
    if (i == 0) stamps[8 + 2 * cta] = t;
    if (i == 7) stamps[9 + 2 * cta] = t;
  }
}

// silu(o) = o / (1 + exp(-o)) from the fast exponential and division (two
// special-function operations, which bound the second pass; relative error
// ~1e-6, far below a bf16 ulp; o < -88 gives -0 as the exact form)
__device__ __forceinline__ float silu_f(float o) { return __fdividef(o, 1.0f + __expf(-o)); }

// the value at shared-memory address `p` of this CTA in CTA `rank` of its
// cluster (distributed shared memory)
__device__ __forceinline__ float ld_cluster(const float* p, int rank) {
  unsigned a = (unsigned)__cvta_generic_to_shared(p), r;
  float v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(a), "r"(rank));
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(r) : "memory");
  return v;
}

// K1's launch parameters, derived once per shape on the host
// (ops/groupnorm.py::plan_group_norm; gn_launch checks them)
struct GNParams {
  const void* x;
  const float* gamma;
  const float* beta;
  void* y;
  unsigned long long* stamps;
  int N, C, G, cg;  // rows and channels of a sample, groups, channels a group
  int rows;         // rows a CTA
  int lp;           // log2 of P, the row lanes of a channel vector
  int ld;           // the rows' stride in shared memory, in 16-byte vectors (gn_stride)
  float inv_cnt;    // 1 / (N cg)
  float eps;
  int silu;
};

// One CTA of a sample's cluster: rows [rank * rows, min(N, (rank + 1) * rows))
// of sample blockIdx.y, C / VEC 16-byte vectors a row (VEC channels each).
// Thread t owns channel vector t / P and row lane t % P (rows lane, lane +
// P, ...): the P lanes of a vector sit in one warp, so a warp reads P rows
// of 32 / P vectors and the lanes add their channel sums with shuffles.
// RESIDENT: the CTA copies its rows into shared memory with cp.async in
// GN_CHUNKS groups (every copy in flight at once, no registers held) and
// sums each group of rows while the later ones arrive; both passes read the
// rows there. Otherwise (fp32 at the largest maps) both read device memory.
// Shared memory: the rows (stride ld), the CTA's channel sums (2, C), its
// group sums (2, G), mean and rstd (2, G).
template <typename T, bool RESIDENT>
__global__ void __launch_bounds__(GN_MAX_THREADS) gn_cluster_kernel(const GNParams p) {
  constexpr int VEC = 16 / sizeof(T), LV = VEC == 8 ? 3 : 2;
  extern __shared__ __align__(16) unsigned char smem[];
  gn_stamp(p.stamps, 0);
  cg::cluster_group cluster = cg::this_cluster();
  const int k = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int C = p.C, G = p.G, P = 1 << p.lp, CV = C >> LV, tid = threadIdx.x, nt = blockDim.x;
  const int cv = tid >> p.lp, lane = tid & (P - 1);
  const bool active = cv < CV;
  const int r0 = rank * p.rows, nr = max(0, min(p.N, r0 + p.rows) - r0);
  const int64_t base = ((int64_t)blockIdx.y * p.N + r0) * C;
  const uint4* xv = reinterpret_cast<const uint4*>(reinterpret_cast<const T*>(p.x) + base) + cv;
  uint4* yv = reinterpret_cast<uint4*>(reinterpret_cast<T*>(p.y) + base) + cv;
  uint4* slice = reinterpret_cast<uint4*>(smem) + cv;
  float* chan = reinterpret_cast<float*>(smem + (RESIDENT ? (size_t)p.rows * p.ld * 16 : 0));
  float* grp = chan + 2 * C;
  float* stat = grp + 2 * G;
  // the affine's operands, in flight while the rows load (a load still
  // pending at the cluster barrier would hold up its release)
  float ga[VEC], be[VEC];
  if (active) {
#pragma unroll
    for (int j = 0; j < VEC; j += 4) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(p.gamma + cv * VEC + j));
      const float4 b = __ldg(reinterpret_cast<const float4*>(p.beta + cv * VEC + j));
      ga[j] = a.x, ga[j + 1] = a.y, ga[j + 2] = a.z, ga[j + 3] = a.w;
      be[j] = b.x, be[j + 1] = b.y, be[j + 2] = b.z, be[j + 3] = b.w;
    }
  }
  // a chunk is a whole number of P-row steps, so each lane's rows stay in order
  const int chunk = RESIDENT ? ((nr + (GN_CHUNKS << p.lp) - 1) >> (p.lp + 2)) << p.lp : nr;

  if (RESIDENT) {
#pragma unroll
    for (int q = 0; q < GN_CHUNKS; ++q) {
      if (active)
        for (int r = q * chunk + lane; r < min(nr, (q + 1) * chunk); r += P)
          cp_async16(slice + r * p.ld, xv + (int64_t)r * CV, true);
      cp_async_commit();
    }
  }
  gn_stamp(p.stamps, 1);

  // pass 1: channel sums in fp32, each lane over its rows in order (chunk by
  // chunk as they arrive), then the P lanes in a fixed shuffle tree
  float s1[VEC], s2[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) s1[j] = s2[j] = 0.0f;
#pragma unroll
  for (int q = 0; q < (RESIDENT ? GN_CHUNKS : 1); ++q) {
    if (RESIDENT) {
      if (q == 0) cp_async_wait<GN_CHUNKS - 1>();
      if (q == 1) cp_async_wait<GN_CHUNKS - 2>();
      if (q == 2) cp_async_wait<GN_CHUNKS - 3>();
      if (q == 3) cp_async_wait<0>();
      __syncthreads();
    }
    const int r_end = min(nr, (q + 1) * chunk);
    if (active)
      for (int r = q * chunk + lane; r < r_end; r += GN_UNROLL * P) {
        uint4 v[GN_UNROLL];
#pragma unroll
        for (int u = 0; u < GN_UNROLL; ++u)
          if (r + u * P < r_end) v[u] = RESIDENT ? slice[(r + u * P) * p.ld] : __ldg(xv + (int64_t)(r + u * P) * CV);
#pragma unroll
        for (int u = 0; u < GN_UNROLL; ++u)
          if (r + u * P < r_end) {
            float f[VEC];
            unpack16(v[u], f);
#pragma unroll
            for (int j = 0; j < VEC; ++j) s1[j] += f[j], s2[j] += f[j] * f[j];
          }
      }
  }
  for (int o = 1; o < P; o <<= 1)  // P is uniform and divides 32: whole warps
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      s1[j] += __shfl_xor_sync(0xffffffffu, s1[j], o);
      s2[j] += __shfl_xor_sync(0xffffffffu, s2[j], o);
    }
  if (active && lane == 0) {
    float4* p1 = reinterpret_cast<float4*>(chan + cv * VEC);
    float4* p2 = reinterpret_cast<float4*>(chan + C + cv * VEC);
#pragma unroll
    for (int j = 0; j < VEC; j += 4) {
      p1[j / 4] = make_float4(s1[j], s1[j + 1], s1[j + 2], s1[j + 3]);
      p2[j / 4] = make_float4(s2[j], s2[j + 1], s2[j + 2], s2[j + 3]);
    }
  }
  gn_stamp(p.stamps, 2);
  __syncthreads();
  // this CTA's group sums: GN_SUB threads a (moment, group) pair, each adding
  // channels c = sub, sub + GN_SUB, ... of the group in order, then a fixed
  // shuffle tree over the GN_SUB threads
  for (int t0 = 0; t0 < 2 * G * GN_SUB; t0 += nt) {  // uniform across the CTA
    const int t = t0 + tid, j = t / GN_SUB, sub = t % GN_SUB;
    float s = 0.0f;
    if (j < 2 * G) {
      const int m = j >= G;
      const float* ch = chan + m * C + (j - m * G) * p.cg;
#pragma unroll 4
      for (int c = sub; c < p.cg; c += GN_SUB) s += ch[c];
    }
#pragma unroll
    for (int o = GN_SUB / 2; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (j < 2 * G && sub == 0) grp[j] = s;
  }
  gn_stamp(p.stamps, 3);
  cluster.sync();
  gn_stamp(p.stamps, 4);
  // the cluster's group sums, CTAs in rank order (k independent loads from
  // distributed shared memory), then mean and rstd
  for (int g = tid; g < G; g += nt) {
    float a[GN_MAX_CLUSTER], b[GN_MAX_CLUSTER];
#pragma unroll
    for (int q = 0; q < GN_MAX_CLUSTER; ++q)
      if (q < k) a[q] = ld_cluster(grp + g, q), b[q] = ld_cluster(grp + G + g, q);
    float s1t = a[0], s2t = b[0];
#pragma unroll
    for (int q = 1; q < GN_MAX_CLUSTER; ++q)
      if (q < k) s1t += a[q], s2t += b[q];
    const float mean = s1t * p.inv_cnt;
    // E[x^2] - E[x]^2 clamped at 0, as the reference
    stat[g] = mean;
    stat[G + g] = rsqrtf(fmaxf(s2t * p.inv_cnt - mean * mean, 0.0f) + p.eps);
  }
  cluster_arrive();  // this CTA is done reading the others' sums
  __syncthreads();
  gn_stamp(p.stamps, 5);

  // pass 2: (x - mean) * (rstd * gamma) + beta (+ SiLU)
  if (active) {
    float mu[VEC];
    int g = (cv * VEC) / p.cg, next = (g + 1) * p.cg;  // the group of channel cv VEC + j, found in order
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      while (cv * VEC + j >= next) ++g, next += p.cg;
      mu[j] = stat[g];
      ga[j] *= stat[G + g];
    }
    for (int r = lane; r < nr; r += GN_UNROLL * P) {
      uint4 v[GN_UNROLL];
#pragma unroll
      for (int u = 0; u < GN_UNROLL; ++u)
        if (r + u * P < nr) v[u] = RESIDENT ? slice[(r + u * P) * p.ld] : __ldg(xv + (int64_t)(r + u * P) * CV);
#pragma unroll
      for (int u = 0; u < GN_UNROLL; ++u)
        if (r + u * P < nr) {
          float f[VEC];
          unpack16(v[u], f);
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            const float o = (f[j] - mu[j]) * ga[j] + be[j];
            f[j] = p.silu ? silu_f(o) : o;
          }
          yv[(int64_t)(r + u * P) * CV] = pack16(f);
        }
    }
  }
  gn_stamp(p.stamps, 6);
  cluster_wait();  // every CTA of the cluster has read this CTA's sums
  gn_stamp(p.stamps, 7);
}

// the dynamic shared-memory limit and non-portable cluster sizes, set once
// per device
template <typename T, bool RESIDENT>
static cudaError_t gn_configure() {
  static unsigned long long done = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && (done >> dev) & 1ull)) return err;
  err = cudaFuncSetAttribute(gn_cluster_kernel<T, RESIDENT>, cudaFuncAttributeMaxDynamicSharedMemorySize, GN_SMEM_MAX);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(gn_cluster_kernel<T, RESIDENT>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess && dev < 64) done |= 1ull << dev;
  return err;
}

static void gn_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr, int k, int B, int threads, int smem,
                      cudaStream_t s) {
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(k, B);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = k;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
}

template <typename T, bool RESIDENT>
static int gn_launch(const GNParams& p, int B, int k, int threads, int smem, cudaStream_t s) {
  constexpr int VEC = 16 / sizeof(T);
  const int P = 1 << p.lp, CV = p.C / VEC;
  if (p.C % VEC || p.G < 1 || p.C % p.G || p.cg != p.C / p.G || k < 1 || k > GN_MAX_CLUSTER ||
      threads > GN_MAX_THREADS || threads < CV * P || p.lp < 0 || P > GN_MAX_LANES || p.ld < CV ||
      (int64_t)p.rows * k < p.N || smem > GN_SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = gn_configure<T, RESIDENT>();
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  gn_config(cfg, attr, k, B, threads, smem, s);
  err = cudaLaunchKernelEx(&cfg, gn_cluster_kernel<T, RESIDENT>, p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T, bool RESIDENT>
static int gn_max_clusters(int k, int threads, int smem, int* out) {
  cudaError_t err = gn_configure<T, RESIDENT>();
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  gn_config(cfg, attr, k, 1, threads, smem, 0);
  return (int)cudaOccupancyMaxActiveClusters(out, gn_cluster_kernel<T, RESIDENT>, &cfg);
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

// K1: one cluster launch; the plan (k, rows, P, threads, shared memory,
// resident) comes from ops/groupnorm.py::plan_group_norm.
MVDF_API int mvdf_groupnorm(const void* x, const void* gamma, const void* beta, void* y, int B, int N, int C,
                            int G, int k, int rows, int lp, int ld, int threads, int smem, float eps, int silu,
                            int resident, void* stamps, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (G < 1 || C % G) return (int)cudaErrorInvalidValue;
  const GNParams p{x, (const float*)gamma, (const float*)beta, y, (unsigned long long*)stamps, N, C, G, C / G,
                   rows, lp, ld, 1.0f / ((float)N * (float)(C / G)), eps, silu};
  if (dtype == DT_BF16)
    return resident ? gn_launch<bf16, true>(p, B, k, threads, smem, s) : gn_launch<bf16, false>(p, B, k, threads, smem, s);
  return resident ? gn_launch<float, true>(p, B, k, threads, smem, s) : gn_launch<float, false>(p, B, k, threads, smem, s);
}

// how many K1 clusters of k CTAs (threads, smem each) the card holds at once
// (cudaOccupancyMaxActiveClusters); 0: the plan cannot be scheduled
MVDF_API int mvdf_gn_max_clusters(int k, int threads, int smem, int resident, int dtype, void* out) {
  int* n = (int*)out;
  if (dtype == DT_BF16)
    return resident ? gn_max_clusters<bf16, true>(k, threads, smem, n) : gn_max_clusters<bf16, false>(k, threads, smem, n);
  return resident ? gn_max_clusters<float, true>(k, threads, smem, n) : gn_max_clusters<float, false>(k, threads, smem, n);
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
