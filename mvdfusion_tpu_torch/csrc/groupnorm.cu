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
// _gn_stats_kernel and _gn_apply_kernel. Bound by bytes (the stats pass one
// read of x at ~3 flops an element, the apply pass one read and one write).
// The TPU kernel carries its per-channel sums across sequential grid steps;
// here the row tiles of a sample run in parallel CTAs, one wave of them on
// the card (plan_gn_tiled). A thread owns one 16-byte channel vector and
// strides over rows with 4 independent 16-byte loads in flight, so the card
// keeps ~64 KB an SM in flight and x is read once as contiguous spans. Each
// CTA writes its tile's partial sums; the CTA that completes a sample (an
// integer counter, no float atomics) adds them in tile order and folds the
// (B, G) moments into a per-(batch, channel) affine, which the reference
// computes in XLA between its kernels: the stats pass is one launch and no
// host work, and gives the same bits on every run. The apply pass holds its
// vector's affine in registers, indexes by (sample, row, vector), with no
// division per element, and walks each tile back from its end, whose rows
// the stats pass read last and L2 may still hold. The stats pass also
// serves conv3x3's gn_fold_affine, with the variance unclamped as there.
#include <cooperative_groups.h>

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

// K7's CTAs: GNT_THREADS threads; both passes' launch bounds keep
// GNT_BLOCKS of them an SM resident (the registers capped so that they fit;
// ops/groupnorm.py::plan_gn_tiled sizes one wave of row tiles from them),
// with GNT_UNROLL independent 16-byte loads in flight a thread: 4 x 256 x
// 4 x 16 B = 64 KB an SM (8 loads were no faster; 8 CTAs an SM spilled)
constexpr int GNT_THREADS = 256, GNT_BLOCKS = 4, GNT_UNROLL = 4;

// K7's launch parameters (ops/groupnorm.py::plan_gn_tiled gives rows and tiles)
struct GNTParams {
  const void* x;
  float* part;      // (B, tiles, 2, C): each tile's [sum; sum of squares]
  unsigned* count;  // (B,): tiles of a sample done; wraps to 0 at its fold
  const float* gamma;
  const float* beta;
  float* a;  // (B, C): rstd * gamma
  float* sh;  // (B, C): beta - mu * a
  int N, C, G;
  int rows, tiles;  // rows a tile, tiles a sample
  float eps;
  int clamp;
};

// the thread's place in its CTA: channel vector cv (VEC channels at a fixed
// column), row lane `lane` of P = GNT_THREADS / CV; consecutive threads
// read consecutive 16-byte vectors, so a CTA's step reads one contiguous
// span of its tile
template <typename T>
struct GNTThread {
  static constexpr int VEC = 16 / sizeof(T);
  int CV, P, cv, lane, r0, nr;
  __device__ GNTThread(int N, int C, int rows) {
    CV = C / VEC;
    P = GNT_THREADS / CV;
    cv = threadIdx.x % CV;
    lane = threadIdx.x / CV;
    r0 = blockIdx.x * rows;
    nr = min(N - r0, rows);
  }
};

template <int VEC>
__device__ __forceinline__ void gnt_add(const uint4& v, float (&s1)[VEC], float (&s2)[VEC]) {
  float f[VEC];
  unpack16(v, f);
#pragma unroll
  for (int j = 0; j < VEC; ++j) s1[j] += f[j], s2[j] += f[j] * f[j];
}

// K7 pass 1 (and K8's gn_fold_affine): row tile blockIdx.x of sample
// blockIdx.y. Each thread sums its channel vector over rows lane, lane + P,
// ... in order (fp32), the CTA adds its P row lanes in order into the tile's
// partials, part[b][tile]. The CTA that finishes a sample's last tile (an
// atomicInc on count[b] that wraps it back to 0 for the next launch) folds:
// the partials in tile order, each group's channels in order, then a =
// rstd * gamma and sh = beta - mu * a with rstd = rsqrt(E[x^2] - mu^2 +
// eps), the variance clamped at 0 where `clamp` (the tiled GroupNorm; not
// conv3x3's fold). Same bits on every launch, no float atomics.
template <typename T>
__global__ void __launch_bounds__(GNT_THREADS, GNT_BLOCKS) gn_stats_kernel(const GNTParams p) {
  constexpr int VEC = 16 / sizeof(T);
  __shared__ __align__(16) float red[2 * GNT_THREADS * VEC];  // [moment][lane][C]; then the fold's (2, C)
  __shared__ bool last;
  // the apply pass, launched behind this one, may start as CTAs retire
  asm volatile("griddepcontrol.launch_dependents;\n");
  const GNTThread<T> t(p.N, p.C, p.rows);
  const int C = p.C, b = blockIdx.y;
  if (t.lane < t.P) {
    float s1[VEC], s2[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) s1[j] = s2[j] = 0.0f;
    const uint4* xv = reinterpret_cast<const uint4*>(static_cast<const T*>(p.x) + ((int64_t)b * p.N + t.r0) * C) + t.cv;
    const int P = t.P, nr = t.nr;
    int r = t.lane;
    for (; r + (GNT_UNROLL - 1) * P < nr; r += GNT_UNROLL * P) {
      uint4 v[GNT_UNROLL];
#pragma unroll
      for (int u = 0; u < GNT_UNROLL; ++u) v[u] = __ldg(xv + (int64_t)(r + u * P) * t.CV);
#pragma unroll
      for (int u = 0; u < GNT_UNROLL; ++u) gnt_add<VEC>(v[u], s1, s2);
    }
    for (; r < nr; r += P) gnt_add<VEC>(__ldg(xv + (int64_t)r * t.CV), s1, s2);
    float4* q1 = reinterpret_cast<float4*>(red + t.lane * C + t.cv * VEC);
    float4* q2 = reinterpret_cast<float4*>(red + (P + t.lane) * C + t.cv * VEC);
#pragma unroll
    for (int j = 0; j < VEC; j += 4) {
      q1[j / 4] = make_float4(s1[j], s1[j + 1], s1[j + 2], s1[j + 3]);
      q2[j / 4] = make_float4(s2[j], s2[j + 1], s2[j + 2], s2[j + 3]);
    }
  }
  __syncthreads();
  float* pt = p.part + ((int64_t)b * p.tiles + blockIdx.x) * 2 * C;
  for (int i = threadIdx.x; i < 2 * C; i += GNT_THREADS) {
    const int m = i >= C;
    const float* q = red + m * t.P * C + (i - m * C);
    float s = q[0];
    for (int l = 1; l < t.P; ++l) s += q[l * C];
    pt[i] = s;
  }
  __threadfence();  // this CTA's partials reach the device before its count does
  __syncthreads();
  if (threadIdx.x == 0) last = atomicInc(p.count + b, p.tiles - 1) == (unsigned)(p.tiles - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  // four consecutive sums a thread, one 16-byte load a tile, read from L2
  // (other SMs wrote them), 8 tiles' loads in flight
  const float* pb = p.part + (int64_t)b * p.tiles * 2 * C;
  for (int i = 4 * threadIdx.x; i < 2 * C; i += 4 * GNT_THREADS) {
    float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 8
    for (int k = 0; k < p.tiles; ++k) {
      const float4 v = __ldcg(reinterpret_cast<const float4*>(pb + (int64_t)k * 2 * C + i));
      s.x += v.x, s.y += v.y, s.z += v.z, s.w += v.w;
    }
    *reinterpret_cast<float4*>(red + i) = s;
  }
  __syncthreads();
  const int cg = C / p.G;
  const float cnt = (float)p.N * (float)cg;
  for (int c = threadIdx.x; c < C; c += GNT_THREADS) {
    const int c0 = c - c % cg;
    float s1 = 0.0f, s2 = 0.0f;
    for (int k = 0; k < cg; ++k) s1 += red[c0 + k], s2 += red[C + c0 + k];
    const float mu = s1 / cnt;
    float var = s2 / cnt - mu * mu;
    if (p.clamp) var = fmaxf(var, 0.0f);
    const float a = rsqrtf(var + p.eps) * p.gamma[c];
    p.a[(int64_t)b * C + c] = a;
    p.sh[(int64_t)b * C + c] = p.beta[c] - mu * a;
  }
}

// K7 pass 2: y = x * a + sh (+ SiLU) over row tile blockIdx.x of sample
// blockIdx.y, with the stats pass's tiles and thread layout. A thread holds
// its channel vector's a and sh in registers and keeps GNT_UNROLL
// 16-byte loads in flight; x is read evict-first (its last use). Each lane
// walks its rows from the tile's end: the stats pass read those last, so the
// first reads may find them in L2 (faster than the forward walk at every
// VAE map on the H100).
// Launched behind the stats pass as a programmatic dependent launch: its
// first loads of x run before griddepcontrol.wait, so x must be complete
// before the preceding kernel on the stream starts (as it is behind the
// stats pass on the same x); a and sh are read only after the wait.
template <typename T>
__global__ void __launch_bounds__(GNT_THREADS, GNT_BLOCKS) gn_apply_kernel(const void* x, const float* a,
                                                                          const float* sh, void* y, int N, int C,
                                                                          int rows, int silu) {
  constexpr int VEC = 16 / sizeof(T);
  const GNTThread<T> t(N, C, rows);
  if (t.lane >= t.P) return;
  const int b = blockIdx.y;
  float ga[VEC], be[VEC];
  const int64_t base = ((int64_t)b * N + t.r0) * C;
  const uint4* xv = reinterpret_cast<const uint4*>(static_cast<const T*>(x) + base) + t.cv;
  uint4* yv = reinterpret_cast<uint4*>(static_cast<T*>(y) + base) + t.cv;
  const int P = t.P, nr = t.nr;
  auto at = [&](int i) { return (int64_t)(nr - 1 - i) * t.CV; };  // the lane's i-th row from the end, in vectors
  auto apply = [&](const uint4& v, int i) {
    float f[VEC];
    unpack16(v, f);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float o = f[j] * ga[j] + be[j];
      f[j] = silu ? silu_f(o) : o;
    }
    yv[at(i)] = pack16(f);
  };
  int r = t.lane;
  uint4 v[GNT_UNROLL];
#pragma unroll
  for (int u = 0; u < GNT_UNROLL; ++u)
    if (r + (GNT_UNROLL - 1) * P < nr) v[u] = __ldcs(xv + at(r + u * P));
  // the first loads above overlap the stats pass's tail; a and sh only after it
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
#pragma unroll
  for (int j = 0; j < VEC; j += 4) {
    const float4 u = __ldg(reinterpret_cast<const float4*>(a + (int64_t)b * C + t.cv * VEC + j));
    const float4 w = __ldg(reinterpret_cast<const float4*>(sh + (int64_t)b * C + t.cv * VEC + j));
    ga[j] = u.x, ga[j + 1] = u.y, ga[j + 2] = u.z, ga[j + 3] = u.w;
    be[j] = w.x, be[j + 1] = w.y, be[j + 2] = w.z, be[j + 3] = w.w;
  }
  for (; r + (GNT_UNROLL - 1) * P < nr; r += GNT_UNROLL * P) {
    if (r != t.lane) {
#pragma unroll
      for (int u = 0; u < GNT_UNROLL; ++u) v[u] = __ldcs(xv + at(r + u * P));
    }
#pragma unroll
    for (int u = 0; u < GNT_UNROLL; ++u) apply(v[u], r + u * P);
  }
  for (; r < nr; r += P) apply(__ldcs(xv + at(r)), r);
}

// what both passes take: whole 16-byte vectors a row, at most one per thread
// of the CTA, 16-byte aligned, and tiles that cover the rows
template <typename T>
static bool gnt_takes(const void* x, int N, int C, int rows, int tiles) {
  constexpr int VEC = 16 / sizeof(T);
  return C > 0 && C % VEC == 0 && C / VEC <= GNT_THREADS && ((uintptr_t)x & 15) == 0 && rows > 0 && tiles > 0 &&
         (int64_t)rows * tiles >= N && (int64_t)rows * (tiles - 1) < N;
}

template <typename T>
int gn_stats(const GNTParams& p, int B, cudaStream_t s) {
  if (!gnt_takes<T>(p.x, p.N, p.C, p.rows, p.tiles) || p.G < 1 || p.C % p.G) return (int)cudaErrorInvalidValue;
  gn_stats_kernel<T><<<dim3(p.tiles, B), GNT_THREADS, 0, s>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int gn_apply(const void* x, const void* a, const void* sh, void* y, int B, int N, int C, int rows, int tiles, int silu,
             cudaStream_t s) {
  if (!gnt_takes<T>(x, N, C, rows, tiles) || ((uintptr_t)y & 15) || ((uintptr_t)a & 15) || ((uintptr_t)sh & 15))
    return (int)cudaErrorInvalidValue;
  // a programmatic dependent launch (the kernel waits for the preceding
  // kernel's results before it reads a and sh)
  cudaLaunchConfig_t cfg{};
  cfg.gridDim = dim3(tiles, B);
  cfg.blockDim = dim3(GNT_THREADS);
  cfg.stream = s;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, gn_apply_kernel<T>, x, (const float*)a, (const float*)sh, y, N, C,
                                             rows, silu);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
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

// K7's stats pass with the fold, one launch: (tiles, B) CTAs of rows rows
// (ops/groupnorm.py::plan_gn_tiled), the per-sample counters zero between
// launches (the folding CTA wraps them back)
MVDF_API int mvdf_gn_stats(const void* x, void* part, void* count, const void* gamma, const void* beta, void* a,
                           void* sh, int B, int N, int C, int G, int rows, int tiles, float eps, int clamp, int dtype,
                           void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const GNTParams p{x, (float*)part, (unsigned*)count, (const float*)gamma, (const float*)beta, (float*)a, (float*)sh,
                    N, C, G, rows, tiles, eps, clamp};
  return dtype == DT_BF16 ? gn_stats<bf16>(p, B, s) : gn_stats<float>(p, B, s);
}

// K7's apply pass on the stats pass's tiles, a programmatic dependent launch
// behind the stats pass that made a and sh
MVDF_API int mvdf_gn_apply(const void* x, const void* a, const void* sh, void* y, int B, int N, int C, int rows,
                           int tiles, int silu, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return dtype == DT_BF16 ? gn_apply<bf16>(x, a, sh, y, B, N, C, rows, tiles, silu, s)
                          : gn_apply<float>(x, a, sh, y, B, N, C, rows, tiles, silu, s);
}

MVDF_API const char* mvdf_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }
