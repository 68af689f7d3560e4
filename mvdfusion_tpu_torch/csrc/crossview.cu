// K4 stages: the bilinear gather with the geometric embedding, the
// attention across views on a qkv already in device memory, and the softmax
// pool over views.
//
// With block.cu's LayerNorm and gemm_sm90.cu's GEMM and qkv + attention tile
// these replace both forms of mvdfusion_tpu/ops/crossview.py::
// _crossview_fwd_impl: the single-kernel form (_kernel with _geo_aug_t,
// _erf/_gelu and _dit_pool) and the two-phase form (_gather_kernel, then
// _dit_kernel), which the reference takes when the V projected maps exceed
// 6 MiB (V >= 13 views at 32^2 in bf16).
//
// Bound on the H100: operations. At the flagship shape (V=8 views, N=8192
// points, hid=256, 3 layers) the DiT products are ~210 GFLOP a step against
// a few hundred MB of traffic; the gather and the embedding are ~4 GFLOP.
// At the 15-view eval shape (N=15360) the products are ~725 GFLOP.
// Design: the TPU kernel keeps the (N, V, hid) tokens in VMEM; an H100 SM
// cannot hold the DiT weights and a useful token block at once, so here the
// gather writes the fp32 residual stream once, the DiT runs as token-wise
// tensor-core GEMMs over all N*V tokens (weights read once per layer, the
// stream updated in place by the GEMM epilogue's gated add), and only the
// per-point work is custom:
// - the gather (cv_gather_mma_kernel, bf16): a persistent block stages the
//   geometric rows `kall` (G = 105 rows padded to 112) in shared memory once,
//   then for each tile of 32 points of one view computes the harmonic
//   features from the raw 7-vector (ray direction, Plucker moment, depth),
//   rounds them to bf16 and takes their product with kall on the tensor cores
//   (mma.sync m16n8k16, fp32 sums), and adds the 4 bilinear taps (16-byte
//   reads, a border clamp, not the TPU's one-hot matmul), mask * kmask and
//   b_acc in a coalesced pass over the staged sums. fp32 maps, and shapes it
//   does not take, run cv_gather_kernel's CUDA-core loop;
// - the attention across the V tokens of each point and head runs inside
//   the qkv GEMM's tiles (gemm_sm90.cu), or here (cv_attention_kernel) on a
//   qkv in device memory, for fp32 and the shapes the tile does not take;
// - the pool.
// The two forms differ only in their numerics, which this file keeps: the
// single form adds b_acc and applies the GELU to the fp32 token sum; the
// two-phase form rounds the token to the maps' dtype first (the reference's
// phase-1 output), then adds b_acc in fp32 and applies the GELU, in the same
// pass. The TPU's view-major grid and its 128-token blocks exist for VMEM
// and are not kept.
#include "viewattn.cuh"

namespace mvdf {

// what the gather writes at tokens[n, v, :] (t: the fp32 token sum before
// b_acc, with the hat weights and the geometric features rounded to T):
enum {
  CV_SINGLE = 0,  // fp32 gelu(t + bacc[n]): the single form's stream
  CV_TOKENS = 1,  // T(t): the two-phase form's phase-1 tokens
  CV_STREAM = 2,  // fp32 gelu(float(T(t)) + bacc[n]): the two-phase form's stream
};

constexpr int CV_TN = 16;        // points per block of the CUDA-core gather
constexpr int CV_MAXG = 7 * 33;  // raw + sin + cos features for up to 16 harmonics

// the raw 7-vector [dir | o x dir | depth] of point n seen from view v, and
// its 4 bilinear taps (map rows) with their hat weights rounded to T
template <typename T>
__device__ __forceinline__ void cv_point(const float* __restrict__ xy, const float* __restrict__ pts,
                                         const float* __restrict__ centers, int v, int n, int N, int H, int W,
                                         float* X, int* tap_i, float* tap_w) {
  const float cx = centers[v * 3 + 0], cy = centers[v * 3 + 1], cz = centers[v * 3 + 2];
  const float dx = pts[n * 3 + 0] - cx, dy = pts[n * 3 + 1] - cy, dz = pts[n * 3 + 2] - cz;
  const float depth = sqrtf(dx * dx + dy * dy + dz * dz);
  const float inv = 1.0f / fmaxf(depth, 1e-12f);
  const float ux = dx * inv, uy = dy * inv, uz = dz * inv;
  X[0] = ux;
  X[1] = uy;
  X[2] = uz;
  X[3] = cy * uz - cz * uy;  // o x d
  X[4] = cz * ux - cx * uz;
  X[5] = cx * uy - cy * ux;
  X[6] = depth;
  // align_corners=True, border clamp of the coordinate itself
  const float gx = fminf(fmaxf((xy[((int64_t)v * N + n) * 2 + 0] + 1.0f) * 0.5f * (W - 1), 0.0f), (float)(W - 1));
  const float gy = fminf(fmaxf((xy[((int64_t)v * N + n) * 2 + 1] + 1.0f) * 0.5f * (H - 1), 0.0f), (float)(H - 1));
  const float fx = floorf(gx), fy = floorf(gy);
  const float tx = gx - fx, ty = gy - fy;
  const int x0 = (int)fx, y0 = (int)fy;
  const int x1 = min(x0 + 1, W - 1), y1 = min(y0 + 1, H - 1);
  tap_i[0] = y0 * W + x0;
  tap_i[1] = y0 * W + x1;
  tap_i[2] = y1 * W + x0;
  tap_i[3] = y1 * W + x1;
  // the hat weights and (below) the geometric features are rounded to T
  // before their products, as the reference rounds Wm and aug to dt
  tap_w[0] = to_f(from_f<T>((1.0f - tx) * (1.0f - ty)));
  tap_w[1] = to_f(from_f<T>(tx * (1.0f - ty)));
  tap_w[2] = to_f(from_f<T>((1.0f - tx) * ty));
  tap_w[3] = to_f(from_f<T>(tx * ty));
}

// geometric feature g of the raw 7-vector X: [raw 7 | sin(f_k X)
// freq-major | cos(f_k X) freq-major]
__device__ __forceinline__ float cv_feature(const float* X, int g, const float* __restrict__ freqs, int nh) {
  if (g < 7) return X[g];
  const int s = (g - 7) % (7 * nh);
  const float arg = X[s % 7] * freqs[s / 7];
  return (g < 7 + 7 * nh) ? sinf(arg) : cosf(arg);
}

// the two bf16 of a 32-bit word (the lower address in the low half) as
// floats: a bf16 is the upper half of its fp32
__device__ __forceinline__ float2 bf16x2_to_float2(unsigned w) {
  return make_float2(__uint_as_float(w << 16), __uint_as_float(w & 0xffff0000u));
}

// the token's last step: t is the fp32 sum before b_acc
template <typename T, int MODE>
__device__ __forceinline__ float cv_finish(float t, float bacc) {
  if (MODE == CV_SINGLE) return gelu_erf(t + bacc);
  if (MODE == CV_STREAM) return gelu_erf(to_f(from_f<T>(t)) + bacc);
  return t;
}

// CUDA-core gather: one block per 16 points of one view, one channel a
// thread; the geometric product on the CUDA cores
template <typename T, int MODE>
__global__ void __launch_bounds__(256) cv_gather_kernel(
    const float* __restrict__ xy, const float* __restrict__ pts, const float* __restrict__ centers,
    const float* __restrict__ mask, const T* __restrict__ bacc, const T* __restrict__ maps,
    const T* __restrict__ kall, const float* __restrict__ kmask, const float* __restrict__ freqs, int nh,
    void* __restrict__ tokens, int V, int N, int H, int W, int hid) {
  __shared__ float aug[CV_TN][CV_MAXG];
  __shared__ float X[CV_TN][7];
  __shared__ int tap_i[CV_TN][4];
  __shared__ float tap_w[CV_TN][4];
  const int v = blockIdx.y;
  const int n0 = blockIdx.x * CV_TN;
  const int G = 7 * (1 + 2 * nh);
  const int tid = threadIdx.x;

  if (tid < CV_TN) cv_point<T>(xy, pts, centers, v, min(n0 + tid, N - 1), N, H, W, X[tid], tap_i[tid], tap_w[tid]);
  __syncthreads();
  for (int e = tid; e < CV_TN * G; e += blockDim.x) {
    const int p = e / G, g = e - p * G;
    aug[p][g] = to_f(from_f<T>(cv_feature(X[p], g, freqs, nh)));
  }
  __syncthreads();
  const int HW = H * W;
  for (int c = tid; c < hid; c += blockDim.x) {
    float acc[CV_TN];
#pragma unroll
    for (int p = 0; p < CV_TN; ++p) acc[p] = 0.0f;
    for (int g = 0; g < G; ++g) {
      const float kv = to_f(kall[(int64_t)g * hid + c]);
#pragma unroll
      for (int p = 0; p < CV_TN; ++p) acc[p] += aug[p][g] * kv;
    }
    const T* mv = maps + (int64_t)v * HW * hid + c;
    const float mk = mask[v] * kmask[c];
#pragma unroll
    for (int p = 0; p < CV_TN; ++p) {
      const int n = n0 + p;
      if (n < N) {
        float t = acc[p] + mk;
#pragma unroll
        for (int q = 0; q < 4; ++q) t += tap_w[p][q] * to_f(mv[(int64_t)tap_i[p][q] * hid]);
        const int64_t o = ((int64_t)n * V + v) * hid + c;
        const float b = MODE == CV_TOKENS ? 0.0f : to_f(bacc[(int64_t)n * hid + c]);
        if (MODE == CV_TOKENS)
          reinterpret_cast<T*>(tokens)[o] = from_f<T>(t);
        else
          reinterpret_cast<float*>(tokens)[o] = cv_finish<T, MODE>(t, b);
      }
    }
  }
}

// Tensor-core gather (bf16): persistent blocks of 8 warps walk tiles of 32
// points of one view. kall (G x hid, bf16) is staged once a block, its rows
// padded to 112 with zeros; per tile the features are rounded to bf16 into a
// (32 x 112) tile, the product aug @ kall runs as mma.sync m16n8k16 with
// fp32 sums (warp w: 16 points from 16 * (w % 2), 64 channels from
// 64 * (w / 2), then every 256 channels), the sums are staged in fp32, and a
// coalesced pass (8 channels a thread, a warp a point's row) adds the taps,
// mask * kmask and b_acc and writes the token.
constexpr int CVG_TN = 32, CVG_GP = 112, CVG_LDA = CVG_GP + 8, CVG_THREADS = 256;

struct CvgSmem {
  int ldk, lds;
  size_t kall, aug, stage, total;
  __host__ __device__ explicit CvgSmem(int hid)
      : ldk(hid + 8),  // bf16 rows 16 bytes apart mod 128: ldmatrix without conflicts
        lds(hid + 8),  // fp32 staging rows: the fragments' float2 stores without conflicts
        kall((size_t)CVG_GP * (hid + 8) * 2),
        aug((size_t)CVG_TN * CVG_LDA * 2),
        stage((size_t)CVG_TN * (hid + 8) * 4),
        total(kall + aug + stage + CVG_TN * (7 + 4 + 4) * 4) {}
};

template <int MODE>
__global__ void __launch_bounds__(CVG_THREADS, 2) cv_gather_mma_kernel(
    const float* __restrict__ xy, const float* __restrict__ pts, const float* __restrict__ centers,
    const float* __restrict__ mask, const bf16* __restrict__ bacc, const bf16* __restrict__ maps,
    const bf16* __restrict__ kall, const float* __restrict__ kmask, const float* __restrict__ freqs, int nh,
    void* __restrict__ tokens, int V, int N, int H, int W, int hid) {
  extern __shared__ __align__(16) unsigned char smem[];
  const CvgSmem L(hid);
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* aug = reinterpret_cast<bf16*>(smem + L.kall);
  float* stage = reinterpret_cast<float*>(smem + L.kall + L.aug);
  float* X = stage + CVG_TN * L.lds;
  int* tap_i = reinterpret_cast<int*>(X + CVG_TN * 7);
  float* tap_w = reinterpret_cast<float*>(tap_i + CVG_TN * 4);
  const int G = 7 * (1 + 2 * nh), tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tpv = (N + CVG_TN - 1) / CVG_TN, tiles = V * tpv, HW = H * W, CH = hid / 8;

  // kall once, 16 bytes a copy; the padding rows zero
  for (int e = tid; e < CVG_GP * CH; e += CVG_THREADS) {
    const int g = e / CH, c = (e - g * CH) * 8;
    cp_async16(ks + g * L.ldk + c, g < G ? kall + (int64_t)g * hid + c : kall, g < G);
  }
  cp_async_commit();
  cp_async_wait<0>();

  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int v = t / tpv, n0 = (t - v * tpv) * CVG_TN;
    if (tid < CVG_TN)
      cv_point<bf16>(xy, pts, centers, v, min(n0 + tid, N - 1), N, H, W, X + tid * 7, tap_i + tid * 4,
                     tap_w + tid * 4);
    __syncthreads();
    for (int e = tid; e < CVG_TN * CVG_GP; e += CVG_THREADS) {
      const int p = e / CVG_GP, g = e - p * CVG_GP;
      aug[p * CVG_LDA + g] = __float2bfloat16(g < G ? cv_feature(X + p * 7, g, freqs, nh) : 0.0f);
    }
    __syncthreads();
    const int r0 = 16 * (warp & 1);
    for (int c0 = 64 * (warp >> 1); c0 < hid; c0 += 256) {
      float acc[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.0f;
#pragma unroll
      for (int k0 = 0; k0 < CVG_GP; k0 += 16) {
        unsigned fa[4];
        ldsm_x4(fa, aug + (r0 + (lane & 15)) * CVG_LDA + k0 + (lane >> 4) * 8);
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          unsigned fb[4];
          ldsm_x4_t(fb, ks + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * L.ldk + c0 + np * 16 + (lane >> 4) * 8);
          mma_bf16(acc[2 * np], fa, fb[0], fb[1]);
          mma_bf16(acc[2 * np + 1], fa, fb[2], fb[3]);
        }
      }
      const int sr = r0 + (lane >> 2), sc = c0 + 2 * (lane & 3);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        *reinterpret_cast<float2*>(stage + sr * L.lds + sc + 8 * i) = make_float2(acc[i][0], acc[i][1]);
        *reinterpret_cast<float2*>(stage + (sr + 8) * L.lds + sc + 8 * i) = make_float2(acc[i][2], acc[i][3]);
      }
    }
    __syncthreads();
    const float mv = mask[v];
    const bf16* mbase = maps + (int64_t)v * HW * hid;
    for (int e = tid; e < CVG_TN * CH; e += CVG_THREADS) {
      const int p = e / CH, c = (e - p * CH) * 8, n = n0 + p;
      if (n >= N) continue;
      const float4 s0 = *reinterpret_cast<const float4*>(stage + p * L.lds + c);
      const float4 s1 = *reinterpret_cast<const float4*>(stage + p * L.lds + c + 4);
      const float4 m0 = *reinterpret_cast<const float4*>(kmask + c), m1 = *reinterpret_cast<const float4*>(kmask + c + 4);
      float t[8] = {s0.x + mv * m0.x, s0.y + mv * m0.y, s0.z + mv * m0.z, s0.w + mv * m0.w,
                    s1.x + mv * m1.x, s1.y + mv * m1.y, s1.z + mv * m1.z, s1.w + mv * m1.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint4 u = *reinterpret_cast<const uint4*>(mbase + (int64_t)tap_i[p * 4 + q] * hid + c);
        const float w = tap_w[p * 4 + q];
        const float2 f[4] = {bf16x2_to_float2(u.x), bf16x2_to_float2(u.y), bf16x2_to_float2(u.z),
                             bf16x2_to_float2(u.w)};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          t[2 * j] += w * f[j].x;
          t[2 * j + 1] += w * f[j].y;
        }
      }
      const int64_t o = ((int64_t)n * V + v) * hid + c;
      if (MODE == CV_TOKENS) {
        store_row<8>(reinterpret_cast<bf16*>(tokens) + o, t);
      } else {
        const uint4 u = *reinterpret_cast<const uint4*>(bacc + (int64_t)n * hid + c);
        const float2 f[4] = {bf16x2_to_float2(u.x), bf16x2_to_float2(u.y), bf16x2_to_float2(u.z),
                             bf16x2_to_float2(u.w)};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          t[2 * j] = cv_finish<bf16, MODE>(t[2 * j], f[j].x);
          t[2 * j + 1] = cv_finish<bf16, MODE>(t[2 * j + 1], f[j].y);
        }
        store_row<8>(reinterpret_cast<float*>(tokens) + o, t);
      }
    }
    __syncthreads();  // the next tile rewrites the taps and the staging tile
  }
}

// Attention across the V tokens of each point: qkv (N*V, 3*hid) fp32, each
// head's rows packed [q | k | v] (ops/crossview.py::pack_qkv_heads) -> out
// (N*V, hid). One warp per (point, head): it copies the point's V rows of
// the head into shared memory with coalesced 16-byte loads, then two lanes
// per query view attend (viewattn.cuh).
template <typename T, int DH>
__global__ void __launch_bounds__(128) cv_attention_kernel(const float* __restrict__ qkv, T* __restrict__ out, int N,
                                                           int V, int heads, float scale) {
  constexpr int WARPS = DH <= 32 ? 4 : 2, LDS = 3 * DH + 4, R4 = 3 * DH / 4;
  __shared__ __align__(16) float rows[WARPS][CV_MAX_VIEWS * LDS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t item = (int64_t)blockIdx.x * WARPS + warp;
  if (item >= (int64_t)N * heads) return;  // the whole warp
  const int64_t n = item / heads;
  const int h = (int)(item - n * heads), hid = heads * DH;
  float* sm = rows[warp];
  const float* src = qkv + n * V * 3 * hid + h * 3 * DH;
  for (int e = lane; e < V * R4; e += 32) {
    const int w = e / R4, c = e - w * R4;
    *reinterpret_cast<float4*>(sm + w * LDS + 4 * c) = *reinterpret_cast<const float4*>(src + (int64_t)w * 3 * hid + 4 * c);
  }
  __syncwarp();
  const int vq = lane >> 1, half = lane & 1;
  float o[DH / 2];
  view_attention_half<DH, CV_MAX_VIEWS>(sm, LDS, vq < V ? vq : 0, half, V, scale, o);
  if (vq < V) store_row<DH / 2>(out + (n * V + vq) * hid + h * DH + half * (DH / 2), o);
}

// The DiT's LayerNorm with its adaLN modulation: y = (x - mean) * rstd *
// (1 + scale) + shift over rows of C fp32 (the residual stream), two-pass
// fp32 statistics, y in T. Bytes-bound: one warp a
// row, 16-byte loads (C % 4 == 0, C <= 1024), 8 rows a block.
template <typename T>
__global__ void __launch_bounds__(256) cv_layernorm_kernel(const float* __restrict__ x, const float* __restrict__ scale,
                                                           const float* __restrict__ shift, T* __restrict__ y, int M,
                                                           int C, float eps) {
  const int lane = threadIdx.x & 31, n4 = (C + 127) / 128;
  const int64_t row = (int64_t)blockIdx.x * 8 + (threadIdx.x >> 5);
  if (row >= M) return;
  const float* xr = x + row * C;
  float v[8][4];
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < 8; ++i)
    if (i < n4 && 4 * (lane + 32 * i) < C) {
      const float4 a = *reinterpret_cast<const float4*>(xr + 4 * (lane + 32 * i));
      v[i][0] = a.x, v[i][1] = a.y, v[i][2] = a.z, v[i][3] = a.w;
      s += (a.x + a.y) + (a.z + a.w);
    }
  const float mean = warp_sum(s) / (float)C;
  float s2 = 0.0f;
#pragma unroll
  for (int i = 0; i < 8; ++i)
    if (i < n4 && 4 * (lane + 32 * i) < C)
#pragma unroll
      for (int j = 0; j < 4; ++j) s2 += (v[i][j] - mean) * (v[i][j] - mean);
  const float rstd = rsqrtf(warp_sum(s2) / (float)C + eps);
#pragma unroll
  for (int i = 0; i < 8; ++i)
    if (i < n4 && 4 * (lane + 32 * i) < C) {
      const int c = 4 * (lane + 32 * i);
      const float4 a = *reinterpret_cast<const float4*>(scale + c), b = *reinterpret_cast<const float4*>(shift + c);
      const float g[4] = {1.0f + a.x, 1.0f + a.y, 1.0f + a.z, 1.0f + a.w}, h[4] = {b.x, b.y, b.z, b.w};
      float o[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) o[j] = (v[i][j] - mean) * rstd * g[j] + h[j];
      store_row<4>(y + row * C + c, o);
    }
}

// pooled[n] = sum_v softmax_v(x[n, v] . wl + wl_b) * x[n, v]; x fp32
// (N*V, hid), the weight logit taken on x rounded to T as the reference.
// One warp per point, V <= 16, hid <= 1024.
template <typename T>
__global__ void __launch_bounds__(256) cv_pool_kernel(const float* __restrict__ x, const T* __restrict__ wl,
                                                      const float* __restrict__ wl_b, T* __restrict__ pooled, int N, int V, int hid) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t n = (int64_t)blockIdx.x * (blockDim.x >> 5) + warp;
  if (n >= N) return;
  const float* xr = x + n * V * hid;
  float logit[16];
  float mx = -INFINITY;
  for (int v = 0; v < V; ++v) {
    float a = 0.0f;
    for (int c = lane; c < hid; c += 32) a += to_f(from_f<T>(xr[(int64_t)v * hid + c])) * to_f(wl[c]);
    a = warp_sum(a) + wl_b[0];
    logit[v] = a;
    mx = fmaxf(mx, a);
  }
  float den = 0.0f;
  for (int v = 0; v < V; ++v) {
    logit[v] = expf(logit[v] - mx);
    den += logit[v];
  }
  const float inv = 1.0f / den;
  for (int c = lane; c < hid; c += 32) {
    float a = 0.0f;
    for (int v = 0; v < V; ++v) a += xr[(int64_t)v * hid + c] * logit[v];
    pooled[n * hid + c] = from_f<T>(a * inv);
  }
}

}  // namespace mvdf

using namespace mvdf;

template <int MODE>
static int cv_gather_launch(const void* xy, const void* pts, const void* centers, const void* mask, const void* bacc,
                            const void* maps, const void* kall, const void* kmask, const void* freqs, int nh,
                            void* tokens, int V, int N, int H, int W, int hid, int dtype, int mma, cudaStream_t s) {
#define MVDF_CV_ARGS(T)                                                                                         \
  (const float*)xy, (const float*)pts, (const float*)centers, (const float*)mask, (const T*)bacc, (const T*)maps, \
      (const T*)kall, (const float*)kmask, (const float*)freqs, nh, tokens, V, N, H, W, hid
  if (mma) {
    // the tensor-core gather: bf16, G <= 112 (nh <= 7), hid a multiple of 64 up to 512
    if (dtype != DT_BF16 || nh > 7 || hid % 64 || hid > 512) return (int)cudaErrorInvalidValue;
    static int sms = 0;
    if (!sms) {
      int dev = 0;
      cudaGetDevice(&dev);
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      const cudaError_t rc = cudaFuncSetAttribute(cv_gather_mma_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                  (int)CvgSmem(512).total);
      if (rc != cudaSuccess || sms <= 0) {
        sms = 0;
        return rc != cudaSuccess ? (int)rc : (int)cudaErrorInvalidDevice;
      }
    }
    const int tiles = V * ((N + CVG_TN - 1) / CVG_TN);
    const int grid = tiles < 2 * sms ? tiles : 2 * sms;
    cv_gather_mma_kernel<MODE><<<grid, CVG_THREADS, CvgSmem(hid).total, s>>>(MVDF_CV_ARGS(bf16));
  } else {
    if (nh > 16) return (int)cudaErrorInvalidValue;
    dim3 grid((N + CV_TN - 1) / CV_TN, V);
    const int threads = hid < 256 ? ((hid + 31) / 32) * 32 : 256;
    if (dtype == DT_BF16)
      cv_gather_kernel<bf16, MODE><<<grid, threads, 0, s>>>(MVDF_CV_ARGS(bf16));
    else
      cv_gather_kernel<float, MODE><<<grid, threads, 0, s>>>(MVDF_CV_ARGS(float));
  }
#undef MVDF_CV_ARGS
  return (int)cudaGetLastError();
}

// tokens (N, V, hid), point-major so the DiT's GEMMs read rows: fp32 for
// mode 0 (the single form's stream) and 2 (the two-phase form's), the maps'
// dtype for mode 1 (the two-phase form's phase-1 tokens; bacc unused).
// mma: the tensor-core gather (bf16 only), else the CUDA-core loop.
MVDF_API int mvdf_cv_gather(const void* xy, const void* pts, const void* centers, const void* mask,
                            const void* bacc, const void* maps, const void* kall, const void* kmask,
                            const void* freqs, int nh, void* tokens, int V, int N, int H, int W, int hid, int dtype,
                            int mode, int mma, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (mode == CV_SINGLE)
    return cv_gather_launch<CV_SINGLE>(xy, pts, centers, mask, bacc, maps, kall, kmask, freqs, nh, tokens, V, N, H, W,
                                       hid, dtype, mma, s);
  if (mode == CV_TOKENS)
    return cv_gather_launch<CV_TOKENS>(xy, pts, centers, mask, bacc, maps, kall, kmask, freqs, nh, tokens, V, N, H, W,
                                       hid, dtype, mma, s);
  if (mode == CV_STREAM)
    return cv_gather_launch<CV_STREAM>(xy, pts, centers, mask, bacc, maps, kall, kmask, freqs, nh, tokens, V, N, H, W,
                                       hid, dtype, mma, s);
  return (int)cudaErrorInvalidValue;
}

// qkv (N*V, 3*hid) fp32, rows packed per head -> out (N*V, hid); dh 8, 16,
// 32 or 64, V <= 16
MVDF_API int mvdf_cv_attention(const void* qkv, void* out, int N, int V, int heads, int dh, float scale, int dtype,
                               void* stream) {
  if (V < 1 || V > CV_MAX_VIEWS) return (int)cudaErrorInvalidValue;
  const int64_t items = (int64_t)N * heads;
  cudaStream_t s = (cudaStream_t)stream;
#define MVDF_CV_ATT(T, D)                                                                               \
  cv_attention_kernel<T, D><<<(unsigned)((items + (D <= 32 ? 4 : 2) - 1) / (D <= 32 ? 4 : 2)),          \
                              32 * (D <= 32 ? 4 : 2), 0, s>>>((const float*)qkv, (T*)out, N, V, heads, scale)
  if (dtype == DT_BF16) {
    if (dh == 32) MVDF_CV_ATT(bf16, 32);
    else if (dh == 8) MVDF_CV_ATT(bf16, 8);
    else if (dh == 16) MVDF_CV_ATT(bf16, 16);
    else if (dh == 64) MVDF_CV_ATT(bf16, 64);
    else return (int)cudaErrorInvalidValue;
  } else {
    if (dh == 32) MVDF_CV_ATT(float, 32);
    else if (dh == 8) MVDF_CV_ATT(float, 8);
    else if (dh == 16) MVDF_CV_ATT(float, 16);
    else if (dh == 64) MVDF_CV_ATT(float, 64);
    else return (int)cudaErrorInvalidValue;
  }
#undef MVDF_CV_ATT
  return (int)cudaGetLastError();
}

// y (M, C) in `dtype` = LN(x) * (1 + scale) + shift, x fp32; C % 4 == 0, C <= 1024
MVDF_API int mvdf_cv_layernorm(const void* x, const void* scale, const void* shift, void* y, int M, int C, float eps,
                               int dtype, void* stream) {
  if (C % 4 || C > 1024 || M <= 0) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((M + 7) / 8);
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == DT_BF16)
    cv_layernorm_kernel<bf16><<<blocks, 256, 0, s>>>((const float*)x, (const float*)scale, (const float*)shift, (bf16*)y,
                                                     M, C, eps);
  else
    cv_layernorm_kernel<float><<<blocks, 256, 0, s>>>((const float*)x, (const float*)scale, (const float*)shift,
                                                      (float*)y, M, C, eps);
  return (int)cudaGetLastError();
}

MVDF_API int mvdf_cv_pool(const void* x, const void* wl, const void* wl_b, void* pooled, int N, int V, int hid, int dtype,
                          void* stream) {
  if (V > 16) return (int)cudaErrorInvalidValue;
  const int warps = 8;
  const int blocks = (N + warps - 1) / warps;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == DT_BF16)
    cv_pool_kernel<bf16><<<blocks, 32 * warps, 0, s>>>((const float*)x, (const bf16*)wl, (const float*)wl_b, (bf16*)pooled, N, V,
                                                       hid);
  else
    cv_pool_kernel<float><<<blocks, 32 * warps, 0, s>>>((const float*)x, (const float*)wl, (const float*)wl_b, (float*)pooled, N,
                                                        V, hid);
  return (int)cudaGetLastError();
}
