// K4 stages: the bilinear gather with the geometric embedding, the
// attention across views, and the softmax pool over views.
//
// With the LayerNorm and GEMM kernels of block.cu these replace both forms
// of mvdfusion_tpu/ops/crossview.py::_crossview_fwd_impl: the single-kernel
// form (_kernel with _geo_aug_t, _erf/_gelu and _dit_pool) and the two-phase
// form (_gather_kernel, then _dit_kernel), which the reference takes when
// the V projected maps exceed 6 MiB (V >= 13 views at 32^2 in bf16).
//
// Bound on the H100: operations. At the flagship shape (V=8 views, N=8192
// points, hid=256, 3 layers) the DiT products are ~210 GFLOP a step against
// a few hundred MB of traffic; the gather and the embedding are ~4 GFLOP.
// At the 15-view eval shape (N=15360) the products are ~725 GFLOP.
// Design: the TPU kernel keeps the (N, V, hid) tokens in VMEM; an H100 SM
// cannot hold the DiT weights and a useful token block at once, so here the
// gather writes the tokens once, the DiT runs as token-wise tensor-core
// GEMMs over all N*V tokens (weights read once per layer, the fp32 residual
// stream updated in place by the GEMM epilogue's gated add), and only the
// per-point work is custom: a 4-tap gather with a border clamp (not the
// TPU's one-hot matmul), the harmonic embedding computed in registers from
// the raw 7-vector (ray direction, Plucker moment, depth), a V-token
// attention per point and head in registers, and the pool.
// The two forms differ only in their numerics, which this file keeps: the
// single form adds b_acc and applies the GELU to fp32 tokens in the gather
// (fp32 out); the two-phase form's gather rounds the tokens to the maps'
// dtype before b_acc (the reference's phase-1 output), and a separate
// elementwise pass adds b_acc in fp32 and applies the GELU. The TPU's
// view-major grid and its 128-token blocks exist for VMEM and are not kept.
#include "common.cuh"

namespace mvdf {

constexpr int CV_TN = 16;    // points per gather block
constexpr int CV_MAXG = 7 * 33;  // raw + sin + cos features for up to 16 harmonics

// single form (TOKENS false), fp32 out:
//   tokens[n, v, :] = gelu(bilinear(maps[v], xy[v, n]) + aug(pts[n], c_v) @ kall
//                          + mask[v] * kmask + bacc[n])
// with the bilinear weights and aug rounded to T, sums in fp32.
// two-phase form's phase 1 (TOKENS true, bacc unused), out in T:
//   tokens[n, v, :] = T(bilinear(maps[v], xy[v, n]) + aug(pts[n], c_v) @ kall + mask[v] * kmask)
template <typename T, bool TOKENS>
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

  if (tid < CV_TN) {
    const int n = min(n0 + tid, N - 1);
    const float cx = centers[v * 3 + 0], cy = centers[v * 3 + 1], cz = centers[v * 3 + 2];
    const float dx = pts[n * 3 + 0] - cx, dy = pts[n * 3 + 1] - cy, dz = pts[n * 3 + 2] - cz;
    const float depth = sqrtf(dx * dx + dy * dy + dz * dz);
    const float inv = 1.0f / fmaxf(depth, 1e-12f);
    const float ux = dx * inv, uy = dy * inv, uz = dz * inv;
    X[tid][0] = ux;
    X[tid][1] = uy;
    X[tid][2] = uz;
    X[tid][3] = cy * uz - cz * uy;  // o x d
    X[tid][4] = cz * ux - cx * uz;
    X[tid][5] = cx * uy - cy * ux;
    X[tid][6] = depth;
    // align_corners=True, border clamp of the coordinate itself
    const float gx = fminf(fmaxf((xy[((int64_t)v * N + n) * 2 + 0] + 1.0f) * 0.5f * (W - 1), 0.0f), (float)(W - 1));
    const float gy = fminf(fmaxf((xy[((int64_t)v * N + n) * 2 + 1] + 1.0f) * 0.5f * (H - 1), 0.0f), (float)(H - 1));
    const float fx = floorf(gx), fy = floorf(gy);
    const float tx = gx - fx, ty = gy - fy;
    const int x0 = (int)fx, y0 = (int)fy;
    const int x1 = min(x0 + 1, W - 1), y1 = min(y0 + 1, H - 1);
    tap_i[tid][0] = y0 * W + x0;
    tap_i[tid][1] = y0 * W + x1;
    tap_i[tid][2] = y1 * W + x0;
    tap_i[tid][3] = y1 * W + x1;
    // the hat weights and (below) the geometric features are rounded to T
    // before their products, as the reference rounds Wm and aug to dt
    tap_w[tid][0] = to_f(from_f<T>((1.0f - tx) * (1.0f - ty)));
    tap_w[tid][1] = to_f(from_f<T>(tx * (1.0f - ty)));
    tap_w[tid][2] = to_f(from_f<T>((1.0f - tx) * ty));
    tap_w[tid][3] = to_f(from_f<T>(tx * ty));
  }
  __syncthreads();
  // [raw 7 | sin(f_k X) freq-major | cos(f_k X) freq-major]
  for (int e = tid; e < CV_TN * G; e += blockDim.x) {
    const int p = e / G, g = e - p * G;
    float a;
    if (g < 7) {
      a = X[p][g];
    } else {
      const int s = (g - 7) % (7 * nh);
      const float arg = X[p][s % 7] * freqs[s / 7];
      a = (g < 7 + 7 * nh) ? sinf(arg) : cosf(arg);
    }
    aug[p][g] = to_f(from_f<T>(a));
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
        if (!TOKENS) t += to_f(bacc[(int64_t)n * hid + c]);
#pragma unroll
        for (int q = 0; q < 4; ++q) t += tap_w[p][q] * to_f(mv[(int64_t)tap_i[p][q] * hid]);
        const int64_t o = ((int64_t)n * V + v) * hid + c;
        if (TOKENS)
          reinterpret_cast<T*>(tokens)[o] = from_f<T>(t);
        else
          reinterpret_cast<float*>(tokens)[o] = gelu_erf(t);
      }
    }
  }
}

// Two-phase form, phase 2's entry: x[n, v, :] = gelu(float(tok[n, v, :]) +
// float(bacc[n, :])) into the fp32 residual stream (the reference's
// _dit_kernel prologue). Elementwise, bytes-bound.
template <typename T>
__global__ void __launch_bounds__(256) cv_token_gelu_kernel(const T* __restrict__ tok, const T* __restrict__ bacc,
                                                            float* __restrict__ x, int64_t total, int V, int hid) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int64_t n = i / ((int64_t)V * hid);
  const int c = (int)(i % hid);
  x[i] = gelu_erf(to_f(tok[i]) + to_f(bacc[n * hid + c]));
}

// Attention across the V tokens of each point: qkv (N*V, 3*hid) fp32 rows
// [q | k | v] -> out (N*V, hid). One thread per (point, head, query view).
template <typename T, int DH>
__global__ void __launch_bounds__(256) cv_attention_kernel(const float* __restrict__ qkv, T* __restrict__ out,
                                                           int N, int V, int heads, float scale) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (int64_t)N * V * heads) return;
  const int vq = (int)(t % V);
  const int h = (int)((t / V) % heads);
  const int64_t n = t / ((int64_t)V * heads);
  const int hid = heads * DH;
  const float* base = qkv + n * V * 3 * hid;
  float q[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) q[d] = base[(int64_t)vq * 3 * hid + h * DH + d] * scale;
  float s[16];
  float mx = -INFINITY;
  for (int w = 0; w < V; ++w) {
    const float* kr = base + (int64_t)w * 3 * hid + hid + h * DH;
    float a = 0.0f;
#pragma unroll
    for (int d = 0; d < DH; ++d) a += q[d] * kr[d];
    s[w] = a;
    mx = fmaxf(mx, a);
  }
  float den = 0.0f;
  for (int w = 0; w < V; ++w) {
    s[w] = expf(s[w] - mx);
    den += s[w];
  }
  const float inv = 1.0f / den;
  float o[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) o[d] = 0.0f;
  for (int w = 0; w < V; ++w) {
    const float* vr = base + (int64_t)w * 3 * hid + 2 * hid + h * DH;
    const float p = s[w] * inv;
#pragma unroll
    for (int d = 0; d < DH; ++d) o[d] += p * vr[d];
  }
  T* orow = out + (n * V + vq) * hid + h * DH;
#pragma unroll
  for (int d = 0; d < DH; ++d) orow[d] = from_f<T>(o[d]);
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

template <bool TOKENS>
static int cv_gather_launch(const void* xy, const void* pts, const void* centers, const void* mask, const void* bacc,
                            const void* maps, const void* kall, const void* kmask, const void* freqs, int nh,
                            void* tokens, int V, int N, int H, int W, int hid, int dtype, void* stream) {
  if (nh > 16) return (int)cudaErrorInvalidValue;
  dim3 grid((N + CV_TN - 1) / CV_TN, V);
  const int threads = hid < 256 ? ((hid + 31) / 32) * 32 : 256;
  cudaStream_t s = (cudaStream_t)stream;
#define MVDF_CV_ARGS(T)                                                                                         \
  (const float*)xy, (const float*)pts, (const float*)centers, (const float*)mask, (const T*)bacc, (const T*)maps, \
      (const T*)kall, (const float*)kmask, (const float*)freqs, nh, tokens, V, N, H, W, hid
  if (dtype == DT_BF16)
    cv_gather_kernel<bf16, TOKENS><<<grid, threads, 0, s>>>(MVDF_CV_ARGS(bf16));
  else
    cv_gather_kernel<float, TOKENS><<<grid, threads, 0, s>>>(MVDF_CV_ARGS(float));
#undef MVDF_CV_ARGS
  return (int)cudaGetLastError();
}

MVDF_API int mvdf_cv_gather(const void* xy, const void* pts, const void* centers, const void* mask,
                            const void* bacc, const void* maps, const void* kall, const void* kmask,
                            const void* freqs, int nh, void* tokens, int V, int N, int H, int W, int hid, int dtype,
                            void* stream) {
  return cv_gather_launch<false>(xy, pts, centers, mask, bacc, maps, kall, kmask, freqs, nh, tokens, V, N, H, W,
                                 hid, dtype, stream);
}

// tokens (N, V, hid) in the maps' dtype, point-major so the DiT's GEMMs read rows
MVDF_API int mvdf_cv_gather_tokens(const void* xy, const void* pts, const void* centers, const void* mask,
                                   const void* maps, const void* kall, const void* kmask, const void* freqs, int nh,
                                   void* tokens, int V, int N, int H, int W, int hid, int dtype, void* stream) {
  return cv_gather_launch<true>(xy, pts, centers, mask, nullptr, maps, kall, kmask, freqs, nh, tokens, V, N, H, W,
                                hid, dtype, stream);
}

MVDF_API int mvdf_cv_token_gelu(const void* tok, const void* bacc, void* x, int N, int V, int hid, int dtype,
                                void* stream) {
  const int64_t total = (int64_t)N * V * hid;
  const int64_t blocks = (total + 255) / 256;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == DT_BF16)
    cv_token_gelu_kernel<bf16><<<(unsigned)blocks, 256, 0, s>>>((const bf16*)tok, (const bf16*)bacc, (float*)x, total,
                                                                V, hid);
  else
    cv_token_gelu_kernel<float><<<(unsigned)blocks, 256, 0, s>>>((const float*)tok, (const float*)bacc, (float*)x,
                                                                 total, V, hid);
  return (int)cudaGetLastError();
}

MVDF_API int mvdf_cv_attention(const void* qkv, void* out, int N, int V, int heads, int dh, float scale, int dtype,
                               void* stream) {
  if (V > 16) return (int)cudaErrorInvalidValue;
  const int64_t total = (int64_t)N * V * heads;
  const int blocks = (int)((total + 255) / 256);
  cudaStream_t s = (cudaStream_t)stream;
#define MVDF_CV_ATT(T, D) cv_attention_kernel<T, D><<<blocks, 256, 0, s>>>((const float*)qkv, (T*)out, N, V, heads, scale)
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
