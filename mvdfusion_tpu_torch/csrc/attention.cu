// K2: unmasked, non-causal multi-head softmax attention.
//
// Replaces mvdfusion_tpu/ops/attention.py::_fused_attention_fwd_impl and its
// four Pallas kernels (_attn_kernel, _attn_kernel_probs, _attn_kernel_t,
// _attn_kernel_t_probs: one function, split only for Mosaic's layouts).
// Also serves as the self-attention stage of K3 (ops/block.py).
//
// Bound on the H100: operations at the UNet and CLIP shapes (4*Nq*Nk*dh flops
// against (Nq+2Nk)*dh*2 bytes), bytes only for tiny Nk. This first kernel runs
// the products on the fp32 CUDA cores, so its ceiling is the 67 TFLOP/s fp32
// rate, not the 989 TFLOP/s bf16 tensor-core rate; moving QK^T and PV onto
// mma/wgmma is later work. Design: one block per (q-tile, batch*head); the
// K/V tile for all queries of the block is staged in shared memory; TPQ
// threads share one query and split its head dim (the dh=512 VAE head keeps
// 32 accumulator floats per thread); scores are reduced with warp shuffles in
// chunks of 8 keys and folded into an fp32 online softmax (running max and
// sum, deferred normalisation), so the (Nq, Nk) logits never leave the SM.
// The ragged last key tile (CLIP's N=257) is masked.
#include "common.cuh"

namespace mvdf {

template <typename T, int TPQ, int DPT>
__global__ void __launch_bounds__(128) attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                                   const T* __restrict__ v, T* __restrict__ o, int H, int Nq,
                                                   int Nk, int dh, int64_t q_sb, int64_t q_sn, int64_t k_sb,
                                                   int64_t k_sn, int64_t v_sb, int64_t v_sn, int64_t o_sb,
                                                   int64_t o_sn, float scale_log2, int BK) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);
  T* Vs = Ks + BK * dh;
  const int BQ = blockDim.x / TPQ;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int qi = blockIdx.x * BQ + threadIdx.x / TPQ;
  const int part = threadIdx.x % TPQ;
  const bool qvalid = qi < Nq;

  float qr[DPT], acc[DPT];
  const T* qp = q + b * q_sb + (int64_t)(qvalid ? qi : 0) * q_sn + h * dh;
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    const int d = part + i * TPQ;
    qr[i] = (d < dh) ? to_f(qp[d]) * scale_log2 : 0.0f;
    acc[i] = 0.0f;
  }
  float m = -INFINITY, l = 0.0f;
  const T* kb = k + b * k_sb + h * dh;
  const T* vb = v + b * v_sb + h * dh;

  for (int k0 = 0; k0 < Nk; k0 += BK) {
    const int nk = min(BK, Nk - k0);
    __syncthreads();
    for (int e = threadIdx.x; e < nk * dh; e += blockDim.x) {
      const int j = e / dh, d = e - j * dh;
      Ks[e] = kb[(int64_t)(k0 + j) * k_sn + d];
      Vs[e] = vb[(int64_t)(k0 + j) * v_sn + d];
    }
    __syncthreads();
    for (int j0 = 0; j0 < nk; j0 += 8) {
      float s[8];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        float p = 0.0f;
        if (j0 + jj < nk) {
          const T* kr = Ks + (j0 + jj) * dh;
#pragma unroll
          for (int i = 0; i < DPT; ++i) {
            const int d = part + i * TPQ;
            if (d < dh) p += qr[i] * to_f(kr[d]);
          }
        }
        s[jj] = p;
      }
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
        for (int off = TPQ / 2; off > 0; off >>= 1) s[jj] += __shfl_xor_sync(0xffffffffu, s[jj], off);
      }
      float mc = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        if (j0 + jj >= nk) s[jj] = -INFINITY;
        mc = fmaxf(mc, s[jj]);
      }
      const float mn = fmaxf(m, mc);  // finite: chunk j0 always holds a key
      const float corr = exp2f(m - mn);
      l *= corr;
#pragma unroll
      for (int i = 0; i < DPT; ++i) acc[i] *= corr;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        if (j0 + jj < nk) {
          const float p = exp2f(s[jj] - mn);
          l += p;
          const T* vr = Vs + (j0 + jj) * dh;
#pragma unroll
          for (int i = 0; i < DPT; ++i) {
            const int d = part + i * TPQ;
            if (d < dh) acc[i] += p * to_f(vr[d]);
          }
        }
      }
      m = mn;
    }
  }
  if (qvalid) {
    const float inv = 1.0f / l;
    T* op = o + b * o_sb + (int64_t)qi * o_sn + h * dh;
#pragma unroll
    for (int i = 0; i < DPT; ++i) {
      const int d = part + i * TPQ;
      if (d < dh) op[d] = from_f<T>(acc[i] * inv);
    }
  }
}

template <typename T, int TPQ, int DPT>
static void launch_attn(const void* q, const void* k, const void* v, void* o, int B, int H, int Nq, int Nk,
                        int dh, int64_t q_sb, int64_t q_sn, int64_t k_sb, int64_t k_sn, int64_t v_sb,
                        int64_t v_sn, int64_t o_sb, int64_t o_sn, float scale, cudaStream_t s) {
  const int threads = 128;
  const int BQ = threads / TPQ;
  int BK = 64;
  while (BK > 8 && (size_t)2 * BK * dh * sizeof(T) > 40 * 1024) BK >>= 1;
  const size_t smem = (size_t)2 * BK * dh * sizeof(T);
  dim3 grid((Nq + BQ - 1) / BQ, B * H);
  attn_kernel<T, TPQ, DPT><<<grid, threads, smem, s>>>((const T*)q, (const T*)k, (const T*)v, (T*)o, H, Nq, Nk,
                                                        dh, q_sb, q_sn, k_sb, k_sn, v_sb, v_sn, o_sb, o_sn,
                                                        scale * 1.4426950408889634f, BK);
}

template <typename T>
static int dispatch_attn(const void* q, const void* k, const void* v, void* o, int B, int H, int Nq, int Nk,
                         int dh, int64_t q_sb, int64_t q_sn, int64_t k_sb, int64_t k_sn, int64_t v_sb,
                         int64_t v_sn, int64_t o_sb, int64_t o_sn, float scale, cudaStream_t s) {
#define MVDF_ATTN_ARGS q, k, v, o, B, H, Nq, Nk, dh, q_sb, q_sn, k_sb, k_sn, v_sb, v_sn, o_sb, o_sn, scale, s
  if (dh <= 32)
    launch_attn<T, 4, 8>(MVDF_ATTN_ARGS);
  else if (dh <= 64)
    launch_attn<T, 4, 16>(MVDF_ATTN_ARGS);
  else if (dh <= 128)
    launch_attn<T, 4, 32>(MVDF_ATTN_ARGS);
  else if (dh <= 512)
    launch_attn<T, 16, 32>(MVDF_ATTN_ARGS);
  else
    return (int)cudaErrorInvalidValue;
#undef MVDF_ATTN_ARGS
  return (int)cudaGetLastError();
}

}  // namespace mvdf

using namespace mvdf;

// q/k/v/o element (b, n, h, d) sits at b*sb + n*sn + h*dh + d.
MVDF_API int mvdf_attention(const void* q, const void* k, const void* v, void* o, int B, int H, int Nq, int Nk,
                            int dh, int64_t q_sb, int64_t q_sn, int64_t k_sb, int64_t k_sn, int64_t v_sb,
                            int64_t v_sn, int64_t o_sb, int64_t o_sn, float scale, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == DT_BF16)
    return dispatch_attn<bf16>(q, k, v, o, B, H, Nq, Nk, dh, q_sb, q_sn, k_sb, k_sn, v_sb, v_sn, o_sb, o_sn,
                               scale, s);
  return dispatch_attn<float>(q, k, v, o, B, H, Nq, Nk, dh, q_sb, q_sn, k_sb, k_sn, v_sb, v_sn, o_sb, o_sn,
                              scale, s);
}
