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
#include "attention.cuh"

namespace mvdf {

template <typename T, int TPQ, int DPT>
__global__ void __launch_bounds__(128) attn_kernel(const T* q, const T* k, const T* v, T* o, int H, int Nq, int Nk,
                                                   int dh, int64_t q_sb, int64_t q_sn, int64_t k_sb, int64_t k_sn,
                                                   int64_t v_sb, int64_t v_sn, int64_t o_sb, int64_t o_sn,
                                                   float scale_log2, int BK) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  attn_tile<T, TPQ, DPT>(q, k, v, o, H, Nq, Nk, dh, q_sb, q_sn, k_sb, k_sn, v_sb, v_sn, o_sb, o_sn, scale_log2, BK,
                         blockIdx.x, blockIdx.y, smem_raw);
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
