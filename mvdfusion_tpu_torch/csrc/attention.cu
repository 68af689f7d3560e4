// K2: unmasked, non-causal multi-head softmax attention.
//
// Replaces mvdfusion_tpu/ops/attention.py::_fused_attention_fwd_impl (:172)
// and its four Pallas kernels (_attn_kernel, _attn_kernel_probs,
// _attn_kernel_t, _attn_kernel_t_probs: two rounding forms, each in two
// orientations for Mosaic's layouts). Also the self-attention stage of K3
// (ops/block.py) and of K5 (blockforms.cu).
//
// Bound on the H100: operations at every main-path shape (4*Nq*Nk*dh flops
// against (2Nq + 2Nk)*dh*2 bytes: at the 32^2 sites (16, 1024, 8, 40) 21.5
// GFLOP against 5.2 MB, 0.022 ms at 989 TFLOP/s; CLIP (1, 257, 16, 64) 0.27
// GFLOP), bytes only for tiny Nk.
//
// Design. Two forms, chosen by dtype and dh in dispatch_attn:
// - bf16 operands, dh <= 128 (every main-path call: dh 40 and 80 at the
//   sites, 64 in CLIP): attention.cuh's attn_tile_mma. A block of 4 warps
//   takes 64 queries of one (batch, head), each warp 16 of them with their Q
//   fragments in registers. K and V tiles of 64 keys stream through a
//   two-stage ring in shared memory filled by 16-byte cp.async copies, the
//   next tile's copy in flight while this tile's products run. QK^T and PV
//   are mma.sync m16n8k16 (bf16 operands, fp32 sums) on the tensor cores, the
//   B fragments read by ldmatrix (V transposed on the way); dh is padded
//   with zero columns to a multiple of 16 in shared memory (40 -> 48), and P
//   goes from the QK^T sum registers straight into PV's A fragments. Two
//   sweeps over the keys put the bf16 rounding of P where the reference puts
//   it: the first finds each row's max (and its softmax sum), the second
//   recomputes S and rounds P against the final max, in the reference's form
//   for this dh (ops/attention.py::attention_mode; the sites always round
//   the normalised probabilities). The second QK^T costs half again the
//   products of one sweep. mma.sync rather than wgmma: its register
//   fragments are fixed by the ISA and ldmatrix takes one address a row, so
//   dh = 40 and the ragged key tile (CLIP's 257) need no shared-memory
//   descriptor layouts, which could not be checked without the card.
// - fp32 operands, or dh in (128, 512] (the VAE mid-attention at batch 1,
//   outside the main path): attention.cuh's attn_tile, full fp32 products on
//   the CUDA cores. TPQ threads share a query and split its head dim; scores
//   are reduced with shuffles in chunks of 8 keys and folded into an fp32
//   online softmax whose probabilities stay in fp32.
// The ragged last key tile is masked in both.
#include <type_traits>

#include "attention.cuh"

namespace mvdf {

template <int DP>
__global__ void __launch_bounds__(128)
    attn_mma_kernel(const bf16* q, const bf16* k, const bf16* v, bf16* o, int H, int Nq, int Nk, int dh,
                    int64_t q_sb, int64_t q_sn, int64_t k_sb, int64_t k_sn, int64_t v_sb, int64_t v_sn,
                    int64_t o_sb, int64_t o_sn, float scale, int mode) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  attn_tile_mma<DP>(q, k, v, o, H, Nq, Nk, dh, q_sb, q_sn, k_sb, k_sn, v_sb, v_sn, o_sb, o_sn, scale, mode,
                    blockIdx.x, blockIdx.y, smem_raw);
}

template <typename T, int TPQ, int DPT>
__global__ void __launch_bounds__(128) attn_kernel(const T* q, const T* k, const T* v, T* o, int H, int Nq, int Nk,
                                                   int dh, int64_t q_sb, int64_t q_sn, int64_t k_sb, int64_t k_sn,
                                                   int64_t v_sb, int64_t v_sn, int64_t o_sb, int64_t o_sn,
                                                   float scale_log2, int BK) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  attn_tile<T, TPQ, DPT>(q, k, v, o, H, Nq, Nk, dh, q_sb, q_sn, k_sb, k_sn, v_sb, v_sn, o_sb, o_sn, scale_log2, BK,
                         blockIdx.x, blockIdx.y, smem_raw);
}

#define MVDF_ATTN_PARAMS                                                                                         \
  const void *q, const void *k, const void *v, void *o, int B, int H, int Nq, int Nk, int dh, int64_t q_sb,       \
      int64_t q_sn, int64_t k_sb, int64_t k_sn, int64_t v_sb, int64_t v_sn, int64_t o_sb, int64_t o_sn,          \
      float scale, int mode, cudaStream_t s
#define MVDF_ATTN_ARGS q, k, v, o, B, H, Nq, Nk, dh, q_sb, q_sn, k_sb, k_sn, v_sb, v_sn, o_sb, o_sn, scale, mode, s

template <int DP>
static int launch_attn_mma(MVDF_ATTN_PARAMS) {
  constexpr int smem = attn::Tile<DP>::SMEM;
  cudaError_t e = cudaFuncSetAttribute(attn_mma_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((Nq + attn::QB - 1) / attn::QB, B * H);
  attn_mma_kernel<DP><<<grid, 128, smem, s>>>((const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, H,
                                                        Nq, Nk, dh, q_sb, q_sn, k_sb, k_sn, v_sb, v_sn, o_sb, o_sn,
                                                        scale, mode);
  return (int)cudaGetLastError();
}

template <typename T, int TPQ, int DPT>
static int launch_attn(MVDF_ATTN_PARAMS) {
  const int threads = 128;
  const int BQ = threads / TPQ;
  int BK = 64;
  while (BK > 8 && (size_t)2 * BK * dh * sizeof(T) > 40 * 1024) BK >>= 1;
  const size_t smem = (size_t)2 * BK * dh * sizeof(T);
  dim3 grid((Nq + BQ - 1) / BQ, B * H);
  attn_kernel<T, TPQ, DPT><<<grid, threads, smem, s>>>((const T*)q, (const T*)k, (const T*)v, (T*)o, H, Nq, Nk,
                                                        dh, q_sb, q_sn, k_sb, k_sn, v_sb, v_sn, o_sb, o_sn,
                                                        scale * 1.4426950408889634f, BK);
  return (int)cudaGetLastError();
}

// bf16 at dh <= 128: the tensor-core tile, dh padded to DP = 16 * ceil(dh / 16)
static int dispatch_attn_bf16(MVDF_ATTN_PARAMS) {
  if (dh % 8) return (int)cudaErrorInvalidValue;
  switch ((dh + 15) / 16) {
    case 1: return launch_attn_mma<16>(MVDF_ATTN_ARGS);
    case 2: return launch_attn_mma<32>(MVDF_ATTN_ARGS);
    case 3: return launch_attn_mma<48>(MVDF_ATTN_ARGS);
    case 4: return launch_attn_mma<64>(MVDF_ATTN_ARGS);
    case 5: return launch_attn_mma<80>(MVDF_ATTN_ARGS);
    case 6: return launch_attn_mma<96>(MVDF_ATTN_ARGS);
    case 7: return launch_attn_mma<112>(MVDF_ATTN_ARGS);
    default: return launch_attn_mma<128>(MVDF_ATTN_ARGS);
  }
}

template <typename T>
static int dispatch_attn(MVDF_ATTN_PARAMS) {
  if (dh < 1 || dh > 512) return (int)cudaErrorInvalidValue;
  if constexpr (std::is_same<T, bf16>::value) {
    if (dh <= 128) return dispatch_attn_bf16(MVDF_ATTN_ARGS);
    return launch_attn<T, 16, 32>(MVDF_ATTN_ARGS);
  } else {
    if (dh <= 32) return launch_attn<T, 4, 8>(MVDF_ATTN_ARGS);
    if (dh <= 64) return launch_attn<T, 4, 16>(MVDF_ATTN_ARGS);
    if (dh <= 128) return launch_attn<T, 4, 32>(MVDF_ATTN_ARGS);
    return launch_attn<T, 16, 32>(MVDF_ATTN_ARGS);
  }
}

}  // namespace mvdf

using namespace mvdf;

// q/k/v/o element (b, n, h, d) sits at b*sb + n*sn + h*dh + d. mode: the
// tensor-core tile's rounding form (ATTN_PROBS 0, ATTN_PV 1); the fp32 loop
// ignores it.
MVDF_API int mvdf_attention(const void* q, const void* k, const void* v, void* o, int B, int H, int Nq, int Nk,
                            int dh, int64_t q_sb, int64_t q_sn, int64_t k_sb, int64_t k_sn, int64_t v_sb,
                            int64_t v_sn, int64_t o_sb, int64_t o_sn, float scale, int mode, int dtype,
                            void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == DT_BF16) return dispatch_attn<bf16>(MVDF_ATTN_ARGS);
  return dispatch_attn<float>(MVDF_ATTN_ARGS);
}
