// The site GEMM on Hopper: epilogue(A[M, K] @ W[N, K]^T) with bf16 operands,
// fp32 sums, wgmma over a TMA-fed ring of shared-memory stages.
//
// Replaces the products that the TPU kernels compute in their own bodies:
// mvdfusion_tpu/ops/block.py::_attn_kernel (:315: proj_in, qkv, out-proj with
// both residuals) and _ff_kernel (:327: GEGLU, FF out + residual, proj_out +
// residual), the big-C form's _pi_kernel / _h2_kernel / _ff_stream_kernel
// products (:338-428), and the token-wise jnp.dot's of
// ops/crossview.py::_dit_pool (:188, :279). block.cu's wmma tile (gemm.cuh)
// computed them before, one 64x64 tile a block with an un-pipelined K loop.
//
// Bound on the H100: at the main path's shapes the products sit near the
// ridge (K = 256..5120: the 32^2 site's K = 320 products are bytes-bound,
// its FF out and the 16^2 site's are operations-bound), and the epilogue's
// CUDA-core work (an erf per GEGLU or GELU output, residual reads) rivals the
// products. The design:
// - a persistent grid, one 288-thread block an SM, walks 128 x 128 output
//   tiles (N fastest, so the blocks in flight share A's rows in L2);
// - one producer thread keeps a ring of 4 stages full with TMA copies
//   (cp.async.bulk.tensor, 64-deep K slices of A and W in the 128-byte
//   swizzle, zero-filled past the ragged edges of M, N and K), each stage
//   completing on an mbarrier; it runs ahead across tile boundaries, so the
//   next tile's loads overlap this tile's epilogue;
// - two consumer warpgroups, 64 rows each, issue wgmma m64n128k16 with A and
//   B (W's rows, already K-major) read from the swizzled stages, keep one
//   wgmma group in flight and release each stage as the next group starts;
// - the epilogue (gemm.cuh's Epilogue: bias, GELU or GEGLU, gate, two
//   residuals, `steps` rounding, bf16 or fp32 output that may alias res1)
//   stages the fp32 sums in shared memory, then each lane applies it to a
//   fixed 4-column vector down the rows, coalesced, with bias and gate read
//   once a tile and a batch's residual loads in flight together; the
//   main path's combinations of the epilogue's operands each have their own
//   branch-free loop (an unrolled register epilogue with the branches of all
//   of them was too large to run from the instruction cache; PERF.md).
// The same ring also feeds K4's qkv tile (qkv_attention_sm90_kernel below),
// which keeps the DiT's qkv sums in shared memory and attends across views
// there. W's tensor map is made once per prepared weight (mvdf_tma_desc);
// A's is made for each call. cuTensorMapEncodeTiled is fetched at run time
// (cudaGetDriverEntryPointByVersion), so nothing links -lcuda.
#include "gemm.cuh"
#include "viewattn.cuh"

namespace mvdf {
namespace sm90 {

constexpr int BM = 128, BN = 128, BK = 64, STAGES = 4, CONSUMERS = 2;
constexpr int THREADS = 128 * CONSUMERS + 32;  // two consumer warpgroups, one producer warp
constexpr int A_STAGE = BM * BK * 2, B_STAGE = BN * BK * 2;  // bytes of one stage of A and of W

// shared memory: the ring's A and W stages, then each consumer warpgroup's
// fp32 staging tile (64 rows of BN + 8 floats: the float2 writes from the
// accumulator layout and the row-wise float4 reads are free of bank
// conflicts), then the ring's barriers
struct Cfg {
  static constexpr int LDS = EPI_LDS;
  static_assert(LDS == BN + 8, "pass 2 reads the staging tile at EPI_LDS");
  static constexpr int RING = STAGES * (A_STAGE + B_STAGE);
  static constexpr int STAGING = CONSUMERS * 64 * LDS * 4;
  static constexpr int SMEM = RING + STAGING + 2 * STAGES * 8 + 1024;  // + alignment slack
};


// d (+)= A (64x16, K-major, smem) * B (96x16, K-major, smem); 48 fp32 sums a thread
__device__ __forceinline__ void wgmma_n96(float (&d)[48], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      "}, %48, %49, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(da), "l"(db), "r"(accumulate));
}


__global__ void __launch_bounds__(THREADS, 1)
    gemm_sm90_kernel(const __grid_constant__ CUtensorMap tmA, const __grid_constant__ CUtensorMap tmW, int N, int K,
                     Epilogue e, int kind) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* sA = smem;
  unsigned char* sB = smem + STAGES * A_STAGE;
  float* staging = reinterpret_cast<float*>(smem + Cfg::RING);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + Cfg::RING + Cfg::STAGING);
  uint64_t* empty = full + STAGES;

  const int tiles_n = (N + BN - 1) / BN;
  const int tiles = ((e.M + BM - 1) / BM) * tiles_n, nk = (K + BK - 1) / BK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);               // the producer's arrive + the copies' bytes
      mbar_init(&empty[s], 4 * CONSUMERS);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * CONSUMERS) {  // the producer
    if (lane == 0) {
      int it = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = (t / tiles_n) * BM, n0 = (t % tiles_n) * BN;
        for (int kb = 0; kb < nk; ++kb, ++it) {
          const int s = it % STAGES;
          mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);  // a fresh barrier passes parity 1
          mbar_expect_tx(&full[s], A_STAGE + B_STAGE);
          tma_load(sA + s * A_STAGE, &tmA, kb * BK, m0, &full[s]);
          tma_load(sB + s * B_STAGE, &tmW, kb * BK, n0, &full[s]);
        }
      }
    }
    return;
  }

  const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127;
  float* stage = staging + wg * 64 * Cfg::LDS;
  float d[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) d[i] = 0.0f;
  int it = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int m0 = (t / tiles_n) * BM, n0 = (t % tiles_n) * BN;
    int prev = -1;
    for (int kb = 0; kb < nk; ++kb, ++it) {
      const int s = it % STAGES;
      mbar_wait(&full[s], (it / STAGES) & 1);
      const unsigned char* a = sA + s * A_STAGE + wg * (64 * BK * 2);
      const unsigned char* b = sB + s * B_STAGE;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_n128(d, sw128_desc(a + kk * 32), sw128_desc(b + kk * 32), (kb | kk) != 0);
      wgmma_commit();
      wgmma_wait<1>();  // the previous slice's group is done: release its stage
      if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
      prev = s;
    }
    wgmma_wait<0>();
    if (lane == 0) mbar_arrive(&empty[prev]);
    // pass 1: the sums to the staging tile, once every warp of the warpgroup
    // is done with the previous tile's; pass 2 once all are there
    named_barrier(1 + wg, 128);
    const int sr = (tid >> 5) * 16 + (lane >> 2), sc = 2 * (lane & 3);
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
      *reinterpret_cast<float2*>(stage + sr * Cfg::LDS + 8 * i + sc) = make_float2(d[4 * i], d[4 * i + 1]);
      *reinterpret_cast<float2*>(stage + (sr + 8) * Cfg::LDS + 8 * i + sc) = make_float2(d[4 * i + 2], d[4 * i + 3]);
    }
    named_barrier(1 + wg, 128);
    pass2_kind(stage, e, kind, m0 + wg * 64, n0, tid);
  }
}

// K4's qkv GEMM with the view attention in its tiles: att = ViewAttention(
// A @ W^T + bias) for A (M = N*V, K <= 256) bf16 rows point-major and W
// (3*hid, K) with each head's q, k and v rows side by side
// (ops/crossview.py::pack_qkv_heads), dh = 32. The fp32 qkv never reaches
// device memory: a tile holds `points` whole points (points * V <= 128 rows,
// the M stride; A's 128-row box loads the rows past them too, and they are
// never written) and all of K, resident in shared memory while the block
// walks the heads; for each head the producer streams W's 96 rows through
// a 4-stage ring (the next head's while this head's epilogue runs), the two
// consumer warpgroups take the 64 x 96 products (wgmma m64n96k16), stage the
// sums in fp32 with the bias added and q scaled by dh^-0.5, and their 256
// threads attend (viewattn.cuh: two threads a query row, the key loop
// unrolled over 4, 8 or 16 keys without a branch) and store the head's 32
// columns of att in bf16, rounded once. The producer loads the next tile's
// A as soon as the last head's products are done. Measured slower (PERF.md):
// issuing the next head's products before this head's attention into a
// second set of accumulators; four threads a pair of query rows.
constexpr int QA_DH = 32, QA_BN = 3 * QA_DH, QA_SLICES = 4, QA_STAGES = 4;
constexpr int QA_A_SLICE = BM * BK * 2, QA_B_STAGE = QA_BN * BK * 2;

struct QaCfg {
  static constexpr int LDS = QA_BN + 8;  // as Cfg::LDS: the fragments' float2 stores without conflicts
  static constexpr int A = QA_SLICES * QA_A_SLICE;
  static constexpr int RING = QA_STAGES * QA_B_STAGE;
  static constexpr int STAGING = BM * LDS * 4;
  static constexpr int SMEM = A + RING + STAGING + (2 * QA_STAGES + 2) * 8 + 1024;
};

__global__ void __launch_bounds__(THREADS, 1)
    qkv_attention_sm90_kernel(const __grid_constant__ CUtensorMap tmA, const __grid_constant__ CUtensorMap tmW,
                              const float* __restrict__ bias, bf16* __restrict__ out, int M, int K, int V, int points,
                              int heads, float scale) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* sA = smem;
  unsigned char* sB = smem + QaCfg::A;
  float* stage = reinterpret_cast<float*>(smem + QaCfg::A + QaCfg::RING);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + QaCfg::A + QaCfg::RING + QaCfg::STAGING);
  uint64_t* empty = full + QA_STAGES;
  uint64_t* a_full = empty + QA_STAGES;
  uint64_t* a_empty = a_full + 1;

  const int rows = points * V, tiles = (M + rows - 1) / rows, nk = (K + BK - 1) / BK, hid = heads * QA_DH;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < QA_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * CONSUMERS);
    }
    mbar_init(a_full, 1);
    mbar_init(a_empty, 4 * CONSUMERS);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * CONSUMERS) {  // the producer
    if (lane == 0) {
      int it = 0, ti = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++ti) {
        mbar_wait(a_empty, (ti & 1) ^ 1);
        mbar_expect_tx(a_full, nk * QA_A_SLICE);
        for (int kb = 0; kb < nk; ++kb) tma_load(sA + kb * QA_A_SLICE, &tmA, kb * BK, t * rows, a_full);
        for (int h = 0; h < heads; ++h)
          for (int kb = 0; kb < nk; ++kb, ++it) {
            const int s = it % QA_STAGES;
            mbar_wait(&empty[s], ((it / QA_STAGES) & 1) ^ 1);
            mbar_expect_tx(&full[s], QA_B_STAGE);
            tma_load(sB + s * QA_B_STAGE, &tmW, kb * BK, h * QA_BN, &full[s]);
          }
      }
    }
    return;
  }

  const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127, ctid = threadIdx.x;
  const int sr = wg * 64 + (tid >> 5) * 16 + (lane >> 2), sc = 2 * (lane & 3);
  float d[QA_BN / 2];
  int it = 0, ti = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++ti) {
    const int m0 = t * rows;
    mbar_wait(a_full, ti & 1);
    for (int h = 0; h < heads; ++h) {
#pragma unroll
      for (int i = 0; i < QA_BN / 2; ++i) d[i] = 0.0f;
      int prev = -1;
      for (int kb = 0; kb < nk; ++kb, ++it) {
        const int s = it % QA_STAGES;
        mbar_wait(&full[s], (it / QA_STAGES) & 1);
        const unsigned char* a = sA + kb * QA_A_SLICE + wg * (64 * BK * 2);
        const unsigned char* b = sB + s * QA_B_STAGE;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          wgmma_n96(d, sw128_desc(a + kk * 32), sw128_desc(b + kk * 32), (kb | kk) != 0);
        wgmma_commit();
        wgmma_wait<1>();
        if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
        prev = s;
      }
      wgmma_wait<0>();
      wgmma_fence_operand(d);
      if (lane == 0) {
        mbar_arrive(&empty[prev]);
        if (h == heads - 1) mbar_arrive(a_empty);  // the tile's products are done with A
      }
      // the previous head's attention is done with the staging tile
      named_barrier(1, 128 * CONSUMERS);
      const float* bh = bias + h * QA_BN;
#pragma unroll
      for (int i = 0; i < QA_BN / 8; ++i) {
        const int c = 8 * i + sc;
        const float2 b = *reinterpret_cast<const float2*>(bh + c);
        const float f = i < QA_DH / 8 ? scale : 1.0f;  // q's columns
        *reinterpret_cast<float2*>(stage + sr * QaCfg::LDS + c) = make_float2((d[4 * i] + b.x) * f, (d[4 * i + 1] + b.y) * f);
        *reinterpret_cast<float2*>(stage + (sr + 8) * QaCfg::LDS + c) =
            make_float2((d[4 * i + 2] + b.x) * f, (d[4 * i + 3] + b.y) * f);
      }
      named_barrier(1, 128 * CONSUMERS);
      const int r = ctid >> 1, half = ctid & 1;
      const bool ok = r < rows && m0 + r < M;
      const int rr = ok ? r : 0, p0 = (rr / V) * V;
      const float* pt = stage + p0 * QaCfg::LDS;
      float o[QA_DH / 2];
      if (V <= 4)
        view_attention_half<QA_DH, 4>(pt, QaCfg::LDS, rr - p0, half, V, 1.0f, o);
      else if (V <= 8)
        view_attention_half<QA_DH, 8>(pt, QaCfg::LDS, rr - p0, half, V, 1.0f, o);
      else
        view_attention_half<QA_DH, CV_MAX_VIEWS>(pt, QaCfg::LDS, rr - p0, half, V, 1.0f, o);
      if (ok) store_row<QA_DH / 2>(out + (int64_t)(m0 + r) * hid + h * QA_DH + half * (QA_DH / 2), o);
    }
  }
}


static int launch(const CUtensorMap& tmA, const CUtensorMap& tmW, int N, int K, const Epilogue& e,
                  cudaStream_t stream) {
  static int sms = 0;
  if (!sms) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const cudaError_t rc = cudaFuncSetAttribute(gemm_sm90_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::SMEM);
    if (rc != cudaSuccess || sms <= 0) {
      sms = 0;
      return rc != cudaSuccess ? (int)rc : (int)cudaErrorInvalidDevice;
    }
  }
  const int tiles = ((e.M + BM - 1) / BM) * ((N + BN - 1) / BN);
  gemm_sm90_kernel<<<tiles < sms ? tiles : sms, THREADS, Cfg::SMEM, stream>>>(tmA, tmW, N, K, e, epilogue_kind(e));
  return (int)cudaGetLastError();
}

}  // namespace sm90
}  // namespace mvdf

using namespace mvdf;

// W's tensor map (rows x cols bf16, boxes of 64 columns x box_rows rows) into
// the 128 bytes at `desc` (host memory), made once per prepared weight.
MVDF_API int mvdf_tma_desc(const void* base, int rows, int cols, int box_rows, void* desc) {
  if ((uintptr_t)base % 16 || cols % 8 || box_rows < 8 || box_rows > 256) return (int)cudaErrorInvalidValue;
  CUtensorMap map;
  const int rc = sm90::encode(&map, base, rows, cols, box_rows);
  if (rc == 0) memcpy(desc, &map, sizeof(map));
  return rc;
}

// epilogue(A (M, K) @ W (N, K)^T) in bf16 on the wgmma kernel; w_desc is
// W's map from mvdf_tma_desc with box_rows == bn, the tile width (128). act, steps and
// the epilogue's operands as mvdf_gemm's (block.cu); Nout % 4 == 0, and bias,
// gate, out and the residuals 16-byte aligned.
MVDF_API int mvdf_gemm_sm90(const void* A, const void* w_desc, const void* bias, void* out, int out_bf16,
                            const void* res1, int res1_bf16, const void* res2, int res2_bf16, int res2_div,
                            const void* gate, int act, int steps, int M, int N, int K, int bn, void* stream) {
  Epilogue e;
  e.bias = (const float*)bias;
  e.out = out;
  e.out_bf16 = out_bf16;
  e.res1 = res1;
  e.res1_bf16 = res1_bf16;
  e.res2 = res2;
  e.res2_bf16 = res2_bf16;
  e.res2_div = res2_div > 0 ? res2_div : 1;
  e.gate = (const float*)gate;
  e.act = act;
  e.steps = steps;
  e.M = M;
  e.Nout = act == ACT_GEGLU ? N / 2 : N;
  if (M <= 0 || K % 8 || e.Nout % 4 || (act == ACT_GEGLU && N % 64) || (uintptr_t)A % 16)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tmA, tmW;
  const int rc = sm90::encode(&tmA, A, M, K, sm90::BM);
  if (rc) return rc;
  memcpy(&tmW, w_desc, sizeof(tmW));
  cudaStream_t s = (cudaStream_t)stream;
  return bn == sm90::BN ? sm90::launch(tmA, tmW, N, K, e, s) : (int)cudaErrorInvalidValue;
}

// att = ViewAttention(A (M, K) @ W^T + bias) in bf16 (qkv_attention_sm90_kernel):
// w_desc is W's map from mvdf_tma_desc with box_rows == 96 (one head's packed
// q, k and v rows; W (3 * 32 * heads, K)); bias (3 * 32 * heads) fp32, packed
// alike; M = N * V rows point-major, `points` whole points a tile
// (points * V <= 128); K <= 256, K % 8 == 0; dh = 32.
MVDF_API int mvdf_qkv_attention_sm90(const void* A, const void* w_desc, const void* bias, void* out, int M, int K,
                                     int V, int points, int heads, float scale, void* stream) {
  using sm90::QaCfg;
  if (M <= 0 || K % 8 || K > sm90::QA_SLICES * sm90::BK || V < 1 || V > CV_MAX_VIEWS || points < 1 ||
      points * V > sm90::BM || M % V || heads < 1 || !bias || (uintptr_t)A % 16 || (uintptr_t)out % 16)
    return (int)cudaErrorInvalidValue;
  static int sms = 0;
  if (!sms) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const cudaError_t rc =
        cudaFuncSetAttribute(sm90::qkv_attention_sm90_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, QaCfg::SMEM);
    if (rc != cudaSuccess || sms <= 0) {
      sms = 0;
      return rc != cudaSuccess ? (int)rc : (int)cudaErrorInvalidDevice;
    }
  }
  CUtensorMap tmA, tmW;
  const int rc = sm90::encode(&tmA, A, M, K, sm90::BM);
  if (rc) return rc;
  memcpy(&tmW, w_desc, sizeof(tmW));
  const int tiles = (M + points * V - 1) / (points * V);
  sm90::qkv_attention_sm90_kernel<<<tiles < sms ? tiles : sms, sm90::THREADS, QaCfg::SMEM, (cudaStream_t)stream>>>(
      tmA, tmW, (const float*)bias, (bf16*)out, M, K, V, points, heads, scale);
  return (int)cudaGetLastError();
}
