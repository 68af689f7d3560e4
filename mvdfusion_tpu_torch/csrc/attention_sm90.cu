// K2 on Hopper at head dim 64: bf16 attention in the `pv` rounding form over
// whole key tiles, wgmma products fed by a TMA ring.
//
// Replaces mvdfusion_tpu/ops/attention.py::_fused_attention_fwd_impl (:172)
// where ops/attention.py::attention_route picks "sm90": bf16 operands on the
// card, dh = 64, the pv form, a power-of-two scale (dh^-0.5 = 1/8), Nq and Nk
// multiples of 128 with Nk >= 256, and rows and base pointers on TMA's
// 16-byte rule (MVDream's joined attn1 at 4096, 1024 and 256 keys). Every other call keeps attention.cu's tiles.
//
// Bound on the H100: operations. The two sweeps over the keys that the
// rounding needs (QK^T for each row's max, then QK^T again and PV) are 6 Nq
// Nk dh flops: at (16, 4096, 5, 64) 515 GFLOP, 0.52 ms at 989 TFLOP/s,
// against 21 MB of q, k, v and out. Beside the products, each score of the
// second sweep takes a subtract, an accurate expf (7 instructions, one on the
// MUFU) and half a bf16 pack: about as many issue slots as the products take
// tensor-core time. The design:
// - two launches of one kernel template: the max pass (sweep 1) writes each
//   row's max to a scratch vector, the main pass (sweep 2) reads it. In one
//   kernel, ptxas serialized every wgmma of both sweeps (its C7514: the max
//   sweep's reads of one score tile while the next one's wgmma ran);
// - a block takes 64 query rows a consumer warpgroup, 2 or 3 consumers
//   (3 where the padding of Nq to 192 rows is at most a sixteenth of it); one
//   thread of a producer warpgroup issues every load with TMA (the 128-byte
//   swizzle): the block's Q once, then K (and in the main pass V) tiles of 128
//   keys through rings of 4 stages, each stage completing on an mbarrier. The
//   producer warpgroup gives its registers up (setmaxnreg) to the consumers;
// - S = Q K^T is wgmma m64n128k16 with Q and K from shared memory; O += P V
//   is m64n72k16 with P from registers as bf16 (the score sums' fragment
//   layout is PV's A layout) and V from shared memory read MN-major (its rows
//   are the keys; dh = 64 is one 128-byte swizzled row). Sums in fp32;
// - PV's B operand has 8 more columns, a constant tile of ones in shared
//   memory (the descriptor's second MN atom): the tensor cores sum each row's
//   rounded e in fp32 as they accumulate E V, as the reference's kernel does
//   with its ones column;
// - the scale is a power of two, so Q is scaled in shared memory first: the
//   scores and their max are then exactly those times the scale, and the
//   subtraction is the only operation before expf;
// - the main pass issues S of tile t + 1 and PV of tile t, then takes the
//   exponentials of S while PV runs, and rounds them into P once PV is done
//   with P of tile t.
// The rounding is attention.cuh's ATTN_PV form, unchanged: e = bf16(expf((s -
// m) * scale)) against each row's final max m, sum = the fp32 sum of the
// rounded e, out = bf16(E V * (1 / sum)).
#include <math.h>

#include "gemm.cuh"

namespace mvdf {
namespace fa90 {

using namespace sm90;

constexpr int DH = 64;             // head dim: one 128-byte swizzled row
constexpr int BQ = 64;             // query rows a consumer warpgroup
constexpr int BN = 128;            // keys a stage
constexpr int KS = 4, VS = 4;      // stages of the K and V rings
constexpr int TILE = BN * DH * 2;  // bytes of a K or V stage, and of the ones
constexpr int NV = DH + 8;         // PV's N: dh, and the ones column's 8

// the block's shape and shared memory for CONSUMERS consumer warpgroups: Q,
// the K and V rings, the ones tile, the barriers
template <int CONSUMERS>
struct Cfg {
  static constexpr int BM = BQ * CONSUMERS;              // query rows a block
  static constexpr int THREADS = 128 * (CONSUMERS + 1);  // and one producer warpgroup
  static constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = CONSUMERS == 2 ? 240 : 160;  // after setmaxnreg
  static constexpr int Q_TILE = BM * DH * 2;
  static constexpr int Q = 0, K = Q_TILE, V = K + KS * TILE, ONE = V + VS * TILE, BAR = ONE + TILE;
  static constexpr int SIZE = BAR + (1 + 2 * KS + 2 * VS) * 8 + 1024;  // + alignment slack
  static_assert(SIZE <= 227 * 1024, "a block's shared memory");
};

// box (DH columns x the map's rows) at column c, row n of batch b into `dst`
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, int c, int n, int b, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4}], "
      "[%5];\n" ::"r"(smem_u32(dst)),
      "l"((uint64_t)map), "r"(c), "r"(n), "r"(b), "r"(smem_u32(bar))
      : "memory");
}

// descriptor of an MN-major B tile in the 128-byte swizzle: rows of 128 bytes
// along K (the keys), each holding 64 N columns (one swizzle atom wide),
// 8-row groups 1024 bytes apart (the stride field; a k16 step adds 16 rows,
// 2048 bytes), the next 64 N columns `atom` bytes on (the leading field)
__device__ __forceinline__ uint64_t sw128_mn_desc(const void* p, uint32_t atom) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)(atom >> 4) << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

// d = A (64x16, K-major, smem) * B (128x16, K-major, smem): gemm.cuh's
// wgmma_n128 with the sums' old values neither read nor kept live
__device__ __forceinline__ void wgmma_n128_first(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31]),
        "=f"(d[32]), "=f"(d[33]), "=f"(d[34]), "=f"(d[35]), "=f"(d[36]), "=f"(d[37]), "=f"(d[38]), "=f"(d[39]),
        "=f"(d[40]), "=f"(d[41]), "=f"(d[42]), "=f"(d[43]), "=f"(d[44]), "=f"(d[45]), "=f"(d[46]), "=f"(d[47]),
        "=f"(d[48]), "=f"(d[49]), "=f"(d[50]), "=f"(d[51]), "=f"(d[52]), "=f"(d[53]), "=f"(d[54]), "=f"(d[55]),
        "=f"(d[56]), "=f"(d[57]), "=f"(d[58]), "=f"(d[59]), "=f"(d[60]), "=f"(d[61]), "=f"(d[62]), "=f"(d[63])
      : "l"(da), "l"(db), "r"(0));
}

// d += A (64x16, bf16 in registers, mma.sync's A fragment layout) * B (16x72,
// MN-major, smem); 36 fp32 sums a thread
__device__ __forceinline__ void wgmma_rs_n72(float (&d)[NV / 2], const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %41, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n72k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35"
      "}, {%36, %37, %38, %39}, %40, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// P's registers, as the compiler sees them, are read here: none is reused
// before the wgmma that reads them is waited for
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// this warpgroup's registers a thread: fewer for the producer, more for the consumers
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// two floats rounded to bf16 in one register, `lo` in the low half
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// Grid (ceil(Nq / BM), B * H): block (x, y) takes query rows x*BM .. +BM-1
// of (batch, head) y (those past Nq read as zeros and are not stored) against
// all Nk keys. q/k/v tensor maps: (H*dh, N, B) bf16 views, boxes of (DH, BM,
// 1) for q, (DH, BN, 1) for k and v. rowmax: (B * H, Nq) fp32, written by the
// max pass (MAX_PASS) and read by the main pass. `scale`, a power of two, is
// applied to Q in shared memory.
template <int CONSUMERS, bool MAX_PASS>
__global__ void __launch_bounds__(Cfg<CONSUMERS>::THREADS, 1)
    attention_sm90_kernel(const __grid_constant__ CUtensorMap tmQ, const __grid_constant__ CUtensorMap tmK,
                          const __grid_constant__ CUtensorMap tmV, bf16* __restrict__ o, float* __restrict__ rowmax,
                          int H, int Nq, int Nk, int64_t o_sb, int64_t o_sn, float scale) {
  using C = Cfg<CONSUMERS>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* qfull = reinterpret_cast<uint64_t*>(smem + C::BAR);
  uint64_t* kfull = qfull + 1;
  uint64_t* kempty = kfull + KS;
  uint64_t* vfull = kempty + KS;
  uint64_t* vempty = vfull + VS;
  const int T = Nk / BN, b = blockIdx.y / H, h = blockIdx.y % H, q0 = blockIdx.x * C::BM, col = h * DH;
  const int wg = threadIdx.x >> 7, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    mbar_init(qfull, 1);
    for (int s = 0; s < KS; ++s) {
      mbar_init(&kfull[s], 1);
      mbar_init(&kempty[s], 4 * CONSUMERS);  // lane 0 of each consumer warp
    }
    for (int s = 0; s < VS; ++s) {
      mbar_init(&vfull[s], 1);
      mbar_init(&vempty[s], 4 * CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == CONSUMERS) {  // the producer warpgroup: one thread issues every load
    setmaxnreg_dec<C::PRODUCER_REGS>();
    if (threadIdx.x == 128 * CONSUMERS) {
      mbar_expect_tx(qfull, C::Q_TILE);
      tma_load_3d(smem + C::Q, &tmQ, col, q0, b, qfull);
      for (int t = 0; t < T; ++t) {
        const int s = t % KS;
        mbar_wait(&kempty[s], ((t / KS) & 1) ^ 1);  // a fresh barrier passes parity 1
        mbar_expect_tx(&kfull[s], TILE);
        tma_load_3d(smem + C::K + s * TILE, &tmK, col, t * BN, b, &kfull[s]);
        if (MAX_PASS) continue;
        const int sv = t % VS;
        mbar_wait(&vempty[sv], ((t / VS) & 1) ^ 1);
        mbar_expect_tx(&vfull[sv], TILE);
        tma_load_3d(smem + C::V + sv * TILE, &tmV, col, t * BN, b, &vfull[sv]);
      }
    }
    return;
  }

  setmaxnreg_inc<C::CONSUMER_REGS>();
  const int tid = threadIdx.x & 127;
  unsigned char* sq = smem + C::Q + wg * (BQ * DH * 2);
  if (!MAX_PASS) {  // the ones tile, 16 bytes a thread a pass
    const uint4 one = make_uint4(0x3F803F80u, 0x3F803F80u, 0x3F803F80u, 0x3F803F80u);
    for (int i = threadIdx.x; i < TILE / 16; i += 128 * CONSUMERS) reinterpret_cast<uint4*>(smem + C::ONE)[i] = one;
  }
  mbar_wait(qfull, 0);
  for (int i = tid; i < BQ * DH / 8; i += 128) {  // q * scale, exact: this warpgroup's 64 rows
    uint4 u = reinterpret_cast<uint4*>(sq)[i];
    __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(p[j]);
      p[j] = __floats2bfloat162_rn(f.x * scale, f.y * scale);
    }
    reinterpret_cast<uint4*>(sq)[i] = u;
  }
  fence_proxy_async_shared();  // the generic writes, seen by wgmma (the async proxy)
  named_barrier(1, 128 * CONSUMERS);

  // this thread's scores of rows r0, r0 + 8: S[4i + {0, 1}] and S[4i + {2, 3}],
  // columns 8i + 2c + {0, 1}
  float S[BN / 2];
  int kt = 0, vt = 0;  // K and V stages consumed
  // S = Q K^T of the K ring's next stage (issued and committed, not waited for)
  auto issue_qk = [&]() {
    const int s = kt % KS;
    mbar_wait(&kfull[s], (kt / KS) & 1);
    const unsigned char* sk = smem + C::K + s * TILE;
    wgmma_fence();
    wgmma_n128_first(S, sw128_desc(sq), sw128_desc(sk));
#pragma unroll
    for (int kk = 1; kk < DH / 16; ++kk) wgmma_n128(S, sw128_desc(sq + kk * 32), sw128_desc(sk + kk * 32), 1);
    wgmma_commit();
  };
  auto release_k = [&]() {
    wgmma_fence_operand(S);
    if (lane == 0) mbar_arrive(&kempty[kt % KS]);
    ++kt;
  };
  const int r0 = q0 + wg * BQ + (tid >> 5) * 16 + (lane >> 2);
  float* rm = rowmax + (int64_t)blockIdx.y * Nq;

  if constexpr (MAX_PASS) {  // each row's max of the scores
    float m0 = -INFINITY, m1 = -INFINITY;
    for (int t = 0; t < T; ++t) {
      issue_qk();
      wgmma_wait<0>();
      release_k();
#pragma unroll
      for (int i = 0; i < BN / 8; ++i) {
        m0 = fmaxf(m0, fmaxf(S[4 * i], S[4 * i + 1]));
        m1 = fmaxf(m1, fmaxf(S[4 * i + 2], S[4 * i + 3]));
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {  // the quad holds a row
      m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, off));
      m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, off));
    }
    if ((lane & 3) == 0) {
      if (r0 < Nq) rm[r0] = m0;
      if (r0 + 8 < Nq) rm[r0 + 8] = m1;
    }
    return;
  }

  const float m0 = r0 < Nq ? rm[r0] : 0.0f, m1 = r0 + 8 < Nq ? rm[r0 + 8] : 0.0f;  // rows past Nq score 0
  float O[NV / 2];
#pragma unroll
  for (int i = 0; i < NV / 2; ++i) O[i] = 0.0f;
  // e = expf((s - m) * scale) in place in S, the scale already in s and m
  // (forced before the wait that follows, so that it runs under PV)
  auto exps = [&]() {
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      const float m = i & 2 ? m1 : m0;
      S[i] = expf(S[i] - m);
    }
    wgmma_fence_operand(S);
  };
  // e rounded to bf16 as PV's A fragments: the sum tile's columns 16kk ..
  // 16kk+15 are A tile kk, P[4kk .. 4kk+3], so P[j] packs S[2j], S[2j+1]
  uint32_t P[BN / 4];
  auto pack = [&]() {
#pragma unroll
    for (int j = 0; j < BN / 4; ++j) P[j] = pack2(S[2 * j], S[2 * j + 1]);
  };
  // O += P V of the V ring's next stage (issued and committed, not waited for)
  auto issue_pv = [&]() {
    const int s = vt % VS;
    mbar_wait(&vfull[s], (vt / VS) & 1);
    const unsigned char* sv = smem + C::V + s * TILE;
    const uint32_t ones = C::ONE - (C::V + s * TILE);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) wgmma_rs_n72(O, P + 4 * kk, sw128_mn_desc(sv + kk * 2048, ones));
    wgmma_commit();
  };
  auto release_v = [&]() {
    fence_regs(P);
    if (lane == 0) mbar_arrive(&vempty[vt % VS]);
    ++vt;
  };

  issue_qk();  // S of tile 0
  wgmma_wait<0>();
  release_k();
  exps();
  pack();
  // tile t: S of tile t + 1 and PV of tile t issued; the exponentials of S
  // while PV runs, then P of tile t + 1 once PV is done with P of tile t
  for (int t = 0; t < T - 1; ++t) {
    issue_qk();
    issue_pv();
    wgmma_wait<1>();
    release_k();
    exps();
    wgmma_wait<0>();
    release_v();
    pack();
  }
  issue_pv();
  wgmma_wait<0>();
  release_v();
  wgmma_fence_operand(O);

  // every column of the ones tile holds the row's fp32 sum of the rounded e
  const float i0 = 1.0f / O[DH / 2], i1 = 1.0f / O[DH / 2 + 2];
  const int c = 2 * (lane & 3);
  bf16* o0 = o + b * o_sb + r0 * o_sn + h * DH + c;
  bf16* o1 = o0 + 8 * o_sn;
#pragma unroll
  for (int i = 0; i < DH / 8; ++i) {
    if (r0 < Nq) *reinterpret_cast<uint32_t*>(o0 + 8 * i) = pack2(O[4 * i] * i0, O[4 * i + 1] * i0);
    if (r0 + 8 < Nq) *reinterpret_cast<uint32_t*>(o1 + 8 * i) = pack2(O[4 * i + 2] * i1, O[4 * i + 3] * i1);
  }
}

// a (B, N, H*DH) bf16 view (row stride sn, batch stride sb elements) read in
// boxes of DH columns x `rows` rows of one batch, 128-byte swizzle, zeros
// past row N
static int encode_rows(CUtensorMap* map, const void* base, int B, int N, int C, int64_t sb, int64_t sn, int rows) {
  EncodeTiled fn = encode_fn();
  if (!fn) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)C, (cuuint64_t)N, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)sn * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[3] = {(cuuint32_t)DH, (cuuint32_t)rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// the max pass, then the main pass, on one stream
template <int CONSUMERS>
static int launch(const void* q, const CUtensorMap& tk, const CUtensorMap& tv, bf16* o, float* rowmax, int B, int H,
                  int Nq, int Nk, int64_t q_sb, int64_t q_sn, int64_t o_sb, int64_t o_sn, float scale,
                  cudaStream_t stream) {
  using C = Cfg<CONSUMERS>;
  static bool ready = false;
  if (!ready) {
    for (auto fn : {attention_sm90_kernel<CONSUMERS, true>, attention_sm90_kernel<CONSUMERS, false>}) {
      const cudaError_t rc = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SIZE);
      if (rc != cudaSuccess) return (int)rc;
    }
    ready = true;
  }
  CUtensorMap tq;
  const int rc = encode_rows(&tq, q, B, Nq, H * DH, q_sb, q_sn, C::BM);
  if (rc) return rc;
  const dim3 grid((Nq + C::BM - 1) / C::BM, B * H);
  attention_sm90_kernel<CONSUMERS, true>
      <<<grid, C::THREADS, C::SIZE, stream>>>(tq, tk, tv, o, rowmax, H, Nq, Nk, o_sb, o_sn, scale);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  attention_sm90_kernel<CONSUMERS, false>
      <<<grid, C::THREADS, C::SIZE, stream>>>(tq, tk, tv, o, rowmax, H, Nq, Nk, o_sb, o_sn, scale);
  return (int)cudaGetLastError();
}

}  // namespace fa90
}  // namespace mvdf

// out = attention(q, k, v) in bf16, the pv form, dh = 64: q/k/v element (b,
// n, h, d) at b*sb + n*sn + h*64 + d (rows and batches 16-byte aligned, base
// pointers too); out likewise (4-byte aligned). Nk % 128 == 0, Nk >= 256,
// scale a power of two (ops/attention.py::attention_route). rowmax: B * H * Nq
// floats of scratch.
MVDF_API int mvdf_attention_sm90(const void* q, const void* k, const void* v, void* o, void* rowmax, int B, int H,
                                 int Nq, int Nk, int64_t q_sb, int64_t q_sn, int64_t k_sb, int64_t k_sn, int64_t v_sb,
                                 int64_t v_sn, int64_t o_sb, int64_t o_sn, float scale, void* stream) {
  namespace f = mvdf::fa90;
  const int64_t strides[6] = {q_sb, q_sn, k_sb, k_sn, v_sb, v_sn};
  for (int64_t s : strides)
    if (s <= 0 || s % 8) return (int)cudaErrorInvalidValue;
  int e = 0;
  const bool pow2 = scale > 0.0f && frexpf(scale, &e) == 0.5f;  // q * scale exact in bf16
  if (B < 1 || H < 1 || Nq < 1 || Nk < 2 * f::BN || Nk % f::BN || (uintptr_t)q % 16 || (uintptr_t)k % 16 ||
      (uintptr_t)v % 16 || (uintptr_t)o % 4 || o_sb % 2 || o_sn % 2 || !pow2)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tk, tv;
  int rc = f::encode_rows(&tk, k, B, Nk, H * f::DH, k_sb, k_sn, f::BN);
  if (!rc) rc = f::encode_rows(&tv, v, B, Nk, H * f::DH, v_sb, v_sn, f::BN);
  if (rc) return rc;
  // three consumers where their padding of Nq is at most a sixteenth of it
  constexpr int BM3 = f::Cfg<3>::BM;
  const int pad3 = (Nq + BM3 - 1) / BM3 * BM3 - Nq;
  mvdf::bf16* out = (mvdf::bf16*)o;
  float* m = (float*)rowmax;
  cudaStream_t s = (cudaStream_t)stream;
  return 16 * pad3 <= Nq ? f::launch<3>(q, tk, tv, out, m, B, H, Nq, Nk, q_sb, q_sn, o_sb, o_sn, scale, s)
                         : f::launch<2>(q, tk, tv, out, m, B, H, Nq, Nk, q_sb, q_sn, o_sb, o_sn, scale, s);
}
