// K2's attention tiles as device functions: shared by K2's kernel
// (attention.cu) and the one-kernel transformer site (blockforms.cu).
// Design notes are in attention.cu. No pointer is __restrict__: the
// one-kernel site reads q/k/v that an earlier phase of its launch wrote.
#pragma once

#include "common.cuh"

namespace mvdf {

// the tensor-core tile's rounding forms (ops/attention.py)
enum { ATTN_PROBS = 0, ATTN_PV = 1 };

namespace attn {
constexpr int QB = 64;  // queries a tile of 128 threads (4 warps, 16 queries each)
constexpr int KB = 64;  // keys a stage
// bf16 operands, dh <= DP (DP = dh rounded up to 16): a staged K or V row
// holds DP + 8 elements, an odd number of 16-byte units, so ldmatrix's eight
// row addresses fall in eight distinct bank groups
template <int DP>
struct Tile {
  static constexpr int LD = DP + 8;
  static constexpr int STAGE = 2 * KB * LD * 2;  // K and V of one stage, bytes
  static constexpr int SMEM = 2 * STAGE;         // the two-stage ring
};
}  // namespace attn

// The tensor-core tile: queries qblk*64 .. +63 of (batch, head) `bh` (4
// warps of 128 threads, 16 queries each) against all Nk keys, bf16
// operands, dh % 8 == 0, dh <= DP; `smem` holds
// attn::Tile<DP>::SMEM bytes, 16-byte aligned. K/V rows are 16-byte aligned
// (the wrapper checks). Two sweeps over the keys, so that P is rounded to
// bf16 against the row's final max, as the reference rounds it: sweep 1
// takes each row's max (and, in ATTN_PROBS, the fp32 sum of exp((s - max) *
// scale), rescaled as the max grows; a normaliser only, so exp2 with the
// scale folded in); sweep 2 recomputes S, rounds P and accumulates PV in fp32.
//   ATTN_PROBS: p = bf16(expf((s - m) * scale) / sum), out = bf16(P V)
//   ATTN_PV:    e = bf16(expf((s - m) * scale)), sum = fp32 sum of the e,
//               out = bf16(E V * (1 / sum))
// The quotient e / sum is the IEEE one: a reciprocal of the sum once a row,
// then q = e * r refined by one fma residual step, which rounds correctly.
template <int DP>
__device__ __forceinline__ void attn_tile_mma(const bf16* q, const bf16* k, const bf16* v, bf16* o, int H, int Nq,
                                              int Nk, int dh, int64_t q_sb, int64_t q_sn, int64_t k_sb, int64_t k_sn,
                                              int64_t v_sb, int64_t v_sn, int64_t o_sb, int64_t o_sn, float scale,
                                              int mode, int qblk, int bh, unsigned char* smem) {
  using Cfg = attn::Tile<DP>;
  constexpr int LD = Cfg::LD, KS = DP / 16, NT = DP / 8, KB = attn::KB;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, r = lane >> 2, c = lane & 3;
  const int b = bh / H, h = bh % H;
  const bf16* kb = k + b * k_sb + h * dh;
  const bf16* vb = v + b * v_sb + h * dh;
  const int T = (Nk + KB - 1) / KB;

  __syncthreads();  // the caller's last use of smem is over
  // the pad columns dh .. DP-1 (8 of them, or none) of every staged row are
  // zero: copies write columns < dh only
  if (dh < DP)
    for (int i = tid; i < 4 * KB; i += blockDim.x)
      *reinterpret_cast<uint4*>(reinterpret_cast<bf16*>(smem) + i * LD + dh) = make_uint4(0, 0, 0, 0);

  // Q's A fragments, read once from device memory (rows past Nq are zero)
  const int qr0 = qblk * attn::QB + warp * 16 + r, qr1 = qr0 + 8;
  const bf16* qb = q + b * q_sb + h * dh;
  auto qword = [&](int row, int col) -> unsigned {
    return (row < Nq && col < dh) ? *reinterpret_cast<const unsigned*>(qb + row * q_sn + col) : 0u;
  };
  unsigned qa[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const int col = ks * 16 + 2 * c;
    qa[ks][0] = qword(qr0, col);
    qa[ks][1] = qword(qr1, col);
    qa[ks][2] = qword(qr0, col + 8);
    qa[ks][3] = qword(qr1, col + 8);
  }

  // step s < T stages key tile s (K only); step T + t stages tile t (K and V)
  auto stage = [&](int step, int buf) {
    const bool with_v = step >= T;
    const int k0 = (with_v ? step - T : step) * KB;
    bf16* Ks = reinterpret_cast<bf16*>(smem + buf * Cfg::STAGE);
    bf16* Vs = Ks + KB * LD;
    const int cpr = dh >> 3;  // 16-byte units a row
    for (int i = tid; i < KB * cpr; i += blockDim.x) {
      const int j = i / cpr, col = (i - j * cpr) * 8;
      const bool ok = k0 + j < Nk;
      const int64_t key = ok ? k0 + j : 0;
      cp_async16(Ks + j * LD + col, kb + key * k_sn + col, ok);
      if (with_v) cp_async16(Vs + j * LD + col, vb + key * v_sn + col, ok);
    }
  };

  const float scale_log2 = scale * 1.4426950408889634f;
  float m0 = -INFINITY, m1 = -INFINITY;  // rows r and r + 8 of the warp's 16
  float l0 = 0.0f, l1 = 0.0f;            // ATTN_PROBS: sums of exp; ATTN_PV: sums of the rounded e
  float r0 = 0.0f, r1 = 0.0f;            // ATTN_PROBS: 1 / sum
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;

  stage(0, 0);
  cp_async_commit();
  for (int step = 0; step < 2 * T; ++step) {
    const int buf = step & 1;
    if (step + 1 < 2 * T) stage(step + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bool second = step >= T;
    const int k0 = (second ? step - T : step) * KB;
    const bf16* Ks = reinterpret_cast<const bf16*>(smem + buf * Cfg::STAGE);
    const bf16* Vs = Ks + KB * LD;

    // S (16 x 64 a warp) = Q K^T, fp32
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        unsigned bk[4];
        ldsm_x4(bk, Ks + (np * 16 + (lane & 7) + (lane >> 4) * 8) * LD + ks * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * np], qa[ks], bk[0], bk[1]);
        mma_bf16(s[2 * np + 1], qa[ks], bk[2], bk[3]);
      }
    const int nvalid = Nk - k0;  // keys of this tile: columns j < nvalid
    if (nvalid < KB)  // the ragged last tile: exp of a masked score is 0
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (n * 8 + 2 * c + e >= nvalid) s[n][e] = s[n][2 + e] = -INFINITY;

    if (!second) {
      float x0 = -INFINITY, x1 = -INFINITY;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        x0 = fmaxf(x0, fmaxf(s[n][0], s[n][1]));
        x1 = fmaxf(x1, fmaxf(s[n][2], s[n][3]));
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        x0 = fmaxf(x0, __shfl_xor_sync(0xffffffffu, x0, off));
        x1 = fmaxf(x1, __shfl_xor_sync(0xffffffffu, x1, off));
      }
      const float n0 = fmaxf(m0, x0), n1 = fmaxf(m1, x1);  // finite: every tile holds a key
      if (mode == ATTN_PROBS) {
        const float o0 = n0 * scale_log2, o1 = n1 * scale_log2;
        float a0 = 0.0f, a1 = 0.0f;
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            a0 += exp2f(fmaf(s[n][e], scale_log2, -o0));
            a1 += exp2f(fmaf(s[n][2 + e], scale_log2, -o1));
          }
        l0 = l0 * exp2f((m0 - n0) * scale_log2) + a0;
        l1 = l1 * exp2f((m1 - n1) * scale_log2) + a1;
      }
      m0 = n0;
      m1 = n1;
      if (step == T - 1 && mode == ATTN_PROBS) {
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
          l0 += __shfl_xor_sync(0xffffffffu, l0, off);
          l1 += __shfl_xor_sync(0xffffffffu, l1, off);
        }
        r0 = 1.0f / l0;
        r1 = 1.0f / l1;
      }
    } else {
      // P, rounded to bf16, as the A fragments of PV (two 8-key sum tiles
      // make one 16-key A tile)
      unsigned pa[4][4];
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        bf16 p[4];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float e0 = expf((s[n][e] - m0) * scale);
          float e1 = expf((s[n][2 + e] - m1) * scale);
          if (mode == ATTN_PROBS) {
            const float q0 = e0 * r0, q1 = e1 * r1;
            e0 = fmaf(fmaf(-q0, l0, e0), r0, q0);
            e1 = fmaf(fmaf(-q1, l1, e1), r1, q1);
          }
          p[e] = __float2bfloat16(e0);
          p[2 + e] = __float2bfloat16(e1);
          if (mode == ATTN_PV) {
            l0 += __bfloat162float(p[e]);
            l1 += __bfloat162float(p[2 + e]);
          }
        }
        pa[n >> 1][(n & 1) * 2] = pack_bf16(p[0], p[1]);
        pa[n >> 1][(n & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
      }
      // O += P V: V's (key, d) rows transposed into B fragments
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int dp = 0; dp < NT / 2; ++dp) {
          unsigned bv[4];
          ldsm_x4_t(bv, Vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + dp * 16 + (lane >> 4) * 8);
          mma_bf16(acc[2 * dp], pa[kk], bv[0], bv[1]);
          mma_bf16(acc[2 * dp + 1], pa[kk], bv[2], bv[3]);
        }
    }
    __syncthreads();  // every warp is done with this stage before step + 2 refills it
  }

  float i0 = 1.0f, i1 = 1.0f;
  if (mode == ATTN_PV) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    i0 = 1.0f / l0;
    i1 = 1.0f / l1;
  }
  bf16* ob = o + b * o_sb + h * dh;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int col = n * 8 + 2 * c;
    if (col < dh) {
      if (qr0 < Nq) *reinterpret_cast<unsigned*>(ob + qr0 * o_sn + col) = pack_bf16(acc[n][0] * i0, acc[n][1] * i0);
      if (qr1 < Nq) *reinterpret_cast<unsigned*>(ob + qr1 * o_sn + col) = pack_bf16(acc[n][2] * i1, acc[n][3] * i1);
    }
  }
}

// The CUDA-core loop, kept for fp32 operands (full fp32 products) and for
// heads past 128 (up to the VAE's dh = 512): the BQ = blockDim.x / TPQ
// queries of q-block `qblk` of (batch, head) `bh`, against all Nk keys
// staged BK at a time in `smem` (2 BK dh T), with an fp32 online softmax
// whose probabilities stay in fp32.
template <typename T, int TPQ, int DPT>
__device__ __forceinline__ void attn_tile(const T* q, const T* k, const T* v, T* o, int H, int Nq, int Nk, int dh,
                                          int64_t q_sb, int64_t q_sn, int64_t k_sb, int64_t k_sn, int64_t v_sb,
                                          int64_t v_sn, int64_t o_sb, int64_t o_sn, float scale_log2, int BK,
                                          int qblk, int bh, unsigned char* smem) {
  T* Ks = reinterpret_cast<T*>(smem);
  T* Vs = Ks + BK * dh;
  const int BQ = blockDim.x / TPQ;
  const int b = bh / H, h = bh % H;
  const int qi = qblk * BQ + threadIdx.x / TPQ;
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
  __syncthreads();  // the stages are read before the caller's next tile overwrites them
}

}  // namespace mvdf
