// K2's attention loop as a device function: shared by K2's kernel
// (attention.cu) and the one-kernel transformer site (blockforms.cu).
// Design notes are in attention.cu. No pointer is __restrict__: the
// one-kernel site reads q/k/v that an earlier phase of its launch wrote.
#pragma once

#include "common.cuh"

namespace mvdf {

// One tile: the BQ = blockDim.x / TPQ queries of q-block `qblk` of (batch,
// head) `bh`, against all Nk keys staged BK at a time in `smem` (2 BK dh T).
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
