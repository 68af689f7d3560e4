// K4's attention across the V views of one point, for one head, from fp32
// rows [q | k | v] (DH columns each) held in shared memory. Shared by
// crossview.cu's standalone attention kernel and gemm_sm90.cu's qkv tile,
// which stages the qkv GEMM's sums there and never writes them to device
// memory.
//
// Two neighbouring lanes hold one query row, each half of the head's DH
// dimensions; a logit is their two partial dots summed through one shuffle.
// Like the reference's per-head attention (mvdfusion_tpu/ops/crossview.py:
// 278-375) everything is fp32: the logits q . k (q scaled by the caller),
// the softmax over the V keys (max, exp, sum, then the reciprocal of the
// sum times each exp), and P . v; the caller rounds the output once.
#pragma once

#include "common.cuh"

namespace mvdf {

constexpr int CV_MAX_VIEWS = 16;

// o = this lane's half of the attention output of query row `vq` of a point
// whose V <= KMAX rows start at `pt` (`lds` floats apart). q is multiplied
// by `scale` as it is read. The loops run over KMAX keys without a branch,
// the keys past V reading row V - 1 and masked out of the softmax (their
// exp is 0, so they add exact zeros), so the key loop's loads, products
// and shuffles overlap. V is uniform across the warp; every lane of the
// warp calls this (a lane without a row passes vq = 0 and drops o).
template <int DH, int KMAX>
__device__ __forceinline__ void view_attention_half(const float* pt, int lds, int vq, int half, int V, float scale,
                                                    float (&o)[DH / 2]) {
  constexpr int H2 = DH / 2;
  float q[H2];
  const float* qr = pt + vq * lds + half * H2;
#pragma unroll
  for (int j = 0; j < H2; j += 4) {
    const float4 a = *reinterpret_cast<const float4*>(qr + j);
    q[j] = a.x * scale;
    q[j + 1] = a.y * scale;
    q[j + 2] = a.z * scale;
    q[j + 3] = a.w * scale;
  }
  float s[KMAX];
#pragma unroll
  for (int w = 0; w < KMAX; ++w) {
    const float* kr = pt + (w < V ? w : V - 1) * lds + DH + half * H2;
    float a = 0.0f;
#pragma unroll
    for (int j = 0; j < H2; j += 4) {
      const float4 k = *reinterpret_cast<const float4*>(kr + j);
      a += q[j] * k.x + q[j + 1] * k.y + q[j + 2] * k.z + q[j + 3] * k.w;
    }
    s[w] = a;
  }
  float mx = -INFINITY;
#pragma unroll
  for (int w = 0; w < KMAX; ++w) {
    s[w] += __shfl_xor_sync(0xffffffffu, s[w], 1);
    if (w >= V) s[w] = -INFINITY;
    mx = fmaxf(mx, s[w]);
  }
  float den = 0.0f;
#pragma unroll
  for (int w = 0; w < KMAX; ++w) {
    s[w] = expf(s[w] - mx);
    den += s[w];
  }
  const float inv = 1.0f / den;
#pragma unroll
  for (int j = 0; j < H2; ++j) o[j] = 0.0f;
#pragma unroll
  for (int w = 0; w < KMAX; ++w) {
    const float p = s[w] * inv;
    const float* vr = pt + (w < V ? w : V - 1) * lds + 2 * DH + half * H2;
#pragma unroll
    for (int j = 0; j < H2; j += 4) {
      const float4 v = *reinterpret_cast<const float4*>(vr + j);
      o[j] += p * v.x;
      o[j + 1] += p * v.y;
      o[j + 2] += p * v.z;
      o[j + 3] += p * v.w;
    }
  }
}

// n (a multiple of 4) floats from registers to `dst` in T: 16-byte stores
// (8-byte ones for a bf16 row of 4)
template <int n>
__device__ __forceinline__ void store_row(float* dst, const float (&v)[n]) {
#pragma unroll
  for (int j = 0; j < n; j += 4)
    *reinterpret_cast<float4*>(dst + j) = make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]);
}
template <int n>
__device__ __forceinline__ void store_row(bf16* dst, const float (&v)[n]) {
  if constexpr (n % 8 == 0) {
#pragma unroll
    for (int j = 0; j < n; j += 8)
      *reinterpret_cast<uint4*>(dst + j) = make_uint4(pack_bf16(v[j], v[j + 1]), pack_bf16(v[j + 2], v[j + 3]),
                                                      pack_bf16(v[j + 4], v[j + 5]), pack_bf16(v[j + 6], v[j + 7]));
  } else {
#pragma unroll
    for (int j = 0; j < n; j += 4)
      *reinterpret_cast<uint2*>(dst + j) = make_uint2(pack_bf16(v[j], v[j + 1]), pack_bf16(v[j + 2], v[j + 3]));
  }
}

}  // namespace mvdf
