// The PointNet stack's first two layers as the bf16 forward
// (pointnet_sm90.cu) and the bf16 backward (pointnet_bwd_sm90.cu) both run
// them: one copy of the arithmetic, so the backward's recompute of h1, a2
// and h2 has the forward's bits.
//
// Per 64-point tile and warpgroup: layer 1 (K = 3) on the CUDA cores
// straight into layer 2's register-A fragments; layer 2 as wgmma
// m64n128k16 against a resident W2ᵀ (K-major, 128-byte swizzle) whose
// bias b2 rides as one more k-step (a column of ones against the bias).
#pragma once

#include "hopper.cuh"

namespace sga {
namespace sm90 {

constexpr int kPnC1 = 64;
constexpr int kPnC2 = 128;
// W2ᵀ as [128 n][64 k], then b2 as the bias k-step's [128 n][64 k]
constexpr size_t kPnW2Bytes = 2 * kPnC2 * 64 * 2;

// relu that keeps a NaN, on the bits: a non-negative float's bits order as
// a non-negative int, a negative one's (-0.0 too) as a negative int, and the
// card's arithmetic gives the canonical NaN 0x7FFFFFFF, above every number.
// So max(bits, 0) is relu(a) with a NaN kept, and, read as unsigned, the max
// key of relu(a), the one NaN the largest (no fmaxf: it drops a NaN)
__device__ __forceinline__ uint32_t relu_bits(float a) {
  return (uint32_t)max(__float_as_int(a), 0);
}

__device__ __forceinline__ uint32_t pack_relu(float lo, float hi) {
  return pack_bf16(__uint_as_float(relu_bits(lo)), __uint_as_float(relu_bits(hi)));
}

// W2ᵀ and b2's bias step at `dst` (1024-byte aligned, kPnW2Bytes), and w1,
// b1 as f32 [3][64] then [64] at w1s. Called by every thread of the block;
// fence_proxy_async and a barrier follow before a wgmma reads them.
__device__ __forceinline__ void stage_layers12(unsigned char* dst, float* w1s,
                                               const __nv_bfloat16* __restrict__ w1,
                                               const __nv_bfloat16* __restrict__ b1,
                                               const __nv_bfloat16* __restrict__ w2,
                                               const __nv_bfloat16* __restrict__ b2) {
  stage_transposed<kPnC1, kPnC2>(reinterpret_cast<__nv_bfloat16*>(dst), w2);
  stage_bias(reinterpret_cast<__nv_bfloat16*>(dst + kPnW2Bytes / 2), b2, kPnC2);
  for (int i = threadIdx.x; i < 4 * kPnC1; i += blockDim.x)
    w1s[i] = __bfloat162float(i < 3 * kPnC1 ? w1[i] : b1[i - 3 * kPnC1]);
}

// Layer 1 for this thread's two rows of a tile (rl and rl + 8 of its warp:
// x in xr, v[h] whether the row is a point; rows that are not get zeros)
// into layer 2's A fragments: a[kk][2·half + h] holds h1 = round(relu(a1))
// of row rl + 8h, columns 16kk + 8·half + 2q and + 1; a[4] is the bias
// k-step's fragment. With MASK, bit 4·(2kk + half) + 2h + e of *m1 is
// a1 > 0 there (column + e): the index of the same element in an
// m64nNk16 accumulator.
template <bool MASK>
__device__ __forceinline__ void layer1_fragments(const float* w1s, const float (&xr)[2][3],
                                                 const bool (&v)[2], int q, uint32_t (&a)[5][4],
                                                 uint32_t* m1) {
  if constexpr (MASK) *m1 = 0u;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int col = 16 * kk + 8 * half + 2 * q;
      const float2 wa = *reinterpret_cast<const float2*>(w1s + col);
      const float2 wb = *reinterpret_cast<const float2*>(w1s + kPnC1 + col);
      const float2 wc = *reinterpret_cast<const float2*>(w1s + 2 * kPnC1 + col);
      const float2 bb = *reinterpret_cast<const float2*>(w1s + 3 * kPnC1 + col);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float* xv = xr[h];
        float e0 = xv[0] * wa.x, e1 = xv[0] * wa.y;
        e0 = fmaf(xv[1], wb.x, e0);
        e1 = fmaf(xv[1], wb.y, e1);
        e0 = fmaf(xv[2], wc.x, e0);
        e1 = fmaf(xv[2], wc.y, e1);
        a[kk][2 * half + h] = v[h] ? pack_relu(e0 + bb.x, e1 + bb.y) : 0u;
        if constexpr (MASK) {
          const int i = 4 * (2 * kk + half) + 2 * h;
          if (v[h]) *m1 |= (e0 + bb.x > 0.f ? 1u : 0u) << i | (e1 + bb.y > 0.f ? 2u : 0u) << i;
        }
      }
    }
  const uint32_t one = q == 0 ? pack_bf16(1.f, 0.f) : 0u;  // the bias column k = 0
  a[4][0] = v[0] ? one : 0u;
  a[4][1] = v[1] ? one : 0u;
  a[4][2] = a[4][3] = 0u;
}

// a2 = h1·W2 + b2 [64, 128] (f32) from layer1_fragments' a, against the
// staged W2ᵀ and bias step at w2s
__device__ __forceinline__ void layer2(float (&acc)[64], const uint32_t (&a)[5][4],
                                       const unsigned char* w2s) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 5; ++kk)
    wgmma_m64n128k16_rs(acc, a[kk], desc(w2s + (kk / 4) * (kPnC2 * 128), kSw128, (kk % 4) * 32),
                        kk != 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
}

}  // namespace sm90
}  // namespace sga
