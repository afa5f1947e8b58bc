// The PointNet stack's first two layers at float32, as the f32 forward and
// the f32 backward (both in pointnet.cu) run them: one copy of the
// arithmetic, so the backward's recompute of h1, a2 and h2 on its routed
// rows has the forward's bits (JAX's forward and backward share
// _stack_from_cf the same way).
//
// A tile is 64 points whose x sits in shared memory as xs [3][64] (rows that
// are not points hold zeros; callers ignore their results). Every product is
// a register-tiled FMA loop over operands in shared memory, fed by 16-byte
// loads, in full f32 (no TF32): each output is one fmaf chain over k from 0,
// then its bias, in a fixed order. relu keeps a NaN (torch.relu,
// jnp.maximum), so a > 0 is h > 0 for every a: the backward reads its relu
// masks off h1 and h2.
#pragma once

#include <cuda_runtime.h>

namespace sga {
namespace pnf32 {

constexpr int kC1 = 64, kC2 = 128;
constexpr int kTile = 64;          // points a tile
constexpr int kThreads = 256;      // a block; every helper is called by all of them
constexpr int kLdT = kTile + 4;    // row stride of a transposed tile [channel][point]
constexpr int kLdW2 = kC2 + 4;     // row stride of the staged W2 [64][128]

__device__ __forceinline__ float relu_nan(float a) { return (a > 0.f || a != a) ? a : 0.f; }

// Shared-memory regions, 128-byte aligned: reserve n bytes at offset o
__host__ __device__ inline size_t take(size_t& o, size_t n) {
  const size_t at = o;
  o = (o + n + 127) & ~size_t(127);
  return at;
}

// W2 [64][128] into w2s (row stride kLdW2), and w1 [3][64], b1 [64], b2 [128]
// as one f32 vector at vec: w1, then b1 at 192, then b2 at 256. Synchronise
// before use.
__device__ __forceinline__ void stage_layers12(float* w2s, float* vec, const float* __restrict__ w1,
                                               const float* __restrict__ b1,
                                               const float* __restrict__ w2,
                                               const float* __restrict__ b2) {
  for (int i = threadIdx.x; i < kC1 * kC2 / 4; i += blockDim.x) {
    const int k = i / (kC2 / 4), c4 = i % (kC2 / 4);
    *reinterpret_cast<float4*>(w2s + k * kLdW2 + 4 * c4) =
        *reinterpret_cast<const float4*>(w2 + k * kC2 + 4 * c4);
  }
  for (int i = threadIdx.x; i < 3 * kC1 + kC1 + kC2; i += blockDim.x)
    vec[i] = i < 3 * kC1 ? w1[i] : i < 4 * kC1 ? b1[i - 3 * kC1] : b2[i - 4 * kC1];
}

// Layer 1 (K = 3) on the CUDA cores: h1T [64 channels][kLdT] = relu(a1) of
// the tile's 64 rows; with ROWS also h1 [64 rows][kLdT] (the backward's
// weight-gradient operand). Thread t: rows 4(t % 16).., channels 4(t / 16)..
template <bool ROWS>
__device__ __forceinline__ void layer1(const float* xs, const float* vec, float* h1T, float* h1) {
  const int t = threadIdx.x, rg = t % 16, cg = t / 16;
  const float4 x0 = *reinterpret_cast<const float4*>(xs + 4 * rg);
  const float4 x1 = *reinterpret_cast<const float4*>(xs + kTile + 4 * rg);
  const float4 x2 = *reinterpret_cast<const float4*>(xs + 2 * kTile + 4 * rg);
  const float xa[4] = {x0.x, x0.y, x0.z, x0.w}, xb[4] = {x1.x, x1.y, x1.z, x1.w},
              xc[4] = {x2.x, x2.y, x2.z, x2.w};
  float h[4][4];  // [channel][row]
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = 4 * cg + j;
    const float wa = vec[c], wb = vec[kC1 + c], wc = vec[2 * kC1 + c], b = vec[3 * kC1 + c];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float a = xa[i] * wa;
      a = fmaf(xb[i], wb, a);
      a = fmaf(xc[i], wc, a);
      h[j][i] = relu_nan(a + b);
    }
    *reinterpret_cast<float4*>(h1T + c * kLdT + 4 * rg) = make_float4(h[j][0], h[j][1], h[j][2],
                                                                      h[j][3]);
  }
  if constexpr (ROWS) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<float4*>(h1 + (4 * rg + i) * kLdT + 4 * cg) =
          make_float4(h[0][i], h[1][i], h[2][i], h[3][i]);
  }
}

// Layer 2: h2T [128 channels][kLdT] = relu(h1·W2 + b2) from h1T and the staged
// W2. Thread t: rows 4(t % 16).., channels 8(t / 16)..; per k one 16-byte
// load of h1T and two of W2 feed 32 FMAs.
__device__ __forceinline__ void layer2(const float* h1T, const float* w2s, const float* vec,
                                       float* h2T) {
  const int t = threadIdx.x, rg = t % 16, cg = t / 16;
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int k = 0; k < kC1; ++k) {
    const float4 a = *reinterpret_cast<const float4*>(h1T + k * kLdT + 4 * rg);
    const float4 b0 = *reinterpret_cast<const float4*>(w2s + k * kLdW2 + 8 * cg);
    const float4 b1 = *reinterpret_cast<const float4*>(w2s + k * kLdW2 + 8 * cg + 4);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
  const float* b2 = vec + 4 * kC1;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = 8 * cg + j;
    const float b = b2[c];
    *reinterpret_cast<float4*>(h2T + c * kLdT + 4 * rg) =
        make_float4(relu_nan(acc[0][j] + b), relu_nan(acc[1][j] + b), relu_nan(acc[2][j] + b),
                    relu_nan(acc[3][j] + b));
  }
}

}  // namespace pnf32
}  // namespace sga
