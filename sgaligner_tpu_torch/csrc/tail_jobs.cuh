// The f32 PCT tail's jobs on tail_f32.cuh's mainloop (pct_tail.cu's
// header comment says what each computes), in a header so that
// scripts/tail_gemm_bench.cu times the same jobs.
#pragma once

#include "tail_f32.cuh"

#include <climits>

namespace sga {
namespace {

using namespace tail_f32;

constexpr int kC = 128;                 // width of each SA output
constexpr int kZSteps = 4 * kC / kBK;   // k-steps of z's 512-deep product

__device__ __forceinline__ const float* input(const float* x1, const float* x2,
                                              const float* x3, const float* x4, int i) {
  return i == 0 ? x1 : i == 1 ? x2 : i == 2 ? x3 : x4;
}

// The operands of z's product shared by the forward and the g pass: the
// 128-row tile at row r0 of object obj (rows >= valid zero-filled), column
// slice n0 of W
struct ZOperands {
  const float *x1, *x2, *x3, *x4, *w;
  int p, k, n0;

  // k-step ks: channels 16·ks .. of the concatenated input (x1's 128, then
  // x2's, ...), transposed, and the same 16 rows of W's slice
  __device__ __forceinline__ void stage(float* st, int obj, int r0, int valid, int ks) const {
    const int k0 = ks * kBK;
    stage_rows_t(st, input(x1, x2, x3, x4, k0 / kC) + ((size_t)obj * p + r0) * kC + k0 % kC, kC,
                 valid);
    stage_rows(st + kOperand, w + (size_t)k0 * k + n0, k, kBK);
  }
};

// The forward's job: the block's objects, each object's row tiles in turn.
// After a tile's product the accumulators go through the spare stage, 32
// rows at a time, and thread (c, h) (column n0 + c, row parity h) runs the
// first version's pool and sums over its rows in ascending order: the
// running max / min (and first indices) and Σz, Σz² of its rows r ≡ h
// (mod 2), carried over the object's tiles. At an object's end the two
// parities meet through `red` and thread (c, 0) writes the pool and adds
// mask · (Σ₀ + Σ₁) to the block's sums
template <bool kIndex>
struct TailFwd {
  ZOperands z;
  const float* mask;
  float *pmax, *pmin;
  int *amax, *amin;
  float (*red)[2][kTile];  // [mx, mn, Σz, Σz²][parity][column]
  int (*ridx)[2][kTile];   // [imx, imn][parity][column]
  int g, groups, rtiles, objs;
  float mx = -INFINITY, mn = INFINITY, b1 = 0.f, b2 = 0.f, u1 = 0.f, u2 = 0.f;
  int imx = INT_MAX, imn = INT_MAX;

  __device__ int steps() const { return objs * rtiles * kZSteps; }
  __device__ int ksteps() const { return kZSteps; }
  __device__ void stage(int s, float* st) const {
    const int t = s / kZSteps, r0 = (t % rtiles) * kTile;
    z.stage(st, g + groups * (t / rtiles), r0, min(kTile, z.p - r0), s % kZSteps);
  }

  __device__ void epilogue(int t, const float (&acc)[8][8], float* spare) {
    const int obj = g + groups * (t / rtiles), rt = t % rtiles;
    const int r0 = rt * kTile, valid = min(kTile, z.p - r0);
    const int tx = lane_tx(), ty = lane_ty(), c = threadIdx.x % kTile, half = threadIdx.x / kTile;
    __syncthreads();  // every thread is past the product that read `spare`
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      spill_quarter(acc, spare, q, tx, ty);
      __syncthreads();
      // this parity's 16 rows of the quarter, loaded together; the rows
      // past `valid` (zero-filled) are read and skipped
      float v16[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) v16[j] = spare[(half + 2 * j) * kLd + c];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int r = half + 2 * j;
        if (r >= valid - 32 * q) continue;
        const float v = v16[j];
        const int pt = r0 + 32 * q + r;
        if constexpr (kIndex) {
          if (beats_max(v, pt, mx, imx)) { mx = v; imx = pt; }
          if (beats_min(v, pt, mn, imn)) { mn = v; imn = pt; }
        } else {
          mx = fmaxf(mx, v);
          mn = fminf(mn, v);
        }
        b1 += v;
        b2 += v * v;
      }
      __syncthreads();
    }
    if (rt < rtiles - 1) return;
    red[0][half][c] = mx;
    red[1][half][c] = mn;
    red[2][half][c] = b1;
    red[3][half][c] = b2;
    if constexpr (kIndex) {
      ridx[0][half][c] = imx;
      ridx[1][half][c] = imn;
    }
    __syncthreads();
    if (half == 0) {
      const size_t out = (size_t)obj * z.k + z.n0 + c;
      if constexpr (kIndex) {
        const bool hi = beats_max(red[0][1][c], ridx[0][1][c], red[0][0][c], ridx[0][0][c]);
        const bool lo = beats_min(red[1][1][c], ridx[1][1][c], red[1][0][c], ridx[1][0][c]);
        pmax[out] = red[0][hi][c];
        pmin[out] = red[1][lo][c];
        amax[out] = ridx[0][hi][c];
        amin[out] = ridx[1][lo][c];
      } else {
        pmax[out] = fmaxf(red[0][0][c], red[0][1][c]);
        pmin[out] = fminf(red[1][0][c], red[1][1][c]);
      }
      u1 += mask[obj] * (red[2][0][c] + red[2][1][c]);
      u2 += mask[obj] * (red[3][0][c] + red[3][1][c]);
    }
    mx = -INFINITY, mn = INFINITY, b1 = 0.f, b2 = 0.f, imx = INT_MAX, imn = INT_MAX;
    // `red` is written again only after the next object's tiles, each
    // behind a __syncthreads
  }
};

// The g pass's job: tiles u = grp, grp + groups, ... of the (object, row
// tile) list, each written as g's [128, 128] block at column slice n0
struct TailG {
  ZOperands z;
  const float *mask, *dpmax, *dpmin, *dsum, *dsumsq;
  const int *amax, *amin;
  float* g;
  int grp, groups, rtiles, tiles;

  __device__ int steps() const { return tiles * kZSteps; }
  __device__ int ksteps() const { return kZSteps; }
  __device__ void stage(int s, float* st) const {
    const int u = grp + groups * (s / kZSteps), r0 = (u % rtiles) * kTile;
    z.stage(st, u / rtiles, r0, min(kTile, z.p - r0), s % kZSteps);
  }
  __device__ void epilogue(int t, const float (&acc)[8][8], float*) const {
    const int u = grp + groups * t, obj = u / rtiles, r0 = (u % rtiles) * kTile;
    const int valid = min(kTile, z.p - r0), tx = lane_tx(), ty = lane_ty();
    const float m = mask[obj];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = z.n0 + 64 * h + 4 * tx;
      const size_t oc = (size_t)obj * z.k + col;
      const int4 ix = *reinterpret_cast<const int4*>(amax + oc);
      const int4 in = *reinterpret_cast<const int4*>(amin + oc);
      const float4 gx = *reinterpret_cast<const float4*>(dpmax + oc);
      const float4 gn = *reinterpret_cast<const float4*>(dpmin + oc);
      const float4 d1 = *reinterpret_cast<const float4*>(dsum + col);
      const float4 d2 = *reinterpret_cast<const float4*>(dsumsq + col);
      const int imx[4] = {ix.x, ix.y, ix.z, ix.w}, imn[4] = {in.x, in.y, in.z, in.w};
      const float gmx[4] = {gx.x, gx.y, gx.z, gx.w}, gmn[4] = {gn.x, gn.y, gn.z, gn.w};
      const float a1[4] = {m * d1.x, m * d1.y, m * d1.z, m * d1.w};
      const float a2[4] = {m * d2.x, m * d2.y, m * d2.z, m * d2.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int row = tile_row(ty, i);
        if (row >= valid) continue;
        const int pt = r0 + row;
        float gv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          gv[e] = (pt == imx[e] ? gmx[e] : 0.f) + (pt == imn[e] ? gmn[e] : 0.f);
          gv[e] += a1[e] + 2.f * acc[i][4 * h + e] * a2[e];
        }
        store4<float>(g + ((size_t)obj * z.p + pt) * z.k + col, gv[0], gv[1], gv[2], gv[3]);
      }
    }
  }
};

// dX = g·Wᵀ: tiles t = grp, grp + groups, ... of 128 flat rows, column
// slice ct of dX (= dx_ct), K deep
struct TailDx {
  const float *g, *w;
  float* dx;
  long long rows;
  int k, ct, grp, groups, tiles;

  __device__ int steps() const { return tiles * (k / kBK); }
  __device__ int ksteps() const { return k / kBK; }
  __device__ void stage(int s, float* st) const {
    const int ks = k / kBK;
    const long long row0 = (long long)(grp + groups * (s / ks)) * kTile;
    const int k0 = (s % ks) * kBK;
    stage_rows_t(st, g + row0 * k + k0, k, (int)min((long long)kTile, rows - row0));
    // B[kk][n] = W[128·ct + n][k0 + kk]: W's rows, transposed
    stage_rows_t(st + kOperand, w + (size_t)ct * kTile * k + k0, k, kTile);
  }
  __device__ void epilogue(int t, const float (&acc)[8][8], float*) const {
    const long long row0 = (long long)(grp + groups * t) * kTile;
    const int tx = lane_tx(), ty = lane_ty();
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const long long r = row0 + tile_row(ty, i);
      if (r >= rows) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        store4<float>(dx + r * kC + 64 * h + 4 * tx, acc[i][4 * h], acc[i][4 * h + 1],
                      acc[i][4 * h + 2], acc[i][4 * h + 3]);
    }
  }
};

// dW's block (input i, column slice n0, row split): Σ over rows [lo, hi) of
// xᵢᵀ·g[:, n0..], one slice of the scratch per split
struct TailDw {
  const float *x, *g;
  float* out;  // the split's slice at dW[128·i, n0]
  long long lo, hi;
  int k, n0;

  __device__ int steps() const { return (int)((hi - lo + kBK - 1) / kBK); }
  __device__ int ksteps() const { return steps(); }
  __device__ void stage(int s, float* st) const {
    const long long r0 = lo + (long long)s * kBK;
    const int valid = (int)min((long long)kBK, hi - r0);
    stage_rows(st, x + r0 * kC, kC, valid);
    stage_rows(st + kOperand, g + r0 * k + n0, k, valid);
  }
  __device__ void epilogue(int, const float (&acc)[8][8], float*) const {
    const int tx = lane_tx(), ty = lane_ty();
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        store4<float>(out + (size_t)tile_row(ty, i) * k + 64 * h + 4 * tx, acc[i][4 * h],
                      acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]);
  }
};

}  // namespace
}  // namespace sga
