// The f32 embed_second pair's jobs on tail_f32.cuh's mainloop (pct_embed.cu's
// header comment says what each pass computes), in a header so that
// scripts/tail_gemm_bench.cu times the same jobs.
//
// Every product is the mainloop's: a 128 x 128 tile a block of 256 threads,
// 8 x 8 accumulators a thread in registers across the whole reduction, a
// 3-stage cp.async ring of 16-deep k-steps, two blocks an SM. Each output is
// one fmaf chain over k in ascending order from 0, as block_gemm formed it
// in the first version. Every sum keeps the first version's order: slice b
// of `blocks` is the flat 64-row tiles b, b + blocks, ... in ascending order
// (tail_f32::Slice), a tile of the h and dx0 products is two of them (rows
// 0-63 and 64-127), thread (channel c, row parity) runs one chain over its
// rows of the slice, store_channel_sums adds the parities and
// reduce_slices the slices in order; dW1 is one fmaf chain a slice over its
// rows in ascending order (zero rows past a tile's end included). The
// roundings around the products are the ones nvcc gave the first version
// (read in its SASS on an H100), written __fmaf_rn / __fmul_rn / __fadd_rn
// so that no contraction can move a bit.
#pragma once

#include "tail_f32.cuh"

namespace sga {
namespace e2f32 {

using namespace tail_f32;
using tail_f32::kThreads;

constexpr int kC = 128;                 // embedding width
constexpr int kKSteps = kC / kBK;       // k-steps of a 128-deep product
constexpr int kRawLd = kBK + 4;         // row stride of a k-step's raw rows
constexpr int kRaw = 2 * kOperand;      // stage offset of the raw rows
// a stage of A, B and the raw rows [128][kRawLd] that prep transposes into A
constexpr int kRawStage = kRaw + kTile * kRawLd;
constexpr size_t kRawRingBytes = sizeof(float) * kStages * kRawStage;

// The 128 rows of a product tile: the slice's 64-row tiles 2t (rows 0-63)
// and 2t + 1 (rows 64-127), each with its first flat row and valid rows; a
// half past the slice's last tile has none
struct Pair {
  long long row0[2];
  int valid[2];
};

__device__ __forceinline__ Pair pair_of(const Slice& sl, int n, int t) {
  Pair q;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    q.row0[h] = 0;
    q.valid[h] = 0;
    if (2 * t + h < n) sl.tile(2 * t + h, q.row0[h], q.valid[h]);
  }
  return q;
}

// Columns [k0, k0 + 16) of the pair's rows of a row-major [rows, 128]
// matrix into the stage's raw rows, 16 bytes a copy (thread t: row t / 4 of
// each half, columns 4·(t % 4) ..); rows past a half's valid are
// zero-filled
__device__ __forceinline__ void stage_pair(float* st, const float* __restrict__ src,
                                           const Pair& q, int k0) {
  const int r = threadIdx.x / 4, c4 = threadIdx.x % 4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const bool in = r < q.valid[h];
    cp_async16(st + kRaw + (64 * h + r) * kRawLd + 4 * c4,
               src + (in ? (q.row0[h] + r) * kC + k0 : 0) + 4 * c4, in);
  }
}

// prep: the raw rows transposed into A [k][m]; thread (m, half) moves row
// m's columns 8·half .. 8·half + 7. kRelu: each value x becomes
// max(x·wf[k] + bf[k], 0) with one rounding (layer 0's folded BN, x0)
template <bool kRelu>
__device__ __forceinline__ void transpose_raw(float* st, const float* swf, const float* sbf,
                                              int k0) {
  const int m = threadIdx.x % kTile, k8 = 8 * (threadIdx.x / kTile);
  const float* raw = st + kRaw + m * kRawLd + k8;
  const float4 v0 = *reinterpret_cast<const float4*>(raw);
  const float4 v1 = *reinterpret_cast<const float4*>(raw + 4);
  const float v[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    float x = v[e];
    if constexpr (kRelu) x = fmaxf(__fmaf_rn(x, swf[k0 + k8 + e], sbf[k0 + k8 + e]), 0.f);
    st[(k8 + e) * kLd + m] = x;
  }
}

// h = x0·W1 over the slice's pairs (A: h0's rows through prep, B: W1's
// rows). kFwd: h1 and the masked Σh, Σh² (a1, a2) of thread (c, parity),
// each tile's h through the spare stage 32 rows at a time (as the tail's
// forward); kDz: dz = dh + m·ds1 + 2·h·m·ds2 into `out`
enum HMode : int { kFwd = 0, kDz = 1 };

template <int kMode>
struct HJob {
  static constexpr int kRing = kStages, kStageFloats = kRawStage;
  static constexpr bool kPrep = true;
  using Mul = tail_f32::Mul;

  const float *h0, *w, *mask, *dh, *ds1, *ds2;  // dh, ds1, ds2: kDz
  float* out;                                   // h1 or dz
  const float *swf, *sbf;                       // wf, bf in shared memory
  float* mrow;                                  // [128] shared: each row's mask (kFwd)
  Slice sl;
  int n, p;
  float a1 = 0.f, a2 = 0.f;

  __device__ int ksteps() const { return kKSteps; }
  __device__ int steps() const { return (n + 1) / 2 * kKSteps; }
  __device__ void stage(int s, float* st) const {
    const int k0 = (s % kKSteps) * kBK;
    stage_pair(st, h0, pair_of(sl, n, s / kKSteps), k0);
    stage_rows(st + kOperand, w + (size_t)k0 * kC, kC, kBK);
  }
  __device__ void prep(int s, float* st) const {
    transpose_raw<true>(st, swf, sbf, (s % kKSteps) * kBK);
  }

  __device__ void epilogue(int t, const float (&acc)[8][8], float* spare) {
    const Pair q = pair_of(sl, n, t);
    const int tx = lane_tx(), ty = lane_ty();
    if constexpr (kMode == kDz) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int h = i / 4, r = 4 * ty + i % 4;  // tile_row(ty, i) = 64·h + r
        if (r >= q.valid[h]) continue;
        const long long row = q.row0[h] + r;
        const float m = mask[(int)row / p];
#pragma unroll
        for (int hc = 0; hc < 2; ++hc) {
          const int c0 = 64 * hc + 4 * tx;
          const float4 g4 = *reinterpret_cast<const float4*>(dh + row * kC + c0);
          const float4 d14 = *reinterpret_cast<const float4*>(ds1 + c0);
          const float4 d24 = *reinterpret_cast<const float4*>(ds2 + c0);
          const float g[4] = {g4.x, g4.y, g4.z, g4.w};
          const float d1[4] = {d14.x, d14.y, d14.z, d14.w};
          const float d2[4] = {d24.x, d24.y, d24.z, d24.w};
          float dz[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dz[e] = __fmaf_rn(2.f * acc[i][4 * hc + e], __fmul_rn(d2[e], m),
                              __fmaf_rn(d1[e], m, g[e]));
          store4<float>(out + row * kC + c0, dz[0], dz[1], dz[2], dz[3]);
        }
      }
    } else {
      const int c = threadIdx.x % kTile, half = threadIdx.x / kTile;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int h = i / 4, r = 4 * ty + i % 4;
        if (r >= q.valid[h]) continue;
#pragma unroll
        for (int hc = 0; hc < 2; ++hc)
          store4<float>(out + (q.row0[h] + r) * kC + 64 * hc + 4 * tx, acc[i][4 * hc],
                        acc[i][4 * hc + 1], acc[i][4 * hc + 2], acc[i][4 * hc + 3]);
      }
      if (threadIdx.x < kTile) {
        const int r = threadIdx.x % 64, hi = threadIdx.x >= 64;
        const long long row0 = hi ? q.row0[1] : q.row0[0];
        mrow[threadIdx.x] = r < (hi ? q.valid[1] : q.valid[0]) ? mask[(int)(row0 + r) / p] : 0.f;
      }
      __syncthreads();  // every thread is past the product that read `spare`
#pragma unroll
      for (int qr = 0; qr < 4; ++qr) {
        spill_quarter(acc, spare, qr, tx, ty);
        __syncthreads();
        float v16[16];
#pragma unroll
        for (int j = 0; j < 16; ++j) v16[j] = spare[(half + 2 * j) * kLd + c];
        const int h = qr / 2, base = 32 * (qr % 2);
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int r = base + half + 2 * j;  // row of the 64-row tile
          if (r >= q.valid[h]) break;
          const float v = v16[j], mv = __fmul_rn(v, mrow[64 * h + r]);
          a1 = __fadd_rn(a1, mv);
          a2 = __fmaf_rn(v, mv, a2);
        }
        __syncthreads();
      }
    }
  }
};

// dW1 = Σ x0ᵀ·dz over the slice's rows: each 64-row tile in 4 k-steps of
// 16 rows (A: h0's rows, x0 by prep; B: dz's rows; rows past the tile's end
// zero), the slice's share written to `out` [128][128]
struct DwJob {
  static constexpr int kRing = kStages, kStageFloats = kStage;
  static constexpr bool kPrep = true;
  using Mul = tail_f32::Mul;

  const float *h0, *dz;
  float* out;
  Slice sl;
  int n;
  float wfm, bfm;  // wf, bf of the thread's prep column threadIdx.x % 128

  __device__ int steps() const { return n * 4; }
  __device__ int ksteps() const { return steps(); }
  __device__ int rows16(int s, long long& r) const {
    long long row0;
    int valid;
    sl.tile(s / 4, row0, valid);
    const int v16 = max(0, min(kBK, valid - kBK * (s % 4)));
    r = row0 + (v16 > 0 ? kBK * (s % 4) : 0);
    return v16;
  }
  __device__ void stage(int s, float* st) const {
    long long r;
    const int v16 = rows16(s, r);
    stage_rows(st, h0 + r * kC, kC, v16);
    stage_rows(st + kOperand, dz + r * kC, kC, v16);
  }
  // x0 = max(h0·wf + bf, 0) in place, zero past the tile's end
  __device__ void prep(int s, float* st) const {
    long long r;
    const int v16 = rows16(s, r), m = threadIdx.x % kTile;
#pragma unroll
    for (int j = 0; j < kBK / 2; ++j) {
      const int k = threadIdx.x / kTile + 2 * j;
      float* a = st + k * kLd + m;
      *a = k < v16 ? fmaxf(__fmaf_rn(*a, wfm, bfm), 0.f) : 0.f;
    }
  }
  __device__ void epilogue(int, const float (&acc)[8][8], float*) const {
    const int tx = lane_tx(), ty = lane_ty();
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int hc = 0; hc < 2; ++hc)
        store4<float>(out + (size_t)tile_row(ty, i) * kC + 64 * hc + 4 * tx, acc[i][4 * hc],
                      acc[i][4 * hc + 1], acc[i][4 * hc + 2], acc[i][4 * hc + 3]);
  }
};

// dx0 = dz·W1ᵀ over the slice's pairs (A: dz's rows through prep, B: the
// rows of W1ᵀ), then per row of the 64-row tiles, in the first version's
// order (each tile's dx0 through the spare stage, 32 rows at a time, to
// thread (c, parity)): g0 = dx0 where h0·wf + bf > 0, dh0 = g0·wf, and
// the sums Σ g0·h0 (rwf) and Σ g0 (rbf)
struct DxJob {
  static constexpr int kRing = kStages, kStageFloats = kRawStage;
  static constexpr bool kPrep = true;
  using Mul = tail_f32::Mul;

  const float *dz, *wt, *h0;
  float* dh0;
  Slice sl;
  int n;
  float wfc, bfc;  // wf, bf of the thread's channel threadIdx.x % 128
  float rwf = 0.f, rbf = 0.f;

  __device__ int ksteps() const { return kKSteps; }
  __device__ int steps() const { return (n + 1) / 2 * kKSteps; }
  __device__ void stage(int s, float* st) const {
    const int k0 = (s % kKSteps) * kBK;
    stage_pair(st, dz, pair_of(sl, n, s / kKSteps), k0);
    stage_rows(st + kOperand, wt + (size_t)k0 * kC, kC, kBK);
  }
  __device__ void prep(int s, float* st) const {
    transpose_raw<false>(st, nullptr, nullptr, (s % kKSteps) * kBK);
  }
  __device__ void epilogue(int t, const float (&acc)[8][8], float* spare) {
    const Pair q = pair_of(sl, n, t);
    const int tx = lane_tx(), ty = lane_ty(), c = threadIdx.x % kTile, half = threadIdx.x / kTile;
    __syncthreads();  // every thread is past the product that read `spare`
#pragma unroll
    for (int qr = 0; qr < 4; ++qr) {
      spill_quarter(acc, spare, qr, tx, ty);
      __syncthreads();
      const int h = qr / 2, base = 32 * (qr % 2);
      const float* h0t = h0 + q.row0[h] * kC + c;
      float v16[16], hv16[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int r = base + half + 2 * j;
        v16[j] = spare[(half + 2 * j) * kLd + c];
        hv16[j] = r < q.valid[h] ? h0t[(size_t)r * kC] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int r = base + half + 2 * j;
        if (r >= q.valid[h]) break;
        const float hv = hv16[j];
        const float g0 = __fmaf_rn(wfc, hv, bfc) > 0.f ? v16[j] : 0.f;
        dh0[(q.row0[h] + r) * kC + c] = __fmul_rn(wfc, g0);
        rwf = __fmaf_rn(g0, hv, rwf);
        rbf = __fadd_rn(rbf, g0);
      }
      __syncthreads();
    }
  }
};

}  // namespace e2f32
}  // namespace sga
