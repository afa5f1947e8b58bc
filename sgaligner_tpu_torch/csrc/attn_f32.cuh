// The f32 C = 128 attention passes on tail_f32.cuh's mainloop: the jobs and
// kernels of pct_attention.cu's f32 paths (its header comment sets out the
// notation and what each pass computes), in a header so that
// scripts/tail_gemm_bench.cu times the same jobs.
//
// Every product below runs on tail_f32.cuh's mainloop: a 128 x 128 tile a
// block of 256 threads, 8 x 8 accumulators a thread in registers across the
// whole reduction, a 3-stage cp.async ring, two blocks an SM. Each output is
// one fmaf chain over k in ascending order, and every sum keeps the first
// version's order (its 64-row tiles' assignment to `blocks` slices, the
// four lanes of a row, reduce_slices in block order): the f32 outputs keep
// the first version's bits.

#pragma once

#include "pct_attention.cuh"
#include "tail_f32.cuh"

namespace sga {
namespace {
namespace f32 {

using namespace tail_f32;

constexpr int kC = 128;  // channels
constexpr int kDa = 32;  // q/k width (C / 4)

constexpr int kQLd = kDa + 4;  // row stride of a staged q tile

// A job kernel gets its job with `groups` (the grid) set; block b walks the
// job's units (tiles) b, b + groups, ...
template <class Job>
__device__ __forceinline__ void own_units(Job& job, int units) {
  job.grp = (int)blockIdx.x;
  job.tiles = (units - job.grp + job.groups - 1) / job.groups;
}

// Copy q rows [0, rows) (32 floats each) into dst [rows][kQLd]; rows >=
// valid are zero-filled
__device__ __forceinline__ void stage_q(float* dst, const float* __restrict__ src, int rows,
                                        int valid) {
  for (int i = threadIdx.x; i < rows * (kDa / 4); i += kThreads) {
    const int r = i / (kDa / 4), c4 = i % (kDa / 4);
    const bool in = r < valid;
    cp_async16(dst + r * kQLd + 4 * c4, src + (in ? r * kDa : 0) + 4 * c4, in);
  }
}

// The key loops of the apply pass (kAttend*) and the dv pass (kDv), one
// 128-row tile of an object at a time, keys (dv: query rows) in k-steps of
// 16. prep builds the k-step's A from the tile's resident q rows and the
// k-step's streamed q rows: the apply pass As[k][m] = G[m, k] = exp(S[m, k]
// − lse_k), the dv pass As[k][m] = G[k, m] = exp(S[k, m] − lse_m), S = q·qᵀ
// one fmaf chain over the 32 q columns; B is v (apply) or dŶ (dv). Thread t
// of prep owns rows t / 4 and t / 4 + 64 and the streamed rows ≡ t (mod 4):
// the first version's lane of a row, so OA's row sums s (apply) and
// Σ_j G[j, i]·c_j (dv) keep its order (a lane's partial over a 64-key
// chunk, then the quad sum, added in chunk order).
enum GMode : int {
  kAttendU = 0,  // u = y (SA) or x − y/s (OA) into out; OA with out2: y/s into out2, 1/s into sc
  kAttendY = 1,  // the attention op's y (OA: y/s) into out
  kAttendZ = 2,  // y·(1/s) into out, 1/s into sc (the attention op's OA backward)
  kDv = 3        // dv into out; OA: Σ_j G[j, i]·c_j into gcs
};

template <bool kDvPass>
struct GJob {
  static constexpr int kRing = 3;
  static constexpr int kQS = 2 * kOperand;          // streamed q rows [16][kQLd]
  static constexpr int kLV = kQS + kBK * kQLd;      // streamed lse (apply) or c (dv) [16]
  static constexpr int kStageFloats = kLV + kBK;
  static constexpr bool kPrep = true;
  using Mul = tail_f32::Mul;
  // resident, two by tile parity: q rows [128][kQLd], lse [128] (dv), s [128]
  static constexpr int kRes = kTile * kQLd + 2 * kTile;
  static constexpr size_t kSmemBytes = sizeof(float) * (kRing * kStageFloats + 2 * kRes);

  static constexpr bool dv = kDvPass;
  const float *q, *bsrc, *lse, *x, *cvec;
  float *out, *out2, *sc, *gcs, *res;
  int mode, oa, p, rtiles, grp, groups, tiles, kst;
  float part[2] = {0.f, 0.f}, run2[2] = {0.f, 0.f};

  __device__ int steps() const { return tiles * kst; }
  __device__ int ksteps() const { return kst; }
  __device__ void tile_at(int t, int& obj, int& r0, int& valid) const {
    const int u = grp + groups * t;
    obj = u / rtiles;
    r0 = (u % rtiles) * kTile;
    valid = min(kTile, p - r0);
  }
  __device__ void stage(int s, float* st) const {
    const int t = s / kst, ks = s % kst, k0 = ks * kBK, kv = min(kBK, p - k0);
    int obj, r0, valid;
    tile_at(t, obj, r0, valid);
    const size_t ob = (size_t)obj * p;
    stage_rows(st + kOperand, bsrc + (ob + k0) * kC, kC, kv);
    stage_q(st + kQS, q + (ob + k0) * kDa, kBK, kv);
    if constexpr (dv) {
      if (oa) stage_vec(st + kLV, cvec + ob + k0, kBK, kv);
    } else {
      stage_vec(st + kLV, lse + ob + k0, kBK, kv);
    }
    if (ks == 0) {
      float* r = res + (t % 2) * kRes;
      stage_q(r, q + (ob + r0) * kDa, kTile, valid);
      if constexpr (dv) stage_vec(r + kTile * kQLd, lse + ob + r0, kTile, valid);
    }
  }
  __device__ void prep(int s, float* st) {
    const int t = s / kst, ks = s % kst, kv = min(kBK, p - ks * kBK);
    float* rb = res + (t % 2) * kRes;  // the tile's resident q rows, lse, s
    const float* qr = rb;
    const float* lr = rb + kTile * kQLd;
    float* srs = rb + kTile * kQLd + kTile;
    const float* qs = st + kQS;
    const float* lv = st + kLV;
    const int sub = threadIdx.x % 4, r = threadIdx.x / 4;
    if (ks == 0) part[0] = part[1] = run2[0] = run2[1] = 0.f;
    // S of the thread's 2 x 4 (resident, streamed) pairs, 8 q columns at a
    // time: each value one fmaf chain over the 32 columns in order
    float sv[2][4] = {};
#pragma unroll
    for (int d8 = 0; d8 < kDa / 8; ++d8) {
      float qa[2][8];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float4 a0 = *reinterpret_cast<const float4*>(qr + (r + 64 * h) * kQLd + 8 * d8);
        const float4 a1 = *reinterpret_cast<const float4*>(qr + (r + 64 * h) * kQLd + 8 * d8 + 4);
        qa[h][0] = a0.x, qa[h][1] = a0.y, qa[h][2] = a0.z, qa[h][3] = a0.w;
        qa[h][4] = a1.x, qa[h][5] = a1.y, qa[h][6] = a1.z, qa[h][7] = a1.w;
      }
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const float4 b0 = *reinterpret_cast<const float4*>(qs + (sub + 4 * m) * kQLd + 8 * d8);
        const float4 b1 = *reinterpret_cast<const float4*>(qs + (sub + 4 * m) * kQLd + 8 * d8 + 4);
        const float qb[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int d = 0; d < 8; ++d)
#pragma unroll
          for (int h = 0; h < 2; ++h) sv[h][m] = fmaf(qa[h][d], qb[d], sv[h][m]);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rr = r + 64 * h;
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int js = sub + 4 * m;
        const float e = sv[h][m];
        float g;
        if constexpr (dv) {
          g = js < kv ? expf(e - lr[rr]) : 0.f;
          if (oa && js < kv) run2[h] += g * lv[js];
        } else {
          g = js < kv ? expf(e - lv[js]) : 0.f;
          part[h] += g;
        }
        st[js * kLd + rr] = g;
      }
    }
    const bool last = ks == kst - 1;
    if (!dv && (ks % 4 == 3 || last)) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        run2[h] += quad_sum(part[h]);
        part[h] = 0.f;
      }
    }
    if (!last) return;
    int obj, r0, valid;
    tile_at(t, obj, r0, valid);
    const size_t ob = (size_t)obj * p;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rr = r + 64 * h;
      if constexpr (dv) {
        if (oa) {
          const float gq = quad_sum(run2[h]);
          if (sub == 0 && rr < valid) gcs[ob + r0 + rr] = gq;
        }
      } else {
        if (sub == 0) srs[rr] = run2[h];
        if (sc != nullptr && sub == 0 && rr < valid) sc[ob + r0 + rr] = 1.f / (1e-9f + run2[h]);
      }
    }
  }
  __device__ void epilogue(int t, const float (&acc)[8][8], float*) const {
    int obj, r0, valid;
    tile_at(t, obj, r0, valid);
    const size_t ob = (size_t)obj * p;
    const float* srs = res + (t % 2) * kRes + kTile * kQLd + kTile;
    const int tx = lane_tx(), ty = lane_ty();
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = tile_row(ty, i);
      if (row >= valid) continue;
      const size_t g = ob + r0 + row;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = 64 * h + 4 * tx;
        float a[4] = {acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]};
        if (mode == kAttendZ) {
          const float inv = 1.f / (1e-9f + srs[row]);
#pragma unroll
          for (int e = 0; e < 4; ++e) a[e] = a[e] * inv;
        } else if (!dv && oa) {
          const float sr = 1e-9f + srs[row];
#pragma unroll
          for (int e = 0; e < 4; ++e) a[e] = a[e] / sr;
          if (mode == kAttendU) {
            if (out2 != nullptr) store4<float>(out2 + g * kC + col, a[0], a[1], a[2], a[3]);
            const float4 xv = *reinterpret_cast<const float4*>(x + g * kC + col);
            a[0] = xv.x - a[0], a[1] = xv.y - a[1], a[2] = xv.z - a[2], a[3] = xv.w - a[3];
          }
        }
        store4<float>(out + g * kC + col, a[0], a[1], a[2], a[3]);
      }
    }
  }
};

__global__ void __launch_bounds__(kThreads, 2) attend_kernel(GJob<false> job, int units) {
  extern __shared__ __align__(128) unsigned char smem[];
  own_units(job, units);
  float* ring = reinterpret_cast<float*>(smem);
  job.res = ring + GJob<false>::kRing * GJob<false>::kStageFloats;
  run(job, ring);
}

__global__ void __launch_bounds__(kThreads, 2) dv_kernel(GJob<true> job, int units) {
  extern __shared__ __align__(128) unsigned char smem[];
  own_units(job, units);
  float* ring = reinterpret_cast<float*>(smem);
  job.res = ring + GJob<true>::kRing * GJob<true>::kStageFloats;
  run(job, ring);
}

// A product over 128 flat rows a tile: t = u·Wt + bt (kTrain: t_out; kEval:
// out = x + relu(t·wbn + bbn); kDz, kDzEpi: dz from t), dY = ±dz·Wtᵀ (kDy),
// dx = dq·Wqk_sᵀ + dv·Wvᵀ (− dY, + dxn) (kDx)
enum RMode : int { kTrain = 0, kEval = 1, kDz = 2, kDzEpi = 3, kDy = 4, kDx = 5 };

template <int kMode>
struct RowJob {
  static constexpr int mode = kMode;

  const float *a, *a2, *w, *w2;            // A operands and weights (kDx: dq, dv, Wqk, Wv)
  const float *bt, *x, *wbn, *bbn, *mask, *cot, *dsum, *dsumsq, *dy;
  float* out;
  long long rows;
  int p, neg, du, resid, grp, groups, tiles;

  __device__ int ksteps() const { return mode == kDx ? (kDa + kC) / kBK : kC / kBK; }
  __device__ int steps() const { return tiles * ksteps(); }
  __device__ void stage(int s, float* st) const {
    const int kst = ksteps(), ks = s % kst;
    const long long row0 = (long long)(grp + groups * (s / kst)) * kTile;
    const int valid = (int)min((long long)kTile, rows - row0);
    if constexpr (mode == kDx) {
      if (ks < kDa / kBK) {
        stage_rows_t(st, a + row0 * kDa + ks * kBK, kDa, valid);
        stage_rows_t(st + kOperand, w + ks * kBK, kDa, kTile);  // B[k][n] = Wqk[n][k]
      } else {
        const int k0 = (ks - kDa / kBK) * kBK;
        stage_rows_t(st, a2 + row0 * kC + k0, kC, valid);
        stage_rows_t(st + kOperand, w2 + k0, kC, kTile);        // B[k][n] = Wv[n][k]
      }
    } else {
      stage_rows_t(st, a + row0 * kC + ks * kBK, kC, valid);
      if constexpr (mode == kDy)
        stage_rows_t(st + kOperand, w + ks * kBK, kC, kTile);   // B[k][n] = Wt[n][k]
      else
        stage_rows(st + kOperand, w + (size_t)ks * kBK * kC, kC, kBK);
    }
  }
  __device__ void epilogue(int t, const float (&acc)[8][8], float*) const {
    const long long row0 = (long long)(grp + groups * t) * kTile;
    const int tx = lane_tx(), ty = lane_ty();
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const long long r = row0 + tile_row(ty, i);
      if (r >= rows) continue;
      const float m = (mode == kDz || mode == kDzEpi) ? mask[r / p] : 0.f;
      (void)m;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c0 = 64 * h + 4 * tx;
        const long long at = r * kC + c0;
        float o[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = c0 + e;
          const float d = acc[i][4 * h + e];
          if constexpr (mode == kDy) {
            o[e] = neg ? -d : d;
          } else if constexpr (mode == kDx) {
            float v = d;
            if (du) v -= dy[at + e];
            if (resid) v += cot[at + e];
            o[e] = v;
          } else {
            const float tv = d + bt[c];
            if constexpr (mode == kTrain) {
              o[e] = tv;
            } else if constexpr (mode == kEval) {
              const float z = tv * wbn[c] + bbn[c];
              o[e] = x[at + e] + fmaxf(z, 0.f);
            } else {
              // m·dsum and m·dsumsq rounded on their own: the first
              // version computed them once a tile, outside its row loop
              const float g = cot[at + e], md1 = __fmul_rn(m, dsum[c]);
              const float md2 = __fmul_rn(m, dsumsq[c]);
              if constexpr (mode == kDzEpi) {
                const float wc = wbn[c];
                o[e] = ((epi_live<float>(tv, wc, bbn[c]) ? g : 0.f) * wc + md1) + 2.f * tv * md2;
              } else {
                o[e] = (g + md1) + 2.f * tv * md2;
              }
            }
          }
        }
        store4<float>(out + at, o[0], o[1], o[2], o[3]);
      }
    }
  }
};

template <int kMode>
__global__ void __launch_bounds__(kThreads, 2) trans_kernel(RowJob<kMode> job, int units) {
  extern __shared__ __align__(128) unsigned char smem[];
  own_units(job, units);
  run(job, reinterpret_cast<float*>(smem));
}
__global__ void __launch_bounds__(kThreads, 2) dy_kernel(RowJob<kDy> job, int units) {
  extern __shared__ __align__(128) unsigned char smem[];
  own_units(job, units);
  run(job, reinterpret_cast<float*>(smem));
}
__global__ void __launch_bounds__(kThreads, 2) dx_kernel(RowJob<kDx> job, int units) {
  extern __shared__ __align__(128) unsigned char smem[];
  own_units(job, units);
  run(job, reinterpret_cast<float*>(smem));
}

// A 128 x 160 product: B's 128 columns in acc (8 x 8 a thread, as
// product) and 32 more columns (B2, [kBK][kQLd] after A and B in the stage)
// in the job's acc2 (8 x 2 a thread: the same rows, columns 2·tx, 2·tx + 1).
// Each output one fmaf chain over k in ascending order.
struct MulWide {
  static constexpr int kB2 = 2 * kOperand;
  static constexpr int kStageFloats = kB2 + kBK * kQLd;
  template <class Job>
  __device__ __forceinline__ static void apply(Job& job, float (&acc)[8][8], const float* st,
                                               int tx, int ty) {
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      const float4 p0 = *reinterpret_cast<const float4*>(st + k * kLd + 4 * ty);
      const float4 p1 = *reinterpret_cast<const float4*>(st + k * kLd + 64 + 4 * ty);
      const float4 b0 = *reinterpret_cast<const float4*>(st + kOperand + k * kLd + 4 * tx);
      const float4 b1 = *reinterpret_cast<const float4*>(st + kOperand + k * kLd + 64 + 4 * tx);
      const float2 c2 = *reinterpret_cast<const float2*>(st + kB2 + k * kQLd + 2 * tx);
      const float a[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        job.acc2[i][0] = fmaf(a[i], c2.x, job.acc2[i][0]);
        job.acc2[i][1] = fmaf(a[i], c2.y, job.acc2[i][1]);
      }
    }
  }
};

// The projections of 128 flat rows a tile: v = x·Wv + bv and q = x·Wqk_s in
// one 128 x 160 product (K = the 128 channels)
struct ProjJob {
  static constexpr int kRing = kStages;
  static constexpr int kStageFloats = MulWide::kStageFloats;
  static constexpr bool kPrep = false;
  using Mul = MulWide;

  const float *x, *wqk, *wv, *bv;
  float *q, *v;
  long long rows;
  int grp, groups, tiles;
  float acc2[8][2] = {};

  __device__ int ksteps() const { return kC / kBK; }
  __device__ int steps() const { return tiles * ksteps(); }
  __device__ void stage(int s, float* st) const {
    const int ks = s % ksteps(), k0 = ks * kBK;
    const long long row0 = (long long)(grp + groups * (s / ksteps())) * kTile;
    stage_rows_t(st, x + row0 * kC + k0, kC, (int)min((long long)kTile, rows - row0));
    stage_rows(st + kOperand, wv + (size_t)k0 * kC, kC, kBK);
    stage_q(st + MulWide::kB2, wqk + (size_t)k0 * kDa, kBK, kBK);
  }
  __device__ void epilogue(int t, const float (&acc)[8][8], float*) {
    const long long row0 = (long long)(grp + groups * t) * kTile;
    const int tx = lane_tx(), ty = lane_ty();
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const long long r = row0 + tile_row(ty, i);
      if (r < rows) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = 64 * h + 4 * tx;
          store4<float>(v + r * kC + c, acc[i][4 * h] + bv[c], acc[i][4 * h + 1] + bv[c + 1],
                        acc[i][4 * h + 2] + bv[c + 2], acc[i][4 * h + 3] + bv[c + 3]);
        }
        *reinterpret_cast<float2*>(q + r * kDa + 2 * tx) = make_float2(acc2[i][0], acc2[i][1]);
      }
      acc2[i][0] = acc2[i][1] = 0.f;
    }
  }
};

__global__ void __launch_bounds__(kThreads, 2) proj_kernel(ProjJob job, int units) {
  extern __shared__ __align__(128) unsigned char smem[];
  own_units(job, units);
  run(job, reinterpret_cast<float*>(smem));
}

// The log-sum-exp pass: per 128-row tile I of an object, walk the key
// tiles J: S = q_I·q_Jᵀ (K = 32, two k-steps) in registers; the epilogue
// passes S through the spare stage a 64 x 64 quarter at a time to thread
// (row, lane) = (t / 4, t % 4), which runs the first version's online max /
// sum-exp over its keys ≡ lane (mod 4) of that 64-key chunk; at I's last
// key tile the four lanes of a row merge (merge_lse) and lse = m + log l.
struct LseJob {
  static constexpr int kSLd = 66;  // a quarter [64][kSLd] in the spare stage
  static_assert(64 * kSLd <= kStage, "lse: quarter in the spare stage");

  const float* q;
  float* lse;
  int p, rtiles, jtiles, grp, groups, tiles;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  __device__ int ksteps() const { return kDa / kBK; }
  __device__ int steps() const { return tiles * jtiles * ksteps(); }
  __device__ void unit(int T, int& obj, int& i0, int& j0) const {
    const int u = grp + groups * (T / jtiles);
    obj = u / rtiles;
    i0 = (u % rtiles) * kTile;
    j0 = (T % jtiles) * kTile;
  }
  __device__ void stage(int s, float* st) const {
    int obj, i0, j0;
    unit(s / ksteps(), obj, i0, j0);
    const size_t ob = (size_t)obj * p;
    const int k0 = (s % ksteps()) * kBK;
    stage_rows_t(st, q + (ob + i0) * kDa + k0, kDa, min(kTile, p - i0));
    stage_rows_t(st + kOperand, q + (ob + j0) * kDa + k0, kDa, min(kTile, p - j0));
  }
  __device__ void epilogue(int T, const float (&acc)[8][8], float* spare) {
    int obj, i0, j0;
    unit(T, obj, i0, j0);
    const int tx = lane_tx(), ty = lane_ty();
    const int row = threadIdx.x / 4, sub = threadIdx.x % 4;
    const float* ss = spare;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr)
#pragma unroll
      for (int kh = 0; kh < 2; ++kh) {
        __syncthreads();  // the product (or the last quarter's reads) done with `spare`
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            spare[(4 * ty + r) * kSLd + 4 * tx + e] = acc[4 * hr + r][4 * kh + e];
        __syncthreads();
        // the first version's chunk c0 = j0 + 64·kh, verbatim
        const int kv = min(64, p - (j0 + 64 * kh));
        float cm = -INFINITY;
        for (int j = sub; j < kv; j += 4) cm = fmaxf(cm, ss[row * kSLd + j]);
        if (cm != -INFINITY) {
          const float mm = fmaxf(m[hr], cm);
          float a = (m[hr] == -INFINITY) ? 0.f : l[hr] * expf(m[hr] - mm);
          for (int j = sub; j < kv; j += 4) a += expf(ss[row * kSLd + j] - mm);
          m[hr] = mm;
          l[hr] = a;
        }
      }
    if (j0 + kTile < jtiles * kTile) return;  // not I's last key tile
    const size_t ob = (size_t)obj * p;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      merge_lse(m[hr], l[hr]);
      const int r = i0 + 64 * hr + row;
      if (sub == 0 && r < p) lse[ob + r] = m[hr] + logf(l[hr]);
      m[hr] = -INFINITY;
      l[hr] = 0.f;
    }
  }
};

__global__ void __launch_bounds__(kThreads, 2) lse128_kernel(LseJob job, int units) {
  extern __shared__ __align__(128) unsigned char smem[];
  own_units(job, units);
  run(job, reinterpret_cast<float*>(smem));
}

// A weight gradient's share of one slice: Aᵀ·B over the slice's rows, each
// 64-row tile in 4 k-steps (rows past the tile's end zero-filled, as the
// first version's tiles were), written to the slice's part of the scratch.
// kFused: dWv = xᵀ·dv and dWqk = xᵀ·dq in one block (B = dv, and dq's 32
// columns beside it: 8 x 2 more accumulators a thread); else dWt = uᵀ·dz.
template <bool kFused>
struct WgradJob {
  static constexpr int kRing = kStages;
  static constexpr int kStageFloats = kFused ? MulWide::kStageFloats : kStage;
  static constexpr bool kPrep = false;
  using Mul = std::conditional_t<kFused, MulWide, tail_f32::Mul>;

  const float *a, *b, *b2;
  float *out, *out2;
  Slice sl;
  float acc2[8][2] = {};

  __device__ int steps() const { return sl.count() * 4; }
  __device__ int ksteps() const { return steps(); }
  __device__ void stage(int s, float* st) const {
    long long row0;
    int valid;
    sl.tile(s / 4, row0, valid);
    const int v16 = max(0, min(kBK, valid - kBK * (s % 4)));
    const long long r = row0 + (v16 > 0 ? kBK * (s % 4) : 0);
    stage_rows(st, a + r * kC, kC, v16);
    stage_rows(st + kOperand, b + r * kC, kC, v16);
    if constexpr (kFused) stage_q(st + MulWide::kB2, b2 + r * kDa, kBK, v16);
  }
  __device__ void epilogue(int, const float (&acc)[8][8], float*) const {
    const int tx = lane_tx(), ty = lane_ty();
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = tile_row(ty, i);
#pragma unroll
      for (int h = 0; h < 2; ++h)
        store4<float>(out + (size_t)row * kC + 64 * h + 4 * tx, acc[i][4 * h],
                      acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]);
      if constexpr (kFused)
        *reinterpret_cast<float2*>(out2 + (size_t)row * kDa + 2 * tx) =
            make_float2(acc2[i][0], acc2[i][1]);
    }
  }
};

// block b: slice b / n of the gradients b % n + (2 - n): 0, dWt from (u,
// dz) over the per-object tiles; 1, dWv and dWqk from (x, dv, dq) over the
// flat ones (n = 2: both; n = 1: the attention op's, the second alone)
__global__ void __launch_bounds__(kThreads, 2)
wgrad_kernel(const float* __restrict__ u, const float* __restrict__ dz,
             const float* __restrict__ x, const float* __restrict__ dv,
             const float* __restrict__ dq, float* __restrict__ scratch, long long rows, int p,
             int blocks, int n) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int which = (int)blockIdx.x % n + (2 - n), slice = (int)blockIdx.x / n;
  float* part = scratch + (size_t)slice * slice_stride(kBwdGrad);
  float* ring = reinterpret_cast<float*>(smem);
  if (which == 0) {
    WgradJob<false> job{u, dz, nullptr, part + kOffDwt, nullptr, {rows, p, blocks, slice, 0}};
    run_slice(job, ring);
  } else {
    WgradJob<true> job{x, dv, dq, part + kOffDwv, part + kOffDwqk, {rows, p, blocks, slice, 1}};
    run_slice(job, ring);
  }
}

// Channel sums of one slice in the first version's order: thread (c, half)
// adds the values of its rows r ≡ half (mod 2) of the slice's tiles in turn,
// then store_channel_sums adds the two halves. kSumsT: Σ m·t, Σ m·t² of t_out
// (into part[0, 128) and [128, 256)); kSumDbt: Σ dz (per-object tiles) and
// kSumDbv: Σ dv (flat tiles), at their offsets in a backward slice
enum SumMode : int { kSumsT = 0, kSumDbt = 1, kSumDbv = 2 };

__global__ void __launch_bounds__(kThreads)
colsum_kernel(const float* __restrict__ src, const float* __restrict__ mask,
              float* __restrict__ scratch, long long rows, int p, int blocks, int mode) {
  const int c = threadIdx.x % kC, half = threadIdx.x / kC;
  const Slice sl{rows, p, blocks, (int)blockIdx.x, mode == kSumDbv};
  float s1 = 0.f, s2 = 0.f;
  const int n = sl.count();
  for (int k = 0; k < n; ++k) {
    long long row0;
    int valid;
    sl.tile(k, row0, valid);
    const float m = mode == kSumsT ? mask[row0 / p] : 0.f;
    for (int r = half; r < valid; r += 2) {
      const float v = src[(row0 + r) * kC + c];
      if (mode == kSumsT) {
        s1 += m * v;
        s2 += m * (v * v);
      } else {
        s1 += v;
      }
    }
  }
  if (mode == kSumsT) {
    float* part = scratch + (size_t)blockIdx.x * slice_stride(2 * kC);
    store_channel_sums(s1, part);
    store_channel_sums(s2, part + kC);
  } else {
    float* part = scratch + (size_t)blockIdx.x * slice_stride(kBwdGrad);
    store_channel_sums(s1, part + (mode == kSumDbt ? kOffDbt : kOffDbv));
  }
}

// Row passes of four lanes a row (lane sub takes channels sub, sub + 4, ...
// and a quad sum adds them, as the first version's). sc_kernel (OA): c_j =
// Σ (dY_j·(1/s_j))·ŷ_j into sc[rows + j] and dŶ_j = dY_j·(1/s_j), with 1/s
// from sc[0, rows) and ŷ = y/s (the block ops) or y·(1/s) (the attention
// op). dd_kernel: D_i = v_i·dv_i, OA less Σ_j G[j, i]·c_j (gcs).
__global__ void __launch_bounds__(kThreads)
sc_kernel(const float* __restrict__ dy, const float* __restrict__ yhat, float* __restrict__ sc,
          float* __restrict__ dyh, long long rows) {
  const int sub = threadIdx.x % 4;
  for (long long r0 = (long long)blockIdx.x * (kThreads / 4); r0 < rows;
       r0 += (long long)gridDim.x * (kThreads / 4)) {
    const long long row = r0 + threadIdx.x / 4;
    const bool in = row < rows;
    float c = 0.f;
    if (in) {
      const float inv = sc[row];
      for (int cc = sub; cc < kC; cc += 4) {
        const float d = dy[row * kC + cc];
        c += (d * inv) * yhat[row * kC + cc];
        dyh[row * kC + cc] = d * inv;
      }
    }
    c = quad_sum(c);
    if (sub == 0 && in) sc[rows + row] = c;
  }
}

__global__ void __launch_bounds__(kThreads)
dd_kernel(const float* __restrict__ dv, const float* __restrict__ v, const float* __restrict__ gcs,
          float* __restrict__ dd, long long rows, int oa) {
  const int sub = threadIdx.x % 4;
  for (long long r0 = (long long)blockIdx.x * (kThreads / 4); r0 < rows;
       r0 += (long long)gridDim.x * (kThreads / 4)) {
    const long long row = r0 + threadIdx.x / 4;
    const bool in = row < rows;
    float d = 0.f;
    if (in)
      for (int cc = sub; cc < kC; cc += 4) d = fmaf(dv[row * kC + cc], v[row * kC + cc], d);
    d = quad_sum(d);
    if (oa && in) d -= gcs[row];
    if (sub == 0 && in) dd[row] = d;
  }
}

// dq pass: dq = (dE + dEᵀ)·q, one object a block. The block walks the
// object's pairs (I, J) of a 128-row tile I and a 64-key chunk J of a tile
// at or after I, in order; the dual product gives P1 = v_I·dŶ_Jᵀ and P2 =
// dŶ_I·v_Jᵀ side by side in registers (K = the 128 channels), each computed
// once for both tiles of dE + dEᵀ it feeds:
//   F_IJ = exp(S − lse_I)·(P1 − c_J − D_I) + exp(S − lse_J)·(P2 − c_I − D_J),
//   F_JI = (the same two terms in the other order)ᵀ, S = q_I·q_Jᵀ,
// and dq_I += F_IJ·q_J, dq_J += F_JI·q_I (J past I's tile). The epilogue
// forms F 64 rows at a time through the spare stage. dq lives in device
// memory between pairs (zeroed first); in this order every dq row receives
// its keys in ascending order, each value one fmaf chain as the first
// version's per-tile loop gave it.
struct DqJob {
  static constexpr int kRing = kStages;
  static constexpr int kStageFloats = 3 * kOperand;  // A0 = v_I, A1 = dŶ_I, B = [dŶ_J | v_J]
  static constexpr bool kPrep = false;
  using Mul = MulDual;
  static constexpr int kJ = 64;   // keys a chunk
  static constexpr int kFLd = kJ + 4;
  // resident: q_I [128][kQLd], lse, D, c of I [128 each]; q_J [64][kQLd], lse, D, c of J
  static constexpr int kQI = 0, kLI = kTile * kQLd, kDI = kLI + kTile, kCI = kDI + kTile;
  static constexpr int kQJ = kCI + kTile, kLJ = kQJ + kJ * kQLd, kDJ = kLJ + kJ, kCJ = kDJ + kJ;
  static constexpr int kRes = kCJ + kJ;
  static constexpr size_t kSmemBytes = sizeof(float) * (kRing * kStageFloats + kRes);
  static_assert(kJ * kFLd <= kStageFloats, "dq: F tile in the spare stage");

  const float *q, *v, *dyh, *lse, *dd, *cvec;
  float *dq, *res;
  int oa, p, rtiles, jchunks, pairs, grp, groups, tiles;

  __device__ int ksteps() const { return kC / kBK; }
  __device__ int steps() const { return tiles * pairs * ksteps(); }
  // pair T of the block's walk: object, row tile I (rows i0..), chunk jc
  __device__ void unit(int T, int& obj, int& i0, int& valid, int& jc) const {
    obj = grp + groups * (T / pairs);
    int u = T % pairs, it = 0;
    while (u >= jchunks - 2 * it) u -= jchunks - 2 * it++;
    i0 = it * kTile;
    valid = min(kTile, p - i0);
    jc = 2 * it + u;
  }
  __device__ void stage(int s, float* st) const {
    const int ks = s % ksteps(), c0 = ks * kBK;
    int obj, i0, valid, jc;
    unit(s / ksteps(), obj, i0, valid, jc);
    const int j0 = jc * kJ, kv = min(kJ, p - j0);
    const size_t ob = (size_t)obj * p;
    stage_rows_t(st, v + (ob + i0) * kC + c0, kC, valid);
    stage_rows_t(st + kOperand, dyh + (ob + i0) * kC + c0, kC, valid);
    stage_rows_t<kJ>(st + 2 * kOperand, dyh + (ob + j0) * kC + c0, kC, kv);
    stage_rows_t<kJ>(st + 2 * kOperand + kJ, v + (ob + j0) * kC + c0, kC, kv);
    if (ks == ksteps() - 1) {  // what this pair's epilogue reads
      stage_q(res + kQJ, q + (ob + j0) * kDa, kJ, kv);
      stage_vec(res + kLJ, lse + ob + j0, kJ, kv);
      stage_vec(res + kDJ, dd + ob + j0, kJ, kv);
      if (oa) stage_vec(res + kCJ, cvec + ob + j0, kJ, kv);
      if (jc == 2 * (i0 / kTile)) {  // I's first pair
        stage_q(res + kQI, q + (ob + i0) * kDa, kTile, valid);
        stage_vec(res + kLI, lse + ob + i0, kTile, valid);
        stage_vec(res + kDI, dd + ob + i0, kTile, valid);
        if (oa) stage_vec(res + kCI, cvec + ob + i0, kTile, valid);
      }
    }
  }
  // dq rows `row0 + 2·rp + {0, 1}` (those < `valid`) += F[2·rp + a][k]·qk[k]
  // over the 64 keys k of the F tile `f`, columns 4·(t % 8) ..
  __device__ void add_dq(const float* f, const float* qk, size_t row0, int valid) const {
    const int rp = threadIdx.x / 8, dc = 4 * (threadIdx.x % 8);
    float dacc[2][4];
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      float4 v0 = make_float4(0.f, 0.f, 0.f, 0.f);
      if (2 * rp + a < valid) v0 = *reinterpret_cast<const float4*>(dq + (row0 + 2 * rp + a) * kDa + dc);
      dacc[a][0] = v0.x, dacc[a][1] = v0.y, dacc[a][2] = v0.z, dacc[a][3] = v0.w;
    }
#pragma unroll 4
    for (int k4 = 0; k4 < kJ / 4; ++k4) {
      const float4 f0 = *reinterpret_cast<const float4*>(f + (2 * rp) * kFLd + 4 * k4);
      const float4 f1 = *reinterpret_cast<const float4*>(f + (2 * rp + 1) * kFLd + 4 * k4);
      const float fa[2][4] = {{f0.x, f0.y, f0.z, f0.w}, {f1.x, f1.y, f1.z, f1.w}};
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float4 b = *reinterpret_cast<const float4*>(qk + (4 * k4 + kk) * kQLd + dc);
        const float qb[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int a = 0; a < 2; ++a)
#pragma unroll
          for (int e = 0; e < 4; ++e) dacc[a][e] = fmaf(fa[a][kk], qb[e], dacc[a][e]);
      }
    }
#pragma unroll
    for (int a = 0; a < 2; ++a)
      if (2 * rp + a < valid)
        store4<float>(dq + (row0 + 2 * rp + a) * kDa + dc, dacc[a][0], dacc[a][1], dacc[a][2],
                      dacc[a][3]);
  }
  __device__ void epilogue(int T, const float (&acc)[8][8], float* spare) const {
    int obj, i0, valid, jc;
    unit(T, obj, i0, valid, jc);
    const int j0 = jc * kJ, kv = min(kJ, p - j0);
    const bool both = jc / 2 > i0 / kTile;  // J past I's tile: F_JI too
    const size_t ob = (size_t)obj * p;
    const int tx = lane_tx(), ty = lane_ty();
    const float* qi = res + kQI;
    const float* qj = res + kQJ;
    float* f = spare;
    __syncthreads();  // every thread is past the product that read `spare`
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      // S of this thread's rows 64·hh + 4·ty + r (r < 4) and keys 4·tx + e
      float sacc[4][4] = {};
#pragma unroll
      for (int d4 = 0; d4 < kDa / 4; ++d4) {
        float qa[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float4 a0 = *reinterpret_cast<const float4*>(qi + (64 * hh + 4 * ty + r) * kQLd + 4 * d4);
          qa[r][0] = a0.x, qa[r][1] = a0.y, qa[r][2] = a0.z, qa[r][3] = a0.w;
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float4 b = *reinterpret_cast<const float4*>(qj + (4 * tx + e) * kQLd + 4 * d4);
          const float qb[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
          for (int dd4 = 0; dd4 < 4; ++dd4)
#pragma unroll
            for (int r = 0; r < 4; ++r) sacc[r][e] = fmaf(qa[r][dd4], qb[dd4], sacc[r][e]);
        }
      }
      // F_IJ[i][j] into f[i - 64·hh][j]
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = 4 * hh + r, row = 64 * hh + 4 * ty + r;
        const float li = res[kLI + row], di = res[kDI + row], ci = oa ? res[kCI + row] : 0.f;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = 4 * tx + e;
          const float ss = sacc[r][e];
          float a1 = acc[i][e];
          if (oa) a1 -= res[kCJ + j];
          // rounded on its own, as the first version's F tile held it
          const float sf = __fmul_rn(expf(ss - li), a1 - di);
          float fv = 0.f;
          if (j < kv) {
            float a2 = acc[i][4 + e];
            if (oa) a2 -= ci;
            fv = sf + expf(ss - res[kLJ + j]) * (a2 - res[kDJ + j]);
          }
          f[(4 * ty + r) * kFLd + j] = fv;
        }
      }
      __syncthreads();
      add_dq(f, qj, ob + i0 + 64 * hh, valid - 64 * hh);
      __syncthreads();
      if (!both) continue;
      // F_JI[j][i] into f[j][i - 64·hh]: the first version's (J, I) tile
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = 4 * hh + r, row = 64 * hh + 4 * ty + r;
        const float li = res[kLI + row], di = res[kDI + row], ci = oa ? res[kCI + row] : 0.f;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = 4 * tx + e;
          const float ss = sacc[r][e];
          float a2 = acc[i][4 + e];
          if (oa) a2 -= ci;
          const float sf = __fmul_rn(expf(ss - res[kLJ + j]), a2 - res[kDJ + j]);
          float fv = 0.f;
          if (row < valid) {
            float a1 = acc[i][e];
            if (oa) a1 -= res[kCJ + j];
            fv = sf + expf(ss - li) * (a1 - di);
          }
          f[j * kFLd + 4 * ty + r] = fv;
        }
      }
      __syncthreads();
      add_dq(f, qi + 64 * hh * kQLd, ob + j0, kv);
      __syncthreads();
    }
  }
};

__global__ void __launch_bounds__(kThreads, 2) dq_kernel(DqJob job, int units) {
  extern __shared__ __align__(128) unsigned char smem[];
  own_units(job, units);
  float* ring = reinterpret_cast<float*>(smem);
  job.res = ring + DqJob::kRing * DqJob::kStageFloats;
  run(job, ring);
}

}  // namespace f32
}  // namespace
}  // namespace sga
