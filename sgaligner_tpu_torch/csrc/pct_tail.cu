// PCT tail: concat(4 SA outputs) -> 1024-wide projection -> pool, and its
// backward.
//
// pct_tail replaces sgaligner_tpu/ops/pct_tail.py::pct_tail_fused (Pallas
// kernel _fwd_kernel, with its optional argmax/argmin outputs). For x1..x4
// [O, P, 128] and W [512, K]:
//   z = Σᵢ xᵢ·Wᵢ (f32 accumulation), rounded to the compute dtype;
//   pmax, pmin [O, K] f32: per-object, per-channel max / min of z over P;
//   ssum, ssumsq [1, K] f32: masked Σz, Σz² over every (object, point);
//   with the training flag also amax, amin [O, K] int32: the first point
//   index of each max / min (jnp.argmax semantics; a NaN wins, the first
//   one first).
// The [O, P, K] activation never reaches device memory.
//   Bound on the H100: operations. 2·P·512·K FLOP per object (0.54 GFLOP at
//   P = 512, K = 1024) against 4·P·128 inputs read once.
//   bf16: the wgmma design in pct_tail_sm90.cu (W resident, a TMA ring
//   for x, accumulators in registers, the pool in the epilogue).
//   f32 (full f32, no TF32: wgmma has no such form): the register-tiled
//   mainloop of tail_f32.cuh (128 x 128 block tiles, 8 x 8 outputs a
//   thread in registers across the whole 512-deep sum, a 3-stage cp.async
//   ring of 16-deep k-steps). Block b owns the 128-column slice b % (K/128)
//   and walks objects g, g + groups, ... (g = b / (K/128)), each object's
//   128-row tiles in turn; z is one fmaf chain a value over x1's channels,
//   then x2's, x3's and x4's, in order. The epilogue passes each tile's z
//   through the ring stage just freed, 32 rows at a time, to a thread per
//   (column, row parity) that pools and sums its rows in order, carried
//   over the object's tiles, as the first version did: the pool, its
//   indices and the BN sums keep the first version's bits. Rows past a
//   ragged P enter neither the pool nor the sums.
//   Both dtypes: each block (bf16: each consumer warpgroup) adds its
//   objects' masked sums in registers and writes them once into its own
//   slice of a scratch buffer; reduce_slices adds the slices in order. No
//   atomics: the same bits from run to run, in both forms.
//
// pct_tail_bwd replaces ops/pct_tail.py::_bwd_rule with the forward-saved
// indices (Pallas kernel _bwd_kernel_idx). With cotangents dpmax, dpmin
// [O, K] and dsum, dsumsq [1, K] (f32) and the forward's amax, amin:
//   g[p, k] = dpmax·[p = amax] + dpmin·[p = amin] + m·dsum + 2·z·m·dsumsq
//   (f32, z recomputed and rounded as in the forward), g2 = g rounded;
//   dxᵢ = g2·Wᵢᵀ (rounded), dW [512, K] = Σ xᵢᵀ·g2 (f32).
// The BN term reaches every point, so the backward is dense: it recomputes
// all of z, and only the pool term is sparse.
//   Bound on the H100: operations, 3 x 2·P·512·K per object (recompute z,
//   the dx product, the dW product): 1.6 GFLOP per object.
//   bf16: the wgmma design in pct_tail_bwd_sm90.cu. f32 (full f32, no
//   TF32): three launches of tail_f32.cuh's mainloop and a fixed-order sum,
//   no atomics.
//     1. tail_g: the forward's product over (object, row tile, column
//        slice) tiles; its epilogue builds g and writes it to an [O·P, K]
//        buffer (a round trip through device memory that the TPU kernel
//        kept in VMEM, read twice below);
//     2. tail_dx: dX = g·Wᵀ over 128-row tiles of the flat [O·P, K] g and
//        the four 128-column slices of dX (one per dxᵢ), K deep;
//     3. tail_dw: dW = Σ xᵀ·g, one block per (input i, 128-column slice of
//        K, row split), its [128, 128] sum in registers over its rows, then
//        one slice of the scratch per row split; reduce_slices adds the
//        splits in order.
#include "tail_f32.cuh"

#include <algorithm>
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
      // rows 32·q .. 32·q + 31: registers 4·(q/2) .. +3 of threads ty = 8·(q%2) .. +7
      if (ty / 8 == q % 2) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * (q / 2) + e, row = 4 * (ty % 8) + e;
#pragma unroll
          for (int h = 0; h < 2; ++h)
            store4<float>(spare + row * kLd + 64 * h + 4 * tx, acc[i][4 * h],
                          acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]);
        }
      }
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

// The f32 forward (bf16 runs pct_tail_sm90.cu). kIndex: also keep the
// first index of each max / min (the training forward); without it the
// running max / min is a plain fmaxf / fminf. Each block writes its masked
// sums into its slice g of `sums` (Σz at [0, K), Σz² at [K, 2K)).
template <bool kIndex>
__global__ void __launch_bounds__(kThreads, 2)
pct_tail_kernel(const float* __restrict__ x1, const float* __restrict__ x2,
                const float* __restrict__ x3, const float* __restrict__ x4,
                const float* __restrict__ w, const float* __restrict__ mask,
                float* __restrict__ pmax, float* __restrict__ pmin, float* __restrict__ sums,
                long long slice, int* __restrict__ amax, int* __restrict__ amin, int o, int p,
                int k, int groups) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float red[4][2][kTile];
  __shared__ int ridx[2][2][kTile];
  const int slices = k / kTile;
  const int g = blockIdx.x / slices;
  TailFwd<kIndex> job{{x1, x2, x3, x4, w, p, k, (int)(blockIdx.x % slices) * kTile},
                      mask, pmax, pmin, amax, amin, red, ridx, g, groups,
                      max(1, (p + kTile - 1) / kTile), (o - g + groups - 1) / groups};
  run(job, reinterpret_cast<float*>(smem));
  if (threadIdx.x < kTile) {
    sums[(size_t)g * slice + job.z.n0 + threadIdx.x] = job.u1;
    sums[(size_t)g * slice + k + job.z.n0 + threadIdx.x] = job.u2;
  }
}

// ------------------------------- backward ----------------------------------

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

__global__ void __launch_bounds__(kThreads, 2)
tail_g_kernel(const float* __restrict__ x1, const float* __restrict__ x2,
              const float* __restrict__ x3, const float* __restrict__ x4,
              const float* __restrict__ w, const float* __restrict__ mask,
              const float* __restrict__ dpmax, const float* __restrict__ dpmin,
              const float* __restrict__ dsum, const float* __restrict__ dsumsq,
              const int* __restrict__ amax, const int* __restrict__ amin, float* __restrict__ g,
              int o, int p, int k, int groups) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int slices = k / kTile, grp = blockIdx.x / slices;
  const int rtiles = max(1, (p + kTile - 1) / kTile), units = o * rtiles;
  TailG job{{x1, x2, x3, x4, w, p, k, (int)(blockIdx.x % slices) * kTile},
            mask, dpmax, dpmin, dsum, dsumsq, amax, amin, g, grp, groups, rtiles,
            (units - grp + groups - 1) / groups};
  run(job, reinterpret_cast<float*>(smem));
}

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

__global__ void __launch_bounds__(kThreads, 2)
tail_dx_kernel(const float* __restrict__ g, const float* __restrict__ w, float* __restrict__ dx1,
               float* __restrict__ dx2, float* __restrict__ dx3, float* __restrict__ dx4,
               long long rows, int k, int groups) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ct = blockIdx.x % 4, grp = blockIdx.x / 4;
  const long long rtiles = (rows + kTile - 1) / kTile;
  TailDx job{g, w, ct == 0 ? dx1 : ct == 1 ? dx2 : ct == 2 ? dx3 : dx4, rows, k, ct, grp, groups,
             (int)((rtiles - grp + groups - 1) / groups)};
  run(job, reinterpret_cast<float*>(smem));
}

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

__global__ void __launch_bounds__(kThreads, 2)
tail_dw_kernel(const float* __restrict__ x1, const float* __restrict__ x2,
               const float* __restrict__ x3, const float* __restrict__ x4,
               const float* __restrict__ g, float* __restrict__ scratch, long long rows,
               long long rows_per_split, int k) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int slices = k / kTile;
  const int i = blockIdx.x % 4, n0 = ((blockIdx.x / 4) % slices) * kTile;
  const int split = blockIdx.x / (4 * slices);
  const long long lo = split * rows_per_split;
  TailDw job{input(x1, x2, x3, x4, i), g,
             scratch + (size_t)split * 4 * kC * k + (size_t)i * kC * k + n0,
             lo, min(rows, lo + rows_per_split), k, n0};
  if (job.steps() > 0) {
    run(job, reinterpret_cast<float*>(smem));
  } else {  // a split past the last row: its slice is zero
    const float zero[8][8] = {};
    job.epilogue(0, zero, nullptr);
  }
}

// f32 forward; work: `groups` slices of slice_stride(2K) floats
int launch_tail_f32(const void* x1, const void* x2, const void* x3, const void* x4,
                    const void* w, const void* mask, float* pmax, float* pmin, float* s1,
                    float* s2, int* amax, int* amin, float* work, int groups, int o, int p, int k,
                    cudaStream_t st) {
  const unsigned grid = (unsigned)(k / kTile) * (unsigned)groups;
  const long long slice = slice_stride(2LL * k);
  auto kernel = amax != nullptr ? pct_tail_kernel<true> : pct_tail_kernel<false>;
  if (int rc = allow_smem(kernel, kRingBytes)) return rc;
  kernel<<<grid, kThreads, kRingBytes, st>>>((const float*)x1, (const float*)x2,
                                             (const float*)x3, (const float*)x4, (const float*)w,
                                             (const float*)mask, pmax, pmin, work, slice, amax,
                                             amin, o, p, k, groups);
  if (int rc = (int)cudaGetLastError()) return rc;
  if (int rc = reduce_slices(work, slice, groups, s1, k, st)) return rc;
  return reduce_slices(work + k, slice, groups, s2, k, st);
}

// f32 backward: the g and dx passes on as many blocks as stay resident,
// the dW pass on the wrapper's row splits, then the splits' sum
int launch_tail_bwd_f32(const void* x1, const void* x2, const void* x3, const void* x4,
                        const void* w, const void* mask, const float* dpmax,
                        const float* dpmin, const float* dsum, const float* dsumsq,
                        const int* amax, const int* amin, void* g, void* dx1, void* dx2,
                        void* dx3, void* dx4, float* scratch, int splits, float* dw, int o,
                        int p, int k, cudaStream_t st) {
  const int slices = k / kTile;
  const long long rows = (long long)o * p;
  const int rtiles = std::max(1, (p + kTile - 1) / kTile);
  const float *fx1 = (const float*)x1, *fx2 = (const float*)x2, *fx3 = (const float*)x3,
              *fx4 = (const float*)x4, *fw = (const float*)w;

  if (int rc = allow_smem(tail_g_kernel, kRingBytes)) return rc;
  const int g_groups = std::max(
      1, resident_grid(tail_g_kernel, kThreads, kRingBytes, (long long)slices * o * rtiles) / slices);
  tail_g_kernel<<<(unsigned)(slices * g_groups), kThreads, kRingBytes, st>>>(
      fx1, fx2, fx3, fx4, fw, (const float*)mask, dpmax, dpmin, dsum, dsumsq, amax, amin,
      (float*)g, o, p, k, g_groups);
  if (int rc = (int)cudaGetLastError()) return rc;

  if (int rc = allow_smem(tail_dx_kernel, kRingBytes)) return rc;
  const int dx_groups = std::max(
      1, resident_grid(tail_dx_kernel, kThreads, kRingBytes, 4 * ((rows + kTile - 1) / kTile)) / 4);
  tail_dx_kernel<<<(unsigned)(4 * dx_groups), kThreads, kRingBytes, st>>>(
      (const float*)g, fw, (float*)dx1, (float*)dx2, (float*)dx3, (float*)dx4, rows, k,
      dx_groups);
  if (int rc = (int)cudaGetLastError()) return rc;

  if (int rc = allow_smem(tail_dw_kernel, kRingBytes)) return rc;
  // rows a split, rounded up to 64 as the first version's were: the same
  // split boundaries give dW the same bits (a multiple of kBK)
  long long per = (rows + splits - 1) / splits;
  per = (per + 63) / 64 * 64;
  tail_dw_kernel<<<(unsigned)(4 * slices * splits), kThreads, kRingBytes, st>>>(
      fx1, fx2, fx3, fx4, (const float*)g, scratch, rows, per, k);
  if (int rc = (int)cudaGetLastError()) return rc;
  return reduce_slices(scratch, (long long)4 * kC * k, splits, dw, 4 * kC * k, st);
}

}  // namespace

int launch_tail_sm90(const void* x1, const void* x2, const void* x3, const void* x4,
                     const void* w, const void* mask, float* pmax, float* pmin, float* s1,
                     float* s2, int* amax, int* amin, void* work, int groups, int o, int p, int k,
                     cudaStream_t st);
int launch_tail_bwd_sm90(const void* x1, const void* x2, const void* x3, const void* x4,
                         const void* w, const void* mask, const float* dpmax, const float* dpmin,
                         const float* dsum, const float* dsumsq, const int* amax, const int* amin,
                         void* g, void* wt, void* dx1, void* dx2, void* dx3, void* dx4,
                         float* scratch, int splits, float* dw, int o, int p, int k,
                         cudaStream_t st);

}  // namespace sga

extern "C" {

// amax / amin may be null (the serving forward does not ask for them).
// work: `groups` blocks per column slice each keep their masked sums in a
// slice of it (f32: `groups` slices of slice_stride(2K) floats; bf16: the
// transposed W, 512·K bf16, then 2·groups slices)
int sga_pct_tail(const void* x1, const void* x2, const void* x3, const void* x4, const void* w,
                 const void* mask, float* pmax, float* pmin, float* s1, float* s2, int* amax,
                 int* amin, void* work, int groups, int o, int p, int k, int dtype,
                 void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == sga::kBF16)
    return sga::launch_tail_sm90(x1, x2, x3, x4, w, mask, pmax, pmin, s1, s2, amax, amin, work,
                                 groups, o, p, k, st);
  return sga::launch_tail_f32(x1, x2, x3, x4, w, mask, pmax, pmin, s1, s2, amax, amin,
                              static_cast<float*>(work), groups, o, p, k, st);
}

// g: [O·P, K] work buffer in the compute dtype; wt: bf16 only, [K, 512]
// (the transposed W); scratch: `splits` slices of 512·K floats; dw [512, K]
// f32. bf16 runs the wgmma design of pct_tail_bwd_sm90.cu
int sga_pct_tail_bwd(const void* x1, const void* x2, const void* x3, const void* x4,
                     const void* w, const void* mask, const float* dpmax, const float* dpmin,
                     const float* dsum, const float* dsumsq, const int* amax, const int* amin,
                     void* g, void* wt, void* dx1, void* dx2, void* dx3, void* dx4,
                     float* scratch, int splits, float* dw, int o, int p, int k, int dtype,
                     void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == sga::kBF16)
    return sga::launch_tail_bwd_sm90(x1, x2, x3, x4, w, mask, dpmax, dpmin, dsum, dsumsq, amax,
                                     amin, g, wt, dx1, dx2, dx3, dx4, scratch, splits, dw, o, p,
                                     k, st);
  return sga::launch_tail_bwd_f32(x1, x2, x3, x4, w, mask, dpmax, dpmin, dsum, dsumsq, amax,
                                  amin, g, dx1, dx2, dx3, dx4, scratch, splits, dw, o, p, k, st);
}

}  // extern "C"
