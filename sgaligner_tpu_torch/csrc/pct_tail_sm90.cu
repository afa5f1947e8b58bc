// PCT tail, bf16 forward: the wgmma design of pct_tail (see pct_tail.cu for
// the function; the f32 path and the backward stay there).
//
// Replaces sgaligner_tpu/ops/pct_tail.py::pct_tail_fused (Pallas kernel
// _fwd_kernel, with its optional argmax / argmin outputs) for bf16 inputs.
//   Bound on the H100: operations, 2·P·512·K FLOP per object (7.3 ms at
//   O = 13,440, P = 512, K = 1024). The [O·P, K] product is never written;
//   what the design pays instead is x re-read from L2 once per 128-column
//   slice of K (8 times at K = 1024, about 56 GB a call at that O), which
//   sits close to that bound.
//   Design: persistent blocks, one per SM. Block b owns the 128-column slice
//   n0 = (b % (K/128))·128 and keeps its W columns resident in shared memory
//   (transposed to [128 n, 512 k], K-major, 128 KB, one TMA load). Its two
//   consumer warpgroups each walk their own objects (a fixed assignment, so
//   the sums below are the same from run to run); a producer warp per
//   consumer streams that object's x rows through a 4-stage ring of
//   [64 rows, 64 k] TMA boxes (one per 64-deep quarter of an input).
//   Each 64-row tile is 32 wgmma m64n128k16 into f32 registers, one stage
//   in flight behind the one being started. The epilogue rounds z to bf16
//   into a 16 KB swizzled tile; then thread c of the warpgroup scans column
//   c down the tile's rows (rows past P excluded), so the running max / min
//   (with first indices in the training form), Σz and Σz² of a column live
//   in registers of one thread across all P rows: four chains (rows q,
//   q + 4, ...) for instruction-level parallelism, each in row order, merged
//   at the object's end by the full first-index and NaN rules of beats_max
//   / beats_min. Each warpgroup adds its objects' masked sums in
//   registers and writes them once into its own slice of the scratch;
//   reduce_slices adds the slices in order: no atomics, the same bits twice.
#include "common.cuh"
#include "hopper.cuh"

#include <climits>

namespace sga {
namespace {

using namespace sm90;

constexpr int kN = 128;          // columns of K per block
constexpr int kKin = 512;        // depth: 4 inputs of 128 channels
constexpr int kBoxK = 64;        // k per TMA box (128 bytes of bf16)
constexpr int kSteps = kKin / kBoxK;  // 8 boxes per 64-row tile
constexpr int kTile = 64;        // rows per tile
constexpr int kStages = 4;       // ring depth per consumer
constexpr int kThreads = 384;    // producer warpgroup + 2 consumer warpgroups

constexpr size_t kWBox = (size_t)kN * kBoxK * 2;      // 16 KB
constexpr size_t kXBox = (size_t)kTile * kBoxK * 2;   // 8 KB
constexpr size_t kOffW = 0;
constexpr size_t kOffRing = kOffW + kSteps * kWBox;
constexpr size_t kOffZ = kOffRing + 2 * kStages * kXBox;
constexpr size_t kZTile = (size_t)kTile * kN * 2;     // 16 KB
constexpr size_t kOffBar = kOffZ + 2 * kZTile;
constexpr int kBars = 1 + 4 * kStages;                 // W, full[2][S], empty[2][S]
constexpr size_t kSmem = kOffBar + kBars * 8 + 1024;   // + slack to align the base

using TailRing = Ring<kStages>;

// z (row i) against a chain's running (bv, bi) that holds only earlier
// rows: `better` is z > bv for the max, z < bv for the min. An empty chain
// (bi = INT_MAX) takes any row; a NaN beats any number, never a NaN.
__device__ __forceinline__ bool first_beats(float z, float bv, int bi, bool better) {
  if (bv != bv) return false;
  return z != z || better || bi == INT_MAX;
}

// The z tile [64 rows, 128 cols] bf16 as 64 words a row; word w of row r
// sits at w ^ 4·(r % 8), so the accumulator's stores (8 rows x 4 words a
// warp) and the column scan (32 neighbouring columns of one row) are both
// free of bank conflicts.
__device__ __forceinline__ int z_word(int r, int w) { return r * (kN / 2) + (w ^ ((r & 7) << 2)); }

// w [512, K] -> wt [K, 512] (bf16), 32 x 32 tiles
__global__ void transpose_w_kernel(const bf16* __restrict__ w, bf16* __restrict__ wt, int k) {
  __shared__ bf16 tile[32][33];
  const int k0 = blockIdx.x * 32, n0 = blockIdx.y * 32;  // k0: row of w, n0: column
  for (int r = threadIdx.y; r < 32; r += blockDim.y)
    tile[r][threadIdx.x] = w[(size_t)(k0 + r) * k + n0 + threadIdx.x];
  __syncthreads();
  for (int r = threadIdx.y; r < 32; r += blockDim.y)
    wt[(size_t)(n0 + r) * kKin + k0 + threadIdx.x] = tile[threadIdx.x][r];
}

template <bool kIndex>
__global__ void __launch_bounds__(kThreads, 1)
tail_wgmma_kernel(const __grid_constant__ CUtensorMap xm1, const __grid_constant__ CUtensorMap xm2,
                  const __grid_constant__ CUtensorMap xm3, const __grid_constant__ CUtensorMap xm4,
                  const __grid_constant__ CUtensorMap wm, const bf16* __restrict__ mask,
                  float* __restrict__ pmax, float* __restrict__ pmin, int* __restrict__ amax,
                  int* __restrict__ amin, float* __restrict__ sums, long long slice, int o, int p,
                  int k, int groups) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + kOffBar);
  uint64_t* wbar = bars;
  uint64_t* full = bars + 1;                 // [2][kStages]
  uint64_t* empty = bars + 1 + 2 * kStages;  // [2][kStages]

  const int slices = k / kN;
  const int n0 = (blockIdx.x % slices) * kN, g = blockIdx.x / slices;
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  if (threadIdx.x == 0) {
    mbar_init(wbar, 1);
    for (int i = 0; i < 2 * kStages; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, 4);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // producer: warp 0 loads W and feeds ring 0, warp 1 feeds ring 1
    const int warp = t / 32;
    if (warp >= 2 || t % 32 != 0) return;
    if (warp == 0) {
      mbar_expect_tx(wbar, (uint32_t)(kSteps * kWBox));
      for (int s = 0; s < kSteps; ++s) tma_load_2d(smem + kOffW + s * kWBox, &wm, wbar, s * kBoxK, n0);
    }
    const CUtensorMap* xm[4] = {&xm1, &xm2, &xm3, &xm4};
    uint64_t* f = full + warp * kStages;
    uint64_t* e = empty + warp * kStages;
    unsigned char* ring = smem + kOffRing + warp * kStages * kXBox;
    uint32_t n = 0;
    for (int obj = 2 * g + warp; obj < o; obj += 2 * groups)
      for (int r0 = 0; r0 < p; r0 += kTile)
        for (int s = 0; s < kSteps; ++s, ++n) {
          const int st = TailRing::stage(n);
          mbar_wait(e + st, TailRing::empty_parity(n));
          mbar_expect_tx(f + st, (uint32_t)kXBox);
          tma_load_2d(ring + st * kXBox, xm[s / 2], f + st, (s % 2) * kBoxK, obj * p + r0);
        }
    return;
  }

  // consumer warpgroup c = wg - 1: objects 2g + c, 2g + c + 2·groups, ...
  const int c = wg - 1, warp = t / 32, lane = t % 32;
  uint64_t* f = full + c * kStages;
  uint64_t* e = empty + c * kStages;
  const unsigned char* ring = smem + kOffRing + c * kStages * kXBox;
  uint32_t* zt = reinterpret_cast<uint32_t*>(smem + kOffZ + c * kZTile);
  const bf16* zh = reinterpret_cast<const bf16*>(zt);
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  float u1 = 0.f, u2 = 0.f;  // this warpgroup's masked sums of column n0 + t
  uint32_t n = 0;
  mbar_wait(wbar, 0);

  for (int obj = 2 * g + c; obj < o; obj += 2 * groups) {
    // four independent chains, chain q over rows q, q + 4, ... (in order)
    float mx[4], mn[4], b1[4], b2[4];
    int imx[4], imn[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      mx[q] = -INFINITY, mn[q] = INFINITY, b1[q] = 0.f, b2[q] = 0.f;
      imx[q] = INT_MAX, imn[q] = INT_MAX;
    }
    for (int r0 = 0; r0 < p; r0 += kTile) {
      fence_regs(acc);
#pragma unroll 1
      for (int s = 0; s < kSteps; ++s, ++n) {
        const int st = TailRing::stage(n);
        mbar_wait(f + st, TailRing::full_parity(n));
        wgmma_fence();
        const unsigned char* xa = ring + st * kXBox;
        const unsigned char* wb = smem + kOffW + s * kWBox;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_m64n128k16_ss(acc, desc(xa, kSw128, kk * 32), desc(wb, kSw128, kk * 32),
                              (s | kk) != 0);
        wgmma_commit();
        if (s > 0) {
          wgmma_wait<1>();  // the previous stage's products are done: free it
          if (lane == 0) mbar_arrive(e + TailRing::stage(n - 1));
        }
      }
      wgmma_wait<0>();
      fence_regs(acc);
      if (lane == 0) mbar_arrive(e + TailRing::stage(n - 1));

      // z, rounded, into the tile; then thread t scans column t
      bar_sync(1 + c, 128);  // the previous tile's scan is done
      const int rl = 16 * warp + lane / 4;
#pragma unroll
      for (int i = 0; i < 64; i += 2) {
        const int row = rl + 8 * ((i / 2) % 2);
        zt[z_word(row, 4 * (i / 4) + lane % 4)] = pack_bf16(acc[i], acc[i + 1]);
      }
      bar_sync(1 + c, 128);
      // row r of the tile into chain q = r % 4 (q a constant after unrolling,
      // so the chains stay in registers)
      auto scan = [&](int r, int q) {
        const float z = __bfloat162float(zh[2 * z_word(r, t / 2) + (t & 1)]);
        if constexpr (kIndex) {
          // rows arrive in order within a chain: a later row beats only by
          // a larger value, or as a NaN over a number
          if (first_beats(z, mx[q], imx[q], z > mx[q])) { mx[q] = z; imx[q] = r0 + r; }
          if (first_beats(z, mn[q], imn[q], z < mn[q])) { mn[q] = z; imn[q] = r0 + r; }
        } else {
          mx[q] = fmaxf(mx[q], z);
          mn[q] = fminf(mn[q], z);
        }
        b1[q] += z;
        b2[q] = fmaf(z, z, b2[q]);
      };
      const int valid = min(kTile, p - r0);
      if (valid == kTile) {
#pragma unroll 4
        for (int r = 0; r < kTile; r += 4)
#pragma unroll
          for (int q = 0; q < 4; ++q) scan(r + q, q);
      } else {
        for (int r = 0; r < valid; r += 4)
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (r + q < valid) scan(r + q, q);
      }
    }
    // merge the chains (the full rule: the lower index wins a tie)
#pragma unroll
    for (int q = 1; q < 4; ++q) {
      if constexpr (kIndex) {
        if (beats_max(mx[q], imx[q], mx[0], imx[0])) { mx[0] = mx[q]; imx[0] = imx[q]; }
        if (beats_min(mn[q], imn[q], mn[0], imn[0])) { mn[0] = mn[q]; imn[0] = imn[q]; }
      } else {
        mx[0] = fmaxf(mx[0], mx[q]);
        mn[0] = fminf(mn[0], mn[q]);
      }
    }
    const size_t at = (size_t)obj * k + n0 + t;
    pmax[at] = mx[0];
    pmin[at] = mn[0];
    if constexpr (kIndex) {
      amax[at] = imx[0];
      amin[at] = imn[0];
    }
    const float m = __bfloat162float(mask[obj]);
    u1 += m * (((b1[0] + b1[1]) + b1[2]) + b1[3]);
    u2 += m * (((b2[0] + b2[1]) + b2[2]) + b2[3]);
  }
  float* part = sums + (size_t)(2 * g + c) * slice;
  part[n0 + t] = u1;
  part[k + n0 + t] = u2;
}

}  // namespace

// wt [K, 512] = wᵀ (bf16): the K-major B operand of x·W, which the backward
// (pct_tail_bwd_sm90.cu) keeps resident too
int launch_transpose_w_sm90(const void* w, void* wt, int k, cudaStream_t st) {
  transpose_w_kernel<<<dim3(kKin / 32, k / 32), dim3(32, 8), 0, st>>>((const bf16*)w, (bf16*)wt, k);
  return (int)cudaGetLastError();
}

// bf16 forward of sga_pct_tail. work: the transposed W (512·K bf16), then
// 2·groups slices of `slice` floats (the per-warpgroup sums)
int launch_tail_sm90(const void* x1, const void* x2, const void* x3, const void* x4,
                     const void* w, const void* mask, float* pmax, float* pmin, float* s1,
                     float* s2, int* amax, int* amin, void* work, int groups, int o, int p, int k,
                     cudaStream_t st) {
  bf16* wt = static_cast<bf16*>(work);
  float* sums = reinterpret_cast<float*>(wt + (size_t)kKin * k);
  const long long slice = slice_stride(2LL * k);
  if (int rc = launch_transpose_w_sm90(w, wt, k, st)) return rc;

  CUtensorMap xm[4], wm;
  const void* xs[4] = {x1, x2, x3, x4};
  const uint64_t xdims[2] = {128, (uint64_t)o * p}, xstride[1] = {128 * 2};
  const uint32_t xbox[2] = {kBoxK, kTile};
  for (int i = 0; i < 4; ++i)
    if (int rc = make_map(&xm[i], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, xs[i], xdims, xstride, xbox,
                          CU_TENSOR_MAP_SWIZZLE_128B))
      return rc;
  const uint64_t wdims[2] = {kKin, (uint64_t)k}, wstride[1] = {kKin * 2};
  const uint32_t wbox[2] = {kBoxK, kN};
  if (int rc = make_map(&wm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, wt, wdims, wstride, wbox,
                        CU_TENSOR_MAP_SWIZZLE_128B))
    return rc;

  const unsigned grid = (unsigned)(k / kN) * (unsigned)groups;
  if (amax != nullptr) {
    if (int rc = allow_smem(tail_wgmma_kernel<true>, kSmem)) return rc;
    tail_wgmma_kernel<true><<<grid, kThreads, kSmem, st>>>(
        xm[0], xm[1], xm[2], xm[3], wm, (const bf16*)mask, pmax, pmin, amax, amin, sums, slice, o,
        p, k, groups);
  } else {
    if (int rc = allow_smem(tail_wgmma_kernel<false>, kSmem)) return rc;
    tail_wgmma_kernel<false><<<grid, kThreads, kSmem, st>>>(
        xm[0], xm[1], xm[2], xm[3], wm, (const bf16*)mask, pmax, pmin, nullptr, nullptr, sums,
        slice, o, p, k, groups);
  }
  if (int rc = (int)cudaGetLastError()) return rc;
  if (int rc = reduce_slices(sums, slice, 2 * groups, s1, k, st)) return rc;
  return reduce_slices(sums + k, slice, 2 * groups, s2, k, st);
}

}  // namespace sga
