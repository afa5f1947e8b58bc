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
#include "tail_jobs.cuh"

#include <algorithm>

namespace sga {
namespace {

using namespace tail_f32;

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
