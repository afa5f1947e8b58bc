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
//   f32 (full f32, no TF32: wgmma has no such form): blocks of 256 threads,
//   block b owning the 128-column slice b % (K/128) and walking objects in
//   a fixed stride. Per object it walks P in 64-row chunks, stages the four
//   [64, 128] input tiles and the matching [128, 128] slices of W in shared
//   memory and accumulates z with f32 FMAs; the epilogue keeps the running
//   max / min (and, in the training form only, a compile-time variant, their
//   indices) and sums of its column in registers, so the pool over P never
//   leaves the block.
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
//   TF32): three launches and a fixed-order sum, no atomics.
//     1. tail_g: the forward's blocks again, (object, 128-column slice);
//        its epilogue builds g2 and writes it to a [O·P, K] buffer (a round
//        trip through device memory that the TPU kernel kept in VMEM: 2
//        bytes per element in bf16, read twice below);
//     2. tail_dx: a tiled product over 64-row tiles of the flat [O·P, K]
//        g2, one block per (row tile, input i), walking K in 128-column
//        chunks with Wᵢ's matching [128, 128] slice staged;
//     3. tail_dw: one block per (input i, 128-column slice of K, row split),
//        the [128, 128] accumulator in shared memory over its rows
//        (transposed-A block_gemm), then one slice of the scratch per row
//        split; reduce_slices adds the splits in order. A block that owned
//        a whole [512, 128] column slice would need 256 KB of accumulator,
//        more than a block's shared memory.
#include "common.cuh"

#include <climits>

namespace sga {
namespace {

constexpr int kC = 128;       // width of each SA output
constexpr int kN = 128;       // columns of K per block
constexpr int kRows = 64;     // points per chunk
constexpr int kThreads = 256;  // 2 row lanes x 128 columns

template <typename T>
struct TailSmem {
  static constexpr int lda = pad_ld<T>(kC), ldb = pad_ld<T>(kN), ldc = pad_ldf(kN);
  static constexpr size_t a_off = 0;
  static constexpr size_t b_off = align128(a_off + sizeof(T) * kRows * lda);
  static constexpr size_t c_off = align128(b_off + sizeof(T) * kC * ldb);
  static constexpr size_t bytes = align128(c_off + sizeof(float) * kRows * ldc);
};

// sc[r, n] = Σᵢ xᵢ[obj, r0 + r, :]·Wᵢ[:, n0 + n] for the 64-row chunk at r0
// (rows >= valid from zero inputs), f32.
template <typename T>
__device__ __forceinline__ void z_chunk(const T* const (&xs)[4], const T* __restrict__ w, T* sa, T* sb, float* sc,
                        int obj, int p, int k, int n0, int r0, int valid) {
  using L = TailSmem<T>;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    load_tile<T>(sa, L::lda, xs[i] + ((size_t)obj * p + r0) * kC, kC, kRows, kC, valid);
    load_tile<T>(sb, L::ldb, w + (size_t)i * kC * k + n0, k, kC, kN, kC);
    __syncthreads();
    block_gemm<T, false>(sa, L::lda, sb, L::ldb, sc, L::ldc, kRows, kN, kC, i > 0);
    __syncthreads();
  }
}

// The f32 forward (bf16 runs pct_tail_sm90.cu). Block b owns the column
// slice (b % (K/128)) and walks objects g, g + groups, ... with
// g = b / (K/128). kIndex: also keep the first index of each max / min (the
// training forward); without it the running max / min is a plain fmaxf /
// fminf. Each block adds its objects' masked sums in registers and writes
// them into its slice g of `sums` (Σz at [0, K), Σz² at [K, 2K)).
template <bool kIndex>
__global__ void __launch_bounds__(kThreads)
pct_tail_kernel(const float* __restrict__ x1, const float* __restrict__ x2,
                const float* __restrict__ x3, const float* __restrict__ x4,
                const float* __restrict__ w, const float* __restrict__ mask,
                float* __restrict__ pmax, float* __restrict__ pmin, float* __restrict__ sums,
                long long slice, int* __restrict__ amax, int* __restrict__ amin, int o, int p,
                int k, int groups) {
  using L = TailSmem<float>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* sa = reinterpret_cast<float*>(smem + L::a_off);
  float* sb = reinterpret_cast<float*>(smem + L::b_off);
  float* sc = reinterpret_cast<float*>(smem + L::c_off);
  __shared__ float red[4][2][kN];
  __shared__ int ridx[2][2][kN];

  const int slices = k / kN;
  const int n0 = (blockIdx.x % slices) * kN, g = blockIdx.x / slices;
  const int c = threadIdx.x % kN, half = threadIdx.x / kN;
  const float* const xs[4] = {x1, x2, x3, x4};
  float u1 = 0.f, u2 = 0.f;  // half 0: the block's masked sums of column n0 + c

  for (int obj = g; obj < o; obj += groups) {
    float mx = -INFINITY, mn = INFINITY, b1 = 0.f, b2 = 0.f;
    int imx = INT_MAX, imn = INT_MAX;
    for (int r0 = 0; r0 < p; r0 += kRows) {
      const int valid = min(kRows, p - r0);
      z_chunk<float>(xs, w, sa, sb, sc, obj, p, k, n0, r0, valid);
      for (int r = half; r < valid; r += 2) {
        const float z = sc[r * L::ldc + c];
        if constexpr (kIndex) {
          if (beats_max(z, r0 + r, mx, imx)) { mx = z; imx = r0 + r; }
          if (beats_min(z, r0 + r, mn, imn)) { mn = z; imn = r0 + r; }
        } else {
          mx = fmaxf(mx, z);
          mn = fminf(mn, z);
        }
        b1 += z;
        b2 += z * z;
      }
    }
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
      const size_t out = (size_t)obj * k + n0 + c;
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
    __syncthreads();
  }
  if (half == 0) {
    sums[(size_t)g * slice + n0 + c] = u1;
    sums[(size_t)g * slice + k + n0 + c] = u2;
  }
}

// ------------------------------- backward ----------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
tail_g_kernel(const T* __restrict__ x1, const T* __restrict__ x2, const T* __restrict__ x3,
              const T* __restrict__ x4, const T* __restrict__ w, const T* __restrict__ mask,
              const float* __restrict__ dpmax, const float* __restrict__ dpmin,
              const float* __restrict__ dsum, const float* __restrict__ dsumsq,
              const int* __restrict__ amax, const int* __restrict__ amin, T* __restrict__ g,
              int o, int p, int k) {
  using L = TailSmem<T>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sa = reinterpret_cast<T*>(smem + L::a_off);
  T* sb = reinterpret_cast<T*>(smem + L::b_off);
  float* sc = reinterpret_cast<float*>(smem + L::c_off);

  const int slices = k / kN;
  const int n0 = (blockIdx.x % slices) * kN, obj = blockIdx.x / slices;
  const int c = threadIdx.x % kN, half = threadIdx.x / kN;
  const T* const xs[4] = {x1, x2, x3, x4};
  const size_t oc = (size_t)obj * k + n0 + c;
  const int imx = amax[oc], imn = amin[oc];
  const float gmx = dpmax[oc], gmn = dpmin[oc];
  const float m = to_f<T>(mask[obj]);
  const float a1 = m * dsum[n0 + c], a2 = m * dsumsq[n0 + c];

  for (int r0 = 0; r0 < p; r0 += kRows) {
    const int valid = min(kRows, p - r0);
    z_chunk<T>(xs, w, sa, sb, sc, obj, p, k, n0, r0, valid);
    for (int r = half; r < valid; r += 2) {
      const float z = round_to<T>(sc[r * L::ldc + c]);
      const int pt = r0 + r;
      float gv = (pt == imx ? gmx : 0.f) + (pt == imn ? gmn : 0.f);
      gv += a1 + 2.f * z * a2;
      g[((size_t)obj * p + pt) * k + n0 + c] = from_f<T>(gv);
    }
  }
}

template <typename T>
struct DxSmem {
  static constexpr int ldg = pad_ld<T>(kN), ldw = pad_ld<T>(kN), ldc = pad_ldf(kC);
  static constexpr size_t g_off = 0;
  static constexpr size_t w_off = align128(g_off + sizeof(T) * kRows * ldg);
  static constexpr size_t c_off = align128(w_off + sizeof(T) * kC * ldw);
  static constexpr size_t bytes = align128(c_off + sizeof(float) * kRows * ldc);
};

// dxᵢ[r, :] = g2[r, :]·Wᵢᵀ for 64-row tiles of the flat [O·P, K] g2
template <typename T>
__global__ void __launch_bounds__(kThreads)
tail_dx_kernel(const T* __restrict__ g, const T* __restrict__ w, T* __restrict__ dx1,
               T* __restrict__ dx2, T* __restrict__ dx3, T* __restrict__ dx4, long long rows,
               int k) {
  using L = DxSmem<T>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sg = reinterpret_cast<T*>(smem + L::g_off);
  T* sw = reinterpret_cast<T*>(smem + L::w_off);
  float* sc = reinterpret_cast<float*>(smem + L::c_off);
  T* const dxs[4] = {dx1, dx2, dx3, dx4};

  const long long tiles = (rows + kRows - 1) / kRows;
  for (long long t = blockIdx.x; t < tiles * 4; t += gridDim.x) {
    const int i = (int)(t % 4);
    const long long row0 = (t / 4) * kRows;
    const int valid = (int)min((long long)kRows, rows - row0);
    for (int k0 = 0; k0 < k; k0 += kN) {
      load_tile<T>(sg, L::ldg, g + row0 * k + k0, k, kRows, kN, valid);
      // Wᵢ[:, k0:k0+128] is the transposed operand: [128 (c) x 128 (k)]
      load_tile<T>(sw, L::ldw, w + (size_t)i * kC * k + k0, k, kC, kN, kC);
      __syncthreads();
      block_gemm<T, true>(sg, L::ldg, sw, L::ldw, sc, L::ldc, kRows, kC, kN, k0 > 0);
      __syncthreads();
    }
    T* out = dxs[i] + row0 * kC;
    for (int idx = threadIdx.x; idx < valid * kC; idx += blockDim.x)
      out[idx] = from_f<T>(sc[(idx / kC) * L::ldc + idx % kC]);
    __syncthreads();
  }
}

template <typename T>
struct DwSmem {
  static constexpr int ldx = pad_ld<T>(kC), ldg = pad_ld<T>(kN), ldc = pad_ldf(kN);
  static constexpr size_t x_off = 0;
  static constexpr size_t g_off = align128(x_off + sizeof(T) * kRows * ldx);
  static constexpr size_t c_off = align128(g_off + sizeof(T) * kRows * ldg);
  static constexpr size_t bytes = align128(c_off + sizeof(float) * kC * ldc);
};

// block (i, column slice n, row split r): Σ over its rows of xᵢᵀ·g2[:, n]
// into scratch slice r at dW[i·128.., n·128..]
template <typename T>
__global__ void __launch_bounds__(kThreads)
tail_dw_kernel(const T* __restrict__ x1, const T* __restrict__ x2, const T* __restrict__ x3,
               const T* __restrict__ x4, const T* __restrict__ g, float* __restrict__ scratch,
               long long rows, long long rows_per_split, int k) {
  using L = DwSmem<T>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sx = reinterpret_cast<T*>(smem + L::x_off);
  T* sg = reinterpret_cast<T*>(smem + L::g_off);
  float* sc = reinterpret_cast<float*>(smem + L::c_off);
  const T* const xs[4] = {x1, x2, x3, x4};

  const int slices = k / kN;
  const int i = blockIdx.x % 4, n0 = ((blockIdx.x / 4) % slices) * kN;
  const int split = blockIdx.x / (4 * slices);
  const long long lo = split * rows_per_split;
  const long long hi = min(rows, lo + rows_per_split);
  for (int idx = threadIdx.x; idx < kC * kN; idx += blockDim.x)
    sc[(idx / kN) * L::ldc + idx % kN] = 0.f;
  for (long long row0 = lo; row0 < hi; row0 += kRows) {
    const int valid = (int)min((long long)kRows, hi - row0);
    load_tile<T>(sx, L::ldx, xs[i] + row0 * kC, kC, kRows, kC, valid);
    load_tile<T>(sg, L::ldg, g + row0 * k + n0, k, kRows, kN, valid);
    __syncthreads();
    block_gemm<T, false, true>(sx, L::ldx, sg, L::ldg, sc, L::ldc, kC, kN, kRows, true);
    __syncthreads();
  }
  __syncthreads();
  float* out = scratch + (size_t)split * 4 * kC * k + (size_t)i * kC * k + n0;
  for (int idx = threadIdx.x; idx < kC * kN; idx += blockDim.x)
    out[(size_t)(idx / kN) * k + idx % kN] = sc[(idx / kN) * L::ldc + idx % kN];
}

// f32 forward; work: `groups` slices of slice_stride(2K) floats
int launch_tail_f32(const void* x1, const void* x2, const void* x3, const void* x4,
                    const void* w, const void* mask, float* pmax, float* pmin, float* s1,
                    float* s2, int* amax, int* amin, float* work, int groups, int o, int p, int k,
                    cudaStream_t st) {
  const size_t smem = TailSmem<float>::bytes;
  const unsigned grid = (unsigned)(k / kN) * (unsigned)groups;
  const long long slice = slice_stride(2LL * k);
  auto kernel = amax != nullptr ? pct_tail_kernel<true> : pct_tail_kernel<false>;
  if (int rc = allow_smem(kernel, smem)) return rc;
  kernel<<<grid, kThreads, smem, st>>>((const float*)x1, (const float*)x2, (const float*)x3,
                                       (const float*)x4, (const float*)w, (const float*)mask,
                                       pmax, pmin, work, slice, amax, amin, o, p, k, groups);
  if (int rc = (int)cudaGetLastError()) return rc;
  if (int rc = reduce_slices(work, slice, groups, s1, k, st)) return rc;
  return reduce_slices(work + k, slice, groups, s2, k, st);
}

template <typename T>
int launch_tail_bwd(const void* x1, const void* x2, const void* x3, const void* x4,
                    const void* w, const void* mask, const float* dpmax, const float* dpmin,
                    const float* dsum, const float* dsumsq, const int* amax, const int* amin,
                    void* g, void* dx1, void* dx2, void* dx3, void* dx4, float* scratch,
                    int splits, float* dw, int o, int p, int k, cudaStream_t st) {
  const size_t s1 = TailSmem<T>::bytes;
  if (int rc = allow_smem(tail_g_kernel<T>, s1)) return rc;
  tail_g_kernel<T><<<(unsigned)(k / kN) * (unsigned)o, kThreads, s1, st>>>(
      (const T*)x1, (const T*)x2, (const T*)x3, (const T*)x4, (const T*)w, (const T*)mask, dpmax,
      dpmin, dsum, dsumsq, amax, amin, (T*)g, o, p, k);
  if (int rc = (int)cudaGetLastError()) return rc;

  const long long rows = (long long)o * p;
  const size_t s2 = DxSmem<T>::bytes;
  if (int rc = allow_smem(tail_dx_kernel<T>, s2)) return rc;
  const int g2 = resident_grid(tail_dx_kernel<T>, kThreads, s2, ((rows + kRows - 1) / kRows) * 4);
  tail_dx_kernel<T><<<g2, kThreads, s2, st>>>((const T*)g, (const T*)w, (T*)dx1, (T*)dx2,
                                              (T*)dx3, (T*)dx4, rows, k);
  if (int rc = (int)cudaGetLastError()) return rc;

  const size_t s3 = DwSmem<T>::bytes;
  if (int rc = allow_smem(tail_dw_kernel<T>, s3)) return rc;
  long long per = (rows + splits - 1) / splits;
  per = (per + kRows - 1) / kRows * kRows;
  tail_dw_kernel<T><<<4 * (k / kN) * splits, kThreads, s3, st>>>(
      (const T*)x1, (const T*)x2, (const T*)x3, (const T*)x4, (const T*)g, scratch, rows, per, k);
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
  return sga::launch_tail_bwd<float>(x1, x2, x3, x4, w, mask, dpmax, dpmin, dsum, dsumsq, amax,
                                     amin, g, dx1, dx2, dx3, dx4, scratch, splits, dw, o, p, k,
                                     st);
}

}  // extern "C"
