// PCT tail, forward: concat(4 SA outputs) -> 1024-wide projection -> pool.
//
// Replaces sgaligner_tpu/ops/pct_tail.py::pct_tail_fused (Pallas kernel
// _fwd_kernel, without its optional argmax/argmin outputs). For x1..x4
// [O, P, 128] and W [512, K]:
//   z = Σᵢ xᵢ·Wᵢ (f32 accumulation), rounded to the compute dtype;
//   pmax, pmin [O, K] f32: per-object, per-channel max / min of z over P;
//   ssum, ssumsq [1, K] f32: masked Σz, Σz² over every (object, point).
// The [O, P, K] activation never reaches device memory.
//   Bound on the H100: operations. 2·P·512·K FLOP per object (0.54 GFLOP at
//   P = 512, K = 1024) against 4·P·128 inputs read once.
//   Design: one block per (object, 128-column slice of K). It walks P in
//   64-row chunks; for each chunk it stages the four [64, 128] input tiles
//   and the matching [128, 128] slices of W in shared memory and accumulates
//   z on the tensor cores (bf16 WMMA, f32 accumulators) or with f32 FMAs.
//   The epilogue rounds z, then keeps the running max / min / sums of its
//   column in registers, so the max over P never leaves the block; the BN
//   sums cross blocks through one f32 atomicAdd per column. The block index
//   runs over column slices fastest, so the K/128 blocks of one object run
//   together and read its inputs from L2 after the first (one flat grid of
//   O·K/128 blocks, so O is not bound by the 65535 limit of grid.y).
#include "common.cuh"

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
pct_tail_kernel(const T* __restrict__ x1, const T* __restrict__ x2, const T* __restrict__ x3,
                const T* __restrict__ x4, const T* __restrict__ w, const T* __restrict__ mask,
                float* __restrict__ pmax, float* __restrict__ pmin, float* s1, float* s2, int o,
                int p, int k) {
  using L = TailSmem<T>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sa = reinterpret_cast<T*>(smem + L::a_off);
  T* sb = reinterpret_cast<T*>(smem + L::b_off);
  float* sc = reinterpret_cast<float*>(smem + L::c_off);
  __shared__ float red[4][2][kN];

  const int slices = k / kN;
  const int n0 = (blockIdx.x % slices) * kN, obj = blockIdx.x / slices;
  const int c = threadIdx.x % kN, half = threadIdx.x / kN;
  const T* xs[4] = {x1, x2, x3, x4};
  float mx = -INFINITY, mn = INFINITY, b1 = 0.f, b2 = 0.f;

  for (int r0 = 0; r0 < p; r0 += kRows) {
    const int valid = min(kRows, p - r0);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      load_tile<T>(sa, L::lda, xs[i] + ((size_t)obj * p + r0) * kC, kC, kRows, kC, valid);
      load_tile<T>(sb, L::ldb, w + (size_t)i * kC * k + n0, k, kC, kN, kC);
      __syncthreads();
      block_gemm<T, false>(sa, L::lda, sb, L::ldb, sc, L::ldc, kRows, kN, kC, i > 0);
      __syncthreads();
    }
    for (int r = half; r < valid; r += 2) {
      const float z = round_to<T>(sc[r * L::ldc + c]);
      mx = fmaxf(mx, z);
      mn = fminf(mn, z);
      b1 += z;
      b2 += z * z;
    }
  }
  red[0][half][c] = mx;
  red[1][half][c] = mn;
  red[2][half][c] = b1;
  red[3][half][c] = b2;
  __syncthreads();
  if (half == 0) {
    const size_t out = (size_t)obj * k + n0 + c;
    pmax[out] = fmaxf(red[0][0][c], red[0][1][c]);
    pmin[out] = fminf(red[1][0][c], red[1][1][c]);
    const float m = to_f<T>(mask[obj]);
    atomicAdd(&s1[n0 + c], m * (red[2][0][c] + red[2][1][c]));
    atomicAdd(&s2[n0 + c], m * (red[3][0][c] + red[3][1][c]));
  }
}

template <typename T>
int launch_tail(const void* x1, const void* x2, const void* x3, const void* x4, const void* w,
                const void* mask, float* pmax, float* pmin, float* s1, float* s2, int o, int p,
                int k, cudaStream_t st) {
  const size_t smem = TailSmem<T>::bytes;
  cudaFuncSetAttribute(pct_tail_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  const unsigned grid = (unsigned)(k / kN) * (unsigned)o;
  pct_tail_kernel<T><<<grid, kThreads, smem, st>>>(
      (const T*)x1, (const T*)x2, (const T*)x3, (const T*)x4, (const T*)w, (const T*)mask, pmax,
      pmin, s1, s2, o, p, k);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace sga

extern "C" int sga_pct_tail(const void* x1, const void* x2, const void* x3, const void* x4,
                            const void* w, const void* mask, float* pmax, float* pmin, float* s1,
                            float* s2, int o, int p, int k, int dtype, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == sga::kBF16)
    return sga::launch_tail<sga::bf16>(x1, x2, x3, x4, w, mask, pmax, pmin, s1, s2, o, p, k, st);
  return sga::launch_tail<float>(x1, x2, x3, x4, w, mask, pmax, pmin, s1, s2, o, p, k, st);
}
