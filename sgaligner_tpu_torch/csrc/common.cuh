// Shared device helpers for the port's kernels (sm_90a).
//
// Every kernel here keeps its operand tiles in shared memory and multiplies
// them with `block_gemm`: bf16 tiles go through the tensor cores as WMMA
// 16x16x16 fragments with f32 accumulators; f32 tiles take a plain FMA loop,
// so an f32 call computes in full f32 (no TF32), like torch's f32 matmul with
// allow_tf32=False. Accumulators always land in shared memory as f32, and the
// kernels' epilogues read them from there.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

namespace sga {

using bf16 = __nv_bfloat16;

// dtype codes shared with the Python wrappers (ops/_build.py)
enum DType : int { kF32 = 0, kBF16 = 1 };

template <typename T>
__device__ __forceinline__ float to_f(T v);
template <>
__device__ __forceinline__ float to_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f<bf16>(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16_rn(v); }

// round an f32 value to T and back: the "astype(compute dtype)" of the
// reference kernels
template <typename T>
__device__ __forceinline__ float round_to(float v) { return to_f<T>(from_f<T>(v)); }

// Row stride of a shared-memory tile `cols` wide: padded by 16 bytes so
// neighbouring rows start in other banks. Keeps every WMMA tile pointer
// 32-byte aligned (16 rows x stride is a multiple of 32 bytes) and every row
// 16-byte aligned for vector copies.
template <typename T>
__host__ __device__ constexpr int pad_ld(int cols) { return cols + 16 / (int)sizeof(T); }
__host__ __device__ constexpr int pad_ldf(int cols) { return cols + 4; }

__host__ __device__ constexpr size_t align128(size_t n) { return (n + 127) & ~size_t(127); }

// Copy `rows` x `cols` of a row-major global matrix (row stride ld_g) into
// shared memory (row stride ld_s); rows >= valid_rows are zero-filled.
// 16-byte vector copies: cols, ld_g and ld_s times sizeof(T) must be
// multiples of 16 and src 16-byte aligned (the wrappers check the shapes).
template <typename T>
__device__ __forceinline__ void load_tile(T* dst, int ld_s, const T* __restrict__ src,
                                          long long ld_g, int rows, int cols, int valid_rows) {
  constexpr int kVec = 16 / sizeof(T);
  const int vcols = cols / kVec;
  for (int idx = threadIdx.x; idx < rows * vcols; idx += blockDim.x) {
    const int r = idx / vcols, cv = idx % vcols;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid_rows)
      val = *reinterpret_cast<const uint4*>(src + r * ld_g + cv * kVec);
    *reinterpret_cast<uint4*>(dst + r * ld_s + cv * kVec) = val;
  }
}

// C[M,N] (f32, row stride ldc) = (accumulate ? C : 0) + A[M,K] * B.
// A is M x K row-major (lda) or, with A_COL, given as its transpose: K x M
// row-major (lda), i.e. C = Aᵀ * B for a stored [K, M] A (a weight gradient
// hᵀ·g). B is K x N row-major (ldb) or, with B_COL, given as its transpose:
// N x K row-major (ldb), i.e. C = A * Bᵀ.
// Operands and C are generic pointers: shared memory, or global memory (the
// bf16 path then needs 32-byte aligned tile pointers: base aligned and every
// leading dimension a multiple of 16 elements). M, N, K must be multiples
// of 16. Called by every thread of the block; the caller synchronises before
// (operands ready) and after (C complete).
template <typename T, bool B_COL, bool A_COL = false>
__device__ void block_gemm(const T* A, int lda, const T* B, int ldb, float* C, int ldc,
                           int M, int N, int K, bool accumulate) {
  if constexpr (std::is_same<T, bf16>::value) {
    using namespace nvcuda;
    const int warp = threadIdx.x / 32, nwarps = blockDim.x / 32;
    const int tn = N / 16, tiles = (M / 16) * tn;
    using ALayout = typename std::conditional<A_COL, wmma::col_major, wmma::row_major>::type;
    using BLayout = typename std::conditional<B_COL, wmma::col_major, wmma::row_major>::type;
    for (int t = warp; t < tiles; t += nwarps) {
      const int i = t / tn, j = t % tn;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      float* ct = C + i * 16 * ldc + j * 16;
      if (accumulate)
        wmma::load_matrix_sync(acc, ct, ldc, wmma::mem_row_major);
      else
        wmma::fill_fragment(acc, 0.0f);
      for (int k = 0; k < K; k += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, ALayout> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, BLayout> b;
        if constexpr (A_COL)
          wmma::load_matrix_sync(a, A + k * lda + i * 16, lda);
        else
          wmma::load_matrix_sync(a, A + i * 16 * lda + k, lda);
        if constexpr (B_COL)
          wmma::load_matrix_sync(b, B + j * 16 * ldb + k, ldb);
        else
          wmma::load_matrix_sync(b, B + k * ldb + j * 16, ldb);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(ct, acc, ldc, wmma::mem_row_major);
    }
  } else {
    for (int idx = threadIdx.x; idx < M * N; idx += blockDim.x) {
      const int m = idx / N, n = idx % N;
      float s = accumulate ? C[m * ldc + n] : 0.0f;
      for (int k = 0; k < K; ++k) {
        const float a = A_COL ? to_f<T>(A[k * lda + m]) : to_f<T>(A[m * lda + k]);
        const float b = B_COL ? to_f<T>(B[n * ldb + k]) : to_f<T>(B[k * ldb + n]);
        s = fmaf(a, b, s);
      }
      C[m * ldc + n] = s;
    }
  }
}

// The pool's first-index rule (jnp.argmax): (v, i) beats the running
// (bv, bi) for the max if larger, or equal at an earlier index; a NaN beats
// any number and a later NaN.
__device__ __forceinline__ bool beats_max(float v, int i, float bv, int bi) {
  if (v != v) return bv == bv || i < bi;
  if (bv != bv) return false;
  return v > bv || (v == bv && i < bi);
}
__device__ __forceinline__ bool beats_min(float v, int i, float bv, int bi) {
  if (v != v) return bv == bv || i < bi;
  if (bv != bv) return false;
  return v < bv || (v == bv && i < bi);
}

// Grid for a grid-stride kernel: as many blocks as can be resident at once,
// capped by the number of work items.
template <typename K>
inline int resident_grid(K kernel, int threads, size_t smem, long long work) {
  int dev = 0, sms = 1, per_sm = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (per_sm < 1) per_sm = 1;
  long long g = (long long)sms * per_sm;
  if (work < g) g = work;
  return (int)(g < 1 ? 1 : g);
}

// Allow `bytes` of dynamic shared memory for `kernel` (needed above 48 KB).
template <typename K>
inline int allow_smem(K kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

// Floats of one block's slice of a partial-sum scratch buffer: rounded up to
// 64, so every slice starts 256-byte aligned (WMMA accumulates into them).
__host__ __device__ constexpr long long slice_stride(long long n) { return (n + 63) & ~63LL; }

// The training kernels keep no atomics: each block adds its share of a
// weight gradient or BN sum into its own f32 slice of a scratch buffer
// (`blocks` slices of `stride` floats), and this second pass sums the slices
// in block order, so the result has the same bits from run to run.
namespace {
__global__ void reduce_slices_kernel(const float* __restrict__ scratch, long long stride,
                                     int blocks, float* __restrict__ out, int total) {
  for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < total; j += gridDim.x * blockDim.x) {
    float sum = 0.f;
    for (int b = 0; b < blocks; ++b) sum += scratch[(size_t)b * stride + j];
    out[j] = sum;
  }
}

inline int reduce_slices(const float* scratch, long long stride, int blocks, float* out,
                         int total, cudaStream_t st) {
  const int grid = (total + 255) / 256;
  reduce_slices_kernel<<<grid < 1 ? 1 : grid, 256, 0, st>>>(scratch, stride, blocks, out, total);
  return (int)cudaGetLastError();
}
}  // namespace

// The PointNet backward's flat gradient buffer (floats): dw1 [3, 64], db1,
// dw2 [64, 128], db2, dw3 [128, C3], db3, then one float the kernels set to
// the 64-row tiles of routed points they ran (pointnet_bwd_sm90.cu for
// bf16, pointnet.cu for f32).
namespace pointnet_grad {
constexpr int kC1 = 64, kC2 = 128;
constexpr int kOffDb1 = 3 * kC1;
constexpr int kOffDw2 = kOffDb1 + kC1;
constexpr int kOffDb2 = kOffDw2 + kC1 * kC2;
constexpr int kOffDw3 = kOffDb2 + kC2;
__host__ __device__ inline int off_db3(int c3) { return kOffDw3 + kC2 * c3; }
__host__ __device__ inline int total(int c3) { return off_db3(c3) + c3 + 1; }
}  // namespace pointnet_grad

// relu routing of the pct block's training epilogue x + relu(t·wbn + bbn):
// the multiply and add in the compute dtype (rounded after each, no fused
// multiply-add), compared in f32
template <typename T>
__device__ __forceinline__ bool epi_live(float t, float w_t, float b_t) {
  return round_to<T>(__fadd_rn(round_to<T>(__fmul_rn(t, w_t)), b_t)) > 0.f;
}

// One block slice of the block backwards' weight gradients (floats; the
// attention op's backward uses the first three): dWqk [128, 32], dWv
// [128, 128], dbv [128], dWt [128, 128], dbt [128]
constexpr int kOffDwqk = 0;
constexpr int kOffDwv = kOffDwqk + 128 * 32;
constexpr int kOffDbv = kOffDwv + 128 * 128;
constexpr int kOffDwt = kOffDbv + 128;
constexpr int kOffDbt = kOffDwt + 128 * 128;
constexpr int kBwdGrad = kOffDbt + 128;

// Per-channel partial sums of a 256-thread block whose thread t owns channel
// t % 128 in row lane t / 128: the two lanes' values of `v` are added (lane 0
// first) and written to out[0..128). Called by every thread.
__device__ __forceinline__ void store_channel_sums(float v, float* out) {
  __shared__ float lanes[2][128];
  const int c = threadIdx.x % 128, half = threadIdx.x / 128;
  lanes[half][c] = v;
  __syncthreads();
  if (half == 0) out[c] = lanes[0][c] + lanes[1][c];
  __syncthreads();
}

}  // namespace sga
