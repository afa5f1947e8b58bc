// Shared device helpers for the PCT kernels (sm_90a).
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

// C[M,N] (f32, shared, row stride ldc) = (accumulate ? C : 0) + A[M,K] * B.
// A is row-major (lda). B is K x N row-major (ldb) or, with B_COL, given as
// its transpose: N x K row-major (ldb), i.e. C = A * Bᵀ.
// M, N, K must be multiples of 16. Called by every thread of the block; the
// caller synchronises before (operands ready) and after (C complete).
template <typename T, bool B_COL>
__device__ void block_gemm(const T* A, int lda, const T* B, int ldb, float* C, int ldc,
                           int M, int N, int K, bool accumulate) {
  if constexpr (std::is_same<T, bf16>::value) {
    using namespace nvcuda;
    const int warp = threadIdx.x / 32, nwarps = blockDim.x / 32;
    const int tn = N / 16, tiles = (M / 16) * tn;
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
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, BLayout> b;
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
      const T* a = A + m * lda;
      for (int k = 0; k < K; ++k) {
        const float b = B_COL ? to_f<T>(B[n * ldb + k]) : to_f<T>(B[k * ldb + n]);
        s = fmaf(to_f<T>(a[k]), b, s);
      }
      C[m * ldc + n] = s;
    }
  }
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

}  // namespace sga
