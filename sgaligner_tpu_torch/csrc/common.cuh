// Shared device helpers for the port's kernels (sm_90a).
//
// The f32 C = 256 attention kernels (pct_attention_c256.cu,
// pct_attention.cuh) keep their operand tiles in shared memory and multiply
// them with `block_gemm`, a register-tiled FMA product (each thread a
// TM x TN block of outputs in registers, fed by 16-byte shared loads), in
// full f32 (no TF32), like torch's f32 matmul with allow_tf32=False.
// Accumulators land in shared (or global) memory as f32, and the kernels'
// epilogues read them from there.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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
// neighbouring rows start in other banks; every row stays 16-byte aligned
// for vector copies.
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

// 16-byte asynchronous copies global -> shared (cp.async, sm_80+): a
// stage is issued, committed as a group, and waited for with
// cp_async_wait<n> (at most n groups still in flight), then made visible to
// the block by a __syncthreads.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid = true) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  // src-size 0 fills the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// load_tile's asynchronous form (issue only; the caller commits and waits):
// rows >= valid_rows are zero-filled, their source address kept in bounds
template <typename T>
__device__ __forceinline__ void load_tile_async(T* dst, int ld_s, const T* __restrict__ src,
                                                long long ld_g, int rows, int cols,
                                                int valid_rows) {
  constexpr int kVec = 16 / sizeof(T);
  const int vcols = cols / kVec;
  for (int idx = threadIdx.x; idx < rows * vcols; idx += blockDim.x) {
    const int r = idx / vcols, cv = idx % vcols;
    const bool in = r < valid_rows;
    cp_async16(dst + r * ld_s + cv * kVec, src + (in ? r * ld_g : 0) + cv * kVec, in);
  }
}

// Four consecutive values of a row, rounded to T, in one store (16 bytes at
// f32, 8 at bf16): dst 16- (8-) byte aligned
template <typename T>
__device__ __forceinline__ void store4(T* dst, float a, float b, float c, float d) {
  if constexpr (std::is_same<T, float>::value) {
    *reinterpret_cast<float4*>(dst) = make_float4(a, b, c, d);
  } else {
    union {
      bf16 h[4];
      uint2 u;
    } v = {{from_f<T>(a), from_f<T>(b), from_f<T>(c), from_f<T>(d)}};
    *reinterpret_cast<uint2*>(dst) = v.u;
  }
}
template <typename T>
__device__ __forceinline__ float4 load4(const T* src) {
  if constexpr (std::is_same<T, float>::value) {
    return *reinterpret_cast<const float4*>(src);
  } else {
    union {
      uint2 u;
      bf16 h[4];
    } v = {*reinterpret_cast<const uint2*>(src)};
    return make_float4(to_f<T>(v.h[0]), to_f<T>(v.h[1]), to_f<T>(v.h[2]), to_f<T>(v.h[3]));
  }
}

// The f32 product's register tile. Each of the block's kGemmThreads
// threads owns TM x TN outputs of an [M, NC] column chunk of C (NC = N,
// or N split into chunks of at most 64 outputs a thread), as a grid of
// nx = NC / TN column lanes (fastest) by ny = M / TM row lanes:
//   rows: A row-major ty + i·ny; A_COL 4·ty + 4·ny·g + e (i = 4g + e, float4
//     groups along M);
//   columns: B row-major 4·tx + 4·nx·g + e (float4 groups along N); B_COL
//     tx + j·nx.
// So a quarter-warp (8 lanes of one ty, nx >= 8) reads one A address (a
// broadcast) and 8 neighbouring B rows or float4 groups: no bank conflict
// with the 16-byte row padding of pad_ldf (a row stride of 16 mod 128
// bytes).
constexpr int kGemmThreads = 256;

template <int M, int N, bool A_COL, bool B_COL>
struct F32Tile {
  static constexpr int kChunks = M * N > kGemmThreads * 64 ? M * N / (kGemmThreads * 64) : 1;
  static constexpr int NC = N / kChunks;
  static constexpr int kPer = M * NC / kGemmThreads;
  static constexpr int TN = kPer <= 16 ? 4 : kPer == 32 && NC < 64 ? 4 : 8;
  static constexpr int TM = kPer / TN;
  static constexpr int nx = NC / TN, ny = M / TM;
  static_assert(N % kChunks == 0 && M * NC == kGemmThreads * kPer, "f32 tile: shape");
  static_assert(kPer == 8 || kPer == 16 || kPer == 32 || kPer == 64, "f32 tile: outputs a thread");
  static_assert(nx * ny == kGemmThreads && nx >= 8 && M % TM == 0, "f32 tile: thread grid");
  static_assert(TN % 4 == 0 && (!A_COL || TM % 4 == 0), "f32 tile: float4 groups");
};

// One k-step of four: the thread's A fragment a[i][kk] and B fragment
// b[kk][j] for k .. k + 3, each from 16-byte shared (or global) loads.
template <int TM, int TN, int nx, int ny, bool A_COL, bool B_COL>
__device__ __forceinline__ void f32_frag(const float* A, int lda, const float* B, int ldb, int tx,
                                         int ty, int k, float (&a)[TM][4], float (&b)[4][TN]) {
  if constexpr (A_COL) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int g = 0; g < TM / 4; ++g) {
        const float4 v = *reinterpret_cast<const float4*>(A + (k + kk) * lda + 4 * (ty + ny * g));
        a[4 * g][kk] = v.x, a[4 * g + 1][kk] = v.y, a[4 * g + 2][kk] = v.z, a[4 * g + 3][kk] = v.w;
      }
  } else {
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const float4 v = *reinterpret_cast<const float4*>(A + (ty + i * ny) * lda + k);
      a[i][0] = v.x, a[i][1] = v.y, a[i][2] = v.z, a[i][3] = v.w;
    }
  }
  if constexpr (B_COL) {
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const float4 v = *reinterpret_cast<const float4*>(B + (tx + j * nx) * ldb + k);
      b[0][j] = v.x, b[1][j] = v.y, b[2][j] = v.z, b[3][j] = v.w;
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int g = 0; g < TN / 4; ++g) {
        const float4 v = *reinterpret_cast<const float4*>(B + (k + kk) * ldb + 4 * (tx + nx * g));
        b[kk][4 * g] = v.x, b[kk][4 * g + 1] = v.y, b[kk][4 * g + 2] = v.z, b[kk][4 * g + 3] = v.w;
      }
  }
}

template <int TM, int TN>
__device__ __forceinline__ void f32_fma(float (&acc)[TM][TN], const float (&a)[TM][4],
                                        const float (&b)[4][TN]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i][kk], b[kk][j], acc[i][j]);
}

// C[M,N] (f32, row stride ldc) = (accumulate ? C : 0) + A[M,K] * B, all
// f32. A is M x K row-major (lda) or, with A_COL, given as its transpose:
// K x M row-major (lda), i.e. C = Aᵀ * B for a stored [K, M] A (a weight
// gradient hᵀ·g). B is K x N row-major (ldb) or, with B_COL, given as its
// transpose: N x K row-major (ldb), i.e. C = A * Bᵀ.
// Operands and C are generic pointers: shared memory, or global memory
// (16-byte aligned pointers and leading dimensions that are multiples of
// 4). M, N must be multiples of 16, K of 8. Called by every thread of a
// block of kGemmThreads; the caller synchronises before (operands ready)
// and after (C complete).
// A register-tiled FMA product (F32Tile): each thread's TM x TN
// accumulators in registers, fed per k-step of four by TM + TN 16-byte
// loads, the next step's fragments loaded while this one multiplies. Each
// output is one fmaf chain over k in ascending order, from 0 or from C: the
// bits of the one-output-a-thread loop this replaced.
template <bool B_COL, bool A_COL, int M, int N, int K>
__device__ void block_gemm(const float* A, int lda, const float* B, int ldb, float* C, int ldc,
                           bool accumulate) {
  static_assert(M % 16 == 0 && N % 16 == 0 && K % 8 == 0, "block_gemm: shape");
  using F = F32Tile<M, N, A_COL, B_COL>;
  constexpr int TM = F::TM, TN = F::TN, nx = F::nx, ny = F::ny;
  const int tx = threadIdx.x % nx, ty = threadIdx.x / nx;
#pragma unroll 1
  for (int ch = 0; ch < F::kChunks; ++ch) {
    // this chunk's columns: B's and C's first column moves by NC
    const float* Bc = B_COL ? B + ch * F::NC * ldb : B + ch * F::NC;
    float* Cc = C + ch * F::NC;
    auto c_at = [&](int i, int j) -> float* {
      const int m = A_COL ? 4 * (ty + ny * (i / 4)) + i % 4 : ty + i * ny;
      const int n = B_COL ? tx + j * nx : 4 * (tx + nx * (j / 4)) + j % 4;
      return Cc + m * ldc + n;
    };
    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      if constexpr (B_COL) {
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = accumulate ? *c_at(i, j) : 0.f;
      } else {
#pragma unroll
        for (int g = 0; g < TN / 4; ++g) {
          const float4 v = accumulate ? *reinterpret_cast<const float4*>(c_at(i, 4 * g))
                                      : make_float4(0.f, 0.f, 0.f, 0.f);
          acc[i][4 * g] = v.x, acc[i][4 * g + 1] = v.y, acc[i][4 * g + 2] = v.z,
          acc[i][4 * g + 3] = v.w;
        }
      }
    }
    float a0[TM][4], b0[4][TN];
    f32_frag<TM, TN, nx, ny, A_COL, B_COL>(A, lda, Bc, ldb, tx, ty, 0, a0, b0);
    if constexpr (TM * TN <= 32) {
      // the next k-step's fragments in a second register set
      float a1[TM][4], b1[4][TN];
#pragma unroll 1
      for (int k = 0; k < K; k += 8) {
        f32_frag<TM, TN, nx, ny, A_COL, B_COL>(A, lda, Bc, ldb, tx, ty, k + 4, a1, b1);
        f32_fma<TM, TN>(acc, a0, b0);
        if (k + 8 < K)
          f32_frag<TM, TN, nx, ny, A_COL, B_COL>(A, lda, Bc, ldb, tx, ty, k + 8, a0, b0);
        f32_fma<TM, TN>(acc, a1, b1);
      }
    } else {
      // 64 accumulators: 256 FMAs a k-step hide the loads (a second
      // register set measured no faster on an H100)
#pragma unroll 2
      for (int k = 0; k < K; k += 4) {
        if (k > 0) f32_frag<TM, TN, nx, ny, A_COL, B_COL>(A, lda, Bc, ldb, tx, ty, k, a0, b0);
        f32_fma<TM, TN>(acc, a0, b0);
      }
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      if constexpr (B_COL) {
#pragma unroll
        for (int j = 0; j < TN; ++j) *c_at(i, j) = acc[i][j];
      } else {
#pragma unroll
        for (int g = 0; g < TN / 4; ++g)
          *reinterpret_cast<float4*>(c_at(i, 4 * g)) =
              make_float4(acc[i][4 * g], acc[i][4 * g + 1], acc[i][4 * g + 2], acc[i][4 * g + 3]);
      }
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
// 64, so every slice starts 256-byte aligned.
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
