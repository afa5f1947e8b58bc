// block_gemm's f32 product alone (csrc/common.cuh), for
// scripts/chip_gemm_check.py: each of `grid` blocks (256 threads, one an SM:
// it asks for the shared memory a real pass holds) multiplies tiles resident
// in shared memory `reps` times, at the shapes and layouts the C = 256
// passes call it with (NN: A and B row-major; BC: B given transposed; AC: A
// given transposed, C a weight-gradient slice in global memory). Built
// with nvcc into a library with a plain C interface, one entry a shape.
#include "common.cuh"
using namespace sga;
template <bool B_COL, bool A_COL, int M, int N, int K>
__global__ void __launch_bounds__(256) bench(float* out, float* gc, int reps) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int lda = (A_COL ? M : K) + 4, ldb = (B_COL ? K : N) + 4, ldc = N + 4;
  constexpr int arows = A_COL ? K : M, brows = B_COL ? N : K;
  float* A = reinterpret_cast<float*>(smem);
  float* B = A + align128(arows * lda * 4) / 4;
  // A_COL: C is a weight gradient slice in global memory, as in the passes
  float* C = A_COL ? gc + (size_t)blockIdx.x * M * (N + 4) : B + align128(brows * ldb * 4) / 4;
  for (int i = threadIdx.x; i < arows * lda; i += 256) A[i] = 1e-3f * (i % 17);
  for (int i = threadIdx.x; i < brows * ldb; i += 256) B[i] = 1e-3f * (i % 13);
  __syncthreads();
  for (int r = 0; r < reps; ++r) {
    block_gemm<float, B_COL, A_COL, M, N, K>(A, lda, B, ldb, C, ldc, r > 0);
    __syncthreads();
  }
  if (threadIdx.x == 0) out[blockIdx.x] = C[0];
}
#define ENTRY(name, BC, AC, M, N, K)                                                       \
  extern "C" int name(float* out, float* gc, int grid, int reps, int smem, void* st) {                \
    cudaFuncSetAttribute(bench<BC, AC, M, N, K>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem); \
    bench<BC, AC, M, N, K><<<grid, 256, smem, (cudaStream_t)st>>>(out, gc, reps);              \
    return (int)cudaGetLastError();                                                        \
  }
ENTRY(nn_64_32_256, false, false, 64, 32, 256)
ENTRY(bc_64_32_256, true, false, 64, 32, 256)
ENTRY(bc_64_64_64, true, false, 64, 64, 64)
ENTRY(nn_64_64_64, false, false, 64, 64, 64)
ENTRY(nn_64_256_64, false, false, 64, 256, 64)
ENTRY(bc_64_256_32, true, false, 64, 256, 32)
ENTRY(ac_256_32_64, false, true, 256, 32, 64)
ENTRY(ac_256_256_64, false, true, 256, 256, 64)
ENTRY(ac_64_256_64, false, true, 64, 256, 64)
