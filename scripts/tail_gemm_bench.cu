// The f32 tail's mainloop alone (csrc/tail_f32.cuh), for
// scripts/chip_gemm_check.py: the three products of csrc/pct_tail.cu at
// their shapes, read from device memory through the cp.async ring, with an
// epilogue that only folds each tile into one checksum a thread (so the
// rate is the mainloop's). Two blocks an SM walk the output tiles:
//   mode 0, z (the forward and the g pass): C[rows, 1024] = X[rows, 512] · W,
//     X staged transposed, W as it is;
//   mode 1, dx: C[rows, 512] = G[rows, 1024] · Wᵀ, both staged transposed;
//   mode 2, dW: C[512, 1024] = Xᵀ · G over rows split `splits` ways, both as
//     they are.
// Built with nvcc into a library with a plain C interface.
#include "tail_f32.cuh"

namespace tail_bench {

using namespace sga;
using namespace sga::tail_f32;

template <int kMode>
struct Bench {
  const float *a, *b;
  long long rows;
  int n0, m0, tiles, k;
  long long row_first, row_step, lo, hi;
  float sum = 0.f;

  __device__ int steps() const { return kMode == 2 ? (int)((hi - lo) / kBK) : tiles * (k / kBK); }
  __device__ int ksteps() const { return kMode == 2 ? steps() : k / kBK; }
  __device__ void stage(int s, float* st) const {
    if (kMode == 2) {
      const long long r0 = lo + (long long)s * kBK;
      stage_rows(st, a + r0 * 512 + m0, 512, kBK);
      stage_rows(st + kOperand, b + r0 * 1024 + n0, 1024, kBK);
      return;
    }
    const long long row0 = row_first + row_step * (s / (k / kBK));
    const int k0 = (s % (k / kBK)) * kBK;
    stage_rows_t(st, a + row0 * k + k0, k, (int)min((long long)kTile, rows - row0));
    if (kMode == 0)
      stage_rows(st + kOperand, b + (size_t)k0 * 1024 + n0, 1024, kBK);
    else  // B[kk][n] = W[n0 + n][k0 + kk]: W's rows, transposed
      stage_rows_t(st + kOperand, b + (size_t)n0 * 1024 + k0, 1024, kTile);
  }
  __device__ void epilogue(int, const float (&acc)[8][8], float*) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) sum += acc[i][j];
  }
};

template <int kMode>
__global__ void __launch_bounds__(kThreads, 2)
bench(const float* a, const float* b, float* out, long long rows, int groups, int splits) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int ncols = kMode == 1 ? 4 : 8;
  Bench<kMode> job{a, b, rows, 0, 0, 0, kMode == 1 ? 1024 : 512, 0, 0, 0, 0};
  if (kMode == 2) {
    const int mt = blockIdx.x % 4, nt = (blockIdx.x / 4) % ncols, split = blockIdx.x / 32;
    const long long per = rows / splits / kBK * kBK;
    job.m0 = mt * kTile, job.n0 = nt * kTile, job.lo = split * per, job.hi = job.lo + per;
  } else {
    const int grp = blockIdx.x / ncols;
    const long long rtiles = (rows + kTile - 1) / kTile;
    job.n0 = (blockIdx.x % ncols) * kTile;
    job.row_first = (long long)grp * kTile, job.row_step = (long long)groups * kTile;
    job.tiles = (int)((rtiles - grp + groups - 1) / groups);
  }
  run(job, reinterpret_cast<float*>(smem));
  out[blockIdx.x * kThreads + threadIdx.x] = job.sum;
}

template <int kMode>
int launch(const float* a, const float* b, float* out, long long rows, int groups, int splits,
           cudaStream_t st) {
  cudaFuncSetAttribute(bench<kMode>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)kRingBytes);
  const int blocks = kMode == 0 ? 8 * groups : kMode == 1 ? 4 * groups : 32 * splits;
  bench<kMode><<<blocks, kThreads, kRingBytes, st>>>(a, b, out, rows, groups, splits);
  return (int)cudaGetLastError();
}

}  // namespace tail_bench

// mode 0 / 1: `groups` blocks per column tile (8 / 4 column tiles); mode 2:
// 32 tiles x `splits` row splits. b: W (modes 0, 1) or G (mode 2). out:
// one float a thread
extern "C" int tail_gemm(int mode, const float* a, const float* b, float* out, long long rows,
                         int groups, int splits, void* st) {
  auto s = (cudaStream_t)st;
  if (mode == 0) return tail_bench::launch<0>(a, b, out, rows, groups, splits, s);
  if (mode == 1) return tail_bench::launch<1>(a, b, out, rows, groups, splits, s);
  return tail_bench::launch<2>(a, b, out, rows, groups, splits, s);
}
