// The port's f32 mainloop (csrc/tail_f32.cuh) alone, for
// scripts/chip_gemm_check.py: the kernels' own jobs (csrc/tail_jobs.cuh,
// csrc/attn_f32.cuh) with their staging, rings and products as the kernels
// run them, and an epilogue that only folds each tile into one checksum a
// thread, so the rate is the mainloop's. Two blocks an SM.
// tail_gemm (the tail's products, O·P flat rows, K = 1024):
//   mode 0, z: TailFwd's ZOperands staging, [rows, 1024] = x1..x4 · W;
//   mode 1, dx: TailDx, [rows, 512] = G·Wᵀ;
//   mode 2, dW: TailDw, [512, 1024] = Σ xᵀ·G over rows split `splits` ways.
// attn_gemm (the f32 C = 128 attention passes, O objects of P points):
//   mode 3, the apply pass's key loop (GJob: S, G in prep, y = G·v);
//   mode 4, the dq pass's dual product (DqJob: v_I·dŶ_Jᵀ beside dŶ_I·v_Jᵀ);
//   mode 5, the projection's 128 x 160 product (ProjJob).
// e2_gemm (the f32 embed_second pair's products, O·P flat rows, K = 128):
//   mode 6, h = x0·W1 (HJob: h0's rows 16 bytes a copy, the prologue applied
//     by prep while it transposes them);
//   mode 7, the same product with A copied transposed 4 bytes at a time
//     (stage_rows_t, the tail's z route) and the prologue applied in place
//     by prep;
//   mode 8, mode 6 through a 4-stage ring;
//   mode 9, the dW1 and dx0 products side by side, as the backward's third
//     launch runs them (DwJob on blocks < `blocks`, DxJob on the rest).
// Built with nvcc into a library with a plain C interface.
#include "attn_f32.cuh"
#include "embed_f32.cuh"
#include "tail_jobs.cuh"

namespace tail_bench {

using namespace sga;
using namespace sga::tail_f32;
using sga::tail_f32::kThreads;

// a job with a checksum epilogue in place of its own
template <class Job>
struct Sum : Job {
  float sum = 0.f;
  __device__ void epilogue(int, const float (&acc)[8][8], float*) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) sum += acc[i][j];
  }
};

template <int kMode>
__global__ void __launch_bounds__(kThreads, 2)
bench(const float* x1, const float* x2, const float* x3, const float* x4, const float* b,
      float* out, long long rows, int groups, int splits) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);
  const int k = 1024, p = 512, slices = k / kTile;
  float sum = 0.f;
  if constexpr (kMode == 0) {
    const int g = blockIdx.x / slices, o = (int)(rows / p);
    Sum<TailFwd<false>> job{{{x1, x2, x3, x4, b, p, k, (int)(blockIdx.x % slices) * kTile},
                             nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, g,
                             groups, p / kTile, (o - g + groups - 1) / groups}};
    run(job, ring);
    sum = job.sum;
  } else if constexpr (kMode == 1) {
    const int ct = blockIdx.x % 4, grp = blockIdx.x / 4;
    const long long rtiles = (rows + kTile - 1) / kTile;
    Sum<TailDx> job{{x1, b, nullptr, rows, k, ct, grp, groups,
                     (int)((rtiles - grp + groups - 1) / groups)}};
    run(job, ring);
    sum = job.sum;
  } else {
    const int i = blockIdx.x % 4, n0 = ((blockIdx.x / 4) % slices) * kTile;
    const int split = blockIdx.x / (4 * slices);
    const long long per = (rows + splits - 1) / splits / 64 * 64, lo = split * per;
    Sum<TailDw> job{{i == 0 ? x1 : i == 1 ? x2 : i == 2 ? x3 : x4, b, nullptr, lo,
                     lo + per < rows ? lo + per : rows, k, n0}};
    if (job.steps() > 0) run(job, ring);
    sum = job.sum;
  }
  out[blockIdx.x * kThreads + threadIdx.x] = sum;
}

template <int kMode>
int launch(const float* const* x, const float* b, float* out, long long rows, int groups,
           int splits, cudaStream_t st) {
  cudaFuncSetAttribute(bench<kMode>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)kRingBytes);
  const int blocks = kMode == 0 ? 8 * groups : kMode == 1 ? 4 * groups : 32 * splits;
  bench<kMode><<<blocks, kThreads, kRingBytes, st>>>(x[0], x[1], x[2], x[3], b, out, rows,
                                                     groups, splits);
  return (int)cudaGetLastError();
}

template <class Job>
__device__ void attn_run(Job job, float* out, int units) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);
  f32::own_units(job, units);
  job.res = ring + Job::kRing * Job::kStageFloats;
  Sum<Job> s{job};
  run(s, ring);
  out[blockIdx.x * kThreads + threadIdx.x] = s.sum;
}

__global__ void __launch_bounds__(kThreads, 2) attend_bench(f32::GJob<false> job, float* out,
                                                            int units) {
  attn_run(job, out, units);
}

__global__ void __launch_bounds__(kThreads, 2) dq_bench(f32::DqJob job, float* out, int units) {
  attn_run(job, out, units);
}

__global__ void __launch_bounds__(kThreads, 2) proj_bench(f32::ProjJob job, float* out,
                                                          int units) {
  extern __shared__ __align__(128) unsigned char smem[];
  f32::own_units(job, units);
  Sum<f32::ProjJob> s{job};
  run(s, reinterpret_cast<float*>(smem));
  out[blockIdx.x * kThreads + threadIdx.x] = s.sum;
}

template <class Job>
int launch_attn(void (*kernel)(Job, float*, int), Job job, size_t smem, long long units,
                float* out, cudaStream_t st) {
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  job.groups = resident_grid(kernel, kThreads, smem, units);
  kernel<<<job.groups, kThreads, smem, st>>>(job, out, (int)units);
  return (int)cudaGetLastError();
}

// mode 7's job: A copied transposed by stage_rows_t, the prologue in place
struct HJobT : e2f32::HJob<e2f32::kDz> {
  static constexpr int kStageFloats = kStage;
  __device__ void stage(int s, float* st) const {
    const int k0 = (s % e2f32::kKSteps) * kBK;
    const e2f32::Pair q = e2f32::pair_of(sl, n, s / e2f32::kKSteps);
    stage_rows_t<64>(st, h0 + q.row0[0] * e2f32::kC + k0, e2f32::kC, q.valid[0]);
    stage_rows_t<64>(st + 64, h0 + q.row0[1] * e2f32::kC + k0, e2f32::kC, q.valid[1]);
    stage_rows(st + kOperand, w + (size_t)k0 * e2f32::kC, e2f32::kC, kBK);
  }
  __device__ void prep(int s, float* st) const {
    const int k0 = (s % e2f32::kKSteps) * kBK, m = threadIdx.x % kTile;
#pragma unroll
    for (int j = 0; j < kBK / 2; ++j) {
      const int k = threadIdx.x / kTile + 2 * j;
      float* a = st + k * kLd + m;
      *a = fmaxf(__fmaf_rn(*a, swf[k0 + k], sbf[k0 + k]), 0.f);
    }
  }
};

template <class Job>
struct Ring4 : Job {
  static constexpr int kRing = 4;
};

template <class Job>
__global__ void __launch_bounds__(kThreads, 2)
e2_h_bench(Job job, const float* wf, const float* bf, float* out) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float swf[128], sbf[128];
  if (threadIdx.x < 128) {
    swf[threadIdx.x] = wf[threadIdx.x];
    sbf[threadIdx.x] = bf[threadIdx.x];
  }
  job.swf = swf;
  job.sbf = sbf;
  job.sl.slice = (int)blockIdx.x;
  job.n = job.sl.count();
  Sum<Job> s{job};
  run(s, reinterpret_cast<float*>(smem));
  out[blockIdx.x * kThreads + threadIdx.x] = s.sum;
}

__global__ void __launch_bounds__(kThreads, 2)
e2_wgrad_bench(const float* h0, const float* dz, const float* wt, const float* wf,
               const float* bf, float* out, long long rows, int p, int blocks) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);
  const int c = threadIdx.x % 128, b = (int)blockIdx.x % blocks;
  const Slice sl{rows, p, blocks, b, 1};
  float sum;
  if ((int)blockIdx.x < blocks) {
    Sum<e2f32::DwJob> s{{h0, dz, nullptr, sl, sl.count(), wf[c], bf[c]}};
    run(s, ring);
    sum = s.sum;
  } else {
    Sum<e2f32::DxJob> s{{dz, wt, h0, nullptr, sl, sl.count(), wf[c], bf[c]}};
    run(s, ring);
    sum = s.sum;
  }
  out[blockIdx.x * kThreads + threadIdx.x] = sum;
}

template <class Job>
int launch_e2(Job job, const float* wf, const float* bf, float* out, int blocks,
              cudaStream_t st) {
  constexpr size_t smem = sizeof(float) * RingOf<Job>::kRing * RingOf<Job>::kStageFloats;
  cudaFuncSetAttribute(e2_h_bench<Job>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  e2_h_bench<Job><<<blocks, kThreads, smem, st>>>(job, wf, bf, out);
  return (int)cudaGetLastError();
}

}  // namespace tail_bench

// modes 6-9 on h0 [O·P, 128] (also dz for mode 9), w [128, 128] (W1, or
// W1ᵀ for mode 9), wf, bf [128]; `blocks` slices (mode 9: 2·blocks
// blocks). out: one float a thread of the grid
extern "C" int e2_gemm(int mode, const float* h0, const float* w, const float* wf,
                       const float* bf, float* out, int o, int p, int blocks, void* st) {
  using namespace sga::e2f32;
  using tail_bench::Ring4;
  auto s = (cudaStream_t)st;
  const long long rows = (long long)o * p;
  const sga::tail_f32::Slice sl{rows, p, blocks, 0, 1};
  HJob<kDz> job{h0, w, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                sl, 0, p};
  if (mode == 6) return tail_bench::launch_e2(job, wf, bf, out, blocks, s);
  if (mode == 7) {
    tail_bench::HJobT t{job};
    return tail_bench::launch_e2(t, wf, bf, out, blocks, s);
  }
  if (mode == 8) {
    Ring4<HJob<kDz>> r{job};
    return tail_bench::launch_e2(r, wf, bf, out, blocks, s);
  }
  cudaFuncSetAttribute(tail_bench::e2_wgrad_bench, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)kRawRingBytes);
  tail_bench::e2_wgrad_bench<<<2 * blocks, sga::tail_f32::kThreads, kRawRingBytes, s>>>(
      h0, h0, w, wf, bf, out, rows, p, blocks);
  return (int)cudaGetLastError();
}

// mode 0 / 1: `groups` blocks per column tile (8 / 4 column tiles); mode 2:
// 32 tiles x `splits` row splits. x: x1..x4 [rows, 128] each (mode 1: G
// [rows, 1024] in x[0]); b: W (modes 0, 1) or G (mode 2). out: one float a
// thread
extern "C" int tail_gemm(int mode, const float* const* x, const float* b, float* out,
                         long long rows, int groups, int splits, void* st) {
  auto s = (cudaStream_t)st;
  if (mode == 0) return tail_bench::launch<0>(x, b, out, rows, groups, splits, s);
  if (mode == 1) return tail_bench::launch<1>(x, b, out, rows, groups, splits, s);
  return tail_bench::launch<2>(x, b, out, rows, groups, splits, s);
}

// modes 3-5 on q [O·P, 32], v [O·P, 128], lse [O·P] (mode 4 also reads v as
// dŶ and lse as D; mode 5 reads v as x, and w [128, 32] and wv [128, 128];
// its q and v outputs are not written). out: one float a thread of the grid
// (at most 2 x the SMs blocks)
extern "C" int attn_gemm(int mode, const float* q, const float* v, const float* lse,
                         const float* wqk, const float* wv, float* out, int o, int p, void* st) {
  using namespace sga::f32;
  auto s = (cudaStream_t)st;
  const int rtiles = (p + kTile - 1) / kTile;
  if (mode == 3) {
    GJob<false> job{q, v, lse, v, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                    kAttendU, 0, p, rtiles, 0, 0, 0, (p + kBK - 1) / kBK};
    return tail_bench::launch_attn(tail_bench::attend_bench, job, GJob<false>::kSmemBytes,
                                   (long long)o * rtiles, out, s);
  }
  if (mode == 4) {
    const int jchunks = (p + DqJob::kJ - 1) / DqJob::kJ;
    int pairs = 0;
    for (int it = 0; it < rtiles; ++it) pairs += jchunks - 2 * it;
    DqJob job{q, v, v, lse, lse, nullptr, nullptr, nullptr, 0, p, rtiles, jchunks, pairs};
    return tail_bench::launch_attn(tail_bench::dq_bench, job, DqJob::kSmemBytes, o, out, s);
  }
  const long long rows = (long long)o * p;
  ProjJob job{v, wqk, wv, lse, nullptr, nullptr, rows};
  return tail_bench::launch_attn(tail_bench::proj_bench, job,
                                 sizeof(float) * kStages * ProjJob::kStageFloats,
                                 (rows + kTile - 1) / kTile, out, s);
}
