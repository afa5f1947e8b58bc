// PCT block training epilogue, the fold's gradient sums: pct_epi_sums as a
// streaming reduction.
//
// Replaces the Pallas kernel _epi_sums_kernel of
// sgaligner_tpu/ops/pct_attention.py::_block_res_bwd_rule: with g = dy
// where t·wbn + bbn > 0 (the multiply and add in the compute dtype, compared
// in f32, as the reference: epi_live in common.cuh), dwbn = Σ g·t and
// dbbn = Σ g over every row of t_out and dy [rows, 128], in f32.
//   Bound on the H100: bytes. t_out and dy are read once and nothing else
//   is large: 0.070 ms at O = 896, P = 512 in bf16.
//   Design: a thread owns 16 bytes of a row (8 bf16 or 4 f32 channels), so
//   16 (bf16) or 32 (f32) threads cover a 256- or 512-byte row with one
//   16-byte load each, and takes kUnroll rows of both tensors per step,
//   all loads issued before any arithmetic: 128 bytes in flight a thread,
//   32 KB a 256-thread block. Its sums stay in registers (2 per channel);
//   at the end the block's row lanes meet in shared memory in a fixed
//   order and one slice per block is written, which reduce_slices adds in
//   block order: no atomics, the same bits from run to run.
#include "common.cuh"

namespace sga {
namespace {

constexpr int kC = 128;
constexpr int kThreads = 256;
constexpr int kUnroll = 4;

template <typename T>
__global__ void __launch_bounds__(kThreads)
epi_sums_stream_kernel(const T* __restrict__ tout, const float* __restrict__ wbn,
                       const float* __restrict__ bbn, const T* __restrict__ dy,
                       float* __restrict__ scratch, long long rows) {
  constexpr int kVec = 16 / sizeof(T);            // channels a thread owns
  constexpr int kLanes = kC / kVec;               // threads a row
  constexpr int kRowLanes = kThreads / kLanes;    // rows a block takes at once
  __shared__ float part[kRowLanes][2][kC];
  const int lane = threadIdx.x % kLanes, rlane = threadIdx.x / kLanes;
  const int c0 = lane * kVec;
  float w_t[kVec], b_t[kVec], a[kVec], s[kVec];
#pragma unroll
  for (int e = 0; e < kVec; ++e) {
    w_t[e] = round_to<T>(wbn[c0 + e]);
    b_t[e] = round_to<T>(bbn[c0 + e]);
    a[e] = s[e] = 0.f;
  }
  const long long step = (long long)gridDim.x * kRowLanes;
  for (long long r0 = (long long)blockIdx.x * kRowLanes + rlane; r0 < rows;
       r0 += step * kUnroll) {
    uint4 tv[kUnroll], gv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long r = r0 + u * step;
      tv[u] = gv[u] = make_uint4(0u, 0u, 0u, 0u);
      if (r < rows) {
        tv[u] = *reinterpret_cast<const uint4*>(tout + r * kC + c0);
        gv[u] = *reinterpret_cast<const uint4*>(dy + r * kC + c0);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const T* te = reinterpret_cast<const T*>(&tv[u]);
      const T* ge = reinterpret_cast<const T*>(&gv[u]);
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const float t = to_f<T>(te[e]);
        const float g = epi_live<T>(t, w_t[e], b_t[e]) ? to_f<T>(ge[e]) : 0.f;
        a[e] = fmaf(g, t, a[e]);
        s[e] += g;
      }
    }
  }
#pragma unroll
  for (int e = 0; e < kVec; ++e) {
    part[rlane][0][c0 + e] = a[e];
    part[rlane][1][c0 + e] = s[e];
  }
  __syncthreads();
  // thread (sum, channel) adds the row lanes in order into the block's slice
  const int which = threadIdx.x / kC, ch = threadIdx.x % kC;
  float sum = 0.f;
#pragma unroll
  for (int l = 0; l < kRowLanes; ++l) sum += part[l][which][ch];
  scratch[(size_t)blockIdx.x * slice_stride(2 * kC) + which * kC + ch] = sum;
}

template <typename T>
int launch(const void* tout, const float* wbn, const float* bbn, const void* dy, float* scratch,
           int blocks, float* sums, long long rows, cudaStream_t st) {
  if (((uintptr_t)tout | (uintptr_t)dy) & 15) return (int)cudaErrorMisalignedAddress;
  epi_sums_stream_kernel<T><<<blocks, kThreads, 0, st>>>((const T*)tout, wbn, bbn, (const T*)dy,
                                                         scratch, rows);
  if (int rc = (int)cudaGetLastError()) return rc;
  return reduce_slices(scratch, slice_stride(2 * kC), blocks, sums, 2 * kC, st);
}

}  // namespace
}  // namespace sga

extern "C" {

// Rows one block takes per step (its row lanes times the unroll): the
// wrapper sizes the grid by it
int sga_pct_epi_sums_rows_per_block(int dtype) {
  const int lanes = sga::kC / (dtype == sga::kBF16 ? 8 : 4);
  return sga::kThreads / lanes * sga::kUnroll;
}

// sums [2, 128]: Σ g·t, Σ g; scratch: `blocks` slices of slice_stride(256)
int sga_pct_epi_sums(const void* tout, const float* wbn, const float* bbn, const void* dy,
                     float* scratch, int blocks, float* sums, long long rows, int dtype,
                     void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == sga::kBF16)
    return sga::launch<sga::bf16>(tout, wbn, bbn, dy, scratch, blocks, sums, rows, st);
  return sga::launch<float>(tout, wbn, bbn, dy, scratch, blocks, sums, rows, st);
}

}  // extern "C"
