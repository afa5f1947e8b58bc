// PCT block training epilogue, the fold's gradient sums: pct_epi_sums as a
// streaming reduction.
//
// Replaces the Pallas kernel _epi_sums_kernel of
// sgaligner_tpu/ops/pct_attention.py::_block_res_bwd_rule: with g = dy
// where t·wbn + bbn > 0 (the multiply and add in the compute dtype, compared
// in f32, as the reference: epi_live in common.cuh), dwbn = Σ g·t and
// dbbn = Σ g over every row of t_out and dy [rows, C], in f32, at the
// block's widths C = 128 (SPCT, NaivePCT) and C = 256 (FullPCT's OA
// blocks, the entries ending in _c256).
//   Bound on the H100: bytes. t_out and dy are read once and nothing else
//   is large: 0.070 ms at O = 896, P = 512, C = 128 in bf16.
//   Design: a thread owns 16 bytes of a row (8 bf16 or 4 f32 channels), so
//   C / 8 (bf16) or C / 4 (f32) threads cover a row with one 16-byte load
//   each, and takes kUnroll rows of both tensors per step,
//   all loads issued before any arithmetic: 128 bytes in flight a thread,
//   32 KB a 256-thread block. Its sums stay in registers (2 per channel);
//   at the end the block's row lanes meet in shared memory in a fixed
//   order and one slice per block is written, which reduce_slices adds in
//   block order: no atomics, the same bits from run to run.
#include "common.cuh"

namespace sga {
namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;

template <typename T, int kC>
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
  for (int j = threadIdx.x; j < 2 * kC; j += kThreads) {
    const int which = j / kC, ch = j % kC;
    float sum = 0.f;
#pragma unroll
    for (int l = 0; l < kRowLanes; ++l) sum += part[l][which][ch];
    scratch[(size_t)blockIdx.x * slice_stride(2 * kC) + which * kC + ch] = sum;
  }
}

template <typename T, int kC>
int launch(const void* tout, const float* wbn, const float* bbn, const void* dy, float* scratch,
           int blocks, float* sums, long long rows, cudaStream_t st) {
  if (((uintptr_t)tout | (uintptr_t)dy) & 15) return (int)cudaErrorMisalignedAddress;
  epi_sums_stream_kernel<T, kC><<<blocks, kThreads, 0, st>>>((const T*)tout, wbn, bbn,
                                                             (const T*)dy, scratch, rows);
  if (int rc = (int)cudaGetLastError()) return rc;
  return reduce_slices(scratch, slice_stride(2 * kC), blocks, sums, 2 * kC, st);
}

// Rows one block takes per step at C channels (its row lanes times the
// unroll): the wrapper sizes the grid by it
inline int rows_per_block(int c, int dtype) {
  const int lanes = c / (dtype == kBF16 ? 8 : 4);
  return kThreads / lanes * kUnroll;
}

template <int kC>
int epi_sums(const void* tout, const float* wbn, const float* bbn, const void* dy,
             float* scratch, int blocks, float* sums, long long rows, int dtype, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    return launch<bf16, kC>(tout, wbn, bbn, dy, scratch, blocks, sums, rows, st);
  return launch<float, kC>(tout, wbn, bbn, dy, scratch, blocks, sums, rows, st);
}

}  // namespace
}  // namespace sga

extern "C" {

int sga_pct_epi_sums_rows_per_block(int dtype) { return sga::rows_per_block(128, dtype); }
int sga_pct_epi_sums_c256_rows_per_block(int dtype) { return sga::rows_per_block(256, dtype); }

// sums [2, C]: Σ g·t, Σ g; scratch: `blocks` slices of slice_stride(2·C);
// C = 128, and 256 for the _c256 entry
int sga_pct_epi_sums(const void* tout, const float* wbn, const float* bbn, const void* dy,
                     float* scratch, int blocks, float* sums, long long rows, int dtype,
                     void* stream) {
  return sga::epi_sums<128>(tout, wbn, bbn, dy, scratch, blocks, sums, rows, dtype, stream);
}

int sga_pct_epi_sums_c256(const void* tout, const float* wbn, const float* bbn, const void* dy,
                          float* scratch, int blocks, float* sums, long long rows, int dtype,
                          void* stream) {
  return sga::epi_sums<256>(tout, wbn, bbn, dy, scratch, blocks, sums, rows, dtype, stream);
}

}  // extern "C"
