// PCT point embedding, the first layer's backward: embed_first_bwd as a
// streaming reduction, both dtypes.
//
// Replaces sgaligner_tpu/ops/pct_embed.py::_e1_bwd_rule (Pallas kernel
// _e1_bwd_kernel): given the cotangents dh [O, P, 128] of h0 = x_cfᵀ·W0 and
// ds1, ds2 [1, 128] of its masked sums, recompute
// h = round(x0·w0 + x1·w1 + x2·w2), dz = round(dh + m·ds1 + 2·h·m·ds2) in
// the compute dtype, and dW0 [3, 128] = Σ x·dz (f32). No gradient for the
// points: they are data. A dead object (m = 0) adds x·dh alone.
//   Bound on the H100: bytes. dh is read once (117 MB at O = 896, P = 512 in
//   bf16: 0.035 ms); the points are 1/43 of it and the rest is small.
//   Design (pct_epi_sums.cu's streaming reduction): blocks walk the flat rows
//   O·P in a grid-stride loop of chunks (kRowLanes·kUnroll rows), so the
//   work does not split by whole objects; a row's object and mask come from
//   row / P (one division a chunk, then a step). A thread owns 16 bytes of a
//   dh row (8 bf16 or 4 f32 channels) and issues the loads of its kUnroll
//   rows of a chunk (dh, the point's three coordinates, which the row's
//   threads share, and the mask) before any arithmetic; its 3 × 8 (3 × 4)
//   dW0 sums stay in registers. Each bf16 element costs about 15
//   instructions (h, two roundings, dz and the three sums), so what sets
//   the pace is how many warps hide the latency of those chains, not the
//   bytes in flight (variant builds on the card): W0, ds1 and ds2 sit
//   in shared memory (read per row, ld.shared.v4), the BN terms m·ds are
//   formed once per chunk where a thread's rows share a mask value, and
//   the kernel fits 64 registers, two blocks of 16 warps an SM (so that
//   reduce_slices adds no more slices than pct_epi_sums'). At the end
//   the lanes of a warp that share a channel group are added by shuffles,
//   each warp writes one share to shared memory, and the shares are added
//   in warp order into one slice per block, which reduce_slices adds in
//   block order: no atomics, the same bits from run to run.
#include <climits>

#include "common.cuh"

namespace sga {
namespace {

constexpr int kC = 128;
constexpr int kThreads = 512;
constexpr int kBlocksPerSm = 2;  // at 64 registers a thread; _build.stream_blocks' grid
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 2;
constexpr int kGrad = 3 * kC;  // dW0

// 16 bytes of shared memory, loaded where it is used: the compiler keeps
// no copy in registers
__device__ __forceinline__ float4 lds4(const float* p) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"((unsigned)__cvta_generic_to_shared(p)));
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
embed_first_bwd_stream_kernel(const T* __restrict__ x, const T* __restrict__ w,
                              const T* __restrict__ mask, const T* __restrict__ dh,
                              const float* __restrict__ ds1, const float* __restrict__ ds2,
                              float* __restrict__ scratch, int rows, int p) {
  constexpr int kVec = 16 / sizeof(T);          // channels a thread owns
  constexpr int kLanes = kC / kVec;             // threads a row
  constexpr int kRowLanes = kThreads / kLanes;  // rows a block takes at once
  constexpr int kChunk = kRowLanes * kUnroll;   // rows a block takes a step
  __shared__ float part[kWarps][kGrad];
  __shared__ float dsh[2][kC];
  __shared__ __align__(16) float wsh[3][kC];
  const int lane = threadIdx.x % kLanes, rlane = threadIdx.x / kLanes;
  const int c0 = lane * kVec;
  float g[3][kVec];
#pragma unroll
  for (int e = 0; e < kVec; ++e) g[0][e] = g[1][e] = g[2][e] = 0.f;
  for (int i = threadIdx.x; i < kC; i += kThreads) {
    dsh[0][i] = ds1[i];
    dsh[1][i] = ds2[i];
    wsh[0][i] = to_f<T>(w[i]);
    wsh[1][i] = to_f<T>(w[kC + i]);
    wsh[2][i] = to_f<T>(w[2 * kC + i]);
  }
  __syncthreads();

  for (int c = blockIdx.x * kChunk; c < rows; c += gridDim.x * kChunk) {
    const int first = c + rlane;  // this thread's rows: first + u·kRowLanes
    int obj = first / p, pt = first - obj * p;
    uint4 dv[kUnroll];
    float xs[kUnroll][3], m[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int r = first + u * kRowLanes;
      dv[u] = make_uint4(0u, 0u, 0u, 0u);
      xs[u][0] = xs[u][1] = xs[u][2] = m[u] = 0.f;
      if (r < rows) {
        const T* xp = x + (size_t)obj * 3 * p + pt;
        dv[u] = *reinterpret_cast<const uint4*>(dh + (size_t)r * kC + c0);
        xs[u][0] = to_f<T>(xp[0]);
        xs[u][1] = to_f<T>(xp[p]);
        xs[u][2] = to_f<T>(xp[2 * p]);
        m[u] = to_f<T>(mask[obj]);
      }
      for (pt += kRowLanes; pt >= p; pt -= p) ++obj;
    }
    // h = round(x0·w0 + x1·w1 + x2·w2), dz = round(dh + m·ds1 + 2·h·m·ds2)
    // and the three sums of one row, given a1 = m·ds1 and a2 = m·ds2
    auto row = [&](int u, const float (&a1)[kVec], const float (&a2)[kVec]) {
      const T* de = reinterpret_cast<const T*>(&dv[u]);
      const float x0 = xs[u][0], x1 = xs[u][1], x2 = xs[u][2];
      float w0[kVec], w1[kVec], w2[kVec];
#pragma unroll
      for (int j = 0; j < kVec; j += 4) {
        const float4 a = lds4(&wsh[0][c0 + j]), b = lds4(&wsh[1][c0 + j]),
                     d = lds4(&wsh[2][c0 + j]);
        w0[j] = a.x, w0[j + 1] = a.y, w0[j + 2] = a.z, w0[j + 3] = a.w;
        w1[j] = b.x, w1[j + 1] = b.y, w1[j + 2] = b.z, w1[j + 3] = b.w;
        w2[j] = d.x, w2[j + 1] = d.y, w2[j + 2] = d.z, w2[j + 3] = d.w;
      }
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const float h = round_to<T>(x0 * w0[e] + x1 * w1[e] + x2 * w2[e]);
        const float dz = round_to<T>(to_f<T>(de[e]) + a1[e] + 2.f * h * a2[e]);
        g[0][e] = fmaf(x0, dz, g[0][e]);
        g[1][e] = fmaf(x1, dz, g[1][e]);
        g[2][e] = fmaf(x2, dz, g[2][e]);
      }
    };
    bool same = true;
#pragma unroll
    for (int u = 1; u < kUnroll; ++u) same = same && m[u] == m[0];
    if (same) {  // the rows' objects share a mask value (nearly always)
      float a1[kVec], a2[kVec];
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        a1[e] = m[0] * dsh[0][c0 + e];
        a2[e] = m[0] * dsh[1][c0 + e];
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) row(u, a1, a2);
    } else {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        float a1[kVec], a2[kVec];
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          a1[e] = m[u] * dsh[0][c0 + e];
          a2[e] = m[u] * dsh[1][c0 + e];
        }
        row(u, a1, a2);
      }
    }
  }
  // bf16: the two rows of a warp share each channel group
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int e = 0; e < kVec; ++e)
#pragma unroll
      for (int off = kLanes; off < 32; off <<= 1)
        g[k][e] += __shfl_xor_sync(0xffffffffu, g[k][e], off);
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 < kLanes)
#pragma unroll
    for (int k = 0; k < 3; ++k)
#pragma unroll
      for (int e = 0; e < kVec; ++e) part[warp][k * kC + c0 + e] = g[k][e];
  __syncthreads();
  // the warps' shares, added in order, into the block's slice
  for (int i = threadIdx.x; i < kGrad; i += kThreads) {
    float sum = 0.f;
#pragma unroll
    for (int wi = 0; wi < kWarps; ++wi) sum += part[wi][i];
    scratch[(size_t)blockIdx.x * slice_stride(kGrad) + i] = sum;
  }
}

template <typename T>
int launch(const void* x, const void* w, const void* mask, const void* dh, const float* ds1,
           const float* ds2, float* scratch, int blocks, float* dw, int o, int p,
           cudaStream_t st) {
  if ((uintptr_t)dh & 15) return (int)cudaErrorMisalignedAddress;
  // row indices stay ints: the rows, and one grid step past them
  if ((long long)o * p > INT_MAX / 2) return (int)cudaErrorInvalidValue;
  embed_first_bwd_stream_kernel<T><<<blocks, kThreads, 0, st>>>(
      (const T*)x, (const T*)w, (const T*)mask, (const T*)dh, ds1, ds2, scratch, o * p, p);
  if (int rc = (int)cudaGetLastError()) return rc;
  return reduce_slices(scratch, slice_stride(kGrad), blocks, dw, kGrad, st);
}

}  // namespace
}  // namespace sga

extern "C" {

// Rows one block takes per step (its row lanes times the unroll): the
// wrapper sizes the grid by it
int sga_embed_first_bwd_rows_per_block(int dtype) {
  const int lanes = sga::kC / (dtype == sga::kBF16 ? 8 : 4);
  return sga::kThreads / lanes * sga::kUnroll;
}

// dW0 [3, 128] f32; scratch holds `blocks` slices of slice_stride(384)
// floats, one per block of the launch
int sga_embed_first_bwd(const void* x, const void* w, const void* mask, const void* dh,
                        const float* ds1, const float* ds2, float* scratch, int blocks, float* dw,
                        int o, int p, int dtype, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == sga::kBF16)
    return sga::launch<sga::bf16>(x, w, mask, dh, ds1, ds2, scratch, blocks, dw, o, p, st);
  return sga::launch<float>(x, w, mask, dh, ds1, ds2, scratch, blocks, dw, o, p, st);
}

}  // extern "C"
