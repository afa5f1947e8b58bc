// The PCT attention passes that do not depend on how a width's weights are
// staged, templated on the channels kC and the q/k width kDa: the
// log-sum-exp pass, the apply loop of one row tile (attend_tile) and the
// backward's dv pass. pct_attention.cu instantiates them at C = 128,
// da = 32, pct_attention_c256.cu at C = 256, da = 64; pct_attention.cu's
// header comment sets out the notation and what each pass computes.
#pragma once

#include "common.cuh"

namespace sga {
namespace {

constexpr int kRows = 64;     // rows per tile, keys per chunk
constexpr int kThreads = 256;

// Copy a [rows, cols] tile of dY, each row r scaled by scale[r] (1/s, OA's
// dŶ) and rounded to T; rows >= valid_rows are zero-filled.
template <typename T>
__device__ __forceinline__ void load_rows_scaled(T* dst, int ld_s, const T* __restrict__ src,
                                                 long long ld_g, int rows, int cols, int valid_rows,
                                                 const float* __restrict__ scale) {
  for (int idx = threadIdx.x; idx < rows * cols; idx += blockDim.x) {
    const int r = idx / cols, c = idx % cols;
    const float val = r < valid_rows ? to_f<T>(src[r * ld_g + c]) * scale[r] : 0.f;
    dst[r * ld_s + c] = from_f<T>(val);
  }
}

// ------------------------------- pass 2: lse -------------------------------

template <typename T, int kDa>
struct LseSmem {
  static constexpr int ldq = pad_ld<T>(kDa), lds = pad_ldf(kRows);
  static constexpr size_t qt_off = 0;
  static constexpr size_t qc_off = align128(qt_off + sizeof(T) * kRows * ldq);
  static constexpr size_t s_off = align128(qc_off + sizeof(T) * kRows * ldq);
  static constexpr size_t bytes = align128(s_off + sizeof(float) * kRows * lds);
};

// 4 lanes per row: lane `sub` of row r owns columns sub, sub + 4, ...
__device__ __forceinline__ void merge_lse(float& m, float& l) {
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
    const float l2 = __shfl_xor_sync(0xffffffffu, l, off);
    const float mm = fmaxf(m, m2);
    l = (m == -INFINITY ? 0.f : l * expf(m - mm)) + (m2 == -INFINITY ? 0.f : l2 * expf(m2 - mm));
    m = mm;
  }
}

// sum over the 4 lanes of a row (lanes sub = 0..3 of one quad)
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

template <typename T, int kDa>
__global__ void __launch_bounds__(kThreads)
lse_kernel(const T* __restrict__ q, float* __restrict__ lse, int o, int p) {
  using L = LseSmem<T, kDa>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sqt = reinterpret_cast<T*>(smem + L::qt_off);
  T* sqc = reinterpret_cast<T*>(smem + L::qc_off);
  float* ss = reinterpret_cast<float*>(smem + L::s_off);

  const int row = threadIdx.x / 4, sub = threadIdx.x % 4;
  const int per_obj = (p + kRows - 1) / kRows;
  const long long tiles = (long long)o * per_obj;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int obj = (int)(t / per_obj), r0 = (int)(t % per_obj) * kRows;
    const T* qo = q + (size_t)obj * p * kDa;
    load_tile<T>(sqt, L::ldq, qo + (size_t)r0 * kDa, kDa, kRows, kDa, min(kRows, p - r0));
    float m = -INFINITY, l = 0.f;
    for (int c0 = 0; c0 < p; c0 += kRows) {
      const int kv = min(kRows, p - c0);
      load_tile<T>(sqc, L::ldq, qo + (size_t)c0 * kDa, kDa, kRows, kDa, kv);
      __syncthreads();
      block_gemm<T, true>(sqt, L::ldq, sqc, L::ldq, ss, L::lds, kRows, kRows, kDa, false);
      __syncthreads();
      float cm = -INFINITY;
      for (int j = sub; j < kv; j += 4) cm = fmaxf(cm, ss[row * L::lds + j]);
      if (cm != -INFINITY) {
        const float mm = fmaxf(m, cm);
        float acc = (m == -INFINITY) ? 0.f : l * expf(m - mm);
        for (int j = sub; j < kv; j += 4) acc += expf(ss[row * L::lds + j] - mm);
        m = mm;
        l = acc;
      }
      __syncthreads();
    }
    merge_lse(m, l);
    if (sub == 0 && r0 + row < p) lse[(size_t)obj * p + r0 + row] = m + logf(l);
  }
}

// ------------------------------ pass 3: apply ------------------------------

// y of one 64-row tile (rows r0.. of the object starting at row ob):
// sy[r, c] = Σ_k G[r, k]·v[k, c] with G = exp(E − lse_k) rounded to T, and
// srs[r] = Σ_k G[r, k] (OA's row sums). L: the pass's shared-memory layout
// (the tiles qt, y, rs, lc and the key loop's qc, vc, s, g). Ends
// synchronised.
template <typename T, typename L, int kC, int kDa>
__device__ void attend_tile(unsigned char* smem, const T* __restrict__ q, const T* __restrict__ v,
                            const float* __restrict__ lse, size_t ob, int r0, int valid, int p) {
  T* sqt = reinterpret_cast<T*>(smem + L::qt_off);
  float* sy = reinterpret_cast<float*>(smem + L::y_off);
  float* srs = reinterpret_cast<float*>(smem + L::rs_off);
  float* slc = reinterpret_cast<float*>(smem + L::lc_off);
  T* sqc = reinterpret_cast<T*>(smem + L::qc_off);
  T* svc = reinterpret_cast<T*>(smem + L::vc_off);
  float* ss = reinterpret_cast<float*>(smem + L::s_off);
  T* sg = reinterpret_cast<T*>(smem + L::g_off);

  const int row = threadIdx.x / 4, sub = threadIdx.x % 4;
  load_tile<T>(sqt, L::ldq, q + (ob + r0) * kDa, kDa, kRows, kDa, valid);
  if (threadIdx.x < kRows) srs[threadIdx.x] = 0.f;
  for (int c0 = 0; c0 < p; c0 += kRows) {
    const int kv = min(kRows, p - c0);
    load_tile<T>(sqc, L::ldq, q + (ob + c0) * kDa, kDa, kRows, kDa, kv);
    load_tile<T>(svc, L::ldv, v + (ob + c0) * kC, kC, kRows, kC, kv);
    if (threadIdx.x < kRows) slc[threadIdx.x] = threadIdx.x < kv ? lse[ob + c0 + threadIdx.x] : 0.f;
    __syncthreads();
    block_gemm<T, true>(sqt, L::ldq, sqc, L::ldq, ss, L::lds, kRows, kRows, kDa, false);
    __syncthreads();
    float part = 0.f;
    for (int j = sub; j < kRows; j += 4) {
      const float g = j < kv ? expf(ss[row * L::lds + j] - slc[j]) : 0.f;
      const T gt = from_f<T>(g);
      sg[row * L::ldg + j] = gt;
      part += to_f<T>(gt);
    }
    part = quad_sum(part);
    if (sub == 0) srs[row] += part;
    __syncthreads();
    block_gemm<T, false>(sg, L::ldg, svc, L::ldv, sy, L::ldy, kRows, kC, kRows, c0 > 0);
    __syncthreads();
  }
}

// ------------------------------- backward: dv -------------------------------

template <typename T, bool OA, int kC, int kDa>
struct DvSmem {
  static constexpr int ldq = pad_ld<T>(kDa), ldc = pad_ld<T>(kC), ldg = pad_ld<T>(kRows);
  static constexpr int lds = pad_ldf(kRows), ldv = pad_ldf(kC);
  static constexpr size_t qi_off = 0;
  static constexpr size_t qj_off = align128(qi_off + sizeof(T) * kRows * ldq);
  static constexpr size_t dy_off = align128(qj_off + sizeof(T) * kRows * ldq);
  static constexpr size_t s_off = align128(dy_off + sizeof(T) * kRows * ldc);
  static constexpr size_t g_off = align128(s_off + sizeof(float) * kRows * lds);
  static constexpr size_t dv_off = align128(g_off + sizeof(T) * kRows * ldg);
  static constexpr size_t l_off = align128(dv_off + sizeof(float) * kRows * ldv);
  // lse of the key tile; OA: c of the row tile too
  static constexpr size_t bytes = align128(l_off + sizeof(float) * (OA ? 2 : 1) * kRows);
};

// dv pass: per key tile I, dv_I = Σ_J G_JIᵀ·dŶ_J with G[j, i] = exp(E[j,i] −
// lse_i); writes dv (rounded) and D_i = v_i·dv_i (f32), less Σ_j G[j, i]·c_j
// for OA.
template <typename T, bool OA, int kC, int kDa>
__global__ void __launch_bounds__(kThreads)
bwd_dv_kernel(const T* __restrict__ q, const T* __restrict__ v, const float* __restrict__ lse,
              const T* __restrict__ dy, const float* __restrict__ sc, T* __restrict__ dv,
              float* __restrict__ dd, int o, int p) {
  using L = DvSmem<T, OA, kC, kDa>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sqi = reinterpret_cast<T*>(smem + L::qi_off);
  T* sqj = reinterpret_cast<T*>(smem + L::qj_off);
  T* sdy = reinterpret_cast<T*>(smem + L::dy_off);
  float* ss = reinterpret_cast<float*>(smem + L::s_off);
  T* sg = reinterpret_cast<T*>(smem + L::g_off);
  float* sdv = reinterpret_cast<float*>(smem + L::dv_off);
  float* sl = reinterpret_cast<float*>(smem + L::l_off);
  float* scj = sl + kRows;  // OA

  const long long rows = (long long)o * p;
  const int row = threadIdx.x / 4, sub = threadIdx.x % 4;
  const int per_obj = (p + kRows - 1) / kRows;
  const long long tiles = (long long)o * per_obj;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int obj = (int)(t / per_obj), i0 = (int)(t % per_obj) * kRows;
    const int valid = min(kRows, p - i0);
    const size_t ob = (size_t)obj * p;
    load_tile<T>(sqi, L::ldq, q + (ob + i0) * kDa, kDa, kRows, kDa, valid);
    if (threadIdx.x < kRows) sl[threadIdx.x] = threadIdx.x < valid ? lse[ob + i0 + threadIdx.x] : 0.f;
    float gc = 0.f;  // OA: Σ_j G[j, i]·c_j of column i = row, this lane's rows
    for (int j0 = 0; j0 < p; j0 += kRows) {
      const int kv = min(kRows, p - j0);
      load_tile<T>(sqj, L::ldq, q + (ob + j0) * kDa, kDa, kRows, kDa, kv);
      if constexpr (OA) {
        load_rows_scaled<T>(sdy, L::ldc, dy + (ob + j0) * kC, kC, kRows, kC, kv, sc + ob + j0);
        if (threadIdx.x < kRows) scj[threadIdx.x] = threadIdx.x < kv ? sc[rows + ob + j0 + threadIdx.x] : 0.f;
      } else {
        load_tile<T>(sdy, L::ldc, dy + (ob + j0) * kC, kC, kRows, kC, kv);
      }
      __syncthreads();
      block_gemm<T, true>(sqj, L::ldq, sqi, L::ldq, ss, L::lds, kRows, kRows, kDa, false);
      __syncthreads();
      for (int idx = threadIdx.x; idx < kRows * kRows; idx += blockDim.x) {
        const int j = idx / kRows, i = idx % kRows;
        const float g = j < kv ? expf(ss[j * L::lds + i] - sl[i]) : 0.f;
        sg[j * L::ldg + i] = from_f<T>(g);
      }
      __syncthreads();
      if constexpr (OA)
        for (int j = sub; j < kv; j += 4) gc += to_f<T>(sg[j * L::ldg + row]) * scj[j];
      block_gemm<T, false, true>(sg, L::ldg, sdy, L::ldc, sdv, L::ldv, kRows, kC, kRows, j0 > 0);
      __syncthreads();
    }
    for (int idx = threadIdx.x; idx < valid * kC; idx += blockDim.x) {
      const int r = idx / kC, cc = idx % kC;
      dv[(ob + i0 + r) * kC + cc] = from_f<T>(sdv[r * L::ldv + cc]);
    }
    float d = 0.f;
    if (row < valid)
      for (int cc = sub; cc < kC; cc += 4)
        d = fmaf(sdv[row * L::ldv + cc], to_f<T>(v[(ob + i0 + row) * kC + cc]), d);
    d = quad_sum(d);
    if constexpr (OA) d -= quad_sum(gc);
    if (sub == 0 && row < valid) dd[ob + i0 + row] = d;
    __syncthreads();
  }
}

}  // namespace
}  // namespace sga
