// The f32 PCT attention passes that do not depend on how a width's weights
// are staged, templated on the channels kC and the q/k width kDa: the
// log-sum-exp pass, the apply loop of one row tile (attend_tile), the
// attention op's output and OA sc passes, and the backward's dv pass, on
// block_gemm's tiles. pct_attention_c256.cu instantiates them at C = 256,
// da = 64 (the f32 C = 128 forms run attn_f32.cuh's passes instead, with
// merge_lse and quad_sum from here); pct_attention.cu's header comment sets
// out the notation and what each pass computes. Each loop over key chunks
// fetches the next chunk with cp.async while the current one's products and
// exponentials run.
#pragma once

#include "common.cuh"

namespace sga {
namespace {

constexpr int kRows = 64;     // rows per tile, keys per chunk
constexpr int kThreads = 256;

// Scale the rows r < valid of a tile that this thread copied with
// load_tile_async by scale[r] (on its own 16-byte chunks, so no other
// thread's copy need be complete)
__device__ __forceinline__ void scale_own_rows(float* dst, int ld_s, int rows, int cols, int valid,
                                               const float* __restrict__ scale) {
  constexpr int kVec = 16 / sizeof(float);
  const int vcols = cols / kVec;
  for (int idx = threadIdx.x; idx < rows * vcols; idx += blockDim.x) {
    const int r = idx / vcols, cv = idx % vcols;
    if (r >= valid) continue;
    const float sr = scale[r];
    float* d = dst + r * ld_s + cv * kVec;
#pragma unroll
    for (int e = 0; e < kVec; ++e) d[e] = d[e] * sr;
  }
}

// ------------------------------- pass 2: lse -------------------------------

template <int kDa>
struct LseSmem {
  static constexpr int ldq = pad_ld<float>(kDa), lds = pad_ldf(kRows);
  static constexpr size_t qt_off = 0;
  static constexpr size_t qc_off = align128(qt_off + sizeof(float) * kRows * ldq);
  static constexpr size_t s_off = align128(qc_off + sizeof(float) * kRows * ldq);
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

template <int kDa>
__global__ void __launch_bounds__(kThreads)
lse_kernel(const float* __restrict__ q, float* __restrict__ lse, int o, int p) {
  using L = LseSmem<kDa>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* sqt = reinterpret_cast<float*>(smem + L::qt_off);
  float* sqc = reinterpret_cast<float*>(smem + L::qc_off);
  float* ss = reinterpret_cast<float*>(smem + L::s_off);

  const int row = threadIdx.x / 4, sub = threadIdx.x % 4;
  const int per_obj = (p + kRows - 1) / kRows;
  const long long tiles = (long long)o * per_obj;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int obj = (int)(t / per_obj), r0 = (int)(t % per_obj) * kRows;
    const float* qo = q + (size_t)obj * p * kDa;
    // the key chunks by cp.async: chunk c + 1 arrives while chunk c's
    // exponentials run
    load_tile_async<float>(sqt, L::ldq, qo + (size_t)r0 * kDa, kDa, kRows, kDa, min(kRows, p - r0));
    load_tile_async<float>(sqc, L::ldq, qo, kDa, kRows, kDa, min(kRows, p));
    cp_async_commit();
    float m = -INFINITY, l = 0.f;
    for (int c0 = 0; c0 < p; c0 += kRows) {
      const int kv = min(kRows, p - c0);
      cp_async_wait<0>();
      __syncthreads();
      block_gemm<true, false, kRows, kRows, kDa>(sqt, L::ldq, sqc, L::ldq, ss, L::lds, false);
      __syncthreads();
      if (c0 + kRows < p) {
        load_tile_async<float>(sqc, L::ldq, qo + (size_t)(c0 + kRows) * kDa, kDa, kRows, kDa,
                               min(kRows, p - c0 - kRows));
        cp_async_commit();
      }
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
// sy[r, c] = Σ_k G[r, k]·v[k, c] with G = exp(E − lse_k), and
// srs[r] = Σ_k G[r, k] (OA's row sums). L: the pass's shared-memory layout
// (the tiles qt, y, rs, lc and the key loop's qc, vc, s, g). The key
// chunks arrive by cp.async: chunk c + 1's q while chunk c's exponentials
// and G·v run, its v while chunk c + 1's S runs. Ends synchronised, with no
// copy in flight.
template <typename L, int kC, int kDa>
__device__ void attend_tile(unsigned char* smem, const float* __restrict__ q,
                            const float* __restrict__ v, const float* __restrict__ lse, size_t ob,
                            int r0, int valid, int p) {
  float* sqt = reinterpret_cast<float*>(smem + L::qt_off);
  float* sy = reinterpret_cast<float*>(smem + L::y_off);
  float* srs = reinterpret_cast<float*>(smem + L::rs_off);
  float* slc = reinterpret_cast<float*>(smem + L::lc_off);
  float* sqc = reinterpret_cast<float*>(smem + L::qc_off);
  float* svc = reinterpret_cast<float*>(smem + L::vc_off);
  float* ss = reinterpret_cast<float*>(smem + L::s_off);
  float* sg = reinterpret_cast<float*>(smem + L::g_off);

  const int row = threadIdx.x / 4, sub = threadIdx.x % 4;
  load_tile_async<float>(sqt, L::ldq, q + (ob + r0) * kDa, kDa, kRows, kDa, valid);
  load_tile_async<float>(sqc, L::ldq, q + ob * kDa, kDa, kRows, kDa, min(kRows, p));
  cp_async_commit();
  load_tile_async<float>(svc, L::ldv, v + ob * kC, kC, kRows, kC, min(kRows, p));
  cp_async_commit();
  if (threadIdx.x < kRows) srs[threadIdx.x] = 0.f;
  for (int c0 = 0; c0 < p; c0 += kRows) {
    const int kv = min(kRows, p - c0);
    const bool more = c0 + kRows < p;
    if (threadIdx.x < kRows) slc[threadIdx.x] = threadIdx.x < kv ? lse[ob + c0 + threadIdx.x] : 0.f;
    cp_async_wait<1>();  // this chunk's q (its v may still be in flight)
    __syncthreads();
    block_gemm<true, false, kRows, kRows, kDa>(sqt, L::ldq, sqc, L::ldq, ss, L::lds, false);
    __syncthreads();
    if (more) {
      load_tile_async<float>(sqc, L::ldq, q + (ob + c0 + kRows) * kDa, kDa, kRows, kDa,
                             min(kRows, p - c0 - kRows));
      cp_async_commit();
    }
    float part = 0.f;
    for (int j = sub; j < kRows; j += 4) {
      const float g = j < kv ? expf(ss[row * L::lds + j] - slc[j]) : 0.f;
      sg[row * L::ldg + j] = g;
      part += g;
    }
    part = quad_sum(part);
    if (sub == 0) srs[row] += part;
    if (more)
      cp_async_wait<1>();  // this chunk's v (the next q may still be in flight)
    else
      cp_async_wait<0>();
    __syncthreads();
    block_gemm<false, false, kRows, kC, kRows>(sg, L::ldg, svc, L::ldv, sy, L::ldy, c0 > 0);
    __syncthreads();
    if (more) {
      load_tile_async<float>(svc, L::ldv, v + (ob + c0 + kRows) * kC, kC, kRows, kC,
                             min(kRows, p - c0 - kRows));
      cp_async_commit();
    }
  }
}

// ------------------------- the attention op's passes -------------------------

// pct_attn_fwd's output pass: y = Σ G·v (OA: divided by s), four channels a
// thread (L: the apply layout, attend_tile's tiles)
template <typename L, int kC, int kDa, bool OA>
__global__ void __launch_bounds__(kThreads)
attn_out_kernel(const float* __restrict__ q, const float* __restrict__ v,
                const float* __restrict__ lse, float* __restrict__ y, int o, int p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const float* sy = reinterpret_cast<const float*>(smem + L::y_off);
  const float* srs = reinterpret_cast<const float*>(smem + L::rs_off);

  const int per_obj = (p + kRows - 1) / kRows;
  const long long tiles = (long long)o * per_obj;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int obj = (int)(t / per_obj), r0 = (int)(t % per_obj) * kRows;
    const int valid = min(kRows, p - r0);
    const size_t ob = (size_t)obj * p;
    attend_tile<L, kC, kDa>(smem, q, v, lse, ob, r0, valid, p);
    for (int idx = threadIdx.x; idx < valid * (kC / 4); idx += blockDim.x) {
      const int r = idx / (kC / 4), c = 4 * (idx % (kC / 4));
      float4 a = *reinterpret_cast<const float4*>(sy + r * L::ldy + c);
      if constexpr (OA) {
        const float s = 1e-9f + srs[r];
        a = make_float4(a.x / s, a.y / s, a.z / s, a.w / s);
      }
      store4<float>(y + (ob + r0 + r) * kC + c, a.x, a.y, a.z, a.w);
    }
    __syncthreads();
  }
}

// pct_attn_bwd's OA pass: per row, 1/s_j into sc[0..rows) and
// c_j = (dY_j / s_j)·(y_j / s_j) into sc[rows..2·rows), y and s recomputed
// by attend_tile, dY read from the caller's rows
template <typename L, int kC, int kDa>
__global__ void __launch_bounds__(kThreads)
attn_sc_kernel(const float* __restrict__ q, const float* __restrict__ v,
               const float* __restrict__ lse, const float* __restrict__ dy,
               float* __restrict__ sc, int o, int p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const float* sy = reinterpret_cast<const float*>(smem + L::y_off);
  const float* srs = reinterpret_cast<const float*>(smem + L::rs_off);

  const long long rows = (long long)o * p;
  const int row = threadIdx.x / 4, sub = threadIdx.x % 4;
  const int per_obj = (p + kRows - 1) / kRows;
  const long long tiles = (long long)o * per_obj;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int obj = (int)(t / per_obj), r0 = (int)(t % per_obj) * kRows;
    const int valid = min(kRows, p - r0);
    const size_t ob = (size_t)obj * p;
    attend_tile<L, kC, kDa>(smem, q, v, lse, ob, r0, valid, p);
    const float inv = 1.f / (1e-9f + srs[row]);
    float c = 0.f;
    if (row < valid)
      for (int cc = sub; cc < kC; cc += 4)
        c += (dy[(ob + r0 + row) * kC + cc] * inv) * (sy[row * L::ldy + cc] * inv);
    c = quad_sum(c);
    if (sub == 0 && row < valid) {
      sc[ob + r0 + row] = inv;
      sc[rows + ob + r0 + row] = c;
    }
    __syncthreads();
  }
}

// ------------------------------- backward: dv -------------------------------

template <bool OA, int kC, int kDa>
struct DvSmem {
  static constexpr int ldq = pad_ld<float>(kDa), ldc = pad_ld<float>(kC);
  static constexpr int ldg = pad_ld<float>(kRows);
  static constexpr int lds = pad_ldf(kRows), ldv = pad_ldf(kC);
  static constexpr size_t qi_off = 0;
  static constexpr size_t qj_off = align128(qi_off + sizeof(float) * kRows * ldq);
  static constexpr size_t dy_off = align128(qj_off + sizeof(float) * kRows * ldq);
  static constexpr size_t s_off = align128(dy_off + sizeof(float) * kRows * ldc);
  static constexpr size_t g_off = align128(s_off + sizeof(float) * kRows * lds);
  static constexpr size_t dv_off = align128(g_off + sizeof(float) * kRows * ldg);
  static constexpr size_t l_off = align128(dv_off + sizeof(float) * kRows * ldv);
  // lse of the key tile; OA: c of the row tile too
  static constexpr size_t bytes = align128(l_off + sizeof(float) * (OA ? 2 : 1) * kRows);
};

// dv pass: per key tile I, dv_I = Σ_J G_JIᵀ·dŶ_J with G[j, i] = exp(E[j,i] −
// lse_i); writes dv (rounded) and D_i = v_i·dv_i (f32), less Σ_j G[j, i]·c_j
// for OA.
template <bool OA, int kC, int kDa>
__global__ void __launch_bounds__(kThreads)
bwd_dv_kernel(const float* __restrict__ q, const float* __restrict__ v,
              const float* __restrict__ lse, const float* __restrict__ dy,
              const float* __restrict__ sc, float* __restrict__ dv, float* __restrict__ dd, int o,
              int p) {
  using L = DvSmem<OA, kC, kDa>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* sqi = reinterpret_cast<float*>(smem + L::qi_off);
  float* sqj = reinterpret_cast<float*>(smem + L::qj_off);
  float* sdy = reinterpret_cast<float*>(smem + L::dy_off);
  float* ss = reinterpret_cast<float*>(smem + L::s_off);
  float* sg = reinterpret_cast<float*>(smem + L::g_off);
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
    // the key tiles by cp.async: tile j + 1's q while tile j's G and
    // Gᵀ·dŶ run, its dY while tile j + 1's S runs
    load_tile_async<float>(sqi, L::ldq, q + (ob + i0) * kDa, kDa, kRows, kDa, valid);
    load_tile_async<float>(sqj, L::ldq, q + ob * kDa, kDa, kRows, kDa, min(kRows, p));
    cp_async_commit();
    load_tile_async<float>(sdy, L::ldc, dy + ob * kC, kC, kRows, kC, min(kRows, p));
    cp_async_commit();
    if (threadIdx.x < kRows) sl[threadIdx.x] = threadIdx.x < valid ? lse[ob + i0 + threadIdx.x] : 0.f;
    float gc = 0.f;  // OA: Σ_j G[j, i]·c_j of column i = row, this lane's rows
    for (int j0 = 0; j0 < p; j0 += kRows) {
      const int kv = min(kRows, p - j0);
      const bool more = j0 + kRows < p;
      if constexpr (OA)
        if (threadIdx.x < kRows) scj[threadIdx.x] = threadIdx.x < kv ? sc[rows + ob + j0 + threadIdx.x] : 0.f;
      cp_async_wait<1>();  // this tile's q (its dY may still be in flight)
      __syncthreads();
      block_gemm<true, false, kRows, kRows, kDa>(sqj, L::ldq, sqi, L::ldq, ss, L::lds, false);
      __syncthreads();
      if (more) {
        load_tile_async<float>(sqj, L::ldq, q + (ob + j0 + kRows) * kDa, kDa, kRows, kDa,
                               min(kRows, p - j0 - kRows));
        cp_async_commit();
      }
      for (int idx = threadIdx.x; idx < kRows * kRows; idx += blockDim.x) {
        const int j = idx / kRows, i = idx % kRows;
        const float g = j < kv ? expf(ss[j * L::lds + i] - sl[i]) : 0.f;
        sg[j * L::ldg + i] = g;
      }
      if (more)
        cp_async_wait<1>();  // this tile's dY (the next q may still be in flight)
      else
        cp_async_wait<0>();
      // OA's dŶ = dY·(1/s): each thread scales the chunks it copied
      if constexpr (OA) scale_own_rows(sdy, L::ldc, kRows, kC, kv, sc + ob + j0);
      __syncthreads();
      if constexpr (OA)
        for (int j = sub; j < kv; j += 4) gc += sg[j * L::ldg + row] * scj[j];
      block_gemm<false, true, kRows, kC, kRows>(sg, L::ldg, sdy, L::ldc, sdv, L::ldv, j0 > 0);
      __syncthreads();
      if (more) {
        load_tile_async<float>(sdy, L::ldc, dy + (ob + j0 + kRows) * kC, kC, kRows, kC,
                               min(kRows, p - j0 - kRows));
        cp_async_commit();
      }
    }
    for (int idx = threadIdx.x; idx < valid * kC; idx += blockDim.x) {
      const int r = idx / kC, cc = idx % kC;
      dv[(ob + i0 + r) * kC + cc] = sdv[r * L::ldv + cc];
    }
    float d = 0.f;
    if (row < valid)
      for (int cc = sub; cc < kC; cc += 4)
        d = fmaf(sdv[row * L::ldv + cc], v[(ob + i0 + row) * kC + cc], d);
    d = quad_sum(d);
    if constexpr (OA) d -= quad_sum(gc);
    if (sub == 0 && row < valid) dd[ob + i0 + row] = d;
    __syncthreads();
  }
}

}  // namespace
}  // namespace sga
