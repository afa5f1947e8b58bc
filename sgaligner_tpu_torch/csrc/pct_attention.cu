// PCT self-attention block, inference form (SA and OA).
//
// Replaces sgaligner_tpu/ops/pct_attention.py::pct_block_eval (Pallas kernel
// _block_eval_kernel). Per object, with x [P, 128]:
//   q = x·Wqk (Wqk already scaled by da^-1/4 for SA), v = x·Wv + bv, both
//   rounded to the compute dtype;
//   E = q·qᵀ [P, P] (symmetric: q doubles as k);
//   y[p] = Σ_q exp(E[p,q] − lse_q)·v[q], lse_q = log Σ_p exp(E[p,q]) — the
//   column softmax of E applied to v (the reference's transposed apply);
//   OA divides each row by 1e-9 + Σ_q exp(E[p,q] − lse_q);
//   u = y (SA) or x − y (OA); t = u·Wt + bt (rounded);
//   out = x + relu(t·wbn + bbn), with (wbn, bbn) the BN affine folded from
//   running statistics.
// The [P, P] energies never reach device memory.
//   Bound on the H100: operations. 2·P·C·(da + C) for the projections,
//   2·P²·da for E and 2·P²·C for y, 2·P·C² for t: 126 MFLOP per object at
//   P = 512, C = 128, da = 32, against 2·P·C elements in and out.
//   Design: the softmax normaliser runs over the KEY axis (columns), so an
//   online (flash-style) row softmax does not apply. By symmetry of E the
//   column log-sum-exp of key q equals the row log-sum-exp of row q, which
//   gives three grid-stride passes over 64-row tiles:
//     1. project: q and v of a tile, Wqk and Wv resident in shared memory;
//     2. lse: for a tile of rows, an online max / sum-exp over all P columns
//        of E, recomputing E from q in 64-column chunks (f32);
//     3. apply: for a tile of rows, walk the keys in 64-chunks: S = q_tile·
//        q_chunkᵀ, G = exp(S − lse) rounded to the compute dtype, y += G·v
//        (tensor cores for bf16); then the residual epilogue with Wt resident.
//   E is computed twice (passes 2 and 3), 2·P²·da extra FLOP, an eighth of
//   the 2·P²·C of the y product. The normaliser is an f32 log-sum-exp where
//   the TPU kernel exponentiated in the compute dtype against a column max.
#include "common.cuh"

namespace sga {
namespace {

constexpr int kC = 128;       // channels
constexpr int kDa = 32;       // q/k width (C / 4)
constexpr int kRows = 64;     // rows per tile, keys per chunk
constexpr int kThreads = 256;

// ----------------------------- pass 1: project -----------------------------

template <typename T>
struct ProjSmem {
  static constexpr int ldx = pad_ld<T>(kC), ldq = pad_ld<T>(kDa), ldv = pad_ld<T>(kC);
  static constexpr int ldcq = pad_ldf(kDa), ldcv = pad_ldf(kC);
  static constexpr size_t wq_off = 0;
  static constexpr size_t wv_off = align128(wq_off + sizeof(T) * kC * ldq);
  static constexpr size_t x_off = align128(wv_off + sizeof(T) * kC * ldv);
  static constexpr size_t cq_off = align128(x_off + sizeof(T) * kRows * ldx);
  static constexpr size_t cv_off = align128(cq_off + sizeof(float) * kRows * ldcq);
  static constexpr size_t bytes = align128(cv_off + sizeof(float) * kRows * ldcv);
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
project_kernel(const T* __restrict__ x, const T* __restrict__ wqk, const T* __restrict__ wv,
               const T* __restrict__ bv, T* __restrict__ q, T* __restrict__ v, int o, int p) {
  using L = ProjSmem<T>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* swq = reinterpret_cast<T*>(smem + L::wq_off);
  T* swv = reinterpret_cast<T*>(smem + L::wv_off);
  T* sx = reinterpret_cast<T*>(smem + L::x_off);
  float* cq = reinterpret_cast<float*>(smem + L::cq_off);
  float* cv = reinterpret_cast<float*>(smem + L::cv_off);

  load_tile<T>(swq, L::ldq, wqk, kDa, kC, kDa, kC);
  load_tile<T>(swv, L::ldv, wv, kC, kC, kC, kC);
  const int per_obj = (p + kRows - 1) / kRows;
  const long long tiles = (long long)o * per_obj;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int obj = (int)(t / per_obj), r0 = (int)(t % per_obj) * kRows;
    const int valid = min(kRows, p - r0);
    const size_t row0 = (size_t)obj * p + r0;
    load_tile<T>(sx, L::ldx, x + row0 * kC, kC, kRows, kC, valid);
    __syncthreads();
    block_gemm<T, false>(sx, L::ldx, swq, L::ldq, cq, L::ldcq, kRows, kDa, kC, false);
    block_gemm<T, false>(sx, L::ldx, swv, L::ldv, cv, L::ldcv, kRows, kC, kC, false);
    __syncthreads();
    for (int idx = threadIdx.x; idx < valid * kDa; idx += blockDim.x) {
      const int r = idx / kDa, d = idx % kDa;
      q[(row0 + r) * kDa + d] = from_f<T>(cq[r * L::ldcq + d]);
    }
    for (int idx = threadIdx.x; idx < valid * kC; idx += blockDim.x) {
      const int r = idx / kC, c = idx % kC;
      v[(row0 + r) * kC + c] = from_f<T>(cv[r * L::ldcv + c] + to_f<T>(bv[c]));
    }
    __syncthreads();
  }
}

// ------------------------------- pass 2: lse -------------------------------

template <typename T>
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
lse_kernel(const T* __restrict__ q, float* __restrict__ lse, int o, int p) {
  using L = LseSmem<T>;
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

template <typename T>
struct ApplySmem {
  static constexpr int ldq = pad_ld<T>(kDa), ldv = pad_ld<T>(kC), ldg = pad_ld<T>(kRows);
  static constexpr int ldw = pad_ld<T>(kC), ldu = pad_ld<T>(kC);
  static constexpr int lds = pad_ldf(kRows), ldy = pad_ldf(kC);
  static constexpr size_t wt_off = 0;
  static constexpr size_t qt_off = align128(wt_off + sizeof(T) * kC * ldw);
  static constexpr size_t y_off = align128(qt_off + sizeof(T) * kRows * ldq);
  static constexpr size_t rs_off = align128(y_off + sizeof(float) * kRows * ldy);
  static constexpr size_t lc_off = align128(rs_off + sizeof(float) * kRows);
  // key-loop buffers; the epilogue's U tile reuses this region
  static constexpr size_t qc_off = align128(lc_off + sizeof(float) * kRows);
  static constexpr size_t vc_off = align128(qc_off + sizeof(T) * kRows * ldq);
  static constexpr size_t s_off = align128(vc_off + sizeof(T) * kRows * ldv);
  static constexpr size_t g_off = align128(s_off + sizeof(float) * kRows * lds);
  static constexpr size_t loop_end = align128(g_off + sizeof(T) * kRows * ldg);
  static constexpr size_t u_off = qc_off;
  static constexpr size_t u_end = align128(u_off + sizeof(T) * kRows * ldu);
  static constexpr size_t bytes = loop_end > u_end ? loop_end : u_end;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
apply_kernel(const T* __restrict__ x, const T* __restrict__ q, const T* __restrict__ v,
             const float* __restrict__ lse, const T* __restrict__ wt, const T* __restrict__ bt,
             const float* __restrict__ wbn, const float* __restrict__ bbn, T* __restrict__ out,
             int o, int p, int oa) {
  using L = ApplySmem<T>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* swt = reinterpret_cast<T*>(smem + L::wt_off);
  T* sqt = reinterpret_cast<T*>(smem + L::qt_off);
  float* sy = reinterpret_cast<float*>(smem + L::y_off);  // y, then t
  float* srs = reinterpret_cast<float*>(smem + L::rs_off);
  float* slc = reinterpret_cast<float*>(smem + L::lc_off);
  T* sqc = reinterpret_cast<T*>(smem + L::qc_off);
  T* svc = reinterpret_cast<T*>(smem + L::vc_off);
  float* ss = reinterpret_cast<float*>(smem + L::s_off);
  T* sg = reinterpret_cast<T*>(smem + L::g_off);
  T* su = reinterpret_cast<T*>(smem + L::u_off);

  load_tile<T>(swt, L::ldw, wt, kC, kC, kC, kC);
  const int row = threadIdx.x / 4, sub = threadIdx.x % 4;
  const int per_obj = (p + kRows - 1) / kRows;
  const long long tiles = (long long)o * per_obj;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int obj = (int)(t / per_obj), r0 = (int)(t % per_obj) * kRows;
    const int valid = min(kRows, p - r0);
    const size_t ob = (size_t)obj * p;
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
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      if (sub == 0) srs[row] += part;
      __syncthreads();
      block_gemm<T, false>(sg, L::ldg, svc, L::ldv, sy, L::ldy, kRows, kC, kRows, c0 > 0);
      __syncthreads();
    }
    // u = y (SA) or x − y (OA), each rounded to T
    for (int idx = threadIdx.x; idx < kRows * kC; idx += blockDim.x) {
      const int r = idx / kC, c = idx % kC;
      float u = 0.f;
      if (r < valid) {
        float y = sy[r * L::ldy + c];
        if (oa) y = y / (1e-9f + srs[r]);
        u = round_to<T>(y);
        if (oa) u = to_f<T>(x[(ob + r0 + r) * kC + c]) - u;
      }
      su[r * L::ldu + c] = from_f<T>(u);
    }
    __syncthreads();
    block_gemm<T, false>(su, L::ldu, swt, L::ldw, sy, L::ldy, kRows, kC, kC, false);
    __syncthreads();
    for (int idx = threadIdx.x; idx < valid * kC; idx += blockDim.x) {
      const int r = idx / kC, c = idx % kC;
      const size_t at = (ob + r0 + r) * kC + c;
      const float tv = round_to<T>(sy[r * L::ldy + c] + to_f<T>(bt[c]));
      const float z = tv * wbn[c] + bbn[c];
      out[at] = from_f<T>(to_f<T>(x[at]) + fmaxf(z, 0.f));
    }
    __syncthreads();
  }
}

template <typename K>
size_t prepare(K kernel, size_t smem) {
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  return smem;
}

template <typename T>
int launch_block(const void* x, const void* wqk, const void* wv, const void* bv, const void* wt,
                 const void* bt, const float* wbn, const float* bbn, void* q, void* v, float* lse,
                 void* out, int o, int p, int oa, cudaStream_t st) {
  const long long tiles = (long long)o * ((p + kRows - 1) / kRows);

  const size_t s1 = prepare(project_kernel<T>, ProjSmem<T>::bytes);
  const int g1 = resident_grid(project_kernel<T>, kThreads, s1, tiles);
  project_kernel<T><<<g1, kThreads, s1, st>>>((const T*)x, (const T*)wqk, (const T*)wv,
                                              (const T*)bv, (T*)q, (T*)v, o, p);
  int err = (int)cudaGetLastError();
  if (err) return err;

  const size_t s2 = prepare(lse_kernel<T>, LseSmem<T>::bytes);
  const int g2 = resident_grid(lse_kernel<T>, kThreads, s2, tiles);
  lse_kernel<T><<<g2, kThreads, s2, st>>>((const T*)q, lse, o, p);
  err = (int)cudaGetLastError();
  if (err) return err;

  const size_t s3 = prepare(apply_kernel<T>, ApplySmem<T>::bytes);
  const int g3 = resident_grid(apply_kernel<T>, kThreads, s3, tiles);
  apply_kernel<T><<<g3, kThreads, s3, st>>>((const T*)x, (const T*)q, (const T*)v, lse,
                                            (const T*)wt, (const T*)bt, wbn, bbn, (T*)out, o, p,
                                            oa);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace sga

extern "C" int sga_pct_block_eval(const void* x, const void* wqk, const void* wv, const void* bv,
                                  const void* wt, const void* bt, const float* wbn,
                                  const float* bbn, void* q, void* v, float* lse, void* out,
                                  int o, int p, int oa, int dtype, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == sga::kBF16)
    return sga::launch_block<sga::bf16>(x, wqk, wv, bv, wt, bt, wbn, bbn, q, v, lse, out, o, p,
                                        oa, st);
  return sga::launch_block<float>(x, wqk, wv, bv, wt, bt, wbn, bbn, q, v, lse, out, o, p, oa,
                                  st);
}
