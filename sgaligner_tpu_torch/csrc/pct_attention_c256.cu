// PCT self-attention at C = 256, da = 64, the width of FullPCT's four OA
// blocks: the block's inference form (pct_block_eval), its training forward
// (pct_block_fwd) and its training backward with the BN epilogue
// (pct_block_res_bwd), f32 and bf16 (f32 accumulation), SA and OA. The
// notation is pct_attention.cu's.
//
// pct_block_eval replaces sgaligner_tpu/ops/pct_attention.py::pct_block_eval
// (Pallas kernel _block_eval_kernel) at this width, pct_block_fwd
// pct_block_fused's forward (_block_fwd_kernel), pct_block_res_bwd the
// backward of _block_res_bwd_rule (_block_res_bwd_kernel); the epilogue sums
// of that rule (_epi_sums_kernel) are pct_epi_sums.cu's at C = 256.
//   Bound on the H100: operations. The forward does 2·P·C·(da + C) +
//   2·P²·da + 2·P²·C + 2·P·C² = 117 MFLOP per object at P = C = 256, against
//   2·P·C elements in and out; the backward about three times that.
//   Design: pct_attention.cu's grid-stride passes over 64-row tiles (shared
//   with it through pct_attention.cuh: the log-sum-exp pass, the apply
//   loop and the dv pass), with block_gemm's WMMA (bf16) or FMA (f32)
//   tiles. What changes at this width is shared memory: Wv and Wt are
//   256 KB each at f32 (128 KB at bf16) and a block has 227 KB, so no pass
//   keeps a whole weight resident, as the C = 128 passes do. Every product
//   with a weight streams it through shared memory in kN = 32-column (or
//   -row) slices, per 64-row tile, from L2 (the forward's 0.6 MB of
//   weights a tile at f32 against its 30 MFLOP: far below L2's rate):
//     project: [Wqk | Wv] in column slices, each slice's q or v columns
//       written as it is done;
//     apply (eval and training forward): y by attend_tile, u in shared
//       memory, then t = u·Wt one column slice at a time, each slice's
//       epilogue (the residual, or t and the masked BN sums) right after;
//     dz (backward): t, dz, dWt += uᵀ·dz and du += dz·Wt_sliceᵀ slice by
//       slice from the same column slice of Wt, so neither t nor dz is
//       ever whole; OA keeps y/s in a device work buffer (no room beside
//       du) and forms c_j from it once du is complete;
//     dq: the (I, J) products v_I·dŶ_Jᵀ and dŶ_I·v_Jᵀ summed over column
//       slices of the four operands, which no longer fit whole;
//     dx: dx = dq·Wqk_sᵀ + dv·Wvᵀ one output column slice at a time from
//       row slices of Wqk and Wv.
//   Every layout is checked against the 232,448 bytes a block may have.
//   Weight gradients and BN sums go to per-block slices that reduce_slices
//   adds in block order: no atomics, the same bits from run to run.
#include "pct_attention.cuh"

namespace sga {
namespace {

constexpr int kC = 256;       // channels
constexpr int kDa = 64;       // q/k width (C / 4)
constexpr int kN = 32;        // columns (or rows) of a streamed weight slice
constexpr size_t kSmemMax = 232448;
static_assert(kC == kThreads, "the dx pass gives each thread one channel");

// One block slice of the backward's weight gradients (floats): dWqk
// [256, 64], dWv [256, 256], dbv [256], dWt [256, 256], dbt [256]
struct Grad {
  static constexpr int dwqk = 0;
  static constexpr int dwv = dwqk + kC * kDa;
  static constexpr int dbv = dwv + kC * kC;
  static constexpr int dwt = dbv + kC;
  static constexpr int dbt = dwt + kC * kC;
  static constexpr int total = dbt + kC;
};
// WMMA tiles accumulate into the slice: 32-byte aligned
static_assert(Grad::dwv % 8 == 0 && Grad::dwt % 8 == 0, "gradient slice alignment");

// ----------------------------- pass 1: project -----------------------------

template <typename T>
struct ProjSmem {
  static constexpr int ldx = pad_ld<T>(kC), ldw = pad_ld<T>(kN), ldc = pad_ldf(kN);
  static constexpr size_t x_off = 0;
  static constexpr size_t w_off = align128(x_off + sizeof(T) * kRows * ldx);
  static constexpr size_t c_off = align128(w_off + sizeof(T) * kC * ldw);
  static constexpr size_t bytes = align128(c_off + sizeof(float) * kRows * ldc);
};
static_assert(ProjSmem<float>::bytes <= kSmemMax, "project: shared memory");

// q = x·Wqk and v = x·Wv + bv of each 64-row tile, one kN-column slice of
// [Wqk | Wv] at a time
template <typename T>
__global__ void __launch_bounds__(kThreads)
project_kernel(const T* __restrict__ x, const T* __restrict__ wqk, const T* __restrict__ wv,
               const T* __restrict__ bv, T* __restrict__ q, T* __restrict__ v, int o, int p) {
  using L = ProjSmem<T>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sx = reinterpret_cast<T*>(smem + L::x_off);
  T* sw = reinterpret_cast<T*>(smem + L::w_off);
  float* sc = reinterpret_cast<float*>(smem + L::c_off);

  const int per_obj = (p + kRows - 1) / kRows;
  const long long tiles = (long long)o * per_obj;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int obj = (int)(t / per_obj), r0 = (int)(t % per_obj) * kRows;
    const int valid = min(kRows, p - r0);
    const size_t row0 = (size_t)obj * p + r0;
    load_tile<T>(sx, L::ldx, x + row0 * kC, kC, kRows, kC, valid);
    for (int s = 0; s < (kDa + kC) / kN; ++s) {
      const bool is_q = s * kN < kDa;
      const int n0 = is_q ? s * kN : s * kN - kDa;  // first column in Wqk or Wv
      if (is_q)
        load_tile<T>(sw, L::ldw, wqk + n0, kDa, kC, kN, kC);
      else
        load_tile<T>(sw, L::ldw, wv + n0, kC, kC, kN, kC);
      __syncthreads();
      block_gemm<T, false>(sx, L::ldx, sw, L::ldw, sc, L::ldc, kRows, kN, kC, false);
      __syncthreads();
      for (int idx = threadIdx.x; idx < valid * kN; idx += blockDim.x) {
        const int r = idx / kN, c = idx % kN;
        if (is_q)
          q[(row0 + r) * kDa + n0 + c] = from_f<T>(sc[r * L::ldc + c]);
        else
          v[(row0 + r) * kC + n0 + c] = from_f<T>(sc[r * L::ldc + c] + to_f<T>(bv[n0 + c]));
      }
    }
  }
}

// ------------------------- pass 3: apply, and dz ----------------------------

// The apply pass's and the dz pass's layout: attend_tile's tiles (qt, y, rs,
// lc, then the key loop's qc, vc, s, g); acc: the block's per-channel sums;
// the epilogue reuses the key loop's region for the u tile, a column slice
// of Wt, the t slice (f32) and the dz slice
template <typename T>
struct ApplySmem {
  static constexpr int ldq = pad_ld<T>(kDa), ldv = pad_ld<T>(kC), ldg = pad_ld<T>(kRows);
  static constexpr int lds = pad_ldf(kRows), ldy = pad_ldf(kC);
  static constexpr int ldu = pad_ld<T>(kC), ldw = pad_ld<T>(kN), ldt = pad_ldf(kN);
  static constexpr int ldz = pad_ld<T>(kN);
  static constexpr size_t qt_off = 0;
  static constexpr size_t y_off = align128(qt_off + sizeof(T) * kRows * ldq);
  static constexpr size_t rs_off = align128(y_off + sizeof(float) * kRows * ldy);
  static constexpr size_t lc_off = align128(rs_off + sizeof(float) * kRows);
  static constexpr size_t acc_off = align128(lc_off + sizeof(float) * kRows);
  static constexpr size_t qc_off = align128(acc_off + sizeof(float) * 2 * kC);
  static constexpr size_t vc_off = align128(qc_off + sizeof(T) * kRows * ldq);
  static constexpr size_t s_off = align128(vc_off + sizeof(T) * kRows * ldv);
  static constexpr size_t g_off = align128(s_off + sizeof(float) * kRows * lds);
  static constexpr size_t loop_end = align128(g_off + sizeof(T) * kRows * ldg);
  static constexpr size_t u_off = qc_off;
  static constexpr size_t w_off = align128(u_off + sizeof(T) * kRows * ldu);
  static constexpr size_t t_off = align128(w_off + sizeof(T) * kC * ldw);
  static constexpr size_t z_off = align128(t_off + sizeof(float) * kRows * ldt);
  static constexpr size_t epi_end = align128(z_off + sizeof(T) * kRows * ldz);
  static constexpr size_t bytes = loop_end > epi_end ? loop_end : epi_end;
};
static_assert(ApplySmem<float>::bytes <= kSmemMax, "apply: shared memory");

// u = y (SA) or x − y/s (OA) of one tile into su, each rounded to T; rows
// past `valid` zero. OA with ys: y/s (f32) also into ys (the dz pass's c).
template <typename T, typename L>
__device__ __forceinline__ void form_u(unsigned char* smem, const T* __restrict__ x, size_t at0,
                                       int valid, int oa, float* __restrict__ ys) {
  const float* sy = reinterpret_cast<const float*>(smem + L::y_off);
  const float* srs = reinterpret_cast<const float*>(smem + L::rs_off);
  T* su = reinterpret_cast<T*>(smem + L::u_off);
  for (int idx = threadIdx.x; idx < kRows * kC; idx += blockDim.x) {
    const int r = idx / kC, c = idx % kC;
    float u = 0.f;
    if (r < valid) {
      float y = sy[r * L::ldy + c];
      if (oa) y = y / (1e-9f + srs[r]);
      u = round_to<T>(y);
      if (oa) {
        if (ys) ys[at0 + (size_t)r * kC + c] = y;
        u = to_f<T>(x[at0 + (size_t)r * kC + c]) - u;
      }
    }
    su[r * L::ldu + c] = from_f<T>(u);
  }
}

// TRAIN = false: out = x + relu(t·wbn + bbn) (pct_block_eval).
// TRAIN = true: out = t (pct_block_fwd) and the block's masked channel sums
// Σ m·t, Σ m·t² into its scratch slice [2, 256].
template <typename T, bool TRAIN>
__global__ void __launch_bounds__(kThreads)
apply_kernel(const T* __restrict__ x, const T* __restrict__ q, const T* __restrict__ v,
             const float* __restrict__ lse, const T* __restrict__ wt, const T* __restrict__ bt,
             const float* __restrict__ wbn, const float* __restrict__ bbn,
             const T* __restrict__ mask, T* __restrict__ out, float* __restrict__ scratch,
             int o, int p, int oa) {
  using L = ApplySmem<T>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* sacc = reinterpret_cast<float*>(smem + L::acc_off);
  const T* su = reinterpret_cast<const T*>(smem + L::u_off);
  T* sw = reinterpret_cast<T*>(smem + L::w_off);
  float* st = reinterpret_cast<float*>(smem + L::t_off);

  for (int i = threadIdx.x; i < 2 * kC; i += blockDim.x) sacc[i] = 0.f;
  const int per_obj = (p + kRows - 1) / kRows;
  const long long tiles = (long long)o * per_obj;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int obj = (int)(t / per_obj), r0 = (int)(t % per_obj) * kRows;
    const int valid = min(kRows, p - r0);
    const size_t ob = (size_t)obj * p;
    attend_tile<T, L, kC, kDa>(smem, q, v, lse, ob, r0, valid, p);
    form_u<T, L>(smem, x, (ob + r0) * kC, valid, oa, nullptr);
    const float m = TRAIN ? to_f<T>(mask[obj]) : 0.f;
    for (int n0 = 0; n0 < kC; n0 += kN) {
      load_tile<T>(sw, L::ldw, wt + n0, kC, kC, kN, kC);
      __syncthreads();
      block_gemm<T, false>(su, L::ldu, sw, L::ldw, st, L::ldt, kRows, kN, kC, false);
      __syncthreads();
      for (int idx = threadIdx.x; idx < valid * kN; idx += blockDim.x) {
        const int r = idx / kN, c = idx % kN;
        const size_t at = (ob + r0 + r) * kC + n0 + c;
        const float tv = round_to<T>(st[r * L::ldt + c] + to_f<T>(bt[n0 + c]));
        if constexpr (TRAIN) {
          out[at] = from_f<T>(tv);
          st[r * L::ldt + c] = tv;
        } else {
          const float z = tv * wbn[n0 + c] + bbn[n0 + c];
          out[at] = from_f<T>(to_f<T>(x[at]) + fmaxf(z, 0.f));
        }
      }
      if constexpr (TRAIN) {
        __syncthreads();
        if (threadIdx.x < kN) {
          float s1 = 0.f, s2 = 0.f;
          for (int r = 0; r < valid; ++r) {
            const float tv = st[r * L::ldt + threadIdx.x];
            s1 += m * tv;
            s2 += m * (tv * tv);
          }
          sacc[n0 + threadIdx.x] += s1;
          sacc[kC + n0 + threadIdx.x] += s2;
        }
      }
    }
    __syncthreads();
  }
  if constexpr (TRAIN) {
    __syncthreads();
    float* part = scratch + (size_t)blockIdx.x * slice_stride(2 * kC);
    for (int i = threadIdx.x; i < 2 * kC; i += blockDim.x) part[i] = sacc[i];
  }
}

// dz pass of pct_block_res_bwd: per row tile recompute y, u and, one column
// slice of Wt at a time, t_out and dz = dxn·[t_out·wbn + bbn > 0]·wbn +
// m·dsum + 2·t_out·m·dsumsq (rounded), adding uᵀ·dz into the block's dWt and
// Σ dz into its dbt, and du += dz·Wt_sliceᵀ; then dY = ±du (rounded) and for
// OA the row vectors 1/s_j and c_j = (dY_j / s_j)·(y_j / s_j) into sc.
template <typename T, bool OA>
__global__ void __launch_bounds__(kThreads)
bwd_dz_kernel(const T* __restrict__ x, const T* __restrict__ q, const T* __restrict__ v,
              const float* __restrict__ lse, const T* __restrict__ wt, const T* __restrict__ bt,
              const T* __restrict__ mask, const T* __restrict__ dxn,
              const float* __restrict__ wbn, const float* __restrict__ bbn,
              const float* __restrict__ dsum, const float* __restrict__ dsumsq,
              T* __restrict__ dy, float* __restrict__ sc, float* __restrict__ ys,
              float* __restrict__ scratch, int o, int p) {
  using L = ApplySmem<T>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* sy = reinterpret_cast<float*>(smem + L::y_off);  // y, then du
  const float* srs = reinterpret_cast<const float*>(smem + L::rs_off);
  float* sdbt = reinterpret_cast<float*>(smem + L::acc_off);
  const T* su = reinterpret_cast<const T*>(smem + L::u_off);
  T* sw = reinterpret_cast<T*>(smem + L::w_off);
  float* st = reinterpret_cast<float*>(smem + L::t_off);
  T* sz = reinterpret_cast<T*>(smem + L::z_off);

  float* part = scratch + (size_t)blockIdx.x * slice_stride(Grad::total);
  for (int i = threadIdx.x; i < kC * kC; i += blockDim.x) part[Grad::dwt + i] = 0.f;
  for (int i = threadIdx.x; i < kC; i += blockDim.x) sdbt[i] = 0.f;
  const long long rows = (long long)o * p;
  const int row = threadIdx.x / 4, sub = threadIdx.x % 4;
  __syncthreads();

  const int per_obj = (p + kRows - 1) / kRows;
  const long long tiles = (long long)o * per_obj;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int obj = (int)(t / per_obj), r0 = (int)(t % per_obj) * kRows;
    const int valid = min(kRows, p - r0);
    const size_t ob = (size_t)obj * p;
    attend_tile<T, L, kC, kDa>(smem, q, v, lse, ob, r0, valid, p);
    form_u<T, L>(smem, x, (ob + r0) * kC, valid, OA, ys);
    const float m = to_f<T>(mask[obj]);
    for (int n0 = 0; n0 < kC; n0 += kN) {
      load_tile<T>(sw, L::ldw, wt + n0, kC, kC, kN, kC);
      __syncthreads();
      block_gemm<T, false>(su, L::ldu, sw, L::ldw, st, L::ldt, kRows, kN, kC, false);
      __syncthreads();
      for (int idx = threadIdx.x; idx < kRows * kN; idx += blockDim.x) {
        const int r = idx / kN, c = idx % kN, ch = n0 + c;
        float dz = 0.f;
        if (r < valid) {
          const float wc = wbn[ch];
          const float tv = round_to<T>(st[r * L::ldt + c] + to_f<T>(bt[ch]));
          const float g = to_f<T>(dxn[(ob + r0 + r) * kC + ch]);
          const bool live = epi_live<T>(tv, round_to<T>(wc), round_to<T>(bbn[ch]));
          dz = round_to<T>(((live ? g : 0.f) * wc + m * dsum[ch]) + 2.f * tv * (m * dsumsq[ch]));
        }
        sz[r * L::ldz + c] = from_f<T>(dz);
      }
      __syncthreads();
      if (threadIdx.x < kN) {
        float s = 0.f;
        for (int r = 0; r < valid; ++r) s += to_f<T>(sz[r * L::ldz + threadIdx.x]);
        sdbt[n0 + threadIdx.x] += s;
      }
      block_gemm<T, false, true>(su, L::ldu, sz, L::ldz, part + Grad::dwt + n0, kC, kC, kN, kRows,
                                 true);
      block_gemm<T, true>(sz, L::ldz, sw, L::ldw, sy, L::ldy, kRows, kC, kN, n0 > 0);
      __syncthreads();
    }
    if constexpr (OA) {
      // dY = −du; c_j = (dY_j / s_j)·(y_j / s_j), y/s from this tile's rows of ys
      const float inv = 1.f / (1e-9f + srs[row]);
      float cr = 0.f;
      if (row < valid)
        for (int cc = sub; cc < kC; cc += 4)
          cr += (-sy[row * L::ldy + cc] * inv) * ys[(ob + r0 + row) * kC + cc];
      cr = quad_sum(cr);
      if (sub == 0 && row < valid) {
        sc[ob + r0 + row] = inv;
        sc[rows + ob + r0 + row] = cr;
      }
    }
    for (int idx = threadIdx.x; idx < valid * kC; idx += blockDim.x) {
      const int r = idx / kC, cc = idx % kC;
      const float d = sy[r * L::ldy + cc];
      dy[(ob + r0 + r) * kC + cc] = from_f<T>(OA ? -d : d);
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < kC; i += blockDim.x) part[Grad::dbt + i] = sdbt[i];
}

// --------------------------------- dq pass ----------------------------------

template <typename T, bool OA>
struct DqSmem {
  static constexpr bool kF32 = std::is_same<T, float>::value;
  static constexpr int ldq = pad_ld<T>(kDa), ldk = pad_ld<T>(kN), ldf = pad_ld<T>(kRows);
  static constexpr int lds = pad_ldf(kRows), lda = pad_ldf(kDa);
  static constexpr size_t qi_off = 0;
  static constexpr size_t qj_off = align128(qi_off + sizeof(T) * kRows * ldq);
  // a column slice of the I-side and of the J-side operand
  static constexpr size_t a_off = align128(qj_off + sizeof(T) * kRows * ldq);
  static constexpr size_t b_off = align128(a_off + sizeof(T) * kRows * ldk);
  static constexpr size_t s_off = align128(b_off + sizeof(T) * kRows * ldk);
  static constexpr size_t pp_off = align128(s_off + sizeof(float) * kRows * lds);
  static constexpr size_t f_off = align128(pp_off + sizeof(float) * kRows * lds);
  static constexpr size_t f_end = align128(f_off + sizeof(float) * kRows * lds);
  // the rounded F tile: its own buffer in bf16, the f32 F itself in f32
  static constexpr size_t ft_off = kF32 ? f_off : f_end;
  static constexpr size_t ft_end = kF32 ? f_end : align128(ft_off + sizeof(T) * kRows * ldf);
  static constexpr size_t dq_off = ft_end;
  static constexpr size_t vec_off = align128(dq_off + sizeof(float) * kRows * lda);
  // lse and D of tiles I and J; OA: c of both too
  static constexpr size_t bytes = align128(vec_off + sizeof(float) * (OA ? 6 : 4) * kRows);
};
static_assert(DqSmem<float, true>::bytes <= kSmemMax, "dq: shared memory");

// spp[i, j] = Σ_c a[i, c]·b[j, c] over the C channels of the rows a0.. (a)
// and b0.. (b) of the object, in kN-column slices; a (or b) with `a_dy`
// (`b_dy`) is dY, scaled by 1/s (sc) for OA. Ends synchronised.
template <typename T, bool OA>
__device__ void channel_product(unsigned char* smem, const T* __restrict__ a, bool a_dy,
                                const T* __restrict__ b, const float* __restrict__ sc,
                                size_t a0, int a_valid, size_t b0, int b_valid) {
  using L = DqSmem<T, OA>;
  T* sa = reinterpret_cast<T*>(smem + L::a_off);
  T* sb = reinterpret_cast<T*>(smem + L::b_off);
  float* spp = reinterpret_cast<float*>(smem + L::pp_off);
  for (int k0 = 0; k0 < kC; k0 += kN) {
    if (OA && a_dy)
      load_rows_scaled<T>(sa, L::ldk, a + a0 * kC + k0, kC, kRows, kN, a_valid, sc + a0);
    else
      load_tile<T>(sa, L::ldk, a + a0 * kC + k0, kC, kRows, kN, a_valid);
    if (OA && !a_dy)
      load_rows_scaled<T>(sb, L::ldk, b + b0 * kC + k0, kC, kRows, kN, b_valid, sc + b0);
    else
      load_tile<T>(sb, L::ldk, b + b0 * kC + k0, kC, kRows, kN, b_valid);
    __syncthreads();
    block_gemm<T, true>(sa, L::ldk, sb, L::ldk, spp, L::lds, kRows, kRows, kN, k0 > 0);
    __syncthreads();
  }
}

// dq pass: per row tile I, dq_I = Σ_J F_IJ·q_J with F the (I, J) tile of
// dE + dEᵀ (pct_attention.cu's bwd_dq_kernel, its two [64, 64] products
// over the channels taken in slices)
template <typename T, bool OA>
__global__ void __launch_bounds__(kThreads)
bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ v, const float* __restrict__ lse,
              const T* __restrict__ dy, const float* __restrict__ dd,
              const float* __restrict__ sc, T* __restrict__ dq, int o, int p) {
  using L = DqSmem<T, OA>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sqi = reinterpret_cast<T*>(smem + L::qi_off);
  T* sqj = reinterpret_cast<T*>(smem + L::qj_off);
  float* ss = reinterpret_cast<float*>(smem + L::s_off);
  const float* spp = reinterpret_cast<const float*>(smem + L::pp_off);
  float* sf = reinterpret_cast<float*>(smem + L::f_off);
  T* sft = reinterpret_cast<T*>(smem + L::ft_off);
  float* sdq = reinterpret_cast<float*>(smem + L::dq_off);
  float* li = reinterpret_cast<float*>(smem + L::vec_off);
  float* di = li + kRows;
  float* lj = li + 2 * kRows;
  float* dj = li + 3 * kRows;
  float* ci = li + 4 * kRows;  // OA
  float* cj = li + 5 * kRows;  // OA

  const long long rows = (long long)o * p;
  const int per_obj = (p + kRows - 1) / kRows;
  const long long tiles = (long long)o * per_obj;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int obj = (int)(t / per_obj), i0 = (int)(t % per_obj) * kRows;
    const int valid = min(kRows, p - i0);
    const size_t ob = (size_t)obj * p;
    load_tile<T>(sqi, L::ldq, q + (ob + i0) * kDa, kDa, kRows, kDa, valid);
    if (threadIdx.x < kRows) {
      const bool in = threadIdx.x < valid;
      li[threadIdx.x] = in ? lse[ob + i0 + threadIdx.x] : 0.f;
      di[threadIdx.x] = in ? dd[ob + i0 + threadIdx.x] : 0.f;
      if constexpr (OA) ci[threadIdx.x] = in ? sc[rows + ob + i0 + threadIdx.x] : 0.f;
    }
    for (int j0 = 0; j0 < p; j0 += kRows) {
      const int kv = min(kRows, p - j0);
      load_tile<T>(sqj, L::ldq, q + (ob + j0) * kDa, kDa, kRows, kDa, kv);
      if (threadIdx.x < kRows) {
        const bool in = threadIdx.x < kv;
        lj[threadIdx.x] = in ? lse[ob + j0 + threadIdx.x] : 0.f;
        dj[threadIdx.x] = in ? dd[ob + j0 + threadIdx.x] : 0.f;
        if constexpr (OA) cj[threadIdx.x] = in ? sc[rows + ob + j0 + threadIdx.x] : 0.f;
      }
      __syncthreads();
      block_gemm<T, true>(sqi, L::ldq, sqj, L::ldq, ss, L::lds, kRows, kRows, kDa, false);
      // v_I·dŶ_Jᵀ
      channel_product<T, OA>(smem, v, false, dy, sc, ob + i0, valid, ob + j0, kv);
      // dE[j, i] term: G[j, i] = exp(E[i, j] − lse_i), dŶ_j·v_i = (v_I·dŶ_Jᵀ)[i, j]
      for (int idx = threadIdx.x; idx < kRows * kRows; idx += blockDim.x) {
        const int i = idx / kRows, j = idx % kRows;
        float a = spp[i * L::lds + j];
        if constexpr (OA) a -= cj[j];
        sf[i * L::lds + j] = expf(ss[i * L::lds + j] - li[i]) * (a - di[i]);
      }
      __syncthreads();
      // dŶ_I·v_Jᵀ
      channel_product<T, OA>(smem, dy, true, v, sc, ob + i0, valid, ob + j0, kv);
      // dE[i, j] term: G[i, j] = exp(E[i, j] − lse_j), dŶ_i·v_j
      for (int idx = threadIdx.x; idx < kRows * kRows; idx += blockDim.x) {
        const int i = idx / kRows, j = idx % kRows;
        float f = 0.f;
        if (j < kv) {
          float a = spp[i * L::lds + j];
          if constexpr (OA) a -= ci[i];
          f = sf[i * L::lds + j] + expf(ss[i * L::lds + j] - lj[j]) * (a - dj[j]);
        }
        sft[i * L::ldf + j] = from_f<T>(f);
      }
      __syncthreads();
      block_gemm<T, false>(sft, L::ldf, sqj, L::ldq, sdq, L::lda, kRows, kDa, kRows, j0 > 0);
      __syncthreads();
    }
    for (int idx = threadIdx.x; idx < valid * kDa; idx += blockDim.x) {
      const int r = idx / kDa, d = idx % kDa;
      dq[(ob + i0 + r) * kDa + d] = from_f<T>(sdq[r * L::lda + d]);
    }
    __syncthreads();
  }
}

// --------------------------------- dx pass ----------------------------------

template <typename T>
struct DxSmem {
  static constexpr int ldx = pad_ld<T>(kC), ldq = pad_ld<T>(kDa), ldc = pad_ldf(kN);
  static constexpr size_t x_off = 0;
  static constexpr size_t dq_off = align128(x_off + sizeof(T) * kRows * ldx);
  static constexpr size_t dv_off = align128(dq_off + sizeof(T) * kRows * ldq);
  // row slices [kN, ·] of Wqk_s and Wv
  static constexpr size_t wq_off = align128(dv_off + sizeof(T) * kRows * ldx);
  static constexpr size_t wv_off = align128(wq_off + sizeof(T) * kN * ldq);
  static constexpr size_t c_off = align128(wv_off + sizeof(T) * kN * ldx);
  static constexpr size_t bytes = align128(c_off + sizeof(float) * kRows * ldc);
};
static_assert(DxSmem<float>::bytes <= kSmemMax, "dx: shared memory");

// dx pass: dx = dq·Wqk_sᵀ + dv·Wvᵀ (OA: + du = −dY) + dxn, one kN-column
// slice of dx at a time; xᵀ·dq, xᵀ·dv and Σ dv into the block's slice.
template <typename T, bool OA>
__global__ void __launch_bounds__(kThreads)
bwd_dx_kernel(const T* __restrict__ x, const T* __restrict__ wqk, const T* __restrict__ wv,
              const T* __restrict__ dq, const T* __restrict__ dv, const T* __restrict__ dxn,
              const T* __restrict__ dy, T* __restrict__ dx, float* __restrict__ scratch,
              long long rows) {
  using L = DxSmem<T>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sx = reinterpret_cast<T*>(smem + L::x_off);
  T* sdq = reinterpret_cast<T*>(smem + L::dq_off);
  T* sdv = reinterpret_cast<T*>(smem + L::dv_off);
  T* swq = reinterpret_cast<T*>(smem + L::wq_off);
  T* swv = reinterpret_cast<T*>(smem + L::wv_off);
  float* sc = reinterpret_cast<float*>(smem + L::c_off);

  float* part = scratch + (size_t)blockIdx.x * slice_stride(Grad::total);
  for (int i = threadIdx.x; i < Grad::dbv; i += blockDim.x) part[i] = 0.f;  // dWqk, dWv
  float rdbv = 0.f;  // channel threadIdx.x
  __syncthreads();

  const long long tiles = (rows + kRows - 1) / kRows;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long row0 = t * kRows;
    const int valid = (int)min((long long)kRows, rows - row0);
    load_tile<T>(sx, L::ldx, x + row0 * kC, kC, kRows, kC, valid);
    load_tile<T>(sdq, L::ldq, dq + row0 * kDa, kDa, kRows, kDa, valid);
    load_tile<T>(sdv, L::ldx, dv + row0 * kC, kC, kRows, kC, valid);
    __syncthreads();
    block_gemm<T, false, true>(sx, L::ldx, sdq, L::ldq, part + Grad::dwqk, kDa, kC, kDa, kRows,
                               true);
    block_gemm<T, false, true>(sx, L::ldx, sdv, L::ldx, part + Grad::dwv, kC, kC, kC, kRows, true);
    for (int r = 0; r < valid; ++r) rdbv += to_f<T>(sdv[r * L::ldx + threadIdx.x]);
    for (int n0 = 0; n0 < kC; n0 += kN) {
      load_tile<T>(swq, L::ldq, wqk + (size_t)n0 * kDa, kDa, kN, kDa, kN);
      load_tile<T>(swv, L::ldx, wv + (size_t)n0 * kC, kC, kN, kC, kN);
      __syncthreads();
      block_gemm<T, true>(sdq, L::ldq, swq, L::ldq, sc, L::ldc, kRows, kN, kDa, false);
      __syncthreads();
      block_gemm<T, true>(sdv, L::ldx, swv, L::ldx, sc, L::ldc, kRows, kN, kC, true);
      __syncthreads();
      for (int idx = threadIdx.x; idx < valid * kN; idx += blockDim.x) {
        const int r = idx / kN, c = idx % kN;
        const long long at = (row0 + r) * kC + n0 + c;
        float d = sc[r * L::ldc + c];
        if constexpr (OA) d -= to_f<T>(dy[at]);
        d += to_f<T>(dxn[at]);
        dx[at] = from_f<T>(d);
      }
    }
    __syncthreads();
  }
  part[Grad::dbv + threadIdx.x] = rdbv;
}

// ---------------------------------- launch ----------------------------------

template <typename T>
int project_and_lse(const void* x, const void* wqk, const void* wv, const void* bv, void* q,
                    void* v, float* lse, int o, int p, cudaStream_t st) {
  const long long tiles = (long long)o * ((p + kRows - 1) / kRows);
  const size_t s1 = ProjSmem<T>::bytes;
  if (int rc = allow_smem(project_kernel<T>, s1)) return rc;
  const int g1 = resident_grid(project_kernel<T>, kThreads, s1, tiles);
  project_kernel<T><<<g1, kThreads, s1, st>>>((const T*)x, (const T*)wqk, (const T*)wv,
                                              (const T*)bv, (T*)q, (T*)v, o, p);
  if (int rc = (int)cudaGetLastError()) return rc;

  const size_t s2 = LseSmem<T, kDa>::bytes;
  if (int rc = allow_smem(lse_kernel<T, kDa>, s2)) return rc;
  const int g2 = resident_grid(lse_kernel<T, kDa>, kThreads, s2, tiles);
  lse_kernel<T, kDa><<<g2, kThreads, s2, st>>>((const T*)q, lse, o, p);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_block(const void* x, const void* wqk, const void* wv, const void* bv, const void* wt,
                 const void* bt, const float* wbn, const float* bbn, void* q, void* v, float* lse,
                 void* out, int o, int p, int oa, cudaStream_t st) {
  if (int rc = project_and_lse<T>(x, wqk, wv, bv, q, v, lse, o, p, st)) return rc;
  const long long tiles = (long long)o * ((p + kRows - 1) / kRows);
  const size_t s3 = ApplySmem<T>::bytes;
  if (int rc = allow_smem(apply_kernel<T, false>, s3)) return rc;
  const int g3 = resident_grid(apply_kernel<T, false>, kThreads, s3, tiles);
  apply_kernel<T, false><<<g3, kThreads, s3, st>>>(
      (const T*)x, (const T*)q, (const T*)v, lse, (const T*)wt, (const T*)bt, wbn, bbn, nullptr,
      (T*)out, nullptr, o, p, oa);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_block_fwd(const void* x, const void* wqk, const void* wv, const void* bv,
                     const void* wt, const void* bt, const void* mask, void* q, void* v,
                     float* lse, void* tout, float* scratch, int blocks, float* sums, int o,
                     int p, int oa, cudaStream_t st) {
  if (int rc = project_and_lse<T>(x, wqk, wv, bv, q, v, lse, o, p, st)) return rc;
  const size_t s3 = ApplySmem<T>::bytes;
  if (int rc = allow_smem(apply_kernel<T, true>, s3)) return rc;
  apply_kernel<T, true><<<blocks, kThreads, s3, st>>>(
      (const T*)x, (const T*)q, (const T*)v, lse, (const T*)wt, (const T*)bt, nullptr, nullptr,
      (const T*)mask, (T*)tout, scratch, o, p, oa);
  if (int rc = (int)cudaGetLastError()) return rc;
  return reduce_slices(scratch, slice_stride(2 * kC), blocks, sums, 2 * kC, st);
}

// The backward's buffers, carved from one work buffer: q, v, lse, dY, dv, D,
// dq, OA's [2, O·P] row vectors (1/s, c) and y/s [O·P, 256] (f32)
template <typename T>
struct Work {
  T *q, *v, *dy, *dv, *dq;
  float *lse, *dd, *sc, *ys;
};

template <typename T>
size_t carve(void* base, int o, int p, Work<T>* w) {
  const size_t rows = (size_t)o * p;
  size_t off = 0;
  auto take = [&](size_t bytes) {
    char* at = static_cast<char*>(base) + off;
    off += (bytes + 255) & ~size_t(255);
    return at;
  };
  Work<T> tmp;
  Work<T>& r = w ? *w : tmp;
  r.q = reinterpret_cast<T*>(take(sizeof(T) * rows * kDa));
  r.v = reinterpret_cast<T*>(take(sizeof(T) * rows * kC));
  r.dy = reinterpret_cast<T*>(take(sizeof(T) * rows * kC));
  r.dv = reinterpret_cast<T*>(take(sizeof(T) * rows * kC));
  r.dq = reinterpret_cast<T*>(take(sizeof(T) * rows * kDa));
  r.lse = reinterpret_cast<float*>(take(sizeof(float) * rows));
  r.dd = reinterpret_cast<float*>(take(sizeof(float) * rows));
  r.sc = reinterpret_cast<float*>(take(sizeof(float) * 2 * rows));
  r.ys = reinterpret_cast<float*>(take(sizeof(float) * rows * kC));
  return off;
}

template <typename T, bool OA>
int launch_block_res_bwd(const void* x, const void* wqk, const void* wv, const void* bv,
                         const void* wt, const void* bt, const void* mask, const void* dxn,
                         const float* wbn, const float* bbn, const float* dsum,
                         const float* dsumsq, void* work, void* dx, float* scratch, int blocks,
                         float* grads, int o, int p, cudaStream_t st) {
  Work<T> w;
  carve<T>(work, o, p, &w);
  if (int rc = project_and_lse<T>(x, wqk, wv, bv, w.q, w.v, w.lse, o, p, st)) return rc;
  const long long tiles = (long long)o * ((p + kRows - 1) / kRows);

  const size_t s1 = ApplySmem<T>::bytes;
  if (int rc = allow_smem(bwd_dz_kernel<T, OA>, s1)) return rc;
  bwd_dz_kernel<T, OA><<<blocks, kThreads, s1, st>>>(
      (const T*)x, w.q, w.v, w.lse, (const T*)wt, (const T*)bt, (const T*)mask, (const T*)dxn,
      wbn, bbn, dsum, dsumsq, w.dy, w.sc, w.ys, scratch, o, p);
  if (int rc = (int)cudaGetLastError()) return rc;

  const size_t s2 = DvSmem<T, OA, kC, kDa>::bytes;
  if (int rc = allow_smem(bwd_dv_kernel<T, OA, kC, kDa>, s2)) return rc;
  const int g2 = resident_grid(bwd_dv_kernel<T, OA, kC, kDa>, kThreads, s2, tiles);
  bwd_dv_kernel<T, OA, kC, kDa><<<g2, kThreads, s2, st>>>(w.q, w.v, w.lse, w.dy, w.sc, w.dv,
                                                          w.dd, o, p);
  if (int rc = (int)cudaGetLastError()) return rc;

  const size_t s3 = DqSmem<T, OA>::bytes;
  if (int rc = allow_smem(bwd_dq_kernel<T, OA>, s3)) return rc;
  const int g3 = resident_grid(bwd_dq_kernel<T, OA>, kThreads, s3, tiles);
  bwd_dq_kernel<T, OA><<<g3, kThreads, s3, st>>>(w.q, w.v, w.lse, w.dy, w.dd, w.sc, w.dq, o, p);
  if (int rc = (int)cudaGetLastError()) return rc;

  const size_t s4 = DxSmem<T>::bytes;
  if (int rc = allow_smem(bwd_dx_kernel<T, OA>, s4)) return rc;
  bwd_dx_kernel<T, OA><<<blocks, kThreads, s4, st>>>(
      (const T*)x, (const T*)wqk, (const T*)wv, w.dq, w.dv, (const T*)dxn, w.dy, (T*)dx, scratch,
      (long long)o * p);
  if (int rc = (int)cudaGetLastError()) return rc;
  return reduce_slices(scratch, slice_stride(Grad::total), blocks, grads, Grad::total, st);
}

template <typename T>
int block_res_bwd(const void* x, const void* wqk, const void* wv, const void* bv, const void* wt,
                  const void* bt, const void* mask, const void* dxn, const float* wbn,
                  const float* bbn, const float* dsum, const float* dsumsq, void* work, void* dx,
                  float* scratch, int blocks, float* grads, int o, int p, int oa,
                  cudaStream_t st) {
  if (oa)
    return launch_block_res_bwd<T, true>(x, wqk, wv, bv, wt, bt, mask, dxn, wbn, bbn, dsum,
                                         dsumsq, work, dx, scratch, blocks, grads, o, p, st);
  return launch_block_res_bwd<T, false>(x, wqk, wv, bv, wt, bt, mask, dxn, wbn, bbn, dsum,
                                        dsumsq, work, dx, scratch, blocks, grads, o, p, st);
}

}  // namespace
}  // namespace sga

extern "C" {

// The C = 256 forms of sga_pct_block_eval, sga_pct_block_fwd and
// sga_pct_block_res_bwd (pct_attention.cu), with the same arguments, for
// both dtypes: q [O, P, 64], v [O, P, 256] and lse [O, P] work buffers;
// grads f32 dWqk_s [256, 64], dWv [256, 256], dbv [256], dWt [256, 256],
// dbt [256]; scratch: `blocks` slices of slice_stride(512) floats (the
// forward's sums) or slice_stride(147968) (the backward's gradients)
int sga_pct_block_eval_c256(const void* x, const void* wqk, const void* wv, const void* bv,
                            const void* wt, const void* bt, const float* wbn, const float* bbn,
                            void* q, void* v, float* lse, void* out, int o, int p, int oa,
                            int dtype, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == sga::kBF16)
    return sga::launch_block<sga::bf16>(x, wqk, wv, bv, wt, bt, wbn, bbn, q, v, lse, out, o, p,
                                        oa, st);
  return sga::launch_block<float>(x, wqk, wv, bv, wt, bt, wbn, bbn, q, v, lse, out, o, p, oa,
                                  st);
}

int sga_pct_block_fwd_c256(const void* x, const void* wqk, const void* wv, const void* bv,
                           const void* wt, const void* bt, const void* mask, void* q, void* v,
                           float* lse, void* tout, float* scratch, int blocks, float* sums,
                           int o, int p, int oa, int dtype, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == sga::kBF16)
    return sga::launch_block_fwd<sga::bf16>(x, wqk, wv, bv, wt, bt, mask, q, v, lse, tout,
                                            scratch, blocks, sums, o, p, oa, st);
  return sga::launch_block_fwd<float>(x, wqk, wv, bv, wt, bt, mask, q, v, lse, tout, scratch,
                                      blocks, sums, o, p, oa, st);
}

// Bytes of sga_pct_block_res_bwd_c256's work buffer
long long sga_pct_bwd_work_bytes_c256(int o, int p, int dtype) {
  if (dtype == sga::kBF16) return (long long)sga::carve<sga::bf16>(nullptr, o, p, nullptr);
  return (long long)sga::carve<float>(nullptr, o, p, nullptr);
}

int sga_pct_block_res_bwd_c256(const void* x, const void* wqk, const void* wv, const void* bv,
                               const void* wt, const void* bt, const void* mask, const void* dxn,
                               const float* wbn, const float* bbn, const float* dsum,
                               const float* dsumsq, void* work, void* dx, float* scratch,
                               int blocks, float* grads, int o, int p, int oa, int dtype,
                               void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == sga::kBF16)
    return sga::block_res_bwd<sga::bf16>(x, wqk, wv, bv, wt, bt, mask, dxn, wbn, bbn, dsum,
                                         dsumsq, work, dx, scratch, blocks, grads, o, p, oa, st);
  return sga::block_res_bwd<float>(x, wqk, wv, bv, wt, bt, mask, dxn, wbn, bbn, dsum, dsumsq,
                                   work, dx, scratch, blocks, grads, o, p, oa, st);
}

}  // extern "C"
