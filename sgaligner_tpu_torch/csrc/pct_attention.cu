// PCT self-attention: the SA / OA block in its inference form, its training
// forward and backward, the block op's own backward, and the bare attention
// op (projections and core, no trans) with its backward, at C = 128,
// da = 32. The log-sum-exp pass, the apply loop and the dv pass are
// width-generic (pct_attention.cuh); pct_attention_c256.cu runs them, and
// passes of its own that stream the weights, at C = 256, da = 64.
//
// Notation, per object, with x [P, 128]:
//   q = x·Wqk (Wqk already scaled by da^-1/4 for SA), v = x·Wv + bv, both
//   rounded to the compute dtype;
//   E = q·qᵀ [P, P] (symmetric: q doubles as k);
//   G[j, i] = exp(E[j, i] − lse_i), lse_i = log Σ_j exp(E[j, i]): the column
//   softmax of E (the reference's transposed apply), rounded to the compute
//   dtype;
//   y_j = Σ_i G[j, i]·v_i (SA); OA divides each row by s_j = 1e-9 + Σ_i G[j, i];
//   u = y (SA) or x − y (OA); t = u·Wt + bt (rounded).
// The [P, P] energies never reach device memory.
//
// pct_block_eval replaces sgaligner_tpu/ops/pct_attention.py::pct_block_eval
// (Pallas kernel _block_eval_kernel): out = x + relu(t·wbn + bbn), with
// (wbn, bbn) the BN affine folded from running statistics.
//   Bound on the H100: operations. 2·P·C·(da + C) for the projections,
//   2·P²·da for E and 2·P²·C for y, 2·P·C² for t: 126 MFLOP per object at
//   P = 512, C = 128, da = 32, against 2·P·C elements in and out.
//   Design: the softmax normaliser runs over the KEY axis (columns), so an
//   online (flash-style) row softmax does not apply. By symmetry of E the
//   column log-sum-exp of key q equals the row log-sum-exp of row q, which
//   gives three passes over 64-row tiles. bf16 runs them as the wgmma
//   design of pct_block_eval_sm90.cu (the training forward and the
//   attention op's forward below too); f32 as these grid-stride passes:
//     1. project: q and v of a tile, Wqk and Wv resident in shared memory;
//     2. lse: for a tile of rows, an online max / sum-exp over all P columns
//        of E, recomputing E from q in 64-column chunks (f32);
//     3. apply: for a tile of rows, walk the keys in 64-chunks: S = q_tile·
//        q_chunkᵀ, G = exp(S − lse) rounded to the compute dtype, y += G·v
//        (tensor cores for bf16); then the residual epilogue with Wt resident.
//   E is computed twice (passes 2 and 3), 2·P²·da extra FLOP, an eighth of
//   the 2·P²·C of the y product. The normaliser is an f32 log-sum-exp where
//   the TPU kernel exponentiated in the compute dtype against a column max.
//   OA divides y by s after the apply (f32), where the TPU kernel rounds
//   G·(1/s) to the compute dtype before it: the same at f32.
//
// pct_block_fwd replaces ops/pct_attention.py::pct_block_fused (Pallas kernel
// _block_fwd_kernel), the training forward, SA or OA: the same three passes,
// with the apply pass's epilogue writing t_out = round(u·Wt + bt)
// [O, P, 128] and the masked BN sums Σ m·t, Σ m·t² [1, 128] (f32) instead of
// folding.
//   Bound on the H100: operations, as pct_block_eval.
//   bf16: pct_block_eval's wgmma passes, the apply pass with a training
//   epilogue chosen at compile time (pct_block_eval_sm90.cu): t stays in
//   registers, its sums reduce over lanes by shuffles into per-warpgroup
//   slices. f32: the passes below; each block keeps its channel sums in
//   registers and writes them to its scratch slice. reduce_slices adds the
//   slices in order.
//
// pct_epi_sums (the Pallas kernel _epi_sums_kernel of
// ops/pct_attention.py::_block_res_bwd_rule) is a streaming reduction of
// its own: pct_epi_sums.cu.
//
// pct_block_res_bwd replaces the Pallas kernel _block_res_bwd_kernel (same
// rule): the block's backward with the BN epilogue's routing and the
// residual, SA or OA. Given dxn (the next layer's cotangent), the fold
// (wbn, bbn) and the batch-statistics cotangents (dsum, dsumsq; from the
// fold's vjp and pct_epi_sums, so they must be complete first):
//   recompute q, v, lse, y, u, t_out;
//   dz = dxn·[t_out·wbn + bbn > 0]·wbn + m·dsum + 2·t_out·m·dsumsq, rounded;
//   dWt = Σ uᵀ·dz, dbt = Σ dz, du = dz·Wtᵀ; dY = du (SA) or −du (OA);
//   the attention core's backward at dY (column softmax G, keys = queries),
//   with dŶ_j = dY_j / s_j and c_j = dŶ_j·y_j for OA (s = 1, c = 0 for SA):
//     dv_i = Σ_j G[j, i]·dŶ_j;  D_i = v_i·dv_i − Σ_j G[j, i]·c_j;
//     dE[j, i] = G[j, i]·(dŶ_j·v_i − c_j − D_i);  dq = (dE + dEᵀ)·q;
//   dWqk = s·Σ xᵀ·dq, dWv = Σ xᵀ·dv, dbv = Σ dv,
//   dx = dq·Wqk_sᵀ + dv·Wvᵀ (+ du for OA) + dxn (the residual), rounded.
//   Bound on the H100: operations, about 3 x the forward.
//   bf16 (this op, pct_block_bwd and pct_attn_bwd): the wgmma design of
//   pct_block_bwd_sm90.cu. f32 (full f32, no TF32):
//   Design: four grid-stride passes over 64-row tiles after projection and
//   lse, with the tile intermediates of one pass handed to the next through
//   device memory (q, v, lse, dY, dv, D, dq, and for OA 1/s and c:
//   O(P·C) per object, never [P, P]):
//     dz pass: the apply loop recomputes y; the epilogue builds dz, adds
//       uᵀ·dz into the block's scratch slice and writes dY (rounded); OA
//       keeps the f32 y tile beside t and dY in shared memory and writes
//       1/s_j and c_j per row;
//     dv pass: per key tile, walk the rows: G recomputed from q and lse,
//       dv += Gᵀ·dŶ (transposed-A block_gemm; dŶ = dY·(1/s) rounded as the
//       tile is loaded); then D, less the column sums of G·c for OA;
//     dq pass: per row tile I, walk the tiles J: with S = q_I·q_Jᵀ,
//       F = exp(S − lse_I)·(v_I·dŶ_Jᵀ − c_J − D_I) + exp(S − lse_J)·(dŶ_I·v_Jᵀ
//       − c_I − D_J) is the tile of dE + dEᵀ, and dq_I += F·q_J: the block
//       owns dq_I, so no atomics;
//     dx pass: dx and the projection gradients, into the scratch slice.
//   reduce_slices then adds the slices in block order. The OA variant is a
//   compile-time template flag: the SA launches keep their code.
//
// pct_block_bwd replaces ops/pct_attention.py::_block_bwd_rule (Pallas kernel
// _block_bwd_kernel): pct_block_fused's own backward, for the cotangents
// (dt, dsum, dsumsq) of (t_out, ssum, ssumsq):
//   dz = dt + m·dsum + 2·t_out·m·dsumsq, rounded (no relu routing), then
//   pct_block_res_bwd's passes; dx has no residual (+du for OA).
//   Bound on the H100: operations, as pct_block_res_bwd.
//   Design: pct_block_res_bwd's passes, the dz pass's and dx pass's
//   epilogues chosen at compile time.
//
// pct_attn_fwd replaces ops/pct_attention.py::pct_attention_fused (Pallas
// kernel _fwd_kernel): y [O, P, 128], rounded to the compute dtype, with no
// trans, epilogue or sums. The scale flag is folded into Wqk by the wrapper,
// so SA and OA normalisation each pair with either scale.
//   Bound on the H100: operations. 2·P·C·(da + C) + 2·P²·da + 2·P²·C per
//   object: 105 MFLOP at P = 512.
//   bf16: pct_block_eval's wgmma passes, the apply pass with the attention
//   epilogue (pct_block_eval_sm90.cu). f32: projection and lse as
//   pct_block_eval, then an apply pass that writes y (OA divides by s)
//   instead of running the trans epilogue; Wt is not resident, so the apply
//   pass's shared memory is the key loop's alone.
//
// pct_attn_bwd replaces ops/pct_attention.py::_bwd_rule (Pallas kernel
// _bwd_kernel): for the cotangent dY of y, dx = dq·Wqk_sᵀ + dv·Wvᵀ (no
// residual, no du), dWqk_s, dWv, dbv (f32).
//   Bound on the H100: operations. The projections again, E, dv = Gᵀ·dŶ,
//   dG = dŶ·vᵀ, dq = (dE + dEᵀ)·q, the projection gradients and dx (for OA
//   also y, for s and c).
//   Design: projection and lse; for OA only, a pass per row tile that
//   recomputes y and s (the apply loop) and writes 1/s_j and c_j; then the
//   dv, dq and dx passes of pct_block_res_bwd (the dx pass without the
//   residual and du). Each block sums its weight gradients into its own
//   scratch slice; reduce_slices adds them in block order: the same bits
//   twice.
#include "pct_attention.cuh"

namespace sga {
namespace {

constexpr int kC = 128;       // channels
constexpr int kDa = 32;       // q/k width (C / 4)


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
    block_gemm<T, false, false, kRows, kDa, kC>(sx, L::ldx, swq, L::ldq, cq, L::ldcq, false);
    block_gemm<T, false, false, kRows, kC, kC>(sx, L::ldx, swv, L::ldv, cv, L::ldcv, false);
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

// ------------------------------ pass 3: apply ------------------------------

// kWt: Wt resident ahead of the apply region (the block kernels); the
// attention op's passes leave it out
template <typename T, bool kWt = true>
struct ApplySmem {
  static constexpr int ldq = pad_ld<T>(kDa), ldv = pad_ld<T>(kC), ldg = pad_ld<T>(kRows);
  static constexpr int ldw = pad_ld<T>(kC), ldu = pad_ld<T>(kC);
  static constexpr int lds = pad_ldf(kRows), ldy = pad_ldf(kC);
  static constexpr size_t wt_off = 0;
  static constexpr size_t qt_off = kWt ? align128(wt_off + sizeof(T) * kC * ldw) : 0;
  static constexpr size_t y_off = align128(qt_off + sizeof(T) * kRows * ldq);
  static constexpr size_t rs_off = align128(y_off + sizeof(float) * kRows * ldy);
  static constexpr size_t lc_off = align128(rs_off + sizeof(float) * kRows);
  // key-loop buffers; the epilogue's U tile (and the backward's dz tile)
  // reuse this region
  static constexpr size_t qc_off = align128(lc_off + sizeof(float) * kRows);
  static constexpr size_t vc_off = align128(qc_off + sizeof(T) * kRows * ldq);
  static constexpr size_t s_off = align128(vc_off + sizeof(T) * kRows * ldv);
  static constexpr size_t g_off = align128(s_off + sizeof(float) * kRows * lds);
  static constexpr size_t loop_end = align128(g_off + sizeof(T) * kRows * ldg);
  static constexpr size_t u_off = qc_off;
  static constexpr size_t u_end = align128(u_off + sizeof(T) * kRows * ldu);
  static constexpr size_t dz_off = u_end;
  static constexpr size_t dz_end = align128(dz_off + sizeof(T) * kRows * ldu);
  static constexpr size_t bytes = loop_end > u_end ? loop_end : u_end;
  static constexpr size_t bwd_bytes = loop_end > dz_end ? loop_end : dz_end;
  // the OA backward's dz pass keeps the f32 y tile in y_off and puts t,
  // then dY, in a tile of its own
  static constexpr size_t t_off = bwd_bytes;
  static constexpr size_t oa_bwd_bytes = align128(t_off + sizeof(float) * kRows * ldy);
};

// TRAIN = false: out = x + relu(t·wbn + bbn) (pct_block_eval).
// TRAIN = true: out = t (pct_block_fwd) and the block's masked channel sums
// into part[0..128) and part[128..256).
template <typename T, bool TRAIN>
__global__ void __launch_bounds__(kThreads)
apply_kernel(const T* __restrict__ x, const T* __restrict__ q, const T* __restrict__ v,
             const float* __restrict__ lse, const T* __restrict__ wt, const T* __restrict__ bt,
             const float* __restrict__ wbn, const float* __restrict__ bbn,
             const T* __restrict__ mask, T* __restrict__ out, float* __restrict__ scratch,
             int o, int p, int oa) {
  using L = ApplySmem<T>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* swt = reinterpret_cast<T*>(smem + L::wt_off);
  float* sy = reinterpret_cast<float*>(smem + L::y_off);  // y, then t
  float* srs = reinterpret_cast<float*>(smem + L::rs_off);
  T* su = reinterpret_cast<T*>(smem + L::u_off);

  load_tile<T>(swt, L::ldw, wt, kC, kC, kC, kC);
  float s1 = 0.f, s2 = 0.f;  // TRAIN: this thread's channel, masked
  const int per_obj = (p + kRows - 1) / kRows;
  const long long tiles = (long long)o * per_obj;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int obj = (int)(t / per_obj), r0 = (int)(t % per_obj) * kRows;
    const int valid = min(kRows, p - r0);
    const size_t ob = (size_t)obj * p;
    attend_tile<T, L, kC, kDa>(smem, q, v, lse, ob, r0, valid, p);
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
    block_gemm<T, false, false, kRows, kC, kC>(su, L::ldu, swt, L::ldw, sy, L::ldy, false);
    __syncthreads();
    const float m = TRAIN ? to_f<T>(mask[obj]) : 0.f;
    for (int idx = threadIdx.x; idx < valid * kC; idx += blockDim.x) {
      const int r = idx / kC, c = idx % kC;
      const size_t at = (ob + r0 + r) * kC + c;
      const float tv = round_to<T>(sy[r * L::ldy + c] + to_f<T>(bt[c]));
      if constexpr (TRAIN) {
        out[at] = from_f<T>(tv);
        s1 += m * tv;
        s2 += m * (tv * tv);
      } else {
        const float z = tv * wbn[c] + bbn[c];
        out[at] = from_f<T>(to_f<T>(x[at]) + fmaxf(z, 0.f));
      }
    }
    __syncthreads();
  }
  if constexpr (TRAIN) {
    float* part = scratch + (size_t)blockIdx.x * slice_stride(2 * kC);
    store_channel_sums(s1, part);
    store_channel_sums(s2, part + kC);
  }
}

// ------------------------------ training: backward --------------------------

// dz pass: recompute y and t_out per row tile, build dz, add uᵀ·dz and Σ dz
// into the block's slice, write dY = ±dz·Wtᵀ (rounded).
// EPI: dz from the epilogue's routing of dxn (pct_block_res_bwd); otherwise
// dxn is the cotangent dt of t_out (pct_block_bwd). OA: u = x − y, dY = −du,
// and the row vectors 1/s, c into sc.
template <typename T, bool EPI, bool OA>
__global__ void __launch_bounds__(kThreads)
bwd_dz_kernel(const T* __restrict__ x, const T* __restrict__ q, const T* __restrict__ v,
              const float* __restrict__ lse, const T* __restrict__ wt, const T* __restrict__ bt,
              const T* __restrict__ mask, const T* __restrict__ dxn,
              const float* __restrict__ wbn, const float* __restrict__ bbn,
              const float* __restrict__ dsum, const float* __restrict__ dsumsq,
              T* __restrict__ dy, float* __restrict__ sc, float* __restrict__ scratch, int o,
              int p) {
  using L = ApplySmem<T>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* swt = reinterpret_cast<T*>(smem + L::wt_off);
  float* sy = reinterpret_cast<float*>(smem + L::y_off);  // y (SA: then t, then dY)
  const float* srs = reinterpret_cast<const float*>(smem + L::rs_off);
  float* st = OA ? reinterpret_cast<float*>(smem + L::t_off) : sy;  // t, then du
  T* su = reinterpret_cast<T*>(smem + L::u_off);
  T* sdz = reinterpret_cast<T*>(smem + L::dz_off);

  float* part = scratch + (size_t)blockIdx.x * slice_stride(kBwdGrad);
  for (int i = threadIdx.x; i < kC * kC; i += blockDim.x) part[kOffDwt + i] = 0.f;
  load_tile<T>(swt, L::ldw, wt, kC, kC, kC, kC);
  const int c = threadIdx.x % kC;
  float wc = 0.f, w_t = 0.f, b_t = 0.f;
  if constexpr (EPI) {
    wc = wbn[c];
    w_t = round_to<T>(wc);
    b_t = round_to<T>(bbn[c]);
  }
  const float btc = to_f<T>(bt[c]), d1 = dsum[c], d2 = dsumsq[c];
  const long long rows = (long long)o * p;
  const int row = threadIdx.x / 4, sub = threadIdx.x % 4;
  float rdbt = 0.f;
  __syncthreads();

  const int per_obj = (p + kRows - 1) / kRows;
  const long long tiles = (long long)o * per_obj;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int obj = (int)(t / per_obj), r0 = (int)(t % per_obj) * kRows;
    const int valid = min(kRows, p - r0);
    const size_t ob = (size_t)obj * p;
    attend_tile<T, L, kC, kDa>(smem, q, v, lse, ob, r0, valid, p);
    for (int idx = threadIdx.x; idx < kRows * kC; idx += blockDim.x) {
      const int r = idx / kC, cc = idx % kC;
      if constexpr (OA) {
        float u = 0.f;
        if (r < valid) {
          const float y = sy[r * L::ldy + cc] / (1e-9f + srs[r]);
          sy[r * L::ldy + cc] = y;  // kept for c
          u = to_f<T>(x[(ob + r0 + r) * kC + cc]) - round_to<T>(y);
        }
        su[r * L::ldu + cc] = from_f<T>(u);
      } else {
        su[r * L::ldu + cc] = from_f<T>(r < valid ? sy[r * L::ldy + cc] : 0.f);  // u = y
      }
    }
    __syncthreads();
    block_gemm<T, false, false, kRows, kC, kC>(su, L::ldu, swt, L::ldw, st, L::ldy, false);
    __syncthreads();
    const float m = to_f<T>(mask[obj]);
    for (int idx = threadIdx.x; idx < kRows * kC; idx += blockDim.x) {
      const int r = idx / kC;  // channel c (idx % kC) throughout
      float dz = 0.f;
      if (r < valid) {
        const float tv = round_to<T>(st[r * L::ldy + c] + btc);
        const float g = to_f<T>(dxn[(ob + r0 + r) * kC + c]);
        if constexpr (EPI)
          dz = round_to<T>(((epi_live<T>(tv, w_t, b_t) ? g : 0.f) * wc + m * d1) +
                           2.f * tv * (m * d2));
        else
          dz = round_to<T>((g + m * d1) + 2.f * tv * (m * d2));
      }
      sdz[r * L::ldu + c] = from_f<T>(dz);
      rdbt += dz;
    }
    __syncthreads();
    block_gemm<T, false, true, kC, kC, kRows>(su, L::ldu, sdz, L::ldu, part + kOffDwt, kC, true);
    block_gemm<T, true, false, kRows, kC, kC>(sdz, L::ldu, swt, L::ldw, st, L::ldy, false);
    __syncthreads();
    if constexpr (OA) {
      // dY = −du; c_j = (dY_j / s_j)·y_j
      const float inv = 1.f / (1e-9f + srs[row]);
      float cr = 0.f;
      if (row < valid)
        for (int cc = sub; cc < kC; cc += 4)
          cr += (-st[row * L::ldy + cc] * inv) * sy[row * L::ldy + cc];
      cr = quad_sum(cr);
      if (sub == 0 && row < valid) {
        sc[ob + r0 + row] = inv;
        sc[rows + ob + r0 + row] = cr;
      }
    }
    for (int idx = threadIdx.x; idx < valid * kC; idx += blockDim.x) {
      const int r = idx / kC, cc = idx % kC;
      const float d = st[r * L::ldy + cc];
      dy[(ob + r0 + r) * kC + cc] = from_f<T>(OA ? -d : d);
    }
    __syncthreads();
  }
  store_channel_sums(rdbt, part + kOffDbt);
}

template <typename T, bool OA>
struct DqSmem {
  static constexpr bool kF32 = std::is_same<T, float>::value;
  static constexpr int ldq = pad_ld<T>(kDa), ldc = pad_ld<T>(kC), ldf = pad_ld<T>(kRows);
  static constexpr int lds = pad_ldf(kRows), lda = pad_ldf(kDa);
  static constexpr size_t qi_off = 0;
  static constexpr size_t qj_off = align128(qi_off + sizeof(T) * kRows * ldq);
  static constexpr size_t vi_off = align128(qj_off + sizeof(T) * kRows * ldq);
  static constexpr size_t yi_off = align128(vi_off + sizeof(T) * kRows * ldc);
  static constexpr size_t vj_off = align128(yi_off + sizeof(T) * kRows * ldc);
  static constexpr size_t yj_off = align128(vj_off + sizeof(T) * kRows * ldc);
  static constexpr size_t s_off = align128(yj_off + sizeof(T) * kRows * ldc);
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

// dq pass: per row tile I, dq_I = Σ_J F_IJ·q_J with F the (I, J) tile of
// dE + dEᵀ.
template <typename T, bool OA>
__global__ void __launch_bounds__(kThreads)
bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ v, const float* __restrict__ lse,
              const T* __restrict__ dy, const float* __restrict__ dd,
              const float* __restrict__ sc, T* __restrict__ dq, int o, int p) {
  using L = DqSmem<T, OA>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sqi = reinterpret_cast<T*>(smem + L::qi_off);
  T* sqj = reinterpret_cast<T*>(smem + L::qj_off);
  T* svi = reinterpret_cast<T*>(smem + L::vi_off);
  T* syi = reinterpret_cast<T*>(smem + L::yi_off);
  T* svj = reinterpret_cast<T*>(smem + L::vj_off);
  T* syj = reinterpret_cast<T*>(smem + L::yj_off);
  float* ss = reinterpret_cast<float*>(smem + L::s_off);
  float* spp = reinterpret_cast<float*>(smem + L::pp_off);
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
    load_tile<T>(svi, L::ldc, v + (ob + i0) * kC, kC, kRows, kC, valid);
    if constexpr (OA)
      load_rows_scaled<T>(syi, L::ldc, dy + (ob + i0) * kC, kC, kRows, kC, valid, sc + ob + i0);
    else
      load_tile<T>(syi, L::ldc, dy + (ob + i0) * kC, kC, kRows, kC, valid);
    if (threadIdx.x < kRows) {
      const bool in = threadIdx.x < valid;
      li[threadIdx.x] = in ? lse[ob + i0 + threadIdx.x] : 0.f;
      di[threadIdx.x] = in ? dd[ob + i0 + threadIdx.x] : 0.f;
      if constexpr (OA) ci[threadIdx.x] = in ? sc[rows + ob + i0 + threadIdx.x] : 0.f;
    }
    for (int j0 = 0; j0 < p; j0 += kRows) {
      const int kv = min(kRows, p - j0);
      load_tile<T>(sqj, L::ldq, q + (ob + j0) * kDa, kDa, kRows, kDa, kv);
      load_tile<T>(svj, L::ldc, v + (ob + j0) * kC, kC, kRows, kC, kv);
      if constexpr (OA)
        load_rows_scaled<T>(syj, L::ldc, dy + (ob + j0) * kC, kC, kRows, kC, kv, sc + ob + j0);
      else
        load_tile<T>(syj, L::ldc, dy + (ob + j0) * kC, kC, kRows, kC, kv);
      if (threadIdx.x < kRows) {
        const bool in = threadIdx.x < kv;
        lj[threadIdx.x] = in ? lse[ob + j0 + threadIdx.x] : 0.f;
        dj[threadIdx.x] = in ? dd[ob + j0 + threadIdx.x] : 0.f;
        if constexpr (OA) cj[threadIdx.x] = in ? sc[rows + ob + j0 + threadIdx.x] : 0.f;
      }
      __syncthreads();
      block_gemm<T, true, false, kRows, kRows, kDa>(sqi, L::ldq, sqj, L::ldq, ss, L::lds, false);
      block_gemm<T, true, false, kRows, kRows, kC>(svi, L::ldc, syj, L::ldc, spp, L::lds, false);
      __syncthreads();
      // dE[j, i] term: G[j, i] = exp(E[i, j] − lse_i), dŶ_j·v_i = (v_I·dŶ_Jᵀ)[i, j]
      for (int idx = threadIdx.x; idx < kRows * kRows; idx += blockDim.x) {
        const int i = idx / kRows, j = idx % kRows;
        float a = spp[i * L::lds + j];
        if constexpr (OA) a -= cj[j];
        sf[i * L::lds + j] = expf(ss[i * L::lds + j] - li[i]) * (a - di[i]);
      }
      __syncthreads();
      block_gemm<T, true, false, kRows, kRows, kC>(syi, L::ldc, svj, L::ldc, spp, L::lds, false);
      __syncthreads();
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
      block_gemm<T, false, false, kRows, kDa, kRows>(sft, L::ldf, sqj, L::ldq, sdq, L::lda, j0 > 0);
      __syncthreads();
    }
    for (int idx = threadIdx.x; idx < valid * kDa; idx += blockDim.x) {
      const int r = idx / kDa, d = idx % kDa;
      dq[(ob + i0 + r) * kDa + d] = from_f<T>(sdq[r * L::lda + d]);
    }
    __syncthreads();
  }
}

template <typename T>
struct DxSmem {
  static constexpr int ldwq = pad_ld<T>(kDa), ldw = pad_ld<T>(kC), ldx = pad_ld<T>(kC);
  static constexpr int ldq = pad_ld<T>(kDa), ldc = pad_ldf(kC);
  static constexpr size_t wq_off = 0;
  static constexpr size_t wv_off = align128(wq_off + sizeof(T) * kC * ldwq);
  static constexpr size_t x_off = align128(wv_off + sizeof(T) * kC * ldw);
  static constexpr size_t dq_off = align128(x_off + sizeof(T) * kRows * ldx);
  static constexpr size_t dv_off = align128(dq_off + sizeof(T) * kRows * ldq);
  static constexpr size_t c_off = align128(dv_off + sizeof(T) * kRows * ldx);
  static constexpr size_t bytes = align128(c_off + sizeof(float) * kRows * ldc);
};

// dx pass: dx = dq·Wqk_sᵀ + dv·Wvᵀ (+ du = −dY with DU) (+ dxn with RESID);
// xᵀ·dq, xᵀ·dv and Σ dv into the block's slice.
template <typename T, bool RESID, bool DU>
__global__ void __launch_bounds__(kThreads)
bwd_dx_kernel(const T* __restrict__ x, const T* __restrict__ wqk, const T* __restrict__ wv,
              const T* __restrict__ dq, const T* __restrict__ dv, const T* __restrict__ dxn,
              const T* __restrict__ dy, T* __restrict__ dx, float* __restrict__ scratch,
              long long rows) {
  using L = DxSmem<T>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* swq = reinterpret_cast<T*>(smem + L::wq_off);
  T* swv = reinterpret_cast<T*>(smem + L::wv_off);
  T* sx = reinterpret_cast<T*>(smem + L::x_off);
  T* sdq = reinterpret_cast<T*>(smem + L::dq_off);
  T* sdv = reinterpret_cast<T*>(smem + L::dv_off);
  float* sc = reinterpret_cast<float*>(smem + L::c_off);

  float* part = scratch + (size_t)blockIdx.x * slice_stride(kBwdGrad);
  for (int i = threadIdx.x; i < kOffDbv; i += blockDim.x) part[i] = 0.f;  // dWqk, dWv
  load_tile<T>(swq, L::ldwq, wqk, kDa, kC, kDa, kC);
  load_tile<T>(swv, L::ldw, wv, kC, kC, kC, kC);
  const int c = threadIdx.x % kC;
  float rdbv = 0.f;
  __syncthreads();

  const long long tiles = (rows + kRows - 1) / kRows;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long row0 = t * kRows;
    const int valid = (int)min((long long)kRows, rows - row0);
    load_tile<T>(sx, L::ldx, x + row0 * kC, kC, kRows, kC, valid);
    load_tile<T>(sdq, L::ldq, dq + row0 * kDa, kDa, kRows, kDa, valid);
    load_tile<T>(sdv, L::ldx, dv + row0 * kC, kC, kRows, kC, valid);
    __syncthreads();
    block_gemm<T, true, false, kRows, kC, kDa>(sdq, L::ldq, swq, L::ldwq, sc, L::ldc, false);
    __syncthreads();
    block_gemm<T, true, false, kRows, kC, kC>(sdv, L::ldx, swv, L::ldw, sc, L::ldc, true);
    block_gemm<T, false, true, kC, kDa, kRows>(sx, L::ldx, sdq, L::ldq, part + kOffDwqk, kDa, true);
    block_gemm<T, false, true, kC, kC, kRows>(sx, L::ldx, sdv, L::ldx, part + kOffDwv, kC, true);
    __syncthreads();
    for (int idx = threadIdx.x; idx < valid * kC; idx += blockDim.x) {
      const int r = idx / kC;  // channel c throughout
      const long long at = (row0 + r) * kC + c;
      float d = sc[r * L::ldc + c];
      if constexpr (DU) d -= to_f<T>(dy[at]);
      if constexpr (RESID) d += to_f<T>(dxn[at]);
      dx[at] = from_f<T>(d);
      rdbv += to_f<T>(sdv[r * L::ldx + c]);
    }
    __syncthreads();
  }
  store_channel_sums(rdbv, part + kOffDbv);
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

// The dv, dq and dx passes shared by the three backwards (dY, and for OA
// 1/s and c, already in device memory). RESID / DU: the dx pass's residual
// and du terms.
template <typename T, bool OA, bool RESID, bool DU>
int launch_core_bwd(const void* x, const void* wqk, const void* wv, const void* dxn,
                    const void* q, const void* v, const float* lse, const void* dy,
                    const float* sc, void* dv, float* dd, void* dq, void* dx, float* scratch,
                    int blocks, int o, int p, cudaStream_t st) {
  const long long tiles = (long long)o * ((p + kRows - 1) / kRows);
  const size_t s2 = DvSmem<T, OA, kC, kDa>::bytes;
  if (int rc = allow_smem(bwd_dv_kernel<T, OA, kC, kDa>, s2)) return rc;
  const int g2 = resident_grid(bwd_dv_kernel<T, OA, kC, kDa>, kThreads, s2, tiles);
  bwd_dv_kernel<T, OA, kC, kDa><<<g2, kThreads, s2, st>>>((const T*)q, (const T*)v, lse, (const T*)dy,
                                                 sc, (T*)dv, dd, o, p);
  if (int rc = (int)cudaGetLastError()) return rc;

  const size_t s3 = DqSmem<T, OA>::bytes;
  if (int rc = allow_smem(bwd_dq_kernel<T, OA>, s3)) return rc;
  const int g3 = resident_grid(bwd_dq_kernel<T, OA>, kThreads, s3, tiles);
  bwd_dq_kernel<T, OA><<<g3, kThreads, s3, st>>>((const T*)q, (const T*)v, lse, (const T*)dy,
                                                 dd, sc, (T*)dq, o, p);
  if (int rc = (int)cudaGetLastError()) return rc;

  const size_t s4 = DxSmem<T>::bytes;
  if (int rc = allow_smem(bwd_dx_kernel<T, RESID, DU>, s4)) return rc;
  bwd_dx_kernel<T, RESID, DU><<<blocks, kThreads, s4, st>>>(
      (const T*)x, (const T*)wqk, (const T*)wv, (const T*)dq, (const T*)dv, (const T*)dxn,
      (const T*)dy, (T*)dx, scratch, (long long)o * p);
  return (int)cudaGetLastError();
}

// pct_block_res_bwd (EPI) and pct_block_bwd: dxn is the next layer's
// cotangent (EPI) or t_out's (not EPI)
template <typename T, bool EPI, bool OA>
int launch_block_bwd(const void* x, const void* wqk, const void* wv, const void* bv,
                     const void* wt, const void* bt, const void* mask, const void* dxn,
                     const float* wbn, const float* bbn, const float* dsum, const float* dsumsq,
                     void* q, void* v, float* lse, void* dy, void* dv, float* dd, void* dq,
                     float* sc, void* dx, float* scratch, int blocks, float* grads, int o, int p,
                     cudaStream_t st) {
  if (int rc = project_and_lse<T>(x, wqk, wv, bv, q, v, lse, o, p, st)) return rc;

  const size_t s1 = OA ? ApplySmem<T>::oa_bwd_bytes : ApplySmem<T>::bwd_bytes;
  if (int rc = allow_smem(bwd_dz_kernel<T, EPI, OA>, s1)) return rc;
  bwd_dz_kernel<T, EPI, OA><<<blocks, kThreads, s1, st>>>(
      (const T*)x, (const T*)q, (const T*)v, lse, (const T*)wt, (const T*)bt, (const T*)mask,
      (const T*)dxn, wbn, bbn, dsum, dsumsq, (T*)dy, sc, scratch, o, p);
  if (int rc = (int)cudaGetLastError()) return rc;

  if (int rc = launch_core_bwd<T, OA, EPI, OA>(x, wqk, wv, dxn, q, v, lse, dy, sc, dv, dd, dq,
                                                dx, scratch, blocks, o, p, st))
    return rc;
  return reduce_slices(scratch, slice_stride(kBwdGrad), blocks, grads, kBwdGrad, st);
}

template <typename T>
int launch_attn_fwd(const void* x, const void* wqk, const void* wv, const void* bv, void* q,
                    void* v, float* lse, void* y, int o, int p, int oa, cudaStream_t st) {
  if (int rc = project_and_lse<T>(x, wqk, wv, bv, q, v, lse, o, p, st)) return rc;
  const long long tiles = (long long)o * ((p + kRows - 1) / kRows);
  using L = ApplySmem<T, false>;
  const size_t s3 = L::bytes;
  auto kernel =
      oa ? attn_out_kernel<T, L, kC, kDa, true> : attn_out_kernel<T, L, kC, kDa, false>;
  if (int rc = allow_smem(kernel, s3)) return rc;
  const int g3 = resident_grid(kernel, kThreads, s3, tiles);
  kernel<<<g3, kThreads, s3, st>>>((const T*)q, (const T*)v, lse, (T*)y, o, p);
  return (int)cudaGetLastError();
}

template <typename T, bool OA>
int launch_attn_bwd(const void* x, const void* wqk, const void* wv, const void* bv,
                    const void* dy, void* q, void* v, float* lse, void* dv, float* dd, void* dq,
                    float* sc, void* dx, float* scratch, int blocks, float* grads, int o, int p,
                    cudaStream_t st) {
  if (int rc = project_and_lse<T>(x, wqk, wv, bv, q, v, lse, o, p, st)) return rc;
  if constexpr (OA) {
    const long long tiles = (long long)o * ((p + kRows - 1) / kRows);
    const size_t s1 = ApplySmem<T, false>::bytes;
    auto kernel = attn_sc_kernel<T, ApplySmem<T, false>, kC, kDa>;
    if (int rc = allow_smem(kernel, s1)) return rc;
    const int g1 = resident_grid(kernel, kThreads, s1, tiles);
    kernel<<<g1, kThreads, s1, st>>>((const T*)q, (const T*)v, lse, (const T*)dy, sc, o, p);
    if (int rc = (int)cudaGetLastError()) return rc;
  }
  if (int rc = launch_core_bwd<T, OA, false, false>(x, wqk, wv, nullptr, q, v, lse, dy, sc, dv,
                                                     dd, dq, dx, scratch, blocks, o, p, st))
    return rc;
  return reduce_slices(scratch, slice_stride(kBwdGrad), blocks, grads, kOffDwt, st);
}

// The f32 backwards' buffers, carved from one work buffer: q, v, lse, dY,
// dv, D, dq and OA's [2, O·P] row vectors (1/s, c)
struct F32Work {
  float *q, *v, *lse, *dy, *dv, *dd, *dq, *sc;
};

inline size_t carve_f32(void* base, int o, int p, F32Work* w) {
  const size_t rows = (size_t)o * p;
  size_t off = 0;
  auto take = [&](size_t floats) {
    float* at = reinterpret_cast<float*>(static_cast<char*>(base) + off);
    off += (floats * 4 + 255) & ~size_t(255);
    return at;
  };
  F32Work tmp;
  F32Work& r = w ? *w : tmp;
  r.q = take(rows * kDa);
  r.v = take(rows * kC);
  r.lse = take(rows);
  r.dy = take(rows * kC);
  r.dv = take(rows * kC);
  r.dd = take(rows);
  r.dq = take(rows * kDa);
  r.sc = take(2 * rows);
  return off;
}

// the f32 block backwards: oa -> one instantiation
template <bool EPI>
int block_bwd_f32(const void* x, const void* wqk, const void* wv, const void* bv, const void* wt,
                  const void* bt, const void* mask, const void* dxn, const float* wbn,
                  const float* bbn, const float* dsum, const float* dsumsq, void* work, void* dx,
                  float* scratch, int blocks, float* grads, int o, int p, int oa,
                  cudaStream_t st) {
  F32Work w;
  carve_f32(work, o, p, &w);
#define SGA_BLOCK_BWD(OA)                                                                       \
  return launch_block_bwd<float, EPI, OA>(x, wqk, wv, bv, wt, bt, mask, dxn, wbn, bbn, dsum,    \
                                          dsumsq, w.q, w.v, w.lse, w.dy, w.dv, w.dd, w.dq, w.sc, \
                                          dx, scratch, blocks, grads, o, p, st)
  if (oa) SGA_BLOCK_BWD(true);
  SGA_BLOCK_BWD(false);
#undef SGA_BLOCK_BWD
}

}  // namespace

int launch_block_eval_sm90(const void* x, const void* wqk, const void* wv, const void* bv,
                           const void* wt, const void* bt, const float* wbn, const float* bbn,
                           void* q, void* vt, float* lse2, void* out, int o, int p, int oa,
                           cudaStream_t st);
int launch_block_fwd_sm90(const void* x, const void* wqk, const void* wv, const void* bv,
                          const void* wt, const void* bt, const void* mask, void* q, void* vt,
                          float* lse2, void* tout, float* scratch, int slices, float* sums,
                          int o, int p, int oa, cudaStream_t st);
int launch_attn_fwd_sm90(const void* x, const void* wqk, const void* wv, const void* bv, void* q,
                         void* vt, float* lse2, void* y, int o, int p, int oa, cudaStream_t st);
size_t block_bwd_work_bytes_sm90(int o, int p);
int launch_block_bwd_sm90(int kind, const void* x, const void* wqk, const void* wv,
                          const void* bv, const void* wt, const void* bt, const void* mask,
                          const void* cot, const float* wbn, const float* bbn, const float* dsum,
                          const float* dsumsq, void* work, void* dx, float* scratch, int blocks,
                          float* grads, int o, int p, int oa, cudaStream_t st);

}  // namespace sga

extern "C" {

// bf16 takes the wgmma design (pct_block_eval_sm90.cu): v is then the
// transposed work buffer [O, 128, pp] and lse [O, pp] (pp = P rounded up to
// a multiple of 8); f32 takes the three passes below with v [O, P, 128] and
// lse [O, P]
int sga_pct_block_eval(const void* x, const void* wqk, const void* wv, const void* bv,
                       const void* wt, const void* bt, const float* wbn, const float* bbn,
                       void* q, void* v, float* lse, void* out, int o, int p, int oa, int dtype,
                       void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == sga::kBF16)
    return sga::launch_block_eval_sm90(x, wqk, wv, bv, wt, bt, wbn, bbn, q, v, lse, out, o, p, oa,
                                       st);
  return sga::launch_block<float>(x, wqk, wv, bv, wt, bt, wbn, bbn, q, v, lse, out, o, p, oa,
                                  st);
}

// Training forward (SA, or OA with oa = 1): t_out [O, P, 128], sums [2, 128]
// (Σ m·t, Σ m·t²) f32; scratch: `blocks` slices of slice_stride(256) floats.
// bf16 takes the wgmma design (pct_block_eval_sm90.cu) with v and lse the
// eval block's work buffers vᵀ [O, 128, pp] and [O, pp], and `blocks` even:
// one slice per consumer warpgroup of blocks / 2 persistent blocks; f32
// takes the three passes below, one slice per block
int sga_pct_block_fwd(const void* x, const void* wqk, const void* wv, const void* bv,
                      const void* wt, const void* bt, const void* mask, void* q, void* v,
                      float* lse, void* tout, float* scratch, int blocks, float* sums, int o,
                      int p, int oa, int dtype, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == sga::kBF16)
    return sga::launch_block_fwd_sm90(x, wqk, wv, bv, wt, bt, mask, q, v, lse, tout, scratch,
                                      blocks, sums, o, p, oa, st);
  return sga::launch_block_fwd<float>(x, wqk, wv, bv, wt, bt, mask, q, v, lse, tout, scratch,
                                      blocks, sums, o, p, oa, st);
}

// Bytes of the work buffer of the three backwards below
long long sga_pct_bwd_work_bytes(int o, int p, int dtype) {
  if (dtype == sga::kBF16) return (long long)sga::block_bwd_work_bytes_sm90(o, p);
  return (long long)sga::carve_f32(nullptr, o, p, nullptr);
}

// Training backward with the epilogue (SA, or OA with oa = 1). grads f32:
// dWqk_s [128, 32] (the gradient of the scaled weight), dWv [128, 128],
// dbv [128], dWt [128, 128], dbt [128]; work: sga_pct_bwd_work_bytes bytes
// (bf16 runs the wgmma design of pct_block_bwd_sm90.cu); scratch: `blocks`
// slices of slice_stride(37120) floats
int sga_pct_block_res_bwd(const void* x, const void* wqk, const void* wv, const void* bv,
                          const void* wt, const void* bt, const void* mask, const void* dxn,
                          const float* wbn, const float* bbn, const float* dsum,
                          const float* dsumsq, void* work, void* dx, float* scratch, int blocks,
                          float* grads, int o, int p, int oa, int dtype, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == sga::kBF16)
    return sga::launch_block_bwd_sm90(0, x, wqk, wv, bv, wt, bt, mask, dxn, wbn, bbn, dsum,
                                      dsumsq, work, dx, scratch, blocks, grads, o, p, oa, st);
  return sga::block_bwd_f32<true>(x, wqk, wv, bv, wt, bt, mask, dxn, wbn, bbn, dsum, dsumsq,
                                  work, dx, scratch, blocks, grads, o, p, oa, st);
}

// pct_block_fused's backward for the cotangents dt [O, P, 128] (compute
// dtype) and dsum, dsumsq [128] (f32): dx without a residual, grads and
// buffers as sga_pct_block_res_bwd
int sga_pct_block_bwd(const void* x, const void* wqk, const void* wv, const void* bv,
                      const void* wt, const void* bt, const void* mask, const void* dt,
                      const float* dsum, const float* dsumsq, void* work, void* dx,
                      float* scratch, int blocks, float* grads, int o, int p, int oa, int dtype,
                      void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == sga::kBF16)
    return sga::launch_block_bwd_sm90(1, x, wqk, wv, bv, wt, bt, mask, dt, nullptr, nullptr,
                                      dsum, dsumsq, work, dx, scratch, blocks, grads, o, p, oa,
                                      st);
  return sga::block_bwd_f32<false>(x, wqk, wv, bv, wt, bt, mask, dt, nullptr, nullptr, dsum,
                                   dsumsq, work, dx, scratch, blocks, grads, o, p, oa, st);
}

// pct_attention_fused's forward: y [O, P, 128] in the compute dtype (OA row
// normalisation with oa = 1); q, v, lse work buffers as sga_pct_block_eval's
// (bf16 runs the wgmma design of pct_block_eval_sm90.cu)
int sga_pct_attn_fwd(const void* x, const void* wqk, const void* wv, const void* bv, void* q,
                     void* v, float* lse, void* y, int o, int p, int oa, int dtype,
                     void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == sga::kBF16)
    return sga::launch_attn_fwd_sm90(x, wqk, wv, bv, q, v, lse, y, o, p, oa, st);
  return sga::launch_attn_fwd<float>(x, wqk, wv, bv, q, v, lse, y, o, p, oa, st);
}

// pct_attention_fused's backward for dY [O, P, 128]: dx, and grads f32
// dWqk_s [128, 32], dWv [128, 128], dbv [128]; work and scratch as
// sga_pct_block_res_bwd
int sga_pct_attn_bwd(const void* x, const void* wqk, const void* wv, const void* bv,
                     const void* dy, void* work, void* dx, float* scratch, int blocks,
                     float* grads, int o, int p, int oa, int dtype, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == sga::kBF16)
    return sga::launch_block_bwd_sm90(2, x, wqk, wv, bv, nullptr, nullptr, nullptr, dy, nullptr,
                                      nullptr, nullptr, nullptr, work, dx, scratch, blocks, grads,
                                      o, p, oa, st);
  sga::F32Work w;
  sga::carve_f32(work, o, p, &w);
#define SGA_ATTN_BWD(OA)                                                                      \
  return sga::launch_attn_bwd<float, OA>(x, wqk, wv, bv, dy, w.q, w.v, w.lse, w.dv, w.dd, w.dq, \
                                         w.sc, dx, scratch, blocks, grads, o, p, st)
  if (oa) SGA_ATTN_BWD(true);
  SGA_ATTN_BWD(false);
#undef SGA_ATTN_BWD
}

}  // extern "C"
