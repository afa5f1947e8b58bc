// PCT self-attention: the SA / OA block in its inference form, its training
// forward and backward, the block op's own backward, and the bare attention
// op (projections and core, no trans) with its backward, at C = 128,
// da = 32. bf16 runs the wgmma designs of pct_block_eval_sm90.cu and
// pct_block_bwd_sm90.cu; f32 the passes of attn_f32.cuh on tail_f32.cuh's
// mainloop, launched below. pct_attention_c256.cu runs the C = 256, da = 64
// forms (pct_attention.cuh's width-generic passes and its own).
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
//   gives three passes. bf16 runs them as the wgmma design of
//   pct_block_eval_sm90.cu (the training forward and the attention op's
//   forward below too). f32 (full f32, no TF32) runs them on tail_f32.cuh's
//   mainloop (128 x 128 block tiles, 8 x 8 accumulators a thread in
//   registers across the whole reduction, a 3-stage cp.async ring, two
//   blocks an SM; attn_f32.cuh):
//     1. proj: q and v of 128 flat rows in one 128 x 160 product (x·[Wv |
//        Wqk], the weights streamed through the ring);
//     2. lse: per 128-row tile, S = q·qᵀ a 128-key tile at a time (K = 32);
//        the online max / sum-exp over each 64-key chunk through the spare
//        stage, in the first version's lane order;
//     3. attend: per 128-row tile, the keys in k-steps of 16: prep builds
//        G = exp(S − lse) of the k-step from the tile's resident q rows and
//        the k-step's q, and the mainloop adds G·v into y, in registers over
//        the whole key loop; u = y (SA) or x − y/s (OA) into the output;
//     4. trans: t = u·Wt + bt (128 flat rows a tile, in place of u), the
//        eval epilogue x + relu(t·wbn + bbn) or t_out.
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
//   slices. f32: pct_block_eval's passes with the t_out epilogue, then
//   colsum: block b of the wrapper's `blocks` adds the rows of the 64-row
//   tiles b, b + blocks, ... in the first version's order into its slice;
//   reduce_slices adds the slices in order.
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
//   pct_block_bwd_sm90.cu. f32 (full f32, no TF32): passes on tail_f32.cuh's
//   mainloop (attn_f32.cuh) after proj and lse, handing O(P·C)
//   intermediates through one work buffer (q, v, lse, u, dz, dY, OA's ŷ and
//   dŶ, dv, D, dq, 1/s and c; never [P, P]):
//     attend: y, u (OA also ŷ = y/s and 1/s);
//     trans: t = u·Wt + bt and dz with the epilogue's routing;
//     dy: dY = ±dz·Wtᵀ; OA then sc: c_j = dŶ_j·ŷ_j and dŶ = dY·(1/s);
//     dv: per 128-key tile, the query rows in k-steps of 16, G built by
//       prep, dv = Gᵀ·dŶ in registers (OA: Σ_j G[j, i]·c_j in prep); dd:
//       D_i = v_i·dv_i (less that sum);
//     dq: per object, its pairs (128-row tile I, 64-key chunk J at or after
//       I's tile) in order; one dual product gives v_I·dŶ_Jᵀ and dŶ_I·v_Jᵀ
//       in registers, from which the epilogue forms the (I, J) and (J, I)
//       tiles of dE + dEᵀ: the P²·C product once, where the first version
//       ran it for both tiles;
//     dx: dx = dq·Wqk_sᵀ + dv·Wvᵀ (+ du for OA) (+ dxn), 128 flat rows a
//       tile, K = 160;
//     wgrad and colsum: dWt = Σ uᵀ·dz, dWv, dWqk = Σ xᵀ·[dv | dq] and dbt,
//       dbv, one block a slice of the wrapper's `blocks`, over the 64-row
//       tiles the first version gave that block;
//   reduce_slices then adds the slices in block order. Every value is one
//   fmaf chain in the first version's order (the dq pass's pair order keeps
//   each dq row's keys ascending), and the sums keep its lanes and slices:
//   the f32 outputs have the first version's bits, and the same bits twice.
//
// pct_block_bwd replaces ops/pct_attention.py::_block_bwd_rule (Pallas kernel
// _block_bwd_kernel): pct_block_fused's own backward, for the cotangents
// (dt, dsum, dsumsq) of (t_out, ssum, ssumsq):
//   dz = dt + m·dsum + 2·t_out·m·dsumsq, rounded (no relu routing), then
//   pct_block_res_bwd's passes; dx has no residual (+du for OA).
//   Bound on the H100: operations, as pct_block_res_bwd.
//   Design: pct_block_res_bwd's passes, the trans pass's dz epilogue and
//   the dx pass's terms chosen per launch.
//
// pct_attn_fwd replaces ops/pct_attention.py::pct_attention_fused (Pallas
// kernel _fwd_kernel): y [O, P, 128], rounded to the compute dtype, with no
// trans, epilogue or sums. The scale flag is folded into Wqk by the wrapper,
// so SA and OA normalisation each pair with either scale.
//   Bound on the H100: operations. 2·P·C·(da + C) + 2·P²·da + 2·P²·C per
//   object: 105 MFLOP at P = 512.
//   bf16: pct_block_eval's wgmma passes, the apply pass with the attention
//   epilogue (pct_block_eval_sm90.cu). f32: proj, lse and attend as
//   pct_block_eval, attend writing y (OA y/s); no trans.
//
// pct_attn_bwd replaces ops/pct_attention.py::_bwd_rule (Pallas kernel
// _bwd_kernel): for the cotangent dY of y, dx = dq·Wqk_sᵀ + dv·Wvᵀ (no
// residual, no du), dWqk_s, dWv, dbv (f32).
//   Bound on the H100: operations. The projections again, E, dv = Gᵀ·dŶ,
//   dG = dŶ·vᵀ, dq = (dE + dEᵀ)·q, the projection gradients and dx (for OA
//   also y, for s and c).
//   Design: proj and lse; for OA only, attend (y·(1/s) and 1/s) and sc;
//   then pct_block_res_bwd's dv, dd, dq, dx (no residual, no du), wgrad and
//   colsum passes (no dWt, dbt); reduce_slices adds the slices in block
//   order: the same bits twice.
#include "attn_f32.cuh"

namespace sga {
namespace {
namespace f32 {

// ---------------------------------- launch ----------------------------------

// Launch a job kernel on as many blocks as stay resident (two an SM), at
// most one a unit
template <class Job>
int launch_job(void (*kernel)(Job, int), Job job, size_t smem, long long units,
               cudaStream_t st) {
  if (int rc = allow_smem(kernel, smem)) return rc;
  job.groups = resident_grid(kernel, kThreads, smem, units);
  kernel<<<job.groups, kThreads, smem, st>>>(job, (int)units);
  return (int)cudaGetLastError();
}

// The key loop over one object's 128-row tiles
template <bool kDvPass>
int launch_g(void (*kernel)(GJob<kDvPass>, int), GJob<kDvPass> job, int o, cudaStream_t st) {
  job.rtiles = max(1, (job.p + kTile - 1) / kTile);
  job.kst = max(1, (job.p + kBK - 1) / kBK);
  return launch_job(kernel, job, GJob<kDvPass>::kSmemBytes, (long long)o * job.rtiles, st);
}

template <int kMode>
int launch_rows(void (*kernel)(RowJob<kMode>, int), RowJob<kMode> job, cudaStream_t st) {
  return launch_job(kernel, job, kRingBytes, (job.rows + kTile - 1) / kTile, st);
}

// q and v (the projection job), then lse
int project_and_lse(const void* x, const void* wqk, const void* wv, const void* bv, float* q,
                    float* v, float* lse, int o, int p, cudaStream_t st) {
  const long long rows = (long long)o * p;
  ProjJob pj{(const float*)x, (const float*)wqk, (const float*)wv, (const float*)bv, q, v, rows};
  if (int rc = launch_job(proj_kernel, pj, sizeof(float) * kStages * ProjJob::kStageFloats,
                          (rows + kTile - 1) / kTile, st))
    return rc;
  const int rtiles = max(1, (p + kTile - 1) / kTile);
  LseJob lj{q, lse, p, rtiles, rtiles};
  return launch_job(lse128_kernel, lj, kRingBytes, (long long)o * rtiles, st);
}

inline unsigned row_grid(long long rows) {
  const long long g = (rows + kThreads / 4 - 1) / (kThreads / 4);
  return (unsigned)(g < 4096 ? g : 4096);
}

// the apply pass: u (or y) into out
int attend(const float* q, const float* v, const float* lse, const float* x, float* out,
           float* yhat, float* sc, int mode, int o, int p, int oa, cudaStream_t st) {
  GJob<false> job{q, v, lse, x, nullptr, out, yhat, sc, nullptr, nullptr, mode, oa, p};
  return launch_g(attend_kernel, job, o, st);
}

// eval (out = x + relu(t·wbn + bbn)) or the training forward (t_out, and
// its sums into `blocks` slices of `scratch`, then `sums`)
int block_fwd(const void* x, const void* wqk, const void* wv, const void* bv, const void* wt,
              const void* bt, const float* wbn, const float* bbn, const void* mask, void* q,
              void* v, float* lse, void* out, float* scratch, int blocks, float* sums, int o,
              int p, int oa, cudaStream_t st) {
  if (p == 0) return 0;  // no rows: the wrapper's zeroed sums stand
  if (int rc = project_and_lse(x, wqk, wv, bv, (float*)q, (float*)v, lse, o, p, st)) return rc;
  const float* fx = (const float*)x;
  float* fo = (float*)out;
  if (int rc = attend((const float*)q, (const float*)v, lse, fx, fo, nullptr, nullptr, kAttendU,
                      o, p, oa, st))
    return rc;
  const long long rows = (long long)o * p;
  const bool train = sums != nullptr;
  // in place: each tile's u, then t
  if (train) {
    RowJob<kTrain> t{fo, nullptr, (const float*)wt, nullptr, (const float*)bt, fx, wbn, bbn,
                     nullptr, nullptr, nullptr, nullptr, nullptr, fo, rows, p};
    if (int rc = launch_rows(trans_kernel<kTrain>, t, st)) return rc;
  } else {
    RowJob<kEval> t{fo, nullptr, (const float*)wt, nullptr, (const float*)bt, fx, wbn, bbn,
                    nullptr, nullptr, nullptr, nullptr, nullptr, fo, rows, p};
    return launch_rows(trans_kernel<kEval>, t, st);
  }
  colsum_kernel<<<blocks, kThreads, 0, st>>>(fo, (const float*)mask, scratch, rows, p, blocks,
                                              kSumsT);
  if (int rc = (int)cudaGetLastError()) return rc;
  return reduce_slices(scratch, slice_stride(2 * kC), blocks, sums, 2 * kC, st);
}

int attn_fwd(const void* x, const void* wqk, const void* wv, const void* bv, void* q, void* v,
             float* lse, void* y, int o, int p, int oa, cudaStream_t st) {
  if (p == 0) return 0;
  if (int rc = project_and_lse(x, wqk, wv, bv, (float*)q, (float*)v, lse, o, p, st)) return rc;
  return attend((const float*)q, (const float*)v, lse, (const float*)x, (float*)y, nullptr,
                nullptr, kAttendY, o, p, oa, st);
}

// The backwards' buffers, carved from one work buffer (O(P·C) each, no
// [P, P]): q, v, lse; u, dz (the block ops), dY, OA's ŷ and dŶ; dv, D, dq;
// OA's rows 1/s and c, and Σ_j G[j, i]·c_j. SA carves no OA buffer (null).
struct Work {
  float *q, *v, *lse, *u, *dz, *dy, *yhat, *dyh, *dv, *dd, *dq, *sc, *gcs;
};

inline size_t carve(void* base, int o, int p, int oa, Work* w) {
  const size_t rows = (size_t)o * p;
  size_t off = 0;
  auto take = [&](size_t floats) {
    float* at = reinterpret_cast<float*>(static_cast<char*>(base) + off);
    off += (floats * 4 + 255) & ~size_t(255);
    return at;
  };
  auto take_oa = [&](size_t floats) { return oa ? take(floats) : nullptr; };
  Work tmp;
  Work& r = w ? *w : tmp;
  r.q = take(rows * kDa);
  r.v = take(rows * kC);
  r.lse = take(rows);
  r.u = take(rows * kC);
  r.dz = take(rows * kC);
  r.dy = take(rows * kC);
  r.yhat = take_oa(rows * kC);
  r.dyh = take_oa(rows * kC);
  r.dv = take(rows * kC);
  r.dd = take(rows);
  r.dq = take(rows * kDa);
  r.sc = take_oa(2 * rows);
  r.gcs = take_oa(rows);
  return off;
}

// dv, D, dq, dx and the weight gradients' slices, shared by the three
// backwards (dY, and for OA dŶ, 1/s and c, in place). n = 2: dWt too (from
// u and dz) and Σ dz.
int core_bwd(const float* x, const float* wqk, const float* wv, const float* dxn,
             const float* dy, const Work& w, float* dx, float* scratch, int blocks, int o, int p,
             int oa, int resid, int du, int n, cudaStream_t st) {
  const long long rows = (long long)o * p;
  const float* dyh = oa ? w.dyh : dy;
  const float* cvec = oa ? w.sc + rows : nullptr;  // OA's c
  GJob<true> g{w.q, dyh, w.lse, x, cvec, w.dv, nullptr, nullptr, w.gcs, nullptr, kDv, oa,
                p};
  if (int rc = launch_g(dv_kernel, g, o, st)) return rc;
  dd_kernel<<<row_grid(rows), kThreads, 0, st>>>(w.dv, w.v, w.gcs, w.dd, rows, oa);
  if (int rc = (int)cudaGetLastError()) return rc;

  const int rtiles = max(1, (p + kTile - 1) / kTile), jchunks = (p + DqJob::kJ - 1) / DqJob::kJ;
  int pairs = 0;
  for (int it = 0; it < rtiles; ++it) pairs += jchunks - 2 * it;
  DqJob dq{w.q, w.v, dyh, w.lse, w.dd, cvec, w.dq, nullptr, oa, p, rtiles, jchunks, pairs};
  if (int rc = (int)cudaMemsetAsync(w.dq, 0, sizeof(float) * rows * kDa, st)) return rc;
  if (int rc = launch_job(dq_kernel, dq, DqJob::kSmemBytes, (long long)o, st)) return rc;

  RowJob<kDx> d{w.dq, w.dv, wqk, wv, nullptr, nullptr, nullptr, nullptr, nullptr, dxn, nullptr,
                nullptr, dy, dx, rows, p, 0, du, resid};
  if (int rc = launch_rows(dx_kernel, d, st)) return rc;

  const size_t ws = sizeof(float) * kStages * WgradJob<true>::kStageFloats;
  if (int rc = allow_smem(wgrad_kernel, ws)) return rc;
  wgrad_kernel<<<(unsigned)(n * blocks), kThreads, ws, st>>>(w.u, w.dz, x, w.dv, w.dq, scratch,
                                                            rows, p, blocks, n);
  if (int rc = (int)cudaGetLastError()) return rc;
  if (n == 2) {
    colsum_kernel<<<blocks, kThreads, 0, st>>>(w.dz, nullptr, scratch, rows, p, blocks, kSumDbt);
    if (int rc = (int)cudaGetLastError()) return rc;
  }
  colsum_kernel<<<blocks, kThreads, 0, st>>>(w.dv, nullptr, scratch, rows, p, blocks, kSumDbv);
  return (int)cudaGetLastError();
}

// pct_block_res_bwd (epi) and pct_block_bwd: cot is dxn (epi) or dt
int block_bwd(bool epi, const void* x, const void* wqk, const void* wv, const void* bv,
              const void* wt, const void* bt, const void* mask, const void* cot,
              const float* wbn, const float* bbn, const float* dsum, const float* dsumsq,
              void* work, void* dx, float* scratch, int blocks, float* grads, int o, int p,
              int oa, cudaStream_t st) {
  if (p == 0) return 0;  // no rows: the wrapper's zeroed gradients stand
  Work w;
  carve(work, o, p, oa, &w);
  const float* fx = (const float*)x;
  const long long rows = (long long)o * p;
  if (int rc = project_and_lse(x, wqk, wv, bv, w.q, w.v, w.lse, o, p, st)) return rc;
  if (int rc = attend(w.q, w.v, w.lse, fx, w.u, oa ? w.yhat : nullptr, oa ? w.sc : nullptr,
                      kAttendU, o, p, oa, st))
    return rc;
  if (epi) {
    RowJob<kDzEpi> t{w.u, nullptr, (const float*)wt, nullptr, (const float*)bt, nullptr, wbn,
                     bbn, (const float*)mask, (const float*)cot, dsum, dsumsq, nullptr, w.dz,
                     rows, p};
    if (int rc = launch_rows(trans_kernel<kDzEpi>, t, st)) return rc;
  } else {
    RowJob<kDz> t{w.u, nullptr, (const float*)wt, nullptr, (const float*)bt, nullptr, wbn, bbn,
                  (const float*)mask, (const float*)cot, dsum, dsumsq, nullptr, w.dz, rows, p};
    if (int rc = launch_rows(trans_kernel<kDz>, t, st)) return rc;
  }
  RowJob<kDy> y{w.dz, nullptr, (const float*)wt, nullptr, nullptr, nullptr, nullptr, nullptr,
                nullptr, nullptr, nullptr, nullptr, nullptr, w.dy, rows, p, oa};
  if (int rc = launch_rows(dy_kernel, y, st)) return rc;
  if (oa) {
    sc_kernel<<<row_grid(rows), kThreads, 0, st>>>(w.dy, w.yhat, w.sc, w.dyh, rows);
    if (int rc = (int)cudaGetLastError()) return rc;
  }
  if (int rc = core_bwd(fx, (const float*)wqk, (const float*)wv, (const float*)cot, w.dy, w,
                        (float*)dx, scratch, blocks, o, p, oa, epi, oa, 2, st))
    return rc;
  return reduce_slices(scratch, slice_stride(kBwdGrad), blocks, grads, kBwdGrad, st);
}

int attn_bwd(const void* x, const void* wqk, const void* wv, const void* bv, const void* dy,
             void* work, void* dx, float* scratch, int blocks, float* grads, int o, int p, int oa,
             cudaStream_t st) {
  if (p == 0) return 0;
  Work w;
  carve(work, o, p, oa, &w);
  const float* fx = (const float*)x;
  const float* fdy = (const float*)dy;
  const long long rows = (long long)o * p;
  if (int rc = project_and_lse(x, wqk, wv, bv, w.q, w.v, w.lse, o, p, st)) return rc;
  if (oa) {
    if (int rc = attend(w.q, w.v, w.lse, fx, w.yhat, nullptr, w.sc, kAttendZ, o, p, oa, st))
      return rc;
    sc_kernel<<<row_grid(rows), kThreads, 0, st>>>(fdy, w.yhat, w.sc, w.dyh, rows);
    if (int rc = (int)cudaGetLastError()) return rc;
  }
  if (int rc = core_bwd(fx, (const float*)wqk, (const float*)wv, nullptr, fdy, w, (float*)dx,
                        scratch, blocks, o, p, oa, 0, 0, 1, st))
    return rc;
  return reduce_slices(scratch, slice_stride(kBwdGrad), blocks, grads, kOffDwt, st);
}

}  // namespace f32
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
  return sga::f32::block_fwd(x, wqk, wv, bv, wt, bt, wbn, bbn, nullptr, q, v, lse, out, nullptr,
                            0, nullptr, o, p, oa, st);
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
  return sga::f32::block_fwd(x, wqk, wv, bv, wt, bt, nullptr, nullptr, mask, q, v, lse, tout,
                            scratch, blocks, sums, o, p, oa, st);
}

// Bytes of the work buffer of the three backwards below (oa = 1: OA's;
// f32 SA needs less)
long long sga_pct_bwd_work_bytes(int o, int p, int oa, int dtype) {
  if (dtype == sga::kBF16) return (long long)sga::block_bwd_work_bytes_sm90(o, p);
  return (long long)sga::f32::carve(nullptr, o, p, oa, nullptr);
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
  return sga::f32::block_bwd(true, x, wqk, wv, bv, wt, bt, mask, dxn, wbn, bbn, dsum, dsumsq,
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
  return sga::f32::block_bwd(false, x, wqk, wv, bv, wt, bt, mask, dt, nullptr, nullptr, dsum,
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
  return sga::f32::attn_fwd(x, wqk, wv, bv, q, v, lse, y, o, p, oa, st);
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
  return sga::f32::attn_bwd(x, wqk, wv, bv, dy, work, dx, scratch, blocks, grads, o, p, oa, st);
}

}  // extern "C"
