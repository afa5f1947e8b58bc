// PCT self-attention at C = 256, da = 64, the width of FullPCT's four OA
// blocks: the block's inference form (pct_block_eval), its training forward
// (pct_block_fwd) and its training backward with the BN epilogue
// (pct_block_res_bwd); the block op's own backward (pct_block_bwd); and the
// bare attention op's forward and backward (pct_attn_fwd, pct_attn_bwd);
// SA and OA. This file holds their C entry points and their f32 forms; the
// bf16 forms run the wgmma passes of pct_block_c256_sm90.cu (the forwards)
// and pct_block_bwd_c256_sm90.cu (the backwards). The notation is
// pct_attention.cu's, and so are the arguments of each C entry point.
//
// pct_block_eval replaces sgaligner_tpu/ops/pct_attention.py::pct_block_eval
// (Pallas kernel _block_eval_kernel) at this width, pct_block_fwd
// pct_block_fused's forward (_block_fwd_kernel), pct_block_res_bwd the
// backward of _block_res_bwd_rule (_block_res_bwd_kernel); the epilogue sums
// of that rule (_epi_sums_kernel) are pct_epi_sums.cu's at C = 256.
// pct_block_bwd replaces _block_bwd_rule's _block_bwd_kernel, pct_attn_fwd
// pct_attention_fused's _fwd_kernel and pct_attn_bwd _bwd_rule's
// _bwd_kernel.
//   Bound on the H100 at f32: operations. The forward does 2·P·C·(da + C) +
//   2·P²·da + 2·P²·C + 2·P·C² = 117 MFLOP per object at P = C = 256, against
//   2·P·C elements in and out; the backward about three times that. At f32
//   (no TF32: the plain versions' cuBLAS products are full f32 too) that is
//   the CUDA cores' 67 TFLOP/s: 0.45 ms a forward and 1.35 ms a backward at
//   O = 256. The attention op leaves out the 2·P·C² of trans (and its
//   backward trans's two products): 0.32 ms forward, 0.83 (SA) and 0.96
//   (OA, y again for c) backward at f32.
//   Design: pct_attention.cu's grid-stride passes over 64-row tiles (shared
//   with it through pct_attention.cuh: the log-sum-exp pass, the apply
//   loop and the dv pass), multiplying with block_gemm's register-tiled FMA
//   product (8 to 64 outputs a thread in registers, fed by 16-byte shared
//   loads, every output one fmaf chain in k order), which lifts the FMA
//   loop off the two shared loads an FMA of a one-output-a-thread loop.
//   What changes at this width is shared memory: Wv and Wt are 256 KB each
//   and a block has 227 KB, so no pass keeps a whole weight resident, as the
//   C = 128 passes do. Every product with a weight streams it through shared
//   memory in kN = 32-column (or -row) slices, per 64-row tile, from L2,
//   double-buffered with cp.async so that slice s + 1 arrives while slice s
//   multiplies:
//     project: [Wqk | Wv] in column slices, each slice's q or v columns
//       written as it is done (16-byte stores); two weight stages and two
//       x tiles, the next tile's x arriving with its first slice;
//     apply (eval and training forward): y by attend_tile, u in shared
//       memory, then t = u·Wt one column slice at a time, each slice's
//       epilogue (the residual, or t and the masked BN sums) right after;
//       the two Wt stages take the key loop's room beside u, and the t
//       slice the q tile's place;
//     dz (backward): t, dz, dWt += uᵀ·dz and du += dz·Wt_sliceᵀ slice by
//       slice from the same column slice of Wt (two stages, as apply's;
//       the dz slice overwrites t in place, which is what makes room for
//       the second stage: 226,816 bytes), so neither t nor dz is ever
//       whole; OA keeps y/s in a device work buffer (no room beside du) and
//       forms c_j from it once du is complete;
//     dq: the (I, J) products v_I·dŶ_Jᵀ and dŶ_I·v_Jᵀ summed over kNq =
//       64-channel slices of the four operands, which no longer fit whole,
//       double-buffered (OA's 1/s applied by each thread to the chunks it
//       copied);
//     dx: dx = dq·Wqk_sᵀ + dv·Wvᵀ one output column slice at a time from
//       row slices of Wqk and Wv, the second stage in the x tile's place
//       once xᵀ·dq and xᵀ·dv have read it.
//   pct_block_bwd runs the same passes with the dz pass's and the dx pass's
//   epilogues chosen at compile time (dz from the cotangent dt, no relu
//   routing, in dxn's slice; no residual in dx). pct_attn_fwd runs project,
//   lse and an output pass (attend_tile, then y, OA y/s; no Wt staged, so
//   its shared memory is the key loop's alone); pct_attn_bwd runs project,
//   lse, for OA an sc pass (y and s again, then 1/s_j and c_j from the
//   caller's dY rows), then the dv, dq and dx passes (dx without residual
//   or du) on the caller's dY.
//   The key chunks of the lse, apply and dv loops arrive the same way
//   (pct_attention.cuh). Every layout is checked against the 232,448 bytes
//   a block may have.
//   Weight gradients and BN sums go to per-block slices that reduce_slices
//   adds in block order: no atomics, the same bits from run to run.
#include "pct_attention.cuh"

namespace sga {
namespace {

constexpr int kC = 256;       // channels
constexpr int kDa = 64;       // q/k width (C / 4)
constexpr int kN = 32;        // columns (or rows) of a streamed weight slice
constexpr int kNq = 64;       // channels of the dq pass's slices of v and dY
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
// block_gemm's 16-byte stores accumulate into the slice: aligned pieces
static_assert(Grad::dwv % 8 == 0 && Grad::dwt % 8 == 0, "gradient slice alignment");

// ----------------------------- pass 1: project -----------------------------

// The x tile and two stages of a kNp-column slice of [Wqk | Wv]: slice
// s + 1 arrives (cp.async) while slice s multiplies; the next tile's x once
// the last slice has read this one's. kNp = 64 (not kN): a thread's 16
// outputs of a [64, 64] slice take half the shared loads an FMA of 8 of a
// [64, 32] one
constexpr int kNp = 64;
constexpr int kProjSlices = (kDa + kC) / kNp;  // slice 0 is Wqk, 1.. are Wv's
static_assert(kDa == kNp, "project: slice 0 is all of Wqk");

struct ProjSmem {
  static constexpr int ldx = pad_ld<float>(kC), ldw = pad_ld<float>(kNp), ldc = pad_ldf(kNp);
  static constexpr size_t w_stage = align128(sizeof(float) * kC * ldw);
  static constexpr size_t x_off = 0;
  static constexpr size_t w_off = align128(x_off + sizeof(float) * kRows * ldx);
  static constexpr size_t c_off = w_off + 2 * w_stage;
  static constexpr size_t bytes = align128(c_off + sizeof(float) * kRows * ldc);
};
static_assert(ProjSmem::bytes <= kSmemMax, "project: shared memory");

// q = x·Wqk and v = x·Wv + bv of each 64-row tile, one kNp-column slice of
// [Wqk | Wv] at a time
__global__ void __launch_bounds__(kThreads)
project_kernel(const float* __restrict__ x, const float* __restrict__ wqk,
               const float* __restrict__ wv, const float* __restrict__ bv,
               float* __restrict__ q, float* __restrict__ v, int o, int p) {
  using L = ProjSmem;
  extern __shared__ __align__(128) unsigned char smem[];
  float* sx = reinterpret_cast<float*>(smem + L::x_off);
  float* sc = reinterpret_cast<float*>(smem + L::c_off);
  auto sw = [&](int i) {
    return reinterpret_cast<float*>(smem + L::w_off + (i & 1) * L::w_stage);
  };

  const int per_obj = (p + kRows - 1) / kRows;
  const long long tiles = (long long)o * per_obj;
  auto issue_x = [&](long long t) {
    const int obj = (int)(t / per_obj), r0 = (int)(t % per_obj) * kRows;
    load_tile_async<float>(sx, L::ldx, x + ((size_t)obj * p + r0) * kC, kC, kRows, kC,
                           min(kRows, p - r0));
    cp_async_commit();
  };
  auto issue_slice = [&](int s, int i) {
    if (s == 0)
      load_tile_async<float>(sw(i), L::ldw, wqk, kDa, kC, kNp, kC);
    else
      load_tile_async<float>(sw(i), L::ldw, wv + (s - 1) * kNp, kC, kC, kNp, kC);
    cp_async_commit();
  };
  if (blockIdx.x < tiles) {
    issue_x(blockIdx.x);
    issue_slice(0, 0);
  }
  int g = 0;  // this block's slice count: slice g sits in stage g % 2
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int obj = (int)(t / per_obj), r0 = (int)(t % per_obj) * kRows;
    const int valid = min(kRows, p - r0);
    const size_t row0 = (size_t)obj * p + r0;
    const bool more = t + gridDim.x < tiles;
    for (int s = 0; s < kProjSlices; ++s, ++g) {
      const bool last = s + 1 == kProjSlices;
      if (!last || more) {
        issue_slice(last ? 0 : s + 1, g + 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      block_gemm<false, false, kRows, kNp, kC>(sx, L::ldx, sw(g), L::ldw, sc, L::ldc, false);
      __syncthreads();
      if (last && more) issue_x(t + gridDim.x);  // x read: the next tile's may come
      for (int idx = threadIdx.x; idx < valid * (kNp / 4); idx += blockDim.x) {
        const int r = idx / (kNp / 4), c = 4 * (idx % (kNp / 4));
        const float4 a = *reinterpret_cast<const float4*>(sc + r * L::ldc + c);
        if (s == 0) {
          store4<float>(q + (row0 + r) * kDa + c, a.x, a.y, a.z, a.w);
        } else {
          const int n = (s - 1) * kNp + c;
          const float4 b = load4<float>(bv + n);
          store4<float>(v + (row0 + r) * kC + n, a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
        }
      }
    }
  }
}

// ------------------------- pass 3: apply, and dz ----------------------------

// The apply pass's (kDz false) and the dz pass's layout: attend_tile's tiles
// (qt, y, rs, lc, then the key loop's qc, vc, s, g); acc: the block's
// per-channel sums. The epilogue multiplies u by kNw-column slices of Wt in
// two stages (slice n0 + kNw arrives while n0 multiplies) in the key loop's
// room, with u beside them or, in the apply pass, over y (form_u writes
// each element over its own y), which leaves room for kNw = 64 there (16
// outputs a thread, not 8; the dz pass keeps du in y and takes kN = 32).
// The t slice takes the q tile's place where it fits; the dz slice takes
// t's place (each element overwrites its own t), then the dz pass's slice
// of dxn the rest of the q tile's place
template <bool kDz>
struct ApplySmem {
  static constexpr int kNw = kDz ? kN : 2 * kN;
  static constexpr int ldq = pad_ld<float>(kDa), ldv = pad_ld<float>(kC);
  static constexpr int ldg = pad_ld<float>(kRows);
  static constexpr int lds = pad_ldf(kRows), ldy = pad_ldf(kC);
  static constexpr int ldu = pad_ld<float>(kC), ldw = pad_ld<float>(kNw), ldt = pad_ldf(kNw);
  static constexpr int ldz = pad_ld<float>(kN);
  static constexpr size_t qt_off = 0;
  static constexpr size_t y_off = align128(qt_off + sizeof(float) * kRows * ldq);
  static constexpr size_t rs_off = align128(y_off + sizeof(float) * kRows * ldy);
  static constexpr size_t lc_off = align128(rs_off + sizeof(float) * kRows);
  static constexpr size_t acc_off = align128(lc_off + sizeof(float) * kRows);
  static constexpr size_t qc_off = align128(acc_off + sizeof(float) * 2 * kC);
  static constexpr size_t vc_off = align128(qc_off + sizeof(float) * kRows * ldq);
  static constexpr size_t s_off = align128(vc_off + sizeof(float) * kRows * ldv);
  static constexpr size_t g_off = align128(s_off + sizeof(float) * kRows * lds);
  static constexpr size_t loop_end = align128(g_off + sizeof(float) * kRows * ldg);
  static constexpr bool kUinY = !kDz;
  static constexpr size_t u_off = kUinY ? y_off : qc_off;
  static constexpr size_t w_stage = align128(sizeof(float) * kC * ldw);
  static constexpr size_t w_off = kUinY ? qc_off : align128(u_off + sizeof(float) * kRows * ldu);
  static constexpr size_t w_end = w_off + 2 * w_stage;
  static constexpr bool kTinQ = sizeof(float) * kRows * ldt <= y_off - qt_off;
  static constexpr size_t t_off = kTinQ ? qt_off : w_end;
  static constexpr size_t t_end = kTinQ ? w_end : align128(t_off + sizeof(float) * kRows * ldt);
  static constexpr size_t z_off = t_off;
  static constexpr size_t dxn_off = align128(t_off + sizeof(float) * kRows * ldt);
  static constexpr size_t bytes = loop_end > t_end ? loop_end : t_end;
  static_assert(!kUinY || ldu == ldy, "apply: u over y element by element");
  static_assert(!kDz || (kTinQ && dxn_off + sizeof(float) * kRows * kN <= y_off),
                "dz: t and dxn in the q tile's place");
  static_assert(!kDz || ldz == ldt, "dz: the dz slice overwrites t in place");
};
static_assert(ApplySmem<false>::bytes <= kSmemMax, "apply: shared memory");
static_assert(ApplySmem<true>::bytes <= kSmemMax, "dz: shared memory");

// Issue the column slice n0.. of Wt into the epilogue's weight stage `i % 2`
template <typename L>
__device__ __forceinline__ void wt_slice_async(unsigned char* smem, const float* __restrict__ wt,
                                               int n0, int i) {
  load_tile_async<float>(reinterpret_cast<float*>(smem + L::w_off + (i & 1) * L::w_stage), L::ldw,
                         wt + n0, kC, kC, L::kNw, kC);
  cp_async_commit();
}

// Wait for the weight stage of slice n0 (the next one issued first, if any)
template <typename L>
__device__ __forceinline__ const float* wt_slice_ready(unsigned char* smem,
                                                       const float* __restrict__ wt, int n0) {
  const int i = n0 / L::kNw;
  if (n0 + L::kNw < kC) {
    wt_slice_async<L>(smem, wt, n0 + L::kNw, i + 1);
    cp_async_wait<1>();
  } else {
    cp_async_wait<0>();
  }
  __syncthreads();
  return reinterpret_cast<const float*>(smem + L::w_off + (i & 1) * L::w_stage);
}

// u = y (SA) or x − y/s (OA) of one tile into su; rows
// past `valid` zero. OA with ys: y/s (f32) also into ys (the dz pass's c).
template <typename L>
__device__ __forceinline__ void form_u(unsigned char* smem, const float* __restrict__ x, size_t at0,
                                       int valid, int oa, float* __restrict__ ys) {
  const float* sy = reinterpret_cast<const float*>(smem + L::y_off);
  const float* srs = reinterpret_cast<const float*>(smem + L::rs_off);
  float* su = reinterpret_cast<float*>(smem + L::u_off);
  for (int idx = threadIdx.x; idx < kRows * kC; idx += blockDim.x) {
    const int r = idx / kC, c = idx % kC;
    float u = 0.f;
    if (r < valid) {
      float y = sy[r * L::ldy + c];
      if (oa) y = y / (1e-9f + srs[r]);
      u = y;
      if (oa) {
        if (ys) ys[at0 + (size_t)r * kC + c] = y;
        u = x[at0 + (size_t)r * kC + c] - u;
      }
    }
    su[r * L::ldu + c] = u;
  }
}

// TRAIN = false: out = x + relu(t·wbn + bbn) (pct_block_eval).
// TRAIN = true: out = t (pct_block_fwd) and the block's masked channel sums
// Σ m·t, Σ m·t² into its scratch slice [2, 256].
template <bool TRAIN>
__global__ void __launch_bounds__(kThreads)
apply_kernel(const float* __restrict__ x, const float* __restrict__ q, const float* __restrict__ v,
             const float* __restrict__ lse, const float* __restrict__ wt,
             const float* __restrict__ bt, const float* __restrict__ wbn,
             const float* __restrict__ bbn,
             const float* __restrict__ mask, float* __restrict__ out, float* __restrict__ scratch,
             int o, int p, int oa) {
  using L = ApplySmem<false>;
  constexpr int kNw = L::kNw;
  extern __shared__ __align__(128) unsigned char smem[];
  float* sacc = reinterpret_cast<float*>(smem + L::acc_off);
  const float* su = reinterpret_cast<const float*>(smem + L::u_off);
  float* st = reinterpret_cast<float*>(smem + L::t_off);

  for (int i = threadIdx.x; i < 2 * kC; i += blockDim.x) sacc[i] = 0.f;
  const int per_obj = (p + kRows - 1) / kRows;
  const long long tiles = (long long)o * per_obj;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int obj = (int)(t / per_obj), r0 = (int)(t % per_obj) * kRows;
    const int valid = min(kRows, p - r0);
    const size_t ob = (size_t)obj * p;
    attend_tile<L, kC, kDa>(smem, q, v, lse, ob, r0, valid, p);
    wt_slice_async<L>(smem, wt, 0, 0);
    form_u<L>(smem, x, (ob + r0) * kC, valid, oa, nullptr);
    const float m = TRAIN ? mask[obj] : 0.f;
    for (int n0 = 0; n0 < kC; n0 += kNw) {
      const float* sw = wt_slice_ready<L>(smem, wt, n0);
      block_gemm<false, false, kRows, kNw, kC>(su, L::ldu, sw, L::ldw, st, L::ldt, false);
      __syncthreads();
      for (int idx = threadIdx.x; idx < valid * (kNw / 4); idx += blockDim.x) {
        const int r = idx / (kNw / 4), c = 4 * (idx % (kNw / 4));
        const size_t at = (ob + r0 + r) * kC + n0 + c;
        const float4 a = *reinterpret_cast<const float4*>(st + r * L::ldt + c);
        const float4 b = load4<float>(bt + n0 + c);
        const float tv[4] = {a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w};
        if constexpr (TRAIN) {
          store4<float>(out + at, tv[0], tv[1], tv[2], tv[3]);
          *reinterpret_cast<float4*>(st + r * L::ldt + c) = make_float4(tv[0], tv[1], tv[2], tv[3]);
        } else {
          const float4 xv = load4<float>(x + at);
          const float xs[4] = {xv.x, xv.y, xv.z, xv.w};
          float o4[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            o4[e] = xs[e] + fmaxf(tv[e] * wbn[n0 + c + e] + bbn[n0 + c + e], 0.f);
          store4<float>(out + at, o4[0], o4[1], o4[2], o4[3]);
        }
      }
      if constexpr (TRAIN) {
        __syncthreads();
        if (threadIdx.x < kNw) {
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

// The attention op's passes (attn_out_kernel, attn_sc_kernel) hold
// attend_tile's tiles alone: the apply layout up to the end of its key loop
// (no weight stage, u or t)
constexpr size_t kAttnSmem = ApplySmem<false>::loop_end;
static_assert(kAttnSmem <= kSmemMax, "attention: shared memory");

// dz pass of the block backwards: per row tile recompute y, u and, one
// column slice of Wt at a time, t_out and dz (rounded), adding uᵀ·dz into
// the block's dWt and Σ dz into its dbt, and du += dz·Wt_sliceᵀ; then
// dY = ±du (rounded) and for OA the row vectors 1/s_j and
// c_j = (dY_j / s_j)·(y_j / s_j) into sc. EPI (pct_block_res_bwd):
// dz = dxn·[t_out·wbn + bbn > 0]·wbn + m·dsum + 2·t_out·m·dsumsq; otherwise
// (pct_block_bwd) dxn is the cotangent dt of t_out, dz = dt + m·dsum +
// 2·t_out·m·dsumsq, and wbn, bbn are not read.
template <bool EPI, bool OA>
__global__ void __launch_bounds__(kThreads)
bwd_dz_kernel(const float* __restrict__ x, const float* __restrict__ q, const float* __restrict__ v,
              const float* __restrict__ lse, const float* __restrict__ wt,
              const float* __restrict__ bt,
              const float* __restrict__ mask, const float* __restrict__ dxn,
              const float* __restrict__ wbn, const float* __restrict__ bbn,
              const float* __restrict__ dsum, const float* __restrict__ dsumsq,
              float* __restrict__ dy, float* __restrict__ sc, float* __restrict__ ys,
              float* __restrict__ scratch, int o, int p) {
  using L = ApplySmem<true>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* sy = reinterpret_cast<float*>(smem + L::y_off);  // y, then du
  const float* srs = reinterpret_cast<const float*>(smem + L::rs_off);
  float* sdbt = reinterpret_cast<float*>(smem + L::acc_off);
  const float* su = reinterpret_cast<const float*>(smem + L::u_off);
  float* st = reinterpret_cast<float*>(smem + L::t_off);
  float* sz = reinterpret_cast<float*>(smem + L::z_off);
  float* sdxn = reinterpret_cast<float*>(smem + L::dxn_off);

  float* part = scratch + (size_t)blockIdx.x * slice_stride(Grad::total);
  for (int i = threadIdx.x; i < kC * kC / 4; i += blockDim.x)
    reinterpret_cast<float4*>(part + Grad::dwt)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
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
    attend_tile<L, kC, kDa>(smem, q, v, lse, ob, r0, valid, p);
    wt_slice_async<L>(smem, wt, 0, 0);
    form_u<L>(smem, x, (ob + r0) * kC, valid, OA, ys);
    const float m = mask[obj];
    for (int n0 = 0; n0 < kC; n0 += kN) {
      // this slice's dxn arrives while t multiplies, and the next Wt slice
      load_tile_async<float>(sdxn, kN, dxn + (ob + r0) * kC + n0, kC, kRows, kN, valid);
      cp_async_commit();
      const int i = n0 / kN;
      if (n0 + kN < kC) {
        wt_slice_async<L>(smem, wt, n0 + kN, i + 1);
        cp_async_wait<2>();
      } else {
        cp_async_wait<1>();
      }
      __syncthreads();
      const float* sw = reinterpret_cast<const float*>(smem + L::w_off + (i & 1) * L::w_stage);
      block_gemm<false, false, kRows, kN, kC>(su, L::ldu, sw, L::ldw, st, L::ldt, false);
      cp_async_wait<0>();
      __syncthreads();
      // one element at a time, as written: the same expression over four
      // elements gave other bits on an H100 (the compiler fused other
      // products into FMAs)
#pragma unroll
      for (int e = 0; e < kRows * kN / kThreads; ++e) {
        const int idx = threadIdx.x + e * kThreads;
        const int r = idx / kN, c = idx % kN, ch = n0 + c;
        float dz = 0.f;
        if (r < valid) {
          if constexpr (EPI) {
            const float wc = wbn[ch];
            const float tv = st[r * L::ldt + c] + bt[ch];
            const float g = sdxn[r * kN + c];
            const bool live = epi_live<float>(tv, wc, bbn[ch]);
            dz = ((live ? g : 0.f) * wc + m * dsum[ch]) + 2.f * tv * (m * dsumsq[ch]);
          } else {
            const float tv = st[r * L::ldt + c] + bt[ch];
            const float g = sdxn[r * kN + c];
            dz = (g + m * dsum[ch]) + 2.f * tv * (m * dsumsq[ch]);
          }
        }
        sz[r * L::ldz + c] = dz;
      }
      __syncthreads();
      if (threadIdx.x < kN) {
        float s = 0.f;
        for (int r = 0; r < valid; ++r) s += sz[r * L::ldz + threadIdx.x];
        sdbt[n0 + threadIdx.x] += s;
      }
      block_gemm<false, true, kC, kN, kRows>(su, L::ldu, sz, L::ldz, part + Grad::dwt + n0, kC,
                                             true);
      block_gemm<true, false, kRows, kC, kN>(sz, L::ldz, sw, L::ldw, sy, L::ldy, n0 > 0);
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
    for (int idx = threadIdx.x; idx < valid * (kC / 4); idx += blockDim.x) {
      const int r = idx / (kC / 4), cc = 4 * (idx % (kC / 4));
      const float4 d = *reinterpret_cast<const float4*>(sy + r * L::ldy + cc);
      if (OA)
        store4<float>(dy + (ob + r0 + r) * kC + cc, -d.x, -d.y, -d.z, -d.w);
      else
        store4<float>(dy + (ob + r0 + r) * kC + cc, d.x, d.y, d.z, d.w);
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < kC; i += blockDim.x) part[Grad::dbt + i] = sdbt[i];
}

// --------------------------------- dq pass ----------------------------------

template <bool OA>
struct DqSmem {
  static constexpr int ldq = pad_ld<float>(kDa), ldk = pad_ld<float>(kNq);
  static constexpr int ldf = pad_ld<float>(kRows);
  static constexpr int lds = pad_ldf(kRows), lda = pad_ldf(kDa);
  static constexpr size_t qi_off = 0;
  static constexpr size_t qj_off = align128(qi_off + sizeof(float) * kRows * ldq);
  // two stages of a column slice of the I-side and of the J-side operand:
  // slice k + 1 arrives while slice k multiplies
  static constexpr size_t ab_tile = align128(sizeof(float) * kRows * ldk);
  static constexpr size_t ab_off = align128(qj_off + sizeof(float) * kRows * ldq);
  static constexpr size_t s_off = ab_off + 4 * ab_tile;
  static constexpr size_t pp_off = align128(s_off + sizeof(float) * kRows * lds);
  static constexpr size_t f_off = align128(pp_off + sizeof(float) * kRows * lds);
  static constexpr size_t f_end = align128(f_off + sizeof(float) * kRows * lds);
  // the F tile the product reads: F itself
  static constexpr size_t ft_off = f_off;
  static constexpr size_t dq_off = f_end;
  static constexpr size_t vec_off = align128(dq_off + sizeof(float) * kRows * lda);
  // lse and D of tiles I and J; OA: c of both too
  static constexpr size_t bytes = align128(vec_off + sizeof(float) * (OA ? 6 : 4) * kRows);
  __device__ static float* a(unsigned char* smem, int i) {
    return reinterpret_cast<float*>(smem + ab_off + (i & 1) * 2 * ab_tile);
  }
  __device__ static float* b(unsigned char* smem, int i) {
    return reinterpret_cast<float*>(smem + ab_off + ((i & 1) * 2 + 1) * ab_tile);
  }
};
static_assert(DqSmem<true>::bytes <= kSmemMax, "dq: shared memory");

// spp[i, j] = Σ_c a[i, c]·b[j, c] over the C channels of the rows a0.. (a)
// and b0.. (b) of the object, in kNq-column slices; a (or b) with `a_dy`
// (`b_dy`) is dY, scaled by 1/s (sc) for OA. Ends synchronised.
template <bool OA>
__device__ void channel_product(unsigned char* smem, const float* __restrict__ a, bool a_dy,
                                const float* __restrict__ b, const float* __restrict__ sc,
                                size_t a0, int a_valid, size_t b0, int b_valid) {
  using L = DqSmem<OA>;
  float* spp = reinterpret_cast<float*>(smem + L::pp_off);
  auto issue = [&](int k0, int i) {
    load_tile_async<float>(L::a(smem, i), L::ldk, a + a0 * kC + k0, kC, kRows, kNq, a_valid);
    load_tile_async<float>(L::b(smem, i), L::ldk, b + b0 * kC + k0, kC, kRows, kNq, b_valid);
    cp_async_commit();
  };
  issue(0, 0);
  for (int k0 = 0, i = 0; k0 < kC; k0 += kNq, ++i) {
    if (k0 + kNq < kC) {
      issue(k0 + kNq, i + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    if constexpr (OA) {
      if (a_dy)
        scale_own_rows(L::a(smem, i), L::ldk, kRows, kNq, a_valid, sc + a0);
      else
        scale_own_rows(L::b(smem, i), L::ldk, kRows, kNq, b_valid, sc + b0);
    }
    __syncthreads();
    block_gemm<true, false, kRows, kRows, kNq>(L::a(smem, i), L::ldk, L::b(smem, i), L::ldk,
                                               spp, L::lds, k0 > 0);
    __syncthreads();
  }
}

// dq pass: per row tile I, dq_I = Σ_J F_IJ·q_J with F the (I, J) tile of
// dE + dEᵀ (pct_attention.cu's bwd_dq_kernel, its two [64, 64] products
// over the channels taken in slices)
template <bool OA>
__global__ void __launch_bounds__(kThreads)
bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ v,
              const float* __restrict__ lse, const float* __restrict__ dy,
              const float* __restrict__ dd, const float* __restrict__ sc, float* __restrict__ dq,
              int o, int p) {
  using L = DqSmem<OA>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* sqi = reinterpret_cast<float*>(smem + L::qi_off);
  float* sqj = reinterpret_cast<float*>(smem + L::qj_off);
  float* ss = reinterpret_cast<float*>(smem + L::s_off);
  const float* spp = reinterpret_cast<const float*>(smem + L::pp_off);
  float* sf = reinterpret_cast<float*>(smem + L::f_off);
  float* sft = reinterpret_cast<float*>(smem + L::ft_off);
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
    load_tile<float>(sqi, L::ldq, q + (ob + i0) * kDa, kDa, kRows, kDa, valid);
    if (threadIdx.x < kRows) {
      const bool in = threadIdx.x < valid;
      li[threadIdx.x] = in ? lse[ob + i0 + threadIdx.x] : 0.f;
      di[threadIdx.x] = in ? dd[ob + i0 + threadIdx.x] : 0.f;
      if constexpr (OA) ci[threadIdx.x] = in ? sc[rows + ob + i0 + threadIdx.x] : 0.f;
    }
    for (int j0 = 0; j0 < p; j0 += kRows) {
      const int kv = min(kRows, p - j0);
      load_tile<float>(sqj, L::ldq, q + (ob + j0) * kDa, kDa, kRows, kDa, kv);
      if (threadIdx.x < kRows) {
        const bool in = threadIdx.x < kv;
        lj[threadIdx.x] = in ? lse[ob + j0 + threadIdx.x] : 0.f;
        dj[threadIdx.x] = in ? dd[ob + j0 + threadIdx.x] : 0.f;
        if constexpr (OA) cj[threadIdx.x] = in ? sc[rows + ob + j0 + threadIdx.x] : 0.f;
      }
      __syncthreads();
      block_gemm<true, false, kRows, kRows, kDa>(sqi, L::ldq, sqj, L::ldq, ss, L::lds, false);
      // v_I·dŶ_Jᵀ
      channel_product<OA>(smem, v, false, dy, sc, ob + i0, valid, ob + j0, kv);
      // dE[j, i] term: G[j, i] = exp(E[i, j] − lse_i), dŶ_j·v_i = (v_I·dŶ_Jᵀ)[i, j]
      for (int idx = threadIdx.x; idx < kRows * kRows; idx += blockDim.x) {
        const int i = idx / kRows, j = idx % kRows;
        float a = spp[i * L::lds + j];
        if constexpr (OA) a -= cj[j];
        sf[i * L::lds + j] = expf(ss[i * L::lds + j] - li[i]) * (a - di[i]);
      }
      __syncthreads();
      // dŶ_I·v_Jᵀ
      channel_product<OA>(smem, dy, true, v, sc, ob + i0, valid, ob + j0, kv);
      // dE[i, j] term: G[i, j] = exp(E[i, j] − lse_j), dŶ_i·v_j
      for (int idx = threadIdx.x; idx < kRows * kRows; idx += blockDim.x) {
        const int i = idx / kRows, j = idx % kRows;
        float f = 0.f;
        if (j < kv) {
          float a = spp[i * L::lds + j];
          if constexpr (OA) a -= ci[i];
          f = sf[i * L::lds + j] + expf(ss[i * L::lds + j] - lj[j]) * (a - dj[j]);
        }
        sft[i * L::ldf + j] = f;
      }
      __syncthreads();
      block_gemm<false, false, kRows, kDa, kRows>(sft, L::ldf, sqj, L::ldq, sdq, L::lda, j0 > 0);
      __syncthreads();
    }
    for (int idx = threadIdx.x; idx < valid * kDa; idx += blockDim.x) {
      const int r = idx / kDa, d = idx % kDa;
      dq[(ob + i0 + r) * kDa + d] = sdq[r * L::lda + d];
    }
    __syncthreads();
  }
}

// --------------------------------- dx pass ----------------------------------

// Two stages of the row slices [kN, ·] of Wqk_s and Wv: stage 0 after the
// tiles, stage 1 in the x tile's place, free once the weight gradients have
// read x
struct DxSmem {
  static constexpr int ldx = pad_ld<float>(kC), ldq = pad_ld<float>(kDa), ldc = pad_ldf(kN);
  static constexpr size_t x_off = 0;
  static constexpr size_t dq_off = align128(x_off + sizeof(float) * kRows * ldx);
  static constexpr size_t dv_off = align128(dq_off + sizeof(float) * kRows * ldq);
  static constexpr size_t wq0_off = align128(dv_off + sizeof(float) * kRows * ldx);
  static constexpr size_t wv0_off = align128(wq0_off + sizeof(float) * kN * ldq);
  static constexpr size_t wq1_off = x_off;
  static constexpr size_t wv1_off = align128(wq1_off + sizeof(float) * kN * ldq);
  static constexpr size_t c_off = align128(wv0_off + sizeof(float) * kN * ldx);
  static constexpr size_t bytes = align128(c_off + sizeof(float) * kRows * ldc);
  static_assert(wv1_off + sizeof(float) * kN * ldx <= dq_off, "dx: stage 1 in the x tile");
};
static_assert(DxSmem::bytes <= kSmemMax, "dx: shared memory");

// dx pass: dx = dq·Wqk_sᵀ + dv·Wvᵀ (+ du = −dY with DU) (+ dxn with RESID),
// one kN-column slice of dx at a time; xᵀ·dq, xᵀ·dv and Σ dv into the
// block's slice.
template <bool RESID, bool DU>
__global__ void __launch_bounds__(kThreads)
bwd_dx_kernel(const float* __restrict__ x, const float* __restrict__ wqk,
              const float* __restrict__ wv, const float* __restrict__ dq,
              const float* __restrict__ dv, const float* __restrict__ dxn,
              const float* __restrict__ dy, float* __restrict__ dx, float* __restrict__ scratch,
              long long rows) {
  using L = DxSmem;
  extern __shared__ __align__(128) unsigned char smem[];
  float* sx = reinterpret_cast<float*>(smem + L::x_off);
  float* sdq = reinterpret_cast<float*>(smem + L::dq_off);
  float* sdv = reinterpret_cast<float*>(smem + L::dv_off);
  float* sc = reinterpret_cast<float*>(smem + L::c_off);
  auto issue_slice = [&](int n0, int i) {
    load_tile_async<float>(reinterpret_cast<float*>(smem + (i & 1 ? L::wq1_off : L::wq0_off)),
                           L::ldq, wqk + (size_t)n0 * kDa, kDa, kN, kDa, kN);
    load_tile_async<float>(reinterpret_cast<float*>(smem + (i & 1 ? L::wv1_off : L::wv0_off)),
                           L::ldx, wv + (size_t)n0 * kC, kC, kN, kC, kN);
    cp_async_commit();
  };

  float* part = scratch + (size_t)blockIdx.x * slice_stride(Grad::total);
  for (int i = threadIdx.x; i < Grad::dbv; i += blockDim.x) part[i] = 0.f;  // dWqk, dWv
  float rdbv = 0.f;  // channel threadIdx.x
  __syncthreads();

  const long long tiles = (rows + kRows - 1) / kRows;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long row0 = t * kRows;
    const int valid = (int)min((long long)kRows, rows - row0);
    load_tile_async<float>(sx, L::ldx, x + row0 * kC, kC, kRows, kC, valid);
    load_tile_async<float>(sdq, L::ldq, dq + row0 * kDa, kDa, kRows, kDa, valid);
    load_tile_async<float>(sdv, L::ldx, dv + row0 * kC, kC, kRows, kC, valid);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    issue_slice(0, 0);  // arrives while the weight gradients multiply
    block_gemm<false, true, kC, kDa, kRows>(sx, L::ldx, sdq, L::ldq, part + Grad::dwqk, kDa,
                                            true);
    block_gemm<false, true, kC, kC, kRows>(sx, L::ldx, sdv, L::ldx, part + Grad::dwv, kC, true);
    for (int r = 0; r < valid; ++r) rdbv += sdv[r * L::ldx + threadIdx.x];
    __syncthreads();  // x read: stage 1 may take its place
    for (int n0 = 0; n0 < kC; n0 += kN) {
      const int i = n0 / kN;
      if (n0 + kN < kC) {
        issue_slice(n0 + kN, i + 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const float* swq = reinterpret_cast<const float*>(smem + (i & 1 ? L::wq1_off : L::wq0_off));
      const float* swv = reinterpret_cast<const float*>(smem + (i & 1 ? L::wv1_off : L::wv0_off));
      block_gemm<true, false, kRows, kN, kDa>(sdq, L::ldq, swq, L::ldq, sc, L::ldc, false);
      __syncthreads();
      block_gemm<true, false, kRows, kN, kC>(sdv, L::ldx, swv, L::ldx, sc, L::ldc, true);
      __syncthreads();
      for (int idx = threadIdx.x; idx < valid * (kN / 4); idx += blockDim.x) {
        const int r = idx / (kN / 4), c = 4 * (idx % (kN / 4));
        const long long at = (row0 + r) * kC + n0 + c;
        const float4 s4 = *reinterpret_cast<const float4*>(sc + r * L::ldc + c);
        float d[4] = {s4.x, s4.y, s4.z, s4.w};
        if constexpr (DU) {
          const float4 y4 = load4<float>(dy + at);
          d[0] -= y4.x, d[1] -= y4.y, d[2] -= y4.z, d[3] -= y4.w;
        }
        if constexpr (RESID) {
          const float4 g4 = load4<float>(dxn + at);
          d[0] += g4.x, d[1] += g4.y, d[2] += g4.z, d[3] += g4.w;
        }
        store4<float>(dx + at, d[0], d[1], d[2], d[3]);
      }
    }
    __syncthreads();
  }
  part[Grad::dbv + threadIdx.x] = rdbv;
}

// ---------------------------------- launch ----------------------------------

int project_and_lse(const void* x, const void* wqk, const void* wv, const void* bv, void* q,
                    void* v, float* lse, int o, int p, cudaStream_t st) {
  const long long tiles = (long long)o * ((p + kRows - 1) / kRows);
  const size_t s1 = ProjSmem::bytes;
  if (int rc = allow_smem(project_kernel, s1)) return rc;
  const int g1 = resident_grid(project_kernel, kThreads, s1, tiles);
  project_kernel<<<g1, kThreads, s1, st>>>((const float*)x, (const float*)wqk, (const float*)wv,
                                           (const float*)bv, (float*)q, (float*)v, o, p);
  if (int rc = (int)cudaGetLastError()) return rc;

  const size_t s2 = LseSmem<kDa>::bytes;
  if (int rc = allow_smem(lse_kernel<kDa>, s2)) return rc;
  const int g2 = resident_grid(lse_kernel<kDa>, kThreads, s2, tiles);
  lse_kernel<kDa><<<g2, kThreads, s2, st>>>((const float*)q, lse, o, p);
  return (int)cudaGetLastError();
}

int launch_block(const void* x, const void* wqk, const void* wv, const void* bv, const void* wt,
                 const void* bt, const float* wbn, const float* bbn, void* q, void* v, float* lse,
                 void* out, int o, int p, int oa, cudaStream_t st) {
  if (int rc = project_and_lse(x, wqk, wv, bv, q, v, lse, o, p, st)) return rc;
  const long long tiles = (long long)o * ((p + kRows - 1) / kRows);
  const size_t s3 = ApplySmem<false>::bytes;
  if (int rc = allow_smem(apply_kernel<false>, s3)) return rc;
  const int g3 = resident_grid(apply_kernel<false>, kThreads, s3, tiles);
  apply_kernel<false><<<g3, kThreads, s3, st>>>(
      (const float*)x, (const float*)q, (const float*)v, lse, (const float*)wt, (const float*)bt,
      wbn, bbn, nullptr, (float*)out, nullptr, o, p, oa);
  return (int)cudaGetLastError();
}

int launch_block_fwd(const void* x, const void* wqk, const void* wv, const void* bv,
                     const void* wt, const void* bt, const void* mask, void* q, void* v,
                     float* lse, void* tout, float* scratch, int blocks, float* sums, int o,
                     int p, int oa, cudaStream_t st) {
  if (int rc = project_and_lse(x, wqk, wv, bv, q, v, lse, o, p, st)) return rc;
  const size_t s3 = ApplySmem<false>::bytes;
  if (int rc = allow_smem(apply_kernel<true>, s3)) return rc;
  apply_kernel<true><<<blocks, kThreads, s3, st>>>(
      (const float*)x, (const float*)q, (const float*)v, lse, (const float*)wt, (const float*)bt,
      nullptr, nullptr, (const float*)mask, (float*)tout, scratch, o, p, oa);
  if (int rc = (int)cudaGetLastError()) return rc;
  return reduce_slices(scratch, slice_stride(2 * kC), blocks, sums, 2 * kC, st);
}

// The backwards' buffers, carved from one work buffer: q, v, lse, dY, dv, D,
// dq, OA's [2, O·P] row vectors (1/s, c) and y/s [O·P, 256] (f32);
// pct_attn_bwd leaves dY (the caller's) and y/s unused
struct Work {
  float *q, *v, *dy, *dv, *dq;
  float *lse, *dd, *sc, *ys;
};

size_t carve(void* base, int o, int p, Work* w) {
  const size_t rows = (size_t)o * p;
  size_t off = 0;
  auto take = [&](size_t bytes) {
    char* at = static_cast<char*>(base) + off;
    off += (bytes + 255) & ~size_t(255);
    return at;
  };
  Work tmp;
  Work& r = w ? *w : tmp;
  r.q = reinterpret_cast<float*>(take(sizeof(float) * rows * kDa));
  r.v = reinterpret_cast<float*>(take(sizeof(float) * rows * kC));
  r.dy = reinterpret_cast<float*>(take(sizeof(float) * rows * kC));
  r.dv = reinterpret_cast<float*>(take(sizeof(float) * rows * kC));
  r.dq = reinterpret_cast<float*>(take(sizeof(float) * rows * kDa));
  r.lse = reinterpret_cast<float*>(take(sizeof(float) * rows));
  r.dd = reinterpret_cast<float*>(take(sizeof(float) * rows));
  r.sc = reinterpret_cast<float*>(take(sizeof(float) * 2 * rows));
  r.ys = reinterpret_cast<float*>(take(sizeof(float) * rows * kC));
  return off;
}

int launch_attn_fwd(const void* x, const void* wqk, const void* wv, const void* bv, void* q,
                    void* v, float* lse, void* y, int o, int p, int oa, cudaStream_t st) {
  if (int rc = project_and_lse(x, wqk, wv, bv, q, v, lse, o, p, st)) return rc;
  const long long tiles = (long long)o * ((p + kRows - 1) / kRows);
  using L = ApplySmem<false>;
  auto kernel =
      oa ? attn_out_kernel<L, kC, kDa, true> : attn_out_kernel<L, kC, kDa, false>;
  if (int rc = allow_smem(kernel, kAttnSmem)) return rc;
  const int g = resident_grid(kernel, kThreads, kAttnSmem, tiles);
  kernel<<<g, kThreads, kAttnSmem, st>>>((const float*)q, (const float*)v, lse, (float*)y, o, p);
  return (int)cudaGetLastError();
}

// The dv, dq and dx passes of the three backwards (dY, and for OA 1/s and
// c, already in device memory). RESID / DU: the dx pass's residual and du
// terms.
template <bool OA, bool RESID, bool DU>
int launch_core_bwd(const void* x, const void* wqk, const void* wv, const void* dxn,
                    const Work& w, const float* dy, void* dx, float* scratch, int blocks, int o,
                    int p, cudaStream_t st) {
  const long long tiles = (long long)o * ((p + kRows - 1) / kRows);
  const size_t s2 = DvSmem<OA, kC, kDa>::bytes;
  if (int rc = allow_smem(bwd_dv_kernel<OA, kC, kDa>, s2)) return rc;
  const int g2 = resident_grid(bwd_dv_kernel<OA, kC, kDa>, kThreads, s2, tiles);
  bwd_dv_kernel<OA, kC, kDa><<<g2, kThreads, s2, st>>>(w.q, w.v, w.lse, dy, w.sc, w.dv,
                                                       w.dd, o, p);
  if (int rc = (int)cudaGetLastError()) return rc;

  const size_t s3 = DqSmem<OA>::bytes;
  if (int rc = allow_smem(bwd_dq_kernel<OA>, s3)) return rc;
  const int g3 = resident_grid(bwd_dq_kernel<OA>, kThreads, s3, tiles);
  bwd_dq_kernel<OA><<<g3, kThreads, s3, st>>>(w.q, w.v, w.lse, dy, w.dd, w.sc, w.dq, o, p);
  if (int rc = (int)cudaGetLastError()) return rc;

  const size_t s4 = DxSmem::bytes;
  if (int rc = allow_smem(bwd_dx_kernel<RESID, DU>, s4)) return rc;
  bwd_dx_kernel<RESID, DU><<<blocks, kThreads, s4, st>>>(
      (const float*)x, (const float*)wqk, (const float*)wv, w.dq, w.dv, (const float*)dxn, dy,
      (float*)dx, scratch, (long long)o * p);
  return (int)cudaGetLastError();
}

// pct_block_res_bwd (EPI) and pct_block_bwd: dxn is the next layer's
// cotangent (EPI) or t_out's (not EPI)
template <bool EPI, bool OA>
int launch_block_bwd(const void* x, const void* wqk, const void* wv, const void* bv,
                     const void* wt, const void* bt, const void* mask, const void* dxn,
                     const float* wbn, const float* bbn, const float* dsum, const float* dsumsq,
                     void* work, void* dx, float* scratch, int blocks, float* grads, int o, int p,
                     cudaStream_t st) {
  Work w;
  carve(work, o, p, &w);
  if (int rc = project_and_lse(x, wqk, wv, bv, w.q, w.v, w.lse, o, p, st)) return rc;

  const size_t s1 = ApplySmem<true>::bytes;
  if (int rc = allow_smem(bwd_dz_kernel<EPI, OA>, s1)) return rc;
  bwd_dz_kernel<EPI, OA><<<blocks, kThreads, s1, st>>>(
      (const float*)x, w.q, w.v, w.lse, (const float*)wt, (const float*)bt, (const float*)mask,
      (const float*)dxn, wbn, bbn, dsum, dsumsq, w.dy, w.sc, w.ys, scratch, o, p);
  if (int rc = (int)cudaGetLastError()) return rc;

  if (int rc = launch_core_bwd<OA, EPI, OA>(x, wqk, wv, dxn, w, w.dy, dx, scratch, blocks, o,
                                            p, st))
    return rc;
  return reduce_slices(scratch, slice_stride(Grad::total), blocks, grads, Grad::total, st);
}

template <bool EPI>
int block_bwd(const void* x, const void* wqk, const void* wv, const void* bv, const void* wt,
              const void* bt, const void* mask, const void* dxn, const float* wbn,
              const float* bbn, const float* dsum, const float* dsumsq, void* work, void* dx,
              float* scratch, int blocks, float* grads, int o, int p, int oa, cudaStream_t st) {
  if (oa)
    return launch_block_bwd<EPI, true>(x, wqk, wv, bv, wt, bt, mask, dxn, wbn, bbn, dsum,
                                       dsumsq, work, dx, scratch, blocks, grads, o, p, st);
  return launch_block_bwd<EPI, false>(x, wqk, wv, bv, wt, bt, mask, dxn, wbn, bbn, dsum,
                                      dsumsq, work, dx, scratch, blocks, grads, o, p, st);
}

// pct_attn_bwd: only the first Grad::dwt floats of the slices (dWqk, dWv,
// dbv) are reduced
template <bool OA>
int launch_attn_bwd(const void* x, const void* wqk, const void* wv, const void* bv,
                    const void* dy, void* work, void* dx, float* scratch, int blocks,
                    float* grads, int o, int p, cudaStream_t st) {
  Work w;
  carve(work, o, p, &w);
  if (int rc = project_and_lse(x, wqk, wv, bv, w.q, w.v, w.lse, o, p, st)) return rc;
  if constexpr (OA) {
    const long long tiles = (long long)o * ((p + kRows - 1) / kRows);
    auto kernel = attn_sc_kernel<ApplySmem<false>, kC, kDa>;
    if (int rc = allow_smem(kernel, kAttnSmem)) return rc;
    const int g = resident_grid(kernel, kThreads, kAttnSmem, tiles);
    kernel<<<g, kThreads, kAttnSmem, st>>>(w.q, w.v, w.lse, (const float*)dy, w.sc, o, p);
    if (int rc = (int)cudaGetLastError()) return rc;
  }
  if (int rc = launch_core_bwd<OA, false, false>(x, wqk, wv, nullptr, w, (const float*)dy, dx,
                                                 scratch, blocks, o, p, st))
    return rc;
  return reduce_slices(scratch, slice_stride(Grad::total), blocks, grads, Grad::dwt, st);
}

int attn_bwd(const void* x, const void* wqk, const void* wv, const void* bv, const void* dy,
             void* work, void* dx, float* scratch, int blocks, float* grads, int o, int p, int oa,
             cudaStream_t st) {
  if (oa)
    return launch_attn_bwd<true>(x, wqk, wv, bv, dy, work, dx, scratch, blocks, grads, o, p, st);
  return launch_attn_bwd<false>(x, wqk, wv, bv, dy, work, dx, scratch, blocks, grads, o, p, st);
}

}  // namespace

int launch_block_eval_c256_sm90(const void* x, const void* wqk, const void* wv, const void* bv,
                                const void* wt, const void* bt, const float* wbn,
                                const float* bbn, void* q, void* vt, float* lse2, void* out,
                                int o, int p, int oa, cudaStream_t st);
int launch_block_fwd_c256_sm90(const void* x, const void* wqk, const void* wv, const void* bv,
                               const void* wt, const void* bt, const void* mask, void* q,
                               void* vt, float* lse2, void* tout, float* scratch, int blocks,
                               float* sums, int o, int p, int oa, cudaStream_t st);
int launch_attn_fwd_c256_sm90(const void* x, const void* wqk, const void* wv, const void* bv,
                              void* q, void* vt, float* lse2, void* y, int o, int p, int oa,
                              cudaStream_t st);
size_t block_bwd_work_bytes_c256_sm90(int o, int p);
int launch_block_bwd_c256_sm90(int kind, const void* x, const void* wqk, const void* wv,
                               const void* bv, const void* wt, const void* bt, const void* mask,
                               const void* cot, const float* wbn, const float* bbn,
                               const float* dsum, const float* dsumsq, void* work, void* dx,
                               float* scratch, int blocks, float* grads, int o, int p, int oa,
                               cudaStream_t st);

}  // namespace sga

extern "C" {

// The C = 256 forms of pct_attention.cu's entry points, with the same
// arguments, for both dtypes: q [O, P, 64] and, at f32, v [O, P, 256] and
// lse [O, P] work buffers (bf16: vᵀ [O, 256, pp] and lse [O, pp], pp = P
// rounded up to 8); grads f32 dWqk_s [256, 64], dWv [256, 256], dbv [256],
// dWt [256, 256], dbt [256]; scratch: `blocks` slices of slice_stride(512)
// floats (the forward's sums) or slice_stride(147968) (the backwards'
// gradients)
int sga_pct_block_eval_c256(const void* x, const void* wqk, const void* wv, const void* bv,
                            const void* wt, const void* bt, const float* wbn, const float* bbn,
                            void* q, void* v, float* lse, void* out, int o, int p, int oa,
                            int dtype, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == sga::kBF16)
    return sga::launch_block_eval_c256_sm90(x, wqk, wv, bv, wt, bt, wbn, bbn, q, v, lse, out, o,
                                            p, oa, st);
  return sga::launch_block(x, wqk, wv, bv, wt, bt, wbn, bbn, q, v, lse, out, o, p, oa, st);
}

int sga_pct_block_fwd_c256(const void* x, const void* wqk, const void* wv, const void* bv,
                           const void* wt, const void* bt, const void* mask, void* q, void* v,
                           float* lse, void* tout, float* scratch, int blocks, float* sums,
                           int o, int p, int oa, int dtype, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == sga::kBF16)
    return sga::launch_block_fwd_c256_sm90(x, wqk, wv, bv, wt, bt, mask, q, v, lse, tout,
                                           scratch, blocks, sums, o, p, oa, st);
  return sga::launch_block_fwd(x, wqk, wv, bv, wt, bt, mask, q, v, lse, tout, scratch,
                               blocks, sums, o, p, oa, st);
}

// Bytes of sga_pct_block_res_bwd_c256's work buffer (the same for SA and
// OA: oa is the C = 128 query's argument)
long long sga_pct_bwd_work_bytes_c256(int o, int p, int /*oa*/, int dtype) {
  if (dtype == sga::kBF16) return (long long)sga::block_bwd_work_bytes_c256_sm90(o, p);
  return (long long)sga::carve(nullptr, o, p, nullptr);
}

int sga_pct_block_res_bwd_c256(const void* x, const void* wqk, const void* wv, const void* bv,
                               const void* wt, const void* bt, const void* mask, const void* dxn,
                               const float* wbn, const float* bbn, const float* dsum,
                               const float* dsumsq, void* work, void* dx, float* scratch,
                               int blocks, float* grads, int o, int p, int oa, int dtype,
                               void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == sga::kBF16)
    return sga::launch_block_bwd_c256_sm90(0, x, wqk, wv, bv, wt, bt, mask, dxn, wbn, bbn, dsum,
                                           dsumsq, work, dx, scratch, blocks, grads, o, p, oa,
                                           st);
  return sga::block_bwd<true>(x, wqk, wv, bv, wt, bt, mask, dxn, wbn, bbn, dsum, dsumsq,
                              work, dx, scratch, blocks, grads, o, p, oa, st);
}

// pct_block_fused's backward at C = 256 for the cotangents dt [O, P, 256]
// (compute dtype) and dsum, dsumsq [256] (f32): dx without a residual,
// grads, work and scratch as sga_pct_block_res_bwd_c256's
int sga_pct_block_bwd_c256(const void* x, const void* wqk, const void* wv, const void* bv,
                           const void* wt, const void* bt, const void* mask, const void* dt,
                           const float* dsum, const float* dsumsq, void* work, void* dx,
                           float* scratch, int blocks, float* grads, int o, int p, int oa,
                           int dtype, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == sga::kBF16)
    return sga::launch_block_bwd_c256_sm90(1, x, wqk, wv, bv, wt, bt, mask, dt, nullptr, nullptr,
                                           dsum, dsumsq, work, dx, scratch, blocks, grads, o, p,
                                           oa, st);
  return sga::block_bwd<false>(x, wqk, wv, bv, wt, bt, mask, dt, nullptr, nullptr, dsum,
                               dsumsq, work, dx, scratch, blocks, grads, o, p, oa, st);
}

// pct_attention_fused's forward at C = 256: y [O, P, 256] in the compute
// dtype (OA row normalisation with oa = 1); q, v, lse work buffers as
// sga_pct_block_eval_c256's
int sga_pct_attn_fwd_c256(const void* x, const void* wqk, const void* wv, const void* bv,
                          void* q, void* v, float* lse, void* y, int o, int p, int oa, int dtype,
                          void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == sga::kBF16)
    return sga::launch_attn_fwd_c256_sm90(x, wqk, wv, bv, q, v, lse, y, o, p, oa, st);
  return sga::launch_attn_fwd(x, wqk, wv, bv, q, v, lse, y, o, p, oa, st);
}

// pct_attention_fused's backward at C = 256 for dY [O, P, 256]: dx, and
// grads f32 dWqk_s [256, 64], dWv [256, 256], dbv [256]; work and scratch
// as sga_pct_block_res_bwd_c256's
int sga_pct_attn_bwd_c256(const void* x, const void* wqk, const void* wv, const void* bv,
                          const void* dy, void* work, void* dx, float* scratch, int blocks,
                          float* grads, int o, int p, int oa, int dtype, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == sga::kBF16)
    return sga::launch_block_bwd_c256_sm90(2, x, wqk, wv, bv, nullptr, nullptr, nullptr, dy,
                                           nullptr, nullptr, nullptr, nullptr, work, dx, scratch,
                                           blocks, grads, o, p, oa, st);
  return sga::attn_bwd(x, wqk, wv, bv, dy, work, dx, scratch, blocks, grads, o, p, oa, st);
}

}  // extern "C"
