// PCT SA / OA block backward at C = 256, da = 64, bf16: the wgmma design of
// pct_block_res_bwd, pct_block_bwd and pct_attn_bwd at FullPCT's width
// (pct_attention_c256.cu holds their C entry points and f32 forms; the
// notation is pct_attention.cu's).
//
// Replaces sgaligner_tpu/ops/pct_attention.py::_block_res_bwd_rule (Pallas
// kernel _block_res_bwd_kernel), _block_bwd_rule (_block_bwd_kernel) and
// _bwd_rule (_bwd_kernel) for bf16 inputs of 256 channels.
//   Bound on the H100: operations on the tensor cores, about three times
//   the forward's (91 µs for pct_block_res_bwd at O = 256, P = 256).
//   Design: pct_block_bwd_sm90.cu's passes, widened, after the forward's
//   projection (also writing v row-major) and lse passes
//   (pct_block_c256_sm90.cu). The key passes are persistent, one block an
//   SM, a producer and two consumer warpgroups on one 64-row tile (dz and dq
//   at 384 threads: the producer warpgroup gives its registers to the
//   consumers by setmaxnreg; dv at 288, a producer warp):
//     dz (pct_block_dz_c256_sm90.cu, a translation unit of its own so that
//       nvcc builds it beside this one): as the forward's apply, each
//       warpgroup its 128 channels of y; u (both halves) in one shared row
//       tile; t = u·Wt and then dY = dz·Wtᵀ
//       one 32-column slice at a time against Wt streamed by a second
//       producer thread (16 KB slices: [256 k, 32 n] MN-major for t, Wt's
//       rows [32 n, 256 k] K-major for dY), dz in the same tile once both
//       t products have read u; the cotangent tile then stages dŶ (and for
//       the OA block round(dY), the dx pass's du term); OA's c_j from the
//       two halves' partial sums, exchanged through shared memory;
//     dv: per key tile I, S and Gᵀ = exp(S − lse_I) in registers (both
//       warpgroups) as the A operand of dv_I[:, 128c..] += Gᵀ·dŶ_J, dŶ_J an
//       MN-major operand straight from its TMA boxes; D_i = v_i·dv_i from
//       the two halves (less Σ_j G[j,i]·c_j for OA);
//     dq: per row tile I (q_I, v_I, dŶ_I: 72 KB, shared), key chunk ch
//       goes to warpgroup ch % 2 through its own stage of a two-stage ring
//       of 73 KB stages (q_J, v_J, dŶ_J, lse_J, D_J, c_J): each forms the
//       two dP products over 256 channels, F and dq_I += F·q_J in registers
//       for its chunks; the two partial dq are added at the item's end
//       through the I tile's room (so each row's sums keep one order,
//       whatever the launch);
//     dx: each block one half of the output channels with that half of Wqk
//       and Wv resident (80 KB), flat 64-row tiles of dq and dv through a
//       three-stage TMA ring, each warpgroup 64 of the block's 128 columns;
//       + round(dY) for the OA block (du), + the cotangent (the residual);
//     the weight gradients: pct_block_bwd_sm90.cu's wgrad_wgmma_kernel on
//       each 128-column half of x or u, per-block slices that
//       reduce_slices adds in order: no atomics, the same bits twice.
//   Every layout is checked against the 232,448 bytes a block may have.
#include "pct_c256_sm90.cuh"

namespace sga {

int launch_wgrad_sm90(const void* a, int lda, const void* bmat, int ldb, int nb, int bias,
                      long long rows, float* scratch, long long slice, int ld, int m_off,
                      int bias_off, int splits, cudaStream_t st);
int launch_dz_c256_sm90(int epi, int oa, int attn, const CUtensorMap& qm, const CUtensorMap& vm,
                        const CUtensorMap& lm, const CUtensorMap& xm, const CUtensorMap& gm,
                        const CUtensorMap& wtcm, const CUtensorMap& wtrm, const void* bt,
                        const void* mask, const float* wbn, const float* bbn, const float* dsum,
                        const float* dsumsq, void* u, void* dz, void* dyh, void* dyr, float* cvec,
                        int grid, int o, int p, cudaStream_t st);

namespace {

using namespace c256;

constexpr int kKeyStages = 2;  // the dq pass's ring

// One block slice of the weight gradients (floats): dWqk [256, 64], dWv
// [256, 256], dbv [256], dWt [256, 256], dbt [256]
constexpr int kOffDwqk256 = 0;
constexpr int kOffDwv256 = kOffDwqk256 + kC * kDa;
constexpr int kOffDbv256 = kOffDwv256 + kC * kC;
constexpr int kOffDwt256 = kOffDbv256 + kC;
constexpr int kOffDbt256 = kOffDwt256 + kC * kC;
constexpr int kGrad256 = kOffDbt256 + kC;

// ---------------------------------- pass dv ----------------------------------

constexpr int kDvStages = 4;
using DvRing = Ring<kDvStages>;

struct KeyBars {
  uint64_t full[kDvStages], empty[kDvStages], qfull[2], qempty[2];
  __device__ void init() {
    for (int i = 0; i < kDvStages; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, 8);
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(qfull + i, 1);
      mbar_init(qempty + i, 8);
    }
    mbar_fence_init();
  }
};

struct DvSmem {
  static constexpr size_t stage_bytes = round1k(kRowTile + kQTile + kVec);  // dŶ_J, q_J, c_J
  static constexpr size_t qi_off = 0;  // two slots
  static constexpr size_t ring_off = qi_off + 2 * kQTile;
  static constexpr size_t xch_off = ring_off + kDvStages * stage_bytes;  // [2][2][64] f32
  static constexpr size_t bar_off = xch_off + 2 * 2 * kTile * 4;
  static constexpr size_t bytes = bar_off + sizeof(KeyBars) + 1024;
};
static_assert(DvSmem::bytes <= kSmemMax, "dv: shared memory");

// dv_I = Σ_J G_JIᵀ·dŶ_J (rows I are keys i), warpgroup c its channels
// 128c.., written rounded; D_i = v_i·dv_i (f32) less Σ_j G[j, i]·c_j for OA
template <bool OA>
__global__ void __launch_bounds__(kThreads, 1)
dv256_wgmma_kernel(const __grid_constant__ CUtensorMap qm, const __grid_constant__ CUtensorMap dym,
                   const __grid_constant__ CUtensorMap cm, const float* __restrict__ lse2,
                   const bf16* __restrict__ vrow, bf16* __restrict__ dv, float* __restrict__ dd,
                   int o, int p, int pp) {
  using L = DvSmem;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  KeyBars& b = *reinterpret_cast<KeyBars*>(smem + L::bar_off);
  if (threadIdx.x == 0) b.init();
  __syncthreads();
  const int per_obj = (p + kTile - 1) / kTile;
  const int items = o * per_obj;
  const int c = threadIdx.x / 128, t = threadIdx.x % 128;

  if (c == 2) {
    if (t != 0) return;
    uint32_t n = 0, qn = 0;
    for (int it = blockIdx.x; it < items; it += gridDim.x, ++qn) {
      const int obj = it / per_obj, i0 = (it % per_obj) * kTile;
      const int qs = qn % 2;
      mbar_wait(b.qempty + qs, ((qn / 2) & 1u) ^ 1u);
      mbar_expect_tx(b.qfull + qs, kQTile);
      tma_load_3d(smem + L::qi_off + qs * kQTile, &qm, b.qfull + qs, 0, i0, obj);
      for (int c0 = 0; c0 < p; c0 += kTile, ++n) {
        const int st = DvRing::stage(n);
        unsigned char* sp = smem + L::ring_off + st * L::stage_bytes;
        mbar_wait(b.empty + st, DvRing::empty_parity(n));
        mbar_expect_tx(b.full + st, kRowTile + kQTile + (OA ? kVec : 0));
        load_rows3(sp, &dym, b.full + st, obj, c0);
        tma_load_3d(sp + kRowTile, &qm, b.full + st, 0, c0, obj);
        if constexpr (OA) tma_load_2d(sp + kRowTile + kQTile, &cm, b.full + st, c0, obj);
      }
    }
    return;
  }

  const int warp = t / 32, lane = t % 32;
  const int rl = 16 * warp + lane / 4;
  uint32_t n = 0, qn = 0;
  for (int it = blockIdx.x; it < items; it += gridDim.x, ++qn) {
    const int obj = it / per_obj, i0 = (it % per_obj) * kTile;
    const int qs = qn % 2;
    const int valid = min(kTile, p - i0);
    float li[2];  // lse2 of this thread's two keys
#pragma unroll
    for (int h = 0; h < 2; ++h)
      li[h] = rl + 8 * h < valid ? lse2[(size_t)obj * pp + i0 + rl + 8 * h] : 0.f;
    mbar_wait(b.qfull + qs, (qn / 2) & 1u);
    const unsigned char* qi = smem + L::qi_off + qs * kQTile;
    float dv0[32], dv1[32];
    float gc[2] = {0.f, 0.f};
    for (int c0 = 0; c0 < p; c0 += kTile, ++n) {
      const int st = DvRing::stage(n);
      const unsigned char* sp = smem + L::ring_off + st * L::stage_bytes;
      const float* cj = reinterpret_cast<const float*>(sp + kRowTile + kQTile);
      mbar_wait(b.full + st, DvRing::full_parity(n));
      float s[32];
      start_energies(s, qi, sp + kRowTile);
      wgmma_wait<0>();
      fence_regs(s);
      if (lane == 0 && c0 + kTile >= p) mbar_arrive(b.qempty + qs);
      // Gᵀ[i, j] = exp(S[i, j] − lse_i), rounded: the A fragments over j
      const int kv = p - c0;
      uint32_t a[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int hj = 0; hj < 2; ++hj) {
          const int j = 2 * kk + hj, col = 8 * j + 2 * (lane % 4);
          float g[2][2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const bool live = col + e < kv;
            g[0][e] = live ? ex2(fmaf(s[4 * j + e], kLog2e, -li[0])) : 0.f;
            g[1][e] = live ? ex2(fmaf(s[4 * j + 2 + e], kLog2e, -li[1])) : 0.f;
          }
          a[kk][2 * hj] = pack_bf16(g[0][0], g[0][1]);
          a[kk][2 * hj + 1] = pack_bf16(g[1][0], g[1][1]);
          if constexpr (OA) {
            const float c0v = col < kv ? cj[col] : 0.f, c1v = col + 1 < kv ? cj[col + 1] : 0.f;
            gc[0] += lo_bf16(a[kk][2 * hj]) * c0v + hi_bf16(a[kk][2 * hj]) * c1v;
            gc[1] += lo_bf16(a[kk][2 * hj + 1]) * c0v + hi_bf16(a[kk][2 * hj + 1]) * c1v;
          }
        }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_m64n64k16_rs_t<1>(dv0, a[kk], desc_mn(sp + 2 * c * kBox, kSw128, 16 * kk, 0),
                                (c0 | kk) != 0);
        wgmma_m64n64k16_rs_t<1>(dv1, a[kk], desc_mn(sp + (2 * c + 1) * kBox, kSw128, 16 * kk, 0),
                                (c0 | kk) != 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv0);
      fence_regs(dv1);
      if (lane == 0) mbar_arrive(b.empty + st);
    }
    // write dv rounded; this half's Σ_c dv[i, c]·v[i, c] (f32)
    float d[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 64; i += 2) {
      const float* part = i < 32 ? dv0 : dv1;
      const int ii = i % 32, h = (ii / 2) % 2;
      const int row = rl + 8 * h, col = 128 * c + 64 * (i / 32) + acc_col(lane, ii);
      if (row < valid) {
        const size_t at = ((size_t)obj * p + i0 + row) * kC + col;
        const __nv_bfloat162 v2 = *reinterpret_cast<const __nv_bfloat162*>(vrow + at);
        d[h] = fmaf(part[ii], __bfloat162float(v2.x), d[h]);
        d[h] = fmaf(part[ii + 1], __bfloat162float(v2.y), d[h]);
        *reinterpret_cast<uint32_t*>(dv + at) = pack_bf16(part[ii], part[ii + 1]);
      }
    }
    // D_i = both halves' sums − Σ_j G[j, i]·c_j
    float* xch = reinterpret_cast<float*>(smem + L::xch_off) + (qn % 2) * 2 * kTile;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float dh = quad_sum(d[h]);
      if (lane % 4 == 0) xch[c * kTile + rl + 8 * h] = dh;
    }
    bar_sync(1, 256);
    if (c == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float g = OA ? quad_sum(gc[h]) : 0.f;
        const int row = rl + 8 * h;
        if (lane % 4 == 0 && row < valid)
          dd[(size_t)obj * pp + i0 + row] = (xch[row] + xch[kTile + row]) - g;
      }
    }
  }
}

// ---------------------------------- pass dq ----------------------------------

struct DqBars {
  uint64_t full[kKeyStages], empty[kKeyStages], ifull, iempty;
  __device__ void init() {
    for (int i = 0; i < kKeyStages; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, 4);  // stage i serves warpgroup i
    }
    mbar_init(&ifull, 1);
    mbar_init(&iempty, 8);
    mbar_fence_init();
  }
};

struct DqSmem {
  // a tile's q, v, dŶ: 8 + 32 + 32 KB; a ring stage adds lse2, D, c
  static constexpr size_t tile_bytes = kQTile + 2 * kRowTile;
  static constexpr size_t stage_bytes = round1k(tile_bytes + 3 * kVec);
  static constexpr size_t it_off = 0;  // the row tile I
  static constexpr size_t ring_off = it_off + tile_bytes;
  static constexpr size_t bar_off = ring_off + kKeyStages * stage_bytes;
  static constexpr size_t bytes = bar_off + sizeof(DqBars) + 1024;
};
static_assert(DqSmem::bytes <= kSmemMax, "dq: shared memory");
static_assert(kKeyStages == 2, "dq: key chunk ch goes to stage and warpgroup ch % 2");

// q, v, dŶ of rows r0.. of object obj
__device__ __forceinline__ void load_qvd(unsigned char* dst, const CUtensorMap* qm,
                                         const CUtensorMap* vrm, const CUtensorMap* dym,
                                         uint64_t* bar, int r0, int obj) {
  tma_load_3d(dst, qm, bar, 0, r0, obj);
  load_rows3(dst + kQTile, vrm, bar, obj, r0);
  load_rows3(dst + kQTile + kRowTile, dym, bar, obj, r0);
}

// dq_I = Σ_J F_IJ·q_J, F the (I, J) tile of dE + dEᵀ; key chunk ch of an
// item to ring stage and warpgroup ch % 2 (u[s]: uses of stage s over the
// block's life), the two partial sums added at the item's end: each row's
// sums in an order that no other item changes
template <bool OA>
__global__ void __launch_bounds__(kThreadsWide, 1)
dq256_wgmma_kernel(const __grid_constant__ CUtensorMap qm, const __grid_constant__ CUtensorMap vrm,
                   const __grid_constant__ CUtensorMap dym, const __grid_constant__ CUtensorMap lm,
                   const __grid_constant__ CUtensorMap dm, const __grid_constant__ CUtensorMap cm,
                   const float* __restrict__ lse2, const float* __restrict__ dd,
                   const float* __restrict__ cvec, bf16* __restrict__ dq, int o, int p, int pp) {
  using L = DqSmem;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  DqBars& b = *reinterpret_cast<DqBars*>(smem + L::bar_off);
  if (threadIdx.x == 0) b.init();
  __syncthreads();
  const int per_obj = (p + kTile - 1) / kTile;
  const int items = o * per_obj;
  const int c = threadIdx.x / 128, t = threadIdx.x % 128;

  if (c == 2) {
    reg_dealloc<kProducerRegs>();
    if (t != 0) return;
    uint32_t u[2] = {0, 0}, qn = 0;
    for (int it = blockIdx.x; it < items; it += gridDim.x, ++qn) {
      const int obj = it / per_obj, i0 = (it % per_obj) * kTile;
      mbar_wait(&b.iempty, (qn & 1u) ^ 1u);
      mbar_expect_tx(&b.ifull, (uint32_t)L::tile_bytes);
      load_qvd(smem + L::it_off, &qm, &vrm, &dym, &b.ifull, i0, obj);
      for (int c0 = 0; c0 < p; c0 += kTile) {
        const int st = (c0 / kTile) % 2;
        unsigned char* sp = smem + L::ring_off + st * L::stage_bytes;
        mbar_wait(b.empty + st, (u[st]++ & 1u) ^ 1u);
        mbar_expect_tx(b.full + st, (uint32_t)L::tile_bytes + (OA ? 3 : 2) * kVec);
        load_qvd(sp, &qm, &vrm, &dym, b.full + st, c0, obj);
        tma_load_2d(sp + L::tile_bytes, &lm, b.full + st, c0, obj);
        tma_load_2d(sp + L::tile_bytes + kVec, &dm, b.full + st, c0, obj);
        if constexpr (OA) tma_load_2d(sp + L::tile_bytes + 2 * kVec, &cm, b.full + st, c0, obj);
      }
    }
    return;
  }
  reg_alloc<kConsumerRegs>();

  const int warp = t / 32, lane = t % 32;
  const int rl = 16 * warp + lane / 4;
  const unsigned char* ti = smem + L::it_off;
  const int nch = (p + kTile - 1) / kTile;
  uint32_t u = 0, qn = 0;  // u: this warpgroup's uses of its stage c
  for (int it = blockIdx.x; it < items; it += gridDim.x, ++qn) {
    const int obj = it / per_obj, i0 = (it % per_obj) * kTile;
    const int valid = min(kTile, p - i0);
    float li[2], di[2], ci[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const bool in = rl + 8 * h < valid;
      const size_t at = (size_t)obj * pp + i0 + rl + 8 * h;
      li[h] = in ? lse2[at] : 0.f;
      di[h] = in ? dd[at] : 0.f;
      ci[h] = OA && in ? cvec[at] : 0.f;
    }
    mbar_wait(&b.ifull, qn & 1u);
    float dqa[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) dqa[i] = 0.f;
    for (int ch = c; ch < nch; ch += 2, ++u) {
      const int c0 = ch * kTile;
      const unsigned char* sp = smem + L::ring_off + c * L::stage_bytes;
      const float* lj = reinterpret_cast<const float*>(sp + L::tile_bytes);
      const float* dj = lj + kTile;
      const float* cj = lj + 2 * kTile;
      mbar_wait(b.full + c, u & 1u);
      float s[32], pp1[32], f[32];
      start_energies(s, ti, sp);
      start_dp(pp1, ti + kQTile, sp + kQTile + kRowTile);  // v_I·dŶ_Jᵀ
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(pp1);
      const int kv = p - c0;
      // dE[j, i] term: G[j, i] = exp(E[i, j] − lse_i) times (dŶ_j·v_i − c_j − D_i)
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int h = (i / 2) % 2, col = acc_col(lane, i);
        float a = pp1[i] - di[h];
        if constexpr (OA) a -= cj[col];
        f[i] = col < kv ? ex2(fmaf(s[i], kLog2e, -li[h])) * a : 0.f;
      }
      start_dp(pp1, ti + kQTile + kRowTile, sp + kQTile);  // dŶ_I·v_Jᵀ
      wgmma_wait<0>();
      fence_regs(pp1);
      // dE[i, j] term: G[i, j] = exp(E[i, j] − lse_j) times (dŶ_i·v_j − c_i − D_j)
      uint32_t fa[4][4];
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        float v2[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int h = (i / 2) % 2, col = acc_col(lane, i + e);
          const float a = pp1[i + e] - ci[h] - dj[col];
          v2[e] = col < kv ? f[i + e] + ex2(fmaf(s[i + e], kLog2e, -lj[col])) * a : 0.f;
        }
        fa[i / 8][(i % 8) / 2] = pack_bf16(v2[0], v2[1]);
      }
      // dq_I += F·q_J (q_J row-major: the MN-major B operand)
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_m64n64k16_rs_t<1>(dqa, fa[kk], desc_mn(sp, kSw128, 16 * kk, 0), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dqa);
      __syncwarp();
      if (lane == 0) mbar_arrive(b.empty + c);
    }
    // dq = warpgroup 0's partial sum + warpgroup 1's, through the room of
    // v_I (both warpgroups are done with the I tile)
    bar_sync(1, 256);
    float* xf = reinterpret_cast<float*>(smem + L::it_off + kQTile);
    if (c == 1) {
#pragma unroll
      for (int i = 0; i < 32; ++i) xf[i * 128 + t] = dqa[i];
    }
    bar_sync(1, 256);
    if (c == 0) {
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int row = acc_row(warp, lane, i), col = acc_col(lane, i);
        if (row < valid)
          *reinterpret_cast<uint32_t*>(dq + ((size_t)obj * p + i0 + row) * kDa + col) =
              pack_bf16(dqa[i] + xf[i * 128 + t], dqa[i + 1] + xf[(i + 1) * 128 + t]);
      }
    }
    fence_proxy_async();  // the plain accesses to the tile before the next TMA into it
    __syncwarp();
    if (lane == 0) mbar_arrive(&b.iempty);
  }
}

// ---------------------------------- pass dx ----------------------------------

constexpr int kDxStages = 3;
using DxRing = Ring<kDxStages>;

struct DxSmem {
  static constexpr size_t wq_off = 0;                      // Wqk_s rows of the half [128, 64]
  // Wv's rows of the half: four [128, 64] boxes
  static constexpr size_t wv_off = wq_off + 128 * 64 * 2;
  static constexpr size_t stage_bytes = kQTile + kRowTile;  // dq, dv tiles
  static constexpr size_t ring_off = wv_off + 4 * 128 * 64 * 2;
  static constexpr size_t bar_off = ring_off + kDxStages * stage_bytes;
  static constexpr size_t bytes = bar_off + (2 * kDxStages + 1) * 8 + 1024;
};
static_assert(DxSmem::bytes <= kSmemMax, "dx: shared memory");

// dx[:, 128h..] = dq·Wqk_sᵀ + dv·Wvᵀ (− round(dY) with DU: the OA block's
// du) (+ the cotangent with RESID), rounded, for the half h = blockIdx.x % 2
// of the output channels; flat 64-row tiles, warpgroup c the columns
// 128h + 64c..
template <bool RESID, bool DU>
__global__ void __launch_bounds__(kThreads, 1)
dx256_wgmma_kernel(const __grid_constant__ CUtensorMap dqm, const __grid_constant__ CUtensorMap dvm,
                   const __grid_constant__ CUtensorMap wqm, const __grid_constant__ CUtensorMap wvm,
                   const bf16* __restrict__ cot, const bf16* __restrict__ dyr,
                   bf16* __restrict__ dx, long long rows) {
  using L = DxSmem;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::bar_off);
  uint64_t* empty = full + kDxStages;
  uint64_t* wbar = empty + kDxStages;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kDxStages; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, 8);
    }
    mbar_init(wbar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  const long long tiles = (rows + kTile - 1) / kTile;
  const int half = blockIdx.x % 2, blocks = gridDim.x / 2;
  const int c = threadIdx.x / 128, t = threadIdx.x % 128;

  if (c == 2) {
    if (t != 0) return;
    mbar_expect_tx(wbar, 5 * 128 * 64 * 2);
    tma_load_2d(smem + L::wq_off, &wqm, wbar, 0, 128 * half);
    for (int kb = 0; kb < 4; ++kb)
      tma_load_2d(smem + L::wv_off + kb * 128 * 64 * 2, &wvm, wbar, 64 * kb, 128 * half);
    uint32_t k = 0;
    for (long long tile = blockIdx.x / 2; tile < tiles; tile += blocks, ++k) {
      const int st = DxRing::stage(k);
      unsigned char* sp = smem + L::ring_off + st * L::stage_bytes;
      const int r0 = (int)(tile * kTile);
      mbar_wait(empty + st, DxRing::empty_parity(k));
      mbar_expect_tx(full + st, (uint32_t)L::stage_bytes);
      tma_load_2d(sp, &dqm, full + st, 0, r0);
      for (int b4 = 0; b4 < 4; ++b4)
        tma_load_2d(sp + kQTile + b4 * kBox, &dvm, full + st, 64 * b4, r0);
    }
    return;
  }

  const int warp = t / 32, lane = t % 32;
  mbar_wait(wbar, 0);
  uint32_t k = 0;
  for (long long tile = blockIdx.x / 2; tile < tiles; tile += blocks, ++k) {
    const int st = DxRing::stage(k);
    const unsigned char* sp = smem + L::ring_off + st * L::stage_bytes;
    mbar_wait(full + st, DxRing::full_parity(k));
    float acc[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_m64n64k16_ss(acc, desc(sp, kSw128, kk * 32),
                         desc(smem + L::wq_off + c * 8192, kSw128, kk * 32), kk != 0);
#pragma unroll
    for (int kk = 0; kk < 16; ++kk)
      wgmma_m64n64k16_ss(acc, desc(sp + kQTile + (kk / 4) * kBox, kSw128, (kk % 4) * 32),
                         desc(smem + L::wv_off + (kk / 4) * 128 * 64 * 2 + c * 8192, kSw128,
                              (kk % 4) * 32),
                         1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + st);
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const long long row = tile * kTile + acc_row(warp, lane, i);
      const int col = 128 * half + 64 * c + acc_col(lane, i);
      if (row < rows) {
        float d0 = acc[i], d1 = acc[i + 1];
        if constexpr (DU) {
          const __nv_bfloat162 r = *reinterpret_cast<const __nv_bfloat162*>(dyr + row * kC + col);
          d0 -= __bfloat162float(r.x);
          d1 -= __bfloat162float(r.y);
        }
        if constexpr (RESID) {
          const __nv_bfloat162 r = *reinterpret_cast<const __nv_bfloat162*>(cot + row * kC + col);
          d0 += __bfloat162float(r.x);
          d1 += __bfloat162float(r.y);
        }
        *reinterpret_cast<uint32_t*>(dx + row * kC + col) = pack_bf16(d0, d1);
      }
    }
  }
}

// ---------------------------------- launch -----------------------------------

// the bf16 work buffer's pieces (256-byte aligned)
struct Work {
  bf16 *q, *vt, *v, *u, *dz, *dyh, *dyr, *dv, *dq;
  float *lse2, *dd, *cv;
};

inline size_t carve(void* base, int o, int p, Work* w) {
  const size_t pp = (size_t)(p + 7) / 8 * 8, rows = (size_t)o * p;
  size_t off = 0;
  auto take = [&](size_t bytes) {
    char* at = static_cast<char*>(base) + off;
    off += (bytes + 255) & ~size_t(255);
    return at;
  };
  Work tmp;
  Work& r = w ? *w : tmp;
  r.q = (bf16*)take(rows * kDa * 2);
  r.vt = (bf16*)take((size_t)o * kC * pp * 2);
  r.v = (bf16*)take(rows * kC * 2);
  r.u = (bf16*)take(rows * kC * 2);
  r.dz = (bf16*)take(rows * kC * 2);
  r.dyh = (bf16*)take(rows * kC * 2);
  r.dyr = (bf16*)take(rows * kC * 2);
  r.dv = (bf16*)take(rows * kC * 2);
  r.dq = (bf16*)take(rows * kDa * 2);
  r.lse2 = (float*)take((size_t)o * pp * 4);
  r.dd = (float*)take((size_t)o * pp * 4);
  r.cv = (float*)take((size_t)o * pp * 4);
  return off;
}

}  // namespace

size_t block_bwd_work_bytes_c256_sm90(int o, int p) { return carve(nullptr, o, p, nullptr); }

// The bf16 backwards at C = 256. kind 0: pct_block_res_bwd (cot = dxn, with
// wbn, bbn, dsum, dsumsq); 1: pct_block_bwd (cot = dt, with dsum, dsumsq);
// 2: pct_attn_bwd (cot = dY; wt, bt, mask unused). grads: the 147,968 floats
// of a slice (kind 2: dWqk, dWv, dbv); scratch: `blocks` slices of
// slice_stride(147,968) floats
int launch_block_bwd_c256_sm90(int kind, const void* x, const void* wqk, const void* wv,
                               const void* bv, const void* wt, const void* bt, const void* mask,
                               const void* cot, const float* wbn, const float* bbn,
                               const float* dsum, const float* dsumsq, void* work, void* dx,
                               float* scratch, int blocks, float* grads, int o, int p, int oa,
                               cudaStream_t st) {
  if (blocks < 1) return (int)cudaErrorInvalidValue;
  Work w;
  carve(work, o, p, &w);
  const int pp = (p + 7) / 8 * 8;
  const long long rows = (long long)o * p;
  CUtensorMap qm, vm, lm;
  if (int rc = launch_project_lse_c256_sm90(x, wqk, wv, bv, w.q, w.vt, w.v, w.lse2, o, p, &qm, &vm,
                                            &lm, st))
    return rc;
  CUtensorMap xm, gm, vrm, dm, cm, dym, wtcm{}, wtrm{};
  if (int rc = map_rows(&xm, x, o, p, kC)) return rc;
  if (int rc = map_rows(&gm, cot, o, p, kC)) return rc;
  if (int rc = map_rows(&vrm, w.v, o, p, kC)) return rc;
  if (int rc = map_vec(&dm, w.dd, o, p)) return rc;
  if (int rc = map_vec(&cm, w.cv, o, p)) return rc;
  if (kind != 2) {
    if (int rc = map_2d(&wtcm, wt, kC, kC, kC, kC, 32)) return rc;
    if (int rc = map_2d(&wtrm, wt, kC, kC, kC, 32, 64)) return rc;
  }
  const int grid = persistent_grid((long long)o * ((p + kTile - 1) / kTile));

  // dz: u, dz, dŶ (and OA's c and round(dY)); the attention op's SA
  // backward has dŶ = dY
  const bf16* dyh = w.dyh;
  int rc = 0;
  if (kind != 2 || oa)
    rc = launch_dz_c256_sm90(kind == 0, oa, kind == 2, qm, vm, lm, xm, gm, wtcm, wtrm, bt, mask,
                             wbn, bbn, dsum, dsumsq, w.u, w.dz, w.dyh, w.dyr, w.cv, grid, o, p,
                             st);
  else
    dyh = (const bf16*)cot;
  if (rc) return rc;
  if (int rc2 = map_rows(&dym, dyh, o, p, kC)) return rc2;

  auto dv_kernel = oa ? dv256_wgmma_kernel<true> : dv256_wgmma_kernel<false>;
  if (int rc2 = allow_smem(dv_kernel, DvSmem::bytes)) return rc2;
  dv_kernel<<<grid, kThreads, DvSmem::bytes, st>>>(qm, dym, cm, w.lse2, w.v, w.dv, w.dd, o, p, pp);
  if (int rc2 = (int)cudaGetLastError()) return rc2;

  auto dq_kernel = oa ? dq256_wgmma_kernel<true> : dq256_wgmma_kernel<false>;
  if (int rc2 = allow_smem(dq_kernel, DqSmem::bytes)) return rc2;
  dq_kernel<<<grid, kThreadsWide, DqSmem::bytes, st>>>(qm, vrm, dym, lm, dm, cm, w.lse2, w.dd, w.cv,
                                                   w.dq, o, p, pp);
  if (int rc2 = (int)cudaGetLastError()) return rc2;

  CUtensorMap dqm, dvm, wqm, wvm;
  if (int rc2 = map_2d(&dqm, w.dq, rows, kDa, kDa, kTile, 64)) return rc2;
  if (int rc2 = map_2d(&dvm, w.dv, rows, kC, kC, kTile, 64)) return rc2;
  if (int rc2 = map_2d(&wqm, wqk, kC, kDa, kDa, 128, 64)) return rc2;
  if (int rc2 = map_2d(&wvm, wv, kC, kC, kC, 128, 64)) return rc2;
  const long long tiles = (rows + kTile - 1) / kTile;
  const int half_grid = (int)(tiles < sm_count() / 2 ? tiles : sm_count() / 2);
  const int gx = 2 * (half_grid < 1 ? 1 : half_grid);
  auto dx_launch = [&](auto kernel) -> int {
    if (int rc3 = allow_smem(kernel, DxSmem::bytes)) return rc3;
    kernel<<<gx, kThreads, DxSmem::bytes, st>>>(dqm, dvm, wqm, wvm, (const bf16*)cot, w.dyr,
                                                (bf16*)dx, rows);
    return (int)cudaGetLastError();
  };
  if (kind == 0)
    rc = oa ? dx_launch(dx256_wgmma_kernel<true, true>)
            : dx_launch(dx256_wgmma_kernel<true, false>);
  else if (kind == 1)
    rc = oa ? dx_launch(dx256_wgmma_kernel<false, true>)
            : dx_launch(dx256_wgmma_kernel<false, false>);
  else
    rc = dx_launch(dx256_wgmma_kernel<false, false>);
  if (rc) return rc;

  // dWqk = xᵀ·dq, dWv = xᵀ·dv (with dbv), dWt = uᵀ·dz (with dbt): each over
  // the two 128-column halves of x or u
  const long long slice = slice_stride(kGrad256);
  const bf16* xb = (const bf16*)x;
  for (int h = 0; h < 2; ++h) {
    if (int rc2 = launch_wgrad_sm90(xb + 128 * h, kC, w.dq, kDa, 64, 0, rows,
                                    scratch + kOffDwqk256, slice, kDa, 128 * h, 0, blocks, st))
      return rc2;
    if (int rc2 = launch_wgrad_sm90(xb + 128 * h, kC, w.dv, kC, 128, h == 0, rows,
                                    scratch + kOffDwv256, slice, kC, 128 * h,
                                    kOffDbv256 - kOffDwv256, blocks, st))
      return rc2;
    if (kind != 2)
      if (int rc2 = launch_wgrad_sm90(w.u + 128 * h, kC, w.dz, kC, 128, h == 0, rows,
                                      scratch + kOffDwt256, slice, kC, 128 * h,
                                      kOffDbt256 - kOffDwt256, blocks, st))
        return rc2;
  }
  return reduce_slices(scratch, slice, blocks, grads, kind == 2 ? kOffDwt256 : kGrad256, st);
}

}  // namespace sga
