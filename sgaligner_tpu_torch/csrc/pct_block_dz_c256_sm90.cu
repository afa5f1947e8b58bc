// The dz pass of the bf16 C = 256 block backwards (pct_block_bwd_c256_sm90.cu
// holds the design notes and the other passes), in a file of its own so
// that nvcc compiles it beside the others.
#include "pct_c256_sm90.cuh"

namespace sga {
namespace {

using namespace c256;

constexpr int kKeyStages = 2;
using KeyRing = Ring<kKeyStages>;

// ---------------------------------- pass dz ----------------------------------

struct DzBars {
  // the key ring; the q_I tile; the x and cotangent tiles; each
  // warpgroup's two Wt slices (slot 2c + s)
  uint64_t full[kKeyStages], empty[kKeyStages], qfull, qempty, tfull, tempty, wfull[4], wempty[4];
  __device__ void init() {
    for (int i = 0; i < kKeyStages; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, 8);  // one arrival per consumer warp
    }
    mbar_init(&qfull, 1);
    mbar_init(&qempty, 8);
    mbar_init(&tfull, 1);
    mbar_init(&tempty, 8);
    for (int i = 0; i < 4; ++i) {
      mbar_init(wfull + i, 1);
      mbar_init(wempty + i, 4);  // the slot's warpgroup
    }
    mbar_fence_init();
  }
};

struct DzSmem {
  static constexpr size_t stage_bytes = round1k(kVtChunk + kQTile + kVec);  // vᵀ_J, q_J, lse_J
  static constexpr size_t ring_off = 0;
  static constexpr size_t qi_off = ring_off + kKeyStages * stage_bytes;
  static constexpr size_t xu_off = qi_off + kQTile;      // x, u, then dz
  static constexpr size_t gt_off = xu_off + kRowTile;    // the cotangent, then dŶ and dY
  static constexpr size_t w_off = gt_off + kRowTile;     // four Wt slices
  static constexpr size_t vec_off = w_off + 4 * kWSlot;  // bt, wbn, bbn, dsum, dsumsq f32
  static constexpr size_t xch_off = vec_off + 5 * kC * 4;  // [2 items][2 halves][64] f32
  static constexpr size_t bar_off = xch_off + 2 * 2 * kTile * 4;
  static constexpr size_t bytes = bar_off + sizeof(DzBars) + 1024;
};
static_assert(DzSmem::bytes <= kSmemMax, "dz: shared memory");

// epi: dz from the relu routing of the next layer's cotangent
// (pct_block_res_bwd), else the cotangent is t_out's (pct_block_bwd).
// ATTN (OA only): the attention op's backward, whose cotangent is dY
// itself: only dŶ and c are written. OA: u = x − y/s, dY = −du, dŶ = dY/s
// rounded, c_j = (dY_j / s_j)·(y_j / s_j); the block forms also write
// round(dY) to dyr.
template <bool OA, bool ATTN>
__global__ void __launch_bounds__(kThreadsWide, 1)
dz256_wgmma_kernel(const __grid_constant__ CUtensorMap qm, const __grid_constant__ CUtensorMap vm,
                   const __grid_constant__ CUtensorMap lm, const __grid_constant__ CUtensorMap xm,
                   const __grid_constant__ CUtensorMap gm, const __grid_constant__ CUtensorMap wtcm,
                   const __grid_constant__ CUtensorMap wtrm, const bf16* __restrict__ bt,
                   const bf16* __restrict__ mask, const float* __restrict__ wbn,
                   const float* __restrict__ bbn, const float* __restrict__ dsum,
                   const float* __restrict__ dsumsq, bf16* __restrict__ u, bf16* __restrict__ dz,
                   bf16* __restrict__ dyh, bf16* __restrict__ dyr, float* __restrict__ cvec,
                   int epi, int o, int p, int pp) {
  using L = DzSmem;
  constexpr bool kXload = OA && !ATTN;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  DzBars& b = *reinterpret_cast<DzBars*>(smem + L::bar_off);
  float* vec = reinterpret_cast<float*>(smem + L::vec_off);

  if constexpr (!ATTN) {
    for (int i = threadIdx.x; i < kC; i += blockDim.x) {
      vec[i] = __bfloat162float(bt[i]);
      vec[kC + i] = epi ? wbn[i] : 0.f;
      vec[2 * kC + i] = epi ? bbn[i] : 0.f;
      vec[3 * kC + i] = dsum[i];
      vec[4 * kC + i] = dsumsq[i];
    }
  }
  if (threadIdx.x == 0) b.init();
  __syncthreads();
  const int per_obj = (p + kTile - 1) / kTile;
  const int items = o * per_obj;
  const int c = threadIdx.x / 128, t = threadIdx.x % 128;  // c = 2: the producer warpgroup

  if (c == 2) {
    reg_dealloc<kProducerRegs>();
    if (t == 0) {
      uint32_t n = 0, qn = 0;
      for (int it = blockIdx.x; it < items; it += gridDim.x, ++qn) {
        const int obj = it / per_obj, r0 = (it % per_obj) * kTile;
        mbar_wait(&b.qempty, (qn & 1u) ^ 1u);
        mbar_expect_tx(&b.qfull, kQTile);
        tma_load_3d(smem + L::qi_off, &qm, &b.qfull, 0, r0, obj);
        for (int c0 = 0; c0 < p; c0 += kTile, ++n) {
          const int st = KeyRing::stage(n);
          unsigned char* sp = smem + L::ring_off + st * L::stage_bytes;
          mbar_wait(b.empty + st, KeyRing::empty_parity(n));
          mbar_expect_tx(b.full + st, kVtChunk + kQTile + kVec);
          tma_load_3d(sp, &vm, b.full + st, c0, 0, obj);
          tma_load_3d(sp + kVtChunk, &qm, b.full + st, 0, c0, obj);
          tma_load_2d(sp + kVtChunk + kQTile, &lm, b.full + st, c0, obj);
        }
        mbar_wait(&b.tempty, (qn & 1u) ^ 1u);
        mbar_expect_tx(&b.tfull, (kXload ? 2 : 1) * kRowTile);
        if constexpr (kXload) load_rows3(smem + L::xu_off, &xm, &b.tfull, obj, r0);
        load_rows3(smem + L::gt_off, &gm, &b.tfull, obj, r0);
      }
    } else if (t == 1) {
      // Wt's slices: warpgroup h's k-th of an item, k < 4, is Wt's columns
      // 128h + 32k.. (for t), k >= 4 Wt's rows 128h + 32(k − 4).. (for dY)
      if constexpr (!ATTN) {
        uint32_t wn = 0;
        for (int it = blockIdx.x; it < items; it += gridDim.x)
          for (int k = 0; k < 8; ++k, ++wn)
            for (int h = 0; h < 2; ++h) {
              const int slot = 2 * h + wn % 2;
              unsigned char* ws = smem + L::w_off + slot * kWSlot;
              mbar_wait(b.wempty + slot, ((wn / 2) & 1u) ^ 1u);
              mbar_expect_tx(b.wfull + slot, kWSlot);
              if (k < 4) {
                tma_load_2d(ws, &wtcm, b.wfull + slot, 128 * h + 32 * k, 0);
              } else {
                for (int kb = 0; kb < 4; ++kb)
                  tma_load_2d(ws + kb * (kWSlot / 4), &wtrm, b.wfull + slot, 64 * kb,
                              128 * h + 32 * (k - 4));
              }
            }
      }
    }
    return;
  }
  reg_alloc<kConsumerRegs>();

  const int warp = t / 32, lane = t % 32;
  const int rl = 16 * warp + lane / 4;  // this thread's rows: rl and rl + 8
  uint32_t* xu = reinterpret_cast<uint32_t*>(smem + L::xu_off);
  uint32_t* gt = reinterpret_cast<uint32_t*>(smem + L::gt_off);
  uint32_t n = 0, qn = 0, wn = 0;
  float y[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) y[i] = 0.f;

  for (int it = blockIdx.x; it < items; it += gridDim.x, ++qn) {
    const int obj = it / per_obj, r0 = (it % per_obj) * kTile;
    const int valid = min(kTile, p - r0);
    mbar_wait(&b.qfull, qn & 1u);
    const unsigned char* qi = smem + L::qi_off;
    float rs[2] = {0.f, 0.f};
    fence_regs(y);
    // y[:, 128c..] = Σ_J G_IJ·v_J[:, 128c..], as the forward's apply pass
    for (int c0 = 0; c0 < p; c0 += kTile, ++n) {
      const int st = KeyRing::stage(n);
      const unsigned char* sp = smem + L::ring_off + st * L::stage_bytes;
      const float* lse = reinterpret_cast<const float*>(sp + kVtChunk + kQTile);
      mbar_wait(b.full + st, KeyRing::full_parity(n));
      float s[32];
      start_energies(s, qi, sp + kVtChunk);
      wgmma_wait<0>();
      fence_regs(s);
      if (lane == 0 && c0 + kTile >= p) mbar_arrive(&b.qempty);
      uint32_t a[4][4];
      softmax_frags<OA>(s, lse, p - c0, lane, a, rs);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_m64n128k16_rs(y, a[kk], desc(sp + c * (kVtChunk / 2), kSw128, kk * 32),
                            (c0 | kk) != 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(y);
      if (lane == 0) mbar_arrive(b.empty + st);
    }

    float inv[2] = {1.f, 1.f};  // OA: 1 / (1e-9 + s) of the two rows
    if constexpr (OA) {
      inv[0] = 1.f / (1e-9f + quad_sum(rs[0]));
      inv[1] = 1.f / (1e-9f + quad_sum(rs[1]));
#pragma unroll
      for (int i = 0; i < 64; ++i) y[i] *= inv[(i / 2) % 2];  // y / s
    }
    // the tiles' last readers arrived on tempty before they were reloaded
    mbar_wait(&b.tfull, qn & 1u);
    const size_t row0 = (size_t)obj * p + r0;
    float dy[4][16];  // dY at f32, slice k element i: the tile's word half_word(.., 8k + i / 2)
    if constexpr (!ATTN) {
      // u = y (SA) or x − round(y / s) (OA), rounded, into this
      // warpgroup's half of the tile
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int w = half_word(c, rl, lane, j);
        if constexpr (OA) {
          const uint32_t xv = xu[w];
          const uint32_t yr = pack_bf16(y[2 * j], y[2 * j + 1]);
          xu[w] = pack_bf16(lo_bf16(xv) - lo_bf16(yr), hi_bf16(xv) - hi_bf16(yr));
        } else {
          xu[w] = pack_bf16(y[2 * j], y[2 * j + 1]);
        }
      }
      fence_proxy_async();
      bar_sync(1, 256);  // both halves of u in the tile
      store_half(xu, u + row0 * kC, valid, c, t);
      // t[:, 128c + 32k..] = u·Wt[:, 128c + 32k..]
      float tacc[4][16];
#pragma unroll
      for (int k = 0; k < 4; ++k, ++wn) {
        const int slot = 2 * c + wn % 2;
        mbar_wait(b.wfull + slot, (wn / 2) & 1u);
        const unsigned char* ws = smem + L::w_off + slot * kWSlot;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 16; ++kk)
          wgmma_m64n32k16_ss_t<0, 1>(
              tacc[k], desc(smem + L::xu_off + (kk / 4) * kBox, kSw128, (kk % 4) * 32),
              desc_mn(ws, kSw64, 16 * kk, 0), kk != 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(tacc[k]);
        __syncwarp();
        if (lane == 0) mbar_arrive(b.wempty + slot);
      }
      bar_sync(1, 256);  // both warpgroups' products have read u: the tile takes dz

      // dz = relu-routed cotangent·wbn + m·dsum + 2·t·m·dsumsq (epi), or the
      // cotangent + the same sums' terms; rounded, zero past P
      const float m = __bfloat162float(mask[obj]);
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int i = 0; i < 16; i += 2) {
          const int w = half_word(c, rl, lane, 8 * k + i / 2);
          const int col = 128 * c + 32 * k + acc_col(lane, i);
          const bool in = rl + 8 * ((i / 2) % 2) < valid;
          const uint32_t gw = gt[w];
          float d[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int cc = col + e;
            const float tv = __bfloat162float(__float2bfloat16_rn(tacc[k][i + e] + vec[cc]));
            const float g = e == 0 ? lo_bf16(gw) : hi_bf16(gw);
            const float d1 = vec[3 * kC + cc], d2 = vec[4 * kC + cc];
            float v;
            if (epi) {
              const float wc = vec[kC + cc];
              const float w_t = __bfloat162float(__float2bfloat16_rn(wc));
              const float b_t = __bfloat162float(__float2bfloat16_rn(vec[2 * kC + cc]));
              const float z = __bfloat162float(__float2bfloat16_rn(
                  __fadd_rn(__bfloat162float(__float2bfloat16_rn(__fmul_rn(tv, w_t))), b_t)));
              v = ((z > 0.f ? g : 0.f) * wc + m * d1) + 2.f * tv * (m * d2);
            } else {
              v = (g + m * d1) + 2.f * tv * (m * d2);
            }
            d[e] = in ? v : 0.f;
          }
          xu[w] = pack_bf16(d[0], d[1]);
        }
      fence_proxy_async();
      bar_sync(1, 256);  // both halves of dz in the tile
      store_half(xu, dz + row0 * kC, valid, c, t);
      // dY[:, 128c + 32k..] = ±dz·Wtᵀ[:, 128c + 32k..] (Wt's rows: K-major)
#pragma unroll
      for (int k = 0; k < 4; ++k, ++wn) {
        const int slot = 2 * c + wn % 2;
        mbar_wait(b.wfull + slot, (wn / 2) & 1u);
        const unsigned char* ws = smem + L::w_off + slot * kWSlot;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 16; ++kk)
          wgmma_m64n32k16_ss(dy[k], desc(smem + L::xu_off + (kk / 4) * kBox, kSw128, (kk % 4) * 32),
                             desc(ws + (kk / 4) * (kWSlot / 4), kSw128, (kk % 4) * 32), kk != 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dy[k]);
        __syncwarp();
        if (lane == 0) mbar_arrive(b.wempty + slot);
      }
      if constexpr (OA) {
#pragma unroll
        for (int k = 0; k < 4; ++k)
#pragma unroll
          for (int i = 0; i < 16; ++i) dy[k][i] = -dy[k][i];
      }
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int i = 0; i < 16; i += 2) {
          const uint32_t gw = gt[half_word(c, rl, lane, 8 * k + i / 2)];
          dy[k][i] = lo_bf16(gw);
          dy[k][i + 1] = hi_bf16(gw);
        }
    }
    if constexpr (OA) {
      // c_j = (dY_j / s_j)·(y_j / s_j): each half's partial sum, then both
      float cr[2] = {0.f, 0.f};
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int i = 0; i < 16; ++i)
          cr[(i / 2) % 2] += (dy[k][i] * inv[(i / 2) % 2]) * y[16 * k + i];
      float* xch = reinterpret_cast<float*>(smem + L::xch_off) + (qn % 2) * 2 * kTile;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float cv = quad_sum(cr[h]);
        if (lane % 4 == 0) xch[c * kTile + rl + 8 * h] = cv;
      }
      bar_sync(1, 256);
      if (c == 0 && lane % 4 == 0)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (rl + 8 * h < valid)
            cvec[(size_t)obj * pp + r0 + rl + 8 * h] = xch[rl + 8 * h] + xch[kTile + rl + 8 * h];
    }
    // dŶ = round(round(dY)·(1 / s)) (OA) or round(dY) into the cotangent
    // tile (each word by the thread that read its cotangent), then out
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int i = 0; i < 16; i += 2) {
        const int w = half_word(c, rl, lane, 8 * k + i / 2);
        if constexpr (OA) {
          const float sc = inv[(i / 2) % 2];
          gt[w] = pack_bf16(__bfloat162float(__float2bfloat16_rn(dy[k][i])) * sc,
                            __bfloat162float(__float2bfloat16_rn(dy[k][i + 1])) * sc);
        } else {
          gt[w] = pack_bf16(dy[k][i], dy[k][i + 1]);
        }
      }
    bar_sync(2 + c, 128);
    store_half(gt, dyh + row0 * kC, valid, c, t);
    if constexpr (kXload) {
      // round(dY) = −round(du): the OA block's dx term
      bar_sync(2 + c, 128);
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int i = 0; i < 16; i += 2)
          gt[half_word(c, rl, lane, 8 * k + i / 2)] = pack_bf16(dy[k][i], dy[k][i + 1]);
      bar_sync(2 + c, 128);
      store_half(gt, dyr + row0 * kC, valid, c, t);
    }
    fence_proxy_async();  // the plain accesses to the tiles before the next TMA into them
    __syncwarp();
    if (lane == 0) mbar_arrive(&b.tempty);  // the tiles may take the next item's
  }
}

}  // namespace

// u, dz, dŶ (and OA's c and round(dY)) of the bf16 C = 256 block
// backwards: epi (pct_block_res_bwd) or not (pct_block_bwd), oa, attn (the
// OA attention op's backward: dŶ and c alone); maps as the pass reads them
int launch_dz_c256_sm90(int epi, int oa, int attn, const CUtensorMap& qm, const CUtensorMap& vm,
                        const CUtensorMap& lm, const CUtensorMap& xm, const CUtensorMap& gm,
                        const CUtensorMap& wtcm, const CUtensorMap& wtrm, const void* bt,
                        const void* mask, const float* wbn, const float* bbn, const float* dsum,
                        const float* dsumsq, void* u, void* dz, void* dyh, void* dyr, float* cvec,
                        int grid, int o, int p, cudaStream_t st) {
  const int pp = (p + 7) / 8 * 8;
  auto kernel = attn ? dz256_wgmma_kernel<true, true>
                     : oa ? dz256_wgmma_kernel<true, false> : dz256_wgmma_kernel<false, false>;
  if (int rc = allow_smem(kernel, DzSmem::bytes)) return rc;
  kernel<<<grid, kThreadsWide, DzSmem::bytes, st>>>(
      qm, vm, lm, xm, gm, wtcm, wtrm, (const bf16*)bt, (const bf16*)mask, wbn, bbn, dsum, dsumsq,
      (bf16*)u, (bf16*)dz, (bf16*)dyh, (bf16*)dyr, cvec, epi, o, p, pp);
  return (int)cudaGetLastError();
}

}  // namespace sga
