// PCT SA / OA block backward, bf16: the wgmma design of pct_block_res_bwd,
// pct_block_bwd and pct_attn_bwd (see pct_attention.cu for the functions,
// their notation and their f32 path).
//
// Replaces sgaligner_tpu/ops/pct_attention.py::_block_res_bwd_rule (Pallas
// kernel _block_res_bwd_kernel) for bf16 inputs, and carries the core passes
// of _block_bwd_rule (_block_bwd_kernel) and _bwd_rule (_bwd_kernel).
//   Bound on the H100: operations on the tensor cores, about 3x the
//   forward's: the projections, E, y, t again; dY = dz·Wtᵀ; Gᵀ·dŶ, the two
//   dP products and F·q; dx and the three weight gradients (0.33 ms at
//   O = 896, P = 512).
//   Design: one launch each, over 64-row tiles, after the forward's
//   projection (writing q, vᵀ and v row-major) and lse passes
//   (pct_block_eval_sm90.cu). The key passes are persistent, one block per
//   SM: a producer warp and two consumer warpgroups on neighbouring tiles
//   of one object sharing every key chunk of a TMA ring; accumulators in
//   registers; a score tile leaves the registers only as the register-A
//   fragment of the next product.
//     dz: the apply pass of pct_block_eval (S, G and y in registers), then
//       u, t = u·Wt, dz (the epilogue's relu routing of the cotangent and the
//       BN sums' terms) and dY = dz·Wtᵀ, all by wgmma with Wt resident
//       (once transposed, once as is); u, dz and dŶ (= dY, or dY/s rounded
//       for OA, with OA's c_j) leave through a staging tile in 16-byte rows;
//     dv: per key tile I, S_IJ = q_I·q_Jᵀ and Gᵀ = exp(S − lse_I) in
//       registers as the A fragment of dv_I += Gᵀ·dŶ_J, dŶ_J an MN-major
//       (row-major) operand straight from its TMA box; then D_i = v_i·dv_i
//       (less Σ_j G[j,i]·c_j for OA);
//     dq: per row tile I, one S_IJ serves both terms of dE + dEᵀ: the two
//       dP products v_I·dŶ_Jᵀ and dŶ_I·v_Jᵀ run in turn on one set of
//       registers, F is formed in registers and is the A fragment of
//       dq_I += F·q_J (q_J MN-major);
//     dx: flat 64-row tiles through a TMA ring, dx = dq·Wqkᵀ + dv·Wvᵀ
//       (+ dz·Wtᵀ for the OA block, + the residual) with the weights
//       resident as they are (already the K-major B operand);
//     the weight gradients dWqk = xᵀ·dq, dWv = xᵀ·dv, dWt = uᵀ·dz and the
//       biases' Σdv, Σdz: wgrad_wgmma_kernel, both operands MN-major TMA
//       boxes of the row-major activations, the column sums by a wgmma with
//       an all-ones A fragment; each block sums a fixed range of rows into
//       its own scratch slice and reduce_slices adds the slices in order:
//       no atomics, the same bits twice.
//   D_i needs dv_i complete, so dv and dq are separate launches.
#include "common.cuh"
#include "hopper.cuh"

namespace sga {

int launch_project_lse_sm90(const void* x, const void* wqk, const void* wv, const void* bv,
                            void* q, void* vt, void* vrow, float* lse2, int o, int p,
                            CUtensorMap* xm, CUtensorMap* qm, CUtensorMap* vm, CUtensorMap* lm,
                            cudaStream_t st);

namespace {

using namespace sm90;

constexpr int kC = 128;
constexpr int kDa = 32;
constexpr int kTile = 64;
constexpr int kThreads = 288;  // 2 consumer warpgroups + a producer warp
constexpr float kLog2e = 1.4426950408889634f;

constexpr uint32_t kQTile = kTile * kDa * 2;  // 4 KB, 64-byte rows
constexpr uint32_t kBox = kTile * 64 * 2;     // 8 KB, [64 rows, 64] with 128-byte rows
constexpr uint32_t kRowTile = 2 * kBox;       // 16 KB, [64 rows, 128]: two boxes
constexpr uint32_t kVec = kTile * 4;          // 256 B, 64 f32

__host__ __device__ constexpr size_t round1k(size_t n) { return (n + 1023) & ~size_t(1023); }

__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  return raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
}

// accumulator element i of an m64nN wgmma: this thread's row and column
__device__ __forceinline__ int acc_row(int warp, int lane, int i) {
  return 16 * warp + lane / 4 + 8 * ((i / 2) % 2);
}
__device__ __forceinline__ int acc_col(int lane, int i) { return 8 * (i / 4) + 2 * (lane % 4) + i % 2; }

template <int R>
__device__ __forceinline__ void fence_acc(float* d) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Work item `it`: object it / pairs, row (or key) tiles 2·(it % pairs) and
// the next one, one per consumer warpgroup (the second may lie past P: it
// computes and stores nothing)
struct Items {
  int pairs, items;
  __device__ Items(int p, int o) : pairs(((p + kTile - 1) / kTile + 1) / 2), items(o * pairs) {}
};

// Stage a [64, 128] bf16 tile, given as this thread's 32 packed pairs of an
// m64n128 accumulator (pk[i / 8][(i / 2) % 4] holds elements i, i + 1),
// into the 128-byte-swizzled staging tile, then store its rows < `valid` to
// dst (row stride 128) in 16-byte pieces. Called by all 128 threads of
// consumer warpgroup c.
__device__ __forceinline__ void stage_store(uint32_t* tile, const uint32_t (&pk)[8][4],
                                            bf16* __restrict__ dst, int valid, int c, int t) {
  const int warp = t / 32, lane = t % 32;
#pragma unroll
  for (int idx = 0; idx < 32; ++idx)
    tile[x_word(16 * warp + lane / 4 + 8 * (idx % 2), 8 * (idx / 2) + 2 * (lane % 4))] =
        pk[idx / 4][idx % 4];
  bar_sync(1 + c, 128);
  for (int idx = t; idx < kTile * (kC / 8); idx += 128) {
    const int r = idx / (kC / 8), q = idx % (kC / 8);
    if (r < valid)
      *reinterpret_cast<uint4*>(dst + (size_t)r * kC + 8 * q) =
          *reinterpret_cast<const uint4*>(tile + x_word(r, 8 * q));
  }
  bar_sync(1 + c, 128);
}

// S = q_I·q_Jᵀ [64, 64] (q tiles with 64-byte rows), started, not waited
__device__ __forceinline__ void start_energies(float (&s)[32], const unsigned char* qi,
                                               const unsigned char* qj) {
  wgmma_fence();
  wgmma_m64n64k16_ss(s, desc(qi, kSw64, 0), desc(qj, kSw64, 0), 0);
  wgmma_m64n64k16_ss(s, desc(qi, kSw64, 32), desc(qj, kSw64, 32), 1);
  wgmma_commit();
}

// ---------------------------------- pass dz ----------------------------------

constexpr int kDzStages = 3;
using DzRing = Ring<kDzStages>;

struct DzBars {
  // the key ring; the q_I tiles of an item (two slots); each consumer's
  // x and cotangent tiles; the weights
  uint64_t full[kDzStages], empty[kDzStages], qfull[2], qempty[2], tfull[2], tempty[2], w;
  __device__ void init() {
    for (int i = 0; i < kDzStages; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, 8);
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(qfull + i, 1);
      mbar_init(qempty + i, 8);
      mbar_init(tfull + i, 1);
      mbar_init(tempty + i, 4);
    }
    mbar_init(&w, 1);
    mbar_fence_init();
  }
};

struct DzSmem {
  static constexpr size_t stage_bytes = round1k(kRowTile + kQTile + kVec);  // vᵀ, q_J, lse_J
  static constexpr size_t wtt_off = 0;                  // Wtᵀ (B of u·Wt)
  static constexpr size_t wtr_off = wtt_off + 2 * kRowTile;  // Wt as is (B of dz·Wtᵀ)
  static constexpr size_t qi_off = wtr_off + 2 * kRowTile;   // [2 slots][2 tiles]
  static constexpr size_t ring_off = qi_off + 4 * kQTile;
  static constexpr size_t xt_off = ring_off + kDzStages * stage_bytes;  // [2] x / staging
  static constexpr size_t gt_off = xt_off + 2 * kRowTile;               // [2] cotangent
  static constexpr size_t vec_off = gt_off + 2 * kRowTile;  // bt, wbn, bbn, dsum, dsumsq
  static constexpr size_t bar_off = vec_off + 5 * kC * 4;
  static constexpr size_t bytes = bar_off + sizeof(DzBars) + 1024;
};

// EPI: dz from the relu routing of the next layer's cotangent
// (pct_block_res_bwd), else the cotangent is t_out's (pct_block_bwd).
// ATTN (OA only): the attention op's backward, whose cotangent is dY
// itself: only dŶ and c are written. OA: u = x − y/s, dY = −du, dŶ = dY/s
// rounded, c_j = (dY_j / s_j)·(y_j / s_j).
template <bool EPI, bool OA, bool ATTN>
__global__ void __launch_bounds__(kThreads, 1)
dz_wgmma_kernel(const __grid_constant__ CUtensorMap qm, const __grid_constant__ CUtensorMap vm,
                const __grid_constant__ CUtensorMap lm, const __grid_constant__ CUtensorMap xm,
                const __grid_constant__ CUtensorMap gm, const __grid_constant__ CUtensorMap wtm,
                const bf16* __restrict__ wt, const bf16* __restrict__ bt,
                const bf16* __restrict__ mask, const float* __restrict__ wbn,
                const float* __restrict__ bbn, const float* __restrict__ dsum,
                const float* __restrict__ dsumsq, bf16* __restrict__ u, bf16* __restrict__ dz,
                bf16* __restrict__ dyh, float* __restrict__ cvec, int o, int p, int pp) {
  using L = DzSmem;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  DzBars& b = *reinterpret_cast<DzBars*>(smem + L::bar_off);
  float* vec = reinterpret_cast<float*>(smem + L::vec_off);

  if constexpr (!ATTN) {
    stage_transposed<kC, kC>(reinterpret_cast<bf16*>(smem + L::wtt_off), wt);
    for (int i = threadIdx.x; i < kC; i += blockDim.x) {
      vec[i] = __bfloat162float(bt[i]);
      vec[kC + i] = EPI ? wbn[i] : 0.f;
      vec[2 * kC + i] = EPI ? bbn[i] : 0.f;
      vec[3 * kC + i] = dsum[i];
      vec[4 * kC + i] = dsumsq[i];
    }
  }
  fence_proxy_async();
  if (threadIdx.x == 0) b.init();
  __syncthreads();
  const Items work(p, o);
  const int c = threadIdx.x / 128, t = threadIdx.x % 128;  // c = 2: the producer warp

  if (c == 2) {
    if (t != 0) return;
    if constexpr (!ATTN) {
      mbar_expect_tx(&b.w, 2 * kRowTile);
      tma_load_2d(smem + L::wtr_off, &wtm, &b.w, 0, 0);
      tma_load_2d(smem + L::wtr_off + kRowTile, &wtm, &b.w, 64, 0);
    }
    constexpr uint32_t tile_bytes = (OA && !ATTN ? 2 : 1) * kRowTile;
    uint32_t n = 0, qn = 0;
    for (int it = blockIdx.x; it < work.items; it += gridDim.x, ++qn) {
      const int obj = it / work.pairs, r0 = (it % work.pairs) * 2 * kTile;
      const int qs = qn % 2;
      mbar_wait(b.qempty + qs, ((qn / 2) & 1u) ^ 1u);
      mbar_expect_tx(b.qfull + qs, 2 * kQTile);
      for (int h = 0; h < 2; ++h)
        tma_load_3d(smem + L::qi_off + (2 * qs + h) * kQTile, &qm, b.qfull + qs, 0,
                    r0 + h * kTile, obj);
      for (int c0 = 0; c0 < p; c0 += kTile, ++n) {
        const int st = DzRing::stage(n);
        unsigned char* sp = smem + L::ring_off + st * L::stage_bytes;
        mbar_wait(b.empty + st, DzRing::empty_parity(n));
        mbar_expect_tx(b.full + st, kRowTile + kQTile + kVec);
        tma_load_3d(sp, &vm, b.full + st, c0, 0, obj);
        tma_load_3d(sp + kRowTile, &qm, b.full + st, 0, c0, obj);
        tma_load_2d(sp + kRowTile + kQTile, &lm, b.full + st, c0, obj);
      }
      for (int h = 0; h < 2; ++h) {
        unsigned char* xt = smem + L::xt_off + h * kRowTile;
        unsigned char* gt = smem + L::gt_off + h * kRowTile;
        const int rh = r0 + h * kTile;
        mbar_wait(b.tempty + h, (qn & 1u) ^ 1u);
        mbar_expect_tx(b.tfull + h, tile_bytes);
        if constexpr (OA && !ATTN) {
          tma_load_3d(xt, &xm, b.tfull + h, 0, rh, obj);
          tma_load_3d(xt + kBox, &xm, b.tfull + h, 64, rh, obj);
        }
        tma_load_3d(gt, &gm, b.tfull + h, 0, rh, obj);
        tma_load_3d(gt + kBox, &gm, b.tfull + h, 64, rh, obj);
      }
    }
    return;
  }

  const int warp = t / 32, lane = t % 32;
  const int rl = 16 * warp + lane / 4;  // this thread's rows: rl and rl + 8
  if constexpr (!ATTN) mbar_wait(&b.w, 0);
  uint32_t n = 0, qn = 0;
  float y[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) y[i] = 0.f;

  for (int it = blockIdx.x; it < work.items; it += gridDim.x, ++qn) {
    const int obj = it / work.pairs, r0 = (it % work.pairs) * 2 * kTile + c * kTile;
    const int qs = qn % 2;
    const int valid = min(kTile, p - r0);  // may be <= 0: nothing stored
    mbar_wait(b.qfull + qs, (qn / 2) & 1u);
    const unsigned char* qi = smem + L::qi_off + (2 * qs + c) * kQTile;
    float rs[2] = {0.f, 0.f};
    fence_regs(y);
    // y = Σ_J G_IJ·v_J, as pct_block_eval's apply pass
    for (int c0 = 0; c0 < p; c0 += kTile, ++n) {
      const int st = DzRing::stage(n);
      const unsigned char* sp = smem + L::ring_off + st * L::stage_bytes;
      const float* lse = reinterpret_cast<const float*>(sp + kRowTile + kQTile);
      mbar_wait(b.full + st, DzRing::full_parity(n));
      float s[32];
      start_energies(s, qi, sp + kRowTile);
      wgmma_wait<0>();
      fence_regs(s);
      if (lane == 0 && c0 + kTile >= p) mbar_arrive(b.qempty + qs);
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
            const float lv = lse[col + e];
            const bool live = col + e < kv;
            g[0][e] = live ? ex2(fmaf(s[4 * j + e], kLog2e, -lv)) : 0.f;
            g[1][e] = live ? ex2(fmaf(s[4 * j + 2 + e], kLog2e, -lv)) : 0.f;
          }
          a[kk][2 * hj] = pack_bf16(g[0][0], g[0][1]);
          a[kk][2 * hj + 1] = pack_bf16(g[1][0], g[1][1]);
          if constexpr (OA) {
            rs[0] += lo_bf16(a[kk][2 * hj]) + hi_bf16(a[kk][2 * hj]);
            rs[1] += lo_bf16(a[kk][2 * hj + 1]) + hi_bf16(a[kk][2 * hj + 1]);
          }
        }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_m64n128k16_rs(y, a[kk], desc(sp, kSw128, kk * 32), (c0 | kk) != 0);
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
    mbar_wait(b.tfull + c, qn & 1u);
    uint32_t* xt = reinterpret_cast<uint32_t*>(smem + L::xt_off + c * kRowTile);
    const uint32_t* gt = reinterpret_cast<const uint32_t*>(smem + L::gt_off + c * kRowTile);
    const size_t row0 = (size_t)obj * p + r0;
    float dy[64];  // dY at f32
    uint32_t pk[8][4];
    if constexpr (!ATTN) {
      // u = y (SA) or x − round(y / s) (OA), rounded: the A fragment of u·Wt
#pragma unroll
      for (int idx = 0; idx < 32; ++idx) {
        const int h = idx % 2, col = 8 * (idx / 2) + 2 * (lane % 4);
        const float y0 = y[2 * idx], y1 = y[2 * idx + 1];
        if constexpr (OA) {
          const uint32_t xv = xt[x_word(rl + 8 * h, col)];
          const uint32_t yr = pack_bf16(y0, y1);
          pk[idx / 4][idx % 4] = pack_bf16(lo_bf16(xv) - lo_bf16(yr), hi_bf16(xv) - hi_bf16(yr));
        } else {
          pk[idx / 4][idx % 4] = pack_bf16(y0, y1);
        }
      }
      float tacc[64];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        wgmma_m64n128k16_rs(tacc, pk[kk], desc(smem + L::wtt_off + (kk / 4) * kRowTile, kSw128,
                                               (kk % 4) * 32),
                            kk != 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(tacc);
      if (OA) bar_sync(1 + c, 128);  // every thread has read its x before u overwrites it
      stage_store(xt, pk, u + row0 * kC, valid, c, t);

      // dz = relu-routed cotangent·wbn + m·dsum + 2·t·m·dsumsq (EPI), or
      // the cotangent + the same sums' terms; rounded, zero past P
      const float m = __bfloat162float(mask[obj]);
#pragma unroll
      for (int idx = 0; idx < 32; ++idx) {
        const int h = idx % 2, col = 8 * (idx / 2) + 2 * (lane % 4);
        const bool in = rl + 8 * h < valid;
        const uint32_t gw = gt[x_word(rl + 8 * h, col)];
        float d[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int cc = col + e;
          const float tv = __bfloat162float(__float2bfloat16_rn(tacc[2 * idx + e] + vec[cc]));
          const float g = e == 0 ? lo_bf16(gw) : hi_bf16(gw);
          const float d1 = vec[3 * kC + cc], d2 = vec[4 * kC + cc];
          float v;
          if constexpr (EPI) {
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
        pk[idx / 4][idx % 4] = pack_bf16(d[0], d[1]);
      }
      stage_store(xt, pk, dz + row0 * kC, valid, c, t);
      // dY = ±dz·Wtᵀ (Wt as is: the K-major B operand)
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        wgmma_m64n128k16_rs(dy, pk[kk], desc(smem + L::wtr_off + (kk / 4) * kRowTile, kSw128,
                                             (kk % 4) * 32),
                            kk != 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dy);
      if constexpr (OA) {
#pragma unroll
        for (int i = 0; i < 64; ++i) dy[i] = -dy[i];
      }
    } else {
#pragma unroll
      for (int idx = 0; idx < 32; ++idx) {
        const uint32_t gw = gt[x_word(rl + 8 * (idx % 2), 8 * (idx / 2) + 2 * (lane % 4))];
        dy[2 * idx] = lo_bf16(gw);
        dy[2 * idx + 1] = hi_bf16(gw);
      }
    }
    if constexpr (OA) {
      // c_j = (dY_j / s_j)·(y_j / s_j); dŶ = round(round(dY)·(1 / s))
      float cr[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 64; ++i) cr[(i / 2) % 2] += (dy[i] * inv[(i / 2) % 2]) * y[i];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float cv = quad_sum(cr[h]);
        if (lane % 4 == 0 && rl + 8 * h < valid) cvec[(size_t)obj * pp + r0 + rl + 8 * h] = cv;
      }
#pragma unroll
      for (int idx = 0; idx < 32; ++idx) {
        const float sc = inv[idx % 2];
        pk[idx / 4][idx % 4] =
            pack_bf16(__bfloat162float(__float2bfloat16_rn(dy[2 * idx])) * sc,
                      __bfloat162float(__float2bfloat16_rn(dy[2 * idx + 1])) * sc);
      }
    } else {
#pragma unroll
      for (int idx = 0; idx < 32; ++idx) pk[idx / 4][idx % 4] = pack_bf16(dy[2 * idx], dy[2 * idx + 1]);
    }
    stage_store(xt, pk, dyh + row0 * kC, valid, c, t);
    __syncwarp();
    if (lane == 0) mbar_arrive(b.tempty + c);  // the tiles may take the next item's
  }
}

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
  static constexpr size_t qi_off = 0;                      // [2 slots][2 tiles]
  static constexpr size_t ring_off = qi_off + 4 * kQTile;
  static constexpr size_t bar_off = ring_off + kDvStages * stage_bytes;
  static constexpr size_t bytes = bar_off + sizeof(KeyBars) + 1024;
};

// dv_I = Σ_J G_JIᵀ·dŶ_J (rows I are keys i), written rounded; D_i = v_i·dv_i
// (f32) less Σ_j G[j, i]·c_j for OA
template <bool OA>
__global__ void __launch_bounds__(kThreads, 1)
dv_wgmma_kernel(const __grid_constant__ CUtensorMap qm, const __grid_constant__ CUtensorMap dym,
                const __grid_constant__ CUtensorMap cm, const float* __restrict__ lse2,
                const bf16* __restrict__ vrow, bf16* __restrict__ dv, float* __restrict__ dd,
                int o, int p, int pp) {
  using L = DvSmem;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  KeyBars& b = *reinterpret_cast<KeyBars*>(smem + L::bar_off);
  if (threadIdx.x == 0) b.init();
  __syncthreads();
  const Items work(p, o);
  const int c = threadIdx.x / 128, t = threadIdx.x % 128;

  if (c == 2) {
    if (t != 0) return;
    uint32_t n = 0, qn = 0;
    for (int it = blockIdx.x; it < work.items; it += gridDim.x, ++qn) {
      const int obj = it / work.pairs, r0 = (it % work.pairs) * 2 * kTile;
      const int qs = qn % 2;
      mbar_wait(b.qempty + qs, ((qn / 2) & 1u) ^ 1u);
      mbar_expect_tx(b.qfull + qs, 2 * kQTile);
      for (int h = 0; h < 2; ++h)
        tma_load_3d(smem + L::qi_off + (2 * qs + h) * kQTile, &qm, b.qfull + qs, 0,
                    r0 + h * kTile, obj);
      for (int c0 = 0; c0 < p; c0 += kTile, ++n) {
        const int st = DvRing::stage(n);
        unsigned char* sp = smem + L::ring_off + st * L::stage_bytes;
        mbar_wait(b.empty + st, DvRing::empty_parity(n));
        mbar_expect_tx(b.full + st, kRowTile + kQTile + (OA ? kVec : 0));
        tma_load_3d(sp, &dym, b.full + st, 0, c0, obj);
        tma_load_3d(sp + kBox, &dym, b.full + st, 64, c0, obj);
        tma_load_3d(sp + kRowTile, &qm, b.full + st, 0, c0, obj);
        if constexpr (OA) tma_load_2d(sp + kRowTile + kQTile, &cm, b.full + st, c0, obj);
      }
    }
    return;
  }

  const int warp = t / 32, lane = t % 32;
  const int rl = 16 * warp + lane / 4;
  uint32_t n = 0, qn = 0;
  for (int it = blockIdx.x; it < work.items; it += gridDim.x, ++qn) {
    const int obj = it / work.pairs, i0 = (it % work.pairs) * 2 * kTile + c * kTile;
    const int qs = qn % 2;
    const int valid = min(kTile, p - i0);
    float li[2];  // lse2 of this thread's two keys
#pragma unroll
    for (int h = 0; h < 2; ++h)
      li[h] = rl + 8 * h < valid ? lse2[(size_t)obj * pp + i0 + rl + 8 * h] : 0.f;
    mbar_wait(b.qfull + qs, (qn / 2) & 1u);
    const unsigned char* qi = smem + L::qi_off + (2 * qs + c) * kQTile;
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
        wgmma_m64n64k16_rs_t<1>(dv0, a[kk], desc_mn(sp, kSw128, 16 * kk, kBox), (c0 | kk) != 0);
        wgmma_m64n64k16_rs_t<1>(dv1, a[kk], desc_mn(sp + kBox, kSw128, 16 * kk, kBox),
                                (c0 | kk) != 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv0);
      fence_regs(dv1);
      if (lane == 0) mbar_arrive(b.empty + st);
    }
    // write dv rounded; D_i = Σ_c dv[i, c]·v[i, c] (f32) − Σ_j G[j, i]·c_j
    float d[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 64; i += 2) {
      const float* part = i < 32 ? dv0 : dv1;
      const int ii = i % 32, h = (ii / 2) % 2;
      const int row = rl + 8 * h, col = 64 * (i / 32) + acc_col(lane, ii);
      if (row < valid) {
        const size_t at = ((size_t)obj * p + i0 + row) * kC + col;
        const __nv_bfloat162 v2 = *reinterpret_cast<const __nv_bfloat162*>(vrow + at);
        d[h] = fmaf(part[ii], __bfloat162float(v2.x), d[h]);
        d[h] = fmaf(part[ii + 1], __bfloat162float(v2.y), d[h]);
        *reinterpret_cast<uint32_t*>(dv + at) = pack_bf16(part[ii], part[ii + 1]);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float dh = quad_sum(d[h]);
      if constexpr (OA) dh -= quad_sum(gc[h]);
      if (lane % 4 == 0 && rl + 8 * h < valid) dd[(size_t)obj * pp + i0 + rl + 8 * h] = dh;
    }
  }
}

// ---------------------------------- pass dq ----------------------------------

constexpr int kDqStages = 3;
using DqRing = Ring<kDqStages>;

struct DqBars {
  uint64_t full[kDqStages], empty[kDqStages], ifull[2], iempty[2];
  __device__ void init() {
    for (int i = 0; i < kDqStages; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, 8);
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(ifull + i, 1);
      mbar_init(iempty + i, 4);
    }
    mbar_fence_init();
  }
};

struct DqSmem {
  // a tile's q, v, dŶ: 4 + 16 + 16 KB; a ring stage adds lse2, D, c
  static constexpr size_t tile_bytes = kQTile + 2 * kRowTile;
  static constexpr size_t stage_bytes = round1k(tile_bytes + 3 * kVec);
  static constexpr size_t it_off = 0;  // [2] the consumers' row tiles I
  static constexpr size_t ring_off = it_off + 2 * tile_bytes;
  static constexpr size_t bar_off = ring_off + kDqStages * stage_bytes;
  static constexpr size_t bytes = bar_off + sizeof(DqBars) + 1024;
};

// q, v, dŶ of rows r0.. (q first, then v's and dŶ's two boxes each)
__device__ __forceinline__ void load_qvd(unsigned char* dst, const CUtensorMap* qm,
                                         const CUtensorMap* vrm, const CUtensorMap* dym,
                                         uint64_t* bar, int r0, int obj) {
  tma_load_3d(dst, qm, bar, 0, r0, obj);
  tma_load_3d(dst + kQTile, vrm, bar, 0, r0, obj);
  tma_load_3d(dst + kQTile + kBox, vrm, bar, 64, r0, obj);
  tma_load_3d(dst + kQTile + kRowTile, dym, bar, 0, r0, obj);
  tma_load_3d(dst + kQTile + kRowTile + kBox, dym, bar, 64, r0, obj);
}

// P = A·Bᵀ [64, 64] over 128 channels, A and B [64 rows, 128] row tiles
// (two boxes each), started, not waited
__device__ __forceinline__ void start_dp(float (&d)[32], const unsigned char* a,
                                         const unsigned char* b) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    wgmma_m64n64k16_ss(d, desc(a + (kk / 4) * kBox, kSw128, (kk % 4) * 32),
                       desc(b + (kk / 4) * kBox, kSw128, (kk % 4) * 32), kk != 0);
  wgmma_commit();
}

// dq_I = Σ_J F_IJ·q_J, F the (I, J) tile of dE + dEᵀ
template <bool OA>
__global__ void __launch_bounds__(kThreads, 1)
dq_wgmma_kernel(const __grid_constant__ CUtensorMap qm, const __grid_constant__ CUtensorMap vrm,
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
  const Items work(p, o);
  const int c = threadIdx.x / 128, t = threadIdx.x % 128;

  if (c == 2) {
    if (t != 0) return;
    uint32_t n = 0, qn = 0;
    for (int it = blockIdx.x; it < work.items; it += gridDim.x, ++qn) {
      const int obj = it / work.pairs, r0 = (it % work.pairs) * 2 * kTile;
      for (int h = 0; h < 2; ++h) {
        mbar_wait(b.iempty + h, (qn & 1u) ^ 1u);
        mbar_expect_tx(b.ifull + h, (uint32_t)L::tile_bytes);
        load_qvd(smem + L::it_off + h * L::tile_bytes, &qm, &vrm, &dym, b.ifull + h,
                 r0 + h * kTile, obj);
      }
      for (int c0 = 0; c0 < p; c0 += kTile, ++n) {
        const int st = DqRing::stage(n);
        unsigned char* sp = smem + L::ring_off + st * L::stage_bytes;
        mbar_wait(b.empty + st, DqRing::empty_parity(n));
        mbar_expect_tx(b.full + st, (uint32_t)L::tile_bytes + (OA ? 3 : 2) * kVec);
        load_qvd(sp, &qm, &vrm, &dym, b.full + st, c0, obj);
        tma_load_2d(sp + L::tile_bytes, &lm, b.full + st, c0, obj);
        tma_load_2d(sp + L::tile_bytes + kVec, &dm, b.full + st, c0, obj);
        if constexpr (OA) tma_load_2d(sp + L::tile_bytes + 2 * kVec, &cm, b.full + st, c0, obj);
      }
    }
    return;
  }

  const int warp = t / 32, lane = t % 32;
  const int rl = 16 * warp + lane / 4;
  const unsigned char* ti = smem + L::it_off + c * L::tile_bytes;
  uint32_t n = 0, qn = 0;
  for (int it = blockIdx.x; it < work.items; it += gridDim.x, ++qn) {
    const int obj = it / work.pairs, i0 = (it % work.pairs) * 2 * kTile + c * kTile;
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
    mbar_wait(b.ifull + c, qn & 1u);
    float dqa[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) dqa[i] = 0.f;
    for (int c0 = 0; c0 < p; c0 += kTile, ++n) {
      const int st = DqRing::stage(n);
      const unsigned char* sp = smem + L::ring_off + st * L::stage_bytes;
      const float* lj = reinterpret_cast<const float*>(sp + L::tile_bytes);
      const float* dj = lj + kTile;
      const float* cj = lj + 2 * kTile;
      mbar_wait(b.full + st, DqRing::full_parity(n));
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
        wgmma_m64n32k16_rs_t<1>(dqa, fa[kk], desc_mn(sp, kSw64, 16 * kk, 0), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dqa);
      if (lane == 0) {
        mbar_arrive(b.empty + st);
        if (c0 + kTile >= p) mbar_arrive(b.iempty + c);
      }
    }
#pragma unroll
    for (int i = 0; i < 16; i += 2) {
      const int row = acc_row(warp, lane, i), col = acc_col(lane, i);
      if (row < valid)
        *reinterpret_cast<uint32_t*>(dq + ((size_t)obj * p + i0 + row) * kDa + col) =
            pack_bf16(dqa[i], dqa[i + 1]);
    }
  }
}

// ---------------------------------- pass dx ----------------------------------

// even: tile k goes to consumer k % 2 and to stage k % kDxStages, so each
// stage serves one consumer, which then waits on every phase of it (a
// parity wait cannot tell phase n from phase n + 2)
constexpr int kDxStages = 4;
static_assert(kDxStages % 2 == 0, "each dx stage must serve one consumer");
using DxRing = Ring<kDxStages>;

struct DxSmem {
  static constexpr size_t wq_off = 0;                    // Wqk_s [128, 32], 64-byte rows
  static constexpr size_t wv_off = wq_off + 128 * kDa * 2;  // Wv: two [128, 64] boxes
  static constexpr size_t wt_off = wv_off + 2 * 128 * 64 * 2;
  static constexpr size_t stage_bytes = kQTile + 2 * kRowTile;  // dq, dv, dz tiles
  static constexpr size_t ring_off = wt_off + 2 * 128 * 64 * 2;
  static constexpr size_t bar_off = ring_off + kDxStages * stage_bytes;
  static constexpr size_t bytes = bar_off + (2 * kDxStages + 1) * 8 + 1024;
};

// dx = dq·Wqk_sᵀ + dv·Wvᵀ (+ dz·Wtᵀ with DU, the OA block's du) (+ the
// cotangent with RESID), rounded; flat 64-row tiles, the k-th tile of a
// block to consumer k % 2
template <bool RESID, bool DU>
__global__ void __launch_bounds__(kThreads, 1)
dx_wgmma_kernel(const __grid_constant__ CUtensorMap dqm, const __grid_constant__ CUtensorMap dvm,
                const __grid_constant__ CUtensorMap dzm, const __grid_constant__ CUtensorMap wqm,
                const __grid_constant__ CUtensorMap wvm, const __grid_constant__ CUtensorMap wtm,
                const bf16* __restrict__ dxn, bf16* __restrict__ dx, long long rows) {
  using L = DxSmem;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::bar_off);
  uint64_t* empty = full + kDxStages;
  uint64_t* wbar = empty + kDxStages;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kDxStages; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, 4);
    }
    mbar_init(wbar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  const long long tiles = (rows + kTile - 1) / kTile;
  const int c = threadIdx.x / 128, t = threadIdx.x % 128;

  if (c == 2) {
    if (t != 0) return;
    mbar_expect_tx(wbar, 128 * kDa * 2 + (DU ? 4 : 2) * 128 * 64 * 2);
    tma_load_2d(smem + L::wq_off, &wqm, wbar, 0, 0);
    tma_load_2d(smem + L::wv_off, &wvm, wbar, 0, 0);
    tma_load_2d(smem + L::wv_off + 128 * 64 * 2, &wvm, wbar, 64, 0);
    if constexpr (DU) {
      tma_load_2d(smem + L::wt_off, &wtm, wbar, 0, 0);
      tma_load_2d(smem + L::wt_off + 128 * 64 * 2, &wtm, wbar, 64, 0);
    }
    uint32_t k = 0;
    for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++k) {
      const int st = DxRing::stage(k);
      unsigned char* sp = smem + L::ring_off + st * L::stage_bytes;
      const int r0 = (int)(tile * kTile);
      mbar_wait(empty + st, DxRing::empty_parity(k));
      mbar_expect_tx(full + st, kQTile + (DU ? 2 : 1) * kRowTile);
      tma_load_2d(sp, &dqm, full + st, 0, r0);
      tma_load_2d(sp + kQTile, &dvm, full + st, 0, r0);
      tma_load_2d(sp + kQTile + kBox, &dvm, full + st, 64, r0);
      if constexpr (DU) {
        tma_load_2d(sp + kQTile + kRowTile, &dzm, full + st, 0, r0);
        tma_load_2d(sp + kQTile + kRowTile + kBox, &dzm, full + st, 64, r0);
      }
    }
    return;
  }

  const int warp = t / 32, lane = t % 32;
  mbar_wait(wbar, 0);
  uint32_t k = c;
  for (long long tile = blockIdx.x + (long long)c * gridDim.x; tile < tiles;
       tile += 2LL * gridDim.x, k += 2) {
    const int st = DxRing::stage(k);
    const unsigned char* sp = smem + L::ring_off + st * L::stage_bytes;
    mbar_wait(full + st, DxRing::full_parity(k));
    float acc[64];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
      wgmma_m64n128k16_ss(acc, desc(sp, kSw64, kk * 32), desc(smem + L::wq_off, kSw64, kk * 32),
                          kk != 0);
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      wgmma_m64n128k16_ss(acc, desc(sp + kQTile + (kk / 4) * kBox, kSw128, (kk % 4) * 32),
                          desc(smem + L::wv_off + (kk / 4) * 128 * 64 * 2, kSw128, (kk % 4) * 32),
                          1);
    if constexpr (DU) {
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        wgmma_m64n128k16_ss(
            acc, desc(sp + kQTile + kRowTile + (kk / 4) * kBox, kSw128, (kk % 4) * 32),
            desc(smem + L::wt_off + (kk / 4) * 128 * 64 * 2, kSw128, (kk % 4) * 32), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + st);
#pragma unroll
    for (int i = 0; i < 64; i += 2) {
      const long long row = tile * kTile + acc_row(warp, lane, i);
      const int col = acc_col(lane, i);
      if (row < rows) {
        float d0 = acc[i], d1 = acc[i + 1];
        if constexpr (RESID) {
          const __nv_bfloat162 r = *reinterpret_cast<const __nv_bfloat162*>(dxn + row * kC + col);
          d0 += __bfloat162float(r.x);
          d1 += __bfloat162float(r.y);
        }
        *reinterpret_cast<uint32_t*>(dx + row * kC + col) = pack_bf16(d0, d1);
      }
    }
  }
}

// ------------------------------ weight gradients -----------------------------

constexpr int kWgStages = 4;
using WgRing = Ring<kWgStages>;

template <int NB>
struct WgSmem {
  static constexpr size_t b_bytes = NB == 32 ? kQTile : (size_t)NB * kTile * 2;
  static constexpr size_t stage_bytes = kRowTile + b_bytes;  // A: two boxes; B
  static constexpr size_t ring_off = 0;
  static constexpr size_t bar_off = ring_off + kWgStages * stage_bytes;
  static constexpr size_t bytes = bar_off + 2 * kWgStages * 8 + 1024;
};

// out[m_off + m, n0 + n] = Σ_r A[r, m]·B[r, n0 + n] over the block's rows
// (A [R, 128], B [R, ·] row-major bf16; m < 128, n < NB), and with BIAS
// out_bias[n0 + n] = Σ_r B[r, n0 + n], into the block's scratch slice.
// Block b: column tile b % tiles_n, rows [split·rows_per, +rows_per) with
// split = b / tiles_n. Consumer warpgroup w owns m in [64w, 64w + 64): both
// operands are MN-major TMA boxes of the row-major tiles.
template <int NB, bool BIAS>
__global__ void __launch_bounds__(kThreads, 1)
wgrad_wgmma_kernel(const __grid_constant__ CUtensorMap am, const __grid_constant__ CUtensorMap bm,
                   float* __restrict__ scratch, long long slice, int ld, int m_off, int bias_off,
                   long long rows, long long rows_per, int tiles_n) {
  using L = WgSmem<NB>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::bar_off);
  uint64_t* empty = full + kWgStages;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kWgStages; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, 8);
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int n0 = (blockIdx.x % tiles_n) * NB;
  const long long lo = (long long)(blockIdx.x / tiles_n) * rows_per;
  const long long hi = min(rows, lo + rows_per);
  const int c = threadIdx.x / 128, t = threadIdx.x % 128;

  if (c == 2) {
    if (t != 0) return;
    uint32_t k = 0;
    for (long long r0 = lo; r0 < hi; r0 += kTile, ++k) {
      const int st = WgRing::stage(k);
      unsigned char* sp = smem + L::ring_off + st * L::stage_bytes;
      mbar_wait(empty + st, WgRing::empty_parity(k));
      mbar_expect_tx(full + st, (uint32_t)L::stage_bytes);
      tma_load_2d(sp, &am, full + st, 0, (int)r0);
      tma_load_2d(sp + kBox, &am, full + st, 64, (int)r0);
      if constexpr (NB == 32) {
        tma_load_2d(sp + kRowTile, &bm, full + st, n0, (int)r0);
      } else {
        for (int nb = 0; nb < NB / 64; ++nb)
          tma_load_2d(sp + kRowTile + nb * kBox, &bm, full + st, n0 + 64 * nb, (int)r0);
      }
    }
    return;
  }

  const int warp = t / 32, lane = t % 32;
  constexpr int R = NB / 2;  // accumulator floats per thread
  float acc[R], accb[BIAS ? R : 1];
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (BIAS ? R : 1); ++i) accb[i] = 0.f;
  const bool bias = BIAS && c == 0;
  const uint32_t one = pack_bf16(1.f, 1.f);
  const uint32_t ones[4] = {one, one, one, one};
  uint32_t k = 0;
  for (long long r0 = lo; r0 < hi; r0 += kTile, ++k) {
    const int st = WgRing::stage(k);
    const unsigned char* sp = smem + L::ring_off + st * L::stage_bytes;
    mbar_wait(full + st, WgRing::full_parity(k));
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t da = desc_mn(sp + c * kBox, kSw128, 16 * kk, 0);
      if constexpr (NB == 32) {
        wgmma_m64n32k16_ss_t<1, 1>(acc, da, desc_mn(sp + kRowTile, kSw64, 16 * kk, 0), 1);
      } else {
#pragma unroll
        for (int nb = 0; nb < NB / 64; ++nb) {
          const uint64_t db = desc_mn(sp + kRowTile + nb * kBox, kSw128, 16 * kk, 0);
          wgmma_m64n64k16_ss_t<1, 1>(acc + 32 * nb, da, db, 1);
          if (bias) wgmma_m64n64k16_rs_t<1>(accb + 32 * nb, ones, db, 1);
        }
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc<R>(acc);
    if constexpr (BIAS) fence_acc<R>(accb);
    if (lane == 0) mbar_arrive(empty + st);
  }
  float* out = scratch + (long long)(blockIdx.x / tiles_n) * slice;
#pragma unroll
  for (int i = 0; i < R; i += 2) {
    const int sub = NB == 32 ? i : i % 32;
    const int row = m_off + 64 * c + acc_row(warp, lane, sub);
    const int col = n0 + (NB == 32 ? 0 : 64 * (i / 32)) + acc_col(lane, sub);
    *reinterpret_cast<float2*>(out + (size_t)row * ld + col) = make_float2(acc[i], acc[i + 1]);
    if (bias && warp == 0 && lane < 4 && (sub / 2) % 2 == 0)
      *reinterpret_cast<float2*>(out + bias_off + col) = make_float2(accb[i], accb[i + 1]);
  }
}

// ---------------------------------- launch -----------------------------------

// the bf16 work buffer's pieces (256-byte aligned)
struct Work {
  bf16 *q, *vt, *v, *u, *dz, *dyh, *dv, *dq;
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
  r.dv = (bf16*)take(rows * kC * 2);
  r.dq = (bf16*)take(rows * kDa * 2);
  r.lse2 = (float*)take((size_t)o * pp * 4);
  r.dd = (float*)take((size_t)o * pp * 4);
  r.cv = (float*)take((size_t)o * pp * 4);
  return off;
}

// 3-D map of an [O, P, 128] bf16 activation: boxes of [64 rows, 64]
int map_rows3(CUtensorMap* m, const void* base, int o, int p) {
  const uint64_t dims[3] = {kC, (uint64_t)p, (uint64_t)o};
  const uint64_t strides[2] = {kC * 2, (uint64_t)p * kC * 2};
  const uint32_t box[3] = {64, kTile, 1};
  return make_map(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, base, dims, strides, box,
                  CU_TENSOR_MAP_SWIZZLE_128B);
}

// 2-D map of a row-major [rows, cols] bf16 matrix: boxes of [box_rows, 64]
// (128-byte swizzle) or, for cols = 32, [box_rows, 32] (64-byte)
int map_2d(CUtensorMap* m, const void* base, long long rows, int cols, int box_rows) {
  const uint64_t dims[2] = {(uint64_t)cols, (uint64_t)rows};
  const uint64_t strides[1] = {(uint64_t)cols * 2};
  const uint32_t box[2] = {cols == 32 ? 32u : 64u, (uint32_t)box_rows};
  return make_map(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, base, dims, strides, box,
                  cols == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B);
}

// 2-D map of an [O, pp] f32 row vector: boxes of 64
int map_vec(CUtensorMap* m, const float* base, int o, int p) {
  const uint64_t pp = (uint64_t)(p + 7) / 8 * 8;
  const uint64_t dims[2] = {(uint64_t)p, (uint64_t)o};
  const uint64_t strides[1] = {pp * 4};
  const uint32_t box[2] = {kTile, 1};
  return make_map(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, base, dims, strides, box,
                  CU_TENSOR_MAP_SWIZZLE_NONE);
}

}  // namespace

// Aᵀ·B over row ranges into per-split scratch slices (see wgrad_wgmma_kernel):
// A [rows, 128] (row stride lda: 128, or 256 for one half of a C = 256
// activation), B [rows, ldb] bf16; nb: 32 (ldb = 32), 64 (ldb = 64), 128 or
// 256 columns per block; grid tiles_n × splits
int launch_wgrad_sm90(const void* a, int lda, const void* bmat, int ldb, int nb, int bias,
                      long long rows, float* scratch, long long slice, int ld, int m_off,
                      int bias_off, int splits, cudaStream_t st) {
  CUtensorMap am, bm;
  {
    const uint64_t dims[2] = {kC, (uint64_t)rows};
    const uint64_t strides[1] = {(uint64_t)lda * 2};
    const uint32_t box[2] = {64, kTile};
    if (int rc = make_map(&am, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, a, dims, strides, box,
                          CU_TENSOR_MAP_SWIZZLE_128B))
      return rc;
  }
  if (int rc = map_2d(&bm, bmat, rows, ldb, kTile)) return rc;
  const int tiles_n = nb == 32 ? 1 : ldb / nb;
  long long per = (rows + splits - 1) / splits;
  per = (per + kTile - 1) / kTile * kTile;
  const unsigned grid = (unsigned)(tiles_n * splits);
#define SGA_WGRAD(NB, BIAS)                                                                   \
  {                                                                                           \
    auto kernel = wgrad_wgmma_kernel<NB, BIAS>;                                               \
    if (int rc = allow_smem(kernel, WgSmem<NB>::bytes)) return rc;                            \
    kernel<<<grid, kThreads, WgSmem<NB>::bytes, st>>>(am, bm, scratch, slice, ld, m_off,      \
                                                      bias_off, rows, per, tiles_n);          \
    return (int)cudaGetLastError();                                                           \
  }
  if (nb == 32) SGA_WGRAD(32, false);
  if (nb == 64) SGA_WGRAD(64, false);
  if (nb == 128) {
    if (bias) SGA_WGRAD(128, true);
    SGA_WGRAD(128, false);
  }
  SGA_WGRAD(256, false);
#undef SGA_WGRAD
}

size_t block_bwd_work_bytes_sm90(int o, int p) { return carve(nullptr, o, p, nullptr); }

// The bf16 backwards. kind 0: pct_block_res_bwd (cot = dxn, with wbn, bbn,
// dsum, dsumsq); 1: pct_block_bwd (cot = dt, with dsum, dsumsq); 2:
// pct_attn_bwd (cot = dY; wt, bt, mask unused). grads: kBwdGrad floats
// (kind 2: the first kOffDwt); scratch: `blocks` slices of
// slice_stride(kBwdGrad) floats
int launch_block_bwd_sm90(int kind, const void* x, const void* wqk, const void* wv,
                          const void* bv, const void* wt, const void* bt, const void* mask,
                          const void* cot, const float* wbn, const float* bbn, const float* dsum,
                          const float* dsumsq, void* work, void* dx, float* scratch, int blocks,
                          float* grads, int o, int p, int oa, cudaStream_t st) {
  // stage_transposed reads the weights in 16-byte vectors
  if (kind != 2 && ((uintptr_t)wt & 15)) return (int)cudaErrorMisalignedAddress;
  Work w;
  carve(work, o, p, &w);
  const int pp = (p + 7) / 8 * 8;
  const long long rows = (long long)o * p;
  CUtensorMap xm, qm, vm, lm;
  if (int rc = launch_project_lse_sm90(x, wqk, wv, bv, w.q, w.vt, w.v, w.lse2, o, p, &xm, &qm,
                                       &vm, &lm, st))
    return rc;
  CUtensorMap gm, dym, vrm, dm, cm, wtm{};
  if (int rc = map_rows3(&gm, cot, o, p)) return rc;
  if (int rc = map_rows3(&vrm, w.v, o, p)) return rc;
  if (int rc = map_vec(&dm, w.dd, o, p)) return rc;
  if (int rc = map_vec(&cm, w.cv, o, p)) return rc;
  if (kind != 2)
    if (int rc = map_2d(&wtm, wt, kC, kC, kC)) return rc;
  int dev = 0, sms = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long items = (long long)o * (((p + kTile - 1) / kTile + 1) / 2);
  const int grid = (int)(items < sms ? items : sms);

  // dz: u, dz, dŶ (and OA's c); the attention op's SA backward has dŶ = dY
  const bf16* dyh = w.dyh;
  auto dz_launch = [&](auto kernel) -> int {
    if (int rc = allow_smem(kernel, DzSmem::bytes)) return rc;
    kernel<<<grid, kThreads, DzSmem::bytes, st>>>(
        qm, vm, lm, xm, gm, wtm, (const bf16*)wt, (const bf16*)bt, (const bf16*)mask, wbn, bbn,
        dsum, dsumsq, w.u, w.dz, w.dyh, w.cv, o, p, pp);
    return (int)cudaGetLastError();
  };
  int rc = 0;
  if (kind == 0)
    rc = oa ? dz_launch(dz_wgmma_kernel<true, true, false>)
            : dz_launch(dz_wgmma_kernel<true, false, false>);
  else if (kind == 1)
    rc = oa ? dz_launch(dz_wgmma_kernel<false, true, false>)
            : dz_launch(dz_wgmma_kernel<false, false, false>);
  else if (oa)
    rc = dz_launch(dz_wgmma_kernel<false, true, true>);
  else
    dyh = (const bf16*)cot;
  if (rc) return rc;
  if (int rc2 = map_rows3(&dym, dyh, o, p)) return rc2;

  auto dv_kernel = oa ? dv_wgmma_kernel<true> : dv_wgmma_kernel<false>;
  if (int rc2 = allow_smem(dv_kernel, DvSmem::bytes)) return rc2;
  dv_kernel<<<grid, kThreads, DvSmem::bytes, st>>>(qm, dym, cm, w.lse2, w.v, w.dv, w.dd, o, p,
                                                   pp);
  if (int rc2 = (int)cudaGetLastError()) return rc2;

  auto dq_kernel = oa ? dq_wgmma_kernel<true> : dq_wgmma_kernel<false>;
  if (int rc2 = allow_smem(dq_kernel, DqSmem::bytes)) return rc2;
  dq_kernel<<<grid, kThreads, DqSmem::bytes, st>>>(qm, vrm, dym, lm, dm, cm, w.lse2, w.dd, w.cv,
                                                   w.dq, o, p, pp);
  if (int rc2 = (int)cudaGetLastError()) return rc2;

  CUtensorMap dqm, dvm, dzm, wqm, wvm;
  if (int rc2 = map_2d(&dqm, w.dq, rows, kDa, kTile)) return rc2;
  if (int rc2 = map_2d(&dvm, w.dv, rows, kC, kTile)) return rc2;
  if (int rc2 = map_2d(&dzm, w.dz, rows, kC, kTile)) return rc2;
  if (int rc2 = map_2d(&wqm, wqk, kC, kDa, kC)) return rc2;
  if (int rc2 = map_2d(&wvm, wv, kC, kC, kC)) return rc2;
  if (kind == 2) wtm = wvm;  // unused
  const long long tiles = (rows + kTile - 1) / kTile;
  const int gx = (int)(tiles < sms ? tiles : sms);
  auto dx_launch = [&](auto kernel) -> int {
    if (int rc3 = allow_smem(kernel, DxSmem::bytes)) return rc3;
    kernel<<<gx, kThreads, DxSmem::bytes, st>>>(dqm, dvm, dzm, wqm, wvm, wtm, (const bf16*)cot,
                                                (bf16*)dx, rows);
    return (int)cudaGetLastError();
  };
  if (kind == 0)
    rc = oa ? dx_launch(dx_wgmma_kernel<true, true>) : dx_launch(dx_wgmma_kernel<true, false>);
  else if (kind == 1)
    rc = oa ? dx_launch(dx_wgmma_kernel<false, true>) : dx_launch(dx_wgmma_kernel<false, false>);
  else
    rc = dx_launch(dx_wgmma_kernel<false, false>);
  if (rc) return rc;

  const long long slice = slice_stride(kBwdGrad);
  if (int rc2 = launch_wgrad_sm90(x, kC, w.dq, kDa, 32, 0, rows, scratch + kOffDwqk, slice, kDa,
                                  0, 0, blocks, st))
    return rc2;
  if (int rc2 = launch_wgrad_sm90(x, kC, w.dv, kC, 128, 1, rows, scratch + kOffDwv, slice, kC, 0,
                                  kOffDbv - kOffDwv, blocks, st))
    return rc2;
  if (kind != 2)
    if (int rc2 = launch_wgrad_sm90(w.u, kC, w.dz, kC, 128, 1, rows, scratch + kOffDwt, slice, kC,
                                    0, kOffDbt - kOffDwt, blocks, st))
      return rc2;
  return reduce_slices(scratch, slice, blocks, grads, kind == 2 ? kOffDwt : kBwdGrad, st);
}

}  // namespace sga
