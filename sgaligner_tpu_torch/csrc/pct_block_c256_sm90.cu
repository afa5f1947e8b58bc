// PCT SA / OA block at C = 256, da = 64, bf16: the wgmma design of
// pct_block_eval, of the training forward pct_block_fwd and of the attention
// op's forward pct_attn_fwd at FullPCT's width (pct_attention_c256.cu holds
// their C entry points and f32 forms).
//
// Replaces sgaligner_tpu/ops/pct_attention.py::pct_block_eval (Pallas kernel
// _block_eval_kernel), ::pct_block_fused's forward (_block_fwd_kernel) and
// ::pct_attention_fused's forward (_fwd_kernel) for bf16 inputs of 256
// channels.
//   Bound on the H100: operations on the tensor cores, 2·P·C·(da + C) +
//   2·P²·da + 2·P²·C + 2·P·C² = 117 MFLOP per object at P = C = 256 (30 µs
//   at O = 256); the exponentials (P² per object and pass) are a few µs.
//   Design: pct_block_eval_sm90.cu's three launches, widened. What changes
//   at C = 256 is room: Wv and Wt are 128 KB each, a vᵀ chunk of 64 keys
//   32 KB, and y = G·v [64, 256] f32 would be 128 registers a thread.
//     1. project: two warpgroups a block (q and v's first 128 channels,
//        then v's last 128), one block an SM; Wqk and Wv resident (160 KB,
//        by TMA as they lie: row-major W is the MN-major B operand of x·W),
//        two x tiles by TMA; q, vᵀ [O, 256, Pp] (Pp = P rounded up to 8)
//        and, for the backward, v row-major leave through the consumed x
//        tile (vᵀ in a 16-byte-chunk XOR swizzle) in 16-byte rows;
//     2. lse: as at C = 128 with 128-byte q rows (four k-steps);
//     3. apply: a work item is one 64-row tile, and its two consumer
//        warpgroups split the channels: warpgroup c owns y[:, 128c..+128]
//        (64 registers, as at C = 128). Both compute the same S and G (the
//        exponentials twice, which is cheap here) from one key ring of two
//        stages (q_J, vᵀ_J, lse_J: 41 KB), and each multiplies G by its half
//        of vᵀ_J (wgmma m64n128k16, G the register A operand). The epilogue
//        writes each half of u into one shared row tile (over x, whose words
//        each thread first keeps in registers), and each warpgroup forms its
//        half of t = u·Wt from that tile against Wt streamed through a ring
//        of two 32-column slices per warpgroup (16 KB each, TMA by a second
//        producer thread so that the weights never wait for the keys); then
//        the epilogue (x + relu(t·wbn + bbn), or t and the masked BN sums,
//        or for the attention op y, OA y/s, with no Wt and no u) goes back
//        into the tile and out in 16-byte rows. 384 threads: the producer
//        warpgroup gives its registers to the consumers by setmaxnreg (y,
//        S, G and the epilogue's operands would spill at 168 a thread).
//   Every layout is checked against the 232,448 bytes a block may have. BN
//   sums go to one slice per block (each warpgroup its 128 channels) that
//   reduce_slices adds in block order: no atomics, the same bits twice.
#include "pct_c256_sm90.cuh"

namespace sga {
namespace {

using namespace c256;

// ------------------------------ pass 1: project ------------------------------

struct ProjSmem {
  static constexpr size_t wq_off = 0;                 // Wqk [256 k, 64 n]
  static constexpr size_t wv_off = wq_off + kWBox;    // Wv: four [256 k, 64 n] boxes
  static constexpr size_t x_off = wv_off + 4 * kWBox;  // two x tiles (vᵀ, v staging)
  static constexpr size_t bar_off = x_off + 2 * kRowTile;
  static constexpr size_t bytes = bar_off + 3 * 8 + 1024;
};
static_assert(ProjSmem::bytes <= kSmemMax, "project: shared memory");

// element (c, r) of vᵀ staged [256, 64]: 16-byte chunks XOR-swizzled by c
__device__ __forceinline__ int vt_at(int c, int r) {
  return c * 64 + (((r / 8) ^ (c % 8)) * 8) + r % 8;
}

// acc[b] = x·W_b [64, 64] over 256 k for NB consecutive [256 k, 64 n]
// weight boxes from w (MN-major, 128-byte swizzle), waited
template <int NB>
__device__ __forceinline__ void x_times_boxes(float (&acc)[3][32], const unsigned char* xa,
                                              const unsigned char* w) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 16; ++kk) {
    const uint64_t a = desc(xa + (kk / 4) * kBox, kSw128, (kk % 4) * 32);
#pragma unroll
    for (int b = 0; b < NB; ++b)
      wgmma_m64n64k16_ss_t<0, 1>(acc[b], a, desc_mn(w + b * kWBox, kSw128, 16 * kk, 0), kk != 0);
  }
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int b = 0; b < NB; ++b) fence_regs(acc[b]);
}

// q = x·Wqk and v = x·Wv + bv (rounded) of 64-row tiles; v written
// transposed, vt[obj, c, r], and where vrow is not null row-major too.
// Two warpgroups on one tile: warpgroup 0 forms q and v's channels 0..127,
// warpgroup 1 v's channels 128..255 (96 and 64 accumulators a thread)
__global__ void __launch_bounds__(256, 1)
project256_wgmma_kernel(const __grid_constant__ CUtensorMap xm,
                        const __grid_constant__ CUtensorMap wqm,
                        const __grid_constant__ CUtensorMap wvm, const bf16* __restrict__ bv,
                        bf16* __restrict__ q, bf16* __restrict__ vt, bf16* __restrict__ vrow,
                        int o, int p, int pp) {
  using L = ProjSmem;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::bar_off);
  uint64_t* wbar = full + 2;
  const int c = threadIdx.x / 128, t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int rl = 16 * warp + lane / 4;
  const int per_obj = (p + kTile - 1) / kTile;
  const int tiles = o * per_obj;
  if (threadIdx.x == 0) {
    mbar_init(full, 1);
    mbar_init(full + 1, 1);
    mbar_init(wbar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(wbar, 5 * kWBox);
    tma_load_2d(smem + L::wq_off, &wqm, wbar, 0, 0);
    for (int s = 0; s < 4; ++s) tma_load_2d(smem + L::wv_off + s * kWBox, &wvm, wbar, 64 * s, 0);
    if ((int)blockIdx.x < tiles) {
      mbar_expect_tx(full, kRowTile);
      load_rows3(smem + L::x_off, &xm, full, blockIdx.x / per_obj, (blockIdx.x % per_obj) * kTile);
    }
  }
  mbar_wait(wbar, 0);
  // this warpgroup's [256 k, 64 n] weight boxes (0 = Wqk, 1 + s = Wv's
  // columns 64s..): boxes box0 .. box0 + nbox − 1, Wqk right before Wv
  const int box0 = c == 0 ? 0 : 3;
  const int nbox = c == 0 ? 3 : 2;
  int k = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++k) {
    const int buf = k % 2;
    const int next = tile + gridDim.x;
    // the other tile's last reader passed the closing barrier below
    if (threadIdx.x == 0 && next < tiles) {
      mbar_expect_tx(full + (buf ^ 1), kRowTile);
      load_rows3(smem + L::x_off + (buf ^ 1) * kRowTile, &xm, full + (buf ^ 1), next / per_obj,
                 (next % per_obj) * kTile);
    }
    mbar_wait(full + buf, (uint32_t)(k / 2) & 1u);
    unsigned char* xa = smem + L::x_off + buf * kRowTile;
    float acc[3][32];
    if (c == 0)
      x_times_boxes<3>(acc, xa, smem + L::wq_off);
    else
      x_times_boxes<2>(acc, xa, smem + L::wv_off + 2 * kWBox);

    const int obj = tile / per_obj, r0 = (tile % per_obj) * kTile;
    if (c == 0) {
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int row = r0 + rl + 8 * ((i / 2) % 2), col = acc_col(lane, i);
        if (row < p)
          *reinterpret_cast<uint32_t*>(q + ((size_t)obj * p + row) * kDa + col) =
              pack_bf16(acc[0][i], acc[0][i + 1]);
      }
    }
    __syncthreads();  // every product has read the x tile: it takes vᵀ
    // v box s (channels 64s..) is this warpgroup's acc[s + 1 − box0]
    bf16* vs = reinterpret_cast<bf16*>(xa);
#pragma unroll
    for (int b = 0; b < 3; ++b)
      if (b < nbox && box0 + b > 0)
#pragma unroll
        for (int i = 0; i < 32; i += 2) {
          const int row = rl + 8 * ((i / 2) % 2), col = 64 * (box0 + b - 1) + acc_col(lane, i);
          vs[vt_at(col, row)] = __float2bfloat16_rn(acc[b][i] + __bfloat162float(bv[col]));
          vs[vt_at(col + 1, row)] =
              __float2bfloat16_rn(acc[b][i + 1] + __bfloat162float(bv[col + 1]));
        }
    __syncthreads();
    bf16* vo = vt + (size_t)obj * kC * pp + r0;
    for (int idx = threadIdx.x; idx < kC * 8; idx += 256) {
      const int ch = idx % 8, cc = idx / 8;
      if (r0 + 8 * ch < p)
        *reinterpret_cast<uint4*>(vo + (size_t)cc * pp + 8 * ch) =
            *reinterpret_cast<const uint4*>(vs + cc * 64 + ((ch ^ (cc % 8)) * 8));
    }
    if (vrow != nullptr) {
      __syncthreads();
      uint32_t* xt = reinterpret_cast<uint32_t*>(xa);
#pragma unroll
      for (int b = 0; b < 3; ++b)
        if (b < nbox && box0 + b > 0)
#pragma unroll
          for (int i = 0; i < 32; i += 2) {
            const int row = rl + 8 * ((i / 2) % 2), col = 64 * (box0 + b - 1) + acc_col(lane, i);
            xt[x_word(row, col)] = pack_bf16(acc[b][i] + __bfloat162float(bv[col]),
                                             acc[b][i + 1] + __bfloat162float(bv[col + 1]));
          }
      __syncthreads();
      bf16* vro = vrow + ((size_t)obj * p + r0) * kC;
      for (int idx = threadIdx.x; idx < kTile * 32; idx += 256) {
        const int r = idx / 32, col = 8 * (idx % 32);
        if (r0 + r < p)
          *reinterpret_cast<uint4*>(vro + (size_t)r * kC + col) =
              *reinterpret_cast<const uint4*>(xt + x_word(r, col));
      }
    }
    __syncthreads();
  }
}

// -------------------------------- pass 2: lse --------------------------------

constexpr int kLseStages = 4;
using LseRing = Ring<kLseStages>;

// Work item `it` of the lse pass: object it / pairs, row tiles
// 2·(it % pairs) and the next one, one per consumer warpgroup (the second
// may lie past P: it computes, stores nothing)
struct Pairs {
  int pairs, items;
  __device__ Pairs(int p, int o) : pairs(((p + kTile - 1) / kTile + 1) / 2), items(o * pairs) {}
};

struct LseBars {
  uint64_t full[kLseStages], empty[kLseStages], qfull[2], qempty[2];
  __device__ void init() {
    for (int i = 0; i < kLseStages; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, 8);  // one arrival per consumer warp
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(qfull + i, 1);
      mbar_init(qempty + i, 8);
    }
    mbar_fence_init();
  }
};

struct LseSmem {
  static constexpr size_t qi_off = 0;                      // [2 slots][2 tiles]
  static constexpr size_t ring_off = qi_off + 4 * kQTile;
  static constexpr size_t bar_off = ring_off + kLseStages * kQTile;
  static constexpr size_t bytes = bar_off + sizeof(LseBars) + 1024;
};

// fold one chunk of S into this thread's online max m and sum l of its two
// rows (its 16 columns of each; kFull: all 64 keys of the chunk exist)
template <bool kFull>
__device__ __forceinline__ void lse_update(const float (&s)[32], int kv, int lane, float (&m)[2],
                                           float (&l)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float cm = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (kFull || 8 * j + 2 * (lane % 4) + e < kv) cm = fmaxf(cm, s[4 * j + 2 * h + e]);
    if (cm == -INFINITY) continue;
    const float nm = fmaxf(m[h], cm);
    const float nml = nm * kLog2e;
    float acc[2] = {l[h] * ex2(fmaf(m[h], kLog2e, -nml)), 0.f};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (kFull || 8 * j + 2 * (lane % 4) + e < kv)
          acc[e] += ex2(fmaf(s[4 * j + 2 * h + e], kLog2e, -nml));
    m[h] = nm;
    l[h] = acc[0] + acc[1];
  }
}

// lse2 [O, pp] f32: log2 Σ_j exp(E[i, j]) of every row i (keys j < P)
__global__ void __launch_bounds__(kThreads, 1)
lse256_wgmma_kernel(const __grid_constant__ CUtensorMap qm, float* __restrict__ lse2, int o,
                    int p, int pp) {
  using L = LseSmem;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  LseBars& b = *reinterpret_cast<LseBars*>(smem + L::bar_off);
  if (threadIdx.x == 0) b.init();
  __syncthreads();
  const Pairs work(p, o);
  const int c = threadIdx.x / 128, t = threadIdx.x % 128;  // c = 2: the producer warp

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
        const int st = LseRing::stage(n);
        mbar_wait(b.empty + st, LseRing::empty_parity(n));
        mbar_expect_tx(b.full + st, kQTile);
        tma_load_3d(smem + L::ring_off + st * kQTile, &qm, b.full + st, 0, c0, obj);
      }
    }
    return;
  }

  const int warp = t / 32, lane = t % 32;
  const int rl = 16 * warp + lane / 4;  // this thread's rows: rl and rl + 8
  const int nch = (p + kTile - 1) / kTile;
  uint32_t n = 0, qn = 0;
  for (int it = blockIdx.x; it < work.items; it += gridDim.x, ++qn) {
    const int obj = it / work.pairs, r0 = (it % work.pairs) * 2 * kTile + c * kTile;
    const int qs = qn % 2;
    mbar_wait(b.qfull + qs, (qn / 2) & 1u);
    const unsigned char* qi = smem + L::qi_off + (2 * qs + c) * kQTile;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    // S of chunk ch + 1 runs on the tensor cores while chunk ch's
    // exponentials run
    auto step = [&](float (&cur)[32], float (&nxt)[32], int ch) {
      const uint32_t nc = n + ch;
      if (ch + 1 < nch) {
        mbar_wait(b.full + LseRing::stage(nc + 1), LseRing::full_parity(nc + 1));
        start_energies(nxt, qi, smem + L::ring_off + LseRing::stage(nc + 1) * kQTile);
        wgmma_wait<1>();
      } else {
        wgmma_wait<0>();
      }
      fence_regs(cur);
      if (lane == 0) {
        mbar_arrive(b.empty + LseRing::stage(nc));
        if (ch + 1 == nch) mbar_arrive(b.qempty + qs);
      }
      const int kv = p - ch * kTile;
      if (kv >= kTile)
        lse_update<true>(cur, kv, lane, m, l);
      else
        lse_update<false>(cur, kv, lane, m, l);
    };
    float sa[32], sb[32];
    mbar_wait(b.full + LseRing::stage(n), LseRing::full_parity(n));
    start_energies(sa, qi, smem + L::ring_off + LseRing::stage(n) * kQTile);
    for (int ch = 0; ch < nch; ch += 2) {
      step(sa, sb, ch);
      if (ch + 1 < nch) step(sb, sa, ch + 1);
    }
    n += nch;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        const float m2 = __shfl_xor_sync(0xffffffffu, m[h], off);
        const float l2 = __shfl_xor_sync(0xffffffffu, l[h], off);
        const float mm = fmaxf(m[h], m2);
        l[h] = (m[h] == -INFINITY ? 0.f : l[h] * ex2((m[h] - mm) * kLog2e)) +
               (m2 == -INFINITY ? 0.f : l2 * ex2((m2 - mm) * kLog2e));
        m[h] = mm;
      }
      const int row = r0 + rl + 8 * h;
      if (lane % 4 == 0 && row < p) lse2[(size_t)obj * pp + row] = m[h] * kLog2e + log2f(l[h]);
    }
  }
}

// ------------------------------- pass 3: apply -------------------------------

constexpr int kKeyStages = 2;
using KeyRing = Ring<kKeyStages>;
constexpr long long kSumStride = slice_stride(2 * kC);  // a block's Σt, Σt²

struct ApplyBars {
  // the key ring; the q_I tile of an item (two slots); the x tile; each
  // warpgroup's two Wt slices (slot 2c + s)
  uint64_t full[kKeyStages], empty[kKeyStages], qfull[2], qempty[2], xfull, xempty, wfull[4],
      wempty[4];
  __device__ void init() {
    for (int i = 0; i < kKeyStages; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, 8);  // one arrival per consumer warp
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(qfull + i, 1);
      mbar_init(qempty + i, 8);
    }
    mbar_init(&xfull, 1);
    mbar_init(&xempty, 8);
    for (int i = 0; i < 4; ++i) {
      mbar_init(wfull + i, 1);
      mbar_init(wempty + i, 4);  // the slot's warpgroup
    }
    mbar_fence_init();
  }
};

struct ApplySmem {
  static constexpr size_t stage_bytes = round1k(kVtChunk + kQTile + kVec);  // vᵀ_J, q_J, lse_J
  static constexpr size_t ring_off = 0;
  static constexpr size_t qi_off = ring_off + kKeyStages * stage_bytes;  // two slots
  static constexpr size_t xu_off = qi_off + 2 * kQTile;  // x, u, then the output
  static constexpr size_t w_off = xu_off + kRowTile;     // four Wt slices
  static constexpr size_t vec_off = w_off + 4 * kWSlot;  // bt, wbn, bbn f32
  static constexpr size_t red_off = vec_off + 3 * kC * 4;  // training: [8 warps][256] sums
  static constexpr size_t bar_off = red_off + 8 * 256 * 4;
  static constexpr size_t bytes = bar_off + sizeof(ApplyBars) + 1024;
};
static_assert(ApplySmem::bytes <= kSmemMax, "apply: shared memory");

// The apply pass's epilogue, a compile-time choice:
// kEval: out = x + relu(round(t + bt)·wbn + bbn) (pct_block_eval).
// kTrain: out = t_out = round(u·Wt + bt) (pct_block_fwd) and the masked
//   channel sums Σ m·t, Σ m·t² into the block's scratch slice
//   (slice_stride(512) floats: Σt [256], Σt² [256]); SA loads no x tile.
// kAttn: out = y = round(Σ G·v) (SA) or round(y · 1/(1e-9 + s)) (OA), the
//   attention op pct_attn_fwd: no Wt, no x tile, no u·Wt product.
enum Epilogue { kEval, kTrain, kAttn };

// A warpgroup's four warp shares of its 128 channels' sums (red, [4][256]:
// store_column_sums's layout) added in warp order into the block's slice:
// Σt at 128c + t, Σt² at 256 + 128c + t
__device__ __forceinline__ void store_half_sums(const float* red, float* part, int c, int t) {
  const int rem = t % 16, k = 2 * (rem / 8) + rem % 2, ln = 4 * (t / 16) + (rem % 8) / 2;
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) sum += red[w * 256 + s * 128 + k * 32 + ln];
    part[s * kC + 128 * c + t] = sum;
  }
}

template <bool OA, Epilogue EPI>
__global__ void __launch_bounds__(kThreadsWide, 1)
apply256_wgmma_kernel(const __grid_constant__ CUtensorMap qm,
                      const __grid_constant__ CUtensorMap vm,
                      const __grid_constant__ CUtensorMap lm,
                      const __grid_constant__ CUtensorMap xm,
                      const __grid_constant__ CUtensorMap wtm, const bf16* __restrict__ bt,
                      const float* __restrict__ wbn, const float* __restrict__ bbn,
                      const bf16* __restrict__ mask, bf16* __restrict__ out,
                      float* __restrict__ scratch, int o, int p) {
  using L = ApplySmem;
  constexpr bool TRAIN = EPI == kTrain;
  constexpr bool kX = EPI == kEval || (TRAIN && OA);  // the epilogue reads x
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  ApplyBars& b = *reinterpret_cast<ApplyBars*>(smem + L::bar_off);
  float* vec = reinterpret_cast<float*>(smem + L::vec_off);
  float* red = reinterpret_cast<float*>(smem + L::red_off);

  if constexpr (EPI != kAttn) {
    for (int i = threadIdx.x; i < kC; i += blockDim.x) {
      vec[i] = __bfloat162float(bt[i]);
      if constexpr (EPI == kEval) {
        vec[kC + i] = wbn[i];
        vec[2 * kC + i] = bbn[i];
      }
    }
  }
  if constexpr (TRAIN)
    for (int i = threadIdx.x; i < 8 * 256; i += blockDim.x) red[i] = 0.f;
  if (threadIdx.x == 0) b.init();
  __syncthreads();
  const int per_obj = (p + kTile - 1) / kTile;
  const int items = o * per_obj;
  const int c = threadIdx.x / 128, t = threadIdx.x % 128;  // c = 2: the producer warpgroup

  if (c == 2) {
    reg_dealloc<kProducerRegs>();
    if (t == 0) {
      // the keys, the q_I tile and the x tile
      uint32_t n = 0, qn = 0;
      for (int it = blockIdx.x; it < items; it += gridDim.x, ++qn) {
        const int obj = it / per_obj, r0 = (it % per_obj) * kTile;
        const int qs = qn % 2;
        mbar_wait(b.qempty + qs, ((qn / 2) & 1u) ^ 1u);
        mbar_expect_tx(b.qfull + qs, kQTile);
        tma_load_3d(smem + L::qi_off + qs * kQTile, &qm, b.qfull + qs, 0, r0, obj);
        for (int c0 = 0; c0 < p; c0 += kTile, ++n) {
          const int st = KeyRing::stage(n);
          unsigned char* sp = smem + L::ring_off + st * L::stage_bytes;
          mbar_wait(b.empty + st, KeyRing::empty_parity(n));
          mbar_expect_tx(b.full + st, kVtChunk + kQTile + kVec);
          tma_load_3d(sp, &vm, b.full + st, c0, 0, obj);
          tma_load_3d(sp + kVtChunk, &qm, b.full + st, 0, c0, obj);
          tma_load_2d(sp + kVtChunk + kQTile, &lm, b.full + st, c0, obj);
        }
        if constexpr (kX) {
          // the previous item's output has left the tile by then
          mbar_wait(&b.xempty, (qn & 1u) ^ 1u);
          mbar_expect_tx(&b.xfull, kRowTile);
          load_rows3(smem + L::xu_off, &xm, &b.xfull, obj, r0);
        }
      }
    } else if (t == 1) {
      // Wt's 32-column slices: warpgroup h's k-th of an item is columns
      // 128h + 32k.., into its slot 2h + (count % 2)
      if constexpr (EPI != kAttn) {
        uint32_t wn = 0;
        for (int it = blockIdx.x; it < items; it += gridDim.x)
          for (int k = 0; k < 4; ++k, ++wn)
            for (int h = 0; h < 2; ++h) {
              const int slot = 2 * h + wn % 2;
              mbar_wait(b.wempty + slot, ((wn / 2) & 1u) ^ 1u);
              mbar_expect_tx(b.wfull + slot, kWSlot);
              tma_load_2d(smem + L::w_off + slot * kWSlot, &wtm, b.wfull + slot, 128 * h + 32 * k,
                          0);
            }
      }
    }
    return;
  }
  reg_alloc<kConsumerRegs>();

  const int warp = t / 32, lane = t % 32;
  const int rl = 16 * warp + lane / 4;  // this thread's rows: rl and rl + 8
  uint32_t* xu = reinterpret_cast<uint32_t*>(smem + L::xu_off);
  uint32_t n = 0, qn = 0, wn = 0;
  float y[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) y[i] = 0.f;

  for (int it = blockIdx.x; it < items; it += gridDim.x, ++qn) {
    const int obj = it / per_obj, r0 = (it % per_obj) * kTile;
    const int valid = min(kTile, p - r0);
    const int qs = qn % 2;
    mbar_wait(b.qfull + qs, (qn / 2) & 1u);
    const unsigned char* qi = smem + L::qi_off + qs * kQTile;
    float rs[2] = {0.f, 0.f};
    fence_regs(y);
    // y[:, 128c..] = Σ_J G_IJ·v_J[:, 128c..]: this warpgroup's half of vᵀ_J
    for (int c0 = 0; c0 < p; c0 += kTile, ++n) {
      const int st = KeyRing::stage(n);
      const unsigned char* sp = smem + L::ring_off + st * L::stage_bytes;
      const float* lse = reinterpret_cast<const float*>(sp + kVtChunk + kQTile);
      mbar_wait(b.full + st, KeyRing::full_parity(n));
      float s[32];
      start_energies(s, qi, sp + kVtChunk);
      wgmma_wait<0>();
      fence_regs(s);
      if (lane == 0 && c0 + kTile >= p) mbar_arrive(b.qempty + qs);
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
    }
    if constexpr (kX)
      mbar_wait(&b.xfull, qn & 1u);
    else
      bar_sync(2 + c, 128);  // this warpgroup's last rows have left its half of the tile

    if constexpr (EPI == kAttn) {
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const float sc = inv[j % 2];
        xu[half_word(c, rl, lane, j)] = pack_bf16(y[2 * j] * sc, y[2 * j + 1] * sc);
      }
    } else {
      // u = y (SA) or x − round(y/s) (OA), rounded, into this warpgroup's
      // half of the tile (over x, each word by the thread that read it)
      uint32_t xr[32];
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int w = half_word(c, rl, lane, j);
        if constexpr (kX) xr[j] = xu[w];
        const float y0 = y[2 * j], y1 = y[2 * j + 1];
        if constexpr (OA) {
          const uint32_t yr = pack_bf16(y0 * inv[j % 2], y1 * inv[j % 2]);
          xu[w] = pack_bf16(lo_bf16(xr[j]) - lo_bf16(yr), hi_bf16(xr[j]) - hi_bf16(yr));
        } else {
          xu[w] = pack_bf16(y0, y1);
        }
      }
      fence_proxy_async();
      bar_sync(1, 256);  // both halves of u in the tile
      // t[:, 128c + 32k..] = u·Wt[:, 128c + 32k..], four slices
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
      bar_sync(1, 256);  // both warpgroups' products have read u

      // element i of slice k is the tile's word half_word(c, rl, lane, 8k + i / 2)
      if constexpr (TRAIN) {
        // t = round(u·Wt + bt) into the tile; its masked column sums (rows
        // past P weigh 0) into this warp's share
        const float m = __bfloat162float(mask[obj]);
        const float mh[2] = {r0 + rl < p ? m : 0.f, r0 + rl + 8 < p ? m : 0.f};
        float s1[32], s2[32];
#pragma unroll
        for (int k = 0; k < 4; ++k)
#pragma unroll
          for (int g4 = 0; g4 < 4; ++g4) {
            const int g = 4 * k + g4, col = 128 * c + 8 * g + 2 * (lane % 4);
            uint32_t tw[2];
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              tw[h] = pack_bf16(tacc[k][4 * g4 + 2 * h] + vec[col],
                                tacc[k][4 * g4 + 2 * h + 1] + vec[col + 1]);
              xu[x_word(rl + 8 * h, col)] = tw[h];
            }
            row_pair_sums(tw, mh, s1 + 2 * g, s2 + 2 * g);
          }
        add_column_sums(red + (4 * c + warp) * 256, s1, s2, lane);
      } else {
        // out = x + relu(round(t + bt)·wbn + bbn)
#pragma unroll
        for (int k = 0; k < 4; ++k)
#pragma unroll
          for (int i = 0; i < 16; i += 2) {
            const int j = 8 * k + i / 2, col = 128 * c + 32 * k + acc_col(lane, i);
            float ov[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float tv = __bfloat162float(__float2bfloat16_rn(tacc[k][i + e] + vec[col + e]));
              const float z = tv * vec[kC + col + e] + vec[2 * kC + col + e];
              ov[e] = (e == 0 ? lo_bf16(xr[j]) : hi_bf16(xr[j])) + fmaxf(z, 0.f);
            }
            xu[half_word(c, rl, lane, j)] = pack_bf16(ov[0], ov[1]);
          }
      }
    }
    bar_sync(2 + c, 128);
    store_half(xu, out + ((size_t)obj * p + r0) * kC, valid, c, t);
    if constexpr (kX) {
      fence_proxy_async();  // the plain accesses to the tile before the next TMA into it
      __syncwarp();
      if (lane == 0) mbar_arrive(&b.xempty);  // the tile may take the next x
    }
  }
  if constexpr (TRAIN) {
    bar_sync(2 + c, 128);
    store_half_sums(red + 4 * c * 256, scratch + (size_t)blockIdx.x * kSumStride, c, t);
  }
}

// --------------------------------- launch ------------------------------------

// the map of Wt's 32-column slices [256 k, 32 n] (MN-major B of u·Wt)
int map_wt_cols(CUtensorMap* m, const void* wt) { return map_2d(m, wt, kC, kC, kC, kC, 32); }

// pct_block_eval, pct_block_fwd or pct_attn_fwd's apply pass
template <bool OA, Epilogue EPI>
int launch_apply(const CUtensorMap& qm, const CUtensorMap& vm, const CUtensorMap& lm,
                 const void* x, const void* wt, const void* bt, const float* wbn,
                 const float* bbn, const void* mask, void* out, float* scratch, int grid, int o,
                 int p, cudaStream_t st) {
  CUtensorMap xm{}, wtm{};
  if (EPI == kEval || (EPI == kTrain && OA))
    if (int rc = map_rows(&xm, x, o, p, kC)) return rc;
  if (EPI != kAttn)
    if (int rc = map_wt_cols(&wtm, wt)) return rc;
  auto kernel = apply256_wgmma_kernel<OA, EPI>;
  if (int rc = allow_smem(kernel, ApplySmem::bytes)) return rc;
  kernel<<<grid, kThreadsWide, ApplySmem::bytes, st>>>(qm, vm, lm, xm, wtm, (const bf16*)bt, wbn,
                                                       bbn, (const bf16*)mask, (bf16*)out,
                                                       scratch, o, p);
  return (int)cudaGetLastError();
}

long long tile_items(int o, int p) { return (long long)o * ((p + kTile - 1) / kTile); }

}  // namespace

// The projection and lse passes of the bf16 C = 256 block (here, and the
// backward's in pct_block_bwd_c256_sm90.cu): q [O, P, 64], vt [O, 256, pp]
// and, where vrow is not null, v row-major [O, P, 256]; lse2 [O, pp] (log2
// units). qm, vm, lm: the maps the later passes read q (boxes of 64 rows),
// vᵀ (boxes of 64 keys) and lse2 through
int launch_project_lse_c256_sm90(const void* x, const void* wqk, const void* wv, const void* bv,
                                 void* q, void* vt, void* vrow, float* lse2, int o, int p,
                                 CUtensorMap* qm, CUtensorMap* vm, CUtensorMap* lm,
                                 cudaStream_t st) {
  const int pp = (p + 7) / 8 * 8;
  {
    CUtensorMap xm, wqm, wvm;
    if (int rc = map_rows(&xm, x, o, p, kC)) return rc;
    if (int rc = map_2d(&wqm, wqk, kC, kDa, kDa, kC, 64)) return rc;
    if (int rc = map_2d(&wvm, wv, kC, kC, kC, kC, 64)) return rc;
    if (int rc = allow_smem(project256_wgmma_kernel, ProjSmem::bytes)) return rc;
    project256_wgmma_kernel<<<persistent_grid(tile_items(o, p)), 256, ProjSmem::bytes, st>>>(
        xm, wqm, wvm, (const bf16*)bv, (bf16*)q, (bf16*)vt, (bf16*)vrow, o, p, pp);
    if (int rc = (int)cudaGetLastError()) return rc;
  }
  if (int rc = map_rows(qm, q, o, p, kDa)) return rc;
  {
    const uint64_t dims[3] = {(uint64_t)p, kC, (uint64_t)o};
    const uint64_t strides[2] = {(uint64_t)pp * 2, (uint64_t)kC * pp * 2};
    const uint32_t box[3] = {kTile, kC, 1};
    if (int rc = make_map(vm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, vt, dims, strides, box,
                          CU_TENSOR_MAP_SWIZZLE_128B))
      return rc;
  }
  if (int rc = map_vec(lm, lse2, o, p)) return rc;
  if (int rc = allow_smem(lse256_wgmma_kernel, LseSmem::bytes)) return rc;
  const long long pairs = (long long)o * (((p + kTile - 1) / kTile + 1) / 2);
  lse256_wgmma_kernel<<<persistent_grid(pairs), kThreads, LseSmem::bytes, st>>>(*qm, lse2, o, p,
                                                                                pp);
  return (int)cudaGetLastError();
}

// bf16 pct_block_eval at C = 256: q [O, P, 64], vt [O, 256, pp], lse2
// [O, pp] work buffers (pp = P rounded up to a multiple of 8)
int launch_block_eval_c256_sm90(const void* x, const void* wqk, const void* wv, const void* bv,
                                const void* wt, const void* bt, const float* wbn,
                                const float* bbn, void* q, void* vt, float* lse2, void* out,
                                int o, int p, int oa, cudaStream_t st) {
  CUtensorMap qm, vm, lm;
  if (int rc = launch_project_lse_c256_sm90(x, wqk, wv, bv, q, vt, nullptr, lse2, o, p, &qm, &vm,
                                            &lm, st))
    return rc;
  const int grid = persistent_grid(tile_items(o, p));
  return oa ? launch_apply<true, kEval>(qm, vm, lm, x, wt, bt, wbn, bbn, nullptr, out, nullptr,
                                         grid, o, p, st)
            : launch_apply<false, kEval>(qm, vm, lm, x, wt, bt, wbn, bbn, nullptr, out, nullptr,
                                          grid, o, p, st);
}

// bf16 pct_block_fwd at C = 256: the eval block's passes, the apply pass
// with the training epilogue on `blocks` blocks, one scratch slice of
// slice_stride(512) floats each, which reduce_slices adds in order into
// sums [2, 256]. Work buffers as launch_block_eval_c256_sm90's
int launch_block_fwd_c256_sm90(const void* x, const void* wqk, const void* wv, const void* bv,
                               const void* wt, const void* bt, const void* mask, void* q,
                               void* vt, float* lse2, void* tout, float* scratch, int blocks,
                               float* sums, int o, int p, int oa, cudaStream_t st) {
  if (blocks < 1) return (int)cudaErrorInvalidValue;
  CUtensorMap qm, vm, lm;
  if (int rc = launch_project_lse_c256_sm90(x, wqk, wv, bv, q, vt, nullptr, lse2, o, p, &qm, &vm,
                                            &lm, st))
    return rc;
  const int rc = oa ? launch_apply<true, kTrain>(qm, vm, lm, x, wt, bt, nullptr, nullptr, mask,
                                                  tout, scratch, blocks, o, p, st)
                    : launch_apply<false, kTrain>(qm, vm, lm, x, wt, bt, nullptr, nullptr, mask,
                                                   tout, scratch, blocks, o, p, st);
  if (rc) return rc;
  return reduce_slices(scratch, kSumStride, blocks, sums, 2 * kC, st);
}

// bf16 pct_attn_fwd at C = 256: the projection and lse passes, then the
// apply pass with the attention epilogue, y [O, P, 256] (OA: divided by the
// row sums s). Work buffers as launch_block_eval_c256_sm90's
int launch_attn_fwd_c256_sm90(const void* x, const void* wqk, const void* wv, const void* bv,
                              void* q, void* vt, float* lse2, void* y, int o, int p, int oa,
                              cudaStream_t st) {
  CUtensorMap qm, vm, lm;
  if (int rc = launch_project_lse_c256_sm90(x, wqk, wv, bv, q, vt, nullptr, lse2, o, p, &qm, &vm,
                                            &lm, st))
    return rc;
  const int grid = persistent_grid(tile_items(o, p));
  return oa ? launch_apply<true, kAttn>(qm, vm, lm, x, nullptr, nullptr, nullptr, nullptr,
                                         nullptr, y, nullptr, grid, o, p, st)
            : launch_apply<false, kAttn>(qm, vm, lm, x, nullptr, nullptr, nullptr, nullptr,
                                          nullptr, y, nullptr, grid, o, p, st);
}

}  // namespace sga
