// PCT SA / OA block, bf16: the wgmma design of pct_block_eval and of the
// training forward pct_block_fwd (see pct_attention.cu for the functions and
// their f32 paths).
//
// Replaces sgaligner_tpu/ops/pct_attention.py::pct_block_eval (Pallas kernel
// _block_eval_kernel) for bf16 inputs: out = x + relu(t·wbn + bbn); and
// ::pct_block_fused (Pallas kernel _block_fwd_kernel): t_out = round(t) and
// the masked sums Σ m·t, Σ m·t² (f32).
//   Bound on the H100: operations on the tensor cores (126 MFLOP per object
//   at P = 512: 1.65 ms at O = 13,440), and beside them the exponentials:
//   the softmax normaliser runs over the key axis, so the design takes two
//   passes over E = q·qᵀ, 2·P²·O exponentials (7.0e9 at that O), about
//   1.8 ms on the special-function units. Each costs one FFMA and one ex2:
//   log2(e) is folded into the multiply-add, and the normaliser is kept in
//   log2 units.
//   Design: three launches over 64-row tiles; the lse and apply passes are
//   persistent, one block per SM, a producer warp and two consumer
//   warpgroups, the two warpgroups on neighbouring row tiles of one object
//   so that they share every key chunk:
//     1. project: q [O, P, 32] and vᵀ [O, 128, Pp] (Pp = P rounded up to 8,
//        so that the key axis is contiguous: the K-major B operand of G·v),
//        wgmma over x tiles arriving by TMA, Wqk and Wv resident;
//     2. lse: S = q_I·q_Jᵀ by wgmma m64n64k16 into registers, for each 64-key
//        chunk q_J arriving through a 4-stage TMA ring; per thread an online
//        max and sum of exponentials over its 16 columns of each of its two
//        rows, merged across the row's 4 lanes at the end (log2 units);
//     3. apply: for each key chunk (q_J, vᵀ_J and lse_J through a 4-stage TMA
//        ring): S by wgmma into registers, G = exp2(S·log2e − lse2_J) rounded
//        to bf16 in registers, where it is already the A fragment of
//        y += G·v_J (wgmma m64n128k16, A from registers); y ([64, 128] f32)
//        and OA's row sums stay in registers across all chunks. The epilogue
//        forms u = y or x − y/(1e-9 + s) (rounded as the f32 path rounds)
//        as the register A operand of t = u·Wt (Wt resident, transposed to
//        K-major), then out = x + relu(round(t + bt)·wbn + bbn), written over
//        the warpgroup's x tile (brought by TMA during the key loop) and
//        stored from there in 16-byte rows.
//   The training forward runs the same three passes; its apply pass's
//   epilogue (a compile-time variant) writes t through the staging tile
//   and takes the sums from the registers: per thread over its two rows
//   (rows past P weigh 0), over the 8 lanes of each column by shuffles,
//   into one shared-memory share per warp, and once per warpgroup into its
//   scratch slice, which reduce_slices adds in order (no atomics). SA's
//   training epilogue reads no x, so its x tile is not loaded.
//   Overlap: the lse pass starts S of the next chunk before this chunk's
//   exponentials. In the apply pass each warpgroup runs S, exponentials
//   and G·v of a chunk in turn; the two warpgroups overlap only as the
//   schedulers interleave them (explicit ping-pong and a second S in flight
//   were tried on the card and gained nothing at 168 registers a thread:
//   ptxas then serialises the wgmmas).
#include "common.cuh"
#include "hopper.cuh"

namespace sga {
namespace {

using namespace sm90;

constexpr int kC = 128;
constexpr int kDa = 32;
constexpr int kTile = 64;
constexpr int kThreads = 288;  // 2 consumer warpgroups + a producer warp
constexpr int kStages = 4;
constexpr float kLog2e = 1.4426950408889634f;

constexpr size_t kQTile = (size_t)kTile * kDa * 2;   // 4 KB, 64-byte rows
constexpr size_t kVTile = (size_t)kC * kTile * 2;    // 16 KB, vᵀ chunk [128, 64]
constexpr size_t kLseChunk = kTile * 4;              // 256 B
constexpr size_t kXTile = (size_t)kTile * kC * 2;    // 16 KB, x rows [64, 128]

using BlockRing = Ring<kStages>;

// ------------------------------ pass 1: project ------------------------------

struct ProjSmem {
  static constexpr size_t wv_off = 0;                         // Wvᵀ, two [128, 64] boxes
  static constexpr size_t wq_off = wv_off + 2 * kVTile;       // Wqkᵀ, two [32, 64] boxes
  static constexpr size_t x_off = wq_off + 2 * (size_t)kDa * 64 * 2;  // 2 x [two [64, 64] boxes]
  static constexpr size_t vs_off = x_off + 2 * 2 * (size_t)kTile * 64 * 2;
  static constexpr int ldvs = kTile + 8;                      // vᵀ staging row (bf16)
  static constexpr size_t vr_off = vs_off + (size_t)kC * ldvs * 2;  // row-major v staging
  static constexpr int ldvr = kC + 8;
  static constexpr size_t bar_off = vr_off + (size_t)kTile * ldvr * 2;
  static constexpr size_t bytes = bar_off + 2 * 8 + 1024;
};

// rows r0.. of object obj of x, as two [64, 64] boxes
__device__ __forceinline__ void load_x_tile(unsigned char* dst, const CUtensorMap* xm,
                                            uint64_t* bar, int obj, int r0) {
  mbar_expect_tx(bar, (uint32_t)(2 * kTile * 64 * 2));
  tma_load_3d(dst, xm, bar, 0, r0, obj);
  tma_load_3d(dst + kTile * 64 * 2, xm, bar, 64, r0, obj);
}

// q = x·Wqk and v = x·Wv + bv (rounded) of 64-row tiles, v written
// transposed: vt[obj, c, r] (and, where vrow is not null, row-major too).
// One warpgroup a block, two blocks an SM; the x tile arrives by TMA (next
// tile in flight during this one), the two products are wgmma m64n32k16
// and m64n128k16 over Wqkᵀ and Wvᵀ resident, and v leaves through padded
// shared tiles in 16-byte stores.
__global__ void __launch_bounds__(128)
project_wgmma_kernel(const __grid_constant__ CUtensorMap xm, const bf16* __restrict__ wqk,
                     const bf16* __restrict__ wv, const bf16* __restrict__ bv,
                     bf16* __restrict__ q, bf16* __restrict__ vt, bf16* __restrict__ vrow,
                     int o, int p, int pp) {
  using L = ProjSmem;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::bar_off);
  bf16* vs = reinterpret_cast<bf16*>(smem + L::vs_off);
  bf16* vr = reinterpret_cast<bf16*>(smem + L::vr_off);
  stage_transposed<kC, kC>(reinterpret_cast<bf16*>(smem + L::wv_off), wv);
  stage_transposed<kC, kDa>(reinterpret_cast<bf16*>(smem + L::wq_off), wqk);
  fence_proxy_async();
  if (threadIdx.x == 0) {
    mbar_init(full, 1);
    mbar_init(full + 1, 1);
    mbar_fence_init();
  }
  __syncthreads();

  const int per_obj = (p + kTile - 1) / kTile;
  const int tiles = o * per_obj;
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const int rl = 16 * warp + lane / 4;
  constexpr size_t xbuf = 2 * (size_t)kTile * 64 * 2;  // one tile: two [64, 64] boxes
  if (t == 0 && (int)blockIdx.x < tiles)
    load_x_tile(smem + L::x_off, &xm, full, blockIdx.x / per_obj, (blockIdx.x % per_obj) * kTile);
  int k = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++k) {
    const int buf = k % 2;
    const int next = tile + gridDim.x;
    if (t == 0 && next < tiles)
      load_x_tile(smem + L::x_off + (buf ^ 1) * xbuf, &xm, full + (buf ^ 1), next / per_obj,
                  (next % per_obj) * kTile);
    mbar_wait(full + buf, (uint32_t)(k / 2) & 1u);
    const unsigned char* xa = smem + L::x_off + buf * xbuf;
    float qa[16], va[64];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const unsigned char* a = xa + (kk / 4) * (xbuf / 2);
      const uint32_t kb = (kk % 4) * 32;
      wgmma_m64n32k16_ss(qa, desc(a, kSw128, kb),
                         desc(smem + L::wq_off + (kk / 4) * (kDa * 64 * 2), kSw128, kb), kk != 0);
      wgmma_m64n128k16_ss(va, desc(a, kSw128, kb),
                          desc(smem + L::wv_off + (kk / 4) * kVTile, kSw128, kb), kk != 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(qa);
    fence_regs(va);

    const int obj = tile / per_obj, r0 = (tile % per_obj) * kTile;
#pragma unroll
    for (int i = 0; i < 16; i += 2) {
      const int row = r0 + rl + 8 * ((i / 2) % 2), col = 8 * (i / 4) + 2 * (lane % 4);
      if (row < p)
        *reinterpret_cast<uint32_t*>(q + ((size_t)obj * p + row) * kDa + col) =
            pack_bf16(qa[i], qa[i + 1]);
    }
#pragma unroll
    for (int i = 0; i < 64; i += 2) {
      const int row = rl + 8 * ((i / 2) % 2), col = 8 * (i / 4) + 2 * (lane % 4);
      const bf16 v0 = __float2bfloat16_rn(va[i] + __bfloat162float(bv[col]));
      const bf16 v1 = __float2bfloat16_rn(va[i + 1] + __bfloat162float(bv[col + 1]));
      vs[col * L::ldvs + row] = v0;
      vs[(col + 1) * L::ldvs + row] = v1;
      if (vrow != nullptr) {
        __nv_bfloat162 pair;
        pair.x = v0;
        pair.y = v1;
        *reinterpret_cast<__nv_bfloat162*>(vr + row * L::ldvr + col) = pair;
      }
    }
    __syncthreads();
    if (vrow != nullptr) {
      bf16* vro = vrow + ((size_t)obj * p + r0) * kC;
      for (int idx = t; idx < kTile * (kC / 8); idx += 128) {
        const int r = idx / (kC / 8), chunk = idx % (kC / 8);
        if (r0 + r < p)
          *reinterpret_cast<uint4*>(vro + (size_t)r * kC + 8 * chunk) =
              *reinterpret_cast<const uint4*>(vr + r * L::ldvr + 8 * chunk);
      }
    }
    bf16* vo = vt + (size_t)obj * kC * pp + r0;
    for (int idx = t; idx < kC * (kTile / 8); idx += 128) {
      const int c = idx / (kTile / 8), chunk = idx % (kTile / 8);
      if (r0 + 8 * chunk < p)
        *reinterpret_cast<uint4*>(vo + (size_t)c * pp + 8 * chunk) =
            *reinterpret_cast<const uint4*>(vs + c * L::ldvs + 8 * chunk);
    }
    __syncthreads();
  }
}

// ------------------------- the persistent passes' frame ----------------------

// Work item `it`: object it / pairs, row tiles 2·(it % pairs) and the next
// one (the second consumer's rows may lie past P: it computes, stores
// nothing).
struct Items {
  int pairs, items;
  __device__ Items(int p, int o) : pairs(((p + kTile - 1) / kTile + 1) / 2), items(o * pairs) {}
};

struct Barriers {
  // the key ring; the q_I tiles of an item (two slots); the apply pass's
  // x tile of each consumer (its epilogue's input and output)
  uint64_t full[kStages], empty[kStages], qfull[2], qempty[2], xfull[2], xempty[2];
  __device__ void init() {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, 8);  // one arrival per consumer warp
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(qfull + i, 1);
      mbar_init(qempty + i, 8);
      mbar_init(xfull + i, 1);
      mbar_init(xempty + i, 4);
    }
    mbar_fence_init();
  }
};

// -------------------------------- pass 2: lse --------------------------------

// start S = q_I·q_Jᵀ on the tensor cores (no wait)
__device__ __forceinline__ void start_energies(float (&s)[32], const unsigned char* qi,
                                               const unsigned char* qj) {
  wgmma_fence();
  wgmma_m64n64k16_ss(s, desc(qi, kSw64, 0), desc(qj, kSw64, 0), 0);
  wgmma_m64n64k16_ss(s, desc(qi, kSw64, 32), desc(qj, kSw64, 32), 1);
  wgmma_commit();
}

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

struct LseSmem {
  static constexpr size_t qi_off = 0;                            // [2 slots][2 tiles]
  static constexpr size_t ring_off = qi_off + 4 * kQTile;
  static constexpr size_t bar_off = ring_off + kStages * kQTile;
  static constexpr size_t bytes = bar_off + sizeof(Barriers) + 1024;
};

// lse2 [O, pp] f32: log2 Σ_j exp(E[i, j]) of every row i (keys j < P)
__global__ void __launch_bounds__(kThreads, 1)
lse_wgmma_kernel(const __grid_constant__ CUtensorMap qm, float* __restrict__ lse2, int o, int p,
                 int pp) {
  using L = LseSmem;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  Barriers& b = *reinterpret_cast<Barriers*>(smem + L::bar_off);
  if (threadIdx.x == 0) b.init();
  __syncthreads();
  const Items work(p, o);
  const int c = threadIdx.x / 128, t = threadIdx.x % 128;  // c = 2: the producer warp

  if (c == 2) {
    if (t != 0) return;
    uint32_t n = 0, qn = 0;
    for (int it = blockIdx.x; it < work.items; it += gridDim.x, ++qn) {
      const int obj = it / work.pairs, r0 = (it % work.pairs) * 2 * kTile;
      const int qs = qn % 2;
      mbar_wait(b.qempty + qs, ((qn / 2) & 1u) ^ 1u);
      mbar_expect_tx(b.qfull + qs, (uint32_t)(2 * kQTile));
      for (int h = 0; h < 2; ++h)
        tma_load_3d(smem + L::qi_off + (2 * qs + h) * kQTile, &qm, b.qfull + qs, 0, r0 + h * kTile,
                    obj);
      for (int c0 = 0; c0 < p; c0 += kTile, ++n) {
        const int st = BlockRing::stage(n);
        mbar_wait(b.empty + st, BlockRing::empty_parity(n));
        mbar_expect_tx(b.full + st, (uint32_t)kQTile);
        tma_load_3d(smem + L::ring_off + st * kQTile, &qm, b.full + st, 0, c0, obj);
      }
    }
    return;
  }

  const int warp = t / 32, lane = t % 32;
  const int rl = 16 * warp + lane / 4;  // this thread's rows: rl and rl + 8
  uint32_t n = 0, qn = 0;
  for (int it = blockIdx.x; it < work.items; it += gridDim.x, ++qn) {
    const int obj = it / work.pairs, r0 = (it % work.pairs) * 2 * kTile + c * kTile;
    const int qs = qn % 2;
    mbar_wait(b.qfull + qs, (qn / 2) & 1u);
    const unsigned char* qi = smem + L::qi_off + (2 * qs + c) * kQTile;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    // S of chunk ch + 1 runs on the tensor cores while chunk ch's
    // exponentials run
    const int nch = (p + kTile - 1) / kTile;
    auto step = [&](float (&cur)[32], float (&nxt)[32], int ch) {
      const uint32_t nc = n + ch;
      if (ch + 1 < nch) {
        mbar_wait(b.full + BlockRing::stage(nc + 1), BlockRing::full_parity(nc + 1));
        start_energies(nxt, qi, smem + L::ring_off + BlockRing::stage(nc + 1) * kQTile);
        wgmma_wait<1>();
      } else {
        wgmma_wait<0>();
      }
      fence_regs(cur);
      if (lane == 0) {
        mbar_arrive(b.empty + BlockRing::stage(nc));
        if (ch + 1 == nch) mbar_arrive(b.qempty + qs);
      }
      const int kv = p - ch * kTile;
      if (kv >= kTile)
        lse_update<true>(cur, kv, lane, m, l);
      else
        lse_update<false>(cur, kv, lane, m, l);
    };
    float sa[32], sb[32];
    mbar_wait(b.full + BlockRing::stage(n), BlockRing::full_parity(n));
    start_energies(sa, qi, smem + L::ring_off + BlockRing::stage(n) * kQTile);
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

constexpr long long kSumStride = slice_stride(2 * kC);  // one warpgroup's Σt, Σt²

struct ApplySmem {
  static constexpr size_t stage_bytes = align128(kVTile + kQTile + kLseChunk + 1023) & ~size_t(1023);
  static constexpr size_t wt_off = 0;                            // Wtᵀ, two [128, 64] boxes
  static constexpr size_t qi_off = wt_off + 2 * kVTile;          // [2 slots][2 tiles]
  static constexpr size_t ring_off = qi_off + 4 * kQTile;        // stage: vᵀ, q_J, lse_J
  static constexpr size_t out_off = ring_off + kStages * stage_bytes;  // [2] x / out tiles
  static constexpr size_t vec_off = out_off + 2 * kXTile;    // bt, wbn, bbn f32
  static constexpr size_t red_off = vec_off + 3 * kC * 4;    // training: [8 warps][256] sums
  static constexpr size_t bar_off = red_off + 8 * 2 * kC * 4;
  static constexpr size_t bytes = bar_off + sizeof(Barriers) + 1024;
};

// TRAIN = false: out = x + relu(round(t + bt)·wbn + bbn) (pct_block_eval).
// TRAIN = true: out = t_out = round(u·Wt + bt) (pct_block_fwd), and the
// masked channel sums Σ m·t, Σ m·t² of each consumer warpgroup into its
// scratch slice 2·blockIdx + c (slice_stride(256) floats); SA then loads no
// x tile (its epilogue does not read x).
template <bool OA, bool TRAIN>
__global__ void __launch_bounds__(kThreads, 1)
apply_wgmma_kernel(const __grid_constant__ CUtensorMap qm, const __grid_constant__ CUtensorMap vm,
                   const __grid_constant__ CUtensorMap lm, const __grid_constant__ CUtensorMap xm,
                   const bf16* __restrict__ wt, const bf16* __restrict__ bt,
                   const float* __restrict__ wbn, const float* __restrict__ bbn,
                   const bf16* __restrict__ mask, bf16* __restrict__ out,
                   float* __restrict__ scratch, int o, int p) {
  using L = ApplySmem;
  constexpr bool kX = !TRAIN || OA;  // the epilogue reads the x tile
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  Barriers& b = *reinterpret_cast<Barriers*>(smem + L::bar_off);
  float* vec = reinterpret_cast<float*>(smem + L::vec_off);
  float* red = reinterpret_cast<float*>(smem + L::red_off);

  // Wtᵀ resident (the B operand of u·Wt); the epilogue vectors as f32
  stage_transposed<kC, kC>(reinterpret_cast<bf16*>(smem + L::wt_off), wt);
  for (int i = threadIdx.x; i < kC; i += blockDim.x) {
    vec[i] = __bfloat162float(bt[i]);
    if constexpr (!TRAIN) {
      vec[kC + i] = wbn[i];
      vec[2 * kC + i] = bbn[i];
    }
  }
  if constexpr (TRAIN)
    for (int i = threadIdx.x; i < 8 * 2 * kC; i += blockDim.x) red[i] = 0.f;
  fence_proxy_async();
  if (threadIdx.x == 0) b.init();
  __syncthreads();
  const Items work(p, o);
  const int c = threadIdx.x / 128, t = threadIdx.x % 128;  // c = 2: the producer warp

  if (c == 2) {
    if (t != 0) return;
    uint32_t n = 0, qn = 0;
    for (int it = blockIdx.x; it < work.items; it += gridDim.x, ++qn) {
      const int obj = it / work.pairs, r0 = (it % work.pairs) * 2 * kTile;
      const int qs = qn % 2;
      mbar_wait(b.qempty + qs, ((qn / 2) & 1u) ^ 1u);
      mbar_expect_tx(b.qfull + qs, (uint32_t)(2 * kQTile));
      for (int h = 0; h < 2; ++h)
        tma_load_3d(smem + L::qi_off + (2 * qs + h) * kQTile, &qm, b.qfull + qs, 0, r0 + h * kTile,
                    obj);
      for (int c0 = 0; c0 < p; c0 += kTile, ++n) {
        const int st = BlockRing::stage(n);
        unsigned char* sp = smem + L::ring_off + st * L::stage_bytes;
        mbar_wait(b.empty + st, BlockRing::empty_parity(n));
        mbar_expect_tx(b.full + st, (uint32_t)(kVTile + kQTile + kLseChunk));
        tma_load_3d(sp, &vm, b.full + st, c0, 0, obj);
        tma_load_3d(sp + kVTile, &qm, b.full + st, 0, c0, obj);
        tma_load_2d(sp + kVTile + kQTile, &lm, b.full + st, c0, obj);
      }
      // each consumer's x tile, for its epilogue (the previous item's
      // output has left the tile by then)
      for (int h = 0; h < 2 && kX; ++h) {
        unsigned char* xt = smem + L::out_off + h * kXTile;
        mbar_wait(b.xempty + h, (qn & 1u) ^ 1u);
        mbar_expect_tx(b.xfull + h, (uint32_t)kXTile);
        tma_load_3d(xt, &xm, b.xfull + h, 0, r0 + h * kTile, obj);
        tma_load_3d(xt + kXTile / 2, &xm, b.xfull + h, 64, r0 + h * kTile, obj);
      }
    }
    return;
  }

  const int warp = t / 32, lane = t % 32;
  const int rl = 16 * warp + lane / 4;  // this thread's rows: rl and rl + 8
  uint32_t n = 0, qn = 0;
  float y[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) y[i] = 0.f;

  for (int it = blockIdx.x; it < work.items; it += gridDim.x, ++qn) {
    const int obj = it / work.pairs, r0 = (it % work.pairs) * 2 * kTile + c * kTile;
    const int qs = qn % 2;
    mbar_wait(b.qfull + qs, (qn / 2) & 1u);
    const unsigned char* qi = smem + L::qi_off + (2 * qs + c) * kQTile;
    float rs[2] = {0.f, 0.f};
    fence_regs(y);
    for (int c0 = 0; c0 < p; c0 += kTile, ++n) {
      const int st = BlockRing::stage(n);
      const unsigned char* sp = smem + L::ring_off + st * L::stage_bytes;
      const float* lse = reinterpret_cast<const float*>(sp + kVTile + kQTile);
      mbar_wait(b.full + st, BlockRing::full_parity(n));
      float s[32];
      start_energies(s, qi, sp + kVTile);
      wgmma_wait<0>();
      fence_regs(s);
      if (lane == 0 && c0 + kTile >= p) mbar_arrive(b.qempty + qs);
      // G = exp2(S·log2e − lse2_J), rounded: the A fragments of y += G·v_J
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

    // u = y (SA) or x − y/(1e-9 + s) (OA), rounded as the f32 path rounds;
    // its accumulator columns 16kk.. are the A fragment of k-step kk of u·Wt
    float inv[2] = {1.f, 1.f};  // OA: 1 / (1e-9 + s) of the two rows
    if constexpr (OA) {
      inv[0] = 1.f / (1e-9f + quad_sum(rs[0]));
      inv[1] = 1.f / (1e-9f + quad_sum(rs[1]));
    }
    if constexpr (kX) mbar_wait(b.xfull + c, qn & 1u);
    uint32_t* xt = reinterpret_cast<uint32_t*>(smem + L::out_off + c * kXTile);
    uint32_t ua[8][4];
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int j = 2 * kk + r / 2, h = r % 2;  // column group, row half
        const float y0 = y[4 * j + 2 * h], y1 = y[4 * j + 2 * h + 1];
        if constexpr (OA) {
          const uint32_t xv = xt[x_word(rl + 8 * h, 8 * j + 2 * (lane % 4))];
          const uint32_t yr = pack_bf16(y0 * inv[h], y1 * inv[h]);
          ua[kk][r] = pack_bf16(lo_bf16(xv) - lo_bf16(yr), hi_bf16(xv) - hi_bf16(yr));
        } else {
          ua[kk][r] = pack_bf16(y0, y1);
        }
      }
    float tacc[64];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      wgmma_m64n128k16_rs(tacc, ua[kk], desc(smem + L::wt_off + (kk / 4) * kVTile, kSw128,
                                             (kk % 4) * 32),
                          kk != 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(tacc);

    if constexpr (TRAIN) {
      // t = round(u·Wt + bt), written over the tile; its masked column sums
      // (rows past P out: TMA zero-filled them) into this warp's share
      if constexpr (!kX) bar_sync(1 + c, 128);  // the last item's rows have left the tile
      const float m = __bfloat162float(mask[obj]);
      const float mh[2] = {r0 + rl < p ? m : 0.f, r0 + rl + 8 < p ? m : 0.f};
      float s1[32], s2[32];
#pragma unroll
      for (int g = 0; g < 16; ++g) {  // columns 8g + 2·(lane % 4) and + 1
        const int col = 8 * g + 2 * (lane % 4);
        uint32_t tw[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          tw[h] = pack_bf16(tacc[4 * g + 2 * h] + vec[col], tacc[4 * g + 2 * h + 1] + vec[col + 1]);
          xt[x_word(rl + 8 * h, col)] = tw[h];
        }
        row_pair_sums(tw, mh, s1 + 2 * g, s2 + 2 * g);
      }
      add_column_sums(red + (4 * c + warp) * 2 * kC, s1, s2, lane);
    } else {
      // out = x + relu(round(t + bt)·wbn + bbn), written over x in the tile
#pragma unroll
      for (int i = 0; i < 64; i += 2) {
        const int h = (i / 2) % 2, col = 8 * (i / 4) + 2 * (lane % 4);
        uint32_t& xo = xt[x_word(rl + 8 * h, col)];
        float ov[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float tv = __bfloat162float(__float2bfloat16_rn(tacc[i + e] + vec[col + e]));
          const float z = tv * vec[kC + col + e] + vec[2 * kC + col + e];
          ov[e] = (e == 0 ? lo_bf16(xo) : hi_bf16(xo)) + fmaxf(z, 0.f);
        }
        xo = pack_bf16(ov[0], ov[1]);
      }
    }
    // the tile to device memory in 16-byte rows
    bar_sync(1 + c, 128);
    for (int idx = t; idx < kTile * (kC / 8); idx += 128) {
      const int r = idx / (kC / 8), q = idx % (kC / 8);
      if (r0 + r < p)
        *reinterpret_cast<uint4*>(out + ((size_t)obj * p + r0 + r) * kC + 8 * q) =
            *reinterpret_cast<const uint4*>(xt + x_word(r, 8 * q));
    }
    if constexpr (kX) {
      __syncwarp();
      if (lane == 0) mbar_arrive(b.xempty + c);  // the tile may take the next x
    }
  }
  if constexpr (TRAIN) {
    bar_sync(1 + c, 128);
    store_column_sums(red + 4 * c * 2 * kC, scratch + (size_t)(2 * blockIdx.x + c) * kSumStride,
                      t);
  }
}

}  // namespace

// The projection and lse passes of the bf16 block (pct_block_eval here, and
// the backward passes of pct_block_bwd_sm90.cu): q [O, P, 32], vt [O, 128,
// pp] and, where vrow is not null, v row-major [O, P, 128]; lse2 [O, pp]
// (log2 units). qm, vm, lm, xm: the tensor maps the apply passes read them
// through (x as two [64, 64] boxes of 64 rows)
int launch_project_lse_sm90(const void* x, const void* wqk, const void* wv, const void* bv,
                            void* q, void* vt, void* vrow, float* lse2, int o, int p,
                            CUtensorMap* xm, CUtensorMap* qm, CUtensorMap* vm, CUtensorMap* lm,
                            cudaStream_t st) {
  const int pp = (p + 7) / 8 * 8;
  // stage_transposed reads the weights in 16-byte vectors
  if (((uintptr_t)wqk | (uintptr_t)wv) & 15) return (int)cudaErrorMisalignedAddress;
  int dev = 0, sms = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  {
    const uint64_t dims[3] = {kC, (uint64_t)p, (uint64_t)o};
    const uint64_t strides[2] = {kC * 2, (uint64_t)p * kC * 2};
    const uint32_t box[3] = {64, kTile, 1};
    if (int rc = make_map(xm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, x, dims, strides, box,
                          CU_TENSOR_MAP_SWIZZLE_128B))
      return rc;
    const long long tiles = (long long)o * ((p + kTile - 1) / kTile);
    if (int rc = allow_smem(project_wgmma_kernel, ProjSmem::bytes)) return rc;
    const int g1 = resident_grid(project_wgmma_kernel, 128, ProjSmem::bytes, tiles);
    project_wgmma_kernel<<<g1, 128, ProjSmem::bytes, st>>>(*xm, (const bf16*)wqk, (const bf16*)wv,
                                                           (const bf16*)bv, (bf16*)q, (bf16*)vt,
                                                           (bf16*)vrow, o, p, pp);
    if (int rc = (int)cudaGetLastError()) return rc;
  }
  {
    const uint64_t dims[3] = {kDa, (uint64_t)p, (uint64_t)o};
    const uint64_t strides[2] = {kDa * 2, (uint64_t)p * kDa * 2};
    const uint32_t box[3] = {kDa, kTile, 1};
    if (int rc = make_map(qm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, q, dims, strides, box,
                          CU_TENSOR_MAP_SWIZZLE_64B))
      return rc;
  }
  {
    const uint64_t dims[3] = {(uint64_t)p, kC, (uint64_t)o};
    const uint64_t strides[2] = {(uint64_t)pp * 2, (uint64_t)kC * pp * 2};
    const uint32_t box[3] = {kTile, kC, 1};
    if (int rc = make_map(vm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, vt, dims, strides, box,
                          CU_TENSOR_MAP_SWIZZLE_128B))
      return rc;
  }
  {
    const uint64_t dims[2] = {(uint64_t)p, (uint64_t)o};
    const uint64_t strides[1] = {(uint64_t)pp * 4};
    const uint32_t box[2] = {kTile, 1};
    if (int rc = make_map(lm, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, lse2, dims, strides, box,
                          CU_TENSOR_MAP_SWIZZLE_NONE))
      return rc;
  }
  const long long items = (long long)o * (((p + kTile - 1) / kTile + 1) / 2);
  const int grid = (int)(items < sms ? items : sms);
  if (int rc = allow_smem(lse_wgmma_kernel, LseSmem::bytes)) return rc;
  lse_wgmma_kernel<<<grid, kThreads, LseSmem::bytes, st>>>(*qm, lse2, o, p, pp);
  return (int)cudaGetLastError();
}

// bf16 pct_block_eval: q [O, P, 32], vt [O, 128, pp], lse2 [O, pp] work
// buffers (pp = P rounded up to a multiple of 8)
int launch_block_eval_sm90(const void* x, const void* wqk, const void* wv, const void* bv,
                           const void* wt, const void* bt, const float* wbn, const float* bbn,
                           void* q, void* vt, float* lse2, void* out, int o, int p, int oa,
                           cudaStream_t st) {
  // stage_transposed reads the weights in 16-byte vectors
  if ((uintptr_t)wt & 15) return (int)cudaErrorMisalignedAddress;
  CUtensorMap xm, qm, vm, lm;
  if (int rc = launch_project_lse_sm90(x, wqk, wv, bv, q, vt, nullptr, lse2, o, p, &xm, &qm, &vm,
                                       &lm, st))
    return rc;
  int dev = 0, sms = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long items = (long long)o * (((p + kTile - 1) / kTile + 1) / 2);
  const int grid = (int)(items < sms ? items : sms);
  auto apply = oa ? apply_wgmma_kernel<true, false> : apply_wgmma_kernel<false, false>;
  if (int rc = allow_smem(apply, ApplySmem::bytes)) return rc;
  apply<<<grid, kThreads, ApplySmem::bytes, st>>>(qm, vm, lm, xm, (const bf16*)wt,
                                                  (const bf16*)bt, wbn, bbn, nullptr, (bf16*)out,
                                                  nullptr, o, p);
  return (int)cudaGetLastError();
}

// bf16 pct_block_fwd: the eval block's projection, lse and apply passes,
// the apply pass with the training epilogue. Work buffers as
// launch_block_eval_sm90; scratch: `slices` slices of slice_stride(256)
// floats, two per block of the apply pass's grid (one per consumer
// warpgroup), which reduce_slices adds in order into sums [2, 128]
int launch_block_fwd_sm90(const void* x, const void* wqk, const void* wv, const void* bv,
                          const void* wt, const void* bt, const void* mask, void* q, void* vt,
                          float* lse2, void* tout, float* scratch, int slices, float* sums,
                          int o, int p, int oa, cudaStream_t st) {
  if (slices < 2 || slices % 2) return (int)cudaErrorInvalidValue;
  // stage_transposed reads the weights in 16-byte vectors
  if ((uintptr_t)wt & 15) return (int)cudaErrorMisalignedAddress;
  CUtensorMap xm, qm, vm, lm;
  if (int rc = launch_project_lse_sm90(x, wqk, wv, bv, q, vt, nullptr, lse2, o, p, &xm, &qm, &vm,
                                       &lm, st))
    return rc;
  auto apply = oa ? apply_wgmma_kernel<true, true> : apply_wgmma_kernel<false, true>;
  if (int rc = allow_smem(apply, ApplySmem::bytes)) return rc;
  apply<<<slices / 2, kThreads, ApplySmem::bytes, st>>>(qm, vm, lm, xm, (const bf16*)wt,
                                                        (const bf16*)bt, nullptr, nullptr,
                                                        (const bf16*)mask, (bf16*)tout, scratch,
                                                        o, p);
  if (int rc = (int)cudaGetLastError()) return rc;
  return reduce_slices(scratch, kSumStride, slices, sums, 2 * kC, st);
}

}  // namespace sga
