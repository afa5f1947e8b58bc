// PointNet object encoder, bf16 backward: the Hopper design of pointnet_bwd
// over the routed points only (see pointnet.cu for the function and its f32
// path, pointnet_sm90.cu for the bf16 forward).
//
// Replaces sgaligner_tpu/ops/pointnet_fused.py::_bwd_rule (Pallas kernel
// _bwd_kernel) for bf16 inputs. The max pool routes channel c of object o
// to one point, amax[o, c]; the gradient enters there alone:
//   g3 = dout at (amax, c) where the forward's f32 max peak[o, c] > 0 (a
//   NaN max routes nothing), 0 elsewhere; g2 = (g3·w3ᵀ) masked by a2 > 0,
//   g1 = (g2·w2ᵀ) masked by a1 > 0, each rounded to bf16; dw3 = Σ h2ᵀ·g3,
//   dw2 = Σ h1ᵀ·g2, dw1 = Σ xᵀ·g1, db = Σ g, f32. No dx: points are data.
// A point no channel routes to has g3 = g2 = g1 = 0, so it adds nothing
// (up to a non-finite h or x: 0·NaN; below). The routing test is the
// forward's own (peak > 0 is a3 > 0 at the argmax, as in the JAX kernel,
// where forward and backward share _stack_from_cf); this kernel no longer
// recomputes a3, which the earlier design did with other sums than the
// wgmma forward, so a channel whose forward max is positive could lose its
// gradient there.
//   Bound on the H100: operations on the rows that carry gradient. At
//   O = 896, P = 512, C3 = 256 about 12% of the points are routed (62 an
//   object); the gradients are [64, 128] and [128, C3] f32.
//   Design, two passes:
//   1. pointnet_bwd_wgmma_kernel: persistent, one block per SM of two
//      warpgroups that each own whole objects (one where two do not fit
//      beside W3: C3 > 256). Per object a warpgroup reads amax, peak and
//      dout (C3 each), marks the routed rows in a P-bit bitmap in shared
//      memory and compacts it by popcounts into a sorted row list (at most
//      min(P, C3) rows; no host sync). Each 64-row tile of that list runs
//      layers 1 and 2 as the forward does (pointnet_sm90.cuh: x gathered,
//      layer 1 on the CUDA cores into register-A fragments, wgmma against
//      the resident W2ᵀ), so h1, a2 and h2 have the forward's bits; writes
//      h2 to a per-object row buffer; forms g2 = g3·W3ᵀ as wgmma whose
//      register-A fragments are built from each channel's slot and dout (g3
//      is never stored; a box's fragments are built while the previous
//      box's products run) against W3 resident as K-major boxes (restaged
//      in channel groups per tile when it does not fit); then g1 = g2·W2ᵀ
//      against the same W2ᵀ read MN-major, and dW2 += h1ᵀ·g2 as MN-major
//      products whose accumulators stay in registers for the warpgroup's
//      life; dw1, db1, db2 are column sums one thread owns each, db3 a sum
//      per channel in shared memory.
//   2. pointnet_dw3_wgmma_kernel: dW3ᵀ = g3ᵀ·h2 over the same tiles, one
//      warpgroup per 64 channels (blockIdx.y: groups of 128), objects
//      split over blockIdx.x; g3ᵀ's register-A fragments again from the
//      slots, the h2 tile read MN-major (the next tile's loads in flight
//      in registers), the [64, 128] accumulators in registers until the
//      end. Each column of g3 has one non-zero per object, so pass 1 could
//      add dW3 as rank-1 columns, but that reads and writes all of a
//      [128, C3] f32 slice per object (235 MB at O = 896): the product
//      over the compacted rows keeps it on chip.
//   Dense semantics kept: a tile's non-finite h2 multiplies the zeros of
//   g3 in the products (NaN, as the dense sums' 0·NaN), and a non-finite
//   x[k] anywhere in an object adds NaN to dw1[k] (x·0 of the unrouted
//   points). Every sum over blocks goes through per-block slices added in
//   a fixed order (pass 1's by pass 2, pass 2's by reduce_slices): no
//   atomics but shared-memory bit ORs, the same bits from run to run.
#include "common.cuh"
#include "pointnet_sm90.cuh"

namespace sga {
namespace {

using namespace sm90;
using namespace pointnet_grad;

constexpr int kTile = 64;
constexpr int kWg = 128;                         // threads of a warpgroup
constexpr uint32_t kBox = kTile * 64 * 2;        // 8 KB, [64 rows, 64] with 128-byte rows
constexpr uint32_t kW3Box = kC2 * 64 * 2;        // 16 KB, W3 [128 k][64 channels]
constexpr int kLdG = kC1 + 8;                    // g1 [64 rows][64] row stride
constexpr size_t kSmemMax = 232448;

__host__ __device__ constexpr size_t up(size_t n, size_t a) { return (n + a - 1) / a * a; }

// pass 1's slice: dw1, db1, dw2, db2 (the gradient buffer's first
// kOffDw3 floats), then db3 and the tile count (its last c3 + 1)
__host__ __device__ inline int pass1_floats(int c3) { return kOffDw3 + c3 + 1; }
// rows of an object's h2 buffer: its routed rows, rounded up to a tile
__host__ __device__ inline int row_cap(int p, int c3) {
  return (int)up((size_t)(p < c3 ? p : c3), kTile);
}

// Pass 1's shared memory: the block's W2ᵀ with its bias step, W3 (a group
// of `group` channels as K-major boxes) and w1, b1; then per warpgroup its
// tiles and the current object's routing
struct BwdSmem {
  size_t w3, w1, wg, wg_bytes;
  size_t h1, g2, g1, xs, slot, val, rows, db3, bits, pre, misc;
  size_t bytes;

  __host__ __device__ BwdSmem(int c3p, int p, int group, int nwg) {
    w3 = kPnW2Bytes;
    w1 = w3 + (size_t)group / 64 * kW3Box;
    wg = up(w1 + 4 * kC1 * 4, 1024);
    const int nw = (p + 31) / 32;
    size_t o = 0;
    h1 = o;
    o += kBox;                               // h1 [64 rows][64], one box
    g2 = o;
    o += 2 * kBox;                           // g2 [64 rows][128], two boxes
    g1 = o;
    o += (size_t)kTile * kLdG * 2;           // g1
    xs = o;
    o += kTile * 4 * 4;                      // x of the tile's rows, [64][4] f32
    slot = o;
    o += (size_t)c3p * 4;                    // each channel's slot (-1: none)
    val = o;
    o += (size_t)c3p * 4;                    // each channel's g3 value
    rows = o;
    o += (size_t)c3p * 4;                    // the routed rows, sorted
    db3 = o;
    o += (size_t)c3p * 4;                    // Σ g3 per channel
    bits = o;
    o += up((size_t)nw * 4, 16);             // the routed-row bitmap
    pre = o;
    o += up((size_t)nw * 4, 16);             // routed rows before each word
    misc = o;
    o += 16;                                 // rows, x flags, tiles
    wg_bytes = up(o, 1024);
    bytes = wg + nwg * wg_bytes + 1024;
  }
};

// W3 channels [c0, c0 + n) (n a multiple of 64) as K-major boxes of 64
// channels at dst ([128 k][64] each, 128-byte swizzle); channels past c3
// are zero. 16-byte loads along w3's rows.
__device__ __forceinline__ void stage_w3(unsigned char* dst, const bf16* __restrict__ w3, int c3,
                                         int c0, int n, int tid, int threads) {
  const int chunks = n / 8;
#pragma unroll 4
  for (int idx = tid; idx < kC2 * chunks; idx += threads) {
    const int k = idx / chunks, ch = idx % chunks, c = c0 + 8 * ch;
    const uint4 v = c < c3 ? *reinterpret_cast<const uint4*>(w3 + (size_t)k * c3 + c)
                           : make_uint4(0u, 0u, 0u, 0u);
    *reinterpret_cast<uint4*>(dst + (ch / 8) * kW3Box + k * 128 + (((ch % 8) ^ (k % 8)) * 16)) =
        v;
  }
}

__device__ __forceinline__ float bf(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ bool is_finite(float v) { return fabsf(v) <= 3.402823466e38f; }

// Pass 1. x: [O, 3, P]; dout, amax, peak: [O, c3]; w3 [128, c3] (row
// stride c3); c3p: c3 rounded up to 64; group: W3 channels resident at
// once (c3p when W3 fits); scratch: one pass-1 slice per block; h2g
// [O, rcap / 64] tiles of h2 as two swizzled [64, 64] boxes (16 KB), slotg
// [O, c3] (each live channel's slot
// in its object's row list, else -1) and rowsg [O] (routed rows) for pass 2
__global__ void __launch_bounds__(256, 1)
pointnet_bwd_wgmma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dout,
                          const int* __restrict__ amax, const float* __restrict__ peak,
                          const bf16* __restrict__ w1, const bf16* __restrict__ b1,
                          const bf16* __restrict__ w2, const bf16* __restrict__ b2,
                          const bf16* __restrict__ w3, float* __restrict__ scratch,
                          uint4* __restrict__ h2g, int* __restrict__ slotg,
                          int* __restrict__ rowsg, int o, int p, int c3, int c3p, int group,
                          int rcap) {
  const int nwg = blockDim.x / kWg;
  const BwdSmem L(c3p, p, group, nwg);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  float* w1s = reinterpret_cast<float*>(smem + L.w1);
  unsigned char* w3s = smem + L.w3;
  const unsigned char* w2s = smem;
  const bool resident = group >= c3p;
  stage_layers12(smem, w1s, w1, b1, w2, b2);
  if (resident) stage_w3(w3s, w3, c3, 0, c3p, threadIdx.x, blockDim.x);

  const int c = threadIdx.x / kWg, t = threadIdx.x % kWg;
  const int warp = t / 32, lane = t % 32, q = lane % 4;
  const int rl = 16 * warp + lane / 4;  // this thread's rows of a tile: rl and rl + 8
  unsigned char* wb = smem + L.wg + c * L.wg_bytes;
  const unsigned char* h1s = wb + L.h1;
  const unsigned char* g2s = wb + L.g2;
  uint32_t* h1w = reinterpret_cast<uint32_t*>(wb + L.h1);
  uint32_t* g2w = reinterpret_cast<uint32_t*>(wb + L.g2);
  uint32_t* g1w = reinterpret_cast<uint32_t*>(wb + L.g1);
  const bf16* g1e = reinterpret_cast<const bf16*>(wb + L.g1);
  float* xs = reinterpret_cast<float*>(wb + L.xs);
  int* slot = reinterpret_cast<int*>(wb + L.slot);
  float* val = reinterpret_cast<float*>(wb + L.val);
  int* rows = reinterpret_cast<int*>(wb + L.rows);
  float* db3 = reinterpret_cast<float*>(wb + L.db3);
  uint32_t* bits = reinterpret_cast<uint32_t*>(wb + L.bits);
  int* pre = reinterpret_cast<int*>(wb + L.pre);
  int* misc = reinterpret_cast<int*>(wb + L.misc);
  for (int ch = t; ch < c3p; ch += kWg) {
    slot[ch] = -1;
    val[ch] = 0.f;
    db3[ch] = 0.f;
  }
  fence_proxy_async();
  __syncthreads();

  const int bar = 1 + c;
  const int nw = (p + 31) / 32;
  float dw2[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) dw2[i] = 0.f;
  // column sums owned by this thread: db2[t]; t < 64: dw1[0][t], db1[t];
  // else dw1[1][t - 64], dw1[2][t - 64]
  float s_db2 = 0.f, s_a = 0.f, s_b = 0.f;
  const int j1 = t % 64;
  int tiles = 0;

  for (int obj = blockIdx.x + c * gridDim.x; obj < o; obj += nwg * gridDim.x) {
    const bf16* xo = x + (size_t)obj * 3 * p;
    uint4* h2o = h2g + (size_t)obj * rcap * (kC2 / 8);
    for (int w = t; w < nw; w += kWg) bits[w] = 0u;
    if (t == 0) misc[1] = 0;
    bar_sync(bar, kWg);
    // routing: a channel is live where peak > 0 and dout != 0; a NaN peak
    // marks its point too (its h is NaN: the dense sums' 0·NaN)
    uint32_t xbad = 0;
#pragma unroll 4
    for (int i = t; i < 3 * p; i += kWg)
      if (!is_finite(bf(xo[i]))) xbad |= 1u << (i / p);
    if (xbad) atomicOr(reinterpret_cast<unsigned*>(misc + 1), xbad);
#pragma unroll 2
    for (int ch = t; ch < c3; ch += kWg) {
      const size_t oc = (size_t)obj * c3 + ch;
      const float pk = peak[oc], d = bf(dout[oc]);
      const int a = amax[oc];
      const bool live = pk > 0.f && d != 0.f;
      const bool mark = (live || pk != pk) && a >= 0 && a < p;
      val[ch] = live ? d : 0.f;
      slot[ch] = mark ? a : -1;
      db3[ch] += live ? d : 0.f;
      if (mark) atomicOr(bits + (a >> 5), 1u << (a & 31));
    }
    bar_sync(bar, kWg);
    if (warp == 0) {  // compaction: rows before each word, then the sorted row list
      int base = 0;
      for (int w0 = 0; w0 < nw; w0 += 32) {
        const int w = w0 + lane;
        const uint32_t m = w < nw ? bits[w] : 0u;
        const int n = __popc(m);
        int incl = n;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const int v = __shfl_up_sync(0xffffffffu, incl, d);
          if (lane >= d) incl += v;
        }
        int r = base + incl - n;
        if (w < nw) pre[w] = r;
        for (uint32_t left = m; left; left &= left - 1u) rows[r++] = 32 * w + __ffs(left) - 1;
        base += __shfl_sync(0xffffffffu, incl, 31);
      }
      if (lane == 0) misc[0] = base;
    }
    bar_sync(bar, kWg);
    for (int ch = t; ch < c3; ch += kWg) {  // each live channel's slot in the row list
      const int a = slot[ch];
      slot[ch] = a >= 0 && val[ch] != 0.f
                     ? pre[a >> 5] + __popc(bits[a >> 5] & ((1u << (a & 31)) - 1u))
                     : -1;
      slotg[(size_t)obj * c3 + ch] = slot[ch];
    }
    const int nrows = misc[0];
    if (t == 0) rowsg[obj] = nrows;
    const uint32_t xflags = (uint32_t)misc[1];
    const float qnan = __int_as_float(0x7fffffff);
    if (t < 64) {
      if (xflags & 1u) s_a += qnan;
    } else {
      if (xflags & 2u) s_a += qnan;
      if (xflags & 4u) s_b += qnan;
    }
    bar_sync(bar, kWg);

    for (int s0 = 0; s0 < nrows; s0 += kTile) {
      ++tiles;
      // layers 1 and 2 on the gathered rows, as the forward runs them
      float xr[2][3];
      bool v[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int s = s0 + rl + 8 * h;
        v[h] = s < nrows;
        const int row = v[h] ? rows[s] : 0;
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          xr[h][k] = v[h] ? bf(xo[(size_t)k * p + row]) : 0.f;
          if (q == 0) xs[(rl + 8 * h) * 4 + k] = xr[h][k];
        }
      }
      uint32_t a2[5][4], m1;
      layer1_fragments<true>(w1s, xr, v, q, a2, &m1);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)  // h1 into its tile (the A operand of dW2)
          h1w[x_word(rl + 8 * (r % 2), 16 * kk + 8 * (r / 2) + 2 * q)] = a2[kk][r];
      float acc[64];
      layer2(acc, a2, w2s);
      // m2 = a2 > 0 as bits of the accumulator index; h2 = round(relu(a2))
      // into the g2 tile (free: the last tile's dW2 product is done), then
      // copied as it lies, two swizzled boxes, to the object's row buffer
      // (pass 2's B operand; rows past the list are zeros)
      uint32_t m2[2] = {0u, 0u};
#pragma unroll
      for (int i = 0; i < 64; ++i) m2[i / 32] |= (acc[i] > 0.f ? 1u : 0u) << (i % 32);
#pragma unroll
      for (int i = 0; i < 64; i += 2)
        g2w[x_word(rl + 8 * ((i / 2) % 2), 8 * (i / 4) + 2 * q)] = pack_relu(acc[i], acc[i + 1]);
      bar_sync(bar, kWg);
#pragma unroll
      for (int u = 0; u < 2 * kBox / 16 / kWg; ++u)
        h2o[(size_t)s0 * (kC2 / 8) + t + kWg * u] =
            reinterpret_cast<const uint4*>(g2w)[t + kWg * u];

      // g2 = g3·W3ᵀ, 64 channels (a W3 box) a group of four k-steps: the A
      // fragments from the channels' slots and values, the next box's built
      // while this one's products run
      const int row_a = s0 + rl, row_b = row_a + 8;
      const int nbox = c3p / 64, gboxes = group / 64;
      auto g3_frags = [&](int b, uint32_t(&fa)[4][4]) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const int c0 = 64 * b + 16 * kk + 2 * q;
          const int2 sa = *reinterpret_cast<const int2*>(slot + c0);
          const int2 sb = *reinterpret_cast<const int2*>(slot + c0 + 8);
          const float2 va = *reinterpret_cast<const float2*>(val + c0);
          const float2 vb = *reinterpret_cast<const float2*>(val + c0 + 8);
          fa[kk][0] = pack_bf16(sa.x == row_a ? va.x : 0.f, sa.y == row_a ? va.y : 0.f);
          fa[kk][1] = pack_bf16(sa.x == row_b ? va.x : 0.f, sa.y == row_b ? va.y : 0.f);
          fa[kk][2] = pack_bf16(sb.x == row_a ? vb.x : 0.f, sb.y == row_a ? vb.y : 0.f);
          fa[kk][3] = pack_bf16(sb.x == row_b ? vb.x : 0.f, sb.y == row_b ? vb.y : 0.f);
        }
      };
      auto g3_products = [&](int b, const uint32_t(&fa)[4][4]) {
        const unsigned char* box = w3s + (size_t)(b % gboxes) * kW3Box;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_m64n128k16_rs(acc, fa[kk], desc(box, kSw128, kk * 32), (b | kk) != 0);
        wgmma_commit();
      };
      for (int b = 0; b < nbox; b += 2) {  // a group is an even number of boxes
        if (!resident && b % gboxes == 0) {
          bar_sync(bar, kWg);  // the previous group's products are done
          stage_w3(w3s, w3, c3, 64 * b, min(group, c3p - 64 * b), t, kWg);
          fence_proxy_async();
          bar_sync(bar, kWg);
        }
        uint32_t fa[4][4], fb[4][4];
        g3_frags(b, fa);
        g3_products(b, fa);
        if (b + 1 < nbox) {
          g3_frags(b + 1, fb);
          g3_products(b + 1, fb);
        }
        wgmma_wait<0>();
      }
      fence_regs(acc);
      // g2 masked by m2 and rounded: its tile (dW2's B operand, db2) and
      // the A fragments of g1 = g2·W2ᵀ
      bar_sync(bar, kWg);  // h2 has left the g2 tile
      uint32_t ag[8][4];
#pragma unroll
      for (int g = 0; g < 16; ++g)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = 4 * g + 2 * h;
          const float e0 = (m2[i / 32] >> (i % 32)) & 1u ? acc[i] : 0.f;
          const float e1 = (m2[i / 32] >> (i % 32 + 1)) & 1u ? acc[i + 1] : 0.f;
          const uint32_t w = pack_bf16(e0, e1);
          ag[g / 2][2 * (g % 2) + h] = w;
          g2w[x_word(rl + 8 * h, 8 * g + 2 * q)] = w;
        }
      fence_proxy_async();
      bar_sync(bar, kWg);  // the h1 and g2 tiles are complete

      float g1[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        wgmma_m64n64k16_rs_t<1>(g1, ag[kk], desc_mn(w2s, kSw128, 16 * kk, 0), kk != 0);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int nb = 0; nb < 2; ++nb)
          wgmma_m64n64k16_ss_t<1, 1>(dw2 + 32 * nb, desc_mn(h1s, kSw128, 16 * kk, 0),
                                     desc_mn(g2s + nb * kBox, kSw128, 16 * kk, 0), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(g1);
      fence_regs(dw2);
      // g1 masked by m1 and rounded, into its tile
#pragma unroll
      for (int g = 0; g < 8; ++g)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = 4 * g + 2 * h;
          const float e0 = (m1 >> i) & 1u ? g1[i] : 0.f;
          const float e1 = (m1 >> (i + 1)) & 1u ? g1[i + 1] : 0.f;
          g1w[((rl + 8 * h) * kLdG + 8 * g + 2 * q) / 2] = pack_bf16(e0, e1);
        }
      bar_sync(bar, kWg);  // g1 and x complete

      // the column sums this thread owns, over the tile's rows (rows past
      // the list hold zeros), four partial sums each
      const bf16* g2e = reinterpret_cast<const bf16*>(g2w);
      const bool lo = t < 64;
      float p2[4] = {0.f, 0.f, 0.f, 0.f}, pa[4] = {0.f, 0.f, 0.f, 0.f},
            pb[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int r = 0; r < kTile; ++r) {
        const float g = bf(g1e[r * kLdG + j1]);
        p2[r % 4] += bf(g2e[2 * x_word(r, t & ~1) + (t & 1)]);
        pa[r % 4] = fmaf(xs[r * 4 + (lo ? 0 : 1)], g, pa[r % 4]);
        pb[r % 4] = fmaf(lo ? 1.f : xs[r * 4 + 2], g, pb[r % 4]);
      }
      s_db2 += (p2[0] + p2[1]) + (p2[2] + p2[3]);
      s_a += (pa[0] + pa[1]) + (pa[2] + pa[3]);
      s_b += (pb[0] + pb[1]) + (pb[2] + pb[3]);
      bar_sync(bar, kWg);  // the tiles are rewritten by the next tile or object
    }
  }

  // the block's slice: warpgroup 1 hands its sums to warpgroup 0 through
  // its own shared memory (its tiles are done), which adds them to its own
  // (in that order) and writes them
  float* hand = reinterpret_cast<float*>(wb);  // [64][128] dW2, then 3 × 128
  __syncthreads();
  if (c == 1) {
#pragma unroll
    for (int i = 0; i < 64; ++i) hand[i * kWg + t] = dw2[i];
    hand[64 * kWg + t] = s_a;
    hand[65 * kWg + t] = s_b;
    hand[66 * kWg + t] = s_db2;
    if (t == 0) misc[2] = tiles;
  }
  __syncthreads();
  if (c == 1) return;
  const float* other = reinterpret_cast<const float*>(smem + L.wg + L.wg_bytes);
  const int* other_misc = reinterpret_cast<const int*>(smem + L.wg + L.wg_bytes + L.misc);
  const float* other_db3 = reinterpret_cast<const float*>(smem + L.wg + L.wg_bytes + L.db3);
  if (nwg == 2) {
#pragma unroll
    for (int i = 0; i < 64; ++i) dw2[i] += other[i * kWg + t];
    s_a += other[64 * kWg + t];
    s_b += other[65 * kWg + t];
    s_db2 += other[66 * kWg + t];
    tiles += other_misc[2];
  }
  float* part = scratch + (size_t)blockIdx.x * slice_stride(pass1_floats(c3));
  if (t < 64) {
    part[t] = s_a;
    part[kOffDb1 + t] = s_b;
  } else {
    part[kC1 + j1] = s_a;
    part[2 * kC1 + j1] = s_b;
  }
  part[kOffDb2 + t] = s_db2;
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int ii = i % 32;
    const int jr = 16 * warp + lane / 4 + 8 * ((ii / 2) % 2);
    const int n = 64 * (i / 32) + 8 * (ii / 4) + 2 * q + ii % 2;
    part[kOffDw2 + jr * kC2 + n] = dw2[i];
  }
  for (int ch = t; ch < c3; ch += kWg)
    part[kOffDw3 + ch] = nwg == 2 ? db3[ch] + other_db3[ch] : db3[ch];
  if (t == 0) part[kOffDw3 + c3] = (float)tiles;
}

// Pass 2: dW3ᵀ [c, k] = Σ g3ᵀ·h2 over every routed-row tile. Warpgroup c of
// block (x, y) owns channels 128y + 64c.. (+64) and objects x, x +
// gridDim.x, ...; its slice x of scratch gets those columns of dW3 [128, c3].
// A tile is 16 contiguous KB of h2g, two swizzled boxes copied as they lie
// into shared memory: the next tile's loads (and its
// object's slots) are in flight in registers while this tile's products
// run, and two shared-memory buffers take turns. First the blocks sum pass
// 1's `slices1` slices (s1, stride1) in order into grads: dw1, db1, dw2,
// db2, then db3 and the tile count.
__global__ void __launch_bounds__(256, 1)
pointnet_dw3_wgmma_kernel(const uint4* __restrict__ h2g, const int* __restrict__ slotg,
                          const int* __restrict__ rowsg, const bf16* __restrict__ dout,
                          float* __restrict__ scratch, const float* __restrict__ s1,
                          long long stride1, int slices1, float* __restrict__ grads, int o,
                          int c3, int rcap) {
  const int n1 = pass1_floats(c3), threads = gridDim.x * gridDim.y * blockDim.x;
  for (int j = (blockIdx.y * gridDim.x + blockIdx.x) * blockDim.x + threadIdx.x; j < n1;
       j += threads) {
    float sum = 0.f;
#pragma unroll 8
    for (int b = 0; b < slices1; ++b) sum += s1[(size_t)b * stride1 + j];
    grads[j < kOffDw3 ? j : j - kOffDw3 + off_db3(c3)] = sum;
  }

  constexpr int kLoads = kTile * kC2 / 8 / 256;  // 16-byte loads a thread and tile
  __shared__ __align__(1024) unsigned char tiles[2][2 * kBox];  // h2 [64 rows][128]
  const int c = threadIdx.x / kWg, t = threadIdx.x % kWg;
  const int warp = t / 32, lane = t % 32, q = lane % 4;
  const int ca = 128 * blockIdx.y + 64 * c + 16 * warp + lane / 4, cb = ca + 8;
  float acc[2][32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[0][i] = acc[1][i] = 0.f;
  uint4 next[kLoads];
  int obj = blockIdx.x, s0 = 0, nsa = -1, nsb = -1;
  float nva = 0.f, nvb = 0.f;
  // the next tile's rows and, at an object's first tile, its slots and douts
  auto fetch = [&](bool first) {
    const uint4* src = h2g + ((size_t)obj * rcap + s0) * (kC2 / 8);
#pragma unroll
    for (int u = 0; u < kLoads; ++u) next[u] = src[threadIdx.x + 256 * u];
    if (first) {
      const size_t oc = (size_t)obj * c3;
      nsa = ca < c3 ? slotg[oc + ca] : -1;
      nsb = cb < c3 ? slotg[oc + cb] : -1;
      nva = ca < c3 ? bf(dout[oc + ca]) : 0.f;
      nvb = cb < c3 ? bf(dout[oc + cb]) : 0.f;
    }
  };
  while (obj < o && rowsg[obj] == 0) obj += gridDim.x;
  if (obj < o) fetch(true);
  int sa = -1, sb = -1;
  float va = 0.f, vb = 0.f;
  for (int buf = 0; obj < o; buf ^= 1) {
    unsigned char* tile = tiles[buf];
#pragma unroll
    for (int u = 0; u < kLoads; ++u)
      reinterpret_cast<uint4*>(tile)[threadIdx.x + 256 * u] = next[u];
    fence_proxy_async();
    __syncthreads();  // this buffer is complete, and the other one free
    if (s0 == 0) {
      sa = nsa;
      sb = nsb;
      va = nva;
      vb = nvb;
    }
    const int r_base = s0;
    s0 += kTile;
    const bool next_obj = s0 >= rowsg[obj];
    if (next_obj) {
      s0 = 0;
      do obj += gridDim.x;
      while (obj < o && rowsg[obj] == 0);
    }
    if (obj < o) fetch(next_obj);
    uint32_t fa[4][4];  // g3ᵀ: rows (channels) ca, cb; k = the tile's rows
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int r0 = r_base + 16 * kk + 2 * q;
      fa[kk][0] = pack_bf16(sa == r0 ? va : 0.f, sa == r0 + 1 ? va : 0.f);
      fa[kk][1] = pack_bf16(sb == r0 ? vb : 0.f, sb == r0 + 1 ? vb : 0.f);
      fa[kk][2] = pack_bf16(sa == r0 + 8 ? va : 0.f, sa == r0 + 9 ? va : 0.f);
      fa[kk][3] = pack_bf16(sb == r0 + 8 ? vb : 0.f, sb == r0 + 9 ? vb : 0.f);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int nb = 0; nb < 2; ++nb)
        wgmma_m64n64k16_rs_t<1>(acc[nb], fa[kk], desc_mn(tile + nb * kBox, kSw128, 16 * kk, 0),
                                1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc[0]);
    fence_regs(acc[1]);
  }
  float* part = scratch + (size_t)blockIdx.x * slice_stride((long long)kC2 * c3);
#pragma unroll
  for (int nb = 0; nb < 2; ++nb)
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int ch = (i / 2) % 2 ? cb : ca, k = 64 * nb + 8 * (i / 4) + 2 * q + i % 2;
      if (ch < c3) part[(size_t)k * c3 + ch] = acc[nb][i];
    }
}

// Pass 1: one block per SM (at most one per pair of objects); two
// warpgroups when the block's W3 and both warpgroups' buffers fit, else
// one, and W3 in channel groups when even one warpgroup's buffers and W3
// do not fit. Pass 2: (blocks per channel group) × ⌈c3 / 128⌉ blocks, one
// wave. The work buffer holds both passes' slices, the h2 rows, the slots
// and the row counts.
struct Plan {
  int dev, grid, nwg, group, c3p, rcap, grid2x, grid2y;
  size_t smem, s1, s2, h2, slots, rows, bytes;
};

int plan(int o, int p, int c3, Plan* pl) {
  if (o < 1 || p < 1 || c3 < 16 || c3 % 16) return (int)cudaErrorInvalidValue;
  int sms = 1;
  cudaGetDevice(&pl->dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, pl->dev);
  pl->c3p = (c3 + 63) / 64 * 64;
  pl->group = pl->c3p;
  pl->nwg = 2;
  while (BwdSmem(pl->c3p, p, pl->group, pl->nwg).bytes > kSmemMax) {
    if (pl->nwg == 2) {
      pl->nwg = 1;
    } else if (pl->group > 128) {
      pl->group = (pl->group - 1) / 128 * 128;  // an even number of W3 boxes
    } else {
      return (int)cudaErrorInvalidValue;  // P or C3 too large for one warpgroup
    }
  }
  pl->smem = BwdSmem(pl->c3p, p, pl->group, pl->nwg).bytes;
  const int per = (o + pl->nwg - 1) / pl->nwg;
  pl->grid = per < sms ? per : sms;
  pl->rcap = row_cap(p, c3);
  pl->grid2y = (c3 + 127) / 128;
  const int per2 = sms / pl->grid2y;
  pl->grid2x = per2 < 1 ? 1 : (per2 < o ? per2 : o);
  size_t b = 0;
  pl->s1 = b;
  b = up(b + (size_t)pl->grid * slice_stride(pass1_floats(c3)) * 4, 256);
  pl->s2 = b;
  b = up(b + (size_t)pl->grid2x * slice_stride((long long)kC2 * c3) * 4, 256);
  pl->h2 = b;
  b = up(b + (size_t)o * pl->rcap * kC2 * 2, 256);
  pl->slots = b;
  b = up(b + (size_t)o * c3 * 4, 256);
  pl->rows = b;
  pl->bytes = b + (size_t)o * 4;
  return 0;
}

}  // namespace

// Bytes of the bf16 backward's work buffer; negative: an error code
long long pointnet_bwd_sm90_work_bytes(int o, int p, int c3) {
  Plan pl;
  if (int rc = plan(o, p, c3, &pl)) return -rc;
  return (long long)pl.bytes;
}

// bf16 pointnet_bwd for C3 a multiple of 16: `work` holds
// pointnet_bwd_sm90_work_bytes bytes; grads gets pointnet_grad::total(c3)
int launch_pointnet_bwd_sm90(const void* x, const void* dout, const int* amax, const float* peak,
                             const void* w1, const void* b1, const void* w2, const void* b2,
                             const void* w3, void* work, float* grads, int o, int p, int c3,
                             cudaStream_t st) {
  Plan pl;
  if (int rc = plan(o, p, c3, &pl)) return rc;
  if (((uintptr_t)w2 | (uintptr_t)w3 | (uintptr_t)work) & 15)
    return (int)cudaErrorMisalignedAddress;
  unsigned char* wk = static_cast<unsigned char*>(work);
  float* s1 = reinterpret_cast<float*>(wk + pl.s1);
  float* s2 = reinterpret_cast<float*>(wk + pl.s2);
  int* slots = reinterpret_cast<int*>(wk + pl.slots);
  int* rows = reinterpret_cast<int*>(wk + pl.rows);
  static bool smem_allowed[64] = {};  // per device: every launch fits under the card's maximum
  if (pl.dev < 64 && !smem_allowed[pl.dev]) {
    if (int rc = allow_smem(pointnet_bwd_wgmma_kernel, kSmemMax)) return rc;
    smem_allowed[pl.dev] = true;
  } else if (pl.dev >= 64) {
    if (int rc = allow_smem(pointnet_bwd_wgmma_kernel, pl.smem)) return rc;
  }
  pointnet_bwd_wgmma_kernel<<<pl.grid, kWg * pl.nwg, pl.smem, st>>>(
      (const bf16*)x, (const bf16*)dout, amax, peak, (const bf16*)w1, (const bf16*)b1,
      (const bf16*)w2, (const bf16*)b2, (const bf16*)w3, s1,
      reinterpret_cast<uint4*>(wk + pl.h2), slots, rows, o, p, c3, pl.c3p, pl.group, pl.rcap);
  if (int rc = (int)cudaGetLastError()) return rc;
  pointnet_dw3_wgmma_kernel<<<dim3(pl.grid2x, pl.grid2y), 2 * kWg, 0, st>>>(
      reinterpret_cast<const uint4*>(wk + pl.h2), slots, rows, (const bf16*)dout, s2, s1,
      slice_stride(pass1_floats(c3)), pl.grid, grads, o, c3, pl.rcap);
  if (int rc = (int)cudaGetLastError()) return rc;
  return reduce_slices(s2, slice_stride((long long)kC2 * c3), pl.grid2x, grads + kOffDw3,
                       kC2 * c3, st);
}

}  // namespace sga
