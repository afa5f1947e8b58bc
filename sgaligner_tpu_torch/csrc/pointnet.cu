// PointNet object encoder (parity mode), forward and backward, float32.
//
// pointnet_fwd replaces sgaligner_tpu/ops/pointnet_fused.py::_forward (Pallas
// kernel _fwd_kernel): for channel-first points x [O, 3, P] and weights
// w1 [3, 64], w2 [64, 128], w3 [128, C3] with biases [1, C]:
//   a1 = xᵀ·w1 + b1, h1 = relu(a1) rounded to the compute dtype;
//   a2 = h1·w2 + b2, h2 = relu(a2) rounded;   a3 = h2·w3 + b3 (f32);
//   out [O, C3] f32 = max over P of relu(a3); with the training flag also
//   amax [O, C3] int32 = the first point index reaching that max.
// Every product accumulates in f32 and takes its bias in f32; the relu masks
// come from the f32 pre-activations (the rounding points of _stack_from_cf).
// relu keeps a NaN, as jnp.maximum and torch.relu do, and a NaN wins the
// max (the earlier NaN between two).
//   bf16 runs the Hopper design of pointnet_sm90.cu (wgmma, the max and
//   argmax in registers); float32 runs the kernel below.
//   Bound on the H100 (f32): operations, 2·P·(3·64 + 64·128 + 128·C3) FLOP
//   per object on the CUDA cores (67 TFLOP/s; no TF32), against 12 bytes a
//   point: 0.133 ms at O = 256, P = 512, C3 = 200.
//   Design (f32): persistent, one 256-thread block per SM, each block owning
//   whole objects (at O = 256 two objects an SM: 97% of the 1.94 the card
//   would average, and the same at O = 896). W2 (33 KB) and W3 (100 KB at
//   C3 = 200, 128 at 256) stay resident in shared memory; a C3 above 256 runs
//   in groups of 256 channels, each group staged once per block, layers 1-2
//   recomputed per group. Per 64-point tile: layers 1 and 2
//   (pointnet_f32.cuh, which the backward shares), then layer 3 as a
//   register-tiled FMA product: each thread owns 8 points × 8 channels (64
//   accumulators), fed by four 16-byte shared-memory loads a k-step. Its
//   epilogue folds bias, relu and the running max and first index into 16
//   registers (the thread's points ascend, so a strictly greater value or a
//   first NaN replaces); at the object's end the eight threads that share a
//   channel meet in shared memory and merge by the pool's first-index rule
//   (beats_max). Any C3: the staged W3 is zero-padded to a multiple of 8,
//   and the padded channels are never written.
//
// pointnet_bwd replaces ops/pointnet_fused.py::_bwd_rule (Pallas kernel
// _bwd_kernel): the max pool routes channel c of object o to one point,
// amax[o, c], where the forward's f32 max peak[o, c] > 0 (a NaN max routes
// nothing); g3 = dout there, 0 elsewhere;
//   g2 = (g3·w3ᵀ) masked by a2 > 0, g1 = (g2·w2ᵀ) masked by a1 > 0, each
//   rounded to the compute dtype; dw3 = Σ h2ᵀ·g3, dw2 = Σ h1ᵀ·g2,
//   dw1 = Σ xᵀ·g1 (contracting P), db = Σ g, all f32. No dx: points are data.
//   bf16 runs the Hopper design of pointnet_bwd_sm90.cu; float32 the passes
//   below. Both run over the routed points only: a point no live channel
//   picks has g3 = g2 = g1 = 0 and adds nothing (up to a non-finite h or x,
//   below). peak > 0 is the forward's own a3 > 0 at the argmax (in JAX the
//   forward and backward share _stack_from_cf), so layer 3 is not
//   recomputed.
//   Bound on the H100 (f32): operations on the rows and channels that carry
//   gradient (chip_smoke.py's bwd_work): 0.0103 ms at O = 256, C3 = 200.
//   Design (f32), four launches from one C call:
//   0. transpose_w3_kernel: W3ᵀ [C3][128] into the work buffer, so that a
//      channel's column of W3 is 512 contiguous bytes.
//   1. pointnet_bwd_f32_kernel: persistent, one block per SM, each owning
//      whole objects. Per object it reads amax, peak and dout, marks the
//      routed points in a P-bit bitmap, compacts it by popcounts into a
//      sorted row list (at most min(P, C3) rows) and each live channel's
//      slot in it. Each 64-row tile of the list gathers x, recomputes layers
//      1 and 2 with the forward's code (pointnet_f32.cuh: the same bits, so
//      h > 0 is the forward's relu mask) and writes h2 to a per-object row
//      buffer; g2 = g3·W3ᵀ is formed without g3: each row's live channels
//      (a channel bitmask per row) add dout·W3ᵀ[c] in channel order; then
//      g1 = g2·W2ᵀ (register-tiled FMA against the resident W2) and
//      dW2 += h1ᵀ·g2, whose 32 accumulators a thread keeps in registers
//      for the block's life, as it does its column sums of dw1, db1 and db2;
//      db3 sums per channel in shared memory. The block writes its slice
//      once, at the end.
//   2. pointnet_dw3_f32_kernel: dW3 [k][c] = Σ over objects of h2[slot][k]
//      · dout[c] (g3 has one entry per live channel and object): a lane a
//      channel, a warp 16 k, the object list split over blockIdx.x, the
//      sums in registers; a listed row's non-finite h2[k] adds NaN to every
//      column of row k (the dense product's 0·NaN).
//   3. pointnet_reduce_f32_kernel: each gradient entry sums its slices in a
//      fixed order, eight warps taking every eighth slice, then the eight
//      partial sums in warp order.
//   No float atomics (integer ORs into bitmaps only), so the result has the
//   same bits from run to run. Dense semantics kept: a listed row's
//   non-finite h multiplies the zeros of g in the products (NaN, as the
//   dense sums' 0·NaN), and a non-finite x[k] anywhere in an object adds NaN
//   to dw1[k] (x·0 of the unrouted points).
#include "common.cuh"
#include "pointnet_f32.cuh"

namespace sga {
namespace {

using namespace pnf32;
using pointnet_grad::kOffDb1;
using pointnet_grad::kOffDb2;
using pointnet_grad::kOffDw2;
using pointnet_grad::kOffDw3;
using pointnet_grad::off_db3;

constexpr size_t kSmemMax = 232448;
constexpr int kGroup = 256;   // layer-3 channels a forward block keeps resident
constexpr int kVec = 3 * kC1 + kC1 + kC2;

__device__ __forceinline__ bool finite_f(float v) { return fabsf(v) <= 3.402823466e38f; }

// ------------------------------- forward -------------------------------------

// The forward's shared memory for groups of cgw channels (a multiple of 8,
// at most kGroup). The h1 tile is also where an object's running maxima
// meet at its end (8 × cgw values, then 8 × cgw indices).
struct FwdSmem {
  size_t w2, vec, b3, w3, xs, h1T, h2T, bytes;
  __host__ __device__ explicit FwdSmem(int cgw) {
    size_t o = 0;
    w2 = take(o, sizeof(float) * kC1 * kLdW2);
    vec = take(o, sizeof(float) * kVec);
    b3 = take(o, sizeof(float) * cgw);
    w3 = take(o, sizeof(float) * kC2 * cgw);
    xs = take(o, sizeof(float) * 3 * kTile);
    h1T = take(o, sizeof(float) * kC1 * kLdT);
    h2T = take(o, sizeof(float) * kC2 * kLdT);
    bytes = o;
  }
};
static_assert(16 * kGroup <= kC1 * kLdT, "the merge buffer fits in the h1 tile");

// Layer 3 of one tile for this thread's 8 points (4rg.. and 32 + 4rg..) and 8
// channels (8cg.. of the staged group, row stride ldw), folded into the
// running max bv and first index bi: bias, relu, then, point by point in
// ascending order, a strictly greater value or a first NaN replaces.
__device__ __forceinline__ void layer3_pool(const float* h2T, const float* w3s, const float* b3s,
                                            int ldw, int rg, int cg, int r0, int p, float (&bv)[8],
                                            int (&bi)[8]) {
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
#pragma unroll 2
  for (int k = 0; k < kC2; ++k) {
    const float4 a0 = *reinterpret_cast<const float4*>(h2T + k * kLdT + 4 * rg);
    const float4 a1 = *reinterpret_cast<const float4*>(h2T + k * kLdT + 32 + 4 * rg);
    const float4 b0 = *reinterpret_cast<const float4*>(w3s + k * ldw + 8 * cg);
    const float4 b1 = *reinterpret_cast<const float4*>(w3s + k * ldw + 8 * cg + 4);
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float bw[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bw[j], acc[i][j]);
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float bias = b3s[8 * cg + j];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = r0 + (i < 4 ? 4 * rg + i : 28 + 4 * rg + i);
      const float v = relu_nan(acc[i][j] + bias);
      if (row < p && bv[j] == bv[j] && (v > bv[j] || v != v)) {
        bv[j] = v;
        bi[j] = row;
      }
    }
  }
}

// x [O, 3, P]; w3 [128, c3], b3 [1, c3]; out, amax [O, c3]; cgw: the
// channels of a resident group (c3 rounded up to 8, at most kGroup)
template <bool ARGMAX>
__global__ void __launch_bounds__(kThreads, 1)
pointnet_fwd_f32_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                        const float* __restrict__ b1, const float* __restrict__ w2,
                        const float* __restrict__ b2, const float* __restrict__ w3,
                        const float* __restrict__ b3, float* __restrict__ out,
                        int* __restrict__ amax, int o, int p, int c3, int cgw) {
  extern __shared__ __align__(128) unsigned char smem[];
  const FwdSmem L(cgw);
  float* w2s = reinterpret_cast<float*>(smem + L.w2);
  float* vec = reinterpret_cast<float*>(smem + L.vec);
  float* b3s = reinterpret_cast<float*>(smem + L.b3);
  float* w3s = reinterpret_cast<float*>(smem + L.w3);
  float* xs = reinterpret_cast<float*>(smem + L.xs);
  float* h1T = reinterpret_cast<float*>(smem + L.h1T);
  float* h2T = reinterpret_cast<float*>(smem + L.h2T);
  stage_layers12(w2s, vec, w1, b1, w2, b2);
  const int t = threadIdx.x, rg = t % 8, cg = t / 8;

  for (int g0 = 0; g0 < c3; g0 += cgw) {
    const int gw = min(cgw, c3 - g0), gwp = (gw + 7) & ~7;
    __syncthreads();  // the previous group's products and merges are done
    for (int i = t; i < kC2 * gwp; i += kThreads) {
      const int k = i / gwp, j = i % gwp;
      w3s[i] = j < gw ? w3[(size_t)k * c3 + g0 + j] : 0.f;
    }
    for (int j = t; j < gwp; j += kThreads) b3s[j] = j < gw ? b3[g0 + j] : 0.f;
    __syncthreads();
    const bool active = cg < gwp / 8;

    for (int obj = blockIdx.x; obj < o; obj += gridDim.x) {
      const float* xo = x + (size_t)obj * 3 * p;
      float bv[8];
      int bi[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        bv[j] = -INFINITY;
        bi[j] = 0;
      }
      // thread t < 192 stages x[t / 64] of row t % 64, loaded a tile ahead
      auto xval = [&](int r0) {
        const int r = r0 + t % kTile;
        return t < 3 * kTile && r < p ? xo[(size_t)(t / kTile) * p + r] : 0.f;
      };
      float xn = xval(0);
      for (int r0 = 0; r0 < p; r0 += kTile) {
        if (t < 3 * kTile) xs[t] = xn;
        __syncthreads();
        if (r0 + kTile < p) xn = xval(r0 + kTile);
        layer1<false>(xs, vec, h1T, nullptr);
        __syncthreads();
        layer2(h1T, w2s, vec, h2T);
        __syncthreads();
        if (active) layer3_pool(h2T, w3s, b3s, gwp, rg, cg, r0, p, bv, bi);
      }
      // the eight row groups' maxima meet in the h1 tile (dead until the
      // next object's first barrier)
      float* rv = h1T;
      int* ri = reinterpret_cast<int*>(h1T + 8 * cgw);
      if (active) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          rv[rg * cgw + 8 * cg + j] = bv[j];
          ri[rg * cgw + 8 * cg + j] = bi[j];
        }
      }
      __syncthreads();
      for (int c = t; c < gw; c += kThreads) {
        float v = rv[c];
        int i = ri[c];
#pragma unroll
        for (int r = 1; r < 8; ++r) {
          const float v2 = rv[r * cgw + c];
          const int i2 = ri[r * cgw + c];
          if (beats_max(v2, i2, v, i)) {
            v = v2;
            i = i2;
          }
        }
        out[(size_t)obj * c3 + g0 + c] = v;
        if constexpr (ARGMAX) amax[(size_t)obj * c3 + g0 + c] = i;
      }
    }
  }
}

template <bool ARGMAX>
int launch_fwd(const float* x, const float* w1, const float* b1, const float* w2, const float* b2,
               const float* w3, const float* b3, float* out, int* amax, int o, int p, int c3,
               cudaStream_t st) {
  const int cgw = min(kGroup, (c3 + 7) & ~7);
  const size_t smem = FwdSmem(cgw).bytes;
  auto kernel = pointnet_fwd_f32_kernel<ARGMAX>;
  if (int rc = allow_smem(kernel, smem)) return rc;
  const int grid = resident_grid(kernel, kThreads, smem, o);
  kernel<<<grid, kThreads, smem, st>>>(x, w1, b1, w2, b2, w3, b3, out, amax, o, p, c3, cgw);
  return (int)cudaGetLastError();
}

// ------------------------------- backward ------------------------------------

// pass 1's slice: dw1, db1, dw2, db2 (the gradient buffer's first kOffDw3
// floats), then db3 and the tile count
__host__ __device__ inline int pass1_floats(int c3) { return kOffDw3 + c3 + 1; }

// Pass 1's shared memory: W2 and the layer vectors; the tile's x, h1 (both
// layouts), h2, g2 (both layouts) and g1; the current object's routing
struct BwdSmem {
  size_t w2, vec, xs, h1T, h1, h2T, g2T, g2, g1T, slot, val, db3, rows, bits, pre, mask, misc;
  size_t bytes;
  int nw, words;
  __host__ __device__ BwdSmem(int p, int c3) {
    const int c3p = (c3 + 7) & ~7;
    nw = (p + 31) / 32;
    words = (c3 + 31) / 32;
    size_t o = 0;
    w2 = take(o, sizeof(float) * kC1 * kLdW2);
    vec = take(o, sizeof(float) * kVec);
    xs = take(o, sizeof(float) * 3 * kTile);
    h1T = take(o, sizeof(float) * kC1 * kLdT);    // [channel][row]
    h1 = take(o, sizeof(float) * kTile * kLdT);   // [row][channel]
    h2T = take(o, sizeof(float) * kC2 * kLdT);
    g2T = take(o, sizeof(float) * kC2 * kLdT);
    g2 = take(o, sizeof(float) * kTile * kLdW2);
    g1T = take(o, sizeof(float) * kC1 * kLdT);
    slot = take(o, sizeof(int) * c3p);            // each channel's slot (-1: none)
    val = take(o, sizeof(float) * c3p);           // each live channel's dout
    db3 = take(o, sizeof(float) * c3p);           // Σ g3 per channel
    rows = take(o, sizeof(int) * (p < c3p ? p : c3p));  // the routed rows, sorted
    bits = take(o, sizeof(uint32_t) * nw);        // the routed-row bitmap
    pre = take(o, sizeof(int) * nw);              // routed rows before each word
    mask = take(o, sizeof(uint32_t) * kTile * words);  // each tile row's live channels
    misc = take(o, 16);                           // rows, x flags
    bytes = o;
  }
};

__global__ void transpose_w3_kernel(const float* __restrict__ w3, float* __restrict__ w3t,
                                    int c3) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < kC2 * c3; i += gridDim.x * blockDim.x)
    w3t[(size_t)(i % c3) * kC2 + i / c3] = w3[i];
}

// g2 of the tile (rows r < nv of its routed-row list): thread t owns row
// t / 4 and 32 k from 32(t % 4); each of the row's live channels adds
// dout·W3ᵀ[c] (two channels' loads in flight at once, added in channel
// order); masked by h2 > 0 (a2 > 0) into g2 [row][k] and g2T [k][row]
__device__ __forceinline__ void g2_rows(const uint32_t* mask, int words, const float* val,
                                        const float* __restrict__ w3t, const float* h2T,
                                        float* g2, float* g2T, int nv) {
  const int r = threadIdx.x / 4, q = threadIdx.x % 4;
  float acc[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) acc[j] = 0.f;
  if (r < nv) {
    for (int w = 0; w < words; ++w) {
      uint32_t m = mask[r * words + w];
      while (m) {
        const int ca = 32 * w + __ffs(m) - 1;
        m &= m - 1u;
        const int cb = m ? 32 * w + __ffs(m) - 1 : -1;
        if (m) m &= m - 1u;
        // without a second channel the first one's row is loaded twice (no branch)
        const float4* ra = reinterpret_cast<const float4*>(w3t + (size_t)ca * kC2 + 32 * q);
        const float4* rb = reinterpret_cast<const float4*>(w3t + (size_t)(cb < 0 ? ca : cb) * kC2 +
                                                           32 * q);
        float4 va[8], vb[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          va[u] = __ldg(ra + u);
          vb[u] = __ldg(rb + u);
        }
        const float da = val[ca], db = cb < 0 ? 0.f : val[cb];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          acc[4 * u] = fmaf(da, va[u].x, acc[4 * u]);
          acc[4 * u + 1] = fmaf(da, va[u].y, acc[4 * u + 1]);
          acc[4 * u + 2] = fmaf(da, va[u].z, acc[4 * u + 2]);
          acc[4 * u + 3] = fmaf(da, va[u].w, acc[4 * u + 3]);
        }
        if (cb >= 0) {
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            acc[4 * u] = fmaf(db, vb[u].x, acc[4 * u]);
            acc[4 * u + 1] = fmaf(db, vb[u].y, acc[4 * u + 1]);
            acc[4 * u + 2] = fmaf(db, vb[u].z, acc[4 * u + 2]);
            acc[4 * u + 3] = fmaf(db, vb[u].w, acc[4 * u + 3]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    float g[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = 32 * q + 4 * u + e;
      g[e] = h2T[k * kLdT + r] > 0.f ? acc[4 * u + e] : 0.f;
      g2T[k * kLdT + r] = g[e];
    }
    *reinterpret_cast<float4*>(g2 + r * kLdW2 + 32 * q + 4 * u) = make_float4(g[0], g[1], g[2],
                                                                              g[3]);
  }
}

// Pass 1. x: [O, 3, P]; dout, amax, peak: [O, c3]; w3t: W3ᵀ [c3][128];
// scratch: one pass-1 slice per block; h2g [O][rcap][128]: each object's
// routed rows' h2, slotg [O, c3] (each live channel's slot in its object's
// row list, else -1) and hbadg [O][4] (the k whose h2 is not finite on some
// listed row) for pass 2
__global__ void __launch_bounds__(kThreads, 1)
pointnet_bwd_f32_kernel(const float* __restrict__ x, const float* __restrict__ dout,
                        const int* __restrict__ amax, const float* __restrict__ peak,
                        const float* __restrict__ w1, const float* __restrict__ b1,
                        const float* __restrict__ w2, const float* __restrict__ b2,
                        const float* __restrict__ w3t, float* __restrict__ scratch,
                        float* __restrict__ h2g, int* __restrict__ slotg,
                        uint32_t* __restrict__ hbadg, int o, int p, int c3, int rcap) {
  extern __shared__ __align__(128) unsigned char smem[];
  const BwdSmem L(p, c3);
  float* w2s = reinterpret_cast<float*>(smem + L.w2);
  float* vec = reinterpret_cast<float*>(smem + L.vec);
  float* xs = reinterpret_cast<float*>(smem + L.xs);
  float* h1T = reinterpret_cast<float*>(smem + L.h1T);
  float* h1 = reinterpret_cast<float*>(smem + L.h1);
  float* h2T = reinterpret_cast<float*>(smem + L.h2T);
  float* g2T = reinterpret_cast<float*>(smem + L.g2T);
  float* g2 = reinterpret_cast<float*>(smem + L.g2);
  float* g1T = reinterpret_cast<float*>(smem + L.g1T);
  int* slot = reinterpret_cast<int*>(smem + L.slot);
  float* val = reinterpret_cast<float*>(smem + L.val);
  float* db3 = reinterpret_cast<float*>(smem + L.db3);
  int* rows = reinterpret_cast<int*>(smem + L.rows);
  uint32_t* bits = reinterpret_cast<uint32_t*>(smem + L.bits);
  int* pre = reinterpret_cast<int*>(smem + L.pre);
  uint32_t* mask = reinterpret_cast<uint32_t*>(smem + L.mask);
  int* misc = reinterpret_cast<int*>(smem + L.misc);
  const int nw = L.nw, words = L.words;
  stage_layers12(w2s, vec, w1, b1, w2, b2);
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  for (int c = t; c < c3; c += kThreads) db3[c] = 0.f;

  // the block's sums: dW2 rows 4(t % 16).. and columns 8(t / 16)..; and the
  // column sums this thread owns: t < 64: dw1[0][t], dw1[1][t]; t < 128:
  // dw1[2][t - 64], db1[t - 64]; else db2[t - 128]
  float dw2[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) dw2[i][j] = 0.f;
  float s_a = 0.f, s_b = 0.f;
  int tiles = 0;
  const float qnan = __int_as_float(0x7fffffff);

  for (int obj = blockIdx.x; obj < o; obj += gridDim.x) {
    const float* xo = x + (size_t)obj * 3 * p;
    for (int w = t; w < nw; w += kThreads) bits[w] = 0u;
    if (t == 0) misc[1] = 0;
    __syncthreads();
    // routing: a channel is live where peak > 0 and dout != 0; a NaN peak
    // marks its point too (its h is NaN: the dense sums' 0·NaN)
    uint32_t xbad = 0;
    for (int i = t; i < 3 * p; i += kThreads)
      if (!finite_f(xo[i])) xbad |= 1u << (i / p);
    if (xbad) atomicOr(reinterpret_cast<unsigned*>(misc + 1), xbad);
    for (int c = t; c < c3; c += kThreads) {
      const size_t oc = (size_t)obj * c3 + c;
      const float pk = peak[oc], d = dout[oc];
      const int a = amax[oc];
      const bool live = pk > 0.f && d != 0.f;
      const bool mark = (live || pk != pk) && a >= 0 && a < p;
      val[c] = live ? d : 0.f;
      slot[c] = mark ? a : -1;
      db3[c] += live ? d : 0.f;
      if (mark) atomicOr(bits + (a >> 5), 1u << (a & 31));
    }
    __syncthreads();
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
    __syncthreads();
    for (int c = t; c < c3; c += kThreads) {  // each live channel's slot in the row list
      const int a = slot[c];
      const int s = a >= 0 && val[c] != 0.f
                        ? pre[a >> 5] + __popc(bits[a >> 5] & ((1u << (a & 31)) - 1u))
                        : -1;
      slot[c] = s;
      slotg[(size_t)obj * c3 + c] = s;
    }
    const int nrows = misc[0];
    const uint32_t xflags = (uint32_t)misc[1];
    if (t < kC1) {
      if (xflags & 1u) s_a += qnan;
      if (xflags & 2u) s_b += qnan;
    } else if (t < 2 * kC1) {
      if (xflags & 4u) s_a += qnan;
    }
    bool hbad = false;  // t < 128: h2[·][t] not finite on a listed row
    __syncthreads();

    for (int s0 = 0; s0 < nrows; s0 += kTile) {
      ++tiles;
      const int nv = min(kTile, nrows - s0);
      for (int i = t; i < 3 * kTile; i += kThreads) {
        const int k = i / kTile, r = i % kTile;
        xs[i] = r < nv ? xo[(size_t)k * p + rows[s0 + r]] : 0.f;
      }
      for (int i = t; i < kTile * words; i += kThreads) mask[i] = 0u;
      __syncthreads();
      // layers 1 and 2 on the gathered rows, as the forward runs them
      layer1<true>(xs, vec, h1T, h1);
      for (int c = t; c < c3; c += kThreads) {
        const int s = slot[c] - s0;
        if (s >= 0 && s < kTile) atomicOr(mask + s * words + (c >> 5), 1u << (c & 31));
      }
      __syncthreads();
      layer2(h1T, w2s, vec, h2T);
      __syncthreads();
      // h2 to the object's row buffer (pass 2's operand), its non-finite k,
      // and g2 = g3·W3ᵀ masked by a2 > 0
      float* dst = h2g + ((size_t)obj * rcap + s0) * kC2;
      for (int i = t; i < nv * kC2; i += kThreads) dst[i] = h2T[(i % kC2) * kLdT + i / kC2];
      if (t < kC2)
        for (int r = 0; r < nv; ++r) hbad |= !finite_f(h2T[t * kLdT + r]);
      g2_rows(mask, words, val, w3t, h2T, g2, g2T, nv);
      __syncthreads();
      {  // g1 = g2·W2ᵀ masked by a1 > 0: rows 4(t % 16).., channels t / 16 + 16i
        const int rg = t % 16, jg = t / 16;
        float acc[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
        for (int n = 0; n < kC2; ++n) {
          const float4 a = *reinterpret_cast<const float4*>(g2T + n * kLdT + 4 * rg);
          const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float b = w2s[(jg + 16 * j) * kLdW2 + n];
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(av[i], b, acc[i][j]);
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = jg + 16 * j;
          const float4 h = *reinterpret_cast<const float4*>(h1T + c * kLdT + 4 * rg);
          *reinterpret_cast<float4*>(g1T + c * kLdT + 4 * rg) =
              make_float4(h.x > 0.f ? acc[0][j] : 0.f, h.y > 0.f ? acc[1][j] : 0.f,
                          h.z > 0.f ? acc[2][j] : 0.f, h.w > 0.f ? acc[3][j] : 0.f);
        }
      }
      {  // dW2 += h1ᵀ·g2 over the tile's rows
        const int jg = t % 16, ng = t / 16;
        for (int r = 0; r < nv; ++r) {
          const float4 a = *reinterpret_cast<const float4*>(h1 + r * kLdT + 4 * jg);
          const float4 b0 = *reinterpret_cast<const float4*>(g2 + r * kLdW2 + 8 * ng);
          const float4 b1 = *reinterpret_cast<const float4*>(g2 + r * kLdW2 + 8 * ng + 4);
          const float av[4] = {a.x, a.y, a.z, a.w};
          const float bw[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) dw2[i][j] = fmaf(av[i], bw[j], dw2[i][j]);
        }
      }
      // column sums over the tile's rows (rows past the list hold zeros),
      // four partial sums each: db2 here, dw1 and db1 once g1 is complete
      const int nv4 = (nv + 3) / 4;
      if (t >= 2 * kC1) {
        const float* g = g2T + (t - 2 * kC1) * kLdT;
        float4 ps = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int r4 = 0; r4 < nv4; ++r4) {
          const float4 v = *reinterpret_cast<const float4*>(g + 4 * r4);
          ps = make_float4(ps.x + v.x, ps.y + v.y, ps.z + v.z, ps.w + v.w);
        }
        s_a += (ps.x + ps.y) + (ps.z + ps.w);
      }
      __syncthreads();
      if (t < 2 * kC1) {
        const int j = t % kC1;
        const float* g = g1T + j * kLdT;
        const float* xa = xs + (t < kC1 ? 0 : 2 * kTile);
        float pa[4] = {0.f, 0.f, 0.f, 0.f}, pb[4] = {0.f, 0.f, 0.f, 0.f};
        for (int r4 = 0; r4 < nv4; ++r4) {
          const float4 v = *reinterpret_cast<const float4*>(g + 4 * r4);
          const float4 u = *reinterpret_cast<const float4*>(xa + 4 * r4);
          const float4 w = t < kC1 ? *reinterpret_cast<const float4*>(xs + kTile + 4 * r4)
                                   : make_float4(1.f, 1.f, 1.f, 1.f);
          pa[0] = fmaf(u.x, v.x, pa[0]);
          pa[1] = fmaf(u.y, v.y, pa[1]);
          pa[2] = fmaf(u.z, v.z, pa[2]);
          pa[3] = fmaf(u.w, v.w, pa[3]);
          pb[0] = fmaf(w.x, v.x, pb[0]);
          pb[1] = fmaf(w.y, v.y, pb[1]);
          pb[2] = fmaf(w.z, v.z, pb[2]);
          pb[3] = fmaf(w.w, v.w, pb[3]);
        }
        s_a += (pa[0] + pa[1]) + (pa[2] + pa[3]);
        s_b += (pb[0] + pb[1]) + (pb[2] + pb[3]);
      }
      __syncthreads();  // x, h, g and the row masks are rewritten by the next tile
    }
    if (warp < kC2 / 32) {
      const uint32_t word = __ballot_sync(0xffffffffu, hbad);
      if (lane == 0) hbadg[(size_t)obj * 4 + warp] = word;
    }
  }

  float* part = scratch + (size_t)blockIdx.x * slice_stride(pass1_floats(c3));
  if (t < kC1) {
    part[t] = s_a;
    part[kC1 + t] = s_b;
  } else if (t < 2 * kC1) {
    part[2 * kC1 + t - kC1] = s_a;
    part[kOffDb1 + t - kC1] = s_b;
  } else {
    part[kOffDb2 + t - 2 * kC1] = s_a;
  }
  const int jg = t % 16, ng = t / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) part[kOffDw2 + (4 * jg + i) * kC2 + 8 * ng + j] = dw2[i][j];
  for (int c = t; c < c3; c += kThreads) part[kOffDw3 + c] = db3[c];
  if (t == 0) part[kOffDw3 + c3] = (float)tiles;
}

// Pass 2: dW3 [k][c] = Σ over objects of h2[slot(o, c)][k]·dout[o, c] where
// channel c of object o is live, NaN where a listed row's h2[k] is not
// finite. Lane: channel 32·blockIdx.y + lane; warp: k 16·warp..; objects
// blockIdx.x, + gridDim.x, ..., four in flight; slice blockIdx.x of scratch
// gets the block's columns of dW3 [128, c3].
__global__ void __launch_bounds__(kThreads)
pointnet_dw3_f32_kernel(const float* __restrict__ h2g, const int* __restrict__ slotg,
                        const uint32_t* __restrict__ hbadg, const float* __restrict__ dout,
                        float* __restrict__ scratch, int o, int c3, int rcap) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c = 32 * blockIdx.y + lane, k0 = 16 * warp;
  const bool in = c < c3;
  const float qnan = __int_as_float(0x7fffffff);
  float acc[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) acc[j] = 0.f;
  for (int ob = blockIdx.x; ob < o; ob += 4 * gridDim.x) {
    int s[4];
    uint32_t hb[4];
    float d[4];
    float4 h[4][4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int obj = ob + u * gridDim.x;
      s[u] = obj < o && in ? slotg[(size_t)obj * c3 + c] : -1;
      hb[u] = obj < o ? (hbadg[(size_t)obj * 4 + warp / 2] >> (16 * (warp % 2))) & 0xffffu : 0u;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int obj = ob + u * gridDim.x;
      d[u] = s[u] >= 0 ? dout[(size_t)obj * c3 + c] : 0.f;
      const float4* src = reinterpret_cast<const float4*>(
          h2g + ((size_t)(s[u] >= 0 ? obj : 0) * rcap + (s[u] >= 0 ? s[u] : 0)) * kC2 + k0);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        h[u][e] = s[u] >= 0 ? __ldg(src + e) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (s[u] >= 0) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[4 * e] = fmaf(h[u][e].x, d[u], acc[4 * e]);
          acc[4 * e + 1] = fmaf(h[u][e].y, d[u], acc[4 * e + 1]);
          acc[4 * e + 2] = fmaf(h[u][e].z, d[u], acc[4 * e + 2]);
          acc[4 * e + 3] = fmaf(h[u][e].w, d[u], acc[4 * e + 3]);
        }
      }
      if (hb[u]) {
#pragma unroll
        for (int j = 0; j < 16; ++j)
          if ((hb[u] >> j) & 1u) acc[j] += qnan;
      }
    }
  }
  if (in) {
    float* part = scratch + (size_t)blockIdx.x * slice_stride((long long)kC2 * c3);
#pragma unroll
    for (int j = 0; j < 16; ++j) part[(size_t)(k0 + j) * c3 + c] = acc[j];
  }
}

// The gradient buffer: entry e sums its pass-1 slices (dw1, db1, dw2, db2,
// db3, the tile count) or pass-2 slices (dw3): warp w of the entry's block
// takes slices w, w + 8, ... in order, then warp 0 adds the eight partial
// sums in warp order. 32 entries a block, a lane each.
__global__ void __launch_bounds__(kThreads)
pointnet_reduce_f32_kernel(const float* __restrict__ s1, long long stride1, int n1,
                           const float* __restrict__ s2, long long stride2, int n2,
                           float* __restrict__ grads, int c3) {
  __shared__ float parts[kThreads / 32][32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int total = pointnet_grad::total(c3), e = 32 * blockIdx.x + lane;
  const bool dw3 = e >= kOffDw3 && e < off_db3(c3);
  const float* src = dw3 ? s2 : s1;
  const long long stride = dw3 ? stride2 : stride1;
  const int n = dw3 ? n2 : n1;
  const int idx = e < kOffDw3 ? e : dw3 ? e - kOffDw3 : e - off_db3(c3) + kOffDw3;
  float sum = 0.f;
  if (e < total) {
#pragma unroll 4
    for (int b = warp; b < n; b += kThreads / 32) sum += src[(size_t)b * stride + idx];
  }
  parts[warp][lane] = sum;
  __syncthreads();
  if (warp == 0 && e < total) {
    float s = parts[0][lane];
#pragma unroll
    for (int w = 1; w < kThreads / 32; ++w) s += parts[w][lane];
    grads[e] = s;
  }
}

// Pass 1: one block per SM, at most one per object. Pass 2: (blocks per
// channel group) × ⌈c3 / 32⌉ blocks, about two waves. The work buffer holds
// W3ᵀ, both passes' slices, the h2 rows, the slots and the h2 flags.
struct F32Plan {
  int grid1, grid2x, grid2y, rcap;
  size_t smem, w3t, s1, s2, h2, slots, hbad, bytes;
};

__host__ __device__ constexpr size_t up256(size_t n) { return (n + 255) & ~size_t(255); }

int f32_plan(int o, int p, int c3, F32Plan* pl) {
  if (o < 1 || p < 1 || c3 < 1) return (int)cudaErrorInvalidValue;
  pl->smem = BwdSmem(p, c3).bytes;
  if (pl->smem > kSmemMax) return (int)cudaErrorInvalidValue;  // P or C3 too large
  if (int rc = allow_smem(pointnet_bwd_f32_kernel, pl->smem)) return rc;
  int dev = 0, sms = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  pl->grid1 = resident_grid(pointnet_bwd_f32_kernel, kThreads, pl->smem, o);
  pl->rcap = (int)(((p < c3 ? p : c3) + kTile - 1) / kTile * kTile);
  pl->grid2y = (c3 + 31) / 32;
  const int per = (2 * sms + pl->grid2y - 1) / pl->grid2y;
  pl->grid2x = per < o ? per : o;
  size_t b = 0;
  pl->w3t = b;
  b = up256(b + sizeof(float) * kC2 * (size_t)c3);
  pl->s1 = b;
  b = up256(b + sizeof(float) * (size_t)pl->grid1 * slice_stride(pass1_floats(c3)));
  pl->s2 = b;
  b = up256(b + sizeof(float) * (size_t)pl->grid2x * slice_stride((long long)kC2 * c3));
  pl->h2 = b;
  b = up256(b + sizeof(float) * (size_t)o * pl->rcap * kC2);
  pl->slots = b;
  b = up256(b + sizeof(int) * (size_t)o * c3);
  pl->hbad = b;
  pl->bytes = b + sizeof(uint32_t) * 4 * (size_t)o;
  return 0;
}

int launch_bwd_f32(const float* x, const float* dout, const int* amax, const float* peak,
                   const float* w1, const float* b1, const float* w2, const float* b2,
                   const float* w3, void* work, float* grads, int o, int p, int c3,
                   cudaStream_t st) {
  F32Plan pl;
  if (int rc = f32_plan(o, p, c3, &pl)) return rc;
  if (((uintptr_t)w2 | (uintptr_t)work) & 15) return (int)cudaErrorMisalignedAddress;
  unsigned char* wk = static_cast<unsigned char*>(work);
  float* w3t = reinterpret_cast<float*>(wk + pl.w3t);
  float* s1 = reinterpret_cast<float*>(wk + pl.s1);
  float* s2 = reinterpret_cast<float*>(wk + pl.s2);
  float* h2g = reinterpret_cast<float*>(wk + pl.h2);
  int* slots = reinterpret_cast<int*>(wk + pl.slots);
  uint32_t* hbad = reinterpret_cast<uint32_t*>(wk + pl.hbad);
  const int tgrid = (kC2 * c3 + kThreads - 1) / kThreads;
  transpose_w3_kernel<<<tgrid < 512 ? tgrid : 512, kThreads, 0, st>>>(w3, w3t, c3);
  if (int rc = (int)cudaGetLastError()) return rc;
  pointnet_bwd_f32_kernel<<<pl.grid1, kThreads, pl.smem, st>>>(
      x, dout, amax, peak, w1, b1, w2, b2, w3t, s1, h2g, slots, hbad, o, p, c3, pl.rcap);
  if (int rc = (int)cudaGetLastError()) return rc;
  pointnet_dw3_f32_kernel<<<dim3(pl.grid2x, pl.grid2y), kThreads, 0, st>>>(
      h2g, slots, hbad, dout, s2, o, c3, pl.rcap);
  if (int rc = (int)cudaGetLastError()) return rc;
  const int total = pointnet_grad::total(c3);
  pointnet_reduce_f32_kernel<<<(total + 31) / 32, kThreads, 0, st>>>(
      s1, slice_stride(pass1_floats(c3)), pl.grid1, s2, slice_stride((long long)kC2 * c3),
      pl.grid2x, grads, c3);
  return (int)cudaGetLastError();
}

}  // namespace

int launch_pointnet_fwd_sm90(const void* x, const void* w1, const void* b1, const void* w2,
                             const void* b2, const void* w3, const void* b3, float* out,
                             int* amax, int o, int p, int c3, cudaStream_t st);
long long pointnet_bwd_sm90_work_bytes(int o, int p, int c3);
int launch_pointnet_bwd_sm90(const void* x, const void* dout, const int* amax, const float* peak,
                             const void* w1, const void* b1, const void* w2, const void* b2,
                             const void* w3, void* work, float* grads, int o, int p, int c3,
                             cudaStream_t st);

}  // namespace sga

extern "C" {

// The flat gradient buffer's length: dw1, db1, dw2, db2, dw3, db3, then the
// row tiles the kernels ran (common.cuh, pointnet_grad).
int sga_pointnet_grad_total(int c3) { return sga::pointnet_grad::total(c3); }

// Bytes of the backward's work buffer for the dtype (f32: this file;
// bf16: pointnet_bwd_sm90.cu); a negative value is a CUDA error code.
long long sga_pointnet_bwd_work_bytes(int o, int p, int c3, int dtype) {
  if (dtype == sga::kBF16) return sga::pointnet_bwd_sm90_work_bytes(o, p, c3);
  sga::F32Plan pl;
  if (int rc = sga::f32_plan(o, p, c3, &pl)) return -rc;
  return (long long)pl.bytes;
}

int sga_pointnet_fwd(const void* x, const void* w1, const void* b1, const void* w2,
                     const void* b2, const void* w3, const void* b3, float* out, int* amax, int o,
                     int p, int c3, int dtype, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == sga::kBF16)
    return sga::launch_pointnet_fwd_sm90(x, w1, b1, w2, b2, w3, b3, out, amax, o, p, c3, st);
  if (o < 1 || p < 1 || c3 < 1) return (int)cudaErrorInvalidValue;
  if ((uintptr_t)w2 & 15) return (int)cudaErrorMisalignedAddress;
  const float *xf = (const float*)x, *w1f = (const float*)w1, *b1f = (const float*)b1,
              *w2f = (const float*)w2, *b2f = (const float*)b2, *w3f = (const float*)w3,
              *b3f = (const float*)b3;
  return amax ? sga::launch_fwd<true>(xf, w1f, b1f, w2f, b2f, w3f, b3f, out, amax, o, p, c3, st)
              : sga::launch_fwd<false>(xf, w1f, b1f, w2f, b2f, w3f, b3f, out, nullptr, o, p, c3,
                                       st);
}

// peak [O, C3] f32: the forward's maxima, whose sign routes both dtypes'
// kernels; work: sga_pointnet_bwd_work_bytes bytes (16-byte aligned); grads:
// sga_pointnet_grad_total floats. bf16 takes C3 a multiple of 16 (the
// wrapper pads), f32 any C3.
int sga_pointnet_bwd(const void* x, const void* dout, const int* amax, const float* peak,
                     const void* w1, const void* b1, const void* w2, const void* b2,
                     const void* w3, void* work, float* grads, int o, int p, int c3, int dtype,
                     void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == sga::kBF16)
    return sga::launch_pointnet_bwd_sm90(x, dout, amax, peak, w1, b1, w2, b2, w3, work, grads, o,
                                         p, c3, st);
  return sga::launch_bwd_f32((const float*)x, (const float*)dout, amax, peak, (const float*)w1,
                             (const float*)b1, (const float*)w2, (const float*)b2,
                             (const float*)w3, work, grads, o, p, c3, st);
}

}  // extern "C"
