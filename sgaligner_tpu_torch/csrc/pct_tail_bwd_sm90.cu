// PCT tail backward, bf16: the wgmma design of pct_tail_bwd (see
// pct_tail.cu for the function and its f32 path).
//
// Replaces sgaligner_tpu/ops/pct_tail.py::_bwd_rule with the forward-saved
// indices (Pallas kernel _bwd_kernel_idx) for bf16 inputs.
//   Bound on the H100: operations, three products of 2·P·512·K per object
//   (z again, dx = g·Wᵀ, dW = xᵀ·g): 1.46 ms at O = 896, P = 512, K = 1024.
//   Design: three kinds of launch, each a TMA ring feeding wgmma with f32
//   accumulators in registers.
//     g: pct_tail_sm90.cu's forward again (its 128-column slice of W
//       resident, transposed; x rows through per-warpgroup rings), with the
//       pool replaced by the gradient in the epilogue: g = dpmax at the
//       saved argmax row + dpmin at the argmin row + m·dsum + 2·z·m·dsumsq
//       (z rounded as the forward rounds it), rounded, staged through a
//       swizzled tile and written once in 16-byte rows (bf16 [O·P, K]);
//     dx: dxᵢ = g·Wᵢᵀ over tiles of 128 rows × two inputs: g (K-major) and
//       W as it is (rows of Wᵢ are K-major) through a 4-stage ring, K
//       streamed in 64-deep chunks;
//     dW: xᵢᵀ·g by pct_block_bwd_sm90.cu's wgrad kernel (both operands
//       MN-major TMA boxes), 256 columns of K a block, the rows split
//       across blocks into scratch slices that reduce_slices adds in
//       order: no atomics, the same bits twice.
#include "common.cuh"
#include "hopper.cuh"

namespace sga {

int launch_transpose_w_sm90(const void* w, void* wt, int k, cudaStream_t st);
int launch_wgrad_sm90(const void* a, int lda, const void* bmat, int ldb, int nb, int bias,
                      long long rows, float* scratch, long long slice, int ld, int m_off,
                      int bias_off, int splits, cudaStream_t st);

namespace {

using namespace sm90;

constexpr int kN = 128;          // columns of K per block (the g pass)
constexpr int kKin = 512;        // depth: 4 inputs of 128 channels
constexpr int kBoxK = 64;        // k per TMA box (128 bytes of bf16)
constexpr int kSteps = kKin / kBoxK;
constexpr int kTile = 64;
constexpr int kStages = 3;
constexpr int kThreads = 384;    // producer warpgroup + 2 consumer warpgroups

constexpr size_t kWBox = (size_t)kN * kBoxK * 2;      // 16 KB
constexpr size_t kXBox = (size_t)kTile * kBoxK * 2;   // 8 KB
constexpr size_t kZTile = (size_t)kTile * kN * 2;     // 16 KB
constexpr size_t kOffW = 0;
constexpr size_t kOffRing = kOffW + kSteps * kWBox;
constexpr size_t kOffZ = kOffRing + 2 * kStages * kXBox;
constexpr size_t kOffVec = kOffZ + 2 * kZTile;        // [2][6][128] per-object vectors
constexpr size_t kOffBar = kOffVec + 2 * 6 * kN * 4;
constexpr int kBars = 1 + 4 * kStages;
constexpr size_t kSmem = kOffBar + kBars * 8 + 1024;

using GRing = Ring<kStages>;

__device__ __forceinline__ int z_word(int r, int w) { return r * (kN / 2) + (w ^ ((r & 7) << 2)); }

// g [O·P, K] of the block's 128-column slice, objects 2g + c, 2g + c +
// 2·groups, ... for consumer c (as the forward walks them)
__global__ void __launch_bounds__(kThreads, 1)
tail_g_wgmma_kernel(const __grid_constant__ CUtensorMap xm1, const __grid_constant__ CUtensorMap xm2,
                    const __grid_constant__ CUtensorMap xm3, const __grid_constant__ CUtensorMap xm4,
                    const __grid_constant__ CUtensorMap wm, const bf16* __restrict__ mask,
                    const float* __restrict__ dpmax, const float* __restrict__ dpmin,
                    const float* __restrict__ dsum, const float* __restrict__ dsumsq,
                    const int* __restrict__ amax, const int* __restrict__ amin,
                    bf16* __restrict__ g, int o, int p, int k, int groups) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + kOffBar);
  uint64_t* wbar = bars;
  uint64_t* full = bars + 1;                 // [2][kStages]
  uint64_t* empty = bars + 1 + 2 * kStages;  // [2][kStages]

  const int slices = k / kN;
  const int n0 = (blockIdx.x % slices) * kN, grp = blockIdx.x / slices;
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  if (threadIdx.x == 0) {
    mbar_init(wbar, 1);
    for (int i = 0; i < 2 * kStages; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, 4);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    const int warp = t / 32;
    if (warp >= 2 || t % 32 != 0) return;
    if (warp == 0) {
      mbar_expect_tx(wbar, (uint32_t)(kSteps * kWBox));
      for (int s = 0; s < kSteps; ++s) tma_load_2d(smem + kOffW + s * kWBox, &wm, wbar, s * kBoxK, n0);
    }
    const CUtensorMap* xm[4] = {&xm1, &xm2, &xm3, &xm4};
    uint64_t* f = full + warp * kStages;
    uint64_t* e = empty + warp * kStages;
    unsigned char* ring = smem + kOffRing + warp * kStages * kXBox;
    uint32_t n = 0;
    for (int obj = 2 * grp + warp; obj < o; obj += 2 * groups)
      for (int r0 = 0; r0 < p; r0 += kTile)
        for (int s = 0; s < kSteps; ++s, ++n) {
          const int st = GRing::stage(n);
          mbar_wait(e + st, GRing::empty_parity(n));
          mbar_expect_tx(f + st, (uint32_t)kXBox);
          tma_load_2d(ring + st * kXBox, xm[s / 2], f + st, (s % 2) * kBoxK, obj * p + r0);
        }
    return;
  }

  const int c = wg - 1, warp = t / 32, lane = t % 32;
  uint64_t* f = full + c * kStages;
  uint64_t* e = empty + c * kStages;
  const unsigned char* ring = smem + kOffRing + c * kStages * kXBox;
  uint32_t* zt = reinterpret_cast<uint32_t*>(smem + kOffZ + c * kZTile);
  float* vec = reinterpret_cast<float*>(smem + kOffVec) + c * 6 * kN;
  int* ivec = reinterpret_cast<int*>(vec);
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  uint32_t n = 0;
  mbar_wait(wbar, 0);

  for (int obj = 2 * grp + c; obj < o; obj += 2 * groups) {
    // this object's routing and BN terms of column n0 + t (the previous
    // tile's readers are past its second barrier)
    {
      const size_t oc = (size_t)obj * k + n0 + t;
      const float m = __bfloat162float(mask[obj]);
      ivec[t] = amax[oc];
      ivec[kN + t] = amin[oc];
      vec[2 * kN + t] = dpmax[oc];
      vec[3 * kN + t] = dpmin[oc];
      vec[4 * kN + t] = m * dsum[n0 + t];
      vec[5 * kN + t] = m * dsumsq[n0 + t];
    }
    for (int r0 = 0; r0 < p; r0 += kTile) {
      fence_regs(acc);
#pragma unroll 1
      for (int s = 0; s < kSteps; ++s, ++n) {
        const int st = GRing::stage(n);
        mbar_wait(f + st, GRing::full_parity(n));
        wgmma_fence();
        const unsigned char* xa = ring + st * kXBox;
        const unsigned char* wb = smem + kOffW + s * kWBox;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_m64n128k16_ss(acc, desc(xa, kSw128, kk * 32), desc(wb, kSw128, kk * 32),
                              (s | kk) != 0);
        wgmma_commit();
        if (s > 0) {
          wgmma_wait<1>();
          if (lane == 0) mbar_arrive(e + GRing::stage(n - 1));
        }
      }
      wgmma_wait<0>();
      fence_regs(acc);
      if (lane == 0) mbar_arrive(e + GRing::stage(n - 1));

      bar_sync(1 + c, 128);  // the previous tile's rows have left the tile
      const int rl = 16 * warp + lane / 4;
#pragma unroll
      for (int i = 0; i < 64; i += 2) {
        const int row = rl + 8 * ((i / 2) % 2), col = 8 * (i / 4) + 2 * (lane % 4);
        const int pt = r0 + row;
        float gv[2];
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2) {
          const int cc = col + e2;
          const float z = __bfloat162float(__float2bfloat16_rn(acc[i + e2]));
          float v = (pt == ivec[cc] ? vec[2 * kN + cc] : 0.f) +
                    (pt == ivec[kN + cc] ? vec[3 * kN + cc] : 0.f);
          v += vec[4 * kN + cc] + 2.f * z * vec[5 * kN + cc];
          gv[e2] = v;
        }
        zt[z_word(row, 4 * (i / 4) + lane % 4)] = pack_bf16(gv[0], gv[1]);
      }
      bar_sync(1 + c, 128);
      const int valid = min(kTile, p - r0);
      for (int idx = t; idx < kTile * (kN / 8); idx += 128) {
        const int r = idx / (kN / 8), q = idx % (kN / 8);
        if (r < valid)
          *reinterpret_cast<uint4*>(g + ((size_t)obj * p + r0 + r) * k + n0 + 8 * q) =
              *reinterpret_cast<const uint4*>(zt + r * (kN / 2) + 4 * (q ^ (r & 7)));
      }
    }
  }
}

// ---------------------------------- dx = g·Wᵀ --------------------------------

constexpr int kDxStages = 4;
using DxRing = Ring<kDxStages>;
constexpr size_t kGBox = (size_t)kTile * kBoxK * 2;     // [64 rows, 64 k], 8 KB
constexpr size_t kWHalf = (size_t)128 * kBoxK * 2;      // [128 rows of W, 64 k], 16 KB
constexpr size_t kDxStage = 2 * kGBox + 2 * kWHalf;     // 48 KB
constexpr size_t kDxSmem = kDxStages * kDxStage + 2 * kDxStages * 8 + 1024;

// Tile (row block of 128, input pair h): consumer c computes rows
// 64c.. of the block against Wᵢ for i = 2h, 2h + 1 (two m64n128
// accumulators), K streamed in 64-deep chunks
__global__ void __launch_bounds__(256 + 32, 1)
tail_dx_wgmma_kernel(const __grid_constant__ CUtensorMap gm, const __grid_constant__ CUtensorMap wm,
                     bf16* __restrict__ dx1, bf16* __restrict__ dx2, bf16* __restrict__ dx3,
                     bf16* __restrict__ dx4, long long rows, int k) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kDxStages * kDxStage);
  uint64_t* empty = full + kDxStages;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kDxStages; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, 8);
    }
    mbar_fence_init();
  }
  __syncthreads();
  const long long tiles = (rows + 127) / 128 * 2;
  const int c = threadIdx.x / 128, t = threadIdx.x % 128;

  if (c == 2) {
    if (t != 0) return;
    uint32_t n = 0;
    for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x)
      for (int k0 = 0; k0 < k; k0 += kBoxK, ++n) {
        const int st = DxRing::stage(n);
        unsigned char* sp = smem + st * kDxStage;
        const int r0 = (int)((tile / 2) * 128), h = (int)(tile % 2);
        mbar_wait(empty + st, DxRing::empty_parity(n));
        mbar_expect_tx(full + st, (uint32_t)kDxStage);
        tma_load_2d(sp, &gm, full + st, k0, r0);
        tma_load_2d(sp + kGBox, &gm, full + st, k0, r0 + 64);
        tma_load_2d(sp + 2 * kGBox, &wm, full + st, k0, 256 * h);
        tma_load_2d(sp + 2 * kGBox + kWHalf, &wm, full + st, k0, 256 * h + 128);
      }
    return;
  }

  const int warp = t / 32, lane = t % 32;
  bf16* const dxs[4] = {dx1, dx2, dx3, dx4};
  uint32_t n = 0;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    float a0[64], a1[64];
    for (int k0 = 0; k0 < k; k0 += kBoxK, ++n) {
      const int st = DxRing::stage(n);
      const unsigned char* sp = smem + st * kDxStage;
      mbar_wait(full + st, DxRing::full_parity(n));
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t da = desc(sp + c * kGBox, kSw128, kk * 32);
        wgmma_m64n128k16_ss(a0, da, desc(sp + 2 * kGBox, kSw128, kk * 32), (k0 | kk) != 0);
        wgmma_m64n128k16_ss(a1, da, desc(sp + 2 * kGBox + kWHalf, kSw128, kk * 32),
                            (k0 | kk) != 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(a0);
      fence_regs(a1);
      if (lane == 0) mbar_arrive(empty + st);
    }
    const long long r0 = (tile / 2) * 128 + 64 * c;
    const int h = (int)(tile % 2);
#pragma unroll
    for (int i = 0; i < 64; i += 2) {
      const long long row = r0 + 16 * warp + lane / 4 + 8 * ((i / 2) % 2);
      const int col = 8 * (i / 4) + 2 * (lane % 4);
      if (row < rows) {
        *reinterpret_cast<uint32_t*>(dxs[2 * h] + row * 128 + col) = pack_bf16(a0[i], a0[i + 1]);
        *reinterpret_cast<uint32_t*>(dxs[2 * h + 1] + row * 128 + col) =
            pack_bf16(a1[i], a1[i + 1]);
      }
    }
  }
}

int map_bf16_2d(CUtensorMap* m, const void* base, long long rows, long long cols, uint32_t box_rows) {
  const uint64_t dims[2] = {(uint64_t)cols, (uint64_t)rows};
  const uint64_t strides[1] = {(uint64_t)cols * 2};
  const uint32_t box[2] = {kBoxK, box_rows};
  return make_map(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, base, dims, strides, box,
                  CU_TENSOR_MAP_SWIZZLE_128B);
}

}  // namespace

// bf16 sga_pct_tail_bwd: g [O·P, K] and wt [K, 512] (bf16) work buffers;
// scratch: `splits` slices of 512·K floats
int launch_tail_bwd_sm90(const void* x1, const void* x2, const void* x3, const void* x4,
                         const void* w, const void* mask, const float* dpmax, const float* dpmin,
                         const float* dsum, const float* dsumsq, const int* amax, const int* amin,
                         void* g, void* wt, void* dx1, void* dx2, void* dx3, void* dx4,
                         float* scratch, int splits, float* dw, int o, int p, int k,
                         cudaStream_t st) {
  if (int rc = launch_transpose_w_sm90(w, wt, k, st)) return rc;
  const long long rows = (long long)o * p;
  const void* xs[4] = {x1, x2, x3, x4};
  CUtensorMap xm[4], wtm, gm, wm;
  for (int i = 0; i < 4; ++i)
    if (int rc = map_bf16_2d(&xm[i], xs[i], rows, 128, kTile)) return rc;
  if (int rc = map_bf16_2d(&wtm, wt, k, kKin, kN)) return rc;
  if (int rc = map_bf16_2d(&gm, g, rows, k, kTile)) return rc;
  if (int rc = map_bf16_2d(&wm, w, kKin, k, 128)) return rc;
  int dev = 0, sms = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);

  const int slices = k / kN;
  int groups = sms / slices;
  if (groups > (o + 1) / 2) groups = (o + 1) / 2;
  if (groups < 1) groups = 1;
  if (int rc = allow_smem(tail_g_wgmma_kernel, kSmem)) return rc;
  tail_g_wgmma_kernel<<<(unsigned)(slices * groups), kThreads, kSmem, st>>>(
      xm[0], xm[1], xm[2], xm[3], wtm, (const bf16*)mask, dpmax, dpmin, dsum, dsumsq, amax, amin,
      (bf16*)g, o, p, k, groups);
  if (int rc = (int)cudaGetLastError()) return rc;

  const long long tiles = (rows + 127) / 128 * 2;
  const int gx = (int)(tiles < sms ? tiles : sms);
  if (int rc = allow_smem(tail_dx_wgmma_kernel, kDxSmem)) return rc;
  tail_dx_wgmma_kernel<<<gx, 256 + 32, kDxSmem, st>>>(gm, wm, (bf16*)dx1, (bf16*)dx2, (bf16*)dx3,
                                                      (bf16*)dx4, rows, k);
  if (int rc = (int)cudaGetLastError()) return rc;

  const long long slice = (long long)kKin * k;
  for (int i = 0; i < 4; ++i)
    if (int rc = launch_wgrad_sm90(xs[i], 128, g, k, 256, 0, rows, scratch, slice, k, 128 * i, 0,
                                   splits, st))
      return rc;
  return reduce_slices(scratch, slice, splits, dw, kKin * k, st);
}

}  // namespace sga
