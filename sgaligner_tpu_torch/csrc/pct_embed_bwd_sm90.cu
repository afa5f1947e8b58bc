// PCT point embedding, second layer, bf16 backward: the Hopper design of
// embed_second_bwd (see pct_embed.cu for the function and its f32 path).
//
// Replaces sgaligner_tpu/ops/pct_embed.py::_e2_bwd_rule (Pallas kernel
// _e2_bwd_kernel) for bf16 inputs: pre = h0·wf + bf (f32), x0 = relu(pre)
// rounded, h = x0·W1 rounded; dz = dh + m·ds1 + 2·h·m·ds2 rounded (m the
// row's object mask); dW1 = Σ x0ᵀ·dz and dx0 = dz·W1ᵀ (f32), g0 = dx0
// where pre > 0; dh0 = round(g0·wf), dwf = Σ g0·h0, dbf = Σ g0 (f32).
//   Bound on the H100: bytes. h0 and dh read, dh0 written, 768 bytes a row
//   against 3·2·128·128 FLOP (128 FLOP/B, below the card's ridge of ~295):
//   0.105 ms at O = 896, P = 512.
//   Design: persistent, one block per SM of two warpgroups that work
//   independently, each over its own flat 64-row tiles of [O·P, 128] (tile
//   blockIdx.x + c·gridDim.x, then every 2·gridDim.x-th), fed by its own
//   2-stage TMA / mbarrier ring (a stage is one tile's h0 and dh, [64, 64]
//   boxes of 128-byte rows, swizzled): one thread issues the next tile's
//   loads as the warpgroup starts a tile, so one warpgroup's products and
//   CUDA-core work overlap the other's and the loads in flight. W1ᵀ stays
//   resident once (32 KB): the K-major B operand of h = x0·W1 and, read
//   MN-major (desc_mn), the B operand of dx0 = dz·W1ᵀ. dW1 = Σ x0ᵀ·dz needs
//   x0 and dz as shared-memory operands, so every product reads them from
//   there: each thread applies the prologue in f32 (wf and bf from shared
//   memory, as embed_second) to the h0 words of its accumulator rows and
//   columns and writes x0 to its warpgroup's tile (rows past O·P: 0);
//   h = x0·W1 is eight wgmma m64n128k16; dz is formed in registers from h's
//   accumulators, dh's words and each row's mask (looked up once per tile:
//   a tile may straddle objects) and written over dh. Each warpgroup holds
//   all of its dW1 in registers (128 a thread, 256 threads a block) over
//   all of its tiles and adds a tile's x0ᵀ·dz while it runs the epilogue of
//   dx0's first N = 64 half: pre recomputed from h0 in the stage, dh0 =
//   round(g0·wf) written into the h0 words just read (a staging tile for
//   16-byte row stores), the dwf, dbf column sums from the registers
//   (per-thread two-row sums, the shuffle butterfly, one share per warp).
//   At the end each warpgroup writes one slice (dW1, dwf, dbf) that
//   reduce_slices adds in order: no atomics, the same bits twice.
#include "common.cuh"
#include "hopper.cuh"

namespace sga {
namespace {

using namespace sm90;

constexpr int kC = 128;
constexpr int kTile = 64;
constexpr int kThreads = 256;  // two warpgroups, each feeding itself
constexpr uint32_t kBox = kTile * 64 * 2;   // 8 KB, [64 rows, 64] with 128-byte rows
constexpr uint32_t kRowTile = 2 * kBox;     // 16 KB, [64 rows, 128]
constexpr uint32_t kStage = 2 * kRowTile;   // h0 tile, then dh (later dz)
constexpr int kGrad = kC * kC + 2 * kC;     // dW1, dwf, dbf
constexpr long long kGradStride = slice_stride(kGrad);

struct E2bSmem {
  static constexpr size_t w_off = 0;                           // W1ᵀ, two [128, 64] boxes
  static constexpr size_t ring_off = w_off + 2 * kRowTile;     // [2 warpgroups][2 stages]
  static constexpr size_t x_off = ring_off + 4 * kStage;       // [2] x0 tiles
  static constexpr size_t red_off = x_off + 2 * kRowTile;      // [8 warps][256] sums
  static constexpr size_t vec_off = red_off + 8 * 2 * kC * 4;  // (wf, bf) pairs; ds1; ds2
  static constexpr size_t bar_off = vec_off + kC * 4 + 2 * kC * 4;
  static constexpr size_t bytes = bar_off + 4 * 8 + 1024;
};

__global__ void __launch_bounds__(kThreads, 1)
embed_second_bwd_wgmma_kernel(const __grid_constant__ CUtensorMap hm,
                              const __grid_constant__ CUtensorMap dm, const bf16* __restrict__ wf,
                              const bf16* __restrict__ bf, const bf16* __restrict__ w,
                              const bf16* __restrict__ mask, const float* __restrict__ ds1,
                              const float* __restrict__ ds2, bf16* __restrict__ dh0,
                              float* __restrict__ scratch, int rows, int p) {
  using L = E2bSmem;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  float* red = reinterpret_cast<float*>(smem + L::red_off);
  uint2* wb = reinterpret_cast<uint2*>(smem + L::vec_off);  // (wf, bf) of columns 2j, 2j + 1
  float* d1s = reinterpret_cast<float*>(smem + L::vec_off + kC * 4);
  float* d2s = d1s + kC;
  const unsigned char* wt = smem + L::w_off;

  stage_transposed<kC, kC>(reinterpret_cast<bf16*>(smem + L::w_off), w);
  for (int i = threadIdx.x; i < 8 * 2 * kC; i += blockDim.x) red[i] = 0.f;
  for (int j = threadIdx.x; j < kC / 2; j += blockDim.x)
    wb[j] = make_uint2(pack_bf16(__bfloat162float(wf[2 * j]), __bfloat162float(wf[2 * j + 1])),
                       pack_bf16(__bfloat162float(bf[2 * j]), __bfloat162float(bf[2 * j + 1])));
  for (int i = threadIdx.x; i < kC; i += blockDim.x) {
    d1s[i] = ds1[i];
    d2s[i] = ds2[i];
  }
  fence_proxy_async();
  if (threadIdx.x == 0) {
    for (int i = 0; i < 4; ++i) mbar_init(reinterpret_cast<uint64_t*>(smem + L::bar_off) + i, 1);
    mbar_fence_init();
  }
  __syncthreads();
  const int c = threadIdx.x / 128, t = threadIdx.x % 128;
  const int warp = t / 32, lane = t % 32, q = lane % 4;
  const int rl = 16 * warp + lane / 4;  // this thread's rows: rl and rl + 8
  const int tiles = (rows + kTile - 1) / kTile, stride = 2 * gridDim.x;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::bar_off) + 2 * c;
  float* wred = red + (4 * c + warp) * 2 * kC;  // this warp's share: [2 halves][4][32]
  uint32_t* xt = reinterpret_cast<uint32_t*>(smem + L::x_off + c * kRowTile);
  const unsigned char* xs = smem + L::x_off + c * kRowTile;
  // tile `tile`, the warpgroup's i-th, into its stage i % 2 (one thread)
  auto issue = [&](int tile, uint32_t i) {
    if (t != 0) return;
    unsigned char* sp = smem + L::ring_off + (2 * c + (i & 1)) * kStage;
    uint64_t* bar = full + (i & 1);
    mbar_expect_tx(bar, kStage);
    tma_load_2d(sp, &hm, bar, 0, tile * kTile);
    tma_load_2d(sp + kBox, &hm, bar, 64, tile * kTile);
    tma_load_2d(sp + kRowTile, &dm, bar, 0, tile * kTile);
    tma_load_2d(sp + kRowTile + kBox, &dm, bar, 64, tile * kTile);
  };
  float dw[128];  // dW1 of this warpgroup's tiles: [k half][n half][accumulator]
#pragma unroll
  for (int i = 0; i < 128; ++i) dw[i] = 0.f;

  int tile = blockIdx.x + c * gridDim.x;
  if (tile < tiles) issue(tile, 0);
  for (uint32_t i = 0; tile < tiles; tile += stride, ++i) {
    if (tile + stride < tiles) issue(tile + stride, i + 1);  // its stage left free last tile
    uint32_t* ht = reinterpret_cast<uint32_t*>(smem + L::ring_off + (2 * c + (i & 1)) * kStage);
    uint32_t* dt = ht + kRowTile / 4;
    const unsigned char* zt = reinterpret_cast<const unsigned char*>(dt);
    const int row0 = tile * kTile;
    bool valid[2];
    float mh[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + rl + 8 * h;
      valid[h] = row < rows;
      mh[h] = valid[h] ? __bfloat162float(mask[row / p]) : 0.f;
    }
    mbar_wait(full + (i & 1), (i >> 1) & 1u);

    // x0 = round(relu(h0·wf + bf)) into this warpgroup's x0 tile (rows past
    // O·P zero), each thread the words of its accumulator rows and columns:
    // the A operand of x0·W1 and of dW1
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int at = x_word(rl + 8 * (r % 2), 16 * kk + 8 * (r / 2) + 2 * q);
        const uint32_t hv = ht[at];
        const uint2 v = wb[8 * kk + 4 * (r / 2) + q];
        xt[at] = valid[r % 2]
                     ? pack_bf16(fmaxf(fmaf(lo_bf16(hv), lo_bf16(v.x), lo_bf16(v.y)), 0.f),
                                 fmaxf(fmaf(hi_bf16(hv), hi_bf16(v.x), hi_bf16(v.y)), 0.f))
                     : 0u;
      }
    fence_proxy_async();
    bar_sync(1 + c, 128);  // the x0 tile is complete
    float acc[64];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      wgmma_m64n128k16_ss(acc, desc(xs + (kk / 4) * kBox, kSw128, (kk % 4) * 32),
                          desc(wt + (kk / 4) * kRowTile, kSw128, (kk % 4) * 32), kk != 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);

    // dz = round(dh + m·ds1 + 2·h·m·ds2), h = round(x0·W1), over dh's words
    // in the stage: the A operand of dz·W1ᵀ and the B operand of dW1
#pragma unroll
    for (int g = 0; g < 16; ++g) {  // columns 8g + 2q and + 1
      const int col = 8 * g + 2 * q;
      const float2 d1 = *reinterpret_cast<const float2*>(d1s + col);
      const float2 d2 = *reinterpret_cast<const float2*>(d2s + col);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int at = x_word(rl + 8 * h, col);
        const uint32_t dv = dt[at];
        const float m = mh[h];
        const float h0v = round_to<bf16>(acc[4 * g + 2 * h]);
        const float h1v = round_to<bf16>(acc[4 * g + 2 * h + 1]);
        dt[at] = valid[h] ? pack_bf16(lo_bf16(dv) + m * d1.x + 2.f * h0v * (m * d2.x),
                                      hi_bf16(dv) + m * d1.y + 2.f * h1v * (m * d2.y))
                          : 0u;
      }
    }
    fence_proxy_async();
    bar_sync(1 + c, 128);  // the dz tile is complete

    // dx0 = dz·W1ᵀ in two N = 64 halves (W1ᵀ's boxes read MN-major); dW1 +=
    // x0ᵀ·dz runs in the tensor cores during the first half's epilogue. Per
    // half: g0 = dx0 where pre > 0, dh0 = round(g0·wf) into the h0 words just
    // read (a staging tile), Σ g0·h0 and Σ g0 per column into this warp's
    // share
#pragma unroll
    for (int hx = 0; hx < 2; ++hx) {
      float dx[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        wgmma_m64n64k16_ss_t<0, 1>(dx, desc(zt + (kk / 4) * kBox, kSw128, (kk % 4) * 32),
                                   desc_mn(wt + hx * kRowTile, kSw128, 16 * kk, 0), kk != 0);
      wgmma_commit();
      if (hx == 0) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int mb = 0; mb < 2; ++mb)
#pragma unroll
            for (int nb = 0; nb < 2; ++nb)
              wgmma_m64n64k16_ss_t<1, 1>(dw + 64 * mb + 32 * nb,
                                         desc_mn(xs + mb * kBox, kSw128, 16 * kk, 0),
                                         desc_mn(zt + nb * kBox, kSw128, 16 * kk, 0), 1);
        wgmma_commit();
        wgmma_wait<1>();
      } else {
        wgmma_wait<0>();
        fence_regs(dw);
      }
      fence_regs(dx);
      float v[32];  // Σ g0·h0 of the half's 16 columns of this thread, then Σ g0
#pragma unroll
      for (int g = 0; g < 8; ++g) {
        const int col = 64 * hx + 8 * g + 2 * q;
        const uint2 wv = wb[col / 2];
        const float w0 = lo_bf16(wv.x), w1 = hi_bf16(wv.x), c0 = lo_bf16(wv.y), c1 = hi_bf16(wv.y);
        v[2 * g] = v[2 * g + 1] = v[16 + 2 * g] = v[16 + 2 * g + 1] = 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int at = x_word(rl + 8 * h, col);
          const uint32_t hv = ht[at];
          const float e0 = lo_bf16(hv), e1 = hi_bf16(hv);
          const float g0 = valid[h] && fmaf(e0, w0, c0) > 0.f ? dx[4 * g + 2 * h] : 0.f;
          const float g1 = valid[h] && fmaf(e1, w1, c1) > 0.f ? dx[4 * g + 2 * h + 1] : 0.f;
          ht[at] = pack_bf16(g0 * w0, g1 * w1);
          v[2 * g] += g0 * e0;
          v[2 * g + 1] += g1 * e1;
          v[16 + 2 * g] += g0;
          v[16 + 2 * g + 1] += g1;
        }
      }
      float cs[4];
      lane_column_sums(v, cs, lane);
#pragma unroll
      for (int k = 0; k < 4; ++k) wred[(4 * hx + k) * 32 + lane] += cs[k];
    }
    bar_sync(1 + c, 128);  // the staging tile is complete
    for (int idx = t; idx < kTile * (kC / 8); idx += 128) {
      const int r = idx / (kC / 8), q8 = idx % (kC / 8);
      if (row0 + r < rows)
        *reinterpret_cast<uint4*>(dh0 + ((size_t)row0 + r) * kC + 8 * q8) =
            *reinterpret_cast<const uint4*>(ht + x_word(r, 8 * q8));
    }
    fence_proxy_async();  // the stage's generic accesses before the next TMA fills it
    bar_sync(1 + c, 128);  // ... and the x0 tile's before the next tile's x0
  }

  float* part = scratch + (size_t)(2 * blockIdx.x + c) * kGradStride;
#pragma unroll
  for (int i = 0; i < 128; i += 2) {
    const int sub = i % 32;
    const int row = 64 * (i / 64) + 16 * warp + lane / 4 + 8 * ((sub / 2) % 2);
    const int col = 64 * ((i / 32) % 2) + 8 * (sub / 4) + 2 * q;
    *reinterpret_cast<float2*>(part + (size_t)row * kC + col) = make_float2(dw[i], dw[i + 1]);
  }
  bar_sync(1 + c, 128);  // the four warps' shares of the column sums are in
  // dwf, dbf of channel t: the warpgroup's four shares in warp order. Half
  // hx = t / 64 of a share holds, at (k, lane), value 4·(lane / 4) + k of
  // lane_column_sums's 32: Σ g0·h0 of the thread's column 2g + e (channel
  // 64hx + 8g + 2·(lane % 4) + e), then Σ g0
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int hx = t / 64, idx = 2 * ((t % 64) / 8) + t % 2 + 16 * s;
    const int at = (4 * hx + idx % 4) * 32 + 4 * (idx / 4) + (t % 8) / 2;
    float sum = 0.f;
#pragma unroll
    for (int wp = 0; wp < 4; ++wp) sum += red[(4 * c + wp) * 2 * kC + at];
    part[kC * kC + s * kC + t] = sum;
  }
}

}  // namespace

// bf16 embed_second_bwd: h0, dh, dh0 [O·P, 128]; scratch: `slices` slices of
// slice_stride(128·128 + 256) floats, two per block (one per warpgroup),
// which reduce_slices adds in order into grads (dW1, dwf, dbf)
int launch_embed_second_bwd_sm90(const void* h0, const void* wf, const void* bf, const void* w,
                                 const void* mask, const void* dh, const float* ds1,
                                 const float* ds2, void* dh0, float* scratch, int slices,
                                 float* grads, int o, int p, cudaStream_t st) {
  const long long rows = (long long)o * p;
  if (slices < 2 || slices % 2 || rows >= (1LL << 31) - 2 * kTile)
    return (int)cudaErrorInvalidValue;
  if ((uintptr_t)w & 15) return (int)cudaErrorMisalignedAddress;
  CUtensorMap hm, dm;
  const uint64_t dims[2] = {kC, (uint64_t)rows};
  const uint64_t strides[1] = {kC * 2};
  const uint32_t box[2] = {64, kTile};
  if (int rc = make_map(&hm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, h0, dims, strides, box,
                        CU_TENSOR_MAP_SWIZZLE_128B))
    return rc;
  if (int rc = make_map(&dm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, dh, dims, strides, box,
                        CU_TENSOR_MAP_SWIZZLE_128B))
    return rc;
  if (int rc = allow_smem(embed_second_bwd_wgmma_kernel, E2bSmem::bytes)) return rc;
  embed_second_bwd_wgmma_kernel<<<slices / 2, kThreads, E2bSmem::bytes, st>>>(
      hm, dm, (const bf16*)wf, (const bf16*)bf, (const bf16*)w, (const bf16*)mask, ds1, ds2,
      (bf16*)dh0, scratch, (int)rows, p);
  if (int rc = (int)cudaGetLastError()) return rc;
  return reduce_slices(scratch, kGradStride, slices, grads, kGrad, st);
}

}  // namespace sga
