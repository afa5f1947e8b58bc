// PCT point embedding, second layer, bf16: the Hopper design of
// embed_second (see pct_embed.cu for the function and its f32 path).
//
// Replaces sgaligner_tpu/ops/pct_embed.py::embed_second_fused (Pallas kernel
// _e2_fwd_kernel) for bf16 inputs: x0 = round(relu(h0·wf + bf)) at f32,
// h1 = round(x0·W1) with f32 accumulation, and the masked sums Σ m·h1,
// Σ m·h1² of the rounded values (f32).
//   Bound on the H100: bytes. h0 read and h1 written once, 512 bytes a row
//   against 2·128·128 FLOP (64 FLOP/B, below the card's ridge of ~295):
//   3.52 GB, 1.05 ms at O = 13,440, P = 512.
//   Design: persistent, one block per SM over 64-row tiles of the flat
//   [O·P, 128] activation: a producer warp feeds the tiles through an
//   8-stage TMA / mbarrier ring (two [64, 64] boxes of 128-byte rows,
//   swizzled), and two consumer warpgroups take them in turn, consumer c
//   the stages of parity c (an even depth: each stage has one consumer, and
//   each consumer three tiles in flight ahead of the one it reads). W1
//   stays resident, transposed to the K-major B operand (32 KB). Each
//   thread reads its A fragments of the tile from shared memory (32-bit
//   words, conflict-free in the swizzle), applies the prologue in f32 with
//   wf and bf from shared memory, rounds, and the packed words are the register-A
//   operand of h1 = x0·W1 (eight wgmma m64n128k16). The epilogue rounds the
//   accumulators in registers, writes them through a staging tile in
//   16-byte rows, and takes the masked sums from the same registers: each
//   thread's two rows look up their object's mask once per tile (a tile
//   may straddle objects when P % 64 ≠ 0; rows past O·P count 0), lanes
//   reduce columns by shuffles, warps keep their share in shared memory,
//   and each warpgroup writes one scratch slice that reduce_slices adds in
//   order: no atomics, the same bits twice.
#include "common.cuh"
#include "hopper.cuh"

namespace sga {
namespace {

using namespace sm90;

constexpr int kC = 128;
constexpr int kTile = 64;
constexpr int kThreads = 288;  // 2 consumer warpgroups + a producer warp
constexpr int kStages = 8;
constexpr uint32_t kBox = kTile * 64 * 2;   // 8 KB, [64 rows, 64] with 128-byte rows
constexpr uint32_t kRowTile = 2 * kBox;     // 16 KB, [64 rows, 128]
constexpr long long kSumStride = slice_stride(2 * kC);  // one warpgroup's Σh, Σh²

using E2Ring = Ring<kStages>;

struct E2Bars {
  uint64_t full[kStages], empty[kStages];
  __device__ void init() {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, 4);  // one arrival per warp of the stage's consumer
    }
    mbar_fence_init();
  }
};

struct E2Smem {
  static constexpr size_t w_off = 0;                                // W1ᵀ, two [128, 64] boxes
  static constexpr size_t ring_off = w_off + 2 * kRowTile;          // h0 tiles
  static constexpr size_t out_off = ring_off + kStages * kRowTile;  // [2] staging tiles
  static constexpr size_t red_off = out_off + 2 * kRowTile;         // [8 warps][256] sums
  static constexpr size_t vec_off = red_off + 8 * 2 * kC * 4;       // (wf, bf) word pairs
  static constexpr size_t bar_off = vec_off + kC * 4;
  static constexpr size_t bytes = bar_off + sizeof(E2Bars) + 1024;
};

__global__ void __launch_bounds__(kThreads, 1)
embed_second_wgmma_kernel(const __grid_constant__ CUtensorMap hm, const bf16* __restrict__ wf,
                          const bf16* __restrict__ bf, const bf16* __restrict__ w,
                          const bf16* __restrict__ mask, bf16* __restrict__ h1,
                          float* __restrict__ scratch, int rows, int p) {
  using L = E2Smem;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  E2Bars& b = *reinterpret_cast<E2Bars*>(smem + L::bar_off);
  float* red = reinterpret_cast<float*>(smem + L::red_off);
  // (wf, bf) of columns 2j, 2j + 1 as the packed word pair j
  uint2* wb = reinterpret_cast<uint2*>(smem + L::vec_off);

  stage_transposed<kC, kC>(reinterpret_cast<bf16*>(smem + L::w_off), w);
  for (int i = threadIdx.x; i < 8 * 2 * kC; i += blockDim.x) red[i] = 0.f;
  for (int j = threadIdx.x; j < kC / 2; j += blockDim.x)
    wb[j] = make_uint2(pack_bf16(__bfloat162float(wf[2 * j]), __bfloat162float(wf[2 * j + 1])),
                       pack_bf16(__bfloat162float(bf[2 * j]), __bfloat162float(bf[2 * j + 1])));
  fence_proxy_async();
  if (threadIdx.x == 0) b.init();
  __syncthreads();
  const int tiles = (rows + kTile - 1) / kTile;
  const int c = threadIdx.x / 128, t = threadIdx.x % 128;  // c = 2: the producer warp

  if (c == 2) {
    if (t != 0) return;
    uint32_t n = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++n) {
      const int st = E2Ring::stage(n);
      unsigned char* sp = smem + L::ring_off + st * kRowTile;
      mbar_wait(b.empty + st, E2Ring::empty_parity(n));
      mbar_expect_tx(b.full + st, kRowTile);
      tma_load_2d(sp, &hm, b.full + st, 0, tile * kTile);
      tma_load_2d(sp + kBox, &hm, b.full + st, 64, tile * kTile);
    }
    return;
  }

  const int warp = t / 32, lane = t % 32, q = lane % 4;
  const int rl = 16 * warp + lane / 4;  // this thread's rows: rl and rl + 8
  uint32_t* stage_tile = reinterpret_cast<uint32_t*>(smem + L::out_off + c * kRowTile);
  float* wred = red + (4 * c + warp) * 2 * kC;

  uint32_t n = c;
  for (int tile = blockIdx.x + c * gridDim.x; tile < tiles; tile += 2 * gridDim.x, n += 2) {
    const int st = E2Ring::stage(n);
    const uint32_t* ht = reinterpret_cast<const uint32_t*>(smem + L::ring_off + st * kRowTile);
    // the masks of this thread's rows (each row's object looked up once;
    // rows past O·P count 0), loaded ahead of the product
    const int row0 = tile * kTile;
    float mh[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + rl + 8 * h;
      mh[h] = row < rows ? __bfloat162float(mask[row / p]) : 0.f;
    }
    mbar_wait(b.full + st, E2Ring::full_parity(n));
    // x0 = round(relu(h0·wf + bf)) as the A fragments of x0·W1: a[kk][r]
    // holds row rl + 8·(r % 2), columns 16kk + 8·(r / 2) + 2q and + 1
    uint32_t a[8][4];
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const uint32_t hv = ht[x_word(rl + 8 * (r % 2), 16 * kk + 8 * (r / 2) + 2 * q)];
        const uint2 v = wb[8 * kk + 4 * (r / 2) + q];
        a[kk][r] = pack_bf16(fmaxf(fmaf(lo_bf16(hv), lo_bf16(v.x), lo_bf16(v.y)), 0.f),
                             fmaxf(fmaf(hi_bf16(hv), hi_bf16(v.x), hi_bf16(v.y)), 0.f));
      }
    __syncwarp();
    if (lane == 0) mbar_arrive(b.empty + st);  // this warp has read the stage
    float acc[64];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      wgmma_m64n128k16_rs(acc, a[kk], desc(smem + L::w_off + (kk / 4) * kRowTile, kSw128,
                                           (kk % 4) * 32),
                          kk != 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);

    // h1 rounded into the staging tile; the masked sums of its rows
    bar_sync(1 + c, 128);  // the last tile's rows have left the staging tile
    float s1[32], s2[32];
#pragma unroll
    for (int g = 0; g < 16; ++g) {  // columns 8g + 2q and + 1
      uint32_t hw[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        hw[h] = pack_bf16(acc[4 * g + 2 * h], acc[4 * g + 2 * h + 1]);
        stage_tile[x_word(rl + 8 * h, 8 * g + 2 * q)] = hw[h];
      }
      row_pair_sums(hw, mh, s1 + 2 * g, s2 + 2 * g);
    }
    bar_sync(1 + c, 128);
    for (int idx = t; idx < kTile * (kC / 8); idx += 128) {
      const int r = idx / (kC / 8), q8 = idx % (kC / 8);
      if (row0 + r < rows)
        *reinterpret_cast<uint4*>(h1 + ((size_t)row0 + r) * kC + 8 * q8) =
            *reinterpret_cast<const uint4*>(stage_tile + x_word(r, 8 * q8));
    }
    add_column_sums(wred, s1, s2, lane);
  }
  bar_sync(1 + c, 128);
  store_column_sums(red + 4 * c * 2 * kC, scratch + (size_t)(2 * blockIdx.x + c) * kSumStride, t);
}

}  // namespace

// bf16 embed_second: h0, h1 [O·P, 128]; scratch: `slices` slices of
// slice_stride(256) floats, two per block (one per consumer warpgroup),
// which reduce_slices adds in order into sums [2, 128]
int launch_embed_second_sm90(const void* h0, const void* wf, const void* bf, const void* w,
                             const void* mask, void* h1, float* scratch, int slices, float* sums,
                             int o, int p, cudaStream_t st) {
  const long long rows = (long long)o * p;
  if (slices < 2 || slices % 2 || rows >= (1LL << 31) - kTile) return (int)cudaErrorInvalidValue;
  // stage_transposed reads the weights in 16-byte vectors
  if ((uintptr_t)w & 15) return (int)cudaErrorMisalignedAddress;
  CUtensorMap hm;
  const uint64_t dims[2] = {kC, (uint64_t)rows};
  const uint64_t strides[1] = {kC * 2};
  const uint32_t box[2] = {64, kTile};
  if (int rc = make_map(&hm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, h0, dims, strides, box,
                        CU_TENSOR_MAP_SWIZZLE_128B))
    return rc;
  if (int rc = allow_smem(embed_second_wgmma_kernel, E2Smem::bytes)) return rc;
  embed_second_wgmma_kernel<<<slices / 2, kThreads, E2Smem::bytes, st>>>(
      hm, (const bf16*)wf, (const bf16*)bf, (const bf16*)w, (const bf16*)mask, (bf16*)h1, scratch,
      (int)rows, p);
  if (int rc = (int)cudaGetLastError()) return rc;
  return reduce_slices(scratch, kSumStride, slices, sums, 2 * kC, st);
}

}  // namespace sga
