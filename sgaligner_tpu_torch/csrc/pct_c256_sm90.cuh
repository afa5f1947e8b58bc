// The pieces the bf16 C = 256 wgmma passes share (pct_block_c256_sm90.cu,
// pct_block_bwd_c256_sm90.cu): widths, tile sizes, the energy and
// attention-weight fragments, tile stores and tensor maps.
//
// Tiles in shared memory (all 1024-byte aligned, 128-byte swizzle unless
// said otherwise):
//   a row tile [64 rows, 256] of x, u, dz, a cotangent or a staging tile:
//     four TMA boxes of [64 rows, 64], word x_word(r, col) (hopper.cuh);
//   a q tile [64 rows, 64]: one box;
//   a vᵀ chunk [256 channels, 64 keys]: one box of 256 rows;
//   a weight slice: [256 k, 32 n] (MN-major, 64-byte swizzle: the B operand
//     of u·W with W row-major) or [32 n, 256 k] (K-major: four boxes
//     [32 rows, 64], the B operand of dz·Wᵀ), 16 KB either way.
#pragma once

#include "common.cuh"
#include "hopper.cuh"

namespace sga {
namespace c256 {

using namespace sm90;

constexpr int kC = 256;
constexpr int kDa = 64;
constexpr int kTile = 64;
constexpr int kThreads = 288;  // 2 consumer warpgroups + a producer warp
// The passes whose consumers hold y [64, 128] f32 beside S, G and an
// epilogue's operands: 2 consumer warpgroups and a producer warpgroup that
// gives up its registers (setmaxnreg), so a consumer thread may hold 232
// where 384 threads alone would leave it 168
constexpr int kThreadsWide = 384;
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
static_assert(128 * kProducerRegs + 256 * kConsumerRegs <= 65536, "register file");
constexpr float kLog2e = 1.4426950408889634f;
constexpr size_t kSmemMax = 232448;

constexpr uint32_t kBox = kTile * 64 * 2;         // 8 KB: [64 rows, 64]
constexpr uint32_t kRowTile = 4 * kBox;           // 32 KB: [64 rows, 256]
constexpr uint32_t kQTile = kBox;                 // q [64 rows, 64]
constexpr uint32_t kVtChunk = kC * kTile * 2;     // 32 KB: vᵀ [256, 64 keys]
constexpr uint32_t kVec = kTile * 4;              // 256 B: 64 f32
constexpr uint32_t kWSlot = kC * 32 * 2;          // 16 KB: a 32-column weight slice
constexpr uint32_t kWBox = kC * 64 * 2;           // 32 KB: a [256 k, 64 n] weight box

__host__ __device__ constexpr size_t round1k(size_t n) { return (n + 1023) & ~size_t(1023); }

__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  return raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
}

// accumulator element i of an m64nN wgmma: this thread's row and column
__device__ __forceinline__ int acc_row(int warp, int lane, int i) {
  return 16 * warp + lane / 4 + 8 * ((i / 2) % 2);
}
__device__ __forceinline__ int acc_col(int lane, int i) {
  return 8 * (i / 4) + 2 * (lane % 4) + i % 2;
}

// S = q_I·q_Jᵀ [64, 64] over da = 64 (two q tiles), started, not waited
__device__ __forceinline__ void start_energies(float (&s)[32], const unsigned char* qi,
                                               const unsigned char* qj) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_m64n64k16_ss(s, desc(qi, kSw128, 32 * kk), desc(qj, kSw128, 32 * kk), kk != 0);
  wgmma_commit();
}

// P = A·Bᵀ [64, 64] over the 256 channels of two row tiles, started, not
// waited
__device__ __forceinline__ void start_dp(float (&d)[32], const unsigned char* a,
                                         const unsigned char* b) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 16; ++kk)
    wgmma_m64n64k16_ss(d, desc(a + (kk / 4) * kBox, kSw128, (kk % 4) * 32),
                       desc(b + (kk / 4) * kBox, kSw128, (kk % 4) * 32), kk != 0);
  wgmma_commit();
}

// G[i, j] = exp2(S[i, j]·log2e − l_j) over the 64 keys j of a chunk (the
// first kv live, the rest 0), rounded to bf16: a[kk] is the A fragment of
// k-step kk of a product over the keys. OA: rs[h] += row h's rounded values.
template <bool OA>
__device__ __forceinline__ void softmax_frags(const float (&s)[32], const float* lse, int kv,
                                              int lane, uint32_t (&a)[4][4], float (&rs)[2]) {
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
}

// Word j < 32 of warpgroup half c of a row tile as this thread holds it:
// the pair (2j, 2j + 1) of its m64n128 accumulator over the channels
// 128c.. (row rl + 8·(j % 2), column 128c + 8·(j / 2) + 2·(lane % 4)), the
// layout of y, t, dz and dY in every pass
__device__ __forceinline__ int half_word(int c, int rl, int lane, int j) {
  return x_word(rl + 8 * (j % 2), 128 * c + 8 * (j / 2) + 2 * (lane % 4));
}

// Rows < valid of half c (columns 128c .. 128c + 127) of a row tile to dst
// (row stride 256) in 16-byte pieces; by the 128 threads of warpgroup c
__device__ __forceinline__ void store_half(const uint32_t* tile, bf16* __restrict__ dst,
                                           int valid, int c, int t) {
  for (int idx = t; idx < kTile * 16; idx += 128) {
    const int r = idx / 16, col = 128 * c + 8 * (idx % 16);
    if (r < valid)
      *reinterpret_cast<uint4*>(dst + (size_t)r * kC + col) =
          *reinterpret_cast<const uint4*>(tile + x_word(r, col));
  }
}

// the four boxes of a row tile: rows r0.. of object obj of a 3-D map
__device__ __forceinline__ void load_rows3(unsigned char* dst, const CUtensorMap* m,
                                           uint64_t* bar, int obj, int r0) {
#pragma unroll
  for (int b = 0; b < 4; ++b) tma_load_3d(dst + b * kBox, m, bar, 64 * b, r0, obj);
}

// ------------------------------------ host -----------------------------------

// [O, P, cols] bf16 rows (cols 256 or 64): boxes of [64 rows, 64]
inline int map_rows(CUtensorMap* m, const void* base, int o, int p, int cols) {
  const uint64_t dims[3] = {(uint64_t)cols, (uint64_t)p, (uint64_t)o};
  const uint64_t strides[2] = {(uint64_t)cols * 2, (uint64_t)p * cols * 2};
  const uint32_t box[3] = {64, kTile, 1};
  return make_map(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, base, dims, strides, box,
                  CU_TENSOR_MAP_SWIZZLE_128B);
}

// a row-major [rows, cols] bf16 matrix (row stride ld elements): boxes of
// [box_rows, box_cols] with 128-byte (box_cols 64) or 64-byte (32) swizzle
inline int map_2d(CUtensorMap* m, const void* base, long long rows, int cols, long long ld,
                  int box_rows, int box_cols) {
  const uint64_t dims[2] = {(uint64_t)cols, (uint64_t)rows};
  const uint64_t strides[1] = {(uint64_t)ld * 2};
  const uint32_t box[2] = {(uint32_t)box_cols, (uint32_t)box_rows};
  return make_map(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, base, dims, strides, box,
                  box_cols == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B);
}

// an [O, pp] f32 row vector: boxes of 64
inline int map_vec(CUtensorMap* m, const float* base, int o, int p) {
  const uint64_t pp = (uint64_t)(p + 7) / 8 * 8;
  const uint64_t dims[2] = {(uint64_t)p, (uint64_t)o};
  const uint64_t strides[1] = {pp * 4};
  const uint32_t box[2] = {kTile, 1};
  return make_map(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, base, dims, strides, box,
                  CU_TENSOR_MAP_SWIZZLE_NONE);
}

inline int sm_count() {
  int dev = 0, sms = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

// blocks of a persistent pass: one per SM, at most one per work item
inline int persistent_grid(long long items) {
  const int sms = sm_count();
  return (int)(items < sms ? (items < 1 ? 1 : items) : sms);
}

}  // namespace c256

// The launchers of pct_block_c256_sm90.cu that the backward shares
int launch_project_lse_c256_sm90(const void* x, const void* wqk, const void* wv, const void* bv,
                                 void* q, void* vt, void* vrow, float* lse2, int o, int p,
                                 CUtensorMap* qm, CUtensorMap* vm, CUtensorMap* lm,
                                 cudaStream_t st);

}  // namespace sga
