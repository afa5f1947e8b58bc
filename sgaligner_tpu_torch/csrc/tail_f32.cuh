// The port's f32 product mainloop: full f32 on the CUDA cores, no TF32. The
// f32 PCT tail (csrc/pct_tail.cu), the f32 C = 128 attention passes
// (csrc/pct_attention.cu) and the f32 embed_second pair (csrc/pct_embed.cu)
// run on it; scripts/tail_gemm_bench.cu times it alone on their jobs.
//
// A block of 256 threads owns a 128 x 128 tile of C = A·B and keeps it in
// registers for the whole reduction: thread (tx, ty) holds rows
// 64·(i/4) + 4·ty + i%4 and columns 64·(j/4) + 4·tx + j%4 (i, j < 8), fed
// per k by four 16-byte shared loads (two of A, two of B) into a second
// register set while the previous k's 64 FMAs run. Each output is one fmaf
// chain over k in ascending order, starting from 0.
//
// Operands reach shared memory through a kStages-deep cp.async ring of
// k-steps of kBK: each stage holds A and B as [kBK][kLd] (k-major). A
// row-major [rows, ld] operand whose k runs along its rows (x for z, g for
// dx, W for dx's B) is staged transposed with 4-byte copies
// (stage_rows_t); one whose k runs down its rows (W for z, x and g for dW)
// with 16-byte copies (stage_rows). One __syncthreads per k-step: the
// stage it frees is the one every thread finished with before it.
//
// A job walks the block's tiles as one flat run of k-steps (the ring runs on
// across tile boundaries, so the next tile's loads are in flight during an
// epilogue):
//   int steps() const;            k-steps of the whole run
//   int ksteps() const;           k-steps of one tile
//   void stage(int s, float* st); issue k-step s's copies into a stage
//   void epilogue(int tile, const float (&acc)[8][8], float* spare);
// called by every thread of the block (epilogues may __syncthreads).
// `spare` is the stage the tile's last k-step read: free for the epilogue
// once every thread is past that product, and until the next k-step's
// __syncthreads.
//
// A job may shape its own ring (RingOf): kRing stages of kStageFloats
// floats (A and B first, then what else its k-step copies), its product
// `Mul` (`Mul`, `MulDual`, or its own), and with kPrep a hook that builds
// a k-step's A operand in shared memory from what that k-step's copies
// brought:
//   void prep(int s, float* st);
// The attention passes chain two products per key chunk this way: the
// chunk's S = q·qᵀ and its exponentials in prep, G·v in the mainloop. A job
// that declares none of these (the tail's) runs the plain product through
// kStages stages of kStage floats.
#pragma once

#include "common.cuh"

namespace sga {
namespace tail_f32 {

constexpr int kTile = 128;           // rows and columns of a block tile
constexpr int kBK = 16;              // k per stage
constexpr int kStages = 3;           // depth of the cp.async ring
constexpr int kThreads = 256;
// row stride of a staged operand: 132 keeps the transposing 4-byte copies
// of a warp (8 k x 4 rows) on 32 different banks and every row 16-byte
// aligned
constexpr int kLd = kTile + 4;
constexpr int kOperand = kBK * kLd;  // floats of one staged operand
constexpr int kStage = 2 * kOperand;
constexpr size_t kRingBytes = sizeof(float) * kStages * kStage;

// 4-byte asynchronous copy (cp.async.ca: .cg takes 16 bytes only); src-size
// 0 writes a zero
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0));
}

// The thread's place in the 16 x 16 grid of 8 x 8 output blocks: a warp
// covers 4 ty x 8 tx, so its A loads read 64 contiguous bytes and its B
// loads 128
__device__ __forceinline__ int lane_tx() { return 8 * ((threadIdx.x / 32) % 2) + threadIdx.x % 8; }
__device__ __forceinline__ int lane_ty() { return 4 * (threadIdx.x / 64) + (threadIdx.x % 32) / 8; }
// row (column) of the tile that register index i (j) of a thread maps to
__device__ __forceinline__ int tile_row(int ty, int i) { return 64 * (i / 4) + 4 * ty + i % 4; }

// Rows [0, kRows) x columns [0, kBK) of a row-major matrix (src at row 0,
// column k0; row stride ld floats), transposed into dst[k][m]; rows
// >= valid are zero-filled (their source kept in bounds). A warp copies
// 8 k x 4 rows: 32 bytes of each of 4 rows, one sector each
template <int kRows = kTile>
__device__ __forceinline__ void stage_rows_t(float* dst, const float* __restrict__ src,
                                             long long ld, int valid) {
  static_assert(kRows % 16 == 0 && kRows <= kTile, "stage_rows_t: rows");
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  const int k = 8 * (w % 2) + l % 8, m0 = 4 * (w / 2) + l / 8;
#pragma unroll
  for (int j = 0; j < kRows / 16; ++j) {
    const int m = m0 + 16 * j;
    const bool in = m < valid;
    cp_async4(dst + k * kLd + m, src + (in ? m * ld : 0) + k, in);
  }
}

// Rows [0, kBK) x columns [0, 128) of a row-major matrix (src at row k0,
// column n0; row stride ld floats) into dst[k][n]; rows >= valid are
// zero-filled
__device__ __forceinline__ void stage_rows(float* dst, const float* __restrict__ src,
                                           long long ld, int valid) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int r = 8 * j + w;
    const bool in = r < valid;
    cp_async16(dst + r * kLd + 4 * l, src + (in ? r * ld : 0) + 4 * l, in);
  }
}

__device__ __forceinline__ void frag(const float* as, const float* bs, int k, int tx, int ty,
                                     float (&a)[8], float (&b)[8]) {
  const float4 a0 = *reinterpret_cast<const float4*>(as + k * kLd + 4 * ty);
  const float4 a1 = *reinterpret_cast<const float4*>(as + k * kLd + 64 + 4 * ty);
  const float4 b0 = *reinterpret_cast<const float4*>(bs + k * kLd + 4 * tx);
  const float4 b1 = *reinterpret_cast<const float4*>(bs + k * kLd + 64 + 4 * tx);
  a[0] = a0.x, a[1] = a0.y, a[2] = a0.z, a[3] = a0.w;
  a[4] = a1.x, a[5] = a1.y, a[6] = a1.z, a[7] = a1.w;
  b[0] = b0.x, b[1] = b0.y, b[2] = b0.z, b[3] = b0.w;
  b[4] = b1.x, b[5] = b1.y, b[6] = b1.z, b[7] = b1.w;
}

// acc += one staged k-step (kBK outer products)
__device__ __forceinline__ void product(float (&acc)[8][8], const float* stage, int tx, int ty) {
  const float* as = stage;
  const float* bs = stage + kOperand;
  float a[2][8], b[2][8];
  frag(as, bs, 0, tx, ty, a[0], b[0]);
#pragma unroll
  for (int k = 0; k < kBK; ++k) {
    if (k + 1 < kBK) frag(as, bs, k + 1, tx, ty, a[(k + 1) % 2], b[(k + 1) % 2]);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[k % 2][i], b[k % 2][j], acc[i][j]);
  }
}

// n floats of a vector into dst (4-byte copies, so any offset); entries
// >= valid are zero-filled
__device__ __forceinline__ void stage_vec(float* dst, const float* __restrict__ src, int n,
                                          int valid) {
  for (int i = threadIdx.x; i < n; i += kThreads) cp_async4(dst + i, src + (i < valid ? i : 0), i < valid);
}

// Two products side by side in one 128 x 128 tile: columns 0-63 take A0's
// rows, columns 64-127 A1's (the stage holds A0, A1, then B): thread (tx,
// ty)'s acc[i][j < 4] and acc[i][4 + j] are the same row and column of the
// two products. Each output is one fmaf chain over k in ascending order.
__device__ __forceinline__ void product_dual(float (&acc)[8][8], const float* stage, int tx,
                                             int ty) {
  const float* a0s = stage;
  const float* a1s = stage + kOperand;
  const float* bs = stage + 2 * kOperand;
#pragma unroll
  for (int k = 0; k < kBK; ++k) {
    const float4 p0 = *reinterpret_cast<const float4*>(a0s + k * kLd + 4 * ty);
    const float4 p1 = *reinterpret_cast<const float4*>(a0s + k * kLd + 64 + 4 * ty);
    const float4 q0 = *reinterpret_cast<const float4*>(a1s + k * kLd + 4 * ty);
    const float4 q1 = *reinterpret_cast<const float4*>(a1s + k * kLd + 64 + 4 * ty);
    const float4 b0 = *reinterpret_cast<const float4*>(bs + k * kLd + 4 * tx);
    const float4 b1 = *reinterpret_cast<const float4*>(bs + k * kLd + 64 + 4 * tx);
    const float a0[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
    const float a1[8] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w};
    const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(j < 4 ? a0[i] : a1[i], b[j], acc[i][j]);
  }
}

// Rows 32·qr .. 32·qr + 31 of the block's accumulator tile into spare
// [32][kLd] (an epilogue's pass through the spare stage): registers
// 4·(qr/2) .. +3 of the threads ty = 8·(qr%2) .. +7
__device__ __forceinline__ void spill_quarter(const float (&acc)[8][8], float* spare, int qr,
                                              int tx, int ty) {
  if (ty / 8 != qr % 2) return;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int i = 4 * (qr / 2) + e, row = 4 * (ty % 8) + e;
#pragma unroll
    for (int h = 0; h < 2; ++h)
      store4<float>(spare + row * kLd + 64 * h + 4 * tx, acc[i][4 * h], acc[i][4 * h + 1],
                    acc[i][4 * h + 2], acc[i][4 * h + 3]);
  }
}

// A job's product (Job::Mul): apply(job, acc, stage, tx, ty) multiplies
// one staged k-step into the accumulators (a job may keep more of its own)
struct Mul {
  template <class Job>
  __device__ __forceinline__ static void apply(Job&, float (&acc)[8][8], const float* st, int tx,
                                               int ty) {
    product(acc, st, tx, ty);
  }
};
struct MulDual {
  template <class Job>
  __device__ __forceinline__ static void apply(Job&, float (&acc)[8][8], const float* st, int tx,
                                               int ty) {
    product_dual(acc, st, tx, ty);
  }
};

// What run reads of a job's ring: the plain product through kStages stages
// of kStage floats, or, where the job declares kStageFloats, its own kRing,
// kStageFloats, kPrep and Mul
template <class Job, class = void>
struct RingOf {
  static constexpr int kRing = kStages, kStageFloats = kStage;
  static constexpr bool kPrep = false;
  using Mul = tail_f32::Mul;
};
template <class Job>
struct RingOf<Job, std::void_t<decltype(Job::kStageFloats)>> {
  static constexpr int kRing = Job::kRing, kStageFloats = Job::kStageFloats;
  static constexpr bool kPrep = Job::kPrep;
  using Mul = typename Job::Mul;
};

// The mainloop: every k-step of the job through the ring, an epilogue after
// each tile's last one; `ring` holds the job's kRing stages (kRingBytes of
// dynamic shared memory for the plain ring). Iteration s waits for k-step
// s + 1's copies (s's without prep), synchronises once, issues k-step
// s + kRing - 1's copies into the stage k-step s - 1 used, builds k-step
// s + 1's A (prep), and multiplies k-step s.
template <class Job>
__device__ __forceinline__ void run(Job& job, float* ring) {
  using Ring = RingOf<Job>;
  constexpr int R = Ring::kRing, SF = Ring::kStageFloats;
  static_assert(R >= 3 && SF >= kStage && SF % 4 == 0, "run: ring");
  const int steps = job.steps(), ksteps = job.ksteps();
  const int tx = lane_tx(), ty = lane_ty();
#pragma unroll
  for (int s = 0; s < R - 1; ++s) {
    if (s < steps) job.stage(s, ring + s * SF);
    cp_async_commit();
  }
  if constexpr (Ring::kPrep) {
    cp_async_wait<R - 2>();
    __syncthreads();
    if (steps > 0) job.prep(0, ring);
  }
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  int ks = 0, tile = 0;
#pragma unroll 1
  for (int s = 0; s < steps; ++s) {
    if constexpr (Ring::kPrep)
      cp_async_wait<R - 3>();
    else
      cp_async_wait<R - 2>();
    __syncthreads();
    const int next = s + R - 1;
    if (next < steps) job.stage(next, ring + (next % R) * SF);
    cp_async_commit();
    if constexpr (Ring::kPrep)
      if (s + 1 < steps) job.prep(s + 1, ring + ((s + 1) % R) * SF);
    Ring::Mul::apply(job, acc, ring + (s % R) * SF, tx, ty);
    if (++ks == ksteps) {
      job.epilogue(tile, acc, ring + (s % R) * SF);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
      ks = 0;
      ++tile;
    }
  }
  cp_async_wait<0>();
}

// The 64-row tiles of one `blocks` slice, as the first version's grid-stride
// loops gave them to its block: tile t = slice, slice + blocks, ... of the
// per-object tiles (the attention apply and dz passes; rows r0.. of object
// t / per_obj) or of the flat rows (the attention dx pass, the embed_second
// pair)
struct Slice {
  long long rows;
  int p, blocks, slice, flat;
  __device__ int per_obj() const { return (p + 63) / 64; }
  __device__ long long ntiles() const {
    return flat ? (rows + 63) / 64 : rows / p * per_obj();
  }
  __device__ int count() const {
    const long long n = ntiles();
    return slice < n ? (int)((n - slice + blocks - 1) / blocks) : 0;
  }
  // first flat row and valid rows of the slice's k-th tile
  __device__ void tile(int k, long long& row0, int& valid) const {
    const long long t = slice + (long long)k * blocks;
    if (flat) {
      row0 = t * 64;
      valid = (int)min(64LL, rows - row0);
    } else {
      const long long obj = t / per_obj();
      const int r0 = (int)(t % per_obj()) * 64;
      row0 = obj * p + r0;
      valid = min(64, p - r0);
    }
  }
};

template <class Job>
__device__ __forceinline__ void run_slice(Job& job, float* ring) {
  if (job.steps() > 0) {
    run(job, ring);
  } else {  // a slice with no tile: its share is zero
    const float zero[8][8] = {};
    job.epilogue(0, zero, nullptr);
  }
}

}  // namespace tail_f32
}  // namespace sga
