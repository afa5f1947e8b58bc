// Hopper (sm_90a) building blocks for the redesigned bf16 kernels, in inline
// PTX: mbarriers, TMA tensor loads, wgmma shared-memory descriptors and the
// four wgmma shapes the kernels use (f32 accumulators in registers).
//
// Layouts. Every wgmma operand in shared memory is K-major (the reduction
// axis contiguous) and swizzled as the TMA box that filled it: 128-byte
// rows (64 bf16) with SWIZZLE_128B, or 64-byte rows (32 bf16) with
// SWIZZLE_64B. Each tile starts 1024-byte aligned; 8-row groups sit 8 rows
// apart (the descriptor's stride byte offset), and a 16-deep k-step
// advances the start address by 32 bytes inside the swizzled row.
//
// Register layouts (one warpgroup, thread t, warp w = t / 32, lane l):
//   accumulator of m64nNk16: d[i] is row 16w + l/4 + 8·((i/2)%2), column
//   8·(i/4) + 2·(l%4) + i%2;
//   A fragment of a register-A wgmma (rows 16w.., 16 k): a[0] = (row l/4,
//   k 2(l%4)+{0,1}), a[1] = (row l/4+8, same k), a[2] = (row l/4, k 8+...),
//   a[3] = (row l/4+8, k 8+...), each a bf16x2 with the lower k in the low
//   half. So the accumulator columns 16c..16c+15 of a product become the A
//   fragment of k-step c of the next one without leaving the registers.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace sga {
namespace sm90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ----------------------------------- mbarrier --------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// make the barriers' initialisation visible to the async proxy (TMA)
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// arrive and expect `bytes` of TMA transactions on this phase
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// wait until the phase of parity `parity` has completed (a fresh barrier
// counts the phase before its first, of parity 1, as complete). A wait
// that lasts 2^35 cycles (over ten seconds) can only be a broken pipeline:
// it traps, so the launch fails with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  const long long start = clock64();
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > (1LL << 35)) __trap();
  }
}

// A ring of `kStages` buffers: use n (counted from 0 over the kernel's
// life) sits in stage n % kStages; its consumers wait for the full barrier's
// phase (n / kStages) & 1, its producer for the empty barrier's phase before.
template <int kStages>
struct Ring {
  static __device__ __forceinline__ int stage(uint32_t n) { return (int)(n % kStages); }
  static __device__ __forceinline__ uint32_t full_parity(uint32_t n) { return (n / kStages) & 1u; }
  static __device__ __forceinline__ uint32_t empty_parity(uint32_t n) {
    return ((n / kStages) & 1u) ^ 1u;
  }
};

// ------------------------------------- TMA -----------------------------------

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// generic-proxy writes to shared memory (plain stores) made visible to the
// async proxy (wgmma operands); every writing thread runs it before the
// barrier that hands the data over
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ------------------------------------ wgmma ----------------------------------

enum Swizzle : int { kSw128 = 1, kSw64 = 2 };

// descriptor of a K-major swizzled tile at `tile` (1024-byte aligned),
// advanced `k_bytes` along its rows (a multiple of 32: the k-step)
__device__ __forceinline__ uint64_t desc(const void* tile, int swizzle, uint32_t k_bytes) {
  const uint32_t row_bytes = swizzle == kSw128 ? 128u : 64u;
  const uint32_t addr = smem_u32(tile) + k_bytes;
  uint64_t d = (uint64_t)((addr & 0x3FFFFu) >> 4);
  d |= (uint64_t)1 << 16;                            // leading byte offset (unused)
  d |= (uint64_t)((8u * row_bytes) >> 4) << 32;      // 8-row group stride
  d |= (uint64_t)swizzle << 62;
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma that owns it
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// named barrier over `threads` threads (id 0 is __syncthreads)
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// D[64, 32] (+)= A[64, 16]·B[16, 32]; A and B in shared memory (descriptors);
// scale_d = 0 overwrites D
__device__ __forceinline__ void wgmma_m64n32k16_ss(float (&d)[16], uint64_t a, uint64_t b,
                                                  int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(scale_d));
}

// D[64, 64] (+)= A[64, 16]·B[16, 64]; A and B in shared memory (descriptors);
// scale_d = 0 overwrites D
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t a, uint64_t b,
                                                  int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// D[64, 128] (+)= A[64, 16]·B[16, 128]; A and B in shared memory (descriptors);
// scale_d = 0 overwrites D
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t a, uint64_t b,
                                                  int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

// D[64, 128] (+)= A[64, 16]·B[16, 128]; A in registers (the four bf16x2 of each
// thread's m16n8k16 A fragment, rows of its warp), B in shared memory
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64], const uint32_t (&a)[4],
                                                  uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// ------------------------- wgmma with transposed operands --------------------
//
// An MN-major operand (the reduction axis strided) is what a TMA box of a
// row-major [K rows, MN cols] tile gives: 64 MN values (128-byte swizzle)
// or 32 (64-byte) per row of k. Its descriptor's stride byte offset steps
// 8 k-rows (one swizzle atom), its leading byte offset one MN atom (64 or
// 32 values; unused when the instruction's M or N is one atom wide), and
// a 16-deep k-step advances the start by 16 rows.
__device__ __forceinline__ uint64_t desc_mn(const void* tile, int swizzle, uint32_t k_rows,
                                            uint32_t lbo_bytes) {
  const uint32_t row_bytes = swizzle == kSw128 ? 128u : 64u;
  const uint32_t addr = smem_u32(tile) + k_rows * row_bytes;
  uint64_t d = (uint64_t)((addr & 0x3FFFFu) >> 4);
  d |= (uint64_t)((lbo_bytes >> 4) & 0x3FFFu) << 16;
  d |= (uint64_t)((8u * row_bytes) >> 4) << 32;
  d |= (uint64_t)swizzle << 62;
  return d;
}

// D[64, 64] (+)= A[64, 16]·B[16, 64], both in shared memory; TA / TB = 1:
// that operand is MN-major (transposed; desc_mn) instead of K-major
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n64k16_ss_t(float* d, uint64_t a, uint64_t b,
                                                    int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
}

// D[64, 32] (+)= A[64, 16]·B[16, 32], both in shared memory; TA / TB = 1:
// that operand is MN-major (transposed; desc_mn) instead of K-major
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n32k16_ss_t(float* d, uint64_t a, uint64_t b,
                                                    int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, %19, %20;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
}

// D[64, 64] (+)= A[64, 16]·B[16, 64], A in registers (the A fragment), B in
// shared memory, MN-major with TB = 1
template <int TB>
__device__ __forceinline__ void wgmma_m64n64k16_rs_t(float* d, const uint32_t (&a)[4],
                                                    uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d), "n"(TB));
}

// D[64, 32] (+)= A[64, 16]·B[16, 32], A in registers (the A fragment), B in
// shared memory, MN-major with TB = 1
template <int TB>
__device__ __forceinline__ void wgmma_m64n32k16_rs_t(float* d, const uint32_t (&a)[4],
                                                    uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d), "n"(TB));
}

// Write a row-major [ROWS, COLS] bf16 weight (row stride ld, a multiple of
// 8, as COLS is; w 16-byte aligned, which each launch checks) transposed
// into K-major 128-byte-swizzled boxes of 64 k: element (k, n) to box
// k / 64, row n (the B operand of x·W). 16-byte loads, four in flight a
// thread, consecutive threads on consecutive rows k, so a warp's 2-byte
// stores fill one swizzled row n without bank conflicts. Called by every
// thread; fence_proxy_async and a barrier follow before a wgmma reads it.
template <int ROWS, int COLS>
__device__ __forceinline__ void stage_transposed(__nv_bfloat16* dst,
                                                 const __nv_bfloat16* __restrict__ w,
                                                 int ld = COLS) {
  constexpr int kVecs = ROWS * COLS / 8;
#pragma unroll 4
  for (int idx = threadIdx.x; idx < kVecs; idx += blockDim.x) {
    const int k = idx % ROWS, n0 = (idx / ROWS) * 8, kin = k % 64;
    const uint4 v = *reinterpret_cast<const uint4*>(w + (size_t)k * ld + n0);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + j;
      dst[(k / 64) * (COLS * 64) + n * 64 + (((kin / 8) ^ (n % 8)) * 8) + kin % 8] = e[j];
    }
  }
}

// A bias as the K-major B operand of a bias k-step (one more k-step of a
// product whose register-A fragment is 1 at k = 0): row n of a
// 128-byte-swizzled [cols n][64 k] box holds b[n] at k = 0, zero elsewhere.
// A thread takes whole rows: one load of b[n], eight 16-byte stores (k = 0
// sits in the row's 16-byte chunk n % 8).
__device__ __forceinline__ void stage_bias(__nv_bfloat16* dst, const __nv_bfloat16* __restrict__ b,
                                           int cols) {
  for (int n = threadIdx.x; n < cols; n += blockDim.x) {
    const uint32_t bits = *reinterpret_cast<const uint16_t*>(b + n);
    uint4* row = reinterpret_cast<uint4*>(dst + n * 64);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      row[j] = j == n % 8 ? make_uint4(bits, 0u, 0u, 0u) : make_uint4(0u, 0u, 0u, 0u);
  }
}

// sum over the 4 lanes that hold one accumulator row
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ float lo_bf16(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float hi_bf16(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

// word of (row r, even column col) in a [64, 128] bf16 tile held as two
// 128-byte-swizzled TMA boxes of 64 columns (a row tile of x, or a staging
// tile for 16-byte row stores)
__device__ __forceinline__ int x_word(int r, int col) {
  return ((col / 64) * (64 * 64) + r * 64 + ((((col % 64) / 8) ^ (r % 8)) * 8) + col % 8) / 2;
}

// --------------------- channel sums of accumulator tiles --------------------
//
// The training forwards' masked BN sums Σ m·t and Σ m·t² of [64, 128]
// accumulator tiles, reduced over lanes by shuffles and over tiles in a
// per-warp share of shared memory, in a fixed order: no atomics, the same
// bits twice.

// One column pair's masked sums over a thread's two accumulator rows:
// w[h] packs the bf16 values of row h (columns 2j', 2j' + 1 of the pair),
// weighted by m[h] (0 for rows outside the data); s1 / s2 get Σ m·t and
// Σ m·t² of each column
__device__ __forceinline__ void row_pair_sums(const uint32_t (&w)[2], const float (&m)[2],
                                              float* s1, float* s2) {
  const float a0 = lo_bf16(w[0]), a1 = hi_bf16(w[0]), b0 = lo_bf16(w[1]), b1 = hi_bf16(w[1]);
  s1[0] = m[0] * a0 + m[1] * b0;
  s1[1] = m[0] * a1 + m[1] * b1;
  s2[0] = m[0] * (a0 * a0) + m[1] * (b0 * b0);
  s2[1] = m[0] * (a1 * a1) + m[1] * (b1 * b1);
}

// Combine 32 per-thread values with `op` over the 8 lanes that share
// lane % 4 (the rows of an accumulator's columns): a halving butterfly of
// 28 exchanges, after which lane l holds the results for values
// 4·(l / 4) + k, k < 4 (op(own, other) at each step)
template <typename T, typename Op>
__device__ __forceinline__ void lane_column_reduce(const T (&v)[32], T (&out)[4], int lane, Op op) {
  T a[16], b[8];
  const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4;
#pragma unroll
  for (int k = 0; k < 16; ++k)
    a[k] = op(b4 ? v[k + 16] : v[k], __shfl_xor_sync(0xffffffffu, b4 ? v[k] : v[k + 16], 16));
#pragma unroll
  for (int k = 0; k < 8; ++k)
    b[k] = op(b3 ? a[k + 8] : a[k], __shfl_xor_sync(0xffffffffu, b3 ? a[k] : a[k + 8], 8));
#pragma unroll
  for (int k = 0; k < 4; ++k)
    out[k] = op(b2 ? b[k + 4] : b[k], __shfl_xor_sync(0xffffffffu, b2 ? b[k] : b[k + 4], 4));
}

// the sums of 32 per-thread values over the 8 lanes of each column
__device__ __forceinline__ void lane_column_sums(const float (&v)[32], float (&out)[4], int lane) {
  lane_column_reduce(v, out, lane, [](float x, float y) { return x + y; });
}

// Add one row tile's column sums into this warp's share `wred` ([2][4][32]
// floats: Σt then Σt², entry k·32 + lane of each). s1 / s2: this thread's
// sums over its two rows, value j at accumulator column 8·(j / 2) +
// 2·(lane % 4) + j % 2. Each entry is one lane's: no races, no atomics.
__device__ __forceinline__ void add_column_sums(float* wred, const float (&s1)[32],
                                                const float (&s2)[32], int lane) {
  float c1[4], c2[4];
  lane_column_sums(s1, c1, lane);
  lane_column_sums(s2, c2, lane);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    wred[k * 32 + lane] += c1[k];
    wred[128 + k * 32 + lane] += c2[k];
  }
}

// A warpgroup's four warp shares `red` added in warp order into its scratch
// slice `part` (Σt [128], then Σt² [128]); thread t of the warpgroup owns
// channel t. Entry (k, lane) of a share holds channel 16·(lane / 4) +
// 8·(k / 2) + 2·(lane % 4) + k % 2 (lane_column_sums).
__device__ __forceinline__ void store_column_sums(const float* red, float* part, int t) {
  const int rem = t % 16, k = 2 * (rem / 8) + rem % 2, ln = 4 * (t / 16) + (rem % 8) / 2;
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) sum += red[w * 256 + s * 128 + k * 32 + ln];
    part[s * 128 + t] = sum;
  }
}

// ------------------------------------ host -----------------------------------

// Tensor map of a `rank`-dimensional tensor at `base`: dims innermost first,
// strides in bytes of dims 1.. (multiples of 16), the box copied per load.
// Boxes past the tensor's edge are zero-filled. Returns 0, or
// cudaErrorInvalidValue when cuTensorMapEncodeTiled refuses the map.
inline int make_map(CUtensorMap* map, CUtensorMapDataType type, int rank, const void* base,
                    const uint64_t* dims, const uint64_t* strides, const uint32_t* box,
                    CUtensorMapSwizzle swizzle) {
  const uint32_t elem_strides[5] = {1, 1, 1, 1, 1};
  const CUresult rc = cuTensorMapEncodeTiled(
      map, type, (cuuint32_t)rank, const_cast<void*>(base), dims, strides, box, elem_strides,
      CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

}  // namespace sm90
}  // namespace sga
