// PointNet object encoder, bf16 forward: the Hopper design of pointnet_fwd
// (see pointnet.cu for the function, its f32 path and the backward).
//
// Replaces sgaligner_tpu/ops/pointnet_fused.py::_forward (Pallas kernel
// _fwd_kernel) for bf16 inputs: for channel-first x [O, 3, P],
//   a1 = xᵀ·w1 + b1 (f32), h1 = relu(a1) rounded; a2 = h1·w2 + b2 (f32),
//   h2 = relu(a2) rounded; a3 = h2·w3 + b3 (f32);
//   out [O, C3] = max over P of relu(a3) (f32) and, with the training flag,
//   amax [O, C3] = the first point index reaching it.
// relu keeps a NaN and a NaN wins the max (the smaller index between two
// NaNs), as jnp.maximum / jnp.max / jnp.argmax do.
//   Bound on the H100: operations. 2·P·(3·64 + 64·128 + 128·C3) FLOP per
//   object against 6 bytes a point: 0.573 ms at O = 13,440, P = 512.
//   Design (layers 1 and 2 in pointnet_sm90.cuh, which the bf16 backward
//   shares): persistent, one block per SM, two warpgroups that each own
//   whole objects (grid-stride over objects × warpgroups), so an object's
//   max and argmax never leave one warpgroup. W2ᵀ (16 KB) and W3ᵀ (64 KB
//   at 256 channels) stay resident as K-major, swizzled wgmma B operands,
//   staged with 16-byte loads. Per 64-point tile: layer 1 (K = 3) runs on the CUDA
//   cores straight into the register-A fragments of layer 2 (each thread
//   computes h1 for its own fragment rows and columns, the f32 expression
//   of pointnet.cu, from x loaded a tile ahead); layer 2 is wgmma
//   m64n128k16 whose accumulators, relu'd and rounded in registers, become
//   16 columns at a time the register-A fragments of layer 3; layer 3 runs
//   as NH products of N = 128, all issued before the first epilogue, so
//   half h's max runs while half h + 1 is in the tensor cores. A block
//   takes 128·NH channels: NH = 1 at C3 = 128; NH = 2 for C3 a multiple of
//   256, one group of 256 per blockIdx.y (the wrapper pads other widths
//   with zero channels and drops them). The biases of layers 2 and 3 ride
//   in the products as one more k-step (a column of ones against the
//   bias), and relu is one integer max on the bits: the CUDA cores do the least per value, since the epilogues, not
//   the products, bound this kernel. The max and argmax stay in registers:
//   each value is a 64-bit key (relu(a3)'s bits, a NaN as the largest, then
//   the complement of the point index), so one unsigned max picks the
//   larger value and, at equal values or between NaNs, the smaller index;
//   rows past P have zero inputs and no bias, so their key (0, ~row) loses
//   to every point. Each thread takes the max over its two rows, a halving
//   butterfly over the 8 lanes of each column leaves every lane 4 columns
//   of each half, and the running keys of an object stay in 8 registers a
//   half; at the object's end the four warps meet in shared memory and
//   out / amax are written once. The two warpgroups share no barrier, so
//   one's CUDA-core work overlaps the other's products.
#include "common.cuh"
#include "pointnet_sm90.cuh"

namespace sga {
namespace {

using namespace sm90;

constexpr int kC1 = kPnC1;
constexpr int kC2 = kPnC2;
constexpr int kTile = 64;
constexpr int kThreads = 256;  // two warpgroups, no producer (x is 6 bytes a point)

__device__ __forceinline__ uint64_t key_of(uint32_t bits, int row) {
  return ((uint64_t)bits << 32) | (uint32_t)~row;
}

__device__ __forceinline__ uint64_t kmax(uint64_t a, uint64_t b) { return a > b ? a : b; }

// Shared memory. The biases of layers 2 and 3 ride in the products: one
// more k-step whose B operand holds the bias in its column k = 0 (zero
// elsewhere) and whose register-A fragment is 1 at k = 0 for a point of the
// object (0 for rows past P, whose layer-2 input is 0 too: their a3 is 0
// and their key never wins). A block takes one group of kCG = 128·NH
// channels of layer 3 (blockIdx.y).
template <int NH>
struct PnSmem {
  static constexpr int kCG = 128 * NH;
  static constexpr size_t w2_off = 0;                               // W2ᵀ [128 n][64 k]
  static constexpr size_t b2_off = w2_off + kC2 * 64 * 2;            // b2 as [128 n][64 k]
  static constexpr size_t w3_off = b2_off + kC2 * 64 * 2;            // W3ᵀ, two [kCG n][64 k]
  static constexpr size_t b3_off = w3_off + (size_t)kCG * kC2 * 2;   // b3 as [kCG n][64 k]
  static constexpr size_t red_off = b3_off + (size_t)kCG * 64 * 2;   // [2][4 warps][kCG] keys
  static constexpr size_t vec_off = red_off + (size_t)2 * 4 * kCG * 8;  // w1 [3][64], b1 (f32)
  static constexpr size_t bytes = vec_off + 4 * kC1 * 4 + 1024;
};

// c3: the channels of w3, b3, out and amax (row stride); this block's
// group of kCG starts at column kCG·blockIdx.y
template <int NH, bool ARGMAX>
__global__ void __launch_bounds__(kThreads, 1)
pointnet_fwd_wgmma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                          const bf16* __restrict__ b1, const bf16* __restrict__ w2,
                          const bf16* __restrict__ b2, const bf16* __restrict__ w3,
                          const bf16* __restrict__ b3, float* __restrict__ out,
                          int* __restrict__ amax, int o, int p, int c3) {
  using L = PnSmem<NH>;
  constexpr int kCG = L::kCG;
  const int c0 = kCG * blockIdx.y;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  float* w1s = reinterpret_cast<float*>(smem + L::vec_off);  // [3][64], then b1 [64]
  stage_layers12(smem + L::w2_off, w1s, w1, b1, w2, b2);
  stage_transposed<kC2, kCG>(reinterpret_cast<bf16*>(smem + L::w3_off), w3 + c0, c3);
  stage_bias(reinterpret_cast<bf16*>(smem + L::b3_off), b3 + c0, kCG);
  fence_proxy_async();
  __syncthreads();

  const int c = threadIdx.x / 128, t = threadIdx.x % 128;
  const int warp = t / 32, lane = t % 32, q = lane % 4;
  const int rl = 16 * warp + lane / 4;  // this thread's rows of a tile: rl and rl + 8
  uint64_t* red = reinterpret_cast<uint64_t*>(smem + L::red_off) + (size_t)c * 4 * kCG;
  const unsigned char* w2s = smem + L::w2_off;
  const unsigned char* w3s = smem + L::w3_off;

  for (int obj = blockIdx.x + c * gridDim.x; obj < o; obj += 2 * gridDim.x) {
    const bf16* xo = x + (size_t)obj * 3 * p;
    uint64_t run[NH][4];
#pragma unroll
    for (int hh = 0; hh < NH; ++hh)
#pragma unroll
      for (int k = 0; k < 4; ++k) run[hh][k] = 0;
    // this thread's two points of the next tile, loaded a tile ahead
    float xn[2][3];
    auto load_x = [&](int p0) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          const int row = p0 + rl + 8 * h;
          xn[h][k] = row < p ? __bfloat162float(xo[(size_t)k * p + row]) : 0.f;
        }
    };
    load_x(0);

    for (int p0 = 0; p0 < p; p0 += kTile) {
      const int row0 = p0 + rl, row1 = row0 + 8;
      const bool v[2] = {row0 < p, row1 < p};
      float xr[2][3];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int k = 0; k < 3; ++k) xr[h][k] = xn[h][k];
      if (p0 + kTile < p) load_x(p0 + kTile);
      // layers 1 and 2 (pointnet_sm90.cuh; rows past P give zeros)
      uint32_t a2[5][4];
      layer1_fragments<false>(w1s, xr, v, q, a2, nullptr);
      float acc2[64];
      layer2(acc2, a2, w2s);
      // h2 = round(relu(a2)) as layer 3's A fragments (accumulator columns
      // 16kk.. are k-step kk); k-step 8 is the bias
      uint32_t a3[9][4];
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int g = 2 * kk + r / 2, h = r % 2;
          a3[kk][r] = pack_relu(acc2[4 * g + 2 * h], acc2[4 * g + 2 * h + 1]);
        }
#pragma unroll
      for (int r = 0; r < 4; ++r) a3[8][r] = a2[4][r];
      float acc3[NH][64];
      wgmma_fence();
#pragma unroll
      for (int hh = 0; hh < NH; ++hh) {
#pragma unroll
        for (int kk = 0; kk < 9; ++kk)
          wgmma_m64n128k16_rs(acc3[hh], a3[kk],
                              desc(w3s + (kk / 4) * (kCG * 128) + hh * (128 * 128), kSw128,
                                   (kk % 4) * 32),
                              kk != 0);
        wgmma_commit();
      }
#pragma unroll
      for (int hh = 0; hh < NH; ++hh) {
        if (hh + 1 < NH) wgmma_wait<1>(); else wgmma_wait<0>();
        fence_regs(acc3[hh]);
        // keys of this half: the larger of the thread's two rows per column
        // (value j at column 128hh + 8·(j / 2) + 2q + j % 2)
        uint64_t kv[32];
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          const int i0 = 4 * (j / 2) + j % 2;
          const uint32_t u0 = relu_bits(acc3[hh][i0]), u1 = relu_bits(acc3[hh][i0 + 2]);
          kv[j] = u1 > u0 ? key_of(u1, row1) : key_of(u0, row0);
        }
        uint64_t best[4];
        lane_column_reduce(kv, best, lane, [](uint64_t x, uint64_t y) { return kmax(x, y); });
#pragma unroll
        for (int k = 0; k < 4; ++k) run[hh][k] = kmax(run[hh][k], best[k]);
      }
    }

    // the four warps' keys meet in shared memory; one write per channel
#pragma unroll
    for (int hh = 0; hh < NH; ++hh)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int j = 4 * (lane / 4) + k;
        red[warp * kCG + 128 * hh + 8 * (j / 2) + 2 * q + j % 2] = run[hh][k];
      }
    bar_sync(1 + c, 128);
    for (int col = t; col < kCG; col += 128) {
      uint64_t b = red[col];
#pragma unroll
      for (int w = 1; w < 4; ++w) b = kmax(b, red[w * kCG + col]);
      out[(size_t)obj * c3 + c0 + col] = __uint_as_float((uint32_t)(b >> 32));
      if constexpr (ARGMAX) amax[(size_t)obj * c3 + c0 + col] = (int)~(uint32_t)b;
    }
    bar_sync(1 + c, 128);
  }
}

template <int NH, bool ARGMAX>
int launch(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
           const void* w3, const void* b3, float* out, int* amax, int o, int p, int c3,
           cudaStream_t st) {
  int dev = 0, sms = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int groups = c3 / PnSmem<NH>::kCG;
  const int per = (sms + groups - 1) / groups;  // blocks a group, one per SM in all
  const dim3 grid(per < (o + 1) / 2 ? per : (o + 1) / 2, groups);
  auto kernel = pointnet_fwd_wgmma_kernel<NH, ARGMAX>;
  if (int rc = allow_smem(kernel, PnSmem<NH>::bytes)) return rc;
  kernel<<<grid, kThreads, PnSmem<NH>::bytes, st>>>((const bf16*)x, (const bf16*)w1,
                                                    (const bf16*)b1, (const bf16*)w2,
                                                    (const bf16*)b2, (const bf16*)w3,
                                                    (const bf16*)b3, out, amax, o, p, c3);
  return (int)cudaGetLastError();
}

}  // namespace

// bf16 pointnet_fwd for C3 = 128 or a multiple of 256 (the wrapper pads
// other widths with zero channels); amax may be null
int launch_pointnet_fwd_sm90(const void* x, const void* w1, const void* b1, const void* w2,
                             const void* b2, const void* w3, const void* b3, float* out,
                             int* amax, int o, int p, int c3, cudaStream_t st) {
  if (o < 1 || p < 1 || (c3 != 128 && (c3 < 256 || c3 % 256))) return (int)cudaErrorInvalidValue;
  if (((uintptr_t)w2 | (uintptr_t)w3) & 15) return (int)cudaErrorMisalignedAddress;
  if (c3 == 128)
    return amax ? launch<1, true>(x, w1, b1, w2, b2, w3, b3, out, amax, o, p, c3, st)
                : launch<1, false>(x, w1, b1, w2, b2, w3, b3, out, nullptr, o, p, c3, st);
  return amax ? launch<2, true>(x, w1, b1, w2, b2, w3, b3, out, amax, o, p, c3, st)
              : launch<2, false>(x, w1, b1, w2, b2, w3, b3, out, nullptr, o, p, c3, st);
}

}  // namespace sga
