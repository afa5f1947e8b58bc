// PCT point embedding: the two conv(no bias) layers of NaivePCT, forward only.
//
// embed_first replaces sgaligner_tpu/ops/pct_embed.py::embed_first_fused
// (Pallas kernel _e1_fwd_kernel): h0 = x_cfᵀ·W0 for channel-first points
// [O, 3, P] and W0 [3, 128], rounded to the compute dtype, plus the masked
// per-channel sums Σh, Σh² [1, 128] (f32) of the rounded values.
//   Bound on the H100: bytes. Three FMAs per output; the kernel reads 12 B
//   (f32) or 6 B (bf16) per point and writes 128 outputs per point.
//   Design: one block walks whole objects (grid-stride, as many blocks as fit
//   on the card); thread c owns channel c, so W0's column sits in registers,
//   the points are warp-broadcast loads and each output row is one coalesced
//   store. The TPU kernel carried the sums across its sequential grid; here
//   each block keeps them in registers over all its objects and adds them to
//   the [1, 128] totals with one f32 atomicAdd per channel at the end.
//
// embed_second replaces ops/pct_embed.py::embed_second_fused (Pallas kernel
// _e2_fwd_kernel): prologue x0 = relu(h0·wf0 + bf0) at f32, rounded (layer 0's
// BN folded from running stats), then h1 = x0·W1 [128, 128] with f32
// accumulation, rounded, plus the masked sums of h1.
//   Bound on the H100: bytes (256 FLOP per 4 bytes of bf16 traffic is below
//   the card's ~295 FLOP/B ridge).
//   Design: grid-stride over 64-row tiles of the flat [O·P, 128] activation;
//   W1 stays resident in shared memory for all of a block's tiles; the
//   prologue is applied while the tile is staged; the product runs on the
//   tensor cores (bf16 WMMA) or as f32 FMAs; sums as in embed_first. Tiles
//   may straddle objects: each row looks up its own object's mask.
#include "common.cuh"

namespace sga {
namespace {

constexpr int kC = 128;       // embedding width
constexpr int kThreads = 256;  // 2 row lanes x 128 channels
constexpr int kRows = 64;      // rows per tile in embed_second

__device__ void add_channel_sums(float a1, float a2, float* s1, float* s2) {
  __shared__ float red[2][2][kC];
  const int c = threadIdx.x % kC, half = threadIdx.x / kC;
  red[0][half][c] = a1;
  red[1][half][c] = a2;
  __syncthreads();
  if (half == 0) {
    atomicAdd(&s1[c], red[0][0][c] + red[0][1][c]);
    atomicAdd(&s2[c], red[1][0][c] + red[1][1][c]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
embed_first_kernel(const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ mask,
                   T* __restrict__ h, float* s1, float* s2, int o, int p) {
  const int c = threadIdx.x % kC, half = threadIdx.x / kC;
  const float w0 = to_f<T>(w[c]), w1 = to_f<T>(w[kC + c]), w2 = to_f<T>(w[2 * kC + c]);
  float a1 = 0.f, a2 = 0.f;
  for (int obj = blockIdx.x; obj < o; obj += gridDim.x) {
    const T* xo = x + (size_t)obj * 3 * p;
    T* ho = h + (size_t)obj * p * kC;
    float b1 = 0.f, b2 = 0.f;
    for (int r = half; r < p; r += 2) {
      const float v = to_f<T>(xo[r]) * w0 + to_f<T>(xo[p + r]) * w1 + to_f<T>(xo[2 * p + r]) * w2;
      const T hv = from_f<T>(v);
      ho[(size_t)r * kC + c] = hv;
      const float hf = to_f<T>(hv);
      b1 += hf;
      b2 += hf * hf;
    }
    const float m = to_f<T>(mask[obj]);
    a1 += m * b1;
    a2 += m * b2;
  }
  add_channel_sums(a1, a2, s1, s2);
}

template <typename T>
struct E2Smem {
  static constexpr int ldw = pad_ld<T>(kC), lda = pad_ld<T>(kC), ldc = pad_ldf(kC);
  static constexpr size_t w_off = 0;
  static constexpr size_t a_off = align128(w_off + sizeof(T) * kC * ldw);
  static constexpr size_t c_off = align128(a_off + sizeof(T) * kRows * lda);
  static constexpr size_t bytes = align128(c_off + sizeof(float) * kRows * ldc);
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
embed_second_kernel(const T* __restrict__ h0, const T* __restrict__ wf, const T* __restrict__ bf,
                    const T* __restrict__ w, const T* __restrict__ mask, T* __restrict__ h1,
                    float* s1, float* s2, int o, int p) {
  using L = E2Smem<T>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sw = reinterpret_cast<T*>(smem + L::w_off);
  T* sa = reinterpret_cast<T*>(smem + L::a_off);
  float* sc = reinterpret_cast<float*>(smem + L::c_off);

  load_tile<T>(sw, L::ldw, w, kC, kC, kC, kC);
  const long long rows = (long long)o * p;
  const long long tiles = (rows + kRows - 1) / kRows;
  const int c = threadIdx.x % kC, half = threadIdx.x / kC;
  float a1 = 0.f, a2 = 0.f;

  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long row0 = t * kRows;
    const int valid = (int)min((long long)kRows, rows - row0);
    // stage x0 = relu(h0·wf + bf) rounded to T (the layer-0 BN fold)
    for (int idx = threadIdx.x; idx < kRows * kC; idx += blockDim.x) {
      const int r = idx / kC, k = idx % kC;
      float v = 0.f;
      if (r < valid) {
        const float pre = to_f<T>(h0[(row0 + r) * kC + k]) * to_f<T>(wf[k]) + to_f<T>(bf[k]);
        v = fmaxf(pre, 0.f);
      }
      sa[r * L::lda + k] = from_f<T>(v);
    }
    __syncthreads();
    block_gemm<T, false>(sa, L::lda, sw, L::ldw, sc, L::ldc, kRows, kC, kC, false);
    __syncthreads();
    for (int r = half; r < valid; r += 2) {
      const T hv = from_f<T>(sc[r * L::ldc + c]);
      h1[(row0 + r) * kC + c] = hv;
      const float hf = to_f<T>(hv);
      const float m = to_f<T>(mask[(row0 + r) / p]);
      a1 += m * hf;
      a2 += m * hf * hf;
    }
    __syncthreads();
  }
  add_channel_sums(a1, a2, s1, s2);
}

template <typename T>
int launch_first(const void* x, const void* w, const void* mask, void* h, float* s1, float* s2,
                 int o, int p, cudaStream_t st) {
  const int grid = resident_grid(embed_first_kernel<T>, kThreads, 0, o);
  embed_first_kernel<T><<<grid, kThreads, 0, st>>>(
      (const T*)x, (const T*)w, (const T*)mask, (T*)h, s1, s2, o, p);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_second(const void* h0, const void* wf, const void* bf, const void* w, const void* mask,
                  void* h1, float* s1, float* s2, int o, int p, cudaStream_t st) {
  const size_t smem = E2Smem<T>::bytes;
  cudaFuncSetAttribute(embed_second_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  const long long tiles = ((long long)o * p + kRows - 1) / kRows;
  const int grid = resident_grid(embed_second_kernel<T>, kThreads, smem, tiles);
  embed_second_kernel<T><<<grid, kThreads, smem, st>>>(
      (const T*)h0, (const T*)wf, (const T*)bf, (const T*)w, (const T*)mask, (T*)h1, s1, s2, o,
      p);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace sga

extern "C" {

int sga_embed_first(const void* x, const void* w, const void* mask, void* h, float* s1, float* s2,
                    int o, int p, int dtype, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == sga::kBF16)
    return sga::launch_first<sga::bf16>(x, w, mask, h, s1, s2, o, p, st);
  return sga::launch_first<float>(x, w, mask, h, s1, s2, o, p, st);
}

int sga_embed_second(const void* h0, const void* wf, const void* bf, const void* w,
                     const void* mask, void* h1, float* s1, float* s2, int o, int p, int dtype,
                     void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == sga::kBF16)
    return sga::launch_second<sga::bf16>(h0, wf, bf, w, mask, h1, s1, s2, o, p, st);
  return sga::launch_second<float>(h0, wf, bf, w, mask, h1, s1, s2, o, p, st);
}

const char* sga_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
