// PCT point embedding: the two conv(no bias) layers of NaivePCT, their
// forwards and the second layer's f32 backward.
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
//   each block keeps them in registers over all its objects and writes them
//   once into its own slice of a scratch buffer; reduce_slices adds the
//   slices in block order (no atomics: the same bits from run to run).
//
// embed_second replaces ops/pct_embed.py::embed_second_fused (Pallas kernel
// _e2_fwd_kernel): prologue x0 = relu(h0·wf0 + bf0) at f32, rounded (layer 0's
// BN folded from running stats), then h1 = x0·W1 [128, 128] with f32
// accumulation, rounded, plus the masked sums of h1.
//   Bound on the H100: bytes (256 FLOP per 4 bytes of bf16 traffic is below
//   the card's ~295 FLOP/B ridge).
//   bf16 runs the Hopper design of pct_embed_sm90.cu (TMA ring, wgmma with
//   the prologue applied on the register-A fragments, sums from the
//   accumulators). f32: grid-stride over 64-row tiles of the flat [O·P, 128]
//   activation; W1 stays resident in shared memory for all of a block's
//   tiles; the prologue is applied while the tile is staged; the product
//   is block_gemm's register-tiled f32 FMA product; sums as in embed_first.
//   Tiles may straddle objects: each row looks up its own object's mask.
//   Both kernels take a fixed grid (`blocks`, chosen by the wrapper) so that
//   the scratch holds one slice per block.
#include "common.cuh"

namespace sga {
namespace {

constexpr int kC = 128;       // embedding width
constexpr int kThreads = 256;  // 2 row lanes x 128 channels
constexpr int kRows = 64;      // rows per tile in embed_second

constexpr long long kSumStride = slice_stride(2 * kC);  // Σh, Σh² of one block

// this block's masked channel sums into its slice of the scratch
__device__ __forceinline__ void write_channel_sums(float a1, float a2, float* scratch) {
  float* part = scratch + (size_t)blockIdx.x * kSumStride;
  store_channel_sums(a1, part);
  store_channel_sums(a2, part + kC);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
embed_first_kernel(const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ mask,
                   T* __restrict__ h, float* __restrict__ scratch, int o, int p) {
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
  write_channel_sums(a1, a2, scratch);
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
                    float* __restrict__ scratch, int o, int p) {
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
    block_gemm<T, false, false, kRows, kC, kC>(sa, L::lda, sw, L::ldw, sc, L::ldc, false);
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
  write_channel_sums(a1, a2, scratch);
}

// ------------------------------- backward ----------------------------------
//
// embed_first_bwd is a streaming reduction of its own:
// pct_embed_first_bwd.cu.
//
// embed_second_bwd replaces ops/pct_embed.py::_e2_bwd_rule (Pallas kernel
// _e2_bwd_kernel): recompute pre = h0·wf + bf (f32), x0 = relu(pre) rounded,
// h = x0·W1 rounded; dz = dh + m·ds1 + 2·h·m·ds2 rounded; then
//   dW1 = Σ x0ᵀ·dz, dx0 = dz·W1ᵀ (f32), g0 = dx0 where pre > 0,
//   dh0 = g0·wf (rounded), dwf = Σ g0·h0, dbf = Σ g0 (f32).
//   Bound on the H100: bytes (h0 and dh read, dh0 written; 768 FLOP per
//   row of 256 bytes in bf16, below the ridge).
//   bf16 runs the Hopper design of pct_embed_bwd_sm90.cu (two warpgroups,
//   each with its own TMA ring and all of its dW1 in registers). f32: the forward's grid-stride walk over
//   64-row tiles with W1 resident in shared memory; the recomputed x0 and
//   dz tiles stay in shared memory for the three products (h, dW1 with the
//   transposed-A block_gemm straight into the block's scratch slice, dx0);
//   dwf and dbf are per-thread channel sums. Slices are summed by
//   reduce_slices.

constexpr int kE2Grad = kC * kC + 2 * kC;              // dW1, dwf, dbf

template <typename T>
struct E2BwdSmem {
  static constexpr int ldw = pad_ld<T>(kC), lda = pad_ld<T>(kC), ldc = pad_ldf(kC);
  static constexpr size_t w_off = 0;
  static constexpr size_t a_off = align128(w_off + sizeof(T) * kC * ldw);   // x0 tile
  static constexpr size_t z_off = align128(a_off + sizeof(T) * kRows * lda);  // dz tile
  static constexpr size_t c_off = align128(z_off + sizeof(T) * kRows * lda);  // h, then dx0
  static constexpr size_t bytes = align128(c_off + sizeof(float) * kRows * ldc);
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
embed_second_bwd_kernel(const T* __restrict__ h0, const T* __restrict__ wf,
                        const T* __restrict__ bf, const T* __restrict__ w,
                        const T* __restrict__ mask, const T* __restrict__ dh,
                        const float* __restrict__ ds1, const float* __restrict__ ds2,
                        T* __restrict__ dh0, float* __restrict__ scratch, long long stride,
                        int o, int p) {
  using L = E2BwdSmem<T>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sw = reinterpret_cast<T*>(smem + L::w_off);
  T* sa = reinterpret_cast<T*>(smem + L::a_off);
  T* sz = reinterpret_cast<T*>(smem + L::z_off);
  float* sc = reinterpret_cast<float*>(smem + L::c_off);

  float* part = scratch + (size_t)blockIdx.x * stride;   // dW1 [128, 128], dwf, dbf
  for (int i = threadIdx.x; i < kC * kC; i += blockDim.x) part[i] = 0.f;
  load_tile<T>(sw, L::ldw, w, kC, kC, kC, kC);
  const int c = threadIdx.x % kC;
  const float wfc = to_f<T>(wf[c]), bfc = to_f<T>(bf[c]), d1 = ds1[c], d2 = ds2[c];
  const long long rows = (long long)o * p;
  const long long tiles = (rows + kRows - 1) / kRows;
  float rwf = 0.f, rbf = 0.f;
  __syncthreads();

  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long row0 = t * kRows;
    const int valid = (int)min((long long)kRows, rows - row0);
    // x0 = relu(h0·wf + bf) rounded: the forward's prologue, same expression
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
    block_gemm<T, false, false, kRows, kC, kC>(sa, L::lda, sw, L::ldw, sc, L::ldc, false);
    __syncthreads();
    // dz = dh + m·ds1 + 2·h·m·ds2, rounded (thread owns channel c throughout)
    for (int idx = threadIdx.x; idx < kRows * kC; idx += blockDim.x) {
      const int r = idx / kC;
      float dz = 0.f;
      if (r < valid) {
        const float h = round_to<T>(sc[r * L::ldc + c]);
        const float m = to_f<T>(mask[(row0 + r) / p]);
        dz = round_to<T>(to_f<T>(dh[(row0 + r) * kC + c]) + m * d1 + 2.f * h * (m * d2));
      }
      sz[r * L::lda + c] = from_f<T>(dz);
    }
    __syncthreads();
    // dW1 += x0ᵀ·dz into this block's slice; dx0 = dz·W1ᵀ
    block_gemm<T, false, true, kC, kC, kRows>(sa, L::lda, sz, L::lda, part, kC, true);
    block_gemm<T, true, false, kRows, kC, kC>(sz, L::lda, sw, L::ldw, sc, L::ldc, false);
    __syncthreads();
    for (int idx = threadIdx.x; idx < valid * kC; idx += blockDim.x) {
      const int r = idx / kC;
      const size_t at = (row0 + r) * kC + c;
      const float hv = to_f<T>(h0[at]);
      const float pre = hv * wfc + bfc;
      const float g0 = pre > 0.f ? sc[r * L::ldc + c] : 0.f;
      dh0[at] = from_f<T>(g0 * wfc);
      rwf = fmaf(g0, hv, rwf);
      rbf += g0;
    }
    __syncthreads();
  }
  store_channel_sums(rwf, part + kC * kC);
  store_channel_sums(rbf, part + kC * kC + kC);
}

template <typename T>
int launch_second_bwd(const void* h0, const void* wf, const void* bf, const void* w,
                      const void* mask, const void* dh, const float* ds1, const float* ds2,
                      void* dh0, float* scratch, int blocks, float* grads, int o, int p,
                      cudaStream_t st) {
  const size_t smem = E2BwdSmem<T>::bytes;
  if (int rc = allow_smem(embed_second_bwd_kernel<T>, smem)) return rc;
  const long long stride = slice_stride(kE2Grad);
  embed_second_bwd_kernel<T><<<blocks, kThreads, smem, st>>>(
      (const T*)h0, (const T*)wf, (const T*)bf, (const T*)w, (const T*)mask, (const T*)dh, ds1,
      ds2, (T*)dh0, scratch, stride, o, p);
  if (int rc = (int)cudaGetLastError()) return rc;
  return reduce_slices(scratch, stride, blocks, grads, kE2Grad, st);
}

template <typename T>
int launch_first(const void* x, const void* w, const void* mask, void* h, float* scratch,
                 int blocks, float* sums, int o, int p, cudaStream_t st) {
  embed_first_kernel<T><<<blocks, kThreads, 0, st>>>((const T*)x, (const T*)w, (const T*)mask,
                                                     (T*)h, scratch, o, p);
  if (int rc = (int)cudaGetLastError()) return rc;
  return reduce_slices(scratch, kSumStride, blocks, sums, 2 * kC, st);
}

template <typename T>
int launch_second(const void* h0, const void* wf, const void* bf, const void* w, const void* mask,
                  void* h1, float* scratch, int blocks, float* sums, int o, int p,
                  cudaStream_t st) {
  const size_t smem = E2Smem<T>::bytes;
  if (int rc = allow_smem(embed_second_kernel<T>, smem)) return rc;
  embed_second_kernel<T><<<blocks, kThreads, smem, st>>>(
      (const T*)h0, (const T*)wf, (const T*)bf, (const T*)w, (const T*)mask, (T*)h1, scratch, o,
      p);
  if (int rc = (int)cudaGetLastError()) return rc;
  return reduce_slices(scratch, kSumStride, blocks, sums, 2 * kC, st);
}

}  // namespace

int launch_embed_second_sm90(const void* h0, const void* wf, const void* bf, const void* w,
                             const void* mask, void* h1, float* scratch, int slices, float* sums,
                             int o, int p, cudaStream_t st);
int launch_embed_second_bwd_sm90(const void* h0, const void* wf, const void* bf, const void* w,
                                 const void* mask, const void* dh, const float* ds1,
                                 const float* ds2, void* dh0, float* scratch, int slices,
                                 float* grads, int o, int p, cudaStream_t st);

}  // namespace sga

extern "C" {

// sums [2, 128] f32: Σh, Σh² masked; scratch: `blocks` slices of
// slice_stride(256) floats, one per block of the launch
int sga_embed_first(const void* x, const void* w, const void* mask, void* h, float* scratch,
                    int blocks, float* sums, int o, int p, int dtype, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == sga::kBF16)
    return sga::launch_first<sga::bf16>(x, w, mask, h, scratch, blocks, sums, o, p, st);
  return sga::launch_first<float>(x, w, mask, h, scratch, blocks, sums, o, p, st);
}

// as sga_embed_first; bf16 takes the wgmma design (pct_embed_sm90.cu), with
// `blocks` even: one slice per consumer warpgroup of blocks / 2 persistent
// blocks
int sga_embed_second(const void* h0, const void* wf, const void* bf, const void* w,
                     const void* mask, void* h1, float* scratch, int blocks, float* sums, int o,
                     int p, int dtype, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == sga::kBF16)
    return sga::launch_embed_second_sm90(h0, wf, bf, w, mask, h1, scratch, blocks, sums, o, p,
                                         st);
  return sga::launch_second<float>(h0, wf, bf, w, mask, h1, scratch, blocks, sums, o, p, st);
}

// grads: dW1 [128, 128], dwf [128], dbf [128] back to back, f32; bf16 takes
// the wgmma design (pct_embed_bwd_sm90.cu), with `blocks` even: one slice
// per warpgroup of blocks / 2 persistent blocks
int sga_embed_second_bwd(const void* h0, const void* wf, const void* bf, const void* w,
                         const void* mask, const void* dh, const float* ds1, const float* ds2,
                         void* dh0, float* scratch, int blocks, float* grads, int o, int p,
                         int dtype, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == sga::kBF16)
    return sga::launch_embed_second_bwd_sm90(h0, wf, bf, w, mask, dh, ds1, ds2, dh0, scratch,
                                             blocks, grads, o, p, st);
  return sga::launch_second_bwd<float>(h0, wf, bf, w, mask, dh, ds1, ds2, dh0, scratch, blocks,
                                       grads, o, p, st);
}

const char* sga_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
