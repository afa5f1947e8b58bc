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
//   Bound on the H100: bytes at bf16 (256 FLOP per 4 bytes of traffic is
//   below the card's ~295 FLOP/B ridge); operations at f32 (full f32 on the
//   CUDA cores, 67 TFLOP/s).
//   bf16 runs the Hopper design of pct_embed_sm90.cu (TMA ring, wgmma with
//   the prologue applied on the register-A fragments, sums from the
//   accumulators). f32 runs one job on tail_f32.cuh's mainloop
//   (embed_f32.cuh, HJob<kFwd>): block b of `blocks` takes the flat 64-row
//   tiles b, b + blocks, ... two at a time as one 128 x 128 tile; each
//   k-step copies 16 columns of h0's rows with 16-byte copies and its prep
//   hook applies the prologue while transposing them into the k-major A;
//   W1's rows are B. The epilogue writes h1 from the registers and passes
//   the tile through the ring's spare stage to a thread per (channel, row
//   parity), which adds m·h and m·h² over its rows in the first version's
//   order. Tiles straddle objects: each row takes its own object's mask.
//   Both dtypes keep one sum slice per block (bf16: per consumer
//   warpgroup); reduce_slices adds them in order, no atomics.

#include "embed_f32.cuh"

namespace sga {
namespace {

constexpr int kC = 128;       // embedding width
constexpr int kThreads = 256;  // 2 row lanes x 128 channels

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

// The f32 forward: slice blockIdx.x of gridDim.x, its masked sums into the
// block's slice of the scratch
__global__ void __launch_bounds__(kThreads, 2)
embed_second_f32_kernel(const float* __restrict__ h0, const float* __restrict__ wf,
                        const float* __restrict__ bf, const float* __restrict__ w,
                        const float* __restrict__ mask, float* __restrict__ h1,
                        float* __restrict__ scratch, int o, int p) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float swf[kC], sbf[kC], mrow[kC];
  if (threadIdx.x < kC) {
    swf[threadIdx.x] = wf[threadIdx.x];
    sbf[threadIdx.x] = bf[threadIdx.x];
  }
  const tail_f32::Slice sl{(long long)o * p, p, (int)gridDim.x, (int)blockIdx.x, 1};
  e2f32::HJob<e2f32::kFwd> job{h0, w, mask, nullptr, nullptr, nullptr, h1,
                               swf, sbf, mrow, sl, sl.count(), p};
  // run's first __syncthreads (before the first prep) publishes swf, sbf
  tail_f32::run(job, reinterpret_cast<float*>(smem));
  write_channel_sums(job.a1, job.a2, scratch);
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
//   Bound on the H100: bytes at bf16 (h0 and dh read, dh0 written; 768
//   FLOP per row of 256 bytes, below the ridge); operations at f32 (three
//   128-deep products a row).
//   bf16 runs the Hopper design of pct_embed_bwd_sm90.cu (two warpgroups,
//   each with its own TMA ring and all of its dW1 in registers). f32 runs
//   tail_f32.cuh's mainloop in passes (embed_f32.cuh), with dz [O·P, 128]
//   and W1ᵀ in a work buffer:
//     1. W1ᵀ (a 128 x 128 transpose, so the dx0 pass copies B's rows 16
//        bytes at a time);
//     2. dz: the forward's product (HJob<kDz>) over as many slices as stay
//        resident, dz formed from h in the epilogue;
//     3. one launch of 2·blocks: block b < blocks forms slice b's dW1 =
//        x0ᵀ·dz (DwJob: h0's rows through a prep that applies the prologue,
//        its 128 x 128 share in registers over all its rows), block
//        blocks + b slice b's dx0 = dz·W1ᵀ with g0, dh0 and the dwf, dbf
//        sums in the epilogue in the first version's order (DxJob);
//     4. reduce_slices adds the slices (dW1, dwf, dbf) in order.

constexpr int kE2Grad = kC * kC + 2 * kC;              // dW1, dwf, dbf

__global__ void transpose128_kernel(const float* __restrict__ w, float* __restrict__ wt) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;  // w[n][k], n = i / 128
  if (i < kC * kC) wt[(i % kC) * kC + i / kC] = w[i];
}

__global__ void __launch_bounds__(kThreads, 2)
embed_second_dz_kernel(const float* __restrict__ h0, const float* __restrict__ wf,
                       const float* __restrict__ bf, const float* __restrict__ w,
                       const float* __restrict__ mask, const float* __restrict__ dh,
                       const float* __restrict__ ds1, const float* __restrict__ ds2,
                       float* __restrict__ dz, int o, int p) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float swf[kC], sbf[kC];
  if (threadIdx.x < kC) {
    swf[threadIdx.x] = wf[threadIdx.x];
    sbf[threadIdx.x] = bf[threadIdx.x];
  }
  const tail_f32::Slice sl{(long long)o * p, p, (int)gridDim.x, (int)blockIdx.x, 1};
  e2f32::HJob<e2f32::kDz> job{h0, w, mask, dh, ds1, ds2, dz,
                              swf, sbf, nullptr, sl, sl.count(), p};
  tail_f32::run(job, reinterpret_cast<float*>(smem));
}

__global__ void __launch_bounds__(kThreads, 2)
embed_second_wgrad_kernel(const float* __restrict__ h0, const float* __restrict__ wf,
                          const float* __restrict__ bf, const float* __restrict__ dz,
                          const float* __restrict__ wt, float* __restrict__ dh0,
                          float* __restrict__ scratch, long long stride, int o, int p,
                          int blocks) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);
  const int c = threadIdx.x % kC, b = (int)blockIdx.x % blocks;
  const tail_f32::Slice sl{(long long)o * p, p, blocks, b, 1};
  float* part = scratch + (size_t)b * stride;  // dW1 [128, 128], dwf, dbf
  if ((int)blockIdx.x < blocks) {
    e2f32::DwJob job{h0, dz, part, sl, sl.count(), wf[c], bf[c]};
    tail_f32::run_slice(job, ring);
  } else {
    e2f32::DxJob job{dz, wt, h0, dh0, sl, sl.count(), wf[c], bf[c]};
    tail_f32::run(job, ring);
    store_channel_sums(job.rwf, part + kC * kC);
    store_channel_sums(job.rbf, part + kC * kC + kC);
  }
}

int launch_second_bwd_f32(const void* h0, const void* wf, const void* bf, const void* w,
                          const void* mask, const void* dh, const float* ds1, const float* ds2,
                          void* dh0, float* work, float* scratch, int blocks, float* grads,
                          int o, int p, cudaStream_t st) {
  const long long rows = (long long)o * p;
  float* dz = work;
  float* wt = work + rows * kC;
  const float *fh0 = (const float*)h0, *fwf = (const float*)wf, *fbf = (const float*)bf;
  transpose128_kernel<<<kC * kC / kThreads, kThreads, 0, st>>>((const float*)w, wt);
  if (int rc = (int)cudaGetLastError()) return rc;

  const size_t smem = e2f32::kRawRingBytes;
  if (int rc = allow_smem(embed_second_dz_kernel, smem)) return rc;
  const int dz_blocks =
      resident_grid(embed_second_dz_kernel, kThreads, smem, ((rows + 63) / 64 + 1) / 2);
  embed_second_dz_kernel<<<dz_blocks, kThreads, smem, st>>>(
      fh0, fwf, fbf, (const float*)w, (const float*)mask, (const float*)dh, ds1, ds2, dz, o, p);
  if (int rc = (int)cudaGetLastError()) return rc;

  if (int rc = allow_smem(embed_second_wgrad_kernel, smem)) return rc;
  const long long stride = slice_stride(kE2Grad);
  embed_second_wgrad_kernel<<<2 * blocks, kThreads, smem, st>>>(
      fh0, fwf, fbf, dz, wt, (float*)dh0, scratch, stride, o, p, blocks);
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

int launch_second_f32(const void* h0, const void* wf, const void* bf, const void* w,
                      const void* mask, void* h1, float* scratch, int blocks, float* sums, int o,
                      int p, cudaStream_t st) {
  const size_t smem = e2f32::kRawRingBytes;
  if (int rc = allow_smem(embed_second_f32_kernel, smem)) return rc;
  embed_second_f32_kernel<<<blocks, kThreads, smem, st>>>(
      (const float*)h0, (const float*)wf, (const float*)bf, (const float*)w, (const float*)mask,
      (float*)h1, scratch, o, p);
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
  return sga::launch_second_f32(h0, wf, bf, w, mask, h1, scratch, blocks, sums, o, p, st);
}

// grads: dW1 [128, 128], dwf [128], dbf [128] back to back, f32; work:
// f32 only, O·P·128 + 128·128 floats (dz, then W1ᵀ); bf16 takes the wgmma
// design (pct_embed_bwd_sm90.cu), with `blocks` even: one slice per
// warpgroup of blocks / 2 persistent blocks
int sga_embed_second_bwd(const void* h0, const void* wf, const void* bf, const void* w,
                         const void* mask, const void* dh, const float* ds1, const float* ds2,
                         void* dh0, float* work, float* scratch, int blocks, float* grads, int o,
                         int p, int dtype, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == sga::kBF16)
    return sga::launch_embed_second_bwd_sm90(h0, wf, bf, w, mask, dh, ds1, ds2, dh0, scratch,
                                             blocks, grads, o, p, st);
  return sga::launch_second_bwd_f32(h0, wf, bf, w, mask, dh, ds1, ds2, dh0, work, scratch,
                                    blocks, grads, o, p, st);
}

const char* sga_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
