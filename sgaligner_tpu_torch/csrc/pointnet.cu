// PointNet object encoder (parity mode), forward and backward.
//
// pointnet_fwd replaces sgaligner_tpu/ops/pointnet_fused.py::_forward (Pallas
// kernel _fwd_kernel): for channel-first points x [O, 3, P] and weights
// w1 [3, 64], w2 [64, 128], w3 [128, C3] with biases [1, C]:
//   a1 = xᵀ·w1 + b1, h1 = relu(a1) rounded to the compute dtype;
//   a2 = h1·w2 + b2, h2 = relu(a2) rounded;   a3 = h2·w3 + b3 (f32);
//   out [O, C3] f32 = max over P of relu(a3); with the training flag also
//   amax [O, C3] int32 = the first point index reaching that max.
// Every product accumulates in f32 and takes its bias in f32; the relu masks
// come from the f32 pre-activations (the rounding points of _stack_from_cf).
// relu keeps a NaN, as jnp.maximum and torch.relu do.
//   Bound on the H100: operations. 2·P·(3·64 + 64·128 + 128·C3) FLOP per
//   object (42 MFLOP at P = 512, C3 = 256) against 3·P input values read.
//   bf16 runs the Hopper design of pointnet_sm90.cu (wgmma, the max and
//   argmax in registers). f32: a block walks whole objects (grid-stride, as
//   many blocks as fit), so the max over P and its argmax never cross
//   blocks; w2 and w3 are read from L2 (the bf16 backward's Stack keeps
//   them in shared memory, 17 KB + 68 KB). Points go through in 32-row chunks: layer 1 (K = 3) as f32 FMAs,
//   layers 2 and 3 through block_gemm (bf16 WMMA, f32 accumulators); the
//   epilogue keeps each channel's running max and argmax in shared memory.
//   The [O, P, 64/128/C3] activations never reach device memory.
//
// pointnet_bwd replaces ops/pointnet_fused.py::_bwd_rule (Pallas kernel
// _bwd_kernel): recompute the stack (the f32 forward's device code, Stack
// below; the bf16 forward runs the wgmma design of pointnet_sm90.cu, whose
// sums may differ in the last bits, so a relu mask near 0 may flip between
// the passes: the routed point then carries no gradient, as a3 <= 0 there),
// route dout [O, C3] to the argmax point of each channel (g3 = dout where
// picked and a3 > 0), then
//   g2 = (g3·w3ᵀ) masked by a2 > 0, g1 = (g2·w2ᵀ) masked by a1 > 0, each
//   rounded to the compute dtype; dw3 = Σ h2ᵀ·g3, dw2 = Σ h1ᵀ·g2,
//   dw1 = Σ xᵀ·g1 (contracting P), db = Σ g, all f32. No dx: points are data.
//   Bound on the H100: operations, ≈ 3x the forward (recompute, two data
//   gradients, three weight gradients).
//   Design: the TPU kernel summed the weight gradients across its sequential
//   grid in VMEM; CUDA blocks run in no order. Each block owns a slice of a
//   scratch buffer (one f32 copy of every gradient) and adds its objects'
//   gradients to it: dw3 and dw2 straight from the WMMA accumulators
//   (block_gemm with a transposed A, C in global memory), db by column sums,
//   dw1 and db1 in registers. A second launch sums the slices in a fixed
//   order. No atomics, so the result is the same from run to run.
#include "common.cuh"

namespace sga {
namespace {

constexpr int kC1 = 64;        // conv1 width
constexpr int kC2 = 128;       // conv2 width
constexpr int kR = 32;         // points per chunk
constexpr int kThreads = 256;

// gradient scratch layout (floats): dw1, db1, dw2, db2, dw3, db3
constexpr int kOffDb1 = 3 * kC1;
constexpr int kOffDw2 = kOffDb1 + kC1;
constexpr int kOffDb2 = kOffDw2 + kC1 * kC2;
constexpr int kOffDw3 = kOffDb2 + kC2;
__host__ __device__ inline int off_db3(int c3) { return kOffDw3 + kC2 * c3; }
__host__ __device__ inline int grad_total(int c3) { return off_db3(c3) + c3; }
__host__ __device__ inline int grad_stride(int c3) { return (int)slice_stride(grad_total(c3)); }

__device__ __forceinline__ float relu_nan(float a) { return (a > 0.f || a != a) ? a : 0.f; }

// Reserve n bytes at offset o (128-byte aligned); returns where they start.
__host__ __device__ inline size_t take(size_t& o, size_t n) {
  const size_t at = o;
  o = align128(o + n);
  return at;
}

// Shared-memory layout; bf16 keeps w2 and w3 resident (f32 reads them from
// global memory).
template <typename T>
struct Layout {
  static constexpr bool kStage = std::is_same<T, bf16>::value;
  int ldw2, ldw3, ldh1, ldh2, ldacc, ldg, ldg2;
  size_t w2, w3, xs, h1, h2, acc, best, idx, g, g2, m1, m2, bytes;

  __host__ __device__ Layout(int c3, bool bwd) {
    ldw2 = pad_ld<T>(kC2);
    ldw3 = pad_ld<T>(c3);
    ldh1 = pad_ld<T>(kC1);
    ldh2 = pad_ld<T>(kC2);
    ldacc = pad_ldf(c3 > kC2 ? c3 : kC2);
    ldg = pad_ld<T>(c3 > kC1 ? c3 : kC1);
    ldg2 = pad_ld<T>(kC2);
    size_t o = 0;
    w2 = take(o, kStage ? sizeof(T) * kC1 * ldw2 : 0);
    w3 = take(o, kStage ? sizeof(T) * kC2 * ldw3 : 0);
    xs = take(o, sizeof(float) * 3 * kR);
    h1 = take(o, sizeof(T) * kR * ldh1);
    h2 = take(o, sizeof(T) * kR * ldh2);
    acc = take(o, sizeof(float) * kR * ldacc);
    best = take(o, bwd ? 0 : sizeof(float) * c3);
    idx = take(o, bwd ? 0 : sizeof(int) * c3);
    g = take(o, bwd ? sizeof(T) * kR * ldg : 0);
    g2 = take(o, bwd ? sizeof(T) * kR * ldg2 : 0);
    m1 = take(o, bwd ? kR * kC1 : 0);
    m2 = take(o, bwd ? kR * kC2 : 0);
    bytes = o;
  }
};

// Per-block view of the stack: operand pointers in shared (or global) memory.
template <typename T>
struct Stack {
  const Layout<T> L;
  unsigned char* base;
  const T *w1, *b1, *b2, *w2s, *w3s;
  int ldw2s, ldw3s, c3;

  __device__ Stack(unsigned char* smem, int c3_, bool bwd, const T* w1_, const T* b1_,
                   const T* w2, const T* b2_, const T* w3)
      : L(c3_, bwd), base(smem), w1(w1_), b1(b1_), b2(b2_), c3(c3_) {
    if constexpr (Layout<T>::kStage) {
      T* sw2 = reinterpret_cast<T*>(smem + L.w2);
      T* sw3 = reinterpret_cast<T*>(smem + L.w3);
      load_tile<T>(sw2, L.ldw2, w2, kC2, kC1, kC2, kC1);
      load_tile<T>(sw3, L.ldw3, w3, c3, kC2, c3, kC2);
      w2s = sw2;
      w3s = sw3;
      ldw2s = L.ldw2;
      ldw3s = L.ldw3;
    } else {
      w2s = w2;
      w3s = w3;
      ldw2s = kC2;
      ldw3s = c3;
    }
  }
  __device__ float* xs() const { return reinterpret_cast<float*>(base + L.xs); }
  __device__ T* h1() const { return reinterpret_cast<T*>(base + L.h1); }
  __device__ T* h2() const { return reinterpret_cast<T*>(base + L.h2); }
  __device__ float* acc() const { return reinterpret_cast<float*>(base + L.acc); }
  __device__ uint8_t* m1() const { return base + L.m1; }
  __device__ uint8_t* m2() const { return base + L.m2; }

  // Points [r0, r0 + valid) of one object: stages x, computes h1 and h2 (and
  // the masks a1 > 0, a2 > 0 when asked) and leaves h2·w3 (no bias) in acc.
  // Rows >= valid compute from zero points; callers ignore them.
  __device__ void chunk(const T* __restrict__ xo, int p, int r0, int valid, bool masks) const {
    float* x = xs();
    for (int i = threadIdx.x; i < 3 * kR; i += blockDim.x) {
      const int k = i / kR, r = i % kR;
      x[i] = r < valid ? to_f<T>(xo[(size_t)k * p + r0 + r]) : 0.f;
    }
    __syncthreads();
    T* sh1 = h1();
    for (int i = threadIdx.x; i < kR * kC1; i += blockDim.x) {
      const int r = i / kC1, c = i % kC1;
      float a = x[r] * to_f<T>(w1[c]);
      a = fmaf(x[kR + r], to_f<T>(w1[kC1 + c]), a);
      a = fmaf(x[2 * kR + r], to_f<T>(w1[2 * kC1 + c]), a);
      a += to_f<T>(b1[c]);
      sh1[r * L.ldh1 + c] = from_f<T>(relu_nan(a));
      if (masks) m1()[i] = a > 0.f;
    }
    __syncthreads();
    float* sc = acc();
    block_gemm<T, false>(sh1, L.ldh1, w2s, ldw2s, sc, L.ldacc, kR, kC2, kC1, false);
    __syncthreads();
    T* sh2 = h2();
    for (int i = threadIdx.x; i < kR * kC2; i += blockDim.x) {
      const int r = i / kC2, c = i % kC2;
      const float a = sc[r * L.ldacc + c] + to_f<T>(b2[c]);
      sh2[r * L.ldh2 + c] = from_f<T>(relu_nan(a));
      if (masks) m2()[i] = a > 0.f;
    }
    __syncthreads();
    block_gemm<T, false>(sh2, L.ldh2, w3s, ldw3s, sc, L.ldacc, kR, c3, kC2, false);
    __syncthreads();
  }
};

template <typename T, bool ARGMAX>
__global__ void __launch_bounds__(kThreads)
pointnet_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w1, const T* __restrict__ b1,
                    const T* __restrict__ w2, const T* __restrict__ b2, const T* __restrict__ w3,
                    const T* __restrict__ b3, float* __restrict__ out, int* __restrict__ amax,
                    int o, int p, int c3) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Stack<T> s(smem, c3, false, w1, b1, w2, b2, w3);
  float* best = reinterpret_cast<float*>(smem + s.L.best);
  int* idx = reinterpret_cast<int*>(smem + s.L.idx);
  const float* sc = s.acc();
  // each thread owns the same channels throughout, so best/idx need no sync
  for (int c = threadIdx.x; c < c3; c += blockDim.x) {
    best[c] = -INFINITY;
    idx[c] = 0;
  }
  for (int obj = blockIdx.x; obj < o; obj += gridDim.x) {
    const T* xo = x + (size_t)obj * 3 * p;
    for (int r0 = 0; r0 < p; r0 += kR) {
      const int valid = min(kR, p - r0);
      s.chunk(xo, p, r0, valid, false);
      for (int c = threadIdx.x; c < c3; c += blockDim.x) {
        const float bias = to_f<T>(b3[c]);
        float bv = best[c];
        int bi = idx[c];
        for (int r = 0; r < valid; ++r) {
          const float v = relu_nan(sc[r * s.L.ldacc + c] + bias);
          // strictly greater: the first index wins a tie; a NaN sticks
          if (bv == bv && (v > bv || v != v)) {
            bv = v;
            bi = r0 + r;
          }
        }
        best[c] = bv;
        idx[c] = bi;
      }
      __syncthreads();  // acc is rewritten by the next chunk
    }
    for (int c = threadIdx.x; c < c3; c += blockDim.x) {
      out[(size_t)obj * c3 + c] = best[c];
      if constexpr (ARGMAX) amax[(size_t)obj * c3 + c] = idx[c];
      best[c] = -INFINITY;
      idx[c] = 0;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
pointnet_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dout,
                    const int* __restrict__ amax, const T* __restrict__ w1,
                    const T* __restrict__ b1, const T* __restrict__ w2, const T* __restrict__ b2,
                    const T* __restrict__ w3, const T* __restrict__ b3, float* __restrict__ scratch,
                    int o, int p, int c3) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* part = scratch + (size_t)blockIdx.x * grad_stride(c3);
  for (int i = threadIdx.x; i < grad_total(c3); i += blockDim.x) part[i] = 0.f;
  const Stack<T> s(smem, c3, true, w1, b1, w2, b2, w3);
  const Layout<T>& L = s.L;
  T* g = reinterpret_cast<T*>(smem + L.g);     // g3, then g1
  T* g2 = reinterpret_cast<T*>(smem + L.g2);
  float* sc = s.acc();
  const float* xs = s.xs();
  // dw1 [3, 64] and db1 [64] in registers: thread t < 192 owns dw1[t / 64][t % 64],
  // the next 64 threads own db1
  const int t = threadIdx.x;
  float r1 = 0.f;
  __syncthreads();

  for (int obj = blockIdx.x; obj < o; obj += gridDim.x) {
    const T* xo = x + (size_t)obj * 3 * p;
    for (int r0 = 0; r0 < p; r0 += kR) {
      const int valid = min(kR, p - r0);
      s.chunk(xo, p, r0, valid, true);
      // g3: dout at the argmax point where a3 > 0
      for (int i = threadIdx.x; i < kR * c3; i += blockDim.x) {
        const int r = i / c3, c = i % c3;
        const size_t oc = (size_t)obj * c3 + c;
        const float a3 = sc[r * L.ldacc + c] + to_f<T>(b3[c]);
        const bool routed = amax[oc] == r0 + r && a3 > 0.f;
        g[r * L.ldg + c] = from_f<T>(routed ? to_f<T>(dout[oc]) : 0.f);
      }
      __syncthreads();
      for (int c = threadIdx.x; c < c3; c += blockDim.x) {
        float sum = 0.f;
        for (int r = 0; r < kR; ++r) sum += to_f<T>(g[r * L.ldg + c]);
        part[off_db3(c3) + c] += sum;
      }
      block_gemm<T, false, true>(s.h2(), L.ldh2, g, L.ldg, part + kOffDw3, c3, kC2, c3, kR, true);
      block_gemm<T, true>(g, L.ldg, s.w3s, s.ldw3s, sc, L.ldacc, kR, kC2, c3, false);
      __syncthreads();
      for (int i = threadIdx.x; i < kR * kC2; i += blockDim.x) {
        const int r = i / kC2, c = i % kC2;
        g2[r * L.ldg2 + c] = from_f<T>(s.m2()[i] ? sc[r * L.ldacc + c] : 0.f);
      }
      __syncthreads();
      for (int c = threadIdx.x; c < kC2; c += blockDim.x) {
        float sum = 0.f;
        for (int r = 0; r < kR; ++r) sum += to_f<T>(g2[r * L.ldg2 + c]);
        part[kOffDb2 + c] += sum;
      }
      block_gemm<T, false, true>(s.h1(), L.ldh1, g2, L.ldg2, part + kOffDw2, kC2, kC1, kC2, kR,
                                 true);
      block_gemm<T, true>(g2, L.ldg2, s.w2s, s.ldw2s, sc, L.ldacc, kR, kC1, kC2, false);
      __syncthreads();
      for (int i = threadIdx.x; i < kR * kC1; i += blockDim.x) {
        const int r = i / kC1, c = i % kC1;
        g[r * L.ldg + c] = from_f<T>(s.m1()[i] ? sc[r * L.ldacc + c] : 0.f);
      }
      __syncthreads();
      if (t < 3 * kC1) {
        const int k = t / kC1, c = t % kC1;
        for (int r = 0; r < valid; ++r) r1 = fmaf(xs[k * kR + r], to_f<T>(g[r * L.ldg + c]), r1);
      } else if (t < 4 * kC1) {
        for (int r = 0; r < valid; ++r) r1 += to_f<T>(g[r * L.ldg + t - 3 * kC1]);
      }
      __syncthreads();  // xs, h1, h2, g are rewritten by the next chunk
    }
  }
  if (t < 4 * kC1) part[t] = r1;  // dw1 then db1: offsets 0 and 192
}

template <typename T>
int bwd_blocks(int o, int c3) {
  const size_t smem = Layout<T>(c3, true).bytes;
  if (int rc = allow_smem(pointnet_bwd_kernel<T>, smem)) return -rc;
  return resident_grid(pointnet_bwd_kernel<T>, kThreads, smem, o);
}

template <typename T>
int launch_fwd(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
               const void* w3, const void* b3, float* out, int* amax, int o, int p, int c3,
               cudaStream_t st) {
  const size_t smem = Layout<T>(c3, false).bytes;
  if (amax != nullptr) {
    if (int rc = allow_smem(pointnet_fwd_kernel<T, true>, smem)) return rc;
    const int grid = resident_grid(pointnet_fwd_kernel<T, true>, kThreads, smem, o);
    pointnet_fwd_kernel<T, true><<<grid, kThreads, smem, st>>>(
        (const T*)x, (const T*)w1, (const T*)b1, (const T*)w2, (const T*)b2, (const T*)w3,
        (const T*)b3, out, amax, o, p, c3);
  } else {
    if (int rc = allow_smem(pointnet_fwd_kernel<T, false>, smem)) return rc;
    const int grid = resident_grid(pointnet_fwd_kernel<T, false>, kThreads, smem, o);
    pointnet_fwd_kernel<T, false><<<grid, kThreads, smem, st>>>(
        (const T*)x, (const T*)w1, (const T*)b1, (const T*)w2, (const T*)b2, (const T*)w3,
        (const T*)b3, out, nullptr, o, p, c3);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* x, const void* dout, const int* amax, const void* w1, const void* b1,
               const void* w2, const void* b2, const void* w3, const void* b3, float* scratch,
               int blocks, float* grads, int o, int p, int c3, cudaStream_t st) {
  const size_t smem = Layout<T>(c3, true).bytes;
  if (int rc = allow_smem(pointnet_bwd_kernel<T>, smem)) return rc;
  pointnet_bwd_kernel<T><<<blocks, kThreads, smem, st>>>(
      (const T*)x, (const T*)dout, amax, (const T*)w1, (const T*)b1, (const T*)w2, (const T*)b2,
      (const T*)w3, (const T*)b3, scratch, o, p, c3);
  if (int rc = (int)cudaGetLastError()) return rc;
  return reduce_slices(scratch, grad_stride(c3), blocks, grads, grad_total(c3), st);
}

}  // namespace

int launch_pointnet_fwd_sm90(const void* x, const void* w1, const void* b1, const void* w2,
                             const void* b2, const void* w3, const void* b3, float* out,
                             int* amax, int o, int p, int c3, cudaStream_t st);

}  // namespace sga

extern "C" {

// Floats of one block's gradient slice (the scratch row stride), and the
// flat gradient buffer's length: dw1, db1, dw2, db2, dw3, db3 back to back.
int sga_pointnet_grad_stride(int c3) { return sga::grad_stride(c3); }
int sga_pointnet_grad_total(int c3) { return sga::grad_total(c3); }

// Blocks the backward launches for O objects (the scratch holds one slice
// each); a negative value is a CUDA error code.
int sga_pointnet_bwd_blocks(int o, int c3, int dtype) {
  if (dtype == sga::kBF16) return sga::bwd_blocks<sga::bf16>(o, c3);
  return sga::bwd_blocks<float>(o, c3);
}

int sga_pointnet_fwd(const void* x, const void* w1, const void* b1, const void* w2,
                     const void* b2, const void* w3, const void* b3, float* out, int* amax, int o,
                     int p, int c3, int dtype, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == sga::kBF16)
    return sga::launch_pointnet_fwd_sm90(x, w1, b1, w2, b2, w3, b3, out, amax, o, p, c3, st);
  return sga::launch_fwd<float>(x, w1, b1, w2, b2, w3, b3, out, amax, o, p, c3, st);
}

int sga_pointnet_bwd(const void* x, const void* dout, const int* amax, const void* w1,
                     const void* b1, const void* w2, const void* b2, const void* w3,
                     const void* b3, float* scratch, int blocks, float* grads, int o, int p,
                     int c3, int dtype, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == sga::kBF16)
    return sga::launch_bwd<sga::bf16>(x, dout, amax, w1, b1, w2, b2, w3, b3, scratch, blocks,
                                      grads, o, p, c3, st);
  return sga::launch_bwd<float>(x, dout, amax, w1, b1, w2, b2, w3, b3, scratch, blocks, grads, o,
                                p, c3, st);
}

}  // extern "C"
