// LRN backward (local response normalization across channels) for Hopper.
//
// Replaces the Pallas TPU kernel veles_tpu/ops/lrn_pallas.py:_bwd_kernel
// (lrn_bwd, pallas_call at lrn_pallas.py:162).  Same function, not the
// same blocks.  Over x and the error e viewed as (rows, C), channels last:
//
//   s[r, c]  = sum_{j=c-lo}^{c+hi} x[r, j]^2     (the forward's window)
//   den      = k + alpha * s,   d = den^-beta,   d1 = den^-(beta+1)
//   t[r, c]  = e[r, c] * x[r, c] * d1            (rounded to the input dtype)
//   wt[r, c] = sum_{j=c-hi}^{c+lo} t[r, j]       (the ADJOINT window)
//   out      = e * d - 2 * alpha * beta * x * wt
//
// with lo = n/2, hi = n-1-lo, taps clipped to [0, C).  The adjoint window
// differs from the forward one for even n.  den is recomputed from x (the
// forward keeps no residual but x).  x^2 is rounded to the input dtype
// before the f32 sum and t is rounded to the input dtype before the
// adjoint sum, as the TPU kernel does (it feeds both sums to the matrix
// unit in the input dtype); every other step runs in f32.  For beta = 3/4,
// r = rsqrt(den), d = r * sqrt(r) and d1 = d * r * r; any other beta takes
// powf.  The elementwise steps use round-to-nearest intrinsics so that
// nvcc does not contract them into fused multiply-adds: the kernel then
// rounds at the same places as the plain PyTorch version it is held
// against (veles_tpu_torch/ops/lrn_cuda.py:lrn_bwd_plain).
//
// Bound: memory.  The op reads x and e once and writes the result once
// (3 * numel * itemsize bytes) and does about 2n + 12 flops per element.
// AlexNet's first norm at batch 128, (128*55*55, 96) in bf16, moves 223 MB:
// 66.6 us at 3.35 TB/s.
//
// Design (simple and right first): one block owns a tile of whole rows, so
// both windows stay inside the block and any row count works (the last
// tile is shorter).
//   1. Stage: x and e are read from device memory once, 16 bytes per
//      thread per load where rows are 16-byte multiples and the pointers
//      16-byte aligned.  Shared memory per element: e*d (f32), x and e
//      (input dtype): 8 bytes in bf16, 12 in f32, so a block takes rows of
//      up to 232448 / 12 = 19370 channels in f32.
//   2. Pass 1: one thread per (row, channel) sums the forward window of
//      rounded squares, writes e*d, and overwrites its own e with the
//      rounded t (no other thread reads that e).  Barrier.
//   3. Pass 2: one thread per (row, channel) sums t over the adjoint
//      window and writes the result; consecutive threads take consecutive
//      channels, so stores coalesce.
// The wrapper (veles_tpu_torch/ops/lrn_cuda.py) allocates the result,
// checks shapes and dtypes, and raises on a nonzero return.

#include "lrn_common.cuh"

namespace {

using namespace veles_lrn;

// VEC: elements per 16-byte load (16 / sizeof(T)), or 1 where a row is
// not a multiple of 16 bytes or a pointer is not 16-byte aligned
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
lrn_bwd_kernel(const T* __restrict__ x, const T* __restrict__ e,
               T* __restrict__ out, long long rows, int c,
               int rows_per_block, int lo, int hi, float k, float alpha,
               float beta, float coef) {
  extern __shared__ float4 smem[];
  const long long row0 = static_cast<long long>(blockIdx.x) * rows_per_block;
  const long long left = rows - row0;
  const int nr = left < rows_per_block ? static_cast<int>(left)
                                       : rows_per_block;
  const long long base = row0 * c;
  const int count = nr * c;
  const size_t tile = static_cast<size_t>(rows_per_block) * c;
  // e*d first (f32, 16-byte aligned), then x, then e (later t); with VEC
  // > 1, C is a multiple of VEC, so each array starts 16-byte aligned
  float* ed = reinterpret_cast<float*>(smem);
  T* xs = reinterpret_cast<T*>(ed + tile);
  T* es = xs + tile;

  if constexpr (VEC > 1) {
    const uint4* xsrc = reinterpret_cast<const uint4*>(x + base);
    const uint4* esrc = reinterpret_cast<const uint4*>(e + base);
    uint4* xdst = reinterpret_cast<uint4*>(xs);
    uint4* edst = reinterpret_cast<uint4*>(es);
    const int nvec = count / VEC;
#pragma unroll 4
    for (int v = threadIdx.x; v < nvec; v += blockDim.x) {
      xdst[v] = xsrc[v];
      edst[v] = esrc[v];
    }
  } else {
#pragma unroll 4
    for (int i = threadIdx.x; i < count; i += blockDim.x) {
      xs[i] = x[base + i];
      es[i] = e[base + i];
    }
  }
  __syncthreads();

  const int step_r = blockDim.x / c;
  const int step_c = blockDim.x - step_r * c;
  const int r0 = threadIdx.x / c;
  const int ch0 = threadIdx.x - r0 * c;

  // pass 1: e*d and the rounded t
  int r = r0, ch = ch0;
  for (int i = threadIdx.x; i < count; i += blockDim.x) {
    const T* row = xs + r * c;
    const int j0 = max(ch - lo, 0);
    const int j1 = min(ch + hi, c - 1);
    float s = 0.f;
    for (int j = j0; j <= j1; ++j) s = __fadd_rn(s, square(row[j]));
    const float den = __fadd_rn(k, __fmul_rn(alpha, s));
    float d, d1;
    if (beta == 0.75f) {
      const float rs = rsqrtf(den);
      d = __fmul_rn(rs, sqrtf(rs));
      d1 = __fmul_rn(__fmul_rn(d, rs), rs);
    } else {
      d = powf(den, -beta);
      d1 = powf(den, -beta - 1.f);
    }
    const float xf = to_f32(xs[i]);
    const float ef = to_f32(es[i]);
    ed[i] = __fmul_rn(ef, d);
    es[i] = from_f32<T>(__fmul_rn(__fmul_rn(ef, xf), d1));
    ch += step_c;
    r += step_r;
    if (ch >= c) {
      ch -= c;
      ++r;
    }
  }
  __syncthreads();

  // pass 2: the adjoint window sum of t and the result
  r = r0;
  ch = ch0;
  for (int i = threadIdx.x; i < count; i += blockDim.x) {
    const T* trow = es + r * c;
    const int j0 = max(ch - hi, 0);
    const int j1 = min(ch + lo, c - 1);
    float wt = 0.f;
    for (int j = j0; j <= j1; ++j) wt = __fadd_rn(wt, to_f32(trow[j]));
    const float xf = to_f32(xs[i]);
    out[base + i] =
        from_f32<T>(__fsub_rn(ed[i], __fmul_rn(__fmul_rn(coef, xf), wt)));
    ch += step_c;
    r += step_r;
    if (ch >= c) {
      ch -= c;
      ++r;
    }
  }
}

template <typename T, int VEC>
int launch(const void* x, const void* e, void* out, long long rows, int c,
           int n, float k, float alpha, float beta, float coef,
           cudaStream_t stream) {
  const int rpb = tile_rows(rows, c);
  const size_t smem =
      static_cast<size_t>(rpb) * c * (sizeof(float) + 2 * sizeof(T));
  if (smem > 48 * 1024) {
    const cudaError_t err = allow_large_smem<lrn_bwd_kernel<T, VEC>>();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long blocks = (rows + rpb - 1) / rpb;
  const int lo = n / 2;
  const int hi = n - 1 - lo;
  lrn_bwd_kernel<T, VEC><<<static_cast<unsigned>(blocks), kThreads, smem,
                           stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(e),
      static_cast<T*>(out), rows, c, rpb, lo, hi, k, alpha, beta, coef);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* x, const void* e, void* out, long long rows, int c,
             int n, float k, float alpha, float beta, float coef,
             cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const bool aligned = c % kVec == 0 &&
                       reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(e) % 16 == 0;
  return aligned ? launch<T, kVec>(x, e, out, rows, c, n, k, alpha, beta,
                                   coef, stream)
                 : launch<T, 1>(x, e, out, rows, c, n, k, alpha, beta, coef,
                                stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, e and out share it).  coef is
// 2 * alpha * beta, rounded once by the caller.  Returns a cudaError_t
// (0 = launched).
extern "C" int veles_lrn_bwd(const void* x, const void* e, void* out,
                             long long rows, int c, int n, float k,
                             float alpha, float beta, float coef, int dtype,
                             void* stream) {
  if (rows <= 0 || c <= 0 || n <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return dispatch<float>(x, e, out, rows, c, n, k, alpha, beta, coef, s);
    case 1:
      return dispatch<__nv_bfloat16>(x, e, out, rows, c, n, k, alpha, beta,
                                     coef, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
