// LRN forward (local response normalization across channels) for Hopper.
//
// Replaces the Pallas TPU kernel veles_tpu/ops/lrn_pallas.py:_fwd_kernel
// (lrn_fwd, pallas_call at lrn_pallas.py:140).  Same function, not the
// same blocks:
//
//   y[r, c] = x[r, c] * (k + alpha * sum_{j=c-lo}^{c+hi} x[r, j]^2) ^ -beta
//
// over x viewed as (rows, C) with channels last, taps j in
// [c - n/2, c + n-1-n/2] clipped to [0, C) -- exactly the n taps of
// band_matrix(C, n) for odd and even n.  x^2 is rounded to the input
// dtype before the sum (the TPU kernel squares in the input dtype and
// dots with f32 accumulation); every other step runs in f32.  For
// beta = 3/4 the power is r * sqrt(r) with r = rsqrt(den), as on the
// TPU; any other beta takes powf, so the kernel covers every config the
// layer accepts.
//
// Bound: memory.  The op reads x once and writes y once
// (2 * numel * itemsize bytes) and does about n + 6 flops per element,
// far below the card's ratio of flops to bytes.  AlexNet's first norm at
// batch 64, (64*55*55, 96) in bf16, moves 74 MB: 22 us at 3.35 TB/s.
//
// Design: one block owns a tile of whole rows, so the channel window
// never leaves the block and no block waits on another (the TPU's grid
// split rows the same way, but needed a row count with a multiple-of-8
// divisor; here the last tile is simply shorter).
//   1. Stage: the tile is read from device memory once, 16 bytes per
//      thread per load where rows are 16-byte multiples (VEC elements
//      a load), several loads in flight per thread; shared memory keeps
//      both x (input dtype) and its rounded squares (f32).
//   2. Output: one thread per (row, channel), consecutive threads on
//      consecutive channels, so shared-memory reads do not conflict and
//      stores coalesce.  The (row, channel) index advances by a fixed
//      step, with no division in the loop.
// The wrapper (veles_tpu_torch/ops/lrn_cuda.py) allocates y, checks
// shapes and dtypes, and raises on a nonzero return.

#include "lrn_common.cuh"

namespace {

using namespace veles_lrn;

// VEC: elements per 16-byte load (16 / sizeof(T)), or 1 where a row is
// not a multiple of 16 bytes or a pointer is not 16-byte aligned
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
lrn_fwd_kernel(const T* __restrict__ x, T* __restrict__ y, long long rows,
               int c, int rows_per_block, int lo, int hi, float k,
               float alpha, float beta) {
  extern __shared__ float4 smem[];
  const long long row0 = static_cast<long long>(blockIdx.x) * rows_per_block;
  const long long left = rows - row0;
  const int nr = left < rows_per_block ? static_cast<int>(left)
                                       : rows_per_block;
  const long long base = row0 * c;
  const int count = nr * c;
  // squares first (f32, 16-byte aligned), then x; both tile-sized
  float* sq = reinterpret_cast<float*>(smem);
  T* xs = reinterpret_cast<T*>(sq + static_cast<size_t>(rows_per_block) * c);

  if constexpr (VEC > 1) {
    const uint4* src = reinterpret_cast<const uint4*>(x + base);
    uint4* xdst = reinterpret_cast<uint4*>(xs);
    float4* sdst = reinterpret_cast<float4*>(sq);
    const int nvec = count / VEC;
#pragma unroll 4
    for (int v = threadIdx.x; v < nvec; v += blockDim.x) {
      const uint4 u = src[v];
      xdst[v] = u;
      const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int q = 0; q < VEC; q += 4) {
        sdst[v * (VEC / 4) + q / 4] =
            make_float4(square(e[q]), square(e[q + 1]), square(e[q + 2]),
                        square(e[q + 3]));
      }
    }
  } else {
#pragma unroll 4
    for (int i = threadIdx.x; i < count; i += blockDim.x) {
      const T v = x[base + i];
      xs[i] = v;
      sq[i] = square(v);
    }
  }
  __syncthreads();

  const int step_r = blockDim.x / c;
  const int step_c = blockDim.x - step_r * c;
  int r = threadIdx.x / c;
  int ch = threadIdx.x - r * c;
  for (int i = threadIdx.x; i < count; i += blockDim.x) {
    const float* row = sq + r * c;
    const int j0 = max(ch - lo, 0);
    const int j1 = min(ch + hi, c - 1);
    float s = 0.f;
    for (int j = j0; j <= j1; ++j) s += row[j];
    const float den = k + alpha * s;
    float d;
    if (beta == 0.75f) {
      const float rs = rsqrtf(den);
      d = rs * sqrtf(rs);
    } else {
      d = powf(den, -beta);
    }
    y[base + i] = from_f32<T>(to_f32(xs[i]) * d);
    ch += step_c;
    r += step_r;
    if (ch >= c) {
      ch -= c;
      ++r;
    }
  }
}

template <typename T, int VEC>
int launch(const void* x, void* y, long long rows, int c, int n, float k,
           float alpha, float beta, cudaStream_t stream) {
  const int rpb = tile_rows(rows, c);
  const size_t smem = static_cast<size_t>(rpb) * c *
                      (sizeof(float) + sizeof(T));
  if (smem > 48 * 1024) {
    const cudaError_t e = allow_large_smem<lrn_fwd_kernel<T, VEC>>();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const long long blocks = (rows + rpb - 1) / rpb;
  const int lo = n / 2;
  const int hi = n - 1 - lo;
  lrn_fwd_kernel<T, VEC><<<static_cast<unsigned>(blocks), kThreads, smem,
                           stream>>>(static_cast<const T*>(x),
                                     static_cast<T*>(y), rows, c,
                                     rpb, lo, hi, k, alpha, beta);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* x, void* y, long long rows, int c, int n, float k,
             float alpha, float beta, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const bool aligned =
      c % kVec == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  return aligned
             ? launch<T, kVec>(x, y, rows, c, n, k, alpha, beta, stream)
             : launch<T, 1>(x, y, rows, c, n, k, alpha, beta, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 = launched).
extern "C" int veles_lrn_fwd(const void* x, void* y, long long rows, int c,
                             int n, float k, float alpha, float beta,
                             int dtype, void* stream) {
  if (rows <= 0 || c <= 0 || n <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return dispatch<float>(x, y, rows, c, n, k, alpha, beta, s);
    case 1:
      return dispatch<__nv_bfloat16>(x, y, rows, c, n, k, alpha, beta, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
