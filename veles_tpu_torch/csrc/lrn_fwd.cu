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
// batch 128, (128*55*55, 96) in bf16, moves 149 MB: 44.4 us at 3.35 TB/s.
//
// Design, vector path (C a multiple of VEC = 16 / sizeof(T), x and y
// 16-byte aligned, n <= 5; every AlexNet layer): no shared memory and no
// barrier.  Each lane owns one 16-byte vector of VEC consecutive channels
// (8 bf16 or 4 f32), loaded and stored with one 16-byte access.  It
// squares its own channels once; the window's halo (2 each side) comes
// from the neighbouring lanes by warp shuffles, zeroed where the
// neighbour lies in another row.  A warp loads 32 consecutive vectors and
// stores the middle 30, so lanes 0 and 31 only feed the halo and no row
// ever needs a value from another warp, whatever C is (C = 96 in bf16 is
// 12 vectors a row, rows straddle warps freely).  A grid of at most as
// many blocks as the card holds at once walks the vectors in a
// grid-stride loop with two tiles' loads in flight per warp, so occupancy
// is set by registers and the loads of one step overlap the arithmetic of
// the other.  The window's bounds are arguments: each sum unrolls over
// the 5 offsets around a channel, each predicated on the window, so no
// loop bound depends on the data.
// Row path (any other config): a row is held by a warp or more threads
// (row_width: at most 8 channels a thread below C = 2048) and a block
// holds 256 / width rows, in a grid-stride loop; each row's f32 squares
// go to shared memory (4 bytes a channel), a barrier, then each thread
// sums its outputs' clipped taps.
// The wrapper (veles_tpu_torch/ops/lrn_cuda.py) allocates y, checks
// shapes and dtypes, passes the SM count, and raises on a nonzero return.

#include "lrn_common.cuh"

namespace {

using namespace veles_lrn;

__device__ __forceinline__ float power(float den, float beta) {
  if (beta == 0.75f) {
    const float rs = rsqrtf(den);
    return rs * sqrtf(rs);
  }
  return powf(den, -beta);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
lrn_fwd_vec(const T* __restrict__ x, T* __restrict__ y, long long nvec,
            int vpr, int lo, int hi, float k, float alpha, float beta) {
  constexpr int VEC = kVec<T>;
  VecSlots at(vpr);
  while (at.live(nvec)) {
    uint4 xu[kTilesInFlight];
#pragma unroll
    for (int u = 0; u < kTilesInFlight; ++u)
      xu[u] = load_vec(x, at.v[u], at.v[u] >= 0 && at.v[u] < nvec);
#pragma unroll
    for (int u = 0; u < kTilesInFlight; ++u) {
      float xf[VEC], sq[VEC];
      unpack(xu[u], xf);
#pragma unroll
      for (int i = 0; i < VEC; ++i) sq[i] = xf[i] * xf[i];
      round_to(sq);
      const Window<VEC> sqw(sq, at.col[u] == 0, at.col[u] == vpr - 1);
      float yf[VEC];  // den, then y
#pragma unroll
      for (int i = 0; i < VEC; ++i) yf[i] = k + alpha * sqw.sum(i, lo, hi);
      // one branch on beta for the whole vector, not one per element:
      // the VEC power chains then interleave
      if (beta == 0.75f) {
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          const float rs = rsqrtf(yf[i]);
          yf[i] = xf[i] * (rs * sqrtf(rs));
        }
      } else {
#pragma unroll
        for (int i = 0; i < VEC; ++i) yf[i] = xf[i] * powf(yf[i], -beta);
      }
      if (out_lane() && at.v[u] < nvec)
        reinterpret_cast<uint4*>(y)[at.v[u]] = pack(yf);
    }
    at.advance(vpr);
  }
}

// width threads a row, blockDim.x / width rows a block (row_width)
template <typename T>
__global__ void __launch_bounds__(kThreads)
lrn_fwd_rows(const T* __restrict__ x, T* __restrict__ y, long long rows,
             int c, int width, int lo, int hi, float k, float alpha,
             float beta) {
  extern __shared__ float smem[];
  const int per_block = blockDim.x / width;
  const int slot = threadIdx.x / width;
  const int t0 = threadIdx.x % width;
  float* sq = smem + slot * c;  // this row's f32 squares
  for (long long r0 = static_cast<long long>(blockIdx.x) * per_block;
       r0 < rows; r0 += static_cast<long long>(gridDim.x) * per_block) {
    const long long r = r0 + slot;
    const bool live = r < rows;
    const T* xr = x + r * c;
    T* yr = y + r * c;
    if (live)
      for (int i = t0; i < c; i += width) sq[i] = square(xr[i]);
    __syncthreads();
    if (live)
      for (int i = t0; i < c; i += width) {
        const int j0 = max(i - lo, 0);
        const int j1 = min(i + hi, c - 1);
        float s = 0.f;
        for (int j = j0; j <= j1; ++j) s += sq[j];
        yr[i] = from_f32<T>(to_f32(xr[i]) * power(k + alpha * s, beta));
      }
    __syncthreads();
  }
}

template <typename T>
int launch_vec(const void* x, void* y, long long rows, int c, int lo, int hi,
               float k, float alpha, float beta, int sms,
               cudaStream_t stream) {
  const int vpr = c / kVec<T>;
  const long long nvec = rows * vpr;
  const long long blocks = vec_grid<lrn_fwd_vec<T>>(nvec, sms);
  lrn_fwd_vec<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), nvec, vpr, lo, hi, k,
      alpha, beta);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_rows(const void* x, void* y, long long rows, int c, int lo,
                int hi, float k, float alpha, float beta, int sms,
                cudaStream_t stream) {
  const int width = row_width(c);
  const int per_block = kThreads / width;
  const size_t smem = static_cast<size_t>(per_block) * c * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = allow_large_smem<lrn_fwd_rows<T>>();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const long long groups = (rows + per_block - 1) / per_block;
  lrn_fwd_rows<T><<<static_cast<unsigned>(row_grid(groups, sms)), kThreads,
                    smem, stream>>>(static_cast<const T*>(x),
                                    static_cast<T*>(y), rows, c, width, lo,
                                    hi, k, alpha, beta);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* x, void* y, long long rows, int c, int n, float k,
             float alpha, float beta, int sms, cudaStream_t stream) {
  // taps beyond C - 1 on either side are clipped anyway
  const int lo = std::min(n / 2, c - 1);
  const int hi = std::min(n - 1 - n / 2, c - 1);
  const bool vec = c % kVec<T> == 0 && lo <= kHalo &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(y) % 16 == 0;
  return vec ? launch_vec<T>(x, y, rows, c, lo, hi, k, alpha, beta, sms,
                             stream)
             : launch_rows<T>(x, y, rows, c, lo, hi, k, alpha, beta, sms,
                              stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  sms: the device's SM count.  Returns
// a cudaError_t (0 = launched).
extern "C" int veles_lrn_fwd(const void* x, void* y, long long rows, int c,
                             int n, float k, float alpha, float beta,
                             int dtype, int sms, void* stream) {
  if (rows <= 0 || c <= 0 || n <= 0 || sms <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return dispatch<float>(x, y, rows, c, n, k, alpha, beta, sms, s);
    case 1:
      return dispatch<__nv_bfloat16>(x, y, rows, c, n, k, alpha, beta, sms,
                                     s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
