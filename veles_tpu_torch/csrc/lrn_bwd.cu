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
// against (veles_tpu_torch/ops/lrn_cuda.py:lrn_bwd_plain), and both sums
// add their taps in ascending channel order.
//
// Bound: memory.  The op reads x and e once and writes the result once
// (3 * numel * itemsize bytes) and does about 3n + 11 flops per element.
// AlexNet's first norm at batch 128, (128*55*55, 96) in bf16, moves 223 MB:
// 66.6 us at 3.35 TB/s.  At about 45 instructions an element, the
// instruction rate of 132 SMs comes close to that, so the design also
// counts them.
//
// Design, vector path (C a multiple of VEC = 16 / sizeof(T), x, e and out
// 16-byte aligned, n <= 5; every AlexNet layer): one pass, no shared
// memory and no barrier.  Each lane owns one 16-byte vector of VEC
// consecutive channels (8 bf16 or 4 f32) of x and of e, loaded and stored
// with 16-byte accesses.  It squares its own x once and takes the
// squares' halo (2 each side) from the neighbouring lanes by warp
// shuffles; forms s, d, d1, e*d and the rounded t for its own channels;
// then takes t's halo by a second round of shuffles and sums t over the
// adjoint window.  A halo from another row is zeroed.  A warp loads 32
// consecutive vectors and stores the middle 30: lane 0's last n-1-n/2 t
// values need squares only from lanes 0 and 1, and lane 31's first n/2
// only from lanes 30 and 31 (n - 1 <= VEC, which n <= 5 keeps in f32), so
// the edge lanes feed both halos and no row ever needs a value from
// another warp, whatever C is.  A grid of at most as many blocks as the
// card holds at once walks the vectors in a grid-stride loop with two
// tiles' loads in flight per warp.  The windows' bounds are arguments:
// each sum unrolls over the 5 offsets around a channel, each predicated on
// its window, so no loop bound depends on the data.  At n = 5 that is one
// square, one rsqrt chain and two 5-tap sums an element, and 4 shuffles a
// vector for each halo.
// Row path (any other config): a row is held by a warp or more threads
// (row_width) and a block holds 256 / width rows, in a grid-stride loop;
// each row's f32 squares go to shared memory, a barrier, its t and e*d
// to shared memory (12 bytes a channel in all), a barrier, and the
// result.
// The wrapper (veles_tpu_torch/ops/lrn_cuda.py) allocates the result,
// checks shapes and dtypes, passes the SM count, and raises on a nonzero
// return.

#include "lrn_common.cuh"

namespace {

using namespace veles_lrn;

// d = den^-beta and d1 = den^-(beta+1): the rsqrt chain for beta = 3/4,
// powf for any other beta
__device__ __forceinline__ void powers34(float den, float& d, float& d1) {
  const float rs = rsqrtf(den);
  d = __fmul_rn(rs, sqrtf(rs));
  d1 = __fmul_rn(__fmul_rn(d, rs), rs);
}
__device__ __forceinline__ void powers_any(float den, float beta, float& d,
                                           float& d1) {
  d = powf(den, -beta);
  d1 = powf(den, -beta - 1.f);
}
__device__ __forceinline__ void powers(float den, float beta, float& d,
                                       float& d1) {
  if (beta == 0.75f)
    powers34(den, d, d1);
  else
    powers_any(den, beta, d, d1);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
lrn_bwd_vec(const T* __restrict__ x, const T* __restrict__ e,
            T* __restrict__ out, long long nvec, int vpr, int lo, int hi,
            float k, float alpha, float beta, float coef) {
  constexpr int VEC = kVec<T>;
  VecSlots at(vpr);
  while (at.live(nvec)) {
    uint4 xu[kTilesInFlight], eu[kTilesInFlight];
#pragma unroll
    for (int u = 0; u < kTilesInFlight; ++u) {
      const bool in = at.v[u] >= 0 && at.v[u] < nvec;
      xu[u] = load_vec(x, at.v[u], in);
      eu[u] = load_vec(e, at.v[u], in);
    }
#pragma unroll
    for (int u = 0; u < kTilesInFlight; ++u) {
      float xf[VEC], ef[VEC], sq[VEC];
      unpack(xu[u], xf);
      unpack(eu[u], ef);
#pragma unroll
      for (int i = 0; i < VEC; ++i) sq[i] = __fmul_rn(xf[i], xf[i]);
      round_to(sq);
      const bool first = at.col[u] == 0;
      const bool last = at.col[u] == vpr - 1;
      const Window<VEC> sqw(sq, first, last);
      float d[VEC], d1[VEC];  // den, then its two powers
#pragma unroll
      for (int i = 0; i < VEC; ++i)  // the forward window [i - lo, i + hi]
        d[i] = __fadd_rn(k, __fmul_rn(alpha, sqw.sum(i, lo, hi)));
      // one branch on beta for the whole vector, not one per element:
      // the VEC power chains then interleave
      if (beta == 0.75f) {
#pragma unroll
        for (int i = 0; i < VEC; ++i) powers34(d[i], d[i], d1[i]);
      } else {
#pragma unroll
        for (int i = 0; i < VEC; ++i) powers_any(d[i], beta, d[i], d1[i]);
      }
      float ed[VEC], t[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        ed[i] = __fmul_rn(ef[i], d[i]);
        t[i] = __fmul_rn(__fmul_rn(ef[i], xf[i]), d1[i]);
      }
      round_to(t);
      const Window<VEC> tw(t, first, last);
      float o[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i)  // the adjoint window [i - hi, i + lo]
        o[i] = __fsub_rn(ed[i],
                         __fmul_rn(__fmul_rn(coef, xf[i]), tw.sum(i, hi, lo)));
      if (out_lane() && at.v[u] < nvec)
        reinterpret_cast<uint4*>(out)[at.v[u]] = pack(o);
    }
    at.advance(vpr);
  }
}

// width threads a row, blockDim.x / width rows a block (row_width)
template <typename T>
__global__ void __launch_bounds__(kThreads)
lrn_bwd_rows(const T* __restrict__ x, const T* __restrict__ e,
             T* __restrict__ out, long long rows, int c, int width, int lo,
             int hi, float k, float alpha, float beta, float coef) {
  extern __shared__ float smem[];
  const int per_block = blockDim.x / width;
  const int slot = threadIdx.x / width;
  const int t0 = threadIdx.x % width;
  float* sq = smem + 3 * slot * c;  // this row's rounded squares,
  float* trow = sq + c;             // its rounded t
  float* edrow = trow + c;          // and its e * d
  for (long long r0 = static_cast<long long>(blockIdx.x) * per_block;
       r0 < rows; r0 += static_cast<long long>(gridDim.x) * per_block) {
    const long long r = r0 + slot;
    const bool live = r < rows;
    const T* xr = x + r * c;
    const T* er = e + r * c;
    if (live)
      for (int i = t0; i < c; i += width) sq[i] = square(xr[i]);
    __syncthreads();
    if (live)
      for (int i = t0; i < c; i += width) {
        float s = 0.f;
        for (int j = max(i - lo, 0); j <= min(i + hi, c - 1); ++j)
          s = __fadd_rn(s, sq[j]);
        float d, d1;
        powers(__fadd_rn(k, __fmul_rn(alpha, s)), beta, d, d1);
        const float ef = to_f32(er[i]);
        edrow[i] = __fmul_rn(ef, d);
        trow[i] = to_f32(
            from_f32<T>(__fmul_rn(__fmul_rn(ef, to_f32(xr[i])), d1)));
      }
    __syncthreads();
    if (live)
      for (int i = t0; i < c; i += width) {
        float wt = 0.f;
        for (int j = max(i - hi, 0); j <= min(i + lo, c - 1); ++j)
          wt = __fadd_rn(wt, trow[j]);
        out[r * c + i] = from_f32<T>(__fsub_rn(
            edrow[i], __fmul_rn(__fmul_rn(coef, to_f32(xr[i])), wt)));
      }
    __syncthreads();
  }
}

template <typename T>
int launch_vec(const void* x, const void* e, void* out, long long rows,
               int c, int lo, int hi, float k, float alpha, float beta,
               float coef, int sms, cudaStream_t stream) {
  const int vpr = c / kVec<T>;
  const long long nvec = rows * vpr;
  const long long blocks = vec_grid<lrn_bwd_vec<T>>(nvec, sms);
  lrn_bwd_vec<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(e),
      static_cast<T*>(out), nvec, vpr, lo, hi, k, alpha, beta, coef);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_rows(const void* x, const void* e, void* out, long long rows,
                int c, int lo, int hi, float k, float alpha, float beta,
                float coef, int sms, cudaStream_t stream) {
  const int width = row_width(c);
  const int per_block = kThreads / width;
  const size_t smem = 3 * static_cast<size_t>(per_block) * c * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = allow_large_smem<lrn_bwd_rows<T>>();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long groups = (rows + per_block - 1) / per_block;
  lrn_bwd_rows<T><<<static_cast<unsigned>(row_grid(groups, sms)), kThreads,
                    smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(e),
      static_cast<T*>(out), rows, c, width, lo, hi, k, alpha, beta, coef);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* x, const void* e, void* out, long long rows, int c,
             int n, float k, float alpha, float beta, float coef, int sms,
             cudaStream_t stream) {
  // taps beyond C - 1 on either side are clipped anyway
  const int lo = std::min(n / 2, c - 1);
  const int hi = std::min(n - 1 - n / 2, c - 1);
  const bool vec = c % kVec<T> == 0 && lo <= kHalo &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(e) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  return vec ? launch_vec<T>(x, e, out, rows, c, lo, hi, k, alpha, beta,
                             coef, sms, stream)
             : launch_rows<T>(x, e, out, rows, c, lo, hi, k, alpha, beta,
                              coef, sms, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, e and out share it).  coef is
// 2 * alpha * beta, rounded once by the caller.  sms: the device's SM
// count.  Returns a cudaError_t (0 = launched).
extern "C" int veles_lrn_bwd(const void* x, const void* e, void* out,
                             long long rows, int c, int n, float k,
                             float alpha, float beta, float coef, int dtype,
                             int sms, void* stream) {
  if (rows <= 0 || c <= 0 || n <= 0 || sms <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return dispatch<float>(x, e, out, rows, c, n, k, alpha, beta, coef,
                             sms, s);
    case 1:
      return dispatch<__nv_bfloat16>(x, e, out, rows, c, n, k, alpha, beta,
                                     coef, sms, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
