// Helpers shared by the LRN kernels (lrn_fwd.cu, lrn_bwd.cu): dtype
// conversions and rounding, the square as the TPU kernels form it, 16-byte
// vectors of channels, the lane layout, halo and grid of the vector path,
// and the row groups and shared-memory opt-in of the row path.
#pragma once

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace veles_lrn {

constexpr int kThreads = 256;
constexpr unsigned kFullMask = 0xffffffffu;
// Vector path: a warp loads 32 consecutive 16-byte vectors and stores the
// middle 30.  Lanes 0 and 31 only supply the window's halo to lanes 1 and
// 30; the next warp's tile starts where this one's outputs end.
constexpr int kOutLanes = 30;
// Vector path: tiles each warp has in flight (loads started before any
// compute)
constexpr int kTilesInFlight = 2;
// Vector path: the window's halo each side, so it takes n <= 5 (AlexNet's
// n = 5 has 2 taps each side); a wider window takes the row path.  A halo
// of 4 (bf16's widest) ran n = 5 15-23% slower in bf16 on an H100 80GB
// HBM3 at 700 W, so wider windows get no instantiation of their own.
constexpr int kHalo = 2;
// Hopper's largest dynamic shared memory per block (opt-in)
constexpr int kMaxSmemBytes = 232448;

template <typename T>
constexpr int kVec = 16 / static_cast<int>(sizeof(T));

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// the square as the TPU kernels form it: in the input dtype
template <typename T>
__device__ __forceinline__ float square(T v) {
  const float f = to_f32(v);
  return to_f32(from_f32<T>(f * f));
}

// 16 bytes as kVec<T> f32 values, element 0 first
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[8]) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    f[2 * q] = __uint_as_float(w[q] << 16);
    f[2 * q + 1] = __uint_as_float(w[q] & 0xffff0000u);
  }
}

// kVec<T> f32 values rounded to T (to nearest even) and packed as 16 bytes
__device__ __forceinline__ uint4 pack(const float (&f)[4]) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                    __float_as_uint(f[2]), __float_as_uint(f[3]));
}
__device__ __forceinline__ unsigned pack2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  unsigned w;
  memcpy(&w, &h, sizeof(w));
  return w;
}
__device__ __forceinline__ uint4 pack(const float (&f)[8]) {
  return make_uint4(pack2(f[0], f[1]), pack2(f[2], f[3]), pack2(f[4], f[5]),
                    pack2(f[6], f[7]));
}

// f32 values rounded to T in place (to nearest even), two at a time
__device__ __forceinline__ void round_to(float (&)[4]) {}
__device__ __forceinline__ void round_to(float (&f)[8]) {
  float g[8];
  unpack(pack(f), g);
#pragma unroll
  for (int i = 0; i < 8; ++i) f[i] = g[i];
}

// One lane's vector v of the flat (rows * C / kVec) vector index, and its
// column (vector within its row), for each of the kTilesInFlight tiles of
// a warp's current step; advance() moves all of them one grid step on.
struct VecSlots {
  long long v[kTilesInFlight];
  int col[kTilesInFlight];
  long long step;  // vectors per grid step
  int col_step;    // step % vpr

  __device__ __forceinline__ VecSlots(int vpr) {
    const int lane = threadIdx.x & 31;
    const long long warp =
        (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
    const long long warps =
        (static_cast<long long>(gridDim.x) * blockDim.x) >> 5;
    step = warps * kTilesInFlight * kOutLanes;
    col_step = static_cast<int>(step % vpr);
#pragma unroll
    for (int u = 0; u < kTilesInFlight; ++u) {
      v[u] = (warp + u * warps) * kOutLanes - 1 + lane;
      col[u] = static_cast<int>(((v[u] % vpr) + vpr) % vpr);
    }
  }

  // the warp's first output vector of tile 0 exists (uniform per warp)
  __device__ __forceinline__ bool live(long long nvec) const {
    return v[0] - (threadIdx.x & 31) + 1 < nvec;
  }

  __device__ __forceinline__ void advance(int vpr) {
#pragma unroll
    for (int u = 0; u < kTilesInFlight; ++u) {
      v[u] += step;
      col[u] += col_step;
      if (col[u] >= vpr) col[u] -= vpr;
    }
  }
};

// A lane's VEC per-channel values v with a halo of kHalo values on each
// side: the left neighbour lane's last kHalo and the right one's first
// kHalo, by warp shuffle (every lane of the warp must construct it),
// zeroed where the neighbour's vector lies in another row.  tap(j) is
// channel j of the vector, j in [-kHalo, VEC + kHalo), taken at
// compile-time j.
template <int VEC>
struct Window {
  static_assert(2 * kHalo <= VEC, "halo wider than one neighbouring vector");
  const float (&v)[VEC];
  float left[kHalo], right[kHalo];

  __device__ __forceinline__ Window(const float (&vals)[VEC], bool first,
                                    bool last)
      : v(vals) {
#pragma unroll
    for (int q = 0; q < kHalo; ++q) {
      const float l = __shfl_up_sync(kFullMask, v[VEC - kHalo + q], 1);
      const float r = __shfl_down_sync(kFullMask, v[q], 1);
      left[q] = first ? 0.f : l;
      right[q] = last ? 0.f : r;
    }
  }

  __device__ __forceinline__ float tap(int j) const {
    return j < 0 ? left[j + kHalo] : (j >= VEC ? right[j - VEC] : v[j]);
  }

  // sum of the taps [i - a, i + b] in ascending order, a and b at most
  // kHalo and the same for every element of the kernel: the 2 kHalo + 1
  // offsets are unrolled and each is predicated on the window, so no loop
  // bound depends on the data
  __device__ __forceinline__ float sum(int i, int a, int b) const {
    float s = 0.f;
#pragma unroll
    for (int d = -kHalo; d <= kHalo; ++d)
      if (d >= -a && d <= b) s = __fadd_rn(s, tap(i + d));
    return s;
  }
};

// lane in 1..30: its vector is an output of this warp's tile
__device__ __forceinline__ bool out_lane() {
  const int lane = threadIdx.x & 31;
  return lane >= 1 && lane <= kOutLanes;
}

__device__ __forceinline__ uint4 load_vec(const void* p, long long v,
                                          bool in) {
  return in ? __ldg(reinterpret_cast<const uint4*>(p) + v)
            : make_uint4(0u, 0u, 0u, 0u);
}

// Blocks for the vector path: enough warps for every tile, at most what
// the card holds at once (blocks per SM from the occupancy calculator,
// asked once per kernel instantiation).
template <auto Kernel>
long long vec_grid(long long nvec, int sms) {
  static const int per_sm = [] {
    int n = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, Kernel, kThreads,
                                                      0) != cudaSuccess ||
        n < 1)
      n = 1;
    return n;
  }();
  const long long tiles = (nvec + kOutLanes - 1) / kOutLanes;
  const long long need = (tiles + kThreads / 32 - 1) / (kThreads / 32);
  const long long most = static_cast<long long>(sms) * per_sm;
  return need < most ? need : most;
}

// Row-path blocks over 48 KiB need an opt-in to more dynamic shared
// memory.  It is made once per kernel instantiation and device, to the
// most a block may take (227 KiB, which bounds C in the Python wrapper),
// not on every launch.
template <auto Kernel>
cudaError_t allow_large_smem() {
  constexpr int kMaxDevices = 64;
  // per device: 0 = not yet set, else the setter's cudaError_t + 1 (two
  // threads racing here both set the same value, which is harmless)
  static std::atomic<int> state[kMaxDevices];
  int dev = 0;
  const cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  const int seen = state[dev].load(std::memory_order_acquire);
  if (seen != 0) return static_cast<cudaError_t>(seen - 1);
  const cudaError_t set = cudaFuncSetAttribute(
      Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmemBytes);
  state[dev].store(static_cast<int>(set) + 1, std::memory_order_release);
  return set;
}

// Row path: a row is held by `width` threads (a power of two from a warp
// to the block) and a block holds kThreads / width rows, so a narrow row
// idles no thread and a block's barriers serve all of its rows.  width is
// the least that gives each thread at most 8 channels, so below C = 2048 a
// block's rows take at most 2048 channels of shared memory.
inline int row_width(int c) {
  int w = 32;
  while (w < kThreads && 8 * w < c) w *= 2;
  return w;
}

// Row path: blocks over the groups of rows, in a grid-stride loop; at most
// 8 blocks per SM are asked for, the rest of the groups wait for a block.
inline long long row_grid(long long groups, int sms) {
  const long long most = static_cast<long long>(sms) * 8;
  return groups < most ? groups : most;
}

}  // namespace veles_lrn
