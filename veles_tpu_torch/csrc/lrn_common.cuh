// Helpers shared by the LRN kernels (lrn_fwd.cu, lrn_bwd.cu): dtype
// conversions, the square as the TPU kernels form it, the launch shape of
// a tile of whole rows, and the opt-in to more than 48 KiB of dynamic
// shared memory.
#pragma once

#include <atomic>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace veles_lrn {

constexpr int kThreads = 256;
// tile elements staged per block; a row longer than that gets a block of
// its own
constexpr int kTileElems = 8192;
// Hopper's largest dynamic shared memory per block (opt-in)
constexpr int kMaxSmemBytes = 232448;

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

// Rows per block: whole rows, about kTileElems elements, never more rows
// than there are.
inline int tile_rows(long long rows, int c) {
  int rpb = kTileElems / c;
  if (rpb < 1) rpb = 1;
  if (rpb > rows) rpb = static_cast<int>(rows);
  return rpb;
}

// Tiles over 48 KiB need an opt-in to more dynamic shared memory.  It is
// made once per kernel instantiation and device, to the most a block may
// take (227 KiB, which bounds C in the Python wrapper), not on every
// launch.
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

}  // namespace veles_lrn
