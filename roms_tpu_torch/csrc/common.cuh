// Shared helpers for the roms_tpu_torch CUDA kernels.
//
// Layout of every field: (..., N, Mj, Li) row-major with i contiguous,
// one float type T (float or double) per launch.  Shifts follow
// jnp.roll / torch.roll: an index that leaves [0, n) wraps around.
#pragma once

#include <cuda_runtime.h>

namespace roms {

constexpr int kThreads = 256;

// jnp.roll wrap of i + s for |s| < n
__device__ __forceinline__ int wrap(int i, int n) {
  return i < 0 ? i + n : (i >= n ? i - n : i);
}

inline int blocks_for(long long n) {
  return static_cast<int>((n + kThreads - 1) / kThreads);
}

template <typename T>
__device__ __forceinline__ T pos(T x) { return x > T(0) ? x : T(0); }

template <typename T>
__device__ __forceinline__ T neg(T x) { return x < T(0) ? x : T(0); }

}  // namespace roms
