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

// x mod n in [0, n), for any x
__device__ __forceinline__ int mod(int x, int n) {
  const int r = x % n;
  return r < 0 ? r + n : r;
}

// The tile of one block of a k-marching tiled kernel (rhs3d, tadv,
// prsgrd, uvmix) over an (Mj, Li) grid: at most TJ x TI points, blockIdx.y
// the row tile and blockIdx.x the lane tile.  The lane tiling is shifted
// by half a tile, so that the periodic seam (lanes Li-2 .. 1) lies inside
// tile 0; the wrappers widen a tile of fewer than five lanes for that
// (ops/_lib.py seam_tiles).
struct Tile {
  int j0, i0;   // the tile's first row and lane (i0 < 0 in tile 0)
  int tj, ti;   // its rows and lanes (fewer in the last tiles)

  __device__ Tile(int TJ, int TI, int Mj, int Li)
      : j0(static_cast<int>(blockIdx.y) * TJ),
        i0(static_cast<int>(blockIdx.x) * TI - TI / 2),
        tj(min(TJ, Mj - j0)),
        ti(min(TI, Li - static_cast<int>(blockIdx.x) * TI)) {}

  // the global row and lane of each position of a window that starts
  // `lo` rows and lanes before the tile (WJ rows, WI lanes), wrapping as
  // jnp.roll wraps; the block synchronises before reading them
  __device__ void tables(int lo, int WJ, int WI, int Mj, int Li, int* rowg,
                         int* colg) const {
    for (int n = threadIdx.x; n < WJ; n += blockDim.x)
      rowg[n] = mod(j0 - lo + n, Mj);
    for (int n = threadIdx.x; n < WI; n += blockDim.x)
      colg[n] = mod(i0 - lo + n, Li);
  }
};

// a kernel's dynamic shared memory raised to `smem` bytes; a refusal's
// error is cleared, so that it is not the next launch's
template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) cudaGetLastError();
  return err;
}

inline int blocks_for(long long n) {
  return static_cast<int>((n + kThreads - 1) / kThreads);
}

template <typename T>
__device__ __forceinline__ T pos(T x) { return x > T(0) ? x : T(0); }

template <typename T>
__device__ __forceinline__ T neg(T x) { return x < T(0) ? x : T(0); }

// A product rounded on its own: nvcc never contracts these intrinsics
// into an FMA, so a product that feeds an add or subtract rounds as in
// the plain PyTorch version, where every operation is its own kernel.
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}

// st.periodic_x as an index map: on an EW-periodic grid lane 0 holds
// lane Li-2 and lane Li-1 holds lane 1; i arrives in range
__device__ __forceinline__ int ring_x(int i, int Li, bool ewp) {
  if (!ewp) return i;
  return i == 0 ? Li - 2 : (i == Li - 1 ? 1 : i);
}

// One element from device to shared memory without passing through
// registers (cp.async); copy_commit() closes this thread's copies issued
// since the last commit into a group, copy_wait<n>() waits until at most n
// of its groups are in flight.  Elsewhere than on the card, a plain copy.
__device__ __forceinline__ void copy_async(float* dst, const float* src) {
#if defined(__CUDA_ARCH__)
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
#else
  *dst = *src;
#endif
}
__device__ __forceinline__ void copy_async(double* dst, const double* src) {
#if defined(__CUDA_ARCH__)
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
               "l"(src)
               : "memory");
#else
  *dst = *src;
#endif
}
__device__ __forceinline__ void copy_commit() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
}
template <int n>
__device__ __forceinline__ void copy_wait() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
#endif
}

}  // namespace roms
