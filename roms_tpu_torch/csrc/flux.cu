// Kernels 7 and 8: horizontal mass fluxes fused with the vertical mass flux
// (set_massflux.F:140-163 + omega.F:200-345), two entry points:
//   flux_omega: Huon = Hz_u*u*on_u, Hvom = Hz_v*v*om_v with the EW ring
//               refresh, then W from them;
//   omega:      W alone from given Huon/Hvom (the corrector site).
// W[k] = -sum_{m<k} div[m] bottom-up, the drift correction that makes
// W[N] vanish, W[N] = 0, then bc_rho (ring rows copy their inner
// neighbour, lanes 0 and Li-1 the periodic ones).
//
// Replaces roms_tpu/ops/pallas_flux.py:152 flux_omega_pallas (pallas_call
// l.170) and :185 omega_pallas (l.198); plain versions ops/flux.py.  The
// class is the kernel's: EW-periodic, not NS-periodic, closed or gradient
// N/S zeta walls.  Every point carries the plain path's value: Huon/Hvom
// ring rows hold set_massflux's jnp.roll wrap (the Pallas kernel leaves
// other dead values there), so kernel and plain version compare whole.
//
// Bound on the H100: bytes.  flux_omega reads u, v, Hz (N levels), z_w
// (N+1), on_u, om_v and writes Huon, Hvom (N) and W (N+1); omega reads
// Huon, Hvom, z_w and writes W.  ~15 flops a level.
//
// The running sum follows torch.cumsum over dim 0 on the card: one
// accumulator a column, started at 0 and added to level by level in k
// order (ATen/native/cuda/ScanUtils.cuh tensor_kernel_scan_outer_dim,
// confirmed in torch 2.13's headers).  Products that feed an add or
// subtract are mul_rn, so each value rounds as in the plain version.
//
// flux_omega's design: one 256-thread block per tile of TJ x TI columns
// (ops/flux.py launch_shape; 7 x 31) on roms::Tile's half-shifted tiling,
// so that the periodic seam lies inside tile 0, marching k from 0 to N-1.
// A thread owns one position (yy, xx) of the tile grown by one row north
// and one lane east, (TJ+1) x (TI+1): it stages that position's u, v and
// Hz of level k+2 by cp.async into the third of three buffers (a few
// threads also stage the window's south row and west lane of Hz), and
// forms the level's Huon at (yy, xx) for rows of the tile and its Hvom for
// lanes of the tile, so each flux is formed once a level.  After a
// barrier each tile point writes its Huon and Hvom, taken through the
// window's lane table (st.periodic_x: lane 0 holds lane Li-2's flux,
// lane Li-1 lane 1's; each thread keeps its own two entries of the table
// in registers), and each bc_rho source column (rows 1..Mj-2, lanes
// 1..Li-2) forms its div from the shared fluxes and adds it to its
// running sum, which it keeps, level by level, in dynamic shared memory
// laid out [k][tile point].  After the march a second pass over k reads
// only z_w and writes W: the source column's thread writes W into its
// own column and into the ring copies bc_rho makes of it (row 0 from row
// 1, row Mj-1 from Mj-2, lane 0 from Li-2, lane Li-1 from lane 1, and the
// corners), so no column is integrated twice, whatever tile its copies
// lie in.  Every input plane is read from device memory once and Huon,
// Hvom and W are each written once.  A launch whose running sums do not
// fit a block's shared memory is refused (roms::allow_smem; ops/flux.py
// raises first).
//
// omega keeps the column kernel of the port's first version: one thread
// per (j, i) column, consecutive threads on consecutive i; the column
// whose W lands at (j, i) is the bc_rho source (rm(j), ring_x(i)); the
// thread sums div over k, then walks k again in the same order to write
// W (the fluxes re-read from L1/L2).
#include "common.cuh"

namespace {

using roms::copy_async;
using roms::copy_commit;
using roms::copy_wait;
using roms::mul_rn;
using roms::wrap;

constexpr int kThreadsFlux = 256;
constexpr int kStages = 3;   // level buffers: levels k+1 and k+2 in flight

template <typename T>
struct FluxParams {
  const T *u, *v, *Hz, *on_u, *om_v, *z_w;
  T *Huon, *Hvom, *W;
  int N, Mj, Li, TJ, TI;
};

// the block's shared arrays (ops/flux.py launch_shape counts the bytes)
template <typename T>
struct FluxSmem {
  int nH, nU, nV;   // a level's staged Hz window, u and v positions
  T* raw;           // kStages buffers of (Hz, u, v)
  T *hu, *hv;       // the level's Huon and Hvom on the grown tile
  T* sums;          // the running sums [k][tile point], levels 0..N-2

  __device__ void carve(void* base, int TJ, int TI) {
    nH = (TJ + 2) * (TI + 2);
    nU = TJ * (TI + 1);
    nV = (TJ + 1) * TI;
    raw = static_cast<T*>(base);
    hu = raw + kStages * (nH + nU + nV);
    hv = hu + nU;
    sums = hv + nV;
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreadsFlux)
flux_omega_kernel(const __grid_constant__ FluxParams<T> p) {
  extern __shared__ __align__(16) unsigned char smem[];
  FluxSmem<T> s;
  s.carve(smem, p.TJ, p.TI);
  const int N = p.N, Mj = p.Mj, Li = p.Li;
  const size_t P = static_cast<size_t>(Mj) * Li;
  const roms::Tile t(p.TJ, p.TI, Mj, Li);
  const int tj = t.tj, ti = t.ti;
  // strides of the staged planes: the Hz window (tile grown by a row and a
  // lane each side), u and hu (grown a lane east), v and hv (grown a row
  // north)
  const int WI = ti + 2, UI = ti + 1, VI = ti;

  // this thread's position (yy, xx) of the tile grown a row north and a
  // lane east; rows and lanes wrap as jnp.roll wraps
  const int tx = threadIdx.x, gw = ti + 1;
  const bool act = tx < (tj + 1) * gw;
  const int yy = act ? tx / gw : 0;
  const int xx = act ? tx - yy * gw : 0;
  const bool upos = act && yy < tj;   // forms Huon at (yy, xx)
  const bool vpos = act && xx < ti;   // forms Hvom at (yy, xx)
  const bool tile = upos && vpos;
  const int gj = roms::mod(t.j0 + yy, Mj), gi = roms::mod(t.i0 + xx, Li);
  const int gofs = gj * Li + gi;
  // the Hz window's south row (lanes 1..ti) and west lane (rows 1..tj),
  // staged by the first ti + tj threads
  int rim = -1;
  if (tx < ti)
    rim = roms::mod(t.j0 - 1, Mj) * Li + roms::mod(t.i0 + tx, Li);
  else if (tx < ti + tj)
    rim = roms::mod(t.j0 + tx - ti, Mj) * Li + roms::mod(t.i0 - 1, Li);
  const int rim_at = tx < ti ? tx + 1 : (tx - ti + 1) * WI;
  const int hw = (yy + 1) * WI + xx + 1;   // this position in the window

  // the window's lane table at this thread's lane and the next: the tile
  // lane whose flux a lane holds after st.periodic_x (the seam's ring
  // lanes take lanes Li-2 and 1, which tile 0 holds)
  auto ring = [&](int x) {
    const int g = roms::mod(t.i0 + x, Li);
    const int h = roms::ring_x(g, Li, true);
    return h == g ? x : min(roms::mod(h - t.i0, Li), ti - 1);
  };
  const int lane = ring(xx), east = ring(xx + 1);
  const T on_u = upos ? p.on_u[gofs] : T(0);
  const T om_v = vpos ? p.om_v[gofs] : T(0);
  // a bc_rho source column: it integrates W for itself and its copies
  const bool owner = tile && gj >= 1 && gj <= Mj - 2 && gi >= 1 &&
                     gi <= Li - 2;
  const int pt = yy * ti + xx;   // its tile point, for the running sums
  const int S = p.TJ * p.TI;

  auto stage = [&](int kk, int b) {
    T* hz = s.raw + b * (s.nH + s.nU + s.nV);
    const size_t lev = static_cast<size_t>(kk) * P;
    if (act) copy_async(hz + hw, p.Hz + lev + gofs);
    if (rim >= 0) copy_async(hz + rim_at, p.Hz + lev + rim);
    if (upos) copy_async(hz + s.nH + yy * UI + xx, p.u + lev + gofs);
    if (vpos) copy_async(hz + s.nH + s.nU + yy * VI + xx, p.v + lev + gofs);
  };
  for (int b = 0; b < kStages - 1; ++b) {
    if (b < N) stage(b, b);
    copy_commit();
  }
  copy_wait<kStages - 2>();

  T acc = T(0);
  for (int k = 0; k < N; ++k) {
    const size_t lev = static_cast<size_t>(k) * P;
    __syncthreads();
    // level k+kStages-1 is copied into the buffer of level k-1 while
    // level k is used
    const int kn = k + kStages - 1;
    if (kn < N) stage(kn, kn % kStages);
    copy_commit();
    const T* hz = s.raw + (k % kStages) * (s.nH + s.nU + s.nV);
    const T* u = hz + s.nH;
    const T* v = u + s.nU;
    // A. this position's fluxes: Hz_u = 0.5 (Hz + Hz[i-1]), Hz_v =
    // 0.5 (Hz + Hz[j-1]), then (Hz_x * vel) * metric
    if (upos)
      s.hu[yy * UI + xx] = mul_rn(T(0.5) * (hz[hw] + hz[hw - 1]) *
                                      u[yy * UI + xx], on_u);
    if (vpos)
      s.hv[yy * VI + xx] = mul_rn(T(0.5) * (hz[hw] + hz[hw - WI]) *
                                      v[yy * VI + xx], om_v);
    __syncthreads();
    // B. the ringed fluxes of the tile points, the sources' running sums
    if (tile) {
      p.Huon[lev + gofs] = s.hu[yy * UI + lane];
      p.Hvom[lev + gofs] = s.hv[yy * VI + lane];
      if (owner) {
        const T div = (s.hu[yy * UI + east] - s.hu[yy * UI + xx]) +
                      (s.hv[(yy + 1) * VI + xx] - s.hv[yy * VI + xx]);
        acc = acc + div;
        if (k + 1 < N) s.sums[static_cast<size_t>(k) * S + pt] = acc;
      }
    }
    copy_wait<kStages - 2>();
  }
  if (!owner) return;

  // W of this source column, written into it and into its bc_rho copies
  const int jr = gj == 1 ? 0 : (gj == Mj - 2 ? Mj - 1 : -1);
  const int ir = gi == Li - 2 ? 0 : (gi == 1 ? Li - 1 : -1);
  const int cj = jr * Li, ci = ir - gi;
  auto put = [&](int k, T w) {
    T* W = p.W + static_cast<size_t>(k) * P;
    W[gofs] = w;
    if (ir >= 0) W[gofs + ci] = w;
    if (jr >= 0) {
      W[cj + gi] = w;
      if (ir >= 0) W[cj + ir] = w;
    }
  };
  const T zw0 = p.z_w[gofs];
  const T wrk = -acc / (p.z_w[N * P + gofs] - zw0);
  put(0, T(0) - mul_rn(wrk, zw0 - zw0));
#pragma unroll 4
  for (int k = 1; k < N; ++k)
    put(k, -s.sums[static_cast<size_t>(k - 1) * S + pt] -
               mul_rn(wrk, p.z_w[k * P + gofs] - zw0));
  put(N, T(0));
}

template <typename T>
struct OmegaArgs {
  const T *Huon, *Hvom, *z_w;
  T* W;   // (N+1, Mj, Li)
  int N, Mj, Li;
};

// (ip1(Huon) - Huon) + (jp1(Hvom) - Hvom) at level k
template <typename T>
__device__ T omega_div(const OmegaArgs<T>& a, size_t P, int k, int j, int i) {
  const size_t l = k * P + static_cast<size_t>(j) * a.Li;
  return (a.Huon[l + wrap(i + 1, a.Li)] - a.Huon[l + i]) +
         (a.Hvom[k * P + static_cast<size_t>(wrap(j + 1, a.Mj)) * a.Li + i] -
          a.Hvom[l + i]);
}

template <typename T>
__global__ void omega_kernel(OmegaArgs<T> a) {
  const int Li = a.Li, Mj = a.Mj, N = a.N;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= Mj * Li) return;
  const size_t P = static_cast<size_t>(Mj) * Li;
  const int i = c % Li, j = c / Li;
  // W of the bc_rho source column
  const int wj = j == 0 ? 1 : (j == Mj - 1 ? Mj - 2 : j);
  const int wi = roms::ring_x(i, Li, true);
  const size_t wc = static_cast<size_t>(wj) * Li + wi;
  T acc = T(0);
  for (int k = 0; k < N; ++k) acc = acc + omega_div(a, P, k, wj, wi);
  const T zw0 = a.z_w[wc];
  const T wrk = -acc / (a.z_w[N * P + wc] - zw0);
  a.W[c] = T(0) - mul_rn(wrk, zw0 - zw0);
  acc = T(0);
  for (int k = 0; k < N - 1; ++k) {
    acc = acc + omega_div(a, P, k, wj, wi);
    a.W[(k + 1) * P + c] = -acc - mul_rn(wrk, a.z_w[(k + 1) * P + wc] - zw0);
  }
  a.W[N * P + c] = T(0);
}

template <typename T>
int launch(int with_flux, const void* u, const void* v, const void* Hz,
           const void* on_u, const void* om_v, const void* z_w, void* Huon,
           void* Hvom, void* W, int N, int Mj, int Li, int TJ, int TI,
           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (!with_flux) {
    const OmegaArgs<T> a{static_cast<const T*>(Huon),
                         static_cast<const T*>(Hvom),
                         static_cast<const T*>(z_w), static_cast<T*>(W), N,
                         Mj, Li};
    omega_kernel<T><<<roms::blocks_for(static_cast<long long>(Mj) * Li),
                      roms::kThreads, 0, st>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  if ((TJ + 1) * (TI + 1) > kThreadsFlux)
    return static_cast<int>(cudaErrorInvalidValue);
  const FluxParams<T> p{
      static_cast<const T*>(u),    static_cast<const T*>(v),
      static_cast<const T*>(Hz),   static_cast<const T*>(on_u),
      static_cast<const T*>(om_v), static_cast<const T*>(z_w),
      static_cast<T*>(Huon),       static_cast<T*>(Hvom),
      static_cast<T*>(W),          N, Mj, Li, TJ, TI};
  const size_t nH = (TJ + 2) * (TI + 2), nU = TJ * (TI + 1),
               nV = (TJ + 1) * TI;
  const size_t smem = sizeof(T) * (kStages * (nH + nU + nV) + nU + nV +
                                   static_cast<size_t>(N - 1) * TJ * TI);
  const cudaError_t err = roms::allow_smem(flux_omega_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Li + TI - 1) / TI, (Mj + TJ - 1) / TJ);
  flux_omega_kernel<T><<<grid, kThreadsFlux, smem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define ROMS_FLUX_ENTRY(NAME, T)                                             \
  extern "C" int NAME(int with_flux, const void* u, const void* v,          \
                      const void* Hz, const void* on_u, const void* om_v,   \
                      const void* z_w, void* Huon, void* Hvom, void* W,     \
                      int N, int Mj, int Li, int TJ, int TI, void* stream) { \
    return launch<T>(with_flux, u, v, Hz, on_u, om_v, z_w, Huon, Hvom, W,   \
                     N, Mj, Li, TJ, TI, stream);                            \
  }

ROMS_FLUX_ENTRY(roms_flux_omega_f32, float)
ROMS_FLUX_ENTRY(roms_flux_omega_f64, double)
