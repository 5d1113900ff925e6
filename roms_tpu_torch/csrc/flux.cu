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
// The design: one 256-thread block per tile of TJ x TI columns
// (ops/flux.py launch_shape; 7 x 31) on roms::Tile's half-shifted tiling,
// so that the periodic seam lies inside tile 0, marching k from 0 to N-1;
// one kernel body for both entry points (kFlux).  A thread owns one
// position (yy, xx) of the tile grown by one row north and one lane east,
// (TJ+1) x (TI+1), and stages by cp.async, kStages - 1 levels ahead, what
// that position needs of a level.
//
// flux_omega stages u, v and Hz (a few threads also stage the Hz window's
// south row and west lane) and forms the level's Huon at (yy, xx) for rows
// of the tile and its Hvom for lanes of the tile, so each flux is formed
// once a level.  After a barrier each tile point writes its Huon and Hvom,
// taken through the window's lane table (st.periodic_x: lane 0 holds lane
// Li-2's flux, lane Li-1 lane 1's; each thread keeps its own two entries
// of the table in registers).
//
// omega stages the given Huon on the tile grown a lane east and Hvom on
// the tile grown a row north, and reads them where they land: its inputs
// are already the ringed fluxes, so it needs no lane table and one
// barrier a level.
//
// In both, each bc_rho source column (rows 1..Mj-2, lanes 1..Li-2) forms
// its div from the shared fluxes and adds it to its running sum, which it
// keeps, level by level, in dynamic shared memory laid out [k][tile
// point].  A source column's div reads Huon up to lane Li-1 and Hvom up to
// row Mj-1, so it never needs the roll's wrap; the grown lane past Li-1
// and row past Mj-1 are staged in range and feed no source.  After the
// march a second pass over k reads only z_w and writes W: the source
// column's thread writes W into its own column and into the ring copies
// bc_rho makes of it (row 0 from row 1, row Mj-1 from Mj-2, lane 0 from
// Li-2, lane Li-1 from lane 1, and the corners), so no column is
// integrated twice, whatever tile its copies lie in.  Every input plane is
// read from device memory once and each output written once.  A launch
// whose running sums do not fit a block's shared memory is refused
// (roms::allow_smem; ops/flux.py raises first).
#include "common.cuh"

namespace {

using roms::copy_async;
using roms::copy_commit;
using roms::copy_wait;
using roms::mul_rn;

constexpr int kThreadsFlux = 256;
constexpr int kStages = 3;   // level buffers: levels k+1 and k+2 in flight

template <typename T>
struct FluxParams {
  const T *u, *v, *Hz, *on_u, *om_v, *z_w;
  T *Huon, *Hvom, *W;   // flux_omega's outputs; omega's given fluxes
  int N, Mj, Li, TJ, TI;
};

// the block's shared arrays (ops/flux.py launch_shape counts the bytes)
template <typename T, bool kFlux>
struct FluxSmem {
  int nH, nU, nV;   // a level's staged Hz window, u and v positions
  T* raw;           // kStages buffers of (Hz, u, v), or of (Huon, Hvom)
  T *hu, *hv;       // flux_omega: the level's Huon and Hvom on the grown tile
  T* sums;          // the running sums [k][tile point], levels 0..N-2

  __device__ void carve(void* base, int TJ, int TI) {
    nH = kFlux ? (TJ + 2) * (TI + 2) : 0;
    nU = TJ * (TI + 1);
    nV = (TJ + 1) * TI;
    raw = static_cast<T*>(base);
    hu = raw + kStages * (nH + nU + nV);
    hv = hu + nU;
    sums = kFlux ? hv + nV : hu;
  }
};

template <typename T, bool kFlux>
__global__ void __launch_bounds__(kThreadsFlux)
flux_omega_kernel(const __grid_constant__ FluxParams<T> p) {
  extern __shared__ __align__(16) unsigned char smem[];
  FluxSmem<T, kFlux> s;
  s.carve(smem, p.TJ, p.TI);
  const int N = p.N, Mj = p.Mj, Li = p.Li;
  const size_t P = static_cast<size_t>(Mj) * Li;
  const roms::Tile t(p.TJ, p.TI, Mj, Li);
  const int tj = t.tj, ti = t.ti;
  // strides of the staged planes: the Hz window (tile grown by a row and a
  // lane each side), u, Huon and hu (grown a lane east), v, Hvom and hv
  // (grown a row north)
  const int WI = ti + 2, UI = ti + 1, VI = ti;

  // this thread's position (yy, xx) of the tile grown a row north and a
  // lane east; rows and lanes wrap as jnp.roll wraps
  const int tx = threadIdx.x, gw = ti + 1;
  const bool act = tx < (tj + 1) * gw;
  const int yy = act ? tx / gw : 0;
  const int xx = act ? tx - yy * gw : 0;
  const bool upos = act && yy < tj;   // stages (or forms) Huon at (yy, xx)
  const bool vpos = act && xx < ti;   // stages (or forms) Hvom at (yy, xx)
  const bool tile = upos && vpos;
  const int gj = roms::mod(t.j0 + yy, Mj), gi = roms::mod(t.i0 + xx, Li);
  const int gofs = gj * Li + gi;
  // flux_omega: the Hz window's south row (lanes 1..ti) and west lane
  // (rows 1..tj), staged by the first ti + tj threads
  int rim = -1;
  if (kFlux && tx < ti)
    rim = roms::mod(t.j0 - 1, Mj) * Li + roms::mod(t.i0 + tx, Li);
  else if (kFlux && tx < ti + tj)
    rim = roms::mod(t.j0 + tx - ti, Mj) * Li + roms::mod(t.i0 - 1, Li);
  const int rim_at = tx < ti ? tx + 1 : (tx - ti + 1) * WI;
  const int hw = (yy + 1) * WI + xx + 1;   // this position in the window

  // flux_omega: the window's lane table at this thread's lane and the
  // next, the tile lane whose flux a lane holds after st.periodic_x (the
  // seam's ring lanes take lanes Li-2 and 1, which tile 0 holds); omega's
  // staged fluxes already hold it
  auto ring = [&](int x) {
    if (!kFlux) return x;
    const int g = roms::mod(t.i0 + x, Li);
    const int h = roms::ring_x(g, Li, true);
    return h == g ? x : min(roms::mod(h - t.i0, Li), ti - 1);
  };
  const int lane = ring(xx), east = ring(xx + 1);
  const T on_u = kFlux && upos ? p.on_u[gofs] : T(0);
  const T om_v = kFlux && vpos ? p.om_v[gofs] : T(0);
  // a bc_rho source column: it integrates W for itself and its copies
  const bool owner = tile && gj >= 1 && gj <= Mj - 2 && gi >= 1 &&
                     gi <= Li - 2;
  const int pt = yy * ti + xx;   // its tile point, for the running sums
  const int S = p.TJ * p.TI;
  const int stage_len = s.nH + s.nU + s.nV;

  auto stage = [&](int kk, int b) {
    T* hz = s.raw + b * stage_len;
    T* u = hz + s.nH;
    T* v = u + s.nU;
    const size_t lev = static_cast<size_t>(kk) * P;
    if (kFlux) {
      if (act) copy_async(hz + hw, p.Hz + lev + gofs);
      if (rim >= 0) copy_async(hz + rim_at, p.Hz + lev + rim);
    }
    if (upos) copy_async(u + yy * UI + xx, (kFlux ? p.u : p.Huon) + lev + gofs);
    if (vpos) copy_async(v + yy * VI + xx, (kFlux ? p.v : p.Hvom) + lev + gofs);
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
    const T* hz = s.raw + (k % kStages) * stage_len;
    const T* u = hz + s.nH;
    const T* v = u + s.nU;
    // the level's Huon (grown a lane east) and Hvom (grown a row north)
    const T* fu = u;
    const T* fv = v;
    if (kFlux) {
      // A. this position's fluxes: Hz_u = 0.5 (Hz + Hz[i-1]), Hz_v =
      // 0.5 (Hz + Hz[j-1]), then (Hz_x * vel) * metric
      if (upos)
        s.hu[yy * UI + xx] = mul_rn(T(0.5) * (hz[hw] + hz[hw - 1]) *
                                        u[yy * UI + xx], on_u);
      if (vpos)
        s.hv[yy * VI + xx] = mul_rn(T(0.5) * (hz[hw] + hz[hw - WI]) *
                                        v[yy * VI + xx], om_v);
      __syncthreads();
      fu = s.hu;
      fv = s.hv;
    }
    // B. the ringed fluxes of the tile points, the sources' running sums
    if (tile) {
      if (kFlux) {
        p.Huon[lev + gofs] = fu[yy * UI + lane];
        p.Hvom[lev + gofs] = fv[yy * VI + lane];
      }
      if (owner) {
        const T div = (fu[yy * UI + east] - fu[yy * UI + xx]) +
                      (fv[(yy + 1) * VI + xx] - fv[yy * VI + xx]);
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

// the dynamic shared memory of a launch (ops/flux.py launch_shape)
template <typename T>
size_t smem_bytes(bool with_flux, int N, int TJ, int TI) {
  const size_t nH = with_flux ? (TJ + 2) * (TI + 2) : 0,
               nU = TJ * (TI + 1), nV = (TJ + 1) * TI;
  return sizeof(T) * (kStages * (nH + nU + nV) + (with_flux ? nU + nV : 0) +
                      static_cast<size_t>(N - 1) * TJ * TI);
}

template <typename T, bool kFlux>
int launch_tile(const FluxParams<T>& p, cudaStream_t st) {
  const size_t smem = smem_bytes<T>(kFlux, p.N, p.TJ, p.TI);
  const cudaError_t err = roms::allow_smem(flux_omega_kernel<T, kFlux>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.Li + p.TI - 1) / p.TI, (p.Mj + p.TJ - 1) / p.TJ);
  flux_omega_kernel<T, kFlux><<<grid, kThreadsFlux, smem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// flux_omega reads u, v, Hz, on_u, om_v and writes Huon and Hvom; omega
// reads Huon and Hvom
template <typename T>
int launch(int with_flux, const void* u, const void* v, const void* Hz,
           const void* on_u, const void* om_v, const void* z_w, void* Huon,
           void* Hvom, void* W, int N, int Mj, int Li, int TJ, int TI,
           void* stream) {
  if (N < 1 || (TJ + 1) * (TI + 1) > kThreadsFlux)
    return static_cast<int>(cudaErrorInvalidValue);
  const FluxParams<T> p{
      static_cast<const T*>(u),    static_cast<const T*>(v),
      static_cast<const T*>(Hz),   static_cast<const T*>(on_u),
      static_cast<const T*>(om_v), static_cast<const T*>(z_w),
      static_cast<T*>(Huon),       static_cast<T*>(Hvom),
      static_cast<T*>(W),          N, Mj, Li, TJ, TI};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_flux ? launch_tile<T, true>(p, st) : launch_tile<T, false>(p, st);
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
