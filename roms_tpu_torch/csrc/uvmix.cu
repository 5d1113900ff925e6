// Kernel 10: harmonic momentum mixing along s-surfaces (uv3dmix2_s.h:
// 120-222): the rho-point and psi-point stresses, their divergence, the
// dt-weighted update of the corrector seeds u_part/v_part, and the
// vertical sum of the divergence into the 2D forcing rufrc/rvfrc.
//
// Replaces roms_tpu/ops/pallas_uvmix.py:143 uv3dmix2_s_pallas
// (pallas_call l.190); plain version core/hmix.py uv3dmix2_s
// (ops/uvmix.py).  Class: EW-periodic, not NS-periodic, constant visc2
// (no Smagorinsky coefficients).  Every point carries the plain path's
// value: the ring rows add the roll-wrap stress, where the Pallas kernel
// leaves the seeds unchanged, so the two compare whole.
//
// Bound on the H100: bytes.  It reads u, v, Hz, u_part, v_part (N levels),
// 13 two-dimensional metrics and rufrc, rvfrc, and writes u_part, v_part
// (N) and rufrc, rvfrc: ~7 words a point against ~60 flops.
//
// Design: one 256-thread block per tile of TJ x TI columns (ops/uvmix.py
// launch_shape; 7 x 31), marching k from 0 to N-1.  A thread owns one
// position (yy, xx) of the tile grown by one row and lane, (TJ+1) x
// (TI+1): the rho point (yy-1, xx-1), whose stress factor cff_r gives UFx
// and VFe, and the psi point (yy, xx), whose cff_p gives UFe and VFx, so
// each of the four stress components is formed once a level at every
// point the tile's divergence reaches (a tile point's own column is its
// psi point).  The metric factors of those two points and of the tile
// point (face sums, pmon/pnom, pmask, the visc2-weighted squared metrics,
// formed in the plain version's order) are read once a block into the
// thread's registers.  Each level is two barrier-separated phases:
//   A. (issued first, completed two levels on) cp.async copies of level
//      k+2's u, v and Hz on a window of the tile with a one-point halo,
//      into the third of three shared-memory buffers; each thread's
//      cff_r and cff_p from the window, and the four stresses into
//      shared memory;
//   B. each tile point's divergence du, dv from the stresses of its faces,
//      the seeds' update (u_part/v_part of the next level loaded a level
//      ahead) and the vertical sums.
// The vertical sums su, sv stay in registers in torch.sum's order over
// dim 0 below 64 levels (four accumulators by k mod 4, combined in
// order; Sum4).
//
// Lanes and rows: the window wraps as jnp.roll wraps (rows mod Mj, lanes
// mod Li).  The periodic ring of the four stresses (lane 0 <- Li-2,
// Li-1 <- 1, core/hmix.py _ring) is a table of the window's lanes: the
// position of the ringed lane's copy among the tile's lanes.  Tiles whose
// table is the identity (all but the seam's) run a copy of the level loop
// that reads no table.  The lane tiling is shifted half a tile
// (roms::Tile), so that lanes Li-2 .. 1 lie in the seam's tile.
//
// Every product that feeds an add or subtract is mul_rn, so each value
// rounds as in the plain version.
#include <type_traits>

#include "common.cuh"

namespace {

using roms::copy_async;
using roms::copy_commit;
using roms::copy_wait;
using roms::mul_rn;

constexpr int kThreadsMix = 256;
constexpr int kHalo = 1;     // window rows and lanes beyond the tile, each side
constexpr int kStages = 3;   // level buffers: levels k+1 and k+2 in flight
constexpr int kRaw = 3;      // a level's staged planes: u, v and Hz

template <typename T>
struct Params {
  const T *u, *v, *Hz, *u_part, *v_part, *rufrc, *rvfrc;
  // the 13 metrics of pallas_uvmix._G2D
  const T *pn, *pm, *pmon_r, *pnom_r, *on_r, *om_r, *pmon_p, *pnom_p, *on_p,
      *om_p, *pmask, *visc2_r, *visc2_p;
  T *out_up, *out_vp, *out_ruf, *out_rvf;
  int N, Mj, Li, TJ, TI;
  T dt4;            // dt * 0.25
};

// A sum over levels k = 0, 1, ... in the order of torch.sum(x, dim=0) on
// the card below 64 levels: four accumulators by k mod 4, combined in
// order.  The accumulators rotate after each add, so that the next
// level's is always a0 (no indexed register array); total(n) after n adds.
template <typename T>
struct Sum4 {
  T a0 = T(0), a1 = T(0), a2 = T(0), a3 = T(0);

  __device__ void rotate() {
    const T t = a0;
    a0 = a1;
    a1 = a2;
    a2 = a3;
    a3 = t;
  }
  __device__ void add(T x) {
    a0 = a0 + x;
    rotate();
  }
  __device__ T total(int n) {
    // after n adds a0 holds level n's residue: turn it back to 0's
    for (int m = (4 - (n & 3)) & 3; m > 0; --m) rotate();
    return ((a0 + a1) + a2) + a3;
  }
};

// the block's shared arrays (ops/uvmix.py launch_shape counts the bytes)
template <typename T>
struct Smem {
  int WJ, WI, WP;
  T* raw;                      // kStages buffers x kRaw window planes
  T *ufx, *vfe, *ufe, *vfx;    // the level's four stresses
  int *rowg, *colg, *tr;
  int* goff;                   // each window position's offset in a plane

  __device__ void carve(void* base, int TJ, int TI) {
    WJ = TJ + 2 * kHalo;
    WI = TI + 2 * kHalo;
    WP = WJ * WI;
    raw = static_cast<T*>(base);
    ufx = raw + kStages * kRaw * WP;
    vfe = ufx + WP;
    ufe = vfe + WP;
    vfx = ufe + WP;
    rowg = reinterpret_cast<int*>(vfx + WP);
    colg = rowg + WJ;
    tr = colg + WI;
    goff = tr + WI;
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreadsMix)
uvmix_kernel(const __grid_constant__ Params<T> p) {
  extern __shared__ __align__(16) unsigned char smem[];
  Smem<T> s;
  s.carve(smem, p.TJ, p.TI);
  const int N = p.N, Mj = p.Mj, Li = p.Li;
  const int WI = s.WI;
  const size_t P = static_cast<size_t>(Mj) * Li;
  // the block's tile (lane tiling shifted by half a tile: the periodic
  // seam lies in tile 0)
  const roms::Tile t(p.TJ, p.TI, Mj, Li);
  const int tj = t.tj, ti = t.ti;

  // tables: global row and lane of each window position; the window lane
  // whose stresses each lane takes (tr: the copy of the ringed lane among
  // the tile's lanes, 1 .. ti); `mapped` is set where that is not the
  // identity
  __shared__ int mapped;
  if (threadIdx.x == 0) mapped = 0;
  t.tables(kHalo, s.WJ, WI, Mj, Li, s.rowg, s.colg);
  __syncthreads();
  for (int n = threadIdx.x; n < WI; n += blockDim.x) {
    const int g = s.colg[n];
    const int h = roms::ring_x(g, Li, true);
    int r = n;
    if (h != g) {
      r = min(kHalo + roms::mod(h - s.colg[kHalo], Li), ti);
      mapped = 1;
    }
    s.tr[n] = r;
  }
  for (int n = threadIdx.x; n < s.WP; n += blockDim.x) {
    const int r = n / WI, c = n - r * WI;
    s.goff[n] = s.rowg[r] * Li + s.colg[c];
  }

  // this thread's position (yy, xx) of the tile grown by a row and a lane:
  // its psi point (and tile point) at window position pw, its rho point
  // (yy-1, xx-1) at pw - WI - 1
  const int gw = ti + 1;
  const bool act = static_cast<int>(threadIdx.x) < (tj + 1) * gw;
  const int yy = act ? threadIdx.x / gw : 0;
  const int xx = act ? threadIdx.x - yy * gw : 0;
  const bool tile = act && yy < tj && xx < ti;
  const int pw = (yy + kHalo) * WI + xx + kHalo;
  const int rw = pw - WI - 1;
  // offset of the point (y, x) of the grown tile, rows and lanes wrapped
  auto at = [&](int y, int x) {
    return static_cast<size_t>(roms::mod(t.j0 + y, Mj)) * Li +
           roms::mod(t.i0 + x, Li);
  };
  const size_t gofs = at(yy, xx);

  // the metric factors, each formed as in the plain version: at the rho
  // point, upn at (y, x) and (y, x+1) and vpm at (y, x) and (y+1, x); at
  // the psi point, vpn at (y, x) and (y, x-1) and upm at (y, x) and
  // (y-1, x); at the tile point, the divergence's and the update's
  T r_upn0 = T(0), r_upn1 = T(0), r_vpm0 = T(0), r_vpm1 = T(0);
  T pmon_r = T(0), pnom_r = T(0), cUx = T(0), cVe = T(0);
  T p_vpn0 = T(0), p_vpnw = T(0), p_upm0 = T(0), p_upms = T(0);
  T pmon_p = T(0), pnom_p = T(0), pmask = T(0), cUe = T(0), cVx = T(0);
  T hu_n = T(0), hu_m = T(0), hv_n = T(0), hv_m = T(0), fu = T(0), fv = T(0);
  T upc = T(0), vpc = T(0);
  if (act) {
    const int y = yy - 1, x = xx - 1;
    const size_t cr = at(y, x);
    r_upn0 = p.pn[cr] + p.pn[at(y, x - 1)];
    r_upn1 = p.pn[at(y, x + 1)] + p.pn[cr];
    r_vpm0 = p.pm[cr] + p.pm[at(y - 1, x)];
    r_vpm1 = p.pm[at(y + 1, x)] + p.pm[cr];
    pmon_r = p.pmon_r[cr];
    pnom_r = p.pnom_r[cr];
    cUx = p.on_r[cr] * p.on_r[cr] * p.visc2_r[cr];
    cVe = p.om_r[cr] * p.om_r[cr] * p.visc2_r[cr];
    const size_t cs = at(yy - 1, xx), cw = at(yy, xx - 1);
    p_vpn0 = p.pn[gofs] + p.pn[cs];
    p_vpnw = p.pn[cw] + p.pn[at(yy - 1, xx - 1)];
    p_upm0 = p.pm[gofs] + p.pm[cw];
    p_upms = p.pm[cs] + p.pm[at(yy - 1, xx - 1)];
    pmon_p = p.pmon_p[gofs];
    pnom_p = p.pnom_p[gofs];
    pmask = p.pmask[gofs];
    cUe = p.om_p[gofs] * p.om_p[gofs] * p.visc2_p[gofs];
    cVx = p.on_p[gofs] * p.on_p[gofs] * p.visc2_p[gofs];
    if (tile) {
      const T upn = p.pn[gofs] + p.pn[cw];
      const T vpm = p.pm[gofs] + p.pm[cs];
      hu_n = T(0.5) * upn;
      hu_m = T(0.5) * p_upm0;
      hv_n = T(0.5) * p_vpn0;
      hv_m = T(0.5) * vpm;
      fu = p.dt4 * p_upm0 * upn;
      fv = p.dt4 * vpm * p_vpn0;
      upc = p.u_part[gofs];
      vpc = p.v_part[gofs];
    }
  }

  // stage level kk into raw buffer b
  auto stage = [&](int kk, int b) {
    T* dst = s.raw + kRaw * b * s.WP;
    const size_t lev = static_cast<size_t>(kk) * P;
    for (int n = threadIdx.x; n < s.WP; n += blockDim.x) {
      const size_t g = lev + s.goff[n];
      copy_async(dst + n, p.u + g);
      copy_async(dst + s.WP + n, p.v + g);
      copy_async(dst + 2 * s.WP + n, p.Hz + g);
    }
  };
  __syncthreads();
  for (int b = 0; b < kStages - 1; ++b) {
    if (b < N) stage(b, b);
    copy_commit();
  }
  copy_wait<kStages - 2>();

  Sum4<T> su, sv;
  auto march = [&](auto map) {
    constexpr bool MAP = decltype(map)::value;
    // window lane c of a stress, ringed
    auto lane = [&](int c) { return MAP ? s.tr[c] : c; };
    for (int k = 0; k < N; ++k) {
      const size_t lev = static_cast<size_t>(k) * P;
      __syncthreads();
      // A. level k+kStages-1 is copied into the buffer of level k-1 while
      // level k is used
      const int kn = k + kStages - 1;
      if (kn < N) stage(kn, kn % kStages);
      copy_commit();
      const T* u = s.raw + kRaw * (k % kStages) * s.WP;
      const T* v = u + s.WP;
      const T* hz = v + s.WP;
      if (act) {
        // rho point: Hz*0.5*(pmon_r*dx_p(upn*u) - pnom_r*dy_p(vpm*v))
        const T dxp = mul_rn(r_upn1, u[rw + 1]) - mul_rn(r_upn0, u[rw]);
        const T dyp = mul_rn(r_vpm1, v[rw + WI]) - mul_rn(r_vpm0, v[rw]);
        const T cff_r =
            hz[rw] * T(0.5) * (mul_rn(pmon_r, dxp) - mul_rn(pnom_r, dyp));
        s.ufx[rw] = mul_rn(cUx, cff_r);
        s.vfe[rw] = mul_rn(cVe, cff_r);
        // psi point: 0.5*Hz_p*(pmon_p*dx_m(vpn*v) + pnom_p*dy_m(upm*u))*pmask
        const T Hzp =
            T(0.25) * (((hz[pw] + hz[pw - 1]) + hz[pw - WI]) + hz[pw - WI - 1]);
        const T dxm = mul_rn(p_vpn0, v[pw]) - mul_rn(p_vpnw, v[pw - 1]);
        const T dym = mul_rn(p_upm0, u[pw]) - mul_rn(p_upms, u[pw - WI]);
        const T cff_p = T(0.5) * Hzp *
                        (mul_rn(pmon_p, dxm) + mul_rn(pnom_p, dym)) * pmask;
        s.ufe[pw] = mul_rn(cUe, cff_p);
        s.vfx[pw] = mul_rn(cVx, cff_p);
      }
      __syncthreads();
      // B. the divergence at this thread's tile point
      if (tile) {
        const T up = upc, vp = vpc;
        if (k + 1 < N) {
          upc = p.u_part[lev + P + gofs];
          vpc = p.v_part[lev + P + gofs];
        }
        const int row = pw - xx - kHalo;
        const int c0 = lane(xx + kHalo);
        const T du = mul_rn(hu_n, s.ufx[row + c0] -
                                      s.ufx[row + lane(xx + kHalo - 1)]) +
                     mul_rn(hu_m, s.ufe[row + WI + c0] - s.ufe[row + c0]);
        const T dv = mul_rn(hv_n, s.vfx[row + lane(xx + kHalo + 1)] -
                                      s.vfx[row + c0]) -
                     mul_rn(hv_m, s.vfe[row + c0] - s.vfe[row - WI + c0]);
        p.out_up[lev + gofs] = up + mul_rn(fu, du);
        p.out_vp[lev + gofs] = vp + mul_rn(fv, dv);
        su.add(du);
        sv.add(dv);
      }
      copy_wait<kStages - 2>();
    }
  };
  if (mapped)
    march(std::true_type{});
  else
    march(std::false_type{});
  if (tile) {
    p.out_ruf[gofs] = p.rufrc[gofs] + su.total(N);
    p.out_rvf[gofs] = p.rvfrc[gofs] + sv.total(N);
  }
}

template <typename T>
int launch(const void* const* in, void* const* out, int N, int Mj, int Li,
           int TJ, int TI, double dt, void* stream) {
  Params<T> p;
  const T* const* f = reinterpret_cast<const T* const*>(in);
  const T** fields[] = {&p.u,      &p.v,      &p.Hz,     &p.u_part,
                        &p.v_part, &p.rufrc,  &p.rvfrc,  &p.pn,
                        &p.pm,     &p.pmon_r, &p.pnom_r, &p.on_r,
                        &p.om_r,   &p.pmon_p, &p.pnom_p, &p.on_p,
                        &p.om_p,   &p.pmask,  &p.visc2_r, &p.visc2_p};
  for (int n = 0; n < 20; ++n) *fields[n] = f[n];
  T** outs[] = {&p.out_up, &p.out_vp, &p.out_ruf, &p.out_rvf};
  for (int n = 0; n < 4; ++n) *outs[n] = static_cast<T*>(out[n]);
  p.N = N;
  p.Mj = Mj;
  p.Li = Li;
  p.TJ = TJ;
  p.TI = TI;
  p.dt4 = T(dt * 0.25);
  const size_t WJ = TJ + 2 * kHalo, WI = TI + 2 * kHalo;
  const size_t smem = sizeof(T) * (kStages * kRaw + 4) * WJ * WI +
                      sizeof(int) * (WJ + 2 * WI + WJ * WI);
  if ((TJ + 1) * (TI + 1) > kThreadsMix || N < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = roms::allow_smem(uvmix_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Li + TI - 1) / TI, (Mj + TJ - 1) / TJ);
  uvmix_kernel<T><<<grid, kThreadsMix, smem,
                    static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define ROMS_UVMIX_ENTRY(NAME, T)                                            \
  extern "C" int NAME(const void* const* in, void* const* out, int N,       \
                      int Mj, int Li, int TJ, int TI, double dt,            \
                      void* stream) {                                       \
    return launch<T>(in, out, N, Mj, Li, TJ, TI, dt, stream);               \
  }

ROMS_UVMIX_ENTRY(roms_uv3dmix2_s_f32, float)
ROMS_UVMIX_ENTRY(roms_uv3dmix2_s_f64, double)
