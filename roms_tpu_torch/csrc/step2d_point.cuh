// The fast barotropic loop's per-point formulas (step2d_LF_AM3.h:163-3058,
// core/step2d.py's predictor and corrector), shared by the two fast-loop
// engines: the resident loop (step2d.cu, kernel 11: one launch per
// half-step, one block per tile, its intermediates in shared memory) and
// the j-blocked loop (step2d_blocked.cu, kernel 12: KS substeps per
// launch on a window of each tile with halo, its neighbour-read fields in
// shared memory).  Both evaluate the same expressions in the same order,
// so they round alike.
//
// The formulas are templated on an indexer Ix, which maps a point (j, i)
// of the engine's own coordinates, whose neighbours are (j +- 1, i +- 1),
// to
//   sidx(id, j, i): the element of read-only grid plane id,
//   at(f, id, j, i): the address of carry or scratch field id, given the
//          plane table f,
//   grow(j): the global row (0 <= . < Mj),
//   own(j, i): whether the point is one the block stores (the averages
//          are formed only there),
//   keep(j, i): whether the predictor's rhs_zeta is kept at the point
//          (the points that a later half-step of the launch reads),
// and applies the lateral BCs' index maps from global indices, as
// points of its own coordinates:
//   px(i): the lane an array holds after st.periodic_x (lane 0 holds
//          lane Li-2, lane Li-1 holds lane 1),
//   ring_row(j): the row bc_rho and bc_u copy into rows 0 and Mj-1
//          (1 and Mj-2),
//   rv_row(j): the row the C4 advection's v stencil clamps rows 1 and
//          Mj-1 to (2 and Mj-2).
#pragma once

#include "common.cuh"

namespace roms {
namespace step2d {

// A block's window: a tile of the grid with a halo.  Point (j, i) is
// window row j, lane i; its global row and lane come from per-block
// tables (fill_tables), clamped to the window, so points near the
// window's edge read clamped neighbours and hold dead values, which the
// halo keeps away from the tile.  The BC maps are offsets within the
// window: lane 0 holds lane Li-2, two lanes west under the jnp.roll
// wrap; lane Li-1 holds lane 1, two lanes east.
struct WindowIx {
  int Mj, Li, WJ, WI;
  const int* rowg;    // global row of each window row
  const int* colg;    // global lane of each window lane
  __device__ int cj(int j) const { return min(max(j, 0), WJ - 1); }
  __device__ int ci(int i) const { return min(max(i, 0), WI - 1); }
  __device__ int grow(int j) const { return rowg[cj(j)]; }
  // the element of an (Mj, Li) plane in device memory
  __device__ int gidx(int j, int i) const {
    return grow(j) * Li + colg[ci(i)];
  }
  __device__ int px(int i) const {
    const int g = colg[ci(i)];
    return g == 0 ? i - 2 : (g == Li - 1 ? i + 2 : i);
  }
  // the element of a window plane
  __device__ int widx(int j, int i) const { return cj(j) * WI + ci(i); }
  __device__ int ring_row(int j) const {
    const int g = grow(j);
    return g == 0 ? j + 1 : (g == Mj - 1 ? j - 1 : j);
  }
  __device__ int rv_row(int j) const {
    const int g = grow(j);
    return g == 1 ? j + 1 : (g == Mj - 1 ? j - 1 : j);
  }
};

// the window tables of a block whose window starts at global (j0, i0),
// wrapped as jnp.roll wraps
__device__ __forceinline__ void fill_tables(int* rowg, int* colg, int j0,
                                            int i0, int WJ, int WI, int Mj,
                                            int Li) {
  for (int n = threadIdx.x; n < WJ + WI; n += blockDim.x) {
    if (n < WJ)
      rowg[n] = mod(j0 + n, Mj);
    else
      colg[n - WJ] = mod(i0 + n - WJ, Li);
  }
}

// planes of the carry + scratch buffer
enum Plane {
  ZETA, ZETA_PREV, UBAR, UBAR_PREV, VBAR, VBAR_PREV, RZ_PREV, RU_PREV,
  RV_PREV, RUFRC, RVFRC, ZT, DU1, DV1, DU2, DV2,   // the 16 carry fields
  DUON, DVOM, ZWRK, ZETA_P, UBAR_P, VBAR_P, RZ_M, RU_M, RV_M, RUFRC_N,
  RVFRC_N, NPLANE
};
constexpr int NCARRY = DV2 + 1;

// read-only (Mj, Li) inputs, in the order of ops/step2d.py STATICS
enum Stat {
  H, PM, PN, RMASK, UMASK, VMASK, FOMN, DNDX, DMDE, ON_U, OM_V, PMON_R,
  PNOM_R, PMON_P, PNOM_P, ON_R, OM_R, ON_P, OM_P, PMASK, VISC2_R, VISC2_P,
  RHOS, RHOA, RU0, RV0, RU0P2, RV0P2, NSTAT
};

// The rotation of kernel 11's planes between launches: the corrector
// writes zeta_c into the zeta_prev plane, and after each substep the new
// state and the predictor's rhs histories swap places with the old ones
// instead of being copied.
struct Slots {
  int s[NPLANE];
  __host__ __device__ void reset() {
    for (int p = 0; p < NPLANE; ++p) s[p] = p;
  }
  __host__ __device__ void swap(int a, int b) {
    const int t = s[a];
    s[a] = s[b];
    s[b] = t;
  }
  // rufrc_c of the first substep becomes the forcing
  __host__ __device__ void after_first_predictor() {
    swap(RUFRC, RUFRC_N);
    swap(RVFRC, RVFRC_N);
  }
  __host__ __device__ void after_substep() {
    swap(ZETA, ZETA_PREV);
    swap(UBAR, UBAR_PREV);
    swap(VBAR, VBAR_PREV);
    swap(RZ_PREV, RZ_M);
    swap(RU_PREV, RU_M);
    swap(RV_PREV, RV_M);
  }
};

// constants, rounded once from the double values of the plain loop, and
// the config flags
template <typename T>
struct Consts {
  int var_rho, uv_adv, uv_cor, curv, visc;
  T cff1g, fac, dtf, dtf2, half, s5, s8, s1, cff4p, cff5p, cff4c, cff5c,
      c5, c8, c1, sixth, third, gamma2;

  // k = (g, rho0, dtfast, gamma2); flags as ops/step2d.py packs them
  __host__ void set(const double* k, int flags) {
    var_rho = flags & 1;
    uv_adv = (flags >> 1) & 1;
    uv_cor = (flags >> 2) & 1;
    curv = (flags >> 3) & 1;
    visc = (flags >> 4) & 1;
    const double g = k[0], rho0 = k[1], dtf_ = k[2];
    cff1g = T(0.5 * g);
    fac = T(1000.0 / rho0);
    dtf = T(dtf_);
    dtf2 = T(2.0 * dtf_);
    half = T(0.5 * dtf_);
    s5 = T(5.0 / 12.0 * dtf_);
    s8 = T(8.0 / 12.0 * dtf_);
    s1 = T(1.0 / 12.0 * dtf_);
    cff4p = T(4.0 / 25.0);
    cff5p = T(1.0 - 2.0 * (4.0 / 25.0));
    cff4c = T(2.0 / 5.0);
    cff5c = T(1.0 - 2.0 / 5.0);
    c5 = T(5.0 / 12.0);
    c8 = T(8.0 / 12.0);
    c1 = T(1.0 / 12.0);
    sixth = T(1.0 / 6.0);
    third = T(1.0 / 3.0);
    gamma2 = T(k[3]);
  }
};

// What the per-point formulas see: the launch's constants, grid planes
// and scalar table by reference (each kernel takes them as one
// __grid_constant__ parameter, read in place rather than copied into
// every thread), the plane table of the carry and scratch fields (kernel
// 11's; kernel 12's indexer places its fields itself), the indexer and
// the substep (0-based, of the whole loop).
template <typename T, typename Ix>
struct Ctx {
  const Consts<T>& k;
  const T* const* st;   // NSTAT grid planes
  const T* tab;         // (nfast, 7) scalar table
  T* const* f;          // NPLANE planes, in this substep's rotation
  Ix ix;
  int s;

  __device__ int Mj() const { return ix.Mj; }
  __device__ int px(int i) const { return ix.px(i); }
  __device__ int ring_row(int j) const { return ix.ring_row(j); }
  __device__ T S(int id, int j, int i) const {
    return st[id][ix.sidx(id, j, i)];
  }
  __device__ T V(int id, int j, int i) const { return *ix.at(f, id, j, i); }
  __device__ T& F(int id, int j, int i) const { return *ix.at(f, id, j, i); }
  __device__ T tab_at(int q) const { return tab[s * 7 + q]; }
  __device__ bool first() const { return tab[s * 7] != T(0); }
};

// (i-1) - 2 i + (i+1) along x of field id at (j, i)
template <typename T, typename C>
__device__ T lapx(const C& c, int id, int j, int i) {
  return c.V(id, j, i - 1) - T(2.0) * c.V(id, j, i) + c.V(id, j, i + 1);
}
template <typename T, typename C>
__device__ T lapy(const C& c, int id, int j, int i) {
  return c.V(id, j - 1, i) - T(2.0) * c.V(id, j, i) + c.V(id, j + 1, i);
}

// ---------------------------------------------------------------------------
// the 2D momentum RHS (core/step2d.py _rhs2d_momentum) at one point
// ---------------------------------------------------------------------------

template <typename T, typename C>
struct Rhs {
  const C& c;
  int ub, vb, DU, DV, Z;   // fields: ubar, vbar, fluxes, zeta of Drhs

  // Drhs after st.periodic_x
  __device__ T Dr(int j, int i) const {
    const int ii = c.px(i);
    return c.V(Z, j, ii) + c.S(H, j, ii);
  }
  __device__ T zw(int j, int i) const { return c.V(ZWRK, j, i); }
  __device__ T gz(int j, int i) const {
    return c.k.var_rho ? mul_rn(c.k.fac + c.S(RHOS, j, i), zw(j, i))
                       : zw(j, i);
  }
  __device__ T gz2(int j, int i) const {
    return c.k.var_rho ? mul_rn(gz(j, i), zw(j, i))
                       : mul_rn(zw(j, i), zw(j, i));
  }
  __device__ T gzSA(int j, int i) const {
    return mul_rn(zw(j, i), c.S(RHOS, j, i) - c.S(RHOA, j, i));
  }
  // barotropic pressure gradient, u and v (_pg2d)
  __device__ T pg(int j, int i, int dj, int di, int metric) const {
    const int jm = j - dj, im = i - di;
    const T hm = c.S(H, jm, im), h = c.S(H, j, i);
    T p = mul_rn(hm + h, gz(jm, im) - gz(j, i)) + (gz2(jm, im) - gz2(j, i));
    if (c.k.var_rho) {
      const T t3 = c.k.third * (c.S(RHOA, jm, im) - c.S(RHOA, j, i));
      p = p + mul_rn(hm - h, gzSA(jm, im) + gzSA(j, i) +
                                 mul_rn(t3, zw(jm, im) - zw(j, i)));
    }
    return mul_rn(c.k.cff1g * c.S(metric, j, i), p);
  }

  // C4 advection fluxes
  __device__ T gu(int j, int i) const { return lapx<T>(c, ub, j, c.px(i)); }
  __device__ T Dgu(int j, int i) const { return lapx<T>(c, DU, j, c.px(i)); }
  __device__ T DgDV(int j, int i) const {
    return lapx<T>(c, DV, j, c.px(i));
  }
  __device__ T gv(int j, int i) const { return lapx<T>(c, vb, j, c.px(i)); }
  __device__ T DgDU(int j, int i) const { return lapy<T>(c, DU, j, i); }
  // clamp rows 0 -> 1, Mj-1 -> Mj-2
  __device__ T gue(int j, int i) const {
    return lapy<T>(c, ub, c.ring_row(j), i);
  }
  // clamp rows 1 -> 2, Mj-1 -> Mj-2
  __device__ T gve(int j, int i) const {
    return lapy<T>(c, vb, c.ix.rv_row(j), i);
  }
  __device__ T Dgve(int j, int i) const {
    return lapy<T>(c, DV, c.ix.rv_row(j), i);
  }
  __device__ T quarter_prod(T a0, T a1, T ga0, T ga1, T b0, T b1, T gb0,
                            T gb1) const {
    return mul_rn(T(0.25) * (a0 + a1 - mul_rn(c.k.sixth, ga0 + ga1)),
                  b0 + b1 - mul_rn(c.k.sixth, gb0 + gb1));
  }
  __device__ T UFx(int j, int i) const {
    return quarter_prod(c.V(ub, j, i), c.V(ub, j, i + 1), gu(j, i),
                        gu(j, i + 1), c.V(DU, j, i), c.V(DU, j, i + 1),
                        Dgu(j, i), Dgu(j, i + 1));
  }
  __device__ T UFe(int j, int i) const {
    return quarter_prod(c.V(ub, j, i), c.V(ub, j - 1, i), gue(j, i),
                        gue(j - 1, i), c.V(DV, j, i), c.V(DV, j, i - 1),
                        DgDV(j, i), DgDV(j, i - 1));
  }
  __device__ T VFx(int j, int i) const {
    return quarter_prod(c.V(vb, j, i), c.V(vb, j, i - 1), gv(j, i),
                        gv(j, i - 1), c.V(DU, j, i), c.V(DU, j - 1, i),
                        DgDU(j, i), DgDU(j - 1, i));
  }
  __device__ T VFe(int j, int i) const {
    return quarter_prod(c.V(vb, j, i), c.V(vb, j + 1, i), gve(j, i),
                        gve(j + 1, i), c.V(DV, j, i), c.V(DV, j + 1, i),
                        Dgve(j, i), Dgve(j + 1, i));
  }

  // Coriolis and metric fluxes, ringed (raw value at the periodic lane)
  __device__ T UFxc(int j, int i) const {
    i = c.px(i);
    const T cff = mul_rn(T(0.5) * Dr(j, i), c.S(FOMN, j, i));
    return mul_rn(cff, c.V(vb, j, i) + c.V(vb, j + 1, i));
  }
  __device__ T VFec(int j, int i) const {
    i = c.px(i);
    const T cff = mul_rn(T(0.5) * Dr(j, i), c.S(FOMN, j, i));
    return mul_rn(cff, c.V(ub, j, i) + c.V(ub, j, i + 1));
  }
  __device__ void curv_terms(int j, int i, T& UF, T& VF) const {
    i = c.px(i);
    const T c1 = T(0.5) * (c.V(vb, j, i) + c.V(vb, j + 1, i));
    const T c2 = T(0.5) * (c.V(ub, j, i) + c.V(ub, j, i + 1));
    const T cff = Dr(j, i) * (mul_rn(c1, c.S(DNDX, j, i)) -
                              mul_rn(c2, c.S(DMDE, j, i)));
    UF = mul_rn(cff, c1);
    VF = mul_rn(cff, c2);
  }

  // harmonic viscosity stress factors, ringed
  __device__ T cff_r(int j, int i) const {
    i = c.px(i);
    auto upn_u = [&](int ii) {
      return mul_rn(c.S(PN, j, ii) + c.S(PN, j, ii - 1), c.V(ub, j, ii));
    };
    auto vpm_v = [&](int jj) {
      return mul_rn(c.S(PM, jj, i) + c.S(PM, jj - 1, i), c.V(vb, jj, i));
    };
    const T dxp = upn_u(i + 1) - upn_u(i);
    const T dyp = vpm_v(j + 1) - vpm_v(j);
    return c.S(VISC2_R, j, i) * Dr(j, i) * T(0.5) *
           (mul_rn(c.S(PMON_R, j, i), dxp) - mul_rn(c.S(PNOM_R, j, i), dyp));
  }
  __device__ T cff_p(int j, int i) const {
    i = c.px(i);
    auto vpn_v = [&](int ii) {
      return mul_rn(c.S(PN, j, ii) + c.S(PN, j - 1, ii), c.V(vb, j, ii));
    };
    auto upm_u = [&](int jj) {
      return mul_rn(c.S(PM, jj, i) + c.S(PM, jj, i - 1), c.V(ub, jj, i));
    };
    const T Drp = T(0.25) * (Dr(j, i) + Dr(j, i - 1) + Dr(j - 1, i) +
                             Dr(j - 1, i - 1));
    const T dxm = vpn_v(i) - vpn_v(i - 1);
    const T dym = upm_u(j) - upm_u(j - 1);
    return c.S(VISC2_P, j, i) * Drp * T(0.5) *
           (mul_rn(c.S(PMON_P, j, i), dxm) + mul_rn(c.S(PNOM_P, j, i), dym)) *
           c.S(PMASK, j, i);
  }
  __device__ T sq(int id, int j, int i) const {
    const T m = c.S(id, j, i);
    return m * m;
  }

  __device__ __forceinline__ void eval(int j, int i, T& ru, T& rv) const {
    ru = pg(j, i, 0, 1, ON_U);
    rv = pg(j, i, 1, 0, OM_V);
    if (c.k.uv_adv) {
      ru = ru - (UFx(j, i) - UFx(j, i - 1)) - (UFe(j + 1, i) - UFe(j, i));
      rv = rv - (VFx(j, i + 1) - VFx(j, i)) - (VFe(j, i) - VFe(j - 1, i));
    }
    if (c.k.uv_cor) {
      ru = ru + T(0.5) * (UFxc(j, i) + UFxc(j, i - 1));
      rv = rv - T(0.5) * (VFec(j, i) + VFec(j - 1, i));
    }
    if (c.k.curv) {
      T UF0, VF0, UFm, VFm, UFj, VFj;
      curv_terms(j, i, UF0, VF0);
      curv_terms(j, i - 1, UFm, VFm);
      curv_terms(j - 1, i, UFj, VFj);
      ru = ru + T(0.5) * (UF0 + UFm);
      rv = rv - T(0.5) * (VF0 + VFj);
    }
    if (c.k.visc) {
      const T upn = c.S(PN, j, i) + c.S(PN, j, i - 1);
      const T vpm = c.S(PM, j, i) + c.S(PM, j - 1, i);
      const T vpn = c.S(PN, j, i) + c.S(PN, j - 1, i);
      const T upm = c.S(PM, j, i) + c.S(PM, j, i - 1);
      // UFxv = on_r^2 cff_r, VFev = om_r^2 cff_r, UFev = om_p^2 cff_p,
      // VFxv = on_p^2 cff_p, each at its own point
      auto UFxv = [&](int jj, int ii) {
        return mul_rn(sq(ON_R, jj, ii), cff_r(jj, ii));
      };
      auto VFev = [&](int jj, int ii) {
        return mul_rn(sq(OM_R, jj, ii), cff_r(jj, ii));
      };
      auto UFev = [&](int jj, int ii) {
        return mul_rn(sq(OM_P, jj, ii), cff_p(jj, ii));
      };
      auto VFxv = [&](int jj, int ii) {
        return mul_rn(sq(ON_P, jj, ii), cff_p(jj, ii));
      };
      ru = ru + mul_rn(T(0.5) * upn, UFxv(j, i) - UFxv(j, i - 1)) +
           mul_rn(T(0.5) * upm, UFev(j + 1, i) - UFev(j, i));
      rv = rv + mul_rn(T(0.5) * vpn, VFxv(j, i + 1) - VFxv(j, i)) -
           mul_rn(T(0.5) * vpm, VFev(j, i) - VFev(j - 1, i));
    }
  }
};

// ---------------------------------------------------------------------------
// the three phases of a predictor (CORR = false) or corrector half-step,
// each at one point (j, i); a phase reads only what earlier phases wrote
// ---------------------------------------------------------------------------

// DUon, DVom of the flux state (_flux_state) and the fast-time averages
template <typename T, bool CORR, typename C>
__device__ __forceinline__ void flux_point(const C& c, int j, int i) {
  const int Zf = CORR ? ZETA_P : ZETA;
  const int ii = c.px(i);
  auto Dr = [&](int jj, int i2) { return c.V(Zf, jj, i2) + c.S(H, jj, i2); };
  const T DU = mul_rn(
      c.V(CORR ? UBAR_P : UBAR, j, ii) * (T(0.5) * (Dr(j, ii) + Dr(j, ii - 1))),
      c.S(ON_U, j, ii));
  const T DV = mul_rn(
      c.V(CORR ? VBAR_P : VBAR, j, ii) * (T(0.5) * (Dr(j, ii) + Dr(j - 1, ii))),
      c.S(OM_V, j, ii));
  c.F(DUON, j, i) = DU;
  c.F(DVOM, j, i) = DV;
  if (!c.ix.own(j, i)) return;
  if (CORR) {
    const T A2c = c.tab_at(3);
    c.F(DU2, j, i) = c.V(DU2, j, i) + mul_rn(A2c, DU);
    c.F(DV2, j, i) = c.V(DV2, j, i) + mul_rn(A2c, DV);
  } else if (c.first()) {
    const T A2p = c.tab_at(2);
    c.F(ZT, j, i) = T(0) * c.V(ZETA, j, i);
    c.F(DU1, j, i) = T(0) * DU;
    c.F(DV1, j, i) = T(0) * DV;
    c.F(DU2, j, i) = A2p * DU;
    c.F(DV2, j, i) = A2p * DV;
  } else {
    const T A1 = c.tab_at(1), A2p = c.tab_at(2);
    c.F(ZT, j, i) = c.V(ZT, j, i) + mul_rn(A1, c.V(ZETA, j, i));
    c.F(DU1, j, i) = c.V(DU1, j, i) + mul_rn(A1, DU);
    c.F(DV1, j, i) = c.V(DV1, j, i) + mul_rn(A1, DV);
    c.F(DU2, j, i) = c.V(DU2, j, i) + mul_rn(A2p, DU);
    c.F(DV2, j, i) = c.V(DV2, j, i) + mul_rn(A2p, DV);
  }
}

// free surface: pre-BC zeta_new and zwrk at (j, i); predictor rhs_zeta
template <typename T, bool CORR, typename C>
__device__ __forceinline__ void zeta_raw(const C& c, int j, int i, T& zn,
                                         T& zw, T& rhs) {
  rhs = (c.V(DUON, j, i) - c.V(DUON, j, i + 1)) +
        (c.V(DVOM, j, i) - c.V(DVOM, j + 1, i));
  const T pmn = c.S(PM, j, i) * c.S(PN, j, i);
  const T zeta = c.V(ZETA, j, i);
  if (c.first()) {
    zn = zeta + mul_rn(pmn * c.k.dtf, rhs);
    zw = T(0.5) * (zeta + zn);
  } else if (!CORR) {
    const T zp = c.V(ZETA_PREV, j, i);
    zn = zp + mul_rn(pmn * c.k.dtf2, rhs);
    zw = mul_rn(c.k.cff5p, zeta) + mul_rn(c.k.cff4p, zp + zn);
  } else {
    const T f = mul_rn(c.k.s5, rhs) + mul_rn(c.k.s8, c.V(RZ_M, j, i)) -
                mul_rn(c.k.s1, c.V(RZ_PREV, j, i));
    zn = zeta + mul_rn(pmn, f);
    zw = mul_rn(c.k.cff5c, zn) + mul_rn(c.k.cff4c, c.V(ZETA_P, j, i));
  }
}

template <typename T, bool CORR, typename C>
__device__ __forceinline__ void zeta_point(const C& c, int j, int i) {
  T zn, zw, rhs;
  zeta_raw<T, CORR>(c, j, i, zn, zw, rhs);
  if (!CORR && c.ix.keep(j, i)) c.F(RZ_M, j, i) = rhs;
  c.F(ZWRK, j, i) = zw;
  // bc_rho: ring rows copy their inner neighbour, lanes the periodic ones
  const int sj = c.ring_row(j);
  const int si = c.px(i);
  if (sj != j || si != i) zeta_raw<T, CORR>(c, sj, si, zn, zw, rhs);
  c.F(CORR ? ZETA_PREV : ZETA_P, j, i) = zn * c.S(RMASK, sj, si);
}

template <typename T>
struct MomPt {
  T ru, rv;     // predictor: rhs + forcing (ru_m, rv_m)
  T fu, fv;     // predictor: rufrc_c, rvfrc_c
  T un, vn;     // masked, pre-BC ubar/vbar
};

template <typename T, bool CORR, typename C>
__device__ __forceinline__ MomPt<T> mom_raw(const C& c, int j, int i) {
  const Rhs<T, C> R{c, CORR ? UBAR_P : UBAR, CORR ? VBAR_P : VBAR, DUON, DVOM,
                    CORR ? ZETA_P : ZETA};
  MomPt<T> p;
  T hu, hv;
  R.eval(j, i, hu, hv);
  // new depth: predictor zeta_p, corrector zeta_c (in the ZETA_PREV plane)
  const int Zn = CORR ? ZETA_PREV : ZETA_P;
  auto Dn = [&](int jj, int ii) { return c.V(Zn, jj, ii) + c.S(H, jj, ii); };
  const T Du_new = Dn(j, i) + Dn(j, i - 1);
  const T Dv_new = Dn(j, i) + Dn(j - 1, i);
  const T pmn4_u = (c.S(PM, j, i) + c.S(PM, j, i - 1)) *
                   (c.S(PN, j, i) + c.S(PN, j, i - 1));
  const T pmn4_v = (c.S(PM, j, i) + c.S(PM, j - 1, i)) *
                   (c.S(PN, j, i) + c.S(PN, j - 1, i));
  const bool first = c.first();
  if (!CORR) {
    T cffdt;
    int Zs, Us, Vs;
    if (first) {
      p.fu = c.V(RUFRC, j, i) - hu;
      p.fv = c.V(RVFRC, j, i) - hv;
      const T a1 = c.tab_at(4), a2 = c.tab_at(5), a3 = c.tab_at(6);
      p.ru = hu + (mul_rn(a1, p.fu) - mul_rn(a2, c.S(RU0, j, i)) +
                   mul_rn(a3, c.S(RU0P2, j, i)));
      p.rv = hv + (mul_rn(a1, p.fv) - mul_rn(a2, c.S(RV0, j, i)) +
                   mul_rn(a3, c.S(RV0P2, j, i)));
      cffdt = c.k.half;
      Zs = ZETA, Us = UBAR, Vs = VBAR;
    } else {
      p.fu = c.V(RUFRC, j, i);
      p.fv = c.V(RVFRC, j, i);
      p.ru = hu + p.fu;
      p.rv = hv + p.fv;
      cffdt = c.k.dtf;
      Zs = ZETA_PREV, Us = UBAR_PREV, Vs = VBAR_PREV;
    }
    auto Ds = [&](int jj, int ii) { return c.V(Zs, jj, ii) + c.S(H, jj, ii); };
    const T Du_stp = Ds(j, i) + Ds(j, i - 1);
    const T Dv_stp = Ds(j, i) + Ds(j - 1, i);
    p.un = (mul_rn(c.V(Us, j, i), Du_stp) + mul_rn(pmn4_u * cffdt, p.ru)) /
           Du_new * c.S(UMASK, j, i);
    p.vn = (mul_rn(c.V(Vs, j, i), Dv_stp) + mul_rn(pmn4_v * cffdt, p.rv)) /
           Dv_new * c.S(VMASK, j, i);
  } else {
    hu = hu + c.V(RUFRC, j, i);
    hv = hv + c.V(RVFRC, j, i);
    T tu, tv;
    if (first) {
      tu = c.k.half * hu;
      tv = c.k.half * hv;
    } else {
      tu = c.k.half * (mul_rn(c.k.c5, hu) + mul_rn(c.k.c8, c.V(RU_M, j, i)) -
                       mul_rn(c.k.c1, c.V(RU_PREV, j, i)));
      tv = c.k.half * (mul_rn(c.k.c5, hv) + mul_rn(c.k.c8, c.V(RV_M, j, i)) -
                       mul_rn(c.k.c1, c.V(RV_PREV, j, i)));
    }
    auto Ds = [&](int jj, int ii) { return c.V(ZETA, jj, ii) + c.S(H, jj, ii); };
    const T Du_stp = Ds(j, i) + Ds(j, i - 1);
    const T Dv_stp = Ds(j, i) + Ds(j - 1, i);
    p.un = (mul_rn(c.V(UBAR, j, i), Du_stp) + mul_rn(pmn4_u, tu)) / Du_new *
           c.S(UMASK, j, i);
    p.vn = (mul_rn(c.V(VBAR, j, i), Dv_stp) + mul_rn(pmn4_v, tv)) / Dv_new *
           c.S(VMASK, j, i);
  }
  return p;
}

// the predictor's outputs at the point itself: rhs + forcing, and on the
// first substep the forcing rufrc_c
template <typename T, bool CORR, typename C>
__device__ __forceinline__ void mom_store_own(const C& c, int j, int i,
                                              const MomPt<T>& own) {
  if (!CORR) {
    c.F(RU_M, j, i) = own.ru;
    c.F(RV_M, j, i) = own.rv;
    if (c.first()) {
      c.F(RUFRC_N, j, i) = own.fu;
      c.F(RVFRC_N, j, i) = own.fv;
    }
  }
}

// bc_u: closed N/S walls hold gamma2 * the inner row; bc_v: rows 0, 1
// and Mj-1 zero; both take the periodic lanes.  un(j, i) and vn(j, i)
// give the masked, pre-BC ubar and vbar of the point the BC copies from.
template <typename T, bool CORR, typename C, typename U, typename V>
__device__ __forceinline__ void mom_bc(const C& c, int j, int i, U un,
                                       V vn) {
  const int sj = c.ring_row(j);
  const int si = c.px(i);
  T u = un(sj, si);
  if (sj != j) u = c.k.gamma2 * u;
  T v = T(0);
  const int g = c.ix.grow(j);
  if (g != 0 && g != 1 && g != c.Mj() - 1) v = vn(j, si);
  c.F(CORR ? UBAR_PREV : UBAR_P, j, i) = u;
  c.F(CORR ? VBAR_PREV : VBAR_P, j, i) = v;
}

// momentum at one point, the BC sources evaluated where they are needed
template <typename T, bool CORR, typename C>
__device__ __forceinline__ void mom_point(const C& c, int j, int i) {
  const MomPt<T> own = mom_raw<T, CORR>(c, j, i);
  mom_store_own<T, CORR>(c, j, i, own);
  mom_bc<T, CORR>(
      c, j, i,
      [&](int sj, int si) {
        return (sj == j && si == i) ? own.un : mom_raw<T, CORR>(c, sj, si).un;
      },
      [&](int sj, int si) {
        return si == i ? own.vn : mom_raw<T, CORR>(c, sj, si).vn;
      });
}

}  // namespace step2d
}  // namespace roms
