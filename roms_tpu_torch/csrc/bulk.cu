// Kernel 13: COARE 3.0 bulk air-sea fluxes (Fairall et al. 1996/2003,
// bulk_flux.F open-water path) at rho points, and the stresses staggered
// to U and V points.
//
// Replaces roms_tpu/ops/pallas_bulk.py:41 bulk_flux_pallas (pallas_call
// at l.57); block math core/bulk_flux.py bulk_flux_rho, then
// stagger_stress (roms_tpu staggers outside its kernel; here one C entry
// does both).  Plain version ops/bulk.py bulk_flux_plain.
//
// Bound on the H100: the instructions it issues.  It moves ~60 bytes a
// point (11 planes in, 4 out) but computes ~20 transcendentals and ~25
// IEEE divisions a point, each many instructions (chip_smoke.py counts
// the issue floor from the built kernel's SASS).
//
// Design: one thread per (j, i) point, consecutive threads on
// consecutive i; the three Monin-Obukhov passes are unrolled in
// registers.  Built without fast math, so expf/logf/powf/sqrtf are the
// libdevice functions PyTorch's own CUDA kernels call, and every product
// that feeds an add or subtract is mul_rn, so each value rounds as in the
// plain version, where every operation is its own kernel.  The plain
// version's conventions are kept: a tensor is never divided by a
// constant (it is multiplied by the reciprocal), and integer powers are
// products.  atan is roms_tpu's polynomial (_arctan), not atanf.  What
// the plain version computes twice from equal inputs is computed once:
// with blk_zt == blk_zq (kSameTQ) the humidity's stability function and
// its log(zq/ZoQ) are the temperature's, and psiu/psit take only the
// branch of the point's regime, where the plain version builds both and
// selects one.
//
// The stresses go to U and V points in a second kernel: bulk_kernel writes
// the rho-point stresses to two scratch planes, and stagger_kernel,
// launched after it on the same stream by the same C entry, forms
// sustr = 0.5*(Taux + im1(Taux))*(1/rho0) and svstr likewise with jm1,
// both rolls wrapping as torch.roll wraps.  The products are mul_rn in the
// plain version's order (add, times 0.5, times 1/rho0 rounded to T as
// PyTorch rounds a Python scalar).
#include "common.cuh"

namespace {

using roms::mul_rn;
using roms::wrap;

constexpr double STEFBO = 5.67e-8, EMMISS = 0.97, RHOW = 1000.0;
constexpr double BLK_CPA = 1004.67, BLK_CPW = 4000.0, BLK_RGAS = 287.1;
constexpr double BLK_ZABL = 600.0, BLK_BETA = 1.2;
constexpr double EPS = 1.0e-20;
constexpr double PI = 3.141592653589793;
constexpr double S3 = 1.7320508075688772;   // sqrt(3)
constexpr int kMaxThreads = 512;

struct BulkParams {
  int cool_skin, coare35;
  double rho0, Cp, g, vonKar, zw, zt, zq;
  double o_ribcu;           // 1/Ribcu, as the plain version's Python float
  double Fc;                // cool-skin Fc (bulk_flux.F), from Python
};

// the eleven input planes, in the order of the C entry
template <typename T>
struct BulkIn {
  const T *Uwind, *Vwind, *Tair, *Pair, *Hair, *cloud, *rain, *srflx, *sst,
      *sss, *rho_surf;
};

// what one point gives: the rho-point stresses and the surface fluxes
template <typename T>
struct BulkOut {
  T taux, tauy, stT, stS;
};

template <typename T>
__device__ __forceinline__ T mn(T a, T b) { return a < b ? a : b; }
template <typename T>
__device__ __forceinline__ T mx(T a, T b) { return a > b ? a : b; }
template <typename T>
__device__ __forceinline__ T sgn(T x) {
  return x > T(0) ? T(1) : (x < T(0) ? T(-1) : T(0));
}

// core/bulk_flux.py _arctan
template <typename T>
__device__ T arctan(T x) {
  const T s = sgn(x);
  T t = fabs(x);
  const bool big = t > T(1.0);
  if (big) t = T(1.0) / mx(t, T(1.0e-30));
  const bool fold = t > T(0.4142135623730951);
  const T u = fold ? (t - T(1.0)) / (t + T(1.0)) : t;
  const T u2 = mul_rn(u, u);
  T p = mul_rn(T(-1.0 / 15.0), u2) + T(1.0 / 13.0);
  p = mul_rn(p, u2) + T(-1.0 / 11.0);
  p = mul_rn(p, u2) + T(1.0 / 9.0);
  p = mul_rn(p, u2) + T(-1.0 / 7.0);
  p = mul_rn(p, u2) + T(1.0 / 5.0);
  p = mul_rn(p, u2) + T(-1.0 / 3.0);
  p = mul_rn(p, u2) + T(1.0);
  T a = mul_rn(u, p);
  if (fold) a = T(0.25 * PI) + a;
  if (big) a = T(0.5 * PI) - a;
  return mul_rn(s, a);
}

template <typename T>
__device__ __forceinline__ T psi_convective(T y) {
  return mul_rn(T(1.5), log(mul_rn(T(1.0 / 3.0), T(1.0) + y + mul_rn(y, y))))
         - mul_rn(T(S3), arctan(mul_rn(T(1.0) + mul_rn(T(2.0), y),
                                       T(1.0 / S3))))
         + T(PI / S3);
}

template <typename T>
__device__ __forceinline__ T psi_stable_tail(T ZoL) {
  const T cff = mn(mul_rn(T(0.35), ZoL), T(50.0));
  return mul_rn(T(0.6667), ZoL - T(14.28)) / exp(cff);
}

// bulk_flux.F:1465-1528; the plain version's torch.where(ZoL < 0, ...)
template <typename T>
__device__ T psiu(T ZoL) {
  if (ZoL < T(0.0)) {
    const T x = pow(mx(T(1.0) - mul_rn(T(15.0), ZoL), T(EPS)), T(0.25));
    const T psik = mul_rn(T(2.0), log(mul_rn(T(0.5), T(1.0) + x)))
                   + log(mul_rn(T(0.5), T(1.0) + mul_rn(x, x)))
                   - mul_rn(T(2.0), arctan(x)) + T(0.5 * PI);
    const T y = pow(mx(T(1.0) - mul_rn(T(10.15), ZoL), T(EPS)),
                    T(1.0 / 3.0));
    const T psic = psi_convective(y);
    const T z2 = mul_rn(ZoL, ZoL);
    const T Fw = z2 / (T(1.0) + z2);
    return mul_rn(T(1.0) - Fw, psik) + mul_rn(Fw, psic);
  }
  return -((T(1.0) + ZoL) + psi_stable_tail(ZoL) + T(8.525));
}

// bulk_flux.F:1530-1592
template <typename T>
__device__ T psit(T ZoL) {
  if (ZoL < T(0.0)) {
    const T x = sqrt(mx(T(1.0) - mul_rn(T(15.0), ZoL), T(EPS)));
    const T psik = mul_rn(T(2.0), log(mul_rn(T(0.5), T(1.0) + x)));
    const T y = pow(mx(T(1.0) - mul_rn(T(34.15), ZoL), T(EPS)),
                    T(1.0 / 3.0));
    const T psic = psi_convective(y);
    const T z2 = mul_rn(ZoL, ZoL);
    const T Fw = z2 / (T(1.0) + z2);
    return mul_rn(T(1.0) - Fw, psik) + mul_rn(Fw, psic);
  }
  const T z15 = T(1.0) + mul_rn(T(2.0), ZoL);
  return -(mul_rn(z15, sqrt(mx(z15, T(0.0)))) + psi_stable_tail(ZoL) +
           T(8.525));
}

template <typename T>
__device__ __forceinline__ T sat_vapor(T TC, T Pair) {
  return mul_rn(mul_rn(T(1.0007) + mul_rn(T(3.46e-6), Pair), T(6.1121)),
                exp(mul_rn(T(17.502), TC) / (T(240.97) + TC)));
}

// COARE at the point c
template <typename T, bool kSameTQ>
__device__ __forceinline__ BulkOut<T> bulk_point(const BulkIn<T>& in, int c,
                                                 const BulkParams& p) {
  const T vonKar = T(p.vonKar);
  const T zw = T(p.zw), zt = T(p.zt), zq = T(p.zq);
  const T o_g = T(1.0 / p.g);
  const T Uw = in.Uwind[c], Vw = in.Vwind[c], Pair = in.Pair[c];
  const T RH = in.Hair[c], cl = in.cloud[c], rain = in.rain[c];
  const T sr = in.srflx[c], sss = in.sss[c];

  const T Wmag = sqrt(mul_rn(Uw, Uw) + mul_rn(Vw, Vw));
  const T TairC = in.Tair[c];
  const T TairK = TairC + T(273.16);
  const T TseaC = in.sst[c];
  const T TseaK = TseaC + T(273.16);
  const T SRad = mul_rn(sr, T(p.rho0 * p.Cp));

  // longwave (Berliand)
  const T cffl = (T(0.7859) + mul_rn(T(0.03477), TairC)) /
                 (T(1.0) + mul_rn(T(0.00412), TairC));
  const T e_sat = pow(T(10.0), cffl);
  const T vap_p = mul_rn(e_sat, RH < T(2.0) ? RH : mul_rn(RH, T(0.0))
                                                    + T(0.8));
  const T cff2 = mul_rn(mul_rn(TairK, TairK), TairK);
  const T cff1 = mul_rn(cff2, TairK);
  const T LRad = mul_rn(
      T(-EMMISS * STEFBO),
      mul_rn(mul_rn(cff1, T(0.39) - mul_rn(T(0.05), sqrt(vap_p))),
             T(1.0) - mul_rn(mul_rn(T(0.6823), cl), cl)) +
          mul_rn(mul_rn(cff2, T(4.0)), TseaK - TairK));

  // humidities
  const T cffa = sat_vapor(TairC, Pair);
  const T Qair = mul_rn(T(0.62197), cffa) /
                 (Pair - mul_rn(T(0.378), cffa) + T(EPS));
  const T cffq = mul_rn(cffa, RH < T(2.0) ? RH : T(1.0));
  const T Q = RH < T(2.0) ? mul_rn(T(0.62197), cffq) /
                                (Pair - mul_rn(T(0.378), cffq) + T(EPS))
                          : mul_rn(RH, T(1.0 / 1000.0));
  const T cffs = mul_rn(sat_vapor(TseaC, Pair), T(0.98));
  const T Qsea = mul_rn(T(0.62197), cffs) / (Pair - mul_rn(T(0.378), cffs));
  const T q61 = T(1.0) + mul_rn(T(0.61), Q);
  const T rhoAir = mul_rn(Pair, T(100.0)) /
                   mul_rn(mul_rn(T(BLK_RGAS), TairK), q61);
  const T VisAir = mul_rn(
      T(1.326e-5),
      T(1.0) + mul_rn(TairC, T(6.542e-3) +
                                 mul_rn(TairC, T(8.301e-6) -
                                                   mul_rn(T(4.84e-9), TairC))));
  const T Hlv = mul_rn(T(2.501) - mul_rn(T(0.00237), TseaC), T(1.0e6));

  // first guesses (bulk_flux.F:735-800)
  T Wgus = T(0.5);
  T delW = sqrt(mul_rn(Wmag, Wmag) + mul_rn(Wgus, Wgus));
  const T delQ = Qsea - Q;
  const T delT = TseaC - TairC;
  const T ZoW0 = T(0.0001);
  const T u10 = mul_rn(delW, log(T(10.0) / ZoW0)) / log(zw / ZoW0);
  T Wstar = mul_rn(T(0.035), u10);
  const T Zo10 = mul_rn(mul_rn(mul_rn(T(0.011), Wstar), Wstar), o_g) +
                 mul_rn(T(0.11), VisAir) / Wstar;
  T Cd10 = vonKar / log(T(10.0) / Zo10);
  Cd10 = mul_rn(Cd10, Cd10);
  const T Ct10 = T(0.00115) / sqrt(Cd10);
  const T ZoT10 = T(10.0) / exp(vonKar / Ct10);
  T Cd = vonKar / log(zw / Zo10);
  Cd = mul_rn(Cd, Cd);
  const T Ct = vonKar / log(zt / ZoT10);
  const T CC = mul_rn(vonKar, Ct) / Cd;
  const T Ri = mul_rn(T(-p.g * p.zw),
                      delT + mul_rn(mul_rn(T(0.61), TairK), delQ)) /
               (mul_rn(mul_rn(TairK, delW), delW) + T(EPS));
  const T Zetu = Ri < T(0.0)
      ? mul_rn(CC, Ri) / (T(1.0) + mul_rn(Ri, T(p.o_ribcu)))
      : mul_rn(CC, Ri) / (T(1.0) + mul_rn(T(3.0), Ri) / CC);
  const T L10 = zw / Zetu;
  Wstar = mul_rn(delW, vonKar) / (log(zw / Zo10) - psiu(zw / L10));
  // with zt == zq, the humidity's denominator is the temperature's
  const T denT = log(zt / ZoT10) - psit(zt / L10);
  const T denQ = kSameTQ ? denT : log(zq / ZoT10) - psit(zq / L10);
  T Tstar = mul_rn(-delT, vonKar) / denT;
  T Qstar = mul_rn(-delQ, vonKar) / denQ;

  T charn;
  if (p.coare35) {
    charn = mn(T(-0.005) + mul_rn(T(0.0017), delW), T(0.028));
  } else {
    charn = delW > T(18.0) ? T(0.018)
          : (delW > T(10.0) ? T(0.011) + mul_rn(T(0.125 * (0.018 - 0.011)),
                                                 delW - T(10.0))
                            : T(0.011));
  }
  T delTc = T(0), delQc = T(0);
  T Cwet = T(0), Tcff = T(0), Scff = T(0), rhoSea = T(0);
  if (p.cool_skin) {
    Cwet = mul_rn(mul_rn(T(0.622), Hlv), Qsea) /
           mul_rn(T(BLK_RGAS), mul_rn(TseaK, TseaK));
    Tcff = mul_rn(T(2.1e-5), pow(mx(TseaC + T(3.2), T(0.0)), T(0.79)));
    Scff = mul_rn(T(0.026) /
                      (T(1.0) - mul_rn(mul_rn(T(0.026), sss), T(1.0 / 34.0))
                       + T(EPS)),
                  T(0.0)) + T(0.026);
    rhoSea = T(p.rho0) + in.rho_surf[c];
  }

  // Monin-Obukhov iteration (IterMax=3)
#pragma unroll
  for (int it = 0; it < 3; ++it) {
    const T ZoW = mul_rn(mul_rn(mul_rn(charn, Wstar), Wstar), o_g) +
                  mul_rn(T(0.11), VisAir) / (Wstar + T(EPS));
    const T Rr = mul_rn(ZoW, Wstar) / VisAir;
    const T ZoQ = mn(T(5.5e-5) / pow(Rr, T(0.6)), T(1.15e-4));
    const T ZoT = ZoQ;
    const T ZoL = mul_rn(T(p.vonKar * p.g * p.zw),
                         mul_rn(Tstar, q61) +
                             mul_rn(mul_rn(T(0.61), TairK), Qstar)) /
                  (mul_rn(mul_rn(mul_rn(TairK, Wstar), Wstar), q61) + T(EPS));
    const T L = zw / (ZoL + T(EPS));
    const T Wpsi = psiu(ZoL);
    const T dT = log(zt / ZoT) - psit(zt / L);
    const T dQ = kSameTQ ? dT : log(zq / ZoQ) - psit(zq / L);
    Wstar = mx(mul_rn(delW, vonKar) / (log(zw / ZoW) - Wpsi), T(EPS));
    Tstar = mul_rn(-(delT - delTc), vonKar) / dT;
    Qstar = mul_rn(-(delQ - delQc), vonKar) / dQ;
    const T Bf = mul_rn(mul_rn(T(-p.g) / TairK, Wstar),
                        Tstar + mul_rn(mul_rn(T(0.61), TairK), Qstar));
    Wgus = Bf > T(0.0)
        ? mul_rn(T(BLK_BETA), pow(mx(mul_rn(Bf, T(BLK_ZABL)), T(EPS)),
                                  T(1.0 / 3.0)))
        : T(0.2);
    delW = sqrt(mul_rn(Wmag, Wmag) + mul_rn(Wgus, Wgus));
    if (p.cool_skin) {
      // cool-skin correction (bulk_flux.F:894-938)
      const double visw = 1.0e-6, tcw = 0.6;
      const T rv = mul_rn(rhoSea, T(visw));
      const T Clam = mul_rn(T(16.0 * p.g * BLK_CPW), mul_rn(mul_rn(rv, rv),
                                                            rv)) /
                     mul_rn(mul_rn(T(tcw * tcw), rhoAir), rhoAir);
      const T Hsb = mul_rn(mul_rn(mul_rn(-rhoAir, T(BLK_CPA)), Wstar), Tstar);
      const T Hlb = mul_rn(mul_rn(mul_rn(-rhoAir, Hlv), Wstar), Qstar);
      const T Qcool = LRad + Hsb + Hlb - mul_rn(SRad, T(p.Fc));
      const T Qbouy = mul_rn(Tcff, Qcool) +
                      mul_rn(mul_rn(Scff, Hlb), T(BLK_CPW)) / Hlv;
      const T w2 = mul_rn(Wstar + T(EPS), Wstar + T(EPS));
      const T lambd = T(6.0) /
          pow(T(1.0) + pow(mul_rn(Clam, mx(Qbouy, T(0.0))) / mul_rn(w2, w2),
                           T(0.75)),
              T(1.0 / 3.0));
      const T Hc = mul_rn(lambd, T(visw)) /
                   (mul_rn(sqrt(rhoAir / rhoSea), Wstar) + T(EPS));
      delTc = (Qcool > T(0.0) && Qbouy > T(0.0))
                  ? mul_rn(mul_rn(Qcool, Hc), T(1.0 / tcw)) : T(0.0);
      delQc = mul_rn(Cwet, delTc);
    }
  }

  // fluxes (bulk_flux.F:900-1010)
  const T Hs = mul_rn(mul_rn(mul_rn(T(-BLK_CPA), rhoAir), Wstar), Tstar);
  const T diffw = mul_rn(T(2.11e-5),
                         pow(mul_rn(TairK, T(1.0 / 273.16)), T(1.94)));
  const T diffh = mul_rn(T(0.02411),
                         T(1.0) + mul_rn(TairC, T(3.309e-3) -
                                                    mul_rn(T(1.44e-6), TairC)))
                  / (mul_rn(rhoAir, T(BLK_CPA)) + T(EPS));
  const T cffw = mul_rn(Qair, Hlv) /
                 mul_rn(mul_rn(T(BLK_RGAS), TairK), TairK);
  const T wet_bulb = T(1.0) /
      (T(1.0) + mul_rn(T(0.622), mul_rn(mul_rn(cffw, Hlv), diffw)) /
                    mul_rn(T(BLK_CPA), diffh));
  const T Hsr = mul_rn(mul_rn(mul_rn(fabs(rain), wet_bulb), T(BLK_CPW)),
                       delT + mul_rn(mul_rn(delQ, Hlv), T(1.0 / BLK_CPA)));
  const T SHeat = Hs + Hsr;
  const T Hl = mul_rn(mul_rn(mul_rn(-Hlv, rhoAir), Wstar), Qstar);
  const T upvel = mul_rn(mul_rn(T(-1.61), Wstar), Qstar) -
                  mul_rn(mul_rn(T(1.0) + mul_rn(T(1.61), Q), Wstar), Tstar) /
                      TairK;
  const T Hlw = mul_rn(mul_rn(mul_rn(rhoAir, Hlv), upvel), Q);
  const T LHeat = Hl + Hlw;
  const T Taur = mul_rn(mul_rn(T(0.85), fabs(rain)), Wmag);
  const T cfft = mul_rn(rhoAir, mul_rn(Wstar, Wstar) + Taur / rhoAir) /
                 (Wmag + T(EPS));
  BulkOut<T> o;
  o.taux = mul_rn(cfft, Uw);
  o.tauy = mul_rn(cfft, Vw);
  const T oH = T(1.0 / (p.rho0 * p.Cp));
  const T lrflx = mul_rn(LRad, oH);
  const T lhflx = mul_rn(-LHeat, oH);
  const T shflx = mul_rn(-SHeat, oH);
  o.stT = sr + lrflx + lhflx + shflx;
  const T evap = LHeat / (Hlv + T(EPS));
  o.stS = mul_rn(mul_rn(evap - rain, sss), T(1.0 / RHOW));
  return o;
}

// stagger_stress at one point: 0.5 * (a + a_west_or_south) * (1/rho0)
template <typename T>
__device__ __forceinline__ T stagger(T a, T b, T o_rho0) {
  return mul_rn(mul_rn(T(0.5), a + b), o_rho0);
}

// first kernel: the rho-point stresses to scratch planes
template <typename T, bool kSameTQ>
__global__ void __launch_bounds__(kMaxThreads)
bulk_kernel(const __grid_constant__ BulkIn<T> in, T* __restrict__ taux,
            T* __restrict__ tauy, T* __restrict__ stT, T* __restrict__ stS,
            int P, const __grid_constant__ BulkParams p) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= P) return;
  const BulkOut<T> o = bulk_point<T, kSameTQ>(in, c, p);
  taux[c] = o.taux;
  tauy[c] = o.tauy;
  stT[c] = o.stT;
  stS[c] = o.stS;
}

// second kernel: the stresses to U and V points
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
stagger_kernel(const T* __restrict__ taux, const T* __restrict__ tauy,
               T* __restrict__ sustr, T* __restrict__ svstr, int Mj, int Li,
               double rho0) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= Mj * Li) return;
  const int j = c / Li, i = c - j * Li;
  const T o_rho0 = T(1.0 / rho0);
  sustr[c] = stagger(taux[c], taux[j * Li + wrap(i - 1, Li)], o_rho0);
  svstr[c] = stagger(tauy[c], tauy[wrap(j - 1, Mj) * Li + i], o_rho0);
}

template <typename T, bool kSameTQ>
int launch(const BulkIn<T>& in, T* taux, T* tauy, T* sustr, T* svstr,
           T* stT, T* stS, int Mj, int Li, int threads, const BulkParams& p,
           cudaStream_t st) {
  if (threads < 32 || threads > kMaxThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  const int P = Mj * Li;
  const int blocks = (P + threads - 1) / threads;
  bulk_kernel<T, kSameTQ><<<blocks, threads, 0, st>>>(in, taux, tauy, stT,
                                                      stS, P, p);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  stagger_kernel<T><<<blocks, threads, 0, st>>>(taux, tauy, sustr, svstr, Mj,
                                                Li, p.rho0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// threads a block for both kernels; taux and tauy are scratch planes for
// the rho-point stresses.  With zt == zq the humidity shares the
// temperature's stability function (kSameTQ).
#define ROMS_BULK_ENTRY(NAME, T)                                             \
  extern "C" int NAME(const void* Uwind, const void* Vwind,                 \
                      const void* Tair, const void* Pair, const void* Hair, \
                      const void* cloud, const void* rain,                  \
                      const void* srflx, const void* sst, const void* sss,  \
                      const void* rho_surf, void* taux, void* tauy,         \
                      void* sustr, void* svstr, void* stT, void* stS,       \
                      int Mj, int Li, int threads, int cool_skin,           \
                      int coare35, double rho0, double Cp, double g,        \
                      double vonKar, double zw, double zt, double zq,       \
                      double o_ribcu, double Fc, void* stream) {            \
    const BulkIn<T> in{                                                     \
        static_cast<const T*>(Uwind), static_cast<const T*>(Vwind),         \
        static_cast<const T*>(Tair),  static_cast<const T*>(Pair),          \
        static_cast<const T*>(Hair),  static_cast<const T*>(cloud),         \
        static_cast<const T*>(rain),  static_cast<const T*>(srflx),         \
        static_cast<const T*>(sst),   static_cast<const T*>(sss),           \
        static_cast<const T*>(rho_surf)};                                   \
    const BulkParams p{cool_skin, coare35, rho0, Cp, g, vonKar, zw, zt, zq, \
                       o_ribcu, Fc};                                        \
    T* const out[6] = {static_cast<T*>(taux),  static_cast<T*>(tauy),       \
                       static_cast<T*>(sustr), static_cast<T*>(svstr),      \
                       static_cast<T*>(stT),   static_cast<T*>(stS)};       \
    cudaStream_t st = static_cast<cudaStream_t>(stream);                    \
    return zt == zq ? launch<T, true>(in, out[0], out[1], out[2], out[3],   \
                                      out[4], out[5], Mj, Li, threads, p,   \
                                      st)                                   \
                    : launch<T, false>(in, out[0], out[1], out[2], out[3],  \
                                       out[4], out[5], Mj, Li, threads, p,  \
                                       st);                                 \
  }

ROMS_BULK_ENTRY(roms_bulk_flux_f32, float)
ROMS_BULK_ENTRY(roms_bulk_flux_f64, double)
