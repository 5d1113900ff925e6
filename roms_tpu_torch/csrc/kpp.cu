// Kernels 14 and 15: the LMD-KPP column closure (lmd_vmix.F interior
// mixing, lmd_skpp.F surface boundary layer, LMD_NONLOCAL), alone (KPP
// mode) or after the column EOS of kernel 1 in the same thread (prep
// mode, template flag PREP).
//
// Replaces roms_tpu/ops/pallas_kpp.py:289 kpp_pallas (pallas_call at
// l.323; block math kpp_block l.89-270) and roms_tpu/ops/pallas_prep.py:76
// prep_pallas (pallas_call at l.121).  Plain versions ops/kpp.py
// kpp_block and ops/prep.py prep_plain (rho_eos_plain, then kpp_block).
//
// Bound on the H100: bytes.  KPP mode reads u_r, v_r, pden, Hz (N), bvf,
// z_w (N+1) and 7 planes and writes Akv, Akt, ghT, ghS (N+1) and hsbl;
// prep mode reads t (NT N), z_r, Hz, u_r, v_r (N), z_w (N+1) and writes
// rho, pden (N), rhoA, rhoS and the KPP outputs.  A few hundred flops a
// level (two exp a level and the similarity pow calls) stay under the
// card's flop/byte balance.
//
// Design: one thread per (j, i) column, consecutive threads on
// consecutive i, so every k-plane load and store is coalesced.  N is a
// runtime value: the column arrays (pden, bvf, the Thomas coefficients
// and the three spline derivatives, the shortwave fractions) live in
// per-thread local arrays bounded by roms::kNmax, which the wrapper
// checks; in prep mode pden and bvf are filled by roms::eos_column
// (rho_col.cuh) and bvf never reaches device memory.  The bulk
// Richardson number is scanned upwards as it is computed: the largest k
// with FC[k] < Ric <= FC[k-1] wins, as in the reference's scan, so FC
// needs no array.
//
// Levels are picked by threshold tests (FC against Ric, z_w against
// hsbl, the signs of Bf and Bfsfc), so one rounding difference can move
// a column's boundary layer.  Every operation follows the plain version's
// order, every product that feeds an add or subtract is mul_rn (never
// contracted into an FMA), x**0.25 and x**(1/3) are pow as PyTorch
// computes them, and constant divisions are the plain version's
// reciprocal products, so the kernel rounds as the plain version does.
#include "rho_col.cuh"

namespace {

using roms::EosParams;
using roms::kNmax;
using roms::mul_rn;

// core/lmd.py (mod_scalars.F:1635-1712)
constexpr double EPS = 1.0e-10, SMALL = 1.0e-20;
constexpr double RI0 = 0.7, BVFCON = -2.0e-5, NU0C = 0.01;
constexpr double NU0M = 10.0e-4, NU0S = 10.0e-4, RIC = 0.3;
constexpr double AM = 1.257, AS = -28.86, CM = 8.36, CS = 98.96;
constexpr double CEKMAN = 0.7, CMONOB = 1.0, EPSILON = 0.1;
constexpr double ZETAM = -0.2, ZETAS = -1.0;
constexpr double C3 = 1.0 / 3.0, C6 = 1.0 / 6.0;

// derived constants, computed by the wrapper as the plain version does
// (ops/kpp.py kpp_params)
struct KppParams {
  double akv_bak, akt_bak0;   // background at the end interfaces
  double r1, o_mu1, o_mu2;    // Jerlov water type
  double neg_gorho0, Vtc, Cg, vonKar;
};

template <typename T>
struct KppArgs {
  const T* t;                 // prep mode
  const T* z_r;               // prep mode
  const T* u_r;
  const T* v_r;
  const T* pden_in;           // KPP mode
  const T* bvf_in;            // KPP mode
  const T* Hz;
  const T* z_w;
  const T* Ustar;
  const T* Bo;
  const T* Bosol;
  const T* absf;
  const T* flxT;
  const T* flxS;
  const T* srflx;
  T* rho;                     // prep mode
  T* pden;                    // prep mode
  T* rhoA;                    // prep mode
  T* rhoS;                    // prep mode
  T* Akv;
  T* Akt;
  T* ghT;
  T* ghS;
  T* hsbl;
};

template <typename T>
__device__ __forceinline__ T mn(T a, T b) { return a < b ? a : b; }
template <typename T>
__device__ __forceinline__ T mx(T a, T b) { return a > b ? a : b; }

// eos_column sink of the prep mode: rho and pden to device memory, pden
// and bvf kept in the thread
template <typename T>
struct KeepColumn {
  T* rho;
  T* pden;
  int P, c;
  T* pd;
  T* bv;
  __device__ void level(int k, T r, T p_) {
    const size_t o = static_cast<size_t>(k) * P + c;
    rho[o] = r;
    pden[o] = p_;
    pd[k] = p_;
  }
  __device__ void interface(int k, T b) { bv[k] = b; }
};

// fraction of shortwave left at depth (core/lmd.py swdk_frac)
template <typename T>
__device__ __forceinline__ T swdk(T depth, const KppParams& p) {
  return mul_rn(T(p.r1), exp(mul_rn(-depth, T(p.o_mu1)))) +
         mul_rn(T(1.0 - p.r1), exp(mul_rn(-depth, T(p.o_mu2))));
}

// turbulent velocity scales (core/lmd.py _wscale)
template <typename T>
__device__ void wscale(T Ustar, T zetahat, T vonKar, T& wm, T& ws) {
  const T U3 = mul_rn(mul_rn(Ustar, Ustar), Ustar);
  const T zetapar = zetahat / (U3 + T(SMALL));
  const T wm_stab = mul_rn(vonKar, Ustar) /
                    (T(1.0) + mul_rn(T(5.0), zetapar));
  const T one16 = mx(T(1.0) - mul_rn(T(16.0), zetapar), T(0.0));
  const T kU = mul_rn(vonKar, Ustar);
  const T wm_uns = zetapar > T(ZETAM)
      ? mul_rn(kU, pow(one16, T(0.25)))
      : mul_rn(vonKar, pow(mx(mul_rn(T(AM), U3) - mul_rn(T(CM), zetahat),
                              T(0.0)), T(1.0 / 3.0)));
  const T ws_uns = zetapar > T(ZETAS)
      ? mul_rn(kU, sqrt(one16))
      : mul_rn(vonKar, pow(mx(mul_rn(T(AS), U3) - mul_rn(T(CS), zetahat),
                              T(0.0)), T(1.0 / 3.0)));
  const bool stable = zetahat >= T(0.0);
  wm = stable ? wm_stab : wm_uns;
  ws = stable ? wm_stab : ws_uns;
}

// interior shear / internal-wave / convective mixing at interface k
// (lmd_vmix.F + lmd_finish)
template <typename T>
__device__ void interior_mix(T dU, T dV, T b, T& akv, T& akt) {
  const T shear2 = mul_rn(dU, dU) + mul_rn(dV, dV);
  const T Rig = b / (shear2 + T(EPS));
  const T cff = mn(mul_rn(mx(Rig, T(0.0)), T(1.0 / RI0)), T(1.0));
  T nu = T(1.0) - mul_rn(cff, cff);
  nu = mul_rn(mul_rn(nu, nu), nu);
  const T sh = b / (Rig + T(EPS));
  nu = mul_rn(mul_rn(nu, sh), sh) / (mul_rn(sh, sh) + T(16.0e-10));
  const T cffN = T(1.0) / sqrt(mx(b, T(1.0e-7)));
  akv = mul_rn(T(1.0e-6), cffN) + mul_rn(T(NU0M), nu);
  akt = mul_rn(T(1.0e-7), cffN) + mul_rn(T(NU0S), nu);
  T cffc = mx(b, T(BVFCON));
  cffc = mn(mul_rn(T(BVFCON) - cffc, T(1.0 / BVFCON)), T(1.0));
  T nuc = T(1.0) - mul_rn(cffc, cffc);
  nuc = mul_rn(mul_rn(nuc, nuc), nuc);
  akv = akv + mul_rn(T(NU0C), nuc);
  akt = akt + mul_rn(T(NU0C), nuc);
}

template <typename T, bool PREP>
__global__ void kpp_kernel(KppArgs<T> a, int NT, int N, int P, EosParams e,
                           KppParams p) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= P) return;
  const T vonKar = T(p.vonKar);
  T pd[kNmax], bv[kNmax + 1];
  if (PREP) {
    KeepColumn<T> sink{a.rho, a.pden, P, c, pd, bv};
    T A, S;
    roms::eos_column(a.t, a.z_r, a.Hz, a.z_w, NT, N, P, c, e, sink, A, S);
    bv[0] = T(0);
    bv[N] = T(0);
    a.rhoA[c] = A;
    a.rhoS[c] = S;
  } else {
    for (int k = 0; k < N; ++k)
      pd[k] = a.pden_in[static_cast<size_t>(k) * P + c];
    for (int k = 0; k <= N; ++k)
      bv[k] = a.bvf_in[static_cast<size_t>(k) * P + c];
  }
  const T* Hz = a.Hz + c;
  const T* zw = a.z_w + c;
  const T* ur = a.u_r + c;
  const T* vr = a.v_r + c;
  const size_t sP = static_cast<size_t>(P);

  // ---- spline derivatives: one Thomas factorization, three RHS --------
  // rows m = 0..N-2 (interfaces 1..N-1): lower Hz[m] (0 at m = 0),
  // diagonal 2 (Hz[m] + Hz[m+1]), upper Hz[m+1] (0 at m = N-2); the
  // sweep leaves the solution of row m in dR[m+1] (dR[0] = dR[N] = 0)
  T cp[kNmax], dR[kNmax + 1], dU[kNmax + 1], dV[kNmax + 1];
  const int M = N - 1;
  {
    const T hz0 = Hz[0], hz1 = Hz[sP];
    const T inv0 = T(1.0) / mul_rn(T(2.0), hz0 + hz1);
    cp[0] = mul_rn(M > 1 ? hz1 : T(0.0), inv0);
    dR[1] = mul_rn(mul_rn(T(6.0), pd[1] - pd[0]), inv0);
    dU[1] = mul_rn(mul_rn(T(6.0), ur[sP] - ur[0]), inv0);
    dV[1] = mul_rn(mul_rn(T(6.0), vr[sP] - vr[0]), inv0);
    for (int m = 1; m < M; ++m) {
      const T lo = Hz[m * sP], hn = Hz[(m + 1) * sP];
      const T denom = T(1.0) / (mul_rn(T(2.0), lo + hn) -
                                mul_rn(lo, cp[m - 1]));
      cp[m] = mul_rn(m < M - 1 ? hn : T(0.0), denom);
      dR[m + 1] = mul_rn(mul_rn(T(6.0), pd[m + 1] - pd[m]) -
                         mul_rn(lo, dR[m]), denom);
      dU[m + 1] = mul_rn(mul_rn(T(6.0), ur[(m + 1) * sP] - ur[m * sP]) -
                         mul_rn(lo, dU[m]), denom);
      dV[m + 1] = mul_rn(mul_rn(T(6.0), vr[(m + 1) * sP] - vr[m * sP]) -
                         mul_rn(lo, dV[m]), denom);
    }
    for (int m = M - 2; m >= 0; --m) {
      dR[m + 1] = dR[m + 1] - mul_rn(cp[m], dR[m + 2]);
      dU[m + 1] = dU[m + 1] - mul_rn(cp[m], dU[m + 2]);
      dV[m + 1] = dV[m + 1] - mul_rn(cp[m], dV[m + 2]);
    }
    dR[0] = dU[0] = dV[0] = T(0.0);
    dR[N] = dU[N] = dV[N] = T(0.0);
  }

  // ---- surface buoyancy forcing and shortwave at interfaces -----------
  const T Ustar = a.Ustar[c], Bo = a.Bo[c], Bosol = a.Bosol[c];
  const T zwN = zw[N * sP];
  T swd[kNmax + 1];
  for (int k = 0; k <= N; ++k) swd[k] = swdk(zwN - zw[k * sP], p);

  // ---- bulk Richardson number, scanned upwards (lmd_skpp.F) -----------
  const T hzt = Hz[(N - 1) * sP];
  const T Rref = pd[N - 1] + mul_rn(hzt, mul_rn(T(C3), dR[N]) +
                                            mul_rn(T(C6), dR[N - 1]));
  const T Uref = ur[(N - 1) * sP] + mul_rn(hzt, mul_rn(T(C3), dU[N]) +
                                                   mul_rn(T(C6), dU[N - 1]));
  const T Vref = vr[(N - 1) * sP] + mul_rn(hzt, mul_rn(T(C3), dV[N]) +
                                                   mul_rn(T(C6), dV[N - 1]));
  int kcross = 0;
  T FCk = T(0), FCkm1 = T(0), FCprev = T(0);
  for (int k = 0; k < N; ++k) {
    const T depth = zwN - zw[k * sP];
    const T Bf = Bo + mul_rn(Bosol, T(1.0) - swd[k]);
    const T sl0 = mul_rn(T(EPSILON), depth);
    const T sigma = Bf < T(0.0) ? mn(sl0, depth) : depth;
    T wm, ws;
    wscale(Ustar, mul_rn(mul_rn(vonKar, sigma), Bf), vonKar, wm, ws);
    const T hz = Hz[k * sP];
    const T Rk = pd[k] - mul_rn(hz, mul_rn(T(C3), dR[k]) +
                                        mul_rn(T(C6), dR[k + 1]));
    const T Uk = ur[k * sP] - mul_rn(hz, mul_rn(T(C3), dU[k]) +
                                             mul_rn(T(C6), dU[k + 1]));
    const T Vk = vr[k * sP] - mul_rn(hz, mul_rn(T(C3), dV[k]) +
                                             mul_rn(T(C6), dV[k + 1]));
    const T Ritop = mul_rn(mul_rn(T(p.neg_gorho0), Rref - Rk), depth);
    const T dUr = Uref - Uk, dVr = Vref - Vk;
    const T Ribot = mul_rn(dUr, dUr) + mul_rn(dVr, dVr) +
                    mul_rn(mul_rn(mul_rn(T(p.Vtc), depth), ws),
                           sqrt(fabs(bv[k])));
    const T FC = Ritop / (Ribot + T(EPS));
    if (k >= 2 && FC < T(RIC) && FCprev >= T(RIC)) {
      kcross = k;
      FCk = FC;
      FCkm1 = FCprev;
    }
    FCprev = FC;
  }
  if (FCprev >= T(RIC)) {      // k = N, where FC = 0
    kcross = N;
    FCk = T(0.0);
    FCkm1 = FCprev;
  }
  T hsbl;
  if (kcross >= 2) {
    const T zwk = zw[kcross * sP], zwkm1 = zw[(kcross - 1) * sP];
    hsbl = (mul_rn(FCkm1 - T(RIC), zwk) + mul_rn(T(RIC) - FCk, zwkm1)) /
           (FCkm1 - FCk + T(SMALL));
  } else {
    hsbl = zw[sP];
  }

  // ---- Ekman / Monin-Obukhov caps under stable forcing ----------------
  {
    const T Bfsfc = Bo + mul_rn(Bosol, T(1.0) - swdk(zwN - hsbl, p));
    const T hekman = mul_rn(T(CEKMAN), Ustar) / mx(a.absf[c], T(EPS));
    const T hmonob = mul_rn(T(CMONOB), mul_rn(mul_rn(Ustar, Ustar), Ustar)) /
                     mx(mul_rn(vonKar, Bfsfc), T(EPS));
    const T cap = zwN - mn(mn(hekman, hmonob), zwN - hsbl);
    if (Ustar > T(0.0) && Bfsfc > T(0.0)) hsbl = cap;
    hsbl = mn(mx(hsbl, zw[0]), zwN);
  }
  int ksbl = 0;
  for (int k = 0; k < N; ++k) ksbl += zw[k * sP] < hsbl ? 1 : 0;
  ksbl = ksbl > 1 ? ksbl : 1;

  // ---- boundary-layer scales and profile matching ---------------------
  const T Bfsfc = Bo + mul_rn(Bosol, T(1.0) - swdk(zwN - hsbl, p));
  const T zbl = zwN - hsbl;
  const T sl_dpth = mul_rn(T(EPSILON), zbl);
  const T sig_bl = Bfsfc > T(0.0) ? zbl : mul_rn(T(EPSILON), zbl);
  T wm_bl, ws_bl;
  wscale(Ustar, mul_rn(mul_rn(vonKar, sig_bl), Bfsfc), vonKar, wm_bl, ws_bl);
  const T U2 = mul_rn(Ustar, Ustar);
  const T f1 = mul_rn(mul_rn(T(5.0), mx(Bfsfc, T(0.0))), vonKar) /
               (mul_rn(U2, U2) + T(EPS));
  const T zw_ks = zw[ksbl * sP], zw_ksm1 = zw[(ksbl - 1) * sP];
  const T cffk = T(1.0) / (zw_ks - zw_ksm1);
  const T cff_dn = mul_rn(cffk, hsbl - zw_ksm1);
  const T cff_up = mul_rn(cffk, zw_ks - hsbl);
  T Kv_at, Kt_at, Kv_at1, Kt_at1;
  if (ksbl == N) {
    Kv_at = T(p.akv_bak);
    Kt_at = T(p.akt_bak0);
  } else {
    interior_mix(dU[ksbl], dV[ksbl], bv[ksbl], Kv_at, Kt_at);
  }
  if (ksbl == 1) {
    Kv_at1 = T(p.akv_bak);
    Kt_at1 = T(p.akt_bak0);
  } else {
    interior_mix(dU[ksbl - 1], dV[ksbl - 1], bv[ksbl - 1], Kv_at1, Kt_at1);
  }
  const T Kv_bl = mul_rn(cff_dn, Kv_at) + mul_rn(cff_up, Kv_at1);
  const T dKv_bl = mul_rn(cffk, Kv_at - Kv_at1);
  const T Kv1 = Kv_bl / (mul_rn(zbl, wm_bl) + T(EPS));
  const T dKv1 = mn(-dKv_bl / (wm_bl + T(EPS)) - mul_rn(Kv_bl, f1), T(0.0));
  const T Kt_bl = mul_rn(cff_dn, Kt_at) + mul_rn(cff_up, Kt_at1);
  const T dKt_bl = mul_rn(cffk, Kt_at - Kt_at1);
  const T Kt1 = Kt_bl / (mul_rn(zbl, ws_bl) + T(EPS));
  const T dKt1 = mn(-dKt_bl / (ws_bl + T(EPS)) - mul_rn(Kt_bl, f1), T(0.0));

  // ---- outputs: shape-function profile inside the boundary layer,
  // interior mixing below it, nonlocal transport ------------------------
  const T flxT = a.flxT[c], flxS = a.flxS[c], srflx = a.srflx[c];
  a.Akv[c] = T(p.akv_bak);
  a.Akt[c] = T(p.akt_bak0);
  a.ghT[c] = T(0.0);
  a.ghS[c] = T(0.0);
  for (int k = 1; k < N; ++k) {
    const size_t o = k * sP + c;
    T akv, akt;
    interior_mix(dU[k], dV[k], bv[k], akv, akt);
    T ghT = T(0.0), ghS = T(0.0);
    if (k > ksbl) {
      const T depth = zwN - zw[k * sP];
      const T Bf = Bo + mul_rn(Bosol, T(1.0) - swd[k]);
      const T sigma = Bf < T(0.0) ? mn(sl_dpth, depth) : depth;
      T wm, ws;
      wscale(Ustar, mul_rn(mul_rn(vonKar, sigma), Bf), vonKar, wm, ws);
      const T sig = depth / (zbl + T(EPS));
      const T a1 = sig - T(2.0);
      const T a2 = T(3.0) - mul_rn(T(2.0), sig);
      const T a3 = sig - T(1.0);
      const T Gm = a1 + mul_rn(a2, Kv1) + mul_rn(a3, dKv1);
      akv = mul_rn(mul_rn(depth, wm), T(1.0) + mul_rn(sig, Gm));
      const T Gt = a1 + mul_rn(a2, Kt1) + mul_rn(a3, dKt1);
      akt = mul_rn(mul_rn(depth, ws), T(1.0) + mul_rn(sig, Gt));
      if (Bf < T(0.0)) {
        const T cff_nl = T(p.Cg) / (mul_rn(zbl, ws) + T(EPS));
        ghT = mul_rn(-cff_nl, flxT + mul_rn(srflx, T(1.0) - swd[k]));
        ghS = mul_rn(cff_nl, flxS);
      }
    }
    a.Akv[o] = akv;
    a.Akt[o] = akt;
    a.ghT[o] = ghT;
    a.ghS[o] = ghS;
  }
  const size_t oN = N * sP + c;
  a.Akv[oN] = T(p.akv_bak);
  a.Akt[oN] = T(p.akt_bak0);
  a.ghT[oN] = T(0.0);
  a.ghS[oN] = T(0.0);
  a.hsbl[c] = hsbl;
}

template <typename T, bool PREP>
int launch(const KppArgs<T>& a, int NT, int N, int P, const EosParams& e,
           const KppParams& p, void* stream) {
  kpp_kernel<T, PREP><<<roms::blocks_for(P), roms::kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(a, NT, N, P, e,
                                                             p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define ROMS_COLUMN_SCALARS                                                 \
  int NT, int N, int P, int linear, int use_s, double R0, double T0,        \
      double S0, double R0Tcoef, double R0Scoef, double bvf_c,              \
      double neg_g, double o_rho0, double two_o_rho0, double akv_bak,       \
      double akt_bak0, double r1, double o_mu1, double o_mu2,               \
      double neg_gorho0, double Vtc, double Cg, double vonKar, void* stream

#define ROMS_COLUMN_PARAMS                                                  \
  EosParams e{linear, use_s, R0, T0, S0, R0Tcoef, R0Scoef,                  \
              bvf_c, neg_g, o_rho0, two_o_rho0};                            \
  KppParams p{akv_bak, akt_bak0, r1, o_mu1, o_mu2, neg_gorho0, Vtc, Cg,     \
              vonKar};

#define ROMS_KPP_ENTRY(NAME, T)                                              \
  extern "C" int NAME(const void* u_r, const void* v_r, const void* pden,   \
                      const void* bvf, const void* Hz, const void* z_w,     \
                      const void* Ustar, const void* Bo, const void* Bosol, \
                      const void* absf, const void* flxT, const void* flxS, \
                      const void* srflx, void* Akv, void* Akt, void* ghT,   \
                      void* ghS, void* hsbl, ROMS_COLUMN_SCALARS) {         \
    ROMS_COLUMN_PARAMS                                                      \
    using C = const T*;                                                     \
    KppArgs<T> a{nullptr, nullptr, C(u_r), C(v_r), C(pden), C(bvf),         \
                 C(Hz), C(z_w), C(Ustar), C(Bo), C(Bosol), C(absf),         \
                 C(flxT), C(flxS), C(srflx), nullptr, nullptr, nullptr,     \
                 nullptr, (T*)Akv, (T*)Akt, (T*)ghT, (T*)ghS, (T*)hsbl};    \
    return launch<T, false>(a, NT, N, P, e, p, stream);                     \
  }

#define ROMS_PREP_ENTRY(NAME, T)                                             \
  extern "C" int NAME(const void* t, const void* z_r, const void* Hz,       \
                      const void* z_w, const void* u_r, const void* v_r,    \
                      const void* Ustar, const void* Bo, const void* Bosol, \
                      const void* absf, const void* flxT, const void* flxS, \
                      const void* srflx, void* rho, void* pden, void* rhoA, \
                      void* rhoS, void* Akv, void* Akt, void* ghT,          \
                      void* ghS, void* hsbl, ROMS_COLUMN_SCALARS) {         \
    ROMS_COLUMN_PARAMS                                                      \
    using C = const T*;                                                     \
    KppArgs<T> a{C(t), C(z_r), C(u_r), C(v_r), nullptr, nullptr, C(Hz),     \
                 C(z_w), C(Ustar), C(Bo), C(Bosol), C(absf), C(flxT),       \
                 C(flxS), C(srflx), (T*)rho, (T*)pden, (T*)rhoA,            \
                 (T*)rhoS, (T*)Akv, (T*)Akt, (T*)ghT, (T*)ghS, (T*)hsbl};   \
    return launch<T, true>(a, NT, N, P, e, p, stream);                      \
  }

ROMS_KPP_ENTRY(roms_kpp_f32, float)
ROMS_KPP_ENTRY(roms_kpp_f64, double)
ROMS_PREP_ENTRY(roms_prep_f32, float)
ROMS_PREP_ENTRY(roms_prep_f64, double)
