// The column equation of state (linear or Jackett & McDougall 1995) with
// the barotropic-coupling averages rhoA/rhoS and the Brunt-Vaisala
// frequency, shared by kernel 1 (rho.cu) and the prep mode of kernel 15
// (kpp.cu), so both evaluate one EOS with one rounding.
//
// The column is walked top-down once, with the next A levels' inputs in
// flight in a ring of registers (A = 0: each level's loaded as it comes;
// kernel 1 runs at full occupancy and keeps its registers, the prep
// kernel at low occupancy and prefetches): the rhoA/rhoS sums of
// rho_eos.F:731-741 run in registers in the reference's top-down order,
// and the level above is kept in registers for the interface bvf.  Every
// product that feeds an add or subtract is mul_rn, which nvcc never
// contracts into an FMA, so each value rounds as in the plain version
// (ops/rho.py rho_eos_plain): bvf differences neighbouring levels of rho
// ~ 27 kg/m3, and one float32 ulp of a contracted R0 - R0*Tcoef*(T - T0)
// moves it by ~1e-3.
#pragma once

#include "common.cuh"

namespace roms {

// Jackett & McDougall (1995) coefficients (mod_eoscoef.F)
constexpr double Q00 = +9.99842594e+2, Q01 = +6.793952e-2,
                 Q02 = -9.095290e-3, Q03 = +1.001685e-4,
                 Q04 = -1.120083e-6, Q05 = +6.536332e-9;
constexpr double U00 = +8.24493e-1, U01 = -4.08990e-3, U02 = +7.64380e-5,
                 U03 = -8.24670e-7, U04 = +5.38750e-9;
constexpr double V00 = -5.72466e-3, V01 = +1.02270e-4, V02 = -1.65460e-6;
constexpr double W00 = +4.8314e-4;
constexpr double A00 = +1.909256e+4, A01 = +2.098925e+2,
                 A02 = -3.041638e+0, A03 = -1.852732e-3,
                 A04 = -1.361629e-5;
constexpr double B00 = +1.044077e+2, B01 = -6.500517e+0,
                 B02 = +1.553190e-1, B03 = +2.326469e-4;
constexpr double D00 = -5.587545e+0, D01 = +7.390729e-1,
                 D02 = -1.909078e-2;
constexpr double E00 = +4.721788e-1, E01 = +1.028859e-2,
                 E02 = -2.512549e-4, E03 = -5.939910e-7;
constexpr double F00 = -1.571896e-2, F01 = -2.598241e-4,
                 F02 = +7.267926e-6;
constexpr double G00 = +2.042967e-3;
constexpr double G01 = +1.045941e-5, G02 = -5.782165e-10,
                 G03 = +1.296821e-7;
constexpr double H00 = -2.595994e-7, H01 = -1.248266e-9,
                 H02 = -3.508914e-9;

struct EosParams {
  int linear, use_s;        // linear EOS; add the Scoef term
  double R0, T0, S0, R0Tcoef, R0Scoef;
  double bvf_c;             // -(g/rho0), linear bvf factor
  double neg_g;             // -g, JM95 bvf factor
  double o_rho0, two_o_rho0;
};

// depth-independent JM95 pieces (core/rho_eos.py _jm95_parts)
template <typename T>
__device__ __forceinline__ void jm95(T t0, T t1, bool has_s, T& den1,
                                     T& b0, T& b1, T& b2) {
  const T Tt = t0 > T(-2.0) ? t0 : T(-2.0);
  const T S = has_s ? (t1 > T(0.0) ? t1 : T(0.0)) : T(0.0);
  const T sqrtS = sqrt(S);
  const T S32 = mul_rn(S, sqrtS);
  den1 = T(Q00) + mul_rn(Tt, T(Q01) + mul_rn(Tt, T(Q02) + mul_rn(Tt, T(Q03)
         + mul_rn(Tt, T(Q04) + mul_rn(Tt, T(Q05))))));
  den1 = den1 + mul_rn(S, T(U00) + mul_rn(Tt, T(U01) + mul_rn(Tt, T(U02)
         + mul_rn(Tt, T(U03) + mul_rn(Tt, T(U04))))));
  den1 = den1 + mul_rn(S32, T(V00) + mul_rn(Tt, T(V01) + mul_rn(Tt, T(V02))));
  den1 = den1 + mul_rn(mul_rn(S, S), T(W00));
  b0 = T(A00) + mul_rn(Tt, T(A01) + mul_rn(Tt, T(A02) + mul_rn(Tt, T(A03)
       + mul_rn(Tt, T(A04)))));
  b0 = b0 + mul_rn(S, T(B00) + mul_rn(Tt, T(B01) + mul_rn(Tt, T(B02)
       + mul_rn(Tt, T(B03)))));
  b0 = b0 + mul_rn(S32, T(D00) + mul_rn(Tt, T(D01) + mul_rn(Tt, T(D02))));
  b1 = T(E00) + mul_rn(Tt, T(E01) + mul_rn(Tt, T(E02) + mul_rn(Tt, T(E03))));
  b1 = b1 + mul_rn(S, T(F00) + mul_rn(Tt, T(F01) + mul_rn(Tt, T(F02))));
  b1 = b1 + mul_rn(S32, T(G00));
  b2 = T(G01) + mul_rn(Tt, T(G02) + mul_rn(Tt, T(G03)));
  b2 = b2 + mul_rn(S, T(H00) + mul_rn(Tt, T(H01) + mul_rn(Tt, T(H02))));
}

// One column c of an (N, P) layout, A levels in flight: sink.level(k,
// rho, pden) for each level k (top-down) and sink.interface(k, bvf) for
// each interior interface k = 1..N-1; returns (rhoA, rhoS).  The end
// interfaces' bvf are zero.
template <int A, typename T, typename Sink>
__device__ __forceinline__ void eos_column(const T* __restrict__ t,
                                           const T* __restrict__ z_r,
                                           const T* __restrict__ Hz,
                                           const T* __restrict__ z_w,
                                           int NT, int N, int P, int c,
                                           const EosParams& p, Sink& sink,
                                           T& rhoA, T& rhoS) {
  const size_t tracer = static_cast<size_t>(N) * P;
  T sumA = T(0), sumS = T(0);
  T up_pden = T(0), up_zr = T(0), up_zw = T(0);
  T up_den1 = T(0), up_b0 = T(0), up_b1 = T(0), up_b2 = T(0);
  // level k from its inputs: rho and pden, the interface above, the sums
  auto level = [&](int k, T t0, T t1, T zr, T hz, T zwk) {
    T r, pd, den1 = T(0), b0 = T(0), b1 = T(0), b2 = T(0);
    if (p.linear) {
      r = T(p.R0) - mul_rn(T(p.R0Tcoef), t0 - T(p.T0));
      if (p.use_s) r = r + mul_rn(T(p.R0Scoef), t1 - T(p.S0));
      r = r - T(1000.0);
      pd = r;
    } else {
      jm95(t0, t1, NT > 1, den1, b0, b1, b2);
      const T bulk = b0 - mul_rn(zr, b1 - mul_rn(zr, b2));
      r = den1 * bulk / (bulk + mul_rn(T(0.1), zr)) - T(1000.0);
      pd = den1 - T(1000.0);
    }
    sink.level(k, r, pd);
    if (k < N - 1) {
      // interface k+1, between level k (below) and level k+1 (above)
      T b;
      if (p.linear) {
        b = T(p.bvf_c) * (up_pden - pd) / (up_zr - zr);
      } else {
        const T zw = up_zw;
        const T bulk_up = up_b0 - mul_rn(zw, up_b1 - mul_rn(up_b2, zw));
        const T bulk_dn = b0 - mul_rn(zw, b1 - mul_rn(b2, zw));
        const T den_up = up_den1 * bulk_up / (bulk_up + mul_rn(T(0.1), zw));
        const T den_dn = den1 * bulk_dn / (bulk_dn + mul_rn(T(0.1), zw));
        b = T(p.neg_g) * (den_up - den_dn) /
            (T(0.5) * (den_up + den_dn) * (up_zr - zr));
      }
      sink.interface(k + 1, b);
    }
    // top-down accumulation (rho_eos.F:731-741)
    if (k == N - 1) {
      sumA = mul_rn(r, hz);
      sumS = mul_rn(mul_rn(T(0.5), sumA), hz);
    } else {
      const T cff1 = mul_rn(r, hz);
      sumS = sumS + mul_rn(hz, sumA + mul_rn(T(0.5), cff1));
      sumA = sumA + cff1;
    }
    up_pden = pd;
    up_zr = zr;
    up_zw = zwk;
    up_den1 = den1;
    up_b0 = b0;
    up_b1 = b1;
    up_b2 = b2;
  };
  auto at = [&](const T* f, int k) {
    return f[static_cast<size_t>(k) * P + c];
  };
  if constexpr (A == 0) {
    for (int k = N - 1; k >= 0; --k)
      level(k, at(t, k), NT > 1 ? at(t + tracer, k) : T(0), at(z_r, k),
            at(Hz, k), p.linear ? T(0) : at(z_w, k));
  } else {
    T r0[A], r1[A], rz[A], rh[A], rw[A];
    auto fetch = [&](int k, int u) {
      r0[u] = at(t, k);
      r1[u] = NT > 1 ? at(t + tracer, k) : T(0);
      rz[u] = at(z_r, k);
      rh[u] = at(Hz, k);
      rw[u] = p.linear ? T(0) : at(z_w, k);   // the JM95 bvf's interfaces
    };
#pragma unroll
    for (int u = 0; u < A; ++u)
      if (N - 1 - u >= 0) fetch(N - 1 - u, u);
    for (int k0 = N - 1; k0 >= 0; k0 -= A) {
#pragma unroll
      for (int u = 0; u < A; ++u) {
        const int k = k0 - u;
        if (k < 0) break;
        level(k, r0[u], r1[u], rz[u], rh[u], rw[u]);
        // refill the slot once its level is done
        if (k - A >= 0) fetch(k - A, u);
      }
    }
  }
  const T D_inv = T(1.0) / (z_w[static_cast<size_t>(N) * P + c] - z_w[c]);
  rhoA = T(p.o_rho0) * D_inv * sumA;
  rhoS = T(p.two_o_rho0) * D_inv * D_inv * sumS;
}

}  // namespace roms
