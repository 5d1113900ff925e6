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
// rho, pden (N), rhoA, rhoS and the KPP outputs, Akt once for each of the
// NAT active tracers (the step's stacked Akt and ghats, no copy after).
// A few hundred flops a level (the EOS, the interior mixing, and two exp
// and the similarity pow calls at the levels above the first crossing and
// inside the boundary layer) stay under the card's flop/byte balance.
//
// Design: one thread per (j, i) column, consecutive threads on
// consecutive i, so every k-plane load and store is coalesced.  What the
// column carries from one sweep to the next lives in dynamic shared
// memory laid out [k][thread] and sized by N at runtime (ops/kpp.py
// prep_launch_shape): the interior bvf, the Thomas cp and the three spline
// derivatives, 5 N - 6 values; no local array, no stack frame.  The inputs
// a later step reads again (pden, Hz, z_w, u_r, v_r) come from L2, which
// was faster than keeping them in shared memory at the cost of occupancy.
//   1. top-down: the column EOS (roms::eos_column, rho_col.cuh; its sink
//      writes rho and pden out and keeps the interior bvf), or the load of
//      bvf (KPP mode);
//   2. bottom-up: the Thomas forward elimination of the spline
//      derivatives, one factorization for three right-hand sides (pden,
//      u_r, v_r; u_r and v_r read here for the first time), the next
//      kAhead levels in flight;
//   3. top-down: the back substitution, the finished derivatives in place,
//      and the interior mixing of each interface written out;
//   4. the bulk Richardson number FC from the top down to the first
//      crossing (the largest k with FC[k] < Ric <= FC[k-1]), and
//   5. the shape-function profile and nonlocal transport of the levels
//      inside the boundary layer, written over step 3's.
// Steps 4 and 5 are the costly per-level work, and how many levels a
// column needs varies from column to column: the warp shares its columns'
// levels out over its 32 lanes (shuffles, and reads of the other lanes'
// slots), so a warp takes about as many rounds as its columns' levels
// over 32, not its deepest column's.
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
using roms::mul_rn;

// core/lmd.py (mod_scalars.F:1635-1712)
constexpr double EPS = 1.0e-10, SMALL = 1.0e-20;
constexpr double RI0 = 0.7, BVFCON = -2.0e-5, NU0C = 0.01;
constexpr double NU0M = 10.0e-4, NU0S = 10.0e-4, RIC = 0.3;
constexpr double AM = 1.257, AS = -28.86, CM = 8.36, CS = 98.96;
constexpr double CEKMAN = 0.7, CMONOB = 1.0, EPSILON = 0.1;
constexpr double ZETAM = -0.2, ZETAS = -1.0;
constexpr double C3 = 1.0 / 3.0, C6 = 1.0 / 6.0;

// levels steps 1 and 2 keep in flight ahead of the one they work on
constexpr int kAhead = 4;

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
  T* Akt;                     // nat slots of N+1 levels
  T* ghT;
  T* ghS;
  T* hsbl;
  int NT, N, P, nat;
};

// values a thread keeps in shared memory (ops/kpp.py column_values): the
// interior bvf (N-1), the Thomas cp (N-2) and the three spline derivatives
// (N-1 each)
inline int column_values(int N) { return 5 * N - 6; }

// a level-indexed column: the thread's shared-memory slots [k][thread] or
// its column in device memory; lane(dc) is the same for the column dc
// lanes over (consecutive threads hold consecutive columns)
template <typename T>
struct Col {
  T* p;
  size_t s;
  __device__ __forceinline__ T operator[](int k) const { return p[k * s]; }
  __device__ __forceinline__ T& at(int k) const { return p[k * s]; }
  __device__ __forceinline__ Col lane(int dc) const { return {p + dc, s}; }
};

// eos_column sink of the prep mode: rho and pden to device memory, the
// interior bvf to the thread's slots
template <typename T>
struct KeepColumn {
  T* rho;
  T* pden;
  size_t P, c;
  Col<T> bv;
  __device__ void level(int k, T r, T p_) {
    const size_t o = k * P + c;
    rho[o] = r;
    pden[o] = p_;
  }
  __device__ void interface(int k, T b) { bv.at(k - 1) = b; }
};

template <typename T>
__device__ __forceinline__ T mn(T a, T b) { return a < b ? a : b; }
template <typename T>
__device__ __forceinline__ T mx(T a, T b) { return a > b ? a : b; }

// fraction of shortwave left at depth (core/lmd.py swdk_frac)
template <typename T>
__device__ __forceinline__ T swdk(T depth, const KppParams& p) {
  return mul_rn(T(p.r1), exp(mul_rn(-depth, T(p.o_mu1)))) +
         mul_rn(T(1.0 - p.r1), exp(mul_rn(-depth, T(p.o_mu2))));
}

// turbulent velocity scales (core/lmd.py _wscale); the branch not taken
// is not evaluated (the plain version forms both and selects)
template <typename T>
__device__ void wscale(T Ustar, T zetahat, T vonKar, T& wm, T& ws) {
  const T U3 = mul_rn(mul_rn(Ustar, Ustar), Ustar);
  const T zetapar = zetahat / (U3 + T(SMALL));
  if (zetahat >= T(0.0)) {
    wm = ws = mul_rn(vonKar, Ustar) / (T(1.0) + mul_rn(T(5.0), zetapar));
    return;
  }
  const T one16 = mx(T(1.0) - mul_rn(T(16.0), zetapar), T(0.0));
  const T kU = mul_rn(vonKar, Ustar);
  wm = zetapar > T(ZETAM)
      ? mul_rn(kU, pow(one16, T(0.25)))
      : mul_rn(vonKar, pow(mx(mul_rn(T(AM), U3) - mul_rn(T(CM), zetahat),
                              T(0.0)), T(1.0 / 3.0)));
  ws = zetapar > T(ZETAS)
      ? mul_rn(kU, sqrt(one16))
      : mul_rn(vonKar, pow(mx(mul_rn(T(AS), U3) - mul_rn(T(CS), zetahat),
                              T(0.0)), T(1.0 / 3.0)));
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

// the bulk Richardson number FC of level k at `depth` below the surface
// (lmd_skpp.F), from the finished spline derivatives at its interfaces k
// (dRk, ...) and k+1 (dRa, ...); sw returns the shortwave fraction there
template <typename T>
__device__ __forceinline__ T bulk_richardson(
    T depth, T pdk, T hz, T urk, T vrk, T dRk, T dRa, T dUk, T dUa, T dVk,
    T dVa, T bvk, T Rref, T Uref, T Vref, T Ustar, T Bo, T Bosol,
    const KppParams& p, T& sw) {
  const T vonKar = T(p.vonKar);
  sw = swdk(depth, p);
  const T Bf = Bo + mul_rn(Bosol, T(1.0) - sw);
  const T sl0 = mul_rn(T(EPSILON), depth);
  const T sigma = Bf < T(0.0) ? mn(sl0, depth) : depth;
  T wm, ws;
  wscale(Ustar, mul_rn(mul_rn(vonKar, sigma), Bf), vonKar, wm, ws);
  const T Rk = pdk - mul_rn(hz, mul_rn(T(C3), dRk) + mul_rn(T(C6), dRa));
  const T Uk = urk - mul_rn(hz, mul_rn(T(C3), dUk) + mul_rn(T(C6), dUa));
  const T Vk = vrk - mul_rn(hz, mul_rn(T(C3), dVk) + mul_rn(T(C6), dVa));
  const T Ritop = mul_rn(mul_rn(T(p.neg_gorho0), Rref - Rk), depth);
  const T dUr = Uref - Uk, dVr = Vref - Vk;
  const T Ribot = mul_rn(dUr, dUr) + mul_rn(dVr, dVr) +
                  mul_rn(mul_rn(mul_rn(T(p.Vtc), depth), ws),
                         sqrt(fabs(bvk)));
  return Ritop / (Ribot + T(EPS));
}

// a column's boundary-layer scales, the profile-matching coefficients
// and its surface fluxes: what a level inside its boundary layer needs
template <typename T>
struct BoundaryLayer {
  T Ustar, Bo, Bosol, zwN, zbl, sl_dpth, Kv1, dKv1, Kt1, dKt1;
  T flxT, flxS, srflx;
};

// the shape-function profile and the nonlocal transport at a level inside
// the boundary layer, at `depth` with shortwave fraction sw
template <typename T>
__device__ __forceinline__ void boundary_level(const BoundaryLayer<T>& b,
                                               T depth, T sw,
                                               const KppParams& p, T& akv,
                                               T& akt, T& ghT, T& ghS) {
  const T vonKar = T(p.vonKar);
  const T Bf = b.Bo + mul_rn(b.Bosol, T(1.0) - sw);
  const T sigma = Bf < T(0.0) ? mn(b.sl_dpth, depth) : depth;
  T wm, ws;
  wscale(b.Ustar, mul_rn(mul_rn(vonKar, sigma), Bf), vonKar, wm, ws);
  const T sig = depth / (b.zbl + T(EPS));
  const T a1 = sig - T(2.0);
  const T a2 = T(3.0) - mul_rn(T(2.0), sig);
  const T a3 = sig - T(1.0);
  const T Gm = a1 + mul_rn(a2, b.Kv1) + mul_rn(a3, b.dKv1);
  akv = mul_rn(mul_rn(depth, wm), T(1.0) + mul_rn(sig, Gm));
  const T Gt = a1 + mul_rn(a2, b.Kt1) + mul_rn(a3, b.dKt1);
  akt = mul_rn(mul_rn(depth, ws), T(1.0) + mul_rn(sig, Gt));
  ghT = ghS = T(0.0);
  if (Bf < T(0.0)) {
    const T cff_nl = T(p.Cg) / (mul_rn(b.zbl, ws) + T(EPS));
    ghT = mul_rn(-cff_nl, b.flxT + mul_rn(b.srflx, T(1.0) - sw));
    ghS = mul_rn(cff_nl, b.flxS);
  }
}

constexpr unsigned kFull = 0xffffffffu;

// every field of a BoundaryLayer from lane `src`
template <typename T>
__device__ __forceinline__ BoundaryLayer<T> shfl_layer(
    const BoundaryLayer<T>& b, int src) {
  BoundaryLayer<T> o;
  o.Ustar = __shfl_sync(kFull, b.Ustar, src);
  o.Bo = __shfl_sync(kFull, b.Bo, src);
  o.Bosol = __shfl_sync(kFull, b.Bosol, src);
  o.zwN = __shfl_sync(kFull, b.zwN, src);
  o.zbl = __shfl_sync(kFull, b.zbl, src);
  o.sl_dpth = __shfl_sync(kFull, b.sl_dpth, src);
  o.Kv1 = __shfl_sync(kFull, b.Kv1, src);
  o.dKv1 = __shfl_sync(kFull, b.dKv1, src);
  o.Kt1 = __shfl_sync(kFull, b.Kt1, src);
  o.dKt1 = __shfl_sync(kFull, b.dKt1, src);
  o.flxT = __shfl_sync(kFull, b.flxT, src);
  o.flxS = __shfl_sync(kFull, b.flxS, src);
  o.srflx = __shfl_sync(kFull, b.srflx, src);
  return o;
}

template <typename T, bool PREP>
__global__ void kpp_kernel(const __grid_constant__ KppArgs<T> a,
                           const __grid_constant__ EosParams e,
                           const __grid_constant__ KppParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int B = blockDim.x, N = a.N;
  const int lane = threadIdx.x & 31;
  const size_t sP = static_cast<size_t>(a.P);
  const size_t c = static_cast<size_t>(blockIdx.x) * B + threadIdx.x;
  // a lane past the last column keeps its warp whole for the shuffles:
  // it owns no column but does its share of the warp's work
  const bool live = c < sP;
  const T vonKar = T(p.vonKar);

  // the thread's slots [k][thread] with a stride of B + 1 values, so that
  // a lane reading its neighbours' levels meets no bank conflict; in the
  // order of column_values
  const size_t S = static_cast<size_t>(B) + 1;
  T* s = reinterpret_cast<T*>(smem) + threadIdx.x;
  auto slots = [&](int n) {
    const Col<T> col{s, S};
    s += static_cast<size_t>(n) * S;
    return col;
  };
  auto column = [&](const T* f) { return Col<T>{const_cast<T*>(f) + c, sP}; };
  // pden is read again from L2 (the prep mode's own output)
  const Col<T> pd = column(PREP ? a.pden : a.pden_in);
  const Col<T> bv = slots(N - 1), cp = slots(N - 2);
  const Col<T> dR = slots(N - 1), dU = slots(N - 1), dV = slots(N - 1);
  const Col<T> Hz = column(a.Hz), zw = column(a.z_w);
  const Col<T> ur = column(a.u_r), vr = column(a.v_r);
  const size_t slot = static_cast<size_t>(N + 1) * sP;   // an Akt tracer
  // the outputs of level k of column c + dc
  auto put = [&](int k, int dc, T akv, T akt, T ghT, T ghS) {
    const size_t o = k * sP + c + dc;
    a.Akv[o] = akv;
    for (int n = 0; n < a.nat; ++n) a.Akt[n * slot + o] = akt;
    a.ghT[o] = ghT;
    a.ghS[o] = ghS;
  };

  T zw0 = T(0), zwN = T(0), Ustar = T(0), Bo = T(0), Bosol = T(0);
  T Rref = T(0), Uref = T(0), Vref = T(0);
  if (live) {
    zw0 = zw[0];
    zwN = zw[N];
    Ustar = a.Ustar[c];
    Bo = a.Bo[c];
    Bosol = a.Bosol[c];

    // ---- 1. top-down: pden and the interior bvf -------------------------
    if constexpr (PREP) {
      KeepColumn<T> sink{a.rho, a.pden, sP, c, bv};
      T A, S_;
      roms::eos_column<kAhead>(a.t, a.z_r, a.Hz, a.z_w, a.NT, N, a.P,
                               static_cast<int>(c), e, sink, A, S_);
      a.rhoA[c] = A;
      a.rhoS[c] = S_;
    } else {
      const Col<T> bv_in = column(a.bvf_in);
#pragma unroll 4
      for (int k = N - 1; k >= 1; --k) bv.at(k - 1) = bv_in[k];
    }

    // ---- 2. bottom-up: the spline derivatives, one Thomas factorization
    // and three right-hand sides.  Rows m = 0..N-2 (interfaces 1..N-1):
    // lower Hz[m] (0 at m = 0), diagonal 2 (Hz[m] + Hz[m+1]), upper
    // Hz[m+1] (0 at m = N-2); row m is eliminated when level m+1 arrives,
    // the next kAhead levels in flight.  Slot m of dR/dU/dV holds
    // interface m+1, slot m of cp row m (m <= N-3).
    const int M = N - 1;
    T hz0 = Hz[0], ur0 = ur[0], vr0 = vr[0], pd0 = pd[0];
    T cpp = T(0), xR = T(0), xU = T(0), xV = T(0);
    {
      T rh[kAhead], ru[kAhead], rv[kAhead], rp[kAhead];
      auto fetch = [&](int k, int u) {
        rh[u] = Hz[k];
        ru[u] = ur[k];
        rv[u] = vr[k];
        rp[u] = pd[k];
      };
#pragma unroll
      for (int u = 0; u < kAhead; ++u)
        if (1 + u < N) fetch(1 + u, u);
      for (int k0 = 1; k0 < N; k0 += kAhead) {
#pragma unroll
        for (int u = 0; u < kAhead; ++u) {
          const int k = k0 + u;
          if (k >= N) break;
          const T hz1 = rh[u], ur1 = ru[u], vr1 = rv[u], pd1 = rp[u];
          if (k + kAhead < N) fetch(k + kAhead, u);
          const int m = k - 1;
          const T up = m < M - 1 ? hz1 : T(0.0);
          if (m == 0) {
            const T inv0 = T(1.0) / mul_rn(T(2.0), hz0 + hz1);
            cpp = mul_rn(up, inv0);
            xR = mul_rn(mul_rn(T(6.0), pd1 - pd0), inv0);
            xU = mul_rn(mul_rn(T(6.0), ur1 - ur0), inv0);
            xV = mul_rn(mul_rn(T(6.0), vr1 - vr0), inv0);
          } else {
            const T denom = T(1.0) / (mul_rn(T(2.0), hz0 + hz1) -
                                      mul_rn(hz0, cpp));
            cpp = mul_rn(up, denom);
            xR = mul_rn(mul_rn(T(6.0), pd1 - pd0) - mul_rn(hz0, xR), denom);
            xU = mul_rn(mul_rn(T(6.0), ur1 - ur0) - mul_rn(hz0, xU), denom);
            xV = mul_rn(mul_rn(T(6.0), vr1 - vr0) - mul_rn(hz0, xV), denom);
          }
          if (m < M - 1) cp.at(m) = cpp;
          dR.at(m) = xR;
          dU.at(m) = xU;
          dV.at(m) = xV;
          hz0 = hz1;
          ur0 = ur1;
          vr0 = vr1;
          pd0 = pd1;
        }
      }
    }
    // hz0, ur0, vr0 and pd0 now hold level N-1, and xR, xU, xV the
    // derivatives at interface N-1, final (the top row has no back
    // substitution)
    Rref = pd0 + mul_rn(hz0, mul_rn(T(C3), T(0.0)) + mul_rn(T(C6), xR));
    Uref = ur0 + mul_rn(hz0, mul_rn(T(C3), T(0.0)) + mul_rn(T(C6), xU));
    Vref = vr0 + mul_rn(hz0, mul_rn(T(C3), T(0.0)) + mul_rn(T(C6), xV));

    // ---- 3. top-down: back substitution, the finished derivatives in
    // place, and the interior mixing of each interface (lmd_vmix.F)
    // written out; levels inside the boundary layer are written again in
    // step 5
    put(N, 0, T(p.akv_bak), T(p.akt_bak0), T(0.0), T(0.0));
    T aR = xR, aU = xU, aV = xV;   // the derivatives at interface k
    for (int k = N - 1; k >= 1; --k) {
      if (k < N - 1) {
        const T cpk = cp[k - 1];
        aR = dR[k - 1] - mul_rn(cpk, aR);
        aU = dU[k - 1] - mul_rn(cpk, aU);
        aV = dV[k - 1] - mul_rn(cpk, aV);
        dR.at(k - 1) = aR;
        dU.at(k - 1) = aU;
        dV.at(k - 1) = aV;
      }
      T akv, akt;
      interior_mix(aU, aV, bv[k - 1], akv, akt);
      put(k, 0, akv, akt, T(0.0), T(0.0));
    }
    put(0, 0, T(p.akv_bak), T(p.akt_bak0), T(0.0), T(0.0));
  }
  __syncwarp();

  // ---- 4. the bulk Richardson number from the top down to the first
  // crossing, FC[k+1] < Ric <= FC[k], the largest k + 1 >= 2 (FC[N] = 0).
  // The warp shares out its columns' levels: in each round every column
  // still scanning takes 32 / (such columns) lanes, one level each, its
  // next levels down; the topmost crossing among them ends its scan.
  // Each level's shortwave fraction takes the slot of its Thomas cp,
  // which no later step reads (the top level has none).
  bool scanning = live;
  int pos = N - 1;             // the next level whose FC is formed
  int kfc = N;                 // the lowest level whose FC was formed
  T FCup = T(0), zwup = zwN;   // FC and z_w of the level above pos
  bool found = false;
  T FCk = T(0), FCkm1 = T(0), zwk = T(0), zwkm1 = T(0);
  for (;;) {
    const unsigned act = __ballot_sync(kFull, scanning);
    if (!act) break;
    const int nact = __popc(act);
    const int chunk = 32 / nact;
    const int r = lane / chunk, j = lane - r * chunk;
    const int o = r < nact ? static_cast<int>(__fns(act, 0, r + 1)) : lane;
    const int k = __shfl_sync(kFull, pos, o) - j;
    const bool valid = r < nact && k >= 1;
    const T oRref = __shfl_sync(kFull, Rref, o);
    const T oUref = __shfl_sync(kFull, Uref, o);
    const T oVref = __shfl_sync(kFull, Vref, o);
    const T oUstar = __shfl_sync(kFull, Ustar, o);
    const T oBo = __shfl_sync(kFull, Bo, o);
    const T oBosol = __shfl_sync(kFull, Bosol, o);
    const T ozwN = __shfl_sync(kFull, zwN, o);
    const T oFCup = __shfl_sync(kFull, FCup, o);
    const T ozwup = __shfl_sync(kFull, zwup, o);
    T FC = T(0), zwl = T(0);
    if (valid) {
      const int dc = o - lane;
      const Col<T> odR = dR.lane(dc), odU = dU.lane(dc), odV = dV.lane(dc);
      const bool top = k == N - 1;
      zwl = zw.lane(dc)[k];
      T sw;
      FC = bulk_richardson(
          ozwN - zwl, pd.lane(dc)[k], Hz.lane(dc)[k], ur.lane(dc)[k],
          vr.lane(dc)[k], odR[k - 1], top ? T(0) : odR[k], odU[k - 1],
          top ? T(0) : odU[k], odV[k - 1], top ? T(0) : odV[k],
          bv.lane(dc)[k - 1], oRref, oUref, oVref, oUstar, oBo, oBosol, p,
          sw);
      if (!top) cp.lane(dc).at(k - 1) = sw;
    }
    // FC and z_w of the level above: the previous lane's, or the column's
    // carry for the first level of its lanes
    T FCa = __shfl_up_sync(kFull, FC, 1), zwa = __shfl_up_sync(kFull, zwl, 1);
    if (j == 0) {
      FCa = oFCup;
      zwa = ozwup;
    }
    const unsigned cross =
        __ballot_sync(kFull, valid && FCa < T(RIC) && FC >= T(RIC));
    const unsigned done = __ballot_sync(kFull, valid);
    // each scanning column reads its lanes: the topmost crossing, else the
    // last level formed
    int hit = lane, last = lane, formed = 0;
    bool crossed = false;
    if (scanning) {
      const int rank = __popc(act & ((1u << lane) - 1));
      const unsigned mine =
          (chunk == 32 ? kFull : (1u << chunk) - 1) << (rank * chunk);
      formed = __popc(done & mine);
      last = 31 - __clz(done & mine);
      crossed = (cross & mine) != 0;
      if (crossed) hit = __ffs(cross & mine) - 1;
    }
    const T hFCa = __shfl_sync(kFull, FCa, hit);
    const T hFC = __shfl_sync(kFull, FC, hit);
    const T hzwa = __shfl_sync(kFull, zwa, hit);
    const T hzwl = __shfl_sync(kFull, zwl, hit);
    const T lFC = __shfl_sync(kFull, FC, last);
    const T lzwl = __shfl_sync(kFull, zwl, last);
    if (scanning) {
      kfc = pos - formed + 1;
      if (crossed) {
        found = true;
        FCk = hFCa;
        FCkm1 = hFC;
        zwk = hzwa;
        zwkm1 = hzwl;
        scanning = false;
      } else {
        FCup = lFC;
        zwup = lzwl;
        pos -= formed;
        scanning = pos >= 1;
      }
    }
  }

  // the boundary-layer depth (with no crossing FC was formed down to
  // level 1 and zwup is z_w[1]), the Ekman / Monin-Obukhov caps under
  // stable forcing, ksbl, the boundary-layer scales and the matching
  BoundaryLayer<T> bl{Ustar, Bo, Bosol, zwN, T(0), T(0), T(0), T(0), T(0),
                      T(0), T(0), T(0), T(0)};
  int ksbl = N;
  if (live) {
    T hsbl = found ? (mul_rn(FCkm1 - T(RIC), zwk) +
                      mul_rn(T(RIC) - FCk, zwkm1)) /
                         (FCkm1 - FCk + T(SMALL))
                   : zwup;
    {
      const T Bfsfc = Bo + mul_rn(Bosol, T(1.0) - swdk(zwN - hsbl, p));
      const T hekman = mul_rn(T(CEKMAN), Ustar) / mx(a.absf[c], T(EPS));
      const T hmonob =
          mul_rn(T(CMONOB), mul_rn(mul_rn(Ustar, Ustar), Ustar)) /
          mx(mul_rn(vonKar, Bfsfc), T(EPS));
      const T cap = zwN - mn(mn(hekman, hmonob), zwN - hsbl);
      if (Ustar > T(0.0) && Bfsfc > T(0.0)) hsbl = cap;
      hsbl = mn(mx(hsbl, zw0), zwN);
    }
    a.hsbl[c] = hsbl;
    ksbl = 0;
#pragma unroll 4
    for (int k = 0; k < N; ++k) ksbl += zw[k] < hsbl ? 1 : 0;
    ksbl = ksbl > 1 ? ksbl : 1;

    const T Bfsfc = Bo + mul_rn(Bosol, T(1.0) - swdk(zwN - hsbl, p));
    bl.zbl = zwN - hsbl;
    bl.sl_dpth = mul_rn(T(EPSILON), bl.zbl);
    const T sig_bl = Bfsfc > T(0.0) ? bl.zbl : mul_rn(T(EPSILON), bl.zbl);
    T wm_bl, ws_bl;
    wscale(Ustar, mul_rn(mul_rn(vonKar, sig_bl), Bfsfc), vonKar, wm_bl,
           ws_bl);
    const T U2 = mul_rn(Ustar, Ustar);
    const T f1 = mul_rn(mul_rn(T(5.0), mx(Bfsfc, T(0.0))), vonKar) /
                 (mul_rn(U2, U2) + T(EPS));
    const T zw_ks = zw[ksbl], zw_ksm1 = zw[ksbl - 1];
    const T cffk = T(1.0) / (zw_ks - zw_ksm1);
    const T cff_dn = mul_rn(cffk, hsbl - zw_ksm1);
    const T cff_up = mul_rn(cffk, zw_ks - hsbl);
    // the interior mixing at interfaces ksbl and ksbl-1, formed again
    T Kv_at = T(p.akv_bak), Kt_at = T(p.akt_bak0);
    T Kv_at1 = T(p.akv_bak), Kt_at1 = T(p.akt_bak0);
    if (ksbl < N)
      interior_mix(dU[ksbl - 1], dV[ksbl - 1], bv[ksbl - 1], Kv_at, Kt_at);
    if (ksbl > 1)
      interior_mix(dU[ksbl - 2], dV[ksbl - 2], bv[ksbl - 2], Kv_at1, Kt_at1);
    const T Kv_bl = mul_rn(cff_dn, Kv_at) + mul_rn(cff_up, Kv_at1);
    const T dKv_bl = mul_rn(cffk, Kv_at - Kv_at1);
    bl.Kv1 = Kv_bl / (mul_rn(bl.zbl, wm_bl) + T(EPS));
    bl.dKv1 =
        mn(-dKv_bl / (wm_bl + T(EPS)) - mul_rn(Kv_bl, f1), T(0.0));
    const T Kt_bl = mul_rn(cff_dn, Kt_at) + mul_rn(cff_up, Kt_at1);
    const T dKt_bl = mul_rn(cffk, Kt_at - Kt_at1);
    bl.Kt1 = Kt_bl / (mul_rn(bl.zbl, ws_bl) + T(EPS));
    bl.dKt1 =
        mn(-dKt_bl / (ws_bl + T(EPS)) - mul_rn(Kt_bl, f1), T(0.0));
    bl.flxT = a.flxT[c];
    bl.flxS = a.flxS[c];
    bl.srflx = a.srflx[c];
  }
  __syncwarp();

  // ---- 5. the levels inside the boundary layer, k = ksbl+1 .. N-1: the
  // warp shares them out, one (column, level) a lane, in rounds of 32
  const int nbl = live && ksbl < N - 1 ? N - 1 - ksbl : 0;
  int incl = nbl;   // inclusive prefix sum over the warp's lanes
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += v;
  }
  const int total = __shfl_sync(kFull, incl, 31);
  for (int base = 0; base < total; base += 32) {
    const int t = base + lane;
    // the column of item t: the number of lanes whose prefix is <= t
    int o = 0;
#pragma unroll
    for (int step = 16; step >= 1; step >>= 1) {
      const int v = __shfl_sync(kFull, incl, o + step - 1);
      if (v <= t) o += step;
    }
    o = t < total ? o : lane;
    const int first = __shfl_sync(kFull, incl - nbl, o);
    const int oksbl = __shfl_sync(kFull, ksbl, o);
    const int okfc = __shfl_sync(kFull, kfc, o);
    const BoundaryLayer<T> ob = shfl_layer(bl, o);
    if (t < total) {
      const int dc = o - lane;
      const int k = oksbl + 1 + (t - first);
      const T depth = ob.zwN - zw.lane(dc)[k];
      // the shortwave fraction formed with FC, else formed again
      const T sw = k >= okfc && k < N - 1 ? cp.lane(dc)[k - 1]
                                           : swdk(depth, p);
      T akv, akt, ghT, ghS;
      boundary_level(ob, depth, sw, p, akv, akt, ghT, ghS);
      put(k, dc, akv, akt, ghT, ghS);
    }
  }
}
template <typename T, bool PREP>
int launch(const KppArgs<T>& a, const EosParams& e, const KppParams& p,
           int threads, void* stream) {
  const size_t smem = sizeof(T) *
                      static_cast<size_t>(column_values(a.N)) *
                      (threads + 1);
  const cudaError_t err = cudaFuncSetAttribute(
      kpp_kernel<T, PREP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) {
    cudaGetLastError();   // this launch's error, not the next one's
    return static_cast<int>(err);
  }
  const int blocks = (a.P + threads - 1) / threads;
  kpp_kernel<T, PREP><<<blocks, threads, smem,
                        static_cast<cudaStream_t>(stream)>>>(a, e, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define ROMS_COLUMN_SCALARS                                                 \
  int NT, int N, int P, int nat, int threads, int linear, int use_s,       \
      double R0, double T0, double S0, double R0Tcoef,                      \
      double R0Scoef, double bvf_c, double neg_g, double o_rho0,            \
      double two_o_rho0, double akv_bak, double akt_bak0, double r1,        \
      double o_mu1, double o_mu2, double neg_gorho0, double Vtc, double Cg, \
      double vonKar, void* stream

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
                 nullptr, (T*)Akv, (T*)Akt, (T*)ghT, (T*)ghS, (T*)hsbl,     \
                 NT, N, P, nat};                                            \
    return launch<T, false>(a, e, p, threads, stream);                      \
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
                 (T*)rhoS, (T*)Akv, (T*)Akt, (T*)ghT, (T*)ghS, (T*)hsbl,    \
                 NT, N, P, nat};                                            \
    return launch<T, true>(a, e, p, threads, stream);                       \
  }

ROMS_KPP_ENTRY(roms_kpp_f32, float)
ROMS_KPP_ENTRY(roms_kpp_f64, double)
ROMS_PREP_ENTRY(roms_prep_f32, float)
ROMS_PREP_ENTRY(roms_prep_f64, double)
