// Kernel 4: the 3D momentum corrector (step3d_uv.F:261-1716), two entry
// points:
//   uv_solve:  AB3 seed, spline implicit vertical viscosity for u and v
//              and the first replacement of the vertical mean by
//              DU_avg1/DV_avg1; output before bc_u/bc_v.
//   uv_finish: after bc_u/bc_v, the re-correction, ubar/vbar from
//              DU_avg1, and the time-centred Huon/Hvom consistent with
//              DU_avg2/DV_avg2.
//
// Replaces roms_tpu/ops/pallas_uv.py:174 uv_solve_pallas (pallas_call
// l.201) and :214 uv_finish_pallas (l.234); plain versions ops/uv.py.
// Every point, ring rows included, carries the reference's values: the
// finish outputs persist into the next step.  The u-point averages take
// the (j, i-1) neighbour and the v-point averages (Hz_v, AKv, DC0v) the
// (j-1, i) neighbour, both wrapping like jnp.roll.  On an EW-periodic grid
// uv_finish refreshes the Huon/Hvom lanes itself (ops/uv.py ends with
// st.periodic_x): the threads of lanes Li-2 and 1 also write their flux
// columns into lanes 0 and Li-1, whose own threads leave them alone.
// NS-periodic grids are refused by the wrapper.
//
// Bound on the H100: bytes.  uv_solve reads 5 N-fields, 1 (N+1)-field
// and 10 planes and writes 2 N-fields; uv_finish reads 5 N-fields and 8
// planes and writes 4 N-fields and 2 planes.  The Thomas sweep is ~20
// flops per level.
//
// Design, both entry points: one thread per column and component (u and
// v in different blocks, the two blocks of a column range next to each
// other so that they share Hz (and uv_solve's Akv) in L2), streaming the
// column's levels once from device memory with a few levels in flight in
// registers; what the later passes need lives in dynamic shared memory
// laid out [k][thread] and sized by N, threads a block by element size
// (ops/uv.py solve_launch_shape, finish_launch_shape).  No local array,
// so no stack frame; a depth whose state exceeds a block's shared memory
// is refused by the wrapper.
#include "common.cuh"

namespace {

using roms::allow_smem;
using roms::mul_rn;
using roms::wrap;

// levels a column sweep keeps in flight ahead of the one it works on
constexpr int kAhead = 4;

template <typename T>
struct SolveArgs {
  const T *u_part, *v_part, *ru, *rv, *Hz, *Akv, *pm, *pn;
  const T *umask, *vmask, *on_u, *om_v, *DU1, *DV1;
  T *out_u, *out_v;
  int N, Mj, Li;
  T dt, cffab;
};

// the face average 0.5 (f[c] + f[cn]) of level k
template <typename T>
__device__ __forceinline__ T face(const T* f, size_t o, size_t c, size_t cn) {
  return T(0.5) * (f[o + c] + f[o + cn]);
}

// One column of one component of uv_solve: block x = 2 b + component
// (u, v) holds columns b B .. b B + B - 1, its neighbour for the face
// averages at (j, i-1) for u and (j-1, i) for v.
//
// The spline solve of pallas_uv.py _spline_dq (ops/tridiag.py
// spline_flux_solve over tridiag_plain) as one streaming sweep (vdiff.cu
// runs the same sweep on the tracers):
//   forward, k = 0 .. N-1: level k's face thickness hz, AB3 seed q and
//     face viscosity AK(k+1) are formed as they arrive (the raw values of
//     the next kAhead levels in flight), and interface k's Thomas row is
//     eliminated at once: cp, dp;
//   backward, k = N-1 .. 0: back substitution DC(k) and q += dq in one
//     pass, AK(k) read again (from L2, kAhead levels ahead);
//   then the thickness-weighted sums of _correct in torch.sum's order
//     over dim 0 below 64 levels (four accumulators by k mod 4, combined
//     in order), and a last pass that writes (q - err) mask.
// What the passes keep lives in shared memory laid out [k][thread]
// (conflict-free): hz and q (N each), cp and dp (N-1 each), no local
// array, so no stack frame.  Every product that feeds an add or subtract
// is mul_rn and the quotients are IEEE divisions, so each value rounds as
// in the plain version.
template <typename T>
__global__ void uv_solve_kernel(const __grid_constant__ SolveArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int B = blockDim.x, N = a.N, Li = a.Li;
  const size_t P = static_cast<size_t>(a.Mj) * Li;
  const bool vc = blockIdx.x & 1;
  const size_t c = static_cast<size_t>(blockIdx.x >> 1) * B + threadIdx.x;
  if (c >= P) return;   // no barrier below: each thread owns its slots
  const int i = static_cast<int>(c % Li), j = static_cast<int>(c / Li);
  const size_t cn = vc ? static_cast<size_t>(wrap(j - 1, a.Mj)) * Li + i
                       : c - i + wrap(i - 1, Li);
  const T* part = vc ? a.v_part : a.u_part;
  const T* r = vc ? a.rv : a.ru;
  T* hz_s = reinterpret_cast<T*>(smem) + threadIdx.x;
  T* q_s = hz_s + static_cast<size_t>(N) * B;
  T* cp_s = q_s + static_cast<size_t>(N) * B;
  T* dp_s = cp_s + static_cast<size_t>(N - 1) * B;
  const T dt = a.dt, sixth = T(1.0 / 6.0), third = T(1.0 / 3.0);
  const T DC0 = mul_rn(mul_rn(a.cffab, a.pm[c] + a.pm[cn]),
                       a.pn[c] + a.pn[cn]);

  // forward: the raw values of levels k+1 .. k+kAhead are in flight while
  // interface k's row is eliminated (a ring of registers, slot u of each
  // unrolled group of kAhead levels)
  T hz0 = face(a.Hz, 0, c, cn);
  T q0 = (part[c] + mul_rn(DC0, r[c])) / hz0;
  T o0 = T(1.0) / hz0;
  T ak0 = face(a.Akv, 0, c, cn), ak1 = face(a.Akv, P, c, cn);
  hz_s[0] = hz0;
  q_s[0] = q0;
  T cpp = T(0), dpp = T(0);
  T rh0[kAhead], rh1[kAhead], rp[kAhead], rr[kAhead], ra0[kAhead], ra1[kAhead];
  auto fetch = [&](int k, int u) {
    const size_t o = static_cast<size_t>(k) * P;
    rh0[u] = a.Hz[o + c];
    rh1[u] = a.Hz[o + cn];
    rp[u] = part[o + c];
    rr[u] = r[o + c];
    ra0[u] = a.Akv[o + P + c];
    ra1[u] = a.Akv[o + P + cn];
  };
#pragma unroll
  for (int u = 0; u < kAhead; ++u)
    if (1 + u < N) fetch(1 + u, u);
  for (int k0 = 1; k0 < N; k0 += kAhead) {
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int k = k0 + u;
      if (k >= N) break;
      const T hz1 = T(0.5) * (rh0[u] + rh1[u]);
      const T q1 = (rp[u] + mul_rn(DC0, rr[u])) / hz1;
      const T ak2 = T(0.5) * (ra0[u] + ra1[u]);
      if (k + kAhead < N) fetch(k + kAhead, u);
      const T o1 = T(1.0) / hz1;
      // interface k (row k-1): FC DC(k-1) + BC DC(k) + CF DC(k+1) = q1 - q0
      const T FC = mul_rn(sixth, hz0) - mul_rn(mul_rn(dt, ak0), o0);
      const T CF = mul_rn(sixth, hz1) - mul_rn(mul_rn(dt, ak2), o1);
      const T BC =
          mul_rn(third, hz0 + hz1) + mul_rn(mul_rn(dt, ak1), o0 + o1);
      const T denom = T(1.0) / (BC - mul_rn(FC, cpp));
      cpp = mul_rn(CF, denom);
      dpp = mul_rn((q1 - q0) - mul_rn(FC, dpp), denom);
      cp_s[static_cast<size_t>(k - 1) * B] = cpp;
      dp_s[static_cast<size_t>(k - 1) * B] = dpp;
      hz_s[static_cast<size_t>(k) * B] = hz1;
      q_s[static_cast<size_t>(k) * B] = q1;
      hz0 = hz1;
      q0 = q1;
      o0 = o1;
      ak0 = ak1;
      ak1 = ak2;
    }
  }

  // backward: DC(k) = x(k-1) and q(k) += dt/hz (AK(k+1) DC(k+1) - AK(k)
  // DC(k)), AK(k) read again kAhead levels ahead; ak1 holds AK(N)
  T flux_hi = mul_rn(ak1, T(0));
  T xn = T(0);
#pragma unroll
  for (int u = 0; u < kAhead; ++u) {
    if (N - 1 - u >= 0) {
      const size_t o = static_cast<size_t>(N - 1 - u) * P;
      ra0[u] = a.Akv[o + c];
      ra1[u] = a.Akv[o + cn];
    }
  }
  for (int k0 = N - 1; k0 >= 0; k0 -= kAhead) {
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int k = k0 - u;
      if (k < 0) break;
      const T ak_here = T(0.5) * (ra0[u] + ra1[u]);
      if (k - kAhead >= 0) {
        const size_t o = static_cast<size_t>(k - kAhead) * P;
        ra0[u] = a.Akv[o + c];
        ra1[u] = a.Akv[o + cn];
      }
      T flux_lo;
      if (k > 0) {
        const size_t m = static_cast<size_t>(k - 1) * B;
        xn = dp_s[m] - mul_rn(cp_s[m], xn);
        flux_lo = mul_rn(ak_here, xn);
      } else {
        flux_lo = mul_rn(ak_here, T(0));
      }
      const size_t o = static_cast<size_t>(k) * B;
      const T dq = mul_rn(mul_rn(dt, T(1.0) / hz_s[o]), flux_hi - flux_lo);
      q_s[o] = q_s[o] + dq;
      flux_hi = flux_lo;
    }
  }

  // _correct: torch.sum over dim 0 keeps four accumulators (k mod 4)
  T d[4] = {T(0), T(0), T(0), T(0)}, s[4] = {T(0), T(0), T(0), T(0)};
  for (int k0 = 0; k0 < N; k0 += 4) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (k0 + u < N) {
        const size_t o = static_cast<size_t>(k0 + u) * B;
        const T h = hz_s[o];
        d[u] = d[u] + h;
        s[u] = s[u] + mul_rn(q_s[o], h);
      }
    }
  }
  const T D = ((d[0] + d[1]) + d[2]) + d[3];
  const T S = ((s[0] + s[1]) + s[2]) + s[3];
  const T scale = vc ? a.om_v[c] : a.on_u[c];
  const T avg1 = vc ? a.DV1[c] : a.DU1[c];
  const T mask = vc ? a.vmask[c] : a.umask[c];
  const T err = (mul_rn(S, scale) - avg1) / mul_rn(D, scale);
  T* out = vc ? a.out_v : a.out_u;
  for (int k = 0; k < N; ++k)
    out[static_cast<size_t>(k) * P + c] =
        mul_rn(q_s[static_cast<size_t>(k) * B] - err, mask);
}

template <typename T>
struct FinishArgs {
  const T *un, *vn, *Hz, *Huon_old, *Hvom_old;
  const T *umask, *vmask, *on_u, *om_v, *DU1, *DV1, *DU2, *DV2;
  T *out_u, *out_v, *ubar, *vbar, *Huon, *Hvom;
  int N, Mj, Li, ewp;
};

// One column of one component of uv_finish: block x = 2 b + component
// (u, v) holds columns b B .. b B + B - 1, its face neighbour at (j, i-1)
// for u and (j-1, i) for v.  Three passes over the column:
//   1. k = 0 .. N-1, streamed (kAhead levels in flight): the face
//      thickness hz, D = sum hz and S = sum q hz of _correct; hz*scale
//      and q kept;
//   2. from shared memory: q <- (q - err) mask written, and the
//      time-centred flux F = 0.5 (F_old + q hz scale), F_old streamed, its
//      sum kept and F kept in q's slot;
//   3. F - hz scale err2 written, on an EW-periodic grid by the threads
//      of lanes Li-2 and 1 into lanes 0 and Li-1 as well (st.periodic_x),
//      whose own threads leave their flux column alone.
// The sums run in torch.sum's order over dim 0 below 64 levels (four
// accumulators by k mod 4, combined in order).  hz*scale and q live in
// shared memory [k][thread] (2 N values a thread), no local array.  Every
// product that feeds an add or subtract is mul_rn and the quotients are
// IEEE divisions, so each value rounds as in the plain version.
template <typename T>
__global__ void uv_finish_kernel(const __grid_constant__ FinishArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int B = blockDim.x, N = a.N, Li = a.Li;
  const size_t P = static_cast<size_t>(a.Mj) * Li;
  const bool vc = blockIdx.x & 1;
  const size_t c = static_cast<size_t>(blockIdx.x >> 1) * B + threadIdx.x;
  if (c >= P) return;   // no barrier below: each thread owns its slots
  const int i = static_cast<int>(c % Li), j = static_cast<int>(c / Li);
  const size_t cn = vc ? static_cast<size_t>(wrap(j - 1, a.Mj)) * Li + i
                       : c - i + wrap(i - 1, Li);
  const T* qn = vc ? a.vn : a.un;
  const T* old = vc ? a.Hvom_old : a.Huon_old;
  const T scale = vc ? a.om_v[c] : a.on_u[c];
  const T avg1 = vc ? a.DV1[c] : a.DU1[c];
  const T avg2 = vc ? a.DV2[c] : a.DU2[c];
  const T mask = vc ? a.vmask[c] : a.umask[c];
  T* hs_s = reinterpret_cast<T*>(smem) + threadIdx.x;
  T* q_s = hs_s + static_cast<size_t>(N) * B;
  static_assert(kAhead == 4, "the ring's slot is the sums' k mod 4");

  // 1. hz, D and S; the raw values of levels k+1 .. k+kAhead in flight
  T d[4] = {T(0), T(0), T(0), T(0)}, s[4] = {T(0), T(0), T(0), T(0)};
  T rh0[kAhead], rh1[kAhead], rq[kAhead];
  auto fetch = [&](int k, int u) {
    const size_t o = static_cast<size_t>(k) * P;
    rh0[u] = a.Hz[o + c];
    rh1[u] = a.Hz[o + cn];
    rq[u] = qn[o + c];
  };
#pragma unroll
  for (int u = 0; u < kAhead; ++u)
    if (u < N) fetch(u, u);
  for (int k0 = 0; k0 < N; k0 += kAhead) {
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int k = k0 + u;
      if (k >= N) break;
      const T hz = T(0.5) * (rh0[u] + rh1[u]);
      const T q = rq[u];
      if (k + kAhead < N) fetch(k + kAhead, u);
      d[u] = d[u] + hz;
      s[u] = s[u] + mul_rn(q, hz);
      const size_t o = static_cast<size_t>(k) * B;
      hs_s[o] = mul_rn(hz, scale);
      q_s[o] = q;
    }
  }
  const T D = ((d[0] + d[1]) + d[2]) + d[3];
  const T S = ((s[0] + s[1]) + s[2]) + s[3];
  const T Ds = mul_rn(D, scale);
  const T err = (mul_rn(S, scale) - avg1) / Ds;
  (vc ? a.vbar : a.ubar)[c] = avg1 / Ds * mask;

  // 2. the corrected velocity and the time-centred flux; F_old in flight
  T* out_q = vc ? a.out_v : a.out_u;
  T f[4] = {T(0), T(0), T(0), T(0)}, ro[kAhead];
#pragma unroll
  for (int u = 0; u < kAhead; ++u)
    if (u < N) ro[u] = old[static_cast<size_t>(u) * P + c];
  for (int k0 = 0; k0 < N; k0 += kAhead) {
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int k = k0 + u;
      if (k >= N) break;
      const T fo = ro[u];
      if (k + kAhead < N) ro[u] = old[static_cast<size_t>(k + kAhead) * P + c];
      const size_t o = static_cast<size_t>(k) * B;
      const T q = mul_rn(q_s[o] - err, mask);
      out_q[static_cast<size_t>(k) * P + c] = q;
      const T F = T(0.5) * (fo + mul_rn(q, hs_s[o]));
      q_s[o] = F;
      f[u] = f[u] + F;
    }
  }
  const T err2 = ((((f[0] + f[1]) + f[2]) + f[3]) - avg2) / Ds;

  // 3. the flux made consistent with avg2, and the periodic lanes
  T* flux = vc ? a.Hvom : a.Huon;
  const bool own = !a.ewp || (i != 0 && i != Li - 1);
  const size_t c2 = !a.ewp ? P : (i == Li - 2 ? c - i
                                              : (i == 1 ? c - i + Li - 1 : P));
  for (int k = 0; k < N; ++k) {
    const size_t o = static_cast<size_t>(k) * B;
    const T F = q_s[o] - mul_rn(hs_s[o], err2);
    const size_t g = static_cast<size_t>(k) * P;
    if (own) flux[g + c] = F;
    if (c2 < P) flux[g + c2] = F;
  }
}

template <typename T>
int solve(const SolveArgs<T>& a, int threads, void* stream) {
  const size_t smem = sizeof(T) * static_cast<size_t>(4 * a.N - 2) * threads;
  const cudaError_t err = allow_smem(uv_solve_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long P = static_cast<long long>(a.Mj) * a.Li;
  const int blocks = static_cast<int>(2 * ((P + threads - 1) / threads));
  uv_solve_kernel<T><<<blocks, threads, smem,
                       static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int finish(const FinishArgs<T>& a, int threads, void* stream) {
  const size_t smem = sizeof(T) * static_cast<size_t>(2 * a.N) * threads;
  const cudaError_t err = allow_smem(uv_finish_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long P = static_cast<long long>(a.Mj) * a.Li;
  const int blocks = static_cast<int>(2 * ((P + threads - 1) / threads));
  uv_finish_kernel<T><<<blocks, threads, smem,
                        static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define ROMS_UV_ENTRIES(SOLVE, FINISH, T)                                    \
  extern "C" int SOLVE(const void* u_part, const void* v_part,              \
                       const void* ru, const void* rv, const void* Hz,      \
                       const void* Akv, const void* pm, const void* pn,     \
                       const void* umask, const void* vmask,                \
                       const void* on_u, const void* om_v, const void* DU1, \
                       const void* DV1, void* out_u, void* out_v, int N,    \
                       int Mj, int Li, double dt, double cffab, int threads, \
                       void* stream) {                                      \
    SolveArgs<T> a{                                                          \
        (const T*)u_part, (const T*)v_part, (const T*)ru,   (const T*)rv,   \
        (const T*)Hz,     (const T*)Akv,    (const T*)pm,   (const T*)pn,   \
        (const T*)umask,  (const T*)vmask,  (const T*)on_u, (const T*)om_v, \
        (const T*)DU1,    (const T*)DV1,    (T*)out_u,      (T*)out_v,      \
        N, Mj, Li, T(dt), T(cffab)};                                         \
    return solve<T>(a, threads, stream);                                     \
  }                                                                          \
  extern "C" int FINISH(const void* un, const void* vn, const void* Hz,     \
                        const void* Huon_old, const void* Hvom_old,         \
                        const void* umask, const void* vmask,               \
                        const void* on_u, const void* om_v, const void* DU1, \
                        const void* DV1, const void* DU2, const void* DV2,  \
                        void* out_u, void* out_v, void* ubar, void* vbar,   \
                        void* Huon, void* Hvom, int N, int Mj, int Li,      \
                        int ewp, int threads, void* stream) {               \
    FinishArgs<T> a{                                                         \
        (const T*)un,    (const T*)vn,    (const T*)Hz,                     \
        (const T*)Huon_old, (const T*)Hvom_old, (const T*)umask,            \
        (const T*)vmask, (const T*)on_u,  (const T*)om_v, (const T*)DU1,    \
        (const T*)DV1,   (const T*)DU2,   (const T*)DV2,  (T*)out_u,        \
        (T*)out_v,       (T*)ubar,        (T*)vbar,       (T*)Huon,         \
        (T*)Hvom,        N, Mj, Li, ewp};                                    \
    return finish<T>(a, threads, stream);                                    \
  }

ROMS_UV_ENTRIES(roms_uv_solve_f32, roms_uv_finish_f32, float)
ROMS_UV_ENTRIES(roms_uv_solve_f64, roms_uv_finish_f64, double)
