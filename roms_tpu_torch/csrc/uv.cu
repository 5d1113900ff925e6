// Kernel 4: the 3D momentum corrector (step3d_uv.F:261-1716), two entry
// points:
//   uv_solve:  AB3 seed, spline implicit vertical viscosity for u and v
//              (spline_dq.cuh) and the first replacement of the vertical
//              mean by DU_avg1/DV_avg1; output before bc_u/bc_v.
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
// Design: one thread per (j, i) column, i fastest for coalesced k-plane
// access; the column lives in per-thread local arrays (bound kNmax).
#include "common.cuh"
#include "spline_dq.cuh"

namespace {

using roms::kNmax;
using roms::wrap;

template <typename T>
struct SolveArgs {
  const T *u_part, *v_part, *ru, *rv, *Hz, *Akv, *pm, *pn;
  const T *umask, *vmask, *on_u, *om_v, *DU1, *DV1;
  T *out_u, *out_v;
  int N, Mj, Li;
  T dt, cffab;
};

// q <- (q - err)*mask, err from the thickness-weighted mean vs avg1
// (roms_tpu/ops/pallas_uv.py _correct)
template <typename T>
__device__ void correct(int N, T* q, const T* Hzq, T scale, T avg1,
                        T mask) {
  T D = T(0), s = T(0);
  for (int k = 0; k < N; ++k) {
    D = D + Hzq[k];
    s = s + q[k] * Hzq[k];
  }
  const T err = (s * scale - avg1) / (D * scale);
  for (int k = 0; k < N; ++k) q[k] = (q[k] - err) * mask;
}

// one component of uv_solve at column c, its face neighbour at cn:
// AB3 seed over the face thickness, spline viscosity, mean replacement
template <typename T>
__device__ void solve_column(const SolveArgs<T>& a, int c, int cn,
                             const T* part, const T* r, T scale, T avg1,
                             T mask, T* out) {
  const int N = a.N;
  const int P = a.Mj * a.Li;
  T hz[kNmax], ak[kNmax + 1], q[kNmax];
  const T DC0 = a.cffab * (a.pm[c] + a.pm[cn]) * (a.pn[c] + a.pn[cn]);
  for (int k = 0; k < N; ++k) {
    const size_t o = static_cast<size_t>(k) * P;
    hz[k] = T(0.5) * (a.Hz[o + c] + a.Hz[o + cn]);
    q[k] = (part[o + c] + DC0 * r[o + c]) / hz[k];
  }
  for (int k = 0; k <= N; ++k) {
    const size_t o = static_cast<size_t>(k) * P;
    ak[k] = T(0.5) * (a.Akv[o + c] + a.Akv[o + cn]);
  }
  roms::spline_dq_inplace<T, kNmax>(N, hz, ak, q, a.dt);
  correct(N, q, hz, scale, avg1, mask);
  for (int k = 0; k < N; ++k) out[static_cast<size_t>(k) * P + c] = q[k];
}

template <typename T>
__global__ void uv_solve_kernel(SolveArgs<T> a) {
  const int Li = a.Li;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= a.Mj * Li) return;
  const int i = c % Li, j = c / Li;
  const int cw = c - i + wrap(i - 1, Li);      // (j, i-1)
  const int cs = wrap(j - 1, a.Mj) * Li + i;   // (j-1, i)
  solve_column(a, c, cw, a.u_part, a.ru, a.on_u[c], a.DU1[c], a.umask[c],
               a.out_u);
  solve_column(a, c, cs, a.v_part, a.rv, a.om_v[c], a.DV1[c], a.vmask[c],
               a.out_v);
}

template <typename T>
struct FinishArgs {
  const T *un, *vn, *Hz, *Huon_old, *Hvom_old;
  const T *umask, *vmask, *on_u, *om_v, *DU1, *DV1, *DU2, *DV2;
  T *out_u, *out_v, *ubar, *vbar, *Huon, *Hvom;
  int N, Mj, Li, ewp;
};

// re-correction, barotropic velocity and time-centred flux of one
// column of one component, its face neighbour at cn; the flux column goes
// to lane c unless `own` is false, and to lane c2 as well when c2 >= 0
template <typename T>
__device__ void finish_column(const FinishArgs<T>& a, int c, int cn,
                              const T* qn, const T* flux_old, T scale,
                              T avg1, T avg2, T mask, T* out_q, T* out_bar,
                              T* out_flux, bool own, int c2) {
  const int N = a.N;
  const int P = a.Mj * a.Li;
  T hz[kNmax], q[kNmax];
  T D = T(0);
  for (int k = 0; k < N; ++k) {
    const size_t o = static_cast<size_t>(k) * P;
    hz[k] = T(0.5) * (a.Hz[o + c] + a.Hz[o + cn]);
    q[k] = qn[o + c];
    D = D + hz[k];
  }
  correct(N, q, hz, scale, avg1, mask);
  for (int k = 0; k < N; ++k) out_q[static_cast<size_t>(k) * P + c] = q[k];
  out_bar[c] = avg1 / (D * scale) * mask;
  T sum = T(0);
  for (int k = 0; k < N; ++k) {
    const size_t o = static_cast<size_t>(k) * P + c;
    q[k] = T(0.5) * (flux_old[o] + q[k] * (hz[k] * scale));
    sum = sum + q[k];
  }
  const T err = (sum - avg2) / (D * scale);
  for (int k = 0; k < N; ++k) {
    const T f = q[k] - hz[k] * scale * err;
    if (own) out_flux[static_cast<size_t>(k) * P + c] = f;
    if (c2 >= 0) out_flux[static_cast<size_t>(k) * P + c2] = f;
  }
}

template <typename T>
__global__ void uv_finish_kernel(FinishArgs<T> a) {
  const int Li = a.Li;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= a.Mj * Li) return;
  const int i = c % Li, j = c / Li;
  const int cw = c - i + wrap(i - 1, Li);      // (j, i-1)
  const int cs = wrap(j - 1, a.Mj) * Li + i;   // (j-1, i)
  // periodic lanes: lane 0 <- lane Li-2, lane Li-1 <- lane 1
  const bool own = !a.ewp || (i != 0 && i != Li - 1);
  const int c2 = !a.ewp ? -1 : (i == Li - 2 ? c - i : (i == 1 ? c - i + Li - 1
                                                               : -1));
  finish_column(a, c, cw, a.un, a.Huon_old, a.on_u[c], a.DU1[c], a.DU2[c],
                a.umask[c], a.out_u, a.ubar, a.Huon, own, c2);
  finish_column(a, c, cs, a.vn, a.Hvom_old, a.om_v[c], a.DV1[c], a.DV2[c],
                a.vmask[c], a.out_v, a.vbar, a.Hvom, own, c2);
}

}  // namespace

#define ROMS_UV_ENTRIES(SOLVE, FINISH, T)                                    \
  extern "C" int SOLVE(const void* u_part, const void* v_part,              \
                       const void* ru, const void* rv, const void* Hz,      \
                       const void* Akv, const void* pm, const void* pn,     \
                       const void* umask, const void* vmask,                \
                       const void* on_u, const void* om_v, const void* DU1, \
                       const void* DV1, void* out_u, void* out_v, int N,    \
                       int Mj, int Li, double dt, double cffab,             \
                       void* stream) {                                      \
    SolveArgs<T> a{                                                          \
        (const T*)u_part, (const T*)v_part, (const T*)ru,   (const T*)rv,   \
        (const T*)Hz,     (const T*)Akv,    (const T*)pm,   (const T*)pn,   \
        (const T*)umask,  (const T*)vmask,  (const T*)on_u, (const T*)om_v, \
        (const T*)DU1,    (const T*)DV1,    (T*)out_u,      (T*)out_v,      \
        N, Mj, Li, T(dt), T(cffab)};                                         \
    uv_solve_kernel<T><<<roms::blocks_for((long long)Mj * Li),              \
                         roms::kThreads, 0, (cudaStream_t)stream>>>(a);     \
    return (int)cudaGetLastError();                                          \
  }                                                                          \
  extern "C" int FINISH(const void* un, const void* vn, const void* Hz,     \
                        const void* Huon_old, const void* Hvom_old,         \
                        const void* umask, const void* vmask,               \
                        const void* on_u, const void* om_v, const void* DU1, \
                        const void* DV1, const void* DU2, const void* DV2,  \
                        void* out_u, void* out_v, void* ubar, void* vbar,   \
                        void* Huon, void* Hvom, int N, int Mj, int Li,      \
                        int ewp, void* stream) {                            \
    FinishArgs<T> a{                                                         \
        (const T*)un,    (const T*)vn,    (const T*)Hz,                     \
        (const T*)Huon_old, (const T*)Hvom_old, (const T*)umask,            \
        (const T*)vmask, (const T*)on_u,  (const T*)om_v, (const T*)DU1,    \
        (const T*)DV1,   (const T*)DU2,   (const T*)DV2,  (T*)out_u,        \
        (T*)out_v,       (T*)ubar,        (T*)vbar,       (T*)Huon,         \
        (T*)Hvom,        N, Mj, Li, ewp};                                    \
    uv_finish_kernel<T><<<roms::blocks_for((long long)Mj * Li),             \
                          roms::kThreads, 0, (cudaStream_t)stream>>>(a);    \
    return (int)cudaGetLastError();                                          \
  }

ROMS_UV_ENTRIES(roms_uv_solve_f32, roms_uv_finish_f32, float)
ROMS_UV_ENTRIES(roms_uv_solve_f64, roms_uv_finish_f64, double)
