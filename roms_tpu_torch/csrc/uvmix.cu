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
// (N) and rufrc, rvfrc: ~7 words a point against ~120 flops.
//
// Design: one thread per (j, i) column walks k bottom-up, so the vertical
// sums run in registers in level order, and writes each level's seeds.
// The four stress components at the neighbouring faces are recomputed per
// point from the +-1 stencil (neighbour reuse from L1/L2).  Every product
// that feeds an add or subtract is mul_rn, so each value rounds as in the
// plain version.
#include "common.cuh"

namespace {

using roms::mul_rn;
using roms::wrap;

template <typename T>
struct Args {
  const T *u, *v, *Hz, *u_part, *v_part, *rufrc, *rvfrc;
  // the 13 metrics of pallas_uvmix._G2D
  const T *pn, *pm, *pmon_r, *pnom_r, *on_r, *om_r, *pmon_p, *pnom_p, *on_p,
      *om_p, *pmask, *visc2_r, *visc2_p;
  T *out_up, *out_vp, *out_ruf, *out_rvf;
  int N, Mj, Li;
  T dt4;            // dt * 0.25
};

template <typename T>
struct Level {
  const Args<T>& a;
  const T *u, *v, *Hz;   // this level
  int Mj, Li;

  __device__ int at(int j, int i) const {
    return wrap(j, Mj) * Li + wrap(i, Li);
  }
  // products of the face metrics with the velocities at point (j, i)
  __device__ T upn_u(int j, int i) const {
    const int c = at(j, i), cw = at(j, i - 1);
    return mul_rn(a.pn[c] + a.pn[cw], u[c]);
  }
  __device__ T vpm_v(int j, int i) const {
    const int c = at(j, i), cs = at(j - 1, i);
    return mul_rn(a.pm[c] + a.pm[cs], v[c]);
  }
  __device__ T vpn_v(int j, int i) const {
    const int c = at(j, i), cs = at(j - 1, i);
    return mul_rn(a.pn[c] + a.pn[cs], v[c]);
  }
  __device__ T upm_u(int j, int i) const {
    const int c = at(j, i), cw = at(j, i - 1);
    return mul_rn(a.pm[c] + a.pm[cw], u[c]);
  }
  // rho-point stress factor Hz*0.5*(pmon_r*dx_p(upn*u) - pnom_r*dy_p(vpm*v))
  __device__ T cff_r(int j, int i) const {
    const int c = at(j, i);
    const T dxp = upn_u(j, i + 1) - upn_u(j, i);
    const T dyp = vpm_v(j + 1, i) - vpm_v(j, i);
    return Hz[c] * T(0.5) *
           (mul_rn(a.pmon_r[c], dxp) - mul_rn(a.pnom_r[c], dyp));
  }
  // psi-point stress factor
  __device__ T cff_p(int j, int i) const {
    const int c = at(j, i);
    const T Hzp = T(0.25) * (Hz[c] + Hz[at(j, i - 1)] + Hz[at(j - 1, i)] +
                             Hz[at(j - 1, i - 1)]);
    const T dxm = vpn_v(j, i) - vpn_v(j, i - 1);
    const T dym = upm_u(j, i) - upm_u(j - 1, i);
    return T(0.5) * Hzp *
           (mul_rn(a.pmon_p[c], dxm) + mul_rn(a.pnom_p[c], dym)) *
           a.pmask[c];
  }
  // the four stress components, ringed onto the periodic lanes
  __device__ T UFx(int j, int i) const {
    i = roms::ring_x(wrap(i, Li), Li, true);
    const int c = at(j, i);
    return mul_rn(a.on_r[c] * a.on_r[c] * a.visc2_r[c], cff_r(j, i));
  }
  __device__ T VFe(int j, int i) const {
    i = roms::ring_x(wrap(i, Li), Li, true);
    const int c = at(j, i);
    return mul_rn(a.om_r[c] * a.om_r[c] * a.visc2_r[c], cff_r(j, i));
  }
  __device__ T UFe(int j, int i) const {
    i = roms::ring_x(wrap(i, Li), Li, true);
    const int c = at(j, i);
    return mul_rn(a.om_p[c] * a.om_p[c] * a.visc2_p[c], cff_p(j, i));
  }
  __device__ T VFx(int j, int i) const {
    i = roms::ring_x(wrap(i, Li), Li, true);
    const int c = at(j, i);
    return mul_rn(a.on_p[c] * a.on_p[c] * a.visc2_p[c], cff_p(j, i));
  }
};

template <typename T>
__global__ void uvmix_kernel(Args<T> a) {
  const int Li = a.Li, Mj = a.Mj;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= Mj * Li) return;
  const size_t P = static_cast<size_t>(Mj) * Li;
  const int i = c % Li, j = c / Li;
  const int cw = j * Li + wrap(i - 1, Li), cs = wrap(j - 1, Mj) * Li + i;
  const T upn = a.pn[c] + a.pn[cw], upm = a.pm[c] + a.pm[cw];
  const T vpn = a.pn[c] + a.pn[cs], vpm = a.pm[c] + a.pm[cs];
  T su = T(0), sv = T(0);
  for (int k = 0; k < a.N; ++k) {
    const size_t o = k * P;
    const Level<T> L{a, a.u + o, a.v + o, a.Hz + o, Mj, Li};
    const T du = mul_rn(T(0.5) * upn, L.UFx(j, i) - L.UFx(j, i - 1)) +
                 mul_rn(T(0.5) * upm, L.UFe(j + 1, i) - L.UFe(j, i));
    const T dv = mul_rn(T(0.5) * vpn, L.VFx(j, i + 1) - L.VFx(j, i)) -
                 mul_rn(T(0.5) * vpm, L.VFe(j, i) - L.VFe(j - 1, i));
    a.out_up[o + c] = a.u_part[o + c] + mul_rn(a.dt4 * upm * upn, du);
    a.out_vp[o + c] = a.v_part[o + c] + mul_rn(a.dt4 * vpm * vpn, dv);
    su = k == 0 ? du : su + du;
    sv = k == 0 ? dv : sv + dv;
  }
  a.out_ruf[c] = a.rufrc[c] + su;
  a.out_rvf[c] = a.rvfrc[c] + sv;
}

}  // namespace

#define ROMS_UVMIX_ENTRY(NAME, T)                                            \
  extern "C" int NAME(const void* const* in, void* const* out, int N,       \
                      int Mj, int Li, double dt, void* stream) {            \
    const T* const* f = reinterpret_cast<const T* const*>(in);              \
    Args<T> a{f[0],  f[1],  f[2],  f[3],  f[4],  f[5],  f[6],  f[7],        \
              f[8],  f[9],  f[10], f[11], f[12], f[13], f[14], f[15],       \
              f[16], f[17], f[18], f[19],                                   \
              static_cast<T*>(out[0]), static_cast<T*>(out[1]),             \
              static_cast<T*>(out[2]), static_cast<T*>(out[3]),             \
              N, Mj, Li, T(dt * 0.25)};                                     \
    uvmix_kernel<T><<<roms::blocks_for(static_cast<long long>(Mj) * Li),    \
                      roms::kThreads, 0,                                    \
                      static_cast<cudaStream_t>(stream)>>>(a);              \
    return static_cast<int>(cudaGetLastError());                            \
  }

ROMS_UVMIX_ENTRY(roms_uv3dmix2_s_f32, float)
ROMS_UVMIX_ENTRY(roms_uv3dmix2_s_f64, double)
