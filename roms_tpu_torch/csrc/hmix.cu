// Kernel 16: rotated (geopotential) triad divergence of every tracer,
// the operator of t3dmix2_geo.h / t3dmix4_geo.h.
//
// Replaces roms_tpu/ops/pallas_hmix.py:185 rot_div_geo_batched (and the
// single-tracer rot_div_geo_pallas at l.251; pallas_call at l.232).
// Plain version core/hmix.py _rot_div_geo, applied to each tracer
// (ops/hmix.py rot_div_geo_plain).
//
// Ring rows: the Pallas kernel zeroes output rows j = 0 and Mj-1; this
// kernel keeps the jnp path's roll wrap there (row 0 reads row Mj-1 as
// its j-1 neighbour, row Mj-1 reads row 0 as its j+1 one), so it equals
// its plain version over whole arrays.  The EW-periodic lanes follow
// st.periodic_x through roms::ring_x: the slopes dZdx, the gradients
// dTdx and the fluxes FX at lanes 0 and Li-1 are those of lanes Li-2 and
// 1 (pallas_hmix.py _perx).
//
// Bound on the H100: bytes.  Per point it reads q (NT levels), z_r and
// Hz and writes NT levels, ~(2 NT + 2) words per level against ~60 flops
// per tracer level.
//
// Design: one thread per (j, i) column, consecutive threads on
// consecutive i, walking k upwards for each tracer in turn; the
// cross-flux FS of the interface above is carried to the next level.
// Each thread evaluates the fluxes it needs at i, i+1, j and j+1 from
// its neighbours' loads (L1/L2 hits) instead of staging a tile in
// shared memory: simple first, the tile is later work.  Every product
// that feeds an add or subtract is mul_rn, so each value rounds as in
// the plain version.
#include "common.cuh"

namespace {

using roms::mul_rn;

template <typename T>
__device__ __forceinline__ T mn0(T x) { return x < T(0) ? x : T(0); }
template <typename T>
__device__ __forceinline__ T mx0(T x) { return x > T(0) ? x : T(0); }

template <typename T>
struct Geo {
  const T* q;                     // (N, Mj, Li) of one tracer
  const T* z;                     // z_r
  const T* Hz;
  const T* pm_u;                  // (Mj, Li)
  const T* pn_v;
  const T* cff_u;                 // (Mj, Li) of one tracer
  const T* cff_v;
  int N, Mj, Li;
  bool ewp;
  size_t P;

  __device__ size_t at(int k, int j, int i) const {
    return static_cast<size_t>(k) * P + static_cast<size_t>(j) * Li + i;
  }
  __device__ int iw(int i) const { return roms::wrap(i, Li); }
  __device__ int jw(int j) const { return roms::wrap(j, Mj); }
  __device__ int lane(int i) const { return roms::ring_x(i, Li, ewp); }

  // dT/dz at interface kk (0..N) of column (j, i); zero end interfaces
  __device__ T dTdz(int kk, int j, int i) const {
    if (kk == 0 || kk == N) return T(0);
    return (q[at(kk, j, i)] - q[at(kk - 1, j, i)]) /
           (z[at(kk, j, i)] - z[at(kk - 1, j, i)]);
  }
  // x-gradient of f at U point (j, i) after st.periodic_x
  __device__ T ddx(const T* f, int k, int j, int i) const {
    const int m = lane(i);
    return mul_rn(pm_u[static_cast<size_t>(j) * Li + m],
                  f[at(k, j, m)] - f[at(k, j, iw(m - 1))]);
  }
  // y-gradient of f at V point (j, i)
  __device__ T dde(const T* f, int k, int j, int i) const {
    return mul_rn(pn_v[static_cast<size_t>(j) * Li + i],
                  f[at(k, j, i)] - f[at(k, jw(j - 1), i)]);
  }
  // FX at U point (j, i) after st.periodic_x (t3dmix2_geo.h:205-225)
  __device__ T FX(int k, int j, int i) const {
    const int m = lane(i), mm = iw(m - 1);
    const T sZ = ddx(z, k, j, m);
    const T corr = mul_rn(mn0(sZ), dTdz(k, j, mm) + dTdz(k + 1, j, m)) +
                   mul_rn(mx0(sZ), dTdz(k + 1, j, mm) + dTdz(k, j, m));
    return mul_rn(mul_rn(cff_u[static_cast<size_t>(j) * Li + m],
                         Hz[at(k, j, m)] + Hz[at(k, j, mm)]),
                  ddx(q, k, j, m) - mul_rn(T(0.5), corr));
  }
  // FE at V point (j, i) (t3dmix2_geo.h:226-245)
  __device__ T FE(int k, int j, int i) const {
    const int jm = jw(j - 1);
    const T sZ = dde(z, k, j, i);
    const T corr = mul_rn(mn0(sZ), dTdz(k, jm, i) + dTdz(k + 1, j, i)) +
                   mul_rn(mx0(sZ), dTdz(k + 1, jm, i) + dTdz(k, j, i));
    return mul_rn(mul_rn(cff_v[static_cast<size_t>(j) * Li + i],
                         Hz[at(k, j, i)] + Hz[at(k, jm, i)]),
                  dde(q, k, j, i) - mul_rn(T(0.5), corr));
  }
  // cross flux FS at interior interface kk (t3dmix2_geo.h:248-278)
  __device__ T FS(int kk, int j, int i, T c) const {
    const int ip = iw(i + 1), jp = jw(j + 1);
    const T dTz = dTdz(kk, j, i);
    const T c1 = mn0(ddx(z, kk - 1, j, i)), c2 = mn0(ddx(z, kk, j, ip));
    const T c3 = mx0(ddx(z, kk, j, i)), c4 = mx0(ddx(z, kk - 1, j, ip));
    T a = mul_rn(c1, mul_rn(c1, dTz) - ddx(q, kk - 1, j, i));
    a = a + mul_rn(c2, mul_rn(c2, dTz) - ddx(q, kk, j, ip));
    a = a + mul_rn(c3, mul_rn(c3, dTz) - ddx(q, kk, j, i));
    a = a + mul_rn(c4, mul_rn(c4, dTz) - ddx(q, kk - 1, j, ip));
    const T e1 = mn0(dde(z, kk - 1, j, i)), e2 = mn0(dde(z, kk, jp, i));
    const T e3 = mx0(dde(z, kk, j, i)), e4 = mx0(dde(z, kk - 1, jp, i));
    T e = mul_rn(e1, mul_rn(e1, dTz) - dde(q, kk - 1, j, i));
    e = e + mul_rn(e2, mul_rn(e2, dTz) - dde(q, kk, jp, i));
    e = e + mul_rn(e3, mul_rn(e3, dTz) - dde(q, kk, j, i));
    e = e + mul_rn(e4, mul_rn(e4, dTz) - dde(q, kk - 1, jp, i));
    return mul_rn(c, a) + mul_rn(c, e);
  }
};

template <typename T>
__global__ void rot_div_geo_kernel(const T* __restrict__ q,
                                   const T* __restrict__ z_r,
                                   const T* __restrict__ Hz,
                                   const T* __restrict__ pm_u,
                                   const T* __restrict__ pn_v,
                                   const T* __restrict__ pmn,
                                   const T* __restrict__ cff_u,
                                   const T* __restrict__ cff_v,
                                   const T* __restrict__ d2,
                                   T* __restrict__ out, int NT, int N,
                                   int Mj, int Li, int ewp) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const size_t P = static_cast<size_t>(Mj) * Li;
  if (c >= static_cast<int>(P)) return;
  const int j = c / Li, i = c - j * Li;
  const int ip = roms::wrap(i + 1, Li), jp = roms::wrap(j + 1, Mj);
  for (int tr = 0; tr < NT; ++tr) {
    const size_t tq = static_cast<size_t>(tr) * N * P;
    const size_t tp = static_cast<size_t>(tr) * P;
    const Geo<T> g{q + tq, z_r, Hz, pm_u, pn_v, cff_u + tp, cff_v + tp,
                   N, Mj, Li, ewp != 0, P};
    const T cs = mul_rn(T(0.5), d2[tp + c]);
    T fs_lo = T(0);
    for (int k = 0; k < N; ++k) {
      const T fs_hi = k + 1 < N ? g.FS(k + 1, j, i, cs) : T(0);
      const T div = mul_rn(pmn[c], (g.FX(k, j, ip) - g.FX(k, j, i)) +
                                       (g.FE(k, jp, i) - g.FE(k, j, i))) +
                    (fs_hi - fs_lo);
      out[tq + g.at(k, j, i)] = div;
      fs_lo = fs_hi;
    }
  }
}

template <typename T>
int launch(const void* const* in, void* out, int NT, int N, int Mj, int Li,
           int ewp, void* stream) {
  const long long P = static_cast<long long>(Mj) * Li;
  rot_div_geo_kernel<T><<<roms::blocks_for(P), roms::kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(in[0]), static_cast<const T*>(in[1]),
      static_cast<const T*>(in[2]), static_cast<const T*>(in[3]),
      static_cast<const T*>(in[4]), static_cast<const T*>(in[5]),
      static_cast<const T*>(in[6]), static_cast<const T*>(in[7]),
      static_cast<const T*>(in[8]), static_cast<T*>(out), NT, N, Mj, Li,
      ewp);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define ROMS_HMIX_ENTRY(NAME, T)                                             \
  extern "C" int NAME(const void* q, const void* z_r, const void* Hz,       \
                      const void* pm_u, const void* pn_v, const void* pmn,  \
                      const void* cff_u, const void* cff_v, const void* d2, \
                      void* out, int NT, int N, int Mj, int Li, int ewp,    \
                      void* stream) {                                       \
    const void* in[9] = {q, z_r, Hz, pm_u, pn_v, pmn, cff_u, cff_v, d2};    \
    return launch<T>(in, out, NT, N, Mj, Li, ewp, stream);                  \
  }

ROMS_HMIX_ENTRY(roms_rot_div_geo_f32, float)
ROMS_HMIX_ENTRY(roms_rot_div_geo_f64, double)
