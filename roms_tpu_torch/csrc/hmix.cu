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
// st.periodic_x: the slopes dZdx, the gradients dTdx and the fluxes FX at
// U faces 0 and Li-1 are those of faces Li-2 and 1 (pallas_hmix.py
// _perx), so such a face reads the two cells west and east of its source
// face, which the block loads as extra window columns.
//
// Bound on the H100: bytes.  Per point it reads q (NT levels), z_r and
// Hz and writes NT levels, ~(2 NT + 2) words per level against ~60 flops
// per tracer level.
//
// Design: one block per tile of TJ rows x TI lanes of columns, marching
// k upwards with every tracer at once.  Shared memory holds, for the
// tile and a one-cell halo (rows j0-1 .. j0+TJ, lanes i0-1 .. i0+TI plus
// the periodic faces' source cells), the current level of q and z_r, Hz
// and dT/dz at the interfaces below and above the level; for the U and V
// faces of the tile, the slopes and gradients of two levels, the fluxes
// FX and FE of the level and the coefficient planes; for the tile's
// cells the cross flux FS of the interface below and the coefficients.
// Each level is three phases with __syncthreads() between them:
//   1. every window cell loads level k+1 of q, z_r and level k of Hz,
//      and computes dT/dz at interface k+1;
//   2. every U and V face computes the slopes and gradients of level
//      k+1 and the fluxes FX and FE of level k, once each, for all
//      tracers, with the z slopes shared by the tracers;
//   3. every tile cell computes FS at interface k+1 from its faces, and
//      writes the divergence of level k once, carrying FS up.
// Each word of q, z_r and Hz is loaded once a level per window cell (the
// halo rows and lanes from L2), each flux computed once per face.  The
// coefficient planes pm_u, pn_v, pmn, cff_u, cff_v and 0.5 d2 are built
// in the block's prologue from pm, pn, the masks, on_u, om_v and d2 with
// the plain version's operation order.  Every product that feeds an add
// or subtract is mul_rn, and the sums keep the plain version's order, so
// each value rounds as in the plain version.
//
// What sets the pace (PERF.md): latency, not bytes.  Each level is three
// short phases between barriers, the first waiting on its loads.  The tile
// (ops/hmix.py TILE) was the fastest of those timed; prefetching the next
// level with cp.async while the block computes was slower (more shared
// memory, fewer blocks an SM).
#include "common.cuh"

namespace {

using roms::mul_rn;

template <typename T>
__device__ __forceinline__ T mn0(T x) { return x < T(0) ? x : T(0); }
template <typename T>
__device__ __forceinline__ T mx0(T x) { return x > T(0) ? x : T(0); }

constexpr int kBlockThreads = 256;
// extra window columns: the source cells of U faces 0 and Li-1 on an
// EW-periodic grid
constexpr int kExtra = 4;

template <typename T>
struct Params {
  const T* q;       // (NT, N, Mj, Li)
  const T* z;       // z_r (N, Mj, Li)
  const T* Hz;
  const T* pm;      // (Mj, Li)
  const T* pn;
  const T* umask;
  const T* vmask;
  const T* on_u;
  const T* om_v;
  const T* d2;      // (NT, Mj, Li)
  T* out;           // (NT, N, Mj, Li)
  int NT, N, Mj, Li, ewp, TJ, TI;
};

// the block's shared arrays, carved from dynamic shared memory for tiles
// of at most TJ x TI (ops/hmix.py launch_shape counts the same bytes)
template <typename T>
struct Smem {
  int WC, Wc, Fu, Fv, C;    // window row stride, window cells, faces, cells
  // two levels of the slopes and gradients sit one after the other
  // (level h at sx + h Fu, dqx + h NT Fu), so that no array of pointers
  // is indexed at run time, which would put the struct in local memory
  T *q, *z, *Hz, *dT;                              // window cells
  T *pmu, *cffu, *sx, *dqx, *FX;                   // U faces
  T *pnv, *cffv, *se, *dqe, *FE;                   // V faces
  T *pmn, *cs, *fs;                                // tile cells
  int *rowg, *colg, *fw, *fe;

  __device__ void carve(void* base, int NT, int TJ, int TI) {
    WC = TI + 2 + kExtra;
    Wc = (TJ + 2) * WC;
    Fu = TJ * (TI + 1);
    Fv = (TJ + 1) * TI;
    C = TJ * TI;
    T* p = static_cast<T*>(base);
    auto take = [&](int n) {
      T* r = p;
      p += n;
      return r;
    };
    q = take(NT * Wc);
    z = take(Wc);
    Hz = take(Wc);
    dT = take(2 * NT * Wc);
    pmu = take(Fu);
    cffu = take(NT * Fu);
    sx = take(2 * Fu);
    dqx = take(2 * NT * Fu);
    FX = take(NT * Fu);
    pnv = take(Fv);
    cffv = take(NT * Fv);
    se = take(2 * Fv);
    dqe = take(2 * NT * Fv);
    FE = take(NT * Fv);
    pmn = take(C);
    cs = take(NT * C);
    fs = take(NT * C);
    int* ip = reinterpret_cast<int*>(p);
    rowg = ip;
    colg = rowg + TJ + 2;
    fw = colg + WC;
    fe = fw + TI + 1;
  }
};

template <typename T>
size_t smem_bytes(int NT, int TJ, int TI) {
  const size_t WC = TI + 2 + kExtra, Wc = (TJ + 2) * WC;
  const size_t Fu = TJ * (TI + 1), Fv = (TJ + 1) * TI, C = TJ * TI;
  return sizeof(T) * (Wc * (2 + 3 * NT) + (Fu + Fv) * (3 + 4 * NT) +
                      C * (1 + 2 * NT)) +
         sizeof(int) * (TJ + 2 + WC + 2 * (TI + 1));
}

// the horizontal flux of one face (t3dmix2_geo.h:205-245): sZ the slope
// of z, dq the gradient of q across the face, cff the coefficient, Hw/He
// and the dT/dz at interfaces k (lo) and k+1 (hi) of the cells on either
// side (w the minus side)
template <typename T>
__device__ __forceinline__ T face_flux(T sZ, T dq, T cff, T He, T Hw, T lo_w,
                                       T hi_w, T lo_e, T hi_e) {
  const T corr = mul_rn(mn0(sZ), lo_w + hi_e) + mul_rn(mx0(sZ), hi_w + lo_e);
  return mul_rn(mul_rn(cff, He + Hw), dq - mul_rn(T(0.5), corr));
}

// one slope product of the cross flux (t3dmix2_geo.h:248-278)
template <typename T>
__device__ __forceinline__ T cross(T c, T dTz, T dq) {
  return mul_rn(c, mul_rn(c, dTz) - dq);
}

template <typename T>
__global__ void __launch_bounds__(kBlockThreads)
rot_div_geo_kernel(const __grid_constant__ Params<T> p) {
  extern __shared__ __align__(16) unsigned char smem[];
  Smem<T> s;
  s.carve(smem, p.NT, p.TJ, p.TI);
  const int NT = p.NT, N = p.N, Mj = p.Mj, Li = p.Li;
  const size_t P = static_cast<size_t>(Mj) * Li;
  const int j0 = blockIdx.y * p.TJ, i0 = blockIdx.x * p.TI;
  const int tj = min(p.TJ, Mj - j0), ti = min(p.TI, Li - i0);
  // the periodic faces' source cells, where the tile has such a face
  const bool extra = p.ewp && (i0 == 0 || i0 + ti >= Li - 1);
  const int wc = ti + 2 + (extra ? kExtra : 0);
  const int WC = s.WC;

  // window rows j0-1 .. j0+tj, lanes i0-1 .. i0+ti, then the extra
  // columns (cells Li-3, Li-2 of face 0; cells 0, 1 of face Li-1); the
  // west and east cell of each U face
  for (int n = threadIdx.x; n < tj + 2; n += blockDim.x)
    s.rowg[n] = roms::mod(j0 - 1 + n, Mj);
  for (int n = threadIdx.x; n < wc; n += blockDim.x) {
    const int e = n - (ti + 2);
    s.colg[n] = e < 0 ? roms::mod(i0 - 1 + n, Li)
                      : (e < 2 ? roms::mod(Li - 3 + e, Li) : e - 2);
  }
  for (int n = threadIdx.x; n <= ti; n += blockDim.x) {
    const int f = roms::mod(i0 + n, Li);
    const int m = roms::ring_x(f, Li, p.ewp != 0);
    const int x = m == f ? n : ti + 2 + (f == 0 ? 0 : 2);
    s.fw[n] = x;
    s.fe[n] = m == f ? n + 1 : x + 1;
  }
  __syncthreads();

  // coefficients (ops/hmix.py slopes, core/hmix.py _rot_div_geo)
  const int nu = tj * (ti + 1), nv = (tj + 1) * ti, nc = tj * ti;
  for (int n = threadIdx.x; n < nu; n += blockDim.x) {
    const int a = n / (ti + 1), b = n - a * (ti + 1);
    const size_t g = static_cast<size_t>(s.rowg[a + 1]) * Li;
    const size_t m = g + s.colg[s.fe[b]], mm = g + s.colg[s.fw[b]];
    const int u = a * (p.TI + 1) + b;
    s.pmu[u] = mul_rn(mul_rn(T(0.5), p.pm[m] + p.pm[mm]), p.umask[m]);
    for (int tr = 0; tr < NT; ++tr)
      s.cffu[tr * s.Fu + u] = mul_rn(
          mul_rn(T(0.25), p.d2[tr * P + m] + p.d2[tr * P + mm]), p.on_u[m]);
  }
  for (int n = threadIdx.x; n < nv; n += blockDim.x) {
    const int a = n / ti, b = n - a * ti;
    const size_t lane = s.colg[b + 1];
    const size_t g = static_cast<size_t>(s.rowg[a + 1]) * Li + lane;
    const size_t gm = static_cast<size_t>(s.rowg[a]) * Li + lane;
    const int v = a * p.TI + b;
    s.pnv[v] = mul_rn(mul_rn(T(0.5), p.pn[g] + p.pn[gm]), p.vmask[g]);
    for (int tr = 0; tr < NT; ++tr)
      s.cffv[tr * s.Fv + v] = mul_rn(
          mul_rn(T(0.25), p.d2[tr * P + g] + p.d2[tr * P + gm]), p.om_v[g]);
  }
  for (int n = threadIdx.x; n < nc; n += blockDim.x) {
    const int a = n / ti, b = n - a * ti;
    const size_t g = static_cast<size_t>(s.rowg[a + 1]) * Li + s.colg[b + 1];
    const int c = a * p.TI + b;
    s.pmn[c] = mul_rn(p.pm[g], p.pn[g]);
    for (int tr = 0; tr < NT; ++tr) {
      s.cs[tr * s.C + c] = mul_rn(T(0.5), p.d2[tr * P + g]);
      s.fs[tr * s.C + c] = T(0);
    }
  }
  // level 0 of q and z_r; dT/dz vanishes at interface 0
  const int nw = (tj + 2) * wc;
  for (int n = threadIdx.x; n < nw; n += blockDim.x) {
    const int r = n / wc, c = n - r * wc;
    const size_t g = static_cast<size_t>(s.rowg[r]) * Li + s.colg[c];
    const int w = r * WC + c;
    s.z[w] = p.z[g];
    for (int tr = 0; tr < NT; ++tr) {
      s.q[tr * s.Wc + w] = p.q[static_cast<size_t>(tr) * N * P + g];
      s.dT[tr * s.Wc + w] = T(0);
    }
  }
  __syncthreads();
  // the slopes and gradients of level 0 at the faces
  for (int n = threadIdx.x; n < nu; n += blockDim.x) {
    const int a = n / (ti + 1), b = n - a * (ti + 1);
    const int u = a * (p.TI + 1) + b;
    const int w = (a + 1) * WC + s.fw[b], e = (a + 1) * WC + s.fe[b];
    s.sx[u] = mul_rn(s.pmu[u], s.z[e] - s.z[w]);
    for (int tr = 0; tr < NT; ++tr)
      s.dqx[tr * s.Fu + u] =
          mul_rn(s.pmu[u], s.q[tr * s.Wc + e] - s.q[tr * s.Wc + w]);
  }
  for (int n = threadIdx.x; n < nv; n += blockDim.x) {
    const int a = n / ti, b = n - a * ti;
    const int v = a * p.TI + b;
    const int sc = a * WC + b + 1, nc2 = sc + WC;
    s.se[v] = mul_rn(s.pnv[v], s.z[nc2] - s.z[sc]);
    for (int tr = 0; tr < NT; ++tr)
      s.dqe[tr * s.Fv + v] =
          mul_rn(s.pnv[v], s.q[tr * s.Wc + nc2] - s.q[tr * s.Wc + sc]);
  }

  // dT/dz at interfaces k and k+1 and the faces' levels k and k+1 swap
  // halves each level
  int lo = 0, cur = 0;
  for (int k = 0; k < N; ++k) {
    const bool up = k + 1 < N;
    const int nxt = 1 - cur;
    const T* dTlo = s.dT + lo * NT * s.Wc;
    T* dThi = s.dT + (1 - lo) * NT * s.Wc;
    const T* sx0 = s.sx + cur * s.Fu;
    T* sx1 = s.sx + nxt * s.Fu;
    const T* dqx0 = s.dqx + cur * NT * s.Fu;
    T* dqx1 = s.dqx + nxt * NT * s.Fu;
    const T* se0 = s.se + cur * s.Fv;
    T* se1 = s.se + nxt * s.Fv;
    const T* dqe0 = s.dqe + cur * NT * s.Fv;
    T* dqe1 = s.dqe + nxt * NT * s.Fv;
    __syncthreads();
    // 1. level k+1 of q and z_r, dT/dz at interface k+1, Hz of level k
    for (int n = threadIdx.x; n < nw; n += blockDim.x) {
      const int r = n / wc, c = n - r * wc;
      const size_t g = static_cast<size_t>(s.rowg[r]) * Li + s.colg[c];
      const int w = r * WC + c;
      s.Hz[w] = p.Hz[k * P + g];
      if (up) {
        const T zn = p.z[(k + 1) * P + g];
        for (int tr = 0; tr < NT; ++tr) {
          const T qn = p.q[(static_cast<size_t>(tr) * N + k + 1) * P + g];
          dThi[tr * s.Wc + w] = (qn - s.q[tr * s.Wc + w]) / (zn - s.z[w]);
          s.q[tr * s.Wc + w] = qn;
        }
        s.z[w] = zn;
      } else {
        for (int tr = 0; tr < NT; ++tr) dThi[tr * s.Wc + w] = T(0);
      }
    }
    __syncthreads();
    // 2. U and V faces: level k+1's slopes and gradients, level k's fluxes
    for (int n = threadIdx.x; n < nu; n += blockDim.x) {
      const int a = n / (ti + 1), b = n - a * (ti + 1);
      const int u = a * (p.TI + 1) + b;
      const int w = (a + 1) * WC + s.fw[b], e = (a + 1) * WC + s.fe[b];
      const T sZ = sx0[u];
      if (up) sx1[u] = mul_rn(s.pmu[u], s.z[e] - s.z[w]);
      for (int tr = 0; tr < NT; ++tr) {
        const int tw = tr * s.Wc, tu = tr * s.Fu + u;
        s.FX[tu] = face_flux(sZ, dqx0[tu], s.cffu[tu], s.Hz[e], s.Hz[w],
                             dTlo[tw + w], dThi[tw + w], dTlo[tw + e],
                             dThi[tw + e]);
        if (up) dqx1[tu] = mul_rn(s.pmu[u], s.q[tw + e] - s.q[tw + w]);
      }
    }
    for (int n = threadIdx.x; n < nv; n += blockDim.x) {
      const int a = n / ti, b = n - a * ti;
      const int v = a * p.TI + b;
      const int sc = a * WC + b + 1, nc2 = sc + WC;
      const T sZ = se0[v];
      if (up) se1[v] = mul_rn(s.pnv[v], s.z[nc2] - s.z[sc]);
      for (int tr = 0; tr < NT; ++tr) {
        const int tw = tr * s.Wc, tv = tr * s.Fv + v;
        s.FE[tv] = face_flux(sZ, dqe0[tv], s.cffv[tv], s.Hz[nc2],
                             s.Hz[sc], dTlo[tw + sc], dThi[tw + sc],
                             dTlo[tw + nc2], dThi[tw + nc2]);
        if (up)
          dqe1[tv] = mul_rn(s.pnv[v], s.q[tw + nc2] - s.q[tw + sc]);
      }
    }
    __syncthreads();
    // 3. the tile's cells: FS at interface k+1, the divergence of level k
    for (int n = threadIdx.x; n < nc; n += blockDim.x) {
      const int a = n / ti, b = n - a * ti;
      const int c = a * p.TI + b;
      const int uw = a * (p.TI + 1) + b, ue = uw + 1;
      const int vs = a * p.TI + b, vn = vs + p.TI;
      const int w = (a + 1) * WC + b + 1;
      const size_t g = static_cast<size_t>(s.rowg[a + 1]) * Li + s.colg[b + 1];
      // the slopes of z, shared by the tracers
      T c1 = 0, c2 = 0, c3 = 0, c4 = 0, e1 = 0, e2 = 0, e3 = 0, e4 = 0;
      if (up) {
        c1 = mn0(sx0[uw]);
        c2 = mn0(sx1[ue]);
        c3 = mx0(sx1[uw]);
        c4 = mx0(sx0[ue]);
        e1 = mn0(se0[vs]);
        e2 = mn0(se1[vn]);
        e3 = mx0(se1[vs]);
        e4 = mx0(se0[vn]);
      }
      for (int tr = 0; tr < NT; ++tr) {
        const int tu = tr * s.Fu, tv = tr * s.Fv, tc = tr * s.C + c;
        T fs_hi = T(0);
        if (up) {
          const T dTz = dThi[tr * s.Wc + w];
          T ax = cross(c1, dTz, dqx0[tu + uw]);
          ax = ax + cross(c2, dTz, dqx1[tu + ue]);
          ax = ax + cross(c3, dTz, dqx1[tu + uw]);
          ax = ax + cross(c4, dTz, dqx0[tu + ue]);
          T ae = cross(e1, dTz, dqe0[tv + vs]);
          ae = ae + cross(e2, dTz, dqe1[tv + vn]);
          ae = ae + cross(e3, dTz, dqe1[tv + vs]);
          ae = ae + cross(e4, dTz, dqe0[tv + vn]);
          fs_hi = mul_rn(s.cs[tc], ax) + mul_rn(s.cs[tc], ae);
        }
        const T div = mul_rn(s.pmn[c], (s.FX[tu + ue] - s.FX[tu + uw]) +
                                           (s.FE[tv + vn] - s.FE[tv + vs])) +
                      (fs_hi - s.fs[tc]);
        p.out[(static_cast<size_t>(tr) * N + k) * P + g] = div;
        s.fs[tc] = fs_hi;
      }
    }
    lo = 1 - lo;
    cur = nxt;
  }
}

template <typename T>
int launch(const void* const* in, void* out, int NT, int N, int Mj, int Li,
           int ewp, int TJ, int TI, void* stream) {
  Params<T> p;
  const T** fields[] = {&p.q,     &p.z,     &p.Hz,   &p.pm,   &p.pn,
                        &p.umask, &p.vmask, &p.on_u, &p.om_v, &p.d2};
  for (int n = 0; n < 10; ++n) *fields[n] = static_cast<const T*>(in[n]);
  p.out = static_cast<T*>(out);
  p.NT = NT;
  p.N = N;
  p.Mj = Mj;
  p.Li = Li;
  p.ewp = ewp;
  p.TJ = TJ;
  p.TI = TI;
  const size_t smem = smem_bytes<T>(NT, TJ, TI);
  const cudaError_t err = cudaFuncSetAttribute(
      rot_div_geo_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) {
    cudaGetLastError();   // this launch's error, not the next one's
    return static_cast<int>(err);
  }
  const dim3 grid((Li + TI - 1) / TI, (Mj + TJ - 1) / TJ);
  rot_div_geo_kernel<T><<<grid, kBlockThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define ROMS_HMIX_ENTRY(NAME, T)                                              \
  extern "C" int NAME(const void* q, const void* z_r, const void* Hz,        \
                      const void* pm, const void* pn, const void* umask,     \
                      const void* vmask, const void* on_u, const void* om_v, \
                      const void* d2, void* out, int NT, int N, int Mj,      \
                      int Li, int ewp, int TJ, int TI, void* stream) {       \
    const void* in[10] = {q, z_r, Hz, pm, pn, umask, vmask, on_u, om_v, d2}; \
    return launch<T>(in, out, NT, N, Mj, Li, ewp, TJ, TI, stream);           \
  }

ROMS_HMIX_ENTRY(roms_rot_div_geo_f32, float)
ROMS_HMIX_ENTRY(roms_rot_div_geo_f64, double)
