// Kernel 3: fused 3D momentum right-hand side: Coriolis, curvilinear
// metric terms, UP3 horizontal and C4_SW vertical momentum advection,
// added into ru/rv (rhs3d.F:495-1830).
//
// Replaces roms_tpu/ops/pallas_rhs3d.py:349 rhs3d_momentum_pallas
// (pallas_call l.424); plain version ops/rhs3d.py.  Output rows j = 0 and
// Mj-1 are zeroed, as in the Pallas kernel: dead data that bc_u/bc_v
// overwrite.  Closed or EW-periodic lanes: on a periodic grid the
// curvature arrays, the ringed fluxes and the reach-2 W arm take
// st.periodic_x's lane map where core/rhs3d.py applies it; NS-periodic
// grids are refused by the wrapper.
//
// Bound on the H100: bytes.  Each point reads u, v, Hz, Huon, Hvom, ru, rv
// and W once and writes ru, rv: ~10 words against ~220 flops.
//
// Design: one 256-thread block per tile of TJ x TI columns, one thread a
// column (ops/rhs3d.py launch_shape; 8 x 32), marching k from 0 to N-1.
// Each level is two barrier-separated phases:
//   A. (issued first, completed by the next level) cp.async copies of
//      level k+1's u, v, Huon, Hvom and Hz and W at interface k+2, on a
//      window of the tile with a two-point halo (the UP3 stencil's reach),
//      into the second of two shared-memory buffers, so that the loads of
//      one level overlap the arithmetic of the one before; fomn, dndx and
//      dmde are staged once;
//   B. every face of the tile and its one-point rim gets its UP3 flux
//      (UFx, UFe, VFx, VFe) once, the curvature laplacians (uxx, Huxx,
//      uee, vxx, Hvxx, vee, Hvee and Huon's lap_y) formed from the window
//      as the flux needs them;
//   C. each thread adds to ru/rv at its column the Coriolis and metric
//      terms of its cells, the divergence of the face fluxes and the C4_SW
//      vertical flux difference, and writes both outputs.
// The vertical flux: each thread keeps u and v at k-1 .. k+2 of its column
// in registers (the level k+3 loaded a level ahead) and carries the
// interface flux at k+1 over to the next level as the flux at k, so each
// interface flux is computed once; its W averages Wu and Wv come from the
// staged W plane.
//
// Lanes and rows: the window wraps as jnp.roll wraps (rows mod Mj, lanes
// mod Li), so every stencil neighbour is a window neighbour.  The closed
// wall clamps (uxx and Huxx: lane 1 <- 2, Li-1 <- Li-2; vxx: lane 0 <- 1,
// Li-1 <- Li-2; uee: row 0 <- 1, Mj-1 <- Mj-2; vee and Hvee: row 1 <- 2,
// Mj-1 <- Mj-2) and the periodic ring map (lane 0 <- Li-2, Li-1 <- 1) are
// tables of the window: the position whose value a clamped or ringed array
// takes, a copy of the source lane within two positions, composed as the
// plain version composes its two edge copies.  Tiles whose tables are all
// the identity (those away from the walls and the seam, most of them)
// run a copy of the level loop that reads no table.  The lane tiling is
// shifted half a tile, so that lanes Li-2 .. 1 lie inside one tile and
// every ring position the tile's points reach lies in that tile's window.
// (Checked with the CUDA source compiled for the CPU, shared memory
// poisoned with NaN: bitwise at every tiling tried, wrong with a one-point
// halo or with the tables skipped everywhere.)
//
// Every product that feeds an add or subtract is mul_rn and the sums keep
// the plain version's order, so each value rounds as in the plain version.
#include <type_traits>

#include "common.cuh"

namespace {

using roms::copy_async;
using roms::copy_commit;
using roms::copy_wait;
using roms::mul_rn;

constexpr double GADV = -0.25;
constexpr int kThreadsRhs = 256;
constexpr int kHalo = 2;   // window rows and lanes beyond the tile, each side
// a level's staged planes: u, v, Huon, Hvom, Hz and W (interface k+1)
constexpr int kRaw = 6;

template <typename T>
struct Params {
  const T *u, *v, *Hz, *Huon, *Hvom, *W, *ru, *rv;
  const T *fomn, *dndx, *dmde;
  T *out_u, *out_v;
  int N, Mj, Li, uv_cor, curv, uv_adv, ewp, TJ, TI;
};

// window position whose value an array mapped by lane/row map `m` takes
// at position c (lane or row l): the same displacement as m(l) - l, taken
// to the copy of the source within the window's [1, W-2]
__device__ __forceinline__ int redirect(int c, int l, int m, int L, int W) {
  if (m == l) return c;
  int d = m - l;
  if (2 * d >= L) d -= L;
  if (2 * d < -L) d += L;
  int t = c + d;
  while (t < 1 && t + L <= W - 2) t += L;
  while (t > W - 2 && t - L >= 1) t -= L;
  return min(max(t, 1), W - 2);
}

// the block's shared arrays (ops/rhs3d.py launch_shape counts the bytes)
template <typename T>
struct Smem {
  int WJ, WI, WP;
  T* raw;                      // 2 buffers x kRaw window planes of a level
  T *fomn, *dndx, *dmde;       // window planes of the grid
  T *ufx, *ufe, *vfx, *vfe;    // face fluxes
  int *rowg, *colg, *tue, *tve, *tu, *tv, *tr;

  __device__ void carve(void* base, int TJ, int TI) {
    WJ = TJ + 2 * kHalo;
    WI = TI + 2 * kHalo;
    WP = WJ * WI;
    raw = static_cast<T*>(base);
    fomn = raw + 2 * kRaw * WP;
    dndx = fomn + WP;
    dmde = dndx + WP;
    ufx = dmde + WP;
    ufe = ufx + WP;
    vfx = ufe + WP;
    vfe = vfx + WP;
    int* ip = reinterpret_cast<int*>(vfe + WP);
    rowg = ip;
    tue = rowg + WJ;
    tve = tue + WJ;
    colg = tve + WJ;
    tu = colg + WI;
    tv = tu + WI;
    tr = tv + WI;
  }
};

template <typename T>
__device__ __forceinline__ T up3(T cff1, T curv_m, T curv_p, T flux2,
                                 T hyper) {
  const T curv = cff1 > T(0) ? curv_m : curv_p;
  return mul_rn(mul_rn(T(0.25), cff1 + mul_rn(T(GADV), curv)),
                flux2 + mul_rn(T(GADV * 0.5), hyper));
}

// lap_x / lap_y of a window plane at window position (r, c)
template <typename T>
__device__ __forceinline__ T lapx(const T* f, int WI, int r, int c) {
  const T* q = f + r * WI + c;
  return (q[-1] - mul_rn(T(2.0), q[0])) + q[1];
}
template <typename T>
__device__ __forceinline__ T lapy(const T* f, int WI, int r, int c) {
  const T* q = f + r * WI + c;
  return (q[-WI] - mul_rn(T(2.0), q[0])) + q[WI];
}

// C4_SW interface flux from the four levels around it (lo2, lo, hi, hi2
// already substituted at the column's ends) and the averaged W
template <typename T>
__device__ __forceinline__ T c4(T lo2, T lo, T hi, T hi2, T Wq) {
  const T c1 = T(9.0 / 16.0), c2 = T(1.0 / 16.0);
  return mul_rn(mul_rn(c1, lo + hi) - mul_rn(c2, lo2 + hi2), Wq);
}

template <typename T>
__global__ void __launch_bounds__(kThreadsRhs)
rhs3d_kernel(const __grid_constant__ Params<T> p) {
  extern __shared__ __align__(16) unsigned char smem[];
  Smem<T> s;
  s.carve(smem, p.TJ, p.TI);
  const int N = p.N, Mj = p.Mj, Li = p.Li;
  const int WJ = s.WJ, WI = s.WI;
  const size_t P = static_cast<size_t>(Mj) * Li;
  const bool ewp = p.ewp != 0;
  // the block's tile (lane tiling shifted by half a tile: the periodic
  // seam lies in tile 0)
  const roms::Tile t(p.TJ, p.TI, Mj, Li);
  const int tj = t.tj, ti = t.ti;
  const int wj = tj + 2 * kHalo, wi = ti + 2 * kHalo;

  // tables: global row and lane of each window position and where each
  // clamped or ringed array takes its value (the plain version's two edge
  // copies in its order); `mapped` is set where any of them is not the
  // identity, and the other tiles (most) skip the tables
  __shared__ int mapped;
  if (threadIdx.x == 0) mapped = 0;
  t.tables(kHalo, WJ, WI, Mj, Li, s.rowg, s.colg);
  __syncthreads();
  for (int n = threadIdx.x; n < WJ; n += blockDim.x) {
    const int g = s.rowg[n];
    int mu = g == 0 ? 1 : g;
    if (g == Mj - 1) mu = Mj - 2 == 0 ? 1 : Mj - 2;
    int mv = g == 1 ? 2 : g;
    if (g == Mj - 1) mv = Mj - 2 == 1 ? 2 : Mj - 2;
    s.tue[n] = redirect(n, g, mu, Mj, WJ);
    s.tve[n] = redirect(n, g, mv, Mj, WJ);
    if (s.tue[n] != n || s.tve[n] != n) mapped = 1;
  }
  for (int n = threadIdx.x; n < WI; n += blockDim.x) {
    const int g = s.colg[n];
    int mu, mv, mr;
    if (ewp) {
      mr = g == 0 ? Li - 2 : (g == Li - 1 ? 1 : g);
      mu = mv = mr;
    } else {
      mr = g;
      mu = g == 1 ? 2 : g;
      if (g == Li - 1) mu = Li - 2 == 1 ? 2 : Li - 2;
      mv = g == 0 ? 1 : g;
      if (g == Li - 1) mv = Li - 2 == 0 ? 1 : Li - 2;
    }
    s.tu[n] = redirect(n, g, mu, Li, WI);
    s.tv[n] = redirect(n, g, mv, Li, WI);
    s.tr[n] = redirect(n, g, mr, Li, WI);
    if (s.tu[n] != n || s.tv[n] != n || s.tr[n] != n) mapped = 1;
  }
  __syncthreads();
  for (int n = threadIdx.x; n < wj * wi; n += blockDim.x) {
    const int r = n / wi, c = n - r * wi;
    const size_t g = static_cast<size_t>(s.rowg[r]) * Li + s.colg[c];
    const int w = r * WI + c;
    s.fomn[w] = p.fomn[g];
    s.dndx[w] = p.dndx[g];
    s.dmde[w] = p.dmde[g];
  }

  // this thread's point of the tile (y, x): its window position and
  // global offset, the rolling window of u and v at k-1 .. k+2 and the
  // carried interface fluxes
  const bool own = static_cast<int>(threadIdx.x) < tj * ti;
  const int y = own ? threadIdx.x / ti : 0;
  const int x = own ? threadIdx.x - y * ti : 0;
  const int pr = y + kHalo, pc = x + kHalo;
  const size_t gofs = static_cast<size_t>(s.rowg[pr]) * Li + s.colg[pc];
  // rows 0 and Mj-1 are written as zero and skip the arithmetic
  const bool live = own && s.rowg[pr] != 0 && s.rowg[pr] != Mj - 1;
  T ua = T(0), ub = p.u[gofs], uc = p.u[P + gofs], ud = p.u[2 * P + gofs];
  T va = T(0), vb = p.v[gofs], vc = p.v[P + gofs], vd = p.v[2 * P + gofs];
  T fu = T(0), fv = T(0);
  const int nb = (tj + 2) * (ti + 2);

  // stage level kk (and W at interface kk+1) into raw buffer b
  auto stage = [&](int kk, int b) {
    T* dst = s.raw + b * kRaw * s.WP;
    const size_t lev = static_cast<size_t>(kk) * P;
    const bool wup = p.uv_adv && kk + 1 < N;
    for (int n = threadIdx.x; n < wj * wi; n += blockDim.x) {
      const int r = n / wi, c = n - r * wi;
      const size_t g = lev + static_cast<size_t>(s.rowg[r]) * Li + s.colg[c];
      T* d = dst + r * WI + c;
      copy_async(d, p.u + g);
      copy_async(d + s.WP, p.v + g);
      copy_async(d + 4 * s.WP, p.Hz + g);
      if (p.uv_adv) {
        copy_async(d + 2 * s.WP, p.Huon + g);
        copy_async(d + 3 * s.WP, p.Hvom + g);
        if (wup) copy_async(d + 5 * s.WP, p.W + g + P);
      }
    }
  };
  stage(0, 0);
  copy_commit();
  copy_wait<0>();

  // the level loop, with the tables (MAP) or without
  auto march = [&](auto map) {
    constexpr bool MAP = decltype(map)::value;
    auto TU = [&](int c) { return MAP ? s.tu[c] : c; };
    auto TV = [&](int c) { return MAP ? s.tv[c] : c; };
    auto TR = [&](int c) { return MAP ? s.tr[c] : c; };
    auto TUE = [&](int r) { return MAP ? s.tue[r] : r; };
    auto TVE = [&](int r) { return MAP ? s.tve[r] : r; };
    for (int k = 0; k < N; ++k) {
      const size_t lev = static_cast<size_t>(k) * P;
      const bool up = k + 1 < N;
      // the point's window position, opaque to the compiler each level:
      // otherwise it keeps every address built from it across the loop, in
      // more registers than four blocks an SM leave a thread
      int c = pc, rc = pr * WI;
      asm volatile("" : "+r"(c), "+r"(rc));
      const int w = rc + c;
      __syncthreads();
      // A. level k+1 is copied into the other buffer while level k is used
      if (up) stage(k + 1, (k + 1) & 1);
      const T* bufk = s.raw + (k & 1) * kRaw * s.WP;
      const T *su = bufk, *sv = bufk + s.WP, *shu = bufk + 2 * s.WP,
              *shv = bufk + 3 * s.WP, *shz = bufk + 4 * s.WP,
              *sw = bufk + 5 * s.WP;
      // B. the UP3 face fluxes of the tile and its rim
      if (p.uv_adv) {
        for (int n = threadIdx.x; n < nb; n += blockDim.x) {
          const int y = n / (ti + 2) - 1, x = n - (y + 1) * (ti + 2) - 1;
          const int r = y + kHalo, c = x + kHalo, w = r * WI + c;
          if (y >= 0 && y < tj && x < ti) {
            // UFx at (y, x): uxx and Huxx clamped or ringed
            const int c0 = TU(c), c1 = TU(c + 1);
            s.ufx[w] = up3(su[w] + su[w + 1], lapx(su, WI, r, c0),
                           lapx(su, WI, r, c1), shu[w] + shu[w + 1],
                           lapx(shu, WI, r, c0) + lapx(shu, WI, r, c1));
          }
          if (y >= 0 && x >= 0 && x < ti) {
            // UFe at (y, x): uee of rows y-1, y; Hvxx of lanes x, x-1
            const T cff2 = shv[w] + shv[w - 1];
            const T curv = cff2 > T(0) ? lapy(su, WI, TUE(r - 1), c)
                                       : lapy(su, WI, TUE(r), c);
            const T hyp = lapx(shv, WI, r, TR(c)) +
                          lapx(shv, WI, r, TR(c - 1));
            s.ufe[w] = mul_rn(
                mul_rn(T(0.25), (su[w] + su[w - WI]) + mul_rn(T(GADV), curv)),
                cff2 + mul_rn(T(GADV * 0.5), hyp));
          }
          if (y >= 0 && y < tj && x >= 0) {
            // VFx at (y, x): vxx of lanes x-1, x; Huon's lap_y of rows y, y-1
            const T cff2 = shu[w] + shu[w - WI];
            const T curv = cff2 > T(0) ? lapx(sv, WI, r, TV(c - 1))
                                       : lapx(sv, WI, r, TV(c));
            const T hyp = lapy(shu, WI, r, c) + lapy(shu, WI, r - 1, c);
            s.vfx[w] = mul_rn(
                mul_rn(T(0.25), (sv[w] + sv[w - 1]) + mul_rn(T(GADV), curv)),
                cff2 + mul_rn(T(GADV * 0.5), hyp));
          }
          if (y < tj && x >= 0 && x < ti) {
            // VFe at (y, x): vee and Hvee of rows y, y+1
            const int r0 = TVE(r), r1 = TVE(r + 1);
            s.vfe[w] = up3(sv[w] + sv[w + WI], lapy(sv, WI, r0, c),
                           lapy(sv, WI, r1, c), shv[w] + shv[w + WI],
                           lapy(shv, WI, r0, c) + lapy(shv, WI, r1, c));
          }
        }
      }
      __syncthreads();
      // C. the tile's point of this thread
      // level k+3 of the own column, for the next levels' C4 fluxes
      T un = T(0), vn = T(0);
      if (k + 3 < N) {
        un = p.u[lev + 3 * P + gofs];
        vn = p.v[lev + 3 * P + gofs];
      }
      if (live) {
        T ru = p.ru[lev + gofs];
        T rv = p.rv[lev + gofs];
        const int c0 = TR(c), cm = TR(c - 1);
        if (p.uv_cor) {
          // Coriolis (rhs3d.F:502-527) of cells (y, x), (y, x-1), (y-1, x)
          auto cff = [&](int at) {
            return mul_rn(mul_rn(T(0.5), shz[at]), s.fomn[at]);
          };
          const T UF0 = mul_rn(cff(rc + c0), sv[rc + c0] + sv[rc + WI + c0]);
          const T UFm = mul_rn(cff(rc + cm), sv[rc + cm] + sv[rc + WI + cm]);
          const T VF0 = mul_rn(cff(rc + c0), su[rc + c0] + su[rc + c0 + 1]);
          const int rs = rc - WI;
          const T VFs = mul_rn(cff(rs + c0), su[rs + c0] + su[rs + c0 + 1]);
          ru = ru + mul_rn(T(0.5), UF0 + UFm);
          rv = rv + mul_rn(T(-0.5), VF0 + VFs);
        }
        if (p.curv && p.uv_adv) {
          // curvilinear metric terms (rhs3d.F:577-660)
          auto terms = [&](int at, T& UF, T& VF) {
            const T a1 = mul_rn(T(0.5), sv[at] + sv[at + WI]);
            const T a2 = mul_rn(T(0.5), su[at] + su[at + 1]);
            const T cf = mul_rn(shz[at], mul_rn(a1, s.dndx[at]) -
                                              mul_rn(a2, s.dmde[at]));
            UF = mul_rn(cf, a1);
            VF = mul_rn(cf, a2);
          };
          T UF0, VF0, UFm, VFm, UFs, VFs;
          terms(rc + c0, UF0, VF0);
          terms(rc + cm, UFm, VFm);
          terms(rc - WI + c0, UFs, VFs);
          ru = ru + mul_rn(T(0.5), UF0 + UFm);
          rv = rv + mul_rn(T(-0.5), VF0 + VFs);
        }
        if (p.uv_adv) {
          // UP3 horizontal advection (rhs3d.F:668-1010)
          ru = ru + (-(s.ufx[rc + c0] - s.ufx[rc + cm]) -
                     (s.ufe[w + WI] - s.ufe[w]));
          rv = rv + (-(s.vfx[w + 1] - s.vfx[w]) - (s.vfe[w] - s.vfe[w - WI]));
          // C4_SW vertical advection with 4th-order W averages
          // (rhs3d.F:1133-1168): the flux at interface k+1, the one at k
          // carried from the level below
          T gu = T(0), gv = T(0);
          if (up) {
            const T c1 = T(9.0 / 16.0), c2 = T(1.0 / 16.0);
            const T* Wr = sw + rc;
            auto wm = [&](int cc) { return Wr[TR(TR(cc) - 1)]; };
            const T Wu = mul_rn(c1, Wr[c0] + wm(c)) -
                         mul_rn(c2, Wr[TR(c + 1)] + wm(c - 1));
            const T Wv = mul_rn(c1, sw[rc + c0] + sw[rc - WI + c0]) -
                         mul_rn(c2, sw[rc + WI + c0] + sw[rc - 2 * WI + c0]);
            // interface k+1 reads levels k-1 .. k+2, the column's ends
            // substituted (core/rhs3d.py vadv_uv F1 and Fn)
            const bool bot = k == 0, top = k + 2 == N;
            gu = c4(bot ? ub : ua, ub, uc, top ? uc : ud, Wu);
            gv = c4(bot ? vb : va, vb, vc, top ? vc : vd, Wv);
          }
          ru = ru + -(gu - fu);
          rv = rv + -(gv - fv);
          fu = gu;
          fv = gv;
        }
        p.out_u[lev + gofs] = ru;
        p.out_v[lev + gofs] = rv;
      } else if (own) {
        p.out_u[lev + gofs] = T(0);
        p.out_v[lev + gofs] = T(0);
      }
      ua = ub;
      ub = uc;
      uc = ud;
      ud = un;
      va = vb;
      vb = vc;
      vc = vd;
      vd = vn;
      copy_commit();
      copy_wait<0>();
    }
  };
  if (mapped)
    march(std::true_type{});
  else
    march(std::false_type{});
}

template <typename T>
int launch(const void* const* in, void* out_u, void* out_v, int N, int Mj,
           int Li, int uv_cor, int curv, int uv_adv, int ewp, int TJ, int TI,
           void* stream) {
  Params<T> p;
  const T** fields[] = {&p.u,  &p.v,  &p.Hz,   &p.Huon, &p.Hvom, &p.W,
                        &p.ru, &p.rv, &p.fomn, &p.dndx, &p.dmde};
  for (int n = 0; n < 11; ++n) *fields[n] = static_cast<const T*>(in[n]);
  p.out_u = static_cast<T*>(out_u);
  p.out_v = static_cast<T*>(out_v);
  p.N = N;
  p.Mj = Mj;
  p.Li = Li;
  p.uv_cor = uv_cor;
  p.curv = curv;
  p.uv_adv = uv_adv;
  p.ewp = ewp;
  p.TJ = TJ;
  p.TI = TI;
  const size_t WJ = TJ + 2 * kHalo, WI = TI + 2 * kHalo;
  const size_t smem =
      sizeof(T) * (2 * kRaw + 7) * WJ * WI + sizeof(int) * (3 * WJ + 4 * WI);
  if (TJ * TI > kThreadsRhs) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(
      rhs3d_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) {
    cudaGetLastError();   // this launch's error, not the next one's
    return static_cast<int>(err);
  }
  const dim3 grid((Li + TI - 1) / TI, (Mj + TJ - 1) / TJ);
  rhs3d_kernel<T><<<grid, kThreadsRhs, smem,
                    static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define ROMS_RHS3D_ENTRY(NAME, T)                                            \
  extern "C" int NAME(const void* u, const void* v, const void* Hz,         \
                      const void* Huon, const void* Hvom, const void* W,    \
                      const void* ru, const void* rv, const void* fomn,     \
                      const void* dndx, const void* dmde, void* out_u,      \
                      void* out_v, int N, int Mj, int Li, int uv_cor,       \
                      int curv, int uv_adv, int ewp, int TJ, int TI,        \
                      void* stream) {                                       \
    const void* in[11] = {u, v, Hz, Huon, Hvom, W, ru, rv, fomn, dndx, dmde}; \
    return launch<T>(in, out_u, out_v, N, Mj, Li, uv_cor, curv, uv_adv, ewp, \
                     TJ, TI, stream);                                       \
  }

ROMS_RHS3D_ENTRY(roms_rhs3d_f32, float)
ROMS_RHS3D_ENTRY(roms_rhs3d_f64, double)
