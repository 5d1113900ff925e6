// Kernel 2: fused tracer advection, UP3 horizontal + C4 vertical, for all
// tracers in one launch, in two modes:
//   predictor: t_half of pre_step3d.F:260-700 (AB2 blend, implied-thickness
//              divide), before bc_rho;
//   corrector: the pre-diffusion Hz*t of step3d_t.F:343-1205.
//
// Replaces roms_tpu/ops/pallas_tadv.py:294 predictor_pallas and :286
// corrector_pallas (both through _call l.195, pallas_call l.268); plain
// versions ops/tadv.py.  Output rows j = 0 and Mj-1 are zeroed, as in the
// Pallas kernel: dead data that bc_rho overwrites.  Closed or EW-periodic
// lanes (the periodic UP3 curvature takes st.periodic_x's lane map instead
// of the wall zeros); NS-periodic grids are refused by the wrapper.
//
// Bound on the H100: bytes.  Each output point needs q, aux (and Hz in the
// predictor), Huon, Hvom and W once: ~6-7 words read and 1 written, against
// ~80 flops, far under the flop/byte balance.
//
// Design: one 256-thread block per tile of TJ x TI columns and group of up
// to kGroup tracers, one thread a column (ops/tadv.py launch_shape; 7 x 31),
// marching k from 0 to N-1.  Huon, Hvom, W, Hz, pm*pn, the masks and the
// predictor's mass divergence are read and formed once a point for the
// group's tracers.
// Each level is two barrier-separated phases:
//   A. (issued first, completed two levels on) cp.async copies of level
//      k+2's q of each tracer on a window of the tile with a two-point halo
//      (the UP3 stencil's reach), of its Huon and Hvom on the tile with its
//      east/north rim and of aux, Hz and W above at each thread's point,
//      into the third of three shared-memory buffers (the masks are staged
//      once); then each face flux once, FX on the tile's faces and the east
//      rim, FE on them and the north rim, into shared memory, each with the
//      two UP3 curvatures beside it formed from the window (so each
//      curvature is formed twice: a phase that formed each once, between
//      its own barriers, was slower on the H100);
//   B. each thread's point: the flux divergence from shared memory, the C4
//      vertical flux difference, the update, the write.
// The vertical flux: each thread keeps its column's q at k-1 .. k+2 of each
// tracer in registers (the level k+3 loaded a level ahead) and carries the
// C4 interface flux at k+1 over to the next level as the flux at k, so each
// interface flux is computed once; W is read once per interface.
//
// Lanes and rows: the window wraps as jnp.roll wraps (rows mod Mj, lanes
// mod Li), so every stencil neighbour is a window neighbour.  The curvx
// lane map (zero at closed lanes 0 and Li-1; st.periodic_x's lane 0 <- Li-2,
// Li-1 <- 1 on a periodic grid) is a table of the window: the position
// whose raw curvature a lane takes, -1 for a zero.  Tiles whose table is
// the identity (all but the seam's or the walls') run a copy of the level
// loop that reads no table.  The lane tiling is shifted half a tile, so
// that lanes Li-2 .. 1 lie inside one tile and every ring position the
// tile's points reach lies in its window.  (Checked with the CUDA source
// compiled for the CPU, shared memory poisoned with NaN: bitwise at every
// tiling tried.)
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

constexpr int kThreadsAdv = 256;
constexpr int kHalo = 2;    // window rows and lanes beyond the tile, each side
constexpr int kGroup = 2;   // tracers a block (blockIdx.z takes the groups)
constexpr int kStages = 3;  // level buffers: levels k+1 and k+2 in flight
// fields of a face position's entry (Smem::fpos)
constexpr unsigned kPos = (1u << 28) - 1;  // window offset
constexpr unsigned kFx = 1u << 28;         // FX taken there
constexpr unsigned kFe = 1u << 29;         // FE taken there
constexpr unsigned kWall = 1u << 30;       // its row is a closed one
constexpr unsigned kWallS = 1u << 31;      // the row south is a closed one
// blocks an SM the registers must allow: four in float32 (at most 64
// registers a thread), two in float64 (a bound of four spills there)
template <typename T>
constexpr int kMinBlocks = sizeof(T) == 4 ? 4 : 2;

template <typename T>
struct Params {
  const T* q;      // (NT, N, Mj, Li) advected tracer
  const T* aux;    // predictor: t_prev; corrector: t_part (Hz-weighted)
  const T *Huon, *Hvom, *Hz;   // (N, Mj, Li); Hz read by the predictor only
  const T* W;      // (N+1, Mj, Li)
  const T *pm, *pn, *umask, *vmask;
  T* out;
  int NT, N, Mj, Li, ewp, TJ, TI;
  T s0, s1, s2;    // predictor: cff, cff1, cff2; corrector: dt
};

// the block's shared arrays (ops/tadv.py launch_shape counts the bytes);
// G = min(NT, kGroup) tracer planes of each kind
template <typename T>
struct Smem {
  int WJ, WI, WP;
  T* raw;        // kStages buffers x (G q planes, Huon, Hvom)
  T *um, *vm;    // window planes of the masks
  T *fx, *fe;    // G planes each: the face fluxes
  T* pts;        // kStages buffers x (G aux, Hz, W above) at the points
  int *rowg, *colg, *tcx;
  int* goff;         // each window position's offset in a level's plane
  unsigned* fpos;    // each face position's window offset and flags

  __device__ void carve(void* base, int TJ, int TI, int G) {
    WJ = TJ + 2 * kHalo;
    WI = TI + 2 * kHalo;
    WP = WJ * WI;
    raw = static_cast<T*>(base);
    um = raw + kStages * (G + 2) * WP;
    vm = um + WP;
    fx = vm + WP;
    fe = fx + G * WP;
    pts = fe + G * WP;
    rowg = reinterpret_cast<int*>(pts + kStages * (G + 2) * kThreadsAdv);
    colg = rowg + WJ;
    tcx = colg + WI;
    goff = tcx + WI;
    fpos = reinterpret_cast<unsigned*>(goff + WP);
  }
};

template <typename T>
__device__ __forceinline__ T up3_flux(T h, T q0, T qm, T curv_m, T curv_0) {
  return mul_rn(mul_rn(h, T(0.5)), q0 + qm) -
         mul_rn(T(1.0 / 6.0), mul_rn(curv_m, roms::pos(h)) +
                                   mul_rn(curv_0, roms::neg(h)));
}

template <typename T, bool PREDICTOR>
__global__ void __launch_bounds__(kThreadsAdv, kMinBlocks<T>)
tadv_kernel(const __grid_constant__ Params<T> p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = min(p.NT, kGroup);
  Smem<T> s;
  s.carve(smem, p.TJ, p.TI, G);
  const int N = p.N, Mj = p.Mj, Li = p.Li;
  const int WI = s.WI;
  const size_t P = static_cast<size_t>(Mj) * Li;
  const bool ewp = p.ewp != 0;
  const int g0 = blockIdx.z * kGroup;
  const int gn = min(kGroup, p.NT - g0);
  // the block's tile (lane tiling shifted by half a tile: the periodic
  // seam lies in tile 0)
  const roms::Tile t(p.TJ, p.TI, Mj, Li);
  const int tj = t.tj, ti = t.ti;
  const int wi = ti + 2 * kHalo;

  // tables: global row and lane of each window position; the position
  // whose raw curvature each lane's curvx takes (-1: zero); `mapped` is
  // set where that is not the identity
  __shared__ int mapped;
  if (threadIdx.x == 0) mapped = 0;
  t.tables(kHalo, s.WJ, WI, Mj, Li, s.rowg, s.colg);
  __syncthreads();
  for (int n = threadIdx.x; n < WI; n += blockDim.x) {
    const int g = s.colg[n];
    int t = n;
    if (g == 0 || g == Li - 1) {
      if (ewp) {
        // the first copy of the ringed lane in [1, wi-2]
        const int h = roms::ring_x(g, Li, true);
        t = 1 + roms::mod(h - s.colg[1], Li);
        if (t > wi - 2) t = wi - 2;
      } else {
        t = -1;
      }
      if (t != n) mapped = 1;
    }
    s.tcx[n] = t;
  }
  // the face positions of the tile and its east/north rim, (tj+1) x
  // (ti+1): window offset, whether FX and FE are taken there, and whether
  // curve is zero (closed rows 0 and Mj-1) at its row and the row south
  const int nf = (tj + 1) * (ti + 1);
  for (int n = threadIdx.x; n < nf; n += blockDim.x) {
    const int yy = n / (ti + 1), xx = n - yy * (ti + 1);
    const int r = yy + kHalo;
    auto wall = [&](int rr) {
      return s.rowg[rr] == 0 || s.rowg[rr] == Mj - 1 ? 1u : 0u;
    };
    s.fpos[n] = static_cast<unsigned>(r * WI + xx + kHalo) |
                (yy < tj ? kFx : 0u) | (xx < ti ? kFe : 0u) |
                (wall(r) ? kWall : 0u) | (wall(r - 1) ? kWallS : 0u);
  }
  for (int n = threadIdx.x; n < s.WP; n += blockDim.x) {
    const int r = n / WI, c = n - r * WI;
    const int g = s.rowg[r] * Li + s.colg[c];
    s.goff[n] = g;
    s.um[n] = p.umask[g];
    s.vm[n] = p.vmask[g];
  }

  // this thread's point of the tile (y, x): its window position and
  // global offset, the rolling window of q at k-1 .. k+2 of each tracer,
  // the carried interface fluxes and W at interface k
  const bool own = static_cast<int>(threadIdx.x) < tj * ti;
  const int y = own ? threadIdx.x / ti : 0;
  const int x = own ? threadIdx.x - y * ti : 0;
  const int pr = y + kHalo, pc = x + kHalo;
  __syncthreads();
  const size_t gofs = static_cast<size_t>(s.rowg[pr]) * Li + s.colg[pc];
  // rows 0 and Mj-1 are written as zero and skip the arithmetic
  const bool live = own && s.rowg[pr] != 0 && s.rowg[pr] != Mj - 1;
  const T* qcol[kGroup];
  const T* acol[kGroup];
  T* ocol[kGroup];
  T qa[kGroup], qb[kGroup], qc[kGroup], qd[kGroup], fc[kGroup];
#pragma unroll
  for (int t = 0; t < kGroup; ++t) {
    const size_t base = static_cast<size_t>(g0 + (t < gn ? t : 0)) * N * P;
    qcol[t] = p.q + base + gofs;
    acol[t] = p.aux + base + gofs;
    ocol[t] = p.out + base + gofs;
    qa[t] = T(0);
    qb[t] = live && t < gn ? qcol[t][0] : T(0);
    qc[t] = live && t < gn ? qcol[t][P] : T(0);
    qd[t] = live && t < gn ? qcol[t][2 * P] : T(0);
    fc[t] = T(0);
  }
  const T pmn = live ? mul_rn(p.pm[gofs], p.pn[gofs]) : T(0);
  T Wk = live ? p.W[gofs] : T(0);

  // stage level kk into buffer b: q on the window, Huon and Hvom at the
  // face positions; aux, Hz and W at interface kk+1 at the thread's point
  auto stage = [&](int kk, int b) {
    T* dst = s.raw + b * (G + 2) * s.WP;
    const size_t lev = static_cast<size_t>(kk) * P;
    if (own) {
      T* d = s.pts + b * (G + 2) * kThreadsAdv + threadIdx.x;
#pragma unroll
      for (int t = 0; t < kGroup; ++t)
        if (t < gn) copy_async(d + t * kThreadsAdv, acol[t] + lev);
      if (PREDICTOR) copy_async(d + G * kThreadsAdv, p.Hz + lev + gofs);
      copy_async(d + (G + 1) * kThreadsAdv, p.W + lev + P + gofs);
    }
    for (int n = threadIdx.x; n < s.WP; n += blockDim.x) {
      const size_t g = lev + s.goff[n];
#pragma unroll
      for (int t = 0; t < kGroup; ++t)
        if (t < gn)
          copy_async(dst + t * s.WP + n,
                     p.q + static_cast<size_t>(g0 + t) * N * P + g);
    }
    for (int n = threadIdx.x; n < nf; n += blockDim.x) {
      const int w = s.fpos[n] & kPos;
      const size_t g = lev + s.goff[w];
      copy_async(dst + G * s.WP + w, p.Huon + g);
      copy_async(dst + (G + 1) * s.WP + w, p.Hvom + g);
    }
  };
  for (int b = 0; b < kStages - 1; ++b) {
    if (b < N) stage(b, b);
    copy_commit();
  }
  copy_wait<kStages - 2>();

  auto march = [&](auto map) {
    constexpr bool MAP = decltype(map)::value;
    for (int k = 0; k < N; ++k) {
      const size_t lev = static_cast<size_t>(k) * P;
      __syncthreads();
      // level k+kStages-1 is copied into the buffer of level k-1 while
      // level k is used
      const int kn = k + kStages - 1;
      if (kn < N) stage(kn, kn % kStages);
      copy_commit();
      const T* sq = s.raw + (k % kStages) * (G + 2) * s.WP;
      const T* shu = sq + G * s.WP;
      const T* shv = shu + s.WP;
      // UP3 curvatures (advection.hadv_flux): curvx at window position w
      // of window lane c, through the lane map; curve at w, zero on the
      // closed rows
      auto curvx = [&](const T* q, int w, int c) {
        int wm = w;
        if (MAP) {
          const int m = s.tcx[c];
          if (m < 0) return T(0);
          wm = w - c + m;
        }
        return mul_rn(q[wm + 1] - q[wm], s.um[wm + 1]) -
               mul_rn(q[wm] - q[wm - 1], s.um[wm]);
      };
      auto curve = [&](const T* q, int w, bool wall) {
        if (wall) return T(0);
        return mul_rn(q[w + WI] - q[w], s.vm[w + WI]) -
               mul_rn(q[w] - q[w - WI], s.vm[w]);
      };
      // A. the face fluxes of the tile and its east/north rim
      for (int n = threadIdx.x; n < nf; n += blockDim.x) {
        const unsigned e = s.fpos[n];
        const int w = e & kPos;
        // the window lane, for the lane map of the seam's and walls' tiles
        const int c = MAP ? w % WI : 0;
        if (e & kFx) {
          const T h = shu[w];
#pragma unroll
          for (int t = 0; t < kGroup; ++t) {
            if (t >= gn) break;
            const T* q = sq + t * s.WP;
            s.fx[t * s.WP + w] = up3_flux(h, q[w], q[w - 1],
                                          curvx(q, w - 1, c - 1),
                                          curvx(q, w, c));
          }
        }
        if (e & kFe) {
          const T h = shv[w];
#pragma unroll
          for (int t = 0; t < kGroup; ++t) {
            if (t >= gn) break;
            const T* q = sq + t * s.WP;
            s.fe[t * s.WP + w] = up3_flux(h, q[w], q[w - WI],
                                          curve(q, w - WI, e & kWallS),
                                          curve(q, w, e & kWall));
          }
        }
      }
      __syncthreads();
      // B. the tile's point of this thread
      if (live) {
        const int w = pr * WI + pc;
        const T* pt =
            s.pts + (k % kStages) * (G + 2) * kThreadsAdv + threadIdx.x;
        const T Wn = pt[(G + 1) * kThreadsAdv];
        const bool bot = k == 0, top = k + 2 == N;
        // predictor: the implied thickness of the mass divergence, once
        // for the group's tracers
        const T Hz = PREDICTOR ? pt[G * kThreadsAdv] : T(0);
        const T cmass = mul_rn(PREDICTOR ? p.s0 : -p.s0, pmn);
        T DC = T(0);
        if (PREDICTOR) {
          const T mass = ((shu[w + 1] - shu[w]) + (shv[w + WI] - shv[w])) +
                         (Wn - Wk);
          DC = T(1.0) / (Hz - mul_rn(cmass, mass));
        }
#pragma unroll
        for (int t = 0; t < kGroup; ++t) {
          if (t >= gn) break;
          const T* fxt = s.fx + t * s.WP;
          const T* fet = s.fe + t * s.WP;
          const T hdiv = (fxt[w + 1] - fxt[w]) + (fet[w + WI] - fet[w]);
          // C4 flux at interface k+1 (advection.vadv_flux): the column's
          // ends take the one-sided forms F1 and Fn, the surface zero
          const T c2 = T(7.0 / 12.0), c3 = T(1.0 / 12.0);
          T fn = T(0);
          if (k + 1 < N) {
            if (bot)
              fn = mul_rn(Wn, (mul_rn(T(0.5), qb[t]) + mul_rn(c2, qc[t])) -
                                  mul_rn(c3, qd[t]));
            else if (top)
              fn = mul_rn(Wn, (mul_rn(T(0.5), qc[t]) + mul_rn(c2, qb[t])) -
                                  mul_rn(c3, qa[t]));
            else
              fn = mul_rn(Wn, mul_rn(c2, qb[t] + qc[t]) -
                                  mul_rn(c3, qa[t] + qd[t]));
          }
          const T vdiv = fn - fc[t];
          fc[t] = fn;
          T o;
          if (PREDICTOR) {
            const T th = mul_rn(Hz, mul_rn(p.s1, qb[t]) +
                                        mul_rn(p.s2, pt[t * kThreadsAdv])) -
                         mul_rn(cmass, hdiv);
            o = mul_rn(DC, th - mul_rn(cmass, vdiv));
          } else {
            o = (pt[t * kThreadsAdv] + mul_rn(cmass, hdiv)) +
                mul_rn(cmass, vdiv);
          }
          ocol[t][lev] = o;
        }
        Wk = Wn;
        // level k+3 of the column, for the next levels' C4 fluxes
#pragma unroll
        for (int t = 0; t < kGroup; ++t) {
          const T qn = k + 3 < N && t < gn ? qcol[t][lev + 3 * P] : T(0);
          qa[t] = qb[t];
          qb[t] = qc[t];
          qc[t] = qd[t];
          qd[t] = qn;
        }
      } else if (own) {
        for (int t = 0; t < gn; ++t) ocol[t][lev] = T(0);
      }
      copy_wait<kStages - 2>();
    }
  };
  if (mapped)
    march(std::true_type{});
  else
    march(std::false_type{});
}

template <typename T>
int launch(int predictor, const void* const* in, void* out, int NT, int N,
           int Mj, int Li, int ewp, int TJ, int TI, double s0, double s1,
           double s2, void* stream) {
  Params<T> p;
  const T** fields[] = {&p.q,  &p.aux, &p.Huon, &p.Hvom,  &p.Hz,
                        &p.W,  &p.pm,  &p.pn,   &p.umask, &p.vmask};
  for (int n = 0; n < 10; ++n) *fields[n] = static_cast<const T*>(in[n]);
  p.out = static_cast<T*>(out);
  p.NT = NT;
  p.N = N;
  p.Mj = Mj;
  p.Li = Li;
  p.ewp = ewp;
  p.TJ = TJ;
  p.TI = TI;
  p.s0 = T(s0);
  p.s1 = T(s1);
  p.s2 = T(s2);
  const size_t G = NT < kGroup ? NT : kGroup;
  const size_t WJ = TJ + 2 * kHalo, WI = TI + 2 * kHalo;
  const size_t smem = sizeof(T) * ((kStages * (G + 2) + 2 + 2 * G) * WJ * WI +
                                   kStages * (G + 2) * kThreadsAdv) +
                      sizeof(int) *
                          (WJ + 2 * WI + WJ * WI + (TJ + 1) * (TI + 1));
  if (TJ * TI > kThreadsAdv || NT < 1 || N < 3)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kern = predictor ? tadv_kernel<T, true> : tadv_kernel<T, false>;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) {
    cudaGetLastError();   // this launch's error, not the next one's
    return static_cast<int>(err);
  }
  const dim3 grid((Li + TI - 1) / TI, (Mj + TJ - 1) / TJ,
                  (NT + kGroup - 1) / kGroup);
  kern<<<grid, kThreadsAdv, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define ROMS_TADV_ENTRY(NAME, T)                                             \
  extern "C" int NAME(int predictor, const void* q, const void* aux,        \
                      const void* Huon, const void* Hvom, const void* Hz,   \
                      const void* W, const void* pm, const void* pn,        \
                      const void* umask, const void* vmask, void* out,      \
                      int NT, int N, int Mj, int Li, int ewp, int TJ,       \
                      int TI, double s0, double s1, double s2,              \
                      void* stream) {                                       \
    const void* in[10] = {q, aux, Huon, Hvom, Hz, W, pm, pn, umask, vmask}; \
    return launch<T>(predictor, in, out, NT, N, Mj, Li, ewp, TJ, TI, s0,   \
                     s1, s2, stream);                                       \
  }

ROMS_TADV_ENTRY(roms_tadv_f32, float)
ROMS_TADV_ENTRY(roms_tadv_f64, double)
