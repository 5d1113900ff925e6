// Kernel 12: the fast barotropic loop, j-blocked (step2d_LF_AM3.h:163-3058):
// the same nfast LF-AM3 predictor + corrector substeps with the
// fast-time averages as kernel 11 (step2d.cu), run KS substeps per
// launch on tiles that recompute their halo.
//
// Replaces roms_tpu/ops/pallas_step2d.py:600 fast_loop_pallas (the
// j-blocked engine: pallas_call l.578 in _substep_call l.535, _kernel
// l.484, _substep l.334); plain version core/step2d.py's substep loop
// (ops/step2d.py fast_loop_res_plain).  Class (_class_ok, l.890):
// EW-periodic, closed N/S walls for zeta, ubar and vbar, no VolCons, no
// wet/dry.
//
// What it keeps of the TPU design: KS = 2 substeps per launch (KS = 1 for
// an odd remainder), each tile reads its fields on a window wider than
// the tile and recomputes the predictor and the corrector over the
// window, so no synchronisation between tiles is needed inside a launch;
// only the tile's own points are written.  The scalar table (first,
// cffA1, cffA2p, cffA2c, a1, a2, a3) is uploaded once per fast loop and
// each launch reads its rows.
//
// What differs from the TPU kernel:
//  - tiles in i as well as j (bands of full rows give too few blocks for
//    132 SMs);
//  - the window wraps as jnp.roll wraps, in j as well as in i: a tile at
//    the walls reads the rows across the wrap, so every point of the
//    carry, ring rows and lanes included, equals the plain loop's.  The
//    TPU engine clamps its first block's minus block to itself (l.553)
//    and leaves dead values in the ring rows of the rhs histories and
//    the 2D forcing;
//  - the BCs act from global indices (step2d_point.cuh), as in kernel 11;
//  - the AB3 histories ru0, rv0, ru0p2, rv0p2 are read as they are, not
//    precombined, and VFx takes DgDU's j-1 neighbour as the jnp path does
//    (the TPU kernel's l.235 takes i-1; ROADMAP Queue 3 item 5).  The
//    per-point formulas are kernel 11's own (step2d_point.cuh), so the two
//    engines round alike.
//
// Halo: a half-step reads its inputs up to 3 points west and south of a
// point and 2 east and north (the C4 advection's lap of the fluxes), so a
// substep's dependence reaches 6 points per edge.  The ring copies of the
// lateral BCs reach one row (bc_rho, bc_u) or two lanes (the periodic
// lanes, lane 0 <- Li-2) further, once.  On a grid of 4 or 5 lanes the
// periodic copies chain (at Li = 4 lane Li-4 is lane 0, two lanes west of
// lane Li-2), in every substep.  So a window of HJ = 6 KS + 1 rows and
// HI = 6 KS + 2 (+ 2 KS + 2 when Li <= 5) lanes per edge (ops/step2d.py
// halo) leaves the tile's own points exact; points nearer the window's
// edge read clamped neighbours and hold dead values, which no tile point
// reads.  Half-step h skips the outer 3 h points of each edge, which
// earlier half-steps have already left dead, and its momentum phase 3
// more.  (Checked against the plain loop with the CUDA source compiled
// for the CPU, NaN in every unwritten element: exact at every tiling
// tried, still exact with a halo one point short, wrong with one two
// points short or with a margin of 5.  At Li = 4, 42 substeps, with
// every phase on the half-step's points: with 2 extra lanes for KS = 2
// it departed by 8.9e-17 at Mj = 5 from the first substep in float64,
// with 4 it still did; 42 KS = 1 launches with 2 extra lanes departed by
// 2.7e-10, with 4 they were exact.  With the momentum phase 3 points
// further in, Li = 5 without extra lanes read unwritten points.)
//
// Where the fields live:
//  - the ten fields that some phase reads at another point than its own
//    (zeta, its previous value and then the corrector's new zeta; ubar,
//    vbar; the predictor's zeta_p, ubar_p, vbar_p; DUon, DVom; zwrk) on
//    the window in dynamic shared memory, each in a plane fixed at compile
//    time: the launch is a template on KS and on whether it holds the
//    loop's first substep, so the rotation of the planes between substeps
//    (zeta <-> zeta_prev, the forcing after the first predictor) is
//    resolved by the compiler.  The carry's zeta, zeta_prev, ubar and vbar
//    are read into the window once a launch;
//  - ubar_prev and vbar_prev, which the predictor reads at its own point
//    only, from the launch's input carry (ubar of the launch's first
//    substep is the second's ubar_prev); the corrector writes its new
//    ubar and vbar over the old ones in place, its BCs after all the
//    pre-BC values are written, from sources that are never ring points
//    themselves;
//  - the fast-time averages at the tile's points only: copied from the
//    input carry to the output once a launch and updated there by the
//    thread that owns the point;
//  - the predictor's rhs histories (rzeta, rubar, rvbar) and the first
//    substep's new forcing in device scratch, kept only over the points
//    that a later half-step of the launch reads (keep_j, keep_i): the
//    corrector's points and the ring copies' sources.  The grid is one
//    block per resident slot, each looping over tiles, so the scratch is
//    per slot, not per tile (ops/step2d.py blocked_scratch).
// The phases stride the block's threads over a region's points with no
// per-point division (each_point).
//
// Bound on the H100: the function is kernel 11's, so its bound is too
// (operations: ~470 flops a point a substep).  Its own design's floor is
// the carry (16 planes) and statics (28) read and the carry written once
// a launch; the halo recompute multiplies the arithmetic, at BENCHMARK3's
// float32 tile (37 x 56, window 63 x 84), by 1.98 in the flux and zeta
// phases and 1.75 in the momentum phase.
#include "step2d_point.cuh"

namespace {

using namespace roms::step2d;

// threads a block: one block an SM (its window takes most of the SM's
// shared memory), 20 warps in float32 at up to 96 registers (faster than
// 16 at 128 or 24 at 80 on the H100, PERF.md), 8 in float64 at up to 255
template <typename T>
constexpr int kThreads = sizeof(T) == 4 ? 640 : 256;
// points per window edge that each half-step leaves dead for the next
constexpr int kMargin = 3;

// the window planes in shared memory
enum Win { WZ0, WZ1, WU, WV, WZP, WUP, WVP, WDU, WDV, WZW, NWIN };

// the plane of zeta at substep q of the launch: the other one holds
// zeta_prev, and then the corrector's new zeta, which is zeta at q + 1
__host__ __device__ constexpr int wz(int q) { return q % 2 == 0 ? WZ0 : WZ1; }

// the window plane of field id in substep q's predictor or corrector, -1
// for a field elsewhere; the corrector's new ubar and vbar (UBAR_PREV,
// VBAR_PREV in the point formulas) go over ubar and vbar
template <int Q, bool CORR>
__host__ __device__ constexpr int win_plane(int id) {
  return id == ZETA        ? wz(Q)
         : id == ZETA_PREV ? wz(Q + 1)
         : id == UBAR || (CORR && id == UBAR_PREV) ? WU
         : id == VBAR || (CORR && id == VBAR_PREV) ? WV
         : id == ZETA_P    ? WZP
         : id == UBAR_P    ? WUP
         : id == VBAR_P    ? WVP
         : id == DUON      ? WDU
         : id == DVOM      ? WDV
         : id == ZWRK      ? WZW
                           : -1;
}

// the scratch fields of a block: the predictor's rhs histories of the
// launch's substeps 0 and 1 and the first substep's new forcing
enum Scr { S_RZ0, S_RU0, S_RV0, S_FU, S_FV, S_RZ1, S_RU1, S_RV1, NSCR };

// the rows and lanes at each window edge outside the points that a later
// half-step reads of substep q's predictor outputs: the corrector's
// points, kMargin (2 q + 1) from each edge, less the reach of the ring
// copies' sources (one row, two lanes)
__host__ __device__ constexpr int keep_j(int q) {
  return kMargin * (2 * q + 1) - 1;
}
__host__ __device__ constexpr int keep_i(int q) {
  return kMargin * (2 * q + 1) - 2;
}

// the launch's parameters
template <typename T>
struct Params {
  Consts<T> k;
  const T* st[NSTAT];   // grid planes
  const T* tab;         // (nfast, 7) scalar table
  const T* in;          // carry, 16 planes of Mj*Li
  T* out;
  T* scratch;           // scr_block elements per block
  long long scr_block;
  int Mj, Li, s0, TJ, TI, HJ, HI, nti, ntiles;
};

// a block's tile, held by value: its window planes (W points each), its
// size (a ragged last tile is smaller), its scratch and the scratch
// regions' sizes
template <typename T>
struct Tile {
  T* win;
  T* scr;
  int W, tj, ti, r0, r1;
};

// calls f(j, i) at the points of the nj x ni rectangle of the window from
// (j0, i0), the block's threads striding over them in row-major order with
// no per-point division
template <typename T, typename F>
__device__ __forceinline__ void each_point(int j0, int i0, int nj, int ni,
                                           F f) {
  const int sj = kThreads<T> / ni, si = kThreads<T> - sj * ni;
  int j = static_cast<int>(threadIdx.x) / ni;
  int i = static_cast<int>(threadIdx.x) - j * ni;
  while (j < nj) {
    f(j0 + j, i0 + i);
    j += sj;
    i += si;
    if (i >= ni) {
      i -= ni;
      ++j;
    }
  }
}

// the window less m points at each edge
template <typename T, typename F>
__device__ __forceinline__ void each_point(const WindowIx& w, int m, F f) {
  each_point<T>(m, m, w.WJ - 2 * m, w.WI - 2 * m, f);
}

// substep Q's predictor or corrector: the window fields in shared memory,
// ubar_prev and vbar_prev in the launch's input carry, the histories and
// the new forcing in scratch, the averages in the output carry
template <typename T, bool FIRST, int Q, bool CORR>
struct BlockIx : WindowIx {
  Tile<T> b;
  const T* in;
  T* out;
  int P, HJ, HI;

  __device__ int sidx(int, int j, int i) const { return gidx(j, i); }
  __device__ T* carry(const T* plane, int id, int j, int i) const {
    return const_cast<T*>(plane) + static_cast<size_t>(id) * P + gidx(j, i);
  }
  // scratch field k at window point (j, i)
  __device__ T* scr(int k, int j, int i) const {
    const int q = k < S_RZ1 ? 0 : 1;
    const int base =
        k < S_RZ1 ? k * b.r0 : S_RZ1 * b.r0 + (k - S_RZ1) * b.r1;
    return b.scr + base + (j - keep_j(q)) * (WI - 2 * keep_i(q)) +
           (i - keep_i(q));
  }
  __device__ T* at(T* const*, int id, int j, int i) const {
    const int w = win_plane<Q, CORR>(id);
    if (w >= 0) return b.win + w * b.W + widx(j, i);
    switch (id) {
      case UBAR_PREV:
        return carry(in, Q == 0 ? UBAR_PREV : UBAR, j, i);
      case VBAR_PREV:
        return carry(in, Q == 0 ? VBAR_PREV : VBAR, j, i);
      case RZ_PREV:
        return Q == 0 ? carry(in, RZ_PREV, j, i) : scr(S_RZ0, j, i);
      case RU_PREV:
        return Q == 0 ? carry(in, RU_PREV, j, i) : scr(S_RU0, j, i);
      case RV_PREV:
        return Q == 0 ? carry(in, RV_PREV, j, i) : scr(S_RV0, j, i);
      case RZ_M:
        return scr(Q == 0 ? S_RZ0 : S_RZ1, j, i);
      case RU_M:
        return scr(Q == 0 ? S_RU0 : S_RU1, j, i);
      case RV_M:
        return scr(Q == 0 ? S_RV0 : S_RV1, j, i);
      // rufrc_c of the first substep becomes the forcing after its
      // predictor
      case RUFRC:
        return FIRST && (Q > 0 || CORR) ? scr(S_FU, j, i)
                                        : carry(in, RUFRC, j, i);
      case RVFRC:
        return FIRST && (Q > 0 || CORR) ? scr(S_FV, j, i)
                                        : carry(in, RVFRC, j, i);
      case RUFRC_N:
        return scr(S_FU, j, i);
      case RVFRC_N:
        return scr(S_FV, j, i);
      default:   // the averages
        return carry(out, id, j, i);
    }
  }
  // the tile's points, which the launch stores
  __device__ bool own(int j, int i) const {
    return static_cast<unsigned>(j - HJ) < static_cast<unsigned>(b.tj) &&
           static_cast<unsigned>(i - HI) < static_cast<unsigned>(b.ti);
  }
  // the points of this predictor's outputs that a later half-step reads
  __device__ bool keep(int j, int i) const {
    return static_cast<unsigned>(j - keep_j(Q)) <
               static_cast<unsigned>(WJ - 2 * keep_j(Q)) &&
           static_cast<unsigned>(i - keep_i(Q)) <
               static_cast<unsigned>(WI - 2 * keep_i(Q));
  }
  // a point whose BCs take another point's value: the wall rows, row 1
  // (vbar) and the periodic lanes
  __device__ bool ring(int j, int i) const {
    const int g = grow(j), l = colg[ci(i)];
    return g <= 1 || g == Mj - 1 || l == 0 || l == Li - 1;
  }
};

// one half-step on the window less kMargin (2 Q + CORR) points a side:
// the fluxes and averages, the free surface with its BCs, then momentum
// before the BCs at every point and the BCs at the ring points, each
// phase reading only what earlier phases wrote
template <typename T, int KS, bool FIRST, int Q, bool CORR>
__device__ __forceinline__ void half_step(const Params<T>& p,
                                          const WindowIx& w,
                                          const Tile<T>& b) {
  using Ix = BlockIx<T, FIRST, Q, CORR>;
  const Ix ix{w, b, p.in, p.out, p.Mj * p.Li, p.HJ, p.HI};
  const Ctx<T, Ix> c{p.k, p.st, p.tab, nullptr, ix, p.s0 + Q};
  const int m = kMargin * (2 * Q + CORR);
  each_point<T>(w, m, [&](int j, int i) { flux_point<T, CORR>(c, j, i); });
  __syncthreads();
  each_point<T>(w, m, [&](int j, int i) { zeta_point<T, CORR>(c, j, i); });
  __syncthreads();
  // momentum only at the points whose values a tile point depends on:
  // kMargin further in than the half-step's other phases (their outer
  // kMargin points feed only dead momentum), and at the launch's last
  // half-step the tile's points.  Before the BCs it is formed one row and
  // two lanes further out as well, where the BCs of those points find
  // their sources.  The predictor's pre-BC ubar_p, vbar_p go to their
  // planes, the corrector's over ubar and vbar, each read at its own
  // point only; the last corrector first stores the tile's ubar and vbar
  // as ubar_prev.
  constexpr int Un = CORR ? UBAR : UBAR_P, Vn = CORR ? VBAR : VBAR_P;
  constexpr bool last = CORR && Q == KS - 1;
  const int j0 = last ? p.HJ : m + kMargin, i0 = last ? p.HI : m + kMargin;
  const int nj = last ? b.tj : w.WJ - 2 * j0, ni = last ? b.ti : w.WI - 2 * i0;
  each_point<T>(j0 - 1, i0 - 2, nj + 2, ni + 4, [&](int j, int i) {
    const MomPt<T> r = mom_raw<T, CORR>(c, j, i);
    if (!CORR && ix.keep(j, i)) mom_store_own<T, CORR>(c, j, i, r);
    if (last && ix.own(j, i)) {
      *ix.carry(p.out, UBAR_PREV, j, i) = c.V(UBAR, j, i);
      *ix.carry(p.out, VBAR_PREV, j, i) = c.V(VBAR, j, i);
    }
    c.F(Un, j, i) = r.un;
    c.F(Vn, j, i) = r.vn;
  });
  __syncthreads();
  each_point<T>(j0, i0, nj, ni, [&](int j, int i) {
    if (!ix.ring(j, i)) return;
    mom_bc<T, CORR>(
        c, j, i, [&](int sj, int si) { return c.V(Un, sj, si); },
        [&](int sj, int si) { return c.V(Vn, sj, si); });
  });
  __syncthreads();
}

// KS substeps from substep p.s0 on tiles blockIdx.x, + gridDim.x, ...:
// each tile's window from p.in, its own points to p.out
template <typename T, int KS, bool FIRST>
__global__ void __launch_bounds__(kThreads<T>, 1)
blocked_kernel(const __grid_constant__ Params<T> p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int Mj = p.Mj, Li = p.Li;
  const int WJ = p.TJ + 2 * p.HJ, WI = p.TI + 2 * p.HI;
  Tile<T> b;
  b.W = WJ * WI;
  b.win = reinterpret_cast<T*>(smem);
  int* rowg = reinterpret_cast<int*>(b.win + NWIN * b.W);
  int* colg = rowg + WJ;
  const WindowIx w{Mj, Li, WJ, WI, rowg, colg};
  b.scr = p.scratch + static_cast<long long>(blockIdx.x) * p.scr_block;
  b.r0 = (WJ - 2 * keep_j(0)) * (WI - 2 * keep_i(0));
  b.r1 = (WJ - 2 * keep_j(1)) * (WI - 2 * keep_i(1));
  const size_t P = static_cast<size_t>(Mj) * Li;
  for (int t = blockIdx.x; t < p.ntiles; t += gridDim.x) {
    const int ty = t / p.nti;
    const int cj0 = ty * p.TJ, ci0 = (t - ty * p.nti) * p.TI;
    b.tj = min(p.TJ, Mj - cj0);
    b.ti = min(p.TI, Li - ci0);
    __syncthreads();   // the previous tile's last reads of the tables
    fill_tables(rowg, colg, cj0 - p.HJ, ci0 - p.HI, WJ, WI, Mj, Li);
    __syncthreads();
    // the state into the window; the averages (and the forcing of a
    // launch that keeps it) to the tile's output points
    each_point<T>(w, 0, [&](int j, int i) {
      const size_t g = static_cast<size_t>(rowg[j]) * Li + colg[i];
      const int n = j * WI + i;
      b.win[wz(0) * b.W + n] = p.in[ZETA * P + g];
      b.win[wz(1) * b.W + n] = p.in[ZETA_PREV * P + g];
      b.win[WU * b.W + n] = p.in[UBAR * P + g];
      b.win[WV * b.W + n] = p.in[VBAR * P + g];
    });
    each_point<T>(p.HJ, p.HI, b.tj, b.ti, [&](int j, int i) {
      const size_t g = static_cast<size_t>(rowg[j]) * Li + colg[i];
      for (int f = ZT; f <= DV2; ++f) p.out[f * P + g] = p.in[f * P + g];
      if (!FIRST) {
        p.out[RUFRC * P + g] = p.in[RUFRC * P + g];
        p.out[RVFRC * P + g] = p.in[RVFRC * P + g];
      }
    });
    __syncthreads();
    half_step<T, KS, FIRST, 0, false>(p, w, b);
    half_step<T, KS, FIRST, 0, true>(p, w, b);
    if constexpr (KS == 2) {
      half_step<T, KS, FIRST, 1, false>(p, w, b);
      half_step<T, KS, FIRST, 1, true>(p, w, b);
    }
    // the rest of the carry at the tile's points
    const BlockIx<T, FIRST, KS - 1, true> ix{w, b, p.in, p.out, Mj * Li,
                                              p.HJ, p.HI};
    each_point<T>(p.HJ, p.HI, b.tj, b.ti, [&](int j, int i) {
      const size_t g = static_cast<size_t>(rowg[j]) * Li + colg[i];
      const int n = j * WI + i;
      p.out[ZETA * P + g] = b.win[wz(KS) * b.W + n];
      p.out[ZETA_PREV * P + g] = b.win[wz(KS - 1) * b.W + n];
      p.out[UBAR * P + g] = b.win[WU * b.W + n];
      p.out[VBAR * P + g] = b.win[WV * b.W + n];
      constexpr int last = KS == 1 ? 0 : 1;
      p.out[RZ_PREV * P + g] = *ix.scr(last ? S_RZ1 : S_RZ0, j, i);
      p.out[RU_PREV * P + g] = *ix.scr(last ? S_RU1 : S_RU0, j, i);
      p.out[RV_PREV * P + g] = *ix.scr(last ? S_RV1 : S_RV0, j, i);
      if (FIRST) {
        p.out[RUFRC * P + g] = *ix.scr(S_FU, j, i);
        p.out[RVFRC * P + g] = *ix.scr(S_FV, j, i);
      }
    });
  }
}

template <typename T, int KS, bool FIRST>
cudaError_t launch(const Params<T>& p, int slots, size_t smem,
                   cudaStream_t stream) {
  const cudaError_t err = roms::allow_smem(blocked_kernel<T, KS, FIRST>, smem);
  if (err != cudaSuccess) return err;
  blocked_kernel<T, KS, FIRST><<<slots, kThreads<T>, smem, stream>>>(p);
  return cudaGetLastError();
}

// dynamic shared memory of a launch: the window planes and the tables
template <typename T>
size_t smem_bytes(int WJ, int WI) {
  return sizeof(T) * NWIN * WJ * WI + sizeof(int) * (WJ + WI);
}

// one launch: ks substeps from s0 over the whole grid, `slots` blocks
template <typename T>
int run(const void* const* stat, const void* in, void* out, void* scratch,
        long long scr_block, const void* table, int s0, int ks, int Mj,
        int Li, int TJ, int TI, int HJ, int HI, int slots, const double* k,
        int flags, void* stream) {
  Params<T> p;
  p.k.set(k, flags);
  for (int s = 0; s < NSTAT; ++s) p.st[s] = static_cast<const T*>(stat[s]);
  p.tab = static_cast<const T*>(table);
  p.in = static_cast<const T*>(in);
  p.out = static_cast<T*>(out);
  p.scratch = static_cast<T*>(scratch);
  p.scr_block = scr_block;
  p.Mj = Mj;
  p.Li = Li;
  p.s0 = s0;
  p.TJ = TJ;
  p.TI = TI;
  p.HJ = HJ;
  p.HI = HI;
  p.nti = (Li + TI - 1) / TI;
  p.ntiles = p.nti * ((Mj + TJ - 1) / TJ);
  const int WJ = TJ + 2 * HJ, WI = TI + 2 * HI;
  // the scratch a block needs (ops/step2d.py blocked_scratch)
  long long need = 1LL * S_RZ1 * (WJ - 2 * keep_j(0)) * (WI - 2 * keep_i(0));
  if (ks == 2)
    need += 1LL * (NSCR - S_RZ1) * (WJ - 2 * keep_j(1)) * (WI - 2 * keep_i(1));
  if ((ks != 1 && ks != 2) || need > scr_block || slots < 1 ||
      HJ < keep_j(ks - 1) || HI < keep_i(ks - 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes<T>(WJ, WI);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool first = s0 == 0;
  const cudaError_t err =
      ks == 2 ? (first ? launch<T, 2, true>(p, slots, smem, st)
                       : launch<T, 2, false>(p, slots, smem, st))
              : (first ? launch<T, 1, true>(p, slots, smem, st)
                       : launch<T, 1, false>(p, slots, smem, st));
  return static_cast<int>(err);
}

// blocks of a KS = 2 launch that the card holds at once
template <typename T>
int slots(int TJ, int TI, int HJ, int HI) {
  const size_t smem = smem_bytes<T>(TJ + 2 * HJ, TI + 2 * HI);
  int dev = 0, sms = 0, per_sm = 0;
  if (roms::allow_smem(blocked_kernel<T, 2, false>, smem) != cudaSuccess ||
      cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, blocked_kernel<T, 2, false>, kThreads<T>, smem) !=
          cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  return sms * per_sm;
}

}  // namespace

#define ROMS_FAST_LOOP_BLOCKED_ENTRY(NAME, T)                               \
  extern "C" int NAME(const void* const* stat, const void* in, void* out,  \
                      void* scratch, long long scr_block, const void* table, \
                      int s0, int ks, int Mj, int Li, int TJ, int TI,      \
                      int HJ, int HI, int slots, const double* k,          \
                      int flags, void* stream) {                           \
    return run<T>(stat, in, out, scratch, scr_block, table, s0, ks, Mj, Li, \
                  TJ, TI, HJ, HI, slots, k, flags, stream);                \
  }                                                                        \
  extern "C" int NAME##_slots(int TJ, int TI, int HJ, int HI) {            \
    return slots<T>(TJ, TI, HJ, HI);                                       \
  }

ROMS_FAST_LOOP_BLOCKED_ENTRY(roms_fast_loop_blocked_f32, float)
ROMS_FAST_LOOP_BLOCKED_ENTRY(roms_fast_loop_blocked_f64, double)
