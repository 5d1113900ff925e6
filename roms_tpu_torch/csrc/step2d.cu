// Kernel 11: the fast barotropic loop (step2d_LF_AM3.h:163-3058), all nfast
// LF-AM3 predictor + corrector substeps with the fast-time averages, in
// one call.
//
// Replaces roms_tpu/ops/pallas_step2d.py:804 fast_loop_pallas_res (the
// VMEM-resident engine, pallas_call l.871: _kernel_res l.736, _substep
// l.334, _rhs2d l.193, _flux_state/_gzeta l.166-191, BC helpers l.90-118);
// plain version core/step2d.py's substep loop (ops/step2d.py).  Class
// (_class_ok, l.890): EW-periodic, closed N/S walls for zeta, ubar and
// vbar, no VolCons, no wet/dry.
//
// What it keeps of the TPU design: the carry stays on the device for the
// whole call, all substeps run inside one call with no host
// synchronisation and no PyTorch operation between them, and the
// per-substep scalar table (first, cffA1, cffA2p, cffA2c, a1, a2, a3) is
// uploaded once per call.  What differs: the Pallas engine precombines
// -a2*ru0 + a3*ru0p2 (fu_hist) and re-derives the metrics from pm/pn/rmask;
// this kernel reads the grid's metrics and the four AB3 histories (only on
// the first substep, where they are used), so it rounds exactly as the
// plain loop does.  Every product that feeds an add or subtract is mul_rn.
//
// Bound on the H100: operations (~470 flops a point a substep, the
// smoke test's bound).  What the design moves instead: each half-step
// reads the carry fields and statics it needs and writes the carry and
// the averages, each plane about once (chip_smoke.py prints the planes a
// launch and the floor they give).
//
// Design: one launch per half-step (predictor or corrector), two a
// substep.  One block owns a tile of TJ rows x TI lanes and works on a
// window of the tile with HJ rows and HI lanes of halo per edge
// (ops/step2d.py half_step_halo: a half-step reads its inputs up to 3
// points away, the BCs' ring copies one row or two lanes further).  It
// runs the half-step's phases on the window with __syncthreads()
// between them:
//   flux: DUon, DVom over the whole window, the averages at the tile's
//         points;
//   zeta: the free-surface update and zwrk over the window less
//         kZetaMargin points a side, the predictor rhs_zeta at the
//         tile's points;
//   momentum: the 2D RHS and the ubar/vbar update at the tile's points,
//         before the BCs, into shared memory;
//   BCs: ubar and vbar of the tile's points from the values their BC
//         copies from, which lie in the tile: the lane tiling is shifted
//         half a tile so that the periodic seam (lanes Li-2 .. 1) sits
//         inside a tile, and the wall rows' inner rows share their
//         tile (a ragged one-row last tile evaluates its source itself).
// DUon, DVom, zwrk and the new zeta, which later phases read with
// neighbours, live in dynamic shared memory (kWin window planes); the
// carry and the grid planes are read in place from device memory (their
// neighbours from L1), and the carry and the averages are written at the
// tile's own points only.  Points near the window's edge read clamped
// neighbours and hold dead values that no tile point reads.
//
// The per-point formulas live in step2d_point.cuh, shared with the
// j-blocked engine (step2d_blocked.cu), here with an indexer that sends
// the window fields to shared memory and the rest to device memory; a
// ring point's BC copies the pre-BC value of the point it copies from
// (bc_rho, bc_u with gamma2, bc_v, periodic lanes).  The host rotates the
// carry's planes (zeta <-> zeta_prev, ubar <-> ubar_prev, ...) between
// launches instead of copying them, and returns where each carry field
// ended.
//
// What sets the pace (PERF.md): latency, not bytes.  The phases read ~20
// grid planes and the carry with neighbours from L1/L2 at 80 registers a
// thread, three 256-thread blocks an SM;
// the tile (ops/step2d.py TILE_RES) is chosen so that the float32 grid
// is one wave of those 396 slots at both full-width channel shapes.
// Keeping zeta, ubar and vbar in shared memory too (seven planes, two
// blocks an SM) was slower, and so was a table-free indexer for tiles
// away from the walls and the seam.
#include "step2d_point.cuh"

namespace {

using namespace roms::step2d;

constexpr int kBlockThreads = 256;
// window planes in shared memory: DUON, DVOM, ZWRK and the new zeta,
// which later phases of the half-step read with neighbours
constexpr int kWin = 4;
// window points a side that the zeta phase skips: the momentum phase
// reads zwrk and the new zeta at most two rows and three lanes beyond
// the tile (with the ring copies), so 2 would do; 1 keeps a point of
// slack.  (Checked with this file compiled for the CPU against the plain
// loop: exact at every tiling tried with margin 1 or 2, wrong with 3 and
// with a halo one row or one lane short.)
constexpr int kZetaMargin = 1;

// the field of window plane w in a predictor (CORR = false) or corrector
// half-step
template <bool CORR>
__host__ __device__ constexpr int win_field(int w) {
  return w == 0 ? DUON : w == 1 ? DVOM : w == 2 ? ZWRK
                                        : (CORR ? ZETA_PREV : ZETA_P);
}

// the window plane of field id, -1 for a field in device memory
template <bool CORR>
__host__ __device__ constexpr int win_plane(int id) {
  for (int w = 0; w < kWin; ++w)
    if (win_field<CORR>(w) == id) return w;
  return -1;
}

// the window fields as a bit mask over the field ids
template <bool CORR>
__host__ __device__ constexpr unsigned win_mask() {
  unsigned m = 0;
  for (int w = 0; w < kWin; ++w) m |= 1u << win_field<CORR>(w);
  return m;
}

// the window: its window fields in shared memory at win (the field ids
// are constants once the formulas are inlined, so each access is a
// shared-memory load from a known plane), every other field in device
// memory at the plane the host's rotation gives it; the tile's own points
// are window rows [HJ, HJ + tj) and lanes [HI, HI + ti) (a ragged last
// tile is smaller)
template <typename T, bool CORR>
struct HalfIx : WindowIx {
  T* win;
  int W, HJ, HI, tj, ti;
  __device__ int sidx(int, int j, int i) const { return gidx(j, i); }
  __device__ T* at(T* const* f, int id, int j, int i) const {
    return (win_mask<CORR>() >> id) & 1u
               ? win + win_plane<CORR>(id) * W + widx(j, i)
               : f[id] + gidx(j, i);
  }
  __device__ bool own(int j, int i) const {
    return static_cast<unsigned>(j - HJ) < static_cast<unsigned>(tj) &&
           static_cast<unsigned>(i - HI) < static_cast<unsigned>(ti);
  }
  // the next launch reads rhs_zeta from device memory at the tile's points
  __device__ bool keep(int j, int i) const { return own(j, i); }
};

// one launch's parameters
template <typename T>
struct Params {
  Consts<T> k;
  const T* st[NSTAT];
  const T* tab;
  T* f[NPLANE];         // the planes after the host's rotations so far
  int Mj, Li, s, TJ, TI, HJ, HI, shift;
};

// three blocks an SM in float32 (<= 85 registers); float64 takes what
// it needs
template <typename T>
constexpr int min_blocks() {
  return sizeof(T) == 4 ? 3 : 1;
}

// dynamic shared memory of a launch: the window planes, the tile's
// pre-BC ubar and vbar, and the tables
template <typename T>
size_t smem_bytes(int TJ, int TI, int HJ, int HI) {
  const int WJ = TJ + 2 * HJ, WI = TI + 2 * HI;
  return sizeof(T) * (kWin * WJ * WI + 2 * TJ * TI) +
         sizeof(int) * (WJ + WI);
}

template <typename T, bool CORR>
__global__ void __launch_bounds__(kBlockThreads, min_blocks<T>())
half_step(const __grid_constant__ Params<T> p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int WJ = p.TJ + 2 * p.HJ, WI = p.TI + 2 * p.HI, W = WJ * WI;
  T* win = reinterpret_cast<T*>(smem);
  T* un = win + kWin * W;     // the tile's pre-BC ubar and vbar
  T* vn = un + p.TJ * p.TI;
  int* rowg = reinterpret_cast<int*>(vn + p.TJ * p.TI);
  int* colg = rowg + WJ;
  // tile x covers lanes [x TI - shift, (x + 1) TI - shift) mod Li
  const int cj0 = blockIdx.y * p.TJ, ci0 = blockIdx.x * p.TI;
  fill_tables(rowg, colg, cj0 - p.HJ, ci0 - p.shift - p.HI, WJ, WI, p.Mj,
              p.Li);
  __syncthreads();
  const HalfIx<T, CORR> ix{{p.Mj, p.Li, WJ, WI, rowg, colg}, win, W,
                           p.HJ, p.HI, min(p.TJ, p.Mj - cj0),
                           min(p.TI, p.Li - ci0)};
  const Ctx<T, HalfIx<T, CORR>> c{p.k, p.st, p.tab, p.f, ix, p.s};
  for (int n = threadIdx.x; n < W; n += blockDim.x) {
    const int j = n / WI;
    flux_point<T, CORR>(c, j, n - j * WI);
  }
  __syncthreads();
  const int m = kZetaMargin, wj = WJ - 2 * m, wi = WI - 2 * m;
  for (int n = threadIdx.x; n < wj * wi; n += blockDim.x) {
    const int j = n / wi;
    zeta_point<T, CORR>(c, m + j, m + n - j * wi);
  }
  __syncthreads();
  // the tile's own points: the new zeta to device memory, momentum
  // before the BCs to shared memory, then the BCs, whose sources lie in
  // the tile (the lane tiling puts the periodic seam inside a tile; only
  // a ragged one-row last tile evaluates its wall row's source itself)
  constexpr int zn = win_field<CORR>(kWin - 1);
  const int ti = ix.ti, nt = ix.tj * ti;
  for (int n = threadIdx.x; n < nt; n += blockDim.x) {
    const int a = n / ti;
    const int j = p.HJ + a, i = p.HI + n - a * ti;
    p.f[zn][ix.gidx(j, i)] = win[(kWin - 1) * W + ix.widx(j, i)];
    const MomPt<T> r = mom_raw<T, CORR>(c, j, i);
    mom_store_own<T, CORR>(c, j, i, r);
    un[n] = r.un;
    vn[n] = r.vn;
  }
  __syncthreads();
  auto tile_at = [&](int j, int i) { return (j - p.HJ) * ti + i - p.HI; };
  for (int n = threadIdx.x; n < nt; n += blockDim.x) {
    const int a = n / ti;
    const int j = p.HJ + a, i = p.HI + n - a * ti;
    mom_bc<T, CORR>(
        c, j, i,
        [&](int sj, int si) {
          return ix.own(sj, si) ? un[tile_at(sj, si)]
                                : mom_raw<T, CORR>(c, sj, si).un;
        },
        [&](int sj, int si) {
          return ix.own(sj, si) ? vn[tile_at(sj, si)]
                                : mom_raw<T, CORR>(c, sj, si).vn;
        });
  }
}

template <typename T>
int run(const void* const* stat, void* buf, const void* table, int* final_idx,
        int nfast, int Mj, int Li, int TJ, int TI, int HJ, int HI,
        const double* k, int flags, void* stream) {
  Params<T> c;
  for (int s = 0; s < NSTAT; ++s) c.st[s] = static_cast<const T*>(stat[s]);
  c.tab = static_cast<const T*>(table);
  c.Mj = Mj;
  c.Li = Li;
  c.TJ = TJ;
  c.TI = TI;
  c.HJ = HJ;
  c.HI = HI;
  // the periodic seam half a tile into the first tile column
  c.shift = min(TI, Li) / 2;
  c.k.set(k, flags);

  const size_t smem = smem_bytes<T>(TJ, TI, HJ, HI);
  cudaError_t err = cudaFuncSetAttribute(
      half_step<T, false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(half_step<T, true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  if (err != cudaSuccess) {
    cudaGetLastError();   // this launch's error, not the next one's
    return static_cast<int>(err);
  }

  Slots slot;
  slot.reset();
  T* base = static_cast<T*>(buf);
  const size_t P = static_cast<size_t>(Mj) * Li;
  auto resolve = [&]() {
    for (int p = 0; p < NPLANE; ++p) c.f[p] = base + slot.s[p] * P;
  };
  const dim3 grid((Li + TI - 1) / TI, (Mj + TJ - 1) / TJ);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto check = [&]() {
    const cudaError_t e = cudaGetLastError();
    if (err == cudaSuccess) err = e;
  };
  for (int s = 0; s < nfast && err == cudaSuccess; ++s) {
    c.s = s;
    resolve();
    half_step<T, false><<<grid, kBlockThreads, smem, st>>>(c);
    check();
    if (s == 0) {
      slot.after_first_predictor();
      resolve();
    }
    half_step<T, true><<<grid, kBlockThreads, smem, st>>>(c);
    check();
    slot.after_substep();
  }
  for (int p = 0; p < NCARRY; ++p) final_idx[p] = slot.s[p];
  return static_cast<int>(err);
}

}  // namespace

#define ROMS_FAST_LOOP_ENTRY(NAME, T)                                        \
  extern "C" int NAME(const void* const* stat, void* buf,                   \
                      const void* table, int* final_idx, int nfast, int Mj, \
                      int Li, int TJ, int TI, int HJ, int HI,               \
                      const double* k, int flags, void* stream) {           \
    return run<T>(stat, buf, table, final_idx, nfast, Mj, Li, TJ, TI, HJ,   \
                  HI, k, flags, stream);                                    \
  }

ROMS_FAST_LOOP_ENTRY(roms_fast_loop_f32, float)
ROMS_FAST_LOOP_ENTRY(roms_fast_loop_f64, double)
