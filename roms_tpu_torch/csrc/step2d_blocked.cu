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
// the tile and recomputes the predictor and the corrector over the whole
// window, so no synchronisation between tiles is needed inside a launch;
// only the tile's own points are written.  The scalar table (first,
// cffA1, cffA2p, cffA2c, a1, a2, a3) is uploaded once per fast loop and
// each launch reads its rows.
//
// What differs from the TPU kernel:
//  - tiles in i as well as j (bands of full rows give too few blocks for
//    132 SMs), one CUDA block per tile;
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
// lanes, lane 0 <- Li-2) further, once.  On a 4-lane grid the periodic
// copies chain (lane Li-4 is lane 0, two lanes west of lane Li-2), which
// takes two lanes more, as in kernel 11's half_step_halo.  So a window of
// HJ = 6 KS + 1 rows and HI = 6 KS + 2 (+ 2 when Li = 4) lanes per edge
// (ops/step2d.py halo) leaves the tile's own points exact; points nearer
// the window's edge read clamped neighbours and hold dead values, which no
// tile point reads.  Half-step h skips the outer 3 h points of each edge,
// which earlier half-steps have already left dead.  (Checked against the
// plain loop with the CUDA source compiled for the CPU: exact at every
// tiling tried, still exact with a halo one point short, wrong with one
// two points short or with a margin of 5; at Li = 4 without the two extra
// lanes it departed by 9.4e-14 and 2.9e-11 relative at Mj = 4 and 5
// after 42 substeps.)
//
// Where intermediates live: in a scratch buffer in device memory that the
// wrapper allocates, NPLANE window planes per block (the 16 carry fields
// and 11 scratch planes of kernel 11; 670 KB a block in float32 at the
// default 24 x 96 tile), read through L1/L2.  Each of a substep's six
// phases runs over the window with the block's threads striding over its
// points, separated by __syncthreads().  The carry is ping-ponged between
// launches: a block reads its window from the input planes and writes its
// tile to the output planes, since neighbouring blocks read halo rows of
// the input while others write.
//
// Registers set the pace (two 256-thread blocks an SM at 128 registers):
// the launch's parameters are one __grid_constant__ struct that threads
// read in place, and the block's plane table (the slot rotation of kernel
// 11's host loop) lives in shared memory, not in each thread.
//
// Bound on the H100: the function is kernel 11's, so its bound is too
// (operations: ~470 flops a point a substep).  Its own design's floor is
// the carry (16 planes) and statics (28) read and the carry written once
// a launch; the halo recompute multiplies the arithmetic by about
// WJ WI / (TJ TI), 2.7 at the default tile (2.1 with the margins).
#include "step2d_point.cuh"

namespace {

using namespace roms::step2d;

constexpr int kBlockThreads = 256;
// points per window edge that each half-step leaves dead for the next
constexpr int kMargin = 3;

// kernel 12 keeps every field of the window in its scratch planes, and
// each block stores its tile from there after its last substep
struct TileIx : WindowIx {
  __device__ int sidx(int, int j, int i) const { return gidx(j, i); }
  template <typename T>
  __device__ T* at(T* const* f, int id, int j, int i) const {
    return f[id] + widx(j, i);
  }
  __device__ bool own(int, int) const { return true; }
};

// the launch's parameters
template <typename T>
struct Params {
  Consts<T> k;
  const T* st[NSTAT];   // grid planes
  const T* tab;         // (nfast, 7) scalar table
  const T* in;          // carry, 16 planes of Mj*Li
  T* out;
  T* scratch;           // NPLANE window planes per block
  int Mj, Li, s0, ks, TJ, TI, HJ, HI;
};

template <typename T>
using TileCtx = Ctx<T, TileIx>;

// a phase over the window less m points at each edge
template <typename T, int PHASE, bool CORR>
__device__ void window_phase(const TileCtx<T>& c, int m) {
  const int wj = c.ix.WJ - 2 * m, wi = c.ix.WI - 2 * m;
  for (int n = threadIdx.x; n < wj * wi; n += blockDim.x) {
    const int j = m + n / wi, i = m + n % wi;
    if (PHASE == 0) flux_point<T, CORR>(c, j, i);
    if (PHASE == 1) zeta_point<T, CORR>(c, j, i);
    if (PHASE == 2) mom_point<T, CORR>(c, j, i);
  }
  __syncthreads();
}

// p.ks substeps from substep p.s0 on the tile of this block: its window
// from p.in, its own points to p.out
template <typename T>
__global__ void __launch_bounds__(kBlockThreads)
blocked_kernel(const __grid_constant__ Params<T> p) {
  extern __shared__ int tables[];
  __shared__ T* planes[NPLANE];
  __shared__ Slots slot;
  const int Mj = p.Mj, Li = p.Li;
  const int WJ = p.TJ + 2 * p.HJ, WI = p.TI + 2 * p.HI;
  const int cj0 = blockIdx.y * p.TJ, ci0 = blockIdx.x * p.TI;
  int* rowg = tables;
  int* colg = tables + WJ;
  fill_tables(rowg, colg, cj0 - p.HJ, ci0 - p.HI, WJ, WI, Mj, Li);
  const size_t W = static_cast<size_t>(WJ) * WI;
  const size_t P = static_cast<size_t>(Mj) * Li;
  T* base = p.scratch +
            (static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x) *
                NPLANE * W;
  // the plane of each field after the slot rotations so far
  auto resolve = [&]() {
    for (int q = threadIdx.x; q < NPLANE; q += blockDim.x)
      planes[q] = base + slot.s[q] * W;
    __syncthreads();
  };
  if (threadIdx.x == 0) slot.reset();
  __syncthreads();
  for (size_t n = threadIdx.x; n < NCARRY * W; n += blockDim.x) {
    const int q = static_cast<int>(n / W);
    const int r = static_cast<int>(n - q * W);
    const int j = r / WI, i = r - j * WI;
    base[n] = p.in[q * P + static_cast<size_t>(rowg[j]) * Li + colg[i]];
  }
  resolve();

  TileCtx<T> c{p.k, p.st, p.tab, planes,
               TileIx{{Mj, Li, WJ, WI, rowg, colg}}, 0};
  // half-step h (predictor 2q, corrector 2q + 1) skips the kMargin * h
  // points at each window edge that earlier half-steps left dead
  for (int q = 0; q < p.ks; ++q) {
    c.s = p.s0 + q;
    const int mp = kMargin * 2 * q, mc = kMargin * (2 * q + 1);
    window_phase<T, 0, false>(c, mp);
    window_phase<T, 1, false>(c, mp);
    window_phase<T, 2, false>(c, mp);
    if (c.s == 0) {
      if (threadIdx.x == 0) slot.after_first_predictor();
      __syncthreads();
      resolve();
    }
    window_phase<T, 0, true>(c, mc);
    window_phase<T, 1, true>(c, mc);
    window_phase<T, 2, true>(c, mc);
    if (threadIdx.x == 0) slot.after_substep();
    __syncthreads();
    resolve();
  }

  // the tile's own points, each carry field to its own output plane
  const int TP = p.TJ * p.TI;
  for (int n = threadIdx.x; n < NCARRY * TP; n += blockDim.x) {
    const int q = n / TP, r = n - q * TP;
    const int j = r / p.TI, i = r - j * p.TI;
    if (cj0 + j >= Mj || ci0 + i >= Li) continue;
    p.out[q * P + static_cast<size_t>(cj0 + j) * Li + ci0 + i] =
        planes[q][static_cast<size_t>(p.HJ + j) * WI + p.HI + i];
  }
}

// one launch: ks substeps from s0 over the whole grid
template <typename T>
int run(const void* const* stat, const void* in, void* out, void* scratch,
        const void* table, int s0, int ks, int Mj, int Li, int TJ, int TI,
        int HJ, int HI, const double* k, int flags, void* stream) {
  Params<T> p;
  p.k.set(k, flags);
  for (int s = 0; s < NSTAT; ++s) p.st[s] = static_cast<const T*>(stat[s]);
  p.tab = static_cast<const T*>(table);
  p.in = static_cast<const T*>(in);
  p.out = static_cast<T*>(out);
  p.scratch = static_cast<T*>(scratch);
  p.Mj = Mj;
  p.Li = Li;
  p.s0 = s0;
  p.ks = ks;
  p.TJ = TJ;
  p.TI = TI;
  p.HJ = HJ;
  p.HI = HI;
  const dim3 grid((Li + TI - 1) / TI, (Mj + TJ - 1) / TJ);
  const size_t smem = sizeof(int) * (TJ + 2 * HJ + TI + 2 * HI);
  blocked_kernel<T><<<grid, kBlockThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define ROMS_FAST_LOOP_BLOCKED_ENTRY(NAME, T)                                \
  extern "C" int NAME(const void* const* stat, const void* in, void* out,   \
                      void* scratch, const void* table, int s0, int ks,     \
                      int Mj, int Li, int TJ, int TI, int HJ, int HI,       \
                      const double* k, int flags, void* stream) {           \
    return run<T>(stat, in, out, scratch, table, s0, ks, Mj, Li, TJ, TI, HJ, \
                  HI, k, flags, stream);                                    \
  }

ROMS_FAST_LOOP_BLOCKED_ENTRY(roms_fast_loop_blocked_f32, float)
ROMS_FAST_LOOP_BLOCKED_ENTRY(roms_fast_loop_blocked_f64, double)
