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
// Bound on the H100: bytes per substep.  A substep touches the 16 carry
// fields and ~20 two-dimensional grid and scratch fields; no
// single-pass bound holds once the carry lives in device memory, so the
// smoke test reports the per-call bound (carry in and out, statics once)
// beside the per-substep traffic.
//
// Design: one substep is six launches, one thread per (j, i) point each,
// because every stage needs +-2 neighbours of the stage before it after
// the lateral BCs:
//   flux (predictor / corrector): DUon, DVom (periodic lanes), averages;
//   zeta: the free-surface update, zwrk and the predictor rhs_zeta;
//   momentum: the 2D RHS (pressure gradient, C4 advection, Coriolis,
//             metric terms, harmonic viscosity) and the ubar/vbar update.
// The BCs are applied inside each phase from global indices: the thread
// of a ring point evaluates the pre-BC formula at the point the BC copies
// from (bc_rho, bc_u with gamma2, bc_v, periodic lanes), so no BC pass
// and no race.  The per-point formulas live in step2d_point.cuh, shared
// with the j-blocked engine (step2d_blocked.cu), here with the
// whole-plane indexer.  The host loop rotates the carry's planes (zeta <->
// zeta_prev, ubar <-> ubar_prev, ...) instead of copying them, and
// returns where each carry field ended.
#include "step2d_point.cuh"

namespace {

using namespace roms::step2d;
using roms::wrap;

// the whole (Mj, Li) plane: a point is its global (j, i), neighbours
// wrapped as jnp.roll wraps; the BC maps return in-range indices
struct PlaneIx {
  int Mj, Li;
  __device__ int grow(int j) const { return wrap(j, Mj); }
  __device__ int sidx(int j, int i) const {
    return wrap(j, Mj) * Li + wrap(i, Li);
  }
  __device__ int fidx(int j, int i) const { return sidx(j, i); }
  __device__ int px(int i) const { return roms::ring_x(wrap(i, Li), Li, true); }
  __device__ int ring_row(int j) const {
    j = wrap(j, Mj);
    return j == 0 ? 1 : (j == Mj - 1 ? Mj - 2 : j);
  }
  __device__ int rv_row(int j) const {
    j = wrap(j, Mj);
    return j == 1 ? 2 : (j == Mj - 1 ? Mj - 2 : j);
  }
};

// one phase launch's parameters
template <typename T>
struct Params {
  Consts<T> k;
  const T* st[NSTAT];
  const T* tab;
  T* f[NPLANE];         // the planes after the host's rotations so far
  int Mj, Li, s;
};

template <typename T>
__device__ Ctx<T, PlaneIx> plane_ctx(const Params<T>& p) {
  return {p.k, p.st, p.tab, p.f, PlaneIx{p.Mj, p.Li}, p.s};
}

template <typename T, bool CORR>
__global__ void flux_phase(const __grid_constant__ Params<T> p) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= p.Mj * p.Li) return;
  flux_point<T, CORR>(plane_ctx(p), n / p.Li, n % p.Li);
}

template <typename T, bool CORR>
__global__ void zeta_phase(const __grid_constant__ Params<T> p) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= p.Mj * p.Li) return;
  zeta_point<T, CORR>(plane_ctx(p), n / p.Li, n % p.Li);
}

template <typename T, bool CORR>
__global__ void mom_phase(const __grid_constant__ Params<T> p) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= p.Mj * p.Li) return;
  mom_point<T, CORR>(plane_ctx(p), n / p.Li, n % p.Li);
}

template <typename T>
int run(const void* const* stat, void* buf, const void* table, int* final_idx,
        int nfast, int Mj, int Li, const double* k, int flags,
        void* stream) {
  Params<T> c;
  for (int s = 0; s < NSTAT; ++s) c.st[s] = static_cast<const T*>(stat[s]);
  c.tab = static_cast<const T*>(table);
  c.Mj = Mj;
  c.Li = Li;
  c.k.set(k, flags);

  Slots slot;
  slot.reset();
  T* base = static_cast<T*>(buf);
  const size_t P = static_cast<size_t>(Mj) * Li;
  auto resolve = [&]() {
    for (int p = 0; p < NPLANE; ++p) c.f[p] = base + slot.s[p] * P;
  };
  const int nb = roms::blocks_for(static_cast<long long>(P));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
  auto check = [&]() {
    const cudaError_t e = cudaGetLastError();
    if (err == cudaSuccess) err = e;
  };
  for (int s = 0; s < nfast && err == cudaSuccess; ++s) {
    c.s = s;
    resolve();
    flux_phase<T, false><<<nb, roms::kThreads, 0, st>>>(c);
    check();
    zeta_phase<T, false><<<nb, roms::kThreads, 0, st>>>(c);
    check();
    mom_phase<T, false><<<nb, roms::kThreads, 0, st>>>(c);
    check();
    if (s == 0) {
      slot.after_first_predictor();
      resolve();
    }
    flux_phase<T, true><<<nb, roms::kThreads, 0, st>>>(c);
    check();
    zeta_phase<T, true><<<nb, roms::kThreads, 0, st>>>(c);
    check();
    mom_phase<T, true><<<nb, roms::kThreads, 0, st>>>(c);
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
                      int Li, const double* k, int flags, void* stream) {   \
    return run<T>(stat, buf, table, final_idx, nfast, Mj, Li, k, flags,     \
                  stream);                                                  \
  }

ROMS_FAST_LOOP_ENTRY(roms_fast_loop_f32, float)
ROMS_FAST_LOOP_ENTRY(roms_fast_loop_f64, double)

