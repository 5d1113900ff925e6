// Kernel 1: column equation of state (linear or Jackett & McDougall 1995)
// with the barotropic-coupling averages and the Brunt-Vaisala frequency.
//
// Replaces roms_tpu/ops/pallas_rho.py:76 rho_eos_pallas (pallas_call at
// l.103; block math rho_block l.26-62); plain version ops/rho.py.
//
// Bound on the H100: bytes.  Per column it reads t (NT*N), z_r, Hz (N)
// and z_w (N+1) and writes rho, pden (N), bvf (N+1), rhoA and rhoS (1):
// about (NT+5)*N+4 words against at most ~60 flops per level for JM95,
// two orders of magnitude under the card's flop/byte balance.
//
// Design: one thread per (j, i) column, consecutive threads on
// consecutive i, so every k-plane load and store is coalesced; the column
// body is roms::eos_column (rho_col.cuh), shared with the prep kernel.
// No shared memory.
#include "rho_col.cuh"

namespace {

using roms::EosParams;

// levels eos_column keeps in flight ahead of the one it works on: none,
// each level's inputs are loaded as it comes (at full occupancy a ring
// of registers cost kernel 1 more in occupancy than it hid)
constexpr int kAhead = 0;

// eos_column sink that stores every level and interface
template <typename T>
struct StoreAll {
  T* rho;
  T* pden;
  T* bvf;
  int P, c;
  __device__ void level(int k, T r, T pd) {
    const size_t o = static_cast<size_t>(k) * P + c;
    rho[o] = r;
    pden[o] = pd;
  }
  __device__ void interface(int k, T b) {
    bvf[static_cast<size_t>(k) * P + c] = b;
  }
};

template <typename T>
__global__ void rho_kernel(const T* __restrict__ t,
                           const T* __restrict__ z_r,
                           const T* __restrict__ Hz,
                           const T* __restrict__ z_w,
                           T* __restrict__ rho, T* __restrict__ pden,
                           T* __restrict__ rhoA, T* __restrict__ rhoS,
                           T* __restrict__ bvf, int NT, int N, int P,
                           EosParams p) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= P) return;
  StoreAll<T> sink{rho, pden, bvf, P, c};
  T A, S;
  roms::eos_column<kAhead>(t, z_r, Hz, z_w, NT, N, P, c, p, sink, A, S);
  bvf[c] = T(0);
  bvf[static_cast<size_t>(N) * P + c] = T(0);
  rhoA[c] = A;
  rhoS[c] = S;
}

template <typename T>
int launch(const void* t, const void* z_r, const void* Hz, const void* z_w,
           void* rho, void* pden, void* rhoA, void* rhoS, void* bvf,
           int NT, int N, int P, const EosParams& p, void* stream) {
  rho_kernel<T><<<roms::blocks_for(P), roms::kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(t), static_cast<const T*>(z_r),
      static_cast<const T*>(Hz), static_cast<const T*>(z_w),
      static_cast<T*>(rho), static_cast<T*>(pden), static_cast<T*>(rhoA),
      static_cast<T*>(rhoS), static_cast<T*>(bvf), NT, N, P, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define ROMS_RHO_ENTRY(NAME, T)                                              \
  extern "C" int NAME(const void* t, const void* z_r, const void* Hz,       \
                      const void* z_w, void* rho, void* pden, void* rhoA,   \
                      void* rhoS, void* bvf, int NT, int N, int P,          \
                      int linear, int use_s, double R0, double T0,          \
                      double S0, double R0Tcoef, double R0Scoef,            \
                      double bvf_c, double neg_g, double o_rho0,            \
                      double two_o_rho0, void* stream) {                    \
    EosParams p{linear, use_s, R0, T0, S0, R0Tcoef, R0Scoef,                \
                bvf_c, neg_g, o_rho0, two_o_rho0};                          \
    return launch<T>(t, z_r, Hz, z_w, rho, pden, rhoA, rhoS, bvf, NT, N, P, \
                     p, stream);                                            \
  }

ROMS_RHO_ENTRY(roms_rho_eos_f32, float)
ROMS_RHO_ENTRY(roms_rho_eos_f64, double)
