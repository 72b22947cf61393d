// Wilson-clover kernels K1 (full D), K2 (hopping only) and K3 (packed
// clover / clover-inverse apply) for Hopper (sm_90a).
//
// Replaces: ddalphaamg_tpu/operators/pallas_dslash.py::_dslash_kernel
// (modes "full" and "hop", pallas_call at pallas_dslash.py:385) and
// ::_clover_kernel (pallas_call at pallas_dslash.py:353).
//
// What it computes (reference d_plus_clover_PRECISION,
// src/dirac_generic.c:159-278), with links pre-scaled by 1/2 and the
// anti-periodic time sign folded into U_T:
//   eta(x) = C(x) phi(x)
//          - sum_mu [ U_mu(x) (1 - gamma_mu) phi(x + mu)
//                   + U_mu(x - mu)^dagger (1 + gamma_mu) phi(x - mu) ]
//
// Layout (dof-major, sites fastest; V = T*Z*Y*X lexicographic, X fastest):
//   phi, eta   [batch, 12, V]   dof = 3 * spin + color
//   links      [4, 3, 3, V]     (mu, row, col)
//   cdiag      [2, 6, V] real   packed Hermitian clover: diagonal
//   coff       [2, 15, V]       upper triangle, pairs (i, j) with i < j
//
// What bounds it on the H100: memory.  K1 does 1920 flop per site and
// moves about 1.1 KB per site in single precision (9 spinors, of which 8
// are neighbor re-reads that mostly hit L1/L2, 8 link matrices, the packed
// clover, the result): ~1.7 flop/byte against the card's ~20 flop/byte
// fp32 balance point.  The design therefore only has to keep loads
// coalesced: one thread per (batch, site), every array dof-major with the
// site index fastest, so a warp reads 32 consecutive complex numbers per
// load.  Neighbor indices come from coordinates (no index tables, no
// halo); the TPU kernel's fused Y*X axis, x-boundary blend masks and
// t +- 1 block views were tiling devices and are gone.  The half-spinor
// trick (project to 2 spins, multiply, reconstruct) halves the link
// multiplies, as in the reference.  The batch axis shares the links and
// the clover across right-hand sides (Galerkin basis columns, test vectors).
#include "common.cuh"

// gamma_mu[s][GAMMA_CO[mu][s]] = GAMMA_VAL_RE[mu][s] + i GAMMA_VAL_IM[mu][s]
// Clifford basis BASIS0 of gamma.py; directions T, Z, Y, X.
#define GAMMA_CO {{2, 3, 0, 1}, {3, 2, 1, 0}, {3, 2, 1, 0}, {2, 3, 0, 1}}
#define GAMMA_VAL_RE {{-1, -1, -1, -1}, {0, 0, 0, 0}, {-1, 1, 1, -1}, {0, 0, 0, 0}}
#define GAMMA_VAL_IM {{0, 0, 0, 0}, {-1, -1, 1, 1}, {0, 0, 0, 0}, {-1, 1, 1, -1}}

template <typename R>
__device__ __forceinline__ void clover_site(cplx<R> acc[12], const cplx<R> comp[12], const R* __restrict__ cdiag,
                                            const cplx<R>* __restrict__ coff, int site, int V) {
#pragma unroll
  for (int c = 0; c < 2; ++c) {
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      R d = cdiag[(c * 6 + i) * V + site];
      acc[6 * c + i] = cx<R>(d * comp[6 * c + i].re, d * comp[6 * c + i].im);
    }
    int k = 0;
#pragma unroll
    for (int i = 0; i < 6; ++i) {
#pragma unroll
      for (int j = i + 1; j < 6; ++j) {
        cplx<R> o = coff[(c * 15 + k) * V + site];
        cfma(acc[6 * c + i], o, comp[6 * c + j]);
        acc[6 * c + j] = cadd(acc[6 * c + j], cmulc(o, comp[6 * c + i]));
        ++k;
      }
    }
  }
}

template <typename R, bool CLOVER>
__global__ void __launch_bounds__(128) dslash_kernel(cplx<R>* __restrict__ out, const cplx<R>* __restrict__ phi,
                                                     const cplx<R>* __restrict__ links, const R* __restrict__ cdiag,
                                                     const cplx<R>* __restrict__ coff, Lattice L, int V, int batch) {
  constexpr int CO[4][4] = GAMMA_CO;
  constexpr int VRE[4][4] = GAMMA_VAL_RE;
  constexpr int VIM[4][4] = GAMMA_VAL_IM;
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)batch * V) return;
  int b = (int)(idx / V);
  int site = (int)(idx - (long long)b * V);
  const cplx<R>* p = phi + (long long)b * 12 * V;
  int c[4];
  site_coords(L, site, c);

  cplx<R> acc[12];
  if (CLOVER) {
    cplx<R> comp[12];
#pragma unroll
    for (int i = 0; i < 12; ++i) comp[i] = p[i * V + site];
    clover_site(acc, comp, cdiag, coff, site, V);
  } else {
#pragma unroll
    for (int i = 0; i < 12; ++i) acc[i] = cx<R>(0, 0);
  }

#pragma unroll
  for (int mu = 0; mu < 4; ++mu) {
    // ---- forward hop: eta -= U(x) (1 - gamma_mu) phi(x + mu) ----
    {
      int xf = site_step(L, site, c, mu, +1);
      cplx<R> h[2][3];
#pragma unroll
      for (int s = 0; s < 2; ++s)
#pragma unroll
        for (int a = 0; a < 3; ++a)
          h[s][a] = csub(p[(3 * s + a) * V + xf], cphase(VRE[mu][s], VIM[mu][s], p[(3 * CO[mu][s] + a) * V + xf]));
      cplx<R> hf[2][3];
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        cplx<R> u0 = links[((mu * 3 + a) * 3 + 0) * V + site];
        cplx<R> u1 = links[((mu * 3 + a) * 3 + 1) * V + site];
        cplx<R> u2 = links[((mu * 3 + a) * 3 + 2) * V + site];
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          cplx<R> t = cmul(u0, h[s][0]);
          cfma(t, u1, h[s][1]);
          cfma(t, u2, h[s][2]);
          hf[s][a] = t;
        }
      }
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        acc[a] = csub(acc[a], hf[0][a]);
        acc[3 + a] = csub(acc[3 + a], hf[1][a]);
#pragma unroll
        for (int s = 2; s < 4; ++s)
          acc[3 * s + a] = cadd(acc[3 * s + a], cphase(VRE[mu][s], VIM[mu][s], hf[CO[mu][s]][a]));
      }
    }
    // ---- backward hop: eta -= U(x - mu)^H (1 + gamma_mu) phi(x - mu) ----
    {
      int xb = site_step(L, site, c, mu, -1);
      cplx<R> h[2][3];
#pragma unroll
      for (int s = 0; s < 2; ++s)
#pragma unroll
        for (int a = 0; a < 3; ++a)
          h[s][a] = cadd(p[(3 * s + a) * V + xb], cphase(VRE[mu][s], VIM[mu][s], p[(3 * CO[mu][s] + a) * V + xb]));
      cplx<R> hb[2][3];
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        // column a of U: (U^H)[a][b] = conj(U[b][a])
        cplx<R> u0 = links[((mu * 3 + 0) * 3 + a) * V + xb];
        cplx<R> u1 = links[((mu * 3 + 1) * 3 + a) * V + xb];
        cplx<R> u2 = links[((mu * 3 + 2) * 3 + a) * V + xb];
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          cplx<R> t = cmulc(u0, h[s][0]);
          t = cadd(t, cmulc(u1, h[s][1]));
          t = cadd(t, cmulc(u2, h[s][2]));
          hb[s][a] = t;
        }
      }
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        acc[a] = csub(acc[a], hb[0][a]);
        acc[3 + a] = csub(acc[3 + a], hb[1][a]);
#pragma unroll
        for (int s = 2; s < 4; ++s)
          acc[3 * s + a] = csub(acc[3 * s + a], cphase(VRE[mu][s], VIM[mu][s], hb[CO[mu][s]][a]));
      }
    }
  }
  cplx<R>* o = out + (long long)b * 12 * V;
#pragma unroll
  for (int i = 0; i < 12; ++i) o[i * V + site] = acc[i];
}

// K3: eta = C phi per site (C packed Hermitian: the clover or its inverse).
// parity >= 0 keeps only sites with (t+z+y+x) % 2 == parity in global
// coordinates (the odd-site inverse of the odd-even Schur solves); other
// sites get 0.  A slab of a sharded lattice passes parity_offset, the parity
// of its global offset (t0 + z0 + y0 + x0).
template <typename R>
__global__ void __launch_bounds__(128) clover_kernel(cplx<R>* __restrict__ out, const cplx<R>* __restrict__ phi,
                                                     const R* __restrict__ cdiag, const cplx<R>* __restrict__ coff,
                                                     Lattice L, int V, int batch, int parity, int parity_offset) {
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)batch * V) return;
  int b = (int)(idx / V);
  int site = (int)(idx - (long long)b * V);
  cplx<R>* o = out + (long long)b * 12 * V;
  if (parity >= 0) {
    int c[4];
    site_coords(L, site, c);
    if (((c[0] + c[1] + c[2] + c[3] + parity_offset) & 1) != parity) {
#pragma unroll
      for (int i = 0; i < 12; ++i) o[i * V + site] = cx<R>(0, 0);
      return;
    }
  }
  const cplx<R>* p = phi + (long long)b * 12 * V;
  cplx<R> comp[12], acc[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) comp[i] = p[i * V + site];
  clover_site(acc, comp, cdiag, coff, site, V);
#pragma unroll
  for (int i = 0; i < 12; ++i) o[i * V + site] = acc[i];
}

namespace {

constexpr int kThreads = 128;

inline unsigned blocks_for(long long n) { return (unsigned)((n + kThreads - 1) / kThreads); }

template <typename R>
int launch_dslash(void* out, const void* phi, const void* links, const void* cdiag, const void* coff, int t, int z,
                  int y, int x, int batch, int with_clover, void* stream) {
  Lattice L = make_lattice(t, z, y, x);
  int V = t * z * y * x;
  cudaStream_t s = (cudaStream_t)stream;
  auto o = (cplx<R>*)out;
  auto p = (const cplx<R>*)phi;
  auto u = (const cplx<R>*)links;
  if (with_clover)
    dslash_kernel<R, true><<<blocks_for((long long)batch * V), kThreads, 0, s>>>(
        o, p, u, (const R*)cdiag, (const cplx<R>*)coff, L, V, batch);
  else
    dslash_kernel<R, false><<<blocks_for((long long)batch * V), kThreads, 0, s>>>(o, p, u, nullptr, nullptr, L, V,
                                                                                 batch);
  return (int)cudaGetLastError();
}

template <typename R>
int launch_clover(void* out, const void* phi, const void* cdiag, const void* coff, int t, int z, int y, int x,
                  int batch, int parity, int parity_offset, void* stream) {
  Lattice L = make_lattice(t, z, y, x);
  int V = t * z * y * x;
  clover_kernel<R><<<blocks_for((long long)batch * V), kThreads, 0, (cudaStream_t)stream>>>(
      (cplx<R>*)out, (const cplx<R>*)phi, (const R*)cdiag, (const cplx<R>*)coff, L, V, batch, parity,
      parity_offset);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K1 (with_clover = 1) / K2 (with_clover = 0); returns cudaGetLastError().
int ddaamg_dslash_f32(void* out, const void* phi, const void* links, const void* cdiag, const void* coff, int t, int z,
                      int y, int x, int batch, int with_clover, void* stream) {
  return launch_dslash<float>(out, phi, links, cdiag, coff, t, z, y, x, batch, with_clover, stream);
}

int ddaamg_dslash_f64(void* out, const void* phi, const void* links, const void* cdiag, const void* coff, int t, int z,
                      int y, int x, int batch, int with_clover, void* stream) {
  return launch_dslash<double>(out, phi, links, cdiag, coff, t, z, y, x, batch, with_clover, stream);
}

// K3; parity -1 = all sites, parity_offset = the global coordinate sum of
// site 0.
int ddaamg_clover_f32(void* out, const void* phi, const void* cdiag, const void* coff, int t, int z, int y, int x,
                      int batch, int parity, int parity_offset, void* stream) {
  return launch_clover<float>(out, phi, cdiag, coff, t, z, y, x, batch, parity, parity_offset, stream);
}

int ddaamg_clover_f64(void* out, const void* phi, const void* cdiag, const void* coff, int t, int z, int y, int x,
                      int batch, int parity, int parity_offset, void* stream) {
  return launch_clover<double>(out, phi, cdiag, coff, t, z, y, x, batch, parity, parity_offset, stream);
}

}  // extern "C"
