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
//   compact    [2, 6, V/2], [2, 15, V/2]: the clover (inverse) at the sites
//              of one parity only, by checkerboard index h = site / 2 (with
//              an even x extent each x-pair (2h, 2h+1) holds one site of
//              either parity)
//
// What bounds them on the H100: memory.  K1 does 1896 flop per site and
// right-hand side against ~400 B of compulsory traffic in f32 (~5 flop/B;
// the card's f32 balance point is ~20), K3 576 flop against ~360 B.  The
// first port (one thread per (right-hand side, site), the batch slowest)
// lost the bound in three ways, and the design answers each:
//
// (1) Few threads, long dependency chains.  At batch 1 one thread per site
//     is 65,536 threads at 16^4, a quarter of the card's thread slots, each
//     with ~170 loads and 12 complex accumulators.  The batch-1 kernel
//     gives the four directions of a site to four warps of one block (32
//     sites x 4 directions = 128 threads), so each thread makes 2 hops (42
//     loads) and a warp's direction, hence its gamma structure, is
//     compile-time (no divergence).  The four partial sums meet in shared
//     memory and are added in a fixed order, ((mu0 + mu1) + (mu2 + mu3)),
//     then the warp's three clover rows; warp w writes spin w.
// (2) Re-fetched links and clover.  With the batch slowest, every
//     right-hand side re-read a site's eight link matrices (288 B in f32,
//     three times the spinor) and the clover from DRAM once the fields
//     outgrew the L2.  The multi-right-hand-side kernel puts the batch
//     inside the block: four warps of the same 32 sites take right-hand
//     sides w, w + 4, ..., one thread a whole site (the reference's order
//     of terms), so the links and clover come from DRAM once and from L1
//     after; no barrier separates the right-hand sides.
// (3) Half the work thrown away.  Every K2 of the SAP's block odd-even
//     solve maps a field of one parity to the other and its result is read
//     on one parity only (smoothers/sap.py), and the fine clover inverse is
//     only ever applied on the odd sites.  parity >= 0 computes the sites
//     of that parity only (global parity: a slab passes the parity of its
//     offset, t0 + z0 + y0 + x0), one thread (group) per x-pair, and writes
//     the pair as one vector store, the result in its slot and zero in the
//     other: full sectors.  K3 reads the odd-site inverse from the compact
//     storage (half the bytes, no stride-2 sectors).  The parities of
//     neighbouring sites share DRAM sectors, so a parity K2 still reads all
//     links and all of the input's sectors: it saves L2 traffic and flops,
//     not DRAM bytes.
//
// K3 is block diagonal in chirality: one thread per site (both blocks) or,
// with a parity, per (x-pair, chirality), the packed entries in registers
// across the right-hand sides.  Register arrays are indexed only by
// constants after unrolling (a computed index puts them in local memory).
// No atomics: two launches give the same bits.  Neighbor indices come from
// coordinates (no index tables, no halo); the TPU kernel's fused Y*X axis,
// x-boundary blend masks and t +- 1 block views were tiling devices and
// are gone.  The half-spinor trick (project to 2 spins, multiply,
// reconstruct) halves the link multiplies, as in the reference.  Device
// times against the bound: PERF.md (scripts/probe_torch_dslash.py).
#include "common.cuh"

// gamma_mu[s][GAMMA_CO[mu][s]] = GAMMA_VAL_RE[mu][s] + i GAMMA_VAL_IM[mu][s]
// Clifford basis BASIS0 of gamma.py; directions T, Z, Y, X.
#define GAMMA_CO {{2, 3, 0, 1}, {3, 2, 1, 0}, {3, 2, 1, 0}, {2, 3, 0, 1}}
#define GAMMA_VAL_RE {{-1, -1, -1, -1}, {0, 0, 0, 0}, {-1, 1, 1, -1}, {0, 0, 0, 0}}
#define GAMMA_VAL_IM {{0, 0, 0, 0}, {-1, -1, 1, 1}, {0, 0, 0, 0}, {-1, 1, 1, -1}}

constexpr int DS_SITES = 32;                // batch-1 K1 / K2 block: sites, one per lane,
constexpr int DS_THREADS = 4 * DS_SITES;    // and a warp per direction
constexpr int MR_SLOTS = 128;               // batched K1 / K2 block: sites (or x-pairs), one a thread
constexpr int CL_THREADS = 128;

// ---------------------------------------------------------------------------
// packed Hermitian 6 x 6 blocks: rows [R0, R0 + NR) of C x
// ---------------------------------------------------------------------------

__host__ __device__ constexpr int pair_i(int k) { return k < 5 ? 0 : k < 9 ? 1 : k < 12 ? 2 : k < 14 ? 3 : 4; }
__host__ __device__ constexpr int pair_j(int k) {
  return k < 5 ? k + 1 : k < 9 ? k - 3 : k < 12 ? k - 6 : k < 14 ? k - 8 : 5;
}
__host__ __device__ constexpr int pair_k(int i, int j) { return i * (11 - i) / 2 + (j - i - 1); }

// The entries of one chirality block that rows [R0, R0 + NR) read: NR
// diagonal reals and the off-diagonal pairs that touch those rows, held by
// pair index k (arrays indexed by plain constants after unrolling stay in
// registers; the two halves of a block, R0 = 0 and 3, share one set).
template <typename R, int NR>
struct CloverRows {
  R d[NR];
  cplx<R> o[15];

  template <int R0>
  static __device__ __forceinline__ bool touches(int k) {
    return (pair_i(k) >= R0 && pair_i(k) < R0 + NR) || (pair_j(k) >= R0 && pair_j(k) < R0 + NR);
  }

  // idx: the site's column in the storage of Vc sites
  template <int R0>
  __device__ __forceinline__ void load(const R* __restrict__ cdiag, const cplx<R>* __restrict__ coff, int ch,
                                       int idx, int Vc) {
#pragma unroll
    for (int r = 0; r < NR; ++r) d[r] = cdiag[(long long)(ch * 6 + R0 + r) * Vc + idx];
#pragma unroll
    for (int k = 0; k < 15; ++k)
      if (touches<R0>(k)) o[k] = coff[(long long)(ch * 15 + k) * Vc + idx];
  }

  // y[r] = d x[R0 + r] + sum_{j != R0 + r, ascending} C[R0 + r][j] x[j]
  template <int R0>
  __device__ __forceinline__ void apply(cplx<R> y[NR], const cplx<R> x[6]) const {
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      const int row = R0 + r;
      y[r] = cx<R>(d[r] * x[row].re, d[r] * x[row].im);
#pragma unroll
      for (int j = 0; j < 6; ++j) {
        if (j < row)
          y[r] = cadd(y[r], cmulc(o[pair_k(j, row)], x[j]));
        else if (j > row)
          cfma(y[r], o[pair_k(row, j)], x[j]);
      }
    }
  }
};

// two consecutive complex numbers: the two sites of an x-pair
template <typename R>
struct alignas(4 * sizeof(R)) cpair {
  cplx<R> v0, v1;
};

// y at the pair's site sel (0: 2h, 1: 2h + 1), zero at the other
template <typename R>
__device__ __forceinline__ void store_pair(cplx<R>* row, int h, int sel, cplx<R> y) {
  const cplx<R> zero = cx<R>(0, 0);
  cpair<R> p;
  p.v0 = sel ? zero : y;
  p.v1 = sel ? y : zero;
  reinterpret_cast<cpair<R>*>(row)[h] = p;
}

// Site of a thread slot: the slot itself, or with PARITY the site of parity
// `parity` in x-pair `slot` (parity_offset: the slab's global offset parity).
template <bool PARITY>
__device__ __forceinline__ int locate(const Lattice& L, int slot, int parity, int parity_offset, int c[4],
                                      int& sel) {
  if (!PARITY) {
    sel = 0;
    site_coords(L, slot, c);
    return slot;
  }
  site_coords(L, 2 * slot, c);    // x even: the pair's first site has parity (t + z + y + offset) & 1
  sel = (c[0] + c[1] + c[2] + parity_offset + parity) & 1;
  c[3] += sel;
  return 2 * slot + sel;
}

// ---------------------------------------------------------------------------
// K1 / K2
// ---------------------------------------------------------------------------

template <int MU>
__device__ __forceinline__ void neighbors(const Lattice& L, int site, const int c[4], int& xf, int& xb) {
  xf = site_step(L, site, c, MU, +1);
  xb = site_step(L, site, c, MU, -1);
}

// acc = (ACC ? acc : 0) - [U(x) (1 - gamma_MU) phi(x + MU)
//                          + U(x - MU)^H (1 + gamma_MU) phi(x - MU)],
// the links of both hops loaded here
template <typename R, int MU, bool ACC>
__device__ __forceinline__ void hop_dir(cplx<R> acc[12], const cplx<R>* __restrict__ p,
                                        const cplx<R>* __restrict__ links, int site, int xf, int xb, int V) {
  constexpr int CO[4][4] = GAMMA_CO;
  constexpr int VRE[4][4] = GAMMA_VAL_RE;
  constexpr int VIM[4][4] = GAMMA_VAL_IM;
  cplx<R> u[9], h[2][3], t[2][3];
  // forward: project, multiply by U(x), reconstruct
#pragma unroll
  for (int e = 0; e < 9; ++e) u[e] = links[(MU * 9 + e) * V + site];
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int a = 0; a < 3; ++a)
      h[s][a] = csub(p[(3 * s + a) * V + xf], cphase(VRE[MU][s], VIM[MU][s], p[(3 * CO[MU][s] + a) * V + xf]));
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      cplx<R> v = cmul(u[3 * a], h[s][0]);
      cfma(v, u[3 * a + 1], h[s][1]);
      cfma(v, u[3 * a + 2], h[s][2]);
      t[s][a] = v;
    }
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    acc[a] = ACC ? csub(acc[a], t[0][a]) : cx<R>(-t[0][a].re, -t[0][a].im);
    acc[3 + a] = ACC ? csub(acc[3 + a], t[1][a]) : cx<R>(-t[1][a].re, -t[1][a].im);
#pragma unroll
    for (int s = 2; s < 4; ++s) {
      const cplx<R> v = cphase(VRE[MU][s], VIM[MU][s], t[CO[MU][s]][a]);
      acc[3 * s + a] = ACC ? cadd(acc[3 * s + a], v) : v;
    }
  }
  // backward: project, multiply by U(x - MU)^H, reconstruct
#pragma unroll
  for (int e = 0; e < 9; ++e) u[e] = links[(MU * 9 + e) * V + xb];
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int a = 0; a < 3; ++a)
      h[s][a] = cadd(p[(3 * s + a) * V + xb], cphase(VRE[MU][s], VIM[MU][s], p[(3 * CO[MU][s] + a) * V + xb]));
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      // column a of U: (U^H)[a][b] = conj(U[b][a])
      cplx<R> v = cmulc(u[a], h[s][0]);
      v = cadd(v, cmulc(u[3 + a], h[s][1]));
      v = cadd(v, cmulc(u[6 + a], h[s][2]));
      t[s][a] = v;
    }
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    acc[a] = csub(acc[a], t[0][a]);
    acc[3 + a] = csub(acc[3 + a], t[1][a]);
#pragma unroll
    for (int s = 2; s < 4; ++s) acc[3 * s + a] = csub(acc[3 * s + a], cphase(VRE[MU][s], VIM[MU][s], t[CO[MU][s]][a]));
  }
}

// Warp MU of the batch-1 kernel: the two hops of direction MU into acc and,
// for K1, rows 3 (MU & 1) .. + 2 of chirality MU >> 1 of the clover into z.
template <typename R, int MU, bool CLOVER>
__device__ __forceinline__ void direction(cplx<R> acc[12], cplx<R> z[3], const cplx<R>* __restrict__ p,
                                          const cplx<R>* __restrict__ links, const R* __restrict__ cdiag,
                                          const cplx<R>* __restrict__ coff, const Lattice& L, int site,
                                          const int c[4], int V) {
  int xf, xb;
  neighbors<MU>(L, site, c, xf, xb);
  if (CLOVER) {
    constexpr int CH = MU >> 1, R0 = 3 * (MU & 1);
    CloverRows<R, 3> rows;
    rows.template load<R0>(cdiag, coff, CH, site, V);
    cplx<R> x[6];
#pragma unroll
    for (int j = 0; j < 6; ++j) x[j] = p[(6 * CH + j) * V + site];
    rows.template apply<R0>(z, x);
  }
  hop_dir<R, MU, false>(acc, p, links, site, xf, xb, V);
}

// Batch-1 kernel: one block = DS_SITES sites (or x-pairs with PARITY) of one
// right-hand side (blockIdx.y), warp w = direction w; the four partial sums
// meet in shared memory, added ((mu0 + mu1) + (mu2 + mu3)), then (K1) the
// clover rows; warp w writes spin w.
template <typename R, bool CLOVER, bool PARITY>
__global__ void __launch_bounds__(DS_THREADS) dslash_kernel(cplx<R>* __restrict__ out, const cplx<R>* __restrict__ phi,
                                                            const cplx<R>* __restrict__ links,
                                                            const R* __restrict__ cdiag,
                                                            const cplx<R>* __restrict__ coff, Lattice L, int V,
                                                            int parity, int parity_offset) {
  __shared__ cplx<R> part[4][12][DS_SITES];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nslots = PARITY ? V >> 1 : V;
  const int slot = blockIdx.x * DS_SITES + lane;
  const bool valid = slot < nslots;
  int c[4], sel;
  const int site = locate<PARITY>(L, valid ? slot : 0, parity, parity_offset, c, sel);
  const cplx<R>* p = phi + (long long)blockIdx.y * 12 * V;
  cplx<R> acc[12], z[3];
  switch (w) {
    case 0: direction<R, 0, CLOVER>(acc, z, p, links, cdiag, coff, L, site, c, V); break;
    case 1: direction<R, 1, CLOVER>(acc, z, p, links, cdiag, coff, L, site, c, V); break;
    case 2: direction<R, 2, CLOVER>(acc, z, p, links, cdiag, coff, L, site, c, V); break;
    default: direction<R, 3, CLOVER>(acc, z, p, links, cdiag, coff, L, site, c, V); break;
  }
#pragma unroll
  for (int i = 0; i < 12; ++i) part[w][i][lane] = acc[i];
  __syncthreads();
  if (!valid) return;
  cplx<R>* o = out + (long long)blockIdx.y * 12 * V;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const int i = 3 * w + a;
    cplx<R> y = cadd(cadd(part[0][i][lane], part[1][i][lane]), cadd(part[2][i][lane], part[3][i][lane]));
    if (CLOVER) y = cadd(z[a], y);
    if (PARITY)
      store_pair(o + i * V, slot, sel, y);
    else
      o[i * V + site] = y;
  }
}

// Brick of the multi-right-hand-side kernel: t x z x y extents of a block of
// whole x rows (rx slots a row: X sites, or X / 2 x-pairs), MR_SLOTS slots
// in all; t = 0 where the lattice has none (then linear runs of MR_SLOTS).
struct Brick {
  int t, z, y;
};

inline Brick make_brick(const Lattice& L, int rx) {
  if (rx > MR_SLOTS || MR_SLOTS % rx) return Brick{0, 0, 0};
  int ext[3] = {1, 1, 1};    // y, z, t, doubled in turn
  const int n[3] = {L.n[2], L.n[1], L.n[0]};
  int rows = MR_SLOTS / rx;
  for (bool grew = true; rows > 1 && grew;) {
    grew = false;
    for (int i = 0; i < 3 && rows > 1; ++i)
      if (n[i] % (2 * ext[i]) == 0) {
        ext[i] *= 2;
        rows /= 2;
        grew = true;
      }
  }
  return rows > 1 ? Brick{0, 0, 0} : Brick{ext[2], ext[1], ext[0]};
}

// Multi-right-hand-side kernel: one block = a brick of MR_SLOTS sites (or
// x-pairs), one per thread; every warp walks through the right-hand sides
// in order, so the four warps of a brick gather the same field at about the
// same time and share its halo in L1 (a 2 x 2 x 2 x 16 brick at 16^4 reads
// 4 sites a site from L2 where two x rows read 6).  A thread makes all
// eight hops of its site (the reference's order: the clover, then forward
// and backward hop of T, Z, Y, X); its links and clover come from DRAM once
// and from L1 after, and no barrier separates the right-hand sides.
template <typename R, bool CLOVER, bool PARITY>
__global__ void __launch_bounds__(MR_SLOTS) dslash_mrhs_kernel(cplx<R>* __restrict__ out,
                                                              const cplx<R>* __restrict__ phi,
                                                              const cplx<R>* __restrict__ links,
                                                              const R* __restrict__ cdiag,
                                                              const cplx<R>* __restrict__ coff, Lattice L, int V,
                                                              int batch, int parity, int parity_offset, Brick B) {
  const int rx = PARITY ? L.n[3] >> 1 : L.n[3];
  int slot;
  if (B.t == 0) {
    slot = blockIdx.x * MR_SLOTS + threadIdx.x;
    if (slot >= (PARITY ? V >> 1 : V)) return;
  } else {
    const int ny = L.n[2] / B.y, nz = L.n[1] / B.z;
    const int r = threadIdx.x / rx;
    const int y = (blockIdx.x % ny) * B.y + r % B.y;
    const int z = (blockIdx.x / ny % nz) * B.z + r / B.y % B.z;
    const int t = blockIdx.x / (ny * nz) * B.t + r / (B.y * B.z);
    slot = ((t * L.n[1] + z) * L.n[2] + y) * rx + threadIdx.x % rx;
  }
  int c[4], sel, xf[4], xb[4];
  const int site = locate<PARITY>(L, slot, parity, parity_offset, c, sel);
  neighbors<0>(L, site, c, xf[0], xb[0]);
  neighbors<1>(L, site, c, xf[1], xb[1]);
  neighbors<2>(L, site, c, xf[2], xb[2]);
  neighbors<3>(L, site, c, xf[3], xb[3]);
  for (int b = 0; b < batch; ++b) {
    const cplx<R>* p = phi + (long long)b * 12 * V;
    cplx<R> acc[12];
    if (CLOVER) {
#pragma unroll
      for (int ch = 0; ch < 2; ++ch) {
        CloverRows<R, 6> C;
        C.template load<0>(cdiag, coff, ch, site, V);
        cplx<R> x[6], y[6];
#pragma unroll
        for (int j = 0; j < 6; ++j) x[j] = p[(6 * ch + j) * V + site];
        C.template apply<0>(y, x);
#pragma unroll
        for (int i = 0; i < 6; ++i) acc[6 * ch + i] = y[i];
      }
      hop_dir<R, 0, true>(acc, p, links, site, xf[0], xb[0], V);
    } else {
      hop_dir<R, 0, false>(acc, p, links, site, xf[0], xb[0], V);
    }
    hop_dir<R, 1, true>(acc, p, links, site, xf[1], xb[1], V);
    hop_dir<R, 2, true>(acc, p, links, site, xf[2], xb[2], V);
    hop_dir<R, 3, true>(acc, p, links, site, xf[3], xb[3], V);
    cplx<R>* o = out + (long long)b * 12 * V;
#pragma unroll
    for (int i = 0; i < 12; ++i) {
      if (PARITY)
        store_pair(o + i * V, slot, sel, acc[i]);
      else
        o[i * V + site] = acc[i];
    }
  }
}

// ---------------------------------------------------------------------------
// K3
// ---------------------------------------------------------------------------

// eta = C phi per site (C packed Hermitian: the clover or its inverse).
// MODE 0: all sites, one thread per site and both chiralities (65,536
// threads at 16^4 fit the card in one wave); MODE 1: the sites of `parity`
// with C stored for every site, 2: the same with C stored compact (V/2
// columns by checkerboard index), one thread per (x-pair, chirality =
// blockIdx.y), zeros at the other parity's sites.  The clover stays in
// registers across the right-hand sides.
template <typename R, int MODE>
__global__ void __launch_bounds__(CL_THREADS) clover_kernel(cplx<R>* __restrict__ out, const cplx<R>* __restrict__ phi,
                                                            const R* __restrict__ cdiag,
                                                            const cplx<R>* __restrict__ coff, Lattice L, int V,
                                                            int batch, int parity, int parity_offset) {
  constexpr int NCH = MODE ? 1 : 2;    // chiralities a thread takes
  const int nslots = MODE ? V >> 1 : V;
  const int slot = blockIdx.x * CL_THREADS + threadIdx.x;
  if (slot >= nslots) return;
  int c[4], sel;
  const int site = MODE ? locate<true>(L, slot, parity, parity_offset, c, sel) : slot;
  CloverRows<R, 6> C[NCH];
#pragma unroll
  for (int k = 0; k < NCH; ++k)
    C[k].template load<0>(cdiag, coff, blockIdx.y + k, MODE == 2 ? slot : site, MODE == 2 ? V >> 1 : V);
  for (int b = 0; b < batch; ++b) {
#pragma unroll
    for (int k = 0; k < NCH; ++k) {
      const long long base = ((long long)b * 12 + 6 * (blockIdx.y + k)) * V;
      cplx<R> x[6], y[6];
#pragma unroll
      for (int j = 0; j < 6; ++j) x[j] = phi[base + j * V + site];
      C[k].template apply<0>(y, x);
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        if (MODE)
          store_pair(out + base + i * V, slot, sel, y[i]);
        else
          out[base + i * V + site] = y[i];
      }
    }
  }
}

namespace {

inline unsigned blocks_for(long long n, int per_block) { return (unsigned)((n + per_block - 1) / per_block); }

template <typename R, bool CLOVER, bool PARITY>
void launch_dslash_t(cplx<R>* o, const cplx<R>* p, const cplx<R>* u, const R* cd, const cplx<R>* co, Lattice L,
                     int V, int batch, int parity, int parity_offset, cudaStream_t s) {
  const int slots = PARITY ? V / 2 : V;
  if (batch == 1) {
    const unsigned grid = blocks_for(slots, DS_SITES);
    dslash_kernel<R, CLOVER, PARITY><<<grid, DS_THREADS, 0, s>>>(o, p, u, cd, co, L, V, parity, parity_offset);
  } else {
    const Brick B = make_brick(L, PARITY ? L.n[3] / 2 : L.n[3]);
    const unsigned grid = blocks_for(slots, MR_SLOTS);    // a brick holds MR_SLOTS slots too
    dslash_mrhs_kernel<R, CLOVER, PARITY><<<grid, MR_SLOTS, 0, s>>>(o, p, u, cd, co, L, V, batch, parity,
                                                                    parity_offset, B);
  }
}

template <typename R>
int launch_dslash(void* out, const void* phi, const void* links, const void* cdiag, const void* coff, int t, int z,
                  int y, int x, int batch, int with_clover, int parity, int parity_offset, void* stream) {
  // x-pairs need an even x extent; K1 has no parity form (no caller reads half of D phi)
  if (parity >= 0 && (x % 2 || with_clover)) return (int)cudaErrorInvalidValue;
  Lattice L = make_lattice(t, z, y, x);
  const int V = t * z * y * x;
  auto o = (cplx<R>*)out;
  auto p = (const cplx<R>*)phi;
  auto u = (const cplx<R>*)links;
  auto cd = (const R*)cdiag;
  auto co = (const cplx<R>*)coff;
  auto s = (cudaStream_t)stream;
  if (with_clover)
    launch_dslash_t<R, true, false>(o, p, u, cd, co, L, V, batch, parity, parity_offset, s);
  else if (parity >= 0)
    launch_dslash_t<R, false, true>(o, p, u, cd, co, L, V, batch, parity, parity_offset, s);
  else
    launch_dslash_t<R, false, false>(o, p, u, cd, co, L, V, batch, parity, parity_offset, s);
  return (int)cudaGetLastError();
}

template <typename R>
int launch_clover(void* out, const void* phi, const void* cdiag, const void* coff, int t, int z, int y, int x,
                  int batch, int parity, int parity_offset, int compact, void* stream) {
  if ((parity >= 0 && x % 2) || (compact && parity < 0)) return (int)cudaErrorInvalidValue;
  Lattice L = make_lattice(t, z, y, x);
  const int V = t * z * y * x;
  const dim3 grid = parity < 0 ? dim3(blocks_for(V, CL_THREADS), 1) : dim3(blocks_for(V / 2, CL_THREADS), 2);
  auto o = (cplx<R>*)out;
  auto p = (const cplx<R>*)phi;
  auto cd = (const R*)cdiag;
  auto co = (const cplx<R>*)coff;
  auto s = (cudaStream_t)stream;
  if (parity < 0)
    clover_kernel<R, 0><<<grid, CL_THREADS, 0, s>>>(o, p, cd, co, L, V, batch, parity, parity_offset);
  else if (!compact)
    clover_kernel<R, 1><<<grid, CL_THREADS, 0, s>>>(o, p, cd, co, L, V, batch, parity, parity_offset);
  else
    clover_kernel<R, 2><<<grid, CL_THREADS, 0, s>>>(o, p, cd, co, L, V, batch, parity, parity_offset);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K1 (with_clover = 1) / K2 (with_clover = 0); parity -1 = all sites, else
// (K2 only) the sites of that parity (zeros elsewhere; x extent even),
// parity_offset = the global coordinate sum of site 0.  Returns
// cudaGetLastError().
int ddaamg_dslash_f32(void* out, const void* phi, const void* links, const void* cdiag, const void* coff, int t, int z,
                      int y, int x, int batch, int with_clover, int parity, int parity_offset, void* stream) {
  return launch_dslash<float>(out, phi, links, cdiag, coff, t, z, y, x, batch, with_clover, parity, parity_offset,
                              stream);
}

int ddaamg_dslash_f64(void* out, const void* phi, const void* links, const void* cdiag, const void* coff, int t, int z,
                      int y, int x, int batch, int with_clover, int parity, int parity_offset, void* stream) {
  return launch_dslash<double>(out, phi, links, cdiag, coff, t, z, y, x, batch, with_clover, parity, parity_offset,
                               stream);
}

// K3; parity as above; compact = 1: cdiag / coff hold the sites of that
// parity only ([2, 6, V/2] and [2, 15, V/2] by checkerboard index).
int ddaamg_clover_f32(void* out, const void* phi, const void* cdiag, const void* coff, int t, int z, int y, int x,
                      int batch, int parity, int parity_offset, int compact, void* stream) {
  return launch_clover<float>(out, phi, cdiag, coff, t, z, y, x, batch, parity, parity_offset, compact, stream);
}

int ddaamg_clover_f64(void* out, const void* phi, const void* cdiag, const void* coff, int t, int z, int y, int x,
                      int batch, int parity, int parity_offset, int compact, void* stream) {
  return launch_clover<double>(out, phi, cdiag, coff, t, z, y, x, batch, parity, parity_offset, compact, stream);
}

}  // extern "C"
