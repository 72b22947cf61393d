// Coarse-operator kernels K4 and K5 for Hopper (sm_90a), each with f32 /
// f64 blocks and with bf16 blocks (K4-bf16, K5-bf16).
//
// Replaces: ddalphaamg_tpu/operators/pallas_coarse.py::_kernel_t (K4,
// pallas_call at pallas_coarse.py:200) and ::_kernel_tz (K5, pallas_call at
// pallas_coarse.py:223), both built by _build_call and called by
// apply_packed; the bf16 instances replace the same kernels on blocks
// stored in bf16 and widened to f32 before the multiply-add
// (pallas_coarse.py:114-116 and :140-142).
//
// What they compute: the coarse stencil of d x d complex blocks (d = 2N),
//   out[b, i, x] = sum_{k in [k0, k1)} sum_j B_k[j, i, x] v[b, j, n_k(x)]
// with terms k = 0 self (A), k = 1 + mu forward hops n_k(x) = x + mu (Df_mu),
// k = 5 + mu backward hops n_k(x) = x - mu (Db_mu).  With a mask block
// (bt, bz, by, bx) > 0 the hops that cross a block face are dropped: a
// forward hop from a site on the upper mu face, a backward hop from a site
// on the lower mu face (the Schwarz block operator and intra-block hops,
// and the Galerkin aggregate-internal piece).  parity >= 0 zeroes sites of
// the other parity, counted from global coordinates: a slab of a sharded
// lattice passes the parity of its global offset (t0 + z0 + y0 + x0) & 1.
//
// K4 wraps every hop inside the lattice it is given.  K5 is the same
// contraction on one slab of a lattice sharded along any of t, z, y and x
// (the TPU kernel's "tz" layout, whose neighbor fields were fetched across
// shards by ppermute, shards t and z; the port's slabs split all four
// axes): on a sharded axis a forward hop from the slab's last slice reads
// the face received from the +mu neighbor rank, a backward hop from the
// first slice the face received from the -mu neighbor; unsharded axes wrap
// as in K4.  Faces are [batch, d, V / n_mu], sites lexicographic in the
// three other coordinates (x fastest; parallel/comm.face cuts them so):
// the face site of x is (coordinates before mu) * stride[mu] + site %
// stride[mu].
//
// Layout: fields [batch, d, V]; blocks [K, d (j), d (i), V], sites fastest,
// each entry a complex number of the field's precision or, compressed, one
// 32-bit (re, im) pair of bf16 (complex64 fields only).  The storage type is
// a template parameter of both kernels, so the instances cannot drift
// apart: a bf16 entry is widened exactly (a bf16 is the upper half of an
// f32) and the sums run in f32 in the same fixed order as with f32 blocks.
// Blocks are assumed finite: a dropped term may still meet its (finite)
// block entry times a zero field value.
//
// Two kernels behind each C entry point: the launcher picks one by batch
// and lattice size (`regime` 0), or the caller names it (1, 2).  Times
// below: device time of raw launches on an NVIDIA H100 80GB HBM3 at a
// 700 W power limit, d = 56, complex64 fields (scripts/
// probe_torch_coarse.py; the earlier one-kernel design in brackets).
//
// 1. coarse_b1_kernel, one right-hand side: bound by memory, in the blocks
//    (a full apply reads 9 d^2 entries per site once, one complex FMA
//    each: 1 flop per byte in f32).  On the coarsest level (4^4 = 256
//    sites) the danger is too few bytes in flight: one thread per site
//    with a few 8-byte loads left the card latency-bound.  So a thread
//    block is a tile of 16 sites (32 from B1_WIDE sites on, which measured
//    faster there) and its up to 8 warps split the flattened term sum
//    (k, j): lanes load 16 bytes (two complex64 sites, four bf16 sites) of
//    one (k, j, i) row, a warp covers 32 / (tile / sites per load) terms
//    at once, each thread issues the loads of two terms before it sums
//    them, and the block loops over row chunks of 4 rows with one table
//    of neighbour addresses.  At 4^4 that is 224 blocks (the earlier
//    design: 56 on 132 SMs).  Partial sums meet in a fixed order: a
//    butterfly across a warp's term slots, then the warps in order through
//    shared memory.  Full apply at 4^4: 0.027 ms f32 [0.085], 0.014 ms
//    bf16 [0.049], 63 / 61 % of the byte bound; at 8^4: 0.320 [0.326] /
//    0.171 [0.222] ms, 87 / 81 %.  The coarsest level's f32 blocks with
//    their self-inverse (64 MB) exceed the 50 MB L2, so the coarsest
//    GCR's applies stream them from device memory; in bf16 (32 MB) they
//    fit, and repeated applies can hit L2 (hit rates not measured).
// 2. coarse_mrhs_kernel, a batch (the Galerkin build, the columns of the
//    stored inverses, the sharded setups): per site a small product
//    (d x 9d) x (9d x batch), bound by operations once each block entry is
//    read for many right-hand sides.  A thread block owns 16 sites x 28
//    rows x 28 right-hand sides (f64: 8); per term k and chunk of 8 j it
//    stages the blocks B_k[j-chunk, i-chunk, tile] (plain strided rows,
//    16-byte cp.async) and the gathered field v[b-tile, j-chunk, n_k(tile)]
//    (masks and K5's faces as zero-filled or redirected copies) in a ring
//    of 3 cp.async stages.  Each thread keeps a 7 x 7 (f64: 7 x 2) register
//    tile of complex accumulators (rows x right-hand sides) of one site
//    and does an outer product per j, so each entry read from shared
//    memory feeds 7 right-hand sides and each field value 7 rows.  Products
//    stay f32 (f64) FMAs on the CUDA cores, four fused multiply-adds per
//    complex product (cmac).  Where the grid has at most half as many
//    blocks as SMs (4^4 lattices) the stages of the term sum are split over
//    the blocks of a cluster (up to 8), whose partial tiles are summed in
//    rank order through distributed shared memory (a 128-block grid, the
//    (4, 4, 8, 8) slab at batch 28, ran 10 % slower split in two).  8^4 full batch 28: 0.84 ms f32 [3.89],
//    0.80 ms bf16 [3.81], 46 / 48 % of the 67 TFLOP/s bound.
//
//    Crossover (the probe's batch sweep): the batch-1 kernel costs about
//    batch times its batch-1 time, the multi kernel about its time at 28.
//    At 8^4 the multi kernel wins from batch 6 (f32) or 8 (bf16), at 4^4
//    from about 9 (f32) or 12 (bf16), extrapolated from batches 1-8:
//    MRHS_MIN_BATCH_WIDE and MRHS_MIN_BATCH.
// 3. coarse_b1_kernel_schur (K4-schur, entry points ddaamg_schur_*): the
//    coarsest level's even-site Schur complement as kernel 1's design on
//    blocks stored by parity, two launches an apply in place of four K4
//    launches that each read every site's blocks (section 3 below).
//
// All three kernels: no atomics, sums in an order fixed by the code (two
// launches on the same inputs give identical bits; the order differs
// from the earlier design, so results differ in the last bits); ragged
// edges (V not a multiple of the tile, V not a multiple of the sites in
// 16 bytes -- then entry-sized loads and copies --, d not a multiple of
// the row chunk, a batch not a multiple of the batch tile) are masked in
// the kernel.
#include <cooperative_groups.h>

#include <algorithm>
#include <cstdint>
#include <cstring>

#include "common.cuh"

namespace cg = cooperative_groups;

// the batch-1 kernel
constexpr int B1_WIDE = 2048;           // sites from which a tile has 32 sites, not 16
constexpr int B1_WARPS = 8;             // warps per thread block, at most
constexpr int B1_ICH = 4;               // output rows per row chunk
constexpr int B1_UNROLL = 2;            // terms whose loads a thread issues together
constexpr int B1_SLOT_TERMS = 4;        // terms per term slot, at least
constexpr long long B1_THREADS = 1 << 16;  // threads of a grid, about

// the multi-right-hand-side kernel: TS sites per tile and, by field
// precision, a per-thread register tile of RI rows x RB right-hand sides,
// WR x WB warps, JC values of j per stage, S stages in the ring
constexpr int TS = 16;
template <typename R>
struct Mrhs;
template <>
struct Mrhs<float> {
  static constexpr int RI = 7, RB = 7, WR = 2, WB = 4, JC = 8, S = 3;
};
template <>
struct Mrhs<double> {
  static constexpr int RI = 7, RB = 2, WR = 2, WB = 4, JC = 8, S = 2;
};
constexpr int MAX_SPLITS = 8;  // blocks of a cluster that share one tile's term sum

// one compressed block entry: (re, im) in bf16, re in the low half
struct alignas(4) bf16x2 {
  unsigned int w;
};

// a block entry as a complex number of the field's precision
template <typename R>
__device__ __forceinline__ cplx<R> widen(cplx<R> b) {
  return b;
}

__device__ __forceinline__ cplx<float> widen(bf16x2 b) {
  return cx<float>(__uint_as_float(b.w << 16), __uint_as_float(b.w & 0xffff0000u));
}

// acc += a * b as four fused multiply-adds in this order: 4 instructions,
// where common.cuh's cfma (kept by K1-K3) compiles to a product, a fused
// multiply-add and an add for each part
template <typename R>
__device__ __forceinline__ void cmac(cplx<R>& acc, cplx<R> a, cplx<R> b) {
  acc.re = fma(a.re, b.re, acc.re);
  acc.re = fma(-a.im, b.im, acc.re);
  acc.im = fma(a.re, b.im, acc.im);
  acc.im = fma(a.im, b.re, acc.im);
}

// received faces of the sharded axes t (0), z (1), y (2), x (3); nullptr =
// unsharded
template <typename R>
struct Halo {
  const cplx<R>* fwd[4];  // v(x + mu) for the slab's last mu slice
  const cplx<R>* bwd[4];  // v(x - mu) for the slab's first mu slice
};

// the received face of axis mu (fwd: v(x + mu), else v(x - mu)) or nullptr;
// the unrolled selection keeps the kernel parameter h out of the stack,
// where an index known only at run time would copy it
template <typename R>
__device__ __forceinline__ const cplx<R>* halo_face(const Halo<R>& h, int mu, bool fwd) {
  const cplx<R>* f = nullptr;
#pragma unroll
  for (int m = 0; m < 4; ++m)
    if (m == mu) f = fwd ? h.fwd[m] : h.bwd[m];
  return f;
}

// where term k reads the field for one site: p -> entry (b, j = 0), ld =
// the stride of j; p = nullptr where the term is dropped (masked hop, site
// of the other parity, site outside the lattice)
template <typename R>
struct Src {
  const cplx<R>* p;
  int ld;
};

__device__ __forceinline__ bool dead_site(const Lattice& L, int site, int parity, int parity_offset) {
  if (parity < 0) return false;
  int c[4];
  site_coords(L, site, c);
  return ((c[0] + c[1] + c[2] + c[3] + parity_offset) & 1) != parity;
}

template <typename R, bool HALO>
__device__ Src<R> term_source(const cplx<R>* v, const Halo<R>& h, const Lattice& L, int V, int d, int b, int site,
                              int k, int4 mblk, int parity, int parity_offset) {
  Src<R> s;
  s.p = nullptr;
  s.ld = V;
  if (site >= V || dead_site(L, site, parity, parity_offset)) return s;
  if (k == 0) {
    s.p = v + (long long)b * d * V + site;
    return s;
  }
  int c[4];
  site_coords(L, site, c);
  const int mu = (k - 1) & 3;
  const bool fwd = k < 5;
  const int mb = mu == 0 ? mblk.x : mu == 1 ? mblk.y : mu == 2 ? mblk.z : mblk.w;
  if (mb > 0) {
    const int r = c[mu] % mb;
    if (fwd ? (r == mb - 1) : (r == 0)) return s;
  }
  if (HALO) {
    const cplx<R>* face = halo_face(h, mu, fwd);
    if (face != nullptr && c[mu] == (fwd ? L.n[mu] - 1 : 0)) {
      const int fv = V / L.n[mu];
      // the site without its mu coordinate: the coordinates before mu, then
      // those after it (the lexicographic order of parallel/comm.face)
      const int nb = site / (L.stride[mu] * L.n[mu]) * L.stride[mu] + site % L.stride[mu];
      s.p = face + (long long)b * d * fv + nb;
      s.ld = fv;
      return s;
    }
  }
  s.p = v + (long long)b * d * V + site_step(L, site, c, mu, fwd ? +1 : -1);
  return s;
}

// N bytes of block storage loaded by one instruction
template <int N>
struct Raw;
template <>
struct Raw<4> {
  using T = unsigned int;
};
template <>
struct Raw<8> {
  using T = uint2;
};
template <>
struct Raw<16> {
  using T = uint4;
};

template <typename B, typename T>
__device__ __forceinline__ B entry(const T& raw, int e) {
  B x;
  memcpy(&x, reinterpret_cast<const char*>(&raw) + e * sizeof(B), sizeof(B));
  return x;
}

// ---------------------------------------------------------------------------
// 1. one right-hand side per thread block
//
// Block x = (tile * gy + y) * batch + b (the batch fastest, so the blocks
// of one tile run together and share its block entries through L2): site
// tile `tile` of right-hand side b, row chunks y, y + gy, ... of B1_ICH
// rows.  Thread (lane, warp): p = lane % PL picks SV consecutive sites of
// the tile (one load of SV entries), g = lane / PL and the warp pick the
// term slot q; slot q sums the terms t = q, q + Q, ... of the flattened
// (k, j) range, Q = G * blockDim.y.

// warps of a batch-1 thread block for nt terms: 8, fewer where a term slot
// would get fewer than B1_SLOT_TERMS terms (G slots a warp)
inline int b1_warps(int nt, int G) {
  int nw = B1_WARPS;
  while (nw > 1 && nt < B1_SLOT_TERMS * G * nw) nw /= 2;
  return nw;
}

template <typename R, bool HALO, typename B, int SV, int TS1>
__global__ void __launch_bounds__(32 * B1_WARPS)
    coarse_b1_kernel(cplx<R>* __restrict__ out, const cplx<R>* __restrict__ v, const B* __restrict__ blocks,
                     Halo<R> h, Lattice L, int V, int d, int k0, int k1, int4 mblk, int parity, int parity_offset,
                     int batch, int gy) {
  constexpr int PL = TS1 / SV;  // lanes along the tile's sites
  constexpr int G = 32 / PL;   // term slots per warp
  using T = typename Raw<sizeof(B) * SV>::T;
  __shared__ Src<R> tab[9 * TS1];
  __shared__ cplx<R> part[B1_WARPS][B1_ICH][TS1];
  const int b = blockIdx.x % batch, r = blockIdx.x / batch;
  const int site0 = (r / gy) * TS1;
  const int nk = k1 - k0, nw = blockDim.y, nthr = 32 * nw, tid = threadIdx.y * 32 + threadIdx.x;
  for (int e = tid; e < nk * TS1; e += nthr)
    tab[e] = term_source<R, HALO>(v, h, L, V, d, b, site0 + e % TS1, k0 + e / TS1, mblk, parity, parity_offset);
  __syncthreads();

  const int lane = threadIdx.x, w = threadIdx.y;
  const int p = lane % PL, g = lane / PL, s0 = p * SV, Q = G * nw;
  const int nt = nk * d;
  const bool dead = site0 + tid % TS1 < V && dead_site(L, site0 + tid % TS1, parity, parity_offset);
  for (int i0 = (r % gy) * B1_ICH; i0 < d; i0 += gy * B1_ICH) {
    cplx<R> acc[B1_ICH][SV];
#pragma unroll
    for (int ii = 0; ii < B1_ICH; ++ii)
#pragma unroll
      for (int e = 0; e < SV; ++e) acc[ii][e] = cx<R>(0, 0);
    const int nrow = min(B1_ICH, d - i0);
    // term t = kk * d + j starts at row (t * d + i0) * V of blocks[k0]
    const B* base = blocks + ((long long)k0 * d * d + i0) * V + site0 + s0;
    for (int t0 = w * G + g; t0 < nt; t0 += B1_UNROLL * Q) {
      T raw[B1_UNROLL][B1_ICH];
      cplx<R> vj[B1_UNROLL][SV];
#pragma unroll
      for (int u = 0; u < B1_UNROLL; ++u) {
        const int t = t0 + u * Q;
        const int kk = t / d, j = t - kk * d;
        bool any = false;
#pragma unroll
        for (int e = 0; e < SV; ++e) {
          vj[u][e] = cx<R>(0, 0);
          if (t < nt) {
            const Src<R> s = tab[kk * TS1 + s0 + e];
            if (s.p != nullptr) {
              vj[u][e] = s.p[(long long)j * s.ld];
              any = true;
            }
          }
        }
        const T* row = reinterpret_cast<const T*>(base + (long long)t * d * V);
#pragma unroll
        for (int ii = 0; ii < B1_ICH; ++ii) {
          raw[u][ii] = T{};
          if (any && ii < nrow) raw[u][ii] = __ldg(row + (long long)ii * V / SV);
        }
      }
#pragma unroll
      for (int u = 0; u < B1_UNROLL; ++u)
#pragma unroll
        for (int ii = 0; ii < B1_ICH; ++ii)
#pragma unroll
          for (int e = 0; e < SV; ++e) cmac(acc[ii][e], widen(entry<B>(raw[u][ii], e)), vj[u][e]);
    }

    // lanes of one site vector and different slots: a fixed butterfly
#pragma unroll
    for (int off = PL; off < 32; off <<= 1)
#pragma unroll
      for (int ii = 0; ii < B1_ICH; ++ii)
#pragma unroll
        for (int e = 0; e < SV; ++e) {
          acc[ii][e].re += __shfl_xor_sync(0xffffffffu, acc[ii][e].re, off);
          acc[ii][e].im += __shfl_xor_sync(0xffffffffu, acc[ii][e].im, off);
        }
    if (g == 0)
#pragma unroll
      for (int ii = 0; ii < B1_ICH; ++ii)
#pragma unroll
        for (int e = 0; e < SV; ++e) part[w][ii][s0 + e] = acc[ii][e];
    __syncthreads();
    // then the warps in order (o % TS1 = tid % TS1: nthr is a multiple of TS1)
    for (int o = tid; o < B1_ICH * TS1; o += nthr) {
      const int ii = o / TS1, s = o % TS1, i = i0 + ii, site = site0 + s;
      if (i < d && site < V) {
        cplx<R> sum = part[0][ii][s];
        for (int q = 1; q < nw; ++q) sum = cadd(sum, part[q][ii][s]);
        out[((long long)b * d + i) * V + site] = dead ? cx<R>(0, 0) : sum;
      }
    }
    __syncthreads();  // part is rewritten by the next row chunk
  }
}

// ---------------------------------------------------------------------------
// 2. a tile of right-hand sides per thread block

// cp.async of N bytes (4, 8 or 16); a copy that is not `valid` zero-fills
template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool valid) {
  const unsigned int s = (unsigned int)__cvta_generic_to_shared(dst);
  const int n = valid ? N : 0;
  if constexpr (N == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s), "l"(src), "n"(N), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <typename R, typename B>
constexpr size_t mrhs_smem() {
  using C = Mrhs<R>;
  constexpr int IC = 2 * C::WR * C::RI, BT = C::WB * C::RB;
  return 9 * TS * sizeof(Src<R>) +
         C::S * ((size_t)C::JC * IC * TS * sizeof(B) + (size_t)BT * C::JC * TS * sizeof(cplx<R>));
}

// Block x = ((tile * nic + ic) * nbt + bt) * splits + split.  Lane l of warp
// w: site l % 16, rows ((w % WR) * 2 + l / 16) * RI + [0, RI), right-hand
// sides (w / WR) * RB + [0, RB).  VEC: blocks copied 16 bytes at a time
// (V a multiple of the entries in 16 bytes), else one entry at a time.
template <typename R, bool HALO, typename B, bool VEC>
__global__ void __launch_bounds__(32 * Mrhs<R>::WR * Mrhs<R>::WB, 1)
    coarse_mrhs_kernel(cplx<R>* __restrict__ out, const cplx<R>* __restrict__ v, const B* __restrict__ blocks,
                       Halo<R> h, Lattice L, int V, int d, int k0, int k1, int4 mblk, int parity,
                       int parity_offset, int batch, int splits) {
  using C = Mrhs<R>;
  constexpr int RI = C::RI, RB = C::RB, JC = C::JC, S = C::S;
  constexpr int IC = 2 * C::WR * RI, BT = C::WB * RB, NT = 32 * C::WR * C::WB;
  constexpr int BST = JC * IC * TS, VST = BT * JC * TS;  // entries of one stage
  constexpr int VPASS = NT / (JC * TS);                  // right-hand sides per gather pass
  static_assert(NT % (JC * TS) == 0, "the field gather covers whole (j, site) planes");
  static_assert((size_t)IC * BT * TS * sizeof(cplx<R>) <= (size_t)S * (BST * sizeof(B) + VST * sizeof(cplx<R>)),
                "the cluster reduction reuses the ring");
  extern __shared__ __align__(16) unsigned char smem[];
  Src<R>* tab = reinterpret_cast<Src<R>*>(smem);
  B* Bs = reinterpret_cast<B*>(smem + 9 * TS * sizeof(Src<R>));
  cplx<R>* Vs = reinterpret_cast<cplx<R>*>(Bs + S * BST);

  const int tid = threadIdx.x;
  const int nbt = (batch + BT - 1) / BT, nic = (d + IC - 1) / IC;
  int x = blockIdx.x;
  const int split = x % splits;
  x /= splits;
  const int b0 = (x % nbt) * BT;
  x /= nbt;
  const int i0 = (x % nic) * IC, site0 = (x / nic) * TS;
  const int nk = k1 - k0, nJ = (d + JC - 1) / JC, total = nk * nJ;
  const int st0 = (int)((long long)total * split / splits), st1 = (int)((long long)total * (split + 1) / splits);
  for (int e = tid; e < nk * TS; e += NT)
    tab[e] = term_source<R, HALO>(v, h, L, V, d, 0, site0 + e % TS, k0 + e / TS, mblk, parity, parity_offset);
  __syncthreads();

  // stage it -> slot (it - st0) % S: blocks[k][j0 + jj][i0 + ii][tile] and
  // v[b0 + bb][j0 + jj][n_k(tile)], zero outside the operands
  auto issue = [&](int it) {
    const int slot = (it - st0) % S;
    const int kk = it / nJ, j0 = (it - kk * nJ) * JC;
    B* bs = Bs + slot * BST;
    const B* bk = blocks + (long long)(k0 + kk) * d * d * V + site0;
    if constexpr (VEC) {
      constexpr int EPC = 16 / sizeof(B), CPR = TS / EPC;  // entries per copy, copies per row
      for (int c = tid; c < JC * IC * CPR; c += NT) {
        const int row = c / CPR, cc = c - row * CPR, jj = row / IC, ii = row - jj * IC;
        const bool ok = j0 + jj < d && i0 + ii < d && site0 + cc * EPC < V;
        const B* src = bk + ((long long)(j0 + jj) * d + i0 + ii) * V + cc * EPC;
        cp_async<16>(bs + row * TS + cc * EPC, ok ? src : blocks, ok);
      }
    } else {
      for (int c = tid; c < JC * IC * TS; c += NT) {
        const int row = c / TS, s = c - row * TS, jj = row / IC, ii = row - jj * IC;
        const bool ok = j0 + jj < d && i0 + ii < d && site0 + s < V;
        const B* src = bk + ((long long)(j0 + jj) * d + i0 + ii) * V + s;
        cp_async<sizeof(B)>(bs + c, ok ? src : blocks, ok);
      }
    }
    // each thread gathers one (j, site) of every VPASS-th right-hand side
    const int s = tid % TS, jj = (tid / TS) % JC;
    const Src<R> src = tab[kk * TS + s];
    const bool okj = src.p != nullptr && j0 + jj < d;
    const long long step = (long long)VPASS * d * src.ld;
    const cplx<R>* g = okj ? src.p + ((long long)(b0 + tid / (TS * JC)) * d + j0 + jj) * src.ld : v;
    cplx<R>* dst = Vs + slot * VST + jj * TS + s;
    for (int bb = tid / (TS * JC); bb < BT; bb += VPASS, g += okj ? step : 0) {
      const bool ok = okj && b0 + bb < batch;
      cp_async<sizeof(cplx<R>)>(dst + bb * JC * TS, ok ? g : v, ok);
    }
  };

  for (int st = 0; st < S - 1; ++st) {
    if (st0 + st < st1) issue(st0 + st);
    cp_async_commit();
  }
  const int lane = tid & 31, w = tid >> 5, s = lane & 15;
  const int rowbase = ((w % C::WR) * 2 + (lane >> 4)) * RI, rhsbase = (w / C::WR) * RB;
  cplx<R> acc[RI][RB];
#pragma unroll
  for (int r = 0; r < RI; ++r)
#pragma unroll
    for (int c = 0; c < RB; ++c) acc[r][c] = cx<R>(0, 0);
  for (int it = st0; it < st1; ++it) {
    cp_async_wait<S - 2>();
    __syncthreads();  // stage it has landed; slot (it - 1) is free
    if (it + S - 1 < st1) issue(it + S - 1);
    cp_async_commit();
    const int slot = (it - st0) % S;
    const B* bs = Bs + slot * BST + rowbase * TS + s;
    const cplx<R>* vs = Vs + slot * VST + rhsbase * JC * TS + s;
#pragma unroll
    for (int jj = 0; jj < JC; ++jj) {
      cplx<R> bv[RI], vv[RB];
#pragma unroll
      for (int r = 0; r < RI; ++r) bv[r] = widen(bs[(jj * IC + r) * TS]);
#pragma unroll
      for (int c = 0; c < RB; ++c) vv[c] = vs[(c * JC + jj) * TS];
#pragma unroll
      for (int r = 0; r < RI; ++r)
#pragma unroll
        for (int c = 0; c < RB; ++c) cmac(acc[r][c], bv[r], vv[c]);
    }
  }

  const int site = site0 + s;
  if (splits == 1) {
    if (site >= V) return;
    const bool dead = dead_site(L, site, parity, parity_offset);
#pragma unroll
    for (int r = 0; r < RI; ++r)
#pragma unroll
      for (int c = 0; c < RB; ++c) {
        const int i = i0 + rowbase + r, b = b0 + rhsbase + c;
        if (i < d && b < batch) out[((long long)b * d + i) * V + site] = dead ? cx<R>(0, 0) : acc[r][c];
      }
    return;
  }
  // the blocks of a cluster hold partial sums of one tile: each writes its
  // tile into its ring, and block `split` sums a 1 / splits share of the
  // tile over the cluster's blocks in rank order
  cp_async_wait<0>();
  __syncthreads();
  cplx<R>* red = reinterpret_cast<cplx<R>*>(Bs);  // [IC][BT][TS]
#pragma unroll
  for (int r = 0; r < RI; ++r)
#pragma unroll
    for (int c = 0; c < RB; ++c) red[((rowbase + r) * BT + rhsbase + c) * TS + s] = acc[r][c];
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  constexpr int N = IC * BT * TS;
  const int per = (N + splits - 1) / splits, e1 = min(N, (split + 1) * per);
  for (int e = split * per + tid; e < e1; e += NT) {
    const int ii = e / (BT * TS), bb = (e / TS) % BT, ss = e % TS;
    const int i = i0 + ii, b = b0 + bb, st = site0 + ss;
    if (i >= d || b >= batch || st >= V) continue;
    cplx<R> sum = *cluster.map_shared_rank(red + e, 0);
    for (int r = 1; r < splits; ++r) sum = cadd(sum, *cluster.map_shared_rank(red + e, r));
    out[((long long)b * d + i) * V + st] = dead_site(L, st, parity, parity_offset) ? cx<R>(0, 0) : sum;
  }
  cluster.sync();  // no block leaves while another still reads its ring
}

// ---------------------------------------------------------------------------
// 3. K4-schur: the coarsest level's Schur complement on parity-split blocks
//
//   out_e = A_ee v_e - sum_k hop_k t_o,  t_o = A_oo^-1 sum_k hop_k v_e,  out_o = 0
//
// (the four-launch schur of operators/stencil.py in two launches).  The
// blocks are stored by parity: E [9, d, d, V/2] holds the even sites' self
// block and hops, O [9, d, d, V/2] the odd sites' self-block inverse (slot
// 0) and hops, each half's sites by checkerboard index site >> 1 (every
// extent even: the x-pair (2h, 2h + 1) holds one site of each parity), so
// every 16-byte load holds sites of the parity the launch computes and each
// block row is read once an apply.  Fields stay [batch, d, V]; t_o is
// compact [batch, d, V/2].  Both launches are the batch-1 design above
// (tile, term slots, 16-byte loads, fixed-order sums) with the slots and
// warps the four launches had (b1_warps of 8 d terms for a hop sum, of d
// for a self term), so each sum meets its terms in the same order and the
// result is bit-equal to the four launches'.
//
// Launch 1 (odd tiles): a cluster of gy blocks a tile, each block SCHUR_NH
// groups of nw warps that sum the hops of one row chunk each into shared
// memory; the cluster exchanges the rows (distributed shared memory), and
// each block applies A_oo^-1 to its row chunks with groups of nws warps,
// one chunk a group.  Launch 2 (even tiles): per round of up to nw / nws
// row chunks, the self terms by groups, then each chunk's hops by the
// whole block, and out = self - hops; the odd site of each pair gets an
// exact zero.  At 8^4, d = 56, bf16, batch 1: launch 1 0.1004 ms, launch 2
// 0.0932 ms, 69 / 74 % of their byte bounds; the four launches 0.358 ms.

// Kernel 1's term loop and butterfly for kernel 3: term slot q of Q (its
// warp's index among the nw warps that share the sum, times G, plus g) sums
// rows [i0, i0 + nrow) of its SV sites over the terms t = q, q + Q, ... of
// the flattened (kk, j) range [0, nk d): term t reads the block row base +
// (t d + ii) ld (base: the first term's row i0 at the thread's sites) and
// the field through tab[kk * TS1 + s0 + e]; the slots of a warp are then
// summed by a fixed butterfly, and lane g = 0 writes the warp's sums to
// part[w].  Kernel 1 keeps its own copy: calling this from it changed its
// code and made the 16^4 block-masked apply 2.8 % slower (2.1219 against
// 2.0636 ms, bf16, batch 1, H100 80GB HBM3 at 700 W).
template <typename R, typename B, int SV, int TS1>
__device__ __forceinline__ void b1_slot_sums(cplx<R> (*part)[B1_ICH][TS1], const B* base, long long ld,
                                             const Src<R>* tab, int nk, int d, int nrow, int w, int q, int Q) {
  constexpr int PL = TS1 / SV;
  using T = typename Raw<sizeof(B) * SV>::T;
  const int lane = threadIdx.x, s0 = (lane % PL) * SV, nt = nk * d;
  cplx<R> acc[B1_ICH][SV];
#pragma unroll
  for (int ii = 0; ii < B1_ICH; ++ii)
#pragma unroll
    for (int e = 0; e < SV; ++e) acc[ii][e] = cx<R>(0, 0);
  for (int t0 = q; t0 < nt; t0 += B1_UNROLL * Q) {
    T raw[B1_UNROLL][B1_ICH];
    cplx<R> vj[B1_UNROLL][SV];
#pragma unroll
    for (int u = 0; u < B1_UNROLL; ++u) {
      const int t = t0 + u * Q;
      const int kk = t / d, j = t - kk * d;
      bool any = false;
#pragma unroll
      for (int e = 0; e < SV; ++e) {
        vj[u][e] = cx<R>(0, 0);
        if (t < nt) {
          const Src<R> s = tab[kk * TS1 + s0 + e];
          if (s.p != nullptr) {
            vj[u][e] = s.p[(long long)j * s.ld];
            any = true;
          }
        }
      }
      const T* row = reinterpret_cast<const T*>(base + (long long)t * d * ld);
#pragma unroll
      for (int ii = 0; ii < B1_ICH; ++ii) {
        raw[u][ii] = T{};
        if (any && ii < nrow) raw[u][ii] = __ldg(row + (long long)ii * ld / SV);
      }
    }
#pragma unroll
    for (int u = 0; u < B1_UNROLL; ++u)
#pragma unroll
      for (int ii = 0; ii < B1_ICH; ++ii)
#pragma unroll
        for (int e = 0; e < SV; ++e) cmac(acc[ii][e], widen(entry<B>(raw[u][ii], e)), vj[u][e]);
  }

  // lanes of one site vector and different slots: a fixed butterfly
#pragma unroll
  for (int off = PL; off < 32; off <<= 1)
#pragma unroll
    for (int ii = 0; ii < B1_ICH; ++ii)
#pragma unroll
      for (int e = 0; e < SV; ++e) {
        acc[ii][e].re += __shfl_xor_sync(0xffffffffu, acc[ii][e].re, off);
        acc[ii][e].im += __shfl_xor_sync(0xffffffffu, acc[ii][e].im, off);
      }
  if (lane / PL == 0)
#pragma unroll
    for (int ii = 0; ii < B1_ICH; ++ii)
#pragma unroll
      for (int e = 0; e < SV; ++e) part[w][ii][s0 + e] = acc[ii][e];
}

// the sums of the warps [w0, w0 + nw) for row ii, site s, in warp order
template <typename R, int TS1>
__device__ __forceinline__ cplx<R> b1_warp_sum(cplx<R> (*part)[B1_ICH][TS1], int w0, int nw, int ii, int s) {
  cplx<R> sum = part[w0][ii][s];
  for (int q = 1; q < nw; ++q) sum = cadd(sum, part[w0 + q][ii][s]);
  return sum;
}

// the site of parity par in the x-pair of checkerboard index hs
__device__ __forceinline__ int parity_site(const Lattice& L, int hs, int par) {
  int c[4];
  site_coords(L, 2 * hs, c);
  return 2 * hs + (((c[0] + c[1] + c[2]) & 1) ^ par);
}

constexpr int SCHUR_SMEM_MAX = 160 * 1024;  // dynamic shared memory of launch 1, at most
constexpr int SCHUR_NH = 2;  // row-chunk groups a block of launch 1 works on at once

template <typename R, typename B, int SV, int TS1, bool ODD>
__global__ void __launch_bounds__(32 * B1_WARPS * (ODD ? SCHUR_NH : 1))
    coarse_b1_kernel_schur(cplx<R>* __restrict__ out, cplx<R>* __restrict__ t, const cplx<R>* __restrict__ v,
                           const B* __restrict__ blocks, Lattice L, int V, int d, int batch, int gy, int nw,
                           int nws) {
  constexpr int G = 32 / (TS1 / SV), NH = ODD ? SCHUR_NH : 1;
  extern __shared__ __align__(16) unsigned char hs_raw[];  // launch 1: the hop sums [d][TS1]
  cplx<R>* hs = reinterpret_cast<cplx<R>*>(hs_raw);
  __shared__ Src<R> tab[9 * TS1];
  __shared__ cplx<R> part[NH * B1_WARPS][B1_ICH][TS1];
  const int Vh = V / 2, nic = (d + B1_ICH - 1) / B1_ICH;
  const int nthr = 32 * blockDim.y, tid = threadIdx.y * 32 + threadIdx.x;
  int b, y, site0;
  if constexpr (ODD) {  // x = (tile * batch + b) * gy + y: a cluster per (tile, b)
    y = blockIdx.x % gy;
    b = (blockIdx.x / gy) % batch;
    site0 = (blockIdx.x / gy / batch) * TS1;
  } else {  // x = (tile * gy + y) * batch + b, as kernel 1
    b = blockIdx.x % batch;
    y = (blockIdx.x / batch) % gy;
    site0 = (blockIdx.x / batch / gy) * TS1;
  }
  // hops: tab[kk * TS1 + s], kk = 0..7 (term 1 + kk); launch 2 also the
  // self term at tab[8 * TS1 + s]
  for (int e = tid; e < (ODD ? 8 : 9) * TS1; e += nthr) {
    const int s = e % TS1, kk = e / TS1;
    Src<R> src;
    src.p = nullptr;
    src.ld = V;
    if (site0 + s < Vh) {
      const int site = parity_site(L, site0 + s, ODD ? 1 : 0);
      if (kk == 8) {
        src.p = v + (long long)b * d * V + site;
      } else {
        int c[4];
        site_coords(L, site, c);
        const int nb = site_step(L, site, c, kk & 3, kk < 4 ? +1 : -1);
        if (ODD) {
          src.p = v + (long long)b * d * V + nb;
        } else {
          src.p = t + (long long)b * d * Vh + (nb >> 1);
          src.ld = Vh;
        }
      }
    }
    tab[e] = src;
  }
  __syncthreads();

  // the block's row chunks: c(m) = y NH + m % NH + (m / NH) gy NH, m = 0, 1,
  // ... (row-chunk group y NH + h of gy NH is the block's part h), mc of them
  const int gyn = gy * NH;
  auto chunk = [&](int m) { return y * NH + m % NH + (m / NH) * gyn; };
  const int w = threadIdx.y, g = threadIdx.x / (TS1 / SV), s0 = (threadIdx.x % (TS1 / SV)) * SV;
  const int ng = NH * nw / nws, wg = w / nws;  // groups of nws warps for a self term
  const long long hop0 = (long long)d * d * Vh + site0 + s0;  // term 1, row 0 at the thread's sites
  // the hops of row chunk c by part w / nw of the block into part (c >= nic: none)
  auto hops = [&](int c) {
    if (c < nic)
      b1_slot_sums<R, B, SV, TS1>(part, blocks + hop0 + (long long)c * B1_ICH * Vh, Vh, tab, 8, d,
                                  min(B1_ICH, d - c * B1_ICH), w, (w % nw) * G + g, G * nw);
  };
  // the self term of row chunk c by this thread's group into part (c >= nic: none)
  auto self = [&](int c, const Src<R>* stab) {
    if (c < nic)
      b1_slot_sums<R, B, SV, TS1>(part, blocks + (long long)c * B1_ICH * Vh + site0 + s0, Vh, stab, 1, d,
                                  min(B1_ICH, d - c * B1_ICH), w, (w % nws) * G + g, G * nws);
  };

  if constexpr (ODD) {
    for (int m0 = 0; chunk(m0) < nic; m0 += NH) {
      hops(chunk(m0 + w / nw));
      __syncthreads();
      for (int o = tid; o < NH * B1_ICH * TS1; o += nthr) {
        const int h = o / (B1_ICH * TS1), ii = (o / TS1) % B1_ICH, s = o % TS1, i = chunk(m0 + h) * B1_ICH + ii;
        if (i < d) hs[i * TS1 + s] = b1_warp_sum<R, TS1>(part, h * nw, nw, ii, s);
      }
      __syncthreads();
    }
    // the rows of the cluster's other blocks, then A_oo^-1 from the tab of
    // the tile's hop sums
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    for (int e = tid; e < d * TS1; e += nthr) {
      const int owner = (e / TS1 / B1_ICH) % gyn / NH;
      if (owner != y) hs[e] = *cluster.map_shared_rank(hs + e, owner);
    }
    for (int s = tid; s < TS1; s += nthr) {
      tab[s].p = site0 + s < Vh ? hs + s : nullptr;
      tab[s].ld = TS1;
    }
    cluster.sync();  // every copy is done before a block leaves
    for (int m0 = 0; chunk(m0) < nic; m0 += ng) {
      self(chunk(m0 + wg), tab);
      __syncthreads();
      for (int o = tid; o < ng * B1_ICH * TS1; o += nthr) {
        const int og = o / (B1_ICH * TS1), ii = (o / TS1) % B1_ICH, s = o % TS1;
        const int i = chunk(m0 + og) * B1_ICH + ii;
        if (i < d && site0 + s < Vh)
          t[((long long)b * d + i) * Vh + site0 + s] = b1_warp_sum<R, TS1>(part, og * nws, nws, ii, s);
      }
      __syncthreads();
    }
  } else {
    __shared__ cplx<R> own[B1_WARPS][B1_ICH][TS1];  // the self terms of a round's chunks
    for (int m0 = 0; chunk(m0) < nic; m0 += ng) {
      self(chunk(m0 + wg), tab + 8 * TS1);
      __syncthreads();
      for (int o = tid; o < ng * B1_ICH * TS1; o += nthr) {
        const int og = o / (B1_ICH * TS1), ii = (o / TS1) % B1_ICH, s = o % TS1;
        own[og][ii][s] = b1_warp_sum<R, TS1>(part, og * nws, nws, ii, s);
      }
      __syncthreads();
      for (int og = 0; og < ng && chunk(m0 + og) < nic; ++og) {
        const int c = chunk(m0 + og);
        hops(c);
        __syncthreads();
        for (int o = tid; o < B1_ICH * TS1; o += nthr) {
          const int ii = o / TS1, s = o % TS1, i = c * B1_ICH + ii;
          if (i < d && site0 + s < Vh) {
            const int site = parity_site(L, site0 + s, 0);
            const cplx<R> sum = csub(own[og][ii][s], b1_warp_sum<R, TS1>(part, 0, nw, ii, s));
            cplx<R>* row = out + ((long long)b * d + i) * V;
            row[site] = sum;
            row[site ^ 1] = cx<R>(0, 0);
          }
        }
        __syncthreads();
      }
    }
  }
}

namespace {

// tile: 16 sites, 32 from B1_WIDE sites on; warps: 8, fewer where a term
// slot would get fewer than B1_SLOT_TERMS terms; row-chunk groups gy: as
// many as keep the grid near B1_THREADS threads (each block loops over
// nic / gy row chunks with one table)
template <typename R, bool HALO, typename B, int SV, int TS1>
int launch_b1_tiles(void* out, const void* v, const void* blocks, Halo<R> h, Lattice L, int V, int d, int k0,
                    int k1, int4 mb, int parity, int parity_offset, int batch, cudaStream_t stream) {
  constexpr int G = 32 / (TS1 / SV);
  const int nt = (k1 - k0) * d, nic = (d + B1_ICH - 1) / B1_ICH;
  const int nw = b1_warps(nt, G);
  const long long per_group = (long long)((V + TS1 - 1) / TS1) * batch * 32 * nw;
  const int gy = (int)std::max(1LL, std::min((long long)nic, B1_THREADS / per_group));
  const long long blocks_x = per_group / (32 * nw) * gy;
  coarse_b1_kernel<R, HALO, B, SV, TS1><<<dim3((unsigned)blocks_x), dim3(32, nw), 0, stream>>>(
      (cplx<R>*)out, (const cplx<R>*)v, (const B*)blocks, h, L, V, d, k0, k1, mb, parity, parity_offset, batch,
      gy);
  return (int)cudaGetLastError();
}

template <typename R, bool HALO, typename B, int SV>
int launch_b1(void* out, const void* v, const void* blocks, Halo<R> h, Lattice L, int V, int d, int k0, int k1,
              int4 mb, int parity, int parity_offset, int batch, cudaStream_t stream) {
  return V >= B1_WIDE ? launch_b1_tiles<R, HALO, B, SV, 32>(out, v, blocks, h, L, V, d, k0, k1, mb, parity,
                                                            parity_offset, batch, stream)
                      : launch_b1_tiles<R, HALO, B, SV, 16>(out, v, blocks, h, L, V, d, k0, k1, mb, parity,
                                                            parity_offset, batch, stream);
}

template <typename R, bool HALO, typename B, bool VEC>
int launch_mrhs(void* out, const void* v, const void* blocks, Halo<R> h, Lattice L, int V, int d, int k0, int k1,
                int4 mb, int parity, int parity_offset, int batch, cudaStream_t stream) {
  using C = Mrhs<R>;
  constexpr int IC = 2 * C::WR * C::RI, BT = C::WB * C::RB, NT = 32 * C::WR * C::WB;
  constexpr size_t smem = mrhs_smem<R, B>();
  auto kernel = coarse_mrhs_kernel<R, HALO, B, VEC>;
  static bool ready = false;  // once per instance: shared memory above 48 KB
  if (!ready) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    ready = true;
  }
  const long long tiles = (long long)((V + TS - 1) / TS) * ((d + IC - 1) / IC) * ((batch + BT - 1) / BT);
  const int stages = (k1 - k0) * ((d + C::JC - 1) / C::JC);
  // on a grid of at most half as many blocks as SMs (4^4 lattices), split
  // the term sum over a cluster while the grid has fewer blocks than SMs
  int splits = 1;
  if (tiles * 2 <= num_sms())
    while (splits < MAX_SPLITS && tiles * splits < num_sms() && stages >= 2 * splits * C::S) splits *= 2;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(tiles * splits));
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, kernel, (cplx<R>*)out, (const cplx<R>*)v, (const B*)blocks, h, L, V, d, k0,
                                 k1, mb, parity, parity_offset, batch, splits);
}

// the smallest batch for which the multi-right-hand-side kernel is used,
// on lattices of B1_WIDE sites or more and below (the batch-1 kernel costs
// about batch times its batch-1 time, the multi kernel about its time at 28)
constexpr int MRHS_MIN_BATCH_WIDE = 6, MRHS_MIN_BATCH = 12;

// regime: 0 = by batch, 1 = the batch-1 kernel, 2 = the multi-right-hand-side kernel
template <typename R, bool HALO, typename B>
int launch_coarse(void* out, const void* v, const void* blocks, Halo<R> h, int d, int k0, int k1, int t, int z,
                  int y, int x, int bt, int bz, int by, int bx, int parity, int parity_offset, int batch,
                  int regime, void* stream) {
  Lattice L = make_lattice(t, z, y, x);
  const int V = t * z * y * x;
  const int4 mb = make_int4(bt, bz, by, bx);
  cudaStream_t st = (cudaStream_t)stream;
  constexpr int SV = 16 / sizeof(B);  // entries in 16 bytes
  const bool vec = V % SV == 0 && (uintptr_t)blocks % 16 == 0;
  if (regime == 0) regime = batch >= (V >= B1_WIDE ? MRHS_MIN_BATCH_WIDE : MRHS_MIN_BATCH) ? 2 : 1;
  if (regime == 2)
    return vec ? launch_mrhs<R, HALO, B, true>(out, v, blocks, h, L, V, d, k0, k1, mb, parity, parity_offset,
                                               batch, st)
               : launch_mrhs<R, HALO, B, false>(out, v, blocks, h, L, V, d, k0, k1, mb, parity, parity_offset,
                                                batch, st);
  if (regime != 1) return (int)cudaErrorInvalidValue;
  return vec ? launch_b1<R, HALO, B, SV>(out, v, blocks, h, L, V, d, k0, k1, mb, parity, parity_offset, batch, st)
             : launch_b1<R, HALO, B, 1>(out, v, blocks, h, L, V, d, k0, k1, mb, parity, parity_offset, batch, st);
}

// faces: (fwd, bwd) of t, z, y, x in that order, 8 pointers
template <typename R, typename B>
int launch_halo(void* out, const void* v, const void* blocks, const void* const* faces, int d, int k0, int k1,
                int t, int z, int y, int x, int batch, int regime, void* stream) {
  Halo<R> h;
  for (int mu = 0; mu < 4; ++mu) {
    h.fwd[mu] = (const cplx<R>*)faces[2 * mu];
    h.bwd[mu] = (const cplx<R>*)faces[2 * mu + 1];
  }
  return launch_coarse<R, true, B>(out, v, blocks, h, d, k0, k1, t, z, y, x, 0, 0, 0, 0, -1, 0, batch, regime,
                                   stream);
}

template <typename R>
Halo<R> no_halo() {
  Halo<R> h;
  for (int mu = 0; mu < 4; ++mu) h.fwd[mu] = h.bwd[mu] = nullptr;
  return h;
}

// K4-schur, one launch (phase 1: odd tiles, 2: even tiles): the tile of
// kernel 1 at this V, the hop sums' warps nw and the self terms' nws of the
// four launches, and as many row-chunk groups as launch_b1_tiles takes; in
// launch 1 a block of SCHUR_NH groups (a cluster of 2 blocks of 8 warps is
// resident on 132 SMs where one of 4 was not: 62 of 64 clusters at 8^4),
// the blocks of a tile one cluster (at most MAX_SPLITS)
template <typename R, typename B, int SV, int TS1>
int launch_schur_tiles(void* out, void* t, const void* v, const void* E, const void* O, Lattice L, int V, int d,
                       int batch, int phase, cudaStream_t stream) {
  constexpr int G = 32 / (TS1 / SV);
  const int nic = (d + B1_ICH - 1) / B1_ICH, nw = b1_warps(8 * d, G), nws = b1_warps(d, G);
  const long long tiles = (V / 2 + TS1 - 1) / TS1, per_group = tiles * batch * 32 * nw;
  const int groups = (int)std::max(1LL, std::min((long long)nic, B1_THREADS / per_group));
  if (phase == 2) {
    coarse_b1_kernel_schur<R, B, SV, TS1, false><<<dim3((unsigned)(tiles * batch * groups)), dim3(32, nw), 0,
                                                   stream>>>((cplx<R>*)out, (cplx<R>*)t, (const cplx<R>*)v,
                                                             (const B*)E, L, V, d, batch, groups, nw, nws);
    return (int)cudaGetLastError();
  }
  const int gy = std::min((groups + SCHUR_NH - 1) / SCHUR_NH, MAX_SPLITS);
  auto kernel = coarse_b1_kernel_schur<R, B, SV, TS1, true>;
  const size_t smem = (size_t)d * TS1 * sizeof(cplx<R>);
  if (smem > SCHUR_SMEM_MAX) return (int)cudaErrorInvalidValue;
  static bool ready = false;  // once per instance: shared memory above 48 KB
  if (!ready) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SCHUR_SMEM_MAX);
    if (e != cudaSuccess) return (int)e;
    ready = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(tiles * batch * gy));
  cfg.blockDim = dim3(32, SCHUR_NH * nw);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)gy;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, kernel, (cplx<R>*)out, (cplx<R>*)t, (const cplx<R>*)v, (const B*)O, L, V, d,
                                 batch, gy, nw, nws);
}

// K4-schur: 16-byte loads (each half's sites fill them: with even extents
// V / 2 is a multiple of 8; the blocks must be 16-byte aligned, as fresh
// allocations are); the tile by V as kernel 1's, so the slots match the
// four launches'
template <typename R, typename B>
int launch_schur(void* out, void* t, const void* v, const void* E, const void* O, int d, int tt, int z, int y,
                 int x, int batch, int phase, void* stream) {
  if ((tt | z | y | x) & 1 || (phase != 1 && phase != 2) || (uintptr_t)E % 16 || (uintptr_t)O % 16)
    return (int)cudaErrorInvalidValue;
  Lattice L = make_lattice(tt, z, y, x);
  const int V = tt * z * y * x;
  cudaStream_t st = (cudaStream_t)stream;
  constexpr int SV = 16 / sizeof(B);
  return V >= B1_WIDE ? launch_schur_tiles<R, B, SV, 32>(out, t, v, E, O, L, V, d, batch, phase, st)
                      : launch_schur_tiles<R, B, SV, 16>(out, t, v, E, O, L, V, d, batch, phase, st);
}

}  // namespace

extern "C" {

// K4; blocks holds terms [0, K) of which [k0, k1) are applied; mask block
// extents 0 = unmasked; parity -1 = all sites, parity_offset = the global
// coordinate sum of site 0; regime 0 = kernel chosen by batch, 1 = the
// batch-1 kernel, 2 = the multi-right-hand-side kernel.  Returns
// cudaGetLastError() (or the launch's error).
int ddaamg_coarse_f32(void* out, const void* v, const void* blocks, int d, int k0, int k1, int t, int z, int y,
                      int x, int bt, int bz, int by, int bx, int parity, int parity_offset, int batch, int regime,
                      void* stream) {
  return launch_coarse<float, false, cplx<float>>(out, v, blocks, no_halo<float>(), d, k0, k1, t, z, y, x, bt, bz,
                                                  by, bx, parity, parity_offset, batch, regime, stream);
}

int ddaamg_coarse_f64(void* out, const void* v, const void* blocks, int d, int k0, int k1, int t, int z, int y,
                      int x, int bt, int bz, int by, int bx, int parity, int parity_offset, int batch, int regime,
                      void* stream) {
  return launch_coarse<double, false, cplx<double>>(out, v, blocks, no_halo<double>(), d, k0, k1, t, z, y, x, bt,
                                                    bz, by, bx, parity, parity_offset, batch, regime, stream);
}

// K4-bf16: K4 on complex64 fields with blocks stored as bf16 (re, im) pairs.
int ddaamg_coarse_bf16(void* out, const void* v, const void* blocks, int d, int k0, int k1, int t, int z, int y,
                       int x, int bt, int bz, int by, int bx, int parity, int parity_offset, int batch, int regime,
                       void* stream) {
  return launch_coarse<float, false, bf16x2>(out, v, blocks, no_halo<float>(), d, k0, k1, t, z, y, x, bt, bz, by,
                                             bx, parity, parity_offset, batch, regime, stream);
}

// K5: terms [k0, k1) on one slab with the received faces of the sharded
// axes: (fwd, bwd) pairs of t, z, y and x, nullptr for an unsharded axis;
// regime as for K4.  Returns cudaGetLastError() (or the launch's error).
int ddaamg_coarse_halo_f32(void* out, const void* v, const void* blocks, const void* fwd_t, const void* bwd_t,
                           const void* fwd_z, const void* bwd_z, const void* fwd_y, const void* bwd_y,
                           const void* fwd_x, const void* bwd_x, int d, int k0, int k1, int t, int z, int y, int x,
                           int batch, int regime, void* stream) {
  const void* faces[8] = {fwd_t, bwd_t, fwd_z, bwd_z, fwd_y, bwd_y, fwd_x, bwd_x};
  return launch_halo<float, cplx<float>>(out, v, blocks, faces, d, k0, k1, t, z, y, x, batch, regime, stream);
}

int ddaamg_coarse_halo_f64(void* out, const void* v, const void* blocks, const void* fwd_t, const void* bwd_t,
                           const void* fwd_z, const void* bwd_z, const void* fwd_y, const void* bwd_y,
                           const void* fwd_x, const void* bwd_x, int d, int k0, int k1, int t, int z, int y, int x,
                           int batch, int regime, void* stream) {
  const void* faces[8] = {fwd_t, bwd_t, fwd_z, bwd_z, fwd_y, bwd_y, fwd_x, bwd_x};
  return launch_halo<double, cplx<double>>(out, v, blocks, faces, d, k0, k1, t, z, y, x, batch, regime, stream);
}

// K5-bf16: K5 on complex64 fields with blocks stored as bf16 (re, im) pairs.
int ddaamg_coarse_halo_bf16(void* out, const void* v, const void* blocks, const void* fwd_t, const void* bwd_t,
                            const void* fwd_z, const void* bwd_z, const void* fwd_y, const void* bwd_y,
                            const void* fwd_x, const void* bwd_x, int d, int k0, int k1, int t, int z, int y,
                            int x, int batch, int regime, void* stream) {
  const void* faces[8] = {fwd_t, bwd_t, fwd_z, bwd_z, fwd_y, bwd_y, fwd_x, bwd_x};
  return launch_halo<float, bf16x2>(out, v, blocks, faces, d, k0, k1, t, z, y, x, batch, regime, stream);
}

// K4-schur (kernel 3): launch `phase` (1: t = A_oo^-1 sum_k hop_k v on the
// odd sites, t compact [batch, d, V/2]; 2: out = A_ee v - sum_k hop_k t on
// the even sites, zero on the odd) of the Schur complement on the
// parity-split blocks E, O [9, d, d, V/2] (complex of the field's
// precision, or bf16 pairs with complex64 fields); every extent even.
// Returns cudaGetLastError() (or the launch's error).
int ddaamg_schur_f32(void* out, void* t, const void* v, const void* E, const void* O, int d, int tt, int z, int y,
                     int x, int batch, int phase, void* stream) {
  return launch_schur<float, cplx<float>>(out, t, v, E, O, d, tt, z, y, x, batch, phase, stream);
}

int ddaamg_schur_f64(void* out, void* t, const void* v, const void* E, const void* O, int d, int tt, int z, int y,
                     int x, int batch, int phase, void* stream) {
  return launch_schur<double, cplx<double>>(out, t, v, E, O, d, tt, z, y, x, batch, phase, stream);
}

int ddaamg_schur_bf16(void* out, void* t, const void* v, const void* E, const void* O, int d, int tt, int z, int y,
                      int x, int batch, int phase, void* stream) {
  return launch_schur<float, bf16x2>(out, t, v, E, O, d, tt, z, y, x, batch, phase, stream);
}

}  // extern "C"
