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
// contraction on one slab of a lattice sharded along t and/or z (the TPU
// kernel's "tz" layout, whose neighbor fields were fetched across shards by
// ppermute): on a sharded axis a forward hop from the slab's last slice
// reads the face received from the +mu neighbor rank, a backward hop from
// the first slice the face received from the -mu neighbor; unsharded axes
// wrap as in K4.  Faces are [batch, d, V / n_mu] with the face site index
// (z, y, x) for t and (t, y, x) for z.
//
// Layout: fields [batch, d, V]; blocks [K, d (j), d (i), V], sites fastest,
// each entry a complex number of the field's precision or, compressed, one
// 32-bit (re, im) pair of bf16 (complex64 fields only).  The storage type is
// a template parameter of the one kernel, so the instances cannot drift
// apart: a bf16 entry is widened exactly (__bfloat162float) and the sums run
// in f32 in the same fixed order as with f32 blocks.
//
// What bounds them on the H100: memory, in the blocks.  A full apply at
// d = 56 reads 9 * 56^2 complex64 = 226 KB of blocks per site against
// 9 * 56 * 8 B of field and 56 * 8 B of output, with 8 flop per 8-byte
// block entry (1 flop/byte); the halo faces of K5 add d * 8 B per face site.
// With bf16 blocks a full apply at 8^4, d = 56, batch 1 reads
// 9 * 56^2 * 4 B * 4096 = 463 MB of blocks plus ~18 MB of fields: 0.144 ms
// at 3.35 TB/s (f32 blocks: 925 MB, 0.28 ms), and a warp's load of one
// (k, j, i) entry at 32 sites is 128 B instead of 256 B.
// On the small coarse lattices of the main path (8^4 = 4096 and 4^4 = 256
// sites; a 2-rank slab of 8^4 has 2048) the number of sites is too small to
// hide the load latency with one thread per site, so the design spreads
// each output over more threads: a thread block is TS sites x JS slices
// of the j sum; a thread owns one site, a chunk of ICH output rows i and
// every JS-th j, so a warp reads 32 consecutive sites of the same
// (k, j, i) entry (coalesced) and only ICH complex accumulators live in
// registers (not 56).  The JS partial sums meet in shared memory in a
// fixed order, so results do not depend on scheduling.  The TPU kernel's
// accumulation along a sequential grid axis over k becomes a loop over k
// inside the thread, since thread blocks run in no order.  Neighbor
// fields are gathered and masked here from coordinates (and, in K5, from
// the faces), so no 9-field stack is ever built.  For a batch of
// right-hand sides the batch index is the fastest block index, so the
// blocks of one site tile are read by concurrently running thread blocks
// and reach the other batch members from L2.
#include <cuda_bf16.h>

#include "common.cuh"

constexpr int ICH = 8;  // output rows per thread
constexpr int TS = 32;  // sites per thread block (one warp wide)
constexpr int JS = 8;   // slices of the j sum per thread block

// one compressed block entry: (re, im) in bf16, 4 bytes
struct alignas(4) bf16x2 {
  __nv_bfloat16 re, im;
};

// a block entry as a complex number of the field's precision
template <typename R>
__device__ __forceinline__ cplx<R> widen(cplx<R> b) {
  return b;
}

__device__ __forceinline__ cplx<float> widen(bf16x2 b) {
  return cx<float>(__bfloat162float(b.re), __bfloat162float(b.im));
}

// received faces of the sharded t (0) and z (1) axes; nullptr = unsharded
template <typename R>
struct Halo {
  const cplx<R>* fwd[2];  // v(x + mu) for the slab's last mu slice
  const cplx<R>* bwd[2];  // v(x - mu) for the slab's first mu slice
};

// B: the storage of a block entry, cplx<R> or (R = float only) bf16x2
template <typename R, bool HALO, typename B>
__global__ void __launch_bounds__(TS * JS) coarse_kernel(cplx<R>* __restrict__ out, const cplx<R>* __restrict__ v,
                                                        const B* __restrict__ blocks, Halo<R> h, Lattice L,
                                                        int V, int d, int k0, int k1, int4 mblk, int parity,
                                                        int parity_offset, int batch) {
  __shared__ cplx<R> part[JS][ICH][TS];
  int tile = blockIdx.x / batch;
  int b = blockIdx.x - tile * batch;
  int tx = threadIdx.x, js = threadIdx.y;
  int site = tile * TS + tx;
  int i0 = blockIdx.y * ICH;
  bool live = site < V;
  int c[4] = {0, 0, 0, 0};
  if (live) site_coords(L, site, c);
  bool zero = !live || (parity >= 0 && ((c[0] + c[1] + c[2] + c[3] + parity_offset) & 1) != parity);
  const int mb[4] = {mblk.x, mblk.y, mblk.z, mblk.w};
  const cplx<R>* vb = v + (long long)b * d * V;
  cplx<R> acc[ICH];
#pragma unroll
  for (int ii = 0; ii < ICH; ++ii) acc[ii] = cx<R>(0, 0);

  if (!zero) {
#pragma unroll
    for (int k = 0; k < 9; ++k) {  // unrolled: mu is a constant in each copy
      if (k < k0 || k >= k1) continue;
      int nb = site;
      const cplx<R>* src = vb;
      long long ld = V;  // stride of one dof row in src
      if (k > 0) {
        const int mu = (k - 1) & 3;
        const bool fwd = k < 5;
        if (mb[mu] > 0) {
          int r = c[mu] % mb[mu];
          if (fwd ? (r == mb[mu] - 1) : (r == 0)) continue;
        }
        nb = site_step(L, site, c, mu, fwd ? +1 : -1);
        if (HALO && mu < 2) {
          const cplx<R>* face = fwd ? h.fwd[mu] : h.bwd[mu];
          if (face != nullptr && c[mu] == (fwd ? L.n[mu] - 1 : 0)) {
            int fv = V / L.n[mu];
            nb = mu == 0 ? site - c[0] * L.stride[0] : c[0] * L.stride[1] + site % L.stride[1];
            src = face + (long long)b * d * fv;
            ld = fv;
          }
        }
      }
      const B* Bk = blocks + (long long)k * d * d * V;
      for (int j = js; j < d; j += JS) {
        cplx<R> vj = src[(long long)j * ld + nb];
        const B* Bj = Bk + ((long long)j * d + i0) * V + site;
#pragma unroll
        for (int ii = 0; ii < ICH; ++ii)
          if (i0 + ii < d) cfma(acc[ii], widen(Bj[(long long)ii * V]), vj);
      }
    }
  }
#pragma unroll
  for (int ii = 0; ii < ICH; ++ii) part[js][ii][tx] = acc[ii];
  __syncthreads();
  // JS * TS threads finish ICH * TS outputs: thread (tx, js) sums rows
  // ii = js, js + JS, ... of site tx over the JS slices in order
  if (!live) return;
  cplx<R>* o = out + (long long)b * d * V;
  for (int ii = js; ii < ICH; ii += JS) {
    if (i0 + ii >= d) continue;
    cplx<R> s = part[0][ii][tx];
#pragma unroll
    for (int q = 1; q < JS; ++q) s = cadd(s, part[q][ii][tx]);
    o[(long long)(i0 + ii) * V + site] = s;
  }
}

namespace {

template <typename R, bool HALO, typename B>
int launch_coarse(void* out, const void* v, const void* blocks, Halo<R> h, int d, int k0, int k1, int t, int z,
                  int y, int x, int bt, int bz, int by, int bx, int parity, int parity_offset, int batch,
                  void* stream) {
  Lattice L = make_lattice(t, z, y, x);
  int V = t * z * y * x;
  int tiles = (V + TS - 1) / TS;
  dim3 grid((unsigned)(tiles * batch), (unsigned)((d + ICH - 1) / ICH));
  dim3 block(TS, JS);
  coarse_kernel<R, HALO, B><<<grid, block, 0, (cudaStream_t)stream>>>(
      (cplx<R>*)out, (const cplx<R>*)v, (const B*)blocks, h, L, V, d, k0, k1, make_int4(bt, bz, by, bx),
      parity, parity_offset, batch);
  return (int)cudaGetLastError();
}

template <typename R, typename B>
int launch_halo(void* out, const void* v, const void* blocks, const void* fwd_t, const void* bwd_t,
                const void* fwd_z, const void* bwd_z, int d, int k0, int k1, int t, int z, int y, int x, int batch,
                void* stream) {
  Halo<R> h;
  h.fwd[0] = (const cplx<R>*)fwd_t;
  h.bwd[0] = (const cplx<R>*)bwd_t;
  h.fwd[1] = (const cplx<R>*)fwd_z;
  h.bwd[1] = (const cplx<R>*)bwd_z;
  return launch_coarse<R, true, B>(out, v, blocks, h, d, k0, k1, t, z, y, x, 0, 0, 0, 0, -1, 0, batch, stream);
}

template <typename R>
Halo<R> no_halo() {
  Halo<R> h;
  h.fwd[0] = h.fwd[1] = h.bwd[0] = h.bwd[1] = nullptr;
  return h;
}

}  // namespace

extern "C" {

// K4; blocks holds terms [0, K) of which [k0, k1) are applied; mask block
// extents 0 = unmasked; parity -1 = all sites, parity_offset = the global
// coordinate sum of site 0.  Returns cudaGetLastError().
int ddaamg_coarse_f32(void* out, const void* v, const void* blocks, int d, int k0, int k1, int t, int z, int y,
                      int x, int bt, int bz, int by, int bx, int parity, int parity_offset, int batch,
                      void* stream) {
  return launch_coarse<float, false, cplx<float>>(out, v, blocks, no_halo<float>(), d, k0, k1, t, z, y, x, bt, bz,
                                                  by, bx, parity, parity_offset, batch, stream);
}

int ddaamg_coarse_f64(void* out, const void* v, const void* blocks, int d, int k0, int k1, int t, int z, int y,
                      int x, int bt, int bz, int by, int bx, int parity, int parity_offset, int batch,
                      void* stream) {
  return launch_coarse<double, false, cplx<double>>(out, v, blocks, no_halo<double>(), d, k0, k1, t, z, y, x, bt,
                                                    bz, by, bx, parity, parity_offset, batch, stream);
}

// K4-bf16: K4 on complex64 fields with blocks stored as bf16 (re, im) pairs.
int ddaamg_coarse_bf16(void* out, const void* v, const void* blocks, int d, int k0, int k1, int t, int z, int y,
                       int x, int bt, int bz, int by, int bx, int parity, int parity_offset, int batch,
                       void* stream) {
  return launch_coarse<float, false, bf16x2>(out, v, blocks, no_halo<float>(), d, k0, k1, t, z, y, x, bt, bz, by,
                                             bx, parity, parity_offset, batch, stream);
}

// K5: terms [k0, k1) on one slab with the received faces of the sharded t
// and z axes (nullptr for an unsharded axis).  Returns cudaGetLastError().
int ddaamg_coarse_halo_f32(void* out, const void* v, const void* blocks, const void* fwd_t, const void* bwd_t,
                           const void* fwd_z, const void* bwd_z, int d, int k0, int k1, int t, int z, int y, int x,
                           int batch, void* stream) {
  return launch_halo<float, cplx<float>>(out, v, blocks, fwd_t, bwd_t, fwd_z, bwd_z, d, k0, k1, t, z, y, x, batch,
                                         stream);
}

int ddaamg_coarse_halo_f64(void* out, const void* v, const void* blocks, const void* fwd_t, const void* bwd_t,
                           const void* fwd_z, const void* bwd_z, int d, int k0, int k1, int t, int z, int y, int x,
                           int batch, void* stream) {
  return launch_halo<double, cplx<double>>(out, v, blocks, fwd_t, bwd_t, fwd_z, bwd_z, d, k0, k1, t, z, y, x, batch,
                                           stream);
}

// K5-bf16: K5 on complex64 fields with blocks stored as bf16 (re, im) pairs.
int ddaamg_coarse_halo_bf16(void* out, const void* v, const void* blocks, const void* fwd_t, const void* bwd_t,
                            const void* fwd_z, const void* bwd_z, int d, int k0, int k1, int t, int z, int y, int x,
                            int batch, void* stream) {
  return launch_halo<float, bf16x2>(out, v, blocks, fwd_t, bwd_t, fwd_z, bwd_z, d, k0, k1, t, z, y, x, batch, stream);
}

}  // extern "C"
