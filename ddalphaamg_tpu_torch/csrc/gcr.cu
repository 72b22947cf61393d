// K7: one whole GCR iteration after the operator apply, with the row
// index j read from the device (solvers/device_gmres.GCRLanes.step,
// operators/cuda_gcr.py).
//
// It replaces no Pallas kernel: the JAX package's GCR computes this step
// with XLA einsums and elementwise updates inside the lax.while_loop
// (ddalphaamg_tpu/solvers/device_gmres.py:106-136), which XLA fuses.  For
// every lane b of W, Q [B, m, n], x, r [B, n] and w = A q, q [B, n]:
//
//   h_i = <W_i, w> (i < j),  w' = w - sum_{i<j} h_i W_i,  q' = q - sum_{i<j} h_i Q_i,
//   s = 1 / |w'| (1 where |w'| = 0),  W_j = s w',  Q_j = s q',
//   alpha = go_b ? s <w', r> : 0,  x += alpha Q_j,  r -= alpha W_j,
//   |r| into rn, iters += go, go = (|r| >= stop) & active,
//   and, with B > 1, rz = go ? r : 0 (the next preconditioner input: a
//   frozen lane enters it as zeros).
//
// A frozen lane (go false) keeps x, r, rn and iters; its row j is written
// (its w and q come in as zeros: zero rows).  Only the rows below j are
// read.  Bound by the bytes: (2j + 8) n elements a lane at least (W_i, Q_i
// for i < j, w, q, r and x read; W_j, Q_j, x and r written); classical
// Gram-Schmidt reads W twice (the products, then the update), so
// (3j + 8) n as written here, the second read often from L2.
//
// Two designs, chosen by n (ddaamg_gcr_path; a caller may force one):
//   cluster (small n, the coarsest 4^4 GCR): one launch, one thread-block
//       cluster per lane of up to 16 CTAs, each holding its slice of w, q,
//       r and x in shared memory through all phases; the sums across the
//       cluster (h, |w'|^2 and <w', r>, |r|^2) go through distributed
//       shared memory after cluster.sync(), a CTA's value a lane, summed
//       by a warp's butterfly (cluster_sum).  The products take two
//       rows a warp (a row split over several warps where j is small);
//       the update splits a CTA's rows into up to four groups (no more
//       than j) whose sums meet in shared memory, so that a short slice
//       still keeps many row loads in flight.
//   grid (large n): two launches.  dots: per (chunk, 8 rows, lane) block
//       the chunk's partial h_i, and the last block of a (rows, lane) group
//       to finish (an atomic ticket, reset by that block) sums its rows'
//       chunks.  update: a persistent grid no larger than the card holds at
//       once: w', q' and the partial |w'|^2, <w', r> of every chunk, a
//       grid barrier whose last arrival computes s and alpha of every lane,
//       then rows j, x, r and the partial |r|^2, a second barrier whose
//       last arrival writes rn, iters and go, then rz.  A block that holds
//       one chunk keeps w' and q' in registers across the barrier, else
//       they go through rows j unscaled.
// Every sum is taken in a fixed order (elements of a thread, a warp's
// butterfly, warps or chunks in order, CTAs by a butterfly), so the bits depend on (j, n)
// alone, never on m, on B or on which block arrives last: the host loop,
// a replay and repeated runs agree bit for bit.  complex64 and complex128.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int MAX_ROWS = 2048;        // m at most (h of a lane in shared memory)

// the step's operands (module note); rz and active may be null.  q may be
// r (batch 1) or rz (batch > 1): a GCR without a preconditioner hands its
// residual input over as q.  Both designs read q before they write r or
// rz, which keeps that safe: the cluster design copies its slice of q into
// shared memory before any write, the grid design reads q in the phase
// before its first barrier, writes r after it and rz after the second.
// None of the three pointers is __restrict__.
template <typename R>
struct Step {
  cplx<R>* W;
  cplx<R>* Q;
  const long long* jp;
  const cplx<R>* w;
  const cplx<R>* q;
  cplx<R>* x;
  cplx<R>* r;
  cplx<R>* rz;
  unsigned char* go;
  const R* stop;
  const unsigned char* active;
  R* rn;
  long long* iters;
  long long n;
  int m;
};

// V complex numbers in one load: 16 bytes for complex64 pairs and
// complex128, 8 for single complex64 (odd n)
template <typename R, int V>
struct alignas(V * sizeof(cplx<R>)) Pack {
  cplx<R> v[V];
};

template <typename R, int V>
__device__ __forceinline__ Pack<R, V> zero_pack() {
  Pack<R, V> p;
#pragma unroll
  for (int e = 0; e < V; ++e) p.v[e] = cx<R>(0, 0);
  return p;
}

template <typename R>
__device__ __forceinline__ cplx<R> warp_sum(cplx<R> v) {
  for (int o = 16; o > 0; o >>= 1) {
    v.re += __shfl_xor_sync(0xffffffffu, v.re, o);
    v.im += __shfl_xor_sync(0xffffffffu, v.im, o);
  }
  return v;
}

template <typename R>
__device__ __forceinline__ R warp_sum(R v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// loads of what another block wrote during this launch (past L1)
__device__ __forceinline__ float ldcg(const float* p) { return __ldcg(p); }
__device__ __forceinline__ double ldcg(const double* p) { return __ldcg(p); }
__device__ __forceinline__ cplx<float> ldcg(const cplx<float>* p) {
  const float2 v = __ldcg(reinterpret_cast<const float2*>(p));
  return cx<float>(v.x, v.y);
}
__device__ __forceinline__ cplx<double> ldcg(const cplx<double>* p) {
  const double2 v = __ldcg(reinterpret_cast<const double2*>(p));
  return cx<double>(v.x, v.y);
}

// the row index j, or -1 where it lies outside [0, m) (then nothing runs)
__device__ __forceinline__ int row_of(const long long* jp, int m) {
  const long long j = *jp;
  return (j >= 0 && j < m) ? (int)j : -1;
}

// the largest power of two <= v (v >= 1)
__host__ __device__ __forceinline__ int pow2_floor(int v) {
  int p = 1;
  while (2 * p <= v) p *= 2;
  return p;
}

template <typename R>
__device__ __forceinline__ R norm2(cplx<R> a) {
  return a.re * a.re + a.im * a.im;
}

// the stop test of lane b from its |r| (new if it went, else kept)
template <typename R>
__device__ __forceinline__ bool goes_on(const Step<R>& s, int b, R rn) {
  return rn >= s.stop[b] && (s.active == nullptr || s.active[b] != 0);
}

// v[0..K) summed over the block's warps in order: every thread returns the
// block's sums (red: [warps][K] shared)
template <typename R, int K, int WARPS>
__device__ __forceinline__ void block_sum(R (&v)[K], R (*red)[K]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = warp_sum(v[k]);
  if (lane == 0)
#pragma unroll
    for (int k = 0; k < K; ++k) red[warp][k] = v[k];
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    R t = red[0][k];
#pragma unroll
    for (int p = 1; p < WARPS; ++p) t += red[p][k];
    v[k] = t;
  }
  __syncthreads();  // red may be written again
}

// ---------------------------------------------------------------------------
// cluster design: one launch, a cluster of CTAs a lane
// ---------------------------------------------------------------------------

// the sum over the cluster's CTAs of v at `at` in each CTA's shared memory:
// lane c of the warp reads CTA c's value (all at once), then a butterfly
// over the warp in a fixed order (lanes from the CTA count on add zeros);
// every lane, in every warp of every CTA, gets the same bits
template <typename T>
__device__ __forceinline__ T cluster_sum(cg::cluster_group& cluster, T* at, int ctas) {
  const int lane = threadIdx.x & 31;
  T v;
  if (lane < ctas)
    v = *cluster.map_shared_rank(at, lane);
  else
    v = T{};
  return warp_sum(v);
}

constexpr int CT = 512;                // threads of a CTA
constexpr int CW = CT / 32;
constexpr int CLUSTER_MAX = 16;        // CTAs of a cluster at most (non-portable above 8)
constexpr int CLUSTER_ROWS = 256;      // m at most (h in shared memory)
constexpr int MIN_SLICE = 512;         // elements of a CTA's slice at least
constexpr int SLICE_ALIGN = 32;        // a slice's length: a multiple of this
constexpr int CLUSTER_SMEM = 200 * 1024;  // dynamic shared memory of a CTA at most
constexpr int U = 8;                   // row loads in flight a lane (products)
constexpr int PK = 2;                  // packs a thread updates at once
static_assert(CLUSTER_MAX <= 16, "a half-warp gathers a row's partials from the CTAs");

template <typename R, int V>
__global__ void __launch_bounds__(CT, 1) gcr_cluster_step(Step<R> s, int S, int RG) {
  using P = Pack<R, V>;
  cg::cluster_group cluster = cg::this_cluster();
  const int j = row_of(s.jp, s.m);
  if (j < 0) return;  // the whole grid alike
  const int rank = (int)cluster.block_rank(), ctas = (int)cluster.num_blocks();
  const int b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long n = s.n, k0 = (long long)rank * S;
  const long long rest = n - k0;
  const int np = (int)(rest <= 0 ? 0 : (rest < S ? rest : S)) / V;  // packs of the slice
  extern __shared__ __align__(16) unsigned char smem_raw[];
  P* ws = reinterpret_cast<P*>(smem_raw);
  P* qs = ws + S / V;
  P* rs = qs + S / V;
  P* xs = rs + S / V;
  __shared__ cplx<R> hpart[CLUSTER_ROWS];  // this CTA's partial h, read by the cluster
  __shared__ cplx<R> hsplit[CW][CW / 2];   // few rows: the parts of a row's partial h
  __shared__ cplx<R> hs[CLUSTER_ROWS];
  __shared__ R part_a[3], part_b[1];        // its partial |w'|^2, <w', r>; |r|^2
  __shared__ R red3[CW][3];
  __shared__ R red1[CW][1];
  const bool went = s.go[b] != 0;
  const R rn_old = s.rn[b];
  const long long base = (long long)b * n + k0;
  const P* wg = reinterpret_cast<const P*>(s.w + base);
  const P* qg = reinterpret_cast<const P*>(s.q + base);
  P* rg = reinterpret_cast<P*>(s.r + base);
  P* xg = reinterpret_cast<P*>(s.x + base);
  for (int p = tid; p < np; p += CT) {
    ws[p] = wg[p];
    qs[p] = qg[p];
    rs[p] = rg[p];
    xs[p] = xg[p];
  }
  __syncthreads();

  // h partials.  Few rows (j <= CW / 2): a row split over parts = CW / j
  // warps (a power of two), their sums added in part order; else a warp
  // two rows at once; U loads of a row in flight a lane
  const int parts = j <= CW / 2 ? pow2_floor(CW / (j > 0 ? j : 1)) : 1;
  if (parts > 1) {
    const int part = warp % parts;
    for (int i = warp / parts; i < j; i += CW / parts) {
      const P* row = reinterpret_cast<const P*>(s.W + ((long long)b * s.m + i) * n + k0);
      cplx<R> acc = cx<R>(0, 0);
      for (int p0 = part * 32 + lane; p0 < np; p0 += 32 * parts * U) {
        P a[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int p = p0 + 32 * parts * u;
          a[u] = p < np ? row[p] : zero_pack<R, V>();
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int p = p0 + 32 * parts * u;
          if (p < np) {
            const P wv = ws[p];
#pragma unroll
            for (int e = 0; e < V; ++e) acc = cadd(acc, cmulc(a[u].v[e], wv.v[e]));
          }
        }
      }
      acc = warp_sum(acc);
      if (lane == 0) hsplit[part][i] = acc;
    }
    __syncthreads();
    for (int i = tid; i < j; i += CT) {
      cplx<R> t = hsplit[0][i];
      for (int k = 1; k < parts; ++k) t = cadd(t, hsplit[k][i]);
      hpart[i] = t;
    }
  }
  for (int i = warp; parts == 1 && i < j; i += 2 * CW) {
    const int i2 = i + CW;
    const bool two = i2 < j;
    const P* row = reinterpret_cast<const P*>(s.W + ((long long)b * s.m + i) * n + k0);
    const P* row2 = reinterpret_cast<const P*>(s.W + ((long long)b * s.m + i2) * n + k0);
    cplx<R> acc = cx<R>(0, 0), acc2 = cx<R>(0, 0);
    for (int p0 = lane; p0 < np; p0 += 32 * U) {
      P a[U], c[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int p = p0 + 32 * u;
        a[u] = p < np ? row[p] : zero_pack<R, V>();
        c[u] = two && p < np ? row2[p] : zero_pack<R, V>();
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int p = p0 + 32 * u;
        if (p < np) {
          const P wv = ws[p];
#pragma unroll
          for (int e = 0; e < V; ++e) {
            acc = cadd(acc, cmulc(a[u].v[e], wv.v[e]));
            acc2 = cadd(acc2, cmulc(c[u].v[e], wv.v[e]));
          }
        }
      }
    }
    acc = warp_sum(acc);
    acc2 = warp_sum(acc2);
    if (lane == 0) {
      hpart[i] = acc;
      if (two) hpart[i2] = acc2;
    }
  }
  cluster.sync();
  // h: a half-warp a row, lane c of it reading CTA c's partial (CTAs <= 16)
  for (int i0 = 2 * warp; i0 < j; i0 += 2 * CW) {
    const int i = i0 + (lane >> 4), c = lane & 15;
    cplx<R> t = (c < ctas && i < j) ? *cluster.map_shared_rank(hpart + i, c) : cx<R>(0, 0);
    for (int o = 8; o > 0; o >>= 1) {
      t.re += __shfl_xor_sync(0xffffffffu, t.re, o);
      t.im += __shfl_xor_sync(0xffffffffu, t.im, o);
    }
    if (c == 0 && i < j) hs[i] = t;
  }
  __syncthreads();

  // w' = w - (S_0 + S_1 + ...), q' likewise: the CTA's threads in `groups` row
  // groups, group g summing h_i W_i and h_i Q_i over its rows [r0, r1) in
  // order, PK packs a thread at once; then the partial |w'|^2, <w', r>
  R a3[3] = {0, 0, 0};
  auto finish = [&](int p, const P& sw, const P& sq) {
    P a = ws[p], g = qs[p];
    const P rv = rs[p];
#pragma unroll
    for (int e = 0; e < V; ++e) {
      a.v[e] = csub(a.v[e], sw.v[e]);
      g.v[e] = csub(g.v[e], sq.v[e]);
      a3[0] += norm2(a.v[e]);
      const cplx<R> d = cmulc(a.v[e], rv.v[e]);
      a3[1] += d.re;
      a3[2] += d.im;
    }
    ws[p] = a;
    qs[p] = g;
  };
  const int groups = RG < j ? RG : pow2_floor(j > 0 ? j : 1);  // each a row or more
  const int tpg = CT / groups, grp = tid / tpg, tg = tid - grp * tpg;
  const int r0 = j * grp / groups, r1 = j * (grp + 1) / groups;
  const int spk = S / V;
  P* part = xs + spk;  // groups > 1: their sums [groups][2][spk]
  const long long off = (long long)b * s.m * n + k0;
  for (int p0 = tg; p0 < np; p0 += PK * tpg) {
    P sw[PK], sq[PK];
#pragma unroll
    for (int k = 0; k < PK; ++k) sw[k] = sq[k] = zero_pack<R, V>();
    int i = r0;
    for (; i + 4 <= r1; i += 4) {
      P wa[4][PK], qa[4][PK];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int k = 0; k < PK; ++k) {
          const int p = p0 + k * tpg;
          const long long o = off + (long long)(i + u) * n;
          wa[u][k] = p < np ? reinterpret_cast<const P*>(s.W + o)[p] : zero_pack<R, V>();
          qa[u][k] = p < np ? reinterpret_cast<const P*>(s.Q + o)[p] : zero_pack<R, V>();
        }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const cplx<R> hi = hs[i + u];
#pragma unroll
        for (int k = 0; k < PK; ++k)
#pragma unroll
          for (int e = 0; e < V; ++e) {
            sw[k].v[e] = cadd(sw[k].v[e], cmul(hi, wa[u][k].v[e]));
            sq[k].v[e] = cadd(sq[k].v[e], cmul(hi, qa[u][k].v[e]));
          }
      }
    }
    for (; i < r1; ++i) {
      const cplx<R> hi = hs[i];
      const long long o = off + (long long)i * n;
#pragma unroll
      for (int k = 0; k < PK; ++k) {
        const int p = p0 + k * tpg;
        if (p < np) {
          const P wa = reinterpret_cast<const P*>(s.W + o)[p];
          const P qa = reinterpret_cast<const P*>(s.Q + o)[p];
#pragma unroll
          for (int e = 0; e < V; ++e) {
            sw[k].v[e] = cadd(sw[k].v[e], cmul(hi, wa.v[e]));
            sq[k].v[e] = cadd(sq[k].v[e], cmul(hi, qa.v[e]));
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < PK; ++k) {
      const int p = p0 + k * tpg;
      if (p >= np) continue;
      if (groups == 1) {
        finish(p, sw[k], sq[k]);
      } else {
        part[(2 * grp) * spk + p] = sw[k];
        part[(2 * grp + 1) * spk + p] = sq[k];
      }
    }
  }
  if (groups > 1) {
    __syncthreads();
    for (int p = tid; p < np; p += CT) {
      P sw = part[p], sq = part[spk + p];
      for (int g2 = 1; g2 < groups; ++g2) {
        const P tw = part[(2 * g2) * spk + p], tq = part[(2 * g2 + 1) * spk + p];
#pragma unroll
        for (int e = 0; e < V; ++e) {
          sw.v[e] = cadd(sw.v[e], tw.v[e]);
          sq.v[e] = cadd(sq.v[e], tq.v[e]);
        }
      }
      finish(p, sw, sq);
    }
  }
  block_sum<R, 3, CW>(a3, red3);
  if (tid == 0)
#pragma unroll
    for (int k = 0; k < 3; ++k) part_a[k] = a3[k];
  cluster.sync();
#pragma unroll
  for (int k = 0; k < 3; ++k) a3[k] = cluster_sum(cluster, part_a + k, ctas);
  const R wn = sqrt(a3[0]);
  const R inv = wn == R(0) ? R(1) : R(1) / wn;
  const cplx<R> alpha = went ? cx<R>(inv * a3[1], inv * a3[2]) : cx<R>(0, 0);

  // rows j, x and r, and the partial |r|^2
  R nr[1] = {0};
  P* Wj = reinterpret_cast<P*>(s.W + ((long long)b * s.m + j) * n + k0);
  P* Qj = reinterpret_cast<P*>(s.Q + ((long long)b * s.m + j) * n + k0);
  for (int p = tid; p < np; p += CT) {
    P a = ws[p], g = qs[p];
#pragma unroll
    for (int e = 0; e < V; ++e) {
      a.v[e] = cx<R>(a.v[e].re * inv, a.v[e].im * inv);
      g.v[e] = cx<R>(g.v[e].re * inv, g.v[e].im * inv);
    }
    Wj[p] = a;
    Qj[p] = g;
    if (went) {
      P xv = xs[p], rv = rs[p];
#pragma unroll
      for (int e = 0; e < V; ++e) {
        xv.v[e] = cadd(xv.v[e], cmul(alpha, g.v[e]));
        rv.v[e] = csub(rv.v[e], cmul(alpha, a.v[e]));
        nr[0] += norm2(rv.v[e]);
      }
      xg[p] = xv;
      rg[p] = rv;
      rs[p] = rv;
    }
  }
  block_sum<R, 1, CW>(nr, red1);
  if (tid == 0) part_b[0] = nr[0];
  cluster.sync();
  const R t = cluster_sum(cluster, part_b, ctas);
  const R rn = went ? sqrt(t) : rn_old;
  const bool g = goes_on(s, b, rn);
  if (s.rz != nullptr) {
    P* zg = reinterpret_cast<P*>(s.rz + base);
    for (int p = tid; p < np; p += CT) zg[p] = g ? rs[p] : zero_pack<R, V>();
  }
  if (rank == 0 && tid == 0) {
    if (went) {
      s.rn[b] = rn;
      s.iters[b] += 1;
    }
    s.go[b] = g ? 1 : 0;
  }
  cluster.sync();  // no CTA leaves while another still reads its partial sums
}

// CTAs of a lane's cluster and its slice length for n elements; the CTAs
// at most (16, or 8 where the card schedules no 16-CTA cluster)
int cluster_ctas(long long n, int cap) {
  long long c = (n + MIN_SLICE - 1) / MIN_SLICE;
  return (int)(c < 1 ? 1 : (c > cap ? cap : c));
}

int slice_of(long long n, int ctas) {
  const long long per = (n + ctas - 1) / ctas;
  return (int)((per + SLICE_ALIGN - 1) / SLICE_ALIGN * SLICE_ALIGN);
}

// row groups of the update at slice S: 4 or 2 where their sums fit in
// shared memory beside w, q, r and x, else 1 (a thread sums all the rows);
// no more groups than rows (the kernel takes min(RG, j), a power of two)
int row_groups(int S, int esize) {
  for (int rg = 4; rg > 1; rg /= 2)
    if ((long long)(4 + 2 * rg) * S * esize <= CLUSTER_SMEM) return rg;
  return 1;
}

size_t cluster_smem(int S, int esize) {
  const int rg = row_groups(S, esize);
  return (size_t)(4 + (rg > 1 ? 2 * rg : 0)) * S * esize;
}

template <typename R, int V>
int set_cluster_attributes() {
  static int rc = -1;  // once per instance
  if (rc < 0) {
    auto kernel = gcr_cluster_step<R, V>;
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         CLUSTER_SMEM);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    rc = (int)e;
  }
  return rc;
}

template <typename R, int V>
cudaLaunchConfig_t cluster_config(int B, int ctas, int S, cudaStream_t st,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)ctas, (unsigned)B);
  cfg.blockDim = dim3(CT);
  cfg.dynamicSmemBytes = cluster_smem(S, (int)sizeof(cplx<R>));
  cfg.stream = st;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)ctas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// how many clusters of `ctas` CTAs (slice S) the card runs at once
template <typename R, int V>
int active_clusters(int ctas, int S) {
  if (set_cluster_attributes<R, V>() != 0) return 0;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = cluster_config<R, V>(1, ctas, S, nullptr, attr);
  int k = 0;
  if (cudaOccupancyMaxActiveClusters(&k, gcr_cluster_step<R, V>, &cfg) != cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  return k;
}

// the CTAs a cluster may have on this card (read once)
int cluster_cap() {
  static int cap = 0;
  if (cap == 0) {
    const int S = slice_of(CLUSTER_MAX * 4096LL, CLUSTER_MAX);
    cap = active_clusters<float, 2>(CLUSTER_MAX, S) > 0 ? CLUSTER_MAX : 8;
  }
  return cap;
}

// whether the cluster design takes (n, m) at all (shared memory, rows)
bool cluster_fits(long long n, int m, int esize) {
  if (m > CLUSTER_ROWS) return false;
  const int ctas = cluster_ctas(n, cluster_cap());
  return (long long)4 * slice_of(n, ctas) * esize <= CLUSTER_SMEM;
}

template <typename R, int V>
int launch_cluster(const Step<R>& s, int B, cudaStream_t st) {
  int rc = set_cluster_attributes<R, V>();
  if (rc != 0) return rc;
  const int ctas = cluster_ctas(s.n, cluster_cap());
  const int S = slice_of(s.n, ctas);
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = cluster_config<R, V>(B, ctas, S, st, attr);
  return (int)cudaLaunchKernelEx(&cfg, gcr_cluster_step<R, V>, s, S,
                                 row_groups(S, (int)sizeof(cplx<R>)));
}

// ---------------------------------------------------------------------------
// grid design: the products, then a persistent update with two barriers
// ---------------------------------------------------------------------------

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ROWS = 8;                // rows of W a products block takes
static_assert(ROWS == WARPS, "the last block of a row group sums a row a warp");
constexpr int DE = 4;                  // products: packs of a thread in a chunk
// update: packs of a thread in a chunk, UE_WIDE from UE_WIDE_N elements on
// (three blocks an SM: a batch-1 16^4 x 12 lane's 384 chunks, one a block),
// else 2 with two rows' loads in flight (four blocks an SM: a batch-1
// 8^4 d 56 lane's 224 chunks, one a block)
constexpr int UE_WIDE = 4;
constexpr long long UE_WIDE_N = 1 << 19;

int packs_of(long long n) { return n >= UE_WIDE_N ? UE_WIDE : 2; }

template <typename R, int V>
__global__ void __launch_bounds__(THREADS)
gcr_dots(const cplx<R>* __restrict__ W, const cplx<R>* __restrict__ w,
         const long long* __restrict__ jp, cplx<R>* __restrict__ H, cplx<R>* __restrict__ h,
         unsigned* __restrict__ tickets, long long n, int m, int nchunk) {
  using P = Pack<R, V>;
  const int j = row_of(jp, m);
  const int c = blockIdx.x, i0 = blockIdx.y * ROWS, b = blockIdx.z;
  if (i0 >= j) return;  // also j = -1; every block of the group alike
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long np = n / V, p0 = (long long)c * (THREADS * DE) + threadIdx.x;
  const P* wl = reinterpret_cast<const P*>(w + (long long)b * n);
  P wv[DE];
#pragma unroll
  for (int e = 0; e < DE; ++e) {
    const long long p = p0 + e * THREADS;
    wv[e] = p < np ? wl[p] : zero_pack<R, V>();
  }
  __shared__ cplx<R> part[WARPS][ROWS];
  __shared__ bool last;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    cplx<R> acc = cx<R>(0, 0);
    const int i = i0 + r;
    if (i < j) {
      const P* row = reinterpret_cast<const P*>(W + ((long long)b * m + i) * n);
#pragma unroll
      for (int e = 0; e < DE; ++e) {
        const long long p = p0 + e * THREADS;
        if (p < np) {
          const P a = row[p];
#pragma unroll
          for (int v = 0; v < V; ++v) acc = cadd(acc, cmulc(a.v[v], wv[e].v[v]));
        }
      }
    }
    acc = warp_sum(acc);
    if (lane == 0) part[warp][r] = acc;
  }
  __syncthreads();
  if (threadIdx.x < ROWS) {
    const int i = i0 + threadIdx.x;
    if (i < j) {
      cplx<R> t = part[0][threadIdx.x];
#pragma unroll
      for (int p = 1; p < WARPS; ++p) t = cadd(t, part[p][threadIdx.x]);
      H[((long long)b * m + i) * nchunk + c] = t;
    }
    __threadfence();
  }
  __syncthreads();
  // the last block of this (row group, lane) sums its rows' chunks in order
  if (threadIdx.x == 0) {
    unsigned* t = tickets + (long long)b * gridDim.y + blockIdx.y;
    last = atomicAdd(t, 1u) == (unsigned)nchunk - 1;
    if (last) *t = 0;  // every block of the group has arrived: ready for the next launch
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int i = i0 + warp;
  if (i < j) {
    const cplx<R>* src = H + ((long long)b * m + i) * nchunk;
    cplx<R> t = cx<R>(0, 0);
    for (int cc = lane; cc < nchunk; cc += 32) t = cadd(t, ldcg(src + cc));
    t = warp_sum(t);
    if (lane == 0) h[(long long)b * m + i] = t;
  }
}

// a barrier of the whole (co-resident) grid: the last block to arrive runs
// finish() and then releases the others; bar[0] counts arrivals, bar[1]
// holds the last barrier released
template <typename F>
__device__ __forceinline__ void grid_barrier(unsigned* bar, unsigned k, F finish) {
  __shared__ bool last;
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(bar, 1u) == k * gridDim.x - 1;
  }
  __syncthreads();
  if (last) {
    __threadfence();
    finish();
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) atomicExch(bar + 1, k);
  } else {
    if (threadIdx.x == 0)
      while (*(volatile unsigned*)(bar + 1) < k) __nanosleep(32);
    __syncthreads();
    __threadfence();
  }
}

template <typename R, int V, int UE>
__global__ void __launch_bounds__(THREADS, UE == UE_WIDE ? 3 : 4)
gcr_update(Step<R> s, const cplx<R>* __restrict__ h, R* __restrict__ part,
           R* __restrict__ lanes, unsigned* __restrict__ bar, int B, int nch) {
  using P = Pack<R, V>;
  constexpr int CH = THREADS * UE;  // packs of a chunk
  constexpr int ROW_UNROLL = UE == UE_WIDE ? 1 : 2;
  const int j = row_of(s.jp, s.m);
  if (j < 0) return;
  const long long n = s.n, np = n / V;
  const int items = B * nch;
  const bool single = items <= (int)gridDim.x;  // a block, one chunk: w', q' stay in registers
  const int tid = threadIdx.x;
  __shared__ cplx<R> hs[MAX_ROWS];
  __shared__ R red3[WARPS][3];
  __shared__ R red1[WARPS][1];
  P a[UE], g[UE];
  int hb = -1;  // the lane whose h hs holds

  // w', q' and the partial |w'|^2, <w', r> of every chunk
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int b = it / nch, c = it % nch;
    if (b != hb) {
      __syncthreads();
      for (int i = tid; i < j; i += THREADS) hs[i] = h[(long long)b * s.m + i];
      __syncthreads();
      hb = b;
    }
    const long long p0 = (long long)c * CH + tid;
    const P* wl = reinterpret_cast<const P*>(s.w + (long long)b * n);
    const P* ql = reinterpret_cast<const P*>(s.q + (long long)b * n);
#pragma unroll
    for (int u = 0; u < UE; ++u) {
      const long long p = p0 + (long long)u * THREADS;
      a[u] = p < np ? wl[p] : zero_pack<R, V>();
      g[u] = p < np ? ql[p] : zero_pack<R, V>();
    }
    const long long lane0 = (long long)b * s.m * n;
#pragma unroll ROW_UNROLL
    for (int i = 0; i < j; ++i) {
      const P* Wr = reinterpret_cast<const P*>(s.W + lane0 + (long long)i * n);
      const P* Qr = reinterpret_cast<const P*>(s.Q + lane0 + (long long)i * n);
      P wa[UE], qa[UE];
#pragma unroll
      for (int u = 0; u < UE; ++u) {
        const long long p = p0 + (long long)u * THREADS;
        wa[u] = p < np ? Wr[p] : zero_pack<R, V>();
        qa[u] = p < np ? Qr[p] : zero_pack<R, V>();
      }
      const cplx<R> hi = hs[i];
#pragma unroll
      for (int u = 0; u < UE; ++u)
#pragma unroll
        for (int e = 0; e < V; ++e) {
          a[u].v[e] = csub(a[u].v[e], cmul(hi, wa[u].v[e]));
          g[u].v[e] = csub(g[u].v[e], cmul(hi, qa[u].v[e]));
        }
    }
    R a3[3] = {0, 0, 0};
    P* Wj = reinterpret_cast<P*>(s.W + lane0 + (long long)j * n);
    P* Qj = reinterpret_cast<P*>(s.Q + lane0 + (long long)j * n);
    const P* rl = reinterpret_cast<const P*>(s.r + (long long)b * n);
#pragma unroll
    for (int u = 0; u < UE; ++u) {
      const long long p = p0 + (long long)u * THREADS;
      if (p < np) {
        if (!single) {  // unscaled, read back after the barrier by this thread
          Wj[p] = a[u];
          Qj[p] = g[u];
        }
        const P rv = rl[p];
#pragma unroll
        for (int e = 0; e < V; ++e) {
          a3[0] += norm2(a[u].v[e]);
          const cplx<R> d = cmulc(a[u].v[e], rv.v[e]);
          a3[1] += d.re;
          a3[2] += d.im;
        }
      }
    }
    block_sum<R, 3, WARPS>(a3, red3);
    if (tid == 0)
#pragma unroll
      for (int k = 0; k < 3; ++k) part[(long long)it * 4 + k] = a3[k];
  }

  // s and alpha of every lane: a warp a lane, its chunks in order
  grid_barrier(bar, 1, [&] {
    const int lane = tid & 31, warp = tid >> 5;
    for (int b = warp; b < B; b += WARPS) {
      R t[3] = {0, 0, 0};
      for (int c = lane; c < nch; c += 32)
#pragma unroll
        for (int k = 0; k < 3; ++k) t[k] += ldcg(part + ((long long)b * nch + c) * 4 + k);
#pragma unroll
      for (int k = 0; k < 3; ++k) t[k] = warp_sum(t[k]);
      if (lane == 0) {
        const R wn = sqrt(t[0]);
        const R inv = wn == R(0) ? R(1) : R(1) / wn;
        const bool went = s.go[b] != 0;
        lanes[b * 4 + 0] = inv;
        lanes[b * 4 + 1] = went ? inv * t[1] : R(0);
        lanes[b * 4 + 2] = went ? inv * t[2] : R(0);
      }
    }
  });

  // rows j, x, r and the partial |r|^2, the chunks in reverse (the latest
  // written, likeliest in L2, first)
  const int mine =
      (int)blockIdx.x < items ? (items - 1 - (int)blockIdx.x) / (int)gridDim.x : -1;
  for (int k = mine; k >= 0; --k) {
    const int it = (int)blockIdx.x + k * (int)gridDim.x;
    const int b = it / nch, c = it % nch;
    const R inv = ldcg(lanes + b * 4);
    const cplx<R> alpha = cx<R>(ldcg(lanes + b * 4 + 1), ldcg(lanes + b * 4 + 2));
    const bool went = s.go[b] != 0;  // written only after the second barrier
    const long long p0 = (long long)c * CH + tid;
    const long long lane0 = (long long)b * s.m * n;
    P* Wj = reinterpret_cast<P*>(s.W + lane0 + (long long)j * n);
    P* Qj = reinterpret_cast<P*>(s.Q + lane0 + (long long)j * n);
    P* xl = reinterpret_cast<P*>(s.x + (long long)b * n);
    P* rl = reinterpret_cast<P*>(s.r + (long long)b * n);
    R nr[1] = {0};
#pragma unroll
    for (int u = 0; u < UE; ++u) {
      const long long p = p0 + (long long)u * THREADS;
      if (p < np) {
        P av = single ? a[u] : Wj[p], gv = single ? g[u] : Qj[p];
#pragma unroll
        for (int e = 0; e < V; ++e) {
          av.v[e] = cx<R>(av.v[e].re * inv, av.v[e].im * inv);
          gv.v[e] = cx<R>(gv.v[e].re * inv, gv.v[e].im * inv);
        }
        Wj[p] = av;
        Qj[p] = gv;
        if (went) {
          P xv = xl[p], rv = rl[p];
#pragma unroll
          for (int e = 0; e < V; ++e) {
            xv.v[e] = cadd(xv.v[e], cmul(alpha, gv.v[e]));
            rv.v[e] = csub(rv.v[e], cmul(alpha, av.v[e]));
            nr[0] += norm2(rv.v[e]);
          }
          xl[p] = xv;
          rl[p] = rv;
        }
      }
    }
    block_sum<R, 1, WARPS>(nr, red1);
    if (tid == 0) part[(long long)it * 4 + 3] = nr[0];
  }

  // rn, iters and go of every lane
  grid_barrier(bar, 2, [&] {
    const int lane = tid & 31, warp = tid >> 5;
    for (int b = warp; b < B; b += WARPS) {
      R t = 0;
      for (int c = lane; c < nch; c += 32) t += ldcg(part + ((long long)b * nch + c) * 4 + 3);
      t = warp_sum(t);
      if (lane == 0) {
        const bool went = s.go[b] != 0;
        const R rn = went ? sqrt(t) : s.rn[b];
        if (went) {
          s.rn[b] = rn;
          s.iters[b] += 1;
        }
        s.go[b] = goes_on(s, b, rn) ? 1 : 0;
      }
    }
  });

  if (s.rz != nullptr) {
    for (int it = blockIdx.x; it < items; it += gridDim.x) {
      const int b = it / nch, c = it % nch;
      const bool gb = __ldcg(reinterpret_cast<const unsigned char*>(s.go + b)) != 0;
      const P* rl = reinterpret_cast<const P*>(s.r + (long long)b * n);
      P* zl = reinterpret_cast<P*>(s.rz + (long long)b * n);
#pragma unroll
      for (int u = 0; u < UE; ++u) {
        const long long p = (long long)c * CH + tid + (long long)u * THREADS;
        if (p < np) zl[p] = gb ? rl[p] : zero_pack<R, V>();
      }
    }
  }
  // the last block out resets the barrier for the next launch
  __syncthreads();
  if (tid == 0 && atomicAdd(bar, 1u) == 3u * gridDim.x - 1) {
    bar[1] = 0;
    __threadfence();
    bar[0] = 0;
  }
}

int dot_chunks(long long n, int V) {
  const long long chunk = (long long)THREADS * DE * V;
  return (int)((n + chunk - 1) / chunk);
}

int update_chunks(long long n, int V) {
  const long long chunk = (long long)THREADS * packs_of(n) * V;
  return (int)((n + chunk - 1) / chunk);
}

// the scratch of the grid design, in one byte buffer: H [B, m, dot chunks],
// h [B, m] (complex), the partial sums [B, update chunks, 4] and the lanes'
// s, alpha [B, 4] (real)
struct Layout {
  long long H, h, part, lanes, bytes;
};

Layout layout(int B, int m, long long n, int esize, int V) {
  auto up = [](long long v) { return (v + 255) / 256 * 256; };
  Layout L;
  L.H = 0;
  L.h = up(L.H + (long long)B * m * dot_chunks(n, V) * esize);
  L.part = up(L.h + (long long)B * m * esize);
  L.lanes = up(L.part + (long long)B * update_chunks(n, V) * 4 * (esize / 2));
  L.bytes = up(L.lanes + (long long)B * 4 * (esize / 2));
  return L;
}

template <typename R, int V, int UE>
int update_grid(int items) {
  static int cap = 0;  // blocks the card holds at once (once per instance)
  if (cap == 0) {
    int per_sm = 0;
    cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, gcr_update<R, V, UE>, THREADS, 0);
    if (e != cudaSuccess || per_sm < 1) return -1;
    cap = per_sm * num_sms();
  }
  return items < cap ? items : cap;
}

template <typename R, int V, int UE>
int launch_update(const Step<R>& s, const cplx<R>* h, R* part, R* lanes, unsigned* bar, int B,
                  int nch, cudaStream_t st) {
  const int grid = update_grid<R, V, UE>(B * nch);
  if (grid < 1) return (int)cudaErrorInvalidConfiguration;
  // every block must be resident at once (the barriers): a cooperative launch
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)grid);
  cfg.blockDim = dim3(THREADS);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, gcr_update<R, V, UE>, s, h, part, lanes, bar, B, nch);
}

template <typename R, int V>
int launch_grid(const Step<R>& s, int B, void* work, unsigned* sync, cudaStream_t st) {
  using C = cplx<R>;
  const Layout L = layout(B, s.m, s.n, (int)sizeof(C), V);
  unsigned char* base = static_cast<unsigned char*>(work);
  C* H = reinterpret_cast<C*>(base + L.H);
  C* h = reinterpret_cast<C*>(base + L.h);
  R* part = reinterpret_cast<R*>(base + L.part);
  R* lanes = reinterpret_cast<R*>(base + L.lanes);
  unsigned* bar = sync;           // [2]
  unsigned* tickets = sync + 2;   // [B, row groups]
  const int nchunk = dot_chunks(s.n, V);
  const dim3 dg((unsigned)nchunk, (unsigned)((s.m + ROWS - 1) / ROWS), (unsigned)B);
  gcr_dots<R, V><<<dg, THREADS, 0, st>>>(s.W, s.w, s.jp, H, h, tickets, s.n, s.m, nchunk);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int nch = update_chunks(s.n, V);
  if (packs_of(s.n) == UE_WIDE)
    return launch_update<R, V, UE_WIDE>(s, h, part, lanes, bar, B, nch, st);
  return launch_update<R, V, 2>(s, h, part, lanes, bar, B, nch, st);
}

// ---------------------------------------------------------------------------

// complex numbers of one load: pairs of complex64 where n is even
template <typename R>
int pack_of(long long n) {
  return (sizeof(R) == 4 && n % 2 == 0) ? 2 : 1;
}

// 0: the cluster design, 1: the grid design (module note)
// the crossover (scripts/probe_torch_gcr.py's sweep on an H100): the
// cluster design was faster at n = 14,336 at batch 1 and 12, j = 10 and
// 50; the grid design at 28,672 in three of the four
constexpr long long CLUSTER_MAX_N = 16384;

int default_path(long long n, int m, int esize) {
  return (n <= CLUSTER_MAX_N && cluster_fits(n, m, esize)) ? 0 : 1;
}

bool aligned(const void* p, int bytes) { return reinterpret_cast<uintptr_t>(p) % bytes == 0; }

template <typename R>
int dispatch(void* W, void* Q, const void* j, const void* w, const void* q, void* x, void* r,
             void* rz, void* go, const void* stop, const void* active, void* rn, void* iters,
             void* work, void* sync, int B, int m, long long n, int path, void* stream) {
  if (B < 1 || B > 65535 || m < 1 || m > MAX_ROWS || n < 1) return (int)cudaErrorInvalidValue;
  const int esize = (int)sizeof(cplx<R>);
  if (path < 0) path = default_path(n, m, esize);
  if (path == 0 && !cluster_fits(n, m, esize)) return (int)cudaErrorInvalidValue;
  if (path == 1 && (work == nullptr || sync == nullptr)) return (int)cudaErrorInvalidValue;
  const int V = pack_of<R>(n);
  for (const void* p : {(const void*)W, (const void*)Q, w, q, (const void*)x, (const void*)r,
                        (const void*)rz})
    if (p != nullptr && !aligned(p, V * esize)) return (int)cudaErrorMisalignedAddress;
  Step<R> s;
  s.W = (cplx<R>*)W;
  s.Q = (cplx<R>*)Q;
  s.jp = (const long long*)j;
  s.w = (const cplx<R>*)w;
  s.q = (const cplx<R>*)q;
  s.x = (cplx<R>*)x;
  s.r = (cplx<R>*)r;
  s.rz = (cplx<R>*)rz;
  s.go = (unsigned char*)go;
  s.stop = (const R*)stop;
  s.active = (const unsigned char*)active;
  s.rn = (R*)rn;
  s.iters = (long long*)iters;
  s.n = n;
  s.m = m;
  auto st = (cudaStream_t)stream;
  if constexpr (sizeof(R) == 4) {  // pairs of complex64 where n is even
    if (V == 2)
      return path == 0 ? launch_cluster<R, 2>(s, B, st)
                       : launch_grid<R, 2>(s, B, work, (unsigned*)sync, st);
  }
  return path == 0 ? launch_cluster<R, 1>(s, B, st)
                   : launch_grid<R, 1>(s, B, work, (unsigned*)sync, st);
}

}  // namespace

extern "C" {

// the design K7 takes for n elements a lane and m rows, complex64 (c128 0)
// or complex128 (1): 0 the cluster, 1 the grid design
int ddaamg_gcr_path(long long n, int m, int c128) {
  return default_path(n, m, c128 ? 16 : 8);
}

// whether the cluster design takes (n, m) (shared memory, rows)
int ddaamg_gcr_cluster_fits(long long n, int m, int c128) {
  return cluster_fits(n, m, c128 ? 16 : 8) ? 1 : 0;
}

// the cluster design at n: CTAs a cluster, slice length, and how many such
// clusters the card runs at once (complex64)
int ddaamg_gcr_cluster_shape(long long n, int* ctas, int* slice, int* active) {
  *ctas = cluster_ctas(n, cluster_cap());
  *slice = slice_of(n, *ctas);
  *active = pack_of<float>(n) == 2 ? active_clusters<float, 2>(*ctas, *slice)
                                   : active_clusters<float, 1>(*ctas, *slice);
  return 0;
}

// bytes of the grid design's scratch and its zeroed counters (unsigned)
long long ddaamg_gcr_work_bytes(int B, int m, long long n, int c128) {
  return c128 ? layout(B, m, n, 16, pack_of<double>(n)).bytes
              : layout(B, m, n, 8, pack_of<float>(n)).bytes;
}

int ddaamg_gcr_sync_words(int B, int m) { return 2 + B * ((m + ROWS - 1) / ROWS); }

// K7 on W, Q [B, m, n], w, q, x, r, rz [B, n] (rz may be null), go [B]
// (bool), stop, rn [B] (real), active [B] (bool, may be null), iters [B]
// (int64), j a device int64; work / sync: the grid design's scratch
// (zeroed counters, left zero); path -1 by n, 0 cluster, 1 grid
int ddaamg_gcr_step_c64(void* W, void* Q, const void* j, const void* w, const void* q, void* x,
                        void* r, void* rz, void* go, const void* stop, const void* active,
                        void* rn, void* iters, void* work, void* sync, int B, int m,
                        long long n, int path, void* stream) {
  return dispatch<float>(W, Q, j, w, q, x, r, rz, go, stop, active, rn, iters, work, sync, B, m,
                         n, path, stream);
}

int ddaamg_gcr_step_c128(void* W, void* Q, const void* j, const void* w, const void* q, void* x,
                         void* r, void* rz, void* go, const void* stop, const void* active,
                         void* rn, void* iters, void* work, void* sync, int B, int m,
                         long long n, int path, void* stream) {
  return dispatch<double>(W, Q, j, w, q, x, r, rz, go, stop, active, rn, iters, work, sync, B,
                          m, n, path, stream);
}

}  // extern "C"
