// K6: batched complex matvec with a bf16-stored matrix, for Hopper (sm_90a).
//
//   y[r, b, i] = sum_j A[b, i, j] x[r, b, j]   for the listed blocks b,
//   y[r, b, :] = 0                              for the others,
//
// A [nb, m, m] stored as bf16 (re, im) pairs (4 bytes an entry, row-major),
// x and y [R, nb, m] complex64.  Serves the two stored inverses of the
// multigrid hierarchy: the coarsest level's dense Schur-complement inverse
// (nb = 1, m = n / 2: 7168 at rough16) and the depth-1 Schwarz block
// inverses (nb = 256 blocks of m = 16 * 56 = 896).  In the JAX package both
// products are XLA einsums (operators/stencil.py:710 and :727,
// smoothers/sap.py:193) that widen the bf16 storage to f32 at multiply time;
// no Pallas kernel exists for them.
//
// The block list.  A Schwarz colour step multiplies a field that is zero
// outside the colour's blocks, so the launchers take the sorted list of the
// nc blocks to compute (blocks = nullptr: all nb); only those blocks of A
// and x are read and only their rows of y written.  The wrapper zeroes y
// beforehand when the list is not all blocks.
//
// Batch 1 (dense_bf16_kernel): bound by memory, in the matrix.  Every entry
// is read once and used once (8 flop per 4-byte entry), so the least time is
// the listed blocks' bytes over 3.35 TB/s: 205 MB (61 us) for the Schur
// inverse, 411 MB (123 us) for one red-black colour of the block inverses.
// One warp per output row; the grid runs over the nc * m listed rows, row j
// being row j % m of block blocks[j / m].  Each lane reads 16 bytes (four
// consecutive entries) per step, so a warp reads 512 consecutive bytes of
// the row per step; entries are widened exactly (a bf16 is the upper half of
// an f32) and multiplied in f32 against x, read through the read-only
// cache.  Each lane sums its entries in a fixed order and the lanes meet in
// a fixed butterfly, so a row's bits do not depend on the list or on
// scheduling.  Rows are 16-byte aligned only when m is a multiple of 4; for
// any other m (an odd test-vector count) the launcher takes
// dense_bf16_rows_kernel, the same design with one 4-byte entry per lane and
// step.
//
// 2 <= R <= MRHS_MAX right-hand sides (dense_bf16_mma_kernel): A is read
// once for all R, on the tensor cores.  The stored block is a real
// row-major [m, 2m] bf16 matrix, A_int[i, 2k] = Re A_ik, A_int[i, 2k+1] =
// Im A_ik: the mma's A operand as it lies in memory.  Its B operand has two
// columns a right-hand side: [xr_k, -xi_k] interleaved gives Re y,
// [xi_k, xr_k] gives Im y.  x is f32, so every value is split exactly into
// three bf16 parts, v1 = RN(v), v2 = RN(v - v1), v3 = v - v1 - v2: each
// rounding leaves a remainder of at most 16, then 8 significant bits, so v3
// is exact and v1 + v2 + v3 == v for 2^-110 < |v| < 2^127 (below, v3 falls
// into bf16's subnormals and loses bits; above, v1 rounds to infinity).  A
// bf16 times a bf16 part is exact in the f32 accumulator, and the three
// parts' sums are added in a fixed order, (S3 + S2) + S1, in the epilogue:
// the result differs from an f32 FMA product only in the order of summation
// and the tensor core's f32 accumulation.  The GEMM is [rows, 2m] x [2m, N]
// with N = 2 * 3 * R columns (72 at R = 12), padded to NT tiles of 8.
// Bound: A's bytes (the listed blocks: 822 MB, 245 us for all 256 block
// inverses) against 3 * 8 nb m^2 R operations at 989 TFLOP/s (60 us at R =
// 12): memory again.  It stays short of that bound by what it issues:
// mma.sync reaches about half of the tensor cores' wgmma rate on three times
// the operations, and every tile of rows splits its B operand anew (PERF.md
// has the measured share).  Design: mma.sync m16n8k16 bf16 -> f32, fragments by
// ldmatrix from shared memory.  Each block of threads takes TM rows of one
// block b; A's [TM, 32-entry] tiles stream through a ring of STAGES shared
// memory stages, each filled by one TMA copy of a 2D box (a tensor map of A
// as [nb m, m] 4-byte entries, 128-byte swizzle, zeros past m) that
// completes on the stage's mbarrier; the 128 threads build the split B tile
// of the next 32 columns (both column forms, three parts, from x held in
// registers since the chunk before) in a second, double-buffered region
// while the warps multiply the current one.  The swizzle (A) and rows of 144
// bytes (B) keep ldmatrix free of bank conflicts.  Each of the four warps
// keeps 2 x NT mma tiles of f32 accumulators (32 rows x N columns), so a
// block of threads computes a tile of TM = 128 rows.  With fewer than two
// tiles an SM (the Schur inverse: 56 tiles for 132 SMs; one of sixteen
// colours: 112) a cluster of up to MAX_CS blocks splits each tile's k range,
// and block q adds its TM / cs rows of the tile over the cluster's partial
// sums in rank order, read from their shared memory.  No atomics: two
// launches give the same bits, and a right-hand side's bits do not depend on
// R or on its neighbours (each output column of an mma is its own dot
// product).  Rows not 16-byte aligned (m % 4 != 0) are staged by 4-byte
// loads of the threads into the same swizzled layout instead.
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>

#include <cooperative_groups.h>
#include <cstdint>

#include "common.cuh"

namespace cg = cooperative_groups;

constexpr int WARPS = 8;  // rows (warps) per thread block of the batch-1 kernels

__device__ __forceinline__ float bf16_lo(unsigned int w) {
  return __uint_as_float(w << 16);
}

__device__ __forceinline__ float bf16_hi(unsigned int w) {
  return __uint_as_float(w & 0xffff0000u);
}

// the warp's lanes meet in a fixed butterfly; lane 0 writes y[row]
__device__ __forceinline__ void warp_store(cplx<float>* y, long long row, float re, float im) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    re += __shfl_xor_sync(0xffffffffu, re, off);
    im += __shfl_xor_sync(0xffffffffu, im, off);
  }
  if (threadIdx.x == 0) y[row] = cx<float>(re, im);
}

// listed row j (of nc * m) -> row b * m + i of the whole batch
__device__ __forceinline__ long long listed_row(long long j, const int* blocks, int m) {
  return blocks == nullptr ? j : (long long)blocks[j / m] * m + j % m;
}

__global__ void __launch_bounds__(32 * WARPS)
    dense_bf16_kernel(cplx<float>* __restrict__ y, const float2* __restrict__ x, const uint4* __restrict__ A,
                      const int* __restrict__ blocks, int nc, int m) {
  long long j = (long long)blockIdx.x * WARPS + threadIdx.y;
  if (j >= (long long)nc * m) return;
  const long long row = listed_row(j, blocks, m);  // b * m + i
  int lane = threadIdx.x;
  long long b = row / m;
  const float2* xb = x + b * m;
  const uint4* Ar = A + row * (m / 4);  // four (re, im) pairs per uint4
  float re = 0.f, im = 0.f;
  for (int q = lane; q < m / 4; q += 32) {
    uint4 w = __ldg(Ar + q);
    const unsigned int pair[4] = {w.x, w.y, w.z, w.w};  // (re, im): re in the low half
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float2 xv = __ldg(xb + 4 * q + e);
      float ar = bf16_lo(pair[e]), ai = bf16_hi(pair[e]);
      re += ar * xv.x - ai * xv.y;
      im += ar * xv.y + ai * xv.x;
    }
  }
  warp_store(y, row, re, im);
}

// K6 for rows of any length m: 4-byte loads, 128 bytes per warp and step
__global__ void __launch_bounds__(32 * WARPS)
    dense_bf16_rows_kernel(cplx<float>* __restrict__ y, const float2* __restrict__ x,
                           const unsigned int* __restrict__ A, const int* __restrict__ blocks, int nc, int m) {
  long long j = (long long)blockIdx.x * WARPS + threadIdx.y;
  if (j >= (long long)nc * m) return;
  const long long row = listed_row(j, blocks, m);
  const float2* xb = x + row / m * m;
  const unsigned int* Ar = A + row * m;
  float re = 0.f, im = 0.f;
  for (int q = threadIdx.x; q < m; q += 32) {
    const unsigned int w = __ldg(Ar + q);
    const float2 xv = __ldg(xb + q);
    const float ar = bf16_lo(w), ai = bf16_hi(w);
    re += ar * xv.x - ai * xv.y;
    im += ar * xv.y + ai * xv.x;
  }
  warp_store(y, row, re, im);
}

// ---------------------------------------------------------------------------
// the tensor-core kernel over 2 <= R <= MRHS_MAX right-hand sides
// ---------------------------------------------------------------------------

constexpr int MRHS_MAX = 12;  // right-hand sides of one launch
constexpr int KC = 32;        // complex columns of A a stage holds (128 bytes of a row)
constexpr int LD = 2 * KC + 8;  // shared row stride in bf16 (144 bytes)
constexpr int MMA_THREADS = 128;  // four warps
constexpr int XPT = (MRHS_MAX * KC + MMA_THREADS - 1) / MMA_THREADS;  // x values a thread splits a chunk

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void bar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(bytes)
               : "memory");
}

// wait until the phase of the given parity has completed
__device__ __forceinline__ void bar_wait(uint64_t* bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// one [rows, KC] box of A (the tensor map's 2D view of A, [nb m, m] 4-byte
// entries) at column col and row row, into shared memory in the 128-byte
// swizzle (swz), completing on bar
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int col, int row, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(
          smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(smem_addr(bar))
      : "memory");
}

// byte offset of 16-byte chunk c of row r in a stage of 128-byte rows: the
// 128-byte swizzle puts it at chunk c ^ (r % 8), so the eight rows an
// ldmatrix reads at one chunk fall in eight different banks
__device__ __forceinline__ int swz(int r, int c) { return r * 128 + ((c ^ (r & 7)) << 4); }

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t& r0, uint32_t& r1, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n" : "=r"(r0), "=r"(r1) : "r"(smem_addr(p)));
}

// d += a b: a 16 x 16 bf16 (row), b 16 x 8 bf16 (col), d 16 x 8 f32
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the parts of v = (re, im) as bf16 pairs (re in the low half), v = p[0] +
// p[1] + p[2] exactly in each half (see the note at the top for the range)
__device__ __forceinline__ void split3(float2 v, uint32_t (&p)[3]) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v.x, v.y);
    p[k] = *reinterpret_cast<const uint32_t*>(&h);
    v.x -= __uint_as_float(p[k] << 16);
    v.y -= __uint_as_float(p[k] & 0xffff0000u);
  }
}

constexpr int TM = 128;     // rows a block of threads computes: 32 a warp (two m16 tiles)
constexpr int STAGES = 3;   // stages of A's ring
constexpr int MAX_CS = 4;   // blocks of a cluster that split one tile's k range
constexpr int MIN_CHUNKS = 8;  // chunks a block of such a cluster takes at least

// shared memory: 1024 bytes to align the ring, the ring of A's stages
// [STAGES][TM][128 bytes] (the epilogue's partial sums [TM][N + 1] f32 reuse
// it), B's two buffers [2][N][LD] bf16, an mbarrier a stage
template <int NT>
__host__ __device__ constexpr size_t mma_ring() {
  constexpr size_t ring = (size_t)STAGES * TM * 128;
  constexpr size_t epi = (size_t)TM * (8 * NT + 1) * 4;
  return ring > epi ? ring : epi;
}

template <int NT>
__host__ __device__ constexpr size_t mma_smem() {
  return 1024 + mma_ring<NT>() + (size_t)2 * 8 * NT * LD * 2 + STAGES * 8;
}

// grid (row tiles of TM x cs, nc listed blocks) in clusters of cs blocks,
// block q of a cluster taking chunks [nchunks q / cs, nchunks (q + 1) / cs)
// of the tile's k range; 128 threads.  bulk: A's rows are 16-byte aligned
// (m % 4 == 0) and tmap maps it: stages come by TMA; otherwise the threads
// stage them by 4-byte loads into the same layout
template <int NT>
__global__ void __launch_bounds__(MMA_THREADS)
    dense_bf16_mma_kernel(const __grid_constant__ CUtensorMap tmap, float2* __restrict__ y,
                          const float2* __restrict__ x, const uint32_t* __restrict__ A,
                          const int* __restrict__ blocks, int nb, int m, int nr, int cs, bool bulk) {
  constexpr int N = 8 * NT, EPS = N + 1;
  constexpr size_t RING = mma_ring<NT>();
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* ring = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);  // [STAGES][TM][128 B]
  uint16_t* Bs = reinterpret_cast<uint16_t*>(ring + RING);                           // [2][N][LD]
  uint64_t* bar = reinterpret_cast<uint64_t*>(ring + RING + (size_t)2 * N * LD * 2);  // [STAGES]
  float* epi = reinterpret_cast<float*>(ring);                       // [TM][EPS], after the loop
  cg::cluster_group cluster = cg::this_cluster();

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q = (int)cluster.block_rank();
  const int b = blocks == nullptr ? (int)blockIdx.y : blocks[blockIdx.y];
  const int row0 = (blockIdx.x / cs) * TM;
  const int rows = min(TM, m - row0);
  const int nchunks = (m + KC - 1) / KC;
  const int c0 = nchunks * q / cs, nc_own = nchunks * (q + 1) / cs - c0;  // this block's chunks
  const long long vstride = (long long)nb * m;  // one right-hand side to the next
  const uint32_t* Ab = A + ((long long)b * m + row0) * m;  // row r of the tile at Ab + r * m
  const float2* xb = x + (long long)b * m;

  // B's padding columns stay zero
  for (int e = tid; e < N * LD; e += MMA_THREADS) reinterpret_cast<uint32_t*>(Bs)[e] = 0;
  if (tid == 0)
    for (int s = 0; s < STAGES; ++s) bar_init(bar + s, 1);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  __syncthreads();

  // own chunk i (columns (c0 + i) KC ..., zero past m) into stage i %
  // STAGES; TMA fills rows and columns outside A with zeros
  auto issue = [&](int i) {
    const int st = i % STAGES, col = (c0 + i) * KC;
    unsigned char* dst = ring + st * TM * 128;
    if (bulk) {
      if (tid == 0) {
        bar_arrive_tx(bar + st, TM * 128);
        tma_load(dst, &tmap, col, b * m + row0, bar + st);
      }
    } else {  // visible to all after the __syncthreads that precede its use
      for (int e = tid; e < TM * KC; e += MMA_THREADS) {
        const int r = e / KC, qq = e % KC, k = col + qq;
        *reinterpret_cast<uint32_t*>(dst + swz(r, qq >> 2) + (qq & 3) * 4) =
            (r < rows && k < m) ? __ldg(Ab + (long long)r * m + k) : 0u;
      }
      if (tid == 0) bar_arrive(bar + st);
    }
  };

  float2 xv[XPT];
  auto load_x = [&](int i) {  // x[r, b, (c0 + i) KC + kk], zero past m
#pragma unroll
    for (int j = 0; j < XPT; ++j) {
      const int idx = tid + j * MMA_THREADS, r = idx / KC, k = (c0 + i) * KC + idx % KC;
      xv[j] = (idx < nr * KC && k < m) ? __ldg(xb + r * vstride + k) : make_float2(0.f, 0.f);
    }
  };
  auto build_b = [&](int buf) {  // the split B tile of the chunk in xv
#pragma unroll
    for (int j = 0; j < XPT; ++j) {
      const int idx = tid + j * MMA_THREADS, r = idx / KC, kk = idx % KC;
      if (idx >= nr * KC) continue;
      uint32_t part[3];
      split3(xv[j], part);
#pragma unroll
      for (int p = 0; p < 3; ++p) {
        uint32_t* col = reinterpret_cast<uint32_t*>(Bs + (buf * N + (3 * r + p) * 2) * LD) + kk;
        col[0] = part[p] ^ 0x80000000u;                 // Re y: [xr, -xi]
        col[LD / 2] = __byte_perm(part[p], 0, 0x1032);  // Im y: [xi, xr]
      }
    }
  };

  float acc[2][NT][4];
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int j = 0; j < NT; ++j) acc[t][j][0] = acc[t][j][1] = acc[t][j][2] = acc[t][j][3] = 0.f;

  for (int i = 0; i < STAGES && i < nc_own; ++i) issue(i);
  if (nc_own > 0) {
    load_x(0);
    build_b(0);
    if (nc_own > 1) load_x(1);
  }
  __syncthreads();

  for (int i = 0; i < nc_own; ++i) {
    bar_wait(bar + i % STAGES, (i / STAGES) & 1);
    const unsigned char* a_st = ring + (i % STAGES) * TM * 128;
    const uint16_t* b_st = Bs + (i & 1) * N * LD;
    const int steps = (min(KC, m - (c0 + i) * KC) + 7) / 8;  // k steps of 8 complex columns with data
    for (int kstep = 0; kstep < steps; ++kstep) {
      uint32_t a[2][4];
#pragma unroll
      for (int t = 0; t < 2; ++t)
        ldmatrix_x4(a[t], a_st + swz(warp * 32 + t * 16 + (lane & 15), kstep * 2 + (lane >> 4)));
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t bf[4];
        if (j + 1 < NT) {
          ldmatrix_x4(bf, b_st + ((j + (lane >> 4)) * 8 + (lane & 7)) * LD + kstep * 16 + ((lane >> 3) & 1) * 8);
        } else {
          ldmatrix_x2(bf[0], bf[1], b_st + (j * 8 + (lane & 7)) * LD + kstep * 16 + ((lane >> 3) & 1) * 8);
        }
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          mma_bf16(acc[t][j], a[t], bf[0], bf[1]);
          if (j + 1 < NT) mma_bf16(acc[t][j + 1], a[t], bf[2], bf[3]);
        }
      }
    }
    if (i + 1 < nc_own) {
      build_b((i + 1) & 1);
      if (i + 2 < nc_own) load_x(i + 2);
    }
    __syncthreads();  // every warp is done with stage i % STAGES and B buffer i & 1
    if (i + STAGES < nc_own) issue(i + STAGES);
  }

  // epilogue: partial sums to shared memory; block q of the cluster then
  // adds rows [TM q / cs, TM (q + 1) / cs) over the cluster's blocks in rank
  // order, and y = (S3 + S2) + S1 per right-hand side
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float* e = epi + (warp * 32 + t * 16 + g + 8 * h) * EPS + j * 8 + 2 * t4;
        e[0] = acc[t][j][2 * h];
        e[1] = acc[t][j][2 * h + 1];
      }
  cluster.sync();
  const int rq = TM * q / cs, nrq = TM * (q + 1) / cs - rq;
  for (int idx = tid; idx < nr * nrq; idx += MMA_THREADS) {
    const int r = idx / nrq, row = rq + idx % nrq;
    if (row >= rows) continue;
    float v[MAX_CS][6];  // all loads first, then the sums in rank order
#pragma unroll
    for (int w = 0; w < MAX_CS; ++w)
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        float* e = epi + row * EPS + 6 * r + k;  // part k / 2, re or im
        v[w][k] = w >= cs ? 0.f : cs == 1 ? *e : *cluster.map_shared_rank(e, w);
      }
    float sum[6];
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      sum[k] = v[0][k];
#pragma unroll
      for (int w = 1; w < MAX_CS; ++w)
        if (w < cs) sum[k] += v[w][k];
    }
    y[r * vstride + (long long)b * m + row0 + row] =
        make_float2((sum[4] + sum[2]) + sum[0], (sum[5] + sum[3]) + sum[1]);
  }
  cluster.sync();  // no block leaves while another still reads its partial sums
}

// cuTensorMapEncodeTiled of libcuda, looked up through the runtime (no link to libcuda)
static PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = (PFN_cuTensorMapEncodeTiled_v12000)p;
  }
  return fn;
}

// A as a 2D tensor of 4-byte entries [nb m rows, m columns], boxes of
// [rows, KC] in the 128-byte swizzle, zeros outside
static int make_tensor_map(CUtensorMap* map, const void* A, int nb, int m, int rows) {
  auto encode = tensor_map_encoder();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  cuuint64_t dims[2] = {(cuuint64_t)m, (cuuint64_t)nb * m};
  cuuint64_t strides[1] = {(cuuint64_t)m * 4};
  cuuint32_t box[2] = {(cuuint32_t)KC, (cuuint32_t)rows};
  cuuint32_t elem[2] = {1, 1};
  CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT32, 2, const_cast<void*>(A), dims, strides, box, elem,
                      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int NT>
static int launch_mma(float2* y, const float2* x, const uint32_t* A, const int* blocks, int nb, int m, int nr,
                      int nc, bool bulk, cudaStream_t stream) {
  constexpr size_t smem = mma_smem<NT>();
  auto kernel = dense_bf16_mma_kernel<NT>;
  static bool ready = false;  // once per instance: shared memory above 48 KB
  if (!ready) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    ready = true;
  }
  CUtensorMap tmap{};
  if (bulk) {
    const int rc = make_tensor_map(&tmap, A, nb, m, TM);
    if (rc != 0) return rc;
  }
  // fewer than two blocks of threads an SM: split each tile's k range over
  // a cluster of up to MAX_CS blocks, each keeping at least MIN_CHUNKS chunks
  const long long tiles = (long long)nc * ((m + TM - 1) / TM);
  const int nchunks = (m + KC - 1) / KC;
  int cs = 1;
  while (cs < MAX_CS && tiles * cs < 2LL * num_sms() && nchunks >= 2 * cs * MIN_CHUNKS) cs *= 2;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(((m + TM - 1) / TM) * cs), (unsigned)nc);
  cfg.blockDim = dim3(MMA_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, kernel, tmap, y, x, A, blocks, nb, m, nr, cs, bulk);
}

extern "C" {

// K6 at batch 1 over the nc listed blocks (blocks == nullptr: all nb);
// returns cudaGetLastError().
int ddaamg_dense_bf16(void* y, const void* x, const void* A, const void* blocks, int nb, int m, int nc,
                      void* stream) {
  if (nc < 1 || nc > nb) return (int)cudaErrorInvalidValue;
  long long rows = (long long)nc * m;
  dim3 grid((unsigned)((rows + WARPS - 1) / WARPS));
  dim3 block(32, WARPS);
  auto* bl = (const int*)blocks;
  if (m % 4 == 0 && (uintptr_t)A % 16 == 0)
    dense_bf16_kernel<<<grid, block, 0, (cudaStream_t)stream>>>((cplx<float>*)y, (const float2*)x,
                                                                 (const uint4*)A, bl, nc, m);
  else
    dense_bf16_rows_kernel<<<grid, block, 0, (cudaStream_t)stream>>>((cplx<float>*)y, (const float2*)x,
                                                                      (const unsigned int*)A, bl, nc, m);
  return (int)cudaGetLastError();
}

// K6 over 2 <= nr <= MRHS_MAX right-hand sides, x and y [nr, nb, m], on the
// tensor cores: one launch
int ddaamg_dense_bf16_mrhs(void* y, const void* x, const void* A, const void* blocks, int nb, int m, int nr,
                           int nc, void* stream) {
  if (nr < 2 || nr > MRHS_MAX || nc < 1 || nc > nb || nc > 65535) return (int)cudaErrorInvalidValue;
  const bool bulk = m % 4 == 0 && (uintptr_t)A % 16 == 0;
  auto* yc = (float2*)y;
  auto* xc = (const float2*)x;
  auto* Ac = (const uint32_t*)A;
  auto* bl = (const int*)blocks;
  auto s = (cudaStream_t)stream;
  switch ((6 * nr + 7) / 8) {  // n tiles of 8 columns
#define K6_MMA_CASE(n) \
  case n:              \
    return launch_mma<n>(yc, xc, Ac, bl, nb, m, nr, nc, bulk, s);
    K6_MMA_CASE(2) K6_MMA_CASE(3) K6_MMA_CASE(4) K6_MMA_CASE(5) K6_MMA_CASE(6) K6_MMA_CASE(7) K6_MMA_CASE(8)
    K6_MMA_CASE(9)
#undef K6_MMA_CASE
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
