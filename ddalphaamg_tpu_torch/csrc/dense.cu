// K6: batched complex matvec with a bf16-stored matrix, for Hopper (sm_90a).
//
//   y[b, i] = sum_j A[b, i, j] x[b, j],   A [nb, m, m] stored as bf16 (re, im)
//   pairs (4 bytes an entry, row-major), x and y [nb, m] complex64.
//
// Serves the two stored inverses of the multigrid hierarchy: the coarsest
// level's dense Schur-complement inverse (nb = 1, m = n / 2: 7168 at
// rough16) and the depth-1 Schwarz block inverses (nb = 256 blocks of
// m = 16 * 56 = 896).  In the JAX package both products are XLA einsums
// (operators/stencil.py:710 and :727, smoothers/sap.py:193) that widen the
// bf16 storage to f32 at multiply time; no Pallas kernel exists for them.
//
// What bounds it on the H100: memory, in the matrix.  Every entry is read
// once and used once (8 flop per 4-byte entry, 2 flop/byte), so the least
// time is the matrix's bytes over 3.35 TB/s: 205 MB (61 us) for the Schur
// inverse, 822 MB (245 us) for the block inverses.  Widening to complex64
// first and calling a library product would write and re-read twice the
// stored bytes.
//
// Design: one warp per output row.  Each lane reads 16 bytes (four
// consecutive entries) per step, so a warp reads 512 consecutive bytes of
// the row per step (coalesced); entries are widened exactly (a bf16 is the
// upper half of an f32) and multiplied in f32 against x, which is small and
// read through the read-only cache.  Each lane sums its entries in a fixed order,
// and the warp's lanes meet in a fixed butterfly, so results do not depend
// on scheduling.  Rows are 16-byte aligned only when m is a multiple of 4;
// for any other m (an odd test-vector count) the launcher takes
// dense_bf16_rows_kernel, the same design with one 4-byte entry per lane
// and step.
//
// Over R right-hand sides (ddaamg_dense_bf16_mrhs: a batched cycle solves
// the coarsest level or the Schwarz blocks of R lanes at once),
//
//   y[r, b, i] = sum_j A[b, i, j] x[r, b, j],   x and y [R, nb, m],
//
// every entry of A is still read once, now for all R vectors: 8 R flop per
// 4-byte entry, so at R = 12 the operations (8 nb m^2 R over 67 TFLOP/s in
// f32: 74 us for the Schur inverse, 294 us for the block inverses) and not
// the matrix's bytes bound it.  Launching the batch-1 kernel R times would
// read the matrix R times.  dense_bf16_mrhs_kernel gives each warp
// MRHS_ROWS rows of one block b and keeps MRHS_ROWS x NR (re, im)
// accumulators in registers.  x of a block (R m 8 bytes: 688 KB for the
// Schur inverse at R = 12) does not fit L1, so the thread block stages it
// in shared memory MRHS_CHUNK columns at a time, and every lane reads the
// four rows' entries of its next step before it multiplies the current
// ones; the copies of the next chunk are in flight (cp.async, two buffers)
// while the warps multiply the current one.  A launch takes at most
// MRHS_MAX right-hand sides (one kernel instance per count); the wrapper
// splits more.  Each (row, right-hand
// side) is summed in the batch-1 kernel's order and butterfly, so a lane
// gets the same bits as a batch-1 launch on it alone.
#include <cstdint>

#include "common.cuh"

constexpr int WARPS = 8;  // rows (warps) per thread block

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

__global__ void __launch_bounds__(32 * WARPS)
    dense_bf16_kernel(cplx<float>* __restrict__ y, const float2* __restrict__ x, const uint4* __restrict__ A,
                      int nb, int m) {
  long long row = (long long)blockIdx.x * WARPS + threadIdx.y;  // b * m + i
  if (row >= (long long)nb * m) return;
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
                           const unsigned int* __restrict__ A, int nb, int m) {
  long long row = (long long)blockIdx.x * WARPS + threadIdx.y;  // b * m + i
  if (row >= (long long)nb * m) return;
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

constexpr int MRHS_ROWS = 4;     // rows of A a warp computes together
constexpr int MRHS_MAX = 12;     // right-hand sides of one launch
constexpr int MRHS_CHUNK = 512;  // columns of x a block stages in shared memory at a time

// 8-byte asynchronous copy global -> shared (cp.async, sm_80+)
__device__ __forceinline__ void copy_async8(void* dst, const void* src) {
  const unsigned int s = (unsigned int)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void copy_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// wait until at most one group of copies is still in flight
__device__ __forceinline__ void copy_async_wait1() { asm volatile("cp.async.wait_group 1;\n" ::); }

// K6 over NR right-hand sides (VEC: 16-byte loads of A, m % 4 == 0).  The
// block stages x[:, chunk] in shared memory by asynchronous copies into
// two buffers (2 x NR x 4 KB, dynamic), the next chunk's copies in flight
// while the warps multiply the current one; each warp runs over the chunk
// with its MRHS_ROWS rows, loading the rows' entries for the next step
// before it multiplies the current ones.  A lane visits the columns in the
// batch-1 kernel's order (chunks are whole multiples of its 32-lane stride).
template <int NR, bool VEC>
__global__ void __launch_bounds__(32 * WARPS, 1)
    dense_bf16_mrhs_kernel(cplx<float>* __restrict__ y, const float2* __restrict__ x,
                           const unsigned int* __restrict__ A, int nb, int m) {
  constexpr int E = VEC ? 4 : 1;  // entries a lane takes per row and step
  extern __shared__ __align__(16) float2 xs[];  // [2][NR][MRHS_CHUNK]
  const int lane = threadIdx.x, tid = threadIdx.y * 32 + lane;
  const int i0 = (blockIdx.x * WARPS + threadIdx.y) * MRHS_ROWS;
  const long long b = blockIdx.y;
  const long long vstride = (long long)nb * m;  // one right-hand side to the next
  const float2* xb = x + b * m;
  auto stage = [&](int buf, int c0) {
    const int cn = min(MRHS_CHUNK, m - c0);
    float2* dst = xs + buf * NR * MRHS_CHUNK;
#pragma unroll
    for (int r = 0; r < NR; ++r)
      for (int c = tid; c < cn; c += 32 * WARPS) copy_async8(dst + r * MRHS_CHUNK + c, xb + r * vstride + c0 + c);
    copy_async_commit();
  };
  const unsigned int* Ar[MRHS_ROWS];
#pragma unroll
  for (int t = 0; t < MRHS_ROWS; ++t)  // rows past m repeat row m - 1 (never stored)
    Ar[t] = A + (b * m + min(i0 + t, m - 1)) * (long long)m;
  float acc[MRHS_ROWS][NR][2];
#pragma unroll
  for (int t = 0; t < MRHS_ROWS; ++t)
#pragma unroll
    for (int r = 0; r < NR; ++r) acc[t][r][0] = acc[t][r][1] = 0.f;
  unsigned int w[MRHS_ROWS][E], wn[MRHS_ROWS][E];
  auto load_rows = [&](unsigned int (&dst)[MRHS_ROWS][E], int col) {
#pragma unroll
    for (int t = 0; t < MRHS_ROWS; ++t) {
      if constexpr (VEC) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(Ar[t] + col));
        dst[t][0] = v.x;
        dst[t][1] = v.y;
        dst[t][2] = v.z;
        dst[t][3] = v.w;
      } else {
        dst[t][0] = __ldg(Ar[t] + col);
      }
    }
  };
  stage(0, 0);
  for (int c0 = 0, buf = 0; c0 < m; c0 += MRHS_CHUNK, buf ^= 1) {
    if (c0 + MRHS_CHUNK < m)
      stage(buf ^ 1, c0 + MRHS_CHUNK);  // the buffer read in the previous chunk
    else
      copy_async_commit();  // an empty group: the wait below counts alike
    copy_async_wait1();      // this chunk's copies have landed
    __syncthreads();
    const float2* xc = xs + buf * NR * MRHS_CHUNK;
    const int steps = min(MRHS_CHUNK, m - c0) / E;
    if (i0 < m && lane < steps) {
      load_rows(wn, c0 + E * lane);
      for (int q = lane; q < steps; q += 32) {
#pragma unroll
        for (int t = 0; t < MRHS_ROWS; ++t)
#pragma unroll
          for (int e = 0; e < E; ++e) w[t][e] = wn[t][e];
        if (q + 32 < steps) load_rows(wn, c0 + E * (q + 32));
#pragma unroll
        for (int r = 0; r < NR; ++r) {
          float2 xv[E];
          if constexpr (VEC) {
            const float4 lo = *reinterpret_cast<const float4*>(xc + r * MRHS_CHUNK + E * q);
            const float4 hi = *reinterpret_cast<const float4*>(xc + r * MRHS_CHUNK + E * q + 2);
            xv[0] = make_float2(lo.x, lo.y);
            xv[1] = make_float2(lo.z, lo.w);
            xv[2] = make_float2(hi.x, hi.y);
            xv[3] = make_float2(hi.z, hi.w);
          } else {
            xv[0] = xc[r * MRHS_CHUNK + q];
          }
#pragma unroll
          for (int e = 0; e < E; ++e) {
#pragma unroll
            for (int t = 0; t < MRHS_ROWS; ++t) {
              const float ar = bf16_lo(w[t][e]), ai = bf16_hi(w[t][e]);
              acc[t][r][0] += ar * xv[e].x - ai * xv[e].y;
              acc[t][r][1] += ar * xv[e].y + ai * xv[e].x;
            }
          }
        }
      }
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }
  if (i0 >= m) return;
#pragma unroll
  for (int t = 0; t < MRHS_ROWS; ++t) {
#pragma unroll
    for (int r = 0; r < NR; ++r)
      if (i0 + t < m) warp_store(y + r * vstride + b * m, i0 + t, acc[t][r][0], acc[t][r][1]);
  }
}

template <int NR>
static int launch_mrhs(cplx<float>* y, const float2* x, const unsigned int* A, int nb, int m, bool vec,
                       cudaStream_t stream) {
  constexpr int smem = 2 * NR * MRHS_CHUNK * (int)sizeof(float2);
  auto kernel = vec ? dense_bf16_mrhs_kernel<NR, true> : dense_bf16_mrhs_kernel<NR, false>;
  static bool ready[2] = {false, false};  // once per instance: shared memory above 48 KB
  if (!ready[vec]) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    ready[vec] = true;
  }
  dim3 grid((unsigned)((m + WARPS * MRHS_ROWS - 1) / (WARPS * MRHS_ROWS)), (unsigned)nb);
  dim3 block(32, WARPS);
  kernel<<<grid, block, smem, stream>>>(y, x, A, nb, m);
  return (int)cudaGetLastError();
}

extern "C" {

// K6: y = A x per batch member; returns cudaGetLastError().
int ddaamg_dense_bf16(void* y, const void* x, const void* A, int nb, int m, void* stream) {
  long long rows = (long long)nb * m;
  dim3 grid((unsigned)((rows + WARPS - 1) / WARPS));
  dim3 block(32, WARPS);
  if (m % 4 == 0 && (uintptr_t)A % 16 == 0)
    dense_bf16_kernel<<<grid, block, 0, (cudaStream_t)stream>>>((cplx<float>*)y, (const float2*)x,
                                                                 (const uint4*)A, nb, m);
  else
    dense_bf16_rows_kernel<<<grid, block, 0, (cudaStream_t)stream>>>((cplx<float>*)y, (const float2*)x,
                                                                      (const unsigned int*)A, nb, m);
  return (int)cudaGetLastError();
}

// K6 over 1 <= nr <= MRHS_MAX right-hand sides, x and y [nr, nb, m]: one launch
int ddaamg_dense_bf16_mrhs(void* y, const void* x, const void* A, int nb, int m, int nr,
                           void* stream) {
  if (nr < 1 || nr > MRHS_MAX || nb < 1 || nb > 65535) return (int)cudaErrorInvalidValue;
  const bool vec = m % 4 == 0 && (uintptr_t)A % 16 == 0;
  auto* yc = (cplx<float>*)y;
  auto* xc = (const float2*)x;
  auto* Ac = (const unsigned int*)A;
  auto s = (cudaStream_t)stream;
  switch (nr) {
#define K6_MRHS_CASE(n) \
  case n:               \
    return launch_mrhs<n>(yc, xc, Ac, nb, m, vec, s);
    K6_MRHS_CASE(1) K6_MRHS_CASE(2) K6_MRHS_CASE(3) K6_MRHS_CASE(4) K6_MRHS_CASE(5) K6_MRHS_CASE(6)
    K6_MRHS_CASE(7) K6_MRHS_CASE(8) K6_MRHS_CASE(9) K6_MRHS_CASE(10) K6_MRHS_CASE(11) K6_MRHS_CASE(12)
#undef K6_MRHS_CASE
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
