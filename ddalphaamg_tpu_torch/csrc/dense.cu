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

}  // extern "C"
