// K7: classical Gram-Schmidt of a GCR iteration with the row count read
// from the device (solvers/device_gmres.orthonormalize,
// operators/cuda_gcr.py).
//
// It replaces no Pallas kernel: the JAX package's GCR computes its
// Gram-Schmidt with XLA einsums inside the lax.while_loop
// (ddalphaamg_tpu/solvers/device_gmres.py:111-119), over all m rows of
// bases that start zero ("zero rows contribute zero"), j a traced value.
// For every lane b of W, Q [B, m, n] and w, q [B, n]:
//
//   h_i = <W_i, w> (i < j),  w' = w - sum_{i<j} h_i W_i,  q' = q - sum_{i<j} h_i Q_i,
//   w'' = w' / |w'|, q'' = q' / |w'| (a zero w' keeps scale 1),
//   W_j = w'', Q_j = q'', and w'', q'' into the outputs wo, qo,
//
// with j a device int64 (a loop index of a captured graph, or a row index
// the host loop hands over).  Only the rows below j are read, so the bytes
// follow j and not m: (2j + 4) n elements at least (W_i, Q_i for i < j, w,
// q, and rows j of W and Q), 3j n + 9 n as written here (pass 1 reads W_i
// again); bound by the bytes.
//
// Four passes over n-chunks of THREADS * E elements (E = 4 from 2^20
// elements on, else 1), each launch a fixed-order reduction, so that the
// summation order depends on j and n only, never on m or on B: the host
// loop, a replay and repeated runs give the same bits.
//   dots:   per (chunk, ROWS rows, lane) block, the partial h_i of its
//           chunk: products in element order, a butterfly in the warp, the
//           warps in order -> H [B, m, nchunk]
//   hsum:   per (row, lane) warp, the chunks of H in a fixed strided order
//           and a butterfly -> h [B, m]
//   update: per (chunk, lane) block, w' and q' (rows in order) into wo, qo,
//           and the chunk's partial |w'|^2 -> N [B, nchunk]
//   scale:  every block sums N of its lane in one fixed order, then
//           scales its chunks of wo, qo and writes them to row j.
// complex64 and complex128 (cplx<float> / cplx<double>).

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ROWS = 8;               // rows of W a dots block takes
constexpr int SCALE_BLOCKS = 264;     // scale blocks of a lane at most (2 an SM)
constexpr long long WIDE = 1 << 20;   // from here on 4 elements a thread
constexpr int MAX_ROWS = 2048;        // m at most: h of a lane in 32 KB of shared memory

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

// the row index j, or -1 where it lies outside [0, m) (then nothing runs)
__device__ __forceinline__ int row_of(const long long* jp, int m) {
  const long long j = *jp;
  return (j >= 0 && j < m) ? (int)j : -1;
}

template <typename R, int E>
__global__ void __launch_bounds__(THREADS)
gs_dots(const cplx<R>* __restrict__ W, const cplx<R>* __restrict__ w,
        const long long* __restrict__ jp, cplx<R>* __restrict__ H, long long n, int m,
        int nchunk) {
  const int j = row_of(jp, m);
  const int c = blockIdx.x, i0 = blockIdx.y * ROWS, b = blockIdx.z;
  if (i0 >= j) return;  // also j = -1
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long k0 = (long long)c * (THREADS * E) + threadIdx.x;
  cplx<R> wv[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const long long k = k0 + e * THREADS;
    wv[e] = k < n ? w[(long long)b * n + k] : cx<R>(0, 0);
  }
  __shared__ cplx<R> part[WARPS][ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    cplx<R> acc = cx<R>(0, 0);
    const int i = i0 + r;
    if (i < j) {
      const cplx<R>* row = W + ((long long)b * m + i) * n;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const long long k = k0 + e * THREADS;
        if (k < n) acc = cadd(acc, cmulc(row[k], wv[e]));
      }
    }
    acc = warp_sum(acc);
    if (lane == 0) part[warp][r] = acc;
  }
  __syncthreads();
  if (threadIdx.x < ROWS) {
    const int i = i0 + threadIdx.x;
    if (i < j) {
      cplx<R> s = part[0][threadIdx.x];
#pragma unroll
      for (int p = 1; p < WARPS; ++p) s = cadd(s, part[p][threadIdx.x]);
      H[((long long)b * m + i) * nchunk + c] = s;
    }
  }
}

template <typename R>
__global__ void __launch_bounds__(THREADS)
gs_hsum(const cplx<R>* __restrict__ H, const long long* __restrict__ jp,
        cplx<R>* __restrict__ h, int m, int nchunk) {
  const int j = row_of(jp, m);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int i = blockIdx.x * WARPS + warp, b = blockIdx.y;
  if (i >= j) return;  // a whole warp
  const cplx<R>* src = H + ((long long)b * m + i) * nchunk;
  cplx<R> s = cx<R>(0, 0);
  for (int c = lane; c < nchunk; c += 32) s = cadd(s, src[c]);
  s = warp_sum(s);
  if (lane == 0) h[(long long)b * m + i] = s;
}

template <typename R, int E>
__global__ void __launch_bounds__(THREADS)
gs_update(const cplx<R>* __restrict__ W, const cplx<R>* __restrict__ Q,
          const cplx<R>* __restrict__ w, const cplx<R>* __restrict__ q,
          const long long* __restrict__ jp, const cplx<R>* __restrict__ h,
          cplx<R>* __restrict__ wo, cplx<R>* __restrict__ qo, R* __restrict__ N, long long n,
          int m, int nchunk) {
  const int j = row_of(jp, m);
  if (j < 0) return;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cplx<R>* hs = reinterpret_cast<cplx<R>*>(smem_raw);
  __shared__ R nsum[WARPS];
  const int c = blockIdx.x, b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < j; i += THREADS) hs[i] = h[(long long)b * m + i];
  __syncthreads();
  const long long k0 = (long long)c * (THREADS * E) + threadIdx.x;
  const long long lane0 = (long long)b * n;
  cplx<R> wv[E], qv[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const long long k = k0 + e * THREADS;
    wv[e] = k < n ? w[lane0 + k] : cx<R>(0, 0);
    qv[e] = k < n ? q[lane0 + k] : cx<R>(0, 0);
  }
#pragma unroll 4
  for (int i = 0; i < j; ++i) {
    const cplx<R> hi = hs[i];
    const cplx<R>* Wr = W + ((long long)b * m + i) * n;
    const cplx<R>* Qr = Q + ((long long)b * m + i) * n;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const long long k = k0 + e * THREADS;
      if (k < n) {
        wv[e] = csub(wv[e], cmul(hi, Wr[k]));
        qv[e] = csub(qv[e], cmul(hi, Qr[k]));
      }
    }
  }
  R t = 0;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const long long k = k0 + e * THREADS;
    if (k < n) {
      wo[lane0 + k] = wv[e];
      qo[lane0 + k] = qv[e];
      t += wv[e].re * wv[e].re + wv[e].im * wv[e].im;
    }
  }
  t = warp_sum(t);
  if (lane == 0) nsum[warp] = t;
  __syncthreads();
  if (threadIdx.x == 0) {
    R s = nsum[0];
#pragma unroll
    for (int p = 1; p < WARPS; ++p) s += nsum[p];
    N[(long long)b * nchunk + c] = s;
  }
}

template <typename R, int E>
__global__ void __launch_bounds__(THREADS)
gs_scale(cplx<R>* __restrict__ W, cplx<R>* __restrict__ Q, cplx<R>* __restrict__ wo,
         cplx<R>* __restrict__ qo, const long long* __restrict__ jp, const R* __restrict__ N,
         long long n, int m, int nchunk) {
  const int j = row_of(jp, m);
  if (j < 0) return;
  __shared__ R nsum[WARPS];
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // |w'|^2 of the lane, in the same order in every block
  R t = 0;
  for (int c = threadIdx.x; c < nchunk; c += THREADS) t += N[(long long)b * nchunk + c];
  t = warp_sum(t);
  if (lane == 0) nsum[warp] = t;
  __syncthreads();
  R s = nsum[0];
#pragma unroll
  for (int p = 1; p < WARPS; ++p) s += nsum[p];
  const R wn = sqrt(s);
  const R inv = wn == R(0) ? R(1) : R(1) / wn;
  const long long lane0 = (long long)b * n;
  cplx<R>* Wj = W + ((long long)b * m + j) * n;
  cplx<R>* Qj = Q + ((long long)b * m + j) * n;
  for (int c = blockIdx.x; c < nchunk; c += gridDim.x) {
    const long long k0 = (long long)c * (THREADS * E) + threadIdx.x;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const long long k = k0 + e * THREADS;
      if (k < n) {
        const cplx<R> a = wo[lane0 + k], g = qo[lane0 + k];
        const cplx<R> as = cx<R>(a.re * inv, a.im * inv), gs = cx<R>(g.re * inv, g.im * inv);
        wo[lane0 + k] = as;
        qo[lane0 + k] = gs;
        Wj[k] = as;
        Qj[k] = gs;
      }
    }
  }
}

int elems_per_thread(long long n) { return n >= WIDE ? 4 : 1; }

int chunks_of(long long n) {
  const long long chunk = (long long)THREADS * elems_per_thread(n);
  return (int)((n + chunk - 1) / chunk);
}

template <typename R, int E>
int launch(void* W, void* Q, const void* w, const void* q, void* wo, void* qo, const void* j,
           void* H, void* h, void* N, int B, int m, long long n, cudaStream_t s) {
  using C = cplx<R>;
  const int nchunk = chunks_of(n);
  gs_dots<R, E><<<dim3(nchunk, (m + ROWS - 1) / ROWS, B), THREADS, 0, s>>>(
      (const C*)W, (const C*)w, (const long long*)j, (C*)H, n, m, nchunk);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  gs_hsum<R><<<dim3((m + WARPS - 1) / WARPS, B), THREADS, 0, s>>>(
      (const C*)H, (const long long*)j, (C*)h, m, nchunk);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  gs_update<R, E><<<dim3(nchunk, B), THREADS, m * sizeof(C), s>>>(
      (const C*)W, (const C*)Q, (const C*)w, (const C*)q, (const long long*)j, (const C*)h,
      (C*)wo, (C*)qo, (R*)N, n, m, nchunk);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const int sb = nchunk < SCALE_BLOCKS ? nchunk : SCALE_BLOCKS;
  gs_scale<R, E><<<dim3(sb, B), THREADS, 0, s>>>(
      (C*)W, (C*)Q, (C*)wo, (C*)qo, (const long long*)j, (const R*)N, n, m, nchunk);
  return (int)cudaGetLastError();
}

template <typename R>
int dispatch(void* W, void* Q, const void* w, const void* q, void* wo, void* qo, const void* j,
             void* H, void* h, void* N, int B, int m, long long n, void* stream) {
  if (B < 1 || B > 65535 || m < 1 || m > MAX_ROWS || n < 1) return (int)cudaErrorInvalidValue;
  auto s = (cudaStream_t)stream;
  if (elems_per_thread(n) == 4) return launch<R, 4>(W, Q, w, q, wo, qo, j, H, h, N, B, m, n, s);
  return launch<R, 1>(W, Q, w, q, wo, qo, j, H, h, N, B, m, n, s);
}

}  // namespace

extern "C" {

// chunks of a row of n elements: the scratch H [B, m, chunks] and N
// [B, chunks] the caller allocates
int ddaamg_gcr_chunks(long long n) { return chunks_of(n); }

// K7 on W, Q [B, m, n] and w, q, wo, qo [B, n] (module note); j a device
// int64; H, h, N scratch [B, m, chunks], [B, m], [B, chunks] (real)
int ddaamg_gcr_orthonormalize_c64(void* W, void* Q, const void* w, const void* q, void* wo,
                                  void* qo, const void* j, void* H, void* h, void* N, int B,
                                  int m, long long n, void* stream) {
  return dispatch<float>(W, Q, w, q, wo, qo, j, H, h, N, B, m, n, stream);
}

int ddaamg_gcr_orthonormalize_c128(void* W, void* Q, const void* w, const void* q, void* wo,
                                   void* qo, const void* j, void* H, void* h, void* N, int B,
                                   int m, long long n, void* stream) {
  return dispatch<double>(W, Q, w, q, wo, qo, j, H, h, N, B, m, n, stream);
}

}  // extern "C"
