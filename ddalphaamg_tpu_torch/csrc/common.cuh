// Shared helpers for the hand-written Hopper kernels of ddalphaamg_tpu_torch.
//
// Complex numbers are stored the way torch stores complex64 / complex128:
// interleaved (re, im) pairs, 8- / 16-byte aligned, so one thread loads a
// whole complex number with a single vector load.
#pragma once

#include <cuda_runtime.h>

template <typename R>
struct alignas(2 * sizeof(R)) cplx {
  R re, im;
};

template <typename R>
__device__ __forceinline__ cplx<R> cx(R re, R im) {
  cplx<R> c;
  c.re = re;
  c.im = im;
  return c;
}

template <typename R>
__device__ __forceinline__ cplx<R> cadd(cplx<R> a, cplx<R> b) {
  return cx<R>(a.re + b.re, a.im + b.im);
}

template <typename R>
__device__ __forceinline__ cplx<R> csub(cplx<R> a, cplx<R> b) {
  return cx<R>(a.re - b.re, a.im - b.im);
}

// a * b
template <typename R>
__device__ __forceinline__ cplx<R> cmul(cplx<R> a, cplx<R> b) {
  return cx<R>(a.re * b.re - a.im * b.im, a.re * b.im + a.im * b.re);
}

// conj(a) * b
template <typename R>
__device__ __forceinline__ cplx<R> cmulc(cplx<R> a, cplx<R> b) {
  return cx<R>(a.re * b.re + a.im * b.im, a.re * b.im - a.im * b.re);
}

// acc += a * b
template <typename R>
__device__ __forceinline__ void cfma(cplx<R>& acc, cplx<R> a, cplx<R> b) {
  acc.re += a.re * b.re - a.im * b.im;
  acc.im += a.re * b.im + a.im * b.re;
}

// (vr + i vi) * x for a phase with integer parts (the gamma tables hold
// only +-1 and +-i, so after unrolling these fold into sign flips / swaps)
template <typename R>
__device__ __forceinline__ cplx<R> cphase(int vr, int vi, cplx<R> x) {
  return cx<R>(R(vr) * x.re - R(vi) * x.im, R(vr) * x.im + R(vi) * x.re);
}

// streaming multiprocessors of the current device (read once)
inline int num_sms() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

// lattice coordinates of a lexicographic site index (X fastest), T Z Y X
struct Lattice {
  int n[4];  // extents T, Z, Y, X
  int stride[4];  // site-index stride of one step in each direction
};

__device__ __forceinline__ void site_coords(const Lattice& L, int site, int c[4]) {
  c[3] = site % L.n[3];
  int r = site / L.n[3];
  c[2] = r % L.n[2];
  r /= L.n[2];
  c[1] = r % L.n[1];
  c[0] = r / L.n[1];
}

// neighbor x + dir * mu_hat with periodic wrap (dir = +1 / -1)
__device__ __forceinline__ int site_step(const Lattice& L, int site, const int c[4], int mu, int dir) {
  int cm = c[mu] + dir;
  if (cm == L.n[mu]) return site - (L.n[mu] - 1) * L.stride[mu];
  if (cm < 0) return site + (L.n[mu] - 1) * L.stride[mu];
  return site + dir * L.stride[mu];
}

inline Lattice make_lattice(int t, int z, int y, int x) {
  Lattice L;
  L.n[0] = t;
  L.n[1] = z;
  L.n[2] = y;
  L.n[3] = x;
  L.stride[3] = 1;
  L.stride[2] = x;
  L.stride[1] = x * y;
  L.stride[0] = x * y * z;
  return L;
}
