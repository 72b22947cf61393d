// The tracer's device marks (profiling.py, level 4): a one-thread kernel
// before and after each marked section or port kernel launch, captured into
// a graph's loop bodies like any other kernel, so the table accumulates over
// every pass of every replay with no read of the device.
//
// It replaces no Pallas kernel.  A row of the table is [elapsed ns, passes,
// the open mark's start ns] for one (site path, family); the host reads the
// table once, when it reports.  The time is %globaltimer, the card's
// nanosecond clock, which every SM reads alike (clock64 is an SM's own and
// the two marks of a row may run on different SMs).  Marks on one stream run
// in order, so a row is never open twice at once and needs no atomics.

#include <cuda_runtime.h>

__global__ void mark_kernel(long long* row, int end) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  if (end) {
    row[0] += (long long)t - row[2];
    row[1] += 1;
  } else {
    row[2] = (long long)t;
  }
}

extern "C" {

// opens (end = 0) or closes (end = 1) row `slot` of table [slots, 3]
int ddaamg_mark(long long* table, int slot, int end, void* stream) {
  mark_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(table + 3 * (long long)slot, end);
  return (int)cudaGetLastError();
}

}  // extern "C"
