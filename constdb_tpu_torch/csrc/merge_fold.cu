// Aligned R-replica fold kernels for Hopper (sm_90a): K1 merge_elems and
// K2 merge_counters.
//
// Replace the reference package's Pallas kernels in
// constdb_tpu/ops/pallas_dense.py: `merge_elems` (_elems_kernel) and
// `merge_counters` (_counters_kernel).  The Pallas versions split every
// int64 into hi/lo 32-bit planes and pad S to a 512 multiple because TPU
// VMEM lanes are 32-bit; Hopper compares int64 natively, so both
// artifacts are gone here.
//
// Layout: every input is a contiguous [R, S] int64 stack (row r = replica
// batch r), outputs are [S].  One thread owns one column s and walks the
// R rows (R is small: 2..32), so loads along S are coalesced for every r
// and no cross-thread reduction is needed.
//
// Bound: bytes.  Per column the kernel reads 8*R bytes per input plane
// and writes 8 bytes per output, with a handful of integer compares per
// element, far below the card's integer rate; the design goal is simply
// to touch each input byte once with coalesced 8-byte loads.
//
// Semantics (== ops/dense.py plain versions, bit for bit):
//   K1: lexicographic (add_t, add_node) max over R, the FIRST row that
//       achieves it (a later row replaces the winner only when strictly
//       greater), and an independent max of del_t.  win is int64.
//   K2: lexicographic (uuid, value) max over R (LWW, max value on ties).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void merge_elems_kernel(const int64_t* __restrict__ at,
                                   const int64_t* __restrict__ an,
                                   const int64_t* __restrict__ dt,
                                   int rows, int64_t cols,
                                   int64_t* __restrict__ o_at,
                                   int64_t* __restrict__ o_an,
                                   int64_t* __restrict__ o_dt,
                                   int64_t* __restrict__ o_win) {
  const int64_t s = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (s >= cols) return;
  int64_t best_t = at[s];
  int64_t best_n = an[s];
  int64_t best_d = dt[s];
  int64_t win = 0;
  for (int r = 1; r < rows; ++r) {
    const int64_t off = static_cast<int64_t>(r) * cols + s;
    const int64_t t = at[off];
    const int64_t n = an[off];
    if (t > best_t || (t == best_t && n > best_n)) {
      best_t = t;
      best_n = n;
      win = r;
    }
    const int64_t d = dt[off];
    if (d > best_d) best_d = d;
  }
  o_at[s] = best_t;
  o_an[s] = best_n;
  o_dt[s] = best_d;
  o_win[s] = win;
}

__global__ void merge_counters_kernel(const int64_t* __restrict__ vals,
                                      const int64_t* __restrict__ ts,
                                      int rows, int64_t cols,
                                      int64_t* __restrict__ o_val,
                                      int64_t* __restrict__ o_t) {
  const int64_t s = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (s >= cols) return;
  int64_t best_t = ts[s];
  int64_t best_v = vals[s];
  for (int r = 1; r < rows; ++r) {
    const int64_t off = static_cast<int64_t>(r) * cols + s;
    const int64_t t = ts[off];
    const int64_t v = vals[off];
    if (t > best_t || (t == best_t && v > best_v)) {
      best_t = t;
      best_v = v;
    }
  }
  o_val[s] = best_v;
  o_t[s] = best_t;
}

unsigned int blocks_for(int64_t cols) {
  return static_cast<unsigned int>((cols + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

// Each launcher returns cudaGetLastError() right after the launch (0 on
// success); the caller guarantees rows >= 1 and cols >= 1.
int constdb_merge_elems(const void* at, const void* an, const void* dt,
                        int rows, int64_t cols, void* o_at, void* o_an,
                        void* o_dt, void* o_win, void* stream) {
  merge_elems_kernel<<<blocks_for(cols), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(at), static_cast<const int64_t*>(an),
      static_cast<const int64_t*>(dt), rows, cols,
      static_cast<int64_t*>(o_at), static_cast<int64_t*>(o_an),
      static_cast<int64_t*>(o_dt), static_cast<int64_t*>(o_win));
  return static_cast<int>(cudaGetLastError());
}

int constdb_merge_counters(const void* vals, const void* ts, int rows,
                           int64_t cols, void* o_val, void* o_t,
                           void* stream) {
  merge_counters_kernel<<<blocks_for(cols), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(vals), static_cast<const int64_t*>(ts),
      rows, cols, static_cast<int64_t*>(o_val), static_cast<int64_t*>(o_t));
  return static_cast<int>(cudaGetLastError());
}

const char* constdb_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
