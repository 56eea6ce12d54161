// In-place LWW pair scatter for Hopper (sm_90a): K3 scatter_pair_src.
//
// Replaces the reference package's Pallas kernel `scatter_pair_src_split`
// (_scatter_pair_kernel) in constdb_tpu/ops/pallas_dense.py.  That kernel
// is one grid step per batch row: the scalar-prefetched slot id drives a
// BlockSpec that gathers one state row, compares the batch pair against it
// and writes it back through aliased outputs.  It splits every int64 into
// hi int32 / lo uint32 planes (TPU vector lanes are 32 bits wide), and its
// callers pad the batch to a power of two with rows that must target an
// otherwise untouched state row (the pad-row contract), so that jit traces
// stay few.
//
// Here one thread owns one batch row i < n: it loads idx[i], the two int64
// plane values at that row and the batch pair, compares in native int64 —
// (bp > p) || (bp == p && bs > s), exactly ops/bulk.py _pair_win — and on a
// win writes p, s and src = base + i.  No split, no padding: the caller
// passes exactly the n real rows, so no extra step can alias a real target.
// The planes are updated IN PLACE (the reference donates its buffers).
//
// Races: none.  The host fold (engine/hostbatch.py fold_pair_rows /
// fold_el_rows) makes the slot ids unique within one call, so no two
// threads share a target row and no atomics are needed.  Ids outside
// [0, sp) are skipped, as the plain version drops out-of-range rows.
//
// Bound: launch overhead at the steady path's sizes (a 512-frame coalescer
// flush holds about a thousand rows), then bytes: per row an int32 id and
// two int64 batch values are read, two int64 plane values gathered, and
// on a win two int64 values and one int32 scattered — random 8-byte
// accesses, one 32-byte sector each.  The design keeps one pass and one
// launch per pair; nothing is staged through shared memory because no
// value is reused.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void scatter_pair_kernel(int64_t* __restrict__ p,
                                    int64_t* __restrict__ s,
                                    int32_t* __restrict__ src,
                                    int64_t sp,
                                    const int32_t* __restrict__ idx,
                                    const int64_t* __restrict__ bp,
                                    const int64_t* __restrict__ bs,
                                    int64_t n, int32_t base) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= n) return;
  const int64_t r = idx[i];
  if (r < 0 || r >= sp) return;
  const int64_t np_ = bp[i];
  const int64_t ns = bs[i];
  const int64_t cp = p[r];
  const int64_t cs = s[r];
  if (np_ > cp || (np_ == cp && ns > cs)) {
    p[r] = np_;
    s[r] = ns;
    src[r] = base + static_cast<int32_t>(i);
  }
}

}  // namespace

extern "C" {

// p, s: [sp] int64 planes; src: [sp] int32; idx: [n] int32 unique ids;
// bp, bs: [n] int64.  Returns cudaGetLastError() right after the launch;
// the caller guarantees n >= 1 and base + n - 1 < 2^31.
int constdb_scatter_pair_src(void* p, void* s, void* src, int64_t sp,
                             const void* idx, const void* bp, const void* bs,
                             int64_t n, int32_t base, void* stream) {
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  scatter_pair_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<int64_t*>(p), static_cast<int64_t*>(s),
      static_cast<int32_t*>(src), sp, static_cast<const int32_t*>(idx),
      static_cast<const int64_t*>(bp), static_cast<const int64_t*>(bs), n,
      base);
  return static_cast<int>(cudaGetLastError());
}

const char* constdb_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
