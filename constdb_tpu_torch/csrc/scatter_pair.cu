// In-place LWW scatter of one steady round for Hopper (sm_90a): K3
// scatter_round.
//
// Replaces the reference package's Pallas kernel `scatter_pair_src_split`
// (_scatter_pair_kernel), constdb_tpu/ops/pallas_dense.py:256.  That kernel
// is one grid step per batch row: the scalar-prefetched slot id drives a
// BlockSpec that gathers one state row, compares the batch pair against it
// and writes it back through aliased outputs.  It splits every int64 into
// hi int32 / lo uint32 planes (TPU vector lanes are 32 bits wide), its
// callers pad the batch to a power of two with rows that must target an
// otherwise untouched state row (the pad-row contract), and the engine
// launches it once per LWW pair, leaving the counter base pair and the
// element del_t max to XLA.
//
// Bound: launch overhead and latency.  A steady round (one 512-frame
// coalescer flush) holds about 1,100 rows after the host folds, over
// three to five scatters.
// Each row is a chain of dependent random accesses (id -> plane row ->
// write) of a few dozen bytes, so the bytes bound is nanoseconds while
// one launch costs microseconds.  The design therefore fuses every scatter
// of a round into ONE launch: the host packs the round's batch columns
// into one buffer (one copy) and passes up to kMaxSegments segment
// descriptors by value as a kernel parameter (__grid_constant__, read in
// place from the parameter bank).  Kinds:
//   * kPairSrc: K3 as before: on a strict lexicographic win of
//     (bp, bs) > (p, s) write p, s and src = base + j (j = row in segment);
//   * kPair: the same compare without a src plane (the counter base pair);
//   * kMax1: a plain max into one plane (the element del_t lockstep).
// One thread owns one row of the concatenated batch and finds its segment
// among the (<= 8) prefix offsets.  Compares are native int64, exactly
// ops/bulk.py _pair_win; no split, no padding: the caller passes exactly
// the real rows.  Planes are updated IN PLACE.
//
// Races: none.  Every segment of a round targets its own planes, and the
// host folds (engine/hostbatch.py fold_pair_rows / fold_el_rows) make the
// ids unique within a segment, so no two threads share a word and no
// atomics are needed.  Two batches of one merge call may repeat ids, so
// the engine never fuses across batches.  Ids outside [0, sp) are skipped,
// as the plain version drops out-of-range rows.

#include <cstdint>
#include <cuda_runtime.h>

// The descriptors are outside the unnamed namespace: the C entry point
// takes a Round, and a parameter type with internal linkage would give
// the entry point internal linkage too (no exported symbol).
constexpr int kMaxSegments = 8;

// Mirrored field for field by ops/kernels.py _Seg / _Round (ctypes).
struct Segment {
  int64_t* p;          // primary plane [sp] (kMax1: the one plane)
  int64_t* s;          // secondary plane [sp] (pairs only)
  int32_t* src;        // win-source plane [sp] (kPairSrc only)
  const int32_t* idx;  // [n] unique plane rows
  const int64_t* bp;   // [n] primary batch column
  const int64_t* bs;   // [n] secondary batch column (pairs only)
  int64_t sp;          // plane length
  int64_t start;       // first row of this segment in the round
  int32_t base;        // kPairSrc: src id of the segment's row 0
  int32_t kind;
};

struct Round {
  Segment seg[kMaxSegments];
  int64_t total;  // rows over all segments
  int32_t count;  // segments in use, 1..kMaxSegments
};

namespace {

constexpr int kThreads = 256;

// Segment kinds (ops/bulk.py PAIR_SRC, PAIR, MAX1).
constexpr int32_t kPairSrc = 0;
constexpr int32_t kPair = 1;
constexpr int32_t kMax1 = 2;

__global__ void __launch_bounds__(kThreads)
scatter_round_kernel(const __grid_constant__ Round r) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= r.total) return;
  int k = 0;
#pragma unroll
  for (int j = 1; j < kMaxSegments; ++j) {
    if (j < r.count && i >= r.seg[j].start) k = j;
  }
  const Segment& g = r.seg[k];
  const int64_t j = i - g.start;
  const int64_t row = g.idx[j];
  if (row < 0 || row >= g.sp) return;
  const int64_t np_ = g.bp[j];
  if (g.kind == kMax1) {
    if (np_ > g.p[row]) g.p[row] = np_;
    return;
  }
  const int64_t ns = g.bs[j];
  const int64_t cp = g.p[row];
  const int64_t cs = g.s[row];
  if (np_ > cp || (np_ == cp && ns > cs)) {
    g.p[row] = np_;
    g.s[row] = ns;
    if (g.kind == kPairSrc) g.src[row] = g.base + static_cast<int32_t>(j);
  }
}

}  // namespace

extern "C" {

// One fused launch over the round's segments (their rows in segment
// order).  Returns cudaGetLastError() right after the launch; the caller
// guarantees 1 <= count <= 8, total >= 1, start offsets ascending from 0,
// and base + n - 1 < 2^31 for every kPairSrc segment.
int constdb_scatter_round(const Round* r, void* stream) {
  if (r->count < 1 || r->count > kMaxSegments || r->total < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t blocks = (r->total + kThreads - 1) / kThreads;
  scatter_round_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(*r);
  return static_cast<int>(cudaGetLastError());
}

const char* constdb_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
