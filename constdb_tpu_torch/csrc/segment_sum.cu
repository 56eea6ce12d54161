// Per-segment int64 sums for Hopper (sm_90a): K4 segment_sum.
//
// Replaces the reference package's Pallas kernel `segment_sum`
// (_segment_sum_kernel) in constdb_tpu/ops/pallas_dense.py.  That kernel
// walks the rows one grid step at a time and carries a (1, n_seg) VMEM
// accumulator as hi/lo int32 planes with an explicit carry, which caps
// n_seg at 2^20 (SEGMENT_SUM_MAX_SEG).  Here every row is one atomicAdd on
// the 64-bit segment word in device memory, so there is no scratch cap.
//
// Exactness: the int64 values are reinterpreted as unsigned 64-bit words
// and added with atomicAdd(unsigned long long*), which wraps mod 2^64 —
// bit-identical to int64 two's-complement addition in any order, so the
// result does not depend on the atomics' arrival order.
//
// Bound: bytes.  Each row reads a 4-byte id and an 8-byte value (coalesced,
// grid-stride) and performs one 8-byte atomic on the output; the output
// [n_seg] is written once by the caller's zero fill and then updated by
// atomics that mostly hit L2 (a 1M-segment output is 8 MB).
//
// Ids outside [0, n_seg) are skipped: the engine passes slot kids that
// index the keys table by construction, and an unchecked id would write
// out of bounds.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void segment_sum_kernel(const int32_t* __restrict__ ids,
                                   const int64_t* __restrict__ vals,
                                   int64_t n, int64_t n_seg,
                                   unsigned long long* __restrict__ out) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const int64_t seg = ids[i];
    if (seg >= 0 && seg < n_seg) {
      atomicAdd(out + seg, static_cast<unsigned long long>(vals[i]));
    }
  }
}

}  // namespace

extern "C" {

// `out` must hold n_seg zeros (the wrapper allocates it with torch.zeros).
// Returns cudaGetLastError() right after the launch; the caller
// guarantees n >= 1.
int constdb_segment_sum(const void* ids, const void* vals, int64_t n,
                        int64_t n_seg, void* out, void* stream) {
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > (1 << 20)) blocks = 1 << 20;
  segment_sum_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(ids), static_cast<const int64_t*>(vals), n,
      n_seg, static_cast<unsigned long long*>(out));
  return static_cast<int>(cudaGetLastError());
}

const char* constdb_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
