// Per-segment int64 sums for Hopper (sm_90a): K4 segment_sum, fused with
// the counter-base subtraction.
//
// Computes out[ids[i]] += vals[i] - base[i] (mod 2^64) for i < n, base
// optional.  It replaces two steps of the reference package's counter-sum
// re-derivation: the Pallas kernel `segment_sum` (_segment_sum_kernel,
// constdb_tpu/ops/pallas_dense.py:433) and the XLA subtraction
// `val - base` in front of it (constdb_tpu/engine/tpu.py:1555).  The
// Pallas kernel walks the rows one grid step at a time and carries a
// (1, n_seg) VMEM accumulator as hi/lo int32 planes, which caps n_seg at
// 2^20; here every run of equal ids is one atomic on the 64-bit segment
// word, so there is no cap.
//
// Exactness: the int64 words are reinterpreted as unsigned 64-bit and
// subtracted and added with wrap-around, which is int64 two's-complement
// arithmetic bit for bit, and atomicAdd(unsigned long long*) wraps the same
// way in any order: the result does not depend on the atomics' order.
//
// Bound: bytes.  The fused function reads a 4-byte id and two 8-byte words
// per row once and writes the [n_seg] output once: n * 20 + n_seg * 8
// bytes (72.4 MB, 0.0216 ms at 3.35 TB/s, for the 1M-key catch-up's 3.2M
// counter slots).  The unfused chain (a plain subtraction, then the sum)
// moved 124 MB.
//
// The engine's ids are R ascending sweeps: the counter slots of R replica
// batches, each sweep over the counter keys in key order, so neighbouring
// rows hold ids that differ by +1 and never repeat.  The design:
//   * a thread owns ITEMS = 4 consecutive rows of the aligned body: one
//     16-byte load of ids and two 16-byte (longlong2) loads each of vals
//     and base, all streaming (__ldcs: read once, evict first) and all
//     issued before the first atomic;
//   * equal neighbouring ids inside a thread fold in registers, so a run
//     costs one atomic (a sorted or grouped layout pays fewer atomics; the
//     sweep layout pays one per row, as before);
//   * the folded (id, sum) pairs of a warp pass through shared memory and
//     issue in row order across the lanes: atomic k of lane l is row
//     32 k + l of the warp's 128-row tile, so on the sweep layout a warp's
//     32 atomics hit 32 neighbouring words (8 sectors), not 32 words 32
//     bytes apart.  The atomics' results are unused: they compile to
//     RED.E.ADD.64 (fire and forget);
//   * the grid is at most one wave of resident blocks and warps stride
//     over the 128-row tiles;
//   * a scalar head (rows before the first row at which every pointer is
//     16-byte aligned) and tail (n not a multiple of 4) go to block 0.
//     When no common head exists (ids and vals misaligned against each
//     other, as a view with a storage offset can be), ITEMS = 1 is the
//     scalar width variant: one row per thread, plain loads.
//
// Ids outside [0, n_seg) are skipped: the engine passes slot kids that
// index the keys table by construction, and an unchecked id would write
// out of bounds.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 4;
constexpr int kTile = 32 * kItems;   // rows per warp and tile

using u64 = unsigned long long;

__device__ __forceinline__ void add_to(u64* out, int64_t n_seg, int32_t id,
                                      u64 v) {
  if (id >= 0 && static_cast<int64_t>(id) < n_seg) atomicAdd(out + id, v);
}

__device__ __forceinline__ u64 row_value(const int64_t* vals,
                                         const int64_t* base, int64_t i) {
  const u64 v = static_cast<u64>(
      __ldcs(reinterpret_cast<const long long*>(vals + i)));
  return base ? v - static_cast<u64>(__ldcs(
                        reinterpret_cast<const long long*>(base + i)))
              : v;
}

__device__ __forceinline__ void add_row(const int32_t* ids,
                                        const int64_t* vals,
                                        const int64_t* base, int64_t i,
                                        int64_t n_seg, u64* out) {
  add_to(out, n_seg, __ldcs(ids + i), row_value(vals, base, i));
}

__device__ __forceinline__ longlong2 ld2(const int64_t* p) {
  return __ldcs(reinterpret_cast<const longlong2*>(p));
}

// ITEMS = 1: every row scalar.  ITEMS = 4: rows [0, head) and the tail
// after the last whole 4-row vector scalar (block 0), the body in
// vectors.  `base` may be null.
template <int ITEMS>
__global__ void __launch_bounds__(kThreads)
segment_sum_kernel(const int32_t* __restrict__ ids,
                   const int64_t* __restrict__ vals,
                   const int64_t* __restrict__ base, int64_t n, int64_t head,
                   int64_t n_seg, u64* __restrict__ out) {
  if constexpr (ITEMS == 1) {
    const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
    for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
         i < n; i += stride) {
      add_row(ids, vals, base, i, n_seg, out);
    }
  } else {
    static_assert(ITEMS == 4, "one int4 of ids, two longlong2 of words");
    __shared__ __align__(16) int32_t s_id[kWarps][kTile];
    __shared__ __align__(16) u64 s_v[kWarps][kTile];
    const int64_t nv = (n - head) / ITEMS;        // whole vectors
    const int64_t tail = head + nv * ITEMS;
    if (blockIdx.x == 0) {
      const int64_t t = threadIdx.x;
      if (t < head + (n - tail)) {
        add_row(ids, vals, base, t < head ? t : tail + (t - head), n_seg,
                out);
      }
    }
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int32_t* ids_v = ids + head;
    const int64_t* vals_v = vals + head;
    const int64_t* base_v = base ? base + head : nullptr;
    const int64_t tiles = (nv + 31) / 32;
    for (int64_t w = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
         w < tiles; w += static_cast<int64_t>(gridDim.x) * kWarps) {
      const int64_t v = w * 32 + lane;         // this lane's vector
      int32_t id[ITEMS] = {-1, -1, -1, -1};
      u64 x[ITEMS] = {0, 0, 0, 0};
      if (v < nv) {
        const int64_t r = v * ITEMS;
        const int4 a = __ldcs(reinterpret_cast<const int4*>(ids_v + r));
        const longlong2 p = ld2(vals_v + r);
        const longlong2 q = ld2(vals_v + r + 2);
        id[0] = a.x; id[1] = a.y; id[2] = a.z; id[3] = a.w;
        x[0] = p.x; x[1] = p.y; x[2] = q.x; x[3] = q.y;
        if (base_v) {
          const longlong2 b = ld2(base_v + r);
          const longlong2 c = ld2(base_v + r + 2);
          x[0] -= static_cast<u64>(b.x); x[1] -= static_cast<u64>(b.y);
          x[2] -= static_cast<u64>(c.x); x[3] -= static_cast<u64>(c.y);
        }
        // fold runs of equal ids: the sum of a run sits at its last
        // row, every other row of the run is marked empty (id -1)
#pragma unroll
        for (int k = 1; k < ITEMS; ++k) {
          if (id[k] == id[k - 1]) {
            x[k] += x[k - 1];
            id[k - 1] = -1;
          }
        }
      }
      // the lane's rows into the tile in row order, out in lane order
      *reinterpret_cast<int4*>(&s_id[warp][lane * ITEMS]) =
          make_int4(id[0], id[1], id[2], id[3]);
      *reinterpret_cast<ulonglong2*>(&s_v[warp][lane * ITEMS]) =
          make_ulonglong2(x[0], x[1]);
      *reinterpret_cast<ulonglong2*>(&s_v[warp][lane * ITEMS + 2]) =
          make_ulonglong2(x[2], x[3]);
      __syncwarp();
#pragma unroll
      for (int k = 0; k < ITEMS; ++k) {
        const int j = k * 32 + lane;
        add_to(out, n_seg, s_id[warp][j], s_v[warp][j]);
      }
      __syncwarp();
    }
  }
}

template <int ITEMS>
int launch(const void* ids, const void* vals, const void* base, int64_t n,
           int64_t head, int64_t n_seg, void* out, void* stream) {
  auto* kernel = &segment_sum_kernel<ITEMS>;
  // one wave: resident blocks per SM times the SMs, asked once
  static const int wave = [kernel] {
    int dev = 0, sms = 0, per = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kernel, kThreads, 0);
    return (sms > 0 ? sms : 1) * (per > 0 ? per : 1);
  }();
  const int64_t rows_per_block =
      ITEMS == 1 ? kThreads : static_cast<int64_t>(kWarps) * kTile;
  int64_t blocks = (n + rows_per_block - 1) / rows_per_block;
  if (blocks > wave) blocks = wave;
  if (blocks < 1) blocks = 1;
  kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(ids), static_cast<const int64_t*>(vals),
      static_cast<const int64_t*>(base), n, head, n_seg,
      static_cast<u64*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// out[ids[i]] += vals[i] - base[i] for i < n (base may be null: no
// subtraction).  `out` must hold n_seg zeros (the wrapper allocates it
// with torch.zeros).  `head` selects the width: -1 = the scalar variant
// (ITEMS = 1); else 0 <= head < 4 rows go scalar, after which ids, vals
// and base are 16-byte aligned (the wrapper computes it from the
// pointers).  Returns cudaGetLastError() right after the launch; the
// caller guarantees n >= 1.
int constdb_segment_sum(const void* ids, const void* vals, const void* base,
                        int64_t n, int64_t head, int64_t n_seg, void* out,
                        void* stream) {
  if (n < 1 || head >= kItems || head > n) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (head < 0) {
    return launch<1>(ids, vals, base, n, 0, n_seg, out, stream);
  }
  return launch<kItems>(ids, vals, base, n, head, n_seg, out, stream);
}

const char* constdb_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
