// Tensor-register strategy reduction for Hopper (sm_90a): K5
// tensor_take_reduce.
//
// Replaces the reference package's Pallas kernel `tensor_reduce`
// (_tensor_reduce_kernel) in constdb_tpu/ops/pallas_dense.py.  That kernel
// runs one grid step per (key, 512-lane block), loads the [n, 512]
// contributor slab the caller gathered beforehand, and folds it with the
// exact sequential operation chain of crdt.tensor.reduce_rows.  It is
// f32-only (TPU lanes are 32 bits), so the reference sends f64 to its XLA
// twin.
//
// Here one thread owns one (g, k) column of the [G, Kp] result and reads
// its n contributors straight from the resident payload pool through
// idx[g * n + i], which fuses the gather (no [G, n, Kp] intermediate), then
// walks i = 0..n-1 in canonical order.  One template serves f32 and f64.
//
// Bit identity with the host reference (the canonical-order law):
//   * every add, subtract and divide is an explicitly rounded intrinsic
//     (__fadd_rn / __dadd_rn ...), so nvcc's default -fmad=true can never
//     contract anything into an FMA;
//   * the trimmed-mean divisor arrives as a runtime argument and divides
//     with __fdiv_rn / __ddiv_rn: a constant divisor could be rewritten as
//     a reciprocal multiply, which rounds differently;
//   * min and max are explicit selects with numpy's rule (np.minimum /
//     np.maximum): keep the running value when it is strictly smaller
//     (larger) or NaN, else take the new value — so NaN propagates and a
//     +0/-0 tie takes the newer operand, bit for bit;
//   * maxmag replaces only when |x| > |acc|, strictly.
// avg never reaches this kernel: its products must round before the sum,
// so the engine composes scale (a separate multiply) -> this kernel with
// STRAT_SUM -> divide.
//
// Bound: bytes.  Each thread reads n payload words (coalesced along k:
// neighbouring threads read neighbouring words of the same pool row) and
// writes one; idx is read once per thread from L1.  The design reads each
// contributor row once and keeps the running values in registers.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// Strategy ids of crdt/tensor.py.
constexpr int kSum = 1;
constexpr int kMaxMag = 3;
constexpr int kTrimmed = 4;

__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double sub_rn(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ float div_rn(float a, float b) {
  return __fdiv_rn(a, b);
}
__device__ __forceinline__ double div_rn(double a, double b) {
  return __ddiv_rn(a, b);
}
__device__ __forceinline__ float abs_of(float a) { return fabsf(a); }
__device__ __forceinline__ double abs_of(double a) { return fabs(a); }
// NaN is the one value unequal to itself (nvcc keeps the compare: the
// build uses no fast-math flag)
template <typename T>
__device__ __forceinline__ bool is_nan(T a) { return a != a; }

template <typename T>
__global__ void take_reduce_kernel(const T* __restrict__ buf,
                                   const int32_t* __restrict__ idx,
                                   int64_t groups, int n, int64_t kp, T div,
                                   int strat, T* __restrict__ out) {
  const int64_t k = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (k >= kp) return;
  for (int64_t g = blockIdx.y; g < groups; g += gridDim.y) {
    const int32_t* rows = idx + g * n;
    const T x0 = buf[static_cast<int64_t>(rows[0]) * kp + k];
    T acc = x0;
    if (strat == kSum || (strat == kTrimmed && n <= 2)) {
      for (int i = 1; i < n; ++i) {
        acc = add_rn(acc, buf[static_cast<int64_t>(rows[i]) * kp + k]);
      }
      if (strat == kTrimmed) acc = div_rn(acc, div);
    } else if (strat == kMaxMag) {
      for (int i = 1; i < n; ++i) {
        const T x = buf[static_cast<int64_t>(rows[i]) * kp + k];
        acc = abs_of(x) > abs_of(acc) ? x : acc;
      }
    } else {  // kTrimmed, n > 2
      T mn = x0;
      T mx = x0;
      for (int i = 1; i < n; ++i) {
        const T x = buf[static_cast<int64_t>(rows[i]) * kp + k];
        acc = add_rn(acc, x);
        mn = (mn < x || is_nan(mn)) ? mn : x;
        mx = (mx > x || is_nan(mx)) ? mx : x;
      }
      acc = div_rn(sub_rn(sub_rn(acc, mn), mx), div);
    }
    out[g * kp + k] = acc;
  }
}

template <typename T>
int launch(const void* buf, const void* idx, int64_t g, int n, int64_t kp,
           double div, int strat, void* out, void* stream) {
  // grid.y is capped at 65535; larger group counts stride over it
  const dim3 grid(static_cast<unsigned int>((kp + kThreads - 1) / kThreads),
                  static_cast<unsigned int>(g < 65535 ? g : 65535));
  take_reduce_kernel<T><<<grid, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(buf), static_cast<const int32_t*>(idx), g, n, kp,
      static_cast<T>(div), strat, static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// buf: [C, kp] pool of the payload dtype (f64 = 1, else f32); idx: [g * n]
// int32 pool rows, n contributors per group in canonical order; out:
// [g, kp].  `div` is the trimmed-mean divisor, exact in either dtype.
// Returns cudaGetLastError() right after the launch; the caller
// guarantees g, n, kp >= 1 and a strategy of kSum, kMaxMag or kTrimmed.
int constdb_tensor_take_reduce(const void* buf, const void* idx, int64_t g,
                               int n, int64_t kp, double div, int strat,
                               int f64, void* out, void* stream) {
  if (f64) return launch<double>(buf, idx, g, n, kp, div, strat, out, stream);
  return launch<float>(buf, idx, g, n, kp, div, strat, out, stream);
}

const char* constdb_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
