// Tensor-register strategy reduction for Hopper (sm_90a): K5
// tensor_take_reduce.
//
// Replaces the reference package's Pallas kernel `tensor_reduce`
// (_tensor_reduce_kernel), constdb_tpu/ops/pallas_dense.py:380.  That
// kernel runs one grid step per (key, 512-lane block), loads the [n, 512]
// contributor slab the caller gathered beforehand, and folds it with the
// exact sequential operation chain of crdt.tensor.reduce_rows.  It is
// f32-only (TPU lanes are 32 bits), so the reference sends f64 to its XLA
// twin, and avg never reaches it: the reference composes avg as a separate
// scale, then the kernel's sum, then a divide, so that XLA cannot fuse the
// multiply into an FMA.
//
// Bound: bytes.  A read of G keys with n contributors of Kp elements reads
// G * n * Kp payload words once from the resident pool and writes G * Kp.
// The design moves each of those bytes once, with enough of them in
// flight to cover the memory latency:
//   * one thread owns a vector of W columns (16 bytes: 4 x f32, 2 x f64;
//     the wrapper picks the widest W that divides Kp and the pointers'
//     alignment, and W = 1 is the scalar path for odd widths), so every
//     load is one coalesced 16-byte streaming (evict-first) access;
//   * a block owns (group g, a chunk of kThreads vectors); its group's
//     contributor rows (premultiplied by Kp) and, for avg, weights sit in
//     shared memory, loaded once per chunk of kChunk contributors, so no
//     payload load waits behind an id load;
//   * all contributor loads of a chunk are issued into a register array
//     before the fold consumes them: n <= 8 (a template parameter) is one
//     chunk, larger n loops over chunks of 8 and stays a kernel path;
//   * the grid is at most one wave (blocks per SM from the occupancy API
//     times the SM count) and blocks stride over the (g, chunk) items.
//
// Bit identity with the host reference (the canonical-order law): the
// fold consumes contributors strictly in canonical order i = 0..n-1 with
//   * explicitly rounded intrinsics (__fadd_rn / __fsub_rn / __fmul_rn /
//     __fdiv_rn and their f64 twins), so nvcc's default -fmad=true can
//     never contract anything into an FMA;
//   * the trimmed-mean divisor as a runtime argument (a constant divisor
//     could become a reciprocal multiply, which rounds differently);
//   * numpy's min/max rule as explicit selects (np.minimum / np.maximum:
//     keep the running value when strictly smaller / larger or NaN, else
//     take the new one), and maxmag replacing only when |x| > |acc|;
//   * avg fused: each product x * w[g, i] rounds on its own (__fmul_rn),
//     the rounded products sum in order (__fadd_rn) and the sum divides by
//     the host-accumulated count total tot[g] (__fdiv_rn): bit for bit
//     the reference's scale -> sum -> divide chain, in one pass.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 8;

// Strategy ids of crdt/tensor.py.
constexpr int kSum = 1;
constexpr int kAvg = 2;
constexpr int kMaxMag = 3;
constexpr int kTrimmed = 4;
// trimmed-mean with n <= 2: the plain sum divided by n
constexpr int kSumDiv = 5;

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
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
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

// W elements of T moved as one access of sizeof(T) * W bytes (one
// LDG/STG.E.128 at 16 bytes).  Loads are streaming (__ldcs: ld.global.cs,
// evict-first in L1 and L2): each payload word is read once per call, so
// the read should not push other data out of the L2 or make it write
// back dirty lines.
template <typename T, int W>
struct alignas(sizeof(T) * W) Vec {
  T v[W];
};

template <typename T, int W> struct Ld;
template <> struct Ld<float, 4> {
  static __device__ __forceinline__ Vec<float, 4> go(const float* p) {
    const float4 a = __ldcs(reinterpret_cast<const float4*>(p));
    return {{a.x, a.y, a.z, a.w}};
  }
};
template <> struct Ld<float, 2> {
  static __device__ __forceinline__ Vec<float, 2> go(const float* p) {
    const float2 a = __ldcs(reinterpret_cast<const float2*>(p));
    return {{a.x, a.y}};
  }
};
template <> struct Ld<float, 1> {
  static __device__ __forceinline__ Vec<float, 1> go(const float* p) {
    return {{__ldcs(p)}};
  }
};
template <> struct Ld<double, 2> {
  static __device__ __forceinline__ Vec<double, 2> go(const double* p) {
    const double2 a = __ldcs(reinterpret_cast<const double2*>(p));
    return {{a.x, a.y}};
  }
};
template <> struct Ld<double, 1> {
  static __device__ __forceinline__ Vec<double, 1> go(const double* p) {
    return {{__ldcs(p)}};
  }
};

template <typename T, int W>
__device__ __forceinline__ Vec<T, W> load_vec(const T* p) {
  return Ld<T, W>::go(p);
}

template <typename T, int W>
__device__ __forceinline__ void store_vec(T* p, const Vec<T, W>& x) {
  *reinterpret_cast<Vec<T, W>*>(p) = x;
}

// Running values of one thread's W columns.
template <typename T, int W>
struct Fold {
  T acc[W];
  T mn[W];
  T mx[W];
};

template <typename T, int W>
__device__ __forceinline__ void fold_in(Fold<T, W>& f, const Vec<T, W>& x,
                                        T wi, int mode, bool first) {
#pragma unroll
  for (int e = 0; e < W; ++e) {
    const T v = mode == kAvg ? mul_rn(x.v[e], wi) : x.v[e];
    if (first) {
      f.acc[e] = v;
      f.mn[e] = v;
      f.mx[e] = v;
    } else if (mode == kMaxMag) {
      f.acc[e] = abs_of(v) > abs_of(f.acc[e]) ? v : f.acc[e];
    } else if (mode == kTrimmed) {
      f.acc[e] = add_rn(f.acc[e], v);
      f.mn[e] = (f.mn[e] < v || is_nan(f.mn[e])) ? f.mn[e] : v;
      f.mx[e] = (f.mx[e] > v || is_nan(f.mx[e])) ? f.mx[e] : v;
    } else {  // kSum, kSumDiv, kAvg
      f.acc[e] = add_rn(f.acc[e], v);
    }
  }
}

// N > 0: exactly N contributors (one chunk, fully unrolled); N == 0: any
// n, in chunks of kChunk.
template <typename T, int W, int N>
__global__ void __launch_bounds__(kThreads)
take_reduce_kernel(const T* __restrict__ buf,
                   const int32_t* __restrict__ idx,
                   const T* __restrict__ w, const T* __restrict__ tot,
                   int64_t groups, int n_rt, int64_t kp, T div, int mode,
                   T* __restrict__ out) {
  __shared__ int64_t s_off[kChunk];
  __shared__ T s_w[kChunk];
  const int n = N > 0 ? N : n_rt;
  const int64_t kv = kp / W;                       // vectors per row
  const int64_t chunks = (kv + kThreads - 1) / kThreads;
  const int64_t items = groups * chunks;
  for (int64_t it = blockIdx.x; it < items; it += gridDim.x) {
    const int64_t g = it / chunks;
    const int64_t v = (it - g * chunks) * kThreads + threadIdx.x;
    const bool live = v < kv;
    const int64_t col = v * W;
    Fold<T, W> f;
    for (int c0 = 0; c0 < n; c0 += kChunk) {
      const int m = n - c0 < kChunk ? n - c0 : kChunk;
      if (threadIdx.x < m) {
        const int64_t r = g * n + c0 + threadIdx.x;
        s_off[threadIdx.x] = static_cast<int64_t>(idx[r]) * kp;
        s_w[threadIdx.x] = mode == kAvg ? w[r] : T(0);
      }
      __syncthreads();
      if (live) {
        Vec<T, W> x[kChunk];
#pragma unroll
        for (int i = 0; i < kChunk; ++i) {
          if (i < m) x[i] = load_vec<T, W>(buf + s_off[i] + col);
        }
#pragma unroll
        for (int i = 0; i < kChunk; ++i) {
          if (i < m) fold_in<T, W>(f, x[i], s_w[i], mode, c0 + i == 0);
        }
      }
      __syncthreads();
    }
    if (live) {
      const T d = mode == kAvg ? tot[g] : div;
      Vec<T, W> y;
#pragma unroll
      for (int e = 0; e < W; ++e) {
        T a = f.acc[e];
        if (mode == kTrimmed) {
          a = div_rn(sub_rn(sub_rn(a, f.mn[e]), f.mx[e]), d);
        } else if (mode == kSumDiv || mode == kAvg) {
          a = div_rn(a, d);
        }
        y.v[e] = a;
      }
      store_vec<T, W>(out + g * kp + col, y);
    }
  }
}

template <typename T, int W, int N>
int launch(const void* buf, const void* idx, const void* w, const void* tot,
           int64_t g, int n, int64_t kp, double div, int mode, void* out,
           void* stream) {
  auto* kernel = &take_reduce_kernel<T, W, N>;
  // one wave: resident blocks per SM (registers decide) times the SMs,
  // asked once per instantiation
  static const int wave = [kernel] {
    int dev = 0, sms = 0, per = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kernel, kThreads, 0);
    return (sms > 0 ? sms : 1) * (per > 0 ? per : 1);
  }();
  const int64_t kv = kp / W;
  const int64_t items = g * ((kv + kThreads - 1) / kThreads);
  const int64_t blocks = items < wave ? items : wave;
  take_reduce_kernel<T, W, N><<<static_cast<unsigned int>(blocks), kThreads,
                                0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(buf), static_cast<const int32_t*>(idx),
      static_cast<const T*>(w), static_cast<const T*>(tot), g, n, kp,
      static_cast<T>(div), mode, static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int W>
int launch_n(const void* buf, const void* idx, const void* w,
             const void* tot, int64_t g, int n, int64_t kp, double div,
             int mode, void* out, void* stream) {
  switch (n) {
#define CONSTDB_N(k)                                                      \
  case k:                                                                 \
    return launch<T, W, k>(buf, idx, w, tot, g, n, kp, div, mode, out,    \
                           stream);
    CONSTDB_N(1)
    CONSTDB_N(2)
    CONSTDB_N(3)
    CONSTDB_N(4)
    CONSTDB_N(5)
    CONSTDB_N(6)
    CONSTDB_N(7)
    CONSTDB_N(8)
#undef CONSTDB_N
    default:
      return launch<T, W, 0>(buf, idx, w, tot, g, n, kp, div, mode, out,
                             stream);
  }
}

}  // namespace

extern "C" {

// buf: [C, kp] pool of the payload dtype (f64 = 1, else f32); idx: [g * n]
// int32 pool rows, n contributors per group in canonical order; w: [g * n]
// count weights and tot: [g] count totals in the payload dtype (avg only,
// else ignored); out: [g, kp].  `div` is the trimmed-mean divisor, exact
// in either dtype; `vec` the columns per access (f32: 4, 2 or 1; f64: 2 or
// 1), which must divide kp and match the pointers' alignment.  Returns
// cudaGetLastError() right after the launch; the caller guarantees g, n,
// kp >= 1.
int constdb_tensor_take_reduce(const void* buf, const void* idx,
                               const void* w, const void* tot, int64_t g,
                               int n, int64_t kp, double div, int strat,
                               int f64, int vec, void* out, void* stream) {
  if (g < 1 || n < 1 || kp < 1 || kp % vec != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int mode;
  switch (strat) {
    case kSum:
    case kAvg:
    case kMaxMag:
      mode = strat;
      break;
    case kTrimmed:
      mode = n <= 2 ? kSumDiv : kTrimmed;
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (f64) {
    if (vec == 2) {
      return launch_n<double, 2>(buf, idx, w, tot, g, n, kp, div, mode, out,
                                 stream);
    }
    if (vec == 1) {
      return launch_n<double, 1>(buf, idx, w, tot, g, n, kp, div, mode, out,
                                 stream);
    }
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (vec == 4) {
    return launch_n<float, 4>(buf, idx, w, tot, g, n, kp, div, mode, out,
                              stream);
  }
  if (vec == 2) {
    return launch_n<float, 2>(buf, idx, w, tot, g, n, kp, div, mode, out,
                              stream);
  }
  if (vec == 1) {
    return launch_n<float, 1>(buf, idx, w, tot, g, n, kp, div, mode, out,
                              stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* constdb_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
