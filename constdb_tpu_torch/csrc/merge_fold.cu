// Aligned R-replica fold kernels for Hopper (sm_90a): K1 merge_elems and
// K2 merge_counters.
//
// Replace the reference package's Pallas kernels in
// constdb_tpu/ops/pallas_dense.py: `merge_elems` (_elems_kernel, :105) and
// `merge_counters` (_counters_kernel, :152).  The Pallas versions split
// every int64 into hi/lo 32-bit planes and pad S to a 512 multiple because
// TPU VMEM lanes are 32-bit; Hopper compares int64 natively, so both
// artifacts are gone here.
//
// Layout: every input is a contiguous [R, S] int64 stack (row r = replica
// batch r), outputs are [S].  A thread owns columns and walks the R rows,
// so loads along S are coalesced for every r and no cross-thread
// reduction is needed.
//
// Bound: bytes.  Per column the kernels read 8 * R bytes per input plane
// and write 8 bytes per output, with a handful of integer compares per
// element, far below the card's integer rate.
//
// K2 (redesigned; K1 is next and keeps its first body here, one thread
// per column and a runtime loop of scalar loads, so that each redesign
// is measured on its own):
//   * R is a template parameter for R = 1..8, so all 2R loads of a
//     thread's columns are issued before the first compare; larger R runs
//     the looped instantiation (R = 0), which issues the loads of 8 rows
//     at a time before folding them;
//   * a thread owns W = 2 columns through 16-byte longlong2 loads and
//     stores when S is even and every plane is 16-byte aligned (the
//     wrapper picks W); W = 1 is the scalar width variant;
//   * loads stream (__ldcs: every input word is read once);
//   * the grid is at most one wave of resident blocks, striding over the
//     column vectors, with 128-thread blocks so that the 1M-key
//     catch-up's [8, 131072] stacks spread over every SM.
//
// Semantics (== ops/dense.py plain versions, bit for bit):
//   K1: lexicographic (add_t, add_node) max over R, the FIRST row that
//       achieves it (a later row replaces the winner only when strictly
//       greater), and an independent max of del_t.  win is int64.
//   K2: lexicographic (uuid, value) max over R (LWW, max value on ties),
//       the native int64 compare, so values below NEUTRAL_T follow the
//       Pallas kernel.

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

constexpr int kK2Threads = 128;
constexpr int kK2Chunk = 8;

// W int64 columns moved as one access (one 16-byte access at W = 2).
template <int W>
struct Cols {
  int64_t v[W];
};

template <int W>
__device__ __forceinline__ Cols<W> load_cols(const int64_t* p) {
  if constexpr (W == 2) {
    const longlong2 a = __ldcs(reinterpret_cast<const longlong2*>(p));
    return {{a.x, a.y}};
  } else {
    return {{__ldcs(reinterpret_cast<const long long*>(p))}};
  }
}

template <int W>
__device__ __forceinline__ void store_cols(int64_t* p, const Cols<W>& c) {
  if constexpr (W == 2) {
    *reinterpret_cast<longlong2*>(p) = make_longlong2(c.v[0], c.v[1]);
  } else {
    *p = c.v[0];
  }
}

// (best_t, best_v) <- (t, v) where (t, v) is lexicographically greater
template <int W>
__device__ __forceinline__ void fold_counter(Cols<W>& bt, Cols<W>& bv,
                                             const Cols<W>& t,
                                             const Cols<W>& v) {
#pragma unroll
  for (int e = 0; e < W; ++e) {
    if (t.v[e] > bt.v[e] || (t.v[e] == bt.v[e] && v.v[e] > bv.v[e])) {
      bt.v[e] = t.v[e];
      bv.v[e] = v.v[e];
    }
  }
}

// R > 0: exactly R rows, all 2R loads issued before the fold; R == 0: any
// `rows`, in chunks of kK2Chunk rows.
template <int R, int W>
__global__ void __launch_bounds__(kK2Threads)
merge_counters_kernel(const int64_t* __restrict__ vals,
                      const int64_t* __restrict__ ts, int rows, int64_t cols,
                      int64_t* __restrict__ o_val, int64_t* __restrict__ o_t) {
  const int64_t nvec = cols / W;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t c = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       c < nvec; c += stride) {
    const int64_t col = c * W;
    Cols<W> bt, bv;
    if constexpr (R > 0) {
      Cols<W> t[R], v[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        t[r] = load_cols<W>(ts + r * cols + col);
        v[r] = load_cols<W>(vals + r * cols + col);
      }
      bt = t[0];
      bv = v[0];
#pragma unroll
      for (int r = 1; r < R; ++r) fold_counter<W>(bt, bv, t[r], v[r]);
    } else {
      bt = load_cols<W>(ts + col);
      bv = load_cols<W>(vals + col);
      for (int r0 = 1; r0 < rows; r0 += kK2Chunk) {
        const int m = rows - r0 < kK2Chunk ? rows - r0 : kK2Chunk;
        Cols<W> t[kK2Chunk], v[kK2Chunk];
#pragma unroll
        for (int i = 0; i < kK2Chunk; ++i) {
          if (i < m) {
            const int64_t off = static_cast<int64_t>(r0 + i) * cols + col;
            t[i] = load_cols<W>(ts + off);
            v[i] = load_cols<W>(vals + off);
          }
        }
#pragma unroll
        for (int i = 0; i < kK2Chunk; ++i) {
          if (i < m) fold_counter<W>(bt, bv, t[i], v[i]);
        }
      }
    }
    store_cols<W>(o_val + col, bv);
    store_cols<W>(o_t + col, bt);
  }
}

template <int R, int W>
int launch_counters(const void* vals, const void* ts, int rows, int64_t cols,
                    void* o_val, void* o_t, void* stream) {
  auto* kernel = &merge_counters_kernel<R, W>;
  // one wave: resident blocks per SM times the SMs, asked once per
  // instantiation
  static const int wave = [kernel] {
    int dev = 0, sms = 0, per = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kernel, kK2Threads,
                                                  0);
    return (sms > 0 ? sms : 1) * (per > 0 ? per : 1);
  }();
  const int64_t nvec = cols / W;
  int64_t blocks = (nvec + kK2Threads - 1) / kK2Threads;
  if (blocks > wave) blocks = wave;
  kernel<<<static_cast<unsigned int>(blocks), kK2Threads, 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(vals), static_cast<const int64_t*>(ts),
      rows, cols, static_cast<int64_t*>(o_val), static_cast<int64_t*>(o_t));
  return static_cast<int>(cudaGetLastError());
}

template <int W>
int launch_counters_r(const void* vals, const void* ts, int rows,
                      int64_t cols, void* o_val, void* o_t, void* stream) {
  switch (rows) {
#define CONSTDB_R(k)                                                       \
  case k:                                                                  \
    return launch_counters<k, W>(vals, ts, rows, cols, o_val, o_t, stream);
    CONSTDB_R(1)
    CONSTDB_R(2)
    CONSTDB_R(3)
    CONSTDB_R(4)
    CONSTDB_R(5)
    CONSTDB_R(6)
    CONSTDB_R(7)
    CONSTDB_R(8)
#undef CONSTDB_R
    default:
      return launch_counters<0, W>(vals, ts, rows, cols, o_val, o_t, stream);
  }
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

// `vec` is the columns per thread: 2 (cols even and every pointer 16-byte
// aligned) or 1.
int constdb_merge_counters(const void* vals, const void* ts, int rows,
                           int64_t cols, int vec, void* o_val, void* o_t,
                           void* stream) {
  if (rows < 1 || cols < 1 || (vec != 1 && vec != 2) || cols % vec != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (vec == 2) {
    return launch_counters_r<2>(vals, ts, rows, cols, o_val, o_t, stream);
  }
  return launch_counters_r<1>(vals, ts, rows, cols, o_val, o_t, stream);
}

const char* constdb_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
