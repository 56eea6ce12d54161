// Aligned R-replica fold kernels for Hopper (sm_90a): K1 merge_elems,
// fused with the fold's apply onto the resident state, and K2
// merge_counters.
//
// Replace the reference package's Pallas kernels in
// constdb_tpu/ops/pallas_dense.py: `merge_elems` (_elems_kernel, :105) and
// `merge_counters` (_counters_kernel, :152).  The Pallas versions split
// every int64 into hi/lo 32-bit planes and pad S to a 512 multiple because
// TPU VMEM lanes are 32-bit; Hopper compares int64 natively, so both
// artifacts are gone here.
//
// Layout: every stack is a contiguous [R, S] int64 array (row r = replica
// batch r).  A thread owns columns and walks the R rows, so loads along S
// are coalesced for every r and no cross-thread reduction is needed.
//
// K1 (fold_apply_kernel) computes, for each column s, the fold of the R
// rows and, in its APPLY mode, also the step the reference runs next as a
// separate XLA op (constdb_tpu/ops/bulk.py bulk_elems :267, bulk_lww
// :118): the batch's (add_t, add_node) winner replaces the state row
// idx[s] where it is strictly greater, the row's del_t takes the max, and
// win[s] (int32) is the winning batch row where the batch beat the state,
// else -1.  Columns whose idx lies outside [0, size) (the pad rows of the
// ops/bulk.py protocol) write no state row and win -1.  A batch holds
// each slot once (ColumnarBatch.rows_unique_per_slot), so no two threads
// write one row: no atomics.  The fold-only mode (APPLY = false) writes
// the fold's four [S] outputs instead, as the Pallas kernel does.
// HAS_DEL = false is the register variant: no del plane is read, written
// or allocated (the reference fakes it with a zero stack).
//
// Bound: bytes.  Per column, K1 applying to elements reads 8 R bytes of
// each of its three stacks, a 4-byte idx and the row's three state words,
// and writes what changed plus the 4-byte winner: about 248 bytes at
// R = 8, 130 MB (0.039 ms at 3.35 TB/s) at the catch-up's [8, 524288].
// K2 reads 8 R bytes per input plane and writes 8 bytes per output.  The
// compares are a handful of integer operations per element, far below
// the card's integer rate.
//
// The design, shared by K1 and K2:
//   * R is a template parameter for R = 1..8, so every load of a thread's
//     columns is issued before the first compare; larger R runs the looped
//     instantiation (R = 0), which issues the loads of 8 rows at a time
//     before folding them;
//   * a thread owns W = 2 columns through 16-byte longlong2 loads and
//     stores (K1's idx and winner as one 8-byte int2) when S is even and
//     every stack and output is aligned for it (the wrapper picks W);
//     W = 1 is the scalar width variant for odd widths and offset views;
//   * stack loads stream (__ldcs: every input word is read once);
//   * K1 loads its idx and the state rows before the stacks, so the
//     dependent state gather overlaps the stack loads.  The engine's idx
//     is an ascending run of rows, so the gather and scatter coalesce;
//   * the grid is at most one wave of resident blocks, striding over the
//     column vectors, with 128-thread blocks so that the catch-up's
//     stacks spread over every SM.
//
// Semantics (== ops/dense.py and ops/bulk.py plain versions, bit for bit):
//   K1: lexicographic (add_t, add_node) max over R, the FIRST row that
//       achieves it (a later row replaces the winner only when strictly
//       greater), and an independent max of del_t; the apply is
//       ops/bulk.py bulk_elems / bulk_lww (fold_apply).
//   K2: lexicographic (uuid, value) max over R (LWW, max value on ties),
//       the native int64 compare, so values below NEUTRAL_T follow the
//       Pallas kernel.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kK1Threads = 128;
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

// ------------------------------------------------------------------- K1

struct K1Args {
  const int64_t* at;
  const int64_t* an;
  const int64_t* dt;    // null when !HAS_DEL
  int rows;
  int64_t cols;
  // APPLY: idx, the state planes and the winner
  const int32_t* idx;
  int64_t* st_at;
  int64_t* st_an;
  int64_t* st_dt;       // null when !HAS_DEL
  int64_t size;
  int32_t* win;
  // fold-only: the four [S] outputs
  int64_t* o_at;
  int64_t* o_an;
  int64_t* o_dt;        // null when !HAS_DEL
  int64_t* o_win;
};

// The running fold of W columns: (t, node) winner, its row, del_t max.
template <int W>
struct Best {
  Cols<W> t, n, d;
  int r[W];
};

// Row `r` (its t, node and, HAS_DEL, del_t) into the running fold.
template <bool HAS_DEL, int W>
__device__ __forceinline__ void fold_row(Best<W>& b, const Cols<W>& t,
                                         const Cols<W>& n, const Cols<W>& d,
                                         int r) {
#pragma unroll
  for (int e = 0; e < W; ++e) {
    if (t.v[e] > b.t.v[e] || (t.v[e] == b.t.v[e] && n.v[e] > b.n.v[e])) {
      b.t.v[e] = t.v[e];
      b.n.v[e] = n.v[e];
      b.r[e] = r;
    }
    if constexpr (HAS_DEL) {
      if (d.v[e] > b.d.v[e]) b.d.v[e] = d.v[e];
    }
  }
}

// R > 0: exactly R rows, all loads issued before the fold; R == 0: any
// `rows`, in chunks of kK2Chunk rows.
template <int R, bool HAS_DEL, int W>
__device__ __forceinline__ Best<W> fold_cols(const K1Args& a, int64_t col) {
  Best<W> b;
  Cols<W> none{};
  if constexpr (R > 0) {
    // the register variant keeps one neutral del slot and loads none
    Cols<W> t[R], n[R], d[HAS_DEL ? R : 1];
    d[0] = none;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      t[r] = load_cols<W>(a.at + r * a.cols + col);
      n[r] = load_cols<W>(a.an + r * a.cols + col);
      if constexpr (HAS_DEL) d[r] = load_cols<W>(a.dt + r * a.cols + col);
    }
    b.t = t[0];
    b.n = n[0];
    b.d = d[0];
#pragma unroll
    for (int e = 0; e < W; ++e) b.r[e] = 0;
#pragma unroll
    for (int r = 1; r < R; ++r) {
      fold_row<HAS_DEL, W>(b, t[r], n[r], d[HAS_DEL ? r : 0], r);
    }
  } else {
    b.t = load_cols<W>(a.at + col);
    b.n = load_cols<W>(a.an + col);
    b.d = none;
    if constexpr (HAS_DEL) b.d = load_cols<W>(a.dt + col);
#pragma unroll
    for (int e = 0; e < W; ++e) b.r[e] = 0;
    for (int r0 = 1; r0 < a.rows; r0 += kK2Chunk) {
      const int m = a.rows - r0 < kK2Chunk ? a.rows - r0 : kK2Chunk;
      Cols<W> t[kK2Chunk], n[kK2Chunk], d[kK2Chunk];
#pragma unroll
      for (int i = 0; i < kK2Chunk; ++i) {
        d[i] = none;
        if (i < m) {
          const int64_t off = static_cast<int64_t>(r0 + i) * a.cols + col;
          t[i] = load_cols<W>(a.at + off);
          n[i] = load_cols<W>(a.an + off);
          if constexpr (HAS_DEL) d[i] = load_cols<W>(a.dt + off);
        }
      }
#pragma unroll
      for (int i = 0; i < kK2Chunk; ++i) {
        if (i < m) fold_row<HAS_DEL, W>(b, t[i], n[i], d[i], r0 + i);
      }
    }
  }
  return b;
}

template <int R, bool HAS_DEL, bool APPLY, int W>
__global__ void __launch_bounds__(kK1Threads)
fold_apply_kernel(const K1Args a) {
  const int64_t nvec = a.cols / W;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t c = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       c < nvec; c += stride) {
    const int64_t col = c * W;
    if constexpr (APPLY) {
      // idx and the state rows first: their loads overlap the stacks'
      int32_t ix[W];
      if constexpr (W == 2) {
        const int2 v = __ldcs(reinterpret_cast<const int2*>(a.idx + col));
        ix[0] = v.x;
        ix[1] = v.y;
      } else {
        ix[0] = __ldcs(a.idx + col);
      }
      bool in[W];
      int64_t ct[W], cn[W], cd[W];
#pragma unroll
      for (int e = 0; e < W; ++e) {
        in[e] = ix[e] >= 0 && ix[e] < a.size;
        ct[e] = cn[e] = cd[e] = 0;
        if (in[e]) {
          ct[e] = a.st_at[ix[e]];
          cn[e] = a.st_an[ix[e]];
          if constexpr (HAS_DEL) cd[e] = a.st_dt[ix[e]];
        }
      }
      const Best<W> b = fold_cols<R, HAS_DEL, W>(a, col);
      int32_t w[W];
#pragma unroll
      for (int e = 0; e < W; ++e) {
        w[e] = -1;
        if (!in[e]) continue;
        // the batch wins on a strictly greater (t, node); a tie is the
        // same write
        if (b.t.v[e] > ct[e] || (b.t.v[e] == ct[e] && b.n.v[e] > cn[e])) {
          a.st_at[ix[e]] = b.t.v[e];
          a.st_an[ix[e]] = b.n.v[e];
          w[e] = b.r[e];
        }
        if constexpr (HAS_DEL) {
          if (b.d.v[e] > cd[e]) a.st_dt[ix[e]] = b.d.v[e];
        }
      }
      if constexpr (W == 2) {
        *reinterpret_cast<int2*>(a.win + col) = make_int2(w[0], w[1]);
      } else {
        a.win[col] = w[0];
      }
    } else {
      const Best<W> b = fold_cols<R, HAS_DEL, W>(a, col);
      Cols<W> r;
#pragma unroll
      for (int e = 0; e < W; ++e) r.v[e] = b.r[e];
      store_cols<W>(a.o_at + col, b.t);
      store_cols<W>(a.o_an + col, b.n);
      if constexpr (HAS_DEL) store_cols<W>(a.o_dt + col, b.d);
      store_cols<W>(a.o_win + col, r);
    }
  }
}

// One wave: resident blocks per SM times the SMs, asked once per
// instantiation.
template <typename Kernel>
int wave_of(Kernel kernel, int threads) {
  int dev = 0, sms = 0, per = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kernel, threads, 0);
  return (sms > 0 ? sms : 1) * (per > 0 ? per : 1);
}

unsigned int grid_for(int64_t nvec, int threads, int wave) {
  int64_t blocks = (nvec + threads - 1) / threads;
  if (blocks > wave) blocks = wave;
  return static_cast<unsigned int>(blocks);
}

template <int R, bool HAS_DEL, bool APPLY, int W>
int launch_k1(const K1Args& a, void* stream) {
  auto* kernel = &fold_apply_kernel<R, HAS_DEL, APPLY, W>;
  static const int wave = wave_of(kernel, kK1Threads);
  kernel<<<grid_for(a.cols / W, kK1Threads, wave), kK1Threads, 0,
           static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <bool HAS_DEL, bool APPLY, int W>
int launch_k1_r(const K1Args& a, void* stream) {
  switch (a.rows) {
#define CONSTDB_R(k) \
  case k:            \
    return launch_k1<k, HAS_DEL, APPLY, W>(a, stream);
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
      return launch_k1<0, HAS_DEL, APPLY, W>(a, stream);
  }
}

template <bool APPLY>
int launch_k1_mode(const K1Args& a, int vec, void* stream) {
  const bool del = a.dt != nullptr;
  if (vec == 2) {
    return del ? launch_k1_r<true, APPLY, 2>(a, stream)
               : launch_k1_r<false, APPLY, 2>(a, stream);
  }
  return del ? launch_k1_r<true, APPLY, 1>(a, stream)
             : launch_k1_r<false, APPLY, 1>(a, stream);
}

// ------------------------------------------------------------------- K2

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
  static const int wave = wave_of(kernel, kK2Threads);
  kernel<<<grid_for(cols / W, kK2Threads, wave), kK2Threads, 0,
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

}  // namespace

extern "C" {

// Each launcher returns cudaGetLastError() right after the launch (0 on
// success), or cudaErrorInvalidValue for arguments it does not take.
// `vec` is the columns per thread: 2 (cols even and every pointer aligned
// for its 16-byte, or K1's 8-byte int32, accesses) or 1.

// K1 with its apply: fold the [rows, cols] stacks (dt null: the register
// variant, st_dt null too) and apply the winners to the state rows idx[s]
// in [0, size) in place; win[s] = the winning row where the batch beat
// the state, else -1.
int constdb_fold_apply(const void* at, const void* an, const void* dt,
                       int rows, int64_t cols, int vec, const void* idx,
                       void* st_at, void* st_an, void* st_dt, int64_t size,
                       void* win, void* stream) {
  if (rows < 1 || cols < 1 || (vec != 1 && vec != 2) || cols % vec != 0 ||
      (dt == nullptr) != (st_dt == nullptr) || size < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  K1Args a{};
  a.at = static_cast<const int64_t*>(at);
  a.an = static_cast<const int64_t*>(an);
  a.dt = static_cast<const int64_t*>(dt);
  a.rows = rows;
  a.cols = cols;
  a.idx = static_cast<const int32_t*>(idx);
  a.st_at = static_cast<int64_t*>(st_at);
  a.st_an = static_cast<int64_t*>(st_an);
  a.st_dt = static_cast<int64_t*>(st_dt);
  a.size = size;
  a.win = static_cast<int32_t*>(win);
  return launch_k1_mode<true>(a, vec, stream);
}

// K1 fold-only: the four [cols] outputs (dt null: no o_dt either).
int constdb_merge_elems(const void* at, const void* an, const void* dt,
                        int rows, int64_t cols, int vec, void* o_at,
                        void* o_an, void* o_dt, void* o_win, void* stream) {
  if (rows < 1 || cols < 1 || (vec != 1 && vec != 2) || cols % vec != 0 ||
      (dt == nullptr) != (o_dt == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  K1Args a{};
  a.at = static_cast<const int64_t*>(at);
  a.an = static_cast<const int64_t*>(an);
  a.dt = static_cast<const int64_t*>(dt);
  a.rows = rows;
  a.cols = cols;
  a.o_at = static_cast<int64_t*>(o_at);
  a.o_an = static_cast<int64_t*>(o_an);
  a.o_dt = static_cast<int64_t*>(o_dt);
  a.o_win = static_cast<int64_t*>(o_win);
  return launch_k1_mode<false>(a, vec, stream);
}

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
