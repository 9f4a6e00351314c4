// Native CPU kernels for interpn-tpu.
//
// Role: the latency path. The TPU path (JAX/XLA) wins on throughput for large
// query batches, but a single dispatch through the runtime costs tens of
// microseconds — the reference's headline small-batch numbers (1..1000 points,
// BASELINE.md "1 obs" rows) are won or lost on call latency. This library
// evaluates the same algorithms (identical cell location, saturation regions,
// Hermite construction, and evaluation-tree order as interpn_tpu.ops /
// the reference semantics in SURVEY.md §2) in nanoseconds per point on the
// host, and doubles as an exact-parity CPU oracle.
//
// Design notes (deliberately not a translation of the reference's Rust):
//  * One templated kernel family over <dtype, ndims>, instantiated for
//    ndims 1..8 so the per-dimension loops unroll; a runtime switch picks the
//    instantiation (the compile-time-specialization role of the reference's
//    const generics, done the C++ way).
//  * The corner stencil walk indexes vertices by bit/digit pattern, matching
//    the vertex ordering used by the TPU kernels. CUBIC reduces through the
//    same 4^N value tree as the reference/TPU paths (operation-order
//    agreement to the last ulp — the weight-product form measured ~2 digits
//    worse under deep non-linearized f32 extrapolation, see dispatch_cubic).
//    LINEAR uses a 2^N weight-product accumulation instead of the repeated
//    lerp tree: bit-exact at grid nodes (weights are exactly {0,1} there),
//    last-ulp interior, and divergent from the lerp tree only by
//    association order under deep extrapolation (covered by the fuzzer's
//    two-band tolerance).
//  * extern "C" surface with raw pointers; bound from Python via ctypes
//    (no pybind11 in this image).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <algorithm>
#include <atomic>
#include <cstdlib>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// Observation-axis threading. The per-point loops are embarrassingly
// parallel (the reference is single-threaded by design,
// src/multilinear/regular.rs:268-283 — a deliberate non-goal there); here
// each eval shards [0, n) into contiguous ranges, one std::thread each.
// Determinism: ranges are disjoint and the per-point math is identical, so
// results are bitwise equal to the single-thread run.
// ---------------------------------------------------------------------------

std::atomic<int> g_threads{-1};  // -1 = auto (env / hardware_concurrency)

int native_threads(int64_t n) {
  int configured = g_threads.load(std::memory_order_relaxed);
  if (configured < 0) {
    static const int auto_threads = [] {
      const char* env = std::getenv("INTERPN_TPU_NATIVE_THREADS");
      if (env && *env) return std::max(1, std::atoi(env));
      const unsigned hc = std::thread::hardware_concurrency();
      return hc ? std::min<int>((int)hc, 16) : 1;
    }();
    configured = auto_threads;
  }
  // thread spawn costs ~15-30 us; below this per-thread share it is a loss
  const int64_t MIN_PER_THREAD = 16384;
  const int by_n = (int)std::max<int64_t>(1, n / MIN_PER_THREAD);
  return std::max(1, std::min(configured, by_n));
}

template <typename T, typename F>
int run_sharded(int ndims, const T* const* obs, T* out, int64_t n, F call) {
  if (ndims < 1 || ndims > 8) return 1;
  const int nt = native_threads(n);
  if (nt <= 1) return call(obs, out, n);
  std::vector<std::thread> pool;
  std::vector<int> rcs((size_t)nt, 0);
  const int64_t per = (n + nt - 1) / nt;
  for (int t = 0; t < nt; ++t) {
    const int64_t lo = (int64_t)t * per;
    const int64_t cnt = std::min<int64_t>(per, n - lo);
    if (cnt <= 0) break;
    pool.emplace_back([=, &rcs] {
      const T* sub[8];
      for (int k = 0; k < ndims; ++k) sub[k] = obs[k] + lo;
      rcs[(size_t)t] = call(sub, out + lo, cnt);
    });
  }
  for (auto& th : pool) th.join();
  for (int rc : rcs)
    if (rc) return rc;
  return 0;
}

// Hermite node evaluation: returns the exact endpoint values at t == 0 and
// t == 1 (y0 resp. yend) so grid nodes reproduce bit-for-bit regardless of
// rounding in the slope terms — the reference's tests assert this.
template <typename T>
inline T hermite_exact(T t, T y0, T yend, T dy, T k0, T k1) {
  if (t == (T)0) return y0;
  if (t == (T)1) return yend;
  const T a = k0 - dy;
  const T b = -k1 + dy;
  const T c1 = dy + a;
  const T c2 = b - (a + a);
  const T c3 = a - b;
  return y0 + t * (c1 + t * (c2 + t * c3));
}

template <typename T>
inline T hermite(T t, T y0, T dy, T k0, T k1) {
  const T a = k0 - dy;
  const T b = -k1 + dy;
  const T c1 = dy + a;
  const T c2 = b - (a + a);
  const T c3 = a - b;
  return y0 + t * (c1 + t * (c2 + t * c3));
}

template <typename T>
inline T cd_nonuniform(T y0, T y1, T y2, T h01, T h12) {
  const T a = h01 / (h01 + h12);
  const T b = (y2 - y1) / h12;
  const T c = h12 / (h12 + h01);
  const T d = (y1 - y0) / h01;
  return a * b + c * d;
}

enum class Sat : uint8_t { None, InsideLow, OutsideLow, InsideHigh, OutsideHigh };

// Reference parity: the regular-grid kernels cast the cell location to a
// signed 64-bit index and ERROR on NaN/inf/out-of-range coordinates
// ("Unrepresentable coordinate value", src/multilinear/regular.rs:418,
// src/multicubic/regular.rs:438, src/nearest/regular.rs:309). 2^63 is a
// power of two, exactly representable in both float and double.
constexpr int RC_UNREPRESENTABLE = 2;

template <typename T>
inline bool unrepresentable(T floc) {
  const T lim = (T)9223372036854775808.0;  // 2^63
  return !(floc >= -lim && floc < lim);    // catches NaN via comparison
}

// partition_point(< v): first index with grid[i] >= v.
//
// Two regimes, both branch-free on the comparison outcome (a random query
// makes every branchy bisection step a coin-flip — ~15 ns per miss):
// small grids count matches directly (vectorizes to packed compares), big
// grids run a branchless bisection (the `base += take ? half : 0` step
// compiles to cmov).
template <typename T>
inline int64_t lower_count(const T* grid, int64_t n, T v) {
  if (n <= 64) {
    int64_t c = 0;
    for (int64_t i = 0; i < n; ++i) c += (grid[i] < v) ? 1 : 0;
    return c;
  }
  const T* base = grid;
  int64_t len = n;
  while (len > 1) {
    const int64_t half = len >> 1;
    base += (base[half - 1] < v) ? half : 0;
    len -= half;
  }
  return (base - grid) + ((base[0] < v) ? 1 : 0);
}

template <typename T, int N>
struct LinearRegular {
  static int run(const int64_t* dims, const T* starts, const T* steps,
                 const T* vals, const T* const* obs, T* out, int64_t n) {
    int64_t stride[N];
    int64_t acc = 1;
    for (int k = N - 1; k >= 0; --k) { stride[k] = acc; acc *= dims[k]; }
    bool bad = false;
    for (int64_t i = 0; i < n; ++i) {
      int64_t base = 0;
      T w[N][2];
      for (int k = 0; k < N; ++k) {
        const T x = obs[k][i];
        const T floc = std::floor((x - starts[k]) / steps[k]);
        bad |= unrepresentable(floc);
        const int64_t dimmax = std::max<int64_t>(dims[k] - 2, 0);
        // arg order matters: max((T)0, NaN) -> 0, so the cast below is
        // always defined; the accumulated flag reports the point afterwards
        const int64_t loc =
            (int64_t)std::min<T>((T)dimmax, std::max<T>((T)0, floc));
        const T t = (x - (starts[k] + steps[k] * (T)loc)) / steps[k];
        w[k][0] = (T)1 - t;
        w[k][1] = t;
        base += loc * stride[k];
      }
      // Stop at the first unrepresentable point like the reference's
      // per-point Result propagation (`src/multilinear/regular.rs:268-283`);
      // `out` past this index is unspecified on the error path.
      if (bad) return RC_UNREPRESENTABLE;
      // Per-axis weight product; innermost axis (stride 1) as a contiguous
      // 2-point dot so the compiler vectorizes the loads.
      constexpr int NOUTER = 1 << (N - 1);
      T acc = 0;
      for (int v = 0; v < NOUTER; ++v) {
        int64_t off = 0;
        T wp = 1;
        for (int k = 0; k < N - 1; ++k) {
          const int d = (v >> k) & 1;
          off += (int64_t)d * stride[k];
          wp *= w[k][d];
        }
        const T* p = vals + base + off;
        acc += wp * (p[0] * w[N - 1][0] + p[1] * w[N - 1][1]);
      }
      out[i] = acc;
    }
    return 0;
  }
};

template <typename T, int N>
struct LinearRectilinear {
  static int run(const T* const* grids, const int64_t* dims, const T* vals,
                 const T* const* obs, T* out, int64_t n) {
    int64_t stride[N];
    int64_t acc = 1;
    for (int k = N - 1; k >= 0; --k) { stride[k] = acc; acc *= dims[k]; }
    for (int64_t i = 0; i < n; ++i) {
      int64_t base = 0;
      T t[N];
      for (int k = 0; k < N; ++k) {
        const T x = obs[k][i];
        const int64_t dimmax = std::max<int64_t>(dims[k] - 2, 0);
        int64_t loc = lower_count(grids[k], dims[k], x) - 1;
        loc = std::min(std::max<int64_t>(loc, 0), dimmax);
        const T x0 = grids[k][loc], x1 = grids[k][loc + 1];
        t[k] = (x - x0) / (x1 - x0);
        base += loc * stride[k];
      }
      constexpr int NOUTER = 1 << (N - 1);
      T acc = 0;
      for (int v = 0; v < NOUTER; ++v) {
        int64_t off = 0;
        T wp = 1;
        for (int k = 0; k < N - 1; ++k) {
          const int d = (v >> k) & 1;
          off += (int64_t)d * stride[k];
          wp *= ((d == 0) ? ((T)1 - t[k]) : t[k]);
        }
        const T* p = vals + base + off;
        acc += wp * (p[0] * ((T)1 - t[N - 1]) + p[1] * t[N - 1]);
      }
      out[i] = acc;
    }
    return 0;
  }
};

template <typename T>
inline T cubic_node(T v0, T v1, T v2, T v3, T t, Sat sat, bool linearize) {
  switch (sat) {
    case Sat::None: {
      const T y0 = v1, dy = v2 - v1;
      const T k0 = (v2 - v0) / (T)2;
      const T k1 = (v3 - v1) / (T)2;
      return hermite_exact(t, y0, v2, dy, k0, k1);
    }
    case Sat::InsideLow:
    case Sat::OutsideLow: {
      const T tt = -t;
      const T y0 = v1, dy = v0 - v1;
      const T k0 = -(v2 - v0) / (T)2;
      const T k1 = (T)2 * dy - k0;
      if (sat == Sat::OutsideLow && linearize) return v0 + k1 * (tt - (T)1);
      return hermite_exact(tt, y0, v0, dy, k0, k1);
    }
    default: {
      const T tt = t - (T)1;
      const T y0 = v2, dy = v3 - v2;
      const T k0 = (v3 - v1) / (T)2;
      const T k1 = (T)2 * dy - k0;
      if (sat == Sat::OutsideHigh && linearize) return v3 + k1 * (tt - (T)1);
      return hermite_exact(tt, y0, v3, dy, k0, k1);
    }
  }
}

template <typename T>
inline T cubic_node_rect(T v0, T v1, T v2, T v3, const T* gc, T x, Sat sat,
                         bool linearize) {
  const T h01 = gc[1] - gc[0];
  const T h12 = gc[2] - gc[1];
  const T h23 = gc[3] - gc[2];
  switch (sat) {
    case Sat::None: {
      const T y0 = v1, dy = v2 - v1;
      const T k0 = cd_nonuniform(v0, v1, v2, h01 / h12, (T)1);
      const T k1 = cd_nonuniform(v1, v2, v3, (T)1, h23 / h12);
      const T t = (x - gc[1]) / h12;
      return hermite_exact(t, y0, v2, dy, k0, k1);
    }
    case Sat::InsideLow:
    case Sat::OutsideLow: {
      const T y0 = v1, dy = v0 - v1;
      const T k0 = -cd_nonuniform(v0, v1, v2, (T)1, h12 / h01);
      const T k1 = (T)2 * dy - k0;
      const T t = -(x - gc[1]) / h01;
      if (sat == Sat::OutsideLow && linearize) return v0 + k1 * (t - (T)1);
      return hermite_exact(t, y0, v0, dy, k0, k1);
    }
    default: {
      const T y0 = v2, dy = v3 - v2;
      const T k0 = cd_nonuniform(v1, v2, v3, h12 / h23, (T)1);
      const T k1 = (T)2 * dy - k0;
      const T t = (x - gc[2]) / h23;
      if (sat == Sat::OutsideHigh && linearize) return v3 + k1 * (t - (T)1);
      return hermite_exact(t, y0, v3, dy, k0, k1);
    }
  }
}

template <typename T, int N>
struct CubicRegular {
  static int run(const int64_t* dims, const T* starts, const T* steps,
                 const T* vals, bool linearize, const T* const* obs, T* out,
                 int64_t n) {
    int64_t stride[N];
    int64_t acc = 1;
    for (int k = N - 1; k >= 0; --k) { stride[k] = acc; acc *= dims[k]; }
    constexpr int NV = 1 << (2 * N);  // 4^N
    // digit-pattern stencil offsets are call constants; hoist them out of
    // the per-point loop (they cost ~3 imuls per vertex per point
    // otherwise). 4^N of them: heap for the 5-8D tail, stack for 1-4D.
    std::vector<int64_t> voff_heap;
    int64_t voff_stack[N <= 4 ? NV : 1];
    int64_t* voff = voff_stack;
    if constexpr (N > 4) {
      voff_heap.resize(NV);
      voff = voff_heap.data();
    }
    for (int v = 0; v < NV; ++v) {
      int64_t off = 0;
      for (int k = 0; k < N; ++k) off += (int64_t)((v >> (2 * k)) & 3) * stride[k];
      voff[v] = off;
    }
    std::vector<T> c_heap;
    if constexpr (N > 4) c_heap.resize(NV);
    bool bad = false;
    for (int64_t i = 0; i < n; ++i) {
      int64_t base = 0;
      T t[N];
      Sat sat[N];
      for (int k = 0; k < N; ++k) {
        const T x = obs[k][i];
        const T floc = std::floor((x - starts[k]) / steps[k]);
        bad |= unrepresentable(floc);
        // Clamp in float BEFORE the int cast (casting an unrepresentable
        // float to int64 is UB and can wrap a hugely negative query to the
        // high edge); saturation flags come from float comparisons, matching
        // ops/locate.py::locate_regular_cubic.
        const T filoc = floc - (T)1;
        const int64_t nn = dims[k];
        const int64_t dimmax = std::max<int64_t>(nn - 4, 0);
        // max((T)0, NaN) -> 0: the cast is always defined (see LinearRegular)
        const int64_t loc =
            (int64_t)std::min<T>((T)dimmax, std::max<T>((T)0, filoc));
        if (filoc < (T)-1) sat[k] = Sat::OutsideLow;
        else if (filoc == (T)-1) sat[k] = Sat::InsideLow;
        else if (filoc > (T)(nn - 3)) sat[k] = Sat::OutsideHigh;
        else if (filoc == (T)(nn - 3)) sat[k] = Sat::InsideHigh;
        else sat[k] = Sat::None;
        t[k] = (x - (starts[k] + steps[k] * (T)(loc + 1))) / steps[k];
        base += loc * stride[k];
      }
      // Stop at the first unrepresentable point (see LinearRegular).
      if (bad) return RC_UNREPRESENTABLE;
      // Value-tree evaluation, matching the reference's kernels
      // (src/multicubic/regular.rs:364-422 flattened, *_recursive.rs for
      // 5-8D — same association order) and this library's JAX gather path:
      // gather the 4^N stencil (dim 0 in the lowest digit) and reduce one
      // axis per level. Under deep non-linearized f32 extrapolation this is
      // ~2 decimal digits more accurate than a weight-product form
      // (adjudicated against the f64 oracle by scripts/fuzz_parity.py).
      T c_stack[N <= 4 ? NV : 1];
      T* c = c_stack;
      if constexpr (N > 4) c = c_heap.data();
      for (int v = 0; v < NV; ++v) c[v] = vals[base + voff[v]];
      int len = NV;
      for (int k = 0; k < N; ++k) {
        len /= 4;
        for (int j = 0; j < len; ++j)
          c[j] = cubic_node<T>(c[4 * j], c[4 * j + 1], c[4 * j + 2],
                               c[4 * j + 3], t[k], sat[k], linearize);
      }
      out[i] = c[0];
    }
    return 0;
  }
};

template <typename T, int N>
struct CubicRectilinear {
  static int run(const T* const* grids, const int64_t* dims, const T* vals,
                 bool linearize, const T* const* obs, T* out, int64_t n) {
    int64_t stride[N];
    int64_t acc = 1;
    for (int k = N - 1; k >= 0; --k) { stride[k] = acc; acc *= dims[k]; }
    constexpr int NV = 1 << (2 * N);
    std::vector<int64_t> voff_heap;
    int64_t voff_stack[N <= 4 ? NV : 1];
    int64_t* voff = voff_stack;
    if constexpr (N > 4) {
      voff_heap.resize(NV);
      voff = voff_heap.data();
    }
    for (int v = 0; v < NV; ++v) {
      int64_t off = 0;
      for (int k = 0; k < N; ++k) off += (int64_t)((v >> (2 * k)) & 3) * stride[k];
      voff[v] = off;
    }
    std::vector<T> c_heap;
    if constexpr (N > 4) c_heap.resize(NV);
    for (int64_t i = 0; i < n; ++i) {
      int64_t base = 0;
      int64_t locs[N];
      Sat sat[N];
      for (int k = 0; k < N; ++k) {
        const T x = obs[k][i];
        const int64_t nn = dims[k];
        const int64_t iloc = lower_count(grids[k], nn, x) - 2;
        const int64_t dimmax = std::max<int64_t>(nn - 4, 0);
        const int64_t loc = std::min(std::max<int64_t>(iloc, 0), dimmax);
        if (iloc == -2) sat[k] = Sat::OutsideLow;
        else if (iloc == -1) sat[k] = Sat::InsideLow;
        else if (iloc == nn - 2) sat[k] = Sat::OutsideHigh;
        else if (iloc == nn - 3) sat[k] = Sat::InsideHigh;
        else sat[k] = Sat::None;
        locs[k] = loc;
        base += loc * stride[k];
      }
      // Value-tree evaluation (see CubicRegular above).
      T c_stack[N <= 4 ? NV : 1];
      T* c = c_stack;
      if constexpr (N > 4) c = c_heap.data();
      for (int v = 0; v < NV; ++v) c[v] = vals[base + voff[v]];
      int len = NV;
      for (int k = 0; k < N; ++k) {
        len /= 4;
        const T* gc = grids[k] + locs[k];
        for (int j = 0; j < len; ++j)
          c[j] = cubic_node_rect<T>(c[4 * j], c[4 * j + 1], c[4 * j + 2],
                                    c[4 * j + 3], gc, obs[k][i], sat[k],
                                    linearize);
      }
      out[i] = c[0];
    }
    return 0;
  }
};

template <typename T, int N>
struct NearestRegular {
  static int run(const int64_t* dims, const T* starts, const T* steps,
                 const T* vals, const T* const* obs, T* out, int64_t n) {
    int64_t stride[N];
    int64_t acc = 1;
    for (int k = N - 1; k >= 0; --k) { stride[k] = acc; acc *= dims[k]; }
    bool bad = false;
    for (int64_t i = 0; i < n; ++i) {
      int64_t flat = 0;
      for (int k = 0; k < N; ++k) {
        const T x = obs[k][i];
        const T floc = std::floor((x - starts[k]) / steps[k]);
        bad |= unrepresentable(floc);
        const int64_t dimmax = std::max<int64_t>(dims[k] - 2, 0);
        // max((T)0, NaN) -> 0: the cast is always defined (see LinearRegular)
        const int64_t loc =
            (int64_t)std::min<T>((T)dimmax, std::max<T>((T)0, floc));
        const T dt = (x - (starts[k] + steps[k] * (T)loc)) / steps[k];
        flat += (loc + (dt <= (T)0.5 ? 0 : 1)) * stride[k];
      }
      // Stop at the first unrepresentable point (see LinearRegular).
      if (bad) return RC_UNREPRESENTABLE;
      out[i] = vals[flat];
    }
    return 0;
  }
};

template <typename T, int N>
struct NearestRectilinear {
  static int run(const T* const* grids, const int64_t* dims, const T* vals,
                 const T* const* obs, T* out, int64_t n) {
    int64_t stride[N];
    int64_t acc = 1;
    for (int k = N - 1; k >= 0; --k) { stride[k] = acc; acc *= dims[k]; }
    for (int64_t i = 0; i < n; ++i) {
      int64_t flat = 0;
      for (int k = 0; k < N; ++k) {
        const T x = obs[k][i];
        const int64_t dimmax = std::max<int64_t>(dims[k] - 2, 0);
        int64_t loc = lower_count(grids[k], dims[k], x) - 1;
        loc = std::min(std::max<int64_t>(loc, 0), dimmax);
        const T x0 = grids[k][loc], x1 = grids[k][loc + 1];
        const T dt = (x - x0) / (x1 - x0);
        flat += (loc + (dt <= (T)0.5 ? 0 : 1)) * stride[k];
      }
      out[i] = vals[flat];
    }
    return 0;
  }
};

template <template <typename, int> class K, typename T, typename... A>
int dispatch_regular(int ndims, A... a) {
  switch (ndims) {
    case 1: return K<T, 1>::run(a...);
    case 2: return K<T, 2>::run(a...);
    case 3: return K<T, 3>::run(a...);
    case 4: return K<T, 4>::run(a...);
    case 5: return K<T, 5>::run(a...);
    case 6: return K<T, 6>::run(a...);
    case 7: return K<T, 7>::run(a...);
    case 8: return K<T, 8>::run(a...);
    default: return 1;
  }
}

// Cubic evaluates through the 4^N VALUE tree (reference operation order —
// the weight-product form measured ~2 decimal digits worse under deep
// non-linearized f32 extrapolation); the 4^N scratch lives on the heap for
// the 5-8D tail (voff_heap/c_heap above), so it still instantiates
// through 8D like the linear family.
template <template <typename, int> class K, typename T, typename... A>
int dispatch_cubic(int ndims, A... a) {
  return dispatch_regular<K, T>(ndims, a...);
}

}  // namespace

extern "C" {

int itn_set_threads(int t) {  // <= 0 restores auto
  g_threads.store(t > 0 ? t : -1, std::memory_order_relaxed);
  return 0;
}

#define REGULAR_FN(name, T, KERNEL)                                          \
  int name(const int64_t* dims, int ndims, const T* starts, const T* steps,  \
           const T* vals, const T* const* obs, T* out, int64_t n) {          \
    return run_sharded<T>(                                                   \
        ndims, obs, out, n,                                                  \
        [&](const T* const* o, T* ou, int64_t c) {                           \
          return dispatch_regular<KERNEL, T>(ndims, dims, starts, steps,     \
                                             vals, o, ou, c);                \
        });                                                                  \
  }

REGULAR_FN(itn_linear_regular_f64, double, LinearRegular)
REGULAR_FN(itn_linear_regular_f32, float, LinearRegular)
REGULAR_FN(itn_nearest_regular_f64, double, NearestRegular)
REGULAR_FN(itn_nearest_regular_f32, float, NearestRegular)

#define RECT_FN(name, T, KERNEL)                                             \
  int name(const T* const* grids, const int64_t* dims, int ndims,            \
           const T* vals, const T* const* obs, T* out, int64_t n) {          \
    return run_sharded<T>(                                                   \
        ndims, obs, out, n,                                                  \
        [&](const T* const* o, T* ou, int64_t c) {                           \
          return dispatch_regular<KERNEL, T>(ndims, grids, dims, vals, o,    \
                                             ou, c);                         \
        });                                                                  \
  }

RECT_FN(itn_linear_rectilinear_f64, double, LinearRectilinear)
RECT_FN(itn_linear_rectilinear_f32, float, LinearRectilinear)
RECT_FN(itn_nearest_rectilinear_f64, double, NearestRectilinear)
RECT_FN(itn_nearest_rectilinear_f32, float, NearestRectilinear)

#define CUBIC_REGULAR_FN(name, T)                                            \
  int name(const int64_t* dims, int ndims, const T* starts, const T* steps,  \
           const T* vals, int linearize, const T* const* obs, T* out,        \
           int64_t n) {                                                      \
    return run_sharded<T>(                                                   \
        ndims, obs, out, n,                                                  \
        [&](const T* const* o, T* ou, int64_t c) {                           \
          return dispatch_cubic<CubicRegular, T>(ndims, dims, starts, steps, \
                                                 vals, linearize != 0, o,    \
                                                 ou, c);                     \
        });                                                                  \
  }

CUBIC_REGULAR_FN(itn_cubic_regular_f64, double)
CUBIC_REGULAR_FN(itn_cubic_regular_f32, float)

#define CUBIC_RECT_FN(name, T)                                               \
  int name(const T* const* grids, const int64_t* dims, int ndims,            \
           const T* vals, int linearize, const T* const* obs, T* out,        \
           int64_t n) {                                                      \
    return run_sharded<T>(                                                   \
        ndims, obs, out, n,                                                  \
        [&](const T* const* o, T* ou, int64_t c) {                           \
          return dispatch_cubic<CubicRectilinear, T>(                        \
              ndims, grids, dims, vals, linearize != 0, o, ou, c);           \
        });                                                                  \
  }

CUBIC_RECT_FN(itn_cubic_rectilinear_f64, double)
CUBIC_RECT_FN(itn_cubic_rectilinear_f32, float)

#define BOUNDS_REGULAR_FN(name, T)                                           \
  int name(const int64_t* dims, int ndims, const T* starts, const T* steps,  \
           const T* const* obs, double atol, int64_t n, uint8_t* out) {      \
    for (int k = 0; k < ndims; ++k) {                                        \
      const T first = starts[k];                                             \
      const T last = starts[k] + steps[k] * (T)(dims[k] - 1);                \
      const T lo = std::min(first, last), hi = std::max(first, last);        \
      uint8_t bad = 0;                                                       \
      for (int64_t i = 0; i < n && !bad; ++i) {                              \
        const T x = obs[k][i];                                               \
        if ((x - lo) <= -(T)atol || (x - hi) >= (T)atol) bad = 1;            \
      }                                                                      \
      out[k] = bad;                                                          \
    }                                                                        \
    return 0;                                                                \
  }

BOUNDS_REGULAR_FN(itn_check_bounds_regular_f64, double)
BOUNDS_REGULAR_FN(itn_check_bounds_regular_f32, float)

#define BOUNDS_RECT_FN(name, T)                                              \
  int name(const T* const* grids, const int64_t* dims, int ndims,            \
           const T* const* obs, double atol, int64_t n, uint8_t* out) {      \
    for (int k = 0; k < ndims; ++k) {                                        \
      const T lo = grids[k][0];                                              \
      const T hi = grids[k][dims[k] - 1];                                    \
      uint8_t bad = 0;                                                       \
      for (int64_t i = 0; i < n && !bad; ++i) {                              \
        const T x = obs[k][i];                                               \
        if ((x - lo) <= -(T)atol || (x - hi) >= (T)atol) bad = 1;            \
      }                                                                      \
      out[k] = bad;                                                          \
    }                                                                        \
    return 0;                                                                \
  }

BOUNDS_RECT_FN(itn_check_bounds_rectilinear_f64, double)
BOUNDS_RECT_FN(itn_check_bounds_rectilinear_f32, float)

}  // extern "C"
