// Shared device code of the port's Hopper kernels (sm_90a): IEEE-rounded
// arithmetic, the linear lerp tree, the cubic Hermite tree, a regular and a
// rectilinear cubic axis's locate and four weights and the stencil's
// contraction with them, the B-spline weights and tree, and the bisections.
//
// Every kernel mirrors its plain PyTorch version (`ops/linear.py`,
// `ops/cubic.py`, `ops/nearest.py`, `ops/bspline.py`) node for node, so the
// two agree bit for bit. nvcc contracts a*b+c into an FMA by default, which moves a result by
// an ulp and, at grid nodes, can move floor() to the neighbouring cell. All
// arithmetic here goes through the _rn intrinsics, which are never
// contracted, and the build adds --fmad=false. Division stays IEEE (no fast
// math).

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace interp {

constexpr int kMaxDims = 8;
constexpr int kThreads = 256;
constexpr int kLinear = 0;
constexpr int kCubic = 1;
constexpr int kNearest = 2;

constexpr int ipow(int b, int e) { return e == 0 ? 1 : b * ipow(b, e - 1); }
// Inner levels of the cubic tree that are unrolled (4^3 = 64 table reads);
// each outer level is a loop of 4, so code size grows by one node per level
// and at most 4 partials per level are live.
constexpr int kCubicUnrolled = 3;
// The same for the B-spline tree of width W = k + 1: 4^3 = 64 or 6^2 = 36
// unrolled table reads.
template <int W>
constexpr int kSplineUnrolled = W <= 4 ? 3 : 2;

template <typename T>
struct ObsPtrs {
  const T* p[kMaxDims];
};

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ float floor_(float a) { return floorf(a); }
__device__ __forceinline__ float clamp_(float a, float hi) { return fminf(fmaxf(a, 0.0f), hi); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ double floor_(double a) { return floor(a); }
__device__ __forceinline__ double clamp_(double a, double hi) { return fmin(fmax(a, 0.0), hi); }

// W values side by side: the channels of one table entry that a stack
// kernel reduces together (W = 1 for one table).
template <typename T, int W>
struct Lanes {
  static constexpr int kWidth = W;
  T v[W];
};

template <typename T, int W>
__device__ __forceinline__ Lanes<T, W> lerp(const Lanes<T, W>& y0, const Lanes<T, W>& y1, T t) {
  Lanes<T, W> r;
#pragma unroll
  for (int j = 0; j < W; ++j) r.v[j] = add_rn(y0.v[j], mul_rn(t, sub_rn(y1.v[j], y0.v[j])));
  return r;
}

// The leaf that reads one table entry through the read-only cache.
template <typename T>
struct Ldg {
  const T* p;

  __device__ __forceinline__ Lanes<T, 1> operator()(int off) const { return {__ldg(p + off)}; }
};

// Value of the D-dimensional sub-cell at `base`: the two (D-1)-dimensional
// halves along dim D-1, lerped with t[D-1], down to the leaf, which returns
// the sub-cell of its first LEAF dims (table entries for LEAF = 0, a pair or
// quad already reduced otherwise). Depth first, so at most D partials are
// live; the pairing is the level-by-level tree's (dim 0 first).
template <typename T, int D, int LEAF = 0>
struct LerpTree {
  template <typename Leaf>
  static __device__ __forceinline__ auto eval(const Leaf& leaf, int base, const int* stride,
                                              const T* t) {
    if constexpr (D == LEAF) {
      return leaf(base);
    } else {
      const auto y0 = LerpTree<T, D - 1, LEAF>::eval(leaf, base, stride, t);
      const auto y1 = LerpTree<T, D - 1, LEAF>::eval(leaf, base + stride[D - 1], stride, t);
      return lerp(y0, y1, t[D - 1]);
    }
  }
};

// Normalized cubic Hermite spline via Horner (`ops/cubic.py::_hermite`).
template <typename T>
__device__ __forceinline__ T hermite(T t, T y0, T dy, T k0, T k1) {
  const T a = sub_rn(k0, dy);
  const T b = add_rn(-k1, dy);
  const T c1 = add_rn(dy, a);
  const T c2 = sub_rn(b, add_rn(a, a));
  const T c3 = sub_rn(a, b);
  return add_rn(y0, mul_rn(t, add_rn(c1, mul_rn(t, add_rn(c2, mul_rn(t, c3))))));
}

// Linearized extrapolation in the Outside regions, then the exact endpoint
// values at tt == 0/1 (`ops/cubic.py::_finish_node`).
template <typename T>
__device__ __forceinline__ T cubic_finish(T res, T tt, T y0, T k1, T v0, T v2, T v3,
                                          bool low, bool high, bool outside, bool lin) {
  if (lin && outside) res = add_rn(low ? v0 : v3, mul_rn(k1, sub_rn(tt, T(1))));
  const T endpoint = low ? v0 : (high ? v3 : v2);
  return tt == T(0) ? y0 : (tt == T(1) ? endpoint : res);
}

// One axis of the cubic tree on a regular grid (`_axis_reduce_regular`):
// the mirrored/shifted coordinate tt and the saturation region.
template <typename T>
struct RegularCubicAxis {
  T tt;
  bool low, high, outside;

  __device__ __forceinline__ T node(T v0, T v1, T v2, T v3, bool lin) const {
    const T y0 = high ? v2 : v1;
    const T dy = low ? sub_rn(v0, v1) : (high ? sub_rn(v3, v2) : sub_rn(v2, v1));
    const T half02 = mul_rn(sub_rn(v2, v0), T(0.5));
    const T half13 = mul_rn(sub_rn(v3, v1), T(0.5));
    const T k0 = low ? -half02 : (high ? half13 : half02);
    const T k1 = (low || high) ? sub_rn(mul_rn(T(2), dy), k0) : half13;
    return cubic_finish(hermite(tt, y0, dy, k0, k1), tt, y0, k1, v0, v2, v3, low, high,
                        outside, lin);
  }

  // the weight of tap j: the node on unit basis j, (0, 1, 0, 0) or
  // (0, 0, 1, 0) exactly where tt is 0 (a grid node)
  __device__ __forceinline__ void weights(bool lin, T* w) const {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      w[j] = node(j == 0 ? T(1) : T(0), j == 1 ? T(1) : T(0), j == 2 ? T(1) : T(0),
                  j == 3 ? T(1) : T(0), lin);
    }
  }
};

// Regular cubic axis setup (`locate_regular_cubic` and the coordinate of
// `_axis_reduce_regular`): the stencil's first index, clamped to [0, dim-4]
// (NaN reads 0, +-inf the edge cells), and the region masks from the raw
// iloc (all false for NaN).
template <typename T>
__device__ __forceinline__ int regular_cubic_axis(T x, T start, T step, int dim,
                                                  RegularCubicAxis<T>& ax) {
  const T iloc = sub_rn(floor_(div_rn(sub_rn(x, start), step)), T(1));
  const T last = static_cast<T>(dim - 4 > 0 ? dim - 4 : 0);
  const T high_at = static_cast<T>(dim - 3);
  const int loc = static_cast<int>(clamp_(isnan(iloc) ? T(0) : iloc, last));
  ax.low = iloc <= T(-1);
  ax.high = !ax.low && iloc >= high_at;
  ax.outside = iloc < T(-1) || (!ax.low && iloc > high_at);
  const T t = div_rn(sub_rn(x, add_rn(start, mul_rn(step, static_cast<T>(loc + 1)))), step);
  ax.tt = ax.low ? -t : (ax.high ? sub_rn(t, T(1)) : t);
  return loc;
}

// loc and the four cubic weights of one regular axis at x: K1's node on the
// four unit bases (`ops/cubic.py::regular_cubic_weights`).
template <typename T>
__device__ __forceinline__ int regular_cubic_weights(T x, T start, T step, int dim, bool lin,
                                                     T* w) {
  RegularCubicAxis<T> ax;
  const int loc = regular_cubic_axis(x, start, step, dim, ax);
  ax.weights(lin, w);
  return loc;
}

// Distance-weighted central difference (`_centered_diff_nonuniform` with
// h01 = p, h12 = q): a = p/(p+q) and c = q/(q+p) depend on the grid only and
// are computed once per axis.
template <typename T>
__device__ __forceinline__ T centered_diff(T y0, T y1, T y2, T a, T c, T p, T q) {
  return add_rn(mul_rn(a, div_rn(sub_rn(y2, y1), q)), mul_rn(c, div_rn(sub_rn(y1, y0), p)));
}

// One axis of the cubic tree on a rectilinear grid
// (`_axis_reduce_rectilinear`). (a0, c0, p0, q0) are k0's difference
// weights for the axis's region; (a1, c1, p1, q1) are k1's in the None
// region, where k1 is a difference too.
template <typename T>
struct RectCubicAxis {
  T tt;
  T a0, c0, p0, q0;
  T a1, c1, p1, q1;
  bool low, high, outside;

  __device__ __forceinline__ T node(T v0, T v1, T v2, T v3, bool lin) const {
    const T y0 = high ? v2 : v1;
    const T dy = low ? sub_rn(v0, v1) : (high ? sub_rn(v3, v2) : sub_rn(v2, v1));
    T k0, k1;
    if (low) {
      k0 = -centered_diff(v0, v1, v2, a0, c0, p0, q0);
      k1 = sub_rn(mul_rn(T(2), dy), k0);
    } else if (high) {
      k0 = centered_diff(v1, v2, v3, a0, c0, p0, q0);
      k1 = sub_rn(mul_rn(T(2), dy), k0);
    } else {
      k0 = centered_diff(v0, v1, v2, a0, c0, p0, q0);
      k1 = centered_diff(v1, v2, v3, a1, c1, p1, q1);
    }
    return cubic_finish(hermite(tt, y0, dy, k0, k1), tt, y0, k1, v0, v2, v3, low, high,
                        outside, lin);
  }
};

template <typename T>
__device__ __forceinline__ T quiet_nan();
template <>
__device__ __forceinline__ float quiet_nan<float>() {
  return __int_as_float(0x7fc00000);
}
template <>
__device__ __forceinline__ double quiet_nan<double>() {
  return __longlong_as_double(0x7ff8000000000000LL);
}

// A rectilinear cubic axis for the unit bases: RectCubicAxis::node with
// each difference quotient (y2 - y1) / q taken from the divisor's
// reciprocal. On a unit basis the numerator is 1, -1 or +0, and then
// RN(1 / q), -RN(1 / q) and RN(+0 / q) are the quotient bit for bit (the
// rounding is symmetric in sign; +0 / q is a zero of q's sign, NaN for q
// zero or NaN), so the weights are the plain version's with 2 divisions an
// axis in place of 16.
template <typename T>
struct RectUnitAxis {
  RectCubicAxis<T> ax;
  T rp0, rq0, rp1, rq1;  // reciprocals of the difference divisors
  T zp0, zq0, zp1, zq1;  // +0 / divisor

  // from an axis of rectilinear.cuh's `cubic_axis`, where p1 = 1 and p0 = 1
  // (low) or q0 = 1 (the other regions): 1 / 1 = 1 and +0 / 1 = +0, so two
  // divisions an axis remain
  __device__ __forceinline__ void set(const RectCubicAxis<T>& a) {
    ax = a;
    const T d = a.low ? a.q0 : a.p0;  // the divisor of k0's that is not 1
    const T r = div_rn(T(1), d), z = zero_over(d);
    rp0 = a.low ? T(1) : r;
    zp0 = a.low ? T(0) : z;
    rq0 = a.low ? r : T(1);
    zq0 = a.low ? z : T(0);
    rp1 = T(1);
    zp1 = T(0);
    rq1 = div_rn(T(1), a.q1);
    zq1 = zero_over(a.q1);
  }

  static __device__ __forceinline__ T zero_over(T d) {
    return d != T(0) && d == d ? (d > T(0) ? T(0) : T(-0.0)) : quiet_nan<T>();
  }

  // (numerator) / divisor for a numerator of 1, -1 or +0
  static __device__ __forceinline__ T quot(T num, T recip, T zero) {
    return num == T(1) ? recip : (num == T(-1) ? -recip : zero);
  }

  // centered_diff with its two quotients so taken
  static __device__ __forceinline__ T cd(T y0, T y1, T y2, T a, T c, T rp, T zp, T rq, T zq) {
    return add_rn(mul_rn(a, quot(sub_rn(y2, y1), rq, zq)),
                  mul_rn(c, quot(sub_rn(y1, y0), rp, zp)));
  }

  __device__ __forceinline__ T node(T v0, T v1, T v2, T v3, bool lin) const {
    const T y0 = ax.high ? v2 : v1;
    const T dy = ax.low ? sub_rn(v0, v1) : (ax.high ? sub_rn(v3, v2) : sub_rn(v2, v1));
    T k0, k1;
    if (ax.low) {
      k0 = -cd(v0, v1, v2, ax.a0, ax.c0, rp0, zp0, rq0, zq0);
      k1 = sub_rn(mul_rn(T(2), dy), k0);
    } else if (ax.high) {
      k0 = cd(v1, v2, v3, ax.a0, ax.c0, rp0, zp0, rq0, zq0);
      k1 = sub_rn(mul_rn(T(2), dy), k0);
    } else {
      k0 = cd(v0, v1, v2, ax.a0, ax.c0, rp0, zp0, rq0, zq0);
      k1 = cd(v1, v2, v3, ax.a1, ax.c1, rp1, zp1, rq1, zq1);
    }
    return cubic_finish(hermite(ax.tt, y0, dy, k0, k1), ax.tt, y0, k1, v0, v2, v3, ax.low,
                        ax.high, ax.outside, lin);
  }

  // the weight of tap j: the node on unit basis j
  __device__ __forceinline__ void weights(bool lin, T* w) const {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      w[j] = node(j == 0 ? T(1) : T(0), j == 1 ? T(1) : T(0), j == 2 ? T(1) : T(0),
                  j == 3 ? T(1) : T(0), lin);
    }
  }
};

// Value of the D-dimensional 4^D sub-stencil at `base`: the four
// (D-1)-dimensional sub-stencils along dim D-1 reduced by axis D-1's node,
// down to the leaf, which returns the sub-stencil of its first LEAF dims (a
// table entry for LEAF = 0, `Ldg`; axis 0's four taps already reduced by
// its node for LEAF = 1, regular.cuh's `Taps`). The inner kCubicUnrolled
// levels unroll; each outer level runs its four children in a loop and
// keeps them in registers through selects (a dynamically indexed array
// would live in local memory).
template <typename T, typename Axis, int D, int LEAF = 0>
struct CubicTree {
  template <typename Leaf>
  static __device__ __forceinline__ T eval(const Leaf& leaf, int base, const int* stride,
                                           const Axis* ax, bool lin) {
    if constexpr (D == LEAF) {
      return leaf(base).v[0];
    } else {
      using Sub = CubicTree<T, Axis, D - 1, LEAF>;
      const int s = stride[D - 1];
      if constexpr (D <= kCubicUnrolled) {
        const T v0 = Sub::eval(leaf, base, stride, ax, lin);
        const T v1 = Sub::eval(leaf, base + s, stride, ax, lin);
        const T v2 = Sub::eval(leaf, base + 2 * s, stride, ax, lin);
        const T v3 = Sub::eval(leaf, base + 3 * s, stride, ax, lin);
        return ax[D - 1].node(v0, v1, v2, v3, lin);
      } else {
        T v0 = T(0), v1 = T(0), v2 = T(0), v3 = T(0);
#pragma unroll 1
        for (int j = 0; j < 4; ++j) {
          const T y = Sub::eval(leaf, base + j * s, stride, ax, lin);
          v0 = j == 0 ? y : v0;
          v1 = j == 1 ? y : v1;
          v2 = j == 2 ? y : v2;
          v3 = j == 3 ? y : v3;
        }
        return ax[D - 1].node(v0, v1, v2, v3, lin);
      }
    }
  }
};

// w[r] for a runtime r < W, through selects (a dynamically indexed array
// would live in local memory).
template <typename T, int W>
__device__ __forceinline__ T pick(const T* w, int r) {
  T v = w[0];
#pragma unroll
  for (int j = 1; j < W; ++j) v = r == j ? w[j] : v;
  return v;
}

// acc + w * y, lane by lane
template <typename T, int W>
__device__ __forceinline__ Lanes<T, W> madd(const Lanes<T, W>& acc, T w, const Lanes<T, W>& y) {
  Lanes<T, W> r;
#pragma unroll
  for (int j = 0; j < W; ++j) r.v[j] = add_rn(acc.v[j], mul_rn(w, y.v[j]));
  return r;
}

// ((w0 v0 + w1 v1) + w2 v2) + w3 v3: one stencil row contracted with its
// axis's four cubic weights, in `ops/cubic.py::contract_cubic`'s order.
template <typename T>
__device__ __forceinline__ T dot4(const T* w, T v0, T v1, T v2, T v3) {
  return add_rn(add_rn(add_rn(mul_rn(w[0], v0), mul_rn(w[1], v1)), mul_rn(w[2], v2)),
                mul_rn(w[3], v3));
}

// Value of the D-dimensional 4^D sub-stencil at `base` contracted with the
// axes' cubic weights (axis k's tap j at w[4 * k + j]), axis 0 first as
// CubicTree reduces: the four (D-1)-dimensional sub-stencils along dim D-1
// times axis D-1's weights, summed left to right, down to the leaf, which
// returns the sub-stencil of its first LEAF dims for W channels (a table
// entry for LEAF = 0; axis 0's four taps already contracted for LEAF = 1).
// The plain version is `ops/cubic.py::contract_cubic`. Levels 1..UNROLLED
// unroll (their reads all in flight at once); each outer level is a
// loop of 4 with one running sum a channel, started at -0.0 so that its
// first addition returns the first product bit for bit, its weight picked
// by selects.
template <typename T, int D, int LEAF = 0, int UNROLLED = kCubicUnrolled>
struct WeightTree {
  template <typename Leaf>
  static __device__ __forceinline__ auto eval(const Leaf& leaf, int base, const int* stride,
                                              const T* w) {
    if constexpr (D == LEAF) {
      return leaf(base);
    } else {
      using Sub = WeightTree<T, D - 1, LEAF, UNROLLED>;
      const int s = stride[D - 1];
      const T* wd = w + 4 * (D - 1);
      using L = decltype(Sub::eval(leaf, base, stride, w));
      L acc;
      if constexpr (D <= UNROLLED) {
        acc = Sub::eval(leaf, base, stride, w);
#pragma unroll
        for (int j = 0; j < L::kWidth; ++j) acc.v[j] = mul_rn(wd[0], acc.v[j]);
#pragma unroll
        for (int j = 1; j < 4; ++j) {
          acc = madd(acc, wd[j], Sub::eval(leaf, base + j * s, stride, w));
        }
      } else {
#pragma unroll
        for (int j = 0; j < L::kWidth; ++j) acc.v[j] = T(-0.0);
#pragma unroll 1
        for (int j = 0; j < 4; ++j) {
          acc = madd(acc, pick<T, 4>(wd, j), Sub::eval(leaf, base + j * s, stride, w));
        }
      }
      return acc;
    }
  }
};

// Value of the W^(NDIMS-A) sub-stencil at `base` with axes 0..A-1 fixed:
// sum over r of w[A * W + r] (axis A's weights) times the sub-stencil one
// axis in, summed left to right, down to the leaf, which returns a table
// entry's channels (`Ldg`, regular.cuh's `Channels`: one table, or the
// channels of an interleaved stack side by side). Axis NDIMS-1 is reduced
// first and axis 0 last, the plain version's order
// (`ops/bspline.py::_bspline_impl`). The inner UNROLLED levels unroll; each
// outer level is a loop of W with one running sum a channel, started at
// -0.0 so that its first addition returns the first product bit for bit.
template <typename T, int W, int NDIMS, int A, int UNROLLED = kSplineUnrolled<W>>
struct SplineTree {
  template <typename Leaf>
  static __device__ __forceinline__ auto eval(const Leaf& leaf, int base, const int* stride,
                                              const T* w) {
    if constexpr (A == NDIMS) {
      return leaf(base);
    } else {
      using Sub = SplineTree<T, W, NDIMS, A + 1, UNROLLED>;
      using L = decltype(Sub::eval(leaf, base, stride, w));
      const int s = stride[A];
      L acc;
      if constexpr (NDIMS - A <= UNROLLED) {
        acc = Sub::eval(leaf, base, stride, w);
#pragma unroll
        for (int j = 0; j < L::kWidth; ++j) acc.v[j] = mul_rn(w[A * W], acc.v[j]);
#pragma unroll
        for (int r = 1; r < W; ++r) {
          acc = madd(acc, w[A * W + r], Sub::eval(leaf, base + r * s, stride, w));
        }
      } else {
#pragma unroll
        for (int j = 0; j < L::kWidth; ++j) acc.v[j] = T(-0.0);
#pragma unroll 1
        for (int r = 0; r < W; ++r) {
          acc = madd(acc, pick<T, W>(w + A * W, r), Sub::eval(leaf, base + r * s, stride, w));
        }
      }
      return acc;
    }
  }
};

// Count of entries of the sorted column g[0..n) that are < x (side "left",
// `torch.searchsorted(side="left")`, partition_point) or <= x (side "right");
// 0 for NaN, since every comparison with NaN is false.
template <bool kRight, typename T>
__device__ __forceinline__ int count_below(const T* __restrict__ g, int n, T x) {
  int lo = 0;
  while (n > 0) {
    const int half = n >> 1;
    const T v = __ldg(g + lo + half);
    if (kRight ? v <= x : v < x) {
      lo += half + 1;
      n -= half + 1;
    } else {
      n = half;
    }
  }
  return lo;
}

template <typename T>
__device__ __forceinline__ int partition_point(const T* __restrict__ g, int n, T x) {
  return count_below<false>(g, n, x);
}

// Rectilinear cubic axis setup (`locate_rectilinear_cubic` and the
// per-region coordinate and difference weights of
// `_axis_reduce_rectilinear`).
template <typename T>
__device__ __forceinline__ int cubic_axis(const T* __restrict__ g, int dim, T x,
                                          RectCubicAxis<T>& ax) {
  const int iloc = partition_point(g, dim, x) - 2;
  const int last = dim - 4 > 0 ? dim - 4 : 0;
  const int loc = iloc < 0 ? 0 : (iloc > last ? last : iloc);
  const bool low = iloc <= -1;
  const bool high = !low && iloc >= dim - 3;
  ax.low = low;
  ax.high = high;
  ax.outside = iloc < -1 || (!low && iloc > dim - 3);
  const T g0 = __ldg(g + loc), g1 = __ldg(g + loc + 1);
  const T g2 = __ldg(g + loc + 2), g3 = __ldg(g + loc + 3);
  const T h01 = sub_rn(g1, g0), h12 = sub_rn(g2, g1), h23 = sub_rn(g3, g2);
  const T one = T(1);
  if (low) {  // mirrored: k0 = -cd(v0, v1, v2; 1, h12/h01)
    ax.tt = div_rn(-sub_rn(x, g1), h01);
    ax.p0 = one;
    ax.q0 = div_rn(h12, h01);
  } else if (high) {  // k0 = cd(v1, v2, v3; h12/h23, 1)
    ax.tt = div_rn(sub_rn(x, g2), h23);
    ax.p0 = div_rn(h12, h23);
    ax.q0 = one;
  } else {  // k0 = cd(v0, v1, v2; h01/h12, 1), k1 = cd(v1, v2, v3; 1, h23/h12)
    ax.tt = div_rn(sub_rn(x, g1), h12);
    ax.p0 = div_rn(h01, h12);
    ax.q0 = one;
  }
  ax.p1 = one;
  ax.q1 = div_rn(h23, h12);
  const T s0 = add_rn(ax.p0, ax.q0), s1 = add_rn(ax.p1, ax.q1);
  ax.a0 = div_rn(ax.p0, s0);
  ax.c0 = div_rn(ax.q0, s0);
  ax.a1 = div_rn(ax.p1, s1);
  ax.c1 = div_rn(ax.q1, s1);
  return loc;
}

// loc and the four cubic weights of one axis at x: the node of
// `_axis_reduce_rectilinear` on the four unit bases, with the quotients
// from the divisors' reciprocals (RectUnitAxis).
template <typename T>
__device__ __forceinline__ int cubic_weights(const T* __restrict__ g, int dim, T x, bool lin,
                                             T* w) {
  RectCubicAxis<T> cubic;
  const int loc = cubic_axis(g, dim, x, cubic);
  RectUnitAxis<T> ax;
  ax.set(cubic);
  ax.weights(lin, w);
  return loc;
}

// The K+1 nonzero basis values at x into N, and the stencil's first
// coefficient index along the axis (`spline_locs_weights`).
template <typename T, int K>
__device__ __forceinline__ int basis_weights(const T* __restrict__ t, int dim, T x, T* N) {
  int span = count_below<true>(t, dim + K + 1, x) - 1;
  span = span < K ? K : (span > dim - 1 ? dim - 1 : span);
  T tk[2 * K];  // t[span - K + 1 .. span + K]
#pragma unroll
  for (int o = 0; o < 2 * K; ++o) tk[o] = __ldg(t + span - K + 1 + o);
  N[0] = T(1);
#pragma unroll
  for (int j = 1; j <= K; ++j) N[j] = T(0);
#pragma unroll
  for (int j = 1; j <= K; ++j) {
    T saved = T(0);
#pragma unroll
    for (int r = 0; r < j; ++r) {
      const T right = tk[r + K];     // t[span + r + 1]
      const T left = tk[r + K - j];  // t[span + r + 1 - j]
      const T temp = div_rn(N[r], sub_rn(right, left));
      N[r] = add_rn(saved, mul_rn(sub_rn(right, x), temp));
      saved = mul_rn(sub_rn(x, left), temp);
    }
    N[j] = saved;
  }
  return span - K;
}

}  // namespace interp
