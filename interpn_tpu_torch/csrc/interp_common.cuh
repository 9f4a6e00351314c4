// Shared device code of the port's Hopper kernels (sm_90a): IEEE-rounded
// arithmetic, the linear lerp tree, the cubic Hermite tree, the B-spline
// tree and the bisections.
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

// Value of the D-dimensional sub-cell at `base`: the two (D-1)-dimensional
// halves along dim D-1, lerped with t[D-1]. Depth first, so at most D
// partial sums are live; the pairing is the level-by-level tree's.
template <typename T, int D>
struct LerpTree {
  static __device__ __forceinline__ T eval(const T* __restrict__ vals, int base,
                                           const int* stride, const T* t) {
    const T y0 = LerpTree<T, D - 1>::eval(vals, base, stride, t);
    const T y1 = LerpTree<T, D - 1>::eval(vals, base + stride[D - 1], stride, t);
    return add_rn(y0, mul_rn(t[D - 1], sub_rn(y1, y0)));
  }
};

template <typename T>
struct LerpTree<T, 0> {
  static __device__ __forceinline__ T eval(const T* __restrict__ vals, int base,
                                           const int*, const T*) {
    return __ldg(vals + base);
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
};

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

// Value of the D-dimensional 4^D sub-stencil at `base`: the four
// (D-1)-dimensional sub-stencils along dim D-1 reduced by axis D-1's node.
// The inner kCubicUnrolled levels unroll; each outer level runs its four
// children in a loop and keeps them in registers through selects (a
// dynamically indexed array would live in local memory).
template <typename T, typename Axis, int D>
struct CubicTree {
  static __device__ __forceinline__ T eval(const T* __restrict__ vals, int base,
                                           const int* stride, const Axis* ax, bool lin) {
    const int s = stride[D - 1];
    if constexpr (D <= kCubicUnrolled) {
      const T v0 = CubicTree<T, Axis, D - 1>::eval(vals, base, stride, ax, lin);
      const T v1 = CubicTree<T, Axis, D - 1>::eval(vals, base + s, stride, ax, lin);
      const T v2 = CubicTree<T, Axis, D - 1>::eval(vals, base + 2 * s, stride, ax, lin);
      const T v3 = CubicTree<T, Axis, D - 1>::eval(vals, base + 3 * s, stride, ax, lin);
      return ax[D - 1].node(v0, v1, v2, v3, lin);
    } else {
      T v0 = T(0), v1 = T(0), v2 = T(0), v3 = T(0);
#pragma unroll 1
      for (int j = 0; j < 4; ++j) {
        const T y = CubicTree<T, Axis, D - 1>::eval(vals, base + j * s, stride, ax, lin);
        v0 = j == 0 ? y : v0;
        v1 = j == 1 ? y : v1;
        v2 = j == 2 ? y : v2;
        v3 = j == 3 ? y : v3;
      }
      return ax[D - 1].node(v0, v1, v2, v3, lin);
    }
  }
};

template <typename T, typename Axis>
struct CubicTree<T, Axis, 0> {
  static __device__ __forceinline__ T eval(const T* __restrict__ vals, int base,
                                           const int*, const Axis*, bool) {
    return __ldg(vals + base);
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

// Value of the W^(NDIMS-A) sub-stencil at `base` with axes 0..A-1 fixed:
// sum over r of w[A * W + r] (axis A's weights) times the sub-stencil one
// axis in, summed left to right. Axis NDIMS-1 is reduced first and axis 0 last, the plain version's
// order (`ops/bspline.py::_bspline_impl`). The inner kSplineUnrolled levels
// unroll; each outer level is a loop of W with one running sum, started at
// -0.0 so that its first addition returns the first product bit for bit.
template <typename T, int W, int NDIMS, int A>
struct SplineTree {
  static __device__ __forceinline__ T eval(const T* __restrict__ c, int base,
                                           const int* stride, const T* w) {
    if constexpr (A == NDIMS) {
      return __ldg(c + base);
    } else {
      const int s = stride[A];
      if constexpr (NDIMS - A <= kSplineUnrolled<W>) {
        T acc = mul_rn(w[A * W], SplineTree<T, W, NDIMS, A + 1>::eval(c, base, stride, w));
#pragma unroll
        for (int r = 1; r < W; ++r) {
          const T y = SplineTree<T, W, NDIMS, A + 1>::eval(c, base + r * s, stride, w);
          acc = add_rn(acc, mul_rn(w[A * W + r], y));
        }
        return acc;
      } else {
        T acc = T(-0.0);
#pragma unroll 1
        for (int r = 0; r < W; ++r) {
          const T y = SplineTree<T, W, NDIMS, A + 1>::eval(c, base + r * s, stride, w);
          acc = add_rn(acc, mul_rn(pick<T, W>(w + A * W, r), y));
        }
        return acc;
      }
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

}  // namespace interp
