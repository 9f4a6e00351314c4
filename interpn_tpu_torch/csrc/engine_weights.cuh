// The float64 weight front end of the f64 contraction engines K8
// (`fused_df64.cu`) and K9 (`fused_i8.cu`): per query and axis, the locate,
// the float64 stencil weights and their float32 hi/lo split, in the order
// and with the operations of `ops/df64.py::weights_f64` /
// `spline_weights_f64` (the counterparts of `interpn_tpu/ops/
// pallas_df64.py:502 _axis_weights_f64` and `:529 _weights_jit`), so that
// the kernels contract the very pairs that the plain version builds in
// torch:
// - linear: loc and (1 - t, t), regular (`locate_regular_linear`) or
//   rectilinear (`locate_rectilinear_linear`);
// - cubic: loc and the axis's node function on the four unit bases, as
//   `_axis_weights` applies `_axis_reduce_regular` /
//   `_axis_reduce_rectilinear` to `_unit_bases` (RegularCubicAxis /
//   RectCubicAxis, interp_common.cuh, with K1's regular locate and
//   rectilinear.cuh's `cubic_axis`);
// - B-spline of degree FP - 1: the de Boor span rebased to the first
//   coefficient and the Cox-de Boor weights (bspline.cuh's `basis_weights`,
//   `ops/bspline.py::spline_locs_weights`);
// - the split `split_f64`: hi = f32(w), lo = f32(w - hi).
// Every step is a _rn intrinsic and the build adds --fmad=false, so the
// node function sees its arguments in the order torch computes them and no
// multiply-add is contracted.

#pragma once

#include "bspline.cuh"
#include "interp_common.cuh"
#include "rectilinear.cuh"

namespace interp {

// the grid kinds of the engines' C entries
constexpr int kGridRegular = 0;
constexpr int kGridRectilinear = 1;
constexpr int kGridSpline = 2;

// What the engines read to locate each axis: starts and steps (regular), or
// one sorted column per axis (rectilinear: the grid; spline: the knots).
struct EngineGrid {
  int kind;
  const double* __restrict__ start;
  const double* __restrict__ step;
  const double* col[kMaxDims];
  int dim[kMaxDims];  // points (spline: coefficients) per axis
};

struct EngineObs {
  const double* p[kMaxDims];
};

// A rectilinear cubic axis for the unit bases: RectCubicAxis::node with
// each difference quotient (y2 - y1) / q taken from the divisor's
// reciprocal. On a unit basis the numerator is 1, -1 or +0, and then
// RN(1 / q), -RN(1 / q) and RN(+0 / q) are the quotient bit for bit (the
// rounding is symmetric in sign; +0 / q is a zero of q's sign, NaN for q
// zero or NaN), so the weights are the plain version's with 4 divisions an
// axis in place of 16.
struct RectUnitAxis {
  RectCubicAxis<double> ax;
  double rp0, rq0, rp1, rq1;  // reciprocals of the difference divisors
  double zp0, zq0, zp1, zq1;  // +0 / divisor

  __device__ __forceinline__ void set(const RectCubicAxis<double>& a) {
    ax = a;
    rp0 = div_rn(1.0, a.p0);
    rq0 = div_rn(1.0, a.q0);
    rp1 = div_rn(1.0, a.p1);
    rq1 = div_rn(1.0, a.q1);
    zp0 = zero_over(a.p0);
    zq0 = zero_over(a.q0);
    zp1 = zero_over(a.p1);
    zq1 = zero_over(a.q1);
  }

  static __device__ __forceinline__ double zero_over(double d) {
    return d != 0.0 && d == d ? copysign(0.0, d) : __longlong_as_double(0x7ff8000000000000LL);
  }

  // (numerator) / divisor for a numerator of 1, -1 or +0
  static __device__ __forceinline__ double quot(double num, double recip, double zero) {
    return num == 1.0 ? recip : (num == -1.0 ? -recip : zero);
  }

  // centered_diff of interp_common.cuh with its two quotients so taken
  static __device__ __forceinline__ double cd(double y0, double y1, double y2, double a, double c,
                                              double rp, double zp, double rq, double zq) {
    return add_rn(mul_rn(a, quot(sub_rn(y2, y1), rq, zq)),
                  mul_rn(c, quot(sub_rn(y1, y0), rp, zp)));
  }

  __device__ __forceinline__ double node(double v0, double v1, double v2, double v3,
                                         bool lin) const {
    const double y0 = ax.high ? v2 : v1;
    const double dy =
        ax.low ? sub_rn(v0, v1) : (ax.high ? sub_rn(v3, v2) : sub_rn(v2, v1));
    double k0, k1;
    if (ax.low) {
      k0 = -cd(v0, v1, v2, ax.a0, ax.c0, rp0, zp0, rq0, zq0);
      k1 = sub_rn(mul_rn(2.0, dy), k0);
    } else if (ax.high) {
      k0 = cd(v1, v2, v3, ax.a0, ax.c0, rp0, zp0, rq0, zq0);
      k1 = sub_rn(mul_rn(2.0, dy), k0);
    } else {
      k0 = cd(v0, v1, v2, ax.a0, ax.c0, rp0, zp0, rq0, zq0);
      k1 = cd(v1, v2, v3, ax.a1, ax.c1, rp1, zp1, rq1, zq1);
    }
    return cubic_finish(hermite(ax.tt, y0, dy, k0, k1), ax.tt, y0, k1, v0, v2, v3, ax.low,
                        ax.high, ax.outside, lin);
  }
};

// loc and the FP float64 weights of axis k at x.
template <int FP>
__device__ __forceinline__ int axis_weights(const EngineGrid& g, int k, double x, bool lin,
                                            double* w) {
  const int dim = g.dim[k];
  if constexpr (FP == 2) {
    double t;
    int loc;
    if (g.kind == kGridRegular) {
      const double start = __ldg(g.start + k), step = __ldg(g.step + k);
      double floc = floor(div_rn(sub_rn(x, start), step));
      floc = isnan(floc) ? 0.0 : floc;  // NaN reads cell 0, t = NaN
      loc = static_cast<int>(clamp_(floc, static_cast<double>(dim - 2)));
      t = div_rn(sub_rn(x, add_rn(start, mul_rn(step, static_cast<double>(loc)))), step);
    } else {
      const double* __restrict__ col = g.col[k];
      const int iloc = partition_point(col, dim, x) - 1;
      loc = iloc < 0 ? 0 : (iloc > dim - 2 ? dim - 2 : iloc);
      const double x0 = __ldg(col + loc);
      t = div_rn(sub_rn(x, x0), sub_rn(__ldg(col + loc + 1), x0));
    }
    w[0] = sub_rn(1.0, t);
    w[1] = t;
    return loc;
  } else if constexpr (FP == 4) {
    if (g.kind == kGridSpline) return basis_weights<double, 3>(g.col[k], dim, x, w);
    // the node on unit basis j gives weight j
    if (g.kind == kGridRegular) {
      const double start = __ldg(g.start + k), step = __ldg(g.step + k);
      const double iloc = sub_rn(floor(div_rn(sub_rn(x, start), step)), 1.0);
      const double last = static_cast<double>(dim - 4 > 0 ? dim - 4 : 0);
      const int loc = static_cast<int>(clamp_(isnan(iloc) ? 0.0 : iloc, last));
      const double high_at = static_cast<double>(dim - 3);
      RegularCubicAxis<double> ax;
      ax.low = iloc <= -1.0;
      ax.high = !ax.low && iloc >= high_at;
      ax.outside = iloc < -1.0 || (!ax.low && iloc > high_at);
      const double t = div_rn(
          sub_rn(x, add_rn(start, mul_rn(step, static_cast<double>(loc + 1)))), step);
      ax.tt = ax.low ? -t : (ax.high ? sub_rn(t, 1.0) : t);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        w[j] = ax.node(j == 0 ? 1.0 : 0.0, j == 1 ? 1.0 : 0.0, j == 2 ? 1.0 : 0.0,
                       j == 3 ? 1.0 : 0.0, lin);
      }
      return loc;
    }
    RectCubicAxis<double> cubic;
    const int loc = cubic_axis(g.col[k], dim, x, cubic);
    RectUnitAxis ax;
    ax.set(cubic);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      w[j] = ax.node(j == 0 ? 1.0 : 0.0, j == 1 ? 1.0 : 0.0, j == 2 ? 1.0 : 0.0,
                     j == 3 ? 1.0 : 0.0, lin);
    }
    return loc;
  } else {
    static_assert(FP == 6, "footprint 2 (linear), 4 (cubic, cubic_spline) or 6 (quintic)");
    return basis_weights<double, 5>(g.col[k], dim, x, w);
  }
}

// `split_f64`: hi + lo == w within about 2^-48 relative.
__device__ __forceinline__ void split_f64(double w, float& hi, float& lo) {
  hi = __double2float_rn(w);
  lo = __double2float_rn(__dsub_rn(w, static_cast<double>(hi)));
}

// The float32 pairs of one query's weights, axis-major (axis k's tap j at
// k * FP + j), its stencil's first cell per axis and, when `sum` is given,
// wsum: the product over the axes, in axis order, of each axis's weights
// summed left to right (`ops/df64.py::_pack`).
template <int NDIMS, int FP>
__device__ __forceinline__ void query_weights(const EngineGrid& g, const EngineObs& obs,
                                              int64_t i, bool lin, int* loc, float* wh,
                                              float* wl, double* sum = nullptr) {
  double wsum = 0.0;
#pragma unroll
  for (int k = 0; k < NDIMS; ++k) {
    double w[FP];
    loc[k] = axis_weights<FP>(g, k, __ldg(obs.p[k] + i), lin, w);
    double s = w[0];
#pragma unroll
    for (int j = 0; j < FP; ++j) {
      split_f64(w[j], wh[k * FP + j], wl[k * FP + j]);
      if (j > 0) s = add_rn(s, w[j]);
    }
    wsum = k == 0 ? s : mul_rn(wsum, s);
  }
  if (sum != nullptr) *sum = wsum;
}

}  // namespace interp
