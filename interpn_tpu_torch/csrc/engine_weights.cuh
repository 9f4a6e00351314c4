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
//   `_axis_reduce_rectilinear` to `unit_bases` (interp_common.cuh's
//   `regular_cubic_weights`, with K1's locate and node, and
//   `cubic_weights`, shared with K2 and K6);
// - B-spline of degree FP - 1: the de Boor span rebased to the first
//   coefficient and the Cox-de Boor weights (interp_common.cuh's `basis_weights`,
//   `ops/bspline.py::spline_locs_weights`);
// - the split `split_f64`: hi = f32(w), lo = f32(w - hi).
// Every step is a _rn intrinsic and the build adds --fmad=false, so the
// node function sees its arguments in the order torch computes them and no
// multiply-add is contracted.

#pragma once

#include "interp_common.cuh"

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
    if (g.kind == kGridRegular) {
      return regular_cubic_weights(x, __ldg(g.start + k), __ldg(g.step + k), dim, lin, w);
    }
    return cubic_weights(g.col[k], dim, x, lin, w);
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
