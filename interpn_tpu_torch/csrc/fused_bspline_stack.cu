// Tensor-product B-spline evaluation of a stack of coefficient tables for
// Hopper (sm_90a): degree 3 and 5, f32 and f64, 1-8D.
//
// Replaces the TPU kernel `interpn_tpu/ops/pallas_v3.py::_pallas_v3_knots_stack`
// (K7), and K6's spline use (`_pallas_v3_pre_stack` fed by
// `_bspline_pre_mats`): nch coefficient tables that share one knot set and
// one weight build (`eval_bspline_stack`), f32 only on the TPU. Here the
// kernel of bspline.cuh builds each query's weights once and loops over the
// tables, in f32 and f64.

#include "bspline.cuh"
#include "interp_common.cuh"

// As `interpn_bspline` (fused_bspline.cu), over `nch` >= 1 coefficient
// tables: `coeffs` holds them one after another, prod(dims) entries each,
// and `out` holds nch rows of n.
extern "C" int interpn_bspline_stack(int degree, int is_f64, int ndims, const int* dims,
                                     const void* const* knots, const void* coeffs,
                                     const void* const* obs, void* out, long long n, int nch,
                                     int blocks, void* stream) {
  return interp::bspline_entry<true>(degree, is_f64, ndims, dims, knots, coeffs, obs, out, n,
                                     nch, blocks, stream);
}
