// Tensor-product B-spline evaluation of a stack of coefficient tables for
// Hopper (sm_90a): degree 3 and 5, f32 and f64, 1-8D.
//
// Replaces the TPU kernel `interpn_tpu/ops/pallas_v3.py::_pallas_v3_knots_stack`
// (K7), and K6's spline use (`_pallas_v3_pre_stack` fed by
// `_bspline_pre_mats`): nch coefficient tables that share one knot set and
// one weight build (`eval_bspline_stack`), f32 only on the TPU. Here the
// kernel of bspline.cuh builds each query's weights once and runs the
// tables, in f32 and f64, read as the wrapper's route says: staged in
// shared memory in groups of consecutive tables, one group to a block
// (regular.cuh's kStagedGroups), channel-interleaved (K5's interleave,
// launched by this entry first), or direct.

#include "bspline.cuh"
#include "interp_common.cuh"

// As `interpn_bspline` (fused_bspline.cu), over `nch` >= 1 coefficient
// tables: `coeffs` holds them one after another, prod(dims) entries each,
// and `out` holds nch rows of n. `route` is 0 direct or 7 staged groups
// (the fewest groups of consecutive tables within kGroupBytes, which the
// entry counts; every table within it), which read `coeffs` as it is, or
// 3 interleaved: the interleave of `coeffs` into `work`, (prod(dims), nch)
// in C order, is launched first and the kernel reads it (the caller
// guarantees prod(dims) * nch < 2^31 there).
extern "C" int interpn_bspline_stack(int degree, int is_f64, int ndims, const int* dims,
                                     const void* const* knots, void* work, const void* coeffs,
                                     const void* const* obs, void* out, long long n, int nch,
                                     int route, void* stream) {
  return interp::bspline_entry<true>(degree, is_f64, ndims, dims, knots, work, coeffs, obs, out,
                                     n, nch, route, stream);
}

// As `interpn_bspline_info`, for the stack's instantiations.
extern "C" int interpn_bspline_stack_info(int degree, int is_f64, int ndims, int route,
                                          int* out) {
  return interp::bspline_info_entry<true>(degree, is_f64, ndims, route, out);
}
