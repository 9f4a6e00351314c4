// Tensor-product B-spline evaluation for Hopper (sm_90a): degree 3
// (`cubic_spline`) and 5 (`quintic`), f32 and f64, 1-8D, one coefficient
// table.
//
// Replaces two uses of TPU kernels in `interpn_tpu/ops/pallas_v3.py`:
// - K4, `_pallas_v3_knots` (`_build_kernel(rect="knots")`): in-kernel span
//   search and Cox-de Boor weights (`_bspline_axis_weights`), then the
//   contraction against the coefficients (`eval_bspline`);
// - K2's spline use, `_pallas_v3_pre` fed by `_eval_bspline_pre`, which
//   contracts spans and weights built in XLA: the TPU picks it for knot
//   columns of 48 entries or fewer (`_spline_use_pre`, a v5e measurement).
//   Here one in-kernel weight build serves every knot length.
// On the TPU f64 splines go to `pallas_df64.eval_bspline` (K8); here the
// double instantiation serves them natively. The kernel, what it computes,
// its design and what bounds it on this card are in bspline.cuh;
// `fused_bspline_stack.cu` instantiates it for stacks.

#include "bspline.cuh"
#include "interp_common.cuh"

// Launches the kernel on `stream` without synchronising and returns
// cudaGetLastError() (0 on success), or the error that sizing the grid met.
// `degree` is 3 or 5. `dims` (the coefficients along each axis), `knots`
// and `obs` are host arrays of `ndims` entries; `knots` (one not-a-knot
// vector of dims[a] + degree + 1 entries per axis), `obs`, `coeffs` and
// `out` hold device pointers of the type selected by `is_f64`. `route` is
// 0 direct or 7 staged groups (the table, within kGroupBytes, copied into
// each 1024-thread block's shared memory; over the cap the entry returns
// cudaErrorInvalidValue). `work` is unused. The caller guarantees
// 1 <= ndims <= 8, every dim >= degree + 1, prod(dims) < 2^31,
// 0 < n < 2^31 and nch == 1.
extern "C" int interpn_bspline(int degree, int is_f64, int ndims, const int* dims,
                               const void* const* knots, void* work, const void* coeffs,
                               const void* const* obs, void* out, long long n, int nch,
                               int route, void* stream) {
  return interp::bspline_entry<false>(degree, is_f64, ndims, dims, knots, work, coeffs, obs, out,
                                      n, nch, route, stream);
}

// Registers a thread, static shared bytes, local (spill) bytes a thread and
// the blocks an SM holds at once with the route's reservation of dynamic
// shared memory, of the instantiation `interpn_bspline` launches for
// (degree, is_f64, ndims, route), into out[0..3].
extern "C" int interpn_bspline_info(int degree, int is_f64, int ndims, int route, int* out) {
  return interp::bspline_info_entry<false>(degree, is_f64, ndims, route, out);
}
