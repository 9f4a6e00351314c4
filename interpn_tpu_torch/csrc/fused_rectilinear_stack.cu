// Rectilinear-grid evaluation of a stack of tables for Hopper (sm_90a):
// multilinear, multicubic and nearest, f32 and f64, 1-8D.
//
// Replaces the TPU kernel `interpn_tpu/ops/pallas_v3.py::_pallas_v3_pre_stack`
// (K6): K2's placement and contraction over nch tables that share one
// weight build (`eval_rectilinear_stack`, which serves nearest too), f32 only
// on the TPU. Here the kernel of rectilinear.cuh locates each query once
// (and, for cubic, builds its weights once) and runs every table, in f32
// and f64. The entry also launches the interleaved route's interleave
// (regular.cuh), the one layout kernel this source builds.

#include "interp_common.cuh"
#include "rectilinear.cuh"

// As `interpn_rectilinear` (fused_rectilinear.cu), over `nch` >= 1 tables:
// `vals` holds them one after another, prod(dims) entries each, and `out`
// holds nch rows of n. The cubic routes are 1 staged (all the tables
// within kStageBytes, read one at a time), 6 staged_tables (each table
// within kStageBytes, staged in turn into a double buffer) and 3
// interleaved (the interleave of `vals` into `work`, (prod(dims), nch) in
// C order, is launched first and the kernel reads it; the caller
// guarantees prod(dims) * nch < 2^31 there); 0 direct serves every
// method.
extern "C" int interpn_rectilinear_stack(int method, int linearize, int is_f64, int ndims,
                                         const int* dims, const void* const* grids, void* work,
                                         const void* vals, const void* const* obs, void* out,
                                         long long n, int nch, int route, void* stream) {
  return interp::rectilinear_entry<true>(method, linearize, is_f64, ndims, dims, grids, work,
                                         vals, obs, out, n, nch, route, stream);
}

// As `interpn_rectilinear_info`, for the stack's instantiations.
extern "C" int interpn_rectilinear_stack_info(int method, int is_f64, int ndims, int route,
                                              int* out) {
  return interp::rectilinear_info_entry<true>(method, is_f64, ndims, route, out);
}
