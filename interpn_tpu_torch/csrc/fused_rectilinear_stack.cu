// Rectilinear-grid evaluation of a stack of tables for Hopper (sm_90a):
// multilinear, multicubic and nearest, f32 and f64, 1-8D.
//
// Replaces the TPU kernel `interpn_tpu/ops/pallas_v3.py::_pallas_v3_pre_stack`
// (K6): K2's placement and contraction over nch tables that share one
// weight build (`eval_rectilinear_stack`, which serves nearest too), f32 only
// on the TPU. Here the kernel of rectilinear.cuh locates each query once and
// loops over the tables, in f32 and f64.

#include "interp_common.cuh"
#include "rectilinear.cuh"

// As `interpn_rectilinear` (fused_rectilinear.cu), over `nch` >= 1 tables:
// `vals` holds them one after another, prod(dims) entries each, and `out`
// holds nch rows of n.
extern "C" int interpn_rectilinear_stack(int method, int linearize, int is_f64, int ndims,
                                         const int* dims, const void* const* grids,
                                         const void* vals, const void* const* obs, void* out,
                                         long long n, int nch, int blocks, void* stream) {
  return interp::rectilinear_entry<true>(method, linearize, is_f64, ndims, dims, grids, vals,
                                         obs, out, n, nch, blocks, stream);
}
