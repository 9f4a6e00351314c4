// Regular-grid evaluation of a stack of tables for Hopper (sm_90a):
// multilinear, multicubic and nearest, f32 and f64, 1-8D.
//
// Replaces the TPU kernel `interpn_tpu/ops/pallas_v3.py::_pallas_v3_stack`
// (K5): `_build_kernel(..., rect=False, nch=nch)` over nch tables that share
// one weight build (`eval_regular_stack`), f32 only on the TPU. Here the
// kernel of regular.cuh locates each query once and loops over the tables,
// in f32 and f64.

#include "interp_common.cuh"
#include "regular.cuh"

// As `interpn_regular` (fused_regular.cu), over `nch` >= 1 tables: `vals`
// holds them one after another, prod(dims) entries each, and `out` holds
// nch rows of n.
extern "C" int interpn_regular_stack(int method, int linearize, int is_f64, int ndims,
                                     const int* dims, const void* starts, const void* steps,
                                     const void* vals, const void* const* obs, void* out,
                                     long long n, int nch, int blocks, void* stream) {
  return interp::regular_entry<true>(method, linearize, is_f64, ndims, dims, starts, steps,
                                     vals, obs, out, n, nch, blocks, stream);
}
