// Rectilinear-grid evaluation of a stack of tables for Hopper (sm_90a):
// multilinear, multicubic and nearest, f32 and f64, 1-8D.
//
// Replaces the TPU kernel `interpn_tpu/ops/pallas_v3.py::_pallas_v3_pre_stack`
// (K6): K2's placement and contraction over nch tables that share one
// weight build (`eval_rectilinear_stack`, which serves nearest too), f32 only
// on the TPU. Here the kernel of rectilinear.cuh locates each query once
// (and, for cubic, builds its weights once) and runs every table, in f32
// and f64. The entry also launches the interleaved route's interleave
// (regular.cuh), the one layout kernel this source builds, which
// `interpn_rectilinear_stack_interleave` launches alone. This unit builds
// the cubic instantiations; fused_rectilinear_stack_lerp.cu, compiled
// beside it into the same library, the linear and nearest ones.

#include "interp_common.cuh"
#include "rectilinear.cuh"

// As `interpn_rectilinear` (fused_rectilinear.cu), over `nch` >= 1 tables:
// `vals` holds them one after another, prod(dims) entries each, and `out`
// holds nch rows of n. The cubic routes are 1 staged (all the tables
// within kStageBytes, read one at a time), 6 staged_tables (each table
// within kStageBytes, staged in turn into a double buffer) and 3
// interleaved (the interleave of `vals` into `work`, (prod(dims), nch) in
// C order, is launched first and the kernel reads it; the caller
// guarantees prod(dims) * nch < 2^31 there); linear and nearest take 3
// interleaved too, and linear 1 staged; 0 direct serves every method.
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

// The interleave of the interleaved route alone, as `interpn_rectilinear_stack`
// launches it on that route: `out` (16-byte aligned) receives the (nch,
// table) stack `vals` as (table, nch) (regular.cuh, `interleave_kernel`).
// Launched on `stream` without synchronising; returns cudaGetLastError().
// The caller guarantees table * nch < 2^31.
extern "C" int interpn_rectilinear_stack_interleave(int is_f64, long long table, int nch,
                                                    const void* vals, void* out, void* stream) {
  if (table <= 0 || nch <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      is_f64 ? interp::launch_interleave(static_cast<const double*>(vals),
                                         static_cast<double*>(out), table, nch, s)
             : interp::launch_interleave(static_cast<const float*>(vals),
                                         static_cast<float*>(out), table, nch, s));
}
