// Regular-grid evaluation of a stack of tables for Hopper (sm_90a):
// multilinear, multicubic and nearest, f32 and f64, 1-8D.
//
// Replaces the TPU kernel `interpn_tpu/ops/pallas_v3.py::_pallas_v3_stack`
// (K5): `_build_kernel(..., rect=False, nch=nch)` over nch tables that share
// one weight build (`eval_regular_stack`), f32 only on the TPU. Here the
// kernel of regular.cuh locates each query once and, for a linear or
// nearest stack of 8 f32 or 4 f64 tables or more, reads it
// channel-interleaved, a corner's channels side by side; a smaller linear
// stack is staged in shared memory where the whole stack fits the cap, and
// a cubic stack in groups of consecutive tables, one group to a block,
// each block reading its tables one after another from its copy; a cubic
// stack of larger tables is read table after table through each table's
// cubic pack, which the entry lays out first, four lanes a query from 3D.
// f32 and f64. What bounds it and what the layouts do about it are in
// regular.cuh.

#include "interp_common.cuh"
#include "regular.cuh"

// As `interpn_regular` (fused_regular.cu), over `nch` >= 1 tables that
// `vals` holds one after another, (nch, prod(dims)); `out` holds nch rows of
// n; `route` is 0 direct, 1 staged (linear: the whole stack within
// kStageBytes) or 7 staged groups (cubic: the fewest groups of consecutive
// tables within kGroupBytes, which the entry counts, split as
// `table_group` says; every table within it), which read `vals` as it is,
// or 3 interleaved (linear and nearest): the interleave of `vals` into
// `work`, (prod(dims), nch) in C order, is launched first and the kernel
// reads it, or 4 taps (2D) and 5 taps on four lanes a query (from 3D)
// (cubic): the cubic pack of each table of `vals` into `work`, nch times
// (d0-3) prod(d1..) cells of 4 values, table after table, is launched first
// and the kernel reads it. `work` is unused on the other routes. The caller
// also guarantees prod(dims) * nch < 2^31 on the interleaved route, and
// that `work` holds fewer than 2^31 values on the taps routes.
extern "C" int interpn_regular_stack(int method, int linearize, int is_f64, int ndims,
                                     const int* dims, const void* starts, const void* steps,
                                     void* work, const void* vals, const void* const* obs,
                                     void* out, long long n, int nch, int route,
                                     void* stream) {
  return interp::regular_entry<true>(method, linearize, is_f64, ndims, dims, starts, steps,
                                     work, vals, obs, out, n, nch, route, stream);
}

// As `interpn_regular_info`, for the stack's instantiations.
extern "C" int interpn_regular_stack_info(int method, int is_f64, int ndims, int route,
                                          int* out) {
  return interp::regular_info_entry<true>(method, is_f64, ndims, route, out);
}

// The interleave of the interleaved route alone, as `interpn_regular_stack`
// launches it on that route: `out` (16-byte aligned) receives the (nch,
// table) stack `vals` as (table, nch) (regular.cuh, `interleave_kernel`).
// Launched on `stream` without synchronising; returns cudaGetLastError().
// The caller guarantees table * nch < 2^31.
extern "C" int interpn_regular_stack_interleave(int is_f64, long long table, int nch,
                                                const void* vals, void* out, void* stream) {
  if (table <= 0 || nch <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      is_f64 ? interp::launch_interleave(static_cast<const double*>(vals),
                                         static_cast<double*>(out), table, nch, s)
             : interp::launch_interleave(static_cast<const float*>(vals),
                                         static_cast<float*>(out), table, nch, s));
}

// The cubic pack of the taps routes alone, as `interpn_regular_stack`
// launches it on those routes: `out` receives the cubic pack of each table
// of the (nch, prod(dims)) stack `vals`, table after table (regular.cuh,
// `cubic_pack_kernel`). Launched on `stream` without synchronising;
// returns cudaGetLastError(). The caller guarantees 1 <= ndims <= 8,
// dims[0] >= 4 and that the pack holds fewer than 2^31 values.
extern "C" int interpn_regular_stack_cubic_pack(int is_f64, int ndims, const int* dims, int nch,
                                                const void* vals, void* out, void* stream) {
  if (ndims < 1 || ndims > interp::kMaxDims || dims[0] < 4 || nch <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  long long table = 1;
  for (int k = 0; k < ndims; ++k) table *= dims[k];
  const auto s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      is_f64 ? interp::launch_cubic_pack(ndims, dims, static_cast<const double*>(vals),
                                         static_cast<double*>(out), table, nch, s)
             : interp::launch_cubic_pack(ndims, dims, static_cast<const float*>(vals),
                                         static_cast<float*>(out), table, nch, s));
}
