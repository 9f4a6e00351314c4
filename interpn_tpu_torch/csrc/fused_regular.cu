// Regular-grid evaluation for Hopper (sm_90a): multilinear, multicubic and
// nearest, f32 and f64, 1-8D, one table.
//
// Replaces the TPU kernel `interpn_tpu/ops/pallas_v3.py::_pallas_v3` (K1),
// whose body is `_build_kernel(..., rect=False)` with the per-axis weights of
// `_linear_axis_weights`, `_cubic_axis_weights` and `_nearest_axis_weights`,
// and serves float64 natively (on the TPU, pallas_df64/pallas_i8 serve f64).
// The kernel, what it computes, what bounds it on this card and the layouts
// it reads (the table staged in shared memory, packed quads for a linear
// table above the cap, the cubic pack of axis 0's taps, or the table
// itself) are in regular.cuh; `fused_regular_stack.cu` instantiates it for
// stacks. The entry here also launches the quads and taps routes' packs.

#include "interp_common.cuh"
#include "regular.cuh"

// Launches the kernel on `stream` without synchronising and returns
// cudaGetLastError() (0 on success), or the error that sizing the grid met.
// `method` is 0 linear, 1 cubic, 2 nearest; `linearize` selects linearized
// cubic extrapolation; `route` is the layout the wrapper chose
// (regular.cuh): 0 direct, 1 staged (linear and cubic, the table within
// kStageBytes), 2 quads (linear: the pack of `vals` into `work`,
// (d0-1)(d1-1) prod(d2..) cells of 4 values, or d0-1 pairs of a 1-D table,
// is launched first and the kernel reads it), 4 taps and 5 taps on four
// lanes a query (from 2D) (cubic: the cubic pack of `vals` into `work`,
// (d0-3) prod(d1..) cells of 4 values, is launched first and the kernel
// reads it). `work` is unused
// on the other routes. `dims` and
// `obs` are host arrays of `ndims` entries; `obs`, `starts`, `steps`,
// `work`, `vals` and `out` hold device pointers of the type selected by
// `is_f64`. The caller guarantees 1 <= ndims <= 8, every dim >= 2 (>= 4 for
// cubic), prod(dims) < 2^31, 0 < n < 2^31 and nch == 1. The grid holds as
// many blocks as the card runs at once, at most one query a thread.
extern "C" int interpn_regular(int method, int linearize, int is_f64, int ndims,
                               const int* dims, const void* starts, const void* steps,
                               void* work, const void* vals, const void* const* obs,
                               void* out, long long n, int nch, int route, void* stream) {
  return interp::regular_entry<false>(method, linearize, is_f64, ndims, dims, starts, steps,
                                      work, vals, obs, out, n, nch, route, stream);
}

// Registers a thread, static shared bytes, local (spill) bytes a thread and
// the blocks an SM holds at once with the route's reservation of dynamic
// shared memory, of the instantiation `interpn_regular` launches for
// (method, is_f64, ndims, route), into out[0..3].
extern "C" int interpn_regular_info(int method, int is_f64, int ndims, int route, int* out) {
  return interp::regular_info_entry<false>(method, is_f64, ndims, route, out);
}

// The pack of the quads route alone, as `interpn_regular` launches it on
// that route: `out` receives the packed copy of `vals` (regular.cuh,
// `pack_kernel`). Launched on `stream` without synchronising; returns
// cudaGetLastError(). The caller guarantees 1 <= ndims <= 8, every dim >= 2
// and prod(dims) < 2^31.
extern "C" int interpn_regular_pack(int is_f64, int ndims, const int* dims, const void* vals,
                                    void* out, void* stream) {
  if (ndims < 1 || ndims > interp::kMaxDims) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      is_f64 ? interp::launch_pack(ndims, dims, static_cast<const double*>(vals),
                                   static_cast<double*>(out), s)
             : interp::launch_pack(ndims, dims, static_cast<const float*>(vals),
                                   static_cast<float*>(out), s));
}

// The pack of the taps routes alone, as `interpn_regular` launches it on
// those routes: `out` receives the cubic pack of `vals` (regular.cuh,
// `cubic_pack_kernel`). Launched on `stream` without synchronising; returns
// cudaGetLastError(). The caller guarantees 1 <= ndims <= 8, dims[0] >= 4
// and prod(dims) < 2^31.
extern "C" int interpn_regular_cubic_pack(int is_f64, int ndims, const int* dims,
                                          const void* vals, void* out, void* stream) {
  if (ndims < 1 || ndims > interp::kMaxDims || dims[0] < 4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      is_f64 ? interp::launch_cubic_pack(ndims, dims, static_cast<const double*>(vals),
                                         static_cast<double*>(out), 0, 1, s)
             : interp::launch_cubic_pack(ndims, dims, static_cast<const float*>(vals),
                                         static_cast<float*>(out), 0, 1, s));
}
