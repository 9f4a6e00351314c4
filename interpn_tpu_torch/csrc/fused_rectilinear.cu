// Rectilinear-grid evaluation for Hopper (sm_90a): multilinear, multicubic
// and nearest, f32 and f64, 1-8D, one table.
//
// Replaces two TPU kernels of `interpn_tpu/ops/pallas_v3.py`:
// - K2, `_pallas_v3_pre` (`_build_kernel(rect="pre")`), which places and
//   contracts (loc, weight) pairs precomputed per axis by
//   `_rect_locs_weights`; it serves rectilinear linear and cubic
//   (`eval_rectilinear_pre`). Here method = linear or cubic; cubic builds
//   the same weights in the kernel and contracts the stencil with them.
// - K3, `_pallas_v3_rect` (`_build_kernel(rect=True)`), which locates by a
//   compare-count inside the kernel and selects one-hot; it serves
//   rectilinear nearest (`eval_rectilinear`). Here method = nearest, and
//   a query's cell comes from its bucket of the block's guide and a
//   bisection of that bucket, one table read: the dense compare-count and
//   one-hot planes answer Mosaic's lack of a per-lane gather.
// On the TPU both serve f32 only; the double instantiation serves f64. The
// kernel, what it computes, its design, its routes and what bounds it on
// this card are in rectilinear.cuh; `fused_rectilinear_stack.cu`
// instantiates it for stacks. The entry here also launches the taps route's
// cubic pack (regular.cuh), the one layout kernel this source builds.

#include "interp_common.cuh"
#include "rectilinear.cuh"

// Launches the kernel on `stream` without synchronising and returns
// cudaGetLastError() (0 on success), or the error that sizing the grid met.
// `method` is 0 linear, 1 cubic, 2 nearest; `linearize` selects linearized
// cubic extrapolation; `route` is the layout the wrapper chose
// (rectilinear.cuh): 0 direct (every method), and for cubic 1 staged (the
// table within kStageBytes) and 4 taps (from 2D, one lane a query), on
// which the cubic pack of `vals` into `work`, (d0-3) prod(d1..) cells of 4
// values, is launched first and the kernel reads it; for linear and
// nearest 8 guided (the columns and their bucket starts within
// kColumnBytes in shared memory), and for linear 1 staged (the table and
// that guide within kStageBytes). `work` is unused on the other routes. `dims`, `grids` and `obs` are host
// arrays of `ndims` entries; `grids` (one sorted column per axis), `obs`,
// `work`, `vals` and `out` hold device pointers of the type selected by
// `is_f64`. The caller guarantees 1 <= ndims <= 8, every dim >= 2 (>= 4 for
// cubic), prod(dims) < 2^31, 0 < n < 2^31 and nch == 1. The grid holds as
// many blocks as the card runs at once, at most one query a thread.
extern "C" int interpn_rectilinear(int method, int linearize, int is_f64, int ndims,
                                   const int* dims, const void* const* grids, void* work,
                                   const void* vals, const void* const* obs, void* out,
                                   long long n, int nch, int route, void* stream) {
  return interp::rectilinear_entry<false>(method, linearize, is_f64, ndims, dims, grids, work,
                                          vals, obs, out, n, nch, route, stream);
}

// Registers a thread, static shared bytes, local (spill) bytes a thread and
// the blocks an SM holds at once with the route's reservation of dynamic
// shared memory, of the instantiation `interpn_rectilinear` launches for
// (method, is_f64, ndims, route), into out[0..3].
extern "C" int interpn_rectilinear_info(int method, int is_f64, int ndims, int route,
                                        int* out) {
  return interp::rectilinear_info_entry<false>(method, is_f64, ndims, route, out);
}
