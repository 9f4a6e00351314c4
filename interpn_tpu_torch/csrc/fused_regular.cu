// Regular-grid evaluation for Hopper (sm_90a): multilinear, multicubic and
// nearest, f32 and f64, 1-8D, one table.
//
// Replaces the TPU kernel `interpn_tpu/ops/pallas_v3.py::_pallas_v3` (K1),
// whose body is `_build_kernel(..., rect=False)` with the per-axis weights of
// `_linear_axis_weights`, `_cubic_axis_weights` and `_nearest_axis_weights`,
// and serves float64 natively (on the TPU, pallas_df64/pallas_i8 serve f64).
// The kernel, what it computes, its design and what bounds it on this card
// are in regular.cuh; `fused_regular_stack.cu` instantiates it for stacks.

#include "interp_common.cuh"
#include "regular.cuh"

// Launches the kernel on `stream` without synchronising and returns
// cudaGetLastError() (0 on success). `method` is 0 linear, 1 cubic,
// 2 nearest; `linearize` selects linearized cubic extrapolation. `dims` and
// `obs` are host arrays of `ndims` entries; `obs`, `starts`, `steps`, `vals`
// and `out` hold device pointers of the type selected by `is_f64`. The
// caller guarantees 1 <= ndims <= 8, every dim >= 2 (>= 4 for cubic),
// prod(dims) < 2^31, 0 < n < 2^31 and nch == 1.
extern "C" int interpn_regular(int method, int linearize, int is_f64, int ndims,
                               const int* dims, const void* starts, const void* steps,
                               const void* vals, const void* const* obs, void* out,
                               long long n, int nch, int blocks, void* stream) {
  return interp::regular_entry<false>(method, linearize, is_f64, ndims, dims, starts, steps,
                                      vals, obs, out, n, nch, blocks, stream);
}
