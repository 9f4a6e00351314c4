// Rectilinear-grid evaluation for Hopper (sm_90a): multilinear, multicubic
// and nearest, f32 and f64, 1-8D, one table.
//
// Replaces two TPU kernels of `interpn_tpu/ops/pallas_v3.py`:
// - K2, `_pallas_v3_pre` (`_build_kernel(rect="pre")`), which places and
//   contracts (loc, weight) pairs precomputed per axis by
//   `_rect_locs_weights`; it serves rectilinear linear and cubic
//   (`eval_rectilinear_pre`). Here method = linear or cubic.
// - K3, `_pallas_v3_rect` (`_build_kernel(rect=True)`), which locates by a
//   compare-count inside the kernel and selects one-hot; it serves
//   rectilinear nearest (`eval_rectilinear`). Here method = nearest.
// On the TPU both serve f32 only; the double instantiation serves f64. The
// kernel, what it computes, its design and what bounds it on this card are
// in rectilinear.cuh; `fused_rectilinear_stack.cu` instantiates it for
// stacks.

#include "interp_common.cuh"
#include "rectilinear.cuh"

// Launches the kernel on `stream` without synchronising and returns
// cudaGetLastError() (0 on success). `method` is 0 linear, 1 cubic,
// 2 nearest; `linearize` selects linearized cubic extrapolation. `dims`,
// `grids` and `obs` are host arrays of `ndims` entries; `grids` (one sorted
// column per axis), `obs`, `vals` and `out` hold device pointers of the type
// selected by `is_f64`. The caller guarantees 1 <= ndims <= 8, every
// dim >= 2 (>= 4 for cubic), prod(dims) < 2^31, 0 < n < 2^31 and nch == 1.
extern "C" int interpn_rectilinear(int method, int linearize, int is_f64, int ndims,
                                   const int* dims, const void* const* grids,
                                   const void* vals, const void* const* obs, void* out,
                                   long long n, int nch, int blocks, void* stream) {
  return interp::rectilinear_entry<false>(method, linearize, is_f64, ndims, dims, grids, vals,
                                          obs, out, n, nch, blocks, stream);
}
