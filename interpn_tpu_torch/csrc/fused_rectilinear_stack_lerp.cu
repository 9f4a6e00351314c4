// Rectilinear-grid evaluation of a stack of tables for Hopper (sm_90a), the
// linear and nearest half: the instantiations of rectilinear.cuh's kernel
// for those methods (direct, interleaved, and staged for linear), compiled
// beside fused_rectilinear_stack.cu, whose C entry launches them, by its own
// nvcc, and linked into the same library (interpn_tpu_torch/_build.py's
// PARTS). The layout kernels stay in fused_rectilinear_stack.cu, so that
// each kernel is built in one unit only.

#include "interp_common.cuh"
#include "rectilinear.cuh"

namespace interp {

cudaError_t rect_stack_lerp_launch(int is_f64, int route, int method, int ndims,
                                   const RectLaunch& a) {
  return rect_launch<true, kLerpMethods>(is_f64, route, method, ndims, a);
}

cudaError_t rect_stack_lerp_info(int is_f64, int route, int method, int ndims, int* out) {
  return rect_info<true, kLerpMethods>(is_f64, route, method, ndims, out);
}

}  // namespace interp
