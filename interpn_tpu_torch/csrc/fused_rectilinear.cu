// Rectilinear-grid evaluation for Hopper (sm_90a): multilinear, multicubic
// and nearest, f32 and f64, 1-8D.
//
// Replaces two TPU kernels of `interpn_tpu/ops/pallas_v3.py`:
// - K2, `_pallas_v3_pre` (`_build_kernel(rect="pre")`), which places and
//   contracts (loc, weight) pairs precomputed per axis by
//   `_rect_locs_weights`; it serves rectilinear linear and cubic
//   (`eval_rectilinear_pre`). Here method = linear or cubic.
// - K3, `_pallas_v3_rect` (`_build_kernel(rect=True)`), which locates by a
//   compare-count inside the kernel and selects one-hot; it serves
//   rectilinear nearest (`eval_rectilinear`). Here method = nearest.
// On the TPU both serve f32 only; the double instantiation serves f64.
//
// What it computes, per query: each axis locates its cell by bisection over
// that axis's grid column (partition_point(g < x), NaN counting 0, as
// `ops/locate.py` pins it), then
// - linear: t = (x - x0)/(x1 - x0) and the lerp tree of
//   `ops/linear.py::linear_rectilinear`;
// - cubic: the Hermite tree of `ops/cubic.py::cubic_rectilinear`, with the
//   nonuniform centered differences and h-ratio normalizations of
//   `_axis_reduce_rectilinear`;
// - nearest: one table read, the lower index winning the tie.
// Every rounding step is the plain PyTorch version's, so the two agree bit
// for bit (see interp_common.cuh).
//
// Design: the TPU computes weights outside the kernel (K2) or builds dense
// one-hot planes per axis (K3) because Mosaic has no per-lane gather. Here
// one thread per query bisects its columns (a few KB, read through the
// read-only cache) and reads only its stencil, so no weights pass through
// device memory. The grid-dependent parts of the cubic differences are
// computed once per axis, not once per tree node.
//
// What bounds it on this card: the query stream (sizeof(T)*(ndims+1) bytes
// per query) for linear and nearest, plus about log2(dim) dependent column
// reads per axis for the bisection; cubic adds about 30 floating-point
// operations per tree node and is bound by arithmetic from 3D up.

#include "interp_common.cuh"

namespace {

using namespace interp;

template <typename T>
struct RectGrid {
  const T* col[kMaxDims];  // grid column of each axis
  int dim[kMaxDims];       // its length
  int stride[kMaxDims];    // C-order strides of the table in elements
};

// Cubic axis setup (`locate_rectilinear_cubic` and the per-region
// coordinate and difference weights of `_axis_reduce_rectilinear`).
template <typename T>
__device__ __forceinline__ int cubic_axis(const T* __restrict__ g, int dim, T x,
                                          RectCubicAxis<T>& ax) {
  const int iloc = partition_point(g, dim, x) - 2;
  const int last = dim - 4 > 0 ? dim - 4 : 0;
  const int loc = iloc < 0 ? 0 : (iloc > last ? last : iloc);
  const bool low = iloc <= -1;
  const bool high = !low && iloc >= dim - 3;
  ax.low = low;
  ax.high = high;
  ax.outside = iloc < -1 || (!low && iloc > dim - 3);
  const T g0 = __ldg(g + loc), g1 = __ldg(g + loc + 1);
  const T g2 = __ldg(g + loc + 2), g3 = __ldg(g + loc + 3);
  const T h01 = sub_rn(g1, g0), h12 = sub_rn(g2, g1), h23 = sub_rn(g3, g2);
  const T one = T(1);
  if (low) {  // mirrored: k0 = -cd(v0, v1, v2; 1, h12/h01)
    ax.tt = div_rn(-sub_rn(x, g1), h01);
    ax.p0 = one;
    ax.q0 = div_rn(h12, h01);
  } else if (high) {  // k0 = cd(v1, v2, v3; h12/h23, 1)
    ax.tt = div_rn(sub_rn(x, g2), h23);
    ax.p0 = div_rn(h12, h23);
    ax.q0 = one;
  } else {  // k0 = cd(v0, v1, v2; h01/h12, 1), k1 = cd(v1, v2, v3; 1, h23/h12)
    ax.tt = div_rn(sub_rn(x, g1), h12);
    ax.p0 = div_rn(h01, h12);
    ax.q0 = one;
  }
  ax.p1 = one;
  ax.q1 = div_rn(h23, h12);
  const T s0 = add_rn(ax.p0, ax.q0), s1 = add_rn(ax.p1, ax.q1);
  ax.a0 = div_rn(ax.p0, s0);
  ax.c0 = div_rn(ax.q0, s0);
  ax.a1 = div_rn(ax.p1, s1);
  ax.c1 = div_rn(ax.q1, s1);
  return loc;
}

template <typename T, int NDIMS, int METHOD>
__global__ void __launch_bounds__(kThreads)
    rectilinear_kernel(RectGrid<T> grid, ObsPtrs<T> obs, const T* __restrict__ vals,
                       T* __restrict__ out, int64_t n, bool lin) {
  const int64_t nthreads = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += nthreads) {
    int base = 0;
    int stride[NDIMS];
    if constexpr (METHOD == kCubic) {
      RectCubicAxis<T> ax[NDIMS];
#pragma unroll
      for (int k = 0; k < NDIMS; ++k) {
        stride[k] = grid.stride[k];
        base += cubic_axis(grid.col[k], grid.dim[k], __ldg(obs.p[k] + i), ax[k]) * stride[k];
      }
      out[i] = CubicTree<T, RectCubicAxis<T>, NDIMS>::eval(vals, base, stride, ax, lin);
    } else {
      T t[NDIMS];
#pragma unroll
      for (int k = 0; k < NDIMS; ++k) {
        stride[k] = grid.stride[k];
        const T* __restrict__ g = grid.col[k];
        const T x = __ldg(obs.p[k] + i);
        const int iloc = partition_point(g, grid.dim[k], x) - 1;
        const int last = grid.dim[k] - 2 > 0 ? grid.dim[k] - 2 : 0;
        const int loc = iloc < 0 ? 0 : (iloc > last ? last : iloc);
        const T x0 = __ldg(g + loc);
        t[k] = div_rn(sub_rn(x, x0), sub_rn(__ldg(g + loc + 1), x0));
        // nearest: the lower index at the tie; NaN t fails <= and takes +1
        base += (METHOD == kNearest ? loc + (t[k] <= T(0.5) ? 0 : 1) : loc) * stride[k];
      }
      if constexpr (METHOD == kNearest) {
        out[i] = __ldg(vals + base);
      } else {
        out[i] = LerpTree<T, NDIMS>::eval(vals, base, stride, t);
      }
    }
  }
}

template <typename T, int NDIMS, int METHOD>
cudaError_t launch(const int* dims, const void* const* cols, const void* const* obs,
                   const void* vals, void* out, int64_t n, bool lin, int blocks,
                   cudaStream_t stream) {
  RectGrid<T> grid{};
  ObsPtrs<T> ptrs{};
  int acc = 1;
  for (int k = NDIMS - 1; k >= 0; --k) {
    grid.col[k] = static_cast<const T*>(cols[k]);
    grid.dim[k] = dims[k];
    grid.stride[k] = acc;
    acc *= dims[k];
    ptrs.p[k] = static_cast<const T*>(obs[k]);
  }
  rectilinear_kernel<T, NDIMS, METHOD><<<blocks, kThreads, 0, stream>>>(
      grid, ptrs, static_cast<const T*>(vals), static_cast<T*>(out), n, lin);
  return cudaGetLastError();
}

template <typename T, int METHOD>
cudaError_t launch_ndims(int ndims, const int* dims, const void* const* cols,
                         const void* const* obs, const void* vals, void* out, int64_t n,
                         bool lin, int blocks, cudaStream_t s) {
  switch (ndims) {
    case 1: return launch<T, 1, METHOD>(dims, cols, obs, vals, out, n, lin, blocks, s);
    case 2: return launch<T, 2, METHOD>(dims, cols, obs, vals, out, n, lin, blocks, s);
    case 3: return launch<T, 3, METHOD>(dims, cols, obs, vals, out, n, lin, blocks, s);
    case 4: return launch<T, 4, METHOD>(dims, cols, obs, vals, out, n, lin, blocks, s);
    case 5: return launch<T, 5, METHOD>(dims, cols, obs, vals, out, n, lin, blocks, s);
    case 6: return launch<T, 6, METHOD>(dims, cols, obs, vals, out, n, lin, blocks, s);
    case 7: return launch<T, 7, METHOD>(dims, cols, obs, vals, out, n, lin, blocks, s);
    case 8: return launch<T, 8, METHOD>(dims, cols, obs, vals, out, n, lin, blocks, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_method(int method, int ndims, const int* dims, const void* const* cols,
                          const void* const* obs, const void* vals, void* out, int64_t n,
                          bool lin, int blocks, cudaStream_t s) {
  switch (method) {
    case kLinear:
      return launch_ndims<T, kLinear>(ndims, dims, cols, obs, vals, out, n, lin, blocks, s);
    case kCubic:
      return launch_ndims<T, kCubic>(ndims, dims, cols, obs, vals, out, n, lin, blocks, s);
    case kNearest:
      return launch_ndims<T, kNearest>(ndims, dims, cols, obs, vals, out, n, lin, blocks, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Launches the kernel on `stream` without synchronising and returns
// cudaGetLastError() (0 on success). `method` is 0 linear, 1 cubic,
// 2 nearest; `linearize` selects linearized cubic extrapolation. `dims`,
// `grids` and `obs` are host arrays of `ndims` entries; `grids` (one sorted
// column per axis), `obs`, `vals` and `out` hold device pointers of the type
// selected by `is_f64`. The caller guarantees 1 <= ndims <= 8, every dim >= 2
// (>= 4 for cubic), prod(dims) < 2^31 and 0 < n < 2^31.
extern "C" int interpn_rectilinear(int method, int linearize, int is_f64, int ndims,
                                   const int* dims, const void* const* grids,
                                   const void* vals, const void* const* obs, void* out,
                                   long long n, int blocks, void* stream) {
  if (ndims < 1 || ndims > kMaxDims || n <= 0 || blocks <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  const bool lin = linearize != 0;
  const cudaError_t err =
      is_f64 ? launch_method<double>(method, ndims, dims, grids, obs, vals, out, n, lin,
                                     blocks, s)
             : launch_method<float>(method, ndims, dims, grids, obs, vals, out, n, lin,
                                    blocks, s);
  return static_cast<int>(err);
}
