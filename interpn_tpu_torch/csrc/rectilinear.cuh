// The rectilinear-grid kernel, shared by `fused_rectilinear.cu` (one
// table: K2 linear and cubic, K3 nearest) and `fused_rectilinear_stack.cu`
// (a stack of nch tables, K6): multilinear, multicubic and nearest, f32 and
// f64, 1-8D.
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
// Design: the TPU computes weights outside the kernel (K2, K6) or builds
// dense one-hot planes per axis (K3) because Mosaic has no per-lane gather.
// Here one thread per query bisects its columns (a few KB, read through the
// read-only cache) and reads only its stencil, so no weights pass through
// device memory. The grid-dependent parts of the cubic differences are
// computed once per axis, not once per tree node. The stack instantiation
// (kStack) loops over its channels after the one locate, each reading its
// stencil at the same offsets in its own table and writing its row of the
// (nch, n) output; the single-table instantiation has no loop (see
// regular.cuh for why).
//
// What bounds it on this card: the query stream (sizeof(T)*(ndims+nch) bytes
// per query) for linear and nearest, plus about log2(dim) dependent column
// reads per axis for the bisection. Cubic reads its 4^N stencil entries one
// scalar at a time, the reads that bounded K1 cubic on the same tree before
// its cubic routes (regular.cuh), and adds about 30 floating-point
// operations per tree node and table; which of the two sets its pace has
// not been measured.

#pragma once

#include "interp_common.cuh"

namespace interp {

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

template <typename T, int NDIMS, int METHOD, bool kStack>
__global__ void __launch_bounds__(kThreads)
    rectilinear_kernel(RectGrid<T> grid, ObsPtrs<T> obs, const T* __restrict__ vals,
                       int64_t table, int nch, T* __restrict__ out, int64_t n, bool lin) {
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
      if constexpr (kStack) {
        for (int c = 0; c < nch; ++c) {
          out[c * n + i] = CubicTree<T, RectCubicAxis<T>, NDIMS>::eval(
              Ldg<T>{vals + c * table}, base, stride, ax, lin);
        }
      } else {
        out[i] = CubicTree<T, RectCubicAxis<T>, NDIMS>::eval(Ldg<T>{vals}, base, stride, ax, lin);
      }
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
      if constexpr (kStack) {
        for (int c = 0; c < nch; ++c) {
          if constexpr (METHOD == kNearest) {
            out[c * n + i] = __ldg(vals + c * table + base);
          } else {
            out[c * n + i] =
                LerpTree<T, NDIMS>::eval(Ldg<T>{vals + c * table}, base, stride, t).v[0];
          }
        }
      } else if constexpr (METHOD == kNearest) {
        out[i] = __ldg(vals + base);
      } else {
        out[i] = LerpTree<T, NDIMS>::eval(Ldg<T>{vals}, base, stride, t).v[0];
      }
    }
  }
}

// What every launch of one call shares.
struct RectLaunch {
  const int* dims;
  const void* const* cols;
  const void* const* obs;
  const void* vals;
  int nch;
  void* out;
  int64_t n;
  bool lin;
  int blocks;
  cudaStream_t stream;
};

template <typename T, int NDIMS, int METHOD, bool kStack>
cudaError_t rect_launch(const RectLaunch& a) {
  RectGrid<T> grid{};
  ObsPtrs<T> ptrs{};
  int acc = 1;
  for (int k = NDIMS - 1; k >= 0; --k) {
    grid.col[k] = static_cast<const T*>(a.cols[k]);
    grid.dim[k] = a.dims[k];
    grid.stride[k] = acc;
    acc *= a.dims[k];
    ptrs.p[k] = static_cast<const T*>(a.obs[k]);
  }
  rectilinear_kernel<T, NDIMS, METHOD, kStack><<<a.blocks, kThreads, 0, a.stream>>>(
      grid, ptrs, static_cast<const T*>(a.vals), acc, a.nch, static_cast<T*>(a.out), a.n,
      a.lin);
  return cudaGetLastError();
}

template <typename T, int METHOD, bool kStack>
cudaError_t rect_ndims(int ndims, const RectLaunch& a) {
  switch (ndims) {
    case 1: return rect_launch<T, 1, METHOD, kStack>(a);
    case 2: return rect_launch<T, 2, METHOD, kStack>(a);
    case 3: return rect_launch<T, 3, METHOD, kStack>(a);
    case 4: return rect_launch<T, 4, METHOD, kStack>(a);
    case 5: return rect_launch<T, 5, METHOD, kStack>(a);
    case 6: return rect_launch<T, 6, METHOD, kStack>(a);
    case 7: return rect_launch<T, 7, METHOD, kStack>(a);
    case 8: return rect_launch<T, 8, METHOD, kStack>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, bool kStack>
cudaError_t rect_method(int method, int ndims, const RectLaunch& a) {
  switch (method) {
    case kLinear: return rect_ndims<T, kLinear, kStack>(ndims, a);
    case kCubic: return rect_ndims<T, kCubic, kStack>(ndims, a);
    case kNearest: return rect_ndims<T, kNearest, kStack>(ndims, a);
    default: return cudaErrorInvalidValue;
  }
}

// The body of the sources' C entry points (see fused_rectilinear.cu).
template <bool kStack>
int rectilinear_entry(int method, int linearize, int is_f64, int ndims, const int* dims,
                      const void* const* grids, const void* vals, const void* const* obs,
                      void* out, long long n, int nch, int blocks, void* stream) {
  if (ndims < 1 || ndims > kMaxDims || n <= 0 || nch <= 0 || blocks <= 0 ||
      (!kStack && nch != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const RectLaunch a{dims, grids, obs, vals, nch, out, n, linearize != 0, blocks,
                     static_cast<cudaStream_t>(stream)};
  const cudaError_t err = is_f64 ? rect_method<double, kStack>(method, ndims, a)
                                 : rect_method<float, kStack>(method, ndims, a);
  return static_cast<int>(err);
}

}  // namespace interp
