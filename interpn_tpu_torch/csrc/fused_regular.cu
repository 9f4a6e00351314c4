// Regular-grid evaluation for Hopper (sm_90a): multilinear, multicubic and
// nearest, f32 and f64, 1-8D.
//
// Replaces the TPU kernel `interpn_tpu/ops/pallas_v3.py::_pallas_v3`, whose
// body is `_build_kernel(..., rect=False)` with the per-axis weights of
// `_linear_axis_weights`, `_cubic_axis_weights` and `_nearest_axis_weights`,
// and serves float64 natively (on the TPU, pallas_df64/pallas_i8 serve f64).
//
// What it computes, per query:
// - linear: the 2^N cell corners reduced by the reference's lerp tree
//   (`ops/linear.py`), cell and t located as `locate_regular_linear` does;
// - cubic: the 4^N stencil reduced by the Hermite tree of `ops/cubic.py`,
//   with the 5-region saturation of `locate_regular_cubic`, optional
//   linearized extrapolation, and exact values at grid nodes;
// - nearest: one table read, the lower index winning the tie
//   (`ops/nearest.py`).
// Every rounding step is the plain PyTorch version's, so the two agree bit
// for bit (see interp_common.cuh).
//
// Design: the TPU kernel contracts per-query weight matrices against the
// whole table on the MXU, because Mosaic has no per-lane gather. A Hopper
// thread gathers, so this kernel reads only the stencil: one thread per
// query (grid-stride loop), table reads through the read-only cache.
//
// What bounds it on this card: each query streams sizeof(T)*(ndims+1) bytes
// in and out of device memory. Linear and nearest add 2^N or 1 table reads
// that hit L1/L2 (a 20^3 f32 table is 32 KB; 100^3 is 4 MB, within the 50 MB
// L2) and are bound by the query stream and the scattered reads. Cubic does
// about 20 floating-point operations per tree node, (4^N - 1)/3 nodes per
// query, and is bound by arithmetic from 3D up (f64 most of all).

#include "interp_common.cuh"

namespace {

using namespace interp;

struct GridArgs {
  int dim[kMaxDims];     // points per axis
  int stride[kMaxDims];  // C-order strides in elements
};

template <typename T, int NDIMS, int METHOD>
__global__ void __launch_bounds__(kThreads)
    regular_kernel(GridArgs grid, ObsPtrs<T> obs, const T* __restrict__ starts,
                   const T* __restrict__ steps, const T* __restrict__ vals,
                   T* __restrict__ out, int64_t n, bool lin) {
  T start[NDIMS], step[NDIMS], dimmax[NDIMS], high_at[NDIMS];
  int stride[NDIMS];
#pragma unroll
  for (int k = 0; k < NDIMS; ++k) {
    start[k] = __ldg(starts + k);
    step[k] = __ldg(steps + k);
    const int footprint = METHOD == kCubic ? 4 : 2;
    const int last = grid.dim[k] - footprint;  // the last lower-corner index
    dimmax[k] = static_cast<T>(last > 0 ? last : 0);
    high_at[k] = static_cast<T>(grid.dim[k] - 3);
    stride[k] = grid.stride[k];
  }
  const int64_t nthreads = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += nthreads) {
    int base = 0;
    if constexpr (METHOD == kCubic) {
      RegularCubicAxis<T> ax[NDIMS];
#pragma unroll
      for (int k = 0; k < NDIMS; ++k) {
        const T x = __ldg(obs.p[k] + i);
        const T iloc = sub_rn(floor_(div_rn(sub_rn(x, start[k]), step[k])), T(1));
        // the masks see the raw iloc (all false for NaN); the index sees
        // NaN as 0, and +-inf clamped to the edge cells
        const int loc = static_cast<int>(clamp_(isnan(iloc) ? T(0) : iloc, dimmax[k]));
        base += loc * stride[k];
        const bool low = iloc <= T(-1);
        const bool high = !low && iloc >= high_at[k];
        const T t = div_rn(
            sub_rn(x, add_rn(start[k], mul_rn(step[k], static_cast<T>(loc + 1)))), step[k]);
        ax[k].tt = low ? -t : (high ? sub_rn(t, T(1)) : t);
        ax[k].low = low;
        ax[k].high = high;
        ax[k].outside = iloc < T(-1) || (!low && iloc > high_at[k]);
      }
      out[i] = CubicTree<T, RegularCubicAxis<T>, NDIMS>::eval(vals, base, stride, ax, lin);
    } else {
      T t[NDIMS];
#pragma unroll
      for (int k = 0; k < NDIMS; ++k) {
        const T x = __ldg(obs.p[k] + i);
        T floc = floor_(div_rn(sub_rn(x, start[k]), step[k]));
        // NaN reads cell 0 (and gives t = NaN); +-inf clamp to the edge cells.
        floc = isnan(floc) ? T(0) : floc;
        const int loc = static_cast<int>(clamp_(floc, dimmax[k]));
        t[k] = div_rn(sub_rn(x, add_rn(start[k], mul_rn(step[k], static_cast<T>(loc)))),
                      step[k]);
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
cudaError_t launch(const GridArgs& grid, const void* const* obs, const void* starts,
                   const void* steps, const void* vals, void* out, int64_t n, bool lin,
                   int blocks, cudaStream_t stream) {
  ObsPtrs<T> ptrs{};
  for (int k = 0; k < NDIMS; ++k) ptrs.p[k] = static_cast<const T*>(obs[k]);
  regular_kernel<T, NDIMS, METHOD><<<blocks, kThreads, 0, stream>>>(
      grid, ptrs, static_cast<const T*>(starts), static_cast<const T*>(steps),
      static_cast<const T*>(vals), static_cast<T*>(out), n, lin);
  return cudaGetLastError();
}

template <typename T, int METHOD>
cudaError_t launch_ndims(int ndims, const GridArgs& grid, const void* const* obs,
                         const void* starts, const void* steps, const void* vals,
                         void* out, int64_t n, bool lin, int blocks, cudaStream_t s) {
  switch (ndims) {
    case 1: return launch<T, 1, METHOD>(grid, obs, starts, steps, vals, out, n, lin, blocks, s);
    case 2: return launch<T, 2, METHOD>(grid, obs, starts, steps, vals, out, n, lin, blocks, s);
    case 3: return launch<T, 3, METHOD>(grid, obs, starts, steps, vals, out, n, lin, blocks, s);
    case 4: return launch<T, 4, METHOD>(grid, obs, starts, steps, vals, out, n, lin, blocks, s);
    case 5: return launch<T, 5, METHOD>(grid, obs, starts, steps, vals, out, n, lin, blocks, s);
    case 6: return launch<T, 6, METHOD>(grid, obs, starts, steps, vals, out, n, lin, blocks, s);
    case 7: return launch<T, 7, METHOD>(grid, obs, starts, steps, vals, out, n, lin, blocks, s);
    case 8: return launch<T, 8, METHOD>(grid, obs, starts, steps, vals, out, n, lin, blocks, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_method(int method, int ndims, const GridArgs& grid, const void* const* obs,
                          const void* starts, const void* steps, const void* vals, void* out,
                          int64_t n, bool lin, int blocks, cudaStream_t s) {
  switch (method) {
    case kLinear:
      return launch_ndims<T, kLinear>(ndims, grid, obs, starts, steps, vals, out, n, lin,
                                      blocks, s);
    case kCubic:
      return launch_ndims<T, kCubic>(ndims, grid, obs, starts, steps, vals, out, n, lin,
                                     blocks, s);
    case kNearest:
      return launch_ndims<T, kNearest>(ndims, grid, obs, starts, steps, vals, out, n, lin,
                                       blocks, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Launches the kernel on `stream` without synchronising and returns
// cudaGetLastError() (0 on success). `method` is 0 linear, 1 cubic,
// 2 nearest; `linearize` selects linearized cubic extrapolation. `dims` and
// `obs` are host arrays of `ndims` entries; `obs`, `starts`, `steps`, `vals`
// and `out` hold device pointers of the type selected by `is_f64`. The
// caller guarantees 1 <= ndims <= 8, every dim >= 2 (>= 4 for cubic),
// prod(dims) < 2^31 and 0 < n < 2^31.
extern "C" int interpn_regular(int method, int linearize, int is_f64, int ndims,
                               const int* dims, const void* starts, const void* steps,
                               const void* vals, const void* const* obs, void* out,
                               long long n, int blocks, void* stream) {
  if (ndims < 1 || ndims > kMaxDims || n <= 0 || blocks <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  GridArgs grid{};
  int acc = 1;
  for (int k = ndims - 1; k >= 0; --k) {
    grid.stride[k] = acc;
    grid.dim[k] = dims[k];
    acc *= dims[k];
  }
  auto s = static_cast<cudaStream_t>(stream);
  const bool lin = linearize != 0;
  const cudaError_t err =
      is_f64 ? launch_method<double>(method, ndims, grid, obs, starts, steps, vals, out, n,
                                     lin, blocks, s)
             : launch_method<float>(method, ndims, grid, obs, starts, steps, vals, out, n,
                                    lin, blocks, s);
  return static_cast<int>(err);
}
