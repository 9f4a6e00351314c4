// The regular-grid kernel, shared by `fused_regular.cu` (one table, K1) and
// `fused_regular_stack.cu` (a stack of nch tables, K5): multilinear,
// multicubic and nearest, f32 and f64, 1-8D.
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
// query (grid-stride loop), table reads through the read-only cache. The
// stack instantiation (kStack) locates each query once and then loops over
// the channels, channel c reading its stencil at the same offsets in table c
// and writing row c of the (nch, n) output. The single-table instantiation
// has no loop: a runtime channel loop there cost K1 linear 45% and
// rectilinear cubic f64 80% on an H100 (more registers, fewer blocks per SM).
//
// What bounds it on this card: each query streams sizeof(T)*(ndims+nch)
// bytes in and out of device memory. Linear and nearest add 2^N or 1 table
// reads per table that hit L1/L2 (a 20^3 f32 table is 32 KB; 100^3 is 4 MB,
// within the 50 MB L2) and are bound by the query stream and the scattered
// reads. Cubic does about 20 floating-point operations per tree node,
// (4^N - 1)/3 nodes per query and table, and is bound by arithmetic from 3D
// up (f64 most of all).

#pragma once

#include "interp_common.cuh"

namespace interp {

struct GridArgs {
  int dim[kMaxDims];     // points per axis
  int stride[kMaxDims];  // C-order strides in elements
};

template <typename T, int NDIMS, int METHOD, bool kStack>
__global__ void __launch_bounds__(kThreads)
    regular_kernel(GridArgs grid, ObsPtrs<T> obs, const T* __restrict__ starts,
                   const T* __restrict__ steps, const T* __restrict__ vals, int64_t table,
                   int nch, T* __restrict__ out, int64_t n, bool lin) {
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
      if constexpr (kStack) {
        for (int c = 0; c < nch; ++c) {
          out[c * n + i] = CubicTree<T, RegularCubicAxis<T>, NDIMS>::eval(
              vals + c * table, base, stride, ax, lin);
        }
      } else {
        out[i] = CubicTree<T, RegularCubicAxis<T>, NDIMS>::eval(vals, base, stride, ax, lin);
      }
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
      if constexpr (kStack) {
        for (int c = 0; c < nch; ++c) {
          if constexpr (METHOD == kNearest) {
            out[c * n + i] = __ldg(vals + c * table + base);
          } else {
            out[c * n + i] = LerpTree<T, NDIMS>::eval(vals + c * table, base, stride, t);
          }
        }
      } else if constexpr (METHOD == kNearest) {
        out[i] = __ldg(vals + base);
      } else {
        out[i] = LerpTree<T, NDIMS>::eval(vals, base, stride, t);
      }
    }
  }
}

// What every launch of one call shares.
struct RegularLaunch {
  GridArgs grid;
  const void* const* obs;
  const void* starts;
  const void* steps;
  const void* vals;
  int64_t table;  // entries per table: the channel stride of vals
  int nch;
  void* out;
  int64_t n;
  bool lin;
  int blocks;
  cudaStream_t stream;
};

template <typename T, int NDIMS, int METHOD, bool kStack>
cudaError_t regular_launch(const RegularLaunch& a) {
  ObsPtrs<T> ptrs{};
  for (int k = 0; k < NDIMS; ++k) ptrs.p[k] = static_cast<const T*>(a.obs[k]);
  regular_kernel<T, NDIMS, METHOD, kStack><<<a.blocks, kThreads, 0, a.stream>>>(
      a.grid, ptrs, static_cast<const T*>(a.starts), static_cast<const T*>(a.steps),
      static_cast<const T*>(a.vals), a.table, a.nch, static_cast<T*>(a.out), a.n, a.lin);
  return cudaGetLastError();
}

template <typename T, int METHOD, bool kStack>
cudaError_t regular_ndims(int ndims, const RegularLaunch& a) {
  switch (ndims) {
    case 1: return regular_launch<T, 1, METHOD, kStack>(a);
    case 2: return regular_launch<T, 2, METHOD, kStack>(a);
    case 3: return regular_launch<T, 3, METHOD, kStack>(a);
    case 4: return regular_launch<T, 4, METHOD, kStack>(a);
    case 5: return regular_launch<T, 5, METHOD, kStack>(a);
    case 6: return regular_launch<T, 6, METHOD, kStack>(a);
    case 7: return regular_launch<T, 7, METHOD, kStack>(a);
    case 8: return regular_launch<T, 8, METHOD, kStack>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, bool kStack>
cudaError_t regular_method(int method, int ndims, const RegularLaunch& a) {
  switch (method) {
    case kLinear: return regular_ndims<T, kLinear, kStack>(ndims, a);
    case kCubic: return regular_ndims<T, kCubic, kStack>(ndims, a);
    case kNearest: return regular_ndims<T, kNearest, kStack>(ndims, a);
    default: return cudaErrorInvalidValue;
  }
}

// The body of the sources' C entry points (see fused_regular.cu).
template <bool kStack>
int regular_entry(int method, int linearize, int is_f64, int ndims, const int* dims,
                  const void* starts, const void* steps, const void* vals,
                  const void* const* obs, void* out, long long n, int nch, int blocks,
                  void* stream) {
  if (ndims < 1 || ndims > kMaxDims || n <= 0 || nch <= 0 || blocks <= 0 ||
      (!kStack && nch != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  RegularLaunch a{};
  int acc = 1;
  for (int k = ndims - 1; k >= 0; --k) {
    a.grid.stride[k] = acc;
    a.grid.dim[k] = dims[k];
    acc *= dims[k];
  }
  a.obs = obs;
  a.starts = starts;
  a.steps = steps;
  a.vals = vals;
  a.table = acc;
  a.nch = nch;
  a.out = out;
  a.n = n;
  a.lin = linearize != 0;
  a.blocks = blocks;
  a.stream = static_cast<cudaStream_t>(stream);
  const cudaError_t err = is_f64 ? regular_method<double, kStack>(method, ndims, a)
                                 : regular_method<float, kStack>(method, ndims, a);
  return static_cast<int>(err);
}

}  // namespace interp
