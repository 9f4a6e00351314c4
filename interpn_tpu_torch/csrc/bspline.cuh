// The tensor-product B-spline kernel, shared by `fused_bspline.cu` (one
// coefficient table, K4) and `fused_bspline_stack.cu` (a stack of nch
// tables that share one knot set, K7): degree 3 (`cubic_spline`) and 5
// (`quintic`), f32 and f64, 1-8D.
//
// What it computes, per query: per axis the de Boor span, the count of
// knots <= x minus one (NaN counting 0) clamped to [k, dim-1], by bisection
// of the axis's knot column; the k+1 nonzero basis values by the Cox-de Boor
// recurrence of `ops/bspline.py::_basis_weights`, term for term (den,
// N[r]/den, saved, in that association); then the (k+1)^N tree over the
// coefficients, the last axis reduced first (`_bspline_impl`). Every
// rounding step is the plain PyTorch version's, so the two agree bit for bit
// (see interp_common.cuh). Out-of-bounds queries extrapolate the end span's
// polynomial.
//
// Design: the TPU builds one-hot knot selects because Mosaic has no
// per-lane gather; here one thread per query bisects its knot columns (a few
// hundred bytes, read through the read-only cache) and reads only its
// stencil. The weights stay in registers; the stack instantiation (kStack)
// loops over its channels after the one weight build and writes row c of
// the (nch, n) output, and the single-table instantiation has no loop (see
// regular.cuh for why).
//
// What bounds it on this card: the Cox-de Boor build is 7k(k+1)/2
// operations per axis, k(k+1)/2 of them divisions, and the tree 2(k+1)^N
// operations per table (128 for cubic 3D, 432 for quintic 3D); the (k+1)^N
// stencil reads hit L1/L2 for the bench grids. Arithmetic and the scattered
// reads bound it, not the query stream.

#pragma once

#include "interp_common.cuh"

namespace interp {

template <typename T>
struct KnotArgs {
  const T* col[kMaxDims];  // knot vector of each axis, dim + K + 1 entries
  int dim[kMaxDims];       // coefficients along the axis
  int stride[kMaxDims];    // C-order strides of the coefficient table
};

// The K+1 nonzero basis values at x into N, and the stencil's first
// coefficient index along the axis (`spline_locs_weights`).
template <typename T, int K>
__device__ __forceinline__ int basis_weights(const T* __restrict__ t, int dim, T x, T* N) {
  int span = count_below<true>(t, dim + K + 1, x) - 1;
  span = span < K ? K : (span > dim - 1 ? dim - 1 : span);
  T tk[2 * K];  // t[span - K + 1 .. span + K]
#pragma unroll
  for (int o = 0; o < 2 * K; ++o) tk[o] = __ldg(t + span - K + 1 + o);
  N[0] = T(1);
#pragma unroll
  for (int j = 1; j <= K; ++j) N[j] = T(0);
#pragma unroll
  for (int j = 1; j <= K; ++j) {
    T saved = T(0);
#pragma unroll
    for (int r = 0; r < j; ++r) {
      const T right = tk[r + K];     // t[span + r + 1]
      const T left = tk[r + K - j];  // t[span + r + 1 - j]
      const T temp = div_rn(N[r], sub_rn(right, left));
      N[r] = add_rn(saved, mul_rn(sub_rn(right, x), temp));
      saved = mul_rn(sub_rn(x, left), temp);
    }
    N[j] = saved;
  }
  return span - K;
}

template <typename T, int NDIMS, int K, bool kStack>
__global__ void __launch_bounds__(kThreads)
    bspline_kernel(KnotArgs<T> knots, ObsPtrs<T> obs, const T* __restrict__ coeffs,
                   int64_t table, int nch, T* __restrict__ out, int64_t n) {
  constexpr int W = K + 1;
  const int64_t nthreads = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += nthreads) {
    T w[NDIMS * W];  // axis a's weights at w[a * W ..]
    int stride[NDIMS];
    int base = 0;
#pragma unroll
    for (int a = 0; a < NDIMS; ++a) {
      stride[a] = knots.stride[a];
      base += basis_weights<T, K>(knots.col[a], knots.dim[a], __ldg(obs.p[a] + i), w + a * W) *
              stride[a];
    }
    if constexpr (kStack) {
      for (int c = 0; c < nch; ++c) {
        out[c * n + i] = SplineTree<T, W, NDIMS, 0>::eval(coeffs + c * table, base, stride, w);
      }
    } else {
      out[i] = SplineTree<T, W, NDIMS, 0>::eval(coeffs, base, stride, w);
    }
  }
}

// What every launch of one call shares.
struct SplineLaunch {
  const int* dims;
  const void* const* knots;
  const void* const* obs;
  const void* coeffs;
  int nch;
  void* out;
  int64_t n;
  int blocks;
  cudaStream_t stream;
};

template <typename T, int NDIMS, int K, bool kStack>
cudaError_t spline_launch(const SplineLaunch& a) {
  KnotArgs<T> knots{};
  ObsPtrs<T> ptrs{};
  int acc = 1;
  for (int k = NDIMS - 1; k >= 0; --k) {
    knots.col[k] = static_cast<const T*>(a.knots[k]);
    knots.dim[k] = a.dims[k];
    knots.stride[k] = acc;
    acc *= a.dims[k];
    ptrs.p[k] = static_cast<const T*>(a.obs[k]);
  }
  bspline_kernel<T, NDIMS, K, kStack><<<a.blocks, kThreads, 0, a.stream>>>(
      knots, ptrs, static_cast<const T*>(a.coeffs), acc, a.nch, static_cast<T*>(a.out), a.n);
  return cudaGetLastError();
}

template <typename T, int K, bool kStack>
cudaError_t spline_ndims(int ndims, const SplineLaunch& a) {
  switch (ndims) {
    case 1: return spline_launch<T, 1, K, kStack>(a);
    case 2: return spline_launch<T, 2, K, kStack>(a);
    case 3: return spline_launch<T, 3, K, kStack>(a);
    case 4: return spline_launch<T, 4, K, kStack>(a);
    case 5: return spline_launch<T, 5, K, kStack>(a);
    case 6: return spline_launch<T, 6, K, kStack>(a);
    case 7: return spline_launch<T, 7, K, kStack>(a);
    case 8: return spline_launch<T, 8, K, kStack>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, bool kStack>
cudaError_t spline_degree(int degree, int ndims, const SplineLaunch& a) {
  switch (degree) {
    case 3: return spline_ndims<T, 3, kStack>(ndims, a);
    case 5: return spline_ndims<T, 5, kStack>(ndims, a);
    default: return cudaErrorInvalidValue;
  }
}

// The body of the sources' C entry points (see fused_bspline.cu).
template <bool kStack>
int bspline_entry(int degree, int is_f64, int ndims, const int* dims, const void* const* knots,
                  const void* coeffs, const void* const* obs, void* out, long long n, int nch,
                  int blocks, void* stream) {
  if (ndims < 1 || ndims > kMaxDims || n <= 0 || nch <= 0 || blocks <= 0 ||
      (!kStack && nch != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const SplineLaunch a{dims, knots, obs, coeffs, nch, out, n, blocks,
                       static_cast<cudaStream_t>(stream)};
  const cudaError_t err = is_f64 ? spline_degree<double, kStack>(degree, ndims, a)
                                 : spline_degree<float, kStack>(degree, ndims, a);
  return static_cast<int>(err);
}

}  // namespace interp
