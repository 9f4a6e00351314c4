// K8 for Hopper (sm_90a): the double-float f64 contraction, 2-8D, stencil
// footprint 2 (linear), 4 (cubic, cubic_spline) or 6 (quintic).
//
// Replaces `interpn_tpu/ops/pallas_df64.py::_pallas_df64` (the
// `pl.pallas_call` at :479, kernels `_make_kernel` and `_make_kernel_looped`).
// Inputs, as there: per-axis int32 stencil starts `locs` (ndims, n) and
// float32 hi/lo weights `wh`/`wl` (ndims * FP, n) made outside the kernel in
// float64 (`ops/df64.py::weights_f64`), and the table split into float32
// hi/lo `vh`/`vl`. Output: the result's hi/lo pair; the caller adds them in
// float64.
//
// What it computes, per query, in `ops/df64.py::plain_df64`'s order (the
// TPU flat kernel's `_contract_slab`): for each stencil row of the leading
// axes, in C order, `df_madd` over the last axis's FP stencil entries, then
// the exact `two_sum`; then each middle axis, innermost first, `df_madd`
// over its FP partials and `two_sum`. The TPU multiplies dense weight
// matrices (zero off the stencil) against the whole table because Mosaic
// has no per-lane gather; on a finite table every off-stencil term is an
// exact identity, so reading only the stencil gives the same numbers.
//
// Design: one thread per query; the tree runs depth first (one partial pair
// per level live), the last two axes unrolled with their weights in
// registers, outer axes in loops that read their weights through the
// read-only cache. The table pair is read where the stencil falls (L1/L2 for
// the bench grids).
//
// What holds it on this card: float32 throughput. A df_madd here is 32 float32
// operations (with the two Veltkamp splits) and a two_sum 6; a query does
// FP^N madds on table entries plus the tree's partial madds, 2,814 operations
// for cubic 3D. TwoProd's error from one FMA would cut a df_madd to 18, and
// then cubic 3D is bound by its bytes, not its operations
// (`chip_smoke.py::engine_operations`).

#include <cstdint>

#include "df64.cuh"
#include "interp_common.cuh"

namespace interp {

struct DfArgs {
  const int* __restrict__ locs;  // (ndims, n)
  const float* __restrict__ wh;  // (ndims * FP, n)
  const float* __restrict__ wl;
  const float* __restrict__ vh;  // flat table, hi
  const float* __restrict__ vl;  // flat table, lo
  int stride[kMaxDims];
  int64_t n;
};

// One query's weights: the two innermost axes in registers (axis NDIMS-2 at
// [0, FP), axis NDIMS-1 at [FP, 2 FP)), outer axes read at use.
template <int NDIMS, int FP>
struct DfQuery {
  float ih[2 * FP], il[2 * FP];
  int64_t i;
};

// Contraction of the sub-stencil with axes 0..A-1 fixed at `base`.
template <int NDIMS, int FP, int A>
struct DfTree {
  static __device__ __forceinline__ void eval(const DfArgs& a, const DfQuery<NDIMS, FP>& q,
                                              int base, float& h, float& l) {
    float th = 0.0f, tl = 0.0f;
    const int s = a.stride[A];
    if constexpr (A == NDIMS - 1) {
#pragma unroll
      for (int j = 0; j < FP; ++j) {
        const int c = base + j * s;
        df_madd(th, tl, __ldg(a.vh + c), __ldg(a.vl + c), q.ih[FP + j], q.il[FP + j]);
      }
    } else if constexpr (A == NDIMS - 2) {
#pragma unroll
      for (int b = 0; b < FP; ++b) {
        float gh, gl;
        DfTree<NDIMS, FP, A + 1>::eval(a, q, base + b * s, gh, gl);
        df_madd(th, tl, gh, gl, q.ih[b], q.il[b]);
      }
    } else {
#pragma unroll 1
      for (int b = 0; b < FP; ++b) {
        float gh, gl;
        DfTree<NDIMS, FP, A + 1>::eval(a, q, base + b * s, gh, gl);
        const int64_t w = static_cast<int64_t>(A * FP + b) * a.n + q.i;
        df_madd(th, tl, gh, gl, __ldg(a.wh + w), __ldg(a.wl + w));
      }
    }
    two_sum(th, tl, h, l);
  }
};

template <int NDIMS, int FP>
__global__ void __launch_bounds__(kThreads)
    df64_kernel(DfArgs a, float* __restrict__ oh, float* __restrict__ ol) {
  const int64_t nthreads = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < a.n;
       i += nthreads) {
    DfQuery<NDIMS, FP> q;
    q.i = i;
    int base = 0;
#pragma unroll
    for (int k = 0; k < NDIMS; ++k) base += __ldg(a.locs + k * a.n + i) * a.stride[k];
#pragma unroll
    for (int j = 0; j < 2 * FP; ++j) {
      const int64_t w = static_cast<int64_t>((NDIMS - 2) * FP + j) * a.n + i;
      q.ih[j] = __ldg(a.wh + w);
      q.il[j] = __ldg(a.wl + w);
    }
    float h, l;
    DfTree<NDIMS, FP, 0>::eval(a, q, base, h, l);
    oh[i] = h;
    ol[i] = l;
  }
}

template <int NDIMS, int FP>
cudaError_t df64_launch(const DfArgs& a, float* oh, float* ol, int blocks, cudaStream_t stream) {
  df64_kernel<NDIMS, FP><<<blocks, kThreads, 0, stream>>>(a, oh, ol);
  return cudaGetLastError();
}

template <int FP>
cudaError_t df64_ndims(int ndims, const DfArgs& a, float* oh, float* ol, int blocks,
                       cudaStream_t stream) {
  switch (ndims) {
    case 2: return df64_launch<2, FP>(a, oh, ol, blocks, stream);
    case 3: return df64_launch<3, FP>(a, oh, ol, blocks, stream);
    case 4: return df64_launch<4, FP>(a, oh, ol, blocks, stream);
    case 5: return df64_launch<5, FP>(a, oh, ol, blocks, stream);
    case 6: return df64_launch<6, FP>(a, oh, ol, blocks, stream);
    case 7: return df64_launch<7, FP>(a, oh, ol, blocks, stream);
    case 8: return df64_launch<8, FP>(a, oh, ol, blocks, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace interp

// Launches K8 on `stream` without synchronising and returns
// cudaGetLastError() (0 on success). `dims` is a host array of `ndims`
// entries; the other pointers are device arrays as described above. The
// caller guarantees 2 <= ndims <= 8, footprint 2, 4 or 6, every dim >=
// footprint, 0 <= locs[k] <= dims[k] - footprint, prod(dims) < 2^31 and
// 0 < n < 2^31.
extern "C" int interpn_df64(int footprint, int ndims, const int* dims, const void* locs,
                            const void* wh, const void* wl, const void* vh, const void* vl,
                            void* oh, void* ol, long long n, int blocks, void* stream) {
  using namespace interp;
  if (ndims < 2 || ndims > kMaxDims || n <= 0 || blocks <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  DfArgs a{};
  a.locs = static_cast<const int*>(locs);
  a.wh = static_cast<const float*>(wh);
  a.wl = static_cast<const float*>(wl);
  a.vh = static_cast<const float*>(vh);
  a.vl = static_cast<const float*>(vl);
  a.n = n;
  int acc = 1;
  for (int k = ndims - 1; k >= 0; --k) {
    a.stride[k] = acc;
    acc *= dims[k];
  }
  float* h = static_cast<float*>(oh);
  float* l = static_cast<float*>(ol);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (footprint) {
    case 2: err = df64_ndims<2>(ndims, a, h, l, blocks, s); break;
    case 4: err = df64_ndims<4>(ndims, a, h, l, blocks, s); break;
    case 6: err = df64_ndims<6>(ndims, a, h, l, blocks, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
