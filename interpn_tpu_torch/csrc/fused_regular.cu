// Regular-grid multilinear evaluation for Hopper (sm_90a).
//
// Replaces the TPU kernel `interpn_tpu/ops/pallas_v3.py::_pallas_v3`, whose
// body is `_build_kernel(..., rect=False)`, for method="linear", and serves
// float64 natively (on the TPU, pallas_df64/pallas_i8 serve f64).
//
// What it computes: out(q) = sum over the 2^N cell corners of
// prod_k w_k(q) * vals[corner], with the cell and the weights located exactly
// as `ops/locate.py::locate_regular_linear` does, and the corners reduced by
// the reference's lerp tree (`ops/linear.py::_lerp_reduce`, dim 0 first).
// Every rounding step is the same as the plain PyTorch version's, so the two
// agree bit for bit.
//
// Design: the TPU kernel contracts per-query weight matrices against the
// whole table on the MXU, because Mosaic has no per-lane gather. A Hopper
// thread gathers, so this kernel reads only the stencil: one thread per
// query (grid-stride loop), 2^N table reads through the read-only cache.
//
// What bounds it on this card: each query streams 4*(ndims+1) bytes (f32;
// 8*(ndims+1) for f64) in and out of device memory, plus 2^N table reads
// that hit L1/L2 (a 20^3 f32 table is 32 KB; 100^3 is 4 MB, within the
// 50 MB L2). At small ndims the kernel is bound by device-memory bandwidth
// on the query stream; at large ndims by the cached table reads.
//
// Numerics: nvcc contracts a*b+c into an FMA by default, which moves
// `start + step*loc` and `y0 + t*(y1-y0)` by an ulp; at grid nodes an ulp is
// enough to move floor() to the neighbouring cell. All arithmetic goes
// through the _rn intrinsics, which are never contracted, and the build adds
// --fmad=false. Division stays IEEE (no fast math).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxDims = 8;
constexpr int kThreads = 256;

struct GridArgs {
  int dimmax[kMaxDims];  // max(dim - 2, 0): the last lower-corner index
  int stride[kMaxDims];  // C-order strides in elements
};

template <typename T>
struct ObsPtrs {
  const T* p[kMaxDims];
};

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ float floor_(float a) { return floorf(a); }
__device__ __forceinline__ float clamp_(float a, float hi) { return fminf(fmaxf(a, 0.0f), hi); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ double floor_(double a) { return floor(a); }
__device__ __forceinline__ double clamp_(double a, double hi) { return fmin(fmax(a, 0.0), hi); }

// Value of the D-dimensional sub-cell at `base`: the two (D-1)-dimensional
// halves along dim D-1, lerped with t[D-1]. Depth first, so at most D
// partial sums are live; the pairing is the level-by-level tree's.
template <typename T, int D>
struct LerpTree {
  static __device__ __forceinline__ T eval(const T* __restrict__ vals, int base,
                                           const int* stride, const T* t) {
    const T y0 = LerpTree<T, D - 1>::eval(vals, base, stride, t);
    const T y1 = LerpTree<T, D - 1>::eval(vals, base + stride[D - 1], stride, t);
    return add_rn(y0, mul_rn(t[D - 1], sub_rn(y1, y0)));
  }
};

template <typename T>
struct LerpTree<T, 0> {
  static __device__ __forceinline__ T eval(const T* __restrict__ vals, int base,
                                           const int*, const T*) {
    return __ldg(vals + base);
  }
};

template <typename T, int NDIMS>
__global__ void __launch_bounds__(kThreads)
    linear_regular_kernel(GridArgs grid, ObsPtrs<T> obs, const T* __restrict__ starts,
                          const T* __restrict__ steps, const T* __restrict__ vals,
                          T* __restrict__ out, int64_t n) {
  T start[NDIMS], step[NDIMS], dimmax[NDIMS];
  int stride[NDIMS];
#pragma unroll
  for (int k = 0; k < NDIMS; ++k) {
    start[k] = __ldg(starts + k);
    step[k] = __ldg(steps + k);
    dimmax[k] = static_cast<T>(grid.dimmax[k]);
    stride[k] = grid.stride[k];
  }
  const int64_t nthreads = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += nthreads) {
    int base = 0;
    T t[NDIMS];
#pragma unroll
    for (int k = 0; k < NDIMS; ++k) {
      const T x = __ldg(obs.p[k] + i);
      T floc = floor_(div_rn(sub_rn(x, start[k]), step[k]));
      // NaN reads cell 0 (and gives t = NaN); +-inf clamp to the edge cells.
      floc = isnan(floc) ? T(0) : floc;
      floc = clamp_(floc, dimmax[k]);
      const int loc = static_cast<int>(floc);
      base += loc * stride[k];
      t[k] = div_rn(sub_rn(x, add_rn(start[k], mul_rn(step[k], static_cast<T>(loc)))),
                    step[k]);
    }
    out[i] = LerpTree<T, NDIMS>::eval(vals, base, stride, t);
  }
}

template <typename T, int NDIMS>
cudaError_t launch(const GridArgs& grid, const void* const* obs, const void* starts,
                   const void* steps, const void* vals, void* out, int64_t n, int blocks,
                   cudaStream_t stream) {
  ObsPtrs<T> ptrs{};
  for (int k = 0; k < NDIMS; ++k) ptrs.p[k] = static_cast<const T*>(obs[k]);
  linear_regular_kernel<T, NDIMS><<<blocks, kThreads, 0, stream>>>(
      grid, ptrs, static_cast<const T*>(starts), static_cast<const T*>(steps),
      static_cast<const T*>(vals), static_cast<T*>(out), n);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_ndims(int ndims, const GridArgs& grid, const void* const* obs,
                         const void* starts, const void* steps, const void* vals,
                         void* out, int64_t n, int blocks, cudaStream_t stream) {
  switch (ndims) {
    case 1: return launch<T, 1>(grid, obs, starts, steps, vals, out, n, blocks, stream);
    case 2: return launch<T, 2>(grid, obs, starts, steps, vals, out, n, blocks, stream);
    case 3: return launch<T, 3>(grid, obs, starts, steps, vals, out, n, blocks, stream);
    case 4: return launch<T, 4>(grid, obs, starts, steps, vals, out, n, blocks, stream);
    case 5: return launch<T, 5>(grid, obs, starts, steps, vals, out, n, blocks, stream);
    case 6: return launch<T, 6>(grid, obs, starts, steps, vals, out, n, blocks, stream);
    case 7: return launch<T, 7>(grid, obs, starts, steps, vals, out, n, blocks, stream);
    case 8: return launch<T, 8>(grid, obs, starts, steps, vals, out, n, blocks, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Launches the kernel on `stream` without synchronising and returns
// cudaGetLastError() (0 on success). `dims` and `obs` are host arrays of
// `ndims` entries; `obs`, `starts`, `steps`, `vals` and `out` hold device
// pointers of the type selected by `is_f64`. The caller guarantees
// 1 <= ndims <= 8, every dim >= 2, prod(dims) < 2^31 and 0 < n < 2^31.
extern "C" int interpn_linear_regular(int is_f64, int ndims, const int* dims,
                                      const void* starts, const void* steps,
                                      const void* vals, const void* const* obs, void* out,
                                      long long n, int blocks, void* stream) {
  if (ndims < 1 || ndims > kMaxDims || n <= 0 || blocks <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  GridArgs grid{};
  int acc = 1;
  for (int k = ndims - 1; k >= 0; --k) {
    grid.stride[k] = acc;
    grid.dimmax[k] = dims[k] > 2 ? dims[k] - 2 : 0;
    acc *= dims[k];
  }
  auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_f64 ? launch_ndims<double>(ndims, grid, obs, starts, steps, vals, out, n, blocks, s)
             : launch_ndims<float>(ndims, grid, obs, starts, steps, vals, out, n, blocks, s);
  return static_cast<int>(err);
}
