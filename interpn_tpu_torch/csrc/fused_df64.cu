// K8 for Hopper (sm_90a): the double-float f64 evaluation, 2-8D: linear
// (footprint 2) and cubic (4) on regular and rectilinear grids, and the
// B-splines of degree 3 (4) and 5 (6).
//
// Replaces `interpn_tpu/ops/pallas_df64.py::_pallas_df64` (the
// `pl.pallas_call` at :479, kernels `_make_kernel` and `_make_kernel_looped`)
// and the weight build the TPU runs before it in one XLA program
// (`_axis_weights_f64`, `_weights_jit`). Inputs: the queries and the grid
// (starts and steps, the axes, or the knots) and the table's packed hi/lo
// taps (`ops/df64.py::table_taps`, cached per table). Output: the float64
// result, hi + lo as `_finish` adds them.
//
// What it computes, per query, as `ops/df64.py`'s plain chain does:
// 1. per axis the locate and the float64 weights, split into float32 hi/lo
//    pairs (engine_weights.cuh: `weights_f64`, `spline_weights_f64`);
// 2. the contraction in `plain_df64`'s order (the TPU flat kernel's
//    `_contract_slab`): for each stencil row of the leading axes, in C
//    order, `df_madd` over the last axis's FP stencil entries, then the
//    exact `two_sum`; then each middle axis, innermost first, `df_madd` over
//    its FP partials and `two_sum`;
// 3. hi + lo in float64.
// The TPU multiplies dense weight matrices (zero off the stencil) against
// the whole table because Mosaic has no per-lane gather; on a finite table
// every off-stencil term is an exact identity, so reading only the stencil
// gives the same numbers.
//
// Design: one thread per query; no weight passes through device memory.
// The table is read as packed taps: cell (row, j) holds the hi parts of
// entries j .. j + FP - 1 along the last axis, then their lo parts, so a
// stencil row is one 16-byte (linear), two (cubic) or three (quintic)
// vector loads in place of 2 FP scattered 4-byte loads. The tree runs depth
// first (one partial pair per level live), the last two axes unrolled,
// outer axes in loops that pick their weights from registers by selects.
// Four lanes a query from 4D (lane j building axes j, j + 4 and running
// axis 0's child j, lane 0 reducing the four in the plain version's order)
// ran cubic 12^5 6% slower than one (PERF.md). TwoProd keeps Dekker's
// steps: one FMA would give their bits only behind a guard, which cost
// more than it saved (df64.cuh). The table is not staged in shared memory:
// a route that copied the split (hi and lo, 64 KB at 20^3) into each
// block ran cubic 20^3 no faster (0.1400 against 0.1407 ms) and linear
// 20^3 36% slower (0.0483 against 0.0354), its 112 KiB reservation
// cutting linear's 5 blocks an SM to 2 (PERF.md).

#include <cstdint>

#include "df64.cuh"
#include "engine_weights.cuh"
#include "interp_common.cuh"

namespace interp {

struct DfArgs {
  EngineGrid grid;
  EngineObs obs;
  const float* __restrict__ taps;  // packed cells of 2 FP floats
  int pstride[kMaxDims];           // cell strides of the packed layout
  int64_t n;
  bool lin;
};

// One query's weight pairs, axis-major.
template <int NDIMS, int FP>
struct DfWeights {
  float h[NDIMS * FP], l[NDIMS * FP];
};

// The 2 FP floats of the packed cell at `cell`.
template <int FP>
__device__ __forceinline__ void load_taps(const float* __restrict__ taps, int cell, float* v) {
  const float4* p = reinterpret_cast<const float4*>(taps + static_cast<int64_t>(cell) * 2 * FP);
#pragma unroll
  for (int q = 0; q < FP / 2; ++q) {
    const float4 x = __ldg(p + q);
    v[4 * q] = x.x;
    v[4 * q + 1] = x.y;
    v[4 * q + 2] = x.z;
    v[4 * q + 3] = x.w;
  }
}

// Contraction of the sub-stencil with axes 0..A-1 fixed at packed cell
// `base`.
template <int NDIMS, int FP, int A>
struct DfTree {
  static __device__ __forceinline__ void eval(const DfArgs& a, const DfWeights<NDIMS, FP>& w,
                                              int base, float& h, float& l) {
    float th = 0.0f, tl = 0.0f;
    if constexpr (A == NDIMS - 1) {
      float v[2 * FP];
      load_taps<FP>(a.taps, base, v);
#pragma unroll
      for (int j = 0; j < FP; ++j) {
        df_madd(th, tl, v[j], v[FP + j], w.h[A * FP + j], w.l[A * FP + j]);
      }
    } else if constexpr (A == NDIMS - 2) {
      const int s = a.pstride[A];
#pragma unroll
      for (int b = 0; b < FP; ++b) {
        float gh, gl;
        DfTree<NDIMS, FP, A + 1>::eval(a, w, base + b * s, gh, gl);
        df_madd(th, tl, gh, gl, w.h[A * FP + b], w.l[A * FP + b]);
      }
    } else {
      const int s = a.pstride[A];
#pragma unroll 1
      for (int b = 0; b < FP; ++b) {
        float gh, gl;
        DfTree<NDIMS, FP, A + 1>::eval(a, w, base + b * s, gh, gl);
        df_madd(th, tl, gh, gl, pick<float, FP>(w.h + A * FP, b), pick<float, FP>(w.l + A * FP, b));
      }
    }
    two_sum(th, tl, h, l);
  }
};

template <int NDIMS, int FP>
__global__ void __launch_bounds__(kThreads) df64_kernel(DfArgs a, double* __restrict__ out) {
  const int64_t nthreads = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < a.n;
       i += nthreads) {
    DfWeights<NDIMS, FP> w;
    int loc[NDIMS];
    query_weights<NDIMS, FP>(a.grid, a.obs, i, a.lin, loc, w.h, w.l);
    int base = 0;
#pragma unroll
    for (int k = 0; k < NDIMS; ++k) base += loc[k] * a.pstride[k];
    float h, l;
    DfTree<NDIMS, FP, 0>::eval(a, w, base, h, l);
    out[i] = __dadd_rn(static_cast<double>(h), static_cast<double>(l));
  }
}

// The launch, or the instantiation's attributes and occupancy, of one
// (ndims, footprint).
struct DfOp {
  const DfArgs* args;
  double* out;
  int blocks;
  cudaStream_t stream;
  int* info;  // non-null: registers, static shared bytes, local bytes, blocks an SM

  template <int NDIMS, int FP>
  cudaError_t run() {
    const auto kernel = df64_kernel<NDIMS, FP>;
    if (info != nullptr) {
      cudaFuncAttributes attr{};
      cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
      if (err != cudaSuccess) return err;
      info[0] = attr.numRegs;
      info[1] = static_cast<int>(attr.sharedSizeBytes);
      info[2] = static_cast<int>(attr.localSizeBytes);
      return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[3], kernel, kThreads, 0);
    }
    kernel<<<blocks, kThreads, 0, stream>>>(*args, out);
    return cudaGetLastError();
  }
};

template <int FP>
cudaError_t df64_ndims(int ndims, DfOp& op) {
  switch (ndims) {
    case 2: return op.run<2, FP>();
    case 3: return op.run<3, FP>();
    case 4: return op.run<4, FP>();
    case 5: return op.run<5, FP>();
    case 6: return op.run<6, FP>();
    case 7: return op.run<7, FP>();
    case 8: return op.run<8, FP>();
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t df64_footprint(int footprint, int ndims, DfOp& op) {
  switch (footprint) {
    case 2: return df64_ndims<2>(ndims, op);
    case 4: return df64_ndims<4>(ndims, op);
    case 6: return df64_ndims<6>(ndims, op);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace interp

// Launches K8 on `stream` without synchronising and returns
// cudaGetLastError() (0 on success). `kind` is 0 regular (`starts`, `steps`:
// device arrays of ndims doubles), 1 rectilinear or 2 B-spline (`cols`: a
// host array of ndims device pointers to the sorted axes or the knot
// vectors); `footprint` 2 linear, 4 cubic or cubic_spline, 6 quintic;
// `linearize` the cubic extrapolation mode. `dims` (points, or
// coefficients, per axis) and `obs` are host arrays of ndims entries, `obs`
// of device pointers to the float64 queries; `taps` the packed hi/lo cells
// ((prod(dims[:-1]) * (dims[-1] - footprint + 1), 2 * footprint) floats);
// `out` n doubles. The caller guarantees 2 <= ndims <= 8, every dim >=
// footprint, prod(dims) < 2^31 and 0 < n < 2^31.
extern "C" int interpn_df64(int kind, int footprint, int linearize, int ndims, const int* dims,
                            const void* starts, const void* steps, const void* const* cols,
                            const void* taps, const void* const* obs, void* out, long long n,
                            int blocks, void* stream) {
  using namespace interp;
  if (ndims < 2 || ndims > kMaxDims || n <= 0 || blocks <= 0 || kind < kGridRegular ||
      kind > kGridSpline) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  DfArgs a{};
  a.grid.kind = kind;
  a.grid.start = static_cast<const double*>(starts);
  a.grid.step = static_cast<const double*>(steps);
  for (int k = 0; k < ndims; ++k) {
    a.grid.col[k] = kind == kGridRegular ? nullptr : static_cast<const double*>(cols[k]);
    a.grid.dim[k] = dims[k];
    a.obs.p[k] = static_cast<const double*>(obs[k]);
  }
  a.taps = static_cast<const float*>(taps);
  a.n = n;
  a.lin = linearize != 0;
  int acc = 1;
  a.pstride[ndims - 1] = 1;
  for (int k = ndims - 2; k >= 0; --k) {
    acc *= k == ndims - 2 ? dims[ndims - 1] - footprint + 1 : dims[k + 1];
    a.pstride[k] = acc;
  }
  DfOp op{&a, static_cast<double*>(out), blocks, static_cast<cudaStream_t>(stream), nullptr};
  return static_cast<int>(df64_footprint(footprint, ndims, op));
}

// info[0..3] of K8's instantiation for (footprint, ndims): registers a
// thread, static shared bytes, local (spill) bytes a thread, resident
// blocks an SM.
extern "C" int interpn_df64_info(int footprint, int ndims, int* info) {
  using namespace interp;
  DfOp op{nullptr, nullptr, 0, nullptr, info};
  return static_cast<int>(df64_footprint(footprint, ndims, op));
}
