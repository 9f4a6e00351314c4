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
// loops over its tables after the one weight build and writes row c of the
// (nch, n) output, and the single-table instantiation has no loop (see
// regular.cuh for why). A table or stack is read as
// `ops/fused.py::bspline_route` says:
// - one table within kGroupBytes: kStagedGroups with one group of one
//   table, staged in shared memory by each 1024-thread block
//   (`stage_table`), one block an SM; read direct, each query's 64 (cubic)
//   or 216 (quintic 3D) scattered reads went through L1 and L2 (20^3 f32
//   0.0907 and 0.2618 ms on an H100, staged 0.0528 and 0.1293; K1's 112 KiB
//   reservation timed the same, its 46-59 registers a thread leaving one
//   1024-thread block an SM either way, PERF.md); larger tables direct;
// - a stack, kStagedGroups (tables within kGroupBytes): groups of consecutive
//   tables within kGroupBytes (one group where the whole stack fits),
//   staged in shared memory by each 1024-thread block, as regular.cuh
//   stages K5's cubic stacks; a block builds its queries' weights once for
//   its group. Read direct, a
//   stack of 8 20^3 f32 tables made 8 x 64 scattered L2 requests a query
//   (0.6315 ms on an H100); staged, 0.28 ms, of which the weight build (a
//   copy that only built the weights and stored) took 22% and the shared
//   memory's bank conflicts most of the rest (PERF.md).
// - kInterleaved (tables above kGroupBytes, 8 f32 or 4 f64 of them or
//   more): K5's interleave, an entry's channels side by side, read as two
//   16-byte loads, the tree run over the channels together with one
//   running sum a channel a level (3.4x direct for 8 40^3 f32 tables).
// - kDirect: each table's stencil straight from device memory.
//
// What bounds it on this card: the Cox-de Boor build is 7k(k+1)/2
// operations per axis, k(k+1)/2 of them divisions, and the tree 2(k+1)^N
// operations per table (128 for cubic 3D, 432 for quintic 3D); the (k+1)^N
// stencil reads hit L1/L2 (shared memory, staged) for the bench grids.
// Arithmetic and the scattered reads bound it, not the query stream.

#pragma once

#include "interp_common.cuh"
#include "regular.cuh"

namespace interp {

template <typename T>
struct KnotArgs {
  const T* col[kMaxDims];  // knot vector of each axis, dim + K + 1 entries
  int dim[kMaxDims];       // coefficients along the axis
  int stride[kMaxDims];    // C-order strides of the coefficient table
};

// Whether the B-spline family has an instantiation for the route: direct
// and staged groups for one table (its one group) or a stack; interleaved
// for stacks only.
constexpr bool spline_serves(int route, bool stack) {
  return route == kDirect || route == kStagedGroups || (stack && route == kInterleaved);
}

// The spline tree's unrolled levels (SplineTree's UNROLLED): one where a
// leaf is a sector of channels (interleaved), whose running sums take a
// register each; kSplineUnrolled elsewhere.
template <int W, int ROUTE>
__host__ __device__ constexpr int spline_unrolled() {
  return ROUTE == kInterleaved ? 1 : kSplineUnrolled<W>;
}

template <typename T, int NDIMS, int K, bool kStack, int ROUTE>
__global__ void __launch_bounds__(threads_of<ROUTE>())
    bspline_kernel(KnotArgs<T> knots, ObsPtrs<T> obs, const T* __restrict__ coeffs,
                   int64_t table, int nch, int groups, T* __restrict__ out, int64_t n) {
  constexpr int W = K + 1;
  constexpr bool kShared = ROUTE == kStagedGroups;
  constexpr int L = lanes_of<T, ROUTE>();  // channels a leaf
  constexpr int U = spline_unrolled<W, ROUTE>();
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ uint64_t bar;
  int stride[NDIMS];  // of the layout read: the table's, times nch interleaved
#pragma unroll
  for (int a = 0; a < NDIMS; ++a) stride[a] = knots.stride[a] * (ROUTE == kInterleaved ? nch : 1);
  // the tables this block runs and the blocks that share them: its group
  // and the group's blocks on the staged routes, all of them on the others
  int first = 0, count = nch, b0 = 0, nb = gridDim.x;
  if constexpr (kShared && kStack) {
    block_group(nch, groups, gridDim.x, blockIdx.x, &first, &count, &b0, &nb);
  }
  const T* src = coeffs + first * table;
  T* dst = out + first * n;
  bool pending = false;  // a bulk copy into shared memory not yet awaited
  if constexpr (kShared) src = stage_table(src, table * count, smem, &bar, &pending);
  // 16-byte loads of an interleaved stack's channel runs: every run aligned
  const bool vec = reinterpret_cast<uintptr_t>(src) % 16 == 0 && (nch * sizeof(T)) % 16 == 0;
  const int64_t nthreads = static_cast<int64_t>(nb) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x - b0) * blockDim.x + threadIdx.x; i < n;
       i += nthreads) {
    T w[NDIMS * W];  // axis a's weights at w[a * W ..]
    int base = 0;
#pragma unroll
    for (int a = 0; a < NDIMS; ++a) {
      base += basis_weights<T, K>(knots.col[a], knots.dim[a], __ldg(obs.p[a] + i), w + a * W) *
              stride[a];
    }
    if constexpr (kShared) {
      if (pending) {
        await_bulk(&bar);
        pending = false;
      }
    }
    if constexpr (ROUTE == kInterleaved) {  // L channels at a time
      for (int c0 = 0; c0 < nch; c0 += L) {
        const int cnt = nch - c0 < L ? nch - c0 : L;
        const Lanes<T, L> y = SplineTree<T, W, NDIMS, 0, U>::eval(
            Channels<T, L, false>{src + c0, cnt, vec && cnt == L}, base, stride, w);
#pragma unroll
        for (int j = 0; j < L; ++j) {
          if (j < cnt) out[(c0 + j) * n + i] = y.v[j];
        }
      }
    } else if constexpr (kStack) {  // the block's tables one after another
      for (int c = 0; c < count; ++c) {
        dst[c * n + i] = SplineTree<T, W, NDIMS, 0, U>::eval(
            Channels<T, 1, kShared>{src + c * table, 1, false}, base, stride, w).v[0];
      }
    } else if constexpr (kShared) {  // one table, from its copy in shared memory
      out[i] = SplineTree<T, W, NDIMS, 0, U>::eval(Channels<T, 1, true>{src, 1, false}, base,
                                                   stride, w).v[0];
    } else {
      out[i] = SplineTree<T, W, NDIMS, 0, U>::eval(Ldg<T>{coeffs}, base, stride, w).v[0];
    }
  }
  if constexpr (kShared) {
    // a thread that read no table still lets the copy land before its
    // block's shared memory is released
    if (pending) await_bulk(&bar);
  }
}

// What every launch of one call shares.
struct SplineLaunch {
  const int* dims;
  const void* const* knots;
  const void* const* obs;
  const void* coeffs;  // the stack, or its interleave
  int nch;
  void* out;
  int64_t n;
  cudaStream_t stream;
};

// Blocks an SM of the direct route, as the single-table kernel has always
// run (2048 threads an SM at 256 a block, whatever its registers allow).
constexpr int kDirectBlocksPerSm = 8;

template <typename T, int NDIMS, int K, bool kStack, int ROUTE>
struct Spline {
  static cudaError_t launch(const SplineLaunch& a) {
    const auto kernel = bspline_kernel<T, NDIMS, K, kStack, ROUTE>;
    constexpr int threads = threads_of<ROUTE>();
    constexpr size_t reserve = reserve_of<ROUTE>();
    constexpr bool kShared = ROUTE == kStagedGroups;
    int64_t table = 1;
    for (int k = 0; k < NDIMS; ++k) table *= a.dims[k];
    const int groups = kShared ? table_groups<T>(table, a.nch) : 1;
    if (groups < 1) return cudaErrorInvalidValue;  // a table above the group cap
    // the largest staged group and its offset from a 16-byte boundary
    const size_t smem = kShared ? table * ((a.nch + groups - 1) / groups) * sizeof(T) + 16 : 0;
    if (smem > reserve) return cudaErrorInvalidValue;  // above the staging cap
    int blocks = 0;
    if constexpr (ROUTE == kDirect) {
      int per_sm = 0, sms = 0;
      const cudaError_t err = occupancy(occupancy_cache<Spline>(), kernel, threads, reserve,
                                        &per_sm, &sms);
      if (err != cudaSuccess) return err;
      const int64_t want = (a.n + threads - 1) / threads;
      const int64_t most = static_cast<int64_t>(kDirectBlocksPerSm) * sms;
      blocks = static_cast<int>(want < most ? want : most);
    } else {
      const cudaError_t err = grid_blocks(occupancy_cache<Spline>(), kernel, threads, reserve,
                                          a.n, &blocks, groups, a.nch);
      if (err != cudaSuccess) return err;
    }
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
    kernel<<<blocks, threads, smem, a.stream>>>(knots, ptrs, static_cast<const T*>(a.coeffs),
                                                table, a.nch, groups,
                                                static_cast<T*>(a.out), a.n);
    return cudaGetLastError();
  }

  static cudaError_t info(int* out) {
    return kernel_info(occupancy_cache<Spline>(), bspline_kernel<T, NDIMS, K, kStack, ROUTE>,
                       threads_of<ROUTE>(), reserve_of<ROUTE>(), out);
  }
};

// The B-spline family for regular.cuh's `visit`: the method slot carries
// the degree (kLinear for 3, kCubic for 5, so that `visit_method` picks one
// of two instantiations).
struct SplineFamily {
  static constexpr bool served(int route, int method, bool stack, int ndims) {
    return method != kNearest && spline_serves(route, stack);
  }
  template <typename T, int NDIMS, int METHOD, bool kStack, int ROUTE>
  using Kernel = Spline<T, NDIMS, METHOD == kLinear ? 3 : 5, kStack, ROUTE>;
};

struct SplineLaunchOp {
  const SplineLaunch& a;
  template <typename R>
  cudaError_t run() {
    return R::launch(a);
  }
};

// The degree's slot in `visit`'s method (see SplineFamily); -1 for a degree
// with no instantiation.
constexpr int degree_slot(int degree) {
  return degree == 3 ? kLinear : (degree == 5 ? kCubic : -1);
}

// The body of the sources' C entry points (see fused_bspline.cu).
template <bool kStack>
int bspline_entry(int degree, int is_f64, int ndims, const int* dims, const void* const* knots,
                  void* work, const void* coeffs, const void* const* obs, void* out,
                  long long n, int nch, int route, void* stream) {
  if (ndims < 1 || ndims > kMaxDims || n <= 0 || nch <= 0 || (!kStack && nch != 1) ||
      degree_slot(degree) < 0 || !spline_serves(route, kStack) ||
      (route == kInterleaved && work == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int64_t table = 1;
  for (int k = 0; k < ndims; ++k) table *= dims[k];
  const auto s = static_cast<cudaStream_t>(stream);
  // the interleaved route's layout into `work`, then the kernel that reads it
  const cudaError_t err =
      launch_layout<SplineFamily, kStack>(route, is_f64, ndims, dims, coeffs, work, table, nch, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const SplineLaunch a{dims, knots, obs, route == kInterleaved ? work : coeffs, nch, out, n, s};
  SplineLaunchOp op{a};
  return static_cast<int>(
      visit<SplineFamily, kStack>(is_f64, route, degree_slot(degree), ndims, op));
}

// The body of the sources' info entry points: registers, shared memory,
// spills and resident blocks of one instantiation (see fused_bspline.cu).
template <bool kStack>
int bspline_info_entry(int degree, int is_f64, int ndims, int route, int* out) {
  if (degree_slot(degree) < 0) return static_cast<int>(cudaErrorInvalidValue);
  InfoOp op{out};
  return static_cast<int>(
      visit<SplineFamily, kStack>(is_f64, route, degree_slot(degree), ndims, op));
}

}  // namespace interp
