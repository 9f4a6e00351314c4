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
// - cubic: the four weights of each axis, its Hermite node (the nonuniform
//   centered differences and h-ratio normalizations of
//   `_axis_reduce_rectilinear`) on the four unit bases, and the 4^N stencil
//   of every table contracted with them, axis 0 first
//   (`ops/cubic.py::rectilinear_cubic_weights`, `contract_cubic`); where a
//   result is not finite (a NaN or inf in the stencil, whose 0 * inf the
//   contraction turns into NaN, or an overflow), the Hermite tree of
//   `ops/cubic.py::cubic_rectilinear` on that table in its place, as the
//   plain version (`ops/fused.py::plain_rectilinear`) selects it;
// - nearest: one table read, the lower index winning the tie.
// Every rounding step is the plain PyTorch version's, so the two agree bit
// for bit (see interp_common.cuh).
//
// Design. The TPU computes the weights outside the kernel (K2, K6) or
// builds dense one-hot planes per axis (K3), because Mosaic has no per-lane
// gather; here one thread per query bisects its columns (a few KB, read
// through the read-only cache) and reads only its stencil. Cubic builds its
// weights once a query, as the TPU's `_rect_locs_weights` does, so a stack's
// tables share them and no per-table node arithmetic remains: about 2N
// divisions and 4N nodes on unit bases a query, then 2 * 4^N - 1 operations
// a table (the Hermite tree took 4 divisions and ~27 operations a node, 21
// nodes a 3D table). One linear or nearest table (K2 linear, K3) locates
// by the guided locate below, where its columns fit (kGuided, kStaged):
// each block copies the grid columns into shared memory with 2 dim bucket
// starts an axis, and a query bisects only its own bucket there, a knot or
// two on a jittered axis, in place of about log2(dim) dependent column
// reads from device memory (the bisection stays for K2 cubic, K6 and the
// f64 engines, `partition_point`). An f32 linear table within kStageBytes
// with its guide is staged beside it, as K1 stages its table (kStaged).
// A linear or nearest stack reads K5's layouts (regular.cuh), its trees
// unchanged, so every row is the single-table kernel's bits:
// - kInterleaved (kRunBytes of channels or more, the interleave within
//   int32 indices): the interleave, a corner's channels in one sector, read
//   as two 16-byte loads, the lerp tree over the channels together
//   (`LerpTree` on `Channels<T, W>`), nearest one vector read of its
//   channels. Direct, a stack of 8 f32 tables at 20^3 made 8 x 8 scattered
//   reads a linear query (0.1006 ms on an H100; K5 read interleaved in
//   0.0621, PERF.md).
// - kStaged (an f32 linear stack of at most kStageBytes in all): every
//   table copied into each 1024-thread block's shared memory, as K5 stages
//   one, and read there table by table.
//
// The routes: `ops/fused.py::rectilinear_route` alone picks one, lays
// the table out for it (the entry launches regular.cuh's layout kernels)
// and passes its code; the C side checks only that it has an instantiation
// (`rect_serves`). The cubic ones:
// - kStaged (one table, or a whole stack, of at most kStageBytes): each
//   1024-thread block copies it into shared memory by one bulk copy, as K1
//   does, and reads the stencil there (20^3 f32 0.0829 ms against 0.1303
//   direct on an H100, PERF.md).
// - kStagedTables (a stack above that whose tables fit kStageBytes each):
//   each 1024-thread block takes a tile of queries at a time, builds their
//   weights, then runs the tables one after another from a double buffer
//   in shared memory, copying table c + 1 (`cp.async`, 16 bytes a thread a
//   copy) while table c is contracted. A tile's copies move every table
//   through L2 once; reading an interleaved stack moved each query's 64
//   sectors (0.418 ms for 8 f32 tables at 20^3, at about the L2 rate).
// - kTaps (one table above kStageBytes whose cubic pack fits 32 MiB): the
//   cubic pack (`cubic_pack_kernel`), axis 0's four taps of a stencil row in
//   one 16-byte (f32) or 32-byte (f64) cell, is the leaf: one vector dotted
//   with axis 0's weights. One lane a query from 2D: four lanes (K1's tap
//   lanes), each building all the weights, ran 100^3 f32 in 0.2966 ms
//   against 0.1800.
// - kInterleaved (a stack of kRunBytes of channels or more whose tables
//   exceed kStageBytes; f64 from 4D only tables above 256 KiB): the
//   interleave (`interleave_kernel`), an entry's channels in one sector,
//   read as two 16-byte loads; the contraction keeps one running sum a
//   channel a level (eight Hermite trees at once would not fit the
//   registers; eight partial sums do). 8 f32 tables ran 4.1-7.4x ahead of
//   direct at 3-5D, 4 f64 1.1-3.6x at 30^3-100^3, 20^4 and 9^5, but behind
//   it at 12^4 and 8^5 (8.5%, 13%), whose tables direct reads from L1.
// - kDirect (the rest): the stencil straight from each table through the
//   read-only cache.
//
// The routes of one linear or nearest table (`_lerp_table_route`):
// - kStaged (f32 linear, table and guide within kStageBytes): the table
//   staged by `stage_table`'s bulk copy, in flight while the guide is built;
//   the locate and the 2^N corner reads in shared memory.
// - kGuided (the guide within kColumnBytes; not an f32 linear table above
//   256 KiB from 3D, whose corner reads from L2 set its pace and which ran
//   behind direct there): the guide in shared memory, the table direct.
// - kDirect (the rest): the bisection of each column from device memory.
// Each block builds its own guide, 1024 threads a block sharing it: with
// 256, four times the builds cost 14-24% more time at 1000^2 (PERF.md).
//
// What bounds it on this card: the query stream (sizeof(T)*(ndims+nch)
// bytes per query) for linear and nearest, plus the locate (a few
// dependent shared-memory reads an axis guided, about log2(dim) column
// reads bisecting) and the corners' scattered reads (a sector of channels
// each, interleaved); for cubic the weight build and the stencil's 4^N
// reads a table, from shared memory or L2 (PERF.md).

#pragma once

#include "interp_common.cuh"
#include "regular.cuh"

namespace interp {

template <typename T>
struct RectGrid {
  const T* col[kMaxDims];  // grid column of each axis
  int dim[kMaxDims];       // its length
  int stride[kMaxDims];    // C-order strides of the table in elements
};

// Whether the rectilinear family has an instantiation for the route: direct
// for every method; the cubic routes as the header says (taps from 2D);
// for a linear or nearest stack K5's, interleaved, and staged for linear;
// for one linear or nearest table the guided locate, on kGuided, and for
// linear on kStaged too.
constexpr bool rect_serves(int route, int method, bool stack, int ndims) {
  return route == kDirect ||
         (method == kCubic &&
          (route == kStaged || (stack && (route == kInterleaved || route == kStagedTables)) ||
           (!stack && route == kTaps && ndims >= 2))) ||
         (method != kCubic && stack &&
          (route == kInterleaved || (route == kStaged && method == kLinear))) ||
         (method != kCubic && !stack &&
          (route == kGuided || (route == kStaged && method == kLinear)));
}

// Whether the instantiation locates by the guided locate below: one linear or
// nearest table on kGuided (the table direct) or kStaged (the table in
// shared memory too). Every other instantiation keeps the bisection from
// device memory (`partition_point`).
template <int METHOD, bool kStack, int ROUTE>
__host__ __device__ constexpr bool guided() {
  return METHOD != kCubic && !kStack && (ROUTE == kGuided || ROUTE == kStaged);
}

// --- the guided locate ------------------------------------------------------------

// Buckets of an axis of `dim` points: uniform over [g[0], g[dim-1]], twice
// as many as the points, so that a jittered axis has a knot or none in most.
__host__ __device__ constexpr int buckets_of(int dim) { return 2 * dim; }

// Bytes of the guided locate's shared memory: each axis's column, then each
// axis's bucket starts (buckets_of(dim) + 1 ints).
template <typename T>
int64_t guide_bytes(const int* dims, int ndims) {
  int64_t bytes = 0;
  for (int k = 0; k < ndims; ++k) {
    bytes += dims[k] * static_cast<int64_t>(sizeof(T)) + (buckets_of(dims[k]) + 1) * 4;
  }
  return bytes;
}

// Where the guide starts on kStaged: after the staged table and its offset
// from a 16-byte boundary, on a 16-byte boundary.
__host__ __device__ constexpr int64_t guide_offset(int64_t table_bytes) {
  return (table_bytes + 31) & ~int64_t(15);
}

// An axis's bucket parameters, in shared memory: x's bucket is
// floor((x - lo) * scale), scale = buckets / (g[dim-1] - g[0]).
template <typename T>
struct AxisGuide {
  T lo;
  T scale;
};

// The bucket of x: floor((x - lo) * scale), clamped to [0, m - 1] in floating
// point before the conversion (NaN gives 0, since fmax returns the other
// operand; +-inf and huge |x| the edge buckets). Each step is monotone in x,
// so x <= y gives bucket_of(x) <= bucket_of(y) however the steps round. The
// bucket starts are built with this same function and scale, so every knot
// in a lower bucket than x's is below x and none in a higher one is: the
// count below needs no margin, whatever the grid's offset or spacing.
template <typename T>
__device__ __forceinline__ int bucket_of(T x, const AxisGuide<T>& a, int m) {
  return static_cast<int>(clamp_(floor_(mul_rn(sub_rn(x, a.lo), a.scale)), static_cast<T>(m - 1)));
}

// Count of the staged column's entries < x, as `partition_point` (NaN
// counting 0): the knots of the buckets below x's, first[b], and a bisection
// of x's own bucket's, first[b] .. first[b+1] - 1, all in shared memory.
template <typename T>
__device__ __forceinline__ int guided_count(const T* g, const int* first, const AxisGuide<T>& a,
                                            int m, T x) {
  const int b = bucket_of(x, a, m);
  int lo = first[b];
  int count = first[b + 1] - lo;
  while (count > 0) {
    const int half = count >> 1;
    if (g[lo + half] < x) {
      lo += half + 1;
      count -= half + 1;
    } else {
      count = half;
    }
  }
  return lo;
}

// The guided locate's per-axis steps for axes K .. NDIMS - 1, each at its
// index known when compiled (a loop over the axes, holding a loop per axis,
// left the grid's parameters indexed at run time: copied to local memory,
// 128 bytes a thread).
template <typename T, int NDIMS, int K = 0>
struct GuidedAxes {
  using Next = GuidedAxes<T, NDIMS, K + 1>;

  // Copies column K, then the next ones, into `cols` (axis after axis), and
  // sets each axis's bucket parameters in `axes`.
  static __device__ __forceinline__ void stage(const RectGrid<T>& grid, T* cols,
                                               AxisGuide<T>* axes) {
    if constexpr (K < NDIMS) {
      const int dim = grid.dim[K];
      const T* __restrict__ g = grid.col[K];
      for (int j = threadIdx.x; j < dim; j += blockDim.x) cols[j] = __ldg(g + j);
      if (threadIdx.x == K) {
        const T lo = __ldg(g);
        axes[K].lo = lo;
        axes[K].scale = div_rn(static_cast<T>(buckets_of(dim)), sub_rn(__ldg(g + dim - 1), lo));
      }
      Next::stage(grid, cols + dim, axes);
    }
  }

  // Axis K's bucket starts into `first` (first[c], c = 0..m: the knots whose
  // bucket is below c), then the next axes' after them. A thread takes knot
  // j and writes j into the starts of the buckets from the one after knot
  // j - 1's to knot j's own (j = dim: to the last), so that each start is
  // written once.
  static __device__ __forceinline__ void build(const RectGrid<T>& grid, const T* cols, int* first,
                                               const AxisGuide<T>* axes) {
    if constexpr (K < NDIMS) {
      const int dim = grid.dim[K];
      const int m = buckets_of(dim);
      const AxisGuide<T> a = axes[K];
      for (int j = threadIdx.x; j <= dim; j += blockDim.x) {
        const int from = j == 0 ? 0 : bucket_of(cols[j - 1], a, m) + 1;
        const int to = j == dim ? m : bucket_of(cols[j], a, m);
        for (int c = from; c <= to; ++c) first[c] = j;
      }
      Next::build(grid, cols + dim, first + m + 1, axes);
    }
  }

  // Query i's cell on axes K and on (its node for nearest: the lower index
  // at the tie; a NaN t fails <= and takes +1), as an offset into the table,
  // and each axis's t.
  template <int METHOD>
  static __device__ __forceinline__ int locate(const RectGrid<T>& grid, const ObsPtrs<T>& obs,
                                               int64_t i, const T* cols, const int* first,
                                               const AxisGuide<T>* axes, T* t) {
    if constexpr (K == NDIMS) {
      return 0;
    } else {
      const int dim = grid.dim[K];
      const int m = buckets_of(dim);
      const T x = __ldg(obs.p[K] + i);
      const int iloc = guided_count(cols, first, axes[K], m, x) - 1;
      const int last = dim - 2 > 0 ? dim - 2 : 0;
      const int loc = iloc < 0 ? 0 : (iloc > last ? last : iloc);
      const T x0 = cols[loc];
      t[K] = div_rn(sub_rn(x, x0), sub_rn(cols[loc + 1], x0));
      const int at = METHOD == kNearest ? loc + (t[K] <= T(0.5) ? 0 : 1) : loc;
      return at * grid.stride[K] +
             Next::template locate<METHOD>(grid, obs, i, cols + dim, first + m + 1, axes, t);
    }
  }
};

// One linear or nearest table on kGuided (the table read direct) or kStaged
// (the table in shared memory too, by `stage_table`'s bulk copy, in flight
// while the guides are built): each axis located by `guided_count` from
// the block's copy of its column, then the same t, nearest rule and lerp
// tree as the bisecting instantiations, so the same bits.
template <typename T, int NDIMS, int METHOD, int ROUTE>
__device__ __forceinline__ void guided_table(const RectGrid<T>& grid, const ObsPtrs<T>& obs,
                                             const T* __restrict__ vals, int64_t table,
                                             T* __restrict__ out, int64_t n,
                                             unsigned char* smem, uint64_t* bar) {
  constexpr bool kShared = ROUTE == kStaged;
  using Axes = GuidedAxes<T, NDIMS>;
  __shared__ AxisGuide<T> axes[NDIMS];
  const T* src = vals;
  bool pending = false;  // a bulk copy into shared memory not yet awaited
  unsigned char* region = smem;
  if constexpr (kShared) {
    src = stage_table(vals, table, smem, bar, &pending);
    region = smem + guide_offset(table * static_cast<int64_t>(sizeof(T)));
  }
  int total = 0;
#pragma unroll
  for (int k = 0; k < NDIMS; ++k) total += grid.dim[k];
  T* cols = reinterpret_cast<T*>(region);
  int* first = reinterpret_cast<int*>(cols + total);
  Axes::stage(grid, cols, axes);
  __syncthreads();
  Axes::build(grid, cols, first, axes);
  __syncthreads();
  int stride[NDIMS];
#pragma unroll
  for (int k = 0; k < NDIMS; ++k) stride[k] = grid.stride[k];
  const int64_t nthreads = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += nthreads) {
    T t[NDIMS];
    const int base = Axes::template locate<METHOD>(grid, obs, i, cols, first, axes, t);
    if constexpr (kShared) {
      if (pending) {
        await_bulk(bar);
        pending = false;
      }
    }
    const Channels<T, 1, kShared> at{src, 1, false};
    if constexpr (METHOD == kNearest) {
      out[i] = at(base).v[0];
    } else {
      out[i] = LerpTree<T, NDIMS>::eval(at, base, stride, t).v[0];
    }
  }
  if constexpr (kShared) {
    // a thread that read no table still lets the copy land before its
    // block's shared memory is released
    if (pending) await_bulk(bar);
  }
}

// The leaf of the taps routes: axis 0's four taps at `cell` of the cubic
// pack, one 16-byte (f32) or two (f64) vector loads through the read-only
// cache, contracted with axis 0's weights.
template <typename T>
struct RectTaps {
  const T* q;  // the pack, 4 entries a cell
  const T* w;  // axis 0's weights

  __device__ __forceinline__ Lanes<T, 1> operator()(int cell) const {
    using V = typename Vec16<T>::type;
    constexpr int kPer = 16 / sizeof(T);
    const V* p = reinterpret_cast<const V*>(q) + static_cast<int64_t>(cell) * (4 / kPer);
    T v[4];
#pragma unroll
    for (int j = 0; j < 4 / kPer; ++j) Vec16<T>::put(v + j * kPer, __ldg(p + j));
    return {dot4(w, v[0], v[1], v[2], v[3])};
  }
};

// The plain version's choice where query i's contraction of table c is not
// finite: that table's Hermite tree (`cubic_rectilinear`), read from the
// table itself. The axes are located again, so that no weight stays live,
// and the call is out of line, so that the tree's registers and spills stay
// off the contraction's path (a finite table never takes it).
template <typename T, int NDIMS>
__device__ __noinline__ void cubic_tree_where_not_finite(const RectGrid<T>& grid,
                                                          const ObsPtrs<T>& obs, int64_t i,
                                                          const T* __restrict__ vals,
                                                          int64_t table, int nch,
                                                          T* __restrict__ out, int64_t n,
                                                          bool lin) {
  RectCubicAxis<T> ax[NDIMS];
  int stride[NDIMS];
  int base = 0;
#pragma unroll
  for (int k = 0; k < NDIMS; ++k) {
    stride[k] = grid.stride[k];
    base += cubic_axis(grid.col[k], grid.dim[k], __ldg(obs.p[k] + i), ax[k]) * stride[k];
  }
  for (int c = 0; c < nch; ++c) {
    if (!isfinite(out[c * n + i])) {
      out[c * n + i] = CubicTree<T, RectCubicAxis<T>, NDIMS>::eval(Ldg<T>{vals + c * table},
                                                                   base, stride, ax, lin);
    }
  }
}

// Bytes of one buffer of kStagedTables: a table and its offset from a
// 16-byte boundary, a multiple of 16.
__host__ __device__ constexpr int64_t table_buffer(int64_t bytes) {
  return ((bytes + 15) & ~int64_t(15)) + 16;
}

// kStagedTables: the queries a tile of Q * blockDim.x at a time, every
// thread of the block in every tile, since the copies and barriers are the
// block's. A thread builds its Q queries' weights once; table c + 1 is
// copied into one half of the double buffer while table c, in the other, is
// contracted. Two queries a thread in f32 halve the barriers and copies a
// query (the stack of 8 at 20^3 0.3729 ms against 0.3974 with one); f64's
// two weight sets would not fit the 64 registers (1.0504 against 0.3983).
template <typename T, int NDIMS, int U>
__device__ __forceinline__ void staged_tables(const RectGrid<T>& grid, const ObsPtrs<T>& obs,
                                              const T* __restrict__ vals, int64_t table,
                                              int nch, T* __restrict__ out, int64_t n,
                                              bool lin, unsigned char* smem) {
  constexpr int Q = sizeof(T) == 4 ? 2 : 1;
  const int64_t bytes = table_buffer(table * static_cast<int64_t>(sizeof(T)));
  int stride[NDIMS];
#pragma unroll
  for (int k = 0; k < NDIMS; ++k) stride[k] = grid.stride[k];
  for (int64_t t0 = static_cast<int64_t>(blockIdx.x) * Q * blockDim.x; t0 < n;
       t0 += static_cast<int64_t>(gridDim.x) * Q * blockDim.x) {
    const T* s = stage_async(vals, table, smem);  // table 0 into the first half
    T w[Q][4 * NDIMS];
    int base[Q];
    int64_t iq[Q];
    bool active[Q], finite[Q];
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      iq[q] = t0 + q * blockDim.x + threadIdx.x;
      active[q] = iq[q] < n;
      finite[q] = true;
      base[q] = 0;
      if (active[q]) {
#pragma unroll
        for (int k = 0; k < NDIMS; ++k) {
          base[q] += cubic_weights(grid.col[k], grid.dim[k], __ldg(obs.p[k] + iq[q]), lin,
                                   w[q] + 4 * k) *
                     stride[k];
        }
      }
    }
    for (int c = 0; c < nch; ++c) {
      const T* next = s;
      if (c + 1 < nch) {
        next = stage_async(vals + (c + 1) * table, table, smem + ((c + 1) & 1) * bytes);
        await_async<1>();  // this thread's copies of table c
      } else {
        await_async<0>();
      }
      __syncthreads();  // every thread's copies of table c
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        if (active[q]) {
          const Channels<T, 1, true> at{s, 1, false};
          const T r = WeightTree<T, NDIMS, 0, U>::eval(at, base[q], stride, w[q]).v[0];
          out[c * n + iq[q]] = r;
          finite[q] = finite[q] && isfinite(r);
        }
      }
      __syncthreads();  // table c read: its half may take table c + 2
      s = next;
    }
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      if (active[q] && !finite[q]) {
        cubic_tree_where_not_finite<T, NDIMS>(grid, obs, iq[q], vals, table, nch, out, n, lin);
      }
    }
  }
}

// The contraction's unrolled levels (WeightTree's UNROLLED), whose reads
// are all in flight at once: the tree's three (64 entries, or 16 cells of
// the cubic pack) where each read goes to L1 or L2; fewer where the
// registers are scarcer and the reads nearer: a staged table (1024 threads
// a block leave 64 registers a thread; shared memory answers in tens of
// cycles) and an interleaved stack (a sector of channels a read).
template <typename T, int ROUTE>
__host__ __device__ constexpr int unrolled_of() {
  return ROUTE == kInterleaved ? 1
                               : (ROUTE == kStaged || ROUTE == kStagedTables
                                      ? (sizeof(T) == 4 ? 2 : 1)
                                      : 3);
}

template <typename T, int NDIMS, int METHOD, bool kStack, int ROUTE>
__global__ void __launch_bounds__(threads_of<ROUTE>())
    rectilinear_kernel(RectGrid<T> grid, ObsPtrs<T> obs, const T* __restrict__ vals,
                       const T* __restrict__ layout, int64_t table, int nch,
                       T* __restrict__ out, int64_t n, bool lin) {
  constexpr bool kShared = ROUTE == kStaged;
  constexpr int U = unrolled_of<T, ROUTE>();
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ uint64_t bar;
  if constexpr (ROUTE == kStagedTables) {
    staged_tables<T, NDIMS, U>(grid, obs, vals, table, nch, out, n, lin, smem);
    return;
  }
  if constexpr (guided<METHOD, kStack, ROUTE>()) {
    guided_table<T, NDIMS, METHOD, ROUTE>(grid, obs, vals, table, out, n, smem, &bar);
    return;
  }
  int stride[NDIMS];  // of the layout read: the table's, times nch interleaved
#pragma unroll
  for (int k = 0; k < NDIMS; ++k) stride[k] = grid.stride[k] * (ROUTE == kInterleaved ? nch : 1);
  const T* src = layout;
  bool pending = false;  // a bulk copy into shared memory not yet awaited
  if constexpr (kShared) src = stage_table(vals, table * nch, smem, &bar, &pending);
  const int64_t nthreads = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += nthreads) {
    int base = 0;
    if constexpr (METHOD == kCubic) {
      T w[4 * NDIMS];
#pragma unroll
      for (int k = 0; k < NDIMS; ++k) {
        base += cubic_weights(grid.col[k], grid.dim[k], __ldg(obs.p[k] + i), lin, w + 4 * k) *
                stride[k];
      }
      if constexpr (kShared) {
        if (pending) {
          await_bulk(&bar);
          pending = false;
        }
      }
      bool finite = true;
      if constexpr (ROUTE == kInterleaved) {  // W channels at a time
        constexpr int W = lanes_of<T, ROUTE>();
        const bool vec =
            reinterpret_cast<uintptr_t>(src) % 16 == 0 && (nch * sizeof(T)) % 16 == 0;
        for (int c0 = 0; c0 < nch; c0 += W) {
          const int count = nch - c0 < W ? nch - c0 : W;
          const Lanes<T, W> y = WeightTree<T, NDIMS, 0, U>::eval(
              Channels<T, W, false>{src + c0, count, vec && count == W}, base, stride, w);
#pragma unroll
          for (int j = 0; j < W; ++j) {
            if (j < count) {
              out[(c0 + j) * n + i] = y.v[j];
              finite = finite && isfinite(y.v[j]);
            }
          }
        }
      } else if constexpr (taps(ROUTE)) {
        const T r = WeightTree<T, NDIMS, 1, U>::eval(RectTaps<T>{src, w}, base, stride, w).v[0];
        out[i] = r;
        finite = isfinite(r);
      } else {  // one table, or a stack's tables one at a time
        for (int c = 0; c < nch; ++c) {
          const Channels<T, 1, kShared> at{src + c * table, 1, false};
          const T r = WeightTree<T, NDIMS, 0, U>::eval(at, base, stride, w).v[0];
          out[c * n + i] = r;
          finite = finite && isfinite(r);
          if constexpr (!kStack) break;
        }
      }
      if (!finite) {
        cubic_tree_where_not_finite<T, NDIMS>(grid, obs, i, vals, table, kStack ? nch : 1,
                                              out, n, lin);
      }
    } else {
      T t[NDIMS];
#pragma unroll
      for (int k = 0; k < NDIMS; ++k) {
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
      if constexpr (kShared) {
        if (pending) {
          await_bulk(&bar);
          pending = false;
        }
      }
      if constexpr (ROUTE == kInterleaved) {  // W channels at a time, as K5 reads them
        constexpr int W = lanes_of<T, ROUTE>();
        const bool vec =
            reinterpret_cast<uintptr_t>(src) % 16 == 0 && (nch * sizeof(T)) % 16 == 0;
        for (int c0 = 0; c0 < nch; c0 += W) {
          const int count = nch - c0 < W ? nch - c0 : W;
          const Channels<T, W, false> at{src + c0, count, vec && count == W};
          Lanes<T, W> y;
          if constexpr (METHOD == kNearest) {
            y = at(base);
          } else {
            y = LerpTree<T, NDIMS>::eval(at, base, stride, t);
          }
#pragma unroll
          for (int j = 0; j < W; ++j) {
            if (j < count) out[(c0 + j) * n + i] = y.v[j];
          }
        }
      } else if constexpr (kShared) {  // a linear stack's tables from shared memory
        for (int c = 0; c < nch; ++c) {
          const Channels<T, 1, true> at{src + c * table, 1, false};
          out[c * n + i] = LerpTree<T, NDIMS>::eval(at, base, stride, t).v[0];
        }
      } else if constexpr (kStack) {
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
  if constexpr (kShared) {
    // a thread that read no table still lets the copy land before its
    // block's shared memory is released
    if (pending) await_bulk(&bar);
  }
}

// What every launch of one call shares.
struct RectLaunch {
  const int* dims;
  const void* const* cols;
  const void* const* obs;
  const void* vals;
  const void* layout;  // the layout the route reads: `vals`, or the layout buffer
  int64_t table;
  int nch;
  void* out;
  int64_t n;
  bool lin;
  cudaStream_t stream;
};

template <typename T, int NDIMS, int METHOD, bool kStack, int ROUTE>
struct Rect {
  static cudaError_t launch(const RectLaunch& a) {
    const auto kernel = rectilinear_kernel<T, NDIMS, METHOD, kStack, ROUTE>;
    constexpr int threads = threads_of<ROUTE>();
    constexpr size_t reserve = reserve_of<ROUTE>();
    // the staged tables and their offset from a 16-byte boundary; for
    // kStagedTables two tables' buffers; for the guided locate its columns
    // and bucket starts, after the table on kStaged
    const int64_t bytes = a.table * static_cast<int64_t>(sizeof(T));
    size_t smem = ROUTE == kStaged ? bytes * a.nch + 16
                                   : (ROUTE == kStagedTables ? 2 * table_buffer(bytes) : 0);
    if constexpr (guided<METHOD, kStack, ROUTE>()) {
      smem = (ROUTE == kStaged ? guide_offset(bytes) : 0) + guide_bytes<T>(a.dims, NDIMS);
    }
    if (smem > reserve) return cudaErrorInvalidValue;  // above the staging cap
    // as many blocks as the card holds at once with the route's shared
    // memory; but linear and nearest read direct keep their 8 blocks an
    // SM, more than their registers let run at once (the 48-register linear
    // stack ran 2.3% slower on its 5 resident blocks an SM, PERF.md)
    int per_sm = 0, sms = 0;
    const cudaError_t err = occupancy(occupancy_cache<Rect>(), kernel, threads, reserve,
                                      &per_sm, &sms);
    if (err != cudaSuccess) return err;
    const bool eight = METHOD != kCubic && ROUTE == kDirect;
    const int64_t most = static_cast<int64_t>(eight ? 8 : per_sm) * sms;
    const int64_t want = (a.n + threads - 1) / threads;
    const int blocks = static_cast<int>(want < most ? want : most);
    if (blocks <= 0) return cudaErrorInvalidConfiguration;
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
    kernel<<<blocks, threads, smem, a.stream>>>(
        grid, ptrs, static_cast<const T*>(a.vals), static_cast<const T*>(a.layout), a.table,
        a.nch, static_cast<T*>(a.out), a.n, a.lin);
    return cudaGetLastError();
  }

  static cudaError_t info(int* out) {
    return kernel_info(occupancy_cache<Rect>(), rectilinear_kernel<T, NDIMS, METHOD, kStack, ROUTE>,
                       threads_of<ROUTE>(), reserve_of<ROUTE>(), out);
  }
};

// The methods whose instantiations a translation unit builds, as bits 1 <<
// method: all of them for one table; the stack source builds cubic in
// fused_rectilinear_stack.cu and linear and nearest in
// fused_rectilinear_stack_lerp.cu, two units compiled at once (in one unit
// the stack source's build took 199 s on the card's host, PERF.md).
constexpr int kAllMethods = (1 << kLinear) | (1 << kCubic) | (1 << kNearest);
constexpr int kLerpMethods = (1 << kLinear) | (1 << kNearest);

// The rectilinear family for regular.cuh's `visit`, over the methods of
// kMethods.
template <int kMethods>
struct RectFamily {
  static constexpr bool served(int route, int method, bool stack, int ndims) {
    return ((kMethods >> method) & 1) != 0 && rect_serves(route, method, stack, ndims);
  }
  template <typename T, int NDIMS, int METHOD, bool kStack, int ROUTE>
  using Kernel = Rect<T, NDIMS, METHOD, kStack, ROUTE>;
};

struct RectLaunchOp {
  const RectLaunch& a;
  template <typename R>
  cudaError_t run() {
    return R::launch(a);
  }
};

// The launch of the kernel instantiation for (dtype, route, method, ndims)
// among those of kMethods, and its info (InfoOp's out[4]).
template <bool kStack, int kMethods>
cudaError_t rect_launch(int is_f64, int route, int method, int ndims, const RectLaunch& a) {
  RectLaunchOp op{a};
  return visit<RectFamily<kMethods>, kStack>(is_f64, route, method, ndims, op);
}

template <bool kStack, int kMethods>
cudaError_t rect_info(int is_f64, int route, int method, int ndims, int* out) {
  InfoOp op{out};
  return visit<RectFamily<kMethods>, kStack>(is_f64, route, method, ndims, op);
}

// rect_launch<true, kLerpMethods> and rect_info<true, kLerpMethods>, built
// in fused_rectilinear_stack_lerp.cu.
cudaError_t rect_stack_lerp_launch(int is_f64, int route, int method, int ndims,
                                   const RectLaunch& a);
cudaError_t rect_stack_lerp_info(int is_f64, int route, int method, int ndims, int* out);

// The body of the sources' C entry points (see fused_rectilinear.cu): the
// checks and the route's layout kernel here, in the unit of the entry; the
// kernel through `launch` (the stack source's linear and nearest:
// rect_stack_lerp_launch).
template <bool kStack>
int rectilinear_entry(int method, int linearize, int is_f64, int ndims, const int* dims,
                      const void* const* grids, void* work, const void* vals,
                      const void* const* obs, void* out, long long n, int nch, int route,
                      void* stream) {
  const bool relaid = route == kInterleaved || taps(route);
  if (ndims < 1 || ndims > kMaxDims || n <= 0 || nch <= 0 || (!kStack && nch != 1) ||
      method < kLinear || method > kNearest || !rect_serves(route, method, kStack, ndims) ||
      (relaid && work == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int64_t table = 1;
  for (int k = 0; k < ndims; ++k) table *= dims[k];
  const auto s = static_cast<cudaStream_t>(stream);
  // the route's layout into `work`, then the kernel that reads it
  const cudaError_t err = launch_layout<RectFamily<kAllMethods>, kStack>(
      route, is_f64, ndims, dims, vals, work, table, nch, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const RectLaunch a{dims, grids, obs, vals, relaid ? work : vals, table, nch, out, n,
                     linearize != 0, s};
  if constexpr (kStack) {
    if (method != kCubic) {
      return static_cast<int>(rect_stack_lerp_launch(is_f64, route, method, ndims, a));
    }
    return static_cast<int>(rect_launch<true, 1 << kCubic>(is_f64, route, method, ndims, a));
  } else {
    return static_cast<int>(rect_launch<false, kAllMethods>(is_f64, route, method, ndims, a));
  }
}

// The body of the sources' info entry points: registers, shared memory,
// spills and resident blocks of one instantiation (see fused_rectilinear.cu).
template <bool kStack>
int rectilinear_info_entry(int method, int is_f64, int ndims, int route, int* out) {
  if constexpr (kStack) {
    if (method != kCubic) {
      return static_cast<int>(rect_stack_lerp_info(is_f64, route, method, ndims, out));
    }
    return static_cast<int>(rect_info<true, 1 << kCubic>(is_f64, route, method, ndims, out));
  } else {
    return static_cast<int>(rect_info<false, kAllMethods>(is_f64, route, method, ndims, out));
  }
}

}  // namespace interp
