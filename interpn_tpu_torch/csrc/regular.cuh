// The regular-grid kernel, shared by `fused_regular.cu` (one table, K1) and
// `fused_regular_stack.cu` (a stack of nch tables, K5): multilinear,
// multicubic and nearest, f32 and f64, 1-8D.
//
// What it computes, per query:
// - linear: the 2^N cell corners reduced by the reference's lerp tree
//   (`ops/linear.py`: dim 0 first), cell and t located as
//   `locate_regular_linear` does;
// - cubic: the 4^N stencil reduced by the Hermite tree of `ops/cubic.py`,
//   with the 5-region saturation of `locate_regular_cubic`, optional
//   linearized extrapolation, and exact values at grid nodes;
// - nearest: one table read, the lower index winning the tie
//   (`ops/nearest.py`).
// Every rounding step is the plain PyTorch version's, so the two agree bit
// for bit (see interp_common.cuh). Only how the table values reach the
// registers differs between the routes below; the trees are the same.
//
// The TPU kernel contracts per-query weight matrices against the whole
// table on the MXU, because Mosaic has no per-lane gather. A Hopper thread
// gathers, so this kernel reads only the stencil: one thread per query in a
// grid-stride loop over as many blocks as the card holds at once (sized from
// the occupancy of each instantiation, `Regular::launch`).
//
// What bounds it on this card. Each query streams sizeof(T)*(ndims+nch)
// bytes of coordinates and results through device memory, and reads its
// stencil scattered: a warp's 32 queries touch up to 32 lines per stencil
// read, and each line is one L1 tag lookup, or one L2 request where the
// table misses L1, so the reads, not the bytes, set the pace (reading every
// corner direct, linear ran at 28% of its byte bound at 20^3 f32 and at 10%
// at 100^3). Cubic reads 4^N entries a query, and so is bound by its reads
// too, not by its ~20 operations a tree node: reading each entry as a
// scalar, it ran at 1.3-11% of its operation bound at 20^3-12^5 on an H100,
// worst where the table misses L1 and the tree's outer levels run as
// dependent batches of 64 reads (20^4 f32, 12^5 f64). The cubic routes cut
// the lookups a query and split the batches.
//
// The routes. The wrapper alone picks one, from dims, dtype, method and nch
// (`ops/fused.py::regular_route`), lays the table out for it and passes its
// code; the entry launches the route's instantiation and works nothing out
// again. Linear f64 is never staged nor packed: direct timed ahead of both
// at 20^3 and 100^3 on an H100.
// - kStaged (f32 linear, a table or a stack of fewer than 8, and cubic
//   below; at most kStageBytes): each block copies the table into shared
//   memory once, by one bulk asynchronous copy (`cp.async.bulk`, TMA's 1-D
//   form) completing on an mbarrier, its unaligned head and tail by plain
//   loads, and then reads the stencil there: bank conflicts, a few
//   wavefronts a warp, in place of up to 32 L1 tag lookups. The copies cost
//   L2 bandwidth at the start of the kernel, so the route runs 1024-thread
//   blocks. Nearest, one read a query, did not repay the copies and reads
//   the table direct.
// - kQuads (f32 linear, one table above that cap whose packed copy fits
//   16 MiB): the entry first launches the pack (`pack_kernel`) into a
//   buffer the wrapper allocates each call, so that cell (i, j, ...) holds
//   the four corners of axes 0 and 1 together, one 16-byte sector; a 1-D
//   table is packed as pairs. A query then reads 2^(N-2) quads instead of
//   2^N values. Axes 0 and 1 are the lerp tree's first two levels, so each
//   quad is one leaf of the depth-first tree and at most N - 2 partial sums
//   stay live.
// - kStaged for one cubic table of at most kStageBytes: the table as it
//   is, copied into each block's shared memory the same way, its stencil
//   read there (1.3-1.9x direct at 20^3-30^3 f32, 20^3 f64, 12^4 f32;
//   ahead of the cubic pack staged, of 4x the bytes, at 20^3 f32).
// - kTaps (2D) and kTapLanes (3D and up), one cubic table above that whose
//   pack fits 32 MiB: the entry first launches the cubic pack
//   (`cubic_pack_kernel`) into a buffer the wrapper allocates each call,
//   so that cell (i, r) holds axis 0's four taps (i..i+3, r) side by side,
//   one 16-byte vector of f32 or two of f64 in one sector. Axis 0 is the
//   tree's first level, so each cell is one leaf (`Taps`) and a query reads
//   4^(N-1) cells in place of 4^N entries. On kTapLanes four lanes of a
//   warp run one query, lane j the subtree of child j of the outermost
//   axis, and gather the four by shuffles for its node: the same
//   arithmetic on the same values, with a quarter of the dependent batches
//   and of the live registers a lane (20^4 f32 0.214 against 0.457 ms with
//   one lane a query, 12^5 f64 1.389 against 2.336; at 2D one lane a query
//   led, 0.024 against 0.043 ms at 200^2 f32). A 1-D table reads direct:
//   its taps lie side by side already. So does an f64 table of at most 256
//   KB at 2D or 3D, whose scalar reads hit L1 where its pack would not (a
//   stack of two or more such tables does not fit L1 and reads its packs).
//   A cubic stack of tables above kGroupBytes (K5) reads the same way,
//   table after table, each through its own pack: the entry first lays out
//   the packs of the whole stack, table after table, in one launch of
//   `cubic_pack_kernel`, and each query's axes, located once, serve
//   every table. Against kDirect at 1e6 queries on an H100: 8 x 20^4 f64
//   3.564 against 13.82 ms, 20^4 f32 1.528 against 13.38, 40^3 f32 0.455
//   against 2.569, 12^5 f64 12.10 against 58.61, 31^3 f64, whose tables fit
//   L1 one at a time but not together, 0.641 against 2.217 (2 tables 0.215
//   against 0.372; 1 table 0.144 against 0.136), on kTaps 240^2 f32 0.196
//   against 0.556 and 170^2 f64 0.256 against 0.537 (at 1e4 queries, 8 x
//   40^3 f32 and 20^4 f32 and f64, the kernels 2.0-4.3x too, though 40^3
//   f32's call, bound by the host there, ran 15% behind back to back, ~15
//   us longer on the host). Laid out
//   cell-major (a cell's tables side by side) the packs ran 1.24-2.5x
//   behind: a query's four lanes read four adjacent cells of a table, one
//   128-byte line, where cell-major spreads them over four; streaming loads
//   and stores of the queries and results (`__ldcs`, `__stcs`) moved no
//   case by more than 1%.
// - kInterleaved (a linear or nearest stack of at least kRunBytes of
//   channels a table entry: 8 f32, 4 f64 tables, at 1-8D): the entry
//   first launches the interleave (`interleave_kernel`) into a buffer the
//   wrapper allocates each call, (prod(dims), nch), so a query reads each
//   corner's channels as one run (two 16-byte loads a corner, one sector)
//   and runs the per-channel trees on them together, kRunBytes of channels
//   at a time. A smaller stack, and a cubic one, keeps its tables one after
//   another and runs one table at a time: its runs would fill part of a
//   sector and leave lanes idle (interleaved, stacks of 1 and 3 f32 tables
//   ran 2-3x slower than staged on an H100, `scripts/torch_regular_ab.py`),
//   and a cubic tree over 8 lanes (4^N entries each) would not fit the
//   registers.
// - kStagedGroups (K5 cubic and K7, a stack whose tables fit kGroupBytes
//   each): the stack split into the fewest groups of consecutive tables
//   within kGroupBytes (`table_groups`; one group where the whole stack
//   fits), as evenly as can be (`table_group`), the blocks the card
//   holds at once shared among the groups in proportion to their tables
//   (`block_group`); each 1024-thread block copies its group into shared
//   memory once, as kStaged copies a table, and runs each query of its
//   grid-stride loop over the group's tables from there, with no barrier
//   after the copy lands. Read direct, a stack of 8 20^3 f32 tables made 8 x 64
//   scattered L2 requests a query (0.6495 ms on an H100); from shared
//   memory its reads cost bank conflicts instead, about 3.5 wavefronts a
//   warp's read, which now set the pace (0.27 ms, PERF.md). Reading the
//   group a table at a time through a double buffer (kStagedTables, K6's)
//   and the interleave ran behind.
// - kDirect (the rest): the stencil straight from the table through the
//   read-only cache, a stack's tables one at a time (a cubic stack whose
//   packs would not fit the card's free memory or int32 indices).

#pragma once

#include "interp_common.cuh"
#include "occupancy.cuh"

namespace interp {

// routes: ops/fused.py::ROUTES, chosen by the wrapper alone
constexpr int kDirect = 0;
constexpr int kStaged = 1;
constexpr int kQuads = 2;
constexpr int kInterleaved = 3;
constexpr int kTaps = 4;
constexpr int kTapLanes = 5;
// a stack read one table at a time, each staged into a double buffer in
// shared memory (the rectilinear cubic stacks, rectilinear.cuh)
constexpr int kStagedTables = 6;
// a stack split into groups of consecutive tables, each block staging its
// group once (the cubic stacks, K5 and K7)
constexpr int kStagedGroups = 7;
// one linear or nearest rectilinear table read direct, its grid columns
// and their bucket guides in shared memory (rectilinear.cuh)
constexpr int kGuided = 8;

// Threads a block of the staged route. A staged block copies the whole
// table, so the route runs the largest blocks, one or two copies an SM
// (256-thread blocks made up to eight, and ran slower on an H100).
constexpr int kStagedThreads = 1024;
// The largest staged table in bytes (ops/fused.py::STAGE_BYTES): half of
// the 227 KB a block may use, so that two blocks share an SM.
constexpr int kStageBytes = 112 * 1024;
// The largest group of kStagedGroups in bytes (ops/fused.py::GROUP_BYTES):
// about all that a block may use, one block an SM.
constexpr int kGroupBytes = 224 * 1024;
// The largest guide of kGuided in bytes (ops/fused.py::COLUMN_BYTES): the
// grid columns and their bucket starts, each block's own copy.
constexpr int kColumnBytes = 32 * 1024;
// Bytes of channels an interleaved stack reads and runs together: one
// 32-byte sector, by two 16-byte loads (8 f32, 4 f64 channels).
constexpr int kRunBytes = 32;

// Whether the route reads the cubic pack (`cubic_pack_kernel`).
__host__ __device__ constexpr bool taps(int route) {
  return route == kTaps || route == kTapLanes;
}

// Lanes of a warp that run one query: the four children of the outermost
// axis on four lanes on kTapLanes, one lane on the others.
__host__ __device__ constexpr int group_of(int route) { return route == kTapLanes ? 4 : 1; }

// Whether the route copies tables into shared memory.
__host__ __device__ constexpr bool staged(int route) {
  return route == kStaged || route == kStagedTables || route == kStagedGroups;
}

template <int ROUTE>
constexpr int threads_of() {
  return staged(ROUTE) || ROUTE == kGuided ? kStagedThreads : kThreads;
}

// Dynamic shared memory a block of the route reserves: the largest staged
// table (group of tables) and its offset from a 16-byte boundary (two
// tables, the double buffer of kStagedTables; the guide of kGuided).
template <int ROUTE>
constexpr size_t reserve_of() {
  return ROUTE == kStaged ? kStageBytes + 16
                          : (ROUTE == kStagedTables
                                 ? 2 * (kStageBytes + 16)
                                 : (ROUTE == kStagedGroups
                                        ? kGroupBytes + 16
                                        : (ROUTE == kGuided ? kColumnBytes : 0)));
}

// The groups of consecutive tables that kStagedGroups splits nch tables of
// `table` entries of T into: the fewest whose even split (`table_group`)
// keeps each within kGroupBytes; 0 where one table exceeds it.
template <typename T>
int table_groups(int64_t table, int nch) {
  const int64_t per = kGroupBytes / (table * static_cast<int64_t>(sizeof(T)));
  return per < 1 ? 0 : static_cast<int>((nch + per - 1) / per);
}

// Tables c0 .. c0 + count - 1 of group g when nch tables are split into
// `groups` groups of consecutive tables as evenly as can be (the first
// nch % groups groups hold one table more).
__host__ __device__ inline void table_group(int nch, int groups, int g, int* c0, int* count) {
  const int q = nch / groups, r = nch % groups;
  *c0 = g * q + (g < r ? g : r);
  *count = q + (g < r ? 1 : 0);
}

// The group of tables that block b of `blocks` runs (its tables c0 .. c0 +
// count - 1), and that group's blocks b0 .. b0 + nb - 1: each group takes
// blocks in proportion to its tables, blocks * c0 / nch onwards, so that a
// smaller group does not leave its SMs idle while the larger ones run (a
// stack of 8 split 3 + 3 + 2 over equal blocks ran 12% behind 4 + 4). At
// least one block a group where blocks >= nch.
__device__ __forceinline__ void block_group(int nch, int groups, int blocks, int b, int* c0,
                                            int* count, int* b0, int* nb) {
  for (int g = 0; g < groups; ++g) {
    table_group(nch, groups, g, c0, count);
    const int lo = static_cast<int>(static_cast<int64_t>(blocks) * *c0 / nch);
    const int hi = static_cast<int>(static_cast<int64_t>(blocks) * (*c0 + *count) / nch);
    if (b < hi || g == groups - 1) {
      *b0 = lo;
      *nb = hi - lo;
      return;
    }
  }
}

// Channels of a stack that run together: a sector of them, interleaved;
// one table at a time on the other routes.
template <typename T, int ROUTE>
__host__ __device__ constexpr int lanes_of() {
  return ROUTE == kInterleaved ? kRunBytes / static_cast<int>(sizeof(T)) : 1;
}

// Whether the route has an instantiation for the method and ndims: staged
// serves linear, one table or a stack read table by table, and single-table
// cubic; staged groups the cubic stacks; quads single-table linear;
// interleaved the linear and nearest stacks; taps cubic, one table or a
// stack, at 2D, tap lanes from 3D.
constexpr bool serves(int route, int method, bool stack, int ndims) {
  return route == kDirect ||
         (route == kStaged && (method == kLinear || (method == kCubic && !stack))) ||
         (route == kStagedGroups && method == kCubic && stack) ||
         (route == kQuads && method == kLinear && !stack) ||
         (route == kInterleaved && method != kCubic && stack) ||
         (taps(route) && method == kCubic && (route == kTaps ? ndims == 2 : ndims >= 3));
}

struct GridArgs {
  int dim[kMaxDims];     // points per axis
  int stride[kMaxDims];  // strides in elements (stacks) or quads of the layout read
};

template <typename T>
struct Vec16;  // the 16-byte vector of T
template <>
struct Vec16<float> {
  using type = float4;
  static __device__ __forceinline__ void put(float* v, float4 q) {
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  }
};
template <>
struct Vec16<double> {
  using type = double2;
  static __device__ __forceinline__ void put(double* v, double2 q) {
    v[0] = q.x;
    v[1] = q.y;
  }
};

// *p from the staged copy in shared memory, or through the read-only cache
template <bool kShared, typename V>
__device__ __forceinline__ V load(const V* p) {
  if constexpr (kShared) {
    return *p;
  } else {
    return __ldg(p);
  }
}

// Channels c0 .. c0 + count - 1 (count <= W) of the entry at element offset
// `off`, from the table in device memory or its copy in shared memory: W
// values by 16-byte loads where `vec` (count == W and every run 16-byte
// aligned), else one load per channel; lanes past count read as 0.
template <typename T, int W, bool kShared>
struct Channels {
  const T* p;  // the table at channel c0
  int count;
  bool vec;

  __device__ __forceinline__ Lanes<T, W> operator()(int off) const {
    Lanes<T, W> r;
    constexpr int kPer = 16 / sizeof(T);
    if constexpr (W == 1) {
      r.v[0] = load<kShared>(p + off);
      return r;
    } else if constexpr (W % kPer == 0) {
      if (vec) {
        using V = typename Vec16<T>::type;
        const V* q = reinterpret_cast<const V*>(p + off);
#pragma unroll
        for (int j = 0; j < W / kPer; ++j) Vec16<T>::put(r.v + j * kPer, load<kShared>(q + j));
        return r;
      }
    }
#pragma unroll
    for (int j = 0; j < W; ++j) r.v[j] = j < count ? load<kShared>(p + off + j) : T(0);
    return r;
  }
};

// The leaf of the packed route: the pair (LEAF = 1: entries i, i+1 of a 1-D
// table) or quad (LEAF = 2: (i, j), (i+1, j), (i, j+1), (i+1, j+1) of axes 0
// and 1) at `cell`, reduced by the tree's first LEAF levels.
template <typename T, int LEAF>
struct Packed {
  const T* q;  // the packed copy, 2^LEAF entries a cell
  const T* t;

  __device__ __forceinline__ Lanes<T, 1> operator()(int cell) const {
    T v[1 << LEAF];
    if constexpr (LEAF == 1) {
      if constexpr (sizeof(T) == 4) {
        const float2 p = __ldg(reinterpret_cast<const float2*>(q) + cell);
        v[0] = p.x;
        v[1] = p.y;
      } else {
        Vec16<T>::put(v, __ldg(reinterpret_cast<const double2*>(q) + cell));
      }
    } else {
      using V = typename Vec16<T>::type;
      constexpr int kVecs = 4 * sizeof(T) / 16;
      const V* p = reinterpret_cast<const V*>(q) + static_cast<int64_t>(cell) * kVecs;
#pragma unroll
      for (int j = 0; j < kVecs; ++j) Vec16<T>::put(v + j * (16 / sizeof(T)), __ldg(p + j));
    }
    Lanes<T, 1> r;
    r.v[0] = add_rn(v[0], mul_rn(t[0], sub_rn(v[1], v[0])));
    if constexpr (LEAF == 2) {
      const T b = add_rn(v[2], mul_rn(t[0], sub_rn(v[3], v[2])));
      r.v[0] = add_rn(r.v[0], mul_rn(t[1], sub_rn(b, r.v[0])));
    }
    return r;
  }
};

// The leaf of the taps routes: axis 0's four taps (i..i+3) at `cell` of the
// cubic pack, one 16-byte (f32) or two (f64, one sector) vector loads
// through the read-only cache, reduced by axis 0's node.
template <typename T>
struct Taps {
  const T* q;  // the pack, 4 entries a cell
  RegularCubicAxis<T> a0;
  bool lin;

  __device__ __forceinline__ Lanes<T, 1> operator()(int cell) const {
    using V = typename Vec16<T>::type;
    constexpr int kPer = 16 / sizeof(T);
    const V* p = reinterpret_cast<const V*>(q) + static_cast<int64_t>(cell) * (4 / kPer);
    T v[4];
#pragma unroll
    for (int j = 0; j < 4 / kPer; ++j) Vec16<T>::put(v + j * kPer, __ldg(p + j));
    return {a0.node(v[0], v[1], v[2], v[3], lin)};
  }
};

// --- staging the table in shared memory -------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copies `entries` values from `vals` into shared memory so that entry e sits
// at s[e], s = smem + (vals & 15): the 16-byte-aligned middle by one bulk
// copy that thread 0 issues and that completes on `bar`, the unaligned head
// and tail (under 16 bytes each) by plain loads, visible after the
// __syncthreads here. Returns s; sets *bulk when a bulk copy is in flight
// (block-uniform), which `await_bulk` waits for.
template <typename T>
__device__ __forceinline__ const T* stage_table(const T* __restrict__ vals, int64_t entries,
                                                unsigned char* smem, uint64_t* bar, bool* bulk) {
  const uintptr_t g = reinterpret_cast<uintptr_t>(vals);
  const uintptr_t a = (g + 15) & ~uintptr_t(15);
  const uintptr_t e = (g + entries * sizeof(T)) & ~uintptr_t(15);
  T* s = reinterpret_cast<T*>(smem + (g & 15));
  *bulk = a < e;
  const int64_t head = *bulk ? static_cast<int64_t>((a - g) / sizeof(T)) : entries;
  const int64_t tail = *bulk ? static_cast<int64_t>((e - g) / sizeof(T)) : entries;
  for (int64_t k = threadIdx.x; k < head; k += blockDim.x) s[k] = __ldg(vals + k);
  for (int64_t k = tail + threadIdx.x; k < entries; k += blockDim.x) s[k] = __ldg(vals + k);
  if (*bulk && threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (*bulk && threadIdx.x == 0) {
    const uint32_t bytes = static_cast<uint32_t>(e - a);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                     smem_addr(bar)),
                 "r"(bytes)
                 : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
        "[%3];\n" ::"r"(smem_addr(s + head)),
        "l"(vals + head), "r"(bytes), "r"(smem_addr(bar))
        : "memory");
  }
  return s;
}

// Waits until the bulk copy of `stage_table` has landed (phase 0 of `bar`
// complete).
__device__ __forceinline__ void await_bulk(uint64_t* bar) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar))
        : "memory");
  } while (!done);
}

// Starts copying `entries` values from `vals` into the shared buffer `buf`
// so that entry e lands at s[e], s = buf + (vals & 15), and returns s: the
// 16-byte-aligned middle by asynchronous 16-byte copies (`cp.async`, one
// group a call for each thread), the unaligned head and tail by plain
// loads. The values are in place for every thread after `await_async` and a
// __syncthreads.
template <typename T>
__device__ __forceinline__ const T* stage_async(const T* __restrict__ vals, int64_t entries,
                                                unsigned char* buf) {
  const uintptr_t g = reinterpret_cast<uintptr_t>(vals);
  const uintptr_t a = (g + 15) & ~uintptr_t(15);
  const uintptr_t e = (g + entries * sizeof(T)) & ~uintptr_t(15);
  T* s = reinterpret_cast<T*>(buf + (g & 15));
  const int64_t head = a < e ? static_cast<int64_t>((a - g) / sizeof(T)) : entries;
  const int64_t tail = a < e ? static_cast<int64_t>((e - g) / sizeof(T)) : entries;
  for (int64_t k = threadIdx.x; k < head; k += blockDim.x) s[k] = __ldg(vals + k);
  for (int64_t k = tail + threadIdx.x; k < entries; k += blockDim.x) s[k] = __ldg(vals + k);
  const int64_t chunks = a < e ? static_cast<int64_t>((e - a) / 16) : 0;
  const uint32_t to = smem_addr(s + head);
  for (int64_t k = threadIdx.x; k < chunks; k += blockDim.x) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     to + 16 * static_cast<uint32_t>(k)),
                 "l"(reinterpret_cast<const unsigned char*>(a) + 16 * k)
                 : "memory");
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  return s;
}

// Waits until this thread's copies of `stage_async` but the last PENDING
// groups have landed.
template <int PENDING>
__device__ __forceinline__ void await_async() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// --- the kernel -------------------------------------------------------------------------

template <typename T, int NDIMS, int METHOD, bool kStack, int ROUTE>
__global__ void __launch_bounds__(threads_of<ROUTE>())
    regular_kernel(GridArgs grid, ObsPtrs<T> obs, const T* __restrict__ starts,
                   const T* __restrict__ steps, const T* __restrict__ vals, int64_t table,
                   int nch, int groups, T* __restrict__ out, int64_t n, bool lin) {
  constexpr bool kShared = ROUTE == kStaged || ROUTE == kStagedGroups;
  constexpr int W = lanes_of<T, ROUTE>();
  constexpr int kGroup = group_of(ROUTE);
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ uint64_t bar;
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
  // the tables this block runs and the blocks that share them: its group
  // and the group's blocks on the staged routes, all of them on the others
  int first = 0, count = nch, b0 = 0, nb = gridDim.x;
  if constexpr (kShared && kStack) {
    block_group(nch, groups, gridDim.x, blockIdx.x, &first, &count, &b0, &nb);
  }
  const T* src = vals + first * table;
  T* dst = out + first * n;
  bool pending = false;  // a bulk copy into shared memory not yet awaited
  if constexpr (kShared) src = stage_table(src, table * count, smem, &bar, &pending);
  // 16-byte loads of a stack's channel runs: every entry's run aligned
  const bool vec = reinterpret_cast<uintptr_t>(src) % 16 == 0 && (nch * sizeof(T)) % 16 == 0;
  const int64_t nthreads = static_cast<int64_t>(nb) * blockDim.x / kGroup;
  for (int64_t i = (static_cast<int64_t>(blockIdx.x - b0) * blockDim.x + threadIdx.x) / kGroup;
       i < n; i += nthreads) {
    int base = 0;
    if constexpr (METHOD == kCubic) {
      RegularCubicAxis<T> ax[NDIMS];
#pragma unroll
      for (int k = 0; k < NDIMS; ++k) {  // as interp_common.cuh's `regular_cubic_axis`
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
      if constexpr (kShared) {
        if (pending) {
          await_bulk(&bar);
          pending = false;
        }
      }
      using Axis = RegularCubicAxis<T>;
      if constexpr (taps(ROUTE)) {
        // the table (a stack's tables one after another, `table` entries
        // apart) through its cubic pack
        for (int c = 0; c < (kStack ? count : 1); ++c) {
          const Taps<T> leaf{src + c * table, ax[0], lin};
          if constexpr (kGroup == 4) {
            // lane j of the query's four runs child j of the outermost axis;
            // each lane gathers the four and evaluates its node, lane 0 stores
            const int j = threadIdx.x & 3;
            const unsigned group = 0xFu << (threadIdx.x & 28);
            const T y = CubicTree<T, Axis, NDIMS - 1, 1>::eval(
                leaf, base + j * stride[NDIMS - 1], stride, ax, lin);
            const T v0 = __shfl_sync(group, y, 0, 4);
            const T v1 = __shfl_sync(group, y, 1, 4);
            const T v2 = __shfl_sync(group, y, 2, 4);
            const T v3 = __shfl_sync(group, y, 3, 4);
            if (j == 0) dst[c * n + i] = ax[NDIMS - 1].node(v0, v1, v2, v3, lin);
          } else {
            dst[c * n + i] = CubicTree<T, Axis, NDIMS, 1>::eval(leaf, base, stride, ax, lin);
          }
        }
      } else if constexpr (kStack) {  // the block's tables one after another
        for (int c = 0; c < count; ++c) {
          dst[c * n + i] = CubicTree<T, Axis, NDIMS>::eval(
              Channels<T, 1, kShared>{src + c * table, 1, false}, base, stride, ax, lin);
        }
      } else {
        out[i] = CubicTree<T, Axis, NDIMS>::eval(Channels<T, 1, kShared>{src, 1, false}, base,
                                                 stride, ax, lin);
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
      if constexpr (kShared) {
        if (pending) {
          await_bulk(&bar);
          pending = false;
        }
      }
      if constexpr (ROUTE == kQuads) {
        constexpr int LEAF = NDIMS == 1 ? 1 : 2;
        out[i] = LerpTree<T, NDIMS, LEAF>::eval(Packed<T, LEAF>{vals, t}, base, stride, t).v[0];
      } else if constexpr (W == 1) {  // one table, or a stack's tables one at a time
        for (int c = 0; c < count; ++c) {
          const Channels<T, 1, kShared> at{src + c * table, 1, false};
          if constexpr (METHOD == kNearest) {
            dst[c * n + i] = at(base).v[0];
          } else {
            dst[c * n + i] = LerpTree<T, NDIMS>::eval(at, base, stride, t).v[0];
          }
          if constexpr (!kStack) break;
        }
      } else {  // channel-interleaved, W channels at a time
        for (int c0 = 0; c0 < nch; c0 += W) {
          const int count = nch - c0 < W ? nch - c0 : W;
          const Channels<T, W, kShared> at{src + c0, count, vec && count == W};
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
      }
    }
  }
  if constexpr (kShared) {
    // a thread that read no table still lets the copy land before its
    // block's shared memory is released
    if (pending) await_bulk(&bar);
  }
}

// The pack of the kQuads route: cell q of the (d0-1, d1-1, d2, ...) cells
// holds the corners (i, j), (i+1, j), (i, j+1), (i+1, j+1) of axes 0 and 1
// at the cell's other indices; a 1-D table (d1 = 0) packs (i, i+1). Plain
// version: `ops/fused.py::plain_pack`.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    pack_kernel(const T* __restrict__ vals, T* __restrict__ out, int cells, int d1, int rest) {
  using V = typename Vec16<T>::type;
  const int nthreads = gridDim.x * blockDim.x;
  for (int q = blockIdx.x * blockDim.x + threadIdx.x; q < cells; q += nthreads) {
    if (d1 == 0) {
      const T v0 = __ldg(vals + q), v1 = __ldg(vals + q + 1);
      if constexpr (sizeof(T) == 4) {
        reinterpret_cast<float2*>(out)[q] = make_float2(v0, v1);
      } else {
        reinterpret_cast<double2*>(out)[q] = make_double2(v0, v1);
      }
      continue;
    }
    const int r = q % rest;
    const int ij = q / rest;
    const int j = ij % (d1 - 1);
    const int i = ij / (d1 - 1);
    const int64_t row = static_cast<int64_t>(d1) * rest;  // axis 0's stride
    const T* p = vals + i * row + static_cast<int64_t>(j) * rest + r;
    const T v0 = __ldg(p), v1 = __ldg(p + row), v2 = __ldg(p + rest), v3 = __ldg(p + row + rest);
    if constexpr (sizeof(T) == 4) {
      reinterpret_cast<V*>(out)[q] = make_float4(v0, v1, v2, v3);
    } else {
      V* o = reinterpret_cast<V*>(out) + 2 * static_cast<int64_t>(q);
      o[0] = make_double2(v0, v1);
      o[1] = make_double2(v2, v3);
    }
  }
}

// The pack of the taps routes of the (nch, table) stack `vals` (one table:
// nch = 1): cell q = (i, r) of table c's (d0-3, rest) cells, rest = d1 *
// ... * dN-1, holds axis 0's four taps (i + a, r), a = 0..3, side by side,
// table c's cells after table c-1's. Entry (i, r) of table c is at c *
// table + q. The whole pack holds fewer than 2^31 values. Each thread
// stores one 16-byte vector of the pack (a cell of f32, half a cell of
// f64), so a warp's store is one contiguous run of 512 bytes. Plain
// version: `ops/fused.py::plain_cubic_pack` (`plain_cubic_stack_pack`).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    cubic_pack_kernel(const T* __restrict__ vals, T* __restrict__ out, int cells, int rest,
                      int64_t table, int nch) {
  using V = typename Vec16<T>::type;
  constexpr int kPer = 16 / sizeof(T);  // taps a vector
  const int64_t vecs = static_cast<int64_t>(cells) * nch * (4 / kPer);
  const int64_t nthreads = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t v = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; v < vecs;
       v += nthreads) {
    const int cq = static_cast<int>(v / (4 / kPer));  // the cell of the whole pack
    const int c = cq / cells;
    const T* p = vals + c * table + (cq - c * cells) +
                 static_cast<int64_t>(v % (4 / kPer)) * kPer * rest;
    if constexpr (sizeof(T) == 4) {
      reinterpret_cast<V*>(out)[v] =
          make_float4(__ldg(p), __ldg(p + rest), __ldg(p + 2 * rest), __ldg(p + 3 * rest));
    } else {
      reinterpret_cast<V*>(out)[v] = make_double2(__ldg(p), __ldg(p + rest));
    }
  }
}

// The layout of the kInterleaved route: entry e of table c of the (nch,
// table) stack lands at out[e * nch + c], a corner's channels side by side.
// Each thread gathers one 16-byte vector of the copy from the tables and
// stores it whole (the ragged end value by value), so a warp's store is one
// contiguous run of 512 bytes and its loads of one slot touch a few runs of
// consecutive entries. `out` is 16-byte aligned. Plain version:
// `ops/fused.py::plain_interleave`.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    interleave_kernel(const T* __restrict__ vals, T* __restrict__ out, int64_t table, int nch) {
  using V = typename Vec16<T>::type;
  constexpr int kPer = 16 / sizeof(T);
  const int64_t total = table * nch;
  const int64_t vecs = (total + kPer - 1) / kPer;
  const int64_t nthreads = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t q = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; q < vecs;
       q += nthreads) {
    const int64_t f = q * kPer;  // the vector's first entry of the copy
    int64_t e = f / nch;
    int c = static_cast<int>(f - e * nch);
    T v[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      v[j] = f + j < total ? __ldg(vals + c * table + e) : T(0);
      if (++c == nch) {
        c = 0;
        ++e;
      }
    }
    if (f + kPer <= total) {
      if constexpr (sizeof(T) == 4) {
        reinterpret_cast<V*>(out)[q] = make_float4(v[0], v[1], v[2], v[3]);
      } else {
        reinterpret_cast<V*>(out)[q] = make_double2(v[0], v[1]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        if (f + j < total) out[f + j] = v[j];
      }
    }
  }
}

// --- launching ----------------------------------------------------------------------

template <typename T>
struct PackKey {};
template <typename T>
struct CubicPackKey {};
template <typename T>
struct InterleaveKey {};

// Launches the pack of the quads route on `stream`: `out` receives the
// (d0-1) pairs of a 1-D table, or the (d0-1)(d1-1) prod(d2..) quads.
template <typename T>
cudaError_t launch_pack(int ndims, const int* dims, const T* vals, T* out, cudaStream_t stream) {
  const bool pairs = ndims == 1;
  int rest = 1;
  for (int k = 2; k < ndims; ++k) rest *= dims[k];
  const int cells = pairs ? dims[0] - 1 : (dims[0] - 1) * (dims[1] - 1) * rest;
  const auto kernel = pack_kernel<T>;
  int blocks = 0;
  const cudaError_t err =
      grid_blocks(occupancy_cache<PackKey<T>>(), kernel, kThreads, 0, cells, &blocks);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, kThreads, 0, stream>>>(vals, out, cells, pairs ? 0 : dims[1], rest);
  return cudaGetLastError();
}

// Launches the pack of the taps routes on `stream`: `out` receives the
// (d0-3) prod(d1..) cells of 4 values of each of the nch tables of the
// (nch, table) stack `vals`, table after table (one table: nch = 1).
template <typename T>
cudaError_t launch_cubic_pack(int ndims, const int* dims, const T* vals, T* out,
                              int64_t table, int nch, cudaStream_t stream) {
  int rest = 1;
  for (int k = 1; k < ndims; ++k) rest *= dims[k];
  const int cells = (dims[0] - 3) * rest;
  const auto kernel = cubic_pack_kernel<T>;
  int blocks = 0;
  const cudaError_t err = grid_blocks(occupancy_cache<CubicPackKey<T>>(), kernel, kThreads, 0,
                                      static_cast<int64_t>(cells) * nch * sizeof(T) / 4, &blocks);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, kThreads, 0, stream>>>(vals, out, cells, rest, table, nch);
  return cudaGetLastError();
}

// Launches the layout of the interleaved route on `stream`: `out` (16-byte
// aligned) receives the (nch, table) stack `vals` as (table, nch).
template <typename T>
cudaError_t launch_interleave(const T* vals, T* out, int64_t table, int nch,
                              cudaStream_t stream) {
  if (reinterpret_cast<uintptr_t>(out) % 16 != 0) return cudaErrorInvalidValue;
  const auto kernel = interleave_kernel<T>;
  const int64_t vecs = (table * nch + 16 / sizeof(T) - 1) / (16 / sizeof(T));
  int blocks = 0;
  const cudaError_t err =
      grid_blocks(occupancy_cache<InterleaveKey<T>>(), kernel, kThreads, 0, vecs, &blocks);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, kThreads, 0, stream>>>(vals, out, table, nch);
  return cudaGetLastError();
}

// Launches the layout that `route` reads into `work` on `stream`: the cubic
// pack (taps routes) of one table or of each table of the stack `vals`, the
// pack (quads) of one table, the interleave (interleaved) of the stack;
// nothing on the other routes. Only the layout kernels that the family F
// serves (F::served) are instantiated, so that each source builds those it
// launches and no other.
template <typename F, bool kStack>
cudaError_t launch_layout(int route, int is_f64, int ndims, const int* dims, const void* vals,
                          void* work, int64_t table, int nch, cudaStream_t stream) {
  constexpr bool kTapsServed = F::served(kTaps, kCubic, kStack, 2) ||
                               F::served(kTapLanes, kCubic, kStack, 3);
  if constexpr (kTapsServed) {
    if (taps(route)) {
      return is_f64 ? launch_cubic_pack(ndims, dims, static_cast<const double*>(vals),
                                        static_cast<double*>(work), table, nch, stream)
                    : launch_cubic_pack(ndims, dims, static_cast<const float*>(vals),
                                        static_cast<float*>(work), table, nch, stream);
    }
  }
  if constexpr (F::served(kQuads, kLinear, kStack, 2)) {
    if (route == kQuads) {
      return is_f64 ? launch_pack(ndims, dims, static_cast<const double*>(vals),
                                  static_cast<double*>(work), stream)
                    : launch_pack(ndims, dims, static_cast<const float*>(vals),
                                  static_cast<float*>(work), stream);
    }
  }
  constexpr bool kInterleaveServed =
      F::served(kInterleaved, kLinear, kStack, 2) || F::served(kInterleaved, kCubic, kStack, 2);
  if constexpr (kInterleaveServed) {
    if (route == kInterleaved) {
      return is_f64 ? launch_interleave(static_cast<const double*>(vals),
                                        static_cast<double*>(work), table, nch, stream)
                    : launch_interleave(static_cast<const float*>(vals),
                                        static_cast<float*>(work), table, nch, stream);
    }
  }
  return cudaSuccess;
}

// What every launch of one call shares.
struct RegularLaunch {
  GridArgs grid;
  const void* const* obs;
  const void* starts;
  const void* steps;
  const void* vals;  // the table, its interleaved stack or its packed copy
  int64_t table;     // entries of one table
  int nch;
  void* out;
  int64_t n;
  bool lin;
  cudaStream_t stream;
};

template <typename T, int NDIMS, int METHOD, bool kStack, int ROUTE>
struct Regular {
  static cudaError_t launch(const RegularLaunch& a) {
    const auto kernel = regular_kernel<T, NDIMS, METHOD, kStack, ROUTE>;
    constexpr int threads = threads_of<ROUTE>();
    constexpr size_t reserve = reserve_of<ROUTE>();
    constexpr bool kShared = ROUTE == kStaged || ROUTE == kStagedGroups;
    const int groups = ROUTE == kStagedGroups ? table_groups<T>(a.table, a.nch) : 1;
    if (groups < 1) return cudaErrorInvalidValue;  // a table above the group cap
    // the largest staged group and its offset from a 16-byte boundary
    const int most = (a.nch + groups - 1) / groups;
    const size_t smem = kShared ? a.table * most * sizeof(T) + 16 : 0;
    if (smem > reserve) return cudaErrorInvalidValue;  // above the staging cap
    int blocks = 0;
    const cudaError_t err = grid_blocks(occupancy_cache<Regular>(), kernel, threads, reserve,
                                        a.n * group_of(ROUTE), &blocks, groups, a.nch);
    if (err != cudaSuccess) return err;
    ObsPtrs<T> ptrs{};
    for (int k = 0; k < NDIMS; ++k) ptrs.p[k] = static_cast<const T*>(a.obs[k]);
    kernel<<<blocks, threads, smem, a.stream>>>(
        a.grid, ptrs, static_cast<const T*>(a.starts), static_cast<const T*>(a.steps),
        static_cast<const T*>(a.vals), a.table, a.nch, groups, static_cast<T*>(a.out), a.n, a.lin);
    return cudaGetLastError();
  }

  static cudaError_t info(int* out) {
    return kernel_info(occupancy_cache<Regular>(),
                       regular_kernel<T, NDIMS, METHOD, kStack, ROUTE>, threads_of<ROUTE>(),
                       reserve_of<ROUTE>(), out);
  }
};

// The regular family for `visit`: which instantiations exist, and their
// launcher.
struct RegularFamily {
  static constexpr bool served(int route, int method, bool stack, int ndims) {
    return serves(route, method, stack, ndims);
  }
  template <typename T, int NDIMS, int METHOD, bool kStack, int ROUTE>
  using Kernel = Regular<T, NDIMS, METHOD, kStack, ROUTE>;
};

// Calls op.template run<F::Kernel<...>>() for the instantiation of the
// family F (RegularFamily, rectilinear.cuh's RectFamily) for (dtype,
// method, ndims, route); cudaErrorInvalidValue for a combination that has
// none (`F::served`).
template <typename F, bool kStack, int ROUTE, typename T, int METHOD, int NDIMS, typename Op>
cudaError_t run_served(Op& op) {
  if constexpr (F::served(ROUTE, METHOD, kStack, NDIMS)) {
    return op.template run<typename F::template Kernel<T, NDIMS, METHOD, kStack, ROUTE>>();
  } else {
    return cudaErrorInvalidValue;
  }
}

template <typename F, bool kStack, int ROUTE, typename T, int METHOD, typename Op>
cudaError_t visit_ndims(int ndims, Op& op) {
  switch (ndims) {
    case 1: return run_served<F, kStack, ROUTE, T, METHOD, 1>(op);
    case 2: return run_served<F, kStack, ROUTE, T, METHOD, 2>(op);
    case 3: return run_served<F, kStack, ROUTE, T, METHOD, 3>(op);
    case 4: return run_served<F, kStack, ROUTE, T, METHOD, 4>(op);
    case 5: return run_served<F, kStack, ROUTE, T, METHOD, 5>(op);
    case 6: return run_served<F, kStack, ROUTE, T, METHOD, 6>(op);
    case 7: return run_served<F, kStack, ROUTE, T, METHOD, 7>(op);
    case 8: return run_served<F, kStack, ROUTE, T, METHOD, 8>(op);
    default: return cudaErrorInvalidValue;
  }
}

template <typename F, bool kStack, int ROUTE, typename T, typename Op>
cudaError_t visit_method(int method, int ndims, Op& op) {
  switch (method) {
    case kLinear: return visit_ndims<F, kStack, ROUTE, T, kLinear>(ndims, op);
    case kCubic: return visit_ndims<F, kStack, ROUTE, T, kCubic>(ndims, op);
    case kNearest: return visit_ndims<F, kStack, ROUTE, T, kNearest>(ndims, op);
    default: return cudaErrorInvalidValue;
  }
}

template <typename F, bool kStack, typename T, typename Op>
cudaError_t visit_route(int route, int method, int ndims, Op& op) {
  switch (route) {
    case kDirect: return visit_method<F, kStack, kDirect, T>(method, ndims, op);
    case kStaged: return visit_method<F, kStack, kStaged, T>(method, ndims, op);
    case kQuads: return visit_method<F, kStack, kQuads, T>(method, ndims, op);
    case kInterleaved: return visit_method<F, kStack, kInterleaved, T>(method, ndims, op);
    case kTaps: return visit_method<F, kStack, kTaps, T>(method, ndims, op);
    case kTapLanes: return visit_method<F, kStack, kTapLanes, T>(method, ndims, op);
    case kStagedTables: return visit_method<F, kStack, kStagedTables, T>(method, ndims, op);
    case kStagedGroups: return visit_method<F, kStack, kStagedGroups, T>(method, ndims, op);
    case kGuided: return visit_method<F, kStack, kGuided, T>(method, ndims, op);
    default: return cudaErrorInvalidValue;
  }
}

template <typename F, bool kStack, typename Op>
cudaError_t visit(int is_f64, int route, int method, int ndims, Op& op) {
  if (ndims < 1 || ndims > kMaxDims) return cudaErrorInvalidValue;
  return is_f64 ? visit_route<F, kStack, double>(route, method, ndims, op)
                : visit_route<F, kStack, float>(route, method, ndims, op);
}

struct LaunchOp {
  const RegularLaunch& a;
  template <typename R>
  cudaError_t run() {
    return R::launch(a);
  }
};

struct InfoOp {
  int* out;
  template <typename R>
  cudaError_t run() {
    return R::info(out);
  }
};

// The body of the sources' C entry points (see fused_regular.cu).
template <bool kStack>
int regular_entry(int method, int linearize, int is_f64, int ndims, const int* dims,
                  const void* starts, const void* steps, void* work, const void* vals,
                  const void* const* obs, void* out, long long n, int nch, int route,
                  void* stream) {
  const bool relaid = route == kQuads || route == kInterleaved || taps(route);
  if (ndims < 1 || ndims > kMaxDims || n <= 0 || nch <= 0 || (!kStack && nch != 1) ||
      method < kLinear || method > kNearest || !serves(route, method, kStack, ndims) ||
      (relaid && work == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  RegularLaunch a{};
  // strides of the layout read: the table's in entries (times nch for an
  // interleaved stack; another stack's tables lie one after another); a
  // packed copy's in cells, over (d0-1, d1-1, d2, ...) for quads and
  // (d0-3, d1, ...) for taps (a stack's packs one after another)
  int acc = route == kInterleaved ? nch : 1;
  int64_t table = 1;
  for (int k = ndims - 1; k >= 0; --k) {
    a.grid.dim[k] = dims[k];
    a.grid.stride[k] = acc;
    if (route == kQuads && k < 2 && ndims > 1) {
      acc *= dims[k] - 1;
    } else {
      acc *= taps(route) && k == 0 ? dims[k] - 3 : dims[k];
    }
    table *= dims[k];
  }
  a.stream = static_cast<cudaStream_t>(stream);
  a.vals = relaid ? work : vals;
  const cudaError_t err = launch_layout<RegularFamily, kStack>(route, is_f64, ndims, dims, vals,
                                                               work, table, nch, a.stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  a.obs = obs;
  a.starts = starts;
  a.steps = steps;
  // entries of one table of the layout read: a stack's pack holds 4 a cell
  a.table = kStack && taps(route) ? 4 * static_cast<int64_t>(acc) : table;
  a.nch = nch;
  a.out = out;
  a.n = n;
  a.lin = linearize != 0;
  LaunchOp op{a};
  return static_cast<int>(visit<RegularFamily, kStack>(is_f64, route, method, ndims, op));
}

// The body of the sources' info entry points: registers, shared memory,
// spills and resident blocks of one instantiation (see fused_regular.cu).
template <bool kStack>
int regular_info_entry(int method, int is_f64, int ndims, int route, int* out) {
  InfoOp op{out};
  return static_cast<int>(visit<RegularFamily, kStack>(is_f64, route, method, ndims, op));
}

}  // namespace interp
