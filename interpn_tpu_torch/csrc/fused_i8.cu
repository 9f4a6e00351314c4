// K9 for Hopper (sm_90a): the int8 multipass f64 contraction with exact
// int32 sums, 2-8D, linear (footprint 2) and cubic (footprint 4).
//
// Replaces `interpn_tpu/ops/pallas_i8.py::_pallas_i8` (the `pl.pallas_call`
// at :638, kernel `_make_kernel`). Inputs: `locs`, `wh`, `wl` as K8's
// (`fused_df64.cu`); the table decomposed once on the host
// (`ops/i8.py::prepare`): 8 int8 pieces per cell, cell-major (prod(dims), 8),
// and per row of the (lead, k) table view (the leading M = ndims - G axes by
// the trailing G) its centre hi/lo and its power-of-two scale. Output: the
// hi/lo pair of the result less the global centre, which the caller adds
// back in float64.
//
// What it computes, per query, in `ops/i8.py::plain_i8`'s order:
// 1. the trailing G axes' combined stencil weights in double-float, right to
//    left (`_combined_weights_df`), their peak, f = ceil(log2(peak)) from the
//    float bits, and 7 int8 pieces per weight by round-half-even with the
//    exact two_sum residual (`_quantize_weights`);
// 2. per stencil row of the leading axes: the 35 piece-pair products
//    (i + j <= 7) over the row's FP^G stencil cells in exact int32, grouped
//    by level s = i + j; the groups recombined in ascending s (exact 12-bit
//    split for s <= 5, direct conversion above); the row and query scales
//    restored; the row centre added through S_w, the double-float product of
//    the trailing axes' weight sums; two_sum;
// 3. the leading axes reduced innermost first with df_mul then df_add.
// The TPU contracts 35 int8 MXU passes over the whole 128-padded table;
// every off-stencil weight there is 0 (pieces 0) and adds nothing to the
// exact int32 sums, so reading only the stencil gives the same integers.
//
// Design: one thread per query. The weight pieces of the FP^G stencil
// entries are packed 7 bytes to a uint2 (registers when FP^G <= 16, local
// memory above), each stencil cell's 8 pieces come in one 8-byte load, and
// the 35 products are scalar int32 multiply-adds (tensor-core `mma.sync`
// over int8 is later work).
//
// What holds it on this card: the scalar int32 multiply-adds, 35 per stencil
// cell and query (2,240 for cubic 3D, G = 2), with the byte unpacks, plus
// about 130 float32 operations per weight entry and per row for the
// quantization and the double-float recombination. At the int8 tensor-core
// rate the products cost next to nothing, and cubic 3D's least time is set
// by its bytes (`chip_smoke.py::engine_operations`).

#include <cstdint>

#include "df64.cuh"
#include "interp_common.cuh"

namespace interp {

constexpr int kPiecesV = 8;
constexpr int kPiecesW = 7;
constexpr int kMaxLevel = 7;  // keep piece pairs with i + j <= 7
constexpr int kMaxEntries = 2048;  // FP^G <= k <= 2048 (`_choose_group`, G > 1)

constexpr int ipow(int b, int e) { return e == 0 ? 1 : b * ipow(b, e - 1); }

struct I8Args {
  const int* __restrict__ locs;        // (ndims, n)
  const float* __restrict__ wh;        // (ndims * FP, n)
  const float* __restrict__ wl;
  const uint2* __restrict__ pieces;    // (prod(dims),) cells of 8 int8 pieces
  const float* __restrict__ ch;        // (lead,) row centres, hi
  const float* __restrict__ cl;        // lo
  const float* __restrict__ sv;        // (lead,) row scales
  int stride[kMaxDims];
  int64_t n;
};

// Signed byte k of x.
__device__ __forceinline__ int sbyte(unsigned x, int k) {
  return static_cast<int>(x << (24 - 8 * k)) >> 24;
}

// 2^f for f in [-126, 127], exactly.
__device__ __forceinline__ float pow2(int f) { return __int_as_float((f + 127) << 23); }

template <int NDIMS, int FP, int G>
struct I8Query {
  static constexpr int M = NDIMS - G;
  static constexpr int E = ipow(FP, G);
  float w_h[NDIMS * FP], w_l[NDIMS * FP];
  uint2 bq[E];  // weight pieces of each trailing stencil entry, bytes 0-6
  float fq;     // the query's power-of-two weight scale
  float swh, swl;
  int trail;    // table offset of the trailing stencil's first cell
};

// Combined trailing weight of stencil entry e (C order, last axis fastest):
// w_last, then times each axis's weight right to left.
template <int NDIMS, int FP, int G>
__device__ __forceinline__ void combined_weight(const I8Query<NDIMS, FP, G>& q, int e, float& h,
                                                float& l) {
  constexpr int M = NDIMS - G;
  int d = e % FP;
  h = pick<float, FP>(q.w_h + (NDIMS - 1) * FP, d);
  l = pick<float, FP>(q.w_l + (NDIMS - 1) * FP, d);
#pragma unroll
  for (int a = NDIMS - 2; a >= M; --a) {
    e /= FP;
    d = e % FP;
    df_mul(pick<float, FP>(q.w_h + a * FP, d), pick<float, FP>(q.w_l + a * FP, d), h, l, h, l);
  }
}

// Table offset of trailing stencil entry e from the trailing stencil's
// first cell.
template <int NDIMS, int FP, int G>
__device__ __forceinline__ int entry_offset(const I8Args& a, int e) {
  int off = 0;
#pragma unroll
  for (int ax = NDIMS - 1; ax >= NDIMS - G; --ax) {
    off += (e % FP) * a.stride[ax];
    e /= FP;
  }
  return off;
}

// One stencil row of the leading axes (its first cell at `row`): the value
// restored in double-float, centre included (`_make_kernel` up to the tails).
template <int NDIMS, int FP, int G>
__device__ __forceinline__ void row_value(const I8Args& a, const I8Query<NDIMS, FP, G>& q,
                                          int row, float& h, float& l) {
  constexpr int E = I8Query<NDIMS, FP, G>::E;
  constexpr int kUnrollE = E <= 16 ? E : 1;
  int acc[kMaxLevel + 1];
#pragma unroll
  for (int s = 0; s <= kMaxLevel; ++s) acc[s] = 0;
#pragma unroll kUnrollE
  for (int e = 0; e < E; ++e) {
    const uint2 av = __ldg(a.pieces + row + q.trail + entry_offset<NDIMS, FP, G>(a, e));
    const uint2 bv = q.bq[e];
    int ai[kPiecesV], bj[kPiecesW];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      ai[k] = sbyte(av.x, k);
      ai[4 + k] = sbyte(av.y, k);
      bj[k] = sbyte(bv.x, k);
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) bj[4 + k] = sbyte(bv.y, k);
#pragma unroll
    for (int i = 0; i < kPiecesV; ++i) {
#pragma unroll
      for (int j = 0; j < kPiecesW; ++j) {
        if (i + j <= kMaxLevel) acc[i + j] += ai[i] * bj[j];
      }
    }
  }
  float th = 0.0f, tl = 0.0f;
#pragma unroll
  for (int s = 0; s <= kMaxLevel; ++s) {
    const float lvl = pow2(-(12 + 7 * s));
    if (s <= 5) {
      const int lo_i = acc[s] % 4096;  // truncates toward zero, as lax.rem
      const int hi_i = (acc[s] - lo_i) / 4096;
      df_add(th, tl, fmul(fmul(static_cast<float>(hi_i), 4096.0f), lvl),
             fmul(static_cast<float>(lo_i), lvl), th, tl);
    } else {
      df_add(th, tl, fmul(static_cast<float>(acc[s]), lvl), 0.0f, th, tl);
    }
  }
  const int r = row / a.stride[NDIMS - G - 1];  // row of the (lead, k) view
  const float sv = __ldg(a.sv + r);
  th = fmul(fmul(th, sv), q.fq);
  tl = fmul(fmul(tl, sv), q.fq);
  float ph, pl;
  df_mul(__ldg(a.ch + r), __ldg(a.cl + r), q.swh, q.swl, ph, pl);
  df_add(th, tl, ph, pl, th, tl);
  two_sum(th, tl, h, l);
}

// The leading axes A..M-1 reduced at `row` (axes 0..A-1 fixed): sum over b
// of df_mul(partial, w_A[b]) by df_add, innermost axis first.
template <int NDIMS, int FP, int G, int A>
struct I8Tail {
  static __device__ __forceinline__ void eval(const I8Args& a, const I8Query<NDIMS, FP, G>& q,
                                              int row, float& h, float& l) {
    float sh = 0.0f, sl = 0.0f;
    const int s = a.stride[A];
#pragma unroll 1
    for (int b = 0; b < FP; ++b) {
      float gh, gl;
      if constexpr (A == NDIMS - G - 1) {
        row_value<NDIMS, FP, G>(a, q, row + b * s, gh, gl);
      } else {
        I8Tail<NDIMS, FP, G, A + 1>::eval(a, q, row + b * s, gh, gl);
      }
      float ph, pl;
      df_mul(gh, gl, pick<float, FP>(q.w_h + A * FP, b), pick<float, FP>(q.w_l + A * FP, b), ph,
             pl);
      df_add(sh, sl, ph, pl, sh, sl);
    }
    h = sh;
    l = sl;
  }
};

template <int NDIMS, int FP, int G>
__global__ void __launch_bounds__(kThreads)
    i8_kernel(I8Args a, float* __restrict__ oh, float* __restrict__ ol) {
  constexpr int M = NDIMS - G;
  constexpr int E = I8Query<NDIMS, FP, G>::E;
  constexpr int kUnrollE = E <= 16 ? E : 1;
  const int64_t nthreads = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < a.n;
       i += nthreads) {
    I8Query<NDIMS, FP, G> q;
    int row = 0;
    q.trail = 0;
#pragma unroll
    for (int k = 0; k < NDIMS; ++k) {
      const int off = __ldg(a.locs + k * a.n + i) * a.stride[k];
      if (k < M) {
        row += off;
      } else {
        q.trail += off;
      }
#pragma unroll
      for (int j = 0; j < FP; ++j) {
        const int64_t w = static_cast<int64_t>(k * FP + j) * a.n + i;
        q.w_h[k * FP + j] = __ldg(a.wh + w);
        q.w_l[k * FP + j] = __ldg(a.wl + w);
      }
    }
    // the weight peak (NaN propagates), then f = ceil(log2(max(peak, 1e-30)))
    float peak = 0.0f;
#pragma unroll kUnrollE
    for (int e = 0; e < E; ++e) {
      float h, l;
      combined_weight<NDIMS, FP, G>(q, e, h, l);
      const float m = fabsf(h);
      peak = (m > peak || m != m) && peak == peak ? m : peak;
    }
    peak = peak == peak ? fmaxf(peak, 1e-30f) : peak;
    float inv;
    if (isfinite(peak)) {
      const int bits = __float_as_int(peak);
      const int f = ((bits >> 23) & 0xFF) - 126 - ((bits & 0x7FFFFF) == 0);
      q.fq = pow2(f);
      inv = pow2(-f);
    } else {
      q.fq = peak;
      inv = peak != peak ? peak : 0.0f;
    }
    // the 7 pieces of each combined weight
#pragma unroll kUnrollE
    for (int e = 0; e < E; ++e) {
      float rh, rl;
      combined_weight<NDIMS, FP, G>(q, e, rh, rl);
      rh = fmul(rh, inv);
      rl = fmul(rl, inv);
      unsigned packed[2] = {0u, 0u};
#pragma unroll
      for (int j = 0; j < kPiecesW; ++j) {
        const float qj = rintf(fmul(rh, pow2(6 + 7 * j)));  // half to even
        const int piece = isfinite(qj) ? static_cast<int>(qj) : 0;
        packed[j / 4] |= (static_cast<unsigned>(piece) & 0xFFu) << (8 * (j % 4));
        rh = fsub(rh, fmul(qj, pow2(-(6 + 7 * j))));
        two_sum(rh, rl, rh, rl);
      }
      q.bq[e] = make_uint2(packed[0], packed[1]);
    }
    // S_w: the product over the trailing axes of each axis's weight sum
#pragma unroll
    for (int ax = M; ax < NDIMS; ++ax) {
      float axh = q.w_h[ax * FP], axl = q.w_l[ax * FP];
#pragma unroll
      for (int b = 1; b < FP; ++b) df_add(axh, axl, q.w_h[ax * FP + b], q.w_l[ax * FP + b], axh, axl);
      if (ax == M) {
        q.swh = axh;
        q.swl = axl;
      } else {
        df_mul(q.swh, q.swl, axh, axl, q.swh, q.swl);
      }
    }
    float h, l;
    I8Tail<NDIMS, FP, G, 0>::eval(a, q, row, h, l);
    oh[i] = h;
    ol[i] = l;
  }
}

template <int NDIMS, int FP, int G>
cudaError_t i8_group(int group, const I8Args& a, float* oh, float* ol, int blocks,
                     cudaStream_t stream) {
  if constexpr (G >= NDIMS) {
    return cudaErrorInvalidValue;
  } else {
    if (group != G) return i8_group<NDIMS, FP, G + 1>(group, a, oh, ol, blocks, stream);
    if constexpr (ipow(FP, G) > kMaxEntries) {
      return cudaErrorInvalidValue;
    } else {
      i8_kernel<NDIMS, FP, G><<<blocks, kThreads, 0, stream>>>(a, oh, ol);
      return cudaGetLastError();
    }
  }
}

template <int FP>
cudaError_t i8_ndims(int ndims, int group, const I8Args& a, float* oh, float* ol, int blocks,
                     cudaStream_t stream) {
  switch (ndims) {
    case 2: return i8_group<2, FP, 1>(group, a, oh, ol, blocks, stream);
    case 3: return i8_group<3, FP, 1>(group, a, oh, ol, blocks, stream);
    case 4: return i8_group<4, FP, 1>(group, a, oh, ol, blocks, stream);
    case 5: return i8_group<5, FP, 1>(group, a, oh, ol, blocks, stream);
    case 6: return i8_group<6, FP, 1>(group, a, oh, ol, blocks, stream);
    case 7: return i8_group<7, FP, 1>(group, a, oh, ol, blocks, stream);
    case 8: return i8_group<8, FP, 1>(group, a, oh, ol, blocks, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace interp

// Launches K9 on `stream` without synchronising and returns
// cudaGetLastError() (0 on success). `dims` is a host array of `ndims`
// entries; the other pointers are device arrays as described above. The
// caller guarantees 2 <= ndims <= 8, footprint 2 or 4, 1 <= group < ndims
// (`ops/i8.py::_choose_group`), every dim >= footprint, 0 <= locs[k] <=
// dims[k] - footprint, prod(dims) < 2^31 and 0 < n < 2^31.
extern "C" int interpn_i8(int footprint, int group, int ndims, const int* dims,
                          const void* locs, const void* wh, const void* wl, const void* pieces,
                          const void* ch, const void* cl, const void* sv, void* oh, void* ol,
                          long long n, int blocks, void* stream) {
  using namespace interp;
  if (ndims < 2 || ndims > kMaxDims || group < 1 || group >= ndims || n <= 0 || blocks <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  I8Args a{};
  a.locs = static_cast<const int*>(locs);
  a.wh = static_cast<const float*>(wh);
  a.wl = static_cast<const float*>(wl);
  a.pieces = static_cast<const uint2*>(pieces);
  a.ch = static_cast<const float*>(ch);
  a.cl = static_cast<const float*>(cl);
  a.sv = static_cast<const float*>(sv);
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
    case 2: err = i8_ndims<2>(ndims, group, a, h, l, blocks, s); break;
    case 4: err = i8_ndims<4>(ndims, group, a, h, l, blocks, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
