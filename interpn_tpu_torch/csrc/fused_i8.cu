// K9 for Hopper (sm_90a): the int8 multipass f64 evaluation with exact
// int32 sums, 2-8D, linear (footprint 2) and cubic (footprint 4) on regular
// and rectilinear grids.
//
// Replaces `interpn_tpu/ops/pallas_i8.py::_pallas_i8` (the `pl.pallas_call`
// at :638, kernel `_make_kernel`) and the float64 weight build before it.
// Inputs: the queries and the grid (starts and steps, or the axes), and the
// table decomposed once on the host (`ops/i8.py::prepare`): 8 int8 pieces
// per cell, cell-major (prod(dims), 8), and per row of the (lead, k) table
// view (the leading M = ndims - G axes by the trailing G) its centre hi/lo
// and its power-of-two scale, and the global centre c0. Output: the float64
// result, `(hi + lo) + c0 * wsum` as `ops/i8.py` forms it.
//
// What it computes, per query, in `ops/i8.py`'s plain chain's order:
// 1. per axis the locate, the float64 weights, their hi/lo split, and wsum
//    (engine_weights.cuh, `weights_f64`);
// 2. the trailing G axes' combined stencil weights in double-float, right to
//    left (`_combined_weights_df`), their peak, f = ceil(log2(peak)) from the
//    float bits, and 7 int8 pieces per weight by round-half-even with the
//    exact two_sum residual (`_quantize_weights`);
// 3. per stencil row of the leading axes: acc[s] = sum over the E = FP^G
//    trailing stencil cells e and the piece pairs i + j = s <= 7 of
//    A_i[row, e] * B_j[e], exact in int32; the levels recombined in
//    ascending s (exact 12-bit split for s <= 5, direct conversion above);
//    the row and query scales restored; the row centre added through S_w,
//    the double-float product of the trailing axes' weight sums; two_sum;
// 4. the leading axes reduced innermost first with df_mul then df_add;
// 5. (hi + lo) + c0 * wsum in float64.
// The TPU contracts 35 int8 MXU passes over the whole 128-padded table;
// every off-stencil weight there is 0 (pieces 0) and adds nothing to the
// exact int32 sums, so reading only the stencil gives the same integers.
//
// Design. Step 3's products run on the int8 tensor cores: for a chunk of
// RC <= 16 rows (the innermost leading axes) they are one GEMM
//     acc[r][s] = sum over k = (e, i) of A[r][k] * B'[k][s],
//     B'[(e, i)][s] = B_{s - i}[e]   (0 where s - i is not a piece),
// M = the rows (one 16-row tile), N = the 8 levels, K = 8 E in steps of 32
// (four cells): `mma.sync.m16n8k32.s32.s8.s8.s32`. Ordering K by cell
// makes the cached cell-major pieces fragment-ready as they are: lane t of
// a quad holds cell 4 k + t of its two rows, pieces 0-3 in one A register
// and 4-7 in another, from one 8-byte load, and the quad's loads cover the
// four cells' 32 bytes. Putting the anti-diagonal into B' makes each
// accumulator one level, so no piece pair above level 7 is formed and
// nothing is summed after the MMA. The integer sums are exact in any order
// (|acc| <= 2048 * 8 * 2^14 < 2^31), so the result is the plain version's
// bit for bit. `wgmma` is not used: one query's GEMM is a single 16-row
// tile, far below its 64-row minimum.
// The mma route (32 or more trailing entries: cubic 12^5 has 64) runs the
// scalar work where it fills the warp. A warp holds 32 queries; each
// thread builds its query's weights and S_w and runs its tails; the warp
// takes each query in turn: its lanes quantize its entries (one a lane, in
// passes of 32; each weight's 7 pieces reversed in a 64-bit word, from
// which a lane shifts out its B' window), the GEMM keeps the accumulators
// in registers across the passes, and lanes recombine its rows (one a
// lane). So shared memory holds 32 entries a warp and a row value a row,
// and nothing per stencil entry lives in local memory. Shapes with more
// than 16 leading rows quantize a query again for each row chunk (none of
// the bench shapes). Staging every query's entries in shared memory instead
// ran cubic 12^5 12% slower (2.6622 against 2.3766 ms: one block of four
// warps an SM).
// The dp4a route (16 or fewer trailing entries, `ops/fused.py::i8_route`;
// linear 3D has 4, cubic 3D 16) runs one query a thread with no shared
// memory: its E B' words in registers, and per stencil row the 8 levels by
// `__dp4a` (four piece products summed in int32) on the same
// fragment-ready words, 12 an entry (no piece pair of level <= 3 involves
// pieces 4-7). The integers are the MMA's, so the route changes no bit. At
// 1e6 queries on an H100 it ran linear 20^3 in 0.0565 ms against 0.1000
// on MMAs fed from each query's entries staged in shared memory (a row
// chunk filling an eighth of the tile), cubic 20^3 in 0.2328 against
// 0.2991 (a quarter); linear 6^7 (G = 4), the one shape measured where the
// MMAs won, took 0.6362 against 0.5209 (PERF.md).

#include <cstdint>

#include "df64.cuh"
#include "engine_weights.cuh"
#include "interp_common.cuh"

namespace interp {

constexpr int kPiecesW = 7;
constexpr int kMaxLevel = 7;  // keep piece pairs with i + j <= 7
constexpr int kMaxEntries = 2048;  // FP^G <= k <= 2048 (`_choose_group`, G > 1)
constexpr int kWarps = 4;  // warps a block
constexpr int kI8Threads = 32 * kWarps;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kMaxDevices = 64;
// routes: ops/fused.py::I8_ROUTES, chosen by the wrapper alone
constexpr int kI8Mma = 0;
constexpr int kI8Dp4a = 1;
// the most trailing entries of the dp4a route (ops/fused.py::DP4A_ENTRIES);
// the mma route takes 32 or more (E is a power of the footprint)
constexpr int kDp4aEntries = 16;
constexpr int kPass = 32;  // entries a quantization pass of the mma route

// The leading axes a row chunk spans: the most whose rows fit one tile.
constexpr int chunk_axes(int fp, int m) {
  return m == 0 || ipow(fp, 1) > 16 ? 0 : (ipow(fp, m) <= 16 ? m : chunk_axes(fp, m - 1));
}

// The shapes of one instantiation; on the mma route, a warp's shared
// memory: the B' words of one pass and each of its 32 queries' chunk row
// values (hi, lo a row, padded).
template <int NDIMS, int FP, int G>
struct I8Shape {
  static constexpr int M = NDIMS - G;             // leading axes
  static constexpr int E = ipow(FP, G);           // trailing stencil entries
  static constexpr int LC = chunk_axes(FP, M);    // leading axes of a row chunk
  static constexpr int RC = ipow(FP, LC);         // rows of a chunk (<= 16)
  static constexpr int PASSES = E / kPass;
  static constexpr int KSTEPS = kPass / 4;        // MMA k-steps of a pass
  static constexpr int U_WORDS = 2 * kPass;
  static constexpr int SLOT_WORDS = 2 * RC + 2;
  static constexpr int WARP_WORDS = U_WORDS + 32 * SLOT_WORDS;
  static constexpr size_t SMEM = sizeof(int) * kWarps * WARP_WORDS;
};

struct I8Args {
  EngineGrid grid;
  EngineObs obs;
  const uint2* __restrict__ pieces;  // (prod(dims),): 8 int8 pieces a cell
  const float* __restrict__ ch;         // (lead,) row centres, hi
  const float* __restrict__ cl;         // lo
  const float* __restrict__ sv;         // (lead,) row scales
  double c0;
  int stride[kMaxDims];
  int lstride[kMaxDims];  // C-order strides of the leading axes' (lead,) row view
  int64_t n;
  bool lin;
};

// 2^f for f in [-126, 127], exactly.
__device__ __forceinline__ float pow2(int f) { return __int_as_float((f + 127) << 23); }

template <int NDIMS, int FP, int G>
struct I8Query {
  float w_h[NDIMS * FP], w_l[NDIMS * FP];
  float fq, inv;  // dp4a route: the query's power-of-two weight scale and its inverse
  float swh, swl;
  int trail;      // table offset of the trailing stencil's first cell
};

// A warp's shared memory and the lane's constants of the MMA fragments.
// In a k-step of 32 K values a lane t holds cell 4 k + t of its rows: its
// first A register pieces 0-3 of the cell, its third pieces 4-7, so one
// 8-byte load a row, and a quad's four lanes read the four cells' 32 bytes
// at once.
struct I8Warp {
  unsigned long long* u;  // the pass's B' words: [kPass]
  int* slots;             // [32 queries][SLOT_WORDS]
  int lane;
  // A: the cells of chunk rows g and g + 8 at entry t, from the chunk's
  // first cell; whether row g exists (row g + 8 where RC > 8 only)
  int acell[2];
  bool a0;
  // B': for pieces 0-3 (window 7 - g) and 4-7 (window 11 - g), the staged
  // word's half the window starts in and the shift (32: past the pieces)
  bool bhigh0;
  int bshift0, bshift1;
  // the (lead, k) view offsets of chunk rows g and g + 8 (the lane
  // recombines row g + 8 t for t < 2)
  int voff[2];
};

// Combined trailing weight of stencil entry e (C order, last axis fastest)
// from the trailing G axes' weights th/tl (axis-major): w_last, then times
// each axis's weight right to left.
template <int FP, int G>
__device__ __forceinline__ void combined_weight(const float* th, const float* tl, int e,
                                                float& h, float& l) {
  int d = e % FP;
  h = pick<float, FP>(th + (G - 1) * FP, d);
  l = pick<float, FP>(tl + (G - 1) * FP, d);
#pragma unroll
  for (int a = G - 2; a >= 0; --a) {
    e /= FP;
    d = e % FP;
    df_mul(pick<float, FP>(th + a * FP, d), pick<float, FP>(tl + a * FP, d), h, l, h, l);
  }
}

// The NaN-propagating maximum of the weights' magnitudes, as `torch.amax`.
__device__ __forceinline__ float peak_of(float peak, float m) {
  return (m > peak || m != m) && peak == peak ? m : peak;
}

// (2^f, 2^-f) with f = ceil(log2(max(peak, 1e-30))) from the float bits
// (`_scales`); (inf, 0) for an infinite peak, NaN for NaN.
__device__ __forceinline__ void scales(float peak, float& fq, float& inv) {
  peak = peak == peak ? fmaxf(peak, 1e-30f) : peak;
  if (isfinite(peak)) {
    const int bits = __float_as_int(peak);
    const int f = ((bits >> 23) & 0xFF) - 126 - ((bits & 0x7FFFFF) == 0);
    fq = pow2(f);
    inv = pow2(-f);
  } else {
    fq = peak;
    inv = peak != peak ? peak : 0.0f;
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

// The 7 pieces of the combined weight of entry e (`_quantize_weights`),
// reversed into bytes 7 .. 1 of a word: piece j at byte 7 - j, bytes 0 and
// above 7 zero, so that byte 7 - s + i holds piece s - i.
__device__ __forceinline__ unsigned long long quantize_df(float rh, float rl, float inv) {
  rh = fmul(rh, inv);
  rl = fmul(rl, inv);
  unsigned long long word = 0;
#pragma unroll
  for (int j = 0; j < kPiecesW; ++j) {
    const float qj = rintf(fmul(rh, pow2(6 + 7 * j)));  // half to even
    const int piece = isfinite(qj) ? static_cast<int>(qj) : 0;
    word |= static_cast<unsigned long long>(static_cast<unsigned>(piece) & 0xFFu) << (8 * (7 - j));
    rh = fsub(rh, fmul(qj, pow2(-(6 + 7 * j))));
    two_sum(rh, rl, rh, rl);
  }
  return word;
}

template <int FP, int G>
__device__ __forceinline__ unsigned long long quantize(const float* th, const float* tl, int e,
                                                       float inv) {
  float rh, rl;
  combined_weight<FP, G>(th, tl, e, rh, rl);
  return quantize_df(rh, rl, inv);
}

__device__ __forceinline__ void mma_s8(int* d, const unsigned* a, unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The 4 bytes of B' column s = g for four pieces of an entry from its
// staged word: bytes window .. window + 3.
__device__ __forceinline__ unsigned b_window(unsigned long long word, bool high, int shift) {
  const unsigned lo = static_cast<unsigned>(word), hi = static_cast<unsigned>(word >> 32);
  return __funnelshift_rc(high ? hi : lo, high ? 0u : hi, shift);
}

// One pass's MMAs of one query into d: `cell` is its chunk's first cell,
// `uq` its pass's B' words offset by the lane's entry t, `kcell` the pass's
// k-steps' cell offsets (the same on every lane).
template <int NDIMS, int FP, int G>
__device__ __forceinline__ void pass_products(const I8Args& a, const I8Warp& w, int cell,
                                              const unsigned long long* uq, const int* kcell,
                                              int* d) {
  using S = I8Shape<NDIMS, FP, G>;
  const uint2* row0 = a.pieces + cell + w.acell[0];
  const uint2* row1 = a.pieces + cell + w.acell[1];
  // every A word of the pass first, so that its loads overlap, then the MMAs
  unsigned ra[S::KSTEPS][4];
#pragma unroll
  for (int k = 0; k < S::KSTEPS; ++k) {
    const uint2 v0 = w.a0 ? __ldg(row0 + kcell[k]) : make_uint2(0u, 0u);
    const uint2 v1 = S::RC > 8 && w.a0 ? __ldg(row1 + kcell[k]) : make_uint2(0u, 0u);
    ra[k][0] = v0.x;
    ra[k][1] = v1.x;
    ra[k][2] = v0.y;
    ra[k][3] = v1.y;
  }
  // two accumulator chains, odd and even k-steps, summed at the end (the
  // integer sums are exact in any order)
  int e[4] = {0, 0, 0, 0};
#pragma unroll
  for (int k = 0; k < S::KSTEPS; ++k) {
    const unsigned long long word = uq[4 * k];
    mma_s8(k % 2 ? e : d, ra[k], b_window(word, w.bhigh0, w.bshift0),
           b_window(word, true, w.bshift1));
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) d[j] += e[j];
}

// The cell offsets of the k-steps of the first pass (entry 4 k; the lane
// adds its entry t in acell). A later pass p adds the offset of entry p
// kPass: kPass is a power of FP above 4 k + t, so no base-FP digit carries.
template <int NDIMS, int FP, int G>
__device__ __forceinline__ void pass_offsets(const I8Args& a, int* kcell) {
  using S = I8Shape<NDIMS, FP, G>;
#pragma unroll
  for (int k = 0; k < S::KSTEPS; ++k) kcell[k] = entry_offset<NDIMS, FP, G>(a, 4 * k);
}

// One stencil row of the leading axes (row r of the (lead, k) table view,
// levels lv): the value restored in double-float, centre included
// (`_make_kernel` up to the tails), with the query's scale fq and S_w.
__device__ __forceinline__ void row_value(const I8Args& a, const int* lv, int r, float fq,
                                          float swh, float swl, float& h, float& l) {
  float th = 0.0f, tl = 0.0f;
#pragma unroll
  for (int s = 0; s <= kMaxLevel; ++s) {
    const float lvl = pow2(-(12 + 7 * s));
    if (s <= 5) {
      const int lo_i = lv[s] % 4096;  // truncates toward zero, as lax.rem
      const int hi_i = (lv[s] - lo_i) / 4096;
      df_add(th, tl, fmul(fmul(static_cast<float>(hi_i), 4096.0f), lvl),
             fmul(static_cast<float>(lo_i), lvl), th, tl);
    } else {
      df_add(th, tl, fmul(static_cast<float>(lv[s]), lvl), 0.0f, th, tl);
    }
  }
  const float sv = __ldg(a.sv + r);
  th = fmul(fmul(th, sv), fq);
  tl = fmul(fmul(tl, sv), fq);
  float ph, pl;
  df_mul(__ldg(a.ch + r), __ldg(a.cl + r), swh, swl, ph, pl);
  df_add(th, tl, ph, pl, th, tl);
  two_sum(th, tl, h, l);
}

// Warp-collective: the values of the RC rows of a chunk for each of the
// warp's 32 queries into their slots: in turn for each query, its
// trailing weights and S_w from its lane, its peak and scales, its pieces
// by passes of 32 entries (one a lane), the MMAs, and its rows recombined
// one a lane. `cell` and `view`: this lane's query's first cell and view
// row of the chunk.
template <int NDIMS, int FP, int G>
__device__ __forceinline__ void chunk_rows(const I8Args& a, const I8Query<NDIMS, FP, G>& q,
                                           const I8Warp& w, int cell, int view) {
  using S = I8Shape<NDIMS, FP, G>;
  const int t = w.lane & 3;
  int kcell[S::KSTEPS];
  pass_offsets<NDIMS, FP, G>(a, kcell);
  __syncwarp();  // the slots' last readers done
#pragma unroll 1
  for (int qq = 0; qq < 32; ++qq) {
    float th[G * FP], tl[G * FP];
#pragma unroll
    for (int j = 0; j < G * FP; ++j) {
      th[j] = __shfl_sync(kFull, q.w_h[S::M * FP + j], qq);
      tl[j] = __shfl_sync(kFull, q.w_l[S::M * FP + j], qq);
    }
    // the lane's entries' combined weights, kept for the quantization where
    // there are few passes, else formed again there
    constexpr int kKept = S::PASSES <= 4 ? S::PASSES : 1;
    float kh[kKept], kl[kKept];
    float peak = 0.0f;
#pragma unroll 4
    for (int p = 0; p < S::PASSES; ++p) {
      float h, l;
      combined_weight<FP, G>(th, tl, p * kPass + w.lane, h, l);
      peak = peak_of(peak, fabsf(h));
      if (S::PASSES <= 4) {
        kh[p % kKept] = h;
        kl[p % kKept] = l;
      }
    }
#pragma unroll
    for (int m = 16; m >= 1; m >>= 1) peak = peak_of(peak, __shfl_xor_sync(kFull, peak, m));
    float fq, inv;
    scales(peak, fq, inv);
    int d[4] = {0, 0, 0, 0};
    const int first = __shfl_sync(kFull, cell, qq);
    const auto pass_of = [&](int pass, unsigned long long word) {
      w.u[w.lane] = word;
      __syncwarp();
      pass_products<NDIMS, FP, G>(a, w, first + entry_offset<NDIMS, FP, G>(a, pass * kPass),
                                  w.u + t, kcell, d);
      __syncwarp();
    };
    if constexpr (S::PASSES <= 4) {
#pragma unroll
      for (int pass = 0; pass < S::PASSES; ++pass) pass_of(pass, quantize_df(kh[pass], kl[pass], inv));
    } else {
#pragma unroll 1
      for (int pass = 0; pass < S::PASSES; ++pass) {
        pass_of(pass, quantize<FP, G>(th, tl, pass * kPass + w.lane, inv));
      }
    }
    // row g + 8 t (t < 2) gathers its 8 levels from its quad's lanes
    int lv[kMaxLevel + 1];
#pragma unroll
    for (int src = 0; src < 4; ++src) {
      const int from = (w.lane & ~3) | src;
      const int v0 = __shfl_sync(kFull, d[0], from), v1 = __shfl_sync(kFull, d[1], from);
      const int v2 = __shfl_sync(kFull, d[2], from), v3 = __shfl_sync(kFull, d[3], from);
      lv[2 * src] = t == 1 ? v2 : v0;
      lv[2 * src + 1] = t == 1 ? v3 : v1;
    }
    const float swh = __shfl_sync(kFull, q.swh, qq), swl = __shfl_sync(kFull, q.swl, qq);
    const int vq = __shfl_sync(kFull, view, qq);
    const int rr = (w.lane >> 2) + 8 * t;
    if (t < 2 && rr < S::RC) {
      float h, l;
      row_value(a, lv, vq + w.voff[t], fq, swh, swl, h, l);
      *reinterpret_cast<float2*>(w.slots + qq * S::SLOT_WORDS + 2 * rr) = make_float2(h, l);
    }
  }
  __syncwarp();
}

// The leading axes A..M-1 reduced at `row` (axes 0..A-1 fixed; `view`: its
// row of the (lead, k) table view): sum over b of df_mul(partial, w_A[b]) by
// df_add, innermost axis first. At the top axis of a row chunk the warp
// forms the chunk's slots; `r` is the row's index within its chunk.
template <int NDIMS, int FP, int G, int A>
struct I8Tail {
  static __device__ __forceinline__ void eval(const I8Args& a, const I8Query<NDIMS, FP, G>& q,
                                              const I8Warp& w, int row, int view, int r,
                                              float& h, float& l) {
    using S = I8Shape<NDIMS, FP, G>;
    constexpr bool kInChunk = A >= S::M - S::LC;
    if constexpr (A == S::M - S::LC) chunk_rows<NDIMS, FP, G>(a, q, w, row + q.trail, view);
    float sh = 0.0f, sl = 0.0f;
    const int s = a.stride[A], vs = a.lstride[A];
    const int* slot = w.slots + w.lane * S::SLOT_WORDS;
    const auto term = [&](int b) {
      float gh, gl;
      if constexpr (A == S::M - 1) {
        const float2 v = *reinterpret_cast<const float2*>(slot + 2 * (r * FP + b));
        gh = v.x;
        gl = v.y;
      } else {
        I8Tail<NDIMS, FP, G, A + 1>::eval(a, q, w, row + b * s, view + b * vs,
                                          kInChunk ? r * FP + b : 0, gh, gl);
      }
      float ph, pl;
      df_mul(gh, gl, pick<float, FP>(q.w_h + A * FP, b), pick<float, FP>(q.w_l + A * FP, b), ph,
             pl);
      df_add(sh, sl, ph, pl, sh, sl);
    };
    if constexpr (kInChunk) {  // rows at constant offsets in the chunk's slots
#pragma unroll
      for (int b = 0; b < FP; ++b) term(b);
    } else {
#pragma unroll 1
      for (int b = 0; b < FP; ++b) term(b);
    }
    h = sh;
    l = sl;
  }
};

// A query's weights, S_w and wsum, and its stencil's first cell: `row` of
// the leading axes, `view` its row of the (lead, k) table view, q.trail of
// the trailing ones.
template <int NDIMS, int FP, int G>
__device__ __forceinline__ void query_setup(const I8Args& a, int64_t i, I8Query<NDIMS, FP, G>& q,
                                            int& row, int& view, double& wsum) {
  constexpr int M = NDIMS - G;
  int loc[NDIMS];
  query_weights<NDIMS, FP>(a.grid, a.obs, i, a.lin, loc, q.w_h, q.w_l, &wsum);
  row = 0;
  view = 0;
  q.trail = 0;
#pragma unroll
  for (int k = 0; k < NDIMS; ++k) {
    if (k < M) {
      row += loc[k] * a.stride[k];
      view += loc[k] * a.lstride[k];
    } else {
      q.trail += loc[k] * a.stride[k];
    }
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
}

__device__ __forceinline__ double finish(const I8Args& a, float h, float l, double wsum) {
  return __dadd_rn(__dadd_rn(static_cast<double>(h), static_cast<double>(l)),
                   __dmul_rn(a.c0, wsum));
}

template <int NDIMS, int FP, int G>
__global__ void __launch_bounds__(kI8Threads) i8_kernel(I8Args a, double* __restrict__ out) {
  using S = I8Shape<NDIMS, FP, G>;
  constexpr int M = S::M;
  extern __shared__ __align__(16) int smem_i8[];
  I8Warp w;
  w.lane = threadIdx.x & 31;
  int* mine = smem_i8 + (threadIdx.x >> 5) * S::WARP_WORDS;
  w.u = reinterpret_cast<unsigned long long*>(mine);
  w.slots = mine + S::U_WORDS;
  const int g = w.lane >> 2;
#pragma unroll
  for (int h = 0; h < 2; ++h) {  // chunk row g + 8 h, C order over axes M - LC .. M - 1
    int rr = g + 8 * h, off = 0, voff = 0;
#pragma unroll
    for (int ax = M - 1; ax >= M - S::LC; --ax) {
      off += (rr % FP) * a.stride[ax];
      voff += (rr % FP) * a.lstride[ax];
      rr /= FP;
    }
    w.acell[h] = off + entry_offset<NDIMS, FP, G>(a, w.lane & 3);
    w.voff[h] = voff;
  }
  w.a0 = g < S::RC;
  w.bhigh0 = g <= 3;  // window 7 - g
  w.bshift0 = 8 * ((7 - g) & 3);
  w.bshift1 = g <= 3 ? 32 : 8 * (7 - g);  // window 11 - g, in the high half
  const int64_t step = static_cast<int64_t>(gridDim.x) * kI8Threads;
  // the loop runs whole warps: a lane past n runs the last query and
  // writes nothing, so that every lane takes part in the warp's MMAs
  for (int64_t first = static_cast<int64_t>(blockIdx.x) * kI8Threads + (threadIdx.x & ~31);
       first < a.n; first += step) {
    const int64_t i = first + w.lane;
    I8Query<NDIMS, FP, G> q;
    int row, view;
    double wsum;
    query_setup<NDIMS, FP, G>(a, i < a.n ? i : a.n - 1, q, row, view, wsum);
    float h, l;
    I8Tail<NDIMS, FP, G, 0>::eval(a, q, w, row, view, 0, h, l);
    if (i < a.n) out[i] = finish(a, h, l, wsum);
  }
}

// --- the dp4a route: one thread a query ---------------------------------------------------

// The 8 levels of the FP stencil rows of the innermost leading axis at
// `cell` (row stride `s`): lv[r][lev] = sum over the E trailing entries of
// dp4a(the row's pieces 0-3, B' window 7 - lev) + dp4a(pieces 4-7, window
// 11 - lev), the window bytes as `b_window` takes them.
template <int NDIMS, int FP, int G>
__device__ __forceinline__ void row_levels(const I8Args& a, const unsigned long long* bw, int cell,
                                           int s, int (*lv)[kMaxLevel + 1]) {
  constexpr int E = I8Shape<NDIMS, FP, G>::E;
#pragma unroll
  for (int r = 0; r < FP; ++r) {
#pragma unroll
    for (int lev = 0; lev <= kMaxLevel; ++lev) lv[r][lev] = 0;
  }
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int off = cell + entry_offset<NDIMS, FP, G>(a, e);
    const unsigned lo = static_cast<unsigned>(bw[e]), hi = static_cast<unsigned>(bw[e] >> 32);
    int w0[kMaxLevel + 1], w1[4];
#pragma unroll
    for (int lev = 0; lev <= kMaxLevel; ++lev) {
      w0[lev] = static_cast<int>(lev <= 3 ? __funnelshift_rc(hi, 0u, 8 * (3 - lev))
                                          : __funnelshift_rc(lo, hi, 8 * (7 - lev)));
    }
#pragma unroll
    for (int lev = 4; lev <= kMaxLevel; ++lev) {
      w1[lev - 4] = static_cast<int>(__funnelshift_rc(hi, 0u, 8 * (7 - lev)));
    }
#pragma unroll
    for (int r = 0; r < FP; ++r) {
      const uint2 v = __ldg(a.pieces + off + r * s);
#pragma unroll
      for (int lev = 0; lev <= kMaxLevel; ++lev) {
        lv[r][lev] = __dp4a(static_cast<int>(v.x), w0[lev], lv[r][lev]);
        if (lev >= 4) lv[r][lev] = __dp4a(static_cast<int>(v.y), w1[lev - 4], lv[r][lev]);
      }
    }
  }
}

// I8Tail's reduction of the leading axes A..M-1 at `row` on the dp4a
// route: the innermost leading axis's FP rows from `row_levels`, the same
// row values, df_mul and df_add in the same order.
template <int NDIMS, int FP, int G, int A>
struct I8Dp4aTail {
  static __device__ __forceinline__ void eval(const I8Args& a, const I8Query<NDIMS, FP, G>& q,
                                              const unsigned long long* bw, int row, int view,
                                              float& h, float& l) {
    constexpr int M = NDIMS - G;
    float sh = 0.0f, sl = 0.0f;
    const int s = a.stride[A], vs = a.lstride[A];
    if constexpr (A == M - 1) {
      int lv[FP][kMaxLevel + 1];
      row_levels<NDIMS, FP, G>(a, bw, row + q.trail, s, lv);
#pragma unroll
      for (int b = 0; b < FP; ++b) {
        float gh, gl, ph, pl;
        row_value(a, lv[b], view + b * vs, q.fq, q.swh, q.swl, gh, gl);
        df_mul(gh, gl, q.w_h[A * FP + b], q.w_l[A * FP + b], ph, pl);
        df_add(sh, sl, ph, pl, sh, sl);
      }
    } else {
#pragma unroll 1
      for (int b = 0; b < FP; ++b) {
        float gh, gl, ph, pl;
        I8Dp4aTail<NDIMS, FP, G, A + 1>::eval(a, q, bw, row + b * s, view + b * vs, gh, gl);
        df_mul(gh, gl, pick<float, FP>(q.w_h + A * FP, b), pick<float, FP>(q.w_l + A * FP, b),
               ph, pl);
        df_add(sh, sl, ph, pl, sh, sl);
      }
    }
    h = sh;
    l = sl;
  }
};

template <int NDIMS, int FP, int G>
__global__ void __launch_bounds__(kI8Threads) i8_dp4a_kernel(I8Args a, double* __restrict__ out) {
  constexpr int M = NDIMS - G;
  constexpr int E = I8Shape<NDIMS, FP, G>::E;
  const int64_t step = static_cast<int64_t>(gridDim.x) * kI8Threads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kI8Threads + threadIdx.x; i < a.n;
       i += step) {
    I8Query<NDIMS, FP, G> q;
    int row, view;
    double wsum;
    query_setup<NDIMS, FP, G>(a, i, q, row, view, wsum);
    // the weight peak (NaN propagates), the scales, the B' words
    const float* th = q.w_h + M * FP;
    const float* tl = q.w_l + M * FP;
    float peak = 0.0f;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      float h, l;
      combined_weight<FP, G>(th, tl, e, h, l);
      peak = peak_of(peak, fabsf(h));
    }
    scales(peak, q.fq, q.inv);
    unsigned long long bw[E];
#pragma unroll
    for (int e = 0; e < E; ++e) bw[e] = quantize<FP, G>(th, tl, e, q.inv);
    float h, l;
    I8Dp4aTail<NDIMS, FP, G, 0>::eval(a, q, bw, row, view, h, l);
    out[i] = finish(a, h, l, wsum);
  }
}

namespace {
// Whether this instantiation's shared-memory limit is raised, per device:
// raised once a device to its one value, so two first launches that race
// set it twice to the same. Internal linkage: the static of a function
// with external linkage would be one object per process, shared by every
// library built from this source (two builds loaded side by side would
// skip each other's opt-in).
template <int NDIMS, int FP, int G>
bool* smem_raised() {
  static bool raised[kMaxDevices] = {};
  return raised;
}
}  // namespace

// The launch, or the attributes and occupancy, of one route's
// instantiation for (ndims, footprint, group).
struct I8Op {
  const I8Args* args;
  double* out;
  int blocks;
  int route;
  cudaStream_t stream;
  int* info;  // non-null: registers, static shared bytes, local bytes, blocks an SM

  template <typename Kernel>
  cudaError_t go(Kernel kernel, size_t smem) {
    if (info != nullptr) {
      cudaFuncAttributes attr{};
      const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
      if (err != cudaSuccess) return err;
      info[0] = attr.numRegs;
      info[1] = static_cast<int>(attr.sharedSizeBytes + smem);
      info[2] = static_cast<int>(attr.localSizeBytes);
      return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[3], kernel, kI8Threads, smem);
    }
    kernel<<<blocks, kI8Threads, smem, stream>>>(*args, out);
    return cudaGetLastError();
  }

  // each instantiation has one route: dp4a up to kDp4aEntries trailing
  // entries, mma from kPass
  template <int NDIMS, int FP, int G>
  cudaError_t run() {
    using S = I8Shape<NDIMS, FP, G>;
    if constexpr (S::E <= kDp4aEntries) {
      return route == kI8Dp4a ? go(i8_dp4a_kernel<NDIMS, FP, G>, 0) : cudaErrorInvalidValue;
    } else {
      static_assert(S::E % kPass == 0, "the mma route takes whole passes");
      if (route != kI8Mma) return cudaErrorInvalidValue;
      const auto kernel = i8_kernel<NDIMS, FP, G>;
      bool* raised = smem_raised<NDIMS, FP, G>();
      int device = 0;
      cudaError_t err = cudaGetDevice(&device);
      if (err != cudaSuccess) return err;
      if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
      if (!raised[device] && S::SMEM > 48 * 1024) {
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   static_cast<int>(S::SMEM));
        if (err != cudaSuccess) return err;
      }
      raised[device] = true;
      return go(kernel, S::SMEM);
    }
  }
};

template <int NDIMS, int FP, int G>
cudaError_t i8_group(int group, I8Op& op) {
  if constexpr (G >= NDIMS) {
    return cudaErrorInvalidValue;
  } else {
    if (group != G) return i8_group<NDIMS, FP, G + 1>(group, op);
    if constexpr (ipow(FP, G) > kMaxEntries) {
      return cudaErrorInvalidValue;
    } else {
      return op.run<NDIMS, FP, G>();
    }
  }
}

template <int FP>
cudaError_t i8_ndims(int ndims, int group, I8Op& op) {
  switch (ndims) {
    case 2: return i8_group<2, FP, 1>(group, op);
    case 3: return i8_group<3, FP, 1>(group, op);
    case 4: return i8_group<4, FP, 1>(group, op);
    case 5: return i8_group<5, FP, 1>(group, op);
    case 6: return i8_group<6, FP, 1>(group, op);
    case 7: return i8_group<7, FP, 1>(group, op);
    case 8: return i8_group<8, FP, 1>(group, op);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t i8_footprint(int footprint, int ndims, int group, I8Op& op) {
  switch (footprint) {
    case 2: return i8_ndims<2>(ndims, group, op);
    case 4: return i8_ndims<4>(ndims, group, op);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace interp

// Launches K9 on `stream` without synchronising and returns
// cudaGetLastError() (0 on success). `kind` is 0 regular (`starts`,
// `steps`: device arrays of ndims doubles) or 1 rectilinear (`cols`: a host
// array of ndims device pointers to the sorted axes); `footprint` 2 linear
// or 4 cubic; `linearize` the cubic extrapolation mode; `group` the
// trailing-axis count G (`ops/i8.py::_choose_group`). `dims` and `obs` are
// host arrays of ndims entries, `obs` of device pointers to the float64
// queries; `pieces`, `ch`, `cl`, `sv` and `c0` are `ops/i8.py::prepare`'s;
// `out` n doubles; `route` 0 (mma: footprint^group >= 32) or 1 (dp4a: <= 16). The
// caller guarantees 2 <= ndims <= 8, 1 <= group < ndims with
// footprint^group <= 2048, every dim >= footprint, prod(dims) < 2^31 and
// 0 < n < 2^31.
extern "C" int interpn_i8(int kind, int footprint, int linearize, int group, int route, int ndims,
                          const int* dims, const void* starts, const void* steps,
                          const void* const* cols, const void* pieces, const void* ch,
                          const void* cl, const void* sv, double c0, const void* const* obs,
                          void* out, long long n, int blocks, void* stream) {
  using namespace interp;
  if (ndims < 2 || ndims > kMaxDims || group < 1 || group >= ndims || n <= 0 || blocks <= 0 ||
      (kind != kGridRegular && kind != kGridRectilinear)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  I8Args a{};
  a.grid.kind = kind;
  a.grid.start = static_cast<const double*>(starts);
  a.grid.step = static_cast<const double*>(steps);
  for (int k = 0; k < ndims; ++k) {
    a.grid.col[k] = kind == kGridRegular ? nullptr : static_cast<const double*>(cols[k]);
    a.grid.dim[k] = dims[k];
    a.obs.p[k] = static_cast<const double*>(obs[k]);
  }
  a.pieces = static_cast<const uint2*>(pieces);
  a.ch = static_cast<const float*>(ch);
  a.cl = static_cast<const float*>(cl);
  a.sv = static_cast<const float*>(sv);
  a.c0 = c0;
  a.n = n;
  a.lin = linearize != 0;
  int acc = 1;
  for (int k = ndims - 1; k >= 0; --k) {
    a.stride[k] = acc;
    acc *= dims[k];
  }
  acc = 1;
  for (int k = ndims - group - 1; k >= 0; --k) {
    a.lstride[k] = acc;
    acc *= dims[k];
  }
  I8Op op{&a, static_cast<double*>(out), blocks, route, static_cast<cudaStream_t>(stream),
          nullptr};
  return static_cast<int>(i8_footprint(footprint, ndims, group, op));
}

// info[0..3] of K9's instantiation for (footprint, ndims, group, route):
// registers a thread, shared bytes a block (static and the launch's
// dynamic), local (spill) bytes a thread, resident blocks an SM.
extern "C" int interpn_i8_info(int footprint, int ndims, int group, int route, int* info) {
  using namespace interp;
  I8Op op{nullptr, nullptr, 0, route, nullptr, info};
  return static_cast<int>(i8_footprint(footprint, ndims, group, op));
}
