// Double-float arithmetic for the f64 contraction engines K8
// (`fused_df64.cu`) and K9 (`fused_i8.cu`): a value is an unevaluated sum
// hi + lo of two floats, carried through Dekker/Veltkamp TwoProd (no FMA)
// and Knuth TwoSum, op for op as `ops/df64.py` (the counterpart of
// `interpn_tpu/ops/pallas_df64.py:163-229`).
//
// The compensation steps are exact only if every product and sum rounds on
// its own: an FMA would fold a product into the next addition with one
// rounding and lose the error term. So every step goes through the _rn
// intrinsics, which nvcc never contracts, and the build adds --fmad=false.
//
// TwoProd keeps Dekker's product over Veltkamp's splits. One FMA, e =
// fma(a, b, -a*b), gives the same error wherever both are exact (the exact
// a*b - p is unique), but not where 4097 a overflows (|a| >= 2^116) or a
// partial product underflows (e_a + e_b < -103), so it would need a guard
// to keep the plain version's bits. On an H100 the guard cost more than the
// FMA saved: K8 cubic 20^3 at 1e6 queries took 0.1863 ms with a guard on
// the exponent fields, 0.1696 with a guard on |a|, |b| and |a*b|, 0.1391
// with Dekker's steps alone, and 12^5 2.5221, 2.2919 and 1.9833 ms
// (`scripts/torch_regular_ab.py --engines` against copies of the sources
// with either guard, NVIDIA H100 80GB HBM3 at 700 W; PERF.md).

#pragma once

#include <cuda_runtime.h>

namespace interp {

__device__ __forceinline__ float fadd(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float fsub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float fmul(float a, float b) { return __fmul_rn(a, b); }

// s + e == a + b exactly (`_two_sum`).
__device__ __forceinline__ void two_sum(float a, float b, float& s, float& e) {
  s = fadd(a, b);
  const float bb = fsub(s, a);
  e = fadd(fsub(a, fsub(s, bb)), fsub(b, bb));
}

// hi + lo == a with hi holding the upper 12 bits (`_veltkamp`).
__device__ __forceinline__ void veltkamp(float a, float& hi, float& lo) {
  const float c = fmul(a, 4097.0f);
  hi = fsub(c, fsub(c, a));
  lo = fsub(a, hi);
}

// p + e == a * b exactly, Dekker's left-to-right error (`_two_prod`).
__device__ __forceinline__ void two_prod(float a, float b, float& p, float& e) {
  p = fmul(a, b);
  float ahi, alo, bhi, blo;
  veltkamp(a, ahi, alo);
  veltkamp(b, bhi, blo);
  e = fadd(fadd(fadd(fsub(fmul(ahi, bhi), p), fmul(ahi, blo)), fmul(alo, bhi)), fmul(alo, blo));
}

// Fast2Sum renormalization (`_df_norm`).
__device__ __forceinline__ void df_norm(float h, float e, float& s, float& l) {
  s = fadd(h, e);
  l = fsub(e, fsub(s, h));
}

// (xh, xl) + (yh, yl) (`_df_add`).
__device__ __forceinline__ void df_add(float xh, float xl, float yh, float yl, float& sh,
                                       float& sl) {
  float s, e;
  two_sum(xh, yh, s, e);
  df_norm(s, fadd(e, fadd(xl, yl)), sh, sl);
}

// (xh, xl) * (yh, yl) (`_df_mul`).
__device__ __forceinline__ void df_mul(float xh, float xl, float yh, float yl, float& ph,
                                       float& pl) {
  float p, e;
  two_prod(xh, yh, p, e);
  df_norm(p, fadd(e, fadd(fmul(xh, yl), fmul(xl, yh))), ph, pl);
}

// (th, tl) += (ah, al) * (bh, bl): the product pair normalized, then a
// deferred two_sum accumulation (`_df_madd`).
__device__ __forceinline__ void df_madd(float& th, float& tl, float ah, float al, float bh,
                                        float bl) {
  float ahh, ahl, bhh, bhl;
  veltkamp(ah, ahh, ahl);
  veltkamp(bh, bhh, bhl);
  float p = fmul(ah, bh);
  const float err =
      fadd(fadd(fadd(fsub(fmul(ahh, bhh), p), fmul(ahh, bhl)), fmul(ahl, bhh)), fmul(ahl, bhl));
  float low = fadd(err, fadd(fmul(ah, bl), fmul(al, bh)));
  df_norm(p, low, p, low);
  float s, e;
  two_sum(th, p, s, e);
  th = s;
  tl = fadd(tl, fadd(e, low));
}

}  // namespace interp
