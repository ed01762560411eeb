// The complete projective add and mixed add (RCB16 Algorithms 7 and 8,
// a = 0) of the kernels cadd and cmsm_row_scan, over the packed-word field
// core field_w32.cuh, for G1 (S = 1 Fq component) and G2 (S = 2, Fq2).
//
// The formulas, k p offsets and bounds are the reference's _cadd_body and
// _cmadd_body (groth_sahai_tpu/ops/pallas_curve.py), step for step; every
// step makes the same integer, so the 16-bit limbs at the boundary equal
// the plain versions' (ops/cuda_curve.py). What differs is where values
// live. A body is inlined and indexes its words with constants, so its
// working values stay in registers, and its products call the one
// out-of-line mont, operands and result in registers; the few values that
// wait longest -- the inputs, and t3 and t4 across the six products that
// follow them -- live in the thread's column of shared memory (a Column),
// written once and read where needed, not in local memory.
#pragma once

#include <cstdint>

#include "field_w32.cuh"

namespace gs {
namespace w32 {

// An Fq (S = 1) or Fq2 (S = 2) value: S components of 13 words.
template <int S>
struct Val {
  Fw c[S];
};

template <int S>
__device__ __forceinline__ Val<S> vadd(const Val<S>& a, const Val<S>& b) {
  Val<S> r;
#pragma unroll
  for (int u = 0; u < S; ++u) r.c[u] = add(a.c[u], b.c[u]);
  return r;
}

// a - b for a >= b (per component).
template <int S>
__device__ __forceinline__ Val<S> vsub(const Val<S>& a, const Val<S>& b) {
  Val<S> r;
#pragma unroll
  for (int u = 0; u < S; ++u) r.c[u] = sub(a.c[u], b.c[u]);
  return r;
}

// a + k p (per component).
template <int S>
__device__ __forceinline__ Val<S> vkp(const FieldW& f, const Val<S>& a,
                                      Kp k) {
  Val<S> r;
#pragma unroll
  for (int u = 0; u < S; ++u) r.c[u] = add(a.c[u], f.kp[k]);
  return r;
}

// a - b + k p; bound(b) <= k p.
template <int S>
__device__ __forceinline__ Val<S> vsub_kp(const FieldW& f, const Val<S>& a,
                                          const Val<S>& b, Kp k) {
  Val<S> r;
#pragma unroll
  for (int u = 0; u < S; ++u) r.c[u] = sub_kp(f, a.c[u], b.c[u], k);
  return r;
}

// 3 a = 2 a + a.
template <int S>
__device__ __forceinline__ Val<S> vtriple(const Val<S>& a) {
  return vadd(vadd(a, a), a);
}

// a 3b: 12 a on G1 (b = 4); on G2 (b' = 4(u + 1)) the xi twist
// (a0 - a1 + k p, a0 + a1) with bound(a) <= k p, then 12 x.
__device__ __forceinline__ Val<1> vb3(const FieldW&, const Val<1>& a, Kp) {
  return Val<1>{{mul12(a.c[0])}};
}

__device__ __forceinline__ Val<2> vb3(const FieldW& f, const Val<2>& a,
                                      Kp k) {
  return Val<2>{{mul12(sub_kp(f, a.c[0], a.c[1], k)),
                 mul12(add(a.c[0], a.c[1]))}};
}

// Field products: Fq a Montgomery product (< 2p); Fq2 the Karatsuba of
// the reference's _f2_mulred (t0 - t1 + 2p, t2 - t0 - t1 + 4p), each
// component then times R mod p (< 2p).
__device__ __forceinline__ Val<1> vmul(const FieldW& f, const Val<1>& a,
                                       const Val<1>& b) {
  return Val<1>{{mont(f, a.c[0], b.c[0])}};
}

__device__ __forceinline__ Val<2> vmul(const FieldW& f, const Val<2>& a,
                                       const Val<2>& b) {
  const Fw t0 = mont(f, a.c[0], b.c[0]);
  const Fw t1 = mont(f, a.c[1], b.c[1]);
  const Fw t2 = mont(f, add(a.c[0], a.c[1]), add(b.c[0], b.c[1]));
  const Fw c0 = sub_kp(f, t0, t1, K2);
  const Fw c1 = sub(sub(add(t2, f.kp[K4]), t0), t1);
  Fw one;
#pragma unroll
  for (int j = 0; j < kWords; ++j) one.w[j] = f.one[j];
  return Val<2>{{mont(f, c0, one), mont(f, c1, one)}};
}

// One thread's column of a block's shared memory: word i at s[i * B], so
// the threads of a warp touch 32 neighbouring words (no bank conflict).
// Offsets are in words and known when compiled.
template <int B>
struct Column {
  uint32_t* s;

  template <int S>
  __device__ __forceinline__ Val<S> ld(int at) const {
    Val<S> v;
#pragma unroll
    for (int u = 0; u < S; ++u) {
#pragma unroll
      for (int k = 0; k < kWords; ++k) v.c[u].w[k] = s[(at + u * kWords + k) * B];
    }
    return v;
  }

  template <int S>
  __device__ __forceinline__ void st(int at, const Val<S>& v) const {
#pragma unroll
    for (int u = 0; u < S; ++u) {
#pragma unroll
      for (int k = 0; k < kWords; ++k) s[(at + u * kWords + k) * B] = v.c[u].w[k];
    }
  }
};

// Lane `lane` of a coordinate batch int64 [25, S, M] (limb i of component
// u at (i S + u) M + lane), packed; a limb's value is its int64's low word.
template <int S>
__device__ __forceinline__ Val<S> gload(const int64_t* src, int64_t m,
                                        int64_t lane) {
  const uint32_t* s = reinterpret_cast<const uint32_t*>(src);
  Val<S> v;
#pragma unroll
  for (int u = 0; u < S; ++u) {
#pragma unroll
    for (int k = 0; k < kWords; ++k) {
      const int i = 2 * k;
      const uint32_t lo = __ldg(s + 2 * ((i * S + u) * m + lane));
      const uint32_t hi =
          i + 1 < kLimbs ? __ldg(s + 2 * (((i + 1) * S + u) * m + lane)) : 0;
      v.c[u].w[k] = lo | hi << 16;
    }
  }
  return v;
}

// The 16-bit limbs of v to rows [0, 25) of dst (row stride m) at column
// `lane`, as streaming stores (the row scan's prefix stream is written once
// and read after the launch).
__device__ __forceinline__ void store_limbs_cs(int64_t* dst, int64_t m,
                                               int64_t lane, const Fw& v) {
#pragma unroll
  for (int i = 0; i < kLimbs; ++i)
    __stcs(reinterpret_cast<long long*>(dst + i * m + lane),
           static_cast<long long>((v.w[i / 2] >> (16 * (i % 2))) & 0xFFFFu));
}

// Lane `lane` of v into a coordinate batch int64 [25, S, M].
template <int S>
__device__ __forceinline__ void gstore(int64_t* dst, int64_t m,
                                       int64_t lane, const Val<S>& v) {
#pragma unroll
  for (int u = 0; u < S; ++u) {
#pragma unroll
    for (int i = 0; i < kLimbs; ++i)
      dst[(i * S + u) * m + lane] = (v.c[u].w[i / 2] >> (16 * (i % 2))) & 0xFFFFu;
  }
}

// The three products that close both bodies (RCB16), the reference's:
//   X3 = t3 t1 - t4 Y3 (< 4p), Y3 = t1 Z3 + Y3 t0 (< 4p),
//   Z3 = Z3 t4 + t0 t3 (< 4p).
// In: t3 < 6p in slot T3, t4 < 6p in slot T4, t1 and Z3 < 98p, Y3 < 144p,
// t0 < 6p. Out: slots OX, OY, OZ. OX is free; OZ may be a slot read
// before it (not T3 or T4), OY may be T4.
template <int S, int B>
__device__ __forceinline__ void finish(const FieldW& f, const Column<B>& col,
                                       const Val<S>& t0, const Val<S>& t1,
                                       const Val<S>& y3, const Val<S>& z3,
                                       int T3, int T4, int OX, int OY,
                                       int OZ) {
  col.template st<S>(OX, vkp(f, vmul(f, col.template ld<S>(T3), t1), K2));
  col.template st<S>(OX, vsub(col.template ld<S>(OX),
                              vmul(f, col.template ld<S>(T4), y3)));
  col.template st<S>(OZ, vadd(vmul(f, z3, col.template ld<S>(T4)),
                              vmul(f, t0, col.template ld<S>(T3))));
  col.template st<S>(OY, vadd(vmul(f, t1, z3), vmul(f, y3, t0)));
}

// Complete projective add (_cadd_body): (X1 : Y1 : Z1) + (X2 : Y2 : Z2)
// from the slots at offsets 0, V, ..., 5V (V = 13 S words), coordinates
// < 4p; the sum to the slots at 0, V, 2V (< 4p); slot 6V is scratch.
// Bounds: t2 < 48p after b3, Z3 and t1 < 50p, Y3 < 144p. 12 Montgomery
// products (60 for Fq2).
template <int S, int B>
__device__ __forceinline__ void cadd_body(const FieldW& f,
                                          const Column<B>& col) {
  constexpr int V = kWords * S;
  constexpr int X1 = 0, Y1 = V, Z1 = 2 * V, X2 = 3 * V, Y2 = 4 * V,
                Z2 = 5 * V, T = 6 * V;
  const auto ld = [&](int at) { return col.template ld<S>(at); };
  Val<S> t0 = vmul(f, ld(X1), ld(X2));                          // < 2p
  Val<S> t1 = vmul(f, ld(Y1), ld(Y2));                          // < 2p
  col.template st<S>(T, vsub_kp(f, vmul(f, vadd(ld(X1), ld(Y1)),
                                        vadd(ld(X2), ld(Y2))),
                                vadd(t0, t1), K4));             // t3 < 6p
  Val<S> t2 = vmul(f, ld(Z1), ld(Z2));                          // < 2p
  col.template st<S>(Y1, vsub_kp(f, vmul(f, vadd(ld(Y1), ld(Z1)),
                                         vadd(ld(Y2), ld(Z2))),
                                 vadd(t1, t2), K4));            // t4 < 6p
  Val<S> y3 = vsub_kp(f, vmul(f, vadd(ld(X1), ld(Z1)),
                              vadd(ld(X2), ld(Z2))),
                      vadd(t0, t2), K4);                        // < 6p
  t0 = vtriple(t0);                                             // < 6p
  t2 = vb3(f, t2, K2);                                          // < 48p
  const Val<S> z3 = vadd(t1, t2);                               // < 50p
  t1 = vsub_kp(f, t1, t2, K48);                                 // < 50p
  y3 = vb3(f, y3, K8);                                          // < 144p
  finish<S>(f, col, t0, t1, y3, z3, T, Y1, X1, Y1, Z1);
}

// Complete mixed add (_cmadd_body) of an affine point that is not at
// infinity: the accumulator (X1 : Y1 : Z1) in the slots at A, A + V,
// A + 2V (< 4p), the affine (x2, y2) at X2 and Y2 (< 2p); the sum replaces
// the accumulator (< 4p); slot A + 3V is scratch. `x2_read` runs once x2
// and y2 are read for the last time. Bounds: t2 < 96p, t1 and Z3 < 98p,
// Y3 < 144p; worst product pairs (196)(196) and (12)(288) (units of p, Fq2
// Karatsuba sums included) -- inside the 2^16 p^2 cap. 11 Montgomery
// products (55 for Fq2). Its twin is curve_group_w32.cuh's grouped cw::cmadd
// (the cmadd kernel): the same formulas and k p offsets, taken there as
// levels of a group. An edit to an offset here is made there too.
template <int S, int B, class Then>
__device__ __forceinline__ void cmadd_body(const FieldW& f,
                                           const Column<B>& col, int X2,
                                           int Y2, int A, Then x2_read) {
  constexpr int V = kWords * S;
  const int AX = A, AY = A + V, AZ = A + 2 * V, T = A + 3 * V;
  const auto ld = [&](int at) { return col.template ld<S>(at); };
  Val<S> t0 = vmul(f, ld(AX), ld(X2));                          // < 2p
  Val<S> t1 = vmul(f, ld(AY), ld(Y2));                          // < 2p
  col.template st<S>(T, vsub_kp(f, vmul(f, vadd(ld(X2), ld(Y2)),
                                        vadd(ld(AX), ld(AY))),
                                vadd(t0, t1), K4));             // t3 < 6p
  col.template st<S>(AY, vadd(vmul(f, ld(Y2), ld(AZ)), ld(AY)));  // t4 < 6p
  Val<S> y3 = vadd(vmul(f, ld(X2), ld(AZ)), ld(AX));            // < 6p
  x2_read();
  t0 = vtriple(t0);                                             // < 6p
  const Val<S> t2 = vb3(f, ld(AZ), K4);                         // < 96p
  const Val<S> z3 = vadd(t1, t2);                               // < 98p
  t1 = vsub_kp(f, t1, t2, K96);                                 // < 98p
  y3 = vb3(f, y3, K8);                                          // < 144p
  finish<S>(f, col, t0, t1, y3, z3, T, AY, AX, AY, AZ);
}

}  // namespace w32
}  // namespace gs
