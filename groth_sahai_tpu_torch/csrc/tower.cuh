// In-thread Fq2 / Fq12 formulas of the one-thread tower kernels cyc_sqr
// and miller_add_step.
//
// Port of the in-kernel tower math of groth_sahai_tpu/ops/pallas_tower.py
// (_f2_mul, _f12_post_red, _cyc_sqr_body, and the Miller step bodies at the
// end of this file), over the field library field.cuh. One thread owns one
// Fq12 element: 12 Fq coefficients of 25 limbs, indexed [i][j][u] for
// w^i v^j u^u (the port's coefficient index 6i + 2j + u).
//
// Every Fq product is a narrow-domain Montgomery product (`mm`, output
// < 2p); the Karatsuba combinations are exact adds and `sub_k` chains with
// the reference's k p offsets; an Fq12 result is post-reduced to < 2p by
// one Montgomery product with R mod p per coefficient. Each step is a
// function of the integer values alone, so any route through the same
// formulas (the plain versions in ops/cuda_tower.py) gives the same limbs.
//
// Bounds (pallas_tower.py's audit): Fq2 mul c0 < 4p, c1 < 6p (inputs
// < 128p).
//
// An Fq12 value is 300 words: too many for registers, so the values live
// in the thread's local memory and `mm` is one out-of-line function (a
// single copy of the 25 x 25 product code) to keep the compiled code small.
// The grouped kernels' formulas are tower_w32.cuh's.
#pragma once

#include <cstdint>

#include "field.cuh"

namespace gs {
namespace tower {

constexpr int N = 25;  // Fq limbs
using Fp = uint32_t[N];
using Fp2 = uint32_t[2][N];
using Fp12 = uint32_t[2][3][2][N];
using FieldQ = Field<N>;

__device__ __noinline__ void mm(const FieldQ& f, const Fp& a, const Fp& b,
                                Fp& out) {
  mont_mul<N>(f, a, b, out);
}

__device__ __forceinline__ void f2_add(const Fp2& a, const Fp2& b, Fp2& c) {
  add<N>(a[0], b[0], c[0]);
  add<N>(a[1], b[1], c[1]);
}

__device__ __forceinline__ void f2_sub(const FieldQ& f, const Fp2& a,
                                       const Fp2& b, uint32_t k, Fp2& c) {
  sub_k<N>(a[0], b[0], k, f.p, c[0]);
  sub_k<N>(a[1], b[1], k, f.p, c[1]);
}

// (u + 1) a = (a0 - a1, a0 + a1); bound(a) <= k p. `c` must not be `a`.
__device__ __forceinline__ void f2_xi(const FieldQ& f, const Fp2& a,
                                      uint32_t k, Fp2& c) {
  sub_k<N>(a[0], a[1], k, f.p, c[0]);
  add<N>(a[0], a[1], c[1]);
}

// Karatsuba Fq2 product: c0 = t0 - t1 < 4p, c1 = t2 - t0 - t1 < 6p.
__device__ __noinline__ void f2_mul(const FieldQ& f, const Fp2& a,
                                    const Fp2& b, Fp2& c) {
  Fp t0, t1, t2, sa, sb;
  mm(f, a[0], b[0], t0);
  mm(f, a[1], b[1], t1);
  add<N>(a[0], a[1], sa);
  add<N>(b[0], b[1], sb);
  mm(f, sa, sb, t2);
  sub_k<N>(t0, t1, 2, f.p, c[0]);
  sub_k<N>(t2, t0, 2, f.p, t2);
  sub_k<N>(t2, t1, 2, f.p, c[1]);
}

// Every coefficient times R mod p (Montgomery): < 2p. In place.
__device__ __forceinline__ void post_red(const FieldQ& f, Fp12& c) {
#pragma unroll 1
  for (int i = 0; i < 2; ++i) {
#pragma unroll 1
    for (int j = 0; j < 3; ++j) {
      mm(f, c[i][j][0], f.one, c[i][j][0]);
      mm(f, c[i][j][1], f.one, c[i][j][1]);
    }
  }
}

// Complex square of one Fq2 value: ((a0 + a1)(a0 - a1) < 2p, 2 a0 a1 < 4p).
// `c` must not be `a`.
__device__ __forceinline__ void f2_sqr(const FieldQ& f, const Fp2& a,
                                       Fp2& c) {
  Fp s, d;
  add<N>(a[0], a[1], s);
  sub_k<N>(a[0], a[1], 4, f.p, d);
  mm(f, s, d, c[0]);
  mm(f, a[0], a[1], c[1]);
  dbl<N>(c[1], c[1]);
}

// 3t - 2c = 2(t - c) + t, per component.
__device__ __forceinline__ void comb_a(const FieldQ& f, const Fp2& t,
                                       const Fp2& cc, Fp2& out) {
#pragma unroll 1
  for (int u = 0; u < 2; ++u) {
    sub_k<N>(t[u], cc[u], 2, f.p, out[u]);
    dbl<N>(out[u], out[u]);
    add<N>(out[u], t[u], out[u]);
  }
}

// 3t + 2c = 2(t + c) + t, per component.
__device__ __forceinline__ void comb_b(const Fp2& t, const Fp2& cc,
                                       Fp2& out) {
#pragma unroll 1
  for (int u = 0; u < 2; ++u) {
    add<N>(t[u], cc[u], out[u]);
    dbl<N>(out[u], out[u]);
    add<N>(out[u], t[u], out[u]);
  }
}

// Granger-Scott cyclotomic square, post-reduced (pallas_tower's
// _cyc_sqr_body): inputs < 2p, output < 2p. `out` must not be `a`.
__device__ __noinline__ void cyc_sqr_red(const FieldQ& f, const Fp12& a,
                                         Fp12& out) {
  // Fq2 coefficient m = 3i + j is a[i][j]; x0 = (c0, c3, c1),
  // x1 = (c4, c2, c5).
  const Fp2* x0[3] = {&a[0][0], &a[1][0], &a[0][1]};
  const Fp2* x1[3] = {&a[1][1], &a[0][2], &a[1][2]};
  Fp2 s0[3], s1[3], ta[3], tb[3], w;
#pragma unroll 1
  for (int k = 0; k < 3; ++k) {
    f2_sqr(f, *x0[k], s0[k]);
    f2_sqr(f, *x1[k], s1[k]);
    f2_add(*x0[k], *x1[k], w);
    f2_sqr(f, w, tb[k]);                      // sx = (x0 + x1)^2
    // ta = s0 + xi(s1); tb = sx - s0 - s1
    sub_k<N>(s1[k][0], s1[k][1], 4, f.p, ta[k][0]);
    add<N>(s0[k][0], ta[k][0], ta[k][0]);
    add<N>(s1[k][0], s1[k][1], ta[k][1]);
    add<N>(s0[k][1], ta[k][1], ta[k][1]);
    sub_k<N>(tb[k][0], s0[k][0], 2, f.p, tb[k][0]);
    sub_k<N>(tb[k][0], s1[k][0], 2, f.p, tb[k][0]);
    sub_k<N>(tb[k][1], s0[k][1], 4, f.p, tb[k][1]);
    sub_k<N>(tb[k][1], s1[k][1], 4, f.p, tb[k][1]);
  }
  // A = (ta0, tb0), B = (ta1, tb1), C = (ta2, tb2) are the Fq4 squares
  Fp2 xi_c1;
  f2_xi(f, tb[2], 12, xi_c1);
  comb_a(f, ta[0], a[0][0], out[0][0]);       // 3 A0 - 2 c0
  comb_a(f, ta[1], a[0][1], out[0][1]);       // 3 B0 - 2 c1
  comb_a(f, ta[2], a[0][2], out[0][2]);       // 3 C0 - 2 c2
  comb_b(xi_c1, a[1][0], out[1][0]);          // 3 xi C1 + 2 c3
  comb_b(tb[0], a[1][1], out[1][1]);          // 3 A1 + 2 c4
  comb_b(tb[1], a[1][2], out[1][2]);          // 3 B1 + 2 c5
  post_red(f, out);
}

// ------------------------------------------------ the Miller step bodies
//
// pallas_tower.py's in-kernel helpers of the Miller addition step
// (_f2_mulred, _f2_sqrred, _add_step_body), step for step: the same k p
// offsets and the same post-reductions, so the limbs equal the
// reference's. Every Fq2 product of the step is post-reduced to < 2p
// (mont-by-one), as in the reference. (The doubling step is
// tower_w32.cuh's miller_dbl_step.)

// Fq2 product, both components post-reduced to < 2p (_f2_mulred; the
// square _f2_sqrred is f2_mulred(a, a)).
__device__ __noinline__ void f2_mulred(const FieldQ& f, const Fp2& a,
                                       const Fp2& b, Fp2& c) {
  f2_mul(f, a, b, c);
  mm(f, c[0], f.one, c[0]);
  mm(f, c[1], f.one, c[1]);
}

// k p - a per component; bound(a) <= k p.
__device__ __forceinline__ void f2_neg(const FieldQ& f, const Fp2& a,
                                       uint32_t k, Fp2& c) {
  neg_k<N>(a[0], k, f.p, c[0]);
  neg_k<N>(a[1], k, f.p, c[1]);
}

// Mixed addition step with affine Q (_add_step_body): R with Y < 10p ->
// (X3, Y3 < 4p, Z3) and the line (j < 4p, -theta < 16p, lambda < 4p).
// 65 Montgomery products (13 post-reduced Fq2 products). Outputs must not
// alias inputs.
__device__ __noinline__ void add_step_body(const FieldQ& f, const Fp2& X,
                                           const Fp2& Y, const Fp2& Z,
                                           const Fp2& xq, const Fp2& yq,
                                           Fp2& X3, Fp2& Y3, Fp2& Z3,
                                           Fp2& l0, Fp2& l1, Fp2& l2) {
  Fp2 theta, cc, d, e, ff, g, h, t, u;
  f2_mulred(f, yq, Z, t);
  f2_sub(f, Y, t, 2, theta);                   // < 12p (Y < 10p)
  f2_mulred(f, xq, Z, t);
  f2_sub(f, X, t, 2, l2);                      // lambda < 4p
  f2_mulred(f, theta, theta, cc);
  f2_mulred(f, l2, l2, d);
  f2_mulred(f, l2, d, e);
  f2_mulred(f, Z, cc, ff);
  f2_mulred(f, X, d, g);
  f2_add(e, ff, t);
  f2_add(g, g, u);
  f2_sub(f, t, u, 4, h);                       // < 8p
  f2_mulred(f, l2, h, X3);
  f2_mulred(f, e, Z, Z3);
  f2_mulred(f, e, Y, u);                       // eY
  f2_sub(f, g, h, 8, t);
  f2_mulred(f, theta, t, cc);
  f2_sub(f, cc, u, 2, Y3);                     // < 4p
  f2_mulred(f, theta, xq, t);
  f2_mulred(f, l2, yq, u);
  f2_sub(f, t, u, 2, l0);                      // j < 4p
  f2_neg(f, theta, 16, l1);                    // -theta < 16p
}

}  // namespace tower
}  // namespace gs
