// In-thread Fq2 / Fq6 / Fq12 formulas of the fused tower kernels.
//
// Port of the in-kernel tower math of groth_sahai_tpu/ops/pallas_tower.py
// (_f2_mul, _f6_mul, _f12_mul, _f12_post_red, _cyc_sqr_body), over the
// field library field.cuh. One thread owns one Fq12 element: 12 Fq
// coefficients of 25 limbs, indexed [i][j][u] for w^i v^j u^u (the port's
// coefficient index 6i + 2j + u).
//
// Every Fq product is a narrow-domain Montgomery product (`mm`, output
// < 2p); the Karatsuba combinations are exact adds and `sub_k` chains with
// the reference's k p offsets; an Fq12 result is post-reduced to < 2p by
// one Montgomery product with R mod p per coefficient. Each step is a
// function of the integer values alone, so any route through the same
// formulas (the plain versions in ops/cuda_tower.py) gives the same limbs.
//
// Bounds (pallas_tower.py's audit): Fq2 mul c0 < 4p, c1 < 6p (inputs
// < 128p); Fq6 mul c0 < 42p, c1 < 30p, c2 < 24p; Fq12 mul raw c0 < 90p,
// c1 < 126p. Operand sums grow x8 from Fq12 down to Fq2, so an Fq12
// product needs bound(a) * bound(b) <= 1024 p^2.
//
// An Fq12 value is 300 words: too many for registers, so the values live
// in the thread's local memory and `mm` is one out-of-line function (a
// single copy of the 25 x 25 product code, called 66 times per Fq12
// product) to keep the compiled code small.
#pragma once

#include <cstdint>

#include "field.cuh"

namespace gs {
namespace tower {

constexpr int N = 25;  // Fq limbs
using Fp = uint32_t[N];
using Fp2 = uint32_t[2][N];
using Fp6 = uint32_t[3][2][N];
using Fp12 = uint32_t[2][3][2][N];
using FieldQ = Field<N>;

__device__ __noinline__ void mm(const FieldQ& f, const Fp& a, const Fp& b,
                                Fp& out) {
  mont_mul<N>(f, a, b, out);
}

__device__ __forceinline__ void copy(const Fp& a, Fp& out) {
#pragma unroll
  for (int j = 0; j < N; ++j) out[j] = a[j];
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

// Karatsuba Fq6 product: c0 < 42p, c1 < 30p, c2 < 24p.
__device__ __noinline__ void f6_mul(const FieldQ& f, const Fp6& a,
                                    const Fp6& b, Fp6& c) {
  Fp2 t0, t1, t2, s1, s2, s3, x, y;
  f2_mul(f, a[0], b[0], t0);
  f2_mul(f, a[1], b[1], t1);
  f2_mul(f, a[2], b[2], t2);
  f2_add(a[1], a[2], x);
  f2_add(b[1], b[2], y);
  f2_mul(f, x, y, s1);
  f2_add(a[0], a[1], x);
  f2_add(b[0], b[1], y);
  f2_mul(f, x, y, s2);
  f2_add(a[0], a[2], x);
  f2_add(b[0], b[2], y);
  f2_mul(f, x, y, s3);
  // c0 = t0 + xi(s1 - t1 - t2)
  f2_sub(f, s1, t1, 6, s1);
  f2_sub(f, s1, t2, 6, s1);
  f2_xi(f, s1, 18, x);
  f2_add(t0, x, c[0]);
  // c1 = s2 + xi(t2) - t0 - t1
  f2_xi(f, t2, 6, x);
  f2_add(s2, x, y);
  f2_sub(f, y, t0, 6, y);
  f2_sub(f, y, t1, 6, c[1]);
  // c2 = s3 + t1 - t0 - t2
  f2_add(s3, t1, y);
  f2_sub(f, y, t0, 6, y);
  f2_sub(f, y, t2, 6, c[2]);
}

// Fq12 Karatsuba over Fq6, raw: c0 = t0 + v t1 < 90p, c1 = ts - t0 - t1
// < 126p. `c` must not be `a` or `b`.
__device__ __forceinline__ void f12_mul_raw(const FieldQ& f, const Fp12& a,
                                            const Fp12& b, Fp12& c) {
  Fp6 t0, t1, ts, x, y;
  f6_mul(f, a[0], b[0], t0);
  f6_mul(f, a[1], b[1], t1);
#pragma unroll 1
  for (int j = 0; j < 3; ++j) {
    f2_add(a[0][j], a[1][j], x[j]);
    f2_add(b[0][j], b[1][j], y[j]);
  }
  f6_mul(f, x, y, ts);
  // v t1 = (xi(t1[2]), t1[0], t1[1]); xi(t1[2] < 24p) < 48p
  Fp2 w;
  f2_xi(f, t1[2], 24, w);
  f2_add(t0[0], w, c[0][0]);
  f2_add(t0[1], t1[0], c[0][1]);
  f2_add(t0[2], t1[1], c[0][2]);
#pragma unroll 1
  for (int j = 0; j < 3; ++j) {
    f2_sub(f, ts[j], t0[j], 42, w);
    f2_sub(f, w, t1[j], 42, c[1][j]);
  }
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

// a b post-reduced to < 2p (pallas_tower._f12_mul_red).
__device__ __noinline__ void f12_mul_red(const FieldQ& f, const Fp12& a,
                                         const Fp12& b, Fp12& c) {
  f12_mul_raw(f, a, b, c);
  post_red(f, c);
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

}  // namespace tower
}  // namespace gs
