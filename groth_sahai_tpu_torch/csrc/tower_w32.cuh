// The Fq2 / Fq6 / Fq12 formulas of the kernels fq12_mul, cyc_pow, cyc_sqr,
// f12_pow_dyn, miller_iter_dbl, miller_iter_add, miller_dbl_step and
// miller_add_step on packed 32-bit words (field_w32.cuh), worked by a group
// of G threads per lane.
//
// The formulas, k p offsets and post-reductions are the reference's
// (pallas_tower.py: _f2_mul, _f6_mul, _f12_mul, _f12_post_red,
// _cyc_sqr_body, _dbl_step_body and _add_step_body with _f2_mulred and
// _f2_mul_fq, _sparse_line_mul), as the plain versions (ops/cuda_tower.py)
// write them, step for step: every value is the same integer, so the
// 16-bit limbs at the boundary equal the plain versions'. An Fq value is 13
// packed words at R = 2^400, and every Montgomery product is field_w32.cuh's
// out-of-line `mont`, operands and result in registers. mul12 is the
// reference's mul_small(., 12).
//
// What changes is who computes what, and where values live: a group of G
// threads works each lane, level by level, over the lane's Fq slots in
// shared memory (group_w32.cuh). Exact adds and k p subtractions are
// folded into the tasks that need them (a thread recomputes a cheap
// combination rather than wait a level for it).
//
// The levels of the Fq12 product a b (f12_*): 54 Karatsuba leaves (leaf k =
// 18 F + 3 P + Q: Fq6 product F of (a0, b0), (a1, b1), (a0 + a1, b0 + b1),
// its Fq2 product P of (x0, x1, x2, x1 + x2, x0 + x1, x0 + x2), that one's
// Fq product Q of (c0, c1, c0 + c1)); the nine Fq2 values of the three Fq6
// products; the 12 coefficients, each post-reduced. The cyclotomic square
// (cyc_*): the 18 Fq products of the nine Fq2 squares; the 12 coefficients
// (the Fq4 squares, 3t -+ 2c), each post-reduced. The Miller iterations'
// levels, and the addition iteration's bounds, are with their code below.
//
// Bounds (units of p; every value below 2^400, as mont reads word 12 as 16
// bits; every product value(a) value(b) <= 2^16 p^2; every sum < 2^416):
//   * Fq12 product: bound(a) bound(b) <= 1024 p^2 (inputs < 32p each at
//     most); a leaf's operand sums up to 8 coefficients (< 256p), so a
//     product <= 2^16 p^2. Leaves < 2p; Fq2 c0 < 4p, c1 < 6p; Fq6 c0 < 42p,
//     c1 < 30p, c2 < 24p; raw c0 < 90p, c1 < 126p (offsets 2, 6, 18, 24,
//     42); then each times R mod p (< p).
//   * cyclotomic square: inputs < 2p; an Fq2 square's input < 4p (x0 + x1),
//     its operands (w0 + w1, w0 - w1 + 4p) < 8p; squares c0 < 2p, c1 < 4p;
//     ta < 8p, 10p; tb < 6p, 12p; xi(tb2) < 18p (offset 12); 3t - 2c + 4p <
//     34p, 3t + 2c < 58p.
//   * doubling step: X, Z < 2p, Y < 10p; Y + Z < 12p, the widest leaf
//     (Y + Z)^2's (24p)^2; e = 12 xi(c) < 48p, f = 3e < 144p, b + f <
//     146p (times 1/2 < p), h < 6p, l0 = e - b + 2p < 50p, 3j < 6p, 8p - h
//     < 8p, b - f + 144p < 146p: the widest leaf (a0 + a1)(t0 + t1) <
//     4p 292p; e^2's (96p)^2. Outputs X3, Z3 < 2p, Y3 < 10p.
//   * sparse line product: f < 2p, la < 50p, lb, lc < 2p: the widest leaf
//     (s0 + s1)(la0 + la1) < 8p 100p; Fq6 values < 18p, raw < 54p.
#pragma once

#include <cstdint>

#include "field_w32.cuh"
#include "group_w32.cuh"

namespace gs {
namespace tw {

using w32::Fw;
using w32::Group;
using w32::group_of;
using w32::kWords;
using w32::level;

// The k of the tower's k p offsets.
enum Kp { K2, K4, K6, K8, K12, K16, K18, K24, K42, K144, kKinds };
constexpr uint32_t kKp[kKinds] = {2, 4, 6, 8, 12, 16, 18, 24, 42, 144};

// The constants of a launch, passed by value (the kernel-parameter bank):
// mont's field, the tower's k p, and 1/2 in Montgomery form (the doubling
// step's; zero where unused). field_w32.cuh's FieldW is the curve kernels'
// and keeps its own k p table.
struct TowerW {
  w32::FieldW f;
  uint32_t kp[kKinds][kWords];
  uint32_t tinv[kWords];
};

inline TowerW make_tower_w(const uint32_t* p16, const uint32_t* one16,
                           uint32_t n0, const uint32_t* tinv16) {
  TowerW t;
  t.f = w32::make_field_w(p16, one16, n0);
  uint32_t p[kWords];
  w32::pack_host(p16, p);
  w32::kp_words(p, kKp, kKinds, t.kp);
  for (int j = 0; j < kWords; ++j) t.tinv[j] = 0;
  if (tinv16) w32::pack_host(tinv16, t.tinv);
  return t;
}

// ------------------------------------------------- exact adds, k p offsets

using w32::add;
using w32::dbl;
using w32::mul12;
using w32::sub;
using w32::triple;
using w32::words_of;

// a - b + k p, formed as (a + k p) - b; bound(b) <= k p.
__device__ __forceinline__ Fw subk(const TowerW& t, const Fw& a, const Fw& b,
                                   Kp k) {
  return sub(add(a, t.kp[k]), b);
}

// k p - a; bound(a) <= k p.
__device__ __forceinline__ Fw negk(const TowerW& t, const Fw& a, Kp k) {
  Fw c;
#pragma unroll
  for (int j = 0; j < kWords; ++j) c.w[j] = t.kp[k][j];
  return sub(c, a);
}

// a times R mod p (Montgomery): < 2p.
__device__ __forceinline__ Fw post_red(const TowerW& t, const Fw& a) {
  return w32::mont(t.f, a, words_of(t.f.one));
}

// The operands of Karatsuba leaf q of an Fq2 product a b, from a(u) and
// b(u), the components: q = 0: a0 b0; q = 1: a1 b1; q = 2: (a0 + a1)
// (b0 + b1).
template <class A, class B>
__device__ __forceinline__ void kara_ops(int q, A a, B b, Fw& x, Fw& y) {
  if (q < 2) {
    x = a(q);
    y = b(q);
  } else {
    x = add(a(0), a(1));
    y = add(b(0), b(1));
  }
}

// Component u of a Karatsuba Fq2 product whose leaves t0 = a0 b0, t1 =
// a1 b1, t2 = (a0 + a1)(b0 + b1) sit at slots L, L + 1, L + 2 (_f2_mul):
// c0 = t0 - t1 + 2p (< 4p), c1 = t2 - t0 + 2p - t1 + 2p (< 6p).
template <int G>
__device__ __forceinline__ Fw kara(const TowerW& t, const Group<G>& grp,
                                   int L, int u) {
  const Fw t0 = grp.ld(L), t1 = grp.ld(L + 1);
  return u == 0 ? subk(t, t0, t1, K2)
                : subk(t, subk(t, grp.ld(L + 2), t0, K2), t1, K2);
}

// ------------------------------------------------------ the Fq12 product

// The coefficients (bit 6 i + 2 j + u) whose sum is an operand of leaf
// k = 18 F + 3 P + Q: F picks w^i in {0}, {1}, {0, 1}; P the v^j of the
// Fq6 Karatsuba in {0}, {1}, {2}, {1, 2}, {0, 1}, {0, 2}; Q the u^u of the
// Fq2 Karatsuba in {0}, {1}, {0, 1}.
__device__ __forceinline__ uint32_t f12_leaf_mask(int k) {
  const int F = k / 18, P = k / 3 % 6, Q = k % 3;
  constexpr uint32_t kJ = 5u << 15 | 3u << 12 | 6u << 9 | 4u << 6 | 2u << 3 | 1u;
  const uint32_t jm = kJ >> (3 * P) & 7u;
  uint32_t ju = 0;
#pragma unroll
  for (int j = 0; j < 3; ++j)
    if (jm >> j & 1u) ju |= static_cast<uint32_t>(Q + 1) << (2 * j);
  uint32_t m = 0;
#pragma unroll
  for (int i = 0; i < 2; ++i)
    if ((F + 1) >> i & 1) m |= ju << (6 * i);
  return m;
}

// The sum of the Fq slots base + c for the bits c of m (m != 0).
template <int G>
__device__ __forceinline__ Fw slot_sum(const Group<G>& grp, int base,
                                       uint32_t m) {
  Fw s = grp.ld(base + __ffs(m) - 1);
  m &= m - 1;
#pragma unroll 1
  while (m) {
    s = add(s, grp.ld(base + __ffs(m) - 1));
    m &= m - 1;
  }
  return s;
}

// Level 1 of a b (a at slots A .. A + 11, b at B; B == A squares): the
// operands of leaf k < 54.
template <int G>
__device__ __forceinline__ void f12_leaf_ops(const Group<G>& grp, int A,
                                             int B, int k, Fw& x, Fw& y) {
  const uint32_t m = f12_leaf_mask(k);
  x = slot_sum(grp, A, m);
  y = A == B ? x : slot_sum(grp, B, m);
}

// Level 2 of a b: task k < 9 makes Fq2 value j = k % 3 of the Fq6 product
// F = k / 3 (_f6_mul) from the leaves at LEAF, into slots
// OUT + 6 F + 2 j and + 1.
template <int G>
__device__ __forceinline__ void f6_comb(const TowerW& t, const Group<G>& grp,
                                        int LEAF, int OUT, int k) {
  const int F = k / 3, j = k % 3;
  // the Fq2 products t0, t1, t2, s1, s2, s3 of the Fq6 Karatsuba
  const auto P = [&](int n, int u) {
    return kara(t, grp, LEAF + 18 * F + 3 * n, u);
  };
  Fw c[2];
  if (j == 0) {                     // t0 + xi(s1 - t1 - t2)
    Fw s[2];
#pragma unroll
    for (int u = 0; u < 2; ++u)
      s[u] = subk(t, subk(t, P(3, u), P(1, u), K6), P(2, u), K6);
    c[0] = add(P(0, 0), subk(t, s[0], s[1], K18));
    c[1] = add(P(0, 1), add(s[0], s[1]));
  } else if (j == 1) {              // s2 + xi(t2) - t0 - t1
    const Fw t20 = P(2, 0), t21 = P(2, 1);
    const Fw xi[2] = {subk(t, t20, t21, K6), add(t20, t21)};
#pragma unroll
    for (int u = 0; u < 2; ++u)
      c[u] = subk(t, subk(t, add(P(4, u), xi[u]), P(0, u), K6), P(1, u), K6);
  } else {                          // s3 + t1 - t0 - t2
#pragma unroll
    for (int u = 0; u < 2; ++u)
      c[u] = subk(t, subk(t, add(P(5, u), P(1, u)), P(0, u), K6), P(2, u),
                  K6);
  }
  grp.st(OUT + 6 * F + 2 * j, c[0]);
  grp.st(OUT + 6 * F + 2 * j + 1, c[1]);
}

// Level 3 of a b, before the post-reduction: raw coefficient k = 6 i + 2 j
// + u from the Fq6 products t0, t1, ts at T6 (_f12_mul:
// c0 = t0 + v t1, c1 = ts - t0 - t1). kx and ks are the offsets of
// xi(t1[2]) and of the two subtractions: K24 and K42 for a b; K12 and K18
// for the sparse line product, whose last level has the same form.
template <int G>
__device__ __forceinline__ Fw f12_comb(const TowerW& t, const Group<G>& grp,
                                       int T6, int k, Kp kx, Kp ks) {
  const int i = k / 6, j = k / 2 % 3, u = k % 2;
  const auto T = [&](int F, int jj, int uu) {
    return grp.ld(T6 + 6 * F + 2 * jj + uu);
  };
  if (i == 1) return subk(t, subk(t, T(2, j, u), T(0, j, u), ks), T(1, j, u), ks);
  if (j > 0) return add(T(0, j, u), T(1, j - 1, u));
  const Fw w = u == 0 ? subk(t, T(1, 2, 0), T(1, 2, 1), kx)
                      : add(T(1, 2, 0), T(1, 2, 1));
  return add(T(0, 0, u), w);
}

// a b post-reduced (_f12_mul_red) from slots A and B into slots
// OUT; LEAF (54 slots) and T6 (18) are scratch. OUT must not be A or B.
template <int G>
__device__ __forceinline__ void f12_mul(const TowerW& t, const Group<G>& grp,
                                        int A, int B, int OUT, int LEAF,
                                        int T6) {
  level(grp, 54, [&](int k) {
    Fw x, y;
    f12_leaf_ops(grp, A, B, k, x, y);
    grp.st(LEAF + k, w32::mont(t.f, x, y));
  });
  level(grp, 9, [&](int k) { f6_comb(t, grp, LEAF, T6, k); });
  level(grp, 12, [&](int k) {
    grp.st(OUT + k, post_red(t, f12_comb(t, grp, T6, k, K24, K42)));
  });
}

// ----------------------------------------------------- the cyclotomic square

// Level 1 of the square of a (slots A): task k = 2 q + h, component h of
// the complex Fq2 square q (_cyc_sqr_body's f2sqr: (w0 + w1)(w0 - w1 + 4p)
// < 2p, 2 w0 w1 < 4p) of x0[q], x1[q - 3] or x0[q - 6] + x1[q - 6], with
// x0 = (c0, c3, c1), x1 = (c4, c2, c5) in Fq2 coefficients m = 3 i + j
// (Fq coefficients 6 i + 2 j + u): h = 0: (w0 + w1)(w0 - w1 + 4p); h = 1:
// w0 w1, which the task doubles after the product.
template <int G>
__device__ __forceinline__ void cyc_leaf_ops(const TowerW& t,
                                             const Group<G>& grp, int A,
                                             int k, Fw& x, Fw& y) {
  const int q = k / 2, r = q % 3;
  const int x0 = A + (0x020600 >> (8 * r) & 0xFF);   // 0, 6, 2
  const int x1 = A + (0x0A0408 >> (8 * r) & 0xFF);   // 8, 4, 10
  Fw w0, w1;
  if (q < 6) {
    const int c = q < 3 ? x0 : x1;
    w0 = grp.ld(c);
    w1 = grp.ld(c + 1);
  } else {
    w0 = add(grp.ld(x0), grp.ld(x1));
    w1 = add(grp.ld(x0 + 1), grp.ld(x1 + 1));
  }
  if (k % 2 == 0) {
    x = add(w0, w1);
    y = subk(t, w0, w1, K4);
  } else {
    x = w0;
    y = w1;
  }
}

// Level 2 of the square, before the post-reduction: out coefficient k =
// 6 i + 2 j + u from the squares at SQ (s0, s1, sx at Fq2 q = r, 3 + r,
// 6 + r) and a (_cyc_sqr_body): ta = s0 + xi(s1), tb = sx - s0 -
// s1; out[0][j] = 3 ta_j - 2 a[0][j]; out[1][0] = 3 xi(tb_2) + 2 a[1][0],
// out[1][j] = 3 tb_(j-1) + 2 a[1][j].
template <int G>
__device__ __forceinline__ Fw cyc_comb(const TowerW& t, const Group<G>& grp,
                                       int A, int SQ, int k) {
  const int i = k / 6, j = k / 2 % 3, u = k % 2;
  const auto S = [&](int q, int h) { return grp.ld(SQ + 2 * q + h); };
  const auto tb = [&](int r, int uu) {
    const Kp o = uu == 0 ? K2 : K4;
    return subk(t, subk(t, S(6 + r, uu), S(r, uu), o), S(3 + r, uu), o);
  };
  if (i == 0) {                     // comb_a: 2 (ta - c + 2p) + ta
    const Fw s1 = u == 0 ? subk(t, S(3 + j, 0), S(3 + j, 1), K4)
                         : add(S(3 + j, 0), S(3 + j, 1));
    const Fw ta = add(S(j, u), s1);
    return add(dbl(subk(t, ta, grp.ld(A + 2 * j + u), K2)), ta);
  }
  Fw b;                             // comb_b: 2 (t + c) + t
  if (j == 0) {
    const Fw b0 = tb(2, 0), b1 = tb(2, 1);
    b = u == 0 ? subk(t, b0, b1, K12) : add(b0, b1);
  } else {
    b = tb(j - 1, u);
  }
  return add(dbl(add(b, grp.ld(A + 6 + 2 * j + u))), b);
}

// The Granger-Scott cyclotomic square of a (slots A, < 2p) post-reduced
// into slots OUT (< 2p; _cyc_sqr_body): 30 Montgomery products in two
// levels, 18 and 12, so 2 rounds at G = 32, 3 at 16, 5 at 8 and 8 at 4.
// SQ (18 slots) is scratch. OUT must not be A.
template <int G>
__device__ __forceinline__ void cyc_sqr(const TowerW& t, const Group<G>& grp,
                                        int A, int OUT, int SQ) {
  level(grp, 18, [&](int k) {
    Fw x, y;
    cyc_leaf_ops(t, grp, A, k, x, y);
    const Fw r = w32::mont(t.f, x, y);
    grp.st(SQ + k, k % 2 == 0 ? r : dbl(r));
  });
  level(grp, 12, [&](int k) {
    grp.st(OUT + k, post_red(t, cyc_comb(t, grp, A, SQ, k)));
  });
}

// ---------------------------------------------- the Miller doubling iteration
//
// f <- f^2 line_{R,R}(P), R <- 2R (_f12_sqr_red, _dbl_step_body,
// _f2_mul_fq for the line's scaling, _sparse_line_mul), in six levels whose
// Montgomery products are (f^2's and the point step's side by side):
//   A  69: f^2's 54 leaves; the Karatsuba leaves of X Y, Y^2, Z^2, X^2,
//          (Y + Z)^2;
//   B  10 + 9: those five products' post-reductions (XY, b, c, j, u);
//          f^2's nine Fq6 values (no product);
//   C  12 + 16: f^2's 12 coefficients, post-reduced; a = XY / 2,
//          g = (b + f) / 2, the leaves of e^2 and of b h, lb = 3j px,
//          lc = -h py; l0 = e - b (no product);
//   D  45 + 10: the sparse product's 45 leaves (15 Fq2 products of
//          f0 la, f0 lb, f1 lc, (f0 + f1) la, (f0 + f1)(lb + lc));
//          e^2's and Z3's post-reductions; the leaves of X3 = a (b - f)
//          and of g^2;
//   E  4 + 9: X3's and g^2's post-reductions; the sparse product's nine
//          Fq6 values (no product);
//   F  12 + 2: its 12 coefficients, post-reduced; Y3 = g^2 - 3 e^2.
// 176 Montgomery products in 25 rounds of G = 8 threads.
//
// The lane's slots: f (then f^2) at kF; leaves at kLeaf (69: A's, then
// D's: the sparse leaves at 0 .. 44, e^2 at 45, 46, X3's leaves at 49 ..
// 51, g^2's at 52 .. 54); Fq6 values at kT6 (18); X, Y, Z, px, py at kPt;
// XY, b, c, j, u (then g^2) at kD2; a, g, e^2's leaves, b h's leaves, lb,
// lc, l0 at kD3.
struct DblSlots {
  static constexpr int kF = 0, kLeaf = 12, kT6 = 81, kPt = 99, kD2 = 107,
                       kD3 = 117, kSlots = 133;
};

// The values the iteration and the step write to the lane's outputs.
enum DblOut { kOutF, kOutX, kOutY, kOutZ, kOutL0, kOutL1, kOutL2 };

// The point levels' helpers below read the point, XY .. u and a .. b h at
// slots S::kPt, S::kD2 and S::kD3 (DblSlots for the iteration,
// DblStepSlots for the step).

// e = 12 xi(c) (< 48p), component u.
template <class S, int G>
__device__ __forceinline__ Fw dbl_e(const TowerW& t, const Group<G>& grp,
                                    int u) {
  constexpr int C = S::kD2 + 4;
  const Fw c0 = grp.ld(C), c1 = grp.ld(C + 1);
  return mul12(u == 0 ? subk(t, c0, c1, K2) : add(c0, c1));
}

// h = u - (b + c) + 4p (< 6p), component uu.
template <class S, int G>
__device__ __forceinline__ Fw dbl_h(const TowerW& t, const Group<G>& grp,
                                    int uu) {
  constexpr int D2 = S::kD2;
  return subk(t, grp.ld(D2 + 8 + uu),
              add(grp.ld(D2 + 2 + uu), grp.ld(D2 + 4 + uu)), K4);
}

// The raw line (l0, l1, l2) = (e - b + 2p < 50p, 3j < 6p, 8p - h < 8p),
// component u: no product.
template <class S, int G>
__device__ __forceinline__ Fw dbl_l0(const TowerW& t, const Group<G>& grp,
                                     int u) {
  return subk(t, dbl_e<S>(t, grp, u), grp.ld(S::kD2 + 2 + u), K2);
}
template <class S, int G>
__device__ __forceinline__ Fw dbl_l1(const Group<G>& grp, int u) {
  return triple(grp.ld(S::kD2 + 6 + u));
}
template <class S, int G>
__device__ __forceinline__ Fw dbl_l2(const TowerW& t, const Group<G>& grp,
                                     int u) {
  return negk(t, dbl_h<S>(t, grp, u), K8);
}

// Y3 = g^2 - 3 e^2 + 8p (< 10p) from g^2 and e^2 post-reduced (< 2p).
__device__ __forceinline__ Fw dbl_y3(const TowerW& t, const Fw& g2,
                                     const Fw& e2) {
  return subk(t, g2, triple(e2), K8);
}

// Level A, point step: leaf d < 15 (Karatsuba leaf d % 3 of the Fq2
// product d / 3 of X Y, Y Y, Z Z, X X, (Y + Z)(Y + Z)).
template <class S, int G>
__device__ __forceinline__ void dbl_leaf_ops(const Group<G>& grp, int d,
                                             Fw& x, Fw& y) {
  constexpr int PT = S::kPt;
  const int n = d / 3;
  const int oa = 0x30210 >> (4 * n) & 15;     // 0 X, 1 Y, 2 Z, 3 Y + Z
  const int ob = 0x30211 >> (4 * n) & 15;
  const auto comp = [&](int o, int u) {
    return o < 3 ? grp.ld(PT + 2 * o + u)
                 : add(grp.ld(PT + 2 + u), grp.ld(PT + 4 + u));
  };
  kara_ops(d % 3, [&](int u) { return comp(oa, u); },
           [&](int u) { return comp(ob, u); }, x, y);
}

// Level C, point step: the operands of task d < 10 (a, g, the leaves of
// e^2 and of b h, into slots S::kD3 + d) and, for the iteration, d < 14
// (its line's scaling lb = 3j px, lc = (8p - h) py; px, py at DblSlots'
// kPt + 6, + 7).
template <class S, int G>
__device__ __forceinline__ void dbl_mid_ops(const TowerW& t,
                                            const Group<G>& grp, int d,
                                            Fw& x, Fw& y) {
  constexpr int D2 = S::kD2, PT = S::kPt;
  const int u = d % 2;
  const auto e = [&](int uu) { return dbl_e<S>(t, grp, uu); };
  if (d < 2) {                                   // a = XY tinv
    x = grp.ld(D2 + u);
    y = words_of(t.tinv);
  } else if (d < 4) {                            // g = (b + 3e) tinv
    x = add(grp.ld(D2 + 2 + u), triple(e(u)));
    y = words_of(t.tinv);
  } else if (d < 7) {                            // e e
    kara_ops(d - 4, e, e, x, y);
  } else if (d < 10) {                           // b h
    kara_ops(d - 7, [&](int uu) { return grp.ld(D2 + 2 + uu); },
             [&](int uu) { return dbl_h<S>(t, grp, uu); }, x, y);
  } else if (d < 12) {                           // lb = 3j px
    x = dbl_l1<S>(grp, u);
    y = grp.ld(PT + 6);
  } else {                                       // lc = (8p - h) py
    x = dbl_l2<S>(t, grp, u);
    y = grp.ld(PT + 7);
  }
}

// The sparse line product f (la + lb v + lc v w) (_sparse_line_mul),
// shared by both iterations: leaf k < 45, Karatsuba leaf k % 3 of the Fq2
// product r = k / 3: c6[j] times la, lb, lc, la, lb + lc
// for blocks r / 3 = 0 .. 4 with c6 = f0, f0, f1, f0 + f1, f0 + f1 and
// j = r % 3. f at slots F; la(u) gives la's component u; lb, lc at slots
// LB, LC.
template <int G, class La>
__device__ __forceinline__ void sparse_leaf_ops(const Group<G>& grp, int F,
                                                La la, int LB, int LC, int k,
                                                Fw& x, Fw& y) {
  const int r = k / 3, blk = r / 3, j = r % 3;
  const auto left = [&](int u) {
    const int f0 = F + 2 * j + u, f1 = f0 + 6;
    return blk < 2 ? grp.ld(f0)
                   : blk == 2 ? grp.ld(f1) : add(grp.ld(f0), grp.ld(f1));
  };
  const auto right = [&](int u) {
    const int lb = LB + u, lc = LC + u;
    return blk == 0 || blk == 3 ? la(u)
           : blk == 1           ? grp.ld(lb)
           : blk == 2           ? grp.ld(lc)
                                : add(grp.ld(lb), grp.ld(lc));
  };
  kara_ops(k % 3, left, right, x, y);
}

// Level D, point step: the operands of task d < 10 (d = 0, 1, 4 .. 9 go to
// slot kLeaf + 45 + d; d = 2, 3 are Z3's components): e^2 and Z3 = b h
// post-reduced (x times R mod p), and the leaves of X3 = a (b - 3e + 144p)
// and of g^2.
template <class S, int G>
__device__ __forceinline__ void dbl_late_ops(const TowerW& t,
                                             const Group<G>& grp, int d,
                                             Fw& x, Fw& y) {
  constexpr int D2 = S::kD2, D3 = S::kD3;
  if (d < 4) {                                   // e^2, Z3
    x = kara(t, grp, D3 + (d < 2 ? 4 : 7), d % 2);
    y = words_of(t.f.one);
  } else if (d < 7) {                            // a (b - 3e + 144p)
    kara_ops(d - 4, [&](int u) { return grp.ld(D3 + u); },
             [&](int u) {
               return subk(t, grp.ld(D2 + 2 + u),
                           triple(dbl_e<S>(t, grp, u)), K144);
             }, x, y);
  } else {                                       // g g
    const auto g = [&](int u) { return grp.ld(D3 + 2 + u); };
    kara_ops(d - 7, g, g, x, y);
  }
}

// The sparse product's Fq6 value j = s % 3 of t0 = f0 (la + lb v), t1 =
// f1 lc v, ts = (f0 + f1)(la + (lb + lc) v) for s / 3 = 0, 1, 2 (its Fq6
// products by a + b v and by c v), from its leaves at LEAF into slots T6 + 6 (s / 3)
// + 2 j, + 1.
template <int G>
__device__ __forceinline__ void sparse_comb(const TowerW& t,
                                            const Group<G>& grp, int LEAF,
                                            int T6, int s) {
  const int F = s / 3, j = s % 3;
  const auto P = [&](int blk, int jj, int u) {
    return kara(t, grp, LEAF + 3 * (3 * blk + jj), u);
  };
  const auto xi6 = [&](int blk, int jj, int u) {
    const Fw v0 = P(blk, jj, 0), v1 = P(blk, jj, 1);
    return u == 0 ? subk(t, v0, v1, K6) : add(v0, v1);
  };
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    Fw c;
    if (F == 1) {                                // (c0, c1, c2)(c v)
      c = j == 0 ? xi6(2, 2, u) : P(2, j - 1, u);
    } else {                                     // (c0, c1, c2)(a + b v)
      const int ba = F == 0 ? 0 : 3, bb = ba + 1;
      c = add(P(ba, j, u), j == 0 ? xi6(bb, 2, u) : P(bb, j - 1, u));
    }
    grp.st(T6 + 6 * F + 2 * j + u, c);
  }
}

// The iteration after the lane's inputs are in its slots (f at kF; X, Y, Z
// at kPt; px, py at kPt + 6, kPt + 7): out(kind, c, v) takes f's
// coefficient c (< 2p) and the components c of X3, Y3, Z3.
template <int G, class Out>
__device__ __forceinline__ void miller_dbl(const TowerW& t,
                                           const Group<G>& grp, Out out) {
  using S = DblSlots;
  level(grp, 69, [&](int k) {                    // A
    Fw x, y;
    if (k < 54)
      f12_leaf_ops(grp, S::kF, S::kF, k, x, y);
    else
      dbl_leaf_ops<S>(grp, k - 54, x, y);
    grp.st(S::kLeaf + k, w32::mont(t.f, x, y));
  });
  level(grp, 19, [&](int k) {                    // B
    if (k < 10)
      grp.st(S::kD2 + k, post_red(t, kara(t, grp, S::kLeaf + 54 + 3 * (k / 2),
                                          k % 2)));
    else
      f6_comb(t, grp, S::kLeaf, S::kT6, k - 10);
  });
  level(grp, 28, [&](int k) {                    // C
    Fw x, y;
    int to = S::kF + k;
    if (k < 12) {
      x = f12_comb(t, grp, S::kT6, k, K24, K42);
      y = words_of(t.f.one);
    } else if (k < 26) {
      dbl_mid_ops<S>(t, grp, k - 12, x, y);
      to = S::kD3 + k - 12;
    } else {                                     // l0, no product
      grp.st(S::kD3 + k - 12, dbl_l0<S>(t, grp, k - 26));
      return;
    }
    grp.st(to, w32::mont(t.f, x, y));
  });
  level(grp, 55, [&](int k) {                    // D
    Fw x, y;
    if (k < 45)
      sparse_leaf_ops(grp, S::kF,
                      [&](int u) { return grp.ld(S::kD3 + 14 + u); },
                      S::kD3 + 10, S::kD3 + 12, k, x, y);
    else
      dbl_late_ops<S>(t, grp, k - 45, x, y);
    const Fw r = w32::mont(t.f, x, y);
    if (k == 47 || k == 48)
      out(kOutZ, k - 47, r);
    else
      grp.st(S::kLeaf + k, r);
  });
  level(grp, 13, [&](int k) {                    // E
    if (k < 4) {
      const Fw r = post_red(t, kara(t, grp, S::kLeaf + (k < 2 ? 49 : 52),
                                    k % 2));
      if (k < 2)
        out(kOutX, k, r);
      else
        grp.st(S::kD2 + k - 2, r);
    } else {
      sparse_comb(t, grp, S::kLeaf, S::kT6, k - 4);
    }
  });
  level(grp, 14, [&](int k) {                    // F
    if (k < 12) {
      out(kOutF, k, post_red(t, f12_comb(t, grp, S::kT6, k, K12, K18)));
    } else {
      const int u = k - 12;
      out(kOutY, u, dbl_y3(t, grp.ld(S::kD2 + u), grp.ld(S::kLeaf + 45 + u)));
    }
  });
}

// ------------------------------------------------ the Miller doubling step
//
// R <- 2R and the raw line (l0, l1, l2) = (e - b + 2p, 3j, 8p - h), not
// scaled by P (_dbl_step_body): the point half of miller_dbl on the same
// helpers, without f^2, the sparse product and the line's scaling, in
// five levels of products:
//   A  15: the Karatsuba leaves of X Y, Y^2, Z^2, X^2, (Y + Z)^2;
//   B  10: their post-reductions (XY, b, c, j, u);
//   C  10: a = XY tinv, g = (b + 3e) tinv, the leaves of e^2 and of b h;
//          l0, l1, l2 out (no product);
//   D  10: e^2's and Z3's post-reductions (Z3 out); the leaves of X3 = a
//          (b - 3e + 144p) and of g^2;
//   E   4: X3's post-reduction (out); g^2's, then Y3 = g^2 - 3 e^2 + 8p
//          (out).
// 49 Montgomery products in 9 rounds of G = 8 threads, 14 of the kernel's
// G = 4 (tower_kernels.cu kDblStepGroup). k p offsets and
// bounds as the iteration's point step: X3, Z3 < 2p, Y3 < 10p, l0 < 50p,
// l1 < 6p, l2 < 8p.
//
// The lane's slots: X, Y, Z at kPt; XY, b, c, j, u at kD2; a, g, e^2's
// leaves, b h's leaves at kD3; A's leaves at kLeaf, then D's: e^2 at 0, 1,
// X3's leaves at 4 .. 6, g^2's at 7 .. 9.
struct DblStepSlots {
  static constexpr int kPt = 0, kD2 = 6, kD3 = 16, kLeaf = 26, kSlots = 41;
};

// The step after X, Y, Z are in the lane's slots at kPt: out(kind, c, v)
// takes component c of X3, Y3, Z3, l0, l1, l2.
template <int G, class Out>
__device__ __forceinline__ void miller_dbl_step(const TowerW& t,
                                                const Group<G>& grp,
                                                Out out) {
  using S = DblStepSlots;
  level(grp, 15, [&](int k) {                    // A
    Fw x, y;
    dbl_leaf_ops<S>(grp, k, x, y);
    grp.st(S::kLeaf + k, w32::mont(t.f, x, y));
  });
  level(grp, 10, [&](int k) {                    // B
    grp.st(S::kD2 + k, post_red(t, kara(t, grp, S::kLeaf + 3 * (k / 2),
                                        k % 2)));
  });
  level(grp, 16, [&](int k) {                    // C
    if (k < 10) {
      Fw x, y;
      dbl_mid_ops<S>(t, grp, k, x, y);
      grp.st(S::kD3 + k, w32::mont(t.f, x, y));
    } else {
      const int u = k % 2;
      out(k < 12 ? kOutL0 : k < 14 ? kOutL1 : kOutL2, u,
          k < 12 ? dbl_l0<S>(t, grp, u)
                 : k < 14 ? dbl_l1<S>(grp, u) : dbl_l2<S>(t, grp, u));
    }
  });
  level(grp, 10, [&](int k) {                    // D
    Fw x, y;
    dbl_late_ops<S>(t, grp, k, x, y);
    const Fw r = w32::mont(t.f, x, y);
    if (k == 2 || k == 3)
      out(kOutZ, k - 2, r);
    else
      grp.st(S::kLeaf + k, r);
  });
  level(grp, 4, [&](int k) {                     // E
    const int u = k % 2;
    const Fw r = post_red(t, kara(t, grp, S::kLeaf + (k < 2 ? 4 : 7), u));
    if (k < 2)
      out(kOutX, u, r);
    else
      out(kOutY, u, dbl_y3(t, r, grp.ld(S::kLeaf + u)));
  });
}


// ---------------------------------------------- the Miller addition iteration
//
// f <- f line_{R,Q}(P), R <- R + Q with Q = (xq, yq) affine
// (_add_step_body, _f2_mul_fq for lb = -theta px and lc = lambda py,
// _sparse_line_mul on f), step for step, in eight levels of products (the
// point step's dependency levels, the sparse product's side by side with
// them from the level where j, lb and lc exist) and one without:
//   A   6: the leaves of yq Z and xq Z;
//   B   4: their post-reductions; theta = Y - yqZ + 2p, lambda = X - xqZ +
//          2p follow (no product; each task recomputes them);
//   C  12 + 4: the leaves of theta^2, lambda^2, theta xq, lambda yq;
//          lb = (16p - theta) px, lc = lambda py;
//   D   8: the four post-reductions (cc, d, theta xq, lambda yq); j =
//          theta xq - lambda yq + 2p follows;
//   E  45 + 9: the sparse product's leaves (la = j); the leaves of
//          lambda d, Z cc, X d;
//   F   6 + 9: their post-reductions (e, ff, g); the sparse product's nine
//          Fq6 values (no product); h = e + ff - 2g + 4p follows;
//   G  12 + 12: f's 12 coefficients, post-reduced (f12_comb with K12,
//          K18); the leaves of lambda h, e Z, e Y, theta (g - h + 8p);
//   H   8: their post-reductions: X3, Z3 out; eY, theta (g - h + 8p);
//   I   2 (no product): Y3 = theta (g - h + 8p) - eY + 2p.
// 126 Montgomery products in 17 rounds of G = 8 threads.
//
// The point step is _add_step_body's 13 Fq2 products, 65 Montgomery
// products: each a Karatsuba product post-reduced to < 2p (_f2_mulred;
// the squares theta^2, lambda^2 _f2_sqrred), yq Z, xq Z, cc = theta^2,
// d = lambda^2, e = lambda d, ff = Z cc, g = X d, X3 = lambda h, Z3 = e Z,
// e Y, theta (g - h + 8p), theta xq, lambda yq; the rest exact adds and
// k p subtractions.
//
// Bounds (the reference's audit of _add_step_body and _sparse_line_mul;
// units of p): f, X, Z < 2; Y < 10; xq, yq, px, py < 1.
//   * theta < 12, lambda < 4 (yqZ, xqZ < 2 post-reduced); the widest leaf
//     of C, (theta0 + theta1)^2 < 24^2; -theta = 16 - theta < 16.
//   * cc, d, theta xq, lambda yq < 2; j < 4; lb, lc < 2.
//   * E: (lambda0 + lambda1)(d0 + d1) < 8 4, (Z0 + Z1)(cc0 + cc1) < 4 4,
//     (X0 + X1)(d0 + d1) < 4 4; the sparse leaves as the doubling
//     iteration's with la < 4 (there < 50): (s0 + s1)(la0 + la1) < 8 8.
//   * e, ff, g < 2; h = (e + ff) - 2g + 4 < 8 (2g < 4); g - h + 8 < 10.
//   * G: (lambda0 + lambda1)(h0 + h1) < 8 16, (e0 + e1)(Y0 + Y1) < 4 20,
//     (theta0 + theta1)((g - h + 8)0 + (g - h + 8)1) < 24 20 = 480, each
//     <= 2^16; the sparse product's Fq6 values < 18, raw < 54 (K12, K18).
//   * X3, Z3 < 2; Y3 = theta (g - h + 8) - eY + 2 < 4; the step's line
//     j < 4, -theta < 16, lambda < 4.
//
// The lane's slots: f at kF; leaves at kLeaf (A's at 0 .. 5, C's at 0 ..
// 11, E's at 0 .. 53, G's at 0 .. 11); the sparse product's Fq6 values at
// kT6; X, Y, Z, xq, yq, px, py at kPt; yqZ, xqZ (then eY, theta (g - h +
// 8p)) at kB; lb, lc at kC; cc, d, theta xq, lambda yq at kD; e, ff, g at
// kE.
struct AddSlots {
  static constexpr int kF = 0, kLeaf = 12, kT6 = 66, kPt = 84, kB = 96,
                       kC = 100, kD = 104, kE = 112, kSlots = 118;
};

// The point levels' helpers below read X, Y, Z, xq, yq at slots S::kPt ..
// S::kPt + 9, yqZ and xqZ at S::kB, cc, d, theta xq, lambda yq at S::kD
// and e, ff, g at S::kE (AddSlots for the iteration, AddStepSlots for the
// step).

// theta (u = 0, 1) = Y - yqZ + 2p and lambda (u = 2, 3) = X - xqZ + 2p.
template <class S, int G>
__device__ __forceinline__ Fw add_tl(const TowerW& t, const Group<G>& grp,
                                     int u) {
  const int c = u % 2, pt = u < 2 ? S::kPt + 2 : S::kPt;
  return subk(t, grp.ld(pt + c), grp.ld(S::kB + u), K2);
}

// h = (e + ff) - 2g + 4p, component u.
template <class S, int G>
__device__ __forceinline__ Fw add_h(const TowerW& t, const Group<G>& grp,
                                    int u) {
  constexpr int E = S::kE;
  return subk(t, add(grp.ld(E + u), grp.ld(E + 2 + u)),
              dbl(grp.ld(E + 4 + u)), K4);
}

// j = theta xq - lambda yq + 2p (< 4p), component u: the step's l0, the
// iteration's la.
template <class S, int G>
__device__ __forceinline__ Fw add_j(const TowerW& t, const Group<G>& grp,
                                    int u) {
  return subk(t, grp.ld(S::kD + 4 + u), grp.ld(S::kD + 6 + u), K2);
}

// Y3 = theta (g - h + 8p) - eY + 2p (< 4p), component u, from eY and
// theta (g - h + 8p) post-reduced at S::kB, S::kB + 2 (level H's).
template <class S, int G>
__device__ __forceinline__ Fw add_y3(const TowerW& t, const Group<G>& grp,
                                     int u) {
  return subk(t, grp.ld(S::kB + 2 + u), grp.ld(S::kB + u), K2);
}

// The operands of Karatsuba leaf k % 3 of the Fq2 product k / 3 of one
// point-step level: L names each product's two operands by component.
template <class L>
__device__ __forceinline__ void add_leaf_ops(int k, L operand, Fw& x, Fw& y) {
  const int n = k / 3;
  kara_ops(k % 3, [&](int u) { return operand(n, 0, u); },
           [&](int u) { return operand(n, 1, u); }, x, y);
}

// Level A, point step: leaf k < 6 of yq Z, xq Z.
template <class S, int G>
__device__ __forceinline__ void add_a_ops(const Group<G>& grp, int k, Fw& x,
                                          Fw& y) {
  add_leaf_ops(k, [&](int n, int o, int u) {
    return grp.ld(S::kPt + 2 * (o == 0 ? 4 - n : 2) + u);
  }, x, y);
}

// Level C, point step: leaf k < 12 of theta^2, lambda^2, theta xq,
// lambda yq.
template <class S, int G>
__device__ __forceinline__ void add_c_ops(const TowerW& t,
                                          const Group<G>& grp, int k, Fw& x,
                                          Fw& y) {
  add_leaf_ops(k, [&](int n, int o, int u) {
    if (o == 0 || n < 2) return add_tl<S>(t, grp, (n % 2 == 0 ? 0 : 2) + u);
    return grp.ld(S::kPt + 2 * (n + 1) + u);
  }, x, y);
}

// Level E, point step: leaf k < 9 of lambda d, Z cc, X d.
template <class S, int G>
__device__ __forceinline__ void add_e_ops(const TowerW& t,
                                          const Group<G>& grp, int k, Fw& x,
                                          Fw& y) {
  add_leaf_ops(k, [&](int n, int o, int u) {
    if (o == 1) return grp.ld(S::kD + (n == 1 ? 0 : 2) + u);
    return n == 0 ? add_tl<S>(t, grp, 2 + u)
                  : grp.ld(S::kPt + (n == 1 ? 4 : 0) + u);
  }, x, y);
}

// Level G, point step: leaf k < 12 of lambda h, e Z, e Y, theta (g - h +
// 8p).
template <class S, int G>
__device__ __forceinline__ void add_g_ops(const TowerW& t,
                                          const Group<G>& grp, int k, Fw& x,
                                          Fw& y) {
  add_leaf_ops(k, [&](int n, int o, int u) {
    if (o == 0) {
      if (n == 0) return add_tl<S>(t, grp, 2 + u);
      return n == 3 ? add_tl<S>(t, grp, u) : grp.ld(S::kE + u);
    }
    if (n == 0) return add_h<S>(t, grp, u);
    if (n == 3)
      return subk(t, grp.ld(S::kE + 4 + u), add_h<S>(t, grp, u), K8);
    return grp.ld(S::kPt + (n == 1 ? 4 : 2) + u);
  }, x, y);
}

// The iteration after the lane's inputs are in its slots (f at kF; X, Y,
// Z, xq, yq at kPt .. kPt + 9; px, py at kPt + 10, kPt + 11): out(kind, c,
// v) takes f's coefficient c (< 2p) and the components c of X3, Y3, Z3.
template <int G, class Out>
__device__ __forceinline__ void miller_add(const TowerW& t,
                                           const Group<G>& grp, Out out) {
  using S = AddSlots;
  const auto red = [&](int L, int u) {
    return post_red(t, kara(t, grp, L, u));
  };
  level(grp, 6, [&](int k) {                     // A: yq Z, xq Z
    Fw x, y;
    add_a_ops<S>(grp, k, x, y);
    grp.st(S::kLeaf + k, w32::mont(t.f, x, y));
  });
  level(grp, 4, [&](int k) {                     // B
    grp.st(S::kB + k, red(S::kLeaf + 3 * (k / 2), k % 2));
  });
  level(grp, 16, [&](int k) {                    // C
    Fw x, y;
    int to = S::kLeaf + k;
    if (k < 12) {               // theta^2, lambda^2, theta xq, lambda yq
      add_c_ops<S>(t, grp, k, x, y);
    } else if (k < 14) {        // lb = (16p - theta) px
      x = negk(t, add_tl<S>(t, grp, k - 12), K16);
      y = grp.ld(S::kPt + 10);
      to = S::kC + k - 12;
    } else {                    // lc = lambda py
      x = add_tl<S>(t, grp, k - 12);
      y = grp.ld(S::kPt + 11);
      to = S::kC + k - 12;
    }
    grp.st(to, w32::mont(t.f, x, y));
  });
  level(grp, 8, [&](int k) {                     // D
    grp.st(S::kD + k, red(S::kLeaf + 3 * (k / 2), k % 2));
  });
  level(grp, 54, [&](int k) {                    // E
    Fw x, y;
    if (k < 45)                 // la = j
      sparse_leaf_ops(grp, S::kF,
                      [&](int u) { return add_j<S>(t, grp, u); }, S::kC,
                      S::kC + 2, k, x, y);
    else                        // lambda d, Z cc, X d
      add_e_ops<S>(t, grp, k - 45, x, y);
    grp.st(S::kLeaf + k, w32::mont(t.f, x, y));
  });
  level(grp, 15, [&](int k) {                    // F
    if (k < 6)
      grp.st(S::kE + k, red(S::kLeaf + 45 + 3 * (k / 2), k % 2));
    else
      sparse_comb(t, grp, S::kLeaf, S::kT6, k - 6);
  });
  level(grp, 24, [&](int k) {                    // G
    if (k < 12) {
      out(kOutF, k, post_red(t, f12_comb(t, grp, S::kT6, k, K12, K18)));
      return;
    }
    Fw x, y;                    // lambda h, e Z, e Y, theta (g - h + 8p)
    add_g_ops<S>(t, grp, k - 12, x, y);
    grp.st(S::kLeaf + k - 12, w32::mont(t.f, x, y));
  });
  level(grp, 8, [&](int k) {                     // H
    const Fw r = red(S::kLeaf + 3 * (k / 2), k % 2);
    if (k < 4)
      out(k < 2 ? kOutX : kOutZ, k % 2, r);
    else
      grp.st(S::kB + k - 4, r);
  });
  level(grp, 2, [&](int u) {                     // I
    out(kOutY, u, add_y3<S>(t, grp, u));
  });
}

// ------------------------------------------------ the Miller addition step
//
// R <- R + Q and the raw line (l0, l1, l2) = (j, 16p - theta, lambda), not
// scaled by P (_add_step_body): the point half of miller_add on the same
// helpers, without f, the sparse product and the line's scaling, in eight
// levels of products and one without:
//   A   6: the leaves of yq Z and xq Z;
//   B   4: their post-reductions (yqZ, xqZ);
//   C  12: the leaves of theta^2, lambda^2, theta xq, lambda yq; l1 =
//          16p - theta and l2 = lambda out (no product);
//   D   8: the four post-reductions (cc, d, theta xq, lambda yq);
//   E   9: the leaves of lambda d, Z cc, X d; l0 = j = theta xq - lambda yq
//          + 2p out (no product);
//   F   6: their post-reductions (e, ff, g);
//   G  12: the leaves of lambda h, e Z, e Y, theta (g - h + 8p);
//   H   8: their post-reductions: X3, Z3 out; eY, theta (g - h + 8p);
//   I   2 (no product): Y3 = theta (g - h + 8p) - eY + 2p out.
// 65 Montgomery products in 11 rounds of G = 8 threads (18 at G = 4, 8 at
// G = 16; tower_kernels.cu kAddStepGroup). k p offsets and bounds as the
// iteration's point step: X3, Z3 < 2p, Y3 < 4p, l0 < 4p, l1 < 16p,
// l2 < 4p.
//
// The lane's slots: X, Y, Z, xq, yq at kPt; yqZ, xqZ (then eY, theta (g -
// h + 8p)) at kB; cc, d, theta xq, lambda yq at kD; e, ff, g at kE; the
// leaves of A, C, E and G at kLeaf (6, 12, 9 and 12 of them).
struct AddStepSlots {
  static constexpr int kPt = 0, kB = 10, kD = 14, kE = 22, kLeaf = 28,
                       kSlots = 40;
};

// The step after X, Y, Z, xq, yq are in the lane's slots at kPt:
// out(kind, c, v) takes component c of X3, Y3, Z3, l0, l1, l2.
template <int G, class Out>
__device__ __forceinline__ void miller_add_step(const TowerW& t,
                                                const Group<G>& grp,
                                                Out out) {
  using S = AddStepSlots;
  const auto red = [&](int k) {
    return post_red(t, kara(t, grp, S::kLeaf + 3 * (k / 2), k % 2));
  };
  const auto leaf = [&](int k, const Fw& x, const Fw& y) {
    grp.st(S::kLeaf + k, w32::mont(t.f, x, y));
  };
  level(grp, 6, [&](int k) {                     // A: yq Z, xq Z
    Fw x, y;
    add_a_ops<S>(grp, k, x, y);
    leaf(k, x, y);
  });
  level(grp, 4, [&](int k) { grp.st(S::kB + k, red(k)); });      // B
  level(grp, 16, [&](int k) {                    // C
    if (k < 12) {
      Fw x, y;
      add_c_ops<S>(t, grp, k, x, y);
      leaf(k, x, y);
    } else {                    // l1 = 16p - theta, l2 = lambda
      const Fw v = add_tl<S>(t, grp, k - 12);
      out(k < 14 ? kOutL1 : kOutL2, k % 2, k < 14 ? negk(t, v, K16) : v);
    }
  });
  level(grp, 8, [&](int k) { grp.st(S::kD + k, red(k)); });      // D
  level(grp, 11, [&](int k) {                    // E
    if (k < 9) {
      Fw x, y;
      add_e_ops<S>(t, grp, k, x, y);
      leaf(k, x, y);
    } else {                    // l0 = j
      out(kOutL0, k - 9, add_j<S>(t, grp, k - 9));
    }
  });
  level(grp, 6, [&](int k) { grp.st(S::kE + k, red(k)); });      // F
  level(grp, 12, [&](int k) {                    // G
    Fw x, y;
    add_g_ops<S>(t, grp, k, x, y);
    leaf(k, x, y);
  });
  level(grp, 8, [&](int k) {                     // H
    const Fw r = red(k);
    if (k < 4)
      out(k < 2 ? kOutX : kOutZ, k % 2, r);
    else
      grp.st(S::kB + k - 4, r);
  });
  level(grp, 2, [&](int u) { out(kOutY, u, add_y3<S>(t, grp, u)); });  // I
}

}  // namespace tw
}  // namespace gs
