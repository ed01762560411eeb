// The complete doubling, add and mixed add (RCB16 Algorithms 9, 7 and 8,
// a = 0) of the kernels cdbl_n_add and cmadd on packed 32-bit words
// (field_w32.cuh), worked by a group of G threads per lane (group_w32.cuh),
// for G1 (S = 1 Fq component a coordinate) and G2 (S = 2, Fq2).
//
// The formulas, k p offsets and order are the reference's _cdbl_body,
// _cadd_body and _cmadd_body (groth_sahai_tpu/ops/pallas_curve.py), as the
// plain versions of ops/cuda_curve.py write them: every value is the same
// integer, so the 16-bit limbs at the boundary equal cdbl_n_add_plain's
// and cmadd_plain's. A product is field_w32.cuh's mont on G1, and on G2
// the Karatsuba of the reference's _f2_mulred: leaves t0 = a0 b0, t1 = a1 b1, t2 = (a0 + a1)(b0 + b1), then
// c0 = t0 - t1 + 2p and c1 = t2 - t0 - t1 + 4p, each times R mod p. b3 = 3b
// is x12 on G1 (b = 4); on G2 (b' = 4(u + 1)) the xi twist (a0 - a1 + k p,
// a0 + a1), then x12.
//
// Levels. A level of field products is one level of Montgomery products on
// G1 (a task a product) and two on G2 (a task a Karatsuba leaf, then a task
// a post-reduced component). The operands' exact adds, doublings, x12 and
// k p subtractions are each task's own code: a thread recomputes them from
// the slots the last level wrote rather than wait a level for them.
//   doubling: Y Y, Y Z, Z Z, X Y; then t2 Z3, t1 Z3, t0' Y3, t0' (X Y)
//     with t2 = b3(Z Z), Z3 = 8 t0, Y3 = t0 + t2, t0' = t0 - 3 t2 + 144p.
//     The doubled point stays as those four products (v = t0' (X Y),
//     u = t0' Y3: X = v + v, Y = t2 Z3 + u, Z = t1 Z3), summed by the
//     tasks that read its coordinates (a Pt of slot sums).
//   add: X1 X2, Y1 Y2, Z1 Z2, (X1 + Y1)(X2 + Y2), (Y1 + Z1)(Y2 + Z2),
//     (X1 + Z1)(X2 + Z2); then the finish's six (add_finish): t3' t1',
//     t4' Y3', t1' Z3, Y3' t0', Z3 t4', t0' t3'; then a level without
//     products that stores X3 = a - b + 2p, Y3 = c + d, Z3 = e + g.
//   mixed add: X1 x2, Y1 y2, (x2 + y2)(X1 + Y1), y2 Z1, x2 Z1; then the
//     add's finish and store levels with its own operand forms: t3' =
//     t3 - (t0 + t1) + 4p, t4' = y2 Z1 + Y1, t0' = 3 t0, t2' = b3(Z1)
//     (offset 4p), Z3 = t1 + t2', t1' = t1 - t2' + 96p, Y3' = b3(x2 Z1 +
//     X1) (offset 8p). A lane whose affine point is at infinity makes no
//     product (the kernel copies its accumulator).
// Rounds of products a lane, at G = 4, 8, 16, 32 threads: a G1 doubling 2
// at each G, a G1 add 4, 2, 2, 2; a G2 doubling 10, 6, 4, 4, a G2 add 16,
// 10, 6, 4. A mixed add at G = 2, 4, 8, 16, 32: G1 6, 4, 2, 2, 2 where one
// thread makes 11 products; G2 28, 15, 9, 5, 4 where one thread makes 55.
//
// Bounds (units of p; every mont operand below 2^400, as mont reads word 12
// as 16 bits; value(a) value(b) <= 2^16 p^2 with the Fq2 Karatsuba sums
// counted; every sum < 2^416). Coordinates in < 4p; products < 2p.
//   doubling: the widest leaf of the first level (X0 + X1)(Y0 + Y1) < 8p
//     8p; t2 < 24p (G1), < 48p (G2: 12 (zz0 - zz1 + 2p), 12 (zz0 + zz1));
//     Z3 = 8 t0 < 16p; Y3 = t0 + t2 < 50p; 3 t2 < 144p, so t0' = t0 - 3 t2
//     + 144p < 146p; the widest leaf (t0'0 + t0'1)(Y3_0 + Y3_1) < 292p
//     100p. Out: X3 = 2v < 4p, Y3 = t2 Z3 + u < 4p, Z3 < 2p.
//   add: the first level's widest leaf (16p)(16p); t3', t4', Y3r < 6p
//     (offsets 4p), t0' = 3 t0 < 6p, t2' = b3(t2) < 48p (offset 2p),
//     Z3 = t1 + t2' < 50p, t1' = t1 - t2' + 48p < 50p, Y3' = b3(Y3r)
//     (offset 8p) < 168p (G2 c0; c1 < 144p; G1 < 72p); the widest leaves
//     (t1'0 + t1'1)(Z3_0 + Z3_1) < 100p 100p and (t4'0 + t4'1)(Y3'0 +
//     Y3'1) < 12p 312p. Out: X3 = a - b + 2p < 4p, Y3, Z3 < 4p.
//   mixed add (accumulator < 4p, affine < 2p): the first level's widest
//     leaf (x2 + y2, both components) < 8p times (X1 + Y1) < 16p; t3', t4',
//     Y3r = x2 Z1 + X1 < 6p, t0' < 6p, t2' < 96p (G2: 12 (Z0 - Z1 + 4p);
//     G1 12 Z1 < 48p), Z3 < 98p, t1' = t1 - t2' + 96p < 98p, Y3' < 168p
//     (G2 c0; c1 < 144p; G1 < 72p); the widest leaves (t1'0 + t1'1)(Z3_0 +
//     Z3_1) < 196p 196p and (t4'0 + t4'1)(Y3'0 + Y3'1) < 12p 312p. Out:
//     X3, Y3, Z3 < 4p.
#pragma once

#include <cstdint>

#include "field_w32.cuh"
#include "group_w32.cuh"

namespace gs {
namespace cw {

using w32::add;
using w32::dbl;
using w32::Fw;
using w32::Group;
using w32::kWords;
using w32::level;
using w32::mul12;
using w32::sub;
using w32::triple;

// The k of the curve's k p offsets.
enum Kp { K2, K4, K8, K48, K96, K144, kKinds };
constexpr uint32_t kKp[kKinds] = {2, 4, 8, 48, 96, 144};

// The constants of a launch, passed by value (the kernel-parameter bank):
// mont's field and the curve's k p. field_w32.cuh's FieldW is cadd's and
// cmsm_row_scan's, and keeps its own k p table.
struct CurveW {
  w32::FieldW f;
  uint32_t kp[kKinds][kWords];
};

inline CurveW make_curve_w(const uint32_t* p16, const uint32_t* one16,
                           uint32_t n0) {
  CurveW t;
  t.f = w32::make_field_w(p16, one16, n0);
  uint32_t p[kWords];
  w32::pack_host(p16, p);
  w32::kp_words(p, kKp, kKinds, t.kp);
  return t;
}

// The lane's slots (Fq slots; a coordinate takes S, component u at + u):
// Q, P as loaded, a zero coordinate, the G2 Karatsuba leaves (18: an add's
// six products), a level's products (six), the doubled point's four
// products, the add's six finish products.
template <int S>
struct CurveSlots {
  static constexpr int kQ = 0, kP = 3 * S, kZero = 6 * S, kLeaf = 7 * S,
                       kMid = kLeaf + (S == 2 ? 18 : 0), kDbl = kMid + 6 * S,
                       kFin = kDbl + 4 * S, kSlots = kFin + 6 * S;
};

// a - b + k p, formed as (a + k p) - b; bound(b) <= k p.
__device__ __forceinline__ Fw subk(const CurveW& t, const Fw& a, const Fw& b,
                                   Kp k) {
  return sub(add(a, t.kp[k]), b);
}

// Component u of a 3b from a(w), the components of a: 12 a on G1; on G2
// 12 (a0 - a1 + k p) or 12 (a0 + a1), bound(a) <= k p.
template <int S, class A>
__device__ __forceinline__ Fw b3(const CurveW& t, A a, int u, Kp k) {
  if constexpr (S == 1) {
    return mul12(a(0));
  } else {
    const Fw a0 = a(0), a1 = a(1);
    return mul12(u == 0 ? subk(t, a0, a1, k) : add(a0, a1));
  }
}

// A point whose coordinates are slot sums: X = xa + xb, Y = ya + yb, Z = z
// (component u at + u). A loaded point adds the zero coordinate; a doubled
// one is its four products.
struct Pt {
  int xa, xb, ya, yb, z;
};

template <int S>
__device__ __forceinline__ Pt loaded(int at) {
  using L = CurveSlots<S>;
  return Pt{at, L::kZero, at + S, L::kZero, at + 2 * S};
}

// Component u of coordinate c (0 X, 1 Y, 2 Z) of p.
template <int G>
__device__ __forceinline__ Fw coord(const Group<G>& grp, const Pt& p, int c,
                                    int u) {
  if (c == 2) return grp.ld(p.z + u);
  return c == 0 ? add(grp.ld(p.xa + u), grp.ld(p.xb + u))
                : add(grp.ld(p.ya + u), grp.ld(p.yb + u));
}

// n field products into slots OUT + S k + u, product k of the operands
// ops(k, u, x, y) gives (component u of each). G1: one level, a Montgomery
// product a task. G2: the Karatsuba leaves q = 0, 1, 2 of each product (3 n
// tasks, into LEAF + 3 k + q: the operands' components 0, components 1,
// and the sums of both), then c0 = t0 - t1 + 2p and c1 = t2 - t0 - t1 + 4p
// post-reduced (2 n tasks).
template <int S, int G, class Ops>
__device__ __forceinline__ void products(const CurveW& t, const Group<G>& grp,
                                         int n, int LEAF, int OUT, Ops ops) {
  if constexpr (S == 1) {
    level(grp, n, [&](int k) {
      Fw x, y;
      ops(k, 0, x, y);
      grp.st(OUT + k, w32::mont(t.f, x, y));
    });
  } else {
    level(grp, 3 * n, [&](int j) {
      const int q = j % 3;
      Fw x{}, y{};
#pragma unroll 1
      for (int u = q == 1; u <= (q != 0); ++u) {
        Fw a, b;
        ops(j / 3, u, a, b);
        x = add(x, a);
        y = add(y, b);
      }
      grp.st(LEAF + j, w32::mont(t.f, x, y));
    });
    level(grp, 2 * n, [&](int j) {
      const int L = LEAF + 3 * (j / 2);
      const Fw t0 = grp.ld(L), t1 = grp.ld(L + 1);
      const Fw c = j % 2 == 0 ? subk(t, t0, t1, K2)
                              : sub(subk(t, grp.ld(L + 2), t0, K4), t1);
      grp.st(OUT + j, w32::mont(t.f, c, w32::words_of(t.f.one)));
    });
  }
}

// One complete doubling of p (cdbl_body); returns 2p, left as four
// products at kDbl.
template <int S, int G>
__device__ __forceinline__ Pt cdbl(const CurveW& t, const Group<G>& grp,
                                   const Pt& p) {
  using L = CurveSlots<S>;
  constexpr int M = L::kMid, D = L::kDbl;
  // t0 = Y Y, t1 = Y Z, zz = Z Z, xy = X Y
  products<S>(t, grp, 4, L::kLeaf, M, [&](int k, int u, Fw& x, Fw& y) {
    x = coord(grp, p, 0x0211 >> (4 * k) & 15, u);
    y = coord(grp, p, 0x1221 >> (4 * k) & 15, u);
  });
  const auto T = [&](int i, int u) { return grp.ld(M + S * i + u); };
  // t2 Z3, t1 Z3, t0' Y3, t0' xy
  products<S>(t, grp, 4, L::kLeaf, D, [&](int k, int u, Fw& x, Fw& y) {
    const Fw t0 = T(0, u);
    if (k == 1) {
      x = T(1, u);
      y = dbl(dbl(dbl(t0)));                             // Z3 = 8 t0
      return;
    }
    const Fw t2 = b3<S>(t, [&](int w) { return T(2, w); }, u, K2);
    if (k == 0) {
      x = t2;
      y = dbl(dbl(dbl(t0)));
    } else {
      x = subk(t, t0, triple(t2), K144);                 // t0'
      y = k == 2 ? add(t0, t2) : T(3, u);                // Y3, xy
    }
  });
  return Pt{D + 3 * S, D + 3 * S, D, D + 2 * S, D + S};
}

// The last two levels of an add (the finish of _cadd_body and of
// _cmadd_body): six products t3' t1', t4' Y3', t1' Z3, Y3' t0',
// Z3 t4', t0' t3' into kFin, with t1' = t1 - t2' + k1 p and Z3 = t1 + t2';
// then a level without products that gives out(c, u, v) component u of
// X3 = a - b + 2p, Y3 = c + d, Z3 = e + g. The operand forms are the
// caller's, each component u of a value formed from the slots its first
// level wrote: t0' (t0p), t1, t2' (t2p), t3', t4', Y3' (y3p).
template <int S, int G, class T0, class T1, class T2, class T3, class T4,
          class Y3, class Out>
__device__ __forceinline__ void add_finish(const CurveW& t,
                                           const Group<G>& grp, T0 t0p,
                                           T1 t1, T2 t2p, T3 t3p, T4 t4p,
                                           Y3 y3p, Kp k1, Out out) {
  using L = CurveSlots<S>;
  constexpr int F = L::kFin;
  products<S>(t, grp, 6, L::kLeaf, F, [&](int k, int u, Fw& x, Fw& y) {
    if (k == 1 || k == 3) {
      x = y3p(u);
      y = k == 1 ? t4p(u) : t0p(u);
    } else if (k == 5) {
      x = t0p(u);
      y = t3p(u);
    } else {
      const Fw t1u = t1(u), t2 = t2p(u);
      const Fw t1p = subk(t, t1u, t2, k1), z3 = add(t1u, t2);
      if (k == 0) {
        x = t3p(u);
        y = t1p;
      } else if (k == 2) {
        x = t1p;
        y = z3;
      } else {
        x = z3;
        y = t4p(u);
      }
    }
  });
  level(grp, 3 * S, [&](int j) {
    const int c = j / S, u = j % S;
    const Fw a = grp.ld(F + 2 * S * c + u), b = grp.ld(F + S * (2 * c + 1) + u);
    out(c, u, c == 0 ? subk(t, a, b, K2) : add(a, b));
  });
}

// p + q (cadd_body), out(c, u, v) taking component u of coordinate c of
// the sum.
template <int S, int G, class Out>
__device__ __forceinline__ void cadd(const CurveW& t, const Group<G>& grp,
                                     const Pt& p, const Pt& q, Out out) {
  using L = CurveSlots<S>;
  constexpr int M = L::kMid;
  // t0 = X1 X2, t1 = Y1 Y2, t2 = Z1 Z2, t3 = (X1 + Y1)(X2 + Y2),
  // t4 = (Y1 + Z1)(Y2 + Z2), t5 = (X1 + Z1)(X2 + Z2)
  products<S>(t, grp, 6, L::kLeaf, M, [&](int k, int u, Fw& x, Fw& y) {
    const auto side = [&](const Pt& r) {
      const Fw a = coord(grp, r, 0x010210 >> (4 * k) & 15, u);
      return k < 3 ? a : add(a, coord(grp, r, 0x221 >> (4 * (k - 3)) & 15, u));
    };
    x = side(p);
    y = side(q);
  });
  const auto T = [&](int i, int u) { return grp.ld(M + S * i + u); };
  add_finish<S>(
      t, grp, [&](int u) { return triple(T(0, u)); },     // t0' = 3 t0 < 6p
      [&](int u) { return T(1, u); },
      [&](int u) {                                        // b3(t2) < 48p
        return b3<S>(t, [&](int w) { return T(2, w); }, u, K2);
      },
      [&](int u) {                                        // < 6p
        return subk(t, T(3, u), add(T(0, u), T(1, u)), K4);
      },
      [&](int u) {                                        // < 6p
        return subk(t, T(4, u), add(T(1, u), T(2, u)), K4);
      },
      [&](int u) {                                        // b3(Y3r) < 168p
        return b3<S>(t, [&](int w) {
          return subk(t, T(5, w), add(T(0, w), T(2, w)), K4);
        }, u, K8);
      },
      K48, out);
}

// p + a (cmadd_body) for an accumulator p at slots kP (coordinates < 4p)
// and an affine point a = (x2, y2) at slots kQ (< 2p) that is not at
// infinity; out(c, u, v) takes component u of coordinate c of the sum.
// Its twin is curve_w32.cuh's one-thread cmadd_body (the row scan): the
// same formulas and k p offsets (K4 for t3, K96 for t1', K4 and K8 in the
// two b3), written there as one chain. An edit to an offset here is made
// there too; chip_smoke.py holds both kernels against their plain versions.
template <int S, int G, class Out>
__device__ __forceinline__ void cmadd(const CurveW& t, const Group<G>& grp,
                                      Out out) {
  using L = CurveSlots<S>;
  constexpr int M = L::kMid;
  const auto P = [&](int c, int u) { return grp.ld(L::kP + S * c + u); };
  const auto A = [&](int c, int u) { return grp.ld(L::kQ + S * c + u); };
  // t0 = X1 x2, t1 = Y1 y2, t3 = (x2 + y2)(X1 + Y1), y2 Z1, x2 Z1
  products<S>(t, grp, 5, L::kLeaf, M, [&](int k, int u, Fw& x, Fw& y) {
    if (k == 2) {
      x = add(A(0, u), A(1, u));
      y = add(P(0, u), P(1, u));
    } else {
      x = k < 2 ? P(k, u) : A(4 - k, u);
      y = k < 2 ? A(k, u) : P(2, u);
    }
  });
  const auto T = [&](int i, int u) { return grp.ld(M + S * i + u); };
  add_finish<S>(
      t, grp, [&](int u) { return triple(T(0, u)); },     // t0' = 3 t0 < 6p
      [&](int u) { return T(1, u); },
      [&](int u) {                                        // b3(Z1) < 96p
        return b3<S>(t, [&](int w) { return P(2, w); }, u, K4);
      },
      [&](int u) {                                        // < 6p
        return subk(t, T(2, u), add(T(0, u), T(1, u)), K4);
      },
      [&](int u) { return add(T(3, u), P(1, u)); },       // t4 < 6p
      [&](int u) {                                        // b3(Y3r) < 168p
        return b3<S>(t, [&](int w) { return add(T(4, w), P(0, w)); }, u,
                     K8);
      },
      K96, out);
}

}  // namespace cw
}  // namespace gs
