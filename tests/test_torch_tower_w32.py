"""The grouped packed-word tower of cyc_pow, cyc_sqr, f12_pow_dyn, the two
Miller iterations and the two Miller steps.

`csrc/tower_w32.cuh` cuts an Fq12 product, a cyclotomic square, the Miller
doubling and addition iterations and their steps into levels of independent
tasks that the G threads of a lane's group take round-robin, each task
reading Fq slots of the lane's shared memory that earlier levels wrote and
writing its own. The kernels run only on a card, so this file holds a
pure-Python twin of that schedule -- the same levels, tasks, slots and k p
offsets, each Montgomery product through the twin of the packed-word
product in test_torch_words.py -- and holds it limb for limb against the
plain versions `cuda_tower.cyc_pow_plain`, `cyc_sqr_plain`,
`f12_pow_dyn_plain`, `miller_iter_dbl_plain`, `miller_iter_add_plain`,
`miller_dbl_step_plain` and `miller_add_step_plain` (each step on its
iteration's point levels and helpers; themselves held against the JAX
package in test_torch_cuda_tower.py and test_torch_cuda_miller.py), on
seeded inputs and on the edges chip_smoke.py uses. The twin asserts the
bound audit at every step (Montgomery operands < 2^400 with value(a)
value(b) <= 2^16 p^2, sums < 2^416, every k p subtraction non-negative),
that no task reads a slot before a level wrote it, and that no two tasks of
a level touch a slot that one of them writes, so the threads of a group may
take the tasks in any order; and it counts the rounds of products the
header states. For schedules of tens of thousands of products
(f12_pow_dyn's 272 rounds, the curve twin's thousands of lanes) a FastLane
computes each Montgomery product from its closed form (a b + M p) / 2^400
with M = -a b p^-1 mod 2^400, the one integer that the packed-word
product's instruction twin gives (test_torch_words.py), under the same
bound asserts.
"""

from __future__ import annotations

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from groth_sahai_tpu_torch.ops import bls12_381 as C
from groth_sahai_tpu_torch.ops import cuda_tower as CT
from groth_sahai_tpu_torch.ops.fp import FQ
from groth_sahai_tpu_torch.utils.convert import limbs_from_numpy

from .test_torch_cuda_tower import with_edges
from .test_torch_tower import one_thread, rand_coeffs  # noqa: F401
from .test_torch_words import MASK, NPW, NW, mont_w32, n0w_newton

P = C.P
ONE = FQ.r_mod_p
R_INV = pow(1 << 400, -1, P)
NEG_P_INV = -pow(P, -1, 1 << 400) % (1 << 400)
KP = {k: k * P for k in (2, 4, 6, 8, 12, 16, 18, 24, 42, 144)}  # tower_w32
PW = [(P >> (32 * k)) & MASK for k in range(NPW)]
N0W = n0w_newton(PW[0])


def words(v: int):
    return [(v >> (32 * k)) & MASK for k in range(NW)]


def add(a, b):
    assert a + b < 1 << 400                # < 2^416 for the packed words,
    return a + b                           # < 2^400 for the 16-bit limbs


def subk(a, b, k):
    """a - b + k p, formed as (a + k p) - b; bound(b) <= k p."""
    assert b <= KP[k] and a + KP[k] < 1 << 400
    return add(a, KP[k]) - b


def negk(a, k):
    assert a <= KP[k]
    return KP[k] - a


def dbl(a):
    return add(a, a)


def triple(a):
    return add(dbl(a), a)


def mul12(a):
    assert 12 * a < 1 << 400
    return 12 * a


class Lane:
    """One lane's Fq slots and the group's levels over them: tasks run one
    after another, each read and write recorded by task, and a level's
    hazards checked when it ends. Counts the Montgomery products of each
    task, for the rounds."""

    def __init__(self, slots: int):
        self.s = [None] * slots
        self.rounds = {g: 0 for g in (2, 4, 8, 16, 32)}
        self.products = 0
        self._level = None

    def ld(self, slot):
        assert self.s[slot] is not None, f"slot {slot} read before written"
        if self._level is not None:
            self._level[0].setdefault(slot, set()).add(self._task)
        return self.s[slot]

    def st(self, slot, v):
        assert 0 <= v < 1 << 400
        if self._level is not None:
            self._level[1].setdefault(slot, set()).add(self._task)
        self.s[slot] = v

    def mont(self, a, b):
        assert a < 1 << 400 and b < 1 << 400
        assert a * b <= (1 << 16) * P * P
        self.products += 1
        self._with_product.add(self._task)
        c = self._product(a, b)
        assert c < 2 * P and c % P == a * b * R_INV % P
        return c

    @staticmethod
    def _product(a, b):
        w = mont_w32(words(a), words(b), PW, N0W, FQ.n0)
        return sum(x << (32 * k) for k, x in enumerate(w))

    def level(self, n: int, task):
        reads, writes = {}, {}
        self._level, self._with_product = (reads, writes), set()
        for k in range(n):
            self._task = k
            task(k)
        self._level = None
        for slot, who in writes.items():
            touch = who | reads.get(slot, set())
            assert len(touch) == 1, f"slot {slot} shared by tasks {touch}"
        for g in self.rounds:
            self.rounds[g] += len({k // g for k in self._with_product})

    def post_red(self, a):
        return self.mont(a, ONE)


class FastLane(Lane):
    """A Lane whose Montgomery product is its closed form."""

    @staticmethod
    def _product(a, b):
        t = a * b
        return (t + (t * NEG_P_INV & ((1 << 400) - 1)) * P) >> 400


def kara_ops(q, a, b):
    """Karatsuba leaf q of a b from a(u), b(u)."""
    if q < 2:
        return a(q), b(q)
    return add(a(0), a(1)), add(b(0), b(1))


def kara(ln, L, u):
    t0, t1 = ln.ld(L), ln.ld(L + 1)
    if u == 0:
        return subk(t0, t1, 2)
    return subk(subk(ln.ld(L + 2), t0, 2), t1, 2)


# ------------------------------------------------------- the Fq12 product

def f12_leaf_mask(k):
    F, Pn, Q = k // 18, k // 3 % 6, k % 3
    kj = 5 << 15 | 3 << 12 | 6 << 9 | 4 << 6 | 2 << 3 | 1
    jm = kj >> (3 * Pn) & 7
    ju = 0
    for j in range(3):
        if jm >> j & 1:
            ju |= (Q + 1) << (2 * j)
    return sum(ju << (6 * i) for i in range(2) if (F + 1) >> i & 1)


def slot_sum(ln, base, m):
    cs = [c for c in range(12) if m >> c & 1]
    s = ln.ld(base + cs[0])
    for c in cs[1:]:
        s = add(s, ln.ld(base + c))
    return s


def f12_leaf_ops(ln, A, B, k):
    m = f12_leaf_mask(k)
    x = slot_sum(ln, A, m)
    return x, x if A == B else slot_sum(ln, B, m)


def f6_comb(ln, LEAF, OUT, k):
    F, j = k // 3, k % 3

    def Pr(n, u):
        return kara(ln, LEAF + 18 * F + 3 * n, u)
    if j == 0:
        s = [subk(subk(Pr(3, u), Pr(1, u), 6), Pr(2, u), 6) for u in range(2)]
        c = [add(Pr(0, 0), subk(s[0], s[1], 18)), add(Pr(0, 1), add(s[0], s[1]))]
    elif j == 1:
        t20, t21 = Pr(2, 0), Pr(2, 1)
        xi = [subk(t20, t21, 6), add(t20, t21)]
        c = [subk(subk(add(Pr(4, u), xi[u]), Pr(0, u), 6), Pr(1, u), 6)
             for u in range(2)]
    else:
        c = [subk(subk(add(Pr(5, u), Pr(1, u)), Pr(0, u), 6), Pr(2, u), 6)
             for u in range(2)]
    ln.st(OUT + 6 * F + 2 * j, c[0])
    ln.st(OUT + 6 * F + 2 * j + 1, c[1])


def f12_comb(ln, T6, k, kx, ks):
    i, j, u = k // 6, k // 2 % 3, k % 2

    def T(F, jj, uu):
        return ln.ld(T6 + 6 * F + 2 * jj + uu)
    if i == 1:
        return subk(subk(T(2, j, u), T(0, j, u), ks), T(1, j, u), ks)
    if j > 0:
        return add(T(0, j, u), T(1, j - 1, u))
    w = subk(T(1, 2, 0), T(1, 2, 1), kx) if u == 0 else add(T(1, 2, 0),
                                                            T(1, 2, 1))
    return add(T(0, 0, u), w)


def f12_mul(ln, A, B, OUT, LEAF, T6):
    ln.level(54, lambda k: ln.st(LEAF + k,
                                 ln.mont(*f12_leaf_ops(ln, A, B, k))))
    ln.level(9, lambda k: f6_comb(ln, LEAF, T6, k))
    ln.level(12, lambda k: ln.st(OUT + k, ln.post_red(
        f12_comb(ln, T6, k, 24, 42))))


# ---------------------------------------------------- the cyclotomic square

def cyc_leaf_ops(ln, A, k):
    q = k // 2
    r = q % 3
    x0, x1 = A + [0, 6, 2][r], A + [8, 4, 10][r]
    if q < 6:
        c = x0 if q < 3 else x1
        w0, w1 = ln.ld(c), ln.ld(c + 1)
    else:
        w0 = add(ln.ld(x0), ln.ld(x1))
        w1 = add(ln.ld(x0 + 1), ln.ld(x1 + 1))
    return (add(w0, w1), subk(w0, w1, 4)) if k % 2 == 0 else (w0, w1)


def cyc_comb(ln, A, SQ, k):
    i, j, u = k // 6, k // 2 % 3, k % 2

    def S(q, h):
        return ln.ld(SQ + 2 * q + h)

    def tb(r, uu):
        o = 2 if uu == 0 else 4
        return subk(subk(S(6 + r, uu), S(r, uu), o), S(3 + r, uu), o)
    if i == 0:
        s1 = (subk(S(3 + j, 0), S(3 + j, 1), 4) if u == 0
              else add(S(3 + j, 0), S(3 + j, 1)))
        ta = add(S(j, u), s1)
        return add(dbl(subk(ta, ln.ld(A + 2 * j + u), 2)), ta)
    if j == 0:
        b0, b1 = tb(2, 0), tb(2, 1)
        b = subk(b0, b1, 12) if u == 0 else add(b0, b1)
    else:
        b = tb(j - 1, u)
    return add(dbl(add(b, ln.ld(A + 6 + 2 * j + u))), b)


def cyc_sqr(ln, A, OUT, SQ):
    def leaf(k):
        r = ln.mont(*cyc_leaf_ops(ln, A, k))
        ln.st(SQ + k, r if k % 2 == 0 else dbl(r))
    ln.level(18, leaf)
    ln.level(12, lambda k: ln.st(OUT + k, ln.post_red(cyc_comb(ln, A, SQ,
                                                               k))))


def cyc_sqr_twin(a, lane=Lane):
    """cyc_sqr_kernel for one lane: a is 12 ints, at slots A = 0; the square
    into OUT = 12, the Fq2 squares at SQ = 24. Returns 12 ints and the
    lane."""
    A, OUT, SQ = 0, 12, 24
    ln = lane(12 + 12 + 18)
    ln.level(12, lambda c: ln.st(A + c, a[c]))
    cyc_sqr(ln, A, OUT, SQ)
    return [ln.ld(OUT + c) for c in range(12)], ln


def cyc_pow_twin(a, e: int):
    """cyc_pow_kernel for one lane: a is 12 ints; returns 12 ints and the
    lane (its counts)."""
    X, ACC, TMP, LEAF, T6 = 0, 12, 24, 36, 90
    ln = Lane(108)
    ln.level(12, lambda c: (ln.st(X + c, a[c]),
                            ln.st(ACC + c, ONE if c == 0 else 0)))
    cur, tmp = ACC, TMP
    for i in range(CT.CYC_POW_NBITS - 1, -1, -1):
        cyc_sqr(ln, cur, tmp, LEAF)
        if (e >> i) & 1:
            f12_mul(ln, tmp, X, cur, LEAF, T6)
        else:
            cur, tmp = tmp, cur
    return [ln.ld(cur + c) for c in range(12)], ln


def f12_pow_dyn_twin(a, s: int):
    """f12_pow_dyn_kernel for one lane: a is 12 ints, s the lane's scalar
    (its 272 bits read MSB first); cyc_pow's slots, each round the square
    of cur into tmp (f12_mul with B = A), then the product with a back
    into cur on a set bit, or the two slot indices swapped. Returns 12 ints
    and the lane (its counts)."""
    X, ACC, TMP, LEAF, T6 = 0, 12, 24, 36, 90
    ln = FastLane(108)
    ln.level(12, lambda c: (ln.st(X + c, a[c]),
                            ln.st(ACC + c, ONE if c == 0 else 0)))
    cur, tmp = ACC, TMP
    for b in range(CT.POW_DYN_NBITS - 1, -1, -1):
        f12_mul(ln, cur, cur, tmp, LEAF, T6)
        if (s >> b) & 1:
            f12_mul(ln, tmp, X, cur, LEAF, T6)
        else:
            cur, tmp = tmp, cur
    return [ln.ld(cur + c) for c in range(12)], ln


# ------------------------------------------------- the doubling iteration

SF, SLEAF, ST6, SPT, SD2, SD3, SSLOTS = 0, 12, 81, 99, 107, 117, 133


class DblSlots:
    """The doubling iteration's point slots (tower_w32.cuh DblSlots)."""
    PT, D2, D3 = SPT, SD2, SD3


class DblStepSlots:
    """The doubling step's slots (tower_w32.cuh DblStepSlots)."""
    PT, D2, D3, LEAF, SLOTS = 0, 6, 16, 26, 41


def dbl_e(ln, u, S=DblSlots):
    c0, c1 = ln.ld(S.D2 + 4), ln.ld(S.D2 + 5)
    return mul12(subk(c0, c1, 2) if u == 0 else add(c0, c1))


def dbl_h(ln, u, S=DblSlots):
    return subk(ln.ld(S.D2 + 8 + u), add(ln.ld(S.D2 + 2 + u),
                                          ln.ld(S.D2 + 4 + u)), 4)


def dbl_l0(ln, u, S=DblSlots):
    return subk(dbl_e(ln, u, S), ln.ld(S.D2 + 2 + u), 2)


def dbl_l1(ln, u, S=DblSlots):
    return triple(ln.ld(S.D2 + 6 + u))


def dbl_l2(ln, u, S=DblSlots):
    return negk(dbl_h(ln, u, S), 8)


def dbl_y3(g2, e2):
    return subk(g2, triple(e2), 8)


def dbl_leaf_ops(ln, d, S=DblSlots):
    n = d // 3
    oa, ob = [0, 1, 2, 0, 3][n], [1, 1, 2, 0, 3][n]

    def comp(o, u):
        if o < 3:
            return ln.ld(S.PT + 2 * o + u)
        return add(ln.ld(S.PT + 2 + u), ln.ld(S.PT + 4 + u))
    return kara_ops(d % 3, lambda u: comp(oa, u), lambda u: comp(ob, u))


def dbl_mid_ops(ln, d, tinv, S=DblSlots):
    """Operands of level-C task d < 14 (d >= 10: the iteration's line
    scaling, P at DblSlots' PT + 6, + 7)."""
    u = d % 2
    if d < 2:
        return ln.ld(S.D2 + u), tinv
    if d < 4:
        return add(ln.ld(S.D2 + 2 + u), triple(dbl_e(ln, u, S))), tinv
    if d < 7:
        e = lambda uu: dbl_e(ln, uu, S)
        return kara_ops(d - 4, e, e)
    if d < 10:
        return kara_ops(d - 7, lambda uu: ln.ld(S.D2 + 2 + uu),
                        lambda uu: dbl_h(ln, uu, S))
    if d < 12:
        return dbl_l1(ln, u, S), ln.ld(S.PT + 6)
    return dbl_l2(ln, u, S), ln.ld(S.PT + 7)


def sparse_leaf_ops(ln, F, la, LB, LC, k):
    """Leaf k < 45 of f (la + lb v + lc v w): f at slots F, la(u), lb and
    lc at slots LB, LC."""
    r = k // 3
    blk, j = r // 3, r % 3

    def left(u):
        f0 = F + 2 * j + u
        if blk < 2:
            return ln.ld(f0)
        if blk == 2:
            return ln.ld(f0 + 6)
        return add(ln.ld(f0), ln.ld(f0 + 6))

    def right(u):
        if blk in (0, 3):
            return la(u)
        if blk == 1:
            return ln.ld(LB + u)
        if blk == 2:
            return ln.ld(LC + u)
        return add(ln.ld(LB + u), ln.ld(LC + u))
    return kara_ops(k % 3, left, right)


def dbl_late_ops(ln, d, S=DblSlots):
    if d < 4:
        return kara(ln, S.D3 + (4 if d < 2 else 7), d % 2), ONE
    if d < 7:
        return kara_ops(d - 4, lambda u: ln.ld(S.D3 + u),
                        lambda u: subk(ln.ld(S.D2 + 2 + u),
                                       triple(dbl_e(ln, u, S)), 144))
    g = lambda u: ln.ld(S.D3 + 2 + u)
    return kara_ops(d - 7, g, g)


def sparse_comb(ln, LEAF, T6, s):
    F, j = s // 3, s % 3

    def Pr(blk, jj, u):
        return kara(ln, LEAF + 3 * (3 * blk + jj), u)

    def xi6(blk, jj, u):
        v0, v1 = Pr(blk, jj, 0), Pr(blk, jj, 1)
        return subk(v0, v1, 6) if u == 0 else add(v0, v1)
    for u in range(2):
        if F == 1:
            c = xi6(2, 2, u) if j == 0 else Pr(2, j - 1, u)
        else:
            ba = 0 if F == 0 else 3
            c = add(Pr(ba, j, u), xi6(ba + 1, 2, u) if j == 0
                    else Pr(ba + 1, j - 1, u))
        ln.st(T6 + 6 * F + 2 * j + u, c)


def miller_dbl_twin(f, X, Y, Z, px, py):
    """miller_iter_dbl_kernel for one lane (ints: f 12, X, Y, Z 2 each);
    returns (f', X3, Y3, Z3) and the lane."""
    ln = Lane(SSLOTS)
    ins = f + X + Y + Z + [px, py]
    ln.level(20, lambda k: ln.st(SF + k if k < 12 else SPT + k - 12, ins[k]))
    tinv = CT.TWO_INV_MONT
    out = {"f": [None] * 12, "X": [None] * 2, "Y": [None] * 2,
           "Z": [None] * 2}

    def level_a(k):
        x, y = (f12_leaf_ops(ln, SF, SF, k) if k < 54
                else dbl_leaf_ops(ln, k - 54))
        ln.st(SLEAF + k, ln.mont(x, y))

    def level_b(k):
        if k < 10:
            ln.st(SD2 + k, ln.post_red(kara(ln, SLEAF + 54 + 3 * (k // 2),
                                            k % 2)))
        else:
            f6_comb(ln, SLEAF, ST6, k - 10)

    def level_c(k):
        if k < 12:
            ln.st(SF + k, ln.post_red(f12_comb(ln, ST6, k, 24, 42)))
        elif k < 26:
            ln.st(SD3 + k - 12, ln.mont(*dbl_mid_ops(ln, k - 12, tinv)))
        else:                            # l0, no product
            ln.st(SD3 + k - 12, dbl_l0(ln, k - 26))

    def level_d(k):
        r = ln.mont(*(sparse_leaf_ops(ln, SF, lambda u: ln.ld(SD3 + 14 + u),
                                      SD3 + 10, SD3 + 12, k) if k < 45
                      else dbl_late_ops(ln, k - 45)))
        if k in (47, 48):
            out["Z"][k - 47] = r
        else:
            ln.st(SLEAF + k, r)

    def level_e(k):
        if k < 4:
            r = ln.post_red(kara(ln, SLEAF + (49 if k < 2 else 52), k % 2))
            if k < 2:
                out["X"][k] = r
            else:
                ln.st(SD2 + k - 2, r)
        else:
            sparse_comb(ln, SLEAF, ST6, k - 4)

    def level_f(k):
        if k < 12:
            out["f"][k] = ln.post_red(f12_comb(ln, ST6, k, 12, 18))
        else:
            u = k - 12
            out["Y"][u] = dbl_y3(ln.ld(SD2 + u), ln.ld(SLEAF + 45 + u))
    for n, task in ((69, level_a), (19, level_b), (28, level_c), (55, level_d),
                    (13, level_e), (14, level_f)):
        ln.level(n, task)
    return (out["f"], out["X"], out["Y"], out["Z"]), ln


def miller_dbl_step_twin(X, Y, Z, lane=Lane):
    """miller_dbl_step_kernel for one lane (ints: X, Y, Z 2 each): the
    iteration's point levels on DblStepSlots, in five levels; returns
    ((X3, Y3, Z3), (l0, l1, l2)) and the lane."""
    S = DblStepSlots
    ln = lane(S.SLOTS)
    ins = X + Y + Z
    ln.level(6, lambda k: ln.st(S.PT + k, ins[k]))
    tinv = CT.TWO_INV_MONT
    out = {k: [None] * 2 for k in ("X", "Y", "Z", "l0", "l1", "l2")}

    def level_a(k):
        ln.st(S.LEAF + k, ln.mont(*dbl_leaf_ops(ln, k, S)))

    def level_b(k):
        ln.st(S.D2 + k, ln.post_red(kara(ln, S.LEAF + 3 * (k // 2), k % 2)))

    def level_c(k):
        u = k % 2
        if k < 10:
            ln.st(S.D3 + k, ln.mont(*dbl_mid_ops(ln, k, tinv, S)))
        elif k < 12:
            out["l0"][u] = dbl_l0(ln, u, S)
        elif k < 14:
            out["l1"][u] = dbl_l1(ln, u, S)
        else:
            out["l2"][u] = dbl_l2(ln, u, S)

    def level_d(k):
        r = ln.mont(*dbl_late_ops(ln, k, S))
        if k in (2, 3):
            out["Z"][k - 2] = r
        else:
            ln.st(S.LEAF + k, r)

    def level_e(k):
        u = k % 2
        r = ln.post_red(kara(ln, S.LEAF + (4 if k < 2 else 7), u))
        if k < 2:
            out["X"][u] = r
        else:
            out["Y"][u] = dbl_y3(r, ln.ld(S.LEAF + u))
    for n, task in ((15, level_a), (10, level_b), (16, level_c),
                    (10, level_d), (4, level_e)):
        ln.level(n, task)
    return (tuple(out[k] for k in ("X", "Y", "Z")),
            tuple(out[k] for k in ("l0", "l1", "l2"))), ln


# ------------------------------------------------- the addition iteration

AF, ALEAF, AT6, APT, AB, AC, AD, AE, ASLOTS = (0, 12, 66, 84, 96, 100, 104,
                                               112, 118)


class AddSlots:
    """The addition iteration's point slots (tower_w32.cuh AddSlots)."""
    PT, B, D, E = APT, AB, AD, AE


class AddStepSlots:
    """The addition step's slots (tower_w32.cuh AddStepSlots)."""
    PT, B, D, E, LEAF, SLOTS = 0, 10, 14, 22, 28, 40


def add_tl(ln, u, S=AddSlots):
    """theta (u = 0, 1) = Y - yqZ + 2p; lambda (u = 2, 3) = X - xqZ + 2p."""
    pt = S.PT + 2 if u < 2 else S.PT
    return subk(ln.ld(pt + u % 2), ln.ld(S.B + u), 2)


def add_h(ln, u, S=AddSlots):
    return subk(add(ln.ld(S.E + u), ln.ld(S.E + 2 + u)),
                dbl(ln.ld(S.E + 4 + u)), 4)


def add_j(ln, u, S=AddSlots):
    """j = theta xq - lambda yq + 2p: the step's l0, the iteration's la."""
    return subk(ln.ld(S.D + 4 + u), ln.ld(S.D + 6 + u), 2)


def add_y3(ln, u, S=AddSlots):
    return subk(ln.ld(S.B + 2 + u), ln.ld(S.B + u), 2)


def add_leaf_ops(k, operand):
    n = k // 3
    return kara_ops(k % 3, lambda u: operand(n, 0, u),
                    lambda u: operand(n, 1, u))


def add_a_ops(ln, k, S=AddSlots):
    """Leaf k < 6 of yq Z, xq Z."""
    return add_leaf_ops(k, lambda n, o, u: ln.ld(
        S.PT + 2 * (4 - n if o == 0 else 2) + u))


def add_c_ops(ln, k, S=AddSlots):
    """Leaf k < 12 of theta^2, lambda^2, theta xq, lambda yq."""
    def operand(n, o, u):
        if o == 0 or n < 2:
            return add_tl(ln, (0 if n % 2 == 0 else 2) + u, S)
        return ln.ld(S.PT + 2 * (n + 1) + u)
    return add_leaf_ops(k, operand)


def add_e_ops(ln, k, S=AddSlots):
    """Leaf k < 9 of lambda d, Z cc, X d."""
    def operand(n, o, u):
        if o == 1:
            return ln.ld(S.D + (0 if n == 1 else 2) + u)
        return (add_tl(ln, 2 + u, S) if n == 0
                else ln.ld(S.PT + (4 if n == 1 else 0) + u))
    return add_leaf_ops(k, operand)


def add_g_ops(ln, k, S=AddSlots):
    """Leaf k < 12 of lambda h, e Z, e Y, theta (g - h + 8p)."""
    def operand(n, o, u):
        if o == 0:
            if n == 0:
                return add_tl(ln, 2 + u, S)
            return add_tl(ln, u, S) if n == 3 else ln.ld(S.E + u)
        if n == 0:
            return add_h(ln, u, S)
        if n == 3:
            return subk(ln.ld(S.E + 4 + u), add_h(ln, u, S), 8)
        return ln.ld(S.PT + (4 if n == 1 else 2) + u)
    return add_leaf_ops(k, operand)


def miller_add_twin(f, X, Y, Z, xq, yq, px, py):
    """miller_iter_add_kernel for one lane (ints: f 12, X .. yq 2 each);
    returns (f', X3, Y3, Z3) and the lane."""
    ln = Lane(ASLOTS)
    ins = f + X + Y + Z + xq + yq + [px, py]
    ln.level(24, lambda k: ln.st(AF + k if k < 12 else APT + k - 12, ins[k]))
    out = {"f": [None] * 12, "X": [None] * 2, "Y": [None] * 2,
           "Z": [None] * 2}
    red = lambda L, u: ln.post_red(kara(ln, L, u))

    def level_c(k):
        if k < 12:                       # theta^2, lambda^2, theta xq, ...
            ln.st(ALEAF + k, ln.mont(*add_c_ops(ln, k)))
        elif k < 14:                     # lb = (16p - theta) px
            ln.st(AC + k - 12, ln.mont(negk(add_tl(ln, k - 12), 16),
                                       ln.ld(APT + 10)))
        else:                            # lc = lambda py
            ln.st(AC + k - 12, ln.mont(add_tl(ln, k - 12), ln.ld(APT + 11)))

    def level_e(k):
        if k < 45:                       # la = j
            x, y = sparse_leaf_ops(ln, AF, lambda u: add_j(ln, u), AC, AC + 2,
                                   k)
        else:                            # lambda d, Z cc, X d
            x, y = add_e_ops(ln, k - 45)
        ln.st(ALEAF + k, ln.mont(x, y))

    def level_f(k):
        if k < 6:
            ln.st(AE + k, red(ALEAF + 45 + 3 * (k // 2), k % 2))
        else:
            sparse_comb(ln, ALEAF, AT6, k - 6)

    def level_g(k):
        if k < 12:
            out["f"][k] = ln.post_red(f12_comb(ln, AT6, k, 12, 18))
        else:                            # lambda h, e Z, e Y, theta t
            ln.st(ALEAF + k - 12, ln.mont(*add_g_ops(ln, k - 12)))

    def level_h(k):
        r = red(ALEAF + 3 * (k // 2), k % 2)
        if k < 4:
            out["X" if k < 2 else "Z"][k % 2] = r
        else:
            ln.st(AB + k - 4, r)

    def level_i(u):
        out["Y"][u] = add_y3(ln, u)
    for n, task in ((6, lambda k: ln.st(ALEAF + k,
                                         ln.mont(*add_a_ops(ln, k)))),
                    (4, lambda k: ln.st(AB + k, red(ALEAF + 3 * (k // 2),
                                                    k % 2))),
                    (16, level_c),
                    (8, lambda k: ln.st(AD + k, red(ALEAF + 3 * (k // 2),
                                                    k % 2))),
                    (54, level_e), (15, level_f), (24, level_g), (8, level_h),
                    (2, level_i)):
        ln.level(n, task)
    return (out["f"], out["X"], out["Y"], out["Z"]), ln


def miller_add_step_twin(X, Y, Z, xq, yq, lane=Lane):
    """miller_add_step_kernel for one lane (ints: X .. yq 2 each): the
    addition iteration's point levels on AddStepSlots, eight levels of
    products and one without; returns ((X3, Y3, Z3), (l0, l1, l2)) and the
    lane."""
    S = AddStepSlots
    ln = lane(S.SLOTS)
    ins = X + Y + Z + xq + yq
    ln.level(10, lambda k: ln.st(S.PT + k, ins[k]))
    out = {k: [None] * 2 for k in ("X", "Y", "Z", "l0", "l1", "l2")}
    red = lambda k: ln.post_red(kara(ln, S.LEAF + 3 * (k // 2), k % 2))

    def leaf(ops):
        return lambda k: ln.st(S.LEAF + k, ln.mont(*ops(ln, k, S)))

    def level_c(k):
        if k < 12:
            leaf(add_c_ops)(k)
        elif k < 14:                     # l1 = 16p - theta
            out["l1"][k % 2] = negk(add_tl(ln, k - 12, S), 16)
        else:                            # l2 = lambda
            out["l2"][k % 2] = add_tl(ln, k - 12, S)

    def level_e(k):
        if k < 9:
            leaf(add_e_ops)(k)
        else:                            # l0 = j
            out["l0"][k - 9] = add_j(ln, k - 9, S)

    def level_h(k):
        r = red(k)
        if k < 4:
            out["X" if k < 2 else "Z"][k % 2] = r
        else:
            ln.st(S.B + k - 4, r)

    def level_i(u):
        out["Y"][u] = add_y3(ln, u, S)
    for n, task in ((6, leaf(add_a_ops)),
                    (4, lambda k: ln.st(S.B + k, red(k))),
                    (16, level_c),
                    (8, lambda k: ln.st(S.D + k, red(k))),
                    (11, level_e),
                    (6, lambda k: ln.st(S.E + k, red(k))),
                    (12, leaf(add_g_ops)), (8, level_h), (2, level_i)):
        ln.level(n, task)
    return (tuple(out[k] for k in ("X", "Y", "Z")),
            tuple(out[k] for k in ("l0", "l1", "l2"))), ln


# ------------------------------------------------------------------ tests

def ints(x):
    """numpy limbs (25, *rest) -> nested lists of ints over rest."""
    w = x.astype(object)
    return np.tensordot(np.array([1 << (16 * i) for i in range(FQ.n)],
                                 dtype=object), w, axes=(0, 0))


def limbs(v: int):
    return [(v >> (16 * i)) & 0xFFFF for i in range(FQ.n)]


def f12_lanes(seed, lanes, bound, edges):
    return with_edges(rand_coeffs(seed, 12, lanes, bound=bound), edges)


def test_tower_offsets_and_constants():
    """make_tower_w's k p words and 1/2's packing; the Fq12 leaves' operand
    masks cover each Karatsuba leaf once."""
    for k, v in KP.items():
        assert v < 1 << 400 and words(v)[NW - 1] >> 16 == 0, k
    assert (2 * CT.TWO_INV_MONT * pow(1 << 400, -1, P) - 1) % P == 0
    masks = [f12_leaf_mask(k) for k in range(54)]
    assert len(set(masks)) == 54
    assert max(bin(m).count("1") for m in masks) == 8
    assert [bin(m).count("1") for m in masks[:3]] == [1, 1, 2]


@pytest.mark.parametrize("case", ["random", "32p-1"])
def test_group_fq12_product_matches_plain(case):
    """The three levels of a b against fq12_mul_plain, up to the widest
    operands (every coefficient 32p - 1: leaf sums of 8 at 256p)."""
    lanes = 3
    top = 32 * P - 1
    edges = ([top, top, 0], [top, 1, top]) if case == "32p-1" else ([], [])
    a = f12_lanes(41, lanes, 32 * P, edges[0])
    b = f12_lanes(42, lanes, 32 * P, edges[1])
    want = CT.fq12_mul_plain(limbs_from_numpy(a, device="cpu"),
                             limbs_from_numpy(b, device="cpu"))
    va, vb = ints(a), ints(b)
    for lane in range(lanes):
        ln = Lane(12 + 12 + 12 + 54 + 18)
        ln.level(12, lambda c: (ln.st(c, int(va[c, lane])),
                                ln.st(12 + c, int(vb[c, lane]))))
        f12_mul(ln, 0, 12, 24, 36, 90)
        got = [limbs(ln.ld(24 + c)) for c in range(12)]
        assert got == want[:, :, lane].T.tolist()
        assert ln.products == 66
        assert ln.rounds[8] == 9 and ln.rounds[32] == 3


@pytest.mark.parametrize("e", [abs(C.X), (abs(C.X) + 1) // 3])
def test_group_cyc_pow_matches_plain(e):
    """cyc_pow_kernel's schedule against cyc_pow_plain: seeded lanes < 2p
    and a lane with every coefficient 2p - 1 (chip_smoke.py's edge)."""
    lanes = 2
    a = f12_lanes(43, lanes, 2 * P, [2 * P - 1])
    want = CT.cyc_pow_plain(limbs_from_numpy(a, device="cpu"), e)
    va = ints(a)
    for lane in range(lanes):
        got, ln = cyc_pow_twin([int(va[c, lane]) for c in range(12)], e)
        assert [limbs(v) for v in got] == want[:, :, lane].T.tolist()
        ones = bin(e).count("1")
        assert ln.products == 64 * 30 + ones * 66
        # at G = 32: 2 product rounds a square, 3 a product (plus one
        # level of Fq6 values without products)
        assert ln.rounds[32] == 64 * 2 + ones * 3


@pytest.mark.parametrize("lanes", [4096, 8])
def test_group_cyc_sqr_matches_plain(lanes):
    """cyc_sqr_kernel's layout (a at 0, the square at 12, the Fq2 squares
    at 24) against cyc_sqr_plain, limb for limb: seeded lanes < 2p, lane 0
    with every coefficient 2p - 1, lane 1 zero. 4096 lanes through
    FastLane, 8 through the packed-word product's instruction twin; 30
    products in 3 rounds at G = 16 (8 at 4, 5 at 8, 2 at 32), no slot
    shared within a level, the output < 2p."""
    a = f12_lanes(56, lanes, 2 * P, [2 * P - 1, 0])
    want = CT.cyc_sqr_plain(limbs_from_numpy(a, device="cpu")).numpy()
    va = ints(a)
    lane_kind = FastLane if lanes > 8 else Lane
    got = np.zeros((FQ.n, 12, lanes), dtype=np.int64)
    for lane in range(lanes):
        out, ln = cyc_sqr_twin([int(va[c, lane]) for c in range(12)],
                               lane_kind)
        for c in range(12):
            got[:, c, lane] = limbs(out[c])
        assert ln.products == 30
        assert [ln.rounds[g] for g in (4, 8, 16, 32)] == [8, 5, 3, 2]
    assert np.array_equal(got, want)
    assert all(int(v) < 2 * P for v in ints(want).ravel())


def test_group_f12_pow_dyn_matches_plain():
    """f12_pow_dyn_kernel's slot schedule against f12_pow_dyn_plain, limb
    for limb: an all-zero scalar (272 squares), an all-ones one (272
    squares and 272 products), a seeded 255-bit one; the base's lanes
    seeded < 2p, one with every coefficient 2p - 1. Each Fq12 product
    takes 3 rounds at G = 32 and 5 at G = 16."""
    lanes = 3
    a = f12_lanes(54, lanes, 2 * P, [2 * P - 1])
    scalars = [0, (1 << CT.POW_DYN_NBITS) - 1,
               int.from_bytes(np.random.default_rng(55).bytes(32),
                              "little") >> 1]
    s = np.array([[v >> (16 * i) & 0xFFFF for v in scalars]
                  for i in range(CT.POW_DYN_NBITS // 16)], dtype=np.int64)
    want = CT.f12_pow_dyn_plain(limbs_from_numpy(a, device="cpu"),
                                limbs_from_numpy(s, device="cpu"))
    va = ints(a)
    for lane, sc in enumerate(scalars):
        got, ln = f12_pow_dyn_twin([int(va[c, lane]) for c in range(12)], sc)
        assert [limbs(v) for v in got] == want[:, :, lane].T.tolist(), lane
        products = CT.POW_DYN_NBITS + bin(sc).count("1")
        assert ln.products == 66 * products
        assert (ln.rounds[32], ln.rounds[16]) == (3 * products, 5 * products)


def test_group_miller_iter_dbl_matches_plain():
    """miller_iter_dbl_kernel's six levels against miller_iter_dbl_plain:
    seeded lanes (f < 2p, X, Z < 2p, Y < 10p, P < p), lane 0 at the top of
    every bound (Y = 10p - 1, P at p - 1), lane 1 with R and P zero (P at
    the padding point (0, 0))."""
    lanes = 4
    f = f12_lanes(44, lanes, 2 * P, [2 * P - 1, 2 * P - 1])
    fq2 = lambda seed, bound, top: with_edges(
        rand_coeffs(seed, 2, lanes, bound=bound), [top, 0])
    X, Y, Z = fq2(45, 2 * P, 2 * P - 1), fq2(46, 10 * P, 10 * P - 1), \
        fq2(47, 2 * P, 2 * P - 1)
    px, py = (with_edges(rand_coeffs(s, 1, lanes), [P - 1, 0])[:, 0]
              for s in (48, 49))
    t = lambda x: limbs_from_numpy(x, device="cpu")
    wf, wR = CT.miller_iter_dbl_plain(t(f), (t(X), t(Y), t(Z)), t(px), t(py))
    vf, vX, vY, vZ, vpx, vpy = (ints(x) for x in (f, X, Y, Z, px, py))
    for lane in range(lanes):
        (gf, gX, gY, gZ), ln = miller_dbl_twin(
            [int(vf[c, lane]) for c in range(12)],
            *([int(v[u, lane]) for u in range(2)] for v in (vX, vY, vZ)),
            int(vpx[lane]), int(vpy[lane]))
        assert [limbs(v) for v in gf] == wf[:, :, lane].T.tolist()
        for g, w in zip((gX, gY, gZ), wR):
            assert [limbs(v) for v in g] == w[:, :, lane].T.tolist()
        assert ln.products == 176
        assert ln.rounds[8] == 25


@pytest.mark.parametrize("lanes", [4096, 8])
def test_group_miller_dbl_step_matches_plain(lanes):
    """miller_dbl_step_kernel's five levels against miller_dbl_step_plain,
    limb for limb: X, Z < 2p, Y < 10p on seeded lanes, lane 0 at the top
    of every bound (Y = 10p - 1), lane 1 with R zero, lane 2 X = Z = 2p -
    1, Y = 0. 4096 lanes with each product from its closed form
    (FastLane), 8 through the packed-word product's instruction twin; 49
    products in 9 rounds at G = 8 (14 at 4, 5 at 16), no slot shared
    within a level, every bound of the audit held."""
    fq2 = lambda seed, bound, edges: with_edges(
        rand_coeffs(seed, 2, lanes, bound=bound), edges)
    X, Y, Z = (fq2(60, 2 * P, [2 * P - 1, 0, 2 * P - 1]),
               fq2(61, 10 * P, [10 * P - 1, 0, 0]),
               fq2(62, 2 * P, [2 * P - 1, 0, 2 * P - 1]))
    t = lambda x: limbs_from_numpy(x, device="cpu")
    wR, wl = CT.miller_dbl_step_plain((t(X), t(Y), t(Z)), (P + 1) // 2)
    want = [w.numpy() for w in wR + wl]
    vX, vY, vZ = (ints(x) for x in (X, Y, Z))
    lane_kind = FastLane if lanes > 8 else Lane
    got = np.zeros((6, FQ.n, 2, lanes), dtype=np.int64)
    for lane in range(lanes):
        (R3, line), ln = miller_dbl_step_twin(
            *([int(v[u, lane]) for u in range(2)] for v in (vX, vY, vZ)),
            lane=lane_kind)
        for i, comps in enumerate(R3 + line):
            for u in range(2):
                got[i, :, u, lane] = limbs(comps[u])
        assert ln.products == 49
        assert (ln.rounds[4], ln.rounds[8], ln.rounds[16]) == (14, 9, 5)
    for i in range(6):
        assert np.array_equal(got[i], want[i]), ("X3", "Y3", "Z3", "l0",
                                                 "l1", "l2")[i]
    bounds = (2, 10, 2, 50, 6, 8)          # units of p
    for i, b in enumerate(bounds):
        assert all(int(v) < b * P for v in ints(want[i]).ravel())


def miller_lanes(lanes, seed):
    """chip_smoke.py's Miller inputs as numpy limbs: f < 2p; X, Z < 2p, Y <
    10p; Q, P < p; lane 0 at the top of every bound, lane 1 with R, Q and P
    zero (P, Q the padding point (0, 0)), lane 2 with P zero, lane 3 with Q
    zero."""
    f = f12_lanes(seed, lanes, 2 * P, [2 * P - 1, 2 * P - 1])
    fq2 = lambda s, bound, top: with_edges(
        rand_coeffs(s, 2, lanes, bound=bound), [top, 0])
    X, Y, Z = (fq2(seed + 1, 2 * P, 2 * P - 1),
               fq2(seed + 2, 10 * P, 10 * P - 1),
               fq2(seed + 3, 2 * P, 2 * P - 1))
    xq, yq = (fq2(seed + s, P, P - 1) for s in (4, 5))
    px, py = (with_edges(rand_coeffs(seed + s, 1, lanes), [P - 1, 0])[:, 0]
              for s in (6, 7))
    for x in (px, py):
        x[:, 2] = 0
    for x in (xq, yq):
        x[:, :, 3] = 0
    return f, X, Y, Z, xq, yq, px, py


def test_group_miller_iter_add_matches_plain():
    """miller_iter_add_kernel's levels against miller_iter_add_plain, limb
    for limb, on seeded lanes and chip_smoke.py's edge lanes: 126 products
    in 17 rounds at G = 8 (12 at 16, 33 at 4), no slot shared within a
    level, every bound of the audit held."""
    lanes = 6
    ins = miller_lanes(lanes, 50)
    t = lambda x: limbs_from_numpy(x, device="cpu")
    f, X, Y, Z, xq, yq, px, py = ins
    wf, wR = CT.miller_iter_add_plain(t(f), (t(X), t(Y), t(Z)),
                                      (t(xq), t(yq)), t(px), t(py))
    v = [ints(x) for x in ins]
    for lane in range(lanes):
        (gf, gX, gY, gZ), ln = miller_add_twin(
            [int(v[0][c, lane]) for c in range(12)],
            *([int(x[u, lane]) for u in range(2)] for x in v[1:6]),
            int(v[6][lane]), int(v[7][lane]))
        assert [limbs(x) for x in gf] == wf[:, :, lane].T.tolist()
        for g, w in zip((gX, gY, gZ), wR):
            assert [limbs(x) for x in g] == w[:, :, lane].T.tolist()
        assert ln.products == 126
        assert (ln.rounds[4], ln.rounds[8], ln.rounds[16]) == (33, 17, 12)


@pytest.mark.parametrize("lanes", [4096, 8])
def test_group_miller_add_step_matches_plain(lanes):
    """miller_add_step_kernel's levels on AddStepSlots against
    miller_add_step_plain, limb for limb: X, Z < 2p, Y < 10p, Q < p on
    seeded lanes, lane 0 at the top of every bound (X = Z = 2p - 1, Y =
    10p - 1, Q = p - 1), lane 1 with R zero, lane 2 with Q zero. 4096 lanes
    with each product from its closed form (FastLane), 8 through the
    packed-word product's instruction twin; 65 products in 11 rounds at
    G = 8 (18 at 4, 8 at 16), no slot shared within a level, every bound
    of the audit held: X3, Z3 < 2p, Y3 < 4p, l0 < 4p, l1 < 16p, l2 < 4p."""
    fq2 = lambda seed, bound, edges: with_edges(
        rand_coeffs(seed, 2, lanes, bound=bound), edges)
    X, Y, Z = (fq2(63, 2 * P, [2 * P - 1, 0]),
               fq2(64, 10 * P, [10 * P - 1, 0]),
               fq2(65, 2 * P, [2 * P - 1, 0]))
    xq, yq = fq2(66, P, [P - 1]), fq2(67, P, [P - 1])
    for q in (xq, yq):
        q[:, :, 2] = 0
    t = lambda x: limbs_from_numpy(x, device="cpu")
    wR, wl = CT.miller_add_step_plain((t(X), t(Y), t(Z)), (t(xq), t(yq)))
    want = [w.numpy() for w in wR + wl]
    vs = [ints(x) for x in (X, Y, Z, xq, yq)]
    lane_kind = FastLane if lanes > 8 else Lane
    got = np.zeros((6, FQ.n, 2, lanes), dtype=np.int64)
    for lane in range(lanes):
        (R3, line), ln = miller_add_step_twin(
            *([int(v[u, lane]) for u in range(2)] for v in vs),
            lane=lane_kind)
        for i, comps in enumerate(R3 + line):
            for u in range(2):
                got[i, :, u, lane] = limbs(comps[u])
        assert ln.products == 65
        assert (ln.rounds[4], ln.rounds[8], ln.rounds[16]) == (18, 11, 8)
    for i in range(6):
        assert np.array_equal(got[i], want[i]), ("X3", "Y3", "Z3", "l0",
                                                 "l1", "l2")[i]
    bounds = (2, 4, 2, 4, 16, 4)           # units of p
    for i, b in enumerate(bounds):
        assert all(int(v) < b * P for v in ints(want[i]).ravel())


def test_tower_variants_imports_neither_jax_nor_the_jax_package():
    """The group-size variants script runs on the card, without JAX (with
    --step: the two steps at G = 4, 8, 16 and cyc_sqr at 4, 8, 16, 32,
    each but the committed one)."""
    repo = pathlib.Path(__file__).resolve().parent.parent
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "import groth_sahai_tpu_torch.utils.tower_variants as tv\n"
            "assert set(tv.variants()) >= {'as built', 'G=4', 'G=16'}\n"
            "sv = tv.step_variants()\n"
            "assert {n.split(' G=')[0] for n in sv} == {\n"
            "    'as built', 'steps', 'cyc_sqr'}, sv\n"
            "assert len(sv) == 1 + 3 + 3 - (len(set(\n"
            "    tv.built_groups(tv._STEP_CONST).values())) == 1), sv\n"
            "bad = [m for m, mod in sys.modules.items() if mod is not None\n"
            "       and (m == 'groth_sahai_tpu' or m.startswith(\n"
            "            ('groth_sahai_tpu.', 'jax.')) or m == 'jax')]\n"
            "assert not bad, bad\n"
            "print('clean')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=repo,
                         env=dict(os.environ, PYTHONPATH=str(repo)),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and "clean" in res.stdout, res.stderr
