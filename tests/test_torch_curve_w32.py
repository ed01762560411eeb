"""The grouped packed-word curve law of the kernels cdbl_n_add and cmadd,
and the slot layout of the grouped fq12_mul kernel.

`csrc/curve_group_w32.cuh` cuts the complete doubling and add (G1 over Fq,
G2 over Fq2) into levels of independent tasks that the G threads of a
lane's group take round-robin, each task reading Fq slots of the lane's
shared memory that earlier levels wrote and writing its own; a doubled
point stays as four products that the next reader sums. The kernel runs
only on a card, so this file holds a pure-Python twin of that schedule --
the same levels, tasks, slots and k p offsets, each Montgomery product
through the twin of the packed-word product in test_torch_words.py, the
lane and its hazard checks from test_torch_tower_w32.py -- and holds it
limb for limb against the plain version `cuda_curve.cdbl_n_add_plain`
(itself held against the JAX package's Pallas bodies in
test_torch_curve.py) for G1 and G2 at n = 0, 1 and 8, on seeded lanes and
on chip_smoke.py's edge lanes (P or Q at infinity, P + P, P + (-P), every
coordinate at 4p - 1). The twin asserts the bound audit at every step
(Montgomery operands < 2^400 with value(a) value(b) <= 2^16 p^2, sums <
2^400, every k p subtraction non-negative, the header's named bounds),
that no task reads a slot before a level wrote it and that no two tasks of
a level touch a slot that one of them writes; and it counts the rounds of
products a lane: a G1 doubling 2 at G = 4, 8, 16, 32, a G1 add 4, 2, 2, 2;
a G2 doubling 10, 6, 4, 4, a G2 add 16, 10, 6, 4 (verify-ppe-334's G2
cdbl_n_add with n = 8: 96, 58, 38, 36).

cmadd's mixed add shares the add's last two levels (add_finish) with its
own first level and operand forms. Its twin is held against
`cuda_curve.cmadd_plain` on thousands of seeded G1 and G2 lanes (a k p
offset written wrong changes a Montgomery product's limbs about once in
2^12 products) and on chip_smoke.py's edge lanes: the affine point at
infinity (the lane copies its accumulator and makes no product), the
accumulator at infinity (0 : y : 0), P = A and P = -A, every coordinate
at the top of its bound. Its rounds a lane at G = 2, 4, 8, 16, 32: G1 6,
4, 2, 2, 2; G2 28, 15, 9, 5, 4.

The fq12_mul kernel loads a and b into slots 0 and 12, writes the product
to 24 and keeps its leaves and Fq6 values at 36 and 90; a square (the
same tensor twice, fq12_sqr) loads a once and passes slot 0 as both
operands. Its twin runs tower_w32.cuh's f12_mul schedule over that layout
against `fq12_mul_plain`.
"""

from __future__ import annotations

import pytest
import torch

import chip_smoke as CS
from groth_sahai_tpu_torch.ops import cuda_curve as CC
from groth_sahai_tpu_torch.ops import cuda_tower as CT
from groth_sahai_tpu_torch.ops.curve import G1, G2
from groth_sahai_tpu_torch.ops.fp import FQ
from groth_sahai_tpu_torch.utils import curve_variants as CV
from groth_sahai_tpu_torch.utils.convert import limbs_from_numpy

from .test_torch_cuda_tower import with_edges
from .test_torch_tower import one_thread, rand_coeffs  # noqa: F401
from .test_torch_tower_w32 import (FastLane, Lane, add, dbl, f12_mul, ints,
                                   limbs, mul12, triple, words)
from .test_torch_words import NW

P = FQ.p
KP = {k: k * P for k in (2, 4, 8, 48, 96, 144)}   # curve_group_w32.cuh's


def subk(a, b, k):
    """a - b + k p, formed as (a + k p) - b; bound(b) <= k p."""
    assert b <= KP[k] and a + KP[k] < 1 << 400
    return add(a, KP[k]) - b


def sub(a, b):
    assert a >= b
    return a - b


def bound(v, k):
    """v, checked against the header's bound of k p."""
    assert v < k * P
    return v


class Slots:
    """CurveSlots<S>: Q, P, the zero coordinate, the G2 leaves, a level's
    products, the doubled point's four products, the finish's six."""

    def __init__(self, S: int):
        self.Q, self.P, self.ZERO, self.LEAF = 0, 3 * S, 6 * S, 7 * S
        self.MID = self.LEAF + (18 if S == 2 else 0)
        self.DBL = self.MID + 6 * S
        self.FIN = self.DBL + 4 * S
        self.SLOTS = self.FIN + 6 * S


def b3(S, a, u, k):
    """Component u of a 3b from a(w): 12 a (G1), 12 xi(a) (G2)."""
    if S == 1:
        return mul12(a(0))
    a0, a1 = a(0), a(1)
    return mul12(subk(a0, a1, k) if u == 0 else add(a0, a1))


def loaded(sl, at, S):
    """A Pt (xa, xb, ya, yb, z) of a loaded point: X = xa + the zero."""
    return (at, sl.ZERO, at + S, sl.ZERO, at + 2 * S)


def coord(ln, p, c, u):
    if c == 2:
        return ln.ld(p[4] + u)
    a, b = (p[0], p[1]) if c == 0 else (p[2], p[3])
    return add(ln.ld(a + u), ln.ld(b + u))


def products(ln, S, n, LEAF, OUT, ops):
    """n field products into OUT + S k + u: G1 a Montgomery product a task;
    G2 the Karatsuba leaves (components 0, 1, their sums), then the two
    components post-reduced."""
    if S == 1:
        def task(k):
            x, y = ops(k, 0)
            ln.st(OUT + k, ln.mont(x, y))
        ln.level(n, task)
        return

    def leaf(j):
        q = j % 3
        x = y = 0
        for u in range(int(q == 1), int(q != 0) + 1):
            a, b = ops(j // 3, u)
            x, y = add(x, a), add(y, b)
        ln.st(LEAF + j, ln.mont(x, y))

    def post(j):
        L = LEAF + 3 * (j // 2)
        t0, t1 = ln.ld(L), ln.ld(L + 1)
        c = subk(t0, t1, 2) if j % 2 == 0 else sub(subk(ln.ld(L + 2), t0, 4),
                                                   t1)
        ln.st(OUT + j, ln.post_red(c))
    ln.level(3 * n, leaf)
    ln.level(2 * n, post)


def cdbl(ln, S, sl, p):
    """One doubling of the Pt p; returns 2p as its four products."""
    M, D = sl.MID, sl.DBL
    for c in range(3):
        for u in range(S):
            bound(coord(ln, p, c, u), 4)
    products(ln, S, 4, sl.LEAF, M, lambda k, u: (
        coord(ln, p, 0x0211 >> (4 * k) & 15, u),
        coord(ln, p, 0x1221 >> (4 * k) & 15, u)))

    def T(i, u):
        return ln.ld(M + S * i + u)

    def ops(k, u):
        t0 = T(0, u)
        if k == 1:
            return T(1, u), bound(dbl(dbl(dbl(t0))), 16)      # Z3 = 8 t0
        t2 = bound(b3(S, lambda w: T(2, w), u, 2), 48 if S == 2 else 24)
        if k == 0:
            return t2, dbl(dbl(dbl(t0)))
        return (bound(subk(t0, triple(t2), 144), 146),        # t0'
                bound(add(t0, t2), 50) if k == 2 else T(3, u))
    products(ln, S, 4, sl.LEAF, D, ops)
    return (D + 3 * S, D + 3 * S, D, D + 2 * S, D + S)


def add_finish(ln, S, sl, t0p, t1, t2p, t3p, t4p, y3p, k1, out):
    """The finish's six products and the store level of an add, from the
    caller's operand forms (component u of each); t1' = t1 - t2' + k1 p."""
    F = sl.FIN

    def ops(k, u):
        if k in (1, 3):
            return y3p(u), t4p(u) if k == 1 else t0p(u)
        if k == 5:
            return t0p(u), t3p(u)
        t1u, t2 = t1(u), t2p(u)
        t1p = subk(t1u, t2, k1)
        z3 = add(t1u, t2)
        bound(t1p, k1 + 2)
        bound(z3, k1 + 2)
        if k == 0:
            return t3p(u), t1p
        return (t1p, z3) if k == 2 else (z3, t4p(u))
    products(ln, S, 6, sl.LEAF, F, ops)

    def store(j):
        c, u = j // S, j % S
        a, b = ln.ld(F + 2 * S * c + u), ln.ld(F + S * (2 * c + 1) + u)
        out(c, u, bound(subk(a, b, 2) if c == 0 else add(a, b), 4))
    ln.level(3 * S, store)


def y3_bound(S, u):
    """Y3' = b3(Y3r) with Y3r < 6p and offset 8p: G1 < 72p; G2 c0 < 168p,
    c1 < 144p."""
    return 72 if S == 1 else 168 - 24 * u


def cadd(ln, S, sl, p, q, out):
    """p + q; out(c, u, v) takes component u of coordinate c."""
    M = sl.MID

    def ops1(k, u):
        def side(r):
            a = coord(ln, r, 0x010210 >> (4 * k) & 15, u)
            return a if k < 3 else add(a, coord(
                ln, r, 0x221 >> (4 * (k - 3)) & 15, u))
        return side(p), side(q)
    products(ln, S, 6, sl.LEAF, M, ops1)

    def T(i, u):
        return ln.ld(M + S * i + u)

    def y3r(w):
        return bound(subk(T(5, w), add(T(0, w), T(2, w)), 4), 6)
    add_finish(
        ln, S, sl, lambda u: bound(triple(T(0, u)), 6), lambda u: T(1, u),
        lambda u: bound(b3(S, lambda w: T(2, w), u, 2),
                        48 if S == 2 else 24),
        lambda u: bound(subk(T(3, u), add(T(0, u), T(1, u)), 4), 6),
        lambda u: bound(subk(T(4, u), add(T(1, u), T(2, u)), 4), 6),
        lambda u: bound(b3(S, y3r, u, 8), y3_bound(S, u)), 48, out)


def cmadd(ln, S, sl, out):
    """The accumulator at sl.P plus the affine point at sl.Q (not at
    infinity); out(c, u, v) takes component u of coordinate c."""
    M = sl.MID

    def Pc(c, u):
        return ln.ld(sl.P + S * c + u)

    def A(c, u):
        return ln.ld(sl.Q + S * c + u)

    def ops1(k, u):          # X1 x2, Y1 y2, (x2 + y2)(X1 + Y1), y2 Z1, x2 Z1
        if k == 2:
            return add(A(0, u), A(1, u)), add(Pc(0, u), Pc(1, u))
        return (Pc(k, u), A(k, u)) if k < 2 else (A(4 - k, u), Pc(2, u))
    products(ln, S, 5, sl.LEAF, M, ops1)

    def T(i, u):
        return ln.ld(M + S * i + u)

    def y3r(w):
        return bound(add(T(4, w), Pc(0, w)), 6)
    add_finish(
        ln, S, sl, lambda u: bound(triple(T(0, u)), 6), lambda u: T(1, u),
        lambda u: bound(b3(S, lambda w: Pc(2, w), u, 4),
                        96 if S == 2 else 48),
        lambda u: bound(subk(T(2, u), add(T(0, u), T(1, u)), 4), 6),
        lambda u: bound(add(T(3, u), Pc(1, u)), 6),
        lambda u: bound(b3(S, y3r, u, 8), y3_bound(S, u)), 96, out)


def cmadd_twin(S, acc, aff, flag, lane_cls=Lane):
    """cmadd_kernel for one lane: acc is the accumulator's three
    coordinates and aff the affine point's two, S ints each; a flagged lane
    copies its accumulator. Returns the sum's three coordinates and the
    lane."""
    sl = Slots(S)
    ln = lane_cls(sl.SLOTS)
    if flag:
        return [list(c) for c in acc], ln
    for c in range(3):
        for u in range(S):
            bound(acc[c][u], 4)
    for c in range(2):
        for u in range(S):
            bound(aff[c][u], 2)

    def load(k):
        c = k // S
        ln.st(sl.P + k if c < 3 else sl.Q + k - 3 * S,
              (acc[c] if c < 3 else aff[c - 3])[k % S])
    ln.level(5 * S, load)
    out = [[None] * S for _ in range(3)]
    cmadd(ln, S, sl, lambda c, u, v: out[c].__setitem__(u, v))
    return out, ln


def cdbl_n_add_twin(S, pq, n):
    """cdbl_n_add_kernel for one lane: pq is P's then Q's coordinates, S
    ints each; returns the sum's three coordinates and the lane."""
    sl = Slots(S)
    ln = Lane(sl.SLOTS)

    def load(k):
        c = k // S
        if c == 6:
            ln.st(sl.ZERO + k % S, 0)
        else:
            ln.st(sl.P + k if c < 3 else sl.Q + k - 3 * S, pq[c][k % S])
    ln.level(7 * S, load)
    p = loaded(sl, sl.P, S)
    for _ in range(n):
        p = cdbl(ln, S, sl, p)
    out = [[None] * S for _ in range(3)]
    cadd(ln, S, sl, p, loaded(sl, sl.Q, S),
         lambda c, u, v: out[c].__setitem__(u, v))
    return out, ln


def rounds(S, n, G):
    """The header's rounds of products a lane."""
    dbl_r = {1: {4: 2, 8: 2, 16: 2, 32: 2}, 2: {4: 10, 8: 6, 16: 4, 32: 4}}
    add_r = {1: {4: 4, 8: 2, 16: 2, 32: 2}, 2: {4: 16, 8: 10, 16: 6, 32: 4}}
    return n * dbl_r[S][G] + add_r[S][G]


# ------------------------------------------------------------------ tests

def test_curve_offsets_and_slots():
    """make_curve_w's k p fit 13 words with word 12 below 2^16; the slot
    layout is 23 Fq slots a lane on G1 and 64 on G2, the lane's words odd
    (lane_words)."""
    for k, v in KP.items():
        assert v < 1 << 400 and words(v)[NW - 1] >> 16 == 0, k
    assert Slots(1).SLOTS == 23 and Slots(2).SLOTS == 64
    assert [s * NW | 1 for s in (23, 64)] == [299, 833]


@pytest.mark.parametrize("n", [0, 1, 8])
@pytest.mark.parametrize("name", ["G1", "G2"])
def test_group_cdbl_n_add_matches_plain(name, n):
    """The grouped schedule of n doublings and an add against
    cdbl_n_add_plain, limb for limb, on chip_smoke.py's five edge lanes
    and two seeded lanes (coordinates < 4p); the products and the rounds
    of the header."""
    curve = G2 if name == "G2" else G1
    S = curve.ns
    gen = torch.Generator().manual_seed(1000 * S + n)
    p, _, q, _ = CS.case_args("cdbl_n_add", curve, 7, n, gen, "cpu")
    want = CC.cdbl_n_add_plain(p, n, q, curve)
    vals = [ints(c.numpy()) for c in (*p, *q)]
    for lane in range(7):
        pq = [[int(v[u, lane]) for u in range(S)] if S == 2
              else [int(v[lane])] for v in vals]
        got, ln = cdbl_n_add_twin(S, pq, n)
        for c in range(3):
            w = want[c][..., lane]
            w = w.T.tolist() if S == 2 else [w.tolist()]
            assert [limbs(v) for v in got[c]] == w, (lane, c)
        assert ln.products == (8 * n + 12) * (5 if S == 2 else 1)
        for G in (4, 8, 16, 32):
            assert ln.rounds[G] == rounds(S, n, G), G
    if S == 2 and n == 8:
        assert [rounds(2, 8, G) for G in (4, 8, 16, 32)] == [96, 58, 38, 36]


# cmadd's rounds of products a lane at G = 2, 4, 8, 16, 32 (the header's)
CMADD_ROUNDS = {1: {2: 6, 4: 4, 8: 2, 16: 2, 32: 2},
                2: {2: 28, 4: 15, 8: 9, 16: 5, 32: 4}}


@pytest.mark.parametrize("name", ["G1", "G2"])
def test_group_cmadd_matches_plain(name):
    """The grouped mixed add against cmadd_plain, limb for limb, on 4096
    seeded lanes (accumulators < 4p, affine points < 2p, a
    quarter of them at infinity) whose first five are chip_smoke.py's
    edge lanes; the first eight through the packed-word product's
    instruction twin. A flagged lane makes no product; any other 11 (G1)
    or 55 (G2) in the header's rounds, every bound of the audit held and
    no slot shared within a level."""
    curve = G2 if name == "G2" else G1
    S = curve.ns
    lanes = 4096
    gen = torch.Generator().manual_seed(2000 + S)
    p, a, _ = CS.case_args("cmadd", curve, lanes, None, gen, "cpu")
    want = [w.numpy() for w in CC.cmadd_plain(p, a, curve)]
    vals = [ints(c.numpy()) for c in (*p, a[0], a[1])]
    flags = a[2].tolist()
    assert flags[:5] == [False, True, False, False, False]
    for lane in range(lanes):
        co = [[int(v[u, lane]) for u in range(S)] if S == 2
              else [int(v[lane])] for v in vals]
        got, ln = cmadd_twin(S, co[:3], co[3:], flags[lane],
                             Lane if lane < 8 else FastLane)
        for c in range(3):
            w = want[c][..., lane]
            w = w.T.tolist() if S == 2 else [w.tolist()]
            assert [limbs(v) for v in got[c]] == w, (lane, c)
        if flags[lane]:
            assert ln.products == 0
        else:
            assert ln.products == 11 * (5 if S == 2 else 1)
            assert ln.rounds == CMADD_ROUNDS[S]


@pytest.mark.parametrize("square", [False, True])
def test_group_fq12_mul_slot_layout(square):
    """fq12_mul_kernel's slots: a at 0, b at 12 (a square passes slot 0 as
    both), the product at 24, leaves at 36, Fq6 values at 90 -- 108 slots,
    out not aliased to a or b; against fq12_mul_plain, with coefficients
    up to 32p - 1 (bound(a) bound(b) <= 1024 p^2)."""
    lanes, top = 3, 32 * P - 1
    a = with_edges(rand_coeffs(51, 12, lanes, bound=32 * P), [top, 0])
    b = a if square else with_edges(rand_coeffs(52, 12, lanes,
                                                bound=32 * P), [top, top])
    want = CT.fq12_mul_plain(limbs_from_numpy(a, device="cpu"),
                             limbs_from_numpy(b, device="cpu"))
    va, vb = ints(a), ints(b)
    A, B, OUT, LEAF, T6 = 0, 12, 24, 36, 90
    for lane in range(lanes):
        ln = Lane(12 + 12 + 12 + 54 + 18)

        def load(k):
            src = va if k < 12 else vb
            ln.st(A + k, int(src[k % 12, lane]))
        ln.level(12 if square else 24, load)
        f12_mul(ln, A, A if square else B, OUT, LEAF, T6)
        assert [limbs(ln.ld(OUT + c)) for c in range(12)] == \
            want[:, :, lane].T.tolist()
        assert all(ln.s[B + c] is None for c in range(12)) == square
        assert ln.products == 66 and ln.rounds[16] == 5


def test_cdbl_group_variants_edit_the_committed_constants():
    """curve_variants.py --groups builds G = 4, 8, 16, 32 by editing both
    of curve_kernels.cu's group constants; each variant changes them."""
    text = (CV.cuda_build.CSRC / "curve_kernels.cu").read_text()
    built = {m.group(2): int(m.group(3))
             for m in CV._CDBL_CONST.finditer(text)}
    assert set(built) == {"kCdblGroupG1", "kCdblGroupG2"}
    variants = CV.group_variants("curve_kernels.cu", CV._CDBL_CONST, built)
    assert set(variants) == {"as built", "G=4", "G=8", "G=16", "G=32"}
    for name, edit in variants.items():
        if name != "as built":
            g = int(name[2:])
            new = edit["curve_kernels.cu"](text)
            assert {m.group(2): int(m.group(3))
                    for m in CV._CDBL_CONST.finditer(new)} == \
                {"kCdblGroupG1": g, "kCdblGroupG2": g}
    assert [n for _, n, _ in CV.CDBL_SHAPES] == [8, 4, 4, 13]


def test_curve_group_variants_cover_cmadd():
    """curve_variants.py --groups builds G = 2, 4, 8, 16, 32 by editing the
    two group constants that cdbl_n_add and cmadd both take (cmadd's
    launcher names them); cmadd is timed at its path shapes (the commits'
    1336 lanes, scalar-mul-g1-4096's 4096, gs-e2e's 128, 32 and 8)."""
    text = (CV.cuda_build.CSRC / "curve_kernels.cu").read_text()
    launch = text[text.index("int gs_cmadd("):text.index("int gs_cdbl_n_add(")]
    assert "launch_cmadd<1, kCdblGroupG1>" in launch
    assert "launch_cmadd<2, kCdblGroupG2>" in launch
    built = {m.group(2): int(m.group(3))
             for m in CV._CDBL_CONST.finditer(text)}
    variants = CV.group_variants("curve_kernels.cu", CV._CDBL_CONST, built,
                                 CV.CURVE_GROUPS)
    assert set(variants) == {"as built", "G=2", "G=4", "G=8", "G=16",
                             "G=32"}
    for name, edit in variants.items():
        if name != "as built":
            new = edit["curve_kernels.cu"](text)
            assert set(m.group(3) for m in CV._CDBL_CONST.finditer(new)) \
                == {name[2:]}
    assert {c for c, _ in CV.CMADD_SHAPES} == {"G1", "G2"}
    assert {m for _, m in CV.CMADD_SHAPES} >= {4096, 1336, 128, 32, 8}
