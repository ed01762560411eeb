"""Host-side (plain Python int) BLS12-381 tower + ate pairing.

A copy of the JAX package's module of the same name. In the port it is the
oracle of `chip_smoke.py` and its input maker, never on the device path.

Why this exists: CRS generation (the analogue of
the reference's src/generator.rs:81-118) is a ONE-TIME trusted-setup of
twelve scalar multiplications and a single pairing.  Compiling that onto
the accelerator buys nothing -- the XLA graph for it (8 scalar-mul scans +
Miller loop + batched inversions) took >5 minutes of compile time on CPU
(MULTICHIP_r03) for microseconds of math.  TPU-first design puts tiny
one-off scalar work on the HOST and keeps the accelerator for the batched
hot paths (MSM, batched pairings, prove/verify kernels).

The tower layout matches the device code (ops/tower.py) and arkworks:
    Fq2  = Fq[u]  / (u^2 + 1)          -- (c0, c1) int tuples
    Fq6  = Fq2[v] / (v^3 - (u+1))      -- 3-tuples of Fq2
    Fq12 = Fq6[w] / (w^2 - v)          -- 2-tuples of Fq6
M-type twist; the Miller loop mirrors the device schedule
(ops/pairing.py: projective doubling/addition steps, sparse line values at
coefficients (0,0), (0,1), (1,1)), so host and device agree bit-for-bit.

Point helpers build on utils/hostmath.py's generic Jacobian ops.
"""

from __future__ import annotations

from ..ops import bls12_381 as C
from . import hostmath as HM

P = C.P
R = C.R


# ---------------------------------------------------------------------------
# Fq2 (int tuples)
# ---------------------------------------------------------------------------

def f2_add(a, b):
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


def f2_sub(a, b):
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)


def f2_neg(a):
    return (-a[0] % P, -a[1] % P)


def f2_mul(a, b):
    return ((a[0] * b[0] - a[1] * b[1]) % P,
            (a[0] * b[1] + a[1] * b[0]) % P)


def f2_sqr(a):
    return f2_mul(a, a)


def f2_muls(a, k):
    return (a[0] * k % P, a[1] * k % P)


def f2_conj(a):
    return (a[0], -a[1] % P)


def f2_inv(a):
    t = pow(a[0] * a[0] + a[1] * a[1], P - 2, P)
    return (a[0] * t % P, -a[1] * t % P)


def f2_xi(a):
    """* (u + 1), the Fq6 non-residue."""
    return ((a[0] - a[1]) % P, (a[0] + a[1]) % P)


F2_ZERO = (0, 0)
F2_ONE = (1, 0)


# ---------------------------------------------------------------------------
# Fq6 (3-tuples of Fq2), Fq12 (2-tuples of Fq6)
# ---------------------------------------------------------------------------

def f6_add(a, b):
    return tuple(f2_add(x, y) for x, y in zip(a, b))


def f6_sub(a, b):
    return tuple(f2_sub(x, y) for x, y in zip(a, b))


def f6_neg(a):
    return tuple(f2_neg(x) for x in a)


def f6_mul(a, b):
    a0, a1, a2 = a
    b0, b1, b2 = b
    t0, t1, t2 = f2_mul(a0, b0), f2_mul(a1, b1), f2_mul(a2, b2)
    c0 = f2_add(t0, f2_xi(f2_sub(f2_mul(f2_add(a1, a2), f2_add(b1, b2)),
                                 f2_add(t1, t2))))
    c1 = f2_add(f2_sub(f2_mul(f2_add(a0, a1), f2_add(b0, b1)),
                       f2_add(t0, t1)), f2_xi(t2))
    c2 = f2_add(f2_sub(f2_mul(f2_add(a0, a2), f2_add(b0, b2)),
                       f2_add(t0, t2)), t1)
    return (c0, c1, c2)


def f6_mul_by_v(a):
    """* v: (c0, c1, c2) -> (xi*c2, c0, c1)."""
    return (f2_xi(a[2]), a[0], a[1])


def f6_inv(a):
    a0, a1, a2 = a
    t0 = f2_sub(f2_sqr(a0), f2_xi(f2_mul(a1, a2)))
    t1 = f2_sub(f2_xi(f2_sqr(a2)), f2_mul(a0, a1))
    t2 = f2_sub(f2_sqr(a1), f2_mul(a0, a2))
    d = f2_add(f2_mul(a0, t0),
               f2_xi(f2_add(f2_mul(a2, t1), f2_mul(a1, t2))))
    di = f2_inv(d)
    return (f2_mul(t0, di), f2_mul(t1, di), f2_mul(t2, di))


F6_ZERO = (F2_ZERO,) * 3
F6_ONE = (F2_ONE, F2_ZERO, F2_ZERO)


def f12_add(a, b):
    return (f6_add(a[0], b[0]), f6_add(a[1], b[1]))


def f12_mul(a, b):
    a0, a1 = a
    b0, b1 = b
    t0 = f6_mul(a0, b0)
    t1 = f6_mul(a1, b1)
    c1 = f6_sub(f6_mul(f6_add(a0, a1), f6_add(b0, b1)), f6_add(t0, t1))
    return (f6_add(t0, f6_mul_by_v(t1)), c1)


def f12_sqr(a):
    return f12_mul(a, a)


def f12_conj(a):
    return (a[0], f6_neg(a[1]))


def f12_inv(a):
    a0, a1 = a
    d = f6_sub(f6_mul(a0, a0), f6_mul_by_v(f6_mul(a1, a1)))
    di = f6_inv(d)
    return (f6_mul(a0, di), f6_neg(f6_mul(a1, di)))


def f12_pow(a, e: int):
    r = F12_ONE
    b = a
    while e:
        if e & 1:
            r = f12_mul(r, b)
        b = f12_sqr(b)
        e >>= 1
    return r


def f12_frob(a, power: int = 1):
    """a^(p^power) via per-coefficient conjugation + Frobenius constants."""
    out = []
    for i in range(2):
        row = []
        for j in range(3):
            c = a[i][j]
            if power % 2:
                c = f2_conj(c)
            g = C.FROB_FQ12_C1[power % 12]
            # coefficient of w^i v^j is multiplied by gamma^(6? ) -- use the
            # direct formula: w^(i) v^(j) has w-degree i + 2j... On the
            # (w^i v^j) basis with w^2 = v, the exponent of w is i + 2j and
            # frobenius multiplies by xi^((i+2j)(p^k-1)/6) = g^(i+2j).
            e = i + 2 * j
            m = F2_ONE
            for _ in range(e):
                m = f2_mul(m, g)
            row.append(f2_mul(c, m))
        out.append(tuple(row))
    return tuple(out)


F12_ZERO = (F6_ZERO, F6_ZERO)
F12_ONE = (F6_ONE, F6_ZERO)


# ---------------------------------------------------------------------------
# G1/G2 point helpers (ints; affine = (x, y) or None for infinity)
# ---------------------------------------------------------------------------

def g1_mul(pt, k: int):
    """[k] * affine G1 point -> affine."""
    if pt is None or k % R == 0:
        return None
    j = HM._mul(HM._OPS1, pt, k % R)
    return _jac_to_affine1(j)


def g1_add(a, b):
    if a is None:
        return b
    if b is None:
        return a
    j = HM._add_mixed(HM._OPS1, (a[0], a[1], 1), b)
    return _jac_to_affine1(j)


def g1_neg(a):
    return None if a is None else (a[0], -a[1] % P)


def g2_mul(pt, k: int):
    if pt is None or k % R == 0:
        return None
    j = HM._mul(HM._OPS2, pt, k % R)
    return _jac_to_affine2(j)


def g2_add(a, b):
    if a is None:
        return b
    if b is None:
        return a
    j = HM._add_mixed(HM._OPS2, (a[0], a[1], F2_ONE), b)
    return _jac_to_affine2(j)


def g2_neg(a):
    return None if a is None else (a[0], f2_neg(a[1]))


def _jac_to_affine1(j):
    X, Y, Z = j
    if Z == 0:
        return None
    zi = pow(Z, P - 2, P)
    zi2 = zi * zi % P
    return (X * zi2 % P, Y * zi2 * zi % P)


def _jac_to_affine2(j):
    X, Y, Z = j
    if Z == F2_ZERO:
        return None
    zi = f2_inv(Z)
    zi2 = f2_sqr(zi)
    return (f2_mul(X, zi2), f2_mul(Y, f2_mul(zi2, zi)))


# ---------------------------------------------------------------------------
# Ate pairing (mirrors the device schedule in ops/pairing.py)
# ---------------------------------------------------------------------------

_TWO_INV = pow(2, P - 2, P)
_B3 = C.B_G2                      # twist b = 4(u+1); the dbl step uses 3c*b


def _dbl_step(Rp):
    """Projective doubling + M-twist line coeffs (ops/pairing.py:72-99)."""
    X, Y, Z = Rp
    a = f2_muls(f2_mul(X, Y), _TWO_INV)
    b = f2_sqr(Y)
    c = f2_sqr(Z)
    j = f2_sqr(X)
    e = f2_mul(f2_muls(c, 3), _B3)
    f = f2_muls(e, 3)
    g = f2_muls(f2_add(b, f), _TWO_INV)
    h = f2_sub(f2_sqr(f2_add(Y, Z)), f2_add(b, c))
    i = f2_sub(e, b)
    e2 = f2_sqr(e)
    X3 = f2_mul(a, f2_sub(b, f))
    Y3 = f2_sub(f2_sqr(g), f2_muls(e2, 3))
    Z3 = f2_mul(b, h)
    return (X3, Y3, Z3), (i, f2_muls(j, 3), f2_neg(h))


def _add_step(Rp, Q):
    """Projective mixed addition + line coeffs (ops/pairing.py:102-123)."""
    X, Y, Z = Rp
    xq, yq = Q
    theta = f2_sub(Y, f2_mul(yq, Z))
    lam = f2_sub(X, f2_mul(xq, Z))
    cc = f2_sqr(theta)
    d = f2_sqr(lam)
    e = f2_mul(lam, d)
    f = f2_mul(Z, cc)
    g = f2_mul(X, d)
    h = f2_sub(f2_add(e, f), f2_add(g, g))
    X3 = f2_mul(lam, h)
    Y3 = f2_sub(f2_mul(theta, f2_sub(g, h)), f2_mul(e, Y))
    Z3 = f2_mul(e, Z)
    j = f2_sub(f2_mul(theta, xq), f2_mul(lam, yq))
    return (X3, Y3, Z3), (j, f2_neg(theta), lam)


def _ell(f, line, px, py):
    """f * sparse line value c0 + (c1 px) v + (c2 py) v w."""
    l0, l1, l2 = line
    c1 = f2_muls(l1, px)
    c2 = f2_muls(l2, py)
    lv = ((l0, c1, F2_ZERO), (F2_ZERO, c2, F2_ZERO))
    return f12_mul(f, lv)


def miller_loop(p_aff, q_aff):
    if p_aff is None or q_aff is None:
        return F12_ONE
    px, py = p_aff
    Rp = (q_aff[0], q_aff[1], F2_ONE)
    f = F12_ONE
    bits = bin(abs(C.X))[3:]              # MSB handled by initial R = Q
    for bit in bits:
        f = f12_sqr(f)
        Rp, line = _dbl_step(Rp)
        f = _ell(f, line, px, py)
        if bit == "1":
            Rp, line = _add_step(Rp, q_aff)
            f = _ell(f, line, px, py)
    return f12_conj(f)                    # x < 0


def final_exp(f):
    f1 = f12_mul(f12_conj(f), f12_inv(f))            # ^(p^6 - 1)
    m = f12_mul(f12_frob(f1, 2), f1)                 # ^(p^2 + 1)
    return f12_pow(m, C.FINAL_EXP_HARD)


def pairing(p_aff, q_aff):
    """Full ate pairing; returns the ops/tower.py `to_ints` nested layout
    ((3 Fq2-pairs), (3 Fq2-pairs))."""
    return final_exp(miller_loop(p_aff, q_aff))


_E0_CACHE = {}


def pairing_gen():
    """e(G1_gen, G2_gen), computed once per process."""
    if "e0" not in _E0_CACHE:
        _E0_CACHE["e0"] = pairing((C.G1_GEN_X, C.G1_GEN_Y),
                                  (C.G2_GEN_X, C.G2_GEN_Y))
    return _E0_CACHE["e0"]
