"""Host-side (plain Python int) BLS12-381 point arithmetic (a copy of the
JAX package's module of the same name), first written for serde
validation: on-curve and r-torsion subgroup checks on deserialize, matching
arkworks' `Validate::Yes` behaviour that the reference relies on through
its `CanonicalDeserialize` derives (data_structures.rs:128-133).

Serde is a host path (bytes <-> ints); validating with device kernels
would cost a dispatch per point. Jacobian double-and-add here is ~5 ms per
point -- fine for CRS/proof I/O.
"""

from __future__ import annotations

from ..ops import bls12_381 as C

P = C.P
R = C.R


# ---------------------------------------------------------------------------
# Fq2 helpers (tuples (c0, c1), u^2 = -1)
# ---------------------------------------------------------------------------

def _f2_add(a, b):
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


def _f2_sub(a, b):
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)


def _f2_mul(a, b):
    return ((a[0] * b[0] - a[1] * b[1]) % P,
            (a[0] * b[1] + a[1] * b[0]) % P)


def _f2_sqr(a):
    return _f2_mul(a, a)


# ---------------------------------------------------------------------------
# generic Jacobian arithmetic over a field given by (mul, sqr, add, sub)
# ---------------------------------------------------------------------------

class _Ops:
    def __init__(self, mul, sqr, add, sub, zero, one):
        self.mul, self.sqr, self.add, self.sub = mul, sqr, add, sub
        self.zero, self.one = zero, one


_OPS1 = _Ops(lambda a, b: a * b % P, lambda a: a * a % P,
             lambda a, b: (a + b) % P, lambda a, b: (a - b) % P, 0, 1)
_OPS2 = _Ops(_f2_mul, _f2_sqr, _f2_add, _f2_sub, (0, 0), (1, 0))


def _dbl(ops, p):
    X, Y, Z = p
    if Z == ops.zero or Y == ops.zero:
        return (ops.one, ops.one, ops.zero)
    A = ops.sqr(X)
    B = ops.sqr(Y)
    Cc = ops.sqr(B)
    D = ops.sub(ops.sqr(ops.add(X, B)), ops.add(A, Cc))
    D = ops.add(D, D)
    E = ops.add(ops.add(A, A), A)
    F = ops.sqr(E)
    X3 = ops.sub(F, ops.add(D, D))
    Y3 = ops.sub(ops.mul(E, ops.sub(D, X3)),
                 ops.add(ops.add(ops.add(Cc, Cc), ops.add(Cc, Cc)),
                         ops.add(ops.add(Cc, Cc), ops.add(Cc, Cc))))
    Z3 = ops.add(ops.mul(Y, Z), ops.mul(Y, Z))
    return (X3, Y3, Z3)


def _add_mixed(ops, p, a):
    """Jacobian + affine (a != infinity)."""
    X1, Y1, Z1 = p
    x2, y2 = a
    if Z1 == ops.zero:
        return (x2, y2, ops.one)
    Z1Z1 = ops.sqr(Z1)
    U2 = ops.mul(x2, Z1Z1)
    S2 = ops.mul(y2, ops.mul(Z1, Z1Z1))
    if U2 == X1:
        if S2 == Y1:
            return _dbl(ops, p)
        return (ops.one, ops.one, ops.zero)
    H = ops.sub(U2, X1)
    HH = ops.sqr(H)
    I = ops.add(ops.add(HH, HH), ops.add(HH, HH))
    J = ops.mul(H, I)
    r = ops.sub(S2, Y1)
    r = ops.add(r, r)
    V = ops.mul(X1, I)
    X3 = ops.sub(ops.sub(ops.sqr(r), J), ops.add(V, V))
    Y3 = ops.sub(ops.mul(r, ops.sub(V, X3)),
                 ops.add(ops.mul(Y1, J), ops.mul(Y1, J)))
    Z3 = ops.sub(ops.sqr(ops.add(Z1, H)), ops.add(Z1Z1, HH))
    return (X3, Y3, Z3)


def _mul(ops, a, k):
    """[k] * affine a, Jacobian out."""
    acc = (ops.one, ops.one, ops.zero)
    for bit in bin(k)[2:]:
        acc = _dbl(ops, acc)
        if bit == "1":
            acc = _add_mixed(ops, acc, a)
    return acc


# ---------------------------------------------------------------------------
# public checks
# ---------------------------------------------------------------------------

def g1_on_curve(pt) -> bool:
    """(x, y) ints; infinity (None) is on-curve."""
    if pt is None:
        return True
    x, y = pt
    if not (0 <= x < P and 0 <= y < P):
        return False
    return (y * y - (x * x * x + C.B_G1)) % P == 0


def g1_in_subgroup(pt) -> bool:
    """[r]P == O (arkworks validates this on every deserialize)."""
    if pt is None:
        return True
    return _mul(_OPS1, pt, R)[2] == 0


def g2_on_curve(pt) -> bool:
    if pt is None:
        return True
    x, y = pt
    if not all(0 <= c < P for c in (*x, *y)):
        return False
    rhs = _f2_add(_f2_mul(_f2_sqr(x), x), C.B_G2)
    return _f2_sqr(y) == rhs


def g2_in_subgroup(pt) -> bool:
    if pt is None:
        return True
    return _mul(_OPS2, pt, R)[2] == (0, 0)
