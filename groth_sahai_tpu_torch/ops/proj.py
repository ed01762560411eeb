"""Homogeneous projective points for the complete group law (RCB16).

The port of the data half of ``groth_sahai_tpu/ops/proj.py``: the point at
infinity, conversions to and from affine and Jacobian form, equality and
select. The complete law itself runs in the fused kernels of
:mod:`.cuda_curve` (`cmadd`, `cdbl_n_add`), which is how `scalar_mul`
reaches it; the reference's unfused `madd`, `add`, `dbl`, `dbl_n` and
`sum_reduce` serve its non-fused branch and its MSM, and come with the MSM.

Representation: (X, Y, Z) homogeneous, x = X/Z, y = Y/Z; infinity is
(0, y, 0) for any y != 0. Mixed inputs are the affine (x, y, inf) triples
of :mod:`.curve`. Coordinates stay < 4p (the kernels' invariant).
"""

from __future__ import annotations


def inf(curve, batch_shape=(), device="cuda"):
    """The point at infinity (0 : 1 : 0)."""
    F = curve.F
    return (F.zeros(batch_shape, device=device),
            F.one(batch_shape, device=device),
            F.zeros(batch_shape, device=device))


def is_inf(curve, p):
    return curve.F.is_zero(p[2], k=4)


def from_affine(curve, a):
    """(x, y, inf) -> projective; infinity maps to (0, 1, 0)."""
    x, y, ainf = a
    F = curve.F
    batch, dev = ainf.shape, ainf.device
    one = F.one(batch, device=dev)
    zero = F.zeros(batch, device=dev)
    sel = lambda t, f: curve.select(ainf, t, f)
    return (sel(zero, x), sel(one, y), sel(zero, one))


def to_affine(curve, p):
    """Projective -> (x, y, inf) with ONE batched inversion of Z."""
    X, Y, Z = p
    F = curve.F
    zinf = F.is_zero(Z, k=4)
    zi = F.inv_batch(Z)
    x = F.mul(X, zi)
    y = F.mul(Y, zi)
    zero = F.zeros(zinf.shape, device=zinf.device)
    return (F.select(zinf, zero, x), F.select(zinf, zero, y), zinf)


def to_jacobian(curve, p):
    """(X:Y:Z) homogeneous -> (X Z, Y Z^2, Z) Jacobian (same point)."""
    X, Y, Z = p
    F = curve.F
    return (F.mul(X, Z), F.mul(Y, F.mul(Z, Z)), Z)


def from_jacobian(curve, j):
    """(X:Y:Z) Jacobian -> (X Z, Y, Z^3) homogeneous (same point).

    Jacobian infinity (Z = 0) maps to (0, Y, 0), projective infinity
    whenever Y != 0; prefer `from_affine` when provenance is unknown.
    """
    X, Y, Z = j
    F = curve.F
    return (F.mul(X, Z), Y, F.mul(Z, F.mul(Z, Z)))


def eq(curve, p, q):
    """Projective equality: X1 Z2 == X2 Z1 and Y1 Z2 == Y2 Z1 (+inf cases)."""
    F = curve.F
    ex = F.eq(F.mul(p[0], q[2]), F.mul(q[0], p[2]))
    ey = F.eq(F.mul(p[1], q[2]), F.mul(q[1], p[2]))
    pi, qi = is_inf(curve, p), is_inf(curve, q)
    return (pi & qi) | (~pi & ~qi & ex & ey)


def select(curve, mask, p, q):
    return tuple(curve.select(mask, x, y) for x, y in zip(p, q))
