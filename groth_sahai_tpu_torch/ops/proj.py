"""Homogeneous projective points for the complete group law (RCB16).

The port of ``groth_sahai_tpu/ops/proj.py``: the point at infinity,
conversions to and from affine and Jacobian form, equality and select, and
the complete law under the reference's names (`madd`, `add`, `dbl`,
`dbl_n`, `sum_reduce`) as thin functions over the fused kernels of
:mod:`.cuda_curve` (`cmadd`, `cadd`, `cdbl_n_add`). The reference's unfused
law multiplies by a Montgomery constant 3b where its fused bodies (and so
these kernels) multiply by 12: the same law by value, another redundant
form by limb; the port keeps the one form.

Representation: (X, Y, Z) homogeneous, x = X/Z, y = Y/Z; infinity is
(0, y, 0) for any y != 0. Mixed inputs are the affine (x, y, inf) triples
of :mod:`.curve`. Coordinates stay < 4p (the kernels' invariant).
"""

from __future__ import annotations

import torch

from . import cuda_curve as CC


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


def madd(curve, p, a):
    """Complete mixed addition P + A (RCB16 Algorithm 8): one `cmadd`.

    p projective (coords < 4p); a affine (x, y, inf), coords < 2p.
    """
    return CC.cmadd(p, a, curve)


def add(curve, p, q):
    """Complete projective addition P + Q (RCB16 Algorithm 7): one `cadd`;
    coords < 4p in and out."""
    return CC.cadd(p, q, curve)


def dbl_n(curve, p, n: int):
    """n complete doublings (RCB16 Algorithm 9): one `cdbl_n_add` launch,
    2^n P + (0 : 1 : 0)."""
    o = inf(curve, p[0].shape[curve.ns:], device=p[0].device)
    return CC.cdbl_n_add(p, n, o, curve)


def dbl(curve, p):
    return dbl_n(curve, p, 1)


def sum_reduce(curve, p, axis: int = 0):
    """Tree-reduce a batch axis with the complete addition (`cadd`)."""
    ax = curve.ns + axis
    pts = p
    size = pts[0].shape[ax]
    while size > 1:
        half = size // 2
        summed = add(curve, tuple(l.narrow(ax, 0, half) for l in pts),
                     tuple(l.narrow(ax, half, half) for l in pts))
        if size % 2:
            summed = tuple(torch.cat([a, l.narrow(ax, 2 * half, 1)], ax)
                           for a, l in zip(summed, pts))
            size = half + 1
        else:
            size = half
        pts = summed
    return tuple(l.select(ax, 0) for l in pts)
