"""Batched BLS12-381 ate pairing: Miller loop + final exponentiation.

The port of ``groth_sahai_tpu/ops/pairing.py``, with the same formulas,
schedule and bounds:

  * The Miller loop runs over the 63 bits of |x| after the first: the
    doubling step every iteration, the addition step on the five set bits
    (|x| has Hamming weight 6). The schedule is static, so it is a Python
    loop here (the reference's `lax.scan` + `lax.cond`). At most
    `FUSED_MAX_LANES` lanes, each iteration is one launch of a fused
    Miller-iteration kernel (f^2 line(P) and the point update together),
    as in the reference; above, the lazy tower formulas.
  * Line evaluations build sparse Fq12 elements; G1 arguments enter as
    affine coordinate tensors, G2 as homogeneous projective over Fq2.
  * `multi_miller` multiplies Miller outputs across an axis BEFORE the
    final exponentiation: a k-term product of pairings costs k Miller loops
    plus ONE final exp.
  * The final exponentiation uses the easy part + an exact hard-part chain
    lambda = (x-1)^2/3 * (x+p) * (x^2+p^2-1) + 1  (verified exactly against
    (p^4-p^2+1)/r), all cyclotomic ops.

Point-at-infinity handling: a pair with either side at infinity contributes
the identity (matches `E::pairing(0, q) = 1`).
"""

from __future__ import annotations

import torch

from .fp import FQ
from .tower import FQ2, FQ12
from . import bls12_381 as C
from . import cuda_tower as CT
from . import tower as T

_TWO_INV_INT = (C.P + 1) // 2
_B_TWIST_INTS = C.B_G2          # 4(u+1)

_X_BITS = [int(b) for b in bin(abs(C.X))[2:]]   # MSB first, 64 bits
_U_HARD = ((C.X - 1) ** 2) // 3                 # hard-part chain exponent
assert _U_HARD * (C.X + C.P) * (C.X ** 2 + C.P ** 2 - 1) + 1 == C.FINAL_EXP_HARD
# Split m^u into two short chains: u = v/3 * v with v = |x - 1| = |x| + 1
# (x < 0; 3 | x-1 for BLS parameters).
_V_ABS = abs(C.X) + 1
_V3 = _V_ABS // 3
assert _V3 * 3 == _V_ABS and _V3 * _V_ABS == _U_HARD

assert sum(_X_BITS) == 6 and len(_X_BITS) == 64


def _bcast_const(arr, batch_ndim):
    return arr.reshape(arr.shape + (1,) * batch_ndim)


def _sparse_to_fq12(c0, c1, c2, batch_shape):
    """Assemble the M-twist line value c0 + c1 v + c2 v w as a full Fq12.

    Coefficient positions (index 6i + 2j + u for w^i v^j u^u):
    c0 at (i=0, j=0), c1 at (i=0, j=1), c2 at (i=1, j=1).
    """
    z = FQ.zeros((2,) + tuple(batch_shape), device=c0.device)
    return torch.cat([c0, c1, z, z, c2, z], 1)


def _dbl_step(R, two_inv, b3):
    """Projective doubling step; returns (R', (l0, l1, l2)) line coeffs.

    Formulas per Costello-Lange-Naehrig (as standard for BLS12 pairings);
    all Fq2 ops with audited value bounds (comments give bounds in p units).
    """
    F2 = FQ2
    X, Y, Z = R
    # a = X*Y/2 ; b = Y^2 ; c = Z^2
    a = F2.mul_fq(F2.mul(X, Y), two_inv)           # < 2p
    t = F2.sqr(F2.stack([Y, Z, X]))
    b, c, j = F2.unstack(t, 3)                     # Y^2, Z^2, X^2 < 2p
    # e = 3 c * b_twist ; f = 3 e ; g = (b + f)/2
    e = F2.mul(FQ.add(FQ.double(c), c), b3)        # 3c * 4(u+1) via full mul; < 2p
    f = FQ.add(FQ.double(e), e)                    # < 6p
    g = F2.mul_fq(FQ.add(b, f), two_inv)           # < 2p
    # h = (Y+Z)^2 - (b+c) ; i = e - b ; j = X^2
    h = F2.sub(F2.sqr(FQ.add(Y, Z)), FQ.add(b, c), k=4)   # < 6p
    i = F2.sub(e, b, k=2)                          # < 4p
    e2 = F2.sqr(e)                                 # < 2p
    X3 = F2.mul(a, F2.sub(b, f, k=8))              # < 2p
    Y3 = F2.sub(F2.sqr(g), FQ.add(FQ.double(e2), e2), k=8)   # < 10p
    Z3 = F2.mul(b, h)                              # < 2p
    # line (M-twist): (i, 3j, -h)
    l0 = i
    l1 = FQ.add(FQ.double(j), j)                   # < 6p
    l2 = F2.neg(h, k=8)                            # < 8p
    return (X3, Y3, Z3), (l0, l1, l2)


def _add_step(R, Q):
    """Projective mixed-addition step with affine Q; returns (R', line)."""
    F2 = FQ2
    X, Y, Z = R
    xq, yq, _ = Q
    t = F2.mul(F2.stack([yq, xq]), F2.stack([Z, Z]))
    yqZ, xqZ = F2.unstack(t, 2)                    # < 2p
    theta = F2.sub(Y, yqZ, k=2)                    # < 12p (Y < 10p)
    lam = F2.sub(X, xqZ, k=2)                      # < 4p
    t = F2.sqr(F2.stack([theta, lam]))
    cc, d = F2.unstack(t, 2)                       # < 2p
    t = F2.mul(F2.stack([lam, Z, X]), F2.stack([d, cc, d]))
    e, f, g = F2.unstack(t, 3)                     # < 2p
    h = F2.sub(FQ.add(e, f), FQ.double(g), k=4)    # < 8p
    t = F2.mul(F2.stack([lam, Z, e]), F2.stack([h, e, Y]))
    X3, Z3, eY = F2.unstack(t, 3)                  # < 2p
    Y3 = F2.sub(F2.mul(theta, F2.sub(g, h, k=8)), eY, k=2)   # < 4p
    # line (M-twist): (j, -theta, lambda), j = theta x_q - lambda y_q
    t = F2.mul(F2.stack([theta, lam]), F2.stack([xq, yq]))
    txq, lyq = F2.unstack(t, 2)
    j = F2.sub(txq, lyq, k=2)                      # < 4p
    return (X3, Y3, Z3), (j, F2.neg(theta, k=16), lam)


def _ell(f, line, px, py, batch_shape):
    """f * line(P), with the line's c1, c2 scaled by P's affine coords."""
    l0, l1, l2 = line
    c1 = FQ2.mul_fq(l1, px)
    c2 = FQ2.mul_fq(l2, py)
    lv = _sparse_to_fq12(l0, c1, c2, batch_shape)
    return FQ12.mul(f, lv)


def miller_loop(p_aff, q_aff):
    """Batched Miller loop f_{|x|,Q}(P); infinity pairs give 1.

    p_aff: G1 affine (x, y, inf) with x, y int64[nl, *batch]
    q_aff: G2 affine over Fq2. Batch shapes must match (or broadcast).
    Returns an Fq12 element int64[nl, 12, *batch] on the inputs' device.
    """
    px, py, p_inf = p_aff
    batch = tuple(p_inf.shape)
    dev = px.device
    R = (q_aff[0], q_aff[1], FQ2.one(batch, device=dev))
    f = FQ12.one(batch, device=dev)
    if T._fused(f):
        # one fused launch per iteration (the reference's
        # pallas_tower.miller_iter_dbl / miller_iter_add)
        for do_add in _X_BITS[1:]:
            f, R = CT.miller_iter_dbl(f, R, px, py)
            if do_add:
                f, R = CT.miller_iter_add(f, R, q_aff[:2], px, py)
    else:
        two_inv = _bcast_const(FQ.from_int(_TWO_INV_INT, device=dev),
                               len(batch))
        b3 = _bcast_const(FQ2.from_int_pair(*_B_TWIST_INTS, device=dev),
                          len(batch))
        for do_add in _X_BITS[1:]:
            f = FQ12.sqr(f)
            R, line = _dbl_step(R, two_inv, b3)
            f = _ell(f, line, px, py, batch)
            if do_add:
                R, line = _add_step(R, q_aff)
                f = _ell(f, line, px, py, batch)
    # x < 0: conjugate
    f = FQ12.conj(f)
    # infinity on either side -> identity
    inf = p_inf | q_aff[2]
    return torch.where(inf[None, None], FQ12.one(batch, device=dev), f)


def multi_miller(p_aff, q_aff, axis: int = 0):
    """Product over `axis` (a batch axis) of Miller loops."""
    f = miller_loop(p_aff, q_aff)
    return _product_reduce(f, axis)


def _product_reduce(f, axis: int = 0):
    """Tree-reduce an Fq12 batch axis with FQ12.mul. axis counts batch dims
    (axis 0 = first dim after the (nl, 12) structure axes)."""
    ax = axis + 2
    size = f.shape[ax]
    while size > 1:
        half = size // 2
        m = FQ12.mul(f.narrow(ax, 0, half), f.narrow(ax, half, half))
        if size % 2:
            m = torch.cat([m, f.narrow(ax, 2 * half, size - 2 * half)], ax)
            size = half + 1
        else:
            size = half
        f = m
    return f.select(ax, 0)


def final_exp(f):
    """f^((p^12-1)/r): easy part then the exact-lambda cyclotomic chain."""
    F12 = FQ12
    # easy part: f^((p^6-1)(p^2+1))
    f1 = F12.mul(F12.conj(f), F12.inv(f))          # f^(p^6-1)
    m = F12.mul(F12.frobenius(f1, 2), f1)          # ^(p^2+1); cyclotomic now
    # hard part: lambda = u*(x+p)*(x^2+p^2-1) + 1, u = (x-1)^2/3
    a = F12.cyclotomic_pow(F12.cyclotomic_pow(m, _V3), _V_ABS)   # m^u
    b = F12.mul(F12.pow_x(a), F12.frobenius(a, 1))           # a^(x+p)
    bx2 = F12.pow_x(F12.pow_x(b))                  # b^(x^2)
    c = F12.mul(F12.mul(bx2, F12.frobenius(b, 2)), F12.conj(b))
    return F12.mul(c, m)


def pairing(p_aff, q_aff):
    """Full ate pairing e(P, Q), batched."""
    return final_exp(miller_loop(p_aff, q_aff))


def multi_pairing(p_aff, q_aff, axis: int = 0):
    """prod_k e(P_k, Q_k) with ONE final exponentiation."""
    return final_exp(multi_miller(p_aff, q_aff, axis))


# ---------------------------------------------------------------------------
# GT (pairing target group) helpers
# ---------------------------------------------------------------------------

def gt_mul(a, b):
    return FQ12.mul(a, b)


def gt_inv_cyclotomic(a):
    """Inverse in GT (= conjugate, since GT is in the cyclotomic subgroup)."""
    return FQ12.conj(a)


def gt_exp(a, scalar_limbs):
    """a^s for batched Fr scalars (standard-form limbs int64[17, *batch],
    broadcast to a's batch).

    0 < lanes <= `FUSED_MAX_LANES`: one launch of the fused power kernel
    (the reference's pallas_tower.f12_pow_dyn). Otherwise a square and a
    product per bit with a select, over all 16 * n_limbs bits, MSB first.
    """
    batch = a.shape[2:]
    if batch.numel() and T._fused(a):
        return CT.f12_pow_dyn(a, scalar_limbs)
    acc = FQ12.one(batch, device=a.device)
    for i in range(scalar_limbs.shape[0] * 16 - 1, -1, -1):
        acc = FQ12.sqr(acc)
        acc2 = FQ12.mul(acc, a)
        acc = torch.where(CT.scalar_bit(scalar_limbs, i)[None, None], acc2,
                          acc)
    return acc


def gt_eq(a, b):
    return FQ12.eq(a, b)


def gt_is_one(a):
    return FQ12.eq(a, FQ12.one(a.shape[2:], device=a.device))
