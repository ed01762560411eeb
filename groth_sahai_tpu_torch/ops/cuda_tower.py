"""Hand-written Hopper kernels of the Fq12 tower, with their plain versions.

The port of eight kernels of ``groth_sahai_tpu/ops/pallas_tower.py``, written
in CUDA C++ for ``sm_90a`` in ``csrc/tower_kernels.cu``, all over
``csrc/tower_w32.cuh`` (packed 32-bit words, ``csrc/field_w32.cuh``, a
group of threads per lane, ``csrc/group_w32.cuh``; ``cyc_sqr`` on
``cyc_pow``'s square, each step on its iteration's point levels):

  ===============  =================================  ========================
  wrapper          replaces (TPU kernel)              computes
  ===============  =================================  ========================
  fq12_mul         pallas_tower.py:fq12_mul           a*b, coeffs < 2p
  fq12_sqr         pallas_tower.py:fq12_sqr           a*a (fq12_mul's kernel)
  cyc_pow          pallas_tower.py:cyc_pow            a^e, e < 2^64
  cyc_sqr          pallas_tower.py:cyc_sqr            Granger-Scott a^2
  miller_iter_dbl  pallas_tower.py:miller_iter_dbl    f^2 line_RR(P), 2R
  miller_iter_add  pallas_tower.py:miller_iter_add    f line_RQ(P), R + Q
  f12_pow_dyn      pallas_tower.py:f12_pow_dyn        a^s, per-lane 272-bit s
  miller_dbl_step  pallas_tower.py:miller_dbl_step    2R and line_{R,R}
  miller_add_step  pallas_tower.py:miller_add_step    R + Q and line_{R,Q}
  ===============  =================================  ========================

All compute in the narrow domain: every Fq product is a Montgomery product
(< 2p), Karatsuba combinations use the reference's k*p offsets, and each
Fq12 result is post-reduced by a Montgomery product with R mod p. That is
another redundant form than the tower's lazy (wide-domain) formulas in
:mod:`.tower`: the same value mod p, not always the same limbs. The tower
(`FQ12.mul`, `sqr`, `cyclotomic_sqr`, `cyclotomic_pow`) and the pairing
(`miller_loop`, `gt_exp`) take these kernels for batches of at most 4096
lanes, as the reference does. The two step kernels are the point update and
line of one Miller iteration alone, entry points with no caller in either
package (the iterations supersede them).

What bounds them on the H100: an Fq12 product is 66 Montgomery products
per lane against 7.2 KB of int64 limbs moved, so every kernel here but
``cyc_sqr`` (30 products on 4.8 KB) is bound by the multiplier; at the few
thousand lanes of their calls (four for the verifier's final
exponentiation), one thread per lane leaves most of the card idle and each
thread's dependent chain sets the time. Every kernel shortens that chain:
each lane is worked by a group of threads (fq12_mul and f12_pow_dyn 16,
cyc_pow 32, the iterations and the addition step 8, the doubling step and
cyc_sqr 4), which take the independent products of each level of the
formulas side by side, with the lane's values in shared memory.

Dispatch rule: a CPU tensor runs the plain PyTorch version; a CUDA tensor
launches the kernel or raises. Each wrapper counts its launches in
``launches`` (`fq12_sqr` launches `fq12_mul`'s kernel and counts there).
"""

from __future__ import annotations

import ctypes

import torch

from .cuda_build import KernelLibrary, check, host_words, lanes, on_cpu, stream
from .cuda_fp import mont_mul_plain
from .fp import FQ, FR

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
_U32 = ctypes.c_uint32
LIBRARY = KernelLibrary("gs_tower", "tower_kernels.cu",
                        ["tower_w32.cuh", "group_w32.cuh", "field_w32.cuh"], {
    "gs_fq12_mul": [_I, _P, _P, _P, _I64, _P, _P, _U32, _P],
    "gs_cyc_pow": [_I, _P, ctypes.c_uint64, _P, _I64, _P, _P, _U32, _P],
    "gs_cyc_sqr": [_I, _P, _P, _I64, _P, _P, _U32, _P],
    "gs_miller_iter_dbl": [_I] + [_P] * 10 + [_I64, _P, _P, _P, _U32, _P],
    "gs_miller_iter_add": [_I] + [_P] * 12 + [_I64, _P, _P, _U32, _P],
    "gs_f12_pow_dyn": [_I, _I, _P, _P, _P, _I64, _P, _P, _U32, _P],
    "gs_miller_dbl_step": [_I] + [_P] * 9 + [_I64, _P, _P, _P, _U32, _P],
    "gs_miller_add_step": [_I] + [_P] * 11 + [_I64, _P, _P, _U32, _P],
})

CYC_POW_NBITS = 64     # the kernel's fixed schedule: e < 2^64
# 1/2 in Montgomery form: the doubling step's constant (the reference's
# `two_inv_int`, as the kernel receives it).
TWO_INV_MONT = (FQ.p + 1) // 2 * FQ.r_mod_p % FQ.p


# ---------------------------------------------------------------- plain versions
#
# The kernels' formulas on stacked tensors: every Fq product of one step is
# one Montgomery product over a stack, and the adds and k*p subtractions are
# the field core's exact limb ops, so each value is the kernel's integer and
# the limbs agree. Fq2 values are (nl, 2, *S) with the u axis at 1; extra
# stack axes ride along in *S.

def _mm(a, b):
    return mont_mul_plain(FQ, a, b)


def _f2_mul(a, b):
    """Karatsuba Fq2 product: (t0 - t1 < 4p, t2 - t0 - t1 < 6p)."""
    x = torch.stack([a[:, 0], a[:, 1], FQ.add(a[:, 0], a[:, 1])], 1)
    y = torch.stack([b[:, 0], b[:, 1], FQ.add(b[:, 0], b[:, 1])], 1)
    t = _mm(x, y)
    t0, t1, t2 = t[:, 0], t[:, 1], t[:, 2]
    return torch.stack([FQ.sub(t0, t1, k=2),
                        FQ.sub(FQ.sub(t2, t0, k=2), t1, k=2)], 1)


def _xi(a, k: int):
    """(u + 1) a = (a0 - a1, a0 + a1); bound(a) <= k p."""
    return torch.stack([FQ.sub(a[:, 0], a[:, 1], k=k),
                        FQ.add(a[:, 0], a[:, 1])], 1)


def _f6_mul(a, b):
    """Karatsuba Fq6 product of (nl, 3, 2, *S): c0 < 42p, c1 < 30p, c2 < 24p."""
    a0, a1, a2 = a[:, 0], a[:, 1], a[:, 2]
    b0, b1, b2 = b[:, 0], b[:, 1], b[:, 2]
    x = torch.stack([a0, a1, a2, FQ.add(a1, a2), FQ.add(a0, a1),
                     FQ.add(a0, a2)], 2)
    y = torch.stack([b0, b1, b2, FQ.add(b1, b2), FQ.add(b0, b1),
                     FQ.add(b0, b2)], 2)
    t = _f2_mul(x, y)                                  # (nl, 2, 6, *S)
    t0, t1, t2, s1, s2, s3 = (t[:, :, k] for k in range(6))
    u = FQ.sub(FQ.sub(s1, t1, k=6), t2, k=6)
    c0 = FQ.add(t0, _xi(u, 18))
    c1 = FQ.sub(FQ.sub(FQ.add(s2, _xi(t2, 6)), t0, k=6), t1, k=6)
    c2 = FQ.sub(FQ.sub(FQ.add(s3, t1), t0, k=6), t2, k=6)
    return torch.stack([c0, c1, c2], 1)


def _post_red(c):
    """Every coefficient times R mod p (Montgomery): < 2p."""
    one = FQ._const(FQ.r_mod_p, c.ndim, c.device).expand(c.shape)
    return _mm(c, one)


def _as_nested(a):
    """(nl, 12, *B) -> (nl, 2, 3, 2, *B): [i][j][u] for w^i v^j u^u."""
    return a.reshape((a.shape[0], 2, 3, 2) + a.shape[2:])


def fq12_mul_plain(a, b):
    """Karatsuba Fq12 product over Fq6, post-reduced to < 2p.

    Needs bound(a) * bound(b) <= 1024 p^2 (coefficientwise).
    """
    a, b = _as_nested(a), _as_nested(b)
    a0, a1, b0, b1 = a[:, 0], a[:, 1], b[:, 0], b[:, 1]
    x = torch.stack([a0, a1, FQ.add(a0, a1)], 3)       # (nl, 3, 2, 3, *B)
    y = torch.stack([b0, b1, FQ.add(b0, b1)], 3)
    t = _f6_mul(x, y)
    t0, t1, ts = t[:, :, :, 0], t[:, :, :, 1], t[:, :, :, 2]
    vt1 = torch.stack([_xi(t1[:, 2], 24), t1[:, 0], t1[:, 1]], 1)
    c0 = FQ.add(t0, vt1)                               # < 90p
    c1 = FQ.sub(FQ.sub(ts, t0, k=42), t1, k=42)        # < 126p
    c = torch.stack([c0, c1], 1)
    return _post_red(c).reshape((c.shape[0], 12) + c.shape[4:])


def cyc_sqr_plain(a):
    """Granger-Scott cyclotomic square, post-reduced; inputs < 2p."""
    nl, batch = a.shape[0], a.shape[2:]
    cl = a.reshape((nl, 6, 2) + batch).movedim(2, 1)   # Fq2 m = 3i + j
    x0 = cl[:, :, [0, 3, 1]]                           # (nl, 2, 3, *B)
    x1 = cl[:, :, [4, 2, 5]]
    v = torch.cat([x0, x1, FQ.add(x0, x1)], 2)         # the nine squares
    sd = torch.stack([FQ.add(v[:, 0], v[:, 1]), v[:, 0]], 1)
    de = torch.stack([FQ.sub(v[:, 0], v[:, 1], k=4), v[:, 1]], 1)
    pr = _mm(sd, de)
    sq = torch.stack([pr[:, 0], FQ.double(pr[:, 1])], 1)
    s0, s1, sx = sq[:, :, 0:3], sq[:, :, 3:6], sq[:, :, 6:9]
    ta = torch.stack([FQ.add(s0[:, 0], FQ.sub(s1[:, 0], s1[:, 1], k=4)),
                      FQ.add(s0[:, 1], FQ.add(s1[:, 0], s1[:, 1]))], 1)
    tb = torch.stack([FQ.sub(FQ.sub(sx[:, 0], s0[:, 0], k=2), s1[:, 0], k=2),
                      FQ.sub(FQ.sub(sx[:, 1], s0[:, 1], k=4), s1[:, 1], k=4)],
                     1)
    xi_c1 = _xi(tb[:, :, 2], 12)
    ca = cl[:, :, 0:3]
    za = FQ.add(FQ.double(FQ.sub(ta, ca, k=2)), ta)    # 3t - 2c
    tbb = torch.stack([xi_c1, tb[:, :, 0], tb[:, :, 1]], 2)
    zb = FQ.add(FQ.double(FQ.add(tbb, cl[:, :, 3:6])), tbb)   # 3t + 2c
    z = torch.cat([za, zb], 2).movedim(1, 2)           # (nl, 6, 2, *B)
    return _post_red(z).reshape((nl, 12) + batch)


def _cyc_pow_one(batch, device):
    """The kernel's starting value: R mod p in coefficient 0, zeros else."""
    z = FQ.zeros((11,) + tuple(batch), device=device)
    return torch.cat([FQ.one(batch, device=device)[:, None], z], 1)


def cyc_pow_plain(a, e: int):
    """a^e for e < 2^64: 64 post-reduced cyclotomic squares from one, a
    post-reduced product with a on each set bit (MSB first, leading zeros
    included)."""
    acc = _cyc_pow_one(a.shape[2:], a.device)
    for i in range(CYC_POW_NBITS - 1, -1, -1):
        acc = cyc_sqr_plain(acc)
        if (e >> i) & 1:
            acc = fq12_mul_plain(acc, a)
    return acc


# Miller iterations: the reference's `_dbl_step_body`, `_add_step_body`,
# `_f2_mul_fq` and `_sparse_line_mul`, with every Fq2 product of the point
# steps post-reduced (`_f2_mulred`). Independent products of one step are
# stacked into one Montgomery product; each value is the kernel's integer.

def _f2_mulred(a, b):
    """Fq2 product, both components post-reduced to < 2p."""
    return _post_red(_f2_mul(a, b))


def _f2_mul_fq(a, s):
    """Fq2 values (nl, 2, *S) times Fq scalars (nl, *T), T a suffix of S or
    empty: componentwise Montgomery products, < 2p."""
    s = s.reshape((s.shape[0],) + (1,) * (a.ndim - s.ndim) + s.shape[1:])
    return _mm(a, s.expand(a.shape))


def _triple(a):
    return FQ.add(FQ.double(a), a)


def _dbl_step_plain(X, Y, Z, tinv):
    """Projective doubling step: (X3 < 2p, Y3 < 10p, Z3 < 2p) and the line
    (l0 = i < 50p, l1 = 3j < 6p, l2 = -h < 8p); Y < 10p, X, Z < 2p."""
    st = lambda *xs: torch.stack(xs, 2)
    yz = FQ.add(Y, Z)
    t = _f2_mulred(st(X, Y, Z, X, yz), st(Y, Y, Z, X, yz))
    xy, b, c, j, yz2 = t.unbind(2)
    # e = 3c * b_twist = 12 xi(c) < 48p ; f = 3e < 144p
    e = FQ.mul_small(_xi(c, 2), 12)
    f = _triple(e)
    ag = _f2_mul_fq(st(xy, FQ.add(b, f)), tinv)    # a = XY/2, g = (b+f)/2
    a, g = ag.unbind(2)
    h = FQ.sub(yz2, FQ.add(b, c), k=4)                # < 6p
    l0 = FQ.sub(e, b, k=2)                            # i < 50p
    t = _f2_mulred(st(e, a, g, b), st(e, FQ.sub(b, f, k=144), g, h))
    e2, X3, g2, Z3 = t.unbind(2)
    Y3 = FQ.sub(g2, _triple(e2), k=8)                 # < 10p
    return (X3, Y3, Z3), (l0, _triple(j), FQ.neg(h, k=8))


def _add_step_plain(X, Y, Z, xq, yq):
    """Mixed addition step with affine Q: (X3, Y3 < 4p, Z3) and the line
    (j < 4p, -theta < 16p, lambda < 4p); Y < 10p."""
    st = lambda *xs: torch.stack(xs, 2)
    t = _f2_mulred(st(yq, xq), st(Z, Z))
    theta = FQ.sub(Y, t[:, :, 0], k=2)                # < 12p
    lam = FQ.sub(X, t[:, :, 1], k=2)                  # < 4p
    cc, d = _f2_mulred(st(theta, lam), st(theta, lam)).unbind(2)
    e, f, g = _f2_mulred(st(lam, Z, X), st(d, cc, d)).unbind(2)
    h = FQ.sub(FQ.add(e, f), FQ.double(g), k=4)       # < 8p
    t = _f2_mulred(st(lam, e, e, theta, theta, lam),
                   st(h, Z, Y, FQ.sub(g, h, k=8), xq, yq))
    X3, Z3, eY, tgh, txq, lyq = t.unbind(2)
    Y3 = FQ.sub(tgh, eY, k=2)                         # < 4p
    j = FQ.sub(txq, lyq, k=2)                         # < 4p
    return (X3, Y3, Z3), (j, FQ.neg(theta, k=16), lam)


def _sparse_line_mul_plain(f, la, lb, lc):
    """f (la + lb v + lc v w), post-reduced to < 2p: f < 2p, la < 50p,
    lb, lc < 2p; its 15 Fq2 products as one stack."""
    fn = _as_nested(f)                                # (nl, 2, 3, 2, *B)
    f0, f1 = fn[:, 0].movedim(1, 2), fn[:, 1].movedim(1, 2)   # (nl, 2, 3, *B)
    s = FQ.add(f0, f1)                                # < 4p
    w = FQ.add(lb, lc)
    rep = lambda x: x.unsqueeze(2).expand(x.shape[:2] + (3,) + x.shape[2:])
    t = _f2_mul(torch.cat([f0, f0, f1, s, s], 2),
                torch.cat([rep(la), rep(lb), rep(lc), rep(la), rep(w)], 2))

    def ab(pa, pb):
        """(c0 + c1 v + c2 v^2)(a + b v) from c_j a and c_j b: < 18p."""
        return FQ.add(pa, torch.stack([_xi(pb[:, :, 2], 6), pb[:, :, 0],
                                       pb[:, :, 1]], 2))

    t0 = ab(t[:, :, 0:3], t[:, :, 3:6])
    cv = t[:, :, 6:9]                                 # c_j c: (c v) product
    t1 = torch.stack([_xi(cv[:, :, 2], 6), cv[:, :, 0], cv[:, :, 1]], 2)
    ts = ab(t[:, :, 9:12], t[:, :, 12:15])
    out0 = FQ.add(t0, torch.stack([_xi(t1[:, :, 2], 12), t1[:, :, 0],
                                   t1[:, :, 1]], 2))  # < 54p
    out1 = FQ.sub(FQ.sub(ts, t0, k=18), t1, k=18)     # < 54p
    c = torch.stack([out0, out1], 1).movedim(2, 3)    # (nl, 2, 3, 2, *B)
    return _post_red(c).reshape((c.shape[0], 12) + c.shape[4:])


def _line_scale(l1, l2, px, py):
    """(l1 px, l2 py): the line's v and v w coefficients at P, < 2p."""
    lbc = _f2_mul_fq(torch.stack([l1, l2], 2), torch.stack([px, py], 1))
    return lbc[:, :, 0], lbc[:, :, 1]


def _tinv(device):
    return FQ._const(TWO_INV_MONT, 1, device)


def miller_iter_dbl_plain(f, R, px, py):
    """(f^2 line_{R,R}(P), 2R): f < 2p; R = (X, Y, Z), X, Z < 2p, Y < 10p."""
    fsq = fq12_mul_plain(f, f)
    R3, (l0, l1, l2) = _dbl_step_plain(*R, _tinv(f.device))
    lb, lc = _line_scale(l1, l2, px, py)
    return _sparse_line_mul_plain(fsq, l0, lb, lc), R3


def miller_iter_add_plain(f, R, Q, px, py):
    """(f line_{R,Q}(P), R + Q) with Q = (xq, yq) affine; Y < 10p."""
    R3, (l0, l1, l2) = _add_step_plain(*R, *Q)
    lb, lc = _line_scale(l1, l2, px, py)
    return _sparse_line_mul_plain(f, l0, lb, lc), R3


def miller_dbl_step_plain(Rp, two_inv_int: int):
    """(2R, (l0, l1, l2)) of the doubling step; 1/2 = two_inv_int."""
    X, Y, Z = torch.broadcast_tensors(*Rp)
    tinv = FQ._const(two_inv_int * FQ.r_mod_p % FQ.p, 1, X.device)
    return _dbl_step_plain(X, Y, Z, tinv)


def miller_add_step_plain(Rp, q_aff):
    """(R + Q, (l0, l1, l2)) of the mixed addition step."""
    return _add_step_plain(*torch.broadcast_tensors(*Rp, *q_aff[:2]))


POW_DYN_NBITS = 16 * FR.n   # f12_pow_dyn's schedule: all 272 scalar bits


def f12_pow_dyn_round(acc, a, bit):
    """One round of the power: (acc^2 a if bit else acc^2), post-reduced --
    the reference's order (square, product, select)."""
    sq = fq12_mul_plain(acc, acc)
    return torch.where(bit[None, None], fq12_mul_plain(sq, a), sq)


def scalar_bit(s, b: int):
    """Bit b of standard-form scalar limbs s (17, *batch) as a bool batch."""
    return ((s[b // 16] >> (b % 16)) & 1).bool()


def f12_pow_dyn_plain(a, s):
    """a^s with per-lane scalars s (17 standard-form Fr limbs, broadcast to
    a's batch): 272 rounds from one, MSB first, leading zeros included."""
    s = s.expand((FR.n,) + a.shape[2:])
    acc = _cyc_pow_one(a.shape[2:], a.device)
    for b in range(POW_DYN_NBITS - 1, -1, -1):
        acc = f12_pow_dyn_round(acc, a, scalar_bit(s, b))
    return acc


# --------------------------------------------------------------------- wrappers

def _rows12(x, what: str):
    return lanes(x, FQ.n, what).reshape(FQ.n * 12, -1)


def fq12_mul(a, b):
    """Fused Fq12 product (one launch), coefficients post-reduced to < 2p.

    Replaces pallas_tower.py:fq12_mul (_fq12_mul_kernel). Inputs
    (25, 12, *batch) with bound(a) * bound(b) <= 1024 p^2.
    """
    a, b = torch.broadcast_tensors(a, b)
    if on_cpu(a, b):
        return fq12_mul_plain(a, b)
    a2 = _rows12(a, "fq12_mul a")
    b2 = _rows12(b, "fq12_mul b")
    out = torch.empty_like(a2)
    m = a2.shape[1]
    if m:
        check(LIBRARY.get().gs_fq12_mul(
            FQ.n, a2.data_ptr(), b2.data_ptr(), out.data_ptr(), m,
            host_words(FQ, FQ.p), host_words(FQ, FQ.r_mod_p), FQ.n0,
            stream(a2)), "fq12_mul", FQ.n)
        fq12_mul.launches += 1
    return out.reshape(a.shape)


def fq12_sqr(a):
    """a * a through the product kernel (pallas_tower.py:fq12_sqr)."""
    return fq12_mul(a, a)


def cyc_pow(a, e: int):
    """a^e in the cyclotomic subgroup as one launch; 0 < e < 2^64.

    Replaces pallas_tower.py:cyc_pow (_cyc_pow_kernel); the caller
    conjugates where the reference's `conjugate_result` asks it.
    """
    assert 0 < e.bit_length() <= CYC_POW_NBITS
    if on_cpu(a):
        return cyc_pow_plain(a, e)
    a2 = _rows12(a, "cyc_pow a")
    out = torch.empty_like(a2)
    m = a2.shape[1]
    if m:
        check(LIBRARY.get().gs_cyc_pow(
            FQ.n, a2.data_ptr(), e, out.data_ptr(), m,
            host_words(FQ, FQ.p), host_words(FQ, FQ.r_mod_p), FQ.n0,
            stream(a2)), "cyc_pow", FQ.n)
        cyc_pow.launches += 1
    return out.reshape(a.shape)


def cyc_sqr(a):
    """One Granger-Scott cyclotomic square as one launch, post-reduced to
    < 2p; inputs < 2p.

    Replaces pallas_tower.py:cyc_sqr (_cyc_sqr_kernel).
    """
    if on_cpu(a):
        return cyc_sqr_plain(a)
    a2 = _rows12(a, "cyc_sqr a")
    out = torch.empty_like(a2)
    m = a2.shape[1]
    if m:
        check(LIBRARY.get().gs_cyc_sqr(
            FQ.n, a2.data_ptr(), out.data_ptr(), m, host_words(FQ, FQ.p),
            host_words(FQ, FQ.r_mod_p), FQ.n0, stream(a2)), "cyc_sqr", FQ.n)
        cyc_sqr.launches += 1
    return out.reshape(a.shape)


def _broadcast_lanes(f, fq2s, fqs):
    """Expand an Fq12 batch, Fq2 values and Fq values to one batch shape."""
    batch = torch.broadcast_shapes(f.shape[2:], *(x.shape[2:] for x in fq2s),
                                   *(x.shape[1:] for x in fqs))
    ex = lambda x, lead: x.expand(x.shape[:lead] + batch)
    return (ex(f, 2), [ex(x, 2) for x in fq2s], [ex(x, 1) for x in fqs],
            batch)


def _miller_launch(wrapper, f, fq2s, fqs, extra):
    """Launch the Miller-iteration kernel of `wrapper` and count it;
    returns (f', (X3, Y3, Z3))."""
    name = wrapper.__name__
    f, fq2s, fqs, batch = _broadcast_lanes(f, fq2s, fqs)
    n = FQ.n
    f2 = _rows12(f, name + " f")
    ins = ([f2] + [lanes(x, n, f"{name} Fq2").reshape(2 * n, -1)
                   for x in fq2s] + [lanes(x, n, f"{name} Fq") for x in fqs])
    m = f2.shape[1]
    fo = torch.empty_like(f2)
    rs = [torch.empty((2 * n, m), dtype=torch.int64, device=f2.device)
          for _ in range(3)]
    if m:
        fn = getattr(LIBRARY.get(), "gs_" + name)
        check(fn(n, *(x.data_ptr() for x in ins + [fo] + rs), m,
                 host_words(FQ, FQ.p), host_words(FQ, FQ.r_mod_p), *extra,
                 FQ.n0, stream(f2)), name, n)
        wrapper.launches += 1
    shape2 = (n, 2) + tuple(batch)
    return fo.reshape(f.shape), tuple(r.reshape(shape2) for r in rs)


def miller_iter_dbl(f, R, px, py):
    """One Miller doubling iteration as one launch: (f^2 line_{R,R}(P), 2R).

    Replaces pallas_tower.py:miller_iter_dbl (_miller_iter_dbl_kernel).
    f (25, 12, *batch) < 2p; R = (X, Y, Z) Fq2 (25, 2, *batch) with
    X, Z < 2p, Y < 10p; P = (px, py) Fq (25, *batch) affine. Batch shapes
    broadcast; the kernel takes contiguous copies.
    """
    if on_cpu(f, *R, px, py):
        return miller_iter_dbl_plain(f, R, px, py)
    return _miller_launch(miller_iter_dbl, f, list(R), [px, py],
                          [host_words(FQ, TWO_INV_MONT)])


def miller_iter_add(f, R, Q, px, py):
    """One Miller addition iteration as one launch: (f line_{R,Q}(P), R + Q).

    Replaces pallas_tower.py:miller_iter_add (_miller_iter_add_kernel).
    As `miller_iter_dbl`, with Q = (xq, yq) affine Fq2 (25, 2, *batch).
    """
    if on_cpu(f, *R, *Q, px, py):
        return miller_iter_add_plain(f, R, Q, px, py)
    return _miller_launch(miller_iter_add, f, list(R) + list(Q), [px, py],
                          [])


def f12_pow_dyn(a, s):
    """a^s with per-lane scalars as one launch.

    Replaces pallas_tower.py:f12_pow_dyn (_f12_pow_dyn_kernel). a
    (25, 12, *batch) < 2p, any Fq12 (not only the cyclotomic subgroup);
    s (17, ...) standard-form Fr limbs, broadcast to the batch; all 272
    bits are read, canonical or not.
    """
    if on_cpu(a, s):
        return f12_pow_dyn_plain(a, s)
    a2 = _rows12(a, "f12_pow_dyn a")
    s2 = lanes(s.expand((FR.n,) + a.shape[2:]), FR.n, "f12_pow_dyn s")
    out = torch.empty_like(a2)
    m = a2.shape[1]
    if m:
        check(LIBRARY.get().gs_f12_pow_dyn(
            FQ.n, FR.n, a2.data_ptr(), s2.data_ptr(), out.data_ptr(), m,
            host_words(FQ, FQ.p), host_words(FQ, FQ.r_mod_p), FQ.n0,
            stream(a2)), "f12_pow_dyn", FQ.n)
        f12_pow_dyn.launches += 1
    return out.reshape(a.shape)


def _step_launch(wrapper, fq2s, extra):
    """Launch the Miller-step kernel of `wrapper` over Fq2 inputs of one
    broadcast batch and count it; returns ((X3, Y3, Z3), (l0, l1, l2))."""
    name = wrapper.__name__
    n = FQ.n
    fq2s = torch.broadcast_tensors(*fq2s)
    ins = [lanes(x, n, f"{name} Fq2").reshape(2 * n, -1) for x in fq2s]
    m = ins[0].shape[1]
    outs = [torch.empty_like(ins[0]) for _ in range(6)]
    if m:
        fn = getattr(LIBRARY.get(), "gs_" + name)
        check(fn(n, *(x.data_ptr() for x in ins + outs), m,
                 host_words(FQ, FQ.p), host_words(FQ, FQ.r_mod_p), *extra,
                 FQ.n0, stream(ins[0])), name, n)
        wrapper.launches += 1
    outs = [o.reshape(fq2s[0].shape) for o in outs]
    return tuple(outs[:3]), tuple(outs[3:])


def miller_dbl_step(Rp, two_inv_int: int):
    """The Miller doubling step as one launch: (2R, (l0, l1, l2)), the line
    not scaled by P.

    Replaces pallas_tower.py:miller_dbl_step (_miller_dbl_kernel). R = (X,
    Y, Z) Fq2 (25, 2, *batch) with X, Z < 2p, Y < 10p; two_inv_int is 1/2
    mod p as an int (the kernel takes it in Montgomery form). Returns 2R
    (X3 < 2p, Y3 < 10p, Z3 < 2p) and the line l0 = i < 50p, l1 = 3j < 6p,
    l2 = -h < 8p, each Fq2 (25, 2, *batch). Batch shapes broadcast.
    """
    if on_cpu(*Rp):
        return miller_dbl_step_plain(Rp, two_inv_int)
    tinv = two_inv_int * FQ.r_mod_p % FQ.p
    return _step_launch(miller_dbl_step, list(Rp), [host_words(FQ, tinv)])


def miller_add_step(Rp, q_aff):
    """The Miller mixed addition step as one launch: (R + Q, (l0, l1, l2)).

    Replaces pallas_tower.py:miller_add_step (_miller_add_kernel). R as in
    `miller_dbl_step`, Q = (xq, yq[, ...]) affine Fq2 < p. Returns R + Q
    (Y3 < 4p) and the line j < 4p, -theta < 16p, lambda < 4p.
    """
    if on_cpu(*Rp, *q_aff[:2]):
        return miller_add_step_plain(Rp, q_aff)
    return _step_launch(miller_add_step, list(Rp) + list(q_aff[:2]), [])


KERNELS = (fq12_mul, cyc_pow, cyc_sqr, miller_iter_dbl, miller_iter_add,
           f12_pow_dyn, miller_dbl_step, miller_add_step)
PLAIN = {fq12_mul: fq12_mul_plain, cyc_pow: cyc_pow_plain,
         cyc_sqr: cyc_sqr_plain, miller_iter_dbl: miller_iter_dbl_plain,
         miller_iter_add: miller_iter_add_plain,
         f12_pow_dyn: f12_pow_dyn_plain,
         miller_dbl_step: miller_dbl_step_plain,
         miller_add_step: miller_add_step_plain}
for _k in KERNELS:
    _k.launches = 0


def reset_counts():
    for k in KERNELS:
        k.launches = 0
