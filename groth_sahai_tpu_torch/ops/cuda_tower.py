"""Hand-written Hopper kernels of the Fq12 tower, with their plain versions.

The port of two kernels of ``groth_sahai_tpu/ops/pallas_tower.py``, written
in CUDA C++ for ``sm_90a`` in ``csrc/tower_kernels.cu`` over the in-thread
tower formulas ``csrc/tower.cuh`` (on ``csrc/field.cuh``):

  ==========  ============================================  ==================
  wrapper     replaces (TPU kernel)                         computes
  ==========  ============================================  ==================
  fq12_mul    pallas_tower.py:fq12_mul (_fq12_mul_kernel)   a*b, coeffs < 2p
  fq12_sqr    pallas_tower.py:fq12_sqr (the same kernel)    a*a
  cyc_pow     pallas_tower.py:cyc_pow (_cyc_pow_kernel)     a^e, e < 2^64
  ==========  ============================================  ==================

Both compute in the narrow domain: every Fq product is a Montgomery product
(< 2p), Karatsuba combinations use the reference's k*p offsets, and each
Fq12 result is post-reduced by a Montgomery product with R mod p. That is
another redundant form than the tower's lazy (wide-domain) formulas in
:mod:`.tower`: the same value mod p, not always the same limbs. `FQ12.mul`,
`FQ12.sqr` and `FQ12.cyclotomic_pow` take these kernels for batches of at
most 4096 lanes, as the reference does.

What bounds them on the H100: an Fq12 product is 66 Montgomery products
per lane (82,500 16x16-bit multiply-adds) against 7.2 KB of int64 limbs
moved, so both kernels are bound by the multiplier; at the few thousand
lanes of their calls, one thread per lane leaves most of the card idle and
each thread's dependent chain sets the time.

Dispatch rule: a CPU tensor runs the plain PyTorch version; a CUDA tensor
launches the kernel or raises. Each wrapper counts its launches in
``launches`` (`fq12_sqr` launches `fq12_mul`'s kernel and counts there).
"""

from __future__ import annotations

import ctypes

import torch

from .cuda_build import KernelLibrary, check, host_words, lanes, on_cpu, stream
from .cuda_fp import mont_mul_plain
from .fp import FQ

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
_U32 = ctypes.c_uint32
LIBRARY = KernelLibrary("gs_tower", "tower_kernels.cu",
                        ["tower.cuh", "field.cuh"], {
    "gs_fq12_mul": [_I, _P, _P, _P, _I64, _P, _P, _U32, _P],
    "gs_cyc_pow": [_I, _P, ctypes.c_uint64, _P, _I64, _P, _P, _U32, _P],
})

CYC_POW_NBITS = 64     # the kernel's fixed schedule: e < 2^64


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


KERNELS = (fq12_mul, cyc_pow)
PLAIN = {fq12_mul: fq12_mul_plain, cyc_pow: cyc_pow_plain}
for _k in KERNELS:
    _k.launches = 0


def reset_counts():
    for k in KERNELS:
        k.launches = 0
