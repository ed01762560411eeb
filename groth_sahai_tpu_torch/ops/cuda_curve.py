"""Hand-written Hopper kernels of the curve group law, with their plain
versions.

The port of four kernels of ``groth_sahai_tpu/ops/pallas_curve.py``,
written in CUDA C++ for ``sm_90a`` in ``csrc/curve_kernels.cu``, all on Fq
values of 13 packed 32-bit words at the boundary's R = 2^400: `cadd` and
`cmsm_row_scan` one thread a lane (``csrc/curve_w32.cuh`` on
``csrc/field_w32.cuh``), `cmadd` and `cdbl_n_add` with a group of threads
a lane (``csrc/curve_group_w32.cuh`` on ``csrc/group_w32.cuh``):

  =============  ===================================  ========================
  wrapper        replaces (TPU kernel)                computes
  =============  ===================================  ========================
  cmadd          pallas_curve.py:cmadd                P + A, P projective, A
                                                      affine (complete, RCB16)
  cadd           pallas_curve.py:cadd                 P + Q, projective
  cdbl_n_add     pallas_curve.py:cdbl_n_add           2^n P + Q, projective
  cmsm_row_scan  pallas_curve.py:cmsm_row_scan        running prefix of mixed
                                                      adds down each lane
  =============  ===================================  ========================

All run for G1 (coordinates int64[25, *batch]) and G2 (int64[25, 2,
*batch]); affine infinity flags are a bool batch. Coordinates are < 4p in
and out; affine inputs < 2p. `Curve.scalar_mul` builds its window table
with 14 `cmadd` launches and runs its 64 window steps as `cdbl_n_add` with
n = 4; the Pippenger MSM (:mod:`.msm`) runs one `cmsm_row_scan` over its
sorted point stream, `cadd` for its lane prefix, lookups, bucket
differences and folds, and one `cdbl_n_add` per window.

The kernels' arithmetic is the reference's fused bodies (`_cmadd_body`,
`_cdbl_body`, `_cadd_body`): Montgomery products (for Fq2 the Karatsuba
product post-reduced by R mod p), the b3 products as x12 (after the xi
twist for G2), the reference's k*p offsets. Those limbs are another
redundant form than the unfused law of `ops/proj.py` in the reference
(which multiplies by a Montgomery constant 3b), so results agree with it by
value.

What bounds them on the H100: 11 (G1) or 55 (G2) Montgomery products per
lane for `cmadd` (and per lane and row for `cmsm_row_scan`), 12 or 60 for
`cadd`, 44 or 220 for `cdbl_n_add` at n = 4, against at most 1.8 KB of
int64 limbs moved per add: the multiplier. `cmadd` and `cdbl_n_add` run
over one to a few thousand lanes (14 and 64 launches a `scalar_mul`, one
`cdbl_n_add` a window of each `msm`), where one thread a lane leaves the
card idle and a lane's chain of products sets the time: a group of
threads takes the independent products of each level of the mixed add,
the doubling and the add side by side.

Dispatch rule: a CPU tensor runs the plain PyTorch version; a CUDA tensor
launches the kernel or raises. Each wrapper counts its launches in
``launches``.
"""

from __future__ import annotations

import ctypes

import torch

from .cuda_build import KernelLibrary, check, host_words, lanes, on_cpu, stream
from .cuda_fp import mont_mul_plain
from .cuda_tower import _post_red
from .fp import FQ

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
_U32 = ctypes.c_uint32
LIBRARY = KernelLibrary("gs_curve", "curve_kernels.cu",
                        ["curve_w32.cuh", "curve_group_w32.cuh",
                         "group_w32.cuh", "field_w32.cuh"], {
    "gs_cmadd": [_I, _I] + [_P] * 9 + [_I64, _P, _P, _U32, _P],
    "gs_cdbl_n_add": [_I, _I, _I] + [_P] * 9 + [_I64, _P, _P, _U32, _P],
    "gs_cadd": [_I, _I] + [_P] * 9 + [_I64, _P, _P, _U32, _P],
    "gs_cmsm_row_scan": [_I, _I, _I] + [_P] * 9 + [_I64, _P, _P, _U32, _P],
})


# ---------------------------------------------------------------- plain versions
#
# The kernels' bodies on tensors, step for step: every value is the kernel's
# integer, so the limbs agree. Independent products of a step are stacked
# into one Montgomery product, and the adds, k*p subtractions and small
# multiples of a step are summed as columns and carried together (the same
# integers as the kernel's one-op-at-a-time chain; each subtraction of an
# exact value adds one 2^(16 n) complement, which carries out of the top).
# A value is G1 (25, *S) or G2 (25, 2, *S).

def _exact(*cols):
    """The exact 16-bit limbs of non-negative column tensors of one shape
    (each column < 2^24), in one carry."""
    return FQ._carry(torch.stack(cols, 1), bits=24).unbind(1)


def _kp(k: int, subtrahends: int, like):
    """Columns of k p + s 2^(16 n), s = subtrahends: added to a sum before
    subtracting s exact values, they keep every column non-negative."""
    off = FQ._offset(k * FQ.p, FQ.n, like.ndim, like.device)
    if subtrahends > 1:
        off = off + (subtrahends - 1) * FQ._offset(0, FQ.n, like.ndim,
                                                    like.device)
    return off


class _FqP:
    """Fq adapter (pallas_curve._FqA)."""

    @staticmethod
    def products(lhs, rhs):
        """Montgomery products lhs[i] * rhs[i] (< 2p), one stacked call."""
        return mont_mul_plain(FQ, torch.stack(lhs, 1),
                              torch.stack(rhs, 1)).unbind(1)

    @staticmethod
    def b3(a, k: int):
        """Columns of a * 3b = 12 a (b = 4); a exact, k unused."""
        return 12 * a

    @staticmethod
    def select(mask, a, b):
        return torch.where(mask[None], a, b)


class _Fq2P:
    """Fq2 adapter (pallas_curve._Fq2A): products post-reduced to < 2p."""

    @staticmethod
    def products(lhs, rhs):
        """Fq2 products lhs[i] * rhs[i]: the Karatsuba of _Fq2A.mul
        (t0 - t1 + 2p, t2 - t0 - t1 + 4p), then each component times R mod
        p (< 2p); one stacked Montgomery product for each of the two."""
        a, b = torch.stack(lhs, 2), torch.stack(rhs, 2)    # (25, 2, k, *S)
        sa, sb = _exact(a[:, 0] + a[:, 1], b[:, 0] + b[:, 1])
        t0, t1, t2 = mont_mul_plain(
            FQ, torch.stack([a[:, 0], a[:, 1], sa], 1),
            torch.stack([b[:, 0], b[:, 1], sb], 1)).unbind(1)
        c = torch.stack(_exact(t0 - t1 + _kp(2, 1, t0),
                               t2 - t0 - t1 + _kp(4, 2, t0)), 1)
        return _post_red(c).unbind(2)

    @staticmethod
    def b3(a, k: int):
        """Columns of a * 3b' = 12 (u + 1) a: the xi twist, then x12; a
        exact with bound(a) <= k p."""
        return torch.stack([12 * (a[:, 0] - a[:, 1] + _kp(k, 1, a[:, 0])),
                            12 * (a[:, 0] + a[:, 1])], 1)

    @staticmethod
    def select(mask, a, b):
        return torch.where(mask[None, None], a, b)


def _adapter(curve):
    return _Fq2P if curve.ns == 2 else _FqP


def _finish(F, t0, t1, t3, t4, Y3, Z3):
    """X3 = t3 t1 - t4 Y3, Y3 = t1 Z3 + Y3 t0, Z3 = Z3 t4 + t0 t3 (< 4p)."""
    a, b, c, d, e, g = F.products([t3, t4, t1, Y3, Z3, t0],
                                  [t1, Y3, Z3, t0, t4, t3])
    return _exact(a - b + _kp(2, 1, a), c + d, e + g)


def _cmadd_body(F, X1, Y1, Z1, x2, y2, ainf):
    """Complete mixed add (_cmadd_body); acc < 4p, affine < 2p, out < 4p.

    Bound audit (units of p): t2 < 96, t1/Z3 < 98, Y3' < 144.
    """
    sa, sb = _exact(x2 + y2, X1 + Y1)
    t0, t1, t3, yz, xz = F.products([X1, Y1, sa, y2, x2],
                                    [x2, y2, sb, Z1, Z1])
    t3, t4, Y3, t0, t2 = _exact(
        t3 - t0 - t1 + _kp(4, 2, t3),                 # < 6p
        yz + Y1,                                      # t4 < 6p
        xz + X1,                                      # < 6p
        3 * t0,                                       # < 6p
        F.b3(Z1, 4))                                  # t2 < 96p
    Z3, t1, Y3 = _exact(
        t1 + t2,                                      # < 98p
        t1 - t2 + _kp(96, 1, t1),                     # < 98p
        F.b3(Y3, 8))                                  # < 144p
    X3, Y3, Z3 = _finish(F, t0, t1, t3, t4, Y3, Z3)
    return (F.select(ainf, X1, X3), F.select(ainf, Y1, Y3),
            F.select(ainf, Z1, Z3))


def _cadd_body(F, X1, Y1, Z1, X2, Y2, Z2):
    """Complete projective add (_cadd_body); coords < 4p in and out."""
    s = _exact(X1 + Y1, X2 + Y2, Y1 + Z1, Y2 + Z2, X1 + Z1, X2 + Z2)
    t0, t1, t2, t3, t4, Y3 = F.products([X1, Y1, Z1, s[0], s[2], s[4]],
                                        [X2, Y2, Z2, s[1], s[3], s[5]])
    t3, t4, Y3, t0, t2 = _exact(
        t3 - t0 - t1 + _kp(4, 2, t3),                 # < 6p
        t4 - t1 - t2 + _kp(4, 2, t4),                 # < 6p
        Y3 - t0 - t2 + _kp(4, 2, Y3),                 # < 6p
        3 * t0,                                       # < 6p
        F.b3(t2, 2))                                  # < 48p
    Z3, t1, Y3 = _exact(
        t1 + t2,                                      # < 50p
        t1 - t2 + _kp(48, 1, t1),                     # < 50p
        F.b3(Y3, 8))                                  # < 144p
    return _finish(F, t0, t1, t3, t4, Y3, Z3)


def _cdbl_body(F, X, Y, Z):
    """Complete doubling (_cdbl_body); coords < 4p in, (<4p, <4p, <2p) out."""
    t0, t1, zz, xy = F.products([Y, Y, Z, X], [Y, Z, Z, Y])
    Z3, t2 = _exact(8 * t0, F.b3(zz, 2))              # < 16p, < 48p
    Y3, t0 = _exact(t0 + t2,                          # < 50p
                    t0 - 3 * t2 + _kp(144, 3, t0))    # < 146p
    X3, Z3, u, v = F.products([t2, t1, t0, t0], [Z3, Z3, Y3, xy])
    X3, Y3 = _exact(2 * v, X3 + u)                    # < 4p, < 4p
    return X3, Y3, Z3                                 # Z3 < 2p


# Lanes per step of a plain version: on the CPU a step's tensors stay in
# cache (a G2 add over 16384 lanes runs ~3x faster in steps of 2048), on a
# card a step bounds the memory of the int64 temporaries. The lanes are
# independent, so the steps give the same limbs as one call.
PLAIN_STEP_LANES = {"cpu": 2048, "cuda": 1 << 16}


def _by_lanes(curve, body, coords, flags=()):
    """body(*coords, *flags) over steps of the broadcast batch's lanes;
    returns (X, Y, Z) with the batch's shape."""
    coords, flags, batch = _broadcast(curve, coords, flags)
    lead = coords[0].shape[:curve.ns]
    cs = [c.reshape(lead + (-1,)) for c in coords]
    fs = [f.reshape(-1) for f in flags]
    m = cs[0].shape[-1]
    step = PLAIN_STEP_LANES.get(cs[0].device.type, max(m, 1))
    outs = [body(*(c[..., s:s + step] for c in cs),
                 *(f[s:s + step] for f in fs))
            for s in range(0, max(m, 1), step)]
    return tuple(torch.cat([o[k] for o in outs], -1).reshape(lead + batch)
                 for k in range(3))


def cmadd_plain(p, a, curve):
    F = _adapter(curve)
    return _by_lanes(curve, lambda *v: _cmadd_body(F, *v),
                     [*p, a[0], a[1]], [a[2]])


def cdbl_n_add_plain(p, n_dbl: int, q, curve):
    F = _adapter(curve)

    def body(*c):
        p = c[:3]
        for _ in range(n_dbl):
            p = _cdbl_body(F, *p)
        return _cadd_body(F, *p, *c[3:])

    return _by_lanes(curve, body, [*p, *q])


def cadd_plain(p, q, curve):
    F = _adapter(curve)
    return _by_lanes(curve, lambda *v: _cadd_body(F, *v), [*p, *q])


def _raw_rows(curve, v):
    """A coordinate (25, *B) or (25, 2, *B) as the prefix stream's rows
    (cr, *B): Fq2 as its c0 limb rows, then its c1 rows."""
    if curve.ns == 1:
        return v
    return v.transpose(0, 1).reshape((2 * v.shape[0],) + v.shape[2:])


def cmsm_row_scan_plain(pts_sorted, curve):
    """Row by row (in steps of lanes): the accumulator from (0 : 1 : 0),
    one complete mixed add per row, each row's result written into the raw
    stream."""
    x, y, inf = pts_sorted
    ns, F = curve.ns, _adapter(curve)
    rows, lanes_shape = inf.shape[0], inf.shape[1:]
    lead = x.shape[:ns]
    xs = x.reshape(lead + (rows, -1))
    ys = y.reshape(lead + (rows, -1))
    fs = inf.reshape(rows, -1)
    m = fs.shape[1]
    raw = [torch.empty((rows, FQ.n * ns, m), dtype=torch.int64,
                       device=x.device) for _ in range(3)]
    tot = [torch.empty(lead + (m,), dtype=torch.int64, device=x.device)
           for _ in range(3)]
    step = PLAIN_STEP_LANES.get(x.device.type, max(m, 1))
    for s in range(0, m, step):
        k = min(step, m - s)
        acc = (curve.F.zeros((k,), device=x.device),
               curve.F.one((k,), device=x.device),
               curve.F.zeros((k,), device=x.device))
        for r in range(rows):
            acc = _cmadd_body(F, *acc, xs[..., r, s:s + k],
                              ys[..., r, s:s + k], fs[r, s:s + k])
            for c in range(3):
                raw[c][r, :, s:s + k] = _raw_rows(curve, acc[c])
        for c in range(3):
            tot[c][..., s:s + k] = acc[c]
    return (tuple(t.reshape(lead + lanes_shape) for t in tot),
            tuple(r.reshape((rows, FQ.n * ns) + lanes_shape) for r in raw))


# --------------------------------------------------------------------- wrappers

def _broadcast(curve, coords, flags=()):
    """Expand coordinates and flags to one batch shape."""
    ns = curve.ns
    batch = torch.broadcast_shapes(*(c.shape[ns:] for c in coords),
                                   *(f.shape for f in flags))
    return ([c.expand(c.shape[:ns] + batch) for c in coords],
            [f.expand(batch) for f in flags], batch)


def _launch(wrapper, curve, coords, batch, scalars=(), flags=()):
    """Launch the kernel of `wrapper` over the lanes of `batch` and count
    it; returns (X3, Y3, Z3)."""
    name = wrapper.__name__
    n = FQ.n
    rows = n * curve.ns
    ins = [lanes(c, n, f"{name} {curve.name}").reshape(rows, -1)
           for c in coords]
    m = ins[0].shape[1]
    outs = [torch.empty_like(ins[0]) for _ in range(3)]
    if m:
        fn = getattr(LIBRARY.get(), "gs_" + name)
        check(fn(n, curve.ns, *scalars,
                 *(x.data_ptr() for x in ins + list(flags) + outs), m,
                 host_words(FQ, FQ.p), host_words(FQ, FQ.r_mod_p), FQ.n0,
                 stream(ins[0])), name, n)
        wrapper.launches += 1
    shape = coords[0].shape[:curve.ns] + tuple(batch)
    return tuple(o.reshape(shape) for o in outs)


def cmadd(p, a, curve):
    """Complete projective + affine addition P + A as one launch.

    Replaces pallas_curve.py:cmadd (_cmadd_kernel). p = (X, Y, Z) with
    coordinates < 4p; a = (x, y, inf) affine, x, y < 2p; where inf is set
    the result is P. Batch shapes broadcast; the kernel takes contiguous
    copies. Output coordinates < 4p.
    """
    if on_cpu(*p, *a):
        return cmadd_plain(p, a, curve)
    coords, (ainf,), batch = _broadcast(curve, [*p, a[0], a[1]], [a[2]])
    if ainf.device.type != "cuda" or ainf.dtype != torch.bool:
        raise ValueError(f"cmadd flags: expected a CUDA tensor of bool, got "
                         f"{ainf.dtype} on {ainf.device}")
    return _launch(cmadd, curve, coords, batch,
                   flags=[ainf.contiguous().reshape(-1)])


def cdbl_n_add(p, n_dbl: int, q, curve):
    """n_dbl complete doublings of P, then P + Q, as one launch.

    Replaces pallas_curve.py:cdbl_n_add (_cdbl_n_add_kernel). Projective
    p, q with coordinates < 4p; output < 4p. Batch shapes broadcast.
    """
    assert n_dbl >= 0
    if on_cpu(*p, *q):
        return cdbl_n_add_plain(p, n_dbl, q, curve)
    coords, _, batch = _broadcast(curve, [*p, *q])
    return _launch(cdbl_n_add, curve, coords, batch, scalars=(n_dbl,))


def cadd(p, q, curve):
    """Complete projective addition P + Q as one launch.

    Replaces pallas_curve.py:cadd (_cadd_kernel). Coordinates < 4p in and
    out; batch shapes broadcast.
    """
    if on_cpu(*p, *q):
        return cadd_plain(p, q, curve)
    coords, _, batch = _broadcast(curve, [*p, *q])
    return _launch(cadd, curve, coords, batch)


def cmsm_row_scan(pts_sorted, curve):
    """The per-lane running prefix of complete mixed adds, as one launch.

    Replaces pallas_curve.py:cmsm_row_scan (_cmsm_scan_kernel).
    pts_sorted = (x, y, inf): affine coordinates < 2p laid out (25, rows,
    *lanes) for G1 or (25, 2, rows, *lanes) for G2, flags (rows, *lanes);
    *lanes may hold a batch of independent scans. Row r of a lane adds the
    lane's point in row r to the sum of its rows before it, from
    (0 : 1 : 0); a flagged point adds nothing. Returns (lane totals, the
    raw prefix stream): the totals projective (25[, 2], *lanes), the stream
    three tensors (rows, cr, *lanes), cr = 25 ns, an Fq2 coordinate as its
    c0 rows then its c1 rows (the reference's layout). Any lane count: the
    kernel needs no padding.
    """
    x, y, inf = pts_sorted
    if on_cpu(x, y, inf):
        return cmsm_row_scan_plain(pts_sorted, curve)
    if inf.device.type != "cuda" or inf.dtype != torch.bool:
        raise ValueError(f"cmsm_row_scan flags: expected a CUDA tensor of "
                         f"bool, got {inf.dtype} on {inf.device}")
    n, ns = FQ.n, curve.ns
    rows, lanes_shape = inf.shape[0], inf.shape[1:]
    cr = n * ns
    ins = [lanes(c, n, f"cmsm_row_scan {curve.name}").reshape(cr, rows, -1)
           for c in (x, y)]
    m = ins[0].shape[2]
    if not rows or tuple(ins[1].shape) != (cr, rows, m) or \
            inf.numel() != rows * m:
        raise ValueError("cmsm_row_scan: x, y and inf disagree in shape, "
                         "or there is no row")
    flags = inf.contiguous()
    raw = [torch.empty((rows, cr, m), dtype=torch.int64, device=x.device)
           for _ in range(3)]
    tot = [torch.empty((cr, m), dtype=torch.int64, device=x.device)
           for _ in range(3)]
    if m:
        check(LIBRARY.get().gs_cmsm_row_scan(
            n, ns, rows, *(t.data_ptr() for t in ins + [flags] + raw + tot),
            m, host_words(FQ, FQ.p), host_words(FQ, FQ.r_mod_p), FQ.n0,
            stream(x)), "cmsm_row_scan", n)
        cmsm_row_scan.launches += 1
    shape = x.shape[:ns] + tuple(lanes_shape)
    return (tuple(t.reshape(shape) for t in tot),
            tuple(r.reshape((rows, cr) + tuple(lanes_shape)) for r in raw))


KERNELS = (cmadd, cdbl_n_add, cadd, cmsm_row_scan)
PLAIN = {cmadd: cmadd_plain, cdbl_n_add: cdbl_n_add_plain, cadd: cadd_plain,
         cmsm_row_scan: cmsm_row_scan_plain}
for _k in KERNELS:
    _k.launches = 0


def reset_counts():
    for k in KERNELS:
        k.launches = 0
