"""Batched, branchless G1 / G2 arithmetic, generic over the field.

The port of ``groth_sahai_tpu/ops/curve.py``.

Representation (the reference's)
--------------------------------
* Jacobian point: tuple (X, Y, Z) of field elements; Z == 0 <=> infinity.
* Affine point: tuple (x, y, inf) with `inf: bool[*batch]`; the coordinates
  of the point at infinity are (0, 0) by convention (arkworks'
  `G1Affine::zero()`).

G1 is over Fq (coordinates (nl, *batch)); G2 over Fq2 (coordinates
(nl, 2, *batch)). All exceptional cases (doubling, inverses, infinity) are
`torch.where` selects, so every lane runs the same operations.

`scalar_mul` runs on the complete projective law of :mod:`.proj` through
the fused kernels of :mod:`.cuda_curve` (`cmadd` builds the window table,
`cdbl_n_add` takes each window step); the Jacobian `double`, `add` and
`add_mixed` are PyTorch glue over the field core.
"""

from __future__ import annotations

import numpy as np
import torch

from .fp import FQ, resolve_device
from .tower import FQ2
from . import bls12_381 as C
from . import cuda_curve as CC
from . import proj as PJ

# The reference's default scalar window (GsConfig.scalar_window), a
# constant here: scalar_mul builds a 2^4-entry table and runs 64 windows.
SCALAR_WINDOW = 4


class Curve:
    """y^2 = x^3 + b over `field` (a = 0, as for BLS12-381 G1/G2)."""

    def __init__(self, field, b_ints, name="", ns=1):
        self.F = field
        self.b_ints = b_ints      # b as an int (G1) or an int pair (G2)
        self.name = name
        self.ns = ns              # field structure axes on coordinate arrays

    def b(self, device):
        """The curve constant b, unbatched, on `device`."""
        if self.ns == 1:
            return self.F.from_int(self.b_ints, device=device)
        return self.F.from_int_pair(*self.b_ints, device=device)

    # ------------------------------------------------------------ structure

    def inf_jac(self, batch_shape=(), device="cuda"):
        F = self.F
        return (F.one(batch_shape, device=device),
                F.one(batch_shape, device=device),
                F.zeros(batch_shape, device=device))

    def inf_affine(self, batch_shape=(), device="cuda"):
        F = self.F
        dev = resolve_device(device)
        return (F.zeros(batch_shape, device=dev),
                F.zeros(batch_shape, device=dev),
                torch.ones(batch_shape, dtype=torch.bool, device=dev))

    def from_affine(self, a):
        """(x, y, inf) -> Jacobian; infinity maps to Z = 0."""
        x, y, inf = a
        F = self.F
        one = F.one(inf.shape, device=inf.device)
        z = F.select(~inf, one, F.zeros(inf.shape, device=inf.device))
        return (x, y, z)

    def is_inf(self, p):
        # Z bounds: add < 6p, double < 4p, from_affine < p -> k=8 covers all.
        return self.F.is_zero(p[2], k=8)

    @staticmethod
    def select(mask, p, q):
        """mask ? p : q over whole points (mask: bool[*batch])."""
        if torch.is_tensor(p):
            return torch.where(mask[None], p, q)
        return tuple(torch.where(mask[None], x, y) for x, y in zip(p, q))

    # ------------------------------------------------------------ group law

    def double(self, p):
        """dbl-2009-l (a=0). Correctly sends Z=0 and Y=0 to infinity.

        Value bounds (in units of p): mul/sqr outputs < 2p; X3 < 34p,
        Y3 < 18p, Z3 < 4p -- all mul-safe; the static sub offsets k cover
        each subtrahend's bound.
        """
        F = self.F
        X1, Y1, Z1 = p
        t = F.mul(F.stack([X1, Y1, Y1]), F.stack([X1, Y1, Z1]))
        A, B, YZ = F.unstack(t, 3)                      # X1^2, Y1^2, Y1 Z1 < 2p
        t = F.sqr(F.stack([B, F.add(X1, B)]))
        Cc, S = F.unstack(t, 2)                         # B^2, (X1+B)^2 < 2p
        D = F.double(F.sub(F.sub(S, A, k=2), Cc, k=2))  # < 12p
        E = F.add(F.double(A), A)                       # < 6p
        Ff = F.sqr(E)                                   # < 2p
        X3 = F.sub(Ff, F.double(D), k=32)               # < 34p
        Y3 = F.sub(F.mul(E, F.sub(D, X3, k=64)),
                   F.double(F.double(F.double(Cc))), k=16)   # < 18p
        Z3 = F.double(YZ)                               # < 4p
        return (X3, Y3, Z3)

    def add(self, p, q):
        """Complete select-based addition (add-2007-bl + exceptional cases)."""
        F = self.F
        X1, Y1, Z1 = p
        X2, Y2, Z2 = q
        t = F.sqr(F.stack([Z1, Z2]))
        Z1Z1, Z2Z2 = F.unstack(t, 2)
        t = F.mul(F.stack([X1, X2, Y1, Y2]), F.stack([Z2Z2, Z1Z1, Z2, Z1]))
        U1, U2, Y1Z2, Y2Z1 = F.unstack(t, 4)            # < 2p
        t = F.mul(F.stack([Y1Z2, Y2Z1]), F.stack([Z2Z2, Z1Z1]))
        S1, S2 = F.unstack(t, 2)                        # < 2p
        H = F.sub(U2, U1, k=2)                          # < 4p
        r = F.double(F.sub(S2, S1, k=2))                # < 8p
        t = F.sqr(F.stack([F.double(H), r, F.add(Z1, Z2)]))
        I, r2, ZZ = F.unstack(t, 3)                     # < 2p
        t = F.mul(F.stack([H, U1]), F.stack([I, I]))
        J, V = F.unstack(t, 2)                          # < 2p
        X3 = F.sub(F.sub(r2, J, k=2), F.double(V), k=4)             # < 10p
        t = F.mul(F.stack([r, S1]), F.stack([F.sub(V, X3, k=16), J]))
        rVX, S1J = F.unstack(t, 2)
        Y3 = F.sub(rVX, F.double(S1J), k=4)             # < 6p
        Z3 = F.mul(F.sub(F.sub(ZZ, Z1Z1, k=2), Z2Z2, k=2), H)
        res = (X3, Y3, Z3)

        # Exceptional cases.
        p_inf = self.is_inf(p)
        q_inf = self.is_inf(q)
        same_x = F.eq(U1, U2, k=2) & ~p_inf & ~q_inf
        same_y = F.eq(S1, S2, k=2)
        is_dbl = same_x & same_y
        # same_x & ~same_y -> P + (-P): the formula already yields Z3 = 0.
        res = self.select(is_dbl, self.double(p), res)
        res = self.select(q_inf, p, res)
        res = self.select(p_inf, q, res)
        return res

    def add_mixed(self, p, a):
        """Jacobian + affine (madd-2007-bl), exceptional cases via select."""
        F = self.F
        X1, Y1, Z1 = p
        x2, y2, a_inf = a
        # Input coordinate bounds: X1 < 34p, Y1 < 18p, Z1 < 4p (double()
        # outputs), affine x2, y2 < 2p. All products stay < 2^16 p^2.
        Z1Z1 = F.sqr(Z1)
        t = F.mul(F.stack([x2, y2]), F.stack([Z1Z1, F.mul(Z1, Z1Z1)]))
        U2, S2 = F.unstack(t, 2)                        # < 2p
        H = F.sub(U2, X1, k=64)                         # < 66p
        r = F.double(F.sub(S2, Y1, k=32))               # < 68p
        t = F.sqr(F.stack([H, r, F.add(Z1, H)]))
        HH, r2, ZH = F.unstack(t, 3)                    # < 2p
        I = F.double(F.double(HH))                      # < 8p
        t = F.mul(F.stack([H, X1]), F.stack([I, I]))
        J, V = F.unstack(t, 2)                          # < 2p
        X3 = F.sub(F.sub(r2, J, k=2), F.double(V), k=4)            # < 10p
        t = F.mul(F.stack([r, Y1]), F.stack([F.sub(V, X3, k=16), J]))
        rVX, YJ = F.unstack(t, 2)
        Y3 = F.sub(rVX, F.double(YJ), k=4)              # < 6p
        Z3 = F.sub(F.sub(ZH, Z1Z1, k=2), HH, k=2)       # < 6p
        res = (X3, Y3, Z3)

        p_inf = self.is_inf(p)
        same_x = F.eq(U2, X1, k=64) & ~p_inf & ~a_inf
        same_y = F.eq(S2, Y1, k=32)
        is_dbl = same_x & same_y
        res = self.select(is_dbl, self.double(p), res)
        res = self.select(a_inf, p, res)
        res = self.select(p_inf, self.from_affine(a), res)
        return res

    def neg(self, p, k: int = 2):
        """-P; k must cover bound(Y) (add outputs have Y < 6p -> k=8)."""
        return (p[0], self.F.neg(p[1], k=k), p[2])

    def neg_affine(self, a):
        return (a[0], self.F.neg(a[1]), a[2])

    # ------------------------------------------------------------ conversions

    def to_affine(self, p):
        """Jacobian -> (x, y, inf). Montgomery batch inversion (one Fermat
        per 32 elements, `inv_batch`) instead of one per element."""
        F = self.F
        X, Y, Z = p
        inf = F.is_zero(Z, k=8)          # Z bounds: see is_inf
        zi = F.inv_batch(Z)
        zi2 = F.sqr(zi)
        x = F.mul(X, zi2)
        y = F.mul(Y, F.mul(zi, zi2))
        zero = F.zeros(inf.shape, device=inf.device)
        return (F.select(inf, zero, x), F.select(inf, zero, y), inf)

    # ------------------------------------------------------------ predicates

    def eq_jac(self, p, q):
        """Projective equality: X1 Z2^2 == X2 Z1^2 and Y1 Z2^3 == Y2 Z1^3."""
        F = self.F
        X1, Y1, Z1 = p
        X2, Y2, Z2 = q
        Z1Z1, Z2Z2 = F.sqr(Z1), F.sqr(Z2)
        ex = F.eq(F.mul(X1, Z2Z2), F.mul(X2, Z1Z1))
        ey = F.eq(F.mul(Y1, F.mul(Z2, Z2Z2)), F.mul(Y2, F.mul(Z1, Z1Z1)))
        both_inf = self.is_inf(p) & self.is_inf(q)
        one_inf = self.is_inf(p) ^ self.is_inf(q)
        return both_inf | (~one_inf & ex & ey)

    def eq_affine(self, a, b):
        F = self.F
        both_inf = a[2] & b[2]
        one_inf = a[2] ^ b[2]
        return both_inf | (~one_inf & F.eq(a[0], b[0]) & F.eq(a[1], b[1]))

    def on_curve_affine(self, a):
        F = self.F
        x, y, inf = a
        bb = self.b(x.device)
        bb = bb.reshape(bb.shape + (1,) * inf.ndim)
        rhs = F.add(F.mul(F.sqr(x), x), bb)
        return inf | F.eq(F.sqr(y), rhs, k=4)

    # ------------------------------------------------------------ scalar mul

    def scalar_mul(self, p_affine, scalar_limbs):
        """[k]P for batched affine points and batched Fr scalars (Jacobian).

        Fixed window of SCALAR_WINDOW = 4 bits over the 256-bit scalar
        width: a 16-entry projective table per point (P, then 14 `cmadd`
        launches), then 64 windows MSB-first, each ONE `cdbl_n_add` launch
        (4 doublings, then the add of the table entry the window's digit
        selects). The select is a one-hot masked sum over the table axis.
        All on the complete law: no exceptional lanes.

        Scalars are standard-form Fr limbs (int64[17, *batch], canonical,
        NOT Montgomery); their batch broadcasts against the points'.
        """
        window = SCALAR_WINDOW
        nwin = 256 // window
        ntab = 1 << window
        ns = self.ns
        batch = p_affine[2].shape
        dev = p_affine[2].device

        # table[j] = j * P: inf, P, then 14 complete mixed adds of P
        p1 = PJ.from_affine(self, p_affine)
        entries = [PJ.inf(self, batch, device=dev), p1]
        for _ in range(ntab - 2):
            entries.append(CC.cmadd(entries[-1], p_affine, self))
        table = tuple(torch.stack([e[c] for e in entries], ns)
                      for c in range(3))

        def digit_at(k):                       # window k, LSB-first
            lo = k * window
            return (scalar_limbs[lo // 16] >> (lo % 16)) & (ntab - 1)

        sbatch = scalar_limbs.shape[1:]
        iota = torch.arange(ntab, device=dev).reshape(
            (ntab,) + (1,) * len(sbatch))
        acc = PJ.inf(self, batch, device=dev)
        for k in range(nwin - 1, -1, -1):
            onehot = (iota == digit_at(k)[None]).to(torch.int64)
            onehot = onehot.reshape((1,) * ns + onehot.shape)
            sel = tuple((t * onehot).sum(ns) for t in table)
            acc = CC.cdbl_n_add(acc, window, sel, self)
        return PJ.to_jacobian(self, acc)

    def msm_naive(self, points_affine, scalars):
        """sum_k [s_k] P_k over the first batch axis: per-point scalar-mul
        then tree add-reduction."""
        prods = self.scalar_mul(points_affine, scalars)
        return self.sum_reduce(prods, axis=0)

    def sum_reduce(self, p_jac, axis: int = 0):
        """Tree-reduce a batch axis of Jacobian points with the group law.

        `axis` counts batch dims (coordinates carry self.ns structure axes
        in front).
        """
        ax = self.ns + axis
        pts = p_jac
        size = pts[0].shape[ax]
        while size > 1:
            half = size // 2
            even = tuple(l.narrow(ax, 0, half) for l in pts)
            odd = tuple(l.narrow(ax, half, half) for l in pts)
            summed = self.add(even, odd)
            if size % 2:
                summed = tuple(torch.cat([a, l.narrow(ax, 2 * half, 1)], ax)
                               for a, l in zip(summed, pts))
                size = half + 1
            else:
                size = half
            pts = summed
        return tuple(l.select(ax, 0) for l in pts)


G1 = Curve(FQ, C.B_G1, "G1", ns=1)
G2 = Curve(FQ2, C.B_G2, "G2", ns=2)


def _infs(coords, device):
    return torch.as_tensor(np.array([c is None for c in coords], dtype=bool),
                           device=resolve_device(device))


def g1_affine_from_ints(coords, device="cuda"):
    """[(x, y) or None, ...] -> batched affine G1 on `device`."""
    xs = [0 if c is None else c[0] for c in coords]
    ys = [0 if c is None else c[1] for c in coords]
    return (FQ.from_ints(xs, device=device), FQ.from_ints(ys, device=device),
            _infs(coords, device))


def g2_affine_from_ints(coords, device="cuda"):
    """[((x0,x1),(y0,y1)) or None, ...] -> batched affine G2 on `device`."""
    xs = [(0, 0) if c is None else c[0] for c in coords]
    ys = [(0, 0) if c is None else c[1] for c in coords]
    return (FQ2.from_ints(xs, device=device), FQ2.from_ints(ys, device=device),
            _infs(coords, device))


def g1_affine_to_ints(a):
    """Batched affine G1 -> [(x, y) or None, ...]."""
    xs = G1.F.to_ints(a[0])
    ys = G1.F.to_ints(a[1])
    infs = a[2].cpu().numpy().reshape(-1)
    return [None if i else (x, y) for x, y, i in zip(xs, ys, infs)]


def g2_affine_to_ints(a):
    xs = FQ2.to_ints(a[0])
    ys = FQ2.to_ints(a[1])
    infs = a[2].cpu().numpy().reshape(-1)
    return [None if i else (x, y) for x, y, i in zip(xs, ys, infs)]
