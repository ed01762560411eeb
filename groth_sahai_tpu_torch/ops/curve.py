"""G1 / G2 data for the pairing path: affine batches, infinity, on-curve.

The part of ``groth_sahai_tpu/ops/curve.py`` that the pairing needs. The
group law (Jacobian double/add, scalar multiplication, MSM) waits for the
commit/prove slice of the port.

Representation (the reference's): an affine point batch is a tuple
(x, y, inf) with `inf: bool[*batch]`; the coordinates of the point at
infinity are (0, 0) by convention (arkworks' `G1Affine::zero()`). G1 is
over Fq (coordinates (nl, *batch)); G2 over Fq2 (coordinates
(nl, 2, *batch)).
"""

from __future__ import annotations

import numpy as np
import torch

from .fp import FQ, resolve_device
from .tower import FQ2
from . import bls12_381 as C


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

    def inf_affine(self, batch_shape=(), device="cuda"):
        F = self.F
        dev = resolve_device(device)
        return (F.zeros(batch_shape, device=dev),
                F.zeros(batch_shape, device=dev),
                torch.ones(batch_shape, dtype=torch.bool, device=dev))

    def on_curve_affine(self, a):
        F = self.F
        x, y, inf = a
        bb = self.b(x.device)
        bb = bb.reshape(bb.shape + (1,) * inf.ndim)
        rhs = F.add(F.mul(F.sqr(x), x), bb)
        return inf | F.eq(F.sqr(y), rhs, k=4)


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
