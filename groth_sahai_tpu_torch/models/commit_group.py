"""The GS commitment-group algebra: affine batch helpers (first part).

The part of ``groth_sahai_tpu/models/commit_group.py`` that the verifier's
signed Miller product and the verifier's last comparison need. Shape
conventions (the reference's): an affine point batch is (x, y, inf); `inf`
carries the pure batch shape; coordinate tensors prepend the field
structure axes ((nl,) for G1, (nl, 2) for G2), and `curve.ns` counts them
so helpers stay generic over G1/G2. A Com1 vector of length k is a G1
affine batch with batch shape (2, k); a Com2 vector likewise over G2. A
ComT is a (2, 2) matrix of GT elements, (nl, 12, 2, 2). The rest of the
module (iota maps, com_matvec) waits for the commit/prove slice.
"""

from __future__ import annotations

import torch

from ..ops import pairing as pr
from ..ops.curve import G1, G2
from ..ops.tower import FQ12


def aff_map(curve, a, coord_fn, inf_fn):
    x, y, inf = a
    return (coord_fn(x), coord_fn(y), inf_fn(inf))


def aff_expand(curve, a, axis, size):
    """Insert and broadcast a new batch axis at batch position `axis`."""
    ns = curve.ns

    def cf(l):
        ax = ns + axis
        l2 = l.unsqueeze(ax)
        return l2.expand(l2.shape[:ax] + (size,) + l2.shape[ax + 1:])

    def inf_f(i):
        i2 = i.unsqueeze(axis)
        return i2.expand(i2.shape[:axis] + (size,) + i2.shape[axis + 1:])

    return aff_map(curve, a, cf, inf_f)


# ---------------------------------------------------------------------------
# ComT: 2x2 GT matrices
# ---------------------------------------------------------------------------

def comt_pairing_sum_miller(com1, com2):
    """Miller part of ComT::pairing_sum.

    com1: Com1 vector (2, k); com2: Com2 vector (2, k). Returns the
    unexponentiated Fq12 with batch (2, 2): entry [i, j] = prod_k
    miller(com1[i, k], com2[j, k]). Callers multiply several of these
    together and run one final exponentiation.
    """
    P = aff_expand(G1, com1, 1, 2)     # (2, 2, k): [i, j, k] P = com1[i, k]
    Q = aff_expand(G2, com2, 0, 2)     # (2, 2, k): Q = com2[j, k]
    f = pr.miller_loop(P, Q)           # (nl, 12, 2, 2, k)
    return pr._product_reduce(f, axis=2)


def comt_pairing_miller(com1_elem, com2_elem):
    """Single-pair ComT::pairing Miller part: (2,) x (2,) -> (2, 2)."""
    P = aff_expand(G1, com1_elem, 1, 2)   # (2, 2)
    Q = aff_expand(G2, com2_elem, 0, 2)
    return pr.miller_loop(P, Q)


def comt_eq(a, b):
    """ComT equality = 4 GT equalities, reduced over the (2, 2) axes."""
    return torch.all(torch.all(FQ12.eq(a, b), 0), 0)


def comt_mul(a, b):
    """BT 'addition' (the reference's +) = entry-wise GT multiplication."""
    return FQ12.mul(a, b)


def comt_one(batch_shape=(), device="cuda"):
    return FQ12.one((2, 2) + tuple(batch_shape), device=device)
