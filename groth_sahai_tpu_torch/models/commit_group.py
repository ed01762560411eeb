"""The GS commitment-group algebra: affine batch helpers (first part).

The part of ``groth_sahai_tpu/models/commit_group.py`` that the verifier's
signed Miller product needs. Shape conventions (the reference's): an affine
point batch is (x, y, inf); `inf` carries the pure batch shape; coordinate
tensors prepend the field structure axes ((nl,) for G1, (nl, 2) for G2),
and `curve.ns` counts them so helpers stay generic over G1/G2. A Com1
vector of length k is a G1 affine batch with batch shape (2, k); a Com2
vector likewise over G2. The rest of the module (iota maps, com_matvec,
ComT pairing sums) waits for the commit/prove slice.
"""

from __future__ import annotations


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
