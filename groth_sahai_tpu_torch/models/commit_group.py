"""The GS commitment-group algebra: B1 (= G1^2), B2 (= G2^2), BT (= GT^4).

The port of ``groth_sahai_tpu/models/commit_group.py``. Structure of
arrays everywhere (the reference's shapes):

  * a Com1 vector of length k = G1 affine batch with batch shape (2, k)
    (axis 0 = the B1 pair component, axis 1 = the vector index);
  * a Com2 vector likewise over G2;
  * a ComT batch = Fq12 coefficient tensor with batch shape (2, 2).

An affine point batch is (x, y, inf); `inf` carries the pure batch shape;
coordinate tensors prepend the field structure axes ((nl,) for G1, (nl, 2)
for G2), and `curve.ns` counts them so helpers stay generic over G1/G2.

Linear maps: iota(x) = (O, x); iota'(x) = x (u2 + (O, g)); the ComT
pairings are 2x2 (multi-)pairings.
"""

from __future__ import annotations

import torch

from ..ops import msm as msm_mod
from ..ops import pairing as pr
from ..ops.curve import G1, G2
from ..ops.tower import FQ12


def aff_map(curve, a, coord_fn, inf_fn):
    x, y, inf = a
    return (coord_fn(x), coord_fn(y), inf_fn(inf))


def aff_bcast(curve, a, batch_shape):
    """Broadcast an affine point (batch ()) over `batch_shape`."""
    nb = len(batch_shape)
    bs = tuple(batch_shape)
    return aff_map(
        curve, a,
        lambda l: l.reshape(l.shape + (1,) * nb).expand(l.shape + bs),
        lambda i: i.reshape(i.shape + (1,) * nb).expand(i.shape + bs))


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


def aff_index(curve, a, axis, i):
    """Index batch axis `axis` at position i."""
    ns = curve.ns
    return aff_map(curve, a, lambda l: l.select(ns + axis, i),
                   lambda f: f.select(axis, i))


def aff_slice0(curve, a, axis, stop):
    """Slice batch axis `axis` to [0, stop)."""
    ns = curve.ns
    return aff_map(curve, a, lambda l: l.narrow(ns + axis, 0, stop),
                   lambda f: f.narrow(axis, 0, stop))


def aff_stack(curve, elems, axis=0):
    """Stack affine batches along a new batch axis."""
    ns = curve.ns
    return (torch.stack([e[0] for e in elems], ns + axis),
            torch.stack([e[1] for e in elems], ns + axis),
            torch.stack([e[2] for e in elems], axis))


def aff_concat(curve, elems, axis=0):
    """Concatenate affine batches along existing batch axis `axis`."""
    ns = curve.ns
    return (torch.cat([e[0] for e in elems], ns + axis),
            torch.cat([e[1] for e in elems], ns + axis),
            torch.cat([e[2] for e in elems], axis))


# ---------------------------------------------------------------------------
# iota linear maps
# ---------------------------------------------------------------------------

def iota(curve, pts):
    """iota(x) = (O, x): affine batch (*b,) -> Com batch (2, *b)."""
    x, y, inf = pts
    ns = curve.ns
    cx = torch.stack([torch.zeros_like(x), x], ns)
    cy = torch.stack([torch.zeros_like(y), y], ns)
    cinf = torch.stack([torch.ones_like(inf), inf], 0)
    return (cx, cy, cinf)


def iota_prime_base(curve, key_vec, gen):
    """u2 + (O, g): the fixed Com element scaling scalar commitments.

    key_vec: CRS u (or v) as a Com vector (2, 2); gen: group generator ().
    Returns a Com element, batch (2,).
    """
    u2 = aff_index(curve, key_vec, 1, 1)         # Com element (2,)
    og = iota(curve, aff_bcast(curve, gen, ()))  # (2,)
    j = curve.add(curve.from_affine(u2), curve.from_affine(og))
    return curve.to_affine(j)


def iota_prime(curve, base_elem, scalars_std):
    """iota'(x) = x * (u2 + (O, g)): scalars (17, *L, m) -> Com batch
    (2, *L, m) (*L: leading batch axes, e.g. the batch verifier's
    equations)."""
    b = aff_bcast(curve, base_elem, tuple(scalars_std.shape[1:]))  # (2, *L, m)
    return curve.scalar_mul(b, scalars_std[:, None])   # Jacobian (2, *L, m)


# ---------------------------------------------------------------------------
# Com arithmetic (the reference's Mat<Com> ops)
# ---------------------------------------------------------------------------

def com_matvec(curve, scal_std, com_vec):
    """(I, K) Fr matrix x Com vector (2, K) -> Com vector (2, I), Jacobian.

    scal_std: int64[17, *L, I, K] standard-form scalars, com_vec (2, *L, K):
    *L are leading batch axes (the batch verifier's equations), one
    product each. For K < 16 (the reference's small-K branch): one batched
    windowed scalar-mul over (2, *L, I, K) plus a tree reduction over K.
    For K >= 16 (the verifier's Gamma d at m = n = 334 is 2 x 334 MSMs of
    512 padded points): one Pippenger MSM call over the (2, *L, I) batch of
    MSMs of K points (the reference maps `msm` over it with vmap), window
    4 below K = 512, else 8.
    """
    I, K = scal_std.shape[-2], scal_std.shape[-1]
    lead = scal_std.ndim - 3
    pts = aff_expand(curve, com_vec, 1 + lead, I)    # (2, *L, I, K)
    if K >= 16:
        return msm_mod.msm(curve, pts, scal_std,
                           window=4 if K < 512 else 8)           # (2, *L, I)
    prods = curve.scalar_mul(pts, scal_std[:, None])   # Jacobian
    return curve.sum_reduce(prods, axis=2 + lead)    # Jacobian (2, *L, I)


def com_collapse(curve, scal_std, com_vec):
    """sum_k s_k * C_k: scalars (17, K) x Com (2, K) -> Com element (2,)."""
    prods = curve.scalar_mul(com_vec, scal_std[:, None, :])
    return curve.sum_reduce(prods, axis=1)


def com_add_aff(curve, a, b):
    return curve.to_affine(curve.add(curve.from_affine(a),
                                     curve.from_affine(b)))


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
