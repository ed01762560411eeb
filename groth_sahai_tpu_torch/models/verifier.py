"""The unified GS verifier.

The port of ``groth_sahai_tpu/models/verifier.py``. All four equation
types share the 5-term check

  iota*(A) . d  +  c . iota*(B)  +  c . (Gamma d)
      ==  iota_T(t)  +  u[:wx] . pi  +  theta . v[:wy]

(". " = ComT::pairing_sum; "+" = entry-wise GT multiplication). The Miller
loops of all five pairing_sum terms (both sides) run as ONE signed Miller
product -- rhs terms join with a conjugation mask (final_exp(conj(f)) ==
final_exp(f)^-1) -- then ONE final exponentiation. Non-PPE targets join the
same Miller batch as pairing pairs:

  MSMEG1: iota_T(t) = e-pair(iota1(t), v_base)
  MSMEG2: iota_T(t) = e-pair(u_base, iota2(t))
  Quad:   iota_T(t) = e-pair(u_base, t * v_base)
  PPE:    iota_T(t) = (1, 1, 1, t), compared after the final exp.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.curve import G1, G2
from ..ops.tower import FQ12
from . import commit_group as cg
from . import kernels as K
from .crs import CRS
from .statement import EquType
from .prover import CProof, _iota_side, check_dims, vec_len


def _comt_ppe_target(t_gt):
    """iota_T(t) for a PPE: entries (1, 1, 1, t) as (nl, 12, *L, 2, 2).

    t_gt: GT elements (nl, 12, *L) (*L = () for one equation), on the
    device the result takes.
    """
    one = FQ12.one(tuple(t_gt.shape[2:]), device=t_gt.device)
    row0 = torch.stack([one, one], -1)             # (nl, 12, *L, 2)
    row1 = torch.stack([one, t_gt], -1)
    return torch.stack([row0, row1], -2)           # (nl, 12, *L, 2, 2)


def _as_vec1(curve, elem):
    """Com element (2,) -> Com vector (2, 1)."""
    return cg.aff_map(curve, elem, lambda l: l[..., None],
                      lambda i: i[..., None])


def _target_pair(equ, crs: CRS):
    """Express iota_T(target) as a single (Com1, Com2) pairing pair: Com
    elements (2, *L) for targets with leading batch axes *L (the batch
    verifier's equations; *L = () for one equation)."""
    ty = equ.equ_type
    if ty == EquType.MultiScalarG1:
        c1 = cg.iota(G1, _as_vec1(G1, equ.target))          # (2, *L, 1)
        lead = tuple(equ.target[2].shape)
        return (cg.aff_index(G1, c1, len(lead) + 1, 0),
                cg.aff_bcast(G2, crs.v_base, lead))
    if ty == EquType.MultiScalarG2:
        c2 = cg.iota(G2, _as_vec1(G2, equ.target))
        lead = tuple(equ.target[2].shape)
        return (cg.aff_bcast(G1, crs.u_base, lead),
                cg.aff_index(G2, c2, len(lead) + 1, 0))
    if ty == EquType.Quadratic:
        lead = tuple(equ.target.shape[1:])
        t = equ.target.reshape(equ.target.shape[0], -1)      # (17, prod L)
        vb = K.to_affine(
            G2, K.scalar_mul_vec(G2, cg.aff_bcast(G2, crs.v_base,
                                                  (t.shape[1],)), t))
        vb = cg.aff_map(G2, vb, lambda l: l.reshape(l.shape[:3] + lead),
                        lambda i: i.reshape(i.shape[:1] + lead))
        return (cg.aff_bcast(G1, crs.u_base, lead), vb)
    raise ValueError(ty)


def verify(equ, com_proof: CProof, crs: CRS) -> bool:
    """Verifiable::verify for any equation type; one `.item()` at the end.

    The statement must fit the commitments: A has as many entries as d, B
    as c (the original's dimension asserts), and Gamma is m x n.
    """
    P, Q, mask = _pairs(equ, com_proof, crs)
    f = K.miller_product_signed(P, Q, mask)
    res = K.final_exp(f)

    dev = res.device
    expected = (_comt_ppe_target(equ.target)
                if equ.equ_type == EquType.PairingProduct
                else cg.comt_one(device=dev))
    return bool(cg.comt_eq(res, expected).item())


def _pairs(equ, com_proof: CProof, crs: CRS):
    """The signed Miller product's pairs of one equation: Com1 and Com2
    vectors (2, K) and the rhs conjugation mask, numpy bool (K,)."""
    if len(com_proof.equ_proofs) != 1:
        raise ValueError("verify takes a proof of exactly one equation")
    proof = com_proof.equ_proofs[0]
    if proof.equ_type != equ.equ_type:
        raise ValueError(f"a {proof.equ_type.name} proof for a "
                         f"{equ.equ_type.name} statement")
    c_coms = com_proof.xcoms.coms
    d_coms = com_proof.ycoms.coms
    check_dims(equ, vec_len(c_coms), vec_len(d_coms))
    is_ppe = equ.equ_type == EquType.PairingProduct
    pi, theta = proof.pi, proof.theta
    wx = pi[2].shape[-1]
    wy = theta[2].shape[-1]

    # ---- assemble all pairing pairs + the rhs conjugation mask -------------
    iota_a = _iota_side(G1, equ.x_is_scalar, equ.a_consts, crs.u_base)
    iota_b = _iota_side(G2, equ.y_is_scalar, equ.b_consts, crs.v_base)
    gd = K.to_affine(G2, K.com_matvec(G2, equ.gamma, d_coms))
    u_used = cg.aff_slice0(G1, crs.u, 1, wx)
    v_used = cg.aff_slice0(G2, crs.v, 1, wy)

    lhs1 = [iota_a, c_coms, c_coms]
    lhs2 = [d_coms, iota_b, gd]
    rhs1 = [u_used, theta]
    rhs2 = [pi, v_used]
    if not is_ppe:
        tp1, tp2 = _target_pair(equ, crs)
        rhs1.append(_as_vec1(G1, tp1))
        rhs2.append(_as_vec1(G2, tp2))

    P = cg.aff_concat(G1, lhs1 + rhs1, axis=1)
    Q = cg.aff_concat(G2, lhs2 + rhs2, axis=1)
    k_l = sum(int(v[2].shape[-1]) for v in lhs1)
    k_r = sum(int(v[2].shape[-1]) for v in rhs1)
    return P, Q, np.array([False] * k_l + [True] * k_r)
