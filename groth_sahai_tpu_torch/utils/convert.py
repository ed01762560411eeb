"""Carry state across from the JAX package: numpy limbs <-> port tensors.

The JAX package's arrays reach the port as numpy arrays (`uint32` limbs,
bool infinity masks; `np.asarray` of a JAX array). The port stores limbs
as `int64` tensors with the same layout, so a conversion is a dtype change
and a copy to the device. The converters of whole objects (CRS, statement,
commitments, proof) read the JAX package's objects by their attributes and
turn every array leaf into a tensor; they let one CRS, statement and
randomness feed both packages. Nothing here imports the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.fp import resolve_device


def limbs_from_numpy(arr, device="cuda") -> torch.Tensor:
    """uint32[n_limbs, ...] limbs -> int64 tensor of the same shape."""
    arr = np.asarray(arr)
    if arr.dtype.kind not in "ui" or (arr.size and (arr.min() < 0 or arr.max() > 0xFFFF)):
        raise ValueError("expected exact 16-bit limbs")
    return torch.as_tensor(arr.astype(np.int64), device=resolve_device(device))


def affine_from_numpy(aff, device="cuda"):
    """(x, y, inf) numpy affine batch -> the port's (x, y, inf) tensors."""
    x, y, inf = aff
    dev = resolve_device(device)
    return (limbs_from_numpy(x, dev), limbs_from_numpy(y, dev),
            torch.as_tensor(np.array(inf, dtype=bool), device=dev))


def to_numpy(t) -> np.ndarray:
    """A port tensor -> numpy: limbs as uint32 (the JAX package's dtype),
    masks as bool."""
    arr = t.detach().cpu().numpy()
    return arr if arr.dtype == np.bool_ else arr.astype(np.uint32)


def _value(v, device):
    """An affine batch (a 3-tuple) or a limb array -> the port's."""
    if isinstance(v, tuple):
        return affine_from_numpy(v, device)
    return limbs_from_numpy(v, device)


def crs_from_numpy(crs, device="cuda"):
    """The JAX package's CRS -> the port's `models.crs.CRS`."""
    from ..models.crs import CRS
    aff = lambda a: affine_from_numpy(a, device)
    return CRS(u=aff(crs.u), v=aff(crs.v), g1_gen=aff(crs.g1_gen),
               g2_gen=aff(crs.g2_gen),
               gt_gen=limbs_from_numpy(crs.gt_gen, device),
               u_base=aff(crs.u_base), v_base=aff(crs.v_base))


def statement_from_numpy(equ, device="cuda"):
    """One of the JAX package's four statements -> the port's, by its
    equation type's wire tag."""
    from ..models import statement as S
    cls = {S.EquType.PairingProduct: S.PPE, S.EquType.MultiScalarG1: S.MSMEG1,
           S.EquType.MultiScalarG2: S.MSMEG2,
           S.EquType.Quadratic: S.QuadEqu}[S.EquType(int(equ.equ_type))]
    return cls(a_consts=_value(equ.a_consts, device),
               b_consts=_value(equ.b_consts, device),
               gamma=limbs_from_numpy(equ.gamma, device),
               target=_value(equ.target, device))


def commit_from_numpy(c, device="cuda"):
    """A JAX Commit1 / Commit2 -> the port's (told apart by the rank of the
    coordinates: (nl, 2, m) for G1, (nl, 2, 2, m) for G2)."""
    from ..models.prover import Commit1, Commit2
    coms = affine_from_numpy(c.coms, device)
    cls = Commit2 if coms[0].ndim == 4 else Commit1
    widths = None if c.row_widths is None else tuple(c.row_widths)
    return cls(coms=coms, rand=limbs_from_numpy(c.rand, device),
               row_widths=widths)


def proof_from_numpy(proof, device="cuda"):
    """A JAX CProof -> the port's `models.prover.CProof`."""
    from ..models.prover import CProof, EquProof
    from ..models.statement import EquType
    return CProof(
        xcoms=commit_from_numpy(proof.xcoms, device),
        ycoms=commit_from_numpy(proof.ycoms, device),
        equ_proofs=[EquProof(pi=affine_from_numpy(e.pi, device),
                             theta=affine_from_numpy(e.theta, device),
                             equ_type=EquType(int(e.equ_type)))
                    for e in proof.equ_proofs])
