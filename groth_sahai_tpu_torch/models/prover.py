"""GS commitments and the unified prover.

The port of ``groth_sahai_tpu/models/prover.py``: one generic routine
serves all four equation types, parameterised by which side is
scalar-committed:

  pi    = R^T iota*(B) + (R^T Gamma) iota*(Y) + (R^T Gamma S - T^T) v[:wy]
  theta = S^T iota*(A) + (S^T Gamma^T) iota*(X) + T u[:wx]

with R (m x wx), S (n x wy), T (wy x wx); wx/wy = 2 for group-committed
sides, 1 for scalar-committed sides. Randomness is passed explicitly or
drawn from a GsRng (host Philox, the reference's draw order) and made on
the device of the statement's tensors.

Every Com product goes through `models/kernels.py` (`com_matvec`,
`iota_prime`, `scalar_mul_vec`), so through `Curve.scalar_mul` and its two
fused curve kernels, or, for a `com_matvec` with padded K >= 16, through
the Pippenger MSM of `ops/msm.py`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch

from ..ops.curve import G1, G2
from ..utils.rng import GsRng
from . import commit_group as cg
from . import kernels as K
from .kernels import fr_matmul, fr_transpose, fr_sub_std
from .crs import CRS
from .statement import EquType


# ---------------------------------------------------------------------------
# Commitments
# ---------------------------------------------------------------------------

@dataclass
class Commit1:
    coms: Any            # Com1 vector (2, m) affine
    rand: Any            # int64[17, m, wx] std-form
    # Per-row true randomness widths, or None when uniform (= rand's last
    # dim). Set by a mixed-kind `append`: narrower rows are zero-padded in
    # `rand` (r*u1 == r*u1 + 0*u2) and their true widths recorded here.
    row_widths: Any = None


@dataclass
class Commit2:
    coms: Any            # Com2 vector (2, n) affine
    rand: Any            # int64[17, n, wy] std-form
    row_widths: Any = None


def _commit_group(curve, key_vec, vars_aff, rand_std):
    """c = iota(X) + R u (batched)."""
    lin = cg.iota(curve, vars_aff)                   # (2, m) affine
    # rand (17, m, 2) contracts with the key's element axis
    ru = K.com_matvec(curve, rand_std, key_vec)      # Jacobian (2, m)
    return K.to_affine(curve, K.point_add(curve, curve.from_affine(lin), ru))


def _commit_scalar(curve, key_vec, base_elem, scalar_vars_std, rand_std):
    """c = iota'(x) + r u1 (batched)."""
    lin = K.iota_prime(curve, base_elem, scalar_vars_std)    # Jacobian (2, m)
    u1 = cg.aff_index(curve, key_vec, 1, 0)
    m = scalar_vars_std.shape[-1]
    u1b = cg.aff_bcast(curve, u1, (m,))                      # (2, m)
    ru = K.scalar_mul_vec(curve, u1b, rand_std[:, :, 0])     # Jacobian (2, m)
    return K.to_affine(curve, K.point_add(curve, lin, ru))


def batch_commit_G1(xvars, crs: CRS, rng: Optional[GsRng] = None,
                    rand=None) -> Commit1:
    m = xvars[2].shape[-1]
    if rand is None:
        rand = rng.fr_std((m, 2), device=xvars[2].device)
    return Commit1(coms=_commit_group(G1, crs.u, xvars, rand), rand=rand)


def batch_commit_G2(yvars, crs: CRS, rng: Optional[GsRng] = None,
                    rand=None) -> Commit2:
    n = yvars[2].shape[-1]
    if rand is None:
        rand = rng.fr_std((n, 2), device=yvars[2].device)
    return Commit2(coms=_commit_group(G2, crs.v, yvars, rand), rand=rand)


def batch_commit_scalar_B1(scalar_xvars, crs: CRS,
                           rng: Optional[GsRng] = None, rand=None) -> Commit1:
    m = scalar_xvars.shape[-1]
    if rand is None:
        rand = rng.fr_std((m, 1), device=scalar_xvars.device)
    return Commit1(coms=_commit_scalar(G1, crs.u, crs.u_base,
                                       scalar_xvars, rand), rand=rand)


def batch_commit_scalar_B2(scalar_yvars, crs: CRS,
                           rng: Optional[GsRng] = None, rand=None) -> Commit2:
    n = scalar_yvars.shape[-1]
    if rand is None:
        rand = rng.fr_std((n, 1), device=scalar_yvars.device)
    return Commit2(coms=_commit_scalar(G2, crs.v, crs.v_base,
                                       scalar_yvars, rand), rand=rand)


def _widths_of(c) -> tuple:
    if c.row_widths is not None:
        return tuple(c.row_widths)
    return (int(c.rand.shape[-1]),) * int(c.rand.shape[1])


def _pad_rand(rand, to_w: int):
    w = rand.shape[-1]
    if w == to_w:
        return rand
    return torch.cat([rand, rand.new_zeros(rand.shape[:-1] + (to_w - w,))],
                     -1)


def _append_commits(cls, curve, a, b):
    """Commit::append: concatenate commitment vectors.

    The reference's rand is a ragged list of rows (group rows w=2, scalar
    rows w=1); mixed-kind appends zero-pad the narrower rows (r*u1 ==
    r*u1 + 0*u2) and record the true per-row widths.
    """
    wa, wb = int(a.rand.shape[-1]), int(b.rand.shape[-1])
    w = max(wa, wb)
    rand = torch.cat([_pad_rand(a.rand, w), _pad_rand(b.rand, w)], 1)
    widths = None
    if wa != wb or a.row_widths is not None or b.row_widths is not None:
        widths = _widths_of(a) + _widths_of(b)
    return cls(coms=cg.aff_concat(curve, [a.coms, b.coms], axis=1),
               rand=rand, row_widths=widths)


def append_commit1(a: Commit1, b: Commit1) -> Commit1:
    return _append_commits(Commit1, G1, a, b)


def append_commit2(a: Commit2, b: Commit2) -> Commit2:
    return _append_commits(Commit2, G2, a, b)


# ---------------------------------------------------------------------------
# Proofs
# ---------------------------------------------------------------------------

@dataclass
class EquProof:
    pi: Any              # Com2 vector (2, wx) affine
    theta: Any           # Com1 vector (2, wy) affine
    equ_type: EquType


@dataclass
class CProof:
    """Commitments + per-equation proofs.

    The private proof randomness T is NOT kept on the proof object (the
    reference's Rust original serializes it, which leaks prover
    randomness; the JAX package leaves it off too).
    """
    xcoms: Commit1
    ycoms: Commit2
    equ_proofs: list


def _iota_side(curve, is_scalar, consts_or_vars, base_elem):
    """iota(X) or iota'(x), affine Com batch (2, k)."""
    if is_scalar:
        return K.to_affine(curve,
                           K.iota_prime(curve, base_elem, consts_or_vars))
    return cg.iota(curve, consts_or_vars)


def _prove_kernel(x_is_scalar, y_is_scalar,
                  xvars, yvars, gamma, a_consts, b_consts,
                  R, S, T, crs):
    """The unified prover (see the module docstring for the formulas)."""
    wx = R.shape[-1]
    wy = S.shape[-1]
    Rt = fr_transpose(R)                          # (wx, m)
    St = fr_transpose(S)                          # (wy, n)

    # ---- pi ---------------------------------------------------------------
    iota_b = _iota_side(G2, y_is_scalar, b_consts, crs.v_base)       # (2, m)
    pi1 = K.com_matvec(G2, Rt, iota_b)            # Jacobian (2, wx)
    rg = fr_matmul(Rt, gamma)                     # (wx, n)
    iota_y = _iota_side(G2, y_is_scalar, yvars, crs.v_base)          # (2, n)
    pi2 = K.com_matvec(G2, rg, iota_y)            # Jacobian (2, wx)
    rgs = fr_matmul(rg, S)                        # (wx, wy)
    pf = fr_sub_std(rgs, fr_transpose(T))         # (wx, wy)
    v_used = cg.aff_slice0(G2, crs.v, 1, wy)
    pi3 = K.com_matvec(G2, pf, v_used)            # Jacobian (2, wx)
    pi = K.to_affine(G2, K.point_add(G2, K.point_add(G2, pi1, pi2), pi3))

    # ---- theta ------------------------------------------------------------
    iota_a = _iota_side(G1, x_is_scalar, a_consts, crs.u_base)       # (2, n)
    th1 = K.com_matvec(G1, St, iota_a)            # Jacobian (2, wy)
    sgt = fr_matmul(St, fr_transpose(gamma))      # (wy, m)
    iota_x = _iota_side(G1, x_is_scalar, xvars, crs.u_base)          # (2, m)
    th2 = K.com_matvec(G1, sgt, iota_x)           # Jacobian (2, wy)
    u_used = cg.aff_slice0(G1, crs.u, 1, wx)
    th3 = K.com_matvec(G1, T, u_used)             # Jacobian (2, wy)
    theta = K.to_affine(G1, K.point_add(G1, K.point_add(G1, th1, th2), th3))
    return pi, theta


def vec_len(v) -> int:
    """Length of a variable or constant vector: an affine batch (x, y,
    inf) or Fr limbs (17, k)."""
    return int(v[2].shape[-1]) if isinstance(v, tuple) else int(v.shape[-1])


def check_dims(equ, m: int, n: int):
    """The statement's shapes against m X-side and n Y-side commitments:
    B has m entries, A has n, Gamma is m x n. Raises ValueError."""
    got = (vec_len(equ.b_consts), vec_len(equ.a_consts),
           tuple(equ.gamma.shape[1:]))
    if got != (m, n, (m, n)):
        raise ValueError(f"statement shapes (len B, len A, Gamma) = {got} "
                         f"do not fit m = {m}, n = {n}")


def prove(equ, xvars, yvars, xcoms: Commit1, ycoms: Commit2, crs: CRS,
          rng: Optional[GsRng] = None, T=None) -> EquProof:
    """Produce (pi, theta) for an equation over committed variables.

    T is the (wy, wx) proof randomness (drawn from rng if not given, in the
    reference's row-major order). The variables, commitments and the
    statement must agree in m and n (the original's dimension asserts).
    """
    m, n = vec_len(xcoms.coms), vec_len(ycoms.coms)
    if (vec_len(xvars), vec_len(yvars)) != (m, n):
        raise ValueError(f"{vec_len(xvars)} X and {vec_len(yvars)} Y "
                         f"variables against {m} and {n} commitments")
    check_dims(equ, m, n)
    wx = xcoms.rand.shape[-1]
    wy = ycoms.rand.shape[-1]
    if T is None:
        T = rng.fr_std((wy, wx), device=xcoms.rand.device)
    pi, theta = _prove_kernel(
        equ.x_is_scalar, equ.y_is_scalar,
        xvars, yvars, equ.gamma, equ.a_consts, equ.b_consts,
        xcoms.rand, ycoms.rand, T, crs)
    return EquProof(pi=pi, theta=theta, equ_type=equ.equ_type)


def commit_and_prove(equ, xvars, yvars, crs: CRS, rng: GsRng) -> CProof:
    """Commit to both sides then prove."""
    if equ.x_is_scalar:
        xcoms = batch_commit_scalar_B1(xvars, crs, rng)
    else:
        xcoms = batch_commit_G1(xvars, crs, rng)
    if equ.y_is_scalar:
        ycoms = batch_commit_scalar_B2(yvars, crs, rng)
    else:
        ycoms = batch_commit_G2(yvars, crs, rng)
    proof = prove(equ, xvars, yvars, xcoms, ycoms, crs, rng)
    return CProof(xcoms=xcoms, ycoms=ycoms, equ_proofs=[proof])
