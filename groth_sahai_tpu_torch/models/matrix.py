"""Matrix / commitment-group algebra: full `Mat` + `B1/B2/BT` trait parity.

The port of ``groth_sahai_tpu/models/matrix.py``, function for function:

  * `Mat<Elem>`: add, neg, scalar_mul, transpose, left_mul, right_mul;
  * `B1/B2/BT` entry-wise ops: add, sub, neg, sum;
  * `col_vec_to_vec` / `vec_to_col_vec`: a "column vector" is an array
    axis here, so these are reshape helpers.

Representations (the reference's):

  * Fr matrix (I, J): int64[17, I, J] standard-form limbs;
  * Com1/Com2 matrix: an affine batch whose batch axes are the matrix's,
    structure axes (limbs, Fq2 pair) first. The protocol layer keeps Com
    vectors as (2, k); these helpers treat all batch axes alike, so they
    work for (2, k) vectors, (I, J) matrices or any other layout;
  * a ComT value: Fq12 coefficients with batch (2, 2).

The hot paths (commit, prove, verify) do not call these; they use
models/kernels.py. The products run the same kernels as those paths:
`com_matmul` is one batched `Curve.scalar_mul` (`cmadd`, `cdbl_n_add`)
and a tree of Jacobian adds, the ComT pairings the Miller iterations and
one final exponentiation, `comt_scalar_mul` one `gt_exp` (`f12_pow_dyn`).
The reference's asserts are `ValueError`s.
"""

from __future__ import annotations

from ..ops import pairing as pr
from ..ops.fp import FR
from ..ops.tower import FQ12
from . import commit_group as cg
from .kernels import fr_matmul_std


# ---------------------------------------------------------------------------
# Fr matrices  (Mat<F>)
# ---------------------------------------------------------------------------

def fr_mat_add(a_std, b_std):
    """Entry-wise a + b mod r (canonical std-form output)."""
    return FR.normalize(FR.add(a_std, b_std), k=2)


def fr_mat_neg(a_std):
    """Entry-wise -a mod r."""
    return FR.normalize(FR.neg(a_std, k=1), k=1)


def fr_mat_scalar_mul(s_std, a_std):
    """s * A for one scalar s: int64[17] x int64[17, *shape]."""
    sm = FR.to_mont(s_std)
    shaped = sm.reshape(sm.shape[:1] + (1,) * (a_std.ndim - 1))
    return FR.normalize(FR.mul(shaped, a_std), k=2)


def fr_mat_transpose(a_std):
    """(I, J) -> (J, I) (axes 1 and 2 of the limb array)."""
    return a_std.transpose(1, 2)


def fr_mat_mul(a_std, b_std):
    """(I, K) x (K, J) -> (I, J) mod r: `left_mul` (lhs x self) and
    `right_mul` (self x rhs) are the same product either way around."""
    return fr_matmul_std(a_std, b_std)


def vec_to_col_vec(v_std):
    """int64[17, K] -> int64[17, K, 1]."""
    return v_std[:, :, None]


def col_vec_to_vec(m_std):
    """int64[17, K, 1] -> int64[17, K]."""
    if m_std.shape[-1] != 1:
        raise ValueError(f"not a column vector: {tuple(m_std.shape[1:])}")
    return m_std[:, :, 0]


# ---------------------------------------------------------------------------
# Com1 / Com2 batches: entry-wise B ops
# ---------------------------------------------------------------------------

def com_add(curve, a, b):
    """Entry-wise B addition of two affine Com batches (affine out)."""
    return cg.com_add_aff(curve, a, b)


def com_sub(curve, a, b):
    """Entry-wise a - b."""
    return com_add(curve, a, curve.neg_affine(b))


def com_neg(curve, a):
    """Entry-wise negation."""
    return curve.neg_affine(a)


def com_sum(curve, a, axis: int = 0):
    """B::sum over batch axis `axis`."""
    return curve.to_affine(curve.sum_reduce(curve.from_affine(a), axis=axis))


def com_scalar_mul(curve, s_std, a):
    """Entry-wise [s] * entry for a single Fr scalar s (int64[17])."""
    shaped = s_std.reshape(s_std.shape[:1] + (1,) * a[2].ndim)
    return curve.to_affine(curve.scalar_mul(a, shaped))


def com_transpose(curve, a, ax0: int = 0, ax1: int = 1):
    """Swap two batch axes of a Com matrix."""
    ns = curve.ns
    return (a[0].transpose(ns + ax0, ns + ax1),
            a[1].transpose(ns + ax0, ns + ax1),
            a[2].transpose(ax0, ax1))


def com_matmul(curve, fr_mat_std, com_mat, affine_out: bool = True):
    """(I, K) Fr matrix x Com batch (K, *rest) -> Com batch (I, *rest):
    out[i, ...] = sum_k s[i, k] M[k, ...], as one batched scalar
    multiplication over (I, K, *rest) and a tree reduction over K."""
    I = fr_mat_std.shape[1]
    rest = com_mat[2].shape[1:]
    pts = cg.aff_expand(curve, com_mat, 0, I)       # (I, K, *rest)
    s = fr_mat_std.reshape(fr_mat_std.shape + (1,) * len(rest))
    prods = curve.scalar_mul(pts, s)                # Jacobian (I, K, *rest)
    out = curve.sum_reduce(prods, axis=1)           # contract K -> (I, *rest)
    return curve.to_affine(out) if affine_out else out


def com_left_mul(curve, fr_mat_std, com_mat, affine_out: bool = True):
    """`Mat<Com>::left_mul`: lhs x self."""
    return com_matmul(curve, fr_mat_std, com_mat, affine_out)


def com_right_mul(curve, com_mat, fr_mat_std, affine_out: bool = True):
    """Com (I, K) x Fr (K, J) -> Com (I, J)."""
    out_t = com_matmul(curve, fr_mat_transpose(fr_mat_std),
                       com_transpose(curve, com_mat), affine_out)
    return com_transpose(curve, out_t)


# ---------------------------------------------------------------------------
# ComT (BT) ops
# ---------------------------------------------------------------------------

def comt_pairing(com1_elem, com2_elem):
    """ComT::pairing: the full 2x2 of pairings."""
    return pr.final_exp(cg.comt_pairing_miller(com1_elem, com2_elem))


def comt_pairing_sum(com1_vec, com2_vec):
    """ComT::pairing_sum: 4 multi-pairings with one shared final
    exponentiation."""
    return pr.final_exp(cg.comt_pairing_sum_miller(com1_vec, com2_vec))


def comt_add(a, b):
    """BT '+' = entry-wise GT multiplication."""
    return FQ12.mul(a, b)


def comt_neg(a):
    """BT negation = entry-wise GT inverse."""
    return FQ12.inv(a)


def comt_sub(a, b):
    return FQ12.mul(a, FQ12.inv(b))


def comt_sum(ts):
    """BT sum of a list of ComT values."""
    acc = ts[0]
    for t in ts[1:]:
        acc = FQ12.mul(acc, t)
    return acc


def comt_scalar_mul(s_std, a):
    """BT scalar mul = entry-wise GT exponentiation."""
    return pr.gt_exp(a, s_std.reshape(s_std.shape[:1] + (1,) * (a.ndim - 2)))
