"""The protocol layer's heavy primitives: padding, Com products, the Fr
matrix algebra and the signed Miller product.

The port of ``groth_sahai_tpu/models/kernels.py``. The reference pads every
variable-length axis to a power of two so that XLA compiles one executable
per size bucket; the port keeps the same padding (points at infinity and
zero scalars are neutral in sums, and contribute the identity to a Miller
product), so both packages run the same batch shapes, and so take the same
kernels at each size. No jit: PyTorch runs eagerly.

  * `iota_prime`, `scalar_mul_vec` and `com_matvec` below padded K = 16
    run `Curve.scalar_mul` (the fused `cmadd` / `cdbl_n_add` kernels) on
    padded batches; `com_matvec` at padded K >= 16 runs one Pippenger MSM
    call (`ops/msm.py`: `cmsm_row_scan`, `cadd`, `cdbl_n_add`) over its
    (2, I) batch of MSMs;
  * the Miller batch of `miller_product_signed` is (2, 2, Kp), 4 Kp lanes:
    for Kp <= 1024 (at most 4096 lanes; `verify` of a PPE with m = n = 334
    has K = 1006, Kp = 1024) each of the 63 + 5 Miller iterations is one
    launch of the fused `miller_iter_dbl` / `miller_iter_add`, and the tree
    reduction and the final exponentiation take `fq12_mul` and `cyc_pow`;
    for Kp >= 2048 the Miller loop runs the lazy tower over the field
    kernels (`mont_mul`, `mul_wide`, `redc`);
  * the verifier's five pairing_sum terms plus the rhs fold become ONE
    signed Miller product whose conjugation mask is data, and `final_exp`
    runs once on the (2, 2) ComT shape.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.fp import FR
from ..ops.tower import FQ12
from ..ops.curve import G1, G2
from ..ops import pairing as pr
from . import commit_group as cg


def next_pow2(k: int) -> int:
    return 1 if k <= 1 else 1 << (k - 1).bit_length()


def pad_aff(curve, a, axis: int, to: int):
    """Pad an affine batch axis with points at infinity."""
    n = a[2].shape[axis]
    if n == to:
        return a
    ns = curve.ns

    def padc(l):
        shape = list(l.shape)
        shape[ns + axis] = to - n
        return torch.cat([l, l.new_zeros(shape)], ns + axis)

    def padi(i):
        shape = list(i.shape)
        shape[axis] = to - n
        return torch.cat([i, i.new_ones(shape)], axis)

    return (padc(a[0]), padc(a[1]), padi(a[2]))


def pad_scal(s, axis: int, to: int):
    """Pad a scalar-limb tensor's batch axis with zeros (axis counts from the
    limb axis: axis=1 is the first batch axis)."""
    n = s.shape[axis]
    if n == to:
        return s
    shape = list(s.shape)
    shape[axis] = to - n
    return torch.cat([s, s.new_zeros(shape)], axis)


def com_matvec(curve, scal_std, com_vec):
    """Padded (*L, I, K) x Com(2, *L, K) -> Jacobian Com(2, *L, I)."""
    K = scal_std.shape[-1]
    Kp = next_pow2(K)
    return cg.com_matvec(curve, pad_scal(scal_std, scal_std.ndim - 1, Kp),
                         pad_aff(curve, com_vec, com_vec[2].ndim - 1, Kp))


def to_affine(curve, jac):
    return curve.to_affine(jac)


def point_add(curve, a, b):
    return curve.add(a, b)


def scalar_mul(curve, pts, scal):
    return curve.scalar_mul(pts, scal)


def iota_prime(curve, base_elem, scalars_std, m: int | None = None):
    """iota'(x) of scalars (17, *L, m), padded to pow2 and sliced back to
    m: Jacobian Com (2, *L, m)."""
    m = scalars_std.shape[-1] if m is None else m
    out = cg.iota_prime(curve, base_elem,
                        pad_scal(scalars_std, scalars_std.ndim - 1,
                                 next_pow2(m)))
    return tuple(l.narrow(l.ndim - 1, 0, m) for l in out)


def scalar_mul_vec(curve, pts, scal_vec):
    """[s_i] P_i over a Com-style (2, m) batch, padded to pow2 and sliced.

    scal_vec: int64[17, m] (one scalar per vector element).
    """
    m = pts[2].shape[-1]
    mp = next_pow2(m)
    out = curve.scalar_mul(pad_aff(curve, pts, 1, mp),
                           pad_scal(scal_vec, 1, mp)[:, None, :])
    return tuple(l.narrow(curve.ns + 1, 0, m) for l in out)


def fr_matmul_std(a_std, b_std):
    """(I, K) x (K, J) Fr matmul on std-form limbs; canonical std output.

    One wide-domain product batch + tree add + single redc per entry
    (mont(a) * std(b) -> std(a*b)).
    """
    am = FR.to_mont(a_std)                       # (17, I, K)
    wide = FR.mul_wide(am[:, :, :, None], b_std[:, None, :, :])  # (35,I,K,J)
    s = _add_wide_reduce(wide, axis=2)           # contract K (array axis 2)
    return FR.normalize(FR.redc(s), k=2)


def _add_wide_reduce(w, axis):
    """Tree-sum wide values along ARRAY axis `axis` (axis 0 is limbs)."""
    size = w.shape[axis]
    while size > 1:
        half = size // 2
        s = FR.add_wide(w.narrow(axis, 0, half), w.narrow(axis, half, half))
        if size % 2:
            s = torch.cat([s, w.narrow(axis, 2 * half, 1)], axis)
            size = half + 1
        else:
            size = half
        w = s
    return w.select(axis, 0)


def fr_transpose(a_std):
    return a_std.transpose(1, 2)


def fr_sub_std(a_std, b_std):
    """Canonical a - b mod r on std limbs."""
    return FR.normalize(FR.sub(a_std, b_std, k=2), k=4)


def fr_matmul(a_std, b_std):
    """Fr matmul with the contraction axis padded to pow2."""
    Kp = next_pow2(a_std.shape[2])
    return fr_matmul_std(pad_scal(a_std, 2, Kp), pad_scal(b_std, 1, Kp))


def _miller_product_signed(P, Q, conj_mask):
    """prod_k f_k^(+-1): (2, 2, K) miller batch with per-k conjugation.

    conj_mask: bool[K]; True entries contribute their conjugate (the rhs
    fold: final_exp(conj(f)) == final_exp(f)^-1).
    """
    f = pr.miller_loop(P, Q)                    # (nl, 12, 2, 2, K)
    fc = FQ12.conj(f)
    f = torch.where(conj_mask[None, None, None, None, :], fc, f)
    return pr._product_reduce(f, axis=2)        # (nl, 12, 2, 2)


def miller_product_signed(com1_concat, com2_concat, conj_mask_np):
    """Pad the pair axis to pow2 and run the signed Miller product.

    com1_concat: Com1 vector (2, K); com2_concat: Com2 vector (2, K);
    conj_mask_np: numpy bool (K,). Runs on the points' device.
    """
    K = com1_concat[2].shape[-1]
    Kp = next_pow2(K)
    P = pad_aff(G1, com1_concat, 1, Kp)
    Q = pad_aff(G2, com2_concat, 1, Kp)
    mask = torch.as_tensor(np.pad(np.asarray(conj_mask_np, dtype=bool),
                                  (0, Kp - K)), device=P[0].device)
    Pb = cg.aff_expand(G1, P, 1, 2)             # (2, 2, Kp)
    Qb = cg.aff_expand(G2, Q, 0, 2)
    return _miller_product_signed(Pb, Qb, mask)


def final_exp(f):
    return pr.final_exp(f)
