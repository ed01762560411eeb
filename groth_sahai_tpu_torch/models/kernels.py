"""The verifier's heavy primitives: padding and the signed Miller product.

The part of ``groth_sahai_tpu/models/kernels.py`` on the verification
path. The reference pads every variable-length axis to a power of two so
that XLA compiles one executable per size bucket; the port keeps the same
padding (points at infinity contribute the identity to a Miller product),
so both packages run the same batch shapes, and so take the same kernels
at each size. The Miller batch is (2, 2, Kp), 4 Kp lanes:

  * Kp <= 1024 (at most 4096 lanes; `verify` of a PPE with m = n = 334
    has K = 1006, Kp = 1024): each of the 63 + 5 Miller iterations is one
    launch of the fused `miller_iter_dbl` / `miller_iter_add`; the tree
    reduction and the final exponentiation take `fq12_mul` and `cyc_pow`.
  * Kp >= 2048: the Miller loop runs the lazy tower over the field
    kernels (`mont_mul`, `mul_wide`, `redc`); the tree reduction from
    (2, 2, Kp / 2) takes `fq12_mul` once it is at most 4096 lanes, and the
    final exponentiation on (2, 2) `fq12_mul`, `cyc_pow` and `pow_const`.

  * the verifier's five pairing_sum terms plus the rhs fold become ONE
    signed Miller product (`miller_product_signed`) whose conjugation mask
    is data;
  * `final_exp` then runs once on the (2, 2) ComT shape.
"""

from __future__ import annotations

import numpy as np
import torch

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
