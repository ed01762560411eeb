"""CRS (trusted setup) for the SXDH instantiation.

The port of ``groth_sahai_tpu/models/crs.py``:
  u = [(p1, q1), (u1, v1)]  with q1 = a1 p1, u1 = t1 p1, v1 = t1 q1 (binding)
  v = [(p2, q2), (u2, v2)]  symmetric over G2
  plus generators (g1, g2, gt = e(g1, g2)), and the iota' base elements
  u2 + (O, g1) and v2 + (O, g2) of the scalar commitments and the MSME /
  quadratic target maps.

Generation runs on the host with plain integers (utils/hostcrypto.py):
twelve scalar multiplications and one GT power, then one upload of the
tensors in the layouts the batched kernels consume. The pairing identity
gt = e(r1 g1, r2 g2) = e(g1, g2)^(r1 r2) turns the CRS pairing into the
cached generator pairing and a GT exponent.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

from ..ops.curve import g1_affine_from_ints, g2_affine_from_ints
from ..ops.tower import FQ12
from ..ops import bls12_381 as C
from ..utils import hostcrypto as HC
from ..utils.rng import GsRng


@dataclass
class CRS:
    u: Any          # Com1 vector (2, 2): [[p1, u1], [q1, v1]]; u[:,j] = u_{j+1}
    v: Any          # Com2 vector (2, 2)
    g1_gen: Any     # G1 affine ()
    g2_gen: Any     # G2 affine ()
    gt_gen: Any     # Fq12 (nl, 12)
    u_base: Any     # u2 + (O, g1): iota1' base, Com1 element (2,)
    v_base: Any     # v2 + (O, g2): iota2' base, Com2 element (2,)


def _reshape22(aff, ns):
    x, y, inf = aff
    return (x.reshape(x.shape[:ns] + (2, 2)),
            y.reshape(y.shape[:ns] + (2, 2)),
            inf.reshape(2, 2))


def _index0(aff):
    x, y, inf = aff
    return (x[..., 0], y[..., 0], inf[0])


def generate_crs(rng: GsRng, hiding: bool = False, device="cuda") -> CRS:
    """Sample a binding (default) or hiding CRS on the host, upload it.

    Draw order matches the reference: p1, p2, a1, a2, t1, t2.
    """
    r1, r2, a1, a2, t1, t2 = rng.fr_ints(6)
    g1 = (C.G1_GEN_X, C.G1_GEN_Y)
    g2 = (C.G2_GEN_X, C.G2_GEN_Y)
    p1 = HC.g1_mul(g1, r1)
    p2 = HC.g2_mul(g2, r2)
    q1 = HC.g1_mul(p1, a1)
    q2 = HC.g2_mul(p2, a2)
    u1 = HC.g1_mul(p1, t1)
    u2 = HC.g2_mul(p2, t2)
    # v_i = t_i * q_i (- p_i if hiding)
    v1 = HC.g1_mul(q1, t1)
    v2 = HC.g2_mul(q2, t2)
    if hiding:
        v1 = HC.g1_add(v1, HC.g1_neg(p1))
        v2 = HC.g2_add(v2, HC.g2_neg(p2))

    # device layout (component, elem): [[p, u], [q, v]] so [:, 0] = u_1 etc.
    u = _reshape22(g1_affine_from_ints([p1, u1, q1, v1], device=device), 1)
    v = _reshape22(g2_affine_from_ints([p2, u2, q2, v2], device=device), 2)
    g1_dev = _index0(g1_affine_from_ints([p1], device=device))
    g2_dev = _index0(g2_affine_from_ints([p2], device=device))

    # gt = e(p1, p2) = e(g1, g2)^(r1 r2)
    gt_t = HC.f12_pow(HC.pairing_gen(), (r1 * r2) % C.R)
    gt = FQ12.from_ints([gt_t], device=device)[..., 0]

    # iota' bases: u_2 + (O, g1) and v_2 + (O, g2)
    u_base = g1_affine_from_ints([u1, HC.g1_add(v1, p1)], device=device)
    v_base = g2_affine_from_ints([u2, HC.g2_add(v2, p2)], device=device)

    return CRS(u=u, v=v, g1_gen=g1_dev, g2_gen=g2_dev, gt_gen=gt,
               u_base=u_base, v_base=v_base)
