"""The port's pairing path against the JAX package and the host oracles.

`miller_loop` and `final_exp` are held against the JAX package's (jitted
on the CPU, its non-Pallas branch): limb for limb with the port's tower on
its lazy branch (`FUSED_MAX_LANES` set to 0, the formulas both packages run
above 4096 lanes), and value for value as shipped, where these small
batches take the fused tower kernels' plain versions. `pairing`,
`multi_pairing` and the verifier's signed Miller product are held against
`utils/hostcrypto.py` (the host twin of the device schedule) and
`tests/oracle.py` (an independent textbook pairing).
"""

import numpy as np
import jax
import jax.numpy as jnp
import torch

from groth_sahai_tpu.ops import pairing as jpr
from groth_sahai_tpu.ops.curve import (g1_affine_from_ints as j_g1_from_ints,
                                       g2_affine_from_ints as j_g2_from_ints)

from groth_sahai_tpu_torch.models import kernels as MK
from groth_sahai_tpu_torch.ops import bls12_381 as C
from groth_sahai_tpu_torch.ops import pairing as pr
from groth_sahai_tpu_torch.ops import tower as T
from groth_sahai_tpu_torch.ops.curve import (G1, G2, g1_affine_from_ints,
                                             g1_affine_to_ints,
                                             g2_affine_from_ints,
                                             g2_affine_to_ints)
from groth_sahai_tpu_torch.ops.tower import FQ12
from groth_sahai_tpu_torch.utils import hostcrypto as H
from groth_sahai_tpu_torch.utils.convert import (affine_from_numpy,
                                                 limbs_from_numpy, to_numpy)

from . import oracle as O

G1_GEN = (C.G1_GEN_X, C.G1_GEN_Y)
G2_GEN = (C.G2_GEN_X, C.G2_GEN_Y)


def points(ka, kb):
    return ([H.g1_mul(G1_GEN, k) for k in ka], [H.g2_mul(G2_GEN, k) for k in kb])


def port_points(P, Q):
    return (g1_affine_from_ints(P, device="cpu"),
            g2_affine_from_ints(Q, device="cpu"))


def numpy_aff(a):
    return tuple(np.asarray(x) for x in a)


def same_values(port_out, jax_out):
    """Equal as Fq12 values: every coefficient reduced to [0, p)."""
    assert FQ12.to_ints(port_out) == FQ12.to_ints(
        limbs_from_numpy(jax_out, device="cpu"))


def test_miller_loop_matches_jax(monkeypatch):
    """Against jax.jit(pairing.miller_loop), infinity included: limb for
    limb on the lazy branch, value for value on the fused kernels."""
    P, Q = points([3, 0], [5, 2])
    jP, jQ = j_g1_from_ints(P), j_g2_from_ints(Q)
    want = np.asarray(jax.jit(jpr.miller_loop)(jP, jQ))
    # the JAX package's arrays carried across as numpy
    args = (affine_from_numpy(numpy_aff(jP), device="cpu"),
            affine_from_numpy(numpy_aff(jQ), device="cpu"))
    fused = pr.miller_loop(*args)
    same_values(fused, want)
    assert FQ12.to_ints(fused)[0] == H.miller_loop(P[0], Q[0])
    monkeypatch.setattr(T, "FUSED_MAX_LANES", 0)
    got = pr.miller_loop(*args)
    np.testing.assert_array_equal(to_numpy(got), want)


def test_final_exp_matches_jax(monkeypatch):
    """Against jax.jit(pairing.final_exp) (one JAX compile): limb for limb
    on the lazy branch, value for value on the fused kernels."""
    P, Q = points([2, 7], [3, 1])
    f = FQ12.from_ints([H.miller_loop(p, q) for p, q in zip(P, Q)],
                       device="cpu")
    want = np.asarray(jax.jit(jpr.final_exp)(jnp.asarray(to_numpy(f))))
    fused = pr.final_exp(f)
    same_values(fused, want)
    assert FQ12.to_ints(fused) == [H.pairing(p, q) for p, q in zip(P, Q)]
    monkeypatch.setattr(T, "FUSED_MAX_LANES", 0)
    got = pr.final_exp(f)
    np.testing.assert_array_equal(to_numpy(got), want)


def test_pairing_vs_host_and_oracle():
    """e(aG1, bG2) equals both host pairings; infinity pairs give 1."""
    ka, kb = [2, 1, 0, 5], [3, 7, 3, 0]
    P, Q = points(ka, kb)
    got = FQ12.to_ints(pr.pairing(*port_points(P, Q)))
    assert got == [H.pairing(p, q) for p, q in zip(P, Q)]
    one = H.F12_ONE
    assert got[2] == one and got[3] == one
    o = O.pairing(O.g1_mul(O.G1_GEN, 2), O.g2_mul(O.G2_GEN, 3))
    assert got[0] == tuple(tuple(tuple(c.v for c in f2.c) for f2 in f6.c)
                           for f6 in o.c)


def test_multi_pairing_and_gt_helpers():
    """prod_k e(P_k, Q_k) with one final exp == e(G1, G2)^(sum a_k b_k)."""
    ka, kb = [2, 3, 0, 7], [5, 1, 4, 2]
    P, Q = points(ka, kb)
    p_aff, q_aff = port_points(P, Q)
    got = pr.multi_pairing(p_aff, q_aff, axis=0)
    e0 = H.pairing_gen()
    want = H.f12_pow(e0, sum(a * b for a, b in zip(ka, kb)))
    assert FQ12.to_ints(got) == [want]
    e = got[:, :, None]
    assert bool(pr.gt_is_one(pr.gt_mul(e, pr.gt_inv_cyclotomic(e))).all())
    assert bool(pr.gt_eq(e, FQ12.from_ints([want], device="cpu")).all())
    assert not bool(pr.gt_is_one(e).any())


def test_signed_miller_product_vs_host():
    """miller_product_signed + final_exp over a (2, 2, Kp) batch with a mixed
    conjugation mask and an infinity commitment == host pairing products."""
    sa = [[2, 0, 5], [1, 4, 3]]
    sb = [[3, 2, 1], [6, 1, 2]]
    mask = np.array([False, True, True])
    flat_p = [None if s == 0 else H.g1_mul(G1_GEN, s) for row in sa for s in row]
    flat_q = [H.g2_mul(G2_GEN, s) for row in sb for s in row]
    px, py, pinf = g1_affine_from_ints(flat_p, device="cpu")
    qx, qy, qinf = g2_affine_from_ints(flat_q, device="cpu")
    com1 = (px.reshape(-1, 2, 3), py.reshape(-1, 2, 3), pinf.reshape(2, 3))
    com2 = (qx.reshape(-1, 2, 2, 3), qy.reshape(-1, 2, 2, 3), qinf.reshape(2, 3))
    out = MK.final_exp(MK.miller_product_signed(com1, com2, mask))
    assert tuple(out.shape) == (25, 12, 2, 2)
    e0 = H.pairing_gen()
    got = FQ12.to_ints(out.reshape(25, 12, 4))
    for i in range(2):
        for j in range(2):
            ex = sum((-1 if m else 1) * a * b
                     for m, a, b in zip(mask, sa[i], sb[j]))
            assert got[2 * i + j] == H.f12_pow(e0, ex % C.R), (i, j)


def test_affine_io_and_on_curve():
    P, Q = points([1, 9], [4, 0])
    p_aff, q_aff = port_points(P, Q)
    assert g1_affine_to_ints(p_aff) == P and g2_affine_to_ints(q_aff) == Q
    assert bool(G1.on_curve_affine(p_aff).all())
    assert bool(G2.on_curve_affine(q_aff).all())
    bad = (p_aff[0], G1.F.add(p_aff[1], G1.F.one((2,), device="cpu")), p_aff[2])
    assert not bool(G1.on_curve_affine(bad).any())
    inf = G2.inf_affine((3,), device="cpu")
    assert bool(inf[2].all()) and bool(G2.on_curve_affine(inf).all())
    padded = MK.pad_aff(G1, p_aff, 0, MK.next_pow2(3))
    assert g1_affine_to_ints(padded) == P + [None, None]
    assert torch.equal(padded[2], torch.tensor([False, False, True, True]))
