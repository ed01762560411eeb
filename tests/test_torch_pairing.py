"""The port's pairing path against the JAX package and the host oracles.

`miller_loop` and `final_exp` are held against the JAX package's (jitted
on the CPU, its non-Pallas branch): limb for limb with the port's tower on
its lazy branch (`FUSED_MAX_LANES` set to 0, the formulas both packages run
above 4096 lanes), and value for value as shipped, where these small
batches take the fused kernels' plain versions (the Miller iterations,
the tower products, the powers). `pairing`, `multi_pairing`, `gt_exp`,
the ComT helpers and the verifier's signed Miller product are held against
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

import pytest

from groth_sahai_tpu_torch.models import commit_group as CG
from groth_sahai_tpu_torch.models import kernels as MK
from groth_sahai_tpu_torch.models.verifier import _comt_ppe_target
from groth_sahai_tpu_torch.ops import bls12_381 as C
from groth_sahai_tpu_torch.ops import cuda_tower as CT
from groth_sahai_tpu_torch.ops import pairing as pr
from groth_sahai_tpu_torch.ops import tower as T
from groth_sahai_tpu_torch.ops.fp import FR
from groth_sahai_tpu_torch.ops.limbs import ints_to_limbs
from groth_sahai_tpu_torch.ops.curve import (G1, G2, g1_affine_from_ints,
                                             g1_affine_to_ints,
                                             g2_affine_from_ints,
                                             g2_affine_to_ints)
from groth_sahai_tpu_torch.ops.tower import FQ12
from groth_sahai_tpu_torch.utils import hostcrypto as H
from groth_sahai_tpu_torch.utils.convert import (affine_from_numpy,
                                                 limbs_from_numpy, to_numpy)

from . import oracle as O
from .test_torch_tower import one_thread  # noqa: F401

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


def count_calls(monkeypatch, module, name):
    """Count the calls of module.name (it still runs)."""
    calls = []
    fn = getattr(module, name)

    def spy(*args):
        calls.append(1)
        return fn(*args)

    monkeypatch.setattr(module, name, spy)
    return calls


def test_fused_miller_loop_vs_host_and_lazy(monkeypatch):
    """At these few lanes each iteration is one fused call, 63 doublings
    and 5 additions, as the reference's schedule; equal by value to the
    host twin (infinity on either side gives 1) and to the lazy branch."""
    P, Q = points([3, 0, 6], [5, 2, 0])
    args = port_points(P, Q)
    dbl = count_calls(monkeypatch, CT, "miller_iter_dbl")
    add = count_calls(monkeypatch, CT, "miller_iter_add")
    fused = FQ12.to_ints(pr.miller_loop(*args))
    assert (len(dbl), len(add)) == (63, 5)
    assert fused == [H.miller_loop(p, q) for p, q in zip(P, Q)]
    assert fused[1] == fused[2] == H.F12_ONE
    monkeypatch.setattr(T, "FUSED_MAX_LANES", 0)
    assert FQ12.to_ints(pr.miller_loop(*args)) == fused
    assert (len(dbl), len(add)) == (63, 5)     # the lazy branch: no call


def gt_exp_inputs():
    """GT and non-GT bases (a Miller output, as the batch verifier's
    ratios are) with scalars 0, r - 1 and 2^272 - 1 (all 272 bits read)."""
    g1 = (C.G1_GEN_X, C.G1_GEN_Y)
    g2 = (C.G2_GEN_X, C.G2_GEN_Y)
    base = [H.f12_pow(H.pairing_gen(), 5), H.miller_loop(g1, g2),
            H.f12_pow(H.pairing_gen(), 9)]
    scal = [0, C.R - 1, (1 << 272) - 1]
    return (base, scal, FQ12.from_ints(base, device="cpu"),
            limbs_from_numpy(ints_to_limbs(scal, FR.n), device="cpu"))


@pytest.mark.parametrize("branch", ["fused", "lazy"])
def test_gt_exp_vs_host(branch, monkeypatch):
    """gt_exp by value against hostcrypto.f12_pow, on the fused power and
    on the per-bit square-and-select (FUSED_MAX_LANES = 0); a batch of 0
    lanes takes the per-bit branch, as the reference's `0 < total` does."""
    base, scal, a, s = gt_exp_inputs()
    pow_dyn = count_calls(monkeypatch, CT, "f12_pow_dyn")
    if branch == "lazy":
        monkeypatch.setattr(T, "FUSED_MAX_LANES", 0)
    got = pr.gt_exp(a, s)
    assert len(pow_dyn) == (branch == "fused")
    assert FQ12.to_ints(got) == [H.f12_pow(b, e) for b, e in zip(base, scal)]
    if branch == "fused":
        empty = pr.gt_exp(a[:, :, :0], s[:, :0])
        assert tuple(empty.shape) == (25, 12, 0) and len(pow_dyn) == 1


def test_comt_helpers_and_ppe_target():
    """The verifier's last comparison on a small product whose Com vectors
    have row 0 at infinity, as iota(X) = (O, X) does: entries (0, 0),
    (0, 1) and (1, 0) are 1, and comt_eq holds against (1, 1, 1, t) with t
    the host's (1, 1) entry, and not once t changes."""
    ka, kb = [2, 3], [5, 4]
    P, Q = points(ka, kb)
    px, py, pinf = g1_affine_from_ints([None, None] + P, device="cpu")
    qx, qy, qinf = g2_affine_from_ints([None, None] + Q, device="cpu")
    com1 = (px.reshape(-1, 2, 2), py.reshape(-1, 2, 2), pinf.reshape(2, 2))
    com2 = (qx.reshape(-1, 2, 2, 2), qy.reshape(-1, 2, 2, 2),
            qinf.reshape(2, 2))
    res = pr.final_exp(CG.comt_pairing_sum_miller(com1, com2))
    e0 = H.pairing_gen()
    t_host = H.f12_pow(e0, sum(a * b for a, b in zip(ka, kb)))
    got = FQ12.to_ints(res.reshape(25, 12, 4))
    assert got == [H.F12_ONE] * 3 + [t_host]
    t_gt = FQ12.from_ints([t_host], device="cpu")[:, :, 0]
    target = _comt_ppe_target(t_gt)
    assert tuple(target.shape) == (25, 12, 2, 2)
    assert bool(CG.comt_eq(res, target))
    wrong = _comt_ppe_target(FQ12.from_ints([H.f12_pow(t_host, 2)],
                                            device="cpu")[:, :, 0])
    assert not bool(CG.comt_eq(res, wrong))
    one = CG.comt_one(device="cpu")
    assert bool(CG.comt_eq(CG.comt_mul(res, one), res))
    # one pair: comt_pairing_miller of the last column equals its term
    last = tuple(x[..., 1] for x in com1), tuple(x[..., 1] for x in com2)
    f = CG.comt_pairing_miller(*last)
    assert FQ12.to_ints(f.reshape(25, 12, 4))[3] == H.miller_loop(P[1], Q[1])
