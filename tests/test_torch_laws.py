"""The protocol laws of tests/test_commit_laws.py and tests/test_hiding_crs.py
on the port (groth_sahai_tpu_torch.models), against the host.

  * the four iota_T commutativity laws, one batch of ComT pairings:
    ComT::pairing(iota1(a1), iota2(a2)) == iota_T(f(a1, a2)), one per
    equation type, the target side from the host;
  * the witness-indistinguishability-preserving linear map's components:
    iota1'(a) == (u1 a, (v1 + g1) a), likewise on G2, and iota1's (O, x);
  * batch commit == per-element commit with the same randomness, for all
    four commit functions;
  * commit_and_prove == commit, then prove, from the same seed; the two
    runs serialize to the same bytes (utils/serde.py), and the proof
    verifies;
  * a satisfied PPE proves and verifies under a hiding CRS, and a wrong
    target fails.

The statements are the JAX tests' smallest: the PPE of tests/prover.rs
(X = (2, 3), Y = (4), A = (17), B = (O, 23), Gamma = [[5], [0]]), the
commitments of m = 2 variables (the JAX test's m = 3, cut to keep this
file near a minute on the plain versions).
"""

import pytest
import torch
import numpy as np

from groth_sahai_tpu_torch.models import commit_group as cg
from groth_sahai_tpu_torch.models import kernels as K
from groth_sahai_tpu_torch.models.crs import generate_crs
from groth_sahai_tpu_torch.models.prover import (
    CProof, batch_commit_G1, batch_commit_G2, batch_commit_scalar_B1,
    batch_commit_scalar_B2, commit_and_prove, prove)
from groth_sahai_tpu_torch.models.statement import PPE
from groth_sahai_tpu_torch.models.verifier import _comt_ppe_target, verify
from groth_sahai_tpu_torch.ops import pairing as pr
from groth_sahai_tpu_torch.ops.curve import (G1, G2, g1_affine_from_ints,
                                             g1_affine_to_ints,
                                             g2_affine_from_ints,
                                             g2_affine_to_ints)
from groth_sahai_tpu_torch.ops.fp import FR
from groth_sahai_tpu_torch.ops.limbs import ints_to_limbs
from groth_sahai_tpu_torch.ops.tower import FQ12
from groth_sahai_tpu_torch.utils import hostcrypto as H
from groth_sahai_tpu_torch.utils import serde
from groth_sahai_tpu_torch.utils.rng import GsRng

from .test_torch_tower import one_thread  # noqa: F401

DEV = "cpu"
R = H.R


def dev_g1(pts):
    return g1_affine_from_ints(pts, device=DEV)


def dev_g2(pts):
    return g2_affine_from_ints(pts, device=DEV)


def dev_fr(vals):
    return torch.as_tensor(ints_to_limbs([v % R for v in vals],
                                         FR.n).astype(np.int64))


def dev_gt(vals12):
    return FQ12.from_ints([vals12], device=DEV)[:, :, 0]


def gens(crs):
    return (g1_affine_to_ints(crs.g1_gen)[0], g2_affine_to_ints(crs.g2_gen)[0],
            FQ12.to_ints(crs.gt_gen[:, :, None])[0])


@pytest.fixture(scope="module", autouse=True)
def one_thread_module():
    """One intra-op thread for the module's fixtures too (`one_thread`
    covers the tests; module fixtures are set up before it)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def setup():
    crs = generate_crs(GsRng(777), device=DEV)
    return (crs,) + gens(crs)


def _elem(curve, aff_vec1):
    """(2, 1) Com vector -> (2,) Com element."""
    return cg.aff_index(curve, aff_vec1, 1, 0)


def _vec1(curve, elem):
    return cg.aff_map(curve, elem, lambda l: l[..., None],
                      lambda i: i[..., None])


def test_linear_bilinear_map_commutativity(setup):
    """ComT::pairing(iota1(a1), iota2(a2)) == iota_T(f(a1, a2)) for the
    four equation types, as one batch of seven ComT pairings."""
    crs, g1, g2, _ = setup
    rng = GsRng(31337)
    s1, s2, s3, s4, s5, s6 = rng.fr_ints(6)
    a1, a2 = H.g1_mul(g1, s1), H.g2_mul(g2, s2)      # PPE lhs points
    m1 = H.g1_mul(g1, s3)               # MSMEG1: group m1, scalar s4
    m2 = H.g2_mul(g2, s5)               # MSMEG2: scalar s6, group m2
    q1, q2 = rng.fr_ints(2)
    at_q = (q1 * q2) % R

    iota1 = lambda p: _elem(G1, cg.iota(G1, dev_g1([p])))
    iota2 = lambda p: _elem(G2, cg.iota(G2, dev_g2([p])))
    iota1p = lambda x: _elem(G1, K.to_affine(
        G1, K.iota_prime(G1, crs.u_base, dev_fr([x]))))
    iota2p = lambda y: _elem(G2, K.to_affine(
        G2, K.iota_prime(G2, crs.v_base, dev_fr([y]))))
    # quad target map: iota_T(at) = ComT::pairing(u_base, at * v_base)
    vb_at = _elem(G2, K.to_affine(G2, K.scalar_mul_vec(
        G2, _vec1(G2, crs.v_base), dev_fr([at_q]))))
    pairs = [
        (iota1(a1), iota2(a2)),
        (iota1(m1), iota2p(s4)),
        (iota1p(s6), iota2(m2)),
        (iota1p(q1), iota2p(q2)),
        # the target maps' pairs
        (iota1(H.g1_mul(m1, s4)), crs.v_base),
        (crs.u_base, iota2(H.g2_mul(m2, s6))),
        (crs.u_base, vb_at),
    ]
    P = cg.aff_stack(G1, [cg.aff_expand(G1, p, 1, 2) for p, _ in pairs])
    Q = cg.aff_stack(G2, [cg.aff_expand(G2, q, 0, 2) for _, q in pairs])
    res = pr.final_exp(pr.miller_loop(P, Q))      # (nl, 12, 7, 2, 2)
    eq = lambda a, b: bool(torch.all(FQ12.eq(a, b)))
    # PPE: lhs == (1, 1, 1, e(a1, a2)) with the pairing from the host
    assert eq(res[:, :, 0], _comt_ppe_target(dev_gt(H.pairing(a1, a2))))
    # MSMEG1 / MSMEG2 / quadratic: lhs ComT == target-map ComT
    for k in (1, 2, 3):
        assert eq(res[:, :, k], res[:, :, k + 3])


def test_wi_linear_map_components(setup):
    """iota1'(a) == (u1 a, (v1 + g1) a) with crs.u = [[p1, u1], [q1, v1]];
    iota2'(a) likewise over crs.v; iota1(x) = (O, x)."""
    crs, g1, g2, _ = setup
    (a,) = GsRng(999).fr_ints(1)
    a_d = dev_fr([a])

    def pair(curve, key, base):
        got = K.to_affine(curve, K.iota_prime(curve, base, a_d))  # (2, 1)
        to_ints = g2_affine_to_ints if curve is G2 else g1_affine_to_ints
        pick = lambda i: to_ints(cg.aff_index(curve, cg.aff_index(
            curve, key, 0, i), 0, 1))[0]
        return to_ints(got), pick(0), pick(1)

    got, u1, v1 = pair(G1, crs.u, crs.u_base)
    assert got == [H.g1_mul(u1, a), H.g1_mul(H.g1_add(v1, g1), a)]
    got2, u2, v2 = pair(G2, crs.v, crs.v_base)
    assert got2 == [H.g2_mul(u2, a), H.g2_mul(H.g2_add(v2, g2), a)]

    x = dev_g1([H.g1_mul(g1, 7)])
    ix = cg.iota(G1, x)
    assert bool(ix[2][0, 0]) and not bool(ix[2][1, 0])
    assert torch.equal(ix[0][:, 1, 0], x[0][:, 0])


def _host_coms(curve, coms):
    return (g2_affine_to_ints if curve is G2 else g1_affine_to_ints)(coms)


def test_batch_commit_equals_single(setup):
    """batch commit == the per-element commits joined, with the same
    randomness, for the four commit functions."""
    crs, g1, g2, _ = setup
    rng = GsRng(4242)
    m = 2
    cases = [
        (G1, batch_commit_G1, dev_g1([H.g1_mul(g1, k)
                                      for k in rng.fr_ints(m)]), 2),
        (G2, batch_commit_G2, dev_g2([H.g2_mul(g2, k)
                                      for k in rng.fr_ints(m)]), 2),
    ]
    sc = rng.fr_std((m,), device=DEV)
    cases += [(G1, batch_commit_scalar_B1, sc, 1),
              (G2, batch_commit_scalar_B2, sc, 1)]
    for curve, commit, xs, w in cases:
        rand = rng.fr_std((m, w), device=DEV)
        whole = commit(xs, crs, rand=rand).coms
        one = lambda i: (tuple(l[..., i:i + 1] for l in xs)
                         if isinstance(xs, tuple) else xs[:, i:i + 1])
        parts = [commit(one(i), crs, rand=rand[:, i:i + 1]).coms
                 for i in range(m)]
        assert _host_coms(curve, whole) == _host_coms(
            curve, cg.aff_concat(curve, parts, axis=1)), commit.__name__


def small_ppe(g1, g2, gt):
    """tests/prover.rs's PPE: e(X2, B2) e(A1, Y1) e(X1, Y1)^5 = t."""
    t = 3 * 23 + 17 * 4 + 2 * 4 * 5
    equ = PPE(a_consts=dev_g1([H.g1_mul(g1, 17)]),
              b_consts=dev_g2([None, H.g2_mul(g2, 23)]),
              gamma=dev_fr([5, 0]).reshape(FR.n, 2, 1),
              target=dev_gt(H.f12_pow(gt, t)))
    return (equ, dev_g1([H.g1_mul(g1, 2), H.g1_mul(g1, 3)]),
            dev_g2([H.g2_mul(g2, 4)]))


@pytest.fixture(scope="module")
def both_ways(setup):
    """commit_and_prove(GsRng(2718)), and commit, then prove, from another
    GsRng(2718)."""
    crs, g1, g2, gt = setup
    equ, xv, yv = small_ppe(g1, g2, gt)
    cp = commit_and_prove(equ, xv, yv, crs, GsRng(2718))
    rng = GsRng(2718)
    xcoms = batch_commit_G1(xv, crs, rng)
    ycoms = batch_commit_G2(yv, crs, rng)
    proof = prove(equ, xv, yv, xcoms, ycoms, crs, rng)
    return equ, cp, CProof(xcoms=xcoms, ycoms=ycoms, equ_proofs=[proof])


def test_commit_and_prove_equals_commit_then_prove(both_ways):
    _, cp, ctp = both_ways
    for curve, get in ((G1, lambda p: p.xcoms.coms),
                       (G2, lambda p: p.ycoms.coms),
                       (G2, lambda p: p.equ_proofs[0].pi),
                       (G1, lambda p: p.equ_proofs[0].theta)):
        assert _host_coms(curve, get(cp)) == _host_coms(curve, get(ctp))
    assert torch.equal(cp.xcoms.rand, ctp.xcoms.rand)
    assert torch.equal(cp.ycoms.rand, ctp.ycoms.rand)


def test_same_seed_identical_proof_bytes(setup, both_ways):
    """Two runs from one seed serialize to the same bytes, and verify."""
    crs = setup[0]
    equ, cp, ctp = both_ways
    blob = lambda p: (serde.proof_to_bytes(p.equ_proofs[0])
                      + serde.commit1_to_bytes(p.xcoms)
                      + serde.commit2_to_bytes(p.ycoms))
    assert blob(cp) == blob(ctp)
    assert serde.cproof_to_bytes(cp) == serde.cproof_to_bytes(ctp)
    assert verify(equ, cp, crs)


def test_hiding_crs_e2e(monkeypatch):
    """A hiding-key CRS still proves and verifies a satisfied PPE; a wrong
    target fails. A PPE's target enters only the final comparison, so the
    wrong target is held against the final exponentiation `verify`
    computed for the right one (one Miller loop, not two)."""
    rng = GsRng(6021)
    crs = generate_crs(rng, hiding=True, device=DEV)
    g1, g2, gt = gens(crs)
    equ, xv, yv = small_ppe(g1, g2, gt)
    proof = commit_and_prove(equ, xv, yv, crs, rng)
    seen = []
    real = K.final_exp
    monkeypatch.setattr(K, "final_exp", lambda f: seen.append(real(f))
                        or seen[-1])
    assert verify(equ, proof, crs)
    (res,) = seen
    assert bool(cg.comt_eq(res, _comt_ppe_target(equ.target)).item())
    assert not bool(cg.comt_eq(res, _comt_ppe_target(crs.gt_gen)).item())
