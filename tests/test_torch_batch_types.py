"""The port's batch verifiers on the non-PPE cases of
tests/test_batch_verify_types.py (B = 2): MSMEG1 through `verify_batch`,
MSMEG2 through `verify_batch_randomized`, the quadratic equation through
`verify_batch`, each with one tampered target. Their iota_T targets join
the Miller batch as one conjugated pair per equation (`_target_pair` of
the B targets in one call). Statements from discrete logs over
generate_crs(GsRng(909)) and proofs from the GS formulas on the host, with
the draws commit_and_prove makes from the shared GsRng (see
test_torch_batch.py).
"""

import pytest

from groth_sahai_tpu_torch.ops.fp import FR
from groth_sahai_tpu_torch.models import batch as BT
from groth_sahai_tpu_torch.models import statement as ST
from groth_sahai_tpu_torch.models.crs import generate_crs
from groth_sahai_tpu_torch.utils.rng import GsRng

from .test_torch_batch import (DEV, Host, fr, host_proof,  # noqa: F401
                               one_thread_module)
from .test_torch_tower import one_thread  # noqa: F401


@pytest.fixture(scope="module")
def crs2():
    rng = GsRng(909)
    return Host(generate_crs(rng, device=DEV)), rng


def test_batch_msmeg1(crs2):
    host, rng = crs2
    equs, proofs = [], []
    for b in range(2):
        x, y_sc, a, b_sc, g = 2 + b, 4 + b, 29 + b, 31 + b, 5 + b
        t = x * b_sc + a * y_sc + x * y_sc * g
        equ = ST.MSMEG1(host.G1s([a]), fr([b_sc]),
                        fr([g]).reshape(FR.n, 1, 1), host.G1pt(t))
        equs.append(equ)
        proofs.append(host_proof(host, equ, [host.m1(a)], [b_sc], [[g]],
                                 [host.m1(x)], [y_sc], rng))
    assert BT.verify_batch(equs, proofs, host.crs).tolist() == [True, True]
    bad = ST.MSMEG1(equs[1].a_consts, equs[1].b_consts, equs[1].gamma,
                    host.G1pt(7))
    assert BT.verify_batch([equs[0], bad], proofs,
                           host.crs).tolist() == [True, False]


def test_batch_msmeg2_randomized(crs2):
    host, rng = crs2
    equs, proofs = [], []
    for b in range(2):
        x_sc, y, a_sc, bo, g = 2 + b, 4 + b, 37 + b, 41 + b, 3 + b
        t = bo * x_sc + y * a_sc + y * x_sc * g
        equ = ST.MSMEG2(fr([a_sc]), host.G2s([bo]),
                        fr([g]).reshape(FR.n, 1, 1), host.G2pt(t))
        equs.append(equ)
        proofs.append(host_proof(host, equ, [a_sc], [host.m2(bo)], [[g]],
                                 [x_sc], [host.m2(y)], rng))
    assert BT.verify_batch_randomized(equs, proofs, host.crs, GsRng(3))
    bad = ST.MSMEG2(equs[1].a_consts, equs[1].b_consts, equs[1].gamma,
                    host.G2pt(9))
    assert not BT.verify_batch_randomized([equs[0], bad], proofs, host.crs,
                                          GsRng(4))


def test_batch_quad(crs2):
    host, rng = crs2
    equs, proofs = [], []
    for b in range(2):
        x_sc, y_sc, a_sc, b_sc, g = 2 + b, 4 + b, 43 + b, 47 + b, 5 + b
        t = (b_sc * x_sc + a_sc * y_sc + g * x_sc * y_sc) % FR.p
        equ = ST.QuadEqu(fr([a_sc]), fr([b_sc]), fr([g]).reshape(FR.n, 1, 1),
                         fr([t])[:, 0])
        equs.append(equ)
        proofs.append(host_proof(host, equ, [a_sc], [b_sc], [[g]], [x_sc],
                                 [y_sc], rng))
    assert BT.verify_batch(equs, proofs, host.crs).tolist() == [True, True]
    # the JAX test's wrong target: the last equation's t + 1, in slot 0
    bad = ST.QuadEqu(equs[0].a_consts, equs[0].b_consts, equs[0].gamma,
                     fr([(t + 1) % FR.p])[:, 0])
    assert BT.verify_batch([bad, equs[1]], proofs,
                           host.crs).tolist() == [False, True]
