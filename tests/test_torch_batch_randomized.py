"""The port's randomized batch verifier on the batch3 cases of
tests/test_batch_verify.py: `verify_ppe_batch_randomized` (one rho per
equation from GsRng, the rho-weighted product, one final exponentiation
for the batch) holds on the good batch and fails with one tampered target.
Split from test_torch_batch.py so that each file stays near 90 s on one
CPU thread; the batch3 inputs are made the same way there.
"""

import pytest

from groth_sahai_tpu_torch.models import batch as BT
from groth_sahai_tpu_torch.utils.rng import GsRng

from .test_torch_batch import make_batch3, one_thread_module, with_target  # noqa: F401
from .test_torch_tower import one_thread  # noqa: F401


@pytest.fixture(scope="module")
def batch3():
    return make_batch3()


def test_randomized_all_good(batch3):
    host, equs, proofs, _ = batch3
    ok = BT.verify_ppe_batch_randomized(equs, proofs, host.crs, GsRng(1))
    assert ok is True


def test_randomized_one_bad(batch3):
    host, equs, proofs, wrong = batch3
    assert BT.verify_ppe_batch_randomized(
        [equs[0], equs[1], with_target(equs[2], wrong)], proofs, host.crs,
        GsRng(2)) is False
