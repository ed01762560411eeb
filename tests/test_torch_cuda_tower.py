"""The port's fused tower kernels (groth_sahai_tpu_torch.ops.cuda_tower).

Their plain versions are held limb for limb against the in-kernel formulas
of the JAX package's Pallas tower kernels (`pallas_tower._f12_mul_red` and
`_cyc_sqr_body`, run eagerly on arrays: interpreting the whole Pallas
kernels takes minutes on XLA:CPU), and their values against the host
oracle. The kernels themselves are held against the plain versions on the
card (the `gpu` test here and `chip_smoke.py`). Inputs come from a numpy
seed; edge lanes sit at the top of each kernel's input bound.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from groth_sahai_tpu.ops import pallas_tower as PT
from groth_sahai_tpu.ops.fp import FQ as JFQ
from groth_sahai_tpu.ops.limbs import int_to_limbs as j_int_to_limbs

from groth_sahai_tpu_torch.ops import bls12_381 as C
from groth_sahai_tpu_torch.ops import cuda_tower as CT
from groth_sahai_tpu_torch.ops import tower as T
from groth_sahai_tpu_torch.ops.fp import FQ
from groth_sahai_tpu_torch.ops.limbs import int_to_limbs
from groth_sahai_tpu_torch.ops.tower import FQ12
from groth_sahai_tpu_torch.utils import hostcrypto as H
from groth_sahai_tpu_torch.utils.convert import limbs_from_numpy, to_numpy

from .test_torch_tower import one_thread, rand_coeffs  # noqa: F401

NL = FQ.n


def with_edges(x, values):
    """Lanes 0.. of an Fq12 batch set to all-coefficient constants."""
    x = x.copy()
    for lane, v in enumerate(values):
        x[:, :, lane] = np.asarray(int_to_limbs(v, NL))[:, None]
    return x


def jax_rows(x, lanes):
    """numpy (25, 12, lanes) -> the Pallas bodies' nested Fq12 row lists."""
    def coeff(m):
        return [jnp.asarray(x[i, m]) for i in range(NL)]
    return tuple(tuple((coeff(6 * i + 2 * j), coeff(6 * i + 2 * j + 1))
                       for j in range(3)) for i in range(2))


def from_jax_rows(c):
    return np.stack([np.stack([np.asarray(r) for r in c[i][j][u]], 0)
                     for i in range(2) for j in range(3) for u in range(2)], 1)


def jax_consts(lanes):
    row = lambda v: [jnp.full((lanes,), int(w), jnp.uint32)
                     for w in j_int_to_limbs(v, NL)]
    return row(JFQ.p), row(JFQ.r_mod_p)


def test_fq12_mul_plain_matches_pallas_body():
    """a*b post-reduced, at the kernel's input bound (1024 p^2) and below."""
    top = 32 * C.P - 1
    a = with_edges(rand_coeffs(31, 12, 4, bound=32 * C.P), [top, 0, C.P - 1])
    b = with_edges(rand_coeffs(32, 12, 4, bound=32 * C.P), [top, top, 1])
    p, one = jax_consts(4)
    want = from_jax_rows(PT._f12_mul_red(NL, JFQ.n0, p, one,
                                         jax_rows(a, 4), jax_rows(b, 4)))
    at = limbs_from_numpy(a, device="cpu")
    got = CT.fq12_mul(at, limbs_from_numpy(b, device="cpu"))
    np.testing.assert_array_equal(to_numpy(got), want)
    assert torch.equal(CT.fq12_sqr(at), CT.fq12_mul(at, at))


def test_cyc_sqr_plain_matches_pallas_body():
    """The cyclotomic square of cyc_pow's loop, inputs < 2p."""
    a = with_edges(rand_coeffs(33, 12, 3, bound=2 * C.P), [2 * C.P - 1, 0])
    p, one = jax_consts(3)
    want = from_jax_rows(PT._cyc_sqr_body(NL, JFQ.n0, p, one,
                                          jax_rows(a, 3)))
    got = CT.cyc_sqr_plain(limbs_from_numpy(a, device="cpu"))
    np.testing.assert_array_equal(to_numpy(got), want)


@pytest.mark.parametrize("e", [abs(C.X), (abs(C.X) + 1) // 3,
                               abs(C.X) + 1, 5])
def test_cyc_pow_matches_host(e):
    """a^e on GT elements for the final exponentiation's exponents."""
    g = H.pairing_gen()
    vals = [H.f12_pow(g, 3), H.f12_pow(g, 1 << 40)]
    got = CT.cyc_pow(FQ12.from_ints(vals, device="cpu"), e)
    assert FQ12.to_ints(got) == [H.f12_pow(v, e) for v in vals]


def test_fused_dispatch_follows_the_reference_cap():
    """Fused kernels at <= 4096 lanes: the signed product's tree reduction
    from (2, 2, 1024) down and its final exp on (2, 2); lazy above."""
    shape = lambda *b: torch.empty((NL, 12) + b, device="meta")
    assert T._fused(shape(2, 2, 1024)) and T._fused(shape(2, 2))
    assert T._fused(shape(4096))
    assert not T._fused(shape(2, 2, 2048)) and not T._fused(shape(8192))
    assert not T._fused(shape(4), shape(4097))


def test_tower_wrappers_never_fall_back():
    """A non-CPU tensor goes to the kernel path, which takes only CUDA."""
    a = torch.zeros((NL, 12, 2), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        CT.fq12_mul(a, a)
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        CT.cyc_pow(a, 5)


@pytest.mark.gpu
@pytest.mark.parametrize("lanes", [70, 3])
def test_tower_kernels_match_plain_on_card(lanes):
    """fq12_mul and cyc_pow against their plain versions; 3 lanes leave
    most of cyc_pow's block of lane groups idle."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels are CUDA C++ for sm_90a")
    top = 32 * C.P - 1
    a = limbs_from_numpy(with_edges(rand_coeffs(34, 12, lanes,
                                                bound=32 * C.P),
                                    [top, 0]), device="cuda")
    b = limbs_from_numpy(with_edges(rand_coeffs(35, 12, lanes,
                                                bound=32 * C.P),
                                    [top, top]), device="cuda")
    c = limbs_from_numpy(with_edges(rand_coeffs(36, 12, lanes,
                                                bound=2 * C.P),
                                    [2 * C.P - 1]), device="cuda")
    for kern, args in ((CT.fq12_mul, (a, b)), (CT.cyc_pow, (c, abs(C.X)))):
        before = kern.launches
        got = kern(*args)
        want = CT.PLAIN[kern](*args)
        torch.cuda.synchronize()
        assert kern.launches == before + 1
        assert torch.equal(got, want), kern.__name__
