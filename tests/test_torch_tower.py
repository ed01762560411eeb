"""The port's Fq2/Fq6/Fq12 tower against the JAX package's.

On the CPU the JAX tower takes its non-Pallas branch: the lazy formulas
that both packages run above 4096 lanes. The port's `FQ12.mul`, `sqr`,
`cyclotomic_sqr` and `cyclotomic_pow` take its fused kernels (their plain
versions on the CPU) at these small batches, as the reference does on its
TPU, so each of those tests runs the port twice: with `FUSED_MAX_LANES` set to 0, the lazy
branch must agree with the JAX package in every limb; as shipped, the
fused branch must give the same values (exact equality after reduction to
[0, p): the fused kernels leave another redundant form). Inputs are made
from a numpy seed and passed to both packages as numpy limb arrays.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from groth_sahai_tpu.ops.tower import FQ2 as JFQ2, FQ6 as JFQ6, FQ12 as JFQ12

from groth_sahai_tpu_torch.ops import bls12_381 as C
from groth_sahai_tpu_torch.ops import tower as T
from groth_sahai_tpu_torch.ops.fp import FQ
from groth_sahai_tpu_torch.ops.limbs import ints_to_limbs
from groth_sahai_tpu_torch.ops.tower import FQ2, FQ6, FQ12
from groth_sahai_tpu_torch.utils import hostcrypto as H
from groth_sahai_tpu_torch.utils.convert import limbs_from_numpy, to_numpy


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread (autouse here and where it is imported): these
    tensors are a few lanes wide, and many threads make each small op
    several times slower."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def rand_coeffs(seed, dim, lanes, bound=C.P):
    """numpy uint32[25, dim, lanes] of values < bound (Montgomery forms)."""
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 32, size=(dim * lanes, 14), dtype=np.uint64)
    vals = [sum(int(w) << (32 * i) for i, w in enumerate(r)) % bound
            for r in words]
    return ints_to_limbs(vals, FQ.n).reshape(FQ.n, dim, lanes)


def cyclotomic_elems(count):
    """Elements of GT (cyclotomic): powers of e(G1, G2), as numpy limbs."""
    e0 = H.pairing_gen()
    vals = [H.f12_pow(e0, 7 ** k + 3) for k in range(count)]
    flat = [c for v in vals for six in v for pr in six for c in pr]
    mont = [(c * FQ.r_mod_p) % C.P for c in flat]
    return ints_to_limbs(mont, FQ.n).reshape(FQ.n, count, 12).transpose(0, 2, 1)


def same(port_out, jax_out):
    np.testing.assert_array_equal(to_numpy(port_out), np.asarray(jax_out))


def same_values(port_out, jax_out):
    """Equal as Fq12 values: every coefficient reduced to [0, p)."""
    assert FQ12.to_ints(port_out) == FQ12.to_ints(
        limbs_from_numpy(np.asarray(jax_out), device="cpu"))


def both(x):
    return limbs_from_numpy(x, device="cpu"), jnp.asarray(x)


@pytest.mark.parametrize("op", ["mul", "sqr", "inv", "conj"])
def test_fq2_matches_jax(op):
    a, ja = both(rand_coeffs(11, 2, 4, bound=8 * C.P))
    b, jb = both(rand_coeffs(12, 2, 4, bound=8 * C.P))
    if op == "mul":
        same(FQ2.mul(a, b), jax.jit(JFQ2.mul)(ja, jb))
    elif op == "sqr":
        same(FQ2.sqr(a), jax.jit(JFQ2.sqr)(ja))
    elif op == "inv":
        same(FQ2.inv(a), jax.jit(JFQ2.inv)(ja))
    else:
        same(FQ2.conj(a), jax.jit(JFQ2.conj)(ja))


def test_fq6_mul_inv_match_jax():
    a, ja = both(rand_coeffs(13, 6, 3, bound=4 * C.P))
    b, jb = both(rand_coeffs(14, 6, 3, bound=4 * C.P))
    same(FQ6.mul(a, b), jax.jit(JFQ6.mul)(ja, jb))
    same(FQ6.inv(a), jax.jit(JFQ6.inv)(ja))


@pytest.mark.parametrize("op", ["mul", "sqr", "conj"])
def test_fq12_product_ops_match_jax(op, monkeypatch):
    a, ja = both(rand_coeffs(15, 12, 3, bound=2 * C.P))
    b, jb = both(rand_coeffs(16, 12, 3, bound=2 * C.P))
    if op == "conj":
        same(FQ12.conj(a), jax.jit(JFQ12.conj)(ja))
        return
    if op == "mul":
        port, want = lambda: FQ12.mul(a, b), jax.jit(JFQ12.mul)(ja, jb)
    else:
        port, want = lambda: FQ12.sqr(a), jax.jit(JFQ12.sqr)(ja)
    same_values(port(), want)                      # fused kernel
    monkeypatch.setattr(T, "FUSED_MAX_LANES", 0)
    same(port(), want)                             # lazy branch, every limb


def test_fq12_inv_matches_jax():
    a, ja = both(rand_coeffs(17, 12, 2))
    inv = FQ12.inv(a)
    same(inv, jax.jit(JFQ12.inv)(ja))
    one = FQ12.one((2,), device="cpu")
    assert bool(FQ12.eq(FQ12.mul(a, inv), one).all())


@pytest.mark.parametrize("power", [1, 2])
def test_fq12_frobenius_matches_jax(power):
    a, ja = both(rand_coeffs(18, 12, 3))
    same(FQ12.frobenius(a, power),
         jax.jit(lambda x: JFQ12.frobenius(x, power))(ja))


def test_cyclotomic_sqr_matches_jax(monkeypatch):
    a, ja = both(cyclotomic_elems(3))
    want = jax.jit(JFQ12.cyclotomic_sqr)(ja)
    fused = FQ12.cyclotomic_sqr(a)                  # fused kernel
    same_values(fused, want)
    # and it is a squaring
    assert FQ12.to_ints(fused) == FQ12.to_ints(FQ12.sqr(a))
    monkeypatch.setattr(T, "FUSED_MAX_LANES", 0)
    lazy = FQ12.cyclotomic_sqr(a)                   # lazy branch
    same(lazy, want)
    assert FQ12.to_ints(lazy) == FQ12.to_ints(FQ12.sqr(a))


def test_cyclotomic_sqr_fused_chain_is_squaring():
    """The fused square's output (< 2p) is its own valid input: four
    squarings in a row give a^16 on GT elements, against the host."""
    a, _ = both(cyclotomic_elems(2))
    x = a
    for _ in range(4):
        x = FQ12.cyclotomic_sqr(x)
    assert FQ12.to_ints(x) == [H.f12_pow(v, 16) for v in FQ12.to_ints(a)]


def test_cyclotomic_pow_x_matches_jax(monkeypatch):
    a, ja = both(cyclotomic_elems(2))
    jax_out = jax.jit(lambda x: JFQ12.cyclotomic_pow(x, abs(C.X)))(ja)
    want = [H.f12_pow(v, abs(C.X)) for v in FQ12.to_ints(a)]
    fused = FQ12.cyclotomic_pow(a, abs(C.X))        # fused kernel
    same_values(fused, jax_out)
    same(FQ12.pow_x(a), FQ12.conj(fused))
    assert FQ12.to_ints(fused) == want
    monkeypatch.setattr(T, "FUSED_MAX_LANES", 0)
    got = FQ12.cyclotomic_pow(a, abs(C.X))          # lazy branch
    same(got, jax_out)
    same(FQ12.pow_x(a), FQ12.conj(got))
    assert FQ12.to_ints(got) == want


def test_tower_io_matches_jax():
    vals = [H.pairing_gen(), H.f12_pow(H.pairing_gen(), 5)]
    t = FQ12.from_ints(vals, device="cpu")
    same(t, JFQ12.from_ints(vals))
    assert FQ12.to_ints(t) == vals
    same(FQ12.one((2,), device="cpu"), JFQ12.one((2,)))
    pairs = [(1, 2), (C.P - 1, 7)]
    same(FQ2.from_ints(pairs, device="cpu"), JFQ2.from_ints(pairs))
    assert FQ2.to_ints(FQ2.from_ints(pairs, device="cpu")) == pairs
