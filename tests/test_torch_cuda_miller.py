"""The port's Miller-iteration, Miller-step and dynamic-power kernels
(groth_sahai_tpu_torch.ops.cuda_tower: miller_iter_dbl, miller_iter_add,
miller_dbl_step, miller_add_step, cyc_sqr, f12_pow_dyn).

Their plain versions are held limb for limb against the in-kernel bodies of
the JAX package's Pallas kernels (`pallas_tower._dbl_step_body`,
`_add_step_body`, `_f2_mul_fq`, `_f12_sqr_red`, `_sparse_line_mul`,
`_f12_mul_red`, `_f12_select`), run eagerly on row lists: interpreting the
whole Pallas kernels takes minutes on XLA:CPU, and one eager Montgomery
product takes about 0.1 s, so each kernel's composition is checked in
parts that chain: the point step and its line, the square, and the sparse
product of the plain square with the plain line. Values are held against
the host oracle. The kernels themselves are held against the plain
versions on the card (the `gpu` tests here and `chip_smoke.py`). Inputs
come from a numpy seed; edge lanes sit at the top of each input's bound,
and one lane has P = Q = (0, 0), the padding point.
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
from groth_sahai_tpu_torch.ops.fp import FR
from groth_sahai_tpu_torch.ops.limbs import ints_to_limbs
from groth_sahai_tpu_torch.ops.tower import FQ12
from groth_sahai_tpu_torch.utils import hostcrypto as H
from groth_sahai_tpu_torch.utils.convert import limbs_from_numpy, to_numpy

from .test_torch_cuda_tower import (NL, from_jax_rows, jax_consts, jax_rows,
                                    with_edges)
from .test_torch_tower import one_thread, rand_coeffs  # noqa: F401

LANES = 3


def fq2_in(seed, bound, top):
    """numpy (25, 2, LANES) < bound; lane 0 at top, lane 1 zero."""
    return with_edges(rand_coeffs(seed, 2, LANES, bound=bound), [top, 0])


def fq_in(seed):
    """numpy (25, LANES) < p; lane 0 at p - 1, lane 1 zero."""
    return with_edges(rand_coeffs(seed, 1, LANES), [C.P - 1, 0])[:, 0]


def iteration_inputs(seed):
    """f < 2p; R = (X, Y, Z) with X, Z < 2p, Y < 10p; Q, P affine < p."""
    f = with_edges(rand_coeffs(seed, 12, LANES, bound=2 * C.P),
                   [2 * C.P - 1, 2 * C.P - 1])
    R = (fq2_in(seed + 1, 2 * C.P, 2 * C.P - 1),
         fq2_in(seed + 2, 10 * C.P, 10 * C.P - 1),
         fq2_in(seed + 3, 2 * C.P, 2 * C.P - 1))
    Q = (fq2_in(seed + 4, C.P, C.P - 1), fq2_in(seed + 5, C.P, C.P - 1))
    return f, R, Q, fq_in(seed + 6), fq_in(seed + 7)


def t(x):
    return limbs_from_numpy(x, device="cpu")


def j2(x):
    """numpy Fq2 (25, 2, L) -> the Pallas bodies' (c0 rows, c1 rows)."""
    return tuple([jnp.asarray(x[i, u]) for i in range(NL)] for u in range(2))


def j1(x):
    return [jnp.asarray(x[i]) for i in range(NL)]


def from_j2(c):
    return np.stack([np.stack([np.asarray(r) for r in c[u]], 0)
                     for u in range(2)], 1)


def consts():
    p, one = jax_consts(LANES)
    tinv = [jnp.full((LANES,), int(w), jnp.uint32)
            for w in j_int_to_limbs(CT.TWO_INV_MONT, NL)]
    return p, one, tinv


def same(port, want):
    np.testing.assert_array_equal(to_numpy(port), want)


def test_two_inv_is_the_reference_constant():
    """The doubling step's 1/2, in the Montgomery form the reference's
    miller_iter_dbl builds from two_inv_int."""
    assert CT.TWO_INV_MONT == ((C.P + 1) // 2) * JFQ.r_mod_p % C.P
    assert 2 * CT.TWO_INV_MONT % C.P == JFQ.r_mod_p


@pytest.mark.parametrize("part", ["step", "square", "line"])
def test_miller_iter_dbl_plain_matches_pallas_bodies(part):
    """(f^2 line_{R,R}(P), 2R) as _miller_iter_dbl_kernel composes it:
    _dbl_step_body then _f2_mul_fq on the line (part "step"), _f12_sqr_red
    ("square"), and _sparse_line_mul of the square with that line
    ("line")."""
    f, R, _, px, py = iteration_inputs(40)
    p, one, tinv = consts()
    got_f, got_R = CT.miller_iter_dbl_plain(t(f), tuple(map(t, R)), t(px),
                                            t(py))
    R3, (l0, l1, l2) = CT._dbl_step_plain(*map(t, R), CT._tinv("cpu"))
    lb, lc = CT._line_scale(l1, l2, t(px), t(py))
    if part == "step":
        (jX, jY, jZ), (jl0, jl1, jl2) = PT._dbl_step_body(
            NL, JFQ.n0, p, one, *map(j2, R), tinv)
        want = [jX, jY, jZ, jl0,
                PT._f2_mul_fq(NL, JFQ.n0, p, j1(px), jl1),
                PT._f2_mul_fq(NL, JFQ.n0, p, j1(py), jl2)]
        for g, w in zip(list(got_R) + [l0, lb, lc], want):
            same(g, from_j2(w))
        for g, w in zip(R3, got_R):
            assert torch.equal(g, w)
    elif part == "square":
        same(CT.fq12_mul_plain(t(f), t(f)),
             from_jax_rows(PT._f12_sqr_red(NL, JFQ.n0, p, one,
                                           jax_rows(f, LANES))))
    else:
        fsq = to_numpy(CT.fq12_mul_plain(t(f), t(f)))
        want = PT._sparse_line_mul(
            NL, JFQ.n0, p, one, jax_rows(fsq, LANES),
            *(j2(to_numpy(x)) for x in (l0, lb, lc)))
        same(got_f, from_jax_rows(want))


@pytest.mark.parametrize("part", ["step", "line"])
def test_miller_iter_add_plain_matches_pallas_bodies(part):
    """(f line_{R,Q}(P), R + Q) as _miller_iter_add_kernel composes it:
    _add_step_body then _f2_mul_fq on the line ("step"), and
    _sparse_line_mul of f with that line ("line")."""
    f, R, Q, px, py = iteration_inputs(50)
    p, one, _ = consts()
    got_f, got_R = CT.miller_iter_add_plain(t(f), tuple(map(t, R)),
                                            tuple(map(t, Q)), t(px), t(py))
    _, (l0, l1, l2) = CT._add_step_plain(*map(t, R), *map(t, Q))
    lb, lc = CT._line_scale(l1, l2, t(px), t(py))
    if part == "step":
        (jX, jY, jZ), (jl0, jl1, jl2) = PT._add_step_body(
            NL, JFQ.n0, p, one, *map(j2, R), *map(j2, Q))
        want = [jX, jY, jZ, jl0,
                PT._f2_mul_fq(NL, JFQ.n0, p, j1(px), jl1),
                PT._f2_mul_fq(NL, JFQ.n0, p, j1(py), jl2)]
        for g, w in zip(list(got_R) + [l0, lb, lc], want):
            same(g, from_j2(w))
    else:
        want = PT._sparse_line_mul(
            NL, JFQ.n0, p, one, jax_rows(f, LANES),
            *(j2(to_numpy(x)) for x in (l0, lb, lc)))
        same(got_f, from_jax_rows(want))


@pytest.mark.parametrize("part", ["square", "multiply_select"])
def test_f12_pow_dyn_round_matches_pallas_bodies(part):
    """One round of _f12_pow_dyn_kernel: acc <- _f12_sqr_red(acc)
    ("square"), then _f12_select(bit, _f12_mul_red(acc, a), acc)
    ("multiply_select", on the plain square) -- lanes with bit 1, 0, 1."""
    acc = with_edges(rand_coeffs(60, 12, LANES, bound=2 * C.P),
                     [2 * C.P - 1])
    a = with_edges(rand_coeffs(61, 12, LANES, bound=2 * C.P),
                   [2 * C.P - 1])
    bit = torch.tensor([True, False, True])
    p, one, _ = consts()
    sq = CT.fq12_mul_plain(t(acc), t(acc))
    if part == "square":
        same(sq, from_jax_rows(PT._f12_sqr_red(NL, JFQ.n0, p, one,
                                               jax_rows(acc, LANES))))
    else:
        jsq = jax_rows(to_numpy(sq), LANES)
        am = PT._f12_mul_red(NL, JFQ.n0, p, one, jsq, jax_rows(a, LANES))
        want = PT._f12_select(jnp.asarray(bit.numpy()), am, jsq)
        same(CT.f12_pow_dyn_round(t(acc), t(a), bit), from_jax_rows(want))


def test_f12_pow_dyn_plain_matches_host():
    """a^s on a non-cyclotomic base (Miller outputs, as the batch
    verifier's ratios are) for s = 0, r - 1 and a random 255-bit scalar;
    the scalar broadcasts over the batch, as at batch.py:206."""
    g1 = (C.G1_GEN_X, C.G1_GEN_Y)
    g2 = (C.G2_GEN_X, C.G2_GEN_Y)
    base = [H.miller_loop(H.g1_mul(g1, k), g2) for k in (1, 2, 3)]
    rho = int(np.random.default_rng(62).integers(1, 1 << 62)) << 193 | 12345
    scal = [0, C.R - 1, rho % C.R]
    a = FQ12.from_ints(base, device="cpu")
    s = limbs_from_numpy(ints_to_limbs(scal, FR.n), device="cpu")
    got = FQ12.to_ints(CT.f12_pow_dyn(a, s))
    assert got == [H.f12_pow(b, e) for b, e in zip(base, scal)]
    assert got[0] == H.F12_ONE
    two = CT.f12_pow_dyn(a[:, :, :2].reshape(NL, 12, 2, 1),
                         s[:, 2:3].reshape(FR.n, 1, 1))   # broadcast scalar
    assert FQ12.to_ints(two.reshape(NL, 12, 2)) == [
        H.f12_pow(b, scal[2]) for b in base[:2]]


def test_new_wrappers_never_fall_back():
    """A non-CPU tensor goes to the kernel path, which takes only CUDA."""
    z = lambda *s: torch.zeros((NL,) + s, dtype=torch.int64, device="meta")
    R = (z(2, 2), z(2, 2), z(2, 2))
    for call in (lambda: CT.cyc_sqr(z(12, 2)),
                 lambda: CT.miller_iter_dbl(z(12, 2), R, z(2), z(2)),
                 lambda: CT.miller_iter_add(z(12, 2), R, R[:2], z(2), z(2)),
                 lambda: CT.f12_pow_dyn(z(12, 2), z(2)[:FR.n]),
                 lambda: CT.miller_dbl_step(R, (C.P + 1) // 2),
                 lambda: CT.miller_add_step(R, R[:2])):
        with pytest.raises(ValueError, match="expected a CUDA tensor"):
            call()


def card_inputs(lanes):
    f = with_edges(rand_coeffs(70, 12, lanes, bound=2 * C.P),
                   [2 * C.P - 1, 2 * C.P - 1])
    X = with_edges(rand_coeffs(71, 2, lanes, bound=2 * C.P), [2 * C.P - 1, 0])
    Y = with_edges(rand_coeffs(72, 2, lanes, bound=10 * C.P),
                   [10 * C.P - 1, 0])
    Z = with_edges(rand_coeffs(73, 2, lanes, bound=2 * C.P), [2 * C.P - 1, 0])
    Q = [with_edges(rand_coeffs(74 + k, 2, lanes), [C.P - 1, 0])
         for k in range(2)]
    P = [with_edges(rand_coeffs(76 + k, 1, lanes), [C.P - 1, 0])[:, 0]
         for k in range(2)]
    s = ints_to_limbs([0, C.R - 1, (1 << 272) - 1]
                      + [(7 ** k) % C.R for k in range(lanes - 3)], FR.n)
    cuda = lambda x: limbs_from_numpy(x, device="cuda")
    return (cuda(f), tuple(map(cuda, (X, Y, Z))), tuple(map(cuda, Q)),
            tuple(map(cuda, P)), cuda(s))


@pytest.mark.gpu
@pytest.mark.parametrize("lanes", [70, 1003])
@pytest.mark.parametrize("name", ["cyc_sqr", "miller_iter_dbl",
                                  "miller_iter_add", "f12_pow_dyn",
                                  "miller_dbl_step", "miller_add_step"])
def test_miller_kernels_match_plain_on_card(name, lanes):
    """Each kernel against its plain version; 1003 lanes end in a ragged
    block of lane groups (8 lanes a block in every grouped kernel)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels are CUDA C++ for sm_90a")
    f, R, Q, P, s = card_inputs(lanes)
    kern = getattr(CT, name)
    args = {"cyc_sqr": (f,), "miller_iter_dbl": (f, R, *P),
            "miller_iter_add": (f, R, Q, *P), "f12_pow_dyn": (f, s),
            "miller_dbl_step": (R, (C.P + 1) // 2),
            "miller_add_step": (R, Q)}[name]
    before = kern.launches
    got = kern(*args)
    want = CT.PLAIN[kern](*args)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    flat = lambda x: [x] if torch.is_tensor(x) else [
        y for z in x for y in flat(z)]
    for g, w in zip(flat(got), flat(want)):
        assert torch.equal(g, w), name
