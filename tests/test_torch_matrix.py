"""The port's Mat / B1 / B2 / BT parity API (groth_sahai_tpu_torch.models.matrix)
against the oracle and the JAX package.

The four cases of tests/test_protocol_api.py run on the port with the same
values and are held to the same answers of tests/oracle.py. The Fr matrix
functions and `com_transpose` are held limb for limb against the JAX
package's on the same numpy inputs (eager JAX calls: no curve or pairing
graph is compiled).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from groth_sahai_tpu.models import matrix as JM
from groth_sahai_tpu.ops.curve import G1 as JG1, G2 as JG2

from groth_sahai_tpu_torch.models import matrix as M
from groth_sahai_tpu_torch.models.crs import generate_crs
from groth_sahai_tpu_torch.models.prover import (append_commit1,
                                                 batch_commit_G1)
from groth_sahai_tpu_torch.ops.curve import (G1, G2, g1_affine_from_ints,
                                             g2_affine_from_ints)
from groth_sahai_tpu_torch.ops.fp import FR
from groth_sahai_tpu_torch.ops.limbs import ints_to_limbs, limbs_to_ints
from groth_sahai_tpu_torch.ops.tower import FQ12
from groth_sahai_tpu_torch.utils import hostcrypto as H
from groth_sahai_tpu_torch.utils.convert import to_numpy
from groth_sahai_tpu_torch.utils.rng import GsRng

from . import oracle as O
from .test_torch_tower import one_thread  # noqa: F401

DEV = "cpu"


def o_g1(pt):
    return None if pt is None else (pt[0].v, pt[1].v)


def o_g2(pt):
    if pt is None:
        return None
    return (tuple(c.v for c in pt[0].c), tuple(c.v for c in pt[1].c))


def dev_g1(pts):
    return g1_affine_from_ints([o_g1(p) for p in pts], device=DEV)


def dev_g2(pts):
    return g2_affine_from_ints([o_g2(p) for p in pts], device=DEV)


def dev_fr(vals):
    return torch.as_tensor(ints_to_limbs([v % FR.p for v in vals],
                                         FR.n).astype(np.int64))


def fr_mat(vals):
    """[[ints]] -> int64[17, I, J] std limbs."""
    I, J = len(vals), len(vals[0])
    return dev_fr([v for row in vals for v in row]).reshape(FR.n, I, J)


def mat_ints(std):
    arr = to_numpy(std)
    I, J = arr.shape[1], arr.shape[2]
    return [[limbs_to_ints(arr[:, i, j][:, None])[0] for j in range(J)]
            for i in range(I)]


def all_eq(curve, a, b):
    return bool(torch.all(curve.eq_affine(a, b)))


# ---------------------------------------------------------------------------
# the four cases of tests/test_protocol_api.py
# ---------------------------------------------------------------------------

def test_fr_matrix_ops():
    a = [[1, 2], [3, 4]]
    b = [[5, 6], [7, 8]]
    A, B = fr_mat(a), fr_mat(b)
    assert mat_ints(M.fr_mat_add(A, B)) == [[6, 8], [10, 12]]
    assert mat_ints(M.fr_mat_neg(A)) == [[FR.p - 1, FR.p - 2],
                                         [FR.p - 3, FR.p - 4]]
    s = dev_fr([3])[:, 0]
    assert mat_ints(M.fr_mat_scalar_mul(s, A)) == [[3, 6], [9, 12]]
    assert mat_ints(M.fr_mat_transpose(A)) == [[1, 3], [2, 4]]
    assert mat_ints(M.fr_mat_mul(A, B)) == [[19, 22], [43, 50]]
    v = dev_fr([9, 11])
    assert M.col_vec_to_vec(M.vec_to_col_vec(v)).shape == v.shape
    with pytest.raises(ValueError, match="column vector"):
        M.col_vec_to_vec(A)


def test_com_matrix_ops():
    g1o = O.G1_GEN
    pts = [O.g1_mul(g1o, k) for k in (1, 2, 3, 4)]
    com = tuple(l.reshape(l.shape[:-1] + (2, 2)) for l in dev_g1(pts))

    # entry-wise add / sub / neg roundtrip: (a + b) - b == a
    com_b = tuple(torch.flip(l, dims=(-1,)) for l in com)
    s = M.com_add(G1, com, com_b)
    assert all_eq(G1, M.com_sub(G1, s, com_b), com)
    assert all_eq(G1, M.com_add(G1, com, M.com_neg(G1, com)),
                  G1.inf_affine((2, 2), device=DEV))

    # com_sum over the column axis == adding the columns
    want = dev_g1([O.g1_add(pts[0], pts[1]), O.g1_add(pts[2], pts[3])])
    assert all_eq(G1, M.com_sum(G1, com, axis=1), want)

    # left_mul: [[2, 0], [1, 1]] x [g, 2g] == [2g, 3g]
    vec = dev_g1([O.g1_mul(g1o, 1), O.g1_mul(g1o, 2)])
    out = M.com_left_mul(G1, fr_mat([[2, 0], [1, 1]]), vec)
    assert all_eq(G1, out, dev_g1([O.g1_mul(g1o, 2), O.g1_mul(g1o, 3)]))

    # right_mul (I,K)x(K,J): com (1, 2) x fr (2, 1): [g, 2g] * [[3],[4]] = 11g
    row = lambda a: (a[0][:, None, :], a[1][:, None, :], a[2][None, :])
    out2 = M.com_right_mul(G1, row(vec), fr_mat([[3], [4]]))
    assert all_eq(G1, out2, row(dev_g1([O.g1_mul(g1o, 11)])))

    # scalar_mul: 5 * [g, 2g] == [5g, 10g]
    out3 = M.com_scalar_mul(G1, dev_fr([5])[:, 0], vec)
    assert all_eq(G1, out3, dev_g1([O.g1_mul(g1o, 5), O.g1_mul(g1o, 10)]))


def test_comt_group_laws():
    a = FQ12.from_ints([H.pairing_gen()], device=DEV)[:, :, 0]
    a = a[:, :, None, None].expand(a.shape + (2, 2))
    one = FQ12.one((2, 2), device=DEV)
    eq = lambda x, y: bool(torch.all(FQ12.eq(x, y)))
    # a + (-a) == 0  (GT: a * a^-1 == 1)
    assert eq(M.comt_add(a, M.comt_neg(a)), one)
    # 2 * a == a + a
    assert eq(M.comt_scalar_mul(dev_fr([2])[:, 0], a), M.comt_add(a, a))
    assert eq(M.comt_sum([a, a, M.comt_neg(a)]), a)
    assert eq(M.comt_sub(a, a), one)


def test_commit_append():
    rng = GsRng(77)
    crs = generate_crs(GsRng(2024), device=DEV)
    xs = dev_g1([O.g1_mul(O.G1_GEN, 2), O.g1_mul(O.G1_GEN, 3)])
    r_all = rng.fr_std((2, 2), device=DEV)
    c_all = batch_commit_G1(xs, crs, rand=r_all)

    x0 = tuple(l[..., :1] for l in xs)
    x1 = tuple(l[..., 1:] for l in xs)
    c0 = batch_commit_G1(x0, crs, rand=r_all[:, :1])
    c1 = batch_commit_G1(x1, crs, rand=r_all[:, 1:])
    joined = append_commit1(c0, c1)
    assert all_eq(G1, joined.coms, c_all.coms)
    assert torch.equal(joined.rand, c_all.rand)


# ---------------------------------------------------------------------------
# limb for limb against the JAX package
# ---------------------------------------------------------------------------

def rand_fr(gen, *shape):
    """numpy uint32[17, *shape] of canonical Fr values."""
    vals = [int.from_bytes(gen.bytes(40), "little") % FR.p
            for _ in range(int(np.prod(shape)))]
    return ints_to_limbs(vals, FR.n).reshape((FR.n,) + shape)


def same(port_out, jax_out):
    np.testing.assert_array_equal(to_numpy(port_out), np.asarray(jax_out))


@pytest.mark.parametrize("fn", ["add", "neg", "scalar_mul", "transpose",
                                "mul"])
def test_fr_matrices_match_jax(fn):
    gen = np.random.default_rng(16)
    a, b, s = rand_fr(gen, 3, 4), rand_fr(gen, 4, 2), rand_fr(gen, 1)[:, 0]
    b34 = rand_fr(gen, 3, 4)
    t = lambda x: torch.as_tensor(x.astype(np.int64))
    j = jnp.asarray
    if fn == "add":
        same(M.fr_mat_add(t(a), t(b34)), JM.fr_mat_add(j(a), j(b34)))
    elif fn == "neg":
        same(M.fr_mat_neg(t(a)), JM.fr_mat_neg(j(a)))
    elif fn == "scalar_mul":
        same(M.fr_mat_scalar_mul(t(s), t(a)), JM.fr_mat_scalar_mul(j(s), j(a)))
    elif fn == "transpose":
        same(M.fr_mat_transpose(t(a)), JM.fr_mat_transpose(j(a)))
    else:
        same(M.fr_mat_mul(t(a), t(b)), JM.fr_mat_mul(j(a), j(b)))


@pytest.mark.parametrize("curve", ["G1", "G2"])
def test_com_transpose_matches_jax(curve):
    """The same limbs as the JAX package's `com_transpose`, over both
    pairs of batch axes of a (2, 3, 4) Com batch."""
    gen = np.random.default_rng(17)
    lead = (25,) if curve == "G1" else (25, 2)
    x, y = (gen.integers(0, 1 << 16, size=lead + (2, 3, 4), dtype=np.uint32)
            for _ in range(2))
    inf = gen.integers(0, 2, size=(2, 3, 4)).astype(bool)
    port_curve, jax_curve = (G1, JG1) if curve == "G1" else (G2, JG2)
    port_in = (torch.as_tensor(x.astype(np.int64)),
               torch.as_tensor(y.astype(np.int64)), torch.as_tensor(inf))
    for ax in ((0, 1), (1, 2)):
        got = M.com_transpose(port_curve, port_in, *ax)
        want = JM.com_transpose(jax_curve, (jnp.asarray(x), jnp.asarray(y),
                                            jnp.asarray(inf)), *ax)
        for g, w in zip(got, want):
            same(g, w)


def test_comt_pairing_sum_against_host():
    """comt_pairing_sum entry [i, j] = e(G1, G2)^(sum_k a_ik b_jk) on the
    host; comt_pairing of one pair of elements likewise."""
    a, b = [[1, 2], [3, 4]], [[5, 6], [7, 8]]
    c1 = tuple(l.reshape(l.shape[:-1] + (2, 2)) for l in dev_g1(
        [O.g1_mul(O.G1_GEN, k) for row in a for k in row]))
    c2 = tuple(l.reshape(l.shape[:-1] + (2, 2)) for l in dev_g2(
        [O.g2_mul(O.G2_GEN, k) for row in b for k in row]))
    gt = H.pairing_gen()
    want = lambda e: [H.f12_pow(gt, e[i][j]) for i in range(2)
                      for j in range(2)]
    got = M.comt_pairing_sum(c1, c2)
    assert FQ12.to_ints(got.reshape(got.shape[:2] + (4,))) == want(
        [[sum(a[i][k] * b[j][k] for k in range(2)) for j in range(2)]
         for i in range(2)])
    elem = lambda c: tuple(l[..., 0] for l in c)
    got1 = M.comt_pairing(elem(c1), elem(c2))
    assert FQ12.to_ints(got1.reshape(got1.shape[:2] + (4,))) == want(
        [[a[i][0] * b[j][0] for j in range(2)] for i in range(2)])
