"""The port's Groth-Sahai layer (groth_sahai_tpu_torch.models: crs,
statement, prover, verifier; utils.rng, utils.convert) against the JAX
package and the host.

`GsRng` and `generate_crs` are held element for element against the JAX
package's (Philox on the host; the CRS converted with `crs_from_numpy`).
The four end-to-end scenarios of tests/test_gs_e2e.py run on the JAX
package's CRS and statements, converted with `crs_from_numpy` and
`statement_from_numpy`: the commitments and the proof (pi, theta) are held
against the GS formulas computed on the host with the same GsRng draws,
each proof verifies, and a wrong target fails. The JAX package's prover is
not run (its jitted scalar multiplication takes minutes to compile on
XLA:CPU); the host formulas stand for it.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from groth_sahai_tpu.models import crs as JCRS
from groth_sahai_tpu.models import prover as JPV
from groth_sahai_tpu.models import statement as JST
from groth_sahai_tpu.ops.curve import (g1_affine_from_ints as j_g1,
                                       g2_affine_from_ints as j_g2)
from groth_sahai_tpu.ops.fp import FR as JFR
from groth_sahai_tpu.ops.limbs import ints_to_limbs as j_ints_to_limbs
from groth_sahai_tpu.ops.tower import FQ12 as JFQ12
from groth_sahai_tpu.utils.rng import GsRng as JGsRng

from groth_sahai_tpu_torch.ops import bls12_381 as C
from groth_sahai_tpu_torch.ops.curve import g1_affine_to_ints, g2_affine_to_ints
from groth_sahai_tpu_torch.ops.tower import FQ12
from groth_sahai_tpu_torch.models import prover as PV
from groth_sahai_tpu_torch.models import statement as ST
from groth_sahai_tpu_torch.models.crs import generate_crs
from groth_sahai_tpu_torch.models.verifier import verify
from groth_sahai_tpu_torch.utils import hostcrypto as H
from groth_sahai_tpu_torch.utils.convert import (affine_from_numpy,
                                                 commit_from_numpy,
                                                 crs_from_numpy,
                                                 limbs_from_numpy,
                                                 proof_from_numpy,
                                                 statement_from_numpy,
                                                 to_numpy)
from groth_sahai_tpu_torch.utils.rng import GsRng

from .test_torch_tower import one_thread  # noqa: F401

R = C.R


def leaves(x):
    if torch.is_tensor(x):
        return [x]
    if dataclasses.is_dataclass(x):
        return [y for f in dataclasses.fields(x)
                for y in leaves(getattr(x, f.name))]
    if isinstance(x, (tuple, list)):
        return [y for z in x for y in leaves(z)]
    return []


def same_tensors(a, b):
    la, lb = leaves(a), leaves(b)
    assert len(la) == len(lb) > 0
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


# ---------------------------------------------------------- GsRng and CRS

def test_gsrng_draws_match_jax():
    a, b = GsRng(7), JGsRng(7)
    assert a.fr_ints(5) == b.fr_ints(5)
    np.testing.assert_array_equal(to_numpy(a.fr_std((3, 2), device="cpu")),
                                  np.asarray(b.fr_std((3, 2))))
    np.testing.assert_array_equal(to_numpy(a.fr_std(4, device="cpu")),
                                  np.asarray(b.fr_std(4)))
    np.testing.assert_array_equal(
        to_numpy(a.fr_mont((2,), device="cpu")),
        np.asarray(jax.jit(JFR.to_mont)(b.fr_std((2,)))))


@pytest.mark.parametrize("hiding", [False, True])
def test_generate_crs_matches_jax(hiding):
    got = generate_crs(GsRng(11), hiding=hiding, device="cpu")
    want = crs_from_numpy(JCRS.generate_crs(JGsRng(11), hiding=hiding),
                          device="cpu")
    same_tensors(got, want)


def test_commit_and_proof_converters():
    """commit_from_numpy and proof_from_numpy carry every array across (a
    G1 and a G2 commitment, told apart by rank) with the widths and the
    equation type."""
    rng = np.random.default_rng(3)
    limbs = lambda *shape: rng.integers(0, 1 << 16, size=shape,
                                        dtype=np.uint32)
    flags = lambda *shape: rng.integers(0, 2, size=shape).astype(bool)
    c1 = JPV.Commit1(coms=(limbs(25, 2, 3), limbs(25, 2, 3), flags(2, 3)),
                     rand=limbs(17, 3, 2), row_widths=(2, 1, 2))
    c2 = JPV.Commit2(coms=(limbs(25, 2, 2, 1), limbs(25, 2, 2, 1),
                           flags(2, 1)), rand=limbs(17, 1, 1))
    ep = JPV.EquProof(pi=(limbs(25, 2, 2, 2), limbs(25, 2, 2, 2),
                          flags(2, 2)),
                      theta=(limbs(25, 2, 1), limbs(25, 2, 1), flags(2, 1)),
                      equ_type=JST.EquType.MultiScalarG1)
    got = proof_from_numpy(JPV.CProof(xcoms=c1, ycoms=c2, equ_proofs=[ep]),
                           device="cpu")
    assert isinstance(got.xcoms, PV.Commit1)
    assert isinstance(got.ycoms, PV.Commit2)
    assert got.xcoms.row_widths == (2, 1, 2) and got.ycoms.row_widths is None
    assert got.equ_proofs[0].equ_type == ST.EquType.MultiScalarG1
    for g, w in zip(leaves(got), [*c1.coms, c1.rand, *c2.coms, c2.rand,
                                  *ep.pi, *ep.theta]):
        np.testing.assert_array_equal(to_numpy(g), w)
    assert isinstance(commit_from_numpy(c2, device="cpu"), PV.Commit2)


# ------------------------------------------------- host GS formulas

def host_pt(curve_name, aff):
    """A port affine batch -> host points (flat, row-major)."""
    return (g2_affine_to_ints if curve_name == "G2" else g1_affine_to_ints)(
        aff)


def host_com_vec(curve_name, aff):
    """A Com vector (2, k) -> [(c0, c1)] * k."""
    pts = host_pt(curve_name, aff)
    k = len(pts) // 2
    return [(pts[j], pts[k + j]) for j in range(k)]


class HostCom:
    """Com arithmetic on host points: sums of scalar multiples."""

    def __init__(self, curve_name):
        g2 = curve_name == "G2"
        self.mul = H.g2_mul if g2 else H.g1_mul
        self.add = H.g2_add if g2 else H.g1_add

    def lin(self, coeffs, coms):
        out = (None, None)
        for k, c in zip(coeffs, coms):
            out = tuple(self.add(o, self.mul(x, k % R))
                        for o, x in zip(out, c))
        return out


def matmul(a, b):
    return [[sum(a[i][k] * b[k][j] for k in range(len(b))) % R
             for j in range(len(b[0]))] for i in range(len(a))]


def transpose(a):
    return [list(r) for r in zip(*a)]


def draws(rng, rows, cols):
    v = rng.fr_ints(rows * cols)
    return [v[i * cols:(i + 1) * cols] for i in range(rows)]


# --------------------------------------------------------- end to end

@pytest.fixture(scope="module")
def jax_crs():
    return JCRS.generate_crs(JGsRng(2024))


def jax_fr(vals):
    return jnp.asarray(j_ints_to_limbs([v % JFR.p for v in vals], JFR.n))


def scenario(name, g1, g2, gt):
    """The JAX package's statement (with target t and t + 1 as the wrong
    one), the variables, and the host's view: (statement, wrong statement,
    X, Y, host A, host B, host X, host Y) with group values as points over
    the CRS generators g1 = p1, g2 = p2 and scalars as ints."""
    m1 = lambda k: None if k is None else H.g1_mul(g1, k)
    m2 = lambda k: None if k is None else H.g2_mul(g2, k)
    G1 = lambda ks: j_g1([m1(k) for k in ks])
    G2 = lambda ks: j_g2([m2(k) for k in ks])
    gamma = jax_fr([5, 0]).reshape(JFR.n, 2, 1)
    if name == "PPE":
        t = 3 * 23 + 17 * 4 + 2 * 4 * 5              # e(p1, p2) exponents
        make = lambda e: JST.PPE(G1([17]), G2([None, 23]), gamma,
                                 JFQ12.from_ints([H.f12_pow(gt, e)])[:, :, 0])
        return (make(t), make(t + 1), G1([2, 3]), G2([4]),
                [m1(17)], [None, m2(23)], [m1(2), m1(3)], [m2(4)])
    if name == "MSMEG1":
        t = 3 * 31 + 29 * 4 + 2 * 4 * 5
        make = lambda e: JST.MSMEG1(G1([29]), jax_fr([0, 31]), gamma,
                                    tuple(c[..., 0] for c in G1([e])))
        return (make(t), make(t + 1), G1([2, 3]), jax_fr([4]),
                [m1(29)], [0, 31], [m1(2), m1(3)], [4])
    if name == "MSMEG2":
        t = 3 * 41 + 37 * 4 + 2 * 4 * 5
        make = lambda e: JST.MSMEG2(jax_fr([37]), G2([None, 41]), gamma,
                                    tuple(c[..., 0] for c in G2([e])))
        return (make(t), make(t + 1), jax_fr([2, 3]), G2([4]),
                [37], [None, m2(41)], [2, 3], [m2(4)])
    t = 3 * 47 + 43 * 4 + 2 * 4 * 5
    make = lambda e: JST.QuadEqu(jax_fr([43]), jax_fr([0, 47]), gamma,
                                 jax_fr([e])[:, 0])
    return (make(t), make(t + 1), jax_fr([2, 3]), jax_fr([4]),
            [43], [0, 47], [2, 3], [4])


@pytest.mark.parametrize("name", ["PPE", "MSMEG1", "MSMEG2", "QuadEqu"])
def test_prove_verify_scenario(name, jax_crs):
    """tests/prover.rs scenarios through the port on the JAX package's CRS
    and statements: commitments and (pi, theta) against the host's GS
    formulas with the same GsRng draws; the proof verifies; where the
    reference's test tries a wrong target (PPE, quadratic), it fails (each
    verify on the plain versions takes seconds; chip_smoke.py's gs-e2e
    tries a wrong target for all four)."""
    crs = crs_from_numpy(jax_crs, device="cpu")
    g1 = g1_affine_to_ints(crs.g1_gen)[0]
    g2 = g2_affine_to_ints(crs.g2_gen)[0]
    gt = FQ12.to_ints(crs.gt_gen[:, :, None])[0]
    jequ, jbad, jx, jy, a_h, b_h, x_h, y_h = scenario(name, g1, g2, gt)
    equ = statement_from_numpy(jequ, device="cpu")
    conv = lambda v: (affine_from_numpy(v, device="cpu")
                      if isinstance(v, tuple)
                      else limbs_from_numpy(v, device="cpu"))
    X, Y = conv(jx), conv(jy)
    seed = 100 + len(name)
    proof = PV.commit_and_prove(equ, X, Y, crs, GsRng(seed))

    # the same draws on the host: R (m, wx), S (n, wy), then T (wy, wx)
    xs, ys = equ.x_is_scalar, equ.y_is_scalar
    m, n = len(x_h), len(y_h)
    wx, wy = (1 if xs else 2), (1 if ys else 2)
    twin = GsRng(seed)
    Rm, Sm, Tm = draws(twin, m, wx), draws(twin, n, wy), draws(twin, wy, wx)
    gam = [[5], [0]]
    h1, h2 = HostCom("G1"), HostCom("G2")
    u = host_com_vec("G1", crs.u)                   # u_1, u_2
    v = host_com_vec("G2", crs.v)
    ub = host_com_vec("G1", tuple(c[..., None] for c in crs.u_base))[0]
    vb = host_com_vec("G2", tuple(c[..., None] for c in crs.v_base))[0]
    iota1 = lambda s, vals: ([h1.lin([x], [ub]) for x in vals] if s
                             else [(None, p) for p in vals])
    iota2 = lambda s, vals: ([h2.lin([x], [vb]) for x in vals] if s
                             else [(None, p) for p in vals])

    # commitments: iota(X) + R u, or iota'(x) + r u1
    cx = [h1.lin(Rm[i] + [1], u[:wx] + [iota1(xs, x_h)[i]]) for i in range(m)]
    cy = [h2.lin(Sm[j] + [1], v[:wy] + [iota2(ys, y_h)[j]]) for j in range(n)]
    assert host_com_vec("G1", proof.xcoms.coms) == cx
    assert host_com_vec("G2", proof.ycoms.coms) == cy

    # pi = R^T iota*(B) + (R^T G) iota*(Y) + (R^T G S - T^T) v[:wy]
    # theta = S^T iota*(A) + (S^T G^T) iota*(X) + T u[:wx]
    Rt, St = transpose(Rm), transpose(Sm)
    rg = matmul(Rt, gam)
    pf = [[(a - b) % R for a, b in zip(ra, rb)]
          for ra, rb in zip(matmul(rg, Sm), transpose(Tm))]
    sg = matmul(St, transpose(gam))
    pi = [h2.lin(Rt[k] + rg[k] + pf[k],
                 iota2(ys, b_h) + iota2(ys, y_h) + v[:wy]) for k in range(wx)]
    theta = [h1.lin(St[k] + sg[k] + Tm[k],
                    iota1(xs, a_h) + iota1(xs, x_h) + u[:wx])
             for k in range(wy)]
    ep = proof.equ_proofs[0]
    assert host_com_vec("G2", ep.pi) == pi
    assert host_com_vec("G1", ep.theta) == theta

    assert verify(equ, proof, crs)
    if name in ("PPE", "QuadEqu"):      # the reference tests' wrong targets
        assert not verify(statement_from_numpy(jbad, device="cpu"), proof,
                          crs)


def test_dimension_checks():
    """prove and verify refuse a statement whose shapes do not fit the
    commitments (the original's dimension asserts)."""
    z = torch.zeros((25, 2, 2), dtype=torch.int64)
    com = (z, z, torch.ones((2, 2), dtype=torch.bool))
    xcoms = PV.Commit1(coms=com, rand=torch.zeros((17, 2, 2),
                                                  dtype=torch.int64))
    ycoms = PV.Commit2(coms=(z[:, :, None].expand(25, 2, 2, 2),) * 2
                       + (com[2],), rand=xcoms.rand)
    g1 = (z[:, 0, :1], z[:, 0, :1], torch.ones(1, dtype=torch.bool))
    g2 = (z[:, :, :1].expand(25, 2, 1), z[:, :, :1].expand(25, 2, 1),
          torch.ones(1, dtype=torch.bool))
    equ = ST.PPE(g1, g2, torch.zeros((17, 2, 2), dtype=torch.int64),
                 torch.zeros((25, 12), dtype=torch.int64))
    with pytest.raises(ValueError, match="statement shapes"):
        PV.prove(equ, com, ycoms.coms, xcoms, ycoms, None,
                 T=torch.zeros((17, 2, 2), dtype=torch.int64))
    proof = PV.CProof(xcoms, ycoms, [PV.EquProof(com, com, equ.equ_type)])
    with pytest.raises(ValueError, match="statement shapes"):
        verify(equ, proof, None)
