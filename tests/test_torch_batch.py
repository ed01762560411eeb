"""The port's batch verifier (groth_sahai_tpu_torch.models.batch) on the
batch3 cases of tests/test_batch_verify.py, against its single verifier
and the JAX package.

Three PPEs of the JAX test's shape (m = 2, n = 1: K = 9 Miller pairs,
padded to Kp = 16) over generate_crs(GsRng(808)); targets from discrete
logs on the host, and each proof from the GS formulas on the host with
the draws commit_and_prove makes from the shared GsRng (the port's
commit_and_prove is held against those formulas in test_torch_gs.py; here
it would cost seconds a proof on the plain versions). The JAX package's
batch verifiers are not run: their XLA:CPU compiles take minutes. Its
stacking helpers and GsRng draws are compared directly.

Each equation's ratio -- the signed Miller product the batch feeds to the
final exponentiation -- must be the same limbs as `miller_product_signed`
of that equation's pairs as the single verifier assembles them, and the
batch tiled one equation a tile (`FUSED_MAX_LANES` = 64) the same limbs
as untiled. The randomized cases are in test_torch_batch_randomized.py
(each file stays near 90 s on one CPU thread).
"""

import dataclasses

import numpy as np
import pytest
import torch

from groth_sahai_tpu.models import batch as JB
from groth_sahai_tpu.utils.rng import GsRng as JGsRng

from groth_sahai_tpu_torch.ops import tower
from groth_sahai_tpu_torch.ops.curve import (g1_affine_from_ints,
                                             g1_affine_to_ints,
                                             g2_affine_from_ints,
                                             g2_affine_to_ints)
from groth_sahai_tpu_torch.ops.fp import FR
from groth_sahai_tpu_torch.ops.limbs import ints_to_limbs
from groth_sahai_tpu_torch.ops.tower import FQ12
from groth_sahai_tpu_torch.models import batch as BT
from groth_sahai_tpu_torch.models import commit_group as cg
from groth_sahai_tpu_torch.models import kernels as K
from groth_sahai_tpu_torch.models import prover as PV
from groth_sahai_tpu_torch.models import statement as ST
from groth_sahai_tpu_torch.models import verifier as VF
from groth_sahai_tpu_torch.models.crs import generate_crs
from groth_sahai_tpu_torch.ops.curve import G1, G2
from groth_sahai_tpu_torch.utils import hostcrypto as H
from groth_sahai_tpu_torch.utils import metrics
from groth_sahai_tpu_torch.utils.convert import to_numpy
from groth_sahai_tpu_torch.utils.rng import GsRng

from .test_torch_gs import (HostCom, R, draws, host_com_vec, matmul,
                            transpose)
from .test_torch_tower import one_thread  # noqa: F401

DEV = "cpu"


@pytest.fixture(scope="module", autouse=True)
def one_thread_module():
    """One intra-op thread for the module's fixtures too (`one_thread`
    covers the tests; module fixtures are set up before it)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# ------------------------------------------------------------ host helpers

def fr(vals):
    return torch.as_tensor(ints_to_limbs([v % R for v in vals],
                                         FR.n).astype(np.int64))


class Host:
    """The CRS's generators and keys on the host, and the port's tensors
    of group elements given by discrete logs (None: infinity)."""

    def __init__(self, crs):
        self.crs = crs
        self.g1 = g1_affine_to_ints(crs.g1_gen)[0]
        self.g2 = g2_affine_to_ints(crs.g2_gen)[0]
        self.gt = FQ12.to_ints(crs.gt_gen[:, :, None])[0]

    def m1(self, k):
        return None if k is None else H.g1_mul(self.g1, k % R)

    def m2(self, k):
        return None if k is None else H.g2_mul(self.g2, k % R)

    def G1s(self, ks):
        return g1_affine_from_ints([self.m1(k) for k in ks], device=DEV)

    def G2s(self, ks):
        return g2_affine_from_ints([self.m2(k) for k in ks], device=DEV)

    def G1pt(self, k):
        return tuple(c[..., 0] for c in self.G1s([k]))

    def G2pt(self, k):
        return tuple(c[..., 0] for c in self.G2s([k]))

    def gtp(self, e):
        return FQ12.from_ints([H.f12_pow(self.gt, e % R)], device=DEV)[:, :, 0]


def com_tensor(curve_name, coms):
    """[(c0, c1)] * k host points -> a port Com vector (2, k)."""
    k = len(coms)
    pts = [c[0] for c in coms] + [c[1] for c in coms]
    from_ints = g2_affine_from_ints if curve_name == "G2" else \
        g1_affine_from_ints
    x, y, inf = from_ints(pts, device=DEV)
    shape = lambda l: l.reshape(l.shape[:-1] + (2, k))
    return (shape(x), shape(y), inf.reshape(2, k))


def host_proof(host, equ, a_h, b_h, gam, x_h, y_h, rng):
    """commit_and_prove's CProof from the GS formulas on the host (as
    test_torch_gs.test_prove_verify_scenario writes them), with the draws
    commit_and_prove makes from `rng`: R (m, wx), S (n, wy), T (wy, wx).
    Group values are host points, scalars ints."""
    crs = host.crs
    xs, ys = equ.x_is_scalar, equ.y_is_scalar
    m, n = len(x_h), len(y_h)
    wx, wy = (1 if xs else 2), (1 if ys else 2)
    Rm, Sm, Tm = draws(rng, m, wx), draws(rng, n, wy), draws(rng, wy, wx)
    h1, h2 = HostCom("G1"), HostCom("G2")
    u = host_com_vec("G1", crs.u)
    v = host_com_vec("G2", crs.v)
    ub = host_com_vec("G1", tuple(c[..., None] for c in crs.u_base))[0]
    vb = host_com_vec("G2", tuple(c[..., None] for c in crs.v_base))[0]
    iota1 = lambda s, vals: ([h1.lin([x], [ub]) for x in vals] if s
                             else [(None, p) for p in vals])
    iota2 = lambda s, vals: ([h2.lin([x], [vb]) for x in vals] if s
                             else [(None, p) for p in vals])
    cx = [h1.lin(Rm[i] + [1], u[:wx] + [iota1(xs, x_h)[i]]) for i in range(m)]
    cy = [h2.lin(Sm[j] + [1], v[:wy] + [iota2(ys, y_h)[j]]) for j in range(n)]
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
    rand = lambda M: fr(sum(M, [])).reshape(FR.n, len(M), len(M[0]))
    return PV.CProof(
        xcoms=PV.Commit1(coms=com_tensor("G1", cx), rand=rand(Rm)),
        ycoms=PV.Commit2(coms=com_tensor("G2", cy), rand=rand(Sm)),
        equ_proofs=[PV.EquProof(pi=com_tensor("G2", pi),
                                theta=com_tensor("G1", theta),
                                equ_type=equ.equ_type)])


def make_batch3():
    """test_batch_verify.py's batch3: (host, equations, proofs, wrong
    target) -- equation b has X = (2 + b, 3 + b), Y = (4 + b), A =
    (11 + b), B = (inf, 13 + b), Gamma = [[3 + b], [0]] as discrete logs
    over the CRS's generators."""
    rng = GsRng(808)
    host = Host(generate_crs(rng, device=DEV))
    equs, proofs = [], []
    for b in range(3):
        k = 2 + b
        x, y, a, bb, g = [k, k + 1], [k + 2], [11 + b], [None, 13 + b], 3 + b
        e = x[1] * bb[1] + a[0] * y[0] + x[0] * y[0] * g
        equ = ST.PPE(host.G1s(a), host.G2s(bb), fr([g, 0]).reshape(FR.n, 2, 1),
                     host.gtp(e))
        equs.append(equ)
        proofs.append(host_proof(host, equ, [host.m1(v) for v in a],
                                 [host.m2(v) for v in bb], [[g], [0]],
                                 [host.m1(v) for v in x],
                                 [host.m2(v) for v in y], rng))
    return host, equs, proofs, host.gtp(1)


def with_target(equ, target):
    return dataclasses.replace(equ, target=target)


@pytest.fixture(scope="module")
def batch3():
    return make_batch3()


def run_spied(fn, *args, **kw):
    """fn(*args, **kw) with batch._ratios recorded: (result, pairs,
    ratios)."""
    seen = {}
    real = BT._ratios

    def spy(P, Q, mask):
        seen["pairs"] = (P, Q, mask)
        seen["ratio"] = real(P, Q, mask)
        return seen["ratio"]

    BT._ratios = spy
    try:
        out = fn(*args, **kw)
    finally:
        BT._ratios = real
    return out, seen["pairs"], seen["ratio"]


@pytest.fixture(scope="module")
def good3(batch3):
    host, equs, proofs, _ = batch3
    return run_spied(BT.verify_ppe_batch, equs, proofs, host.crs)


# -------------------------------------------------------------- the cases

def test_batch_all_good(good3):
    ok, _, ratio = good3
    assert isinstance(ok, np.ndarray) and ok.dtype == bool
    assert ok.tolist() == [True, True, True]
    assert tuple(ratio.shape) == (25, 12, 3, 2, 2)


def test_batch_one_bad_tiled(batch3, good3, monkeypatch):
    """A single tampered target must flip exactly its own slot. Run with
    FUSED_MAX_LANES = 64: one equation (4 Kp = 64 lanes) a tile; every
    limb of the ratios equals the untiled run's (the target does not
    enter the Miller product)."""
    host, equs, proofs, wrong = batch3
    monkeypatch.setattr(tower, "FUSED_MAX_LANES", 64)
    assert BT._tile(64) == 1
    ok, _, ratio = run_spied(BT.verify_ppe_batch,
                             [equs[0], with_target(equs[1], wrong), equs[2]],
                             proofs, host.crs)
    assert ok.tolist() == [True, False, True]
    assert torch.equal(ratio, good3[2])


@pytest.mark.parametrize("i", [0, 1, 2])
def test_ratio_is_the_single_verifiers(batch3, good3, i):
    """Equation i's pairs are the single verifier's (verifier._pairs),
    limb for limb, padded to Kp; its ratio is miller_product_signed of
    them."""
    host, equs, proofs, _ = batch3
    _, (P, Q, mask), ratio = good3
    P1, Q1, mask1 = VF._pairs(equs[i], proofs[i], host.crs)
    Kp = P[2].shape[-1]
    assert Kp == K.next_pow2(P1[2].shape[-1]) == 16
    Pi = cg.aff_map(G1, P, lambda l: l[:, i, :, 0], lambda f: f[i, :, 0])
    Qi = cg.aff_map(G2, Q, lambda l: l[:, :, i, 0], lambda f: f[i, 0])
    for got, want in zip(Pi + Qi, K.pad_aff(G1, P1, 1, Kp)
                         + K.pad_aff(G2, Q1, 1, Kp)):
        assert torch.equal(got, want)
    assert mask.tolist() == np.pad(mask1, (0, Kp - len(mask1))).tolist()
    assert torch.equal(ratio[:, :, i], K.miller_product_signed(P1, Q1, mask1))


# ---------------------------------------------- stacking, rho, API edges

def test_stacking_matches_jax(batch3):
    """The stacking helpers hold the JAX package's `_stack_*` leaves, the
    B axis moved from 0 to where the port takes its leading batch."""
    host, equs, proofs, _ = batch3
    numpy_view = lambda v: (tuple(to_numpy(c) for c in v)
                            if isinstance(v, tuple) else to_numpy(v))
    jequs = [dataclasses.replace(e, **{f: numpy_view(getattr(e, f)) for f in
                                       ("a_consts", "b_consts", "gamma",
                                        "target")}) for e in equs]
    jproofs = [PV.CProof(
        xcoms=PV.Commit1(coms=numpy_view(p.xcoms.coms), rand=None),
        ycoms=PV.Commit2(coms=numpy_view(p.ycoms.coms), rand=None),
        equ_proofs=[PV.EquProof(pi=numpy_view(p.equ_proofs[0].pi),
                                theta=numpy_view(p.equ_proofs[0].theta),
                                equ_type=p.equ_proofs[0].equ_type)])
        for p in proofs]
    a, b, g, t = BT._stack_equ_batch(equs)
    ja, jb, jg, jt = JB._stack_equ_batch(jequs)
    c, d, pi, th = BT._stack_proof_batch(proofs)
    jc, jd, jpi, jth = JB._stack_proof_batch(jproofs)
    # (port leaf, JAX leaf, where the port keeps the B axis)
    pairs = [(a[0], ja[0], 1), (a[1], ja[1], 1), (a[2], ja[2], 0),
             (b[0], jb[0], 2), (b[1], jb[1], 2), (b[2], jb[2], 0),
             (g, jg, 1), (t, jt, 2)]
    for port, jx in ((c, jc), (th, jth)):                 # Com1 (2, B, k)
        pairs += [(port[0], jx[0], 2), (port[1], jx[1], 2), (port[2], jx[2], 1)]
    for port, jx in ((d, jd), (pi, jpi)):                 # Com2
        pairs += [(port[0], jx[0], 3), (port[1], jx[1], 3), (port[2], jx[2], 1)]
    for port, jx, axis in pairs:
        np.testing.assert_array_equal(to_numpy(port),
                                      np.moveaxis(np.asarray(jx), 0, axis))


def test_stacking_scalar_sides():
    """Fr constants and quadratic targets stack at axis 1 (after the
    limbs), MSME targets (points) on a new batch axis 0."""
    e = [ST.QuadEqu(fr([1, 2]), fr([3]), fr([4, 5]).reshape(FR.n, 1, 2),
                    fr([6 + i])[:, 0]) for i in range(3)]
    a, b, g, t = BT._stack_equ_batch(e)
    assert tuple(a.shape) == (FR.n, 3, 2) and tuple(b.shape) == (FR.n, 3, 1)
    assert tuple(g.shape) == (FR.n, 3, 1, 2) and tuple(t.shape) == (FR.n, 3)
    assert to_numpy(t)[0].tolist() == [6, 7, 8]
    pt = tuple(c[..., 0] for c in g1_affine_from_ints([None], device=DEV))
    e1 = [ST.MSMEG1(None, None, fr([1]).reshape(FR.n, 1, 1), pt)] * 2
    t1 = BT._stack_equ_batch([dataclasses.replace(x, a_consts=fr([1]),
                                                  b_consts=fr([2]))
                              for x in e1])[3]
    assert tuple(t1[0].shape) == (25, 2) and tuple(t1[2].shape) == (2,)


def test_rho_matches_jax_draws():
    """verify_batch_randomized's rho: `rng.fr_std((B,))`, the JAX
    package's GsRng draws."""
    np.testing.assert_array_equal(to_numpy(GsRng(1).fr_std((3,), device=DEV)),
                                  np.asarray(JGsRng(1).fr_std((3,))))


def test_metrics_count_equations(batch3, monkeypatch):
    """verify_batch counts its equations under batch_verify_equations (the
    pairing work replaced by ones: only the counter is under test)."""
    host, equs, proofs, _ = batch3
    monkeypatch.setattr(BT, "_batch_pairs", lambda *args: (args[8][2].shape[1],))
    monkeypatch.setattr(BT, "_ratios", lambda B: FQ12.one((B, 2, 2), device=DEV))
    monkeypatch.setattr(BT.pr, "final_exp", lambda f: f)
    metrics.reset()
    BT.verify_ppe_batch(equs[:2], proofs[:2], host.crs)
    BT.verify_ppe_batch(equs, proofs, host.crs)
    assert metrics.snapshot()["count/batch_verify_equations"] == 5
    metrics.reset()


def test_mesh_and_mixed_types_raise(batch3):
    host, equs, proofs, _ = batch3
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        BT.verify_ppe_batch(equs, proofs, host.crs, mesh=object())
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        BT.verify_ppe_batch_randomized(equs, proofs, host.crs, GsRng(1),
                                       mesh=object())
    quad = ST.QuadEqu(fr([1]), fr([1]), fr([1]).reshape(FR.n, 1, 1),
                      fr([1])[:, 0])
    with pytest.raises(ValueError, match="mixed equation types"):
        BT.verify_batch([equs[0], quad], proofs[:2], host.crs)
    with pytest.raises(ValueError, match="proofs"):
        BT.verify_batch(equs, proofs[:2], host.crs)
    other = dataclasses.replace(proofs[0], equ_proofs=[dataclasses.replace(
        proofs[0].equ_proofs[0], equ_type=ST.EquType.Quadratic)])
    with pytest.raises(ValueError, match="another type"):
        BT.verify_batch(equs[:2], [proofs[0], other], host.crs)
