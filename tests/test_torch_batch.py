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
from groth_sahai_tpu_torch.parallel.mesh import make_mesh
from groth_sahai_tpu_torch.parallel.multihost import make_global_mesh
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
    """A mesh whose shard count does not divide B, or of two axes, is
    refused before any work; so are mixed or mismatched batches."""
    host, equs, proofs, _ = batch3
    with pytest.raises(ValueError, match="not divisible by 2 shards"):
        BT.verify_ppe_batch(equs, proofs, host.crs,
                            mesh=make_mesh(2, devices=[DEV] * 2))
    with pytest.raises(ValueError, match="flatten_mesh"):
        BT.verify_ppe_batch_randomized(
            equs, proofs, host.crs, GsRng(1),
            mesh=make_global_mesh(local_devices=[DEV] * 3))
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


def test_mismatched_devices_raise(batch3):
    """Without a mesh nothing is moved: a CRS (or an equation) on another
    device than the proofs is refused before any work, by both
    verifiers."""
    host, equs, proofs, _ = batch3
    far = BT._moved(host.crs, "meta")
    with pytest.raises(ValueError, match="share one device"):
        BT.verify_batch(equs, proofs, far)
    with pytest.raises(ValueError, match="share one device"):
        BT.verify_batch_randomized(equs, proofs, far, GsRng(1))
    with pytest.raises(ValueError, match="share one device"):
        BT.verify_batch([BT._moved(equs[0], "meta")] + equs[1:], proofs,
                        host.crs)


# ------------------------------------------------------- over a device mesh
#
# Four slots, [e0, e1, e2, e0], with slot 1's pi taken from proof 2 (a
# tampered proof), over 2 and 4 CPU shards against the unsharded call.
# Each equation's ratio is its own limbs in any batch or tile (the tests
# above), so `_ratios` runs through a memo keyed by an equation's pairs,
# seeded with good3's: only the tampered slot's Miller loop is run (once);
# a sharded call that asked for another would have built other pairs than
# the unsharded one, and the tests check that none is asked for. The
# lane-wise final exponentiations and GT powers go through memos filled by
# the unsharded calls in the same way.

def _slot(P, Q, b):
    return (P[0][:, b], P[1][:, b], P[2][b], Q[0][:, :, b], Q[1][:, :, b],
            Q[2][b])


def _key(P, Q, mask, b):
    return tuple(t.contiguous().numpy().tobytes()
                 for t in _slot(P, Q, b) + (mask,))


@pytest.fixture(scope="module")
def memo(good3):
    _, (P, Q, mask), ratio = good3
    return {_key(P, Q, mask, b): ratio[:, :, b] for b in range(3)}


def memo_ratios(memo, real=BT._ratios):
    def ratios(P, Q, mask):
        keys = [_key(P, Q, mask, b) for b in range(P[2].shape[0])]
        miss = [b for b, k in enumerate(keys) if k not in memo]
        if miss:
            idx = torch.tensor(miss)
            pick = lambda l, d: l.index_select(d, idx)
            sub = real((pick(P[0], 1), pick(P[1], 1), pick(P[2], 0)),
                       (pick(Q[0], 2), pick(Q[1], 2), pick(Q[2], 0)), mask)
            memo.update({keys[b]: sub[:, :, j] for j, b in enumerate(miss)})
        return torch.stack([memo[k] for k in keys], 2)
    return ratios


def lane_memo(memo, real):
    """real(x, *e) on an Fq12 batch x (nl, 12, *batch), lane by lane
    through `memo`, keyed by each lane's limbs and its exponent's (each e
    (17, ...) broadcast over the batch): the lanes not seen before are
    computed, in one call of `real`. For the lane-wise final
    exponentiation and GT power, whose lanes do not depend on how a batch
    is cut."""
    def fn(x, *e):
        batch = tuple(x.shape[2:])
        xf = x.reshape(x.shape[0], x.shape[1], -1)
        ef = [a.expand(a.shape[:1] + batch).reshape(a.shape[0], -1)
              for a in e]
        keys = [tuple(t[..., j].contiguous().numpy().tobytes()
                      for t in [xf] + ef) for j in range(xf.shape[-1])]
        miss = {}
        for j, k in enumerate(keys):
            if k not in memo:
                miss.setdefault(k, j)
        if miss:
            idx = torch.tensor(list(miss.values()))
            out = real(xf.index_select(-1, idx),
                       *(a.index_select(-1, idx) for a in ef))
            memo.update({k: out[..., i] for i, k in enumerate(miss)})
        return torch.stack([memo[k] for k in keys], -1).reshape(x.shape)
    return fn


@pytest.fixture(scope="module")
def exp_memo():
    """Lane memos of `final_exp` and `gt_exp`, filled by the unsharded
    calls (plain4)."""
    return {"final_exp": {}, "gt_exp": {}}


@pytest.fixture(scope="module")
def batch4(batch3):
    host, equs, proofs, _ = batch3
    ep = proofs[1].equ_proofs[0]
    bad = dataclasses.replace(proofs[1], equ_proofs=[dataclasses.replace(
        ep, pi=proofs[2].equ_proofs[0].pi)])
    return host, equs + equs[:1], [proofs[0], bad, proofs[2], proofs[0]]


def spied_randomized(batch4, memo, exp_memo, mesh):
    """verify_ppe_batch_randomized(GsRng(5)) with `_ratios` and `gt_exp`
    memoized; returns (verdict, the Miller product it exponentiates, the
    target product, memo sizes after)."""
    host, equs, proofs = batch4
    seen = {}
    real_fe, real_tgt = BT.pr.final_exp, BT._comt_ppe_target
    real_gt = BT.pr.gt_exp

    def fe(f):
        seen["combined"] = f
        return real_fe(f)

    def tgt(t):
        seen["t"] = t
        return real_tgt(t)

    saved = BT._ratios
    BT._ratios, BT.pr.final_exp, BT._comt_ppe_target = memo_ratios(memo), \
        fe, tgt
    BT.pr.gt_exp = lane_memo(exp_memo["gt_exp"], real_gt)
    try:
        ok = BT.verify_ppe_batch_randomized(equs, proofs, host.crs, GsRng(5),
                                            mesh=mesh)
    finally:
        BT._ratios, BT.pr.final_exp, BT._comt_ppe_target = saved, real_fe, \
            real_tgt
        BT.pr.gt_exp = real_gt
    return ok, seen["combined"], seen["t"], (len(memo),
                                             len(exp_memo["gt_exp"]))


@pytest.fixture(scope="module")
def plain4(batch4, memo, exp_memo):
    host, equs, proofs = batch4
    saved, BT._ratios = BT._ratios, memo_ratios(memo)
    real_fe = BT.pr.final_exp
    BT.pr.final_exp = lane_memo(exp_memo["final_exp"], real_fe)
    try:
        ok = BT.verify_ppe_batch(equs, proofs, host.crs)
    finally:
        BT._ratios, BT.pr.final_exp = saved, real_fe
    assert ok.tolist() == [True, False, True, True]
    return ok, spied_randomized(batch4, memo, exp_memo, None)


@pytest.mark.parametrize("shards", [2, 4])
def test_verify_batch_over_mesh(batch4, memo, exp_memo, plain4, shards,
                                monkeypatch):
    """The per-equation verdicts over 2 and 4 shards equal the unsharded
    call's, from the same pairs and the same final exponentiations'
    inputs (no memo grows: `_ratios`' by the equations' pairs,
    `final_exp`'s by its lanes)."""
    host, equs, proofs = batch4
    sizes = len(memo), len(exp_memo["final_exp"])
    monkeypatch.setattr(BT, "_ratios", memo_ratios(memo))
    monkeypatch.setattr(BT.pr, "final_exp",
                        lane_memo(exp_memo["final_exp"], BT.pr.final_exp))
    ok = BT.verify_ppe_batch(equs, proofs, host.crs,
                             mesh=make_mesh(shards, devices=[DEV] * shards))
    assert isinstance(ok, np.ndarray) and ok.dtype == bool
    assert ok.tolist() == plain4[0].tolist()
    assert (len(memo), len(exp_memo["final_exp"])) == sizes


@pytest.mark.parametrize("shards", [2, 4])
def test_verify_batch_randomized_over_mesh(batch4, memo, exp_memo, plain4,
                                           shards):
    """rho drawn once before the split: over 2 and 4 shards the verdict,
    and the values of the rho-weighted Miller product and target product
    (merged from the shards' partials), equal the unsharded call's; the
    shards ask for no other Miller pairs or (value, rho) GT powers."""
    want_ok, want_f, want_t, size = plain4[1]
    ok, f, t, size_after = spied_randomized(
        batch4, memo, exp_memo, make_mesh(shards, devices=[DEV] * shards))
    assert ok is want_ok is False
    assert size_after == size
    assert FQ12.to_ints(f.reshape(f.shape[:2] + (4,))) == \
        FQ12.to_ints(want_f.reshape(want_f.shape[:2] + (4,)))
    assert FQ12.to_ints(t) == FQ12.to_ints(want_t)
