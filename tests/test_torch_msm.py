"""The port's Pippenger MSM and the complete law under the reference's
names (groth_sahai_tpu_torch.ops.msm, .proj, .cuda_curve; the K >= 16
branch of models.commit_group.com_matvec).

The MSM's pieces are held bit for bit against the JAX package's, run
eagerly (ROADMAP rule 1: no XLA compile of a whole MSM graph): the digits
and signed digits, the stable per-window sort of (key, payload), and the
width, rows and padded length. `cmsm_row_scan`'s plain version is held
limb for limb against the reference's in-kernel body `_cmadd_body`
chained from (0 : 1 : 0). `msm` itself, `proj.madd/add/dbl/dbl_n/
sum_reduce`, a K = 16 `com_matvec` and a PPE with m = n = 9 (the smallest
whose Com products all take the MSM) are held by value against the host,
`msm_naive` and the reference's unfused law (another redundant form: the
same values mod p). On the CPU every kernel wrapper runs its plain
version; the `gpu` test holds the kernels against those on a card.
"""

import dataclasses
import functools
import itertools
import random

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax import lax

from groth_sahai_tpu.ops import msm as JMSM
from groth_sahai_tpu.ops import pallas_curve as PC
from groth_sahai_tpu.ops import proj as JPJ

from groth_sahai_tpu_torch.ops import bls12_381 as C
from groth_sahai_tpu_torch.ops import cuda_curve as CC
from groth_sahai_tpu_torch.ops import cuda_tower as CT
from groth_sahai_tpu_torch.ops import msm as MS
from groth_sahai_tpu_torch.ops import proj as PJ
from groth_sahai_tpu_torch.ops.curve import (G1, G2, g1_affine_from_ints,
                                             g1_affine_to_ints,
                                             g2_affine_from_ints,
                                             g2_affine_to_ints)
from groth_sahai_tpu_torch.ops.fp import FR
from groth_sahai_tpu_torch.ops.limbs import ints_to_limbs
from groth_sahai_tpu_torch.ops.tower import FQ12
from groth_sahai_tpu_torch.models import commit_group as CG
from groth_sahai_tpu_torch.models import statement as ST
from groth_sahai_tpu_torch.models.crs import generate_crs
from groth_sahai_tpu_torch.models.prover import commit_and_prove
from groth_sahai_tpu_torch.models.verifier import verify
from groth_sahai_tpu_torch.utils import hostcrypto as H
from groth_sahai_tpu_torch.utils.convert import limbs_from_numpy
from groth_sahai_tpu_torch.utils.rng import GsRng

from .test_torch_curve import (CURVES, GEN, P, columns, coords,
                               ctx_and_adapter,
                               from_rows, host_points, madd_lanes, mont,
                               port, proj_lanes, rows)
from .test_torch_cuda_tower import NL
from .test_torch_tower import one_thread  # noqa: F401

TO_INTS = {"G1": g1_affine_to_ints, "G2": g2_affine_to_ints}


def from_ints(name, pts):
    fn = g2_affine_from_ints if name == "G2" else g1_affine_from_ints
    return fn(pts, device="cpu")


def scalar_ints(seed, n):
    """Seeded Fr scalars with the edges 0, 1 and r - 1 first."""
    rnd = random.Random(seed)
    s = [rnd.randrange(C.R) for _ in range(n)]
    s[:3] = [0, 1, C.R - 1]
    return s


def std_limbs(values):
    return torch.as_tensor(ints_to_limbs(values, FR.n).astype(np.int64))


def affine_value(name, curve, jac):
    """A Jacobian batch (coordinates (..., k)) as host affine points."""
    return TO_INTS[name](curve.to_affine(jac))


# ------------------------------------------------ the pieces, bit for bit

@pytest.mark.parametrize("window", [4, 8, 13])
def test_digits_and_sorted_stream_match_jax(window):
    """_digits, _signed_digits and the stable per-window sort of (key,
    payload), as the reference's msm makes them with lax.sort."""
    s = std_limbs(scalar_ints(window, 37))
    js = jnp.asarray(s.numpy().astype(np.uint32))
    np.testing.assert_array_equal(MS._digits(s, window).numpy(),
                                  np.asarray(JMSM._digits(js, window)))
    d, n = MS._signed_digits(s, window)
    jd, jn = JMSM._signed_digits(js, window)
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(n.numpy(), np.asarray(jn))
    # the reference's steps 1-2 (ops/msm.py), eagerly
    W, N = jd.shape
    nbuck = (1 << (window - 1)) + 1
    payload = (jnp.broadcast_to(jnp.arange(N, dtype=jnp.uint32)[None], (W, N))
               | (jn.astype(jnp.uint32) << 31))
    digs_s, pay_s = lax.sort((jd, payload), num_keys=1)
    keys = digs_s + jnp.arange(W, dtype=jnp.uint32)[:, None] * nbuck
    got_k, got_p = MS._sorted_stream(s[:, None, :], window)
    np.testing.assert_array_equal(got_k[0].numpy(),
                                  np.asarray(keys).reshape(-1))
    np.testing.assert_array_equal(got_p[0].numpy(),
                                  np.asarray(pay_s).reshape(-1)
                                  .astype(np.int64))


@pytest.mark.parametrize("N,window", [(16, 4), (37, 4), (512, 8),
                                      (65536, 13), (37, 8)])
def test_pick_width_rows_and_padding_match_jax(N, window):
    M = N * -(-MS.NBITS // window)
    width = MS._pick_width(M, None)
    assert width == JMSM._pick_width(M, None)
    assert MS._pick_width(M, 64) == JMSM._pick_width(M, 64)
    rows = -(-M // width)
    assert (rows, rows * width) == {(16, 4): (8, 1024), (37, 4): (19, 2432),
                                    (512, 8): (128, 16384),
                                    (65536, 13): (320, 1310720),
                                    (37, 8): (10, 1280)}[N, window]


@pytest.mark.parametrize("name", ["G1", "G2"])
def test_cmsm_row_scan_plain_matches_chained_pallas_body(name):
    """4 rows (G1) or 3 (G2: each eager G2 body takes seconds) x 8 lanes:
    the raw prefix stream and the lane totals against _cmadd_body chained
    from (0 : 1 : 0), limb for limb. Lane 0 is all infinity; lanes 1-2 add
    P then P again (P + P) or -P (P + (-P)); lane 3 holds coordinates at
    2p - 1; the rest are random in bounds."""
    curve = G2 if name == "G2" else G1
    rnd = random.Random(61)
    pts, _ = host_points(name, 62, 3)
    n_rows, lanes = (3 if name == "G2" else 4), 8
    top = 2 * P - 1 if name == "G1" else (2 * P - 1, 2 * P - 1)
    rand = lambda: (rnd.randrange(2 * P) if name == "G1"
                    else (rnd.randrange(2 * P), rnd.randrange(2 * P)))
    negy = lambda pt: (pt[0], tuple(-c % P for c in pt[1]) if name == "G2"
                       else -pt[1] % P)
    grid, flags = [], []
    for r in range(n_rows):
        row, frow = [], []
        for L in range(lanes):
            if L == 0:
                pt, f = (rand(), rand()), True
            elif L in (1, 2):
                pt = pts[0] if r % 2 == 0 or L == 1 else negy(pts[0])
                pt, f = tuple(mont(c) for c in pt), False
            elif L == 3:
                pt, f = (top, top), False
            else:
                pt, f = (rand(), rand()), rnd.random() < 0.25
            row.append(pt)
            frow.append(f)
        grid.append(row)
        flags.append(frow)
    xs = np.stack([columns(name, row, 0) for row in grid], curve.ns)
    ys = np.stack([columns(name, row, 1) for row in grid], curve.ns)
    inf = np.array(flags)
    tot, raw = CC.cmsm_row_scan_plain((port(xs), port(ys), torch.tensor(inf)),
                                      curve)
    ctx, F = ctx_and_adapter(name, lanes)
    zero = np.zeros_like(columns(name, grid[0], 0))
    one = coords(name, [mont(1) if name == "G1" else (mont(1), 0)] * lanes)
    acc = (rows(name, zero), rows(name, one), rows(name, zero))
    for r in range(n_rows):
        acc = PC._cmadd_body(F, ctx, *acc, rows(name, xs[..., r, :]),
                             rows(name, ys[..., r, :]), jnp.asarray(inf[r]))
        for c in range(3):
            want = from_rows(name, acc[c])
            if name == "G2":
                want = want.transpose(1, 0, 2).reshape(2 * NL, lanes)
            np.testing.assert_array_equal(raw[c][r].numpy(), want)
    for c in range(3):
        np.testing.assert_array_equal(tot[c].numpy(), from_rows(name, acc[c]))


# ---------------------------------------------------------- msm by value

def msm_case(name, n, seed):
    """n points a_i G (one at infinity, two repeated) and scalars with the
    edges 0, 1, r - 1; returns (points, scalars, host sum)."""
    mul = CURVES[name][2]
    rnd = random.Random(seed)
    a = [rnd.randrange(1, C.R) for _ in range(n)]
    a[3] = 0
    a[5] = a[4]
    a[n - 1] = a[4]
    s = scalar_ints(seed + 1, n)
    pts = from_ints(name, [None if k == 0 else mul(GEN[name], k) for k in a])
    want = mul(GEN[name], sum(x * y for x, y in zip(a, s)) % C.R)
    return pts, std_limbs(s), want


@pytest.mark.parametrize("name,n,window", [("G1", 16, 4), ("G1", 16, 8),
                                           ("G1", 37, 4), ("G1", 37, 8),
                                           ("G2", 16, 4), ("G2", 37, 4)])
def test_msm_matches_host(name, n, window):
    """At N = 37 the padded length Mp is not M (a sentinel tail)."""
    curve = CURVES[name][0]
    pts, s, want = msm_case(name, n, 70 + n + window)
    out = MS.msm(curve, pts, s, window=window)
    assert affine_value(name, curve, tuple(c[..., None] for c in out)) \
        == [want]


def test_msm_matches_msm_naive_and_batches():
    """A leading batch of 3 MSMs against three separate calls, and one
    of them against msm_naive (scalar_mul + sum_reduce)."""
    curve = G1
    cases = [msm_case("G1", 16, 80 + k) for k in range(3)]
    pts = tuple(torch.stack([c[0][i] for c in cases], -2) for i in range(3))
    s = torch.stack([c[1] for c in cases], 1)              # (17, 3, 16)
    out = MS.msm(curve, pts, s, window=4)
    got = affine_value("G1", curve, out)
    assert got == [c[2] for c in cases]
    one = MS.msm(curve, cases[1][0], cases[1][1], window=4)
    for a, b in zip(one, out):
        assert torch.equal(a, b[..., 1])
    naive = curve.msm_naive(cases[1][0], cases[1][1])
    assert affine_value("G1", curve, tuple(c[..., None] for c in naive)) \
        == [cases[1][2]]


# -------------------------------------------- proj's law, by value

@pytest.mark.parametrize("name", ["G1"])
def test_proj_law_matches_reference_by_value(name):
    """madd, add, dbl, dbl_n (n = 3) and sum_reduce over the kernels'
    plain versions against the reference's unfused law, as affine points
    (b3 as x12 or as a Montgomery constant; dbl_n adds (0 : 1 : 0) after
    its doublings, which scales the coordinates). G1 only: the jitted G2
    law compiles for over 20 s, and the G2 MSM tests run cadd and
    cdbl_n_add by value."""
    curve, jcurve = CURVES[name][:2]
    accs, affs, inf = madd_lanes(name, 91)
    acc = [columns(name, accs, k) for k in range(3)]
    aff = [columns(name, affs, k) for k in range(2)]
    ps, qs = proj_lanes(name, 92)
    p = [columns(name, ps, k) for k in range(3)]
    q = [columns(name, qs, k) for k in range(3)]
    a_t = (port(aff[0]), port(aff[1]), torch.tensor(inf))
    a_j = (jnp.asarray(aff[0]), jnp.asarray(aff[1]), jnp.asarray(np.array(inf)))

    def run(pj, c, acc, a, p, q):
        return (pj.madd(c, acc, a), pj.add(c, p, q), pj.dbl(c, p),
                pj.dbl_n(c, q, 3), pj.sum_reduce(c, p, axis=0))

    got = run(PJ, curve, tuple(map(port, acc)), a_t, tuple(map(port, p)),
              tuple(map(port, q)))
    want = jax.jit(lambda acc, a, p, q: run(JPJ, jcurve, acc, a, p, q))(
        tuple(map(jnp.asarray, acc)), a_j, tuple(map(jnp.asarray, p)),
        tuple(map(jnp.asarray, q)))
    F = curve.F
    for g3, w3 in zip(got, want):
        w3 = tuple(limbs_from_numpy(np.asarray(w), device="cpu") for w in w3)
        for g, w in zip(PJ.to_affine(curve, g3), PJ.to_affine(curve, w3)):
            assert torch.equal(F.normalize(g) if g.dtype == torch.int64
                               else g, F.normalize(w) if w.dtype == torch.int64
                               else w)


# ------------------------------------------------ com_matvec and the PPE

def test_com_matvec_k16_takes_the_msm():
    """K = 16, I = 2 on G1: the MSM branch against the small-K formula
    (scalar_mul over (2, I, K) + sum_reduce) and the host."""
    mul = H.g1_mul
    rnd = random.Random(95)
    I, K = 2, 16
    logs = [[rnd.randrange(1, C.R) for _ in range(K)] for _ in range(2)]
    logs[0][3] = 0
    com = from_ints("G1", [None if k == 0 else mul(GEN["G1"], k)
                           for row in logs for k in row])
    com = (com[0].reshape(NL, 2, K), com[1].reshape(NL, 2, K),
           com[2].reshape(2, K))
    sc = [[rnd.randrange(C.R) for _ in range(K)] for _ in range(I)]
    sc[1][0] = 0
    s = std_limbs(sum(sc, [])).reshape(FR.n, I, K)
    before = {k: k.launches for k in CC.KERNELS}
    got = CG.com_matvec(G1, s, com)                        # (2, I)
    assert {k: k.launches for k in CC.KERNELS} == before   # CPU: no launch
    small = G1.sum_reduce(G1.scalar_mul(CG.aff_expand(G1, com, 1, I),
                                        s[:, None]), axis=2)
    flat = lambda j: tuple(c.reshape(c.shape[:1] + (-1,)) for c in j)
    want = [mul(GEN["G1"], sum(sc[i][k] * logs[c][k] for k in range(K))
                % C.R) for c in range(2) for i in range(I)]
    assert affine_value("G1", G1, flat(got)) == want
    assert affine_value("G1", G1, flat(small)) == want


@functools.lru_cache(maxsize=1)
def ppe_9x9():
    """A PPE with m = n = 9 over random discrete logs, its target from
    them on the host, committed and proved: (statement, proof, CRS). Every
    Com product of the prover (pi1, pi2, theta1, theta2 at padded K = 16)
    and the verifier's Gamma d take the MSM. Made once per process: both
    tests below read it."""
    m = n = 9
    rnd = random.Random(97)
    crs = generate_crs(GsRng(98), device="cpu")
    g1 = g1_affine_to_ints(crs.g1_gen)[0]
    g2 = g2_affine_to_ints(crs.g2_gen)[0]
    gt = FQ12.to_ints(crs.gt_gen[:, :, None])[0]
    x, b = ([rnd.randrange(C.R) for _ in range(m)] for _ in range(2))
    y, a = ([rnd.randrange(C.R) for _ in range(n)] for _ in range(2))
    gam = [[rnd.randrange(C.R) for _ in range(n)] for _ in range(m)]
    e = (sum(xi * bi for xi, bi in zip(x, b))
         + sum(aj * yj for aj, yj in zip(a, y))
         + sum(gam[i][j] * x[i] * y[j] for i in range(m) for j in range(n)))
    G1s = lambda ks: from_ints("G1", [H.g1_mul(g1, k) for k in ks])
    G2s = lambda ks: from_ints("G2", [H.g2_mul(g2, k) for k in ks])
    equ = ST.PPE(G1s(a), G2s(b), std_limbs(sum(gam, [])).reshape(FR.n, m, n),
                 FQ12.from_ints([H.f12_pow(gt, e % C.R)], device="cpu")[:, :, 0])
    return equ, commit_and_prove(equ, G1s(x), G2s(y), crs, GsRng(99)), crs


@pytest.mark.parametrize("pi_changed", [False, True])
def test_ppe_9x9_proves_and_verifies(pi_changed):
    """The proof of `ppe_9x9` verifies; with pi's first element replaced
    by p2 (the CRS's v[0][0]) it does not."""
    equ, proof, crs = ppe_9x9()
    if pi_changed:
        pi = tuple(c.clone() for c in proof.equ_proofs[0].pi)
        for c in range(3):
            pi[c][..., 0, 0] = crs.v[c][..., 0, 0]
        proof = dataclasses.replace(proof, equ_proofs=[dataclasses.replace(
            proof.equ_proofs[0], pi=pi)])
    assert verify(equ, proof, crs) is not pi_changed


# ----------------------------------------------------------- on a card

@pytest.mark.gpu
def test_msm_kernels_match_plain_on_card():
    """cadd, cmsm_row_scan and the two Miller steps against their plain
    versions on a card, G1 and G2; the steps' R also against the Miller
    iterations' R update."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels are CUDA C++ for sm_90a")
    dev = "cuda"
    gen = torch.Generator().manual_seed(5)

    def rnd(shape, bound):
        bits = (bound * P).bit_length() - 1
        x = torch.randint(0, 1 << 16, (NL,) + shape, generator=gen,
                          dtype=torch.int64)
        for i in range(NL):
            x[i] &= (1 << max(0, min(16, bits - 16 * i))) - 1
        return x.to(dev)

    def same(kern, args, outs=None):
        before = kern.launches
        got = kern(*args)
        want = CC.PLAIN.get(kern, CT.PLAIN.get(kern))(*args)
        torch.cuda.synchronize()
        assert kern.launches == before + 1
        flat = lambda t: [t] if torch.is_tensor(t) else [
            y for z in t for y in flat(z)]
        for g, w in zip(flat(got), flat(want), strict=True):
            assert torch.equal(g, w), kern.__name__
        return got

    # cadd and cmsm_row_scan run blocks of 64 threads (csrc/curve_kernels.cu
    # kWThreads): 77 and 205 lanes end in a ragged block after one and three
    # full ones
    for curve, lanes in itertools.product((G1, G2), (77, 205)):
        lead = (2,) if curve.ns == 2 else ()
        p = tuple(rnd(lead + (lanes,), 4) for _ in range(3))
        q = tuple(rnd(lead + (lanes,), 4) for _ in range(3))
        same(CC.cadd, (p, q, curve))
        x, y = rnd(lead + (5, lanes), 2), rnd(lead + (5, lanes), 2)
        inf = (torch.rand((5, lanes), generator=gen) < 0.3).to(dev)
        inf[:, 0] = True
        same(CC.cmsm_row_scan, ((x, y, inf), curve))
    R = (rnd((2, 45), 2), rnd((2, 45), 10), rnd((2, 45), 2))
    Q = (rnd((2, 45), 1), rnd((2, 45), 1))
    f = torch.zeros((NL, 12, 45), dtype=torch.int64, device=dev)
    px, py = rnd((45,), 1), rnd((45,), 1)
    R3, _ = same(CT.miller_dbl_step, (R, (P + 1) // 2))
    for a, b in zip(R3, CT.miller_iter_dbl(f, R, px, py)[1]):
        assert torch.equal(a, b)
    R3, _ = same(CT.miller_add_step, (R, Q))
    for a, b in zip(R3, CT.miller_iter_add(f, R, Q, px, py)[1]):
        assert torch.equal(a, b)
