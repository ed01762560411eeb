"""The port's group law and its fused curve kernels
(groth_sahai_tpu_torch.ops.curve, .proj, .cuda_curve).

The plain versions of `cmadd` and `cdbl_n_add` are held limb for limb
against the in-kernel bodies of the JAX package's Pallas curve kernels
(`pallas_curve._cmadd_body`, `_cdbl_body`, `_cadd_body`), run eagerly on
row lists through its field adapters `_FqA` / `_Fq2A` (interpreting the
whole Pallas kernels takes minutes on XLA:CPU): `cdbl_n_add` is n of the
doubling body, then the add body, so the test holds each part and the
port's own composition of them. The Jacobian law, `to_affine`,
`inv_batch` and the projective helpers are held limb for limb against the
JAX package's functions (jitted at a few lanes: each compiles in seconds,
faster than running them eagerly); `scalar_mul` by value against the host
oracle. The kernels themselves are held against the plain versions on the
card (the `gpu` test here and `chip_smoke.py`). Inputs come from a numpy or
`random` seed; edge lanes: the accumulator at infinity (0 : 1 : 0), an
affine point with its infinity flag set, P + P, P + (-P), and coordinates
at the top of their bounds (< 4p projective, < 2p affine).
"""

import random

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from groth_sahai_tpu.ops import pallas_curve as PC
from groth_sahai_tpu.ops import proj as JPJ
from groth_sahai_tpu.ops.curve import G1 as JG1, G2 as JG2
from groth_sahai_tpu.ops.fp import FQ as JFQ
from groth_sahai_tpu.ops.tower import FQ2 as JFQ2

from groth_sahai_tpu_torch.ops import bls12_381 as C
from groth_sahai_tpu_torch.ops import cuda_curve as CC
from groth_sahai_tpu_torch.ops import proj as PJ
from groth_sahai_tpu_torch.ops.curve import (G1, G2, g1_affine_from_ints,
                                             g1_affine_to_ints,
                                             g2_affine_from_ints,
                                             g2_affine_to_ints)
from groth_sahai_tpu_torch.ops.fp import FQ
from groth_sahai_tpu_torch.ops.limbs import ints_to_limbs
from groth_sahai_tpu_torch.ops.tower import FQ2
from groth_sahai_tpu_torch.models import commit_group as CG
from groth_sahai_tpu_torch.utils import hostcrypto as H
from groth_sahai_tpu_torch.utils.convert import limbs_from_numpy, to_numpy

from .test_torch_cuda_tower import NL, jax_consts
from .test_torch_tower import one_thread  # noqa: F401

P = C.P
GEN = {"G1": (C.G1_GEN_X, C.G1_GEN_Y), "G2": (C.G2_GEN_X, C.G2_GEN_Y)}
CURVES = {"G1": (G1, JG1, H.g1_mul, H.g1_add, H.g1_neg),
          "G2": (G2, JG2, H.g2_mul, H.g2_add, H.g2_neg)}
ZERO = {"G1": 0, "G2": (0, 0)}


def mont(v):
    """An Fq int or an Fq2 pair in Montgomery form."""
    if isinstance(v, tuple):
        return tuple(mont(c) for c in v)
    return v % P * FQ.r_mod_p % P


def f2mul(a, b):
    """a * b for an Fq int or Fq2 pair a and an int b, mod p."""
    return tuple(c * b % P for c in a) if isinstance(a, tuple) else a * b % P


def neg(a):
    return tuple(-c % P for c in a) if isinstance(a, tuple) else -a % P


def coords(name, vals):
    """Per-lane ints (G1) or int pairs (G2), already in the wanted form ->
    numpy limbs (25, L) or (25, 2, L)."""
    if name == "G1":
        return ints_to_limbs(vals, NL)
    flat = [c for v in vals for c in v]
    return ints_to_limbs(flat, NL).reshape(NL, len(vals), 2).transpose(0, 2, 1)


def random_coord(rnd, name, bound):
    return (rnd.randrange(bound) if name == "G1"
            else (rnd.randrange(bound), rnd.randrange(bound)))


def top(name, bound):
    return bound - 1 if name == "G1" else (bound - 1, bound - 1)


def projective(pt, lam, name):
    """An affine host point (or None) as Montgomery (X : Y : Z) = lam (x, y, 1),
    infinity as (0 : 1 : 0)."""
    if pt is None:
        return (ZERO[name], mont(1) if name == "G1" else (mont(1), 0),
                ZERO[name])
    one = 1 if name == "G1" else (1, 0)
    return tuple(mont(f2mul(c, lam)) for c in (pt[0], pt[1], one))


def host_points(name, seed, count):
    rnd = random.Random(seed)
    mul = CURVES[name][2]
    return [mul(GEN[name], rnd.randrange(1, C.R)) for _ in range(count)], rnd


def madd_lanes(name, seed):
    """(acc (X, Y, Z), affine (x, y), inf) per lane, as lists of ints:
    acc at infinity; affine infinity; P + P; P + (-P); the top of the
    bounds (acc < 4p, affine < 2p); random in bounds."""
    pts, rnd = host_points(name, seed, 4)
    lam = [rnd.randrange(1, P) for _ in range(4)]
    accs = [projective(None, 1, name), projective(pts[1], lam[1], name),
            projective(pts[2], lam[2], name),
            projective((pts[3][0], neg(pts[3][1])), lam[3], name),
            tuple(top(name, 4 * P) for _ in range(3)),
            tuple(random_coord(rnd, name, 4 * P) for _ in range(3))]
    affs = [tuple(mont(c) for c in pts[0]), (ZERO[name], ZERO[name]),
            tuple(mont(c) for c in pts[2]), tuple(mont(c) for c in pts[3]),
            (top(name, 2 * P), top(name, 2 * P)),
            tuple(random_coord(rnd, name, 2 * P) for _ in range(2))]
    inf = [False, True, False, False, False, False]
    return accs, affs, inf


def proj_lanes(name, seed):
    """Two projective inputs (P, Q) per lane: P at infinity; Q at
    infinity; P + P (another Z); P + (-P); the top of the bound (4p - 1);
    random < 4p."""
    pts, rnd = host_points(name, seed, 4)
    lam = [rnd.randrange(1, P) for _ in range(8)]
    ps = [projective(None, 1, name), projective(pts[1], lam[1], name),
          projective(pts[2], lam[2], name), projective(pts[3], lam[3], name),
          tuple(top(name, 4 * P) for _ in range(3)),
          tuple(random_coord(rnd, name, 4 * P) for _ in range(3))]
    qs = [projective(pts[0], lam[4], name), projective(None, 1, name),
          projective(pts[2], lam[5], name),
          projective((pts[3][0], neg(pts[3][1])), lam[6], name),
          tuple(top(name, 4 * P) for _ in range(3)),
          tuple(random_coord(rnd, name, 4 * P) for _ in range(3))]
    return ps, qs


def columns(name, points, k):
    return coords(name, [pt[k] for pt in points])


def port(x):
    return limbs_from_numpy(x, device="cpu")


def rows(name, x):
    """numpy limbs -> the Pallas bodies' row lists ((c0 rows, c1 rows) for
    Fq2)."""
    if name == "G1":
        return [jnp.asarray(x[i]) for i in range(NL)]
    return tuple([jnp.asarray(x[i, u]) for i in range(NL)] for u in range(2))


def from_rows(name, v):
    if name == "G1":
        return np.stack([np.asarray(r) for r in v], 0)
    return np.stack([np.stack([np.asarray(r) for r in v[u]], 0)
                     for u in range(2)], 1)


def ctx_and_adapter(name, lanes):
    p, one = jax_consts(lanes)
    return (PC._Ctx(NL, JFQ.n0, p, one),
            PC._Fq2A if name == "G2" else PC._FqA)


def same(port_out, want):
    np.testing.assert_array_equal(to_numpy(port_out), want)


@pytest.mark.parametrize("name", ["G1", "G2"])
def test_cmadd_plain_matches_pallas_body(name):
    accs, affs, inf = madd_lanes(name, 11)
    acc = [columns(name, accs, k) for k in range(3)]
    aff = [columns(name, affs, k) for k in range(2)]
    ctx, F = ctx_and_adapter(name, len(inf))
    want = PC._cmadd_body(F, ctx, *(rows(name, x) for x in acc + aff),
                          jnp.asarray(np.array(inf)))
    curve = G2 if name == "G2" else G1
    got = CC.cmadd(tuple(map(port, acc)),
                   (port(aff[0]), port(aff[1]), torch.tensor(inf)), curve)
    for g, w in zip(got, want):
        same(g, from_rows(name, w))


@pytest.mark.parametrize("name", ["G1", "G2"])
@pytest.mark.parametrize("part", ["dbl", "add"])
def test_cdbl_n_add_parts_match_pallas_bodies(name, part):
    """The doubling body (`_cdbl_body`) and the complete add
    (`_cadd_body`) that `_cdbl_n_add_kernel` composes."""
    ps, qs = proj_lanes(name, 12)
    p = [columns(name, ps, k) for k in range(3)]
    q = [columns(name, qs, k) for k in range(3)]
    ctx, F = ctx_and_adapter(name, len(ps))
    A = CC._adapter(G2 if name == "G2" else G1)
    if part == "dbl":
        want = PC._cdbl_body(F, ctx, *(rows(name, x) for x in p))
        got = CC._cdbl_body(A, *map(port, p))
    else:
        want = PC._cadd_body(F, ctx, *(rows(name, x) for x in p + q))
        got = CC._cadd_body(A, *map(port, p + q))
    for g, w in zip(got, want):
        same(g, from_rows(name, w))


@pytest.mark.parametrize("n_dbl", [0, 1, 4])
def test_cdbl_n_add_plain_composes_its_parts(n_dbl):
    """cdbl_n_add = n_dbl doublings, then the add, on broadcast inputs."""
    ps, qs = proj_lanes("G2", 13)
    p = tuple(port(columns("G2", ps, k)) for k in range(3))
    q = tuple(port(columns("G2", qs, k)) for k in range(3))
    want = p
    for _ in range(n_dbl):
        want = CC._cdbl_body(CC._Fq2P, *want)
    want = CC._cadd_body(CC._Fq2P, *want, *q)
    got = CC.cdbl_n_add(p, n_dbl, q, G2)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    # a single point broadcast against the batch
    one = tuple(x[:, :, :1] for x in p)
    got = CC.cdbl_n_add(one, n_dbl, q, G2)
    assert tuple(got[0].shape) == tuple(q[0].shape)


def test_curve_wrappers_refuse_non_cuda_devices():
    """A non-CPU input goes to the kernel path, which checks the device."""
    a = torch.zeros((NL, 3), dtype=torch.int64, device="meta")
    flags = torch.zeros((3,), dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        CC.cdbl_n_add((a, a, a), 4, (a, a, a), G1)
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        CC.cmadd((a, a, a), (a, a, flags), G1)


# ------------------------------------------------- the Jacobian law and proj

def jac_lanes(name, seed):
    """Jacobian inputs (P, Q) per lane and an affine A: P + Q generic; P at
    infinity (Z = 0); Q at infinity; P = Q (the doubling lane); P = -Q.
    Coordinates < 2p (Montgomery), Jacobian (l^2 x, l^3 y, l)."""
    pts, rnd = host_points(name, seed, 4)
    one = 1 if name == "G1" else (1, 0)

    def jac(pt, lam):
        if pt is None:
            return (mont(one), mont(one), ZERO[name])
        return (mont(f2mul(pt[0], lam * lam)), mont(f2mul(pt[1], lam ** 3)),
                mont(f2mul(one, lam)))

    lam = [rnd.randrange(1, P) for _ in range(10)]
    ps = [jac(pts[0], lam[0]), jac(None, 1), jac(pts[1], lam[1]),
          jac(pts[2], lam[2]), jac(pts[3], lam[3])]
    qs = [jac(pts[1], lam[4]), jac(pts[2], lam[5]), jac(None, 1),
          jac(pts[2], lam[6]), jac((pts[3][0], neg(pts[3][1])), lam[7])]
    affs = [pts[1], pts[0], None, pts[3], (pts[3][0], neg(pts[3][1]))]
    return ([columns(name, ps, k) for k in range(3)],
            [columns(name, qs, k) for k in range(3)], affs)


def affine_np(name, affs):
    vals = [(mont(a[0]), mont(a[1])) if a is not None
            else (ZERO[name], ZERO[name]) for a in affs]
    return (columns(name, vals, 0), columns(name, vals, 1),
            np.array([a is None for a in affs]))


def both(name, x):
    if isinstance(x, tuple) and len(x) == 3 and x[2].dtype == bool:
        return ((port(x[0]), port(x[1]), torch.as_tensor(x[2])),
                (jnp.asarray(x[0]), jnp.asarray(x[1]), jnp.asarray(x[2])))
    return tuple(map(port, x)), tuple(map(jnp.asarray, x))


def same_tree(got, want):
    for g, w in zip(got, want, strict=True):
        if isinstance(g, tuple):
            same_tree(g, w)
        else:
            same(g, np.asarray(w))


@pytest.mark.parametrize("name", ["G1", "G2"])
def test_jacobian_law_matches_jax(name):
    """add (its doubling and infinity lanes), neg, eq_jac and to_affine,
    and on G1 double and add_mixed, limb for limb (on G2 each jitted
    function costs seconds of XLA:CPU compile)."""
    curve, jcurve = CURVES[name][:2]
    p_np, q_np, affs = jac_lanes(name, 21)
    (p, jp), (q, jq) = both(name, tuple(p_np)), both(name, tuple(q_np))
    a, ja = both(name, affine_np(name, affs))

    def run(c, p, q, a):
        s = c.add(p, q)
        out = (s, c.neg(s, k=8), c.eq_jac(p, q), c.eq_jac(s, s),
               c.to_affine(s))
        if name == "G1":     # G2's double runs inside add (its P = Q lane)
            out += (c.double(p), c.add_mixed(p, a))
        return out

    same_tree(run(curve, p, q, a),
              jax.jit(lambda p, q, a: run(jcurve, p, q, a))(jp, jq, ja))


@pytest.mark.parametrize("name", ["G1", "G2"])
def test_proj_helpers_match_jax(name):
    """from_affine, to_affine (Z = 0 lanes), to_jacobian, from_jacobian,
    eq, select and inf of ops/proj.py, limb for limb."""
    curve, jcurve = CURVES[name][:2]
    p_np, q_np, affs = jac_lanes(name, 22)
    (p, jp), (q, jq) = both(name, tuple(p_np)), both(name, tuple(q_np))
    a, ja = both(name, affine_np(name, affs))
    mask, jmask = torch.tensor([1, 0, 1, 0, 1]).bool(), jnp.asarray(
        np.array([1, 0, 1, 0, 1], dtype=bool))

    def run(pj, c, p, q, a, mask):
        pa = pj.from_affine(c, a)
        return (pa, pj.to_affine(c, p), pj.to_affine(c, pa),
                pj.to_jacobian(c, p), pj.from_jacobian(c, q),
                pj.eq(c, p, q), pj.eq(c, pa, pa), pj.is_inf(c, pa),
                pj.select(c, mask, p, q))

    same_tree(run(PJ, curve, p, q, a, mask),
              jax.jit(lambda p, q, a, m: run(JPJ, jcurve, p, q, a, m))(
                  jp, jq, ja, jmask))
    inf = PJ.inf(curve, (2,), device="cpu")
    same_tree(inf, JPJ.inf(jcurve, (2,)))


@pytest.mark.parametrize("field", ["Fq", "Fq2"])
def test_inv_batch_matches_jax(field):
    """The blocked Montgomery trick (>= 128 lanes, zero lanes -> 0) and the
    Fermat path below it, limb for limb."""
    rnd = random.Random(31)
    n = 131                                 # 5 rows of 32 with padding
    if field == "Fq":
        vals = [rnd.randrange(8 * P) for _ in range(n)]
        for lane, v in ((0, 0), (5, P), (6, 7 * P), (7, 8 * P - 1)):
            vals[lane] = v
        x = ints_to_limbs(vals, NL)
        F, JF = FQ, JFQ
    else:
        vals = [(rnd.randrange(8 * P), rnd.randrange(8 * P)) for _ in range(n)]
        vals[0], vals[5], vals[6] = (0, 0), (P, 2 * P), (0, 7)
        x = coords("G2", vals)
        F, JF = FQ2, JFQ2
    got = F.inv_batch(port(x))
    same(got, np.asarray(jax.jit(JF.inv_batch)(jnp.asarray(x))))
    small = x[..., :4]
    same(F.inv_batch(port(small)),
         np.asarray(jax.jit(JF.inv_batch)(jnp.asarray(small))))
    if field == "Fq":                       # and they are inverses, 0 -> 0
        inv = F.to_ints(got)
        for v, w in zip(vals, inv):
            assert w == (0 if v % P == 0 else pow(v * pow(FQ.r_mod_p, -1, P)
                                                  % P, -1, P))


# ------------------------------------------------------------- scalar_mul

def scalar_lanes():
    """Scalars 0, 1, r - 1, 2^254 - 1 (every nibble 15 but the top), a
    random one, and one on a point at infinity."""
    rnd = random.Random(41)
    return [0, 1, C.R - 1, (1 << 254) - 1, rnd.randrange(C.R), 5]


@pytest.mark.parametrize("name", ["G1", "G2"])
def test_scalar_mul_matches_host(name):
    """[k] P by value, through 14 cmadd and 64 cdbl_n_add launches of the
    plain versions."""
    curve, _, mul = CURVES[name][:3]
    ks = scalar_lanes()
    pts, _ = host_points(name, 42, len(ks))
    pts[-1] = None
    from_ints = g2_affine_from_ints if name == "G2" else g1_affine_from_ints
    to_ints = g2_affine_to_ints if name == "G2" else g1_affine_to_ints
    s = torch.as_tensor(ints_to_limbs(ks, 17).astype(np.int64))
    before = {k: k.launches for k in CC.KERNELS}
    out = curve.to_affine(curve.scalar_mul(from_ints(pts, device="cpu"), s))
    assert to_ints(out) == [None if pt is None else mul(pt, k)
                            for pt, k in zip(pts, ks)]
    assert {k: k.launches for k in CC.KERNELS} == before   # CPU: no launch


@pytest.mark.gpu
def test_curve_kernels_match_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels are CUDA C++ for sm_90a")
    for name in ("G1", "G2"):
        curve = G2 if name == "G2" else G1
        accs, affs, inf = madd_lanes(name, 51)
        acc = tuple(limbs_from_numpy(columns(name, accs, k), device="cuda")
                    for k in range(3))
        aff = (limbs_from_numpy(columns(name, affs, 0), device="cuda"),
               limbs_from_numpy(columns(name, affs, 1), device="cuda"),
               torch.tensor(inf, device="cuda"))
        ps, qs = proj_lanes(name, 52)
        p = tuple(limbs_from_numpy(columns(name, ps, k), device="cuda")
                  for k in range(3))
        q = tuple(limbs_from_numpy(columns(name, qs, k), device="cuda")
                  for k in range(3))
        for kern, args in ((CC.cmadd, (acc, aff, curve)),
                           (CC.cdbl_n_add, (p, 4, q, curve)),
                           (CC.cdbl_n_add, (p, 0, q, curve))):
            before = kern.launches
            got = kern(*args)
            want = CC.PLAIN[kern](*args)
            torch.cuda.synchronize()
            assert kern.launches == before + 1
            for g, w in zip(got, want):
                assert torch.equal(g, w), (name, kern.__name__)
