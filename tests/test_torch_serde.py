"""The port's wire format (groth_sahai_tpu_torch.utils.serde, utils.native)
and its checkpointed chunked MSM (ops.msm_chunked) against the JAX
package's.

The same objects go through both packages' writers (the port's tensors,
and the JAX package's objects over the same arrays as numpy) and must give
the same bytes: points, GT, ComT, Com vectors, the CRS, the four statement
types, proofs, CProof and the bulk writers. The port's readers round-trip,
the known answers and rejections of tests/test_serde_vectors.py hold, and
the two gaps the JAX package leaves (no range check in `fr_from_bytes`, no
subgroup check in `gt_from_bytes`) are there in both. The port's native
codec library (its own copy of limbs.cpp, built by g++) is held against
its numpy versions and against the JAX package's library. The JAX
package's validating bulk readers are not run: their XLA:CPU compiles take
minutes. The port's bulk readers run their device checks on the CPU here
(the kernels' plain versions).
"""

import os

import numpy as np
import pytest
import torch

from groth_sahai_tpu.models import crs as JCRS
from groth_sahai_tpu.models import prover as JPV
from groth_sahai_tpu.ops.curve import (g1_affine_from_ints as j_g1,
                                       g2_affine_from_ints as j_g2)
from groth_sahai_tpu.ops.tower import FQ12 as JFQ12
from groth_sahai_tpu.utils import native as jnative
from groth_sahai_tpu.utils import serde as JS
from groth_sahai_tpu.utils.rng import GsRng as JGsRng

from groth_sahai_tpu_torch.ops import bls12_381 as C
from groth_sahai_tpu_torch.ops.curve import (G1, g1_affine_from_ints,
                                             g1_affine_to_ints,
                                             g2_affine_from_ints,
                                             g2_affine_to_ints)
from groth_sahai_tpu_torch.ops.fp import FR
from groth_sahai_tpu_torch.ops.msm_chunked import msm_chunked
from groth_sahai_tpu_torch.ops.tower import FQ12
from groth_sahai_tpu_torch.models import statement as ST
from groth_sahai_tpu_torch.utils import hostcrypto as H
from groth_sahai_tpu_torch.utils import metrics, native
from groth_sahai_tpu_torch.utils import serde as S
from groth_sahai_tpu_torch.utils.convert import (crs_from_numpy,
                                                 statement_from_numpy,
                                                 to_numpy)
from groth_sahai_tpu_torch.utils.rng import GsRng

from .test_serde_vectors import (G1C, G1INF_C, G1U, G2C, G2U,
                                 _find_non_subgroup_g1)
from .test_torch_batch import Host, fr, host_proof, one_thread_module  # noqa: F401
from .test_torch_gs import scenario
from .test_torch_tower import one_thread  # noqa: F401

DEV = "cpu"
R = C.R
G1_GEN = (C.G1_GEN_X, C.G1_GEN_Y)
G2_GEN = (C.G2_GEN_X, C.G2_GEN_Y)


def g1s(ks):
    return [None if k is None else H.g1_mul(G1_GEN, k) for k in ks]


def g2s(ks):
    return [None if k is None else H.g2_mul(G2_GEN, k) for k in ks]


def com(pts, from_ints):
    """2k host points (component-major) -> a Com vector (2, k)."""
    x, y, inf = from_ints(pts, device=DEV)
    k = len(pts) // 2
    return (x.reshape(x.shape[:-1] + (2, k)), y.reshape(y.shape[:-1] + (2, k)),
            inf.reshape(2, k))


def as_numpy(v):
    """A port value (tensor or affine tuple) -> the same arrays as numpy,
    the form the JAX package's writers read."""
    return tuple(to_numpy(c) for c in v) if isinstance(v, tuple) \
        else to_numpy(v)


def jax_cproof(cp):
    """The JAX package's CProof over a port CProof's arrays."""
    jcommit = lambda cls, c: cls(coms=as_numpy(c.coms),
                                 rand=to_numpy(c.rand),
                                 row_widths=c.row_widths)
    return JPV.CProof(
        xcoms=jcommit(JPV.Commit1, cp.xcoms),
        ycoms=jcommit(JPV.Commit2, cp.ycoms),
        equ_proofs=[JPV.EquProof(pi=as_numpy(p.pi), theta=as_numpy(p.theta),
                                 equ_type=p.equ_type) for p in cp.equ_proofs])


def same(a, b):
    la = [a] if torch.is_tensor(a) else list(a)
    lb = [b] if torch.is_tensor(b) else list(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert torch.equal(x, y)


def same_values(curve_ints, a, b):
    """Equal points (the readers' limbs are Montgomery forms < 2p)."""
    assert curve_ints(a) == curve_ints(b)


# ------------------------------------------------------------- fixtures

@pytest.fixture(scope="module")
def jax_crs():
    return JCRS.generate_crs(JGsRng(2024))


@pytest.fixture(scope="module")
def crs(jax_crs):
    return crs_from_numpy(jax_crs, device=DEV)


@pytest.fixture(scope="module")
def cproof(crs):
    """A PPE proof (m = 2, n = 1) from the GS formulas on the host."""
    host = Host(crs)
    equ = ST.PPE(host.G1s([11]), host.G2s([None, 13]),
                 fr([3, 0]).reshape(FR.n, 2, 1), host.gtp(5))
    return host_proof(host, equ, [host.m1(11)], [None, host.m2(13)],
                      [[3], [0]], [host.m1(2), host.m1(3)], [host.m2(4)],
                      GsRng(5))


# ---------------------------------------------- same bytes as the JAX writers

@pytest.mark.parametrize("compressed", [True, False])
def test_point_writers_match_jax(compressed):
    p1 = g1s([1, 7, None, 2 ** 200 + 3])
    p2 = g2s([1, None, 9])
    for pt in p1:
        assert S.g1_point_to_bytes(pt, compressed) == \
            JS.g1_point_to_bytes(pt, compressed)
    for pt in p2:
        assert S.g2_point_to_bytes(pt, compressed) == \
            JS.g2_point_to_bytes(pt, compressed)
    a1, a2 = g1_affine_from_ints(p1, device=DEV), g2_affine_from_ints(p2,
                                                                      device=DEV)
    assert S.g1_vec_to_bytes(a1, compressed) == JS.g1_vec_to_bytes(j_g1(p1),
                                                                   compressed)
    assert S.g2_vec_to_bytes(a2, compressed) == JS.g2_vec_to_bytes(j_g2(p2),
                                                                   compressed)
    one1 = tuple(c[..., 1] for c in a1)
    assert S.g1_to_bytes(one1, compressed) == JS.g1_point_to_bytes(p1[1],
                                                                   compressed)


@pytest.mark.parametrize("compressed", [True, False])
def test_com_vec_writers_match_jax(compressed):
    c1 = com(g1s([1, 2, None, 4, 5, 6]), g1_affine_from_ints)
    c2 = com(g2s([3, None, 5, 6]), g2_affine_from_ints)
    assert S.com1_vec_to_bytes(c1, compressed) == \
        JS.com1_vec_to_bytes(as_numpy(c1), compressed)
    assert S.com2_vec_to_bytes(c2, compressed) == \
        JS.com2_vec_to_bytes(as_numpy(c2), compressed)


def test_gt_and_comt_writers_match_jax():
    gt = H.pairing_gen()
    vals = [gt, H.f12_pow(gt, 2), H.f12_pow(gt, 3), H.f12_pow(gt, 0)]
    assert S.gt_to_bytes(gt) == JS.gt_to_bytes(gt)
    arr = FQ12.from_ints(vals, device=DEV)
    comt = arr.reshape(arr.shape[0], 12, 2, 2)
    b = S.comt_to_bytes(comt)
    jarr = JFQ12.from_ints(vals)
    assert b == JS.comt_to_bytes(jarr.reshape(jarr.shape[0], 12, 2, 2))
    back, off = S.comt_from_bytes(b, device=DEV)
    assert off == len(b) == 4 * 576 and S.comt_to_bytes(back) == b
    assert FQ12.to_ints(back.reshape(25, 12, 4)) == vals


def test_crs_writer_matches_jax(jax_crs, crs):
    for compressed in (True, False):
        b = S.crs_to_bytes(crs, compressed)
        assert b == JS.crs_to_bytes(jax_crs, compressed)
        back, off = S.crs_from_bytes(b, compressed=compressed, device=DEV)
        assert off == len(b) and S.crs_to_bytes(back, compressed) == b
    # the reader re-derives the iota' bases: the generated CRS's, as points
    for got, want in ((back.u_base, crs.u_base), (back.v_base, crs.v_base)):
        to_ints = g2_affine_to_ints if got[0].ndim == 3 else g1_affine_to_ints
        same_values(to_ints, got, want)


@pytest.mark.parametrize("name", ["PPE", "MSMEG1", "MSMEG2", "QuadEqu"])
def test_statement_writers_match_jax(name, crs):
    host = Host(crs)
    jequ = scenario(name, host.g1, host.g2, host.gt)[0]
    equ = statement_from_numpy(jequ, device=DEV)
    for compressed in (True, False):
        for tagged in (True, False):
            b = S.equ_to_bytes(equ, compressed, tagged)
            assert b == JS.equ_to_bytes(jequ, compressed, tagged)
        b = S.equ_to_bytes(equ, compressed)
        back, off = S.equ_from_bytes(b, compressed=compressed, device=DEV)
        assert off == len(b) and back.equ_type == equ.equ_type
        assert S.equ_to_bytes(back, compressed) == b
        untagged, off = S.equ_from_bytes(b[1:], compressed=compressed,
                                         equ_type=equ.equ_type, device=DEV)
        assert off == len(b) - 1 and S.equ_to_bytes(untagged, compressed) == b


def test_proof_and_cproof_writers_match_jax(cproof):
    jcp = jax_cproof(cproof)
    for compressed in (True, False):
        assert S.proof_to_bytes(cproof.equ_proofs[0], compressed) == \
            JS.proof_to_bytes(jcp.equ_proofs[0], compressed)
        assert S.commit1_to_bytes(cproof.xcoms, compressed) == \
            JS.commit1_to_bytes(jcp.xcoms, compressed)
        assert S.commit2_to_bytes(cproof.ycoms, compressed) == \
            JS.commit2_to_bytes(jcp.ycoms, compressed)
        b = S.cproof_to_bytes(cproof, compressed)
        assert b == JS.cproof_to_bytes(jcp, compressed)
        back, off = S.cproof_from_bytes(b, compressed=compressed, device=DEV)
        assert off == len(b) and S.cproof_to_bytes(back, compressed) == b
        assert back.equ_proofs[0].equ_type == ST.EquType.PairingProduct
        same(back.xcoms.rand, cproof.xcoms.rand)
        same(back.ycoms.rand, cproof.ycoms.rand)


def test_bulk_writers_match_jax():
    p1, p2 = g1s([1, 2, None, 7, 2 ** 100]), g2s([1, None, 3])
    a1 = g1_affine_from_ints(p1, device=DEV)
    a2 = g2_affine_from_ints(p2, device=DEV)
    for compressed in (True, False):
        b1 = S.g1_vec_to_bytes_bulk(a1, compressed)
        assert b1 == JS.g1_vec_to_bytes_bulk(j_g1(p1), compressed)
        assert b1 == S.g1_vec_to_bytes(a1, compressed)
        b2 = S.g2_vec_to_bytes_bulk(a2, compressed)
        assert b2 == JS.g2_vec_to_bytes_bulk(j_g2(p2), compressed)
        assert b2 == S.g2_vec_to_bytes(a2, compressed)
    s = GsRng(13).fr_std((5,), device=DEV)
    b = S.fr_vec_to_bytes_bulk(s)
    assert b == JS.fr_vec_to_bytes_bulk(to_numpy(s)) == S.fr_vec_to_bytes(s)
    back, off = S.fr_vec_from_bytes_bulk(b, device=DEV)
    assert off == len(b)
    same(back, s)
    back, off = S.fr_vec_from_bytes(b, device=DEV)
    assert off == len(b)
    same(back, s)


def test_fr_matrix_codec_ragged_rows():
    """A ragged Matrix<Fr> (a mixed append's rows) is written with each
    row's true width, as the JAX package writes it, and read back
    zero-padded with its widths."""
    rows = [[3, 4], [5, 0]]
    mat = fr(sum(rows, [])).reshape(FR.n, 2, 2)
    b = S.fr_mat_to_bytes(mat, row_widths=(2, 1))
    assert b == JS.fr_mat_to_bytes(to_numpy(mat), row_widths=(2, 1))
    back, off, widths = S.fr_mat_from_bytes(b, device=DEV)
    assert off == len(b) and widths == (2, 1)
    same(back, mat)
    empty, off, widths = S.fr_mat_from_bytes(S._vec_prefix(0), device=DEV)
    assert tuple(empty.shape) == (FR.n, 0, 0) and widths is None


def test_proof_reader_skips_reference_rand():
    """EquProof bytes as the reference writes them, with a nonempty 2 x 2
    rand (T) matrix: the reader skips it and lands on what follows."""
    pi = com(g2s([1, 2]), g2_affine_from_ints)
    theta = com(g1s([3, 4, 5, 6]), g1_affine_from_ints)
    blob = S.com2_vec_to_bytes(pi) + S.com1_vec_to_bytes(theta)
    blob += bytes([int(ST.EquType.PairingProduct)]) + S._vec_prefix(2)
    for row in ([11, 12], [13, 14]):
        blob += S._vec_prefix(2) + b"".join(S.fr_to_bytes(v) for v in row)
    blob += b"\xAB\xCD"
    proof, off = S.proof_from_bytes(blob, device=DEV)
    assert blob[off:] == b"\xAB\xCD"
    assert S.com2_vec_to_bytes(proof.pi) == S.com2_vec_to_bytes(pi)
    assert S.com1_vec_to_bytes(proof.theta) == S.com1_vec_to_bytes(theta)
    assert len(S.proof_to_bytes(proof)) == 8 + 192 + 8 + 192 + 1 + 8


# -------------------------------------------- known answers and rejections

def test_known_answers():
    assert S.g1_point_to_bytes(G1_GEN, True) == G1C
    assert S.g1_point_to_bytes(G1_GEN, False) == G1U
    assert S.g2_point_to_bytes(G2_GEN, True) == G2C
    assert S.g2_point_to_bytes(G2_GEN, False) == G2U
    assert S.g1_point_from_bytes(G1C) == G1_GEN
    assert S.g1_point_from_bytes(G1U, compressed=False) == G1_GEN
    assert S.g2_point_from_bytes(G2C) == G2_GEN
    assert S.g2_point_from_bytes(G2U, compressed=False) == G2_GEN
    assert S.g1_point_to_bytes(None) == G1INF_C
    assert S.g1_point_from_bytes(G1INF_C) is None


def _x_off_curve():
    x = 1
    while pow((pow(x, 3, C.P) + C.B_G1) % C.P, (C.P - 1) // 2, C.P) == 1:
        x += 1
    return x


def test_point_readers_reject():
    bad = S.fq_to_bytes(_x_off_curve())
    with pytest.raises(ValueError, match="not on curve"):
        S.g1_point_from_bytes(bad)
    bad_u = bytearray(S.g1_point_to_bytes(G1_GEN, False))
    bad_u[0] ^= 1
    with pytest.raises(ValueError, match="not on curve"):
        S.g1_point_from_bytes(bytes(bad_u), compressed=False)
    pt = _find_non_subgroup_g1()
    for compressed in (True, False):
        with pytest.raises(ValueError, match="subgroup"):
            S.g1_point_from_bytes(S.g1_point_to_bytes(pt, compressed),
                                  compressed)
    assert S.g1_point_from_bytes(S.g1_point_to_bytes(pt), validate=False) == pt
    with pytest.raises(ValueError, match="field range"):
        S.g1_point_from_bytes(S.fq_to_bytes(C.P))


def test_bulk_readers_roundtrip_and_reject():
    """The bulk readers (decompression and validation on the device of
    `device`, here the CPU) give back the written points; an x off the
    curve and an on-curve point outside the r-torsion are refused."""
    p1 = g1s([1, 2, None, 7])
    a1 = g1_affine_from_ints(p1, device=DEV)
    b1 = S.g1_vec_to_bytes_bulk(a1, compressed=True)
    back, off = S.g1_vec_from_bytes_bulk_compressed(b1, device=DEV)
    assert off == len(b1) and g1_affine_to_ints(back) == p1
    bu = S.g1_vec_to_bytes_bulk(a1, compressed=False)
    back, off = S.g1_vec_from_bytes_bulk(bu, device=DEV)
    assert off == len(bu) and g1_affine_to_ints(back) == p1
    p2 = g2s([1, None, 3])
    a2 = g2_affine_from_ints(p2, device=DEV)
    b2 = S.g2_vec_to_bytes_bulk(a2, compressed=True)
    back, off = S.g2_vec_from_bytes_bulk_compressed(b2, device=DEV)
    assert off == len(b2) and g2_affine_to_ints(back) == p2
    back, off = S.g2_vec_from_bytes_bulk(S.g2_vec_to_bytes_bulk(a2, False),
                                         device=DEV)
    assert g2_affine_to_ints(back) == p2

    off_curve = bytearray(b1)
    off_curve[8 + 48:8 + 96] = S.fq_to_bytes(_x_off_curve())
    with pytest.raises(ValueError, match="not on curve"):
        S.g1_vec_from_bytes_bulk_compressed(bytes(off_curve), device=DEV)
    sub = S._vec_prefix(2) + S.g1_point_to_bytes(p1[0]) + \
        S.g1_point_to_bytes(_find_non_subgroup_g1())
    with pytest.raises(ValueError, match="subgroup"):
        S.g1_vec_from_bytes_bulk_compressed(sub, device=DEV)
    back, _ = S.g1_vec_from_bytes_bulk_compressed(sub, validate=False,
                                                  device=DEV)
    assert g1_affine_to_ints(back)[1] == _find_non_subgroup_g1()
    bad_u = bytearray(bu)
    bad_u[8 + 3] ^= 1
    with pytest.raises(ValueError, match="not on curve"):
        S.g1_vec_from_bytes_bulk(bytes(bad_u), device=DEV)


def test_reference_gaps_carried():
    """fr_from_bytes takes values >= r as they are; gt_from_bytes checks
    no subgroup (nor range); the bulk G1 readers take an Fq coordinate
    >= p (G1's generator with x + p for x reads as the generator), where
    the single-point readers refuse it: all as in the JAX package."""
    big = S.fr_to_bytes(R + 5)
    assert S.fr_from_bytes(big) == JS.fr_from_bytes(big) == R + 5
    vec = S._vec_prefix(1) + big
    got, _ = S.fr_vec_from_bytes(vec, device=DEV)
    assert to_numpy(got)[:, 0].tolist() == \
        np.asarray(JS.fr_vec_from_bytes(vec)[0])[:, 0].tolist()
    not_gt = b"".join(S.fq_to_bytes(v) for v in [1, 2] + [0] * 9 + [C.P + 1])
    assert S.gt_from_bytes(not_gt) == JS.gt_from_bytes(not_gt)
    assert S.gt_from_bytes(not_gt)[0][0] == (1, 2)

    gen = (C.G1_GEN_X, C.G1_GEN_Y)
    x_big = bytearray(S.fq_to_bytes(C.G1_GEN_X + C.P))
    assert x_big[47] == 0x31                      # no flag bit set
    unc = bytes(x_big) + S.fq_to_bytes(C.G1_GEN_Y)
    if S._is_neg_fq(C.G1_GEN_Y):
        x_big[47] |= S.FLAG_NEG
    comp = bytes(x_big)
    for reader, one in ((S.g1_vec_from_bytes_bulk, unc),
                        (S.g1_vec_from_bytes_bulk_compressed, comp)):
        blob = S._vec_prefix(1) + one
        aff, off = reader(blob, device=DEV)       # validated: accepted
        assert off == len(blob) and g1_affine_to_ints(aff) == [gen]
    # the JAX package's bulk reader takes the same limbs (its validation,
    # a jitted scalar multiplication, is not compiled here: the value is
    # the generator)
    blob = S._vec_prefix(1) + unc
    jaff, _ = JS.g1_vec_from_bytes_bulk(blob, validate=False)
    aff, _ = S.g1_vec_from_bytes_bulk(blob, validate=False, device=DEV)
    for port, jx in zip(aff, jaff):
        np.testing.assert_array_equal(to_numpy(port), np.asarray(jx))
    with pytest.raises(ValueError, match="x out of field range"):
        S.g1_point_from_bytes(comp, compressed=True)
    with pytest.raises(ValueError, match="not on curve"):
        S.g1_point_from_bytes(unc, compressed=False)


# --------------------------------------------------------------- native

def test_native_matches_numpy_and_the_jax_packages_library():
    rng = np.random.default_rng(3)
    for nbytes, n_limbs in ((48, 25), (32, 17)):
        data = rng.integers(0, 256, size=nbytes * 7, dtype=np.uint8).tobytes()
        limbs = native.bytes_to_limbs(data, nbytes, n_limbs)
        assert limbs.shape == (n_limbs, 7)
        np.testing.assert_array_equal(
            limbs, native.bytes_to_limbs_plain(data, nbytes, n_limbs))
        np.testing.assert_array_equal(
            limbs, jnative.bytes_to_limbs(data, nbytes, n_limbs))
        back = native.limbs_to_bytes(limbs, nbytes)
        assert back == data == native.limbs_to_bytes_plain(limbs, nbytes) \
            == jnative.limbs_to_bytes(limbs, nbytes)
    s = to_numpy(GsRng(11).fr_std((9,), device=DEV))
    for window in (4, 8, 13):
        d = native.scalar_digits(s, window)
        np.testing.assert_array_equal(d, native.scalar_digits_plain(s, window))
        np.testing.assert_array_equal(d, jnative.scalar_digits(s, window))
    assert native.library_path().parent.name == "build"
    assert native.library_path().exists()


def test_native_build_failure_raises(monkeypatch, tmp_path):
    """No fallback: a library that cannot be built raises."""
    bad = tmp_path / "limbs.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "_LIB", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.bytes_to_limbs(b"\x00" * 48, 48, 25)
    assert not list(tmp_path.glob("*.so")) and not list(tmp_path.glob("*.tmp"))


# ----------------------------------------------------------- msm_chunked

def test_msm_chunked_resumes(tmp_path):
    """40 G1 points in 3 chunks of 16: the host oracle; a rerun after
    deleting one partial reads the other two back (msm_chunks_resumed) and
    gives the same point; a partial's bytes are the JAX package's bulk
    writer's for the same affine point."""
    rng = np.random.default_rng(17)
    logs = [int(v) for v in rng.integers(1, 1000, size=40)]
    logs[5] = None
    pts = g1_affine_from_ints(g1s(logs), device=DEV)
    sc = [int.from_bytes(rng.bytes(32), "little") % R for _ in range(40)]
    sc[:3] = [0, 1, R - 1]
    s = fr(sc)
    want = H.g1_mul(G1_GEN, sum(a * b for a, b in zip(logs, sc) if a) % R)
    ckpt = str(tmp_path / "ckpt")
    metrics.reset()
    out = msm_chunked(G1, pts, s, chunk_size=16, ckpt_dir=ckpt)
    to_pt = lambda j: g1_affine_to_ints(G1.to_affine(tuple(c[..., None]
                                                           for c in j)))[0]
    assert to_pt(out) == want
    names = sorted(os.listdir(ckpt))
    assert names == ["manifest.json"] + [f"msm_partial_{i:06d}.bin"
                                         for i in range(3)]
    part1 = open(os.path.join(ckpt, names[2]), "rb").read()
    aff1, _ = S.g1_vec_from_bytes_bulk(part1, device=DEV)
    assert part1 == JS.g1_vec_to_bytes_bulk(as_numpy(aff1), compressed=False)
    assert metrics.snapshot().get("count/msm_chunks_resumed", 0) == 0
    assert metrics.snapshot()["count/msm_points"] == 40

    os.remove(os.path.join(ckpt, names[2]))
    metrics.reset()
    again = msm_chunked(G1, pts, s, chunk_size=16, ckpt_dir=ckpt)
    assert to_pt(again) == want
    assert metrics.snapshot()["count/msm_chunks_resumed"] == 2
    assert metrics.snapshot()["count/msm_points"] == 16
    assert open(os.path.join(ckpt, names[2]), "rb").read() == part1
    metrics.reset()
