"""arkworks-canonical serialization for CRS / commitments / proofs.

The port of ``groth_sahai_tpu/utils/serde.py``: the same wire format, byte
for byte; readers make the port's tensors on an explicit ``device`` (the
card unless the caller asks for the CPU).

Byte-compatible (to the best verifiable extent without a Rust toolchain in
this environment) with `ark-serialize` 0.4 as used by the reference's
derives (data_structures.rs:128-133, generator.rs:35, commit.rs:18-28,
prove.rs:55, statement.rs:61-97):

  * Fq: 48 bytes little-endian; Fr: 32 bytes LE.
  * Fq2: c0 then c1. Fq12: tower order c0.c0.c0 .. c1.c2.c1 (12 x 48 bytes).
  * G1 compressed: x LE with flags in the top bits of the LAST byte:
      0x40 = point at infinity, 0x80 = y is "negative" (y > -y; for Fq2
      the (c1, c0)-lexicographic comparison).
    Uncompressed: x || y, infinity flag on the last byte of y.
  * G2: same with x in Fq2 (96 bytes compressed).
  * Vec<T>: u64 LE length prefix then elements.
  * EquType: 1 byte (statement.rs:68-74).

Security note: the reference serializes the private proof-randomness matrix
inside EquProof (prove.rs:60). Our native format OMITS it (writing an empty
matrix) -- publishing prover randomness is at best wasteful; the reader
still accepts reference-produced bytes by skipping the field.

The single-point readers decompress (sqrt in Fq / Fq2) and validate on the
host, on Python ints (utils/hostmath.py). The bulk readers decompress and
validate the whole batch on the device: the `pow_const` kernel takes the
square roots, `on_curve_affine` and `scalar_mul` by r (the `cmadd` and
`cdbl_n_add` kernels) the checks.

Two gaps of the JAX package are carried as they are: `fr_from_bytes`
accepts values >= r (no range check), and `gt_from_bytes` makes no
subgroup (or range) check of the 12 coefficients.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import bls12_381 as C
from ..ops.fp import FQ, FR, resolve_device
from ..ops.limbs import int_to_limbs, ints_to_limbs, limbs_to_ints
from ..ops.curve import (G1, G2, g1_affine_from_ints, g2_affine_from_ints,
                         g1_affine_to_ints, g2_affine_to_ints)
from ..ops.tower import FQ2, FQ12
from . import hostmath, native

P = C.P


# ---------------------------------------------------------------------------
# field element bytes
# ---------------------------------------------------------------------------

def fq_to_bytes(v: int) -> bytes:
    return int(v).to_bytes(48, "little")


def fq_from_bytes(b: bytes) -> int:
    return int.from_bytes(b, "little")


def fr_to_bytes(v: int) -> bytes:
    return int(v).to_bytes(32, "little")


def fr_from_bytes(b: bytes) -> int:
    """No range check, as in the JAX package: values >= r come back as
    they are."""
    return int.from_bytes(b, "little")


def _sqrt_fq(a: int):
    s = pow(a, (P + 1) // 4, P)          # p % 4 == 3
    return s if (s * s) % P == a else None


def _sqrt_fq2(a):
    """sqrt in Fq2 = Fq[u]/(u^2+1); returns (c0, c1) or None."""
    a0, a1 = a
    if a1 == 0:
        s = _sqrt_fq(a0)
        if s is not None:
            return (s, 0)
        s = _sqrt_fq((-a0) % P)
        return None if s is None else (0, s)
    n = (a0 * a0 + a1 * a1) % P
    sn = _sqrt_fq(n)
    if sn is None:
        return None
    two_inv = pow(2, P - 2, P)
    x0sq = (a0 + sn) * two_inv % P
    x0 = _sqrt_fq(x0sq)
    if x0 is None:
        x0 = _sqrt_fq((a0 - sn) * two_inv % P)
        if x0 is None:
            return None
    x1 = a1 * pow(2 * x0, P - 2, P) % P
    cand = (x0, x1)
    c0, c1 = cand
    if (c0 * c0 - c1 * c1) % P == a0 and (2 * c0 * c1) % P == a1:
        return cand
    return None


def _is_neg_fq(y: int) -> bool:
    return y > (P - y) % P


def _is_neg_fq2(y) -> bool:
    c0, c1 = y
    n0, n1 = (P - c0) % P, (P - c1) % P
    return (c1, c0) > (n1, n0)


# ---------------------------------------------------------------------------
# points
# ---------------------------------------------------------------------------

FLAG_INF = 0x40
FLAG_NEG = 0x80


def g1_point_to_bytes(pt, compressed=True) -> bytes:
    """pt: (x, y) ints or None for infinity."""
    if compressed:
        if pt is None:
            b = bytearray(fq_to_bytes(0))
            b[-1] |= FLAG_INF
            return bytes(b)
        x, y = pt
        b = bytearray(fq_to_bytes(x))
        if _is_neg_fq(y):
            b[-1] |= FLAG_NEG
        return bytes(b)
    if pt is None:
        b = bytearray(fq_to_bytes(0) + fq_to_bytes(0))
        b[-1] |= FLAG_INF
        return bytes(b)
    return fq_to_bytes(pt[0]) + fq_to_bytes(pt[1])


def g1_point_from_bytes(b: bytes, compressed=True, validate=True):
    """Reader with arkworks `Validate::Yes` semantics by default: on-curve
    (free on the compressed path, checked on the uncompressed one) and
    r-torsion subgroup membership (utils/hostmath.py). Pass validate=False
    only for trusted bytes."""
    if compressed:
        assert len(b) == 48
        raw = bytearray(b)
        flags = raw[-1] & 0xC0
        raw[-1] &= 0x3F
        x = fq_from_bytes(bytes(raw))
        if flags & FLAG_INF:
            return None
        if x >= P:
            raise ValueError("x out of field range")
        ysq = (pow(x, 3, P) + C.B_G1) % P
        y = _sqrt_fq(ysq)
        if y is None:
            raise ValueError("x not on curve")
        if bool(flags & FLAG_NEG) != _is_neg_fq(y):
            y = (P - y) % P
        pt = (x, y)
        if validate and not hostmath.g1_in_subgroup(pt):
            raise ValueError("G1 point not in the r-torsion subgroup")
        return pt
    assert len(b) == 96
    raw = bytearray(b)
    flags = raw[-1] & 0xC0
    raw[-1] &= 0x3F
    x = fq_from_bytes(bytes(raw[:48]))
    y = fq_from_bytes(bytes(raw[48:]))
    if flags & FLAG_INF:
        return None
    pt = (x, y)
    if validate:
        if not hostmath.g1_on_curve(pt):
            raise ValueError("G1 point not on curve")
        if not hostmath.g1_in_subgroup(pt):
            raise ValueError("G1 point not in the r-torsion subgroup")
    return pt


def g2_point_to_bytes(pt, compressed=True) -> bytes:
    if compressed:
        if pt is None:
            b = bytearray(fq_to_bytes(0) * 2)
            b[-1] |= FLAG_INF
            return bytes(b)
        (x0, x1), y = pt
        b = bytearray(fq_to_bytes(x0) + fq_to_bytes(x1))
        if _is_neg_fq2(y):
            b[-1] |= FLAG_NEG
        return bytes(b)
    if pt is None:
        b = bytearray(fq_to_bytes(0) * 4)
        b[-1] |= FLAG_INF
        return bytes(b)
    (x0, x1), (y0, y1) = pt
    return (fq_to_bytes(x0) + fq_to_bytes(x1)
            + fq_to_bytes(y0) + fq_to_bytes(y1))


def g2_point_from_bytes(b: bytes, compressed=True, validate=True):
    """G2 reader; see g1_point_from_bytes for the validation contract."""
    if compressed:
        assert len(b) == 96
        raw = bytearray(b)
        flags = raw[-1] & 0xC0
        raw[-1] &= 0x3F
        x = (fq_from_bytes(bytes(raw[:48])), fq_from_bytes(bytes(raw[48:])))
        if flags & FLAG_INF:
            return None
        if x[0] >= P or x[1] >= P:
            raise ValueError("x out of field range")
        # y^2 = x^3 + 4(u+1)
        x0, x1 = x
        xsq = ((x0 * x0 - x1 * x1) % P, 2 * x0 * x1 % P)
        xcb = ((xsq[0] * x0 - xsq[1] * x1) % P,
               (xsq[0] * x1 + xsq[1] * x0) % P)
        ysq = ((xcb[0] + C.B_G2[0]) % P, (xcb[1] + C.B_G2[1]) % P)
        y = _sqrt_fq2(ysq)
        if y is None:
            raise ValueError("x not on curve")
        if bool(flags & FLAG_NEG) != _is_neg_fq2(y):
            y = ((P - y[0]) % P, (P - y[1]) % P)
        pt = (x, y)
        if validate and not hostmath.g2_in_subgroup(pt):
            raise ValueError("G2 point not in the r-torsion subgroup")
        return pt
    assert len(b) == 192
    raw = bytearray(b)
    flags = raw[-1] & 0xC0
    raw[-1] &= 0x3F
    if flags & FLAG_INF:
        return None
    pt = ((fq_from_bytes(bytes(raw[0:48])), fq_from_bytes(bytes(raw[48:96]))),
          (fq_from_bytes(bytes(raw[96:144])),
           fq_from_bytes(bytes(raw[144:192]))))
    if validate:
        if not hostmath.g2_on_curve(pt):
            raise ValueError("G2 point not on curve")
        if not hostmath.g2_in_subgroup(pt):
            raise ValueError("G2 point not in the r-torsion subgroup")
    return pt


# ---------------------------------------------------------------------------
# container helpers
# ---------------------------------------------------------------------------

def _vec_prefix(n: int) -> bytes:
    return int(n).to_bytes(8, "little")


def _read_prefix(b, off):
    return int.from_bytes(b[off:off + 8], "little"), off + 8


def _np(t) -> np.ndarray:
    """A port tensor (or a numpy array) -> numpy on the host."""
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def _limbs(arr, device) -> torch.Tensor:
    """Host uint32 limbs -> the port's int64 limb tensor on `device`."""
    return torch.as_tensor(np.asarray(arr).astype(np.int64),
                           device=resolve_device(device))


def gt_to_bytes(vals12) -> bytes:
    """Fq12 as 12 Fq coefficients in arkworks tower order.

    vals12: nested ((c0 pairs...), (c1 pairs...)) like `FQ12.to_ints`.
    """
    out = b""
    for six in vals12:                  # c0 (Fq6), c1 (Fq6)
        for pair in six:                # 3 Fq2
            out += fq_to_bytes(pair[0]) + fq_to_bytes(pair[1])
    return out


def gt_from_bytes(b: bytes):
    """No subgroup check, as in the JAX package: any 12 coefficients below
    2^384 are accepted (values >= p too)."""
    assert len(b) == 576
    vals = [fq_from_bytes(b[i * 48:(i + 1) * 48]) for i in range(12)]
    return tuple(tuple((vals[6 * i + 2 * j], vals[6 * i + 2 * j + 1])
                       for j in range(3)) for i in range(2))


def comt_to_bytes(comt) -> bytes:
    """ComT (Fq12 batch (2, 2)) -> bytes, reference derive layout.

    The reference derives CanonicalSerialize on `ComT(pub PairingOutput;4)`
    (data_structures.rs:136-142): four GT elements in field order (0,0),
    (0,1), (1,0), (1,1), no length prefix.
    """
    vals = FQ12.to_ints(comt.reshape(comt.shape[0], comt.shape[1], 4))
    return b"".join(gt_to_bytes(v) for v in vals)


def comt_from_bytes(b: bytes, off=0, device="cuda"):
    """Read a ComT; returns (Fq12 batch (2, 2), new offset)."""
    vals = [gt_from_bytes(b[off + i * 576: off + (i + 1) * 576])
            for i in range(4)]
    arr = FQ12.from_ints(vals, device=device)      # (nl, 12, 4)
    return arr.reshape(arr.shape[0], arr.shape[1], 2, 2), off + 4 * 576


# ---------------------------------------------------------------------------
# device tensors <-> wire: Com vectors and protocol objects
# ---------------------------------------------------------------------------

def com1_vec_to_bytes(com, compressed=True) -> bytes:
    """Com1 vector (2, k) -> Vec<Com1> bytes (each Com1 = 2 G1 points)."""
    pts = g1_affine_to_ints(_flatten_com(com))
    k = com[2].shape[-1]
    out = _vec_prefix(k)
    for i in range(k):
        out += g1_point_to_bytes(pts[2 * i], compressed)
        out += g1_point_to_bytes(pts[2 * i + 1], compressed)
    return out


def com2_vec_to_bytes(com, compressed=True) -> bytes:
    pts = g2_affine_to_ints(_flatten_com(com))
    k = com[2].shape[-1]
    out = _vec_prefix(k)
    for i in range(k):
        out += g2_point_to_bytes(pts[2 * i], compressed)
        out += g2_point_to_bytes(pts[2 * i + 1], compressed)
    return out


def _flatten_com(com):
    """Com (2, k) -> affine batch (2k,) ordered [elem0 pair0, elem0 pair1...]"""
    x, y, inf = com
    # coords (..struct, 2, k) -> (..struct, k, 2) -> (..struct, 2k)
    flat = lambda c: torch.movedim(c, -2, -1).reshape(c.shape[:-2] + (-1,))
    return (flat(x), flat(y), flat(inf))


def com1_vec_from_bytes(b: bytes, off=0, compressed=True, validate=True,
                        device="cuda"):
    k, off = _read_prefix(b, off)
    size = 48 if compressed else 96
    pts = []
    for _ in range(2 * k):
        pts.append(g1_point_from_bytes(b[off:off + size], compressed,
                                       validate))
        off += size
    # reorder [e0p0, e0p1, e1p0, ...] -> (2 pair, k)
    reordered = [pts[2 * i + j] for j in range(2) for i in range(k)]
    aff = g1_affine_from_ints(reordered, device=device)
    return (aff[0].reshape(FQ.n, 2, k), aff[1].reshape(FQ.n, 2, k),
            aff[2].reshape(2, k)), off


def com2_vec_from_bytes(b: bytes, off=0, compressed=True, validate=True,
                        device="cuda"):
    k, off = _read_prefix(b, off)
    size = 96 if compressed else 192
    pts = []
    for _ in range(2 * k):
        pts.append(g2_point_from_bytes(b[off:off + size], compressed,
                                       validate))
        off += size
    reordered = [pts[2 * i + j] for j in range(2) for i in range(k)]
    aff = g2_affine_from_ints(reordered, device=device)
    return (aff[0].reshape(FQ.n, 2, 2, k), aff[1].reshape(FQ.n, 2, 2, k),
            aff[2].reshape(2, k)), off


def _aff_single(a):
    """Affine point batch () -> batch (1,) for the *_to_ints helpers."""
    return tuple(l[..., None] for l in a[:2]) + (a[2].reshape(1),)


def crs_to_bytes(crs, compressed=True) -> bytes:
    """CRS wire format (field order as generator.rs:36-42)."""
    out = com1_vec_to_bytes(crs.u, compressed)
    out += com2_vec_to_bytes(crs.v, compressed)
    out += g1_to_bytes(crs.g1_gen, compressed)
    out += g2_to_bytes(crs.g2_gen, compressed)
    out += gt_to_bytes(FQ12.to_ints(crs.gt_gen)[0])
    return out


def proof_to_bytes(proof, compressed=True) -> bytes:
    """EquProof wire format: pi, theta, equ_type, empty rand matrix.

    (The reference writes its private T matrix here, prove.rs:56-61; we
    write an empty matrix instead -- see module docstring.)
    """
    out = com2_vec_to_bytes(proof.pi, compressed)
    out += com1_vec_to_bytes(proof.theta, compressed)
    out += bytes([int(proof.equ_type)])
    out += _vec_prefix(0)
    return out


def g1_to_bytes(a, compressed=True) -> bytes:
    """Single G1 affine (batch ()) -> arkworks bytes."""
    return g1_point_to_bytes(g1_affine_to_ints(_aff_single(a))[0],
                             compressed)


def g2_to_bytes(a, compressed=True) -> bytes:
    return g2_point_to_bytes(g2_affine_to_ints(_aff_single(a))[0],
                             compressed)


def g1_vec_to_bytes(a, compressed=True) -> bytes:
    """G1 affine batch (K,) -> Vec<G1Affine> bytes."""
    pts = g1_affine_to_ints(a)
    return _vec_prefix(len(pts)) + b"".join(
        g1_point_to_bytes(p, compressed) for p in pts)


def g2_vec_to_bytes(a, compressed=True) -> bytes:
    pts = g2_affine_to_ints(a)
    return _vec_prefix(len(pts)) + b"".join(
        g2_point_to_bytes(p, compressed) for p in pts)


def g1_vec_from_bytes(b: bytes, off=0, compressed=True, device="cuda"):
    k, off = _read_prefix(b, off)
    size = 48 if compressed else 96
    pts = []
    for _ in range(k):
        pts.append(g1_point_from_bytes(b[off:off + size], compressed))
        off += size
    return g1_affine_from_ints(pts, device=device), off


def g2_vec_from_bytes(b: bytes, off=0, compressed=True, device="cuda"):
    k, off = _read_prefix(b, off)
    size = 96 if compressed else 192
    pts = []
    for _ in range(k):
        pts.append(g2_point_from_bytes(b[off:off + size], compressed))
        off += size
    return g2_affine_from_ints(pts, device=device), off


# ---------------------------------------------------------------------------
# Fr vectors / matrices (Vec<F> and Matrix<F> = Vec<Vec<F>>)
# ---------------------------------------------------------------------------

def _fr_limbs_to_int_list(std):
    arr = _np(std)
    return limbs_to_ints(arr.reshape(arr.shape[0], -1))


def fr_vec_to_bytes(std) -> bytes:
    """int64[17, K] canonical std-form -> Vec<Fr> bytes."""
    vals = _fr_limbs_to_int_list(std)
    return _vec_prefix(len(vals)) + b"".join(fr_to_bytes(v) for v in vals)


def fr_vec_from_bytes(b: bytes, off=0, device="cuda"):
    k, off = _read_prefix(b, off)
    vals = []
    for _ in range(k):
        vals.append(fr_from_bytes(b[off:off + 32])); off += 32
    return _limbs(ints_to_limbs(vals, FR.n), device), off


def fr_mat_to_bytes(std, row_widths=None) -> bytes:
    """int64[17, I, J] -> Matrix<Fr> (Vec<Vec<Fr>>, row-major) bytes.

    `row_widths` (from a mixed-kind Commit::append) writes each row i with
    its TRUE width row_widths[i] <= J, dropping the zero padding -- the
    reference's ragged Vec<Vec<Fr>> layout (commit.rs:42-52)."""
    arr = _np(std)
    I, J = arr.shape[1], arr.shape[2]
    out = _vec_prefix(I)
    for i in range(I):
        w = J if row_widths is None else row_widths[i]
        out += fr_vec_to_bytes(arr[:, i, :w])
    return out


def fr_mat_from_bytes(b: bytes, off=0, device="cuda"):
    """Read a Matrix<Fr>; ragged rows (reference mixed appends) are
    zero-padded to the max width. Returns (limbs, off, row_widths) with
    row_widths None when the matrix was rectangular."""
    I, off = _read_prefix(b, off)
    rows = []
    for _ in range(I):
        row, off = fr_vec_from_bytes(b, off, device=device)
        rows.append(row)
    if not rows:
        return (torch.zeros((FR.n, 0, 0), dtype=torch.int64,
                            device=resolve_device(device)), off, None)
    widths = tuple(int(r.shape[-1]) for r in rows)
    J = max(widths)
    rows = [torch.nn.functional.pad(r, (0, J - r.shape[-1])) for r in rows]
    uniform = all(w == J for w in widths)
    return torch.stack(rows, 1), off, (None if uniform else widths)


# ---------------------------------------------------------------------------
# Commit1 / Commit2 (coms + randomness; commit.rs:18-28 derives)
# ---------------------------------------------------------------------------

def commit1_to_bytes(c, compressed=True) -> bytes:
    """Commit1 { coms: Vec<Com1>, rand: Matrix<Fr> } wire format."""
    return (com1_vec_to_bytes(c.coms, compressed)
            + fr_mat_to_bytes(c.rand, getattr(c, "row_widths", None)))


def commit2_to_bytes(c, compressed=True) -> bytes:
    return (com2_vec_to_bytes(c.coms, compressed)
            + fr_mat_to_bytes(c.rand, getattr(c, "row_widths", None)))


def commit1_from_bytes(b: bytes, off=0, compressed=True, device="cuda"):
    from ..models.prover import Commit1
    coms, off = com1_vec_from_bytes(b, off, compressed, device=device)
    rand, off, widths = fr_mat_from_bytes(b, off, device=device)
    return Commit1(coms=coms, rand=rand, row_widths=widths), off


def commit2_from_bytes(b: bytes, off=0, compressed=True, device="cuda"):
    from ..models.prover import Commit2
    coms, off = com2_vec_from_bytes(b, off, compressed, device=device)
    rand, off, widths = fr_mat_from_bytes(b, off, device=device)
    return Commit2(coms=coms, rand=rand, row_widths=widths), off


# ---------------------------------------------------------------------------
# Equations (statement.rs:117 derives; field order a, b, gamma, target)
# ---------------------------------------------------------------------------

def _gt_dev_to_bytes(t):
    return gt_to_bytes(FQ12.to_ints(t[..., None])[0])


def equ_to_bytes(equ, compressed=True, tagged=True) -> bytes:
    """Equation wire format; `tagged` prepends the 1-byte EquType
    (statement.rs:61-97) so a single reader can dispatch. Untagged output
    matches the reference's per-type derive layout."""
    from ..models.statement import EquType
    ty = equ.equ_type
    out = bytes([int(ty)]) if tagged else b""
    if ty == EquType.PairingProduct:
        out += g1_vec_to_bytes(equ.a_consts, compressed)
        out += g2_vec_to_bytes(equ.b_consts, compressed)
        out += fr_mat_to_bytes(equ.gamma)
        out += _gt_dev_to_bytes(equ.target)
    elif ty == EquType.MultiScalarG1:
        out += g1_vec_to_bytes(equ.a_consts, compressed)
        out += fr_vec_to_bytes(equ.b_consts)
        out += fr_mat_to_bytes(equ.gamma)
        out += g1_to_bytes(equ.target, compressed)
    elif ty == EquType.MultiScalarG2:
        out += fr_vec_to_bytes(equ.a_consts)
        out += g2_vec_to_bytes(equ.b_consts, compressed)
        out += fr_mat_to_bytes(equ.gamma)
        out += g2_to_bytes(equ.target, compressed)
    else:
        out += fr_vec_to_bytes(equ.a_consts)
        out += fr_vec_to_bytes(equ.b_consts)
        out += fr_mat_to_bytes(equ.gamma)
        vals = _fr_limbs_to_int_list(equ.target[:, None])
        out += fr_to_bytes(vals[0])
    return out


def equ_from_bytes(b: bytes, off=0, compressed=True, equ_type=None,
                   device="cuda"):
    """Read an equation; if equ_type is None the stream is tagged."""
    from ..models.statement import (EquType, PPE, MSMEG1, MSMEG2, QuadEqu)
    if equ_type is None:
        equ_type = EquType(b[off]); off += 1
    ty = EquType(equ_type)
    if ty == EquType.PairingProduct:
        a, off = g1_vec_from_bytes(b, off, compressed, device=device)
        bc, off = g2_vec_from_bytes(b, off, compressed, device=device)
        g, off, _ = fr_mat_from_bytes(b, off, device=device)
        t12 = gt_from_bytes(b[off:off + 576]); off += 576
        t = FQ12.from_ints([t12], device=device)[:, :, 0]
        return PPE(a_consts=a, b_consts=bc, gamma=g, target=t), off
    if ty == EquType.MultiScalarG1:
        a, off = g1_vec_from_bytes(b, off, compressed, device=device)
        bc, off = fr_vec_from_bytes(b, off, device=device)
        g, off, _ = fr_mat_from_bytes(b, off, device=device)
        size = 48 if compressed else 96
        pt = g1_point_from_bytes(b[off:off + size], compressed); off += size
        t = g1_affine_from_ints([pt], device=device)
        t = tuple(l[..., 0] for l in t)
        return MSMEG1(a_consts=a, b_consts=bc, gamma=g, target=t), off
    if ty == EquType.MultiScalarG2:
        a, off = fr_vec_from_bytes(b, off, device=device)
        bc, off = g2_vec_from_bytes(b, off, compressed, device=device)
        g, off, _ = fr_mat_from_bytes(b, off, device=device)
        size = 96 if compressed else 192
        pt = g2_point_from_bytes(b[off:off + size], compressed); off += size
        t = g2_affine_from_ints([pt], device=device)
        t = tuple(l[..., 0] for l in t)
        return MSMEG2(a_consts=a, b_consts=bc, gamma=g, target=t), off
    a, off = fr_vec_from_bytes(b, off, device=device)
    bc, off = fr_vec_from_bytes(b, off, device=device)
    g, off, _ = fr_mat_from_bytes(b, off, device=device)
    tv = fr_from_bytes(b[off:off + 32]); off += 32
    t = _limbs(ints_to_limbs([tv], FR.n), device)[:, 0]
    return QuadEqu(a_consts=a, b_consts=bc, gamma=g, target=t), off


# ---------------------------------------------------------------------------
# CRS reader + CProof (framework extension; reference CProof has no serde)
# ---------------------------------------------------------------------------

def crs_from_bytes(b: bytes, off=0, compressed=True, device="cuda"):
    """Read a CRS (generator.rs:36-42 field order); recomputes the iota'
    base elements u2+(O,g1) / v2+(O,g2) which are derived, not serialized."""
    from ..models.crs import CRS
    from ..models import commit_group as cg
    u, off = com1_vec_from_bytes(b, off, compressed, device=device)
    v, off = com2_vec_from_bytes(b, off, compressed, device=device)
    size1 = 48 if compressed else 96
    g1pt = g1_point_from_bytes(b[off:off + size1], compressed); off += size1
    size2 = 96 if compressed else 192
    g2pt = g2_point_from_bytes(b[off:off + size2], compressed); off += size2
    gt12 = gt_from_bytes(b[off:off + 576]); off += 576
    g1a = tuple(l[..., 0] for l in g1_affine_from_ints([g1pt], device=device))
    g2a = tuple(l[..., 0] for l in g2_affine_from_ints([g2pt], device=device))
    gt = FQ12.from_ints([gt12], device=device)[:, :, 0]
    u_base = cg.iota_prime_base(G1, u, g1a)
    v_base = cg.iota_prime_base(G2, v, g2a)
    return CRS(u=u, v=v, g1_gen=g1a, g2_gen=g2a, gt_gen=gt,
               u_base=u_base, v_base=v_base), off


def cproof_to_bytes(cp, compressed=True) -> bytes:
    """CProof { xcoms, ycoms, equ_proofs } (prove.rs:64-69; the reference
    derives no serde for CProof -- this framing is ours)."""
    out = commit1_to_bytes(cp.xcoms, compressed)
    out += commit2_to_bytes(cp.ycoms, compressed)
    out += _vec_prefix(len(cp.equ_proofs))
    for p in cp.equ_proofs:
        out += proof_to_bytes(p, compressed)
    return out


def cproof_from_bytes(b: bytes, off=0, compressed=True, device="cuda"):
    from ..models.prover import CProof
    xcoms, off = commit1_from_bytes(b, off, compressed, device=device)
    ycoms, off = commit2_from_bytes(b, off, compressed, device=device)
    k, off = _read_prefix(b, off)
    proofs = []
    for _ in range(k):
        p, off = proof_from_bytes(b, off, compressed, device=device)
        proofs.append(p)
    return CProof(xcoms=xcoms, ycoms=ycoms, equ_proofs=proofs), off


def proof_from_bytes(b: bytes, off=0, compressed=True, device="cuda"):
    from ..models.prover import EquProof
    from ..models.statement import EquType
    pi, off = com2_vec_from_bytes(b, off, compressed, device=device)
    theta, off = com1_vec_from_bytes(b, off, compressed, device=device)
    ty = EquType(b[off]); off += 1
    nrows, off = _read_prefix(b, off)
    for _ in range(nrows):              # skip reference rand rows if present
        ncols, off = _read_prefix(b, off)
        off += 32 * ncols
    return EquProof(pi=pi, theta=theta, equ_type=ty), off


# ---------------------------------------------------------------------------
# bulk (native-backed) point vector IO -- the checkpoint/runtime path
# ---------------------------------------------------------------------------
#
# The per-element writers above cost a Python int round-trip per point;
# at MSM scale (2^16+ points) that is seconds of host time. These bulk
# codecs move the whole batch through the port's native library
# (utils/native.py) at memory bandwidth, with flag/sign handling vectorized
# on limb arrays. The bulk readers decompress and validate (on-curve +
# [r]P = O subgroup check) BATCHED on the device of `device` -- the card
# unless the caller asks for the CPU -- the batched analogue of arkworks'
# per-point `Validate::Yes`.

def _is_neg_fq_limbs(y_std: np.ndarray) -> np.ndarray:
    """Vectorized _is_neg_fq on canonical std limbs uint32[25, K]."""
    half = int_to_limbs((P - 1) // 2, y_std.shape[0])
    gt = np.zeros(y_std.shape[1], dtype=bool)
    eq = np.ones(y_std.shape[1], dtype=bool)
    for l in range(y_std.shape[0] - 1, -1, -1):
        gt |= eq & (y_std[l] > half[l])
        eq &= y_std[l] == half[l]
    return gt


def _std(c) -> np.ndarray:
    """Montgomery coordinates on the device -> canonical std-form uint32
    limbs on the host."""
    return _np(FQ.from_mont(c)).astype(np.uint32)


def _g1_std(a):
    """Affine device batch -> canonical std-form numpy limbs + inf flags."""
    x, y = _std(a[0]), _std(a[1])
    inf = _np(a[2]).reshape(-1)
    return x.reshape(FQ.n, -1), y.reshape(FQ.n, -1), inf


def g1_vec_to_bytes_bulk(a, compressed=True) -> bytes:
    """G1 affine batch (K,) -> Vec<G1Affine> bytes, bulk path."""
    x, y, inf = _g1_std(a)
    K = x.shape[1]
    x = np.where(inf[None, :], 0, x)
    y = np.where(inf[None, :], 0, y)
    xb = np.frombuffer(native.limbs_to_bytes(x, 48), np.uint8).reshape(K, 48)
    if compressed:
        out = xb.copy()
        neg = _is_neg_fq_limbs(y) & ~inf
        out[neg, 47] |= FLAG_NEG
        out[inf, 47] |= FLAG_INF
        return _vec_prefix(K) + out.tobytes()
    yb = np.frombuffer(native.limbs_to_bytes(y, 48), np.uint8).reshape(K, 48)
    out = np.concatenate([xb, yb], axis=1)
    out[inf, 95] |= FLAG_INF
    return _vec_prefix(K) + out.tobytes()


def g1_vec_from_bytes_bulk(b: bytes, off=0, validate=True, device="cuda"):
    """Uncompressed Vec<G1Affine> bulk reader; device-batched validation."""
    k, off = _read_prefix(b, off)
    raw = np.frombuffer(b[off:off + 96 * k], np.uint8).reshape(k, 96).copy()
    off += 96 * k
    inf = (raw[:, 95] & FLAG_INF) != 0
    raw[:, 95] &= 0x3F
    x = native.bytes_to_limbs(raw[:, :48].tobytes(), 48, FQ.n)
    y = native.bytes_to_limbs(raw[:, 48:].tobytes(), 48, FQ.n)
    aff = (FQ.to_mont(_limbs(x, device)), FQ.to_mont(_limbs(y, device)),
           torch.as_tensor(inf, device=resolve_device(device)))
    if validate:
        _validate_batch_device(G1, aff)
    return aff, off


def _validate_batch_device(curve, aff):
    """Batched on-curve + subgroup check on the points' device: one
    `on_curve_affine` and one `scalar_mul` by r over the whole batch, one
    host transfer."""
    on = curve.on_curve_affine(aff)
    batch = aff[2].shape
    r_limbs = _limbs(int_to_limbs(C.R, FR.n), aff[2].device).reshape(
        (FR.n,) + (1,) * len(batch))
    mult = curve.scalar_mul(aff, r_limbs)
    flags = torch.stack([on.all(), curve.is_inf(mult).all()]).tolist()
    if not flags[0]:
        raise ValueError(f"{curve.name} batch: point not on curve")
    if not flags[1]:
        raise ValueError(f"{curve.name} batch: point not in the r-torsion "
                         f"subgroup")


def _limbs_gt(a: np.ndarray, b: np.ndarray):
    """Vectorized (a > b, a == b) on canonical std limbs uint32[nl, K]."""
    gt = np.zeros(a.shape[1], dtype=bool)
    eq = np.ones(a.shape[1], dtype=bool)
    for l in range(a.shape[0] - 1, -1, -1):
        gt |= eq & (a[l] > b[l])
        eq &= a[l] == b[l]
    return gt, eq


def _neg_mod_p_limbs(y_std: np.ndarray) -> np.ndarray:
    """(p - y) % p on canonical std limbs (vectorized, host)."""
    p_limbs = int_to_limbs(P, y_std.shape[0]).astype(np.int64)
    nz = (y_std != 0).any(axis=0)
    d = p_limbs[:, None] - y_std.astype(np.int64)
    # borrow propagate
    for l in range(y_std.shape[0] - 1):
        borrow = d[l] < 0
        d[l] += (1 << 16) * borrow
        d[l + 1] -= borrow
    d = d.astype(np.uint32)
    return np.where(nz[None, :], d, 0)


def _is_neg_fq2_limbs(y0_std: np.ndarray, y1_std: np.ndarray) -> np.ndarray:
    """Vectorized _is_neg_fq2: (c1, c0) > (-c1, -c0) lexicographic."""
    n0 = _neg_mod_p_limbs(y0_std)
    n1 = _neg_mod_p_limbs(y1_std)
    gt1, eq1 = _limbs_gt(y1_std, n1)
    gt0, _ = _limbs_gt(y0_std, n0)
    return gt1 | (eq1 & gt0)


def _g2_std(a):
    """G2 affine device batch -> std numpy limbs (x0,x1,y0,y1) + inf flags."""
    x = _std(a[0]).reshape(FQ.n, 2, -1)             # (nl, 2, K)
    y = _std(a[1]).reshape(FQ.n, 2, -1)
    inf = _np(a[2]).reshape(-1)
    return x[:, 0], x[:, 1], y[:, 0], y[:, 1], inf


def g2_vec_to_bytes_bulk(a, compressed=True) -> bytes:
    """G2 affine batch (K,) -> Vec<G2Affine> bytes, bulk path."""
    x0, x1, y0, y1, inf = _g2_std(a)
    K = x0.shape[1]
    z = lambda arr: np.where(inf[None, :], 0, arr)
    xb0 = np.frombuffer(native.limbs_to_bytes(z(x0), 48),
                        np.uint8).reshape(K, 48)
    xb1 = np.frombuffer(native.limbs_to_bytes(z(x1), 48),
                        np.uint8).reshape(K, 48)
    if compressed:
        out = np.concatenate([xb0, xb1], axis=1)
        neg = _is_neg_fq2_limbs(z(y0), z(y1)) & ~inf
        out[neg, 95] |= FLAG_NEG
        out[inf, 95] |= FLAG_INF
        return _vec_prefix(K) + out.tobytes()
    yb0 = np.frombuffer(native.limbs_to_bytes(z(y0), 48),
                        np.uint8).reshape(K, 48)
    yb1 = np.frombuffer(native.limbs_to_bytes(z(y1), 48),
                        np.uint8).reshape(K, 48)
    out = np.concatenate([xb0, xb1, yb0, yb1], axis=1)
    out[inf, 191] |= FLAG_INF
    return _vec_prefix(K) + out.tobytes()


def g2_vec_from_bytes_bulk(b: bytes, off=0, validate=True, device="cuda"):
    """Uncompressed Vec<G2Affine> bulk reader; device-batched validation."""
    k, off = _read_prefix(b, off)
    raw = np.frombuffer(b[off:off + 192 * k], np.uint8).reshape(k, 192).copy()
    off += 192 * k
    inf = (raw[:, 191] & FLAG_INF) != 0
    raw[:, 191] &= 0x3F
    cols = [native.bytes_to_limbs(raw[:, 48 * i:48 * (i + 1)].tobytes(),
                                  48, FQ.n) for i in range(4)]
    x = np.stack([cols[0], cols[1]], axis=1)        # (nl, 2, K)
    y = np.stack([cols[2], cols[3]], axis=1)
    aff = (FQ.to_mont(_limbs(x, device)), FQ.to_mont(_limbs(y, device)),
           torch.as_tensor(inf, device=resolve_device(device)))
    if validate:
        _validate_batch_device(G2, aff)
    return aff, off


# ---- compressed bulk readers: device-batched sqrt ---------------------------
#
# Decompression needs y = sqrt(x^3 + b). p % 4 == 3, so sqrt(a) = a^((p+1)/4)
# when a is a QR -- ONE batched fixed-exponent pow (the `pow_const` kernel)
# instead of a host bigint pow per point.

def _all(mask) -> bool:
    return bool(mask.all().item())


def g1_vec_from_bytes_bulk_compressed(b: bytes, off=0, validate=True,
                                      device="cuda"):
    k, off = _read_prefix(b, off)
    raw = np.frombuffer(b[off:off + 48 * k], np.uint8).reshape(k, 48).copy()
    off += 48 * k
    inf = (raw[:, 47] & FLAG_INF) != 0
    neg = (raw[:, 47] & FLAG_NEG) != 0
    raw[:, 47] &= 0x3F
    x_std = native.bytes_to_limbs(raw.tobytes(), 48, FQ.n)
    dev = resolve_device(device)
    inf_t = torch.as_tensor(inf, device=dev)

    x = FQ.to_mont(_limbs(x_std, dev))
    bb = G1.b(dev).reshape(FQ.n, 1)
    ysq = FQ.add(FQ.mul(FQ.sqr(x), x), bb.expand(x.shape))
    y = FQ.pow_const(ysq, (P + 1) // 4)
    ok = FQ.eq(FQ.sqr(y), ysq, k=4)
    if not _all(ok | inf_t):
        raise ValueError("G1 compressed batch: x not on curve")
    # sign select on host (canonical std form)
    y_std = _std(y)
    y_neg = _neg_mod_p_limbs(y_std)
    is_neg = _is_neg_fq_limbs(y_std)
    y_sel = np.where((is_neg != neg)[None, :], y_neg, y_std)
    y_sel = np.where(inf[None, :], 0, y_sel)
    x_std = np.where(inf[None, :], 0, x_std)
    aff = (FQ.to_mont(_limbs(x_std, dev)), FQ.to_mont(_limbs(y_sel, dev)),
           inf_t)
    if validate:
        _validate_batch_device(G1, aff)
    return aff, off


def g2_vec_from_bytes_bulk_compressed(b: bytes, off=0, validate=True,
                                      device="cuda"):
    """Compressed Vec<G2Affine> bulk reader: batched Fq2 sqrt on device.

    sqrt in Fq2 via the norm trick (same math as the host `_sqrt_fq2`,
    vectorized): n = c0^2 + c1^2, sn = sqrt(n), x0 = sqrt((c0 + sn)/2)
    (or (c0 - sn)/2), x1 = c1 / (2 x0).
    """
    k, off = _read_prefix(b, off)
    raw = np.frombuffer(b[off:off + 96 * k], np.uint8).reshape(k, 96).copy()
    off += 96 * k
    inf = (raw[:, 95] & FLAG_INF) != 0
    neg = (raw[:, 95] & FLAG_NEG) != 0
    raw[:, 95] &= 0x3F
    x0 = native.bytes_to_limbs(raw[:, :48].tobytes(), 48, FQ.n)
    x1 = native.bytes_to_limbs(raw[:, 48:].tobytes(), 48, FQ.n)
    dev = resolve_device(device)
    inf_t = torch.as_tensor(inf, device=dev)

    x = FQ.to_mont(_limbs(np.stack([x0, x1], axis=1), dev))    # (nl, 2, K)
    bb = G2.b(dev).reshape(FQ.n, 2, 1)
    ysq = FQ.add(FQ2.mul(FQ2.sqr(x), x), bb.expand(x.shape))  # (nl, 2, K)
    a0, a1 = FQ.normalize(ysq[:, 0], k=8), FQ.normalize(ysq[:, 1], k=8)
    n = FQ.add(FQ.sqr(a0), FQ.sqr(a1))                   # norm
    sn = FQ.pow_const(n, (P + 1) // 4)
    half = FQ.from_int((P + 1) // 2, device=dev)
    halfb = half.reshape(FQ.n, 1).expand(a0.shape)
    cand0 = FQ.mul(FQ.add(a0, sn), halfb)                # (c0+sn)/2
    x0c = FQ.pow_const(cand0, (P + 1) // 4)
    ok0 = FQ.eq(FQ.sqr(x0c), cand0, k=4)
    cand1 = FQ.mul(FQ.sub(a0, sn, k=2), halfb)           # (c0-sn)/2
    x0c2 = FQ.pow_const(cand1, (P + 1) // 4)
    x0_sel = FQ.select(ok0, x0c, x0c2)
    # x1 = a1 / (2 x0)
    x1_sel = FQ.mul(a1, FQ.inv_batch(FQ.double(x0_sel), k=4))
    y = torch.stack([x0_sel, x1_sel], 1)
    # pure-real/pure-imaginary special cases (a1 == 0) fall back
    a1_zero = FQ.is_zero(a1, k=2)
    s_real = FQ.pow_const(a0, (P + 1) // 4)
    real_ok = FQ.eq(FQ.sqr(s_real), a0, k=4)
    neg_a0 = FQ.neg(a0, k=2)
    s_imag = FQ.pow_const(neg_a0, (P + 1) // 4)
    zero = torch.zeros_like(a0)
    y_real = torch.stack([s_real, zero], 1)
    y_imag = torch.stack([zero, s_imag], 1)
    y = torch.where((a1_zero & real_ok)[None, None], y_real,
                    torch.where((a1_zero & ~real_ok)[None, None], y_imag, y))
    ok = FQ2.eq(FQ2.sqr(y), ysq, k=8)
    if not _all(ok | inf_t):
        raise ValueError("G2 compressed batch: x not on curve")
    y_std = _std(y)                                      # (nl, 2, K)
    y0, y1 = y_std[:, 0], y_std[:, 1]
    n0, n1 = _neg_mod_p_limbs(y0), _neg_mod_p_limbs(y1)
    is_neg = _is_neg_fq2_limbs(y0, y1)
    flip = (is_neg != neg)
    y0s = np.where(flip[None, :], n0, y0)
    y1s = np.where(flip[None, :], n1, y1)
    z = lambda arr: np.where(inf[None, :], 0, arr)
    xs = np.stack([z(x0), z(x1)], axis=1)
    yy = np.stack([z(y0s), z(y1s)], axis=1)
    aff = (FQ.to_mont(_limbs(xs, dev)), FQ.to_mont(_limbs(yy, dev)), inf_t)
    if validate:
        _validate_batch_device(G2, aff)
    return aff, off


def fr_vec_to_bytes_bulk(std) -> bytes:
    """int64[17, K] canonical std limbs -> Vec<Fr> bytes, bulk path."""
    arr = _np(std).reshape(FR.n, -1)
    return _vec_prefix(arr.shape[1]) + native.limbs_to_bytes(arr, 32)


def fr_vec_from_bytes_bulk(b: bytes, off=0, device="cuda"):
    k, off = _read_prefix(b, off)
    arr = native.bytes_to_limbs(b[off:off + 32 * k], 32, FR.n)
    return _limbs(arr, device), off + 32 * k
