"""Batched (and randomized) verification over many equations at once.

The port of ``groth_sahai_tpu/models/batch.py``: verify a batch of B
same-shaped proofs -- any of the four equation types -- with

  * `verify_batch`: the B signed Miller products, one final
    exponentiation per equation, per-equation equality checks; or
  * `verify_batch_randomized`: sample rho_b, raise each equation's pairing
    ratio to rho_b in GT, multiply everything into a single Fq12 value,
    apply ONE final exponentiation for the WHOLE batch, and compare against
    the rho-weighted product of targets (identity for non-PPE types, whose
    iota_T target joins the Miller product as a conjugated pairing pair).

Flat, where the JAX package maps a per-equation function over the batch
with `vmap`: the B equations and proofs are stacked once, and every
pairing pair of all B is assembled at once, as `verifier.verify` does for
one (iota of both sides, Gamma d as ONE `com_matvec` over the B leading
batch, the rhs terms, the targets of non-PPE types), padded to Kp =
next_pow2(K) pairs and expanded to (B, 2, 2, Kp) Miller lanes. The Miller
loop, its conjugation mask and the product over Kp then run in tiles of
whole equations, at most `ops.tower.FUSED_MAX_LANES` lanes a tile, so each
Miller iteration is one launch of the fused kernels (above that cap the
Miller loop would take the lazy tower); each equation's ratio is the same
limbs as `miller_product_signed` of its pairs alone. The final
exponentiations and the GT powers run in tiles of at most as many lanes.

With `mesh` (a 1-D `parallel.mesh.Mesh`), the equations axis is cut into
D contiguous groups of B / D equations, as the reference shards it; each
group runs the flat path above on its mesh device (this process's groups
only when the mesh spans processes). `verify_batch` joins the groups'
verdicts in order; `verify_batch_randomized` draws rho once, before the
split, and each group gives its rho-weighted Miller product (and, for a
PPE, its rho-weighted target), which merge by product
(`parallel.sharded.gather_partials`) before ONE final exponentiation.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops import pairing as pr
from ..ops import tower
from ..ops.curve import G1, G2
from ..ops.tower import FQ12
from ..parallel.mesh import local_shards
from ..parallel.sharded import gather_partials
from ..utils import metrics
from ..utils.rng import GsRng
from . import commit_group as cg
from . import kernels as K
from .crs import CRS
from .prover import _iota_side
from .statement import EquType
from .verifier import _as_vec1, _comt_ppe_target, _target_pair


class _EquView:
    """Minimal equ-like view for verifier._target_pair over the batch."""

    def __init__(self, ty, target):
        self.equ_type = ty
        self.target = target


# ---------------------------------------------------------------------------
# stacking
# ---------------------------------------------------------------------------
#
# The B axis goes where the port's batched ops take a leading batch: right
# after the structure axes (limbs, Fq2 / Fq12 coefficients) of a value, and
# after the B1 / B2 pair axis of a Com vector: (2, B, k). The JAX package
# stacks every leaf on a new axis 0 for its vmap.

def _stk(vals, axis: int):
    """Stack tensors, or affine batches (x, y, inf) at batch position
    `axis`, along a new axis."""
    if isinstance(vals[0], tuple):
        ns = vals[0][0].ndim - vals[0][2].ndim
        return (torch.stack([v[0] for v in vals], ns + axis),
                torch.stack([v[1] for v in vals], ns + axis),
                torch.stack([v[2] for v in vals], axis))
    return torch.stack(vals, axis)


def _stack_equ_batch(equs):
    """(a, b, gamma, target) of B equations: points (B, n), Fr constants
    (17, B, n), gamma (17, B, m, n), targets (nl, 12, B) (PPE), (B,)
    (MSME) or (17, B) (quadratic)."""
    ppe = equs[0].equ_type == EquType.PairingProduct
    a = _stk([e.a_consts for e in equs], 0 if isinstance(
        equs[0].a_consts, tuple) else 1)
    b = _stk([e.b_consts for e in equs], 0 if isinstance(
        equs[0].b_consts, tuple) else 1)
    g = _stk([e.gamma for e in equs], 1)
    t = _stk([e.target for e in equs], 0 if isinstance(
        equs[0].target, tuple) else (2 if ppe else 1))
    return a, b, g, t


def _stack_proof_batch(proofs):
    """(c, d, pi, theta) of B proofs, each a Com vector batch (2, B, k)."""
    c = _stk([p.xcoms.coms for p in proofs], 1)
    d = _stk([p.ycoms.coms for p in proofs], 1)
    pi = _stk([p.equ_proofs[0].pi for p in proofs], 1)
    th = _stk([p.equ_proofs[0].theta for p in proofs], 1)
    return c, d, pi, th


def _check_same_type(equs, proofs):
    if not equs or len(equs) != len(proofs):
        raise ValueError(f"{len(equs)} equations against {len(proofs)} "
                         f"proofs (need as many, at least one)")
    ty = equs[0].equ_type
    if any(e.equ_type != ty for e in equs):
        raise ValueError("mixed equation types in one batch")
    if any(p.equ_proofs[0].equ_type != ty for p in proofs):
        raise ValueError(f"a proof of another type in a batch of "
                         f"{ty.name} equations")
    return ty, equs[0].x_is_scalar, equs[0].y_is_scalar


def _moved(x, device):
    """Tensors (in tuples, or the fields of a dataclass such as the CRS)
    on `device`."""
    if torch.is_tensor(x):
        return x.to(device)
    if isinstance(x, tuple):
        return tuple(_moved(v, device) for v in x)
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{f.name: _moved(getattr(x, f.name),
                                                        device)
                                         for f in dataclasses.fields(x)})
    return x


def _devices(x) -> set:
    """The devices of the tensors in x (tuples, lists, dataclasses)."""
    if torch.is_tensor(x):
        return {x.device}
    if isinstance(x, (tuple, list)):
        return set().union(*map(_devices, x))
    if dataclasses.is_dataclass(x):
        return set().union(*(_devices(getattr(x, f.name))
                             for f in dataclasses.fields(x)))
    return set()


def _groups(mesh, axis: str, crs, equs, proofs):
    """[(group index, device, slice of equations)] that this process runs:
    without a mesh one group of all B on the one device that holds the
    CRS, equations and proofs (else ValueError: nothing is moved); with
    one, D contiguous groups of B / D, each moved to its shard's
    device."""
    B = len(equs)
    if mesh is None:
        devs = _devices((crs, equs, proofs))
        if len(devs) != 1:
            raise ValueError(f"the CRS, equations and proofs lie on "
                             f"{sorted(map(str, devs))}: without a mesh "
                             f"they must share one device")
        return [(0, devs.pop(), slice(0, B))]
    D, mine = local_shards(mesh, axis)
    if B % D:
        raise ValueError(f"batch of {B} equations not divisible by {D} "
                         f"shards")
    per = B // D
    return [(i, dev, slice(i * per, (i + 1) * per)) for i, dev in mine]


def _merged(mesh, axis: str, parts: dict) -> list:
    """Every group's partials in order (over a mesh, on its merge device;
    one all_gather when it spans processes)."""
    return list(parts.values()) if mesh is None else \
        gather_partials(mesh, parts, axis)


# ---------------------------------------------------------------------------
# the flat Miller batch
# ---------------------------------------------------------------------------

def _swap01(curve, a):
    """Swap the first two batch axes of an affine batch."""
    ns = curve.ns
    return cg.aff_map(curve, a, lambda l: l.transpose(ns, ns + 1),
                      lambda i: i.transpose(0, 1))


def _batch_pairs(ty, x_sc, y_sc, crs, a, b, g, t, c, d, pi, th):
    """Every Miller pair of the B equations: (P, Q, mask) with P, Q affine
    batches (B, 2, 2, Kp) (P[b, i, j, k] = P_bk's component i, Q[b, i, j,
    k] = Q_bk's component j) and the conjugation mask bool (Kp,): the same
    5-term signed product as verifier.verify, each equation's K pairs
    padded to Kp = next_pow2(K) as `miller_product_signed` pads them."""
    B = c[2].shape[1]
    wx = pi[2].shape[-1]
    wy = th[2].shape[-1]
    iota_a = _iota_side(G1, x_sc, a, crs.u_base)          # (2, B, n)
    iota_b = _iota_side(G2, y_sc, b, crs.v_base)          # (2, B, m)
    gd = K.to_affine(G2, K.com_matvec(G2, g, d))          # (2, B, m)
    u_used = cg.aff_expand(G1, cg.aff_slice0(G1, crs.u, 1, wx), 1, B)
    v_used = cg.aff_expand(G2, cg.aff_slice0(G2, crs.v, 1, wy), 1, B)

    lhs1 = [iota_a, c, c]
    lhs2 = [d, iota_b, gd]
    rhs1 = [u_used, th]
    rhs2 = [pi, v_used]
    if ty != EquType.PairingProduct:
        tp1, tp2 = _target_pair(_EquView(ty, t), crs)     # (2, B) each
        rhs1.append(_as_vec1(G1, tp1))
        rhs2.append(_as_vec1(G2, tp2))

    P = cg.aff_concat(G1, lhs1 + rhs1, axis=2)            # (2, B, K)
    Q = cg.aff_concat(G2, lhs2 + rhs2, axis=2)
    k_l = sum(int(v[2].shape[-1]) for v in lhs1)
    k_r = sum(int(v[2].shape[-1]) for v in rhs1)
    Kp = K.next_pow2(k_l + k_r)
    P = _swap01(G1, K.pad_aff(G1, P, 2, Kp))              # (B, 2, Kp)
    Q = _swap01(G2, K.pad_aff(G2, Q, 2, Kp))
    mask = np.zeros(Kp, dtype=bool)
    mask[k_l:k_l + k_r] = True
    return (cg.aff_expand(G1, P, 2, 2), cg.aff_expand(G2, Q, 1, 2),
            torch.as_tensor(mask, device=P[0].device))


def _tile(n_lanes_each: int) -> int:
    """Equations a tile: as many as keep a call at or below the fused
    kernels' cap (at least one)."""
    return max(1, tower.FUSED_MAX_LANES // n_lanes_each)


def _ratios(P, Q, mask):
    """Unexponentiated lhs * conj(rhs) of every equation: (nl, 12, B, 2, 2).

    One `miller_loop` per tile of whole equations (4 Kp lanes each), then
    the conjugation mask and the product over Kp, as
    `kernels._miller_product_signed` takes them for one equation."""
    B, Kp = P[2].shape[0], P[2].shape[-1]
    bt = _tile(4 * Kp)
    out = []
    for s in range(0, B, bt):
        n = min(bt, B - s)
        Pt = cg.aff_map(G1, P, lambda l: l.narrow(1, s, n),
                        lambda i: i.narrow(0, s, n))
        Qt = cg.aff_map(G2, Q, lambda l: l.narrow(2, s, n),
                        lambda i: i.narrow(0, s, n))
        f = pr.miller_loop(Pt, Qt)                        # (nl,12,n,2,2,Kp)
        f = torch.where(mask, FQ12.conj(f), f)
        out.append(pr._product_reduce(f, axis=3))         # (nl, 12, n, 2, 2)
    return torch.cat(out, 2)


def _tiled(fn, x, lanes_each: int, *args):
    """fn over tiles of axis 2 (the first batch axis) of an Fq12 batch x,
    each at most FUSED_MAX_LANES lanes; args are sliced alongside on
    their axis 1."""
    B = x.shape[2]
    bt = _tile(lanes_each)
    return torch.cat([fn(x.narrow(2, s, min(bt, B - s)),
                         *(a.narrow(1, s, min(bt, B - s)) for a in args))
                      for s in range(0, B, bt)], 2)


def _ratio_of(ty, x_sc, y_sc, crs, equs, proofs, device):
    """(ratio (nl, 12, B, 2, 2), stacked targets) of B equations, on
    `device`."""
    crs, stacked = _moved((crs, _stack_equ_batch(equs)
                           + _stack_proof_batch(proofs)), device)
    return (_ratios(*_batch_pairs(ty, x_sc, y_sc, crs, *stacked)),
            stacked[3])


# ---------------------------------------------------------------------------
# plain batched verification (per-equation verdicts)
# ---------------------------------------------------------------------------

def _verdicts(ty, ratio, t):
    """bool[B]: each equation's final exponentiation against its target."""
    res = _tiled(pr.final_exp, ratio, 4)                  # (nl, 12, B, 2, 2)
    if ty == EquType.PairingProduct:
        tgt = _comt_ppe_target(t)                         # (nl, 12, B, 2, 2)
    else:
        tgt = FQ12.one(tuple(ratio.shape[2:]), device=res.device)
    return torch.all(torch.all(FQ12.eq(res, tgt), -1), -1)


def verify_batch(equs, proofs, crs: CRS, mesh=None, axis: str = "chips"):
    """Verify B same-shape proofs (any single equation type); bool[B].

    With `mesh`, B divisible by its shard count; the groups' verdicts in
    order. One host transfer at the end.
    """
    ty, x_sc, y_sc = _check_same_type(equs, proofs)
    groups = _groups(mesh, axis, crs, equs, proofs)
    metrics.count("batch_verify_equations", len(equs))
    oks = {i: (_verdicts(ty, *_ratio_of(ty, x_sc, y_sc, crs, equs[s],
                                        proofs[s], dev)).long(),)
           for i, dev, s in groups}
    return torch.cat([ok for ok, in _merged(mesh, axis, oks)]
                     ).bool().cpu().numpy()


# ---------------------------------------------------------------------------
# randomized linear-combination verification (single verdict, ONE final exp)
# ---------------------------------------------------------------------------

def _weighted(ty, ratio, t, rho):
    """The rho-weighted product of a batch's ratios (nl, 12, 2, 2) and,
    for a PPE, of its targets (nl, 12); else None."""
    powed = _tiled(pr.gt_exp, ratio, 4, rho[:, :, None, None])
    part = pr._product_reduce(powed, axis=0)
    if ty != EquType.PairingProduct:
        return part, None
    return part, pr._product_reduce(_tiled(pr.gt_exp, t, 1, rho), axis=0)


def verify_batch_randomized(equs, proofs, crs: CRS, rng: GsRng,
                            mesh=None, axis: str = "chips"):
    """Randomized combination check: error probability ~2^-255, ONE final
    exponentiation for the whole batch. Returns a single bool (one
    `.item()`). rho: `rng.fr_std((B,))`, the JAX package's draws, drawn
    once before a mesh's split."""
    ty, x_sc, y_sc = _check_same_type(equs, proofs)
    ppe = ty == EquType.PairingProduct
    groups = _groups(mesh, axis, crs, equs, proofs)
    rho = rng.fr_std((len(equs),), device=groups[0][1])
    metrics.count("batch_verify_equations", len(equs))
    parts = {}
    for i, dev, s in groups:
        ratio, t = _ratio_of(ty, x_sc, y_sc, crs, equs[s], proofs[s], dev)
        parts[i] = _weighted(ty, ratio, t, rho[:, s].to(dev))[:1 + ppe]
    part, *t_part = [pr._product_reduce(torch.stack(list(g_parts), 2),
                                        axis=0)
                     for g_parts in zip(*_merged(mesh, axis, parts))]
    res = pr.final_exp(part)
    expected = _comt_ppe_target(t_part[0]) if ppe else \
        cg.comt_one(device=res.device)
    return bool(cg.comt_eq(res, expected).item())


# ---------------------------------------------------------------------------
# backwards-compatible PPE-named wrappers (round-2 API)
# ---------------------------------------------------------------------------

def verify_ppe_batch(equs, proofs, crs: CRS, mesh=None):
    return verify_batch(equs, proofs, crs, mesh=mesh)


def verify_ppe_batch_randomized(equs, proofs, crs: CRS, rng: GsRng,
                                mesh=None):
    return verify_batch_randomized(equs, proofs, crs, rng, mesh=mesh)
