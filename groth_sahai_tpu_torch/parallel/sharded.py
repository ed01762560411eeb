"""Multi-device sharded kernels: MSM and batched pairing products.

The port of ``groth_sahai_tpu/parallel/sharded.py``, with the reference's
split: the point axis / pairing-pair axis becomes (D, N/D), contiguous
shard i going to the mesh's entry i (N must divide by D). Where the JAX
package maps the per-device partial reduction over that axis with
`jax.vmap` and lets XLA place it:

  * `sharded_msm`: each distinct device of the mesh gets ONE `ops/msm.py`
    `msm` call with its shards as the leading MSM batch -- the launches
    of one batched `msm`, whatever the shard count;
  * `sharded_multi_pairing`: likewise ONE `multi_miller` a device, its
    shards a leading batch, the product over each shard's own pairs;
  * the merge: the D partials (one Jacobian point / one Fq12 value each)
    come to the merge device (the mesh's first device; the first of this
    process's when the mesh spans processes, after one
    `torch.distributed.all_gather`, so every rank gets the same value),
    then `Curve.sum_reduce` / `_product_reduce` runs over them, and for
    the pairing one `final_exp`. Group and GT "sums" are not
    coordinate-wise, so there is no all-reduce.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops import msm as msm_mod
from ..ops import pairing as pr
from ..ops.fp import FQ
from ..utils import metrics
from .mesh import local_shards, shard_batch


def _spans_processes(mesh) -> bool:
    import torch.distributed as dist
    return mesh.ranks is not None and dist.is_available() and \
        dist.is_initialized()


def _merge_device(mesh, axis: str = "chips") -> torch.device:
    """Where the partials merge: this process's first device of the mesh."""
    mine = local_shards(mesh, axis)[1]
    if not mine:
        raise ValueError(f"this process computes no shard of {mesh}")
    return mine[0][1]


def gather_partials(mesh, local: dict, axis: str = "chips") -> list:
    """All D partials of a mesh in shard order, on the merge device.

    local: {shard index: tuple of int64 tensors} for the shards this
    process computed, every shard's tuple of the same shapes. Over a mesh
    that spans processes, one `all_gather` of each rank's partials (every
    rank owns as many shards); otherwise a move to the merge device."""
    D, mine = local_shards(mesh, axis)
    dev = _merge_device(mesh, axis)
    if not _spans_processes(mesh):
        return [tuple(t.to(dev) for t in local[i]) for i in range(D)]
    import torch.distributed as dist
    order = [i for i, _ in mine]
    shapes = [t.shape for t in local[order[0]]]
    owners = [np.flatnonzero(mesh.ranks == r)
              for r in range(dist.get_world_size())]
    if any(len(o) != len(order) for o in owners):
        raise ValueError(f"every rank must own as many shards: {owners}")
    send = torch.stack([torch.cat([t.reshape(-1) for t in local[i]]).to(dev)
                        for i in order])
    recv = [torch.empty_like(send) for _ in owners]
    dist.all_gather(recv, send)
    out = [None] * D
    for got, idx in zip(recv, owners):
        for row, i in zip(got, idx):
            pieces = row.split([math.prod(s) for s in shapes])
            out[i] = tuple(p.reshape(s) for p, s in zip(pieces, shapes))
    return out


def _by_device(mesh, axis: str) -> list:
    """This process's shard indices of the mesh, grouped by device."""
    groups = {}
    for i, dev in local_shards(mesh, axis)[1]:
        groups.setdefault(dev, []).append(i)
    return list(groups.values())


def sharded_msm(mesh, curve, points_aff, scalars_std,
                window: int = 4, lanes: int = None, axis: str = "chips"):
    """MSM with the point axis sharded over `axis`.

    points_aff: affine batch (N,); scalars int64[17, N]; N divisible by
    the shard count. Returns the Jacobian sum () on the merge device (the
    same on every rank). (`lanes` is accepted and ignored, as in the
    JAX package: ops/msm.py picks its width.)
    """
    ns = curve.ns
    D = mesh.shape[axis]
    metrics.count("sharded_msm_points", points_aff[2].shape[-1])
    # the only collective: one Jacobian partial (int64 limbs) per shard
    metrics.collective_bytes(D, 3 * FQ.n * (2 if ns == 2 else 1) * 8,
                             "msm_merge")
    xs, ys = (shard_batch(mesh, c, ns, axis) for c in points_aff[:2])
    infs = shard_batch(mesh, points_aff[2], 0, axis)
    ss = shard_batch(mesh, scalars_std, 1, axis)
    local = {}
    for idx in _by_device(mesh, axis):
        pts = (torch.stack([xs[i] for i in idx], ns),
               torch.stack([ys[i] for i in idx], ns),
               torch.stack([infs[i] for i in idx]))
        out = msm_mod.msm(curve, pts, torch.stack([ss[i] for i in idx], 1),
                          window=window)                  # Jacobian (L,)
        for k, i in enumerate(idx):
            local[i] = tuple(c.select(ns, k) for c in out)
    parts = gather_partials(mesh, local, axis)
    return curve.sum_reduce(tuple(torch.stack([p[c] for p in parts], ns)
                                  for c in range(3)), axis=0)


def sharded_multi_pairing(mesh, p_aff, q_aff, axis: str = "chips"):
    """prod_k e(P_k, Q_k) with the pair axis sharded; ONE final exp.

    p_aff: G1 affine (K,), q_aff: G2 affine (K,); K divisible by the
    shard count. Returns an Fq12 (nl, 12) on the merge device (the same
    on every rank).
    """
    D = mesh.shape[axis]
    metrics.count("sharded_pairings", p_aff[2].shape[-1])
    # the only collective: one Fq12 Miller partial (int64 limbs) per shard
    metrics.collective_bytes(D, FQ.n * 12 * 8, "pairing_merge")
    P = [shard_batch(mesh, c, ax, axis) for c, ax in zip(p_aff, (1, 1, 0))]
    Q = [shard_batch(mesh, c, ax, axis) for c, ax in zip(q_aff, (2, 2, 0))]
    local = {}
    for idx in _by_device(mesh, axis):
        stk = lambda shards, axes: tuple(
            torch.stack([c[i] for i in idx], ax) for c, ax in zip(shards,
                                                                  axes))
        f = pr.multi_miller(stk(P, (1, 1, 0)), stk(Q, (2, 2, 0)),
                            axis=1)                       # (nl, 12, len(idx))
        for k, i in enumerate(idx):
            local[i] = (f[:, :, k],)
    parts = gather_partials(mesh, local, axis)
    f = torch.stack([p[0] for p in parts], 2)             # (nl, 12, D)
    return pr.final_exp(pr._product_reduce(f, axis=0))
