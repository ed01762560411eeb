"""Chunked MSM with per-chunk checkpointing and resume.

The port of ``groth_sahai_tpu/ops/msm_chunked.py``. A huge MSM is split
into fixed-size chunks; each chunk runs the Pippenger `msm` of
:mod:`.msm` and its partial (affine, one `to_affine`) is written to
`ckpt_dir` as arkworks-canonical uncompressed bytes by the bulk writer
(utils/serde.py), through a `.tmp` file renamed into place, so a partial
on disk is always whole. After a crash a rerun reads the partials already
on disk back (the bulk reader: validated on the device, on-curve and in
the r-torsion) instead of recomputing them, and counts each in the
`msm_chunks_resumed` counter; only the rest is recomputed. The chunk
combine is one tree reduction.

This also bounds device memory: the sort/gather/prefix pipeline's
footprint is O(chunk * windows), independent of total N.
"""

from __future__ import annotations

import json
import os

import torch

from .curve import Curve
from . import msm as msm_mod
from ..utils import metrics


def _partial_path(ckpt_dir: str, idx: int) -> str:
    return os.path.join(ckpt_dir, f"msm_partial_{idx:06d}.bin")


def _save_partial(curve: Curve, ckpt_dir: str, idx: int, jac) -> None:
    """Store one Jacobian partial as an uncompressed affine point."""
    from ..utils import serde
    aff = curve.to_affine(tuple(l[..., None] for l in jac))
    if curve.ns == 1:
        data = serde.g1_vec_to_bytes_bulk(aff, compressed=False)
    else:
        data = serde.g2_vec_to_bytes_bulk(aff, compressed=False)
    tmp = _partial_path(ckpt_dir, idx) + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, _partial_path(ckpt_dir, idx))     # atomic publish


def _load_partial(curve: Curve, ckpt_dir: str, idx: int, device):
    from ..utils import serde
    path = _partial_path(ckpt_dir, idx)
    if not os.path.exists(path):
        return None
    with open(path, "rb") as f:
        data = f.read()
    if curve.ns == 1:
        aff, _ = serde.g1_vec_from_bytes_bulk(data, validate=True,
                                              device=device)
    else:
        aff, _ = serde.g2_vec_from_bytes_bulk(data, validate=True,
                                              device=device)
    return curve.from_affine(tuple(l[..., 0] for l in aff))


def msm_chunked(curve: Curve, points_aff, scalars_std, window: int = 0,
                chunk_size: int = 1 << 16, ckpt_dir: str | None = None):
    """sum_i s_i P_i over the trailing axis, in resumable chunks.

    points_aff: affine (x, y, inf) with batch (N,); scalars_std:
    int64[17, N]. Runs on the points' device. With `ckpt_dir`, every
    finished chunk's partial is persisted (atomic rename) and
    already-present partials are NOT recomputed -- kill the process at any
    point and rerun to resume. Returns a Jacobian point (batch ()).
    """
    N = points_aff[2].shape[-1]
    if not window:
        window = 8 if chunk_size < 16384 else 13
    n_chunks = -(-N // chunk_size)
    device = points_aff[2].device
    if ckpt_dir:
        os.makedirs(ckpt_dir, exist_ok=True)
        manifest = {"n_points": N, "chunk_size": chunk_size,
                    "window": window, "curve": curve.name}
        with open(os.path.join(ckpt_dir, "manifest.json"), "w") as f:
            json.dump(manifest, f)

    ns = curve.ns
    parts = []
    for c in range(n_chunks):
        if ckpt_dir:
            cached = _load_partial(curve, ckpt_dir, c, device)
            if cached is not None:
                parts.append(cached)
                metrics.count("msm_chunks_resumed")
                continue
        lo, hi = c * chunk_size, min((c + 1) * chunk_size, N)
        pts_c = (points_aff[0].narrow(ns, lo, hi - lo),
                 points_aff[1].narrow(ns, lo, hi - lo),
                 points_aff[2].narrow(0, lo, hi - lo))
        scal_c = scalars_std.narrow(1, lo, hi - lo)
        with metrics.span("msm_chunk"):
            part = msm_mod.msm(curve, pts_c, scal_c, window)
            if part[0].is_cuda:
                torch.cuda.synchronize(part[0].device)
        metrics.count("msm_points", hi - lo)
        if ckpt_dir:
            _save_partial(curve, ckpt_dir, c, part)
        parts.append(part)

    stacked = tuple(torch.stack(ls, ns) for ls in zip(*parts))
    return curve.sum_reduce(stacked, axis=0)
