"""Carry state across from the JAX package: numpy limbs <-> port tensors.

The JAX package's arrays reach the port as numpy arrays (`uint32` limbs,
bool infinity masks; `np.asarray` of a JAX array). The port stores limbs
as `int64` tensors with the same layout, so a conversion is a dtype change
and a copy to the device. Nothing here imports the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.fp import resolve_device


def limbs_from_numpy(arr, device="cuda") -> torch.Tensor:
    """uint32[n_limbs, ...] limbs -> int64 tensor of the same shape."""
    arr = np.asarray(arr)
    if arr.dtype.kind not in "ui" or (arr.size and (arr.min() < 0 or arr.max() > 0xFFFF)):
        raise ValueError("expected exact 16-bit limbs")
    return torch.as_tensor(arr.astype(np.int64), device=resolve_device(device))


def affine_from_numpy(aff, device="cuda"):
    """(x, y, inf) numpy affine batch -> the port's (x, y, inf) tensors."""
    x, y, inf = aff
    dev = resolve_device(device)
    return (limbs_from_numpy(x, dev), limbs_from_numpy(y, dev),
            torch.as_tensor(np.array(inf, dtype=bool), device=dev))


def to_numpy(t) -> np.ndarray:
    """A port tensor -> numpy: limbs as uint32 (the JAX package's dtype),
    masks as bool."""
    arr = t.detach().cpu().numpy()
    return arr if arr.dtype == np.bool_ else arr.astype(np.uint32)
