"""Host-side big-integer <-> limb conversions.

A copy of the JAX package's module of the same name. The limb contract is
the reference's: a field element is `[n_limbs, *batch]` of exact 16-bit
limbs, little-endian (limb 0 = least significant), limb axis first. These
helpers return numpy `uint32` arrays; the port stores limbs as
`torch.int64` on the device (see :mod:`groth_sahai_tpu_torch.utils.convert`).
"""

from __future__ import annotations

import numpy as np

W = 16                # bits per limb
MASK = (1 << W) - 1


def int_to_limbs(value: int, n_limbs: int) -> np.ndarray:
    """One Python int -> uint32[n_limbs]."""
    assert 0 <= value < 1 << (W * n_limbs), "value out of range"
    return np.array([(value >> (W * i)) & MASK for i in range(n_limbs)],
                    dtype=np.uint32)


def ints_to_limbs(values, n_limbs: int) -> np.ndarray:
    """Iterable of ints (any nested shape via flat list) -> uint32[n_limbs, len]."""
    vals = list(values)
    out = np.empty((n_limbs, len(vals)), dtype=np.uint32)
    for k, v in enumerate(vals):
        assert 0 <= v < 1 << (W * n_limbs)
        for i in range(n_limbs):
            out[i, k] = (v >> (W * i)) & MASK
    return out


def limbs_to_int(limbs) -> int:
    """uint32[n_limbs] -> Python int."""
    arr = np.asarray(limbs, dtype=np.uint64)
    assert arr.ndim == 1
    return sum(int(arr[i]) << (W * i) for i in range(arr.shape[0]))


def limbs_to_ints(limbs) -> list:
    """uint32[n_limbs, B] -> list of B Python ints."""
    arr = np.asarray(limbs)
    assert arr.ndim == 2
    return [limbs_to_int(arr[:, k]) for k in range(arr.shape[1])]
