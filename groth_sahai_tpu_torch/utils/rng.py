"""Deterministic, seedable randomness for CRS generation and proving.

The port of ``groth_sahai_tpu/utils/rng.py``: counter-based Philox on the
host (numpy), so identical seeds give identical streams across runs,
machines, process counts and the two packages. All draws are uniform in Fr
via 512-bit reduction (bias < 2^-257). The draws are made on the host and
copied to the device once.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.fp import FR, resolve_device
from ..ops.limbs import ints_to_limbs


class GsRng:
    """Deterministic Fr sampler; draw order is part of the wire contract."""

    def __init__(self, seed: int = 0):
        self._gen = np.random.Generator(np.random.Philox(seed))

    def fr_ints(self, n: int):
        return [int.from_bytes(self._gen.bytes(64), "little") % FR.p
                for _ in range(n)]

    def fr_std(self, shape, device="cuda"):
        """Standard-form (non-Montgomery) Fr limbs int64[17, *shape]."""
        shape = (shape,) if isinstance(shape, int) else tuple(shape)
        arr = ints_to_limbs(self.fr_ints(math.prod(shape)), FR.n)
        return torch.as_tensor(arr.astype(np.int64),
                               device=resolve_device(device)).reshape(
                                   (FR.n,) + shape)

    def fr_mont(self, shape, device="cuda"):
        return FR.to_mont(self.fr_std(shape, device=device))
