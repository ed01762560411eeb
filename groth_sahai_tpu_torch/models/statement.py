"""Groth-Sahai statements: the four bilinear equation types.

The port of ``groth_sahai_tpu/models/statement.py``. An equation has the
abstract form (A * Y)(X * B)(X * Gamma Y) = t; the four types fix which
sides live in G1/G2/Fr:

  PPE     (G1, G2, GT)   pairing-product equation
  MSMEG1  (G1, Fr, G1)   multi-scalar-mult equation in G1
  MSMEG2  (Fr, G2, G2)   multi-scalar-mult equation in G2
  QuadEqu (Fr, Fr, Fr)   quadratic equation in Fr

Representation (structure of arrays, tensors on one device):
  * group constants are affine point batches ((n,) or (m,));
  * scalar constants / gamma are standard-form Fr limb tensors
    (int64[17, n] / int64[17, m, n]);
  * targets: an Fq12 coefficient tensor (nl, 12) for PPE, an affine point
    for MSME, Fr limbs (17,) for Quad.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Any


class EquType(enum.IntEnum):
    """Wire-compatible tags (1-byte canonical serde)."""
    PairingProduct = 0
    MultiScalarG1 = 1
    MultiScalarG2 = 2
    Quadratic = 3


@dataclass
class PPE:
    a_consts: Any        # G1 affine batch (n,)
    b_consts: Any        # G2 affine batch (m,)
    gamma: Any           # int64[17, m, n] std-form Fr
    target: Any          # Fq12 coeff tensor (nl, 12)

    equ_type = EquType.PairingProduct
    x_is_scalar = False
    y_is_scalar = False


@dataclass
class MSMEG1:
    a_consts: Any        # G1 affine batch (n',)
    b_consts: Any        # int64[17, m] std-form Fr
    gamma: Any           # int64[17, m, n']
    target: Any          # G1 affine ()

    equ_type = EquType.MultiScalarG1
    x_is_scalar = False
    y_is_scalar = True


@dataclass
class MSMEG2:
    a_consts: Any        # int64[17, n] std-form Fr
    b_consts: Any        # G2 affine batch (m',)
    gamma: Any           # int64[17, m', n]
    target: Any          # G2 affine ()

    equ_type = EquType.MultiScalarG2
    x_is_scalar = True
    y_is_scalar = False


@dataclass
class QuadEqu:
    a_consts: Any        # int64[17, n']
    b_consts: Any        # int64[17, m']
    gamma: Any           # int64[17, m', n']
    target: Any          # int64[17] std-form Fr

    equ_type = EquType.Quadratic
    x_is_scalar = True
    y_is_scalar = True
