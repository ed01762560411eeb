"""The GS verifier (first part): the PPE target as a ComT.

The part of ``groth_sahai_tpu/models/verifier.py`` that the verifier's
last comparison needs: `verify` compares the final-exponentiated signed
Miller product with iota_T(t) = (1, 1, 1, t) through
`commit_group.comt_eq`. The rest of `verify` waits for the commit/prove
slice.
"""

from __future__ import annotations

import torch

from ..ops.tower import FQ12


def _comt_ppe_target(t_gt):
    """iota_T(t) for a PPE: entries (1, 1, 1, t) as (nl, 12, 2, 2).

    t_gt: a GT element (nl, 12), on the device the result takes.
    """
    one = FQ12.one((), device=t_gt.device)
    row0 = torch.stack([one, one], -1)             # (nl, 12, 2)
    row1 = torch.stack([one, t_gt], -1)
    return torch.stack([row0, row1], -2)           # (nl, 12, 2, 2)
