"""Reduce stage: accumulate projected tiles into coadd + depth.

Counterpart of ``repro.core.reducer`` (the mean path).  Faithful to
Algorithm 3: sum projected illumination into `coadd` and coverage into
`depth`.  The accumulation is a commutative monoid, which is why the paper
could run one serial reducer per query.
"""

from __future__ import annotations

from typing import Tuple

import torch


def reduce_local(tiles: torch.Tensor, covs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Serial (per-device) accumulation over the image axis."""
    return tiles.sum(dim=0), covs.sum(dim=0)


def normalize(coadd: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
    """Depth-normalized stack (mean image); zero where depth == 0.

    Exact masking, no epsilon clamp: fractional depths are divided by their
    true weight, never rescaled by a ``max(depth, eps)``.
    """
    covered = depth > 0
    return torch.where(
        covered, coadd / torch.where(covered, depth, torch.ones_like(depth)), 0.0
    )
