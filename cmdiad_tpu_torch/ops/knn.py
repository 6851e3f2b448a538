"""Masked k-nearest-neighbour grouping (exact).

For each of G centers, the k nearest valid points, ascending by squared
distance with ties to the lower index (the order ``lax.top_k`` gives).
``torch.topk`` promises no order among ties, so the selection runs on a
composite int64 key, (distance bits << 32) | index, which is unique and
orders exactly by (distance, index).
"""

from __future__ import annotations

import torch

from cmdiad_tpu_torch import tracing
from cmdiad_tpu_torch.ops.masked import BIG_DIST, first_valid_index


def pairwise_sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Squared euclidean distances (..., N, C) x (..., M, C) -> (..., N, M),
    clamped at 0: the dot-product identity cancels to about -1e-7 for
    coincident pairs, which would turn 1/(d + eps) weights negative."""
    a2 = torch.sum(a * a, dim=-1)[..., :, None]
    b2 = torch.sum(b * b, dim=-1)[..., None, :]
    ab = torch.matmul(a, b.transpose(-1, -2))
    return torch.clamp_min(a2 + b2 - 2.0 * ab, 0.0)


def masked_knn(points: torch.Tensor, mask: torch.Tensor,
               centers: torch.Tensor, k: int) -> torch.Tensor:
    """points (B, P, 3), mask (B, P), centers (B, G, 3) -> idx (B, G, k)
    int64.  Where fewer than k valid points exist the tail takes the first
    valid point, so later gathers never touch padding."""
    first_valid = first_valid_index(mask)
    out = []
    for b in range(points.shape[0]):   # one (G, P) distance matrix at a time
        d = pairwise_sqdist(centers[b].to(torch.float32),
                            points[b].to(torch.float32))
        d = torch.where(mask[b][None, :], d, tracing.to_device(BIG_DIST, d.device))
        d = d + 0.0    # -0.0 -> +0.0 so the bit pattern orders like the value
        p = d.shape[1]
        key = ((d.view(torch.int32).to(torch.int64) << 32)
               | torch.arange(p, device=d.device, dtype=torch.int64))
        sel = torch.topk(key, k, dim=1, largest=False, sorted=True).values
        idx = sel & 0xFFFFFFFF
        invalid = ~mask[b][idx]
        out.append(torch.where(invalid, first_valid[b], idx))
    return torch.stack(out)
