"""Masked k-nearest-neighbour grouping (exact).

For each of G centers, the k nearest valid points, ascending by squared
distance with ties to the lower index (the order ``lax.top_k`` gives).

``masked_knn`` launches the CUDA kernel (``csrc/knn.cu``, one launch a
batch) for a CUDA tensor and runs ``_knn_plain`` for a CPU tensor.  The
plain version selects on a composite int64 key, (distance bits << 32) |
index, which is unique and orders exactly by (distance, index):
``torch.topk`` promises no order among ties.  The kernel keeps each
center's k smallest such keys without writing the distance matrix.
"""

from __future__ import annotations

import torch

from cmdiad_tpu_torch import kernels
from cmdiad_tpu_torch.ops.masked import BIG_DIST, first_valid_index

# The largest k the kernel's candidate buffer takes (csrc/knn.cu).
MAX_K = 256


def pairwise_sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Squared euclidean distances (..., N, C) x (..., M, C) -> (..., N, M),
    clamped at 0: the dot-product identity cancels to about -1e-7 for
    coincident pairs, which would turn 1/(d + eps) weights negative."""
    a2 = torch.sum(a * a, dim=-1)[..., :, None]
    b2 = torch.sum(b * b, dim=-1)[..., None, :]
    ab = torch.matmul(a, b.transpose(-1, -2))
    return torch.clamp_min(a2 + b2 - 2.0 * ab, 0.0)


def _knn_plain(points: torch.Tensor, mask: torch.Tensor,
               centers: torch.Tensor, k: int) -> torch.Tensor:
    """Plain PyTorch selection, one (G, P) distance matrix a part."""
    first_valid = first_valid_index(mask)
    out = []
    for b in range(points.shape[0]):
        d = pairwise_sqdist(centers[b].to(torch.float32),
                            points[b].to(torch.float32))
        d = d.masked_fill(~mask[b][None, :], BIG_DIST)
        d = d + 0.0    # -0.0 -> +0.0 so the bit pattern orders like the value
        p = d.shape[1]
        key = ((d.view(torch.int32).to(torch.int64) << 32)
               | torch.arange(p, device=d.device, dtype=torch.int64))
        sel = torch.topk(key, k, dim=1, largest=False, sorted=True).values
        idx = sel & 0xFFFFFFFF
        invalid = ~mask[b][idx]
        out.append(torch.where(invalid, first_valid[b], idx))
    return torch.stack(out)


def _packed(points: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(B, P, 3), (B, P) -> (B, P, 4) float32 (x, y, z, |p|^2), -1 in the
    last slot for a masked point: what the kernel streams.  |p|^2 is the
    sum ``pairwise_sqdist`` takes."""
    pts = points.to(torch.float32).contiguous()
    w = torch.where(mask, torch.sum(pts * pts, dim=-1), -1.0)
    return torch.cat([pts, w[..., None]], dim=-1)


def _knn_cuda(points: torch.Tensor, mask: torch.Tensor,
              centers: torch.Tensor, k: int) -> torch.Tensor:
    """The kernel over the whole batch: the wrapper hands it the packed
    points, the centers' norms and each part's first valid index, so that
    no host read happens."""
    b, p, _ = points.shape
    g = centers.shape[1]
    if not 1 <= k <= min(MAX_K, p):
        raise ValueError(f"KNN kernel takes k from 1 to min({MAX_K}, points) "
                         f"= {min(MAX_K, p)}, got {k}")
    pts = _packed(points, mask)
    ctr = centers.to(torch.float32).contiguous()
    c2 = torch.sum(ctr * ctr, dim=-1)
    first = first_valid_index(mask)
    kernels.check_cuda_tensor(pts, "points", torch.float32, (b, p, 4))
    kernels.check_cuda_tensor(ctr, "centers", torch.float32, (b, g, 3))
    out = torch.empty((b, g, k), dtype=torch.int64, device=points.device)
    kernels.launch("knn", pts.data_ptr(), ctr.data_ptr(), c2.data_ptr(),
                   first.data_ptr(), b, p, g, k, BIG_DIST, out.data_ptr())
    return out


def masked_knn(points: torch.Tensor, mask: torch.Tensor,
               centers: torch.Tensor, k: int) -> torch.Tensor:
    """points (B, P, 3), mask (B, P), centers (B, G, 3) -> idx (B, G, k)
    int64.  Where fewer than k valid points exist the tail takes the first
    valid point, so later gathers never touch padding."""
    if points.is_cuda:
        return _knn_cuda(points, mask, centers, k)
    return _knn_plain(points, mask, centers, k)
