"""Masked farthest point sampling.

Semantics of ``pointnet2_ops.furthest_point_sample`` on the reference's
zero-filtered point list: seeded from the first valid point in scan order,
squared-L2 farthest-first selection with a running min-distance vector,
and masked points never selected (they hold a negative running distance).
The argmax takes the lowest index among equal maxima.

``farthest_point_sample`` launches the CUDA kernel (``csrc/fps.cu``) for a
CUDA tensor and runs ``_fps_plain`` for a CPU tensor.  The kernel spreads
each set over a cluster of CTAs and reduces its argmax over 64-bit keys
(``pack_argmax_keys``).
"""

from __future__ import annotations

import ctypes

import torch

from cmdiad_tpu_torch import kernels
from cmdiad_tpu_torch.ops.masked import first_valid_index

# The points a set's state can hold in registers (csrc/fps.cu): a cluster
# of 8 CTAs x 512 threads x 16 points.
MAX_POINTS = 8 * 512 * 16
# The key of a slot that holds no point: below every value's, -1 included.
ABSENT_KEY = -(2 ** 63)


def pack_argmax_keys(v: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(value float32, index) -> int64 keys whose signed order is value
    order, then the lower index first: the float's bits, magnitude flipped
    for negative values, above ~index (0 <= index < 2^32 - 1).  The largest
    key is the first occurrence of the largest value, the argmax
    ``_fps_plain`` takes; -0.0 packs as +0.0.  The kernel reduces these
    keys within and across the CTAs of a set (csrc/fps.cu)."""
    bits = (v.to(torch.float32) + 0.0).view(torch.int32)
    ordered = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    return (ordered.to(torch.int64) << 32) | (~idx.to(torch.int64) & 0xFFFFFFFF)


def unpack_argmax_index(keys: torch.Tensor) -> torch.Tensor:
    """The index a key of ``pack_argmax_keys`` holds; 0 for ``ABSENT_KEY``
    (no point anywhere: the kernel then picks index 0)."""
    idx = ~keys & 0xFFFFFFFF
    return torch.where(keys == ABSENT_KEY, torch.zeros_like(idx), idx)


def cluster_size(batch: int, points: int) -> int:
    """CTAs per set the kernel launches for ``batch`` sets of ``points``:
    16 when all the batch's clusters of 16 fit on the card at once with one
    CTA an SM, else 8 (asks the card; CUDA only)."""
    fn = kernels.library("fps").fps_cluster_size
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn(batch, points)


def _fps_plain(points: torch.Tensor, mask: torch.Tensor,
               num_samples: int) -> torch.Tensor:
    """Plain PyTorch FPS over a batch: points (B, P, 3), mask (B, P) ->
    (B, G) int64.  The squared distance is ((dx*dx + dy*dy) + dz*dz), the
    order the kernel uses."""
    p = points.to(torch.float32)
    b = p.shape[0]
    rows = torch.arange(b, device=p.device)
    min_d = torch.where(mask, torch.tensor(1e10, device=p.device),
                        torch.tensor(-1.0, device=p.device))
    last = first_valid_index(mask)
    out = torch.empty((b, num_samples), dtype=torch.int64, device=p.device)
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    for g in range(num_samples):
        out[:, g] = last
        dx = x - x[rows, last][:, None]
        dy = y - y[rows, last][:, None]
        dz = z - z[rows, last][:, None]
        d = (dx * dx + dy * dy) + dz * dz
        min_d = torch.where(min_d >= 0.0, torch.minimum(min_d, d), min_d)
        last = torch.argmax(min_d, dim=1)
    return out


def _fps_cuda(points: torch.Tensor, mask: torch.Tensor, num_samples: int,
              clusters: int = 0) -> torch.Tensor:
    """The kernel over clusters of ``clusters`` CTAs a set (8 or 16; 0 takes
    ``cluster_size``'s choice)."""
    b, p, _ = points.shape
    if p > MAX_POINTS:
        raise ValueError(f"FPS kernel takes at most {MAX_POINTS} points, got {p}")
    if clusters not in (0, 8, 16):
        raise ValueError(f"FPS kernel runs clusters of 8 or 16 CTAs, got {clusters}")
    xyz = points.to(torch.float32).transpose(1, 2).contiguous()   # (B, 3, P)
    m = mask.to(torch.uint8).contiguous()
    kernels.check_cuda_tensor(xyz, "points", torch.float32, (b, 3, p))
    kernels.check_cuda_tensor(m, "mask", torch.uint8, (b, p))
    out = torch.empty((b, num_samples), dtype=torch.int32, device=points.device)
    kernels.launch("fps", xyz.data_ptr(), m.data_ptr(), b, p, num_samples,
                   clusters, out.data_ptr())
    return out.to(torch.int64)


def farthest_point_sample(points: torch.Tensor, mask: torch.Tensor,
                          num_samples: int):
    """Batched masked FPS: points (B, P, 3), mask (B, P) bool ->
    (centers (B, G, 3) float32, center_idx (B, G) int64)."""
    if points.is_cuda:
        idx = _fps_cuda(points, mask, num_samples)
    else:
        idx = _fps_plain(points, mask, num_samples)
    centers = torch.gather(points.to(torch.float32), 1,
                           idx[..., None].expand(-1, -1, 3))
    return centers, idx
