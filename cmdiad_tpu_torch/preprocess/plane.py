"""RANSAC background-plane removal for organized point clouds, on tensors.

The JAX package's ``preprocess/plane.py`` (the reference's Open3D
``segment_plane``): the background plane is fit on the 10-pixel border
ring of valid points (RANSAC: 1000 candidate planes, each the
least-squares plane of 50 sampled points, scored by the points within
0.004 of it, the first best one refit on its inliers), then every point
within 0.005 of the plane is zeroed in both pc and rgb.

The 1000 candidate fits run as one batched computation on the cloud's
device: (1000, 3, 3) covariances, one batched ``eigh``, one (N, 1000)
distance product, in float64.  The sample indices are drawn on the host
with ``numpy.random.default_rng(seed).integers(0, n, size=(iters, k))``,
the draw of the JAX package's numpy path, so both packages fit the same
samples (its default C++ path draws from ``std::mt19937_64``, whose
integer distribution is implementation-defined).  ``eigh`` fixes no sign,
so a plane and its negation are the same plane.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def border_points(organized_pc: torch.Tensor, border: int = 10) -> torch.Tensor:
    """Valid (all-nonzero) points of the image border ring (N, 3)."""
    pts = torch.cat([organized_pc[:border].reshape(-1, 3),
                     organized_pc[-border:].reshape(-1, 3),
                     organized_pc[:, :border].reshape(-1, 3),
                     organized_pc[:, -border:].reshape(-1, 3)])
    return pts[(pts != 0).all(dim=1)]


def _fit_planes_batch(samples: torch.Tensor):
    """Least-squares plane of each sample set: (B, n, 3) float64 ->
    (normals (B, 3), d (B,)), the normal the smallest-eigenvalue
    eigenvector of the set's scatter matrix."""
    centroid = samples.mean(dim=1, keepdim=True)
    centered = samples - centroid
    cov = torch.einsum("bni,bnj->bij", centered, centered)
    normals = torch.linalg.eigh(cov).eigenvectors[:, :, 0]
    normals = normals / torch.clamp_min(torch.linalg.norm(normals, dim=1, keepdim=True), 1e-12)
    return normals, -torch.sum(normals * centroid[:, 0], dim=1)


def ransac(points: torch.Tensor, distance_threshold: float = 0.004,
           ransac_n: int = 50, num_iterations: int = 1000,
           seed: int = 0) -> Tuple[torch.Tensor, int]:
    """-> (plane (4,) float64, the best candidate's iteration)."""
    n = points.shape[0]
    if n < 3:
        raise ValueError("need at least 3 border points for a plane fit")
    k = min(ransac_n, n)
    idx = np.random.default_rng(seed).integers(0, n, size=(num_iterations, k))
    p = points.to(torch.float64)
    normals, d = _fit_planes_batch(p[torch.from_numpy(idx).to(p.device)])
    dist = torch.abs(p @ normals.T + d[None, :])              # (N, iters)
    best = int(torch.argmax((dist < distance_threshold).sum(dim=0)))  # the first best
    mask = dist[:, best] < distance_threshold
    if int(mask.sum()) >= 3:
        # refit on the best candidate's inliers, as Open3D does
        nrm, dd = _fit_planes_batch(p[mask][None])
        return torch.cat([nrm[0], dd]), best
    return torch.cat([normals[best], d[best:best + 1]]), best


def ransac_plane(points: torch.Tensor, distance_threshold: float = 0.004,
                 ransac_n: int = 50, num_iterations: int = 1000,
                 seed: int = 0) -> torch.Tensor:
    """Best-fit plane (a, b, c, d), float64, with |ax+by+cz+d| as a
    point's distance."""
    return ransac(points, distance_threshold, ransac_n, num_iterations, seed)[0]


def remove_plane(organized_pc: torch.Tensor, organized_rgb: torch.Tensor,
                 distance_threshold: float = 0.005, fit_threshold: float = 0.004,
                 seed: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Zero all points within ``distance_threshold`` of the border plane,
    in new tensors."""
    plane = ransac_plane(border_points(organized_pc),
                         distance_threshold=fit_threshold, seed=seed)
    flat = organized_pc.reshape(-1, 3)
    on_plane = torch.abs(flat.to(torch.float64) @ plane[:3] + plane[3]) < distance_threshold
    pc_out = flat.clone()
    rgb_out = organized_rgb.reshape(-1, organized_rgb.shape[-1]).clone()
    pc_out[on_plane] = 0
    rgb_out[on_plane] = 0
    return pc_out.reshape(organized_pc.shape), rgb_out.reshape(organized_rgb.shape)
