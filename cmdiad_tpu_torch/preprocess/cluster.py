"""Largest-cluster cleaning with DBSCAN, on tensors.

The JAX package's ``preprocess/cluster.py`` (the reference's Open3D
``cluster_dbscan``, eps=0.006, min_points=30): DBSCAN over the valid
points, keep only the largest cluster, zero the rest in pc and rgb.

``dbscan_labels`` gives the labels of both JAX paths (its scipy BFS and
its host C++ ``dbscan``, ``cmdiad_tpu/native/cmdiad_native.cc:268``):

* a point is core when at least ``min_points`` points, itself included,
  lie within eps: ``(dx*dx + dy*dy) + dz*dz <= eps*eps`` in float64 from
  the float32 coordinates, the C++ test (the scipy KD-tree's too);
* core points within eps of each other form components, numbered 0, 1,
  ... in the order of each component's smallest core index, the order in
  which both BFS loops start their clusters;
* a non-core point takes the smallest cluster id among its core
  eps-neighbours, or -1 (noise).

A CUDA tensor runs the grid-hashed kernel ``csrc/dbscan.cu`` (the C++
routine's counterpart) and a CPU tensor ``_roots_plain`` (chunked dense
distances, then min-label propagation to a fixed point); both return each
point's component root, its smallest core index, and the labels are the
roots' ranks.  No eps-neighbour list is ever built: at MVTec 3D-AD's
density every valid point has thousands of eps-neighbours.
"""

from __future__ import annotations

from typing import Tuple

import torch

from cmdiad_tpu_torch import kernels

# 27 neighbour cells of a cell
_OFFSETS = [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)]


def _d2_within(p: torch.Tensor, rows: torch.Tensor, eps2: float) -> torch.Tensor:
    """(len(rows), N) bool: point ``rows[i]`` within eps of point j; ``p``
    float64 (N, 3), the distance summed as (dx² + dy²) + dz²."""
    dx = p[rows, 0, None] - p[None, :, 0]
    dy = p[rows, 1, None] - p[None, :, 1]
    dz = p[rows, 2, None] - p[None, :, 2]
    return (dx * dx + dy * dy) + dz * dz <= eps2


def _roots_plain(points: torch.Tensor, eps: float, min_points: int,
                 chunk_elems: int = 1 << 24) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: (root (N,) int64, -1 for noise; eps-neighbour count
    (N,) int64, itself included)."""
    p = points.to(torch.float64)
    n = p.shape[0]
    eps2 = eps * eps
    step = max(1, chunk_elems // max(n, 1))
    chunks = [torch.arange(s, min(n, s + step), device=p.device) for s in range(0, n, step)]
    counts = torch.cat([_d2_within(p, r, eps2).sum(dim=1) for r in chunks])
    core = counts >= min_points
    none = torch.tensor(n, device=p.device)
    # every core point's label: a core index of its component, never above
    # its own; propagate minima over core-core edges (in place, chunk after
    # chunk), then jump each label to its label's label until none moves,
    # and repeat until a pass changes nothing: every label is then its
    # component's smallest index
    label = torch.where(core, torch.arange(n, device=p.device), none)
    core_idx = torch.nonzero(core).squeeze(1)
    core_chunks = [core_idx[s:s + step] for s in range(0, core_idx.numel(), step)]
    changed = True
    while changed:
        changed = False
        for r in core_chunks:
            near = _d2_within(p, r, eps2) & core[None, :]
            low = torch.where(near, label[None, :], none).amin(dim=1)
            changed |= bool((low < label[r]).any())
            label[r] = torch.minimum(label[r], low)
        while True:
            jumped = label[label[core_idx]]
            if torch.equal(jumped, label[core_idx]):
                break
            label[core_idx] = jumped
    root = label.clone()
    for r in chunks:
        near = _d2_within(p, r, eps2) & core[None, :]
        border = torch.where(near, label[None, :], none).amin(dim=1)
        root[r] = torch.where(core[r], label[r], border)
    return torch.where(root == n, torch.full_like(root, -1), root), counts


def _cell_grid(points: torch.Tensor, eps: float):
    """Sort the points by their grid cell.  Cells are ``eps * (1 + 2^-20)``
    wide, so two points within eps (as ``_d2_within`` computes it) lie in
    the same or adjacent cells along each axis.  Returns (order (N,),
    cell of each sorted point (N,), cell starts (C + 1,), the 27 neighbour
    cells of each cell (C, 27), -1 where empty)."""
    cell = torch.floor(points.to(torch.float64) * (1.0 / (eps * (1.0 + 2.0 ** -20)))
                       ).to(torch.int64)
    lo = cell.amin(dim=0) - 1
    dims = cell.amax(dim=0) - lo + 2          # room for every neighbour's offset
    dx, dy, dz = (int(v) for v in dims)
    if dx * dy * dz >= 2 ** 62:
        raise ValueError(f"point cloud spans {dx} x {dy} x {dz} cells of eps={eps}: "
                         "too many for 64-bit cell keys")
    c = cell - lo
    key = (c[:, 0] * dy + c[:, 1]) * dz + c[:, 2]
    key_sorted, order = torch.sort(key, stable=True)
    cells, counts = torch.unique_consecutive(key_sorted, return_counts=True)
    starts = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
    cell_of = torch.repeat_interleave(torch.arange(cells.numel(), device=key.device), counts)
    offsets = torch.tensor([(a * dy + b) * dz + e for a, b, e in _OFFSETS], device=key.device)
    want = cells[:, None] + offsets[None, :]
    pos = torch.clamp(torch.searchsorted(cells, want), max=cells.numel() - 1)
    neigh = torch.where(cells[pos] == want, pos, torch.full_like(pos, -1))
    return order, cell_of, starts, neigh


def _roots_cuda(points: torch.Tensor, eps: float,
                min_points: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel (``csrc/dbscan.cu``): the same (root, count) as
    ``_roots_plain``."""
    n = points.shape[0]
    order, cell_of, starts, neigh = _cell_grid(points, eps)
    xyz = points.to(torch.float32)[order].T.contiguous()         # (3, N) sorted
    i32 = dict(dtype=torch.int32, device=points.device)
    orig, cell_of = order.to(torch.int32), cell_of.to(torch.int32)
    starts, neigh = starts.to(torch.int32), neigh.to(torch.int32).contiguous()
    kernels.check_cuda_tensor(xyz, "points", torch.float32, (3, n))
    count, parent, root = (torch.empty(n, **i32) for _ in range(3))
    kernels.launch("dbscan", xyz.data_ptr(), orig.data_ptr(), cell_of.data_ptr(),
                   starts.data_ptr(), neigh.data_ptr(), n, float(eps * eps),
                   int(min_points), count.data_ptr(), parent.data_ptr(), root.data_ptr())
    counts = torch.empty(n, dtype=torch.int64, device=points.device)
    counts[order] = count.to(torch.int64)
    return root.to(torch.int64), counts


def _rank(root: torch.Tensor) -> torch.Tensor:
    """Cluster ids: each root's rank among the roots, -1 kept."""
    valid = root >= 0
    roots = torch.unique(root[valid])
    return torch.where(valid, torch.searchsorted(roots, root), root)


def dbscan_labels(points: torch.Tensor, eps: float = 0.006,
                  min_points: int = 30) -> torch.Tensor:
    """DBSCAN cluster labels of points (N, 3) -> (N,) int64; -1 = noise.
    ``min_points`` counts the point itself."""
    if points.shape[0] == 0:
        return torch.empty(0, dtype=torch.int64, device=points.device)
    roots = _roots_cuda if points.is_cuda else _roots_plain
    return _rank(roots(points, eps, min_points)[0])


def largest_cluster_cleaning(organized_pc: torch.Tensor,
                             organized_rgb: torch.Tensor,
                             eps: float = 0.006, min_points: int = 30
                             ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Keep only the largest DBSCAN cluster; zero everything else.

    Returns (pc, rgb, n_clusters), with the JAX package's rules: the first
    of equally large labels wins, noise (-1) is a candidate, and
    n_clusters is ``labels.max() + 1``."""
    flat_pc = organized_pc.reshape(-1, 3).clone()
    flat_rgb = organized_rgb.reshape(-1, organized_rgb.shape[-1]).clone()
    nonzero = torch.nonzero((flat_pc != 0).all(dim=1)).squeeze(1)
    if nonzero.numel() == 0:
        return organized_pc, organized_rgb, 0
    labels = dbscan_labels(flat_pc[nonzero], eps, min_points)
    ids, counts = torch.unique(labels, return_counts=True)
    largest = ids[torch.argmax(counts)]
    outliers = nonzero[labels != largest]
    flat_pc[outliers] = 0
    flat_rgb[outliers] = 0
    return (flat_pc.reshape(organized_pc.shape),
            flat_rgb.reshape(organized_rgb.shape), int(labels.max()) + 1)
