"""Coreset subsampling: sparse random projection + greedy k-center.

The reference (``Features.get_coreset_idx_randomp``) projects the bank with
sklearn's SparseRandomProjection, then runs an n-step greedy
farthest-first loop in FP16.  The port draws the JAX package's projection
matrix bit for bit (``jax.random.uniform(PRNGKey(seed), (d, n_components))``
through ``prng.uniform``, on the CPU or the bank's device alike), so both
packages project a bank alike and pick the same rows; 'FP16' runs the
greedy loop in bfloat16, as the JAX package does.  The JAX package pads the
matrix with zero columns to a multiple of 128 for its compiler; zero
columns change no distance, and the port leaves them out.

Greedy k-center is prefix-stable, so the port runs exactly ``n_select``
steps; the JAX package's row/iteration bucketing only served its compile
cache and changes no selection.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from cmdiad_tpu_torch import prng

_GREEDY_DTYPES = {"FP16": torch.bfloat16, "TF32": torch.float32,
                  "FP32": torch.float32}


def johnson_lindenstrauss_min_dim(n_samples: int, eps: float) -> int:
    """sklearn-compatible JL lower bound on the projection dimension."""
    denom = (eps ** 2 / 2.0) - (eps ** 3 / 3.0)
    return int(4.0 * math.log(n_samples) / denom)


def srp_matrix(d: int, n_components: int, seed: int = 0, device="cpu") -> torch.Tensor:
    """(d, n_components) Achlioptas/Li matrix, density 1/sqrt(d): entries
    -s, +s, 0 with probabilities density/2, density/2, 1 - density,
    s = sqrt(1/density) / sqrt(n_components); the JAX package's matrix of
    ``seed``, bit for bit."""
    density = 1.0 / math.sqrt(d)
    scale = math.sqrt(1.0 / density) / math.sqrt(n_components)
    u = prng.uniform(prng.prng_key(seed, device), (d, n_components))
    return torch.where(u < density / 2.0, -scale,
                       torch.where(u < density, scale, 0.0)).to(torch.float32)


def sparse_random_projection(x: torch.Tensor, eps: float = 0.9, seed: int = 0,
                             n_components: Optional[int] = None) -> torch.Tensor:
    """Project (N, D) -> (N, D') with D' the JL dimension.

    Raises ValueError when the JL dimension exceeds D, as sklearn does; the
    caller then keeps the unprojected bank (reference behaviour).
    """
    n, d = x.shape
    if n_components is None:
        n_components = johnson_lindenstrauss_min_dim(n, eps)
    if n_components > d:
        raise ValueError(f"JL dim {n_components} > input dim {d}; increase eps")
    return x.to(torch.float32) @ srp_matrix(d, n_components, seed, x.device)


def _dist_to(z: torch.Tensor, point: torch.Tensor, metric: str) -> torch.Tensor:
    """Distances in z's dtype, rounded as the JAX package's compiled loop
    rounds them: the differences in z's dtype, their squares (or absolute
    values) summed in float32, the sum rounded to z's dtype, then the root.
    Rounding each bfloat16 square, as an eager bfloat16 product would, moves
    distances by an ulp and changes the greedy picks."""
    if metric == "l2":
        diff = (z - point[None, :]).to(torch.float32)
        return torch.sqrt(torch.sum(diff * diff, dim=1).to(z.dtype))
    if metric == "l1":
        diff = (z - point[None, :]).to(torch.float32)
        return torch.sum(torch.abs(diff), dim=1).to(z.dtype)
    if metric == "cos_dist":
        zn = z / torch.clamp_min(torch.linalg.norm(z, dim=1, keepdim=True), 1e-30)
        pn = point / torch.clamp_min(torch.linalg.norm(point), 1e-30)
        return 1.0 - zn @ pn
    raise ValueError(metric)


def greedy_kcenter(z: torch.Tensor, n_select: int, metric: str = "l2",
                   compute_dtype: str = "FP16") -> torch.Tensor:
    """Greedy farthest-first selection of ``n_select`` row indices (int64).

    Start at row 0; each step takes the distance of every row to the last
    pick, updates the running min, picks its argmax (first occurrence) and
    zeroes that row's running distance.  The running distances and the
    distance pass are in ``compute_dtype``; the initial distances are
    computed in float32 then cast.  The loop never syncs with the host.
    """
    dt = _GREEDY_DTYPES[compute_dtype]
    zc = z.to(dt)
    min_d = _dist_to(z.to(torch.float32), z[0].to(torch.float32), metric).to(dt)
    idxs = torch.zeros((n_select,), dtype=torch.int64, device=z.device)
    last = torch.zeros((), dtype=torch.int64, device=z.device)
    for i in range(n_select):
        idxs[i] = last
        d = _dist_to(zc, torch.index_select(zc, 0, last.view(1))[0], metric)
        min_d = torch.minimum(d, min_d)
        last = torch.argmax(min_d)
        min_d = min_d.index_fill(0, last[None], 0)
    return idxs


def coreset_select(bank: torch.Tensor, f_coreset: float, eps: float = 0.9,
                   seed: int = 0, metric: str = "l2",
                   compute_dtype: str = "FP16") -> torch.Tensor:
    """SRP (falling back to the raw bank when the JL dimension exceeds the
    width) + greedy k-center; int(f_coreset * N) row indices."""
    n_select = int(f_coreset * bank.shape[0])
    try:
        z = sparse_random_projection(bank, eps=eps, seed=seed)
    except ValueError:
        z = bank.to(torch.float32)
    return greedy_kcenter(z, n_select, metric=metric, compute_dtype=compute_dtype)
