"""Multi-device scoring: data-parallel batches and row-sharded banks.

The JAX package's ``parallel/eval.py`` on a process group:

* ``dp_score_batch``: each rank scores its block of a batch against its
  replica of the bank; one gather gives every rank the whole batch's
  scores and maps in batch order;
* ``sharded_bank_min_dist``: each rank holds a block of bank rows
  (``mesh.shard_rows``) and runs the bank-min kernel on it, refining its
  winner exactly in float32 as the JAX sharded function does inside
  ``bank_min_dist_pallas``; one ``all_reduce(MIN)`` over the packed
  (value, global row) keys of ``ops.bank_min.pack_min_keys`` picks the
  global winner, the lowest row, and so the lowest shard, on a tie, as the
  JAX ``argmin`` over the gathered shards does;
* ``sharded_score_batch``: the eq. 7 tail on a sharded bank.  The NN
  table covers the whole padded bank and is replicated; the bank rows it
  names live on one rank each, which supplies them while the others add
  zeros, so one ``all_reduce(SUM)`` carries them to every rank unchanged.

``cos_dist`` stays off the sharded path (padding rows are far only by
value under ``l2`` and ``l1``), as in the JAX package.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from cmdiad_tpu_torch.ops.bank_min import (bank_min_bf16, bank_min_int8,
                                           pack_min_keys, unpack_min_keys)
from cmdiad_tpu_torch.ops.scoring import bank_min_dist, patchcore_finish, patchcore_score
from cmdiad_tpu_torch.parallel.mesh import Mesh, gather_rows


def dp_score_batch(mesh: Mesh, patches: torch.Tensor, bank: torch.Tensor,
                   feat_hw, **kw):
    """Data-parallel scoring.  ``patches`` (B / n, Np, D) is this rank's
    block of a batch and ``bank`` its replica; ``kw`` as for
    ``ops.scoring.patchcore_score``.  Returns the whole batch's (s (B,),
    s_map (B, out, out)) on every rank, in batch order."""
    s, s_map = patchcore_score(patches, bank, feat_hw, **kw)
    return gather_rows(s, mesh), gather_rows(s_map, mesh)


def sharded_bank_min_dist(mesh: Mesh, patch: torch.Tensor, bank_local: torch.Tensor,
                          metric: str = "l2", n_valid=None, bank_operands=None):
    """(min distance (N,), global bank row (N,) int64) of each row of
    ``patch`` (N, D), the same on every rank, over a bank whose rows are
    sharded in equal blocks: ``bank_local`` is this rank's.  ``l2`` and
    ``l2_int8`` choose each shard's row with their kernel and refine its
    distance exactly; ``l1`` is exact.  ``bank_operands`` are the local
    block's kernel operands when the caller keeps them; ``n_valid`` masks
    the padding rows of the whole bank for ``l1``."""
    lo = mesh.rank * bank_local.shape[0]
    ops = bank_operands or {}
    if metric == "l2":
        v, idx = bank_min_bf16(patch, bank_local, **ops)
    elif metric == "l2_int8":
        v, idx = bank_min_int8(patch, bank_local, **ops)
    elif metric == "l1":
        v, idx = bank_min_dist(patch, bank_local, metric,
                               n_valid=None if n_valid is None else n_valid - lo)
    else:
        raise ValueError(f"metric {metric!r} has no sharded bank min (cos_dist "
                         "scores a whole bank)")
    keys = pack_min_keys(v, idx + lo)
    dist.all_reduce(keys, op=dist.ReduceOp.MIN, group=mesh.group)
    return unpack_min_keys(keys)


def owned_rows(mesh: Mesh, bank_local: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``idx`` (global rows, any shape) of a row-sharded bank, on every
    rank: each row's owner supplies it, the other ranks zeros, summed."""
    rows = bank_local.shape[0]
    lo = mesh.rank * rows
    mine = (idx >= lo) & (idx < lo + rows)
    local = bank_local[(idx - lo).clamp(0, rows - 1)]
    out = torch.where(mine[..., None], local, torch.zeros((), dtype=local.dtype,
                                                          device=local.device))
    dist.all_reduce(out, group=mesh.group)
    return out


def sharded_score_batch(mesh: Mesh, patches: torch.Tensor, bank_local: torch.Tensor,
                        feat_hw, nn_table: torch.Tensor, out_size: int = 224,
                        metric: str = "l2", n_reweight: int = 3, blur_radius: float = 4.0,
                        n_valid=None, bank_operands=None, quantized_blur: bool = False):
    """Image scores and maps of a batch ``patches`` (B, Np, D), the same on
    every rank, against a row-sharded bank (``bank_local`` this rank's
    block, ``nn_table`` the whole bank's)."""
    b, n, d = patches.shape
    v, idx = sharded_bank_min_dist(mesh, patches.reshape(b * n, d), bank_local,
                                   metric, n_valid, bank_operands)
    return patchcore_finish(patches, None, v.reshape(b, n), idx.reshape(b, n), feat_hw,
                            out_size=out_size, metric=metric, n_reweight=n_reweight,
                            blur_radius=blur_radius, n_valid=n_valid, nn_table=nn_table,
                            bank_rows=lambda i: owned_rows(mesh, bank_local, i),
                            quantized_blur=quantized_blur)
